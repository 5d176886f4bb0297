"""Courant-limited adaptive time stepping."""

import numpy as np

from cfd_tpu.adaptive import run_adaptive
from cfd_tpu.cases import make_cavity_case, make_channel_case
from cfd_tpu.solver import Simulation


def quiet(*a, **k):
    pass


def test_adaptive_dt_grows_and_respects_courant():
    """Starting from a tiny dt, the controller grows dt toward the Courant
    target without ever exceeding it (after the startup transient)."""
    case = make_cavity_case(n_interior=32, reynolds_number=100.0,
                            final_time=10.0, poisson="multigrid",
                            tolerance_factor=1e-9, print_interval=10,
                            dt=1e-5)
    sim = Simulation(case, log=quiet)
    state, rows = run_adaptive(sim, max_courant=0.5, n_steps=300, log=quiet)
    dts = [r["dt"] for r in rows]
    cos = [r["courant"] for r in rows]
    assert dts[-1] > 50 * dts[0]  # grew far beyond the tiny start
    assert all(c <= 0.5 * 1.05 for c in cos[3:])  # at/below target with slack
    # the cavity operator's eps_s quirk leaves O(5e-2) divergence at the
    # south row by design (the reference binary prints 6.9e-2; SURVEY.md)
    assert rows[-1]["max_divergence"] < 0.2
    assert 0 < rows[-1]["avg_kinetic_energy"] < 1.0


def test_adaptive_matches_fixed_dt_when_dt_constant():
    """With growth=1 and dt0=case.dt the adaptive path reproduces the fixed
    trajectory exactly (same jitted math, dt merely traced)."""
    case = make_channel_case(nx=16, ny=8, final_time=1.0, poisson="sor")
    sim = Simulation(case, log=quiet)
    st_fixed = sim.initial_state()
    for _ in range(5):
        st_fixed, _ = sim._step(st_fixed)
    st_ad, _ = run_adaptive(sim, max_courant=1e9, n_steps=5, dt0=case.dt,
                            growth=1.0, log=quiet)
    np.testing.assert_array_equal(np.asarray(st_ad.u), np.asarray(st_fixed.u))
    np.testing.assert_array_equal(np.asarray(st_ad.p), np.asarray(st_fixed.p))


def test_adaptive_checkpoint_resume_bitwise(tmp_path):
    """Adaptive runs checkpoint (State, step, dt, t) and resume to a
    bitwise-identical continuation (round-1 gap: dt history was not
    persisted, so --adaptive-dt rejected checkpointing)."""
    import numpy as np

    from cfd_tpu.io.checkpoint import CheckpointManager

    case = make_channel_case(nx=16, ny=8, final_time=5.0, print_interval=1000)

    # uninterrupted 10-step run
    sim_a = Simulation(case, log=quiet)
    sa, _ = run_adaptive(sim_a, max_courant=0.5, n_steps=10)

    # run to 10 with checkpoints every 5, then resume from the step-5
    # checkpoint in a FRESH simulation and finish
    sim_b = Simulation(case, log=quiet)
    sim_b.checkpointer = CheckpointManager(tmp_path, interval=5, keep=10)
    run_adaptive(sim_b, max_courant=0.5, n_steps=10)
    st5, k5, extras = sim_b.checkpointer.restore(5, case, with_extras=True)
    assert k5 == 5 and "dt" in extras and "t" in extras

    sim_c = Simulation(case, log=quiet)
    sc, _ = run_adaptive(sim_c, max_courant=0.5, n_steps=5,
                         state=st5, dt0=extras["dt"])
    np.testing.assert_array_equal(np.asarray(sa.u), np.asarray(sc.u))
    np.testing.assert_array_equal(np.asarray(sa.v), np.asarray(sc.v))
    np.testing.assert_array_equal(np.asarray(sa.p), np.asarray(sc.p))

    # the automatic resume path (state=None picks up the latest checkpoint)
    sim_d = Simulation(case, log=quiet)
    sim_d.checkpointer = CheckpointManager(tmp_path, interval=5, keep=10)
    sd, _ = run_adaptive(sim_d, max_courant=0.5, n_steps=10)  # resumes at 10
    np.testing.assert_array_equal(np.asarray(sim_b.checkpointer.restore(10, case)[0].u),
                                  np.asarray(sd.u))


def test_adaptive_f32_follows_f64_schedule():
    """The float32 adaptive run follows the float64 run's dt schedule to
    f32 roundoff and lands on the same trajectory (the Courant estimate
    feeds back into dt, so a relative band rather than equality)."""
    import jax.numpy as jnp

    kw = dict(n_interior=32, reynolds_number=100.0, final_time=10.0,
              poisson="multigrid", tolerance_factor=1e-5, print_interval=5,
              dt=1e-4)
    c32 = make_cavity_case(dtype=jnp.float32, **kw)
    c64 = make_cavity_case(dtype=jnp.float64, **kw)
    st32, rows32 = run_adaptive(Simulation(c32, log=quiet), max_courant=0.4,
                                n_steps=30, log=quiet)
    st64, rows64 = run_adaptive(Simulation(c64, log=quiet), max_courant=0.4,
                                n_steps=30, log=quiet)
    for r32, r64 in zip(rows32, rows64):
        assert abs(r32["dt"] - r64["dt"]) <= 1e-4 * r64["dt"], (r32, r64)
    inner = np.s_[1:-1, 1:-1]
    np.testing.assert_allclose(np.asarray(st32.u)[inner],
                               np.asarray(st64.u)[inner], atol=2e-5)
    np.testing.assert_allclose(np.asarray(st32.p)[inner],
                               np.asarray(st64.p)[inner], atol=1e-4)


def test_adaptive_chunked_checkpoint_resume(tmp_path):
    """The device-resident (chunked) controller checkpoints (State, step,
    dt, t) and resumes onto the uninterrupted trajectory."""
    import jax.numpy as jnp

    from cfd_tpu.io.checkpoint import CheckpointManager

    kw = dict(n_interior=32, reynolds_number=100.0, final_time=10.0,
              poisson="multigrid", tolerance_factor=1e-5, print_interval=5,
              dt=1e-4, dtype=jnp.float32)
    case = make_cavity_case(**kw)
    st_full, _ = run_adaptive(Simulation(case, log=quiet), max_courant=0.4,
                              n_steps=10, steps_per_call=5, log=quiet)

    sim2 = Simulation(case, log=quiet)
    sim2.checkpointer = CheckpointManager(tmp_path, interval=5)
    run_adaptive(sim2, max_courant=0.4, n_steps=5, steps_per_call=5,
                 log=quiet)
    sim3 = Simulation(case, log=quiet)
    sim3.checkpointer = CheckpointManager(tmp_path, interval=5)
    st_res, _ = run_adaptive(sim3, max_courant=0.4, n_steps=10,
                             steps_per_call=5, log=quiet)
    np.testing.assert_allclose(np.asarray(st_res.u), np.asarray(st_full.u),
                               atol=5e-5)
    np.testing.assert_allclose(np.asarray(st_res.p), np.asarray(st_full.p),
                               atol=2e-4)


def test_adaptive_chunked_controller_matches_host_loop():
    """The device-resident (scan-chunked) Courant controller follows the
    host-loop controller's dt schedule and trajectory to f32 roundoff."""
    import jax.numpy as jnp

    kw = dict(n_interior=32, reynolds_number=100.0, final_time=10.0,
              poisson="multigrid", tolerance_factor=1e-5, print_interval=5,
              dt=1e-4, dtype=jnp.float32)
    case = make_cavity_case(**kw)
    sim = Simulation(case, log=quiet)
    st_host, rows_host = run_adaptive(sim, max_courant=0.4, n_steps=20,
                                      log=quiet)
    st_dev, rows_dev = run_adaptive(sim, max_courant=0.4, n_steps=20,
                                    steps_per_call=5, log=quiet)
    for rh, rd in zip(rows_host, rows_dev):
        assert abs(rh["dt"] - rd["dt"]) <= 1e-4 * rh["dt"], (rh, rd)
    inner = np.s_[1:-1, 1:-1]
    np.testing.assert_allclose(np.asarray(st_dev.u)[inner],
                               np.asarray(st_host.u)[inner], atol=2e-5)


def test_adaptive_lagged_controller_matches_exact_band():
    """The lagged controller (one-step-stale Courant feedback = OpenFOAM
    adjustTimeStep semantics) tracks the exact
    controller's dt schedule within the growth band and lands on a nearby
    trajectory; Co stays at/below target after the transient."""
    import jax.numpy as jnp

    kw = dict(n_interior=32, reynolds_number=100.0, final_time=10.0,
              poisson="multigrid", tolerance_factor=1e-5, print_interval=5,
              dt=1e-4, dtype=jnp.float32)
    case = make_cavity_case(**kw)
    sim = Simulation(case, log=quiet)
    st_ex, rows_ex = run_adaptive(sim, max_courant=0.4, n_steps=30, log=quiet)
    st_lag, rows_lag = run_adaptive(sim, max_courant=0.4, n_steps=30,
                                    controller="lagged", steps_per_call=5,
                                    log=quiet)
    assert st_lag.u.shape == case.grid.shape
    # dt schedules: the lag delays each feedback by one growth-limited
    # update, so during the startup ramp the lagged dt can run ahead by up
    # to ~growth while the exact controller is already braking (observed
    # ratio 1.21 at the first print row); 1.5x bounds the band with slack
    for re_, rl in zip(rows_ex, rows_lag):
        assert rl["dt"] <= re_["dt"] * 1.5, (re_, rl)
        assert rl["dt"] >= re_["dt"] / 1.5, (re_, rl)
    # Courant respected after the startup transient (stale feedback may
    # overshoot by at most ~the growth factor for one step)
    assert all(r["courant"] <= 0.4 * 1.25 for r in rows_lag[2:]), rows_lag
    inner = np.s_[1:-1, 1:-1]
    np.testing.assert_allclose(np.asarray(st_lag.u)[inner],
                               np.asarray(st_ex.u)[inner], atol=5e-3)


def test_adaptive_lagged_checkpoint_resume(tmp_path):
    """Lagged-controller checkpoint/resume: (State, step, dt, t, dt_used)
    persisted; the resumed continuation stays on the trajectory."""
    import jax.numpy as jnp

    from cfd_tpu.io.checkpoint import CheckpointManager

    kw = dict(n_interior=32, reynolds_number=100.0, final_time=10.0,
              poisson="multigrid", tolerance_factor=1e-5, print_interval=5,
              dt=1e-4, dtype=jnp.float32)
    case = make_cavity_case(**kw)
    sim = Simulation(case, log=quiet)
    st_full, rows_full = run_adaptive(sim, max_courant=0.4, n_steps=10,
                                      controller="lagged", steps_per_call=5,
                                      log=quiet)

    sim2 = Simulation(case, log=quiet)
    sim2.checkpointer = CheckpointManager(tmp_path, interval=5)
    run_adaptive(sim2, max_courant=0.4, n_steps=5, controller="lagged",
                 steps_per_call=5, log=quiet)
    sim3 = Simulation(case, log=quiet)
    sim3.checkpointer = CheckpointManager(tmp_path, interval=5)
    st_res, _ = run_adaptive(sim3, max_courant=0.4, n_steps=10,
                             controller="lagged", steps_per_call=5,
                             log=quiet)
    np.testing.assert_allclose(np.asarray(st_res.u), np.asarray(st_full.u),
                               atol=5e-5)
    np.testing.assert_allclose(np.asarray(st_res.p), np.asarray(st_full.p),
                               atol=2e-4)


RB_KW = dict(nx=48, ny=16, rayleigh=1e5, dtype=None,  # dtype set below
             tolerance_factor=1e-5, abs_tol=1e-7, print_interval=3)


def _rb_case():
    import jax.numpy as jnp

    from cfd_tpu.physics.boussinesq import make_rayleigh_benard_case

    return make_rayleigh_benard_case(**dict(RB_KW, dtype=jnp.float32))


def test_adaptive_rb_exact_controller_runs():
    """RB's custom step takes a traced dt too: the exact controller runs it,
    grows dt from a small start and keeps T in the wall band."""
    case = _rb_case()
    sim = Simulation(case, log=quiet)
    st, rows = run_adaptive(sim, max_courant=0.4, n_steps=9,
                            dt0=case.dt * 0.25, log=quiet)
    assert rows[-1]["dt"] > rows[0]["dt"]
    Ti = np.asarray(st.T)[1:-1, 1:-1]
    assert np.isfinite(Ti).all() and Ti.min() >= -0.25 and Ti.max() <= 1.25


def test_adaptive_rb_lagged_fixed_dt_equivalence():
    """With growth=1 and a huge Courant target the lagged RB controller
    never changes dt — its trajectory must match the fixed-dt path to f32
    roundoff (same step, dt merely traced)."""
    case = _rb_case()
    sim = Simulation(case, log=quiet)
    st_fixed = sim.initial_state()
    for _ in range(6):
        st_fixed, _ = sim._step(st_fixed)
    lf = st_fixed

    st_ad, _ = run_adaptive(sim, max_courant=1e6, n_steps=6, growth=1.0,
                            controller="lagged", steps_per_call=3, log=quiet)
    assert st_ad.u.shape == case.grid.shape
    for name in ("u", "v", "p", "T"):
        a = np.asarray(getattr(lf, name))
        b = np.asarray(getattr(st_ad, name))
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * scale,
                                   err_msg=name)


def test_adaptive_rb_lagged_grows_to_diffusive_ceiling():
    """RB startup has near-zero velocity: the lagged controller grows dt
    by the growth factor per step until the diffusive stability ceiling
    (0.25 h^2 / max(nu, kappa) — kappa binds at Pr < 1) caps it; the run
    stays finite and T stays within the wall band."""
    case = _rb_case()
    assert case.adaptive_diffusivity is not None
    h = min(case.coeffs.dx, case.coeffs.dy)
    ceiling = 0.25 * h * h / case.adaptive_diffusivity
    sim = Simulation(case, log=quiet)
    st, rows = run_adaptive(sim, max_courant=0.4, n_steps=30,
                            controller="lagged", steps_per_call=3,
                            dt0=case.dt * 0.25, log=quiet)
    dts = [r["dt"] for r in rows]
    assert dts[-1] > dts[0]
    assert all(r["dt"] <= ceiling * (1 + 1e-6) for r in rows), rows
    assert all(r["courant"] <= 0.4 * 1.25 for r in rows[2:]), rows
    assert np.isfinite(np.asarray(st.u)).all()
    Ti = np.asarray(st.T)[1:-1, 1:-1]
    assert Ti.min() >= -0.25 and Ti.max() <= 1.25


def test_adaptive_channel_lagged_fixed_dt_equivalence():
    """Channel lagged controller with growth=1 and a huge Courant target
    == the fixed-dt channel path to f32 roundoff (same step, dt merely
    traced; guess = 2p - p_prev preserved)."""
    import jax.numpy as jnp

    from cfd_tpu.cases import make_channel_case

    case = make_channel_case(nx=96, ny=32, dtype=jnp.float32,
                             poisson="multigrid", tolerance_factor=1e-6,
                             print_interval=3)
    sim = Simulation(case, log=quiet)
    st_fixed = sim.initial_state()
    for _ in range(6):
        st_fixed, _ = sim._step(st_fixed)
    lf = st_fixed

    st_ad, _ = run_adaptive(sim, max_courant=1e6, n_steps=6, growth=1.0,
                            controller="lagged", steps_per_call=3, log=quiet)
    assert st_ad.u.shape == case.grid.shape
    for name in ("u", "v", "p"):
        a = np.asarray(getattr(lf, name))
        b = np.asarray(getattr(st_ad, name))
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * scale,
                                   err_msg=name)


def test_adaptive_channel_lagged_courant_respected():
    """Channel lagged adaptive from a small dt0: dt grows, Courant settles
    at/below target (one-step-stale feedback overshoot bounded by the
    growth factor), trajectory stays finite."""
    import jax.numpy as jnp

    from cfd_tpu.cases import make_channel_case

    case = make_channel_case(nx=96, ny=32, dtype=jnp.float32,
                             poisson="multigrid", tolerance_factor=1e-6,
                             print_interval=3)
    sim = Simulation(case, log=quiet)
    st, rows = run_adaptive(sim, max_courant=0.4, n_steps=18,
                            controller="lagged", steps_per_call=3,
                            dt0=case.dt * 0.2, log=quiet)
    dts = [r["dt"] for r in rows]
    assert dts[-1] > dts[0]
    assert all(r["courant"] <= 0.4 * 1.25 for r in rows[2:]), rows
    assert np.isfinite(np.asarray(st.u)).all()


def test_adaptive_step_lagged_fixed_dt_equivalence():
    """Backwards-step lagged controller with growth=1 and a huge Courant
    target == the fixed-dt masked path to f32 roundoff (same masked step and
    defect-correction MG, plain-p warm start preserved)."""
    import jax.numpy as jnp

    from cfd_tpu.cases.backwards_step import make_backwards_step_case

    case = make_backwards_step_case(nx=64, ny=16, dtype=jnp.float32,
                                    poisson="multigrid",
                                    tolerance_factor=1e-5,
                                    print_interval=3)
    sim = Simulation(case, log=quiet)
    st_fixed = sim.initial_state()
    for _ in range(6):
        st_fixed, _ = sim._step(st_fixed)
    lf = st_fixed

    st_ad, _ = run_adaptive(sim, max_courant=1e6, n_steps=6, growth=1.0,
                            controller="lagged", steps_per_call=3, log=quiet)
    assert st_ad.u.shape == case.grid.shape
    for name in ("u", "v", "p"):
        a = np.asarray(getattr(lf, name))
        b = np.asarray(getattr(st_ad, name))
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * scale,
                                   err_msg=name)


def test_adaptive_step_lagged_courant_respected():
    """Backwards-step lagged adaptive from a small dt0: dt grows toward
    the Courant/diffusive bound and the solid region stays untouched
    (u inside the solid block is exactly zero)."""
    import jax.numpy as jnp

    from cfd_tpu.cases.backwards_step import make_backwards_step_case
    from cfd_tpu.poisson.multigrid import step_rect_params

    case = make_backwards_step_case(nx=64, ny=16, dtype=jnp.float32,
                                    poisson="multigrid",
                                    tolerance_factor=1e-5,
                                    print_interval=3)
    sim = Simulation(case, log=quiet)
    st, rows = run_adaptive(sim, max_courant=0.4, n_steps=12,
                            controller="lagged", steps_per_call=3,
                            dt0=case.dt * 0.2, log=quiet)
    dts = [r["dt"] for r in rows]
    assert dts[-1] > dts[0]
    assert all(r["courant"] <= 0.4 * 1.25 for r in rows[2:]), rows
    assert np.isfinite(np.asarray(st.u)).all()
    step_i, inlet_j = step_rect_params(case.grid)
    u = np.asarray(st.u)
    # solid interior u-faces (both neighbor cells solid) are exactly zero
    assert np.all(u[inlet_j + 1:-1, 1:step_i] == 0.0)


def test_adaptive_rb_lagged_checkpoint_resume(tmp_path):
    """Lagged RB checkpoint/resume stays on the trajectory (T included in
    the persisted state)."""
    from cfd_tpu.io.checkpoint import CheckpointManager

    case = _rb_case()
    sim = Simulation(case, log=quiet)
    st_full, _ = run_adaptive(sim, max_courant=0.4, n_steps=12,
                              controller="lagged", steps_per_call=3,
                              log=quiet)

    sim2 = Simulation(case, log=quiet)
    sim2.checkpointer = CheckpointManager(tmp_path, interval=6)
    run_adaptive(sim2, max_courant=0.4, n_steps=6, controller="lagged",
                 steps_per_call=3, log=quiet)
    sim3 = Simulation(case, log=quiet)
    sim3.checkpointer = CheckpointManager(tmp_path, interval=6)
    st_res, _ = run_adaptive(sim3, max_courant=0.4, n_steps=12,
                             controller="lagged", steps_per_call=3,
                             log=quiet)
    for name in ("u", "v", "p", "T"):
        np.testing.assert_allclose(np.asarray(getattr(st_res, name)),
                                   np.asarray(getattr(st_full, name)),
                                   rtol=0, atol=5e-4, err_msg=name)
