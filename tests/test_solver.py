import numpy as np
import pytest
import jax.numpy as jnp

import oracle
from cfd_tpu.cases.backwards_step import make_backwards_step_case
from cfd_tpu.cases.cavity import make_cavity_case
from cfd_tpu.cases.channel import make_channel_case
from cfd_tpu.solver import Simulation


def quiet(*a, **k):
    pass


def test_cavity_step_matches_oracle_end_to_end():
    """Run 3 full projection steps vs a lexicographic-SOR loop oracle with
    tight Poisson tolerance: converged states must agree."""
    case = make_cavity_case(n_interior=15, final_time=0.1, tolerance_factor=1e-12)
    sim = Simulation(case, log=quiet)
    state = sim.initial_state()
    g, c = case.grid, case.coeffs
    n = g.nx

    u = np.zeros(g.shape)
    v = np.zeros(g.shape)
    for _ in range(3):
        state, _ = sim._step(state)

        u, v = oracle.cavity_bc_loops(u, v, n, n, 1.0)
        us, vs = oracle.predictor_loops(u, v, g.dx, g.dy, c.dt, c.viscosity, n, n)
        b = oracle.source_loops(us, vs, g.dx, g.dy, c.dt, 1.0, n, n)
        from cfd_tpu.grid import optimal_omega

        p, _, _ = oracle.sor_eps_lexicographic(b, g.dx, optimal_omega(n), 1e-12, 30000, n, n)
        u, v = oracle.corrector_loops(us, vs, p, g.dx, g.dy, c.dt, 1.0, n, n,
                                      cavity_form=True, u_prev=u, v_prev=v)

    np.testing.assert_allclose(np.asarray(state.u), u, atol=1e-9)
    np.testing.assert_allclose(np.asarray(state.v), v, atol=1e-9)
    np.testing.assert_allclose(np.asarray(state.p), p, atol=1e-8)


def test_channel_step_matches_oracle_end_to_end():
    case = make_channel_case(nx=12, ny=8, final_time=0.1, tolerance_factor=1e-12, abs_tol=1e-13)
    sim = Simulation(case, log=quiet)
    state = sim.initial_state()
    g, c = case.grid, case.coeffs
    nx, ny = g.nx, g.ny
    from cfd_tpu.grid import optimal_omega

    omega = optimal_omega(nx, ny)
    u = np.zeros(g.shape)
    v = np.zeros(g.shape)
    p = np.zeros(g.shape)
    u, v = oracle.channel_bc_loops(u, v, nx, ny, 1.0)
    for _ in range(3):
        state, _ = sim._step(state)

        us, vs = oracle.predictor_loops(u, v, g.dx, g.dy, c.dt, c.viscosity, nx, ny)
        us, vs = oracle.channel_bc_loops(us, vs, nx, ny, 1.0)
        b = oracle.source_loops(us, vs, g.dx, g.dy, c.dt, 1.0, nx, ny, remove_mean=True)
        p, _, _ = oracle.sor_ghost_lexicographic(
            p, b, g.dx, g.dy, omega, 1e-12, 1e-13, 50000, nx, ny,
            lambda q: oracle.channel_pressure_ghosts_loops(q, nx, ny),
        )
        u, v = oracle.corrector_loops(us, vs, p, g.dx, g.dy, c.dt, 1.0, nx, ny,
                                      cavity_form=False)
        u, v = oracle.channel_bc_loops(u, v, nx, ny, 1.0)

    np.testing.assert_allclose(np.asarray(state.u), u, atol=1e-9)
    np.testing.assert_allclose(np.asarray(state.v), v, atol=1e-9)


def test_backwards_step_matches_oracle_end_to_end():
    case = make_backwards_step_case(nx=24, ny=12, final_time=0.1,
                                    tolerance_factor=1e-12, abs_tol=1e-13)
    sim = Simulation(case, log=quiet)
    state = sim.initial_state()
    g, c = case.grid, case.coeffs
    nx, ny = g.nx, g.ny
    inlet_j_max = int(1.0 / g.dy)
    from cfd_tpu.grid import optimal_omega

    omega = optimal_omega(nx, ny)
    f = g.fluid
    u = np.zeros(g.shape)
    v = np.zeros(g.shape)
    p = np.zeros(g.shape)
    u, v = oracle.step_bc_loops(u, v, nx, ny, 1.0, inlet_j_max, f)
    for _ in range(3):
        state, _ = sim._step(state)

        us, vs = oracle.predictor_loops(u, v, g.dx, g.dy, c.dt, c.viscosity, nx, ny, fluid=f)
        us, vs = oracle.step_bc_loops(us, vs, nx, ny, 1.0, inlet_j_max, f)
        b = oracle.source_loops(us, vs, g.dx, g.dy, c.dt, 1.0, nx, ny, fluid=f, remove_mean=True)
        p, _, _ = oracle.sor_ghost_lexicographic(
            p, b, g.dx, g.dy, omega, 1e-12, 1e-13, 50000, nx, ny,
            lambda q: oracle.step_pressure_ghosts_loops(q, nx, ny, f),
            fluid=f,
        )
        u, v = oracle.corrector_loops(us, vs, p, g.dx, g.dy, c.dt, 1.0, nx, ny,
                                      cavity_form=False, fluid=f, u_prev=u, v_prev=v)
        u, v = oracle.step_bc_loops(u, v, nx, ny, 1.0, inlet_j_max, f)

    np.testing.assert_allclose(np.asarray(state.u), u, atol=1e-9)
    np.testing.assert_allclose(np.asarray(state.v), v, atol=1e-9)


def test_projection_produces_divergence_free_field():
    """Channel case: away from the outlet column the projected field is
    divergence-free up to a uniform constant at the Poisson-tolerance level.

    Two intentional departures from pointwise div=0, both inherited from the
    reference scheme (its own binary plateaus at max(div)=2.17e-2,
    golden/channel/stdout.log): (a) the outlet zero-gradient BC overwrites
    the corrected face u[:, nx] (channel-01.cpp:520-523), injecting
    divergence in the last cell column; (b) mean-source removal
    (channel-01.cpp:620-628) shifts b by a constant, so div after correction
    equals (dt/rho)*mean uniformly. So we assert the *spread* of div over
    cells i in [1, nx-1] is at tolerance, i.e. div is constant there."""
    case = make_channel_case(nx=24, ny=8, final_time=1.0, tolerance_factor=1e-10,
                             abs_tol=1e-12)
    sim = Simulation(case, log=quiet)
    state = sim.run(n_steps=20)
    g, c = case.grid, case.coeffs
    u, v = np.asarray(state.u), np.asarray(state.v)
    div = (u[1:g.ny + 1, 1:g.nx + 1] - u[1:g.ny + 1, 0:g.nx]) / g.dx + (
        v[1:g.ny + 1, 1:g.nx + 1] - v[0:g.ny, 1:g.nx + 1]) / g.dy
    inner = div[:, : g.nx - 1]  # exclude outlet column
    assert inner.max() - inner.min() < 1e-8
    stats = sim.statistics(state)
    assert 0.0 < stats["avg_kinetic_energy"] < 1.0


def test_kinetic_energy_plateaus():
    """KE rises from rest and decelerates toward the steady state (the
    reference's de-facto regression signal, SURVEY.md section 4.2). The
    plateau is asymptotic, so assert deceleration — relative growth in the
    last window at least 10x below the first window — rather than a fixed
    small-change threshold that depends on exactly where the run stops."""
    case = make_cavity_case(n_interior=15, final_time=20.0)
    sim = Simulation(case, log=quiet)
    state = sim.initial_state()
    ke = []
    for _ in range(30):
        for _ in range(10):
            state, _ = sim._step(state)
        ke.append(sim.statistics(state)["avg_kinetic_energy"])
    assert ke[-1] > ke[0] > 0
    growth_first = (ke[1] - ke[0]) / ke[1]
    growth_last = (ke[-1] - ke[-2]) / ke[-1]
    assert 0 <= growth_last < growth_first / 10


def test_steps_per_call_matches_stepwise():
    """Chunked (lax.scan) execution reproduces the stepwise trajectory and
    diagnostics rows."""
    case = make_channel_case(nx=16, ny=8, final_time=1.0, print_interval=2)
    sim_a = Simulation(case, log=quiet)
    sim_b = Simulation(case, log=quiet)
    sa = sim_a.run(n_steps=6)
    sb = sim_b.run(n_steps=6, steps_per_call=2)
    np.testing.assert_array_equal(np.asarray(sa.u), np.asarray(sb.u))
    np.testing.assert_array_equal(np.asarray(sa.p), np.asarray(sb.p))
    assert [r["step"] for r in sim_a.history] == [r["step"] for r in sim_b.history]
    for ra, rb in zip(sim_a.history, sim_b.history):
        assert ra["poisson_iters"] == rb["poisson_iters"]
        assert ra["max_divergence"] == rb["max_divergence"]


def test_steps_per_call_must_divide_intervals():
    case = make_channel_case(nx=16, ny=8, final_time=1.0, print_interval=3)
    sim = Simulation(case, log=quiet)
    import pytest
    with pytest.raises(ValueError, match="steps_per_call"):
        sim.run(n_steps=6, steps_per_call=2)

def test_nondividing_steps_per_call_tail_keeps_diagnostics():
    """Leftover steps (steps_per_call not dividing the range) must still get
    stats rows / final-step bookkeeping and match the stepwise trajectory
    (round-1 gap: the tail loop skipped all diagnostics)."""
    case = make_channel_case(nx=16, ny=8, final_time=1.0, print_interval=2)
    sim_a = Simulation(case, log=quiet)
    sim_b = Simulation(case, log=quiet)
    sa = sim_a.run(n_steps=7)
    sb = sim_b.run(n_steps=7, steps_per_call=2)  # 3 chunks + 1 leftover step
    np.testing.assert_array_equal(np.asarray(sa.u), np.asarray(sb.u))
    np.testing.assert_array_equal(np.asarray(sa.p), np.asarray(sb.p))
    assert [r["step"] for r in sim_b.history] == [2, 4, 6, 7]
    for ra, rb in zip(sim_a.history, sim_b.history):
        assert ra["max_divergence"] == rb["max_divergence"]


def test_final_step_row_emitted_for_custom_n_steps():
    """`last` is based on the requested range, not case.total_steps: a short
    run still emits its final stats row (reference emits one at its own final
    step, cavity-01.cpp:393-400)."""
    case = make_channel_case(nx=16, ny=8, final_time=1.0, print_interval=100)
    sim = Simulation(case, log=quiet)
    sim.run(n_steps=3)
    assert [r["step"] for r in sim.history] == [3]


def test_sor_cap_warning_parity():
    """When the pressure solver hits its iteration cap, Simulation.run logs
    the reference's warn-and-continue message (cavity-01.cpp:681-684)."""
    lines = []
    case = make_cavity_case(n_interior=15, final_time=0.1, print_interval=1,
                            max_sor_iterations=3)
    sim = Simulation(case, log=lambda msg: lines.append(str(msg)))
    sim.run(n_steps=2)
    warnings = [l for l in lines if "did not converge" in l]
    assert warnings, f"expected SOR cap warning in {lines}"
    assert "3 iterations" in warnings[0]


def test_steps_per_call_must_divide_checkpoint_interval(tmp_path):
    from cfd_tpu.io.checkpoint import CheckpointManager
    case = make_channel_case(nx=16, ny=8, final_time=1.0, print_interval=2,
                             save_interval=2)
    sim = Simulation(case, log=quiet)
    sim.checkpointer = CheckpointManager(tmp_path, interval=3)
    import pytest
    with pytest.raises(ValueError, match="checkpoint"):
        sim.run(n_steps=6, steps_per_call=2)


@pytest.mark.parametrize("flavor", ["cavity", "channel", "step", "rb"])
def test_dt_step_with_traced_case_dt_matches_fixed_step(flavor):
    """make_dt_step(case)(state, dt), dt traced into the jitted step (the
    adaptive path), equals the fixed-dt step when dt is the case's own."""
    import jax

    from cfd_tpu.physics.boussinesq import make_rayleigh_benard_case
    from cfd_tpu.solver import make_dt_step, make_step

    case = {
        "cavity": lambda: make_cavity_case(n_interior=32, poisson="multigrid",
                                           final_time=1.0),
        "channel": lambda: make_channel_case(nx=48, ny=16,
                                             poisson="multigrid",
                                             final_time=1.0),
        "step": lambda: make_backwards_step_case(nx=64, ny=16,
                                                 poisson="multigrid",
                                                 final_time=1.0),
        "rb": lambda: make_rayleigh_benard_case(nx=48, ny=16, rayleigh=1e5,
                                                dtype=jnp.float64),
    }[flavor]()
    state = Simulation(case, log=quiet).initial_state()
    fixed = jax.jit(make_step(case))
    traced = jax.jit(make_dt_step(case))
    want, got = state, state
    for _ in range(3):
        want, dw = fixed(want)
        got, dg = traced(got, jnp.asarray(case.dt, case.dtype))
        assert int(dg.poisson_iters) == int(dw.poisson_iters)
    for name in ("u", "v", "p", "T"):
        a = getattr(want, name)
        if a is not None:
            np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                       np.asarray(a), rtol=0,
                                       atol=1e-12 * max(1.0, float(
                                           np.abs(np.asarray(a)).max())),
                                       err_msg=name)
