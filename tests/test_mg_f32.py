"""The float32 multigrid path, which the GPU runs, against the loop oracles
(tests/oracle.py) and against the float64 path: smoothing pairs, residual
and transfers at every operator flavor and at coarsened levels, whole
solves, and step trajectories of the four flavors at the sizes the fused
kernels used to be tested at."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from cfd_tpu.cases import (make_backwards_step_case, make_cavity_case,
                           make_channel_case, make_rayleigh_benard_case)
from cfd_tpu.poisson import multigrid as M
from cfd_tpu.solver import Simulation

FLAVORS = {"cavity": M.cavity_problem, "channel": M.channel_problem,
           "neumann": M.neumann_problem}
# (nx, ny, coarsenings): interior shapes, square and not, plus coarsened
# levels, whose edge couplings are fractional (4/3, 8/5, ...)
SHAPES = [(16, 16, 0), (24, 10, 0), (32, 32, 1), (64, 32, 2)]


def _problem(flavor, nx, ny, coarsen):
    prob = FLAVORS[flavor](nx, ny, 1.0 / nx, 1.0 / ny)
    for _ in range(coarsen):
        prob = M.coarsen_problem(prob)
    return prob


def _fields(prob, seed=0):
    rng = np.random.default_rng(seed)
    inter = M._interior_mask(prob.nx, prob.ny)
    p = np.where(inter, rng.standard_normal(inter.shape), 0.0)
    b = np.where(inter, rng.standard_normal(inter.shape), 0.0)
    return p, b


def _scale(prob, p):
    """Size of the terms a residual subtracts: its rounding scale."""
    return 2 * (1 / prob.dx ** 2 + 1 / prob.dy ** 2) * np.abs(p).max()


@pytest.mark.parametrize("n_pairs", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_f32_smoothing_pairs_match_oracle(flavor, shape, n_pairs):
    prob = _problem(flavor, *shape)
    lv = M._build_level(prob, jnp.float32)
    p, b = _fields(prob)
    interior, red, _ = M._inline_masks(lv)
    inv = M._inv_diag(lv, interior)

    @jax.jit
    def pairs(p, b):
        for _ in range(n_pairs):
            p = M._smooth(lv, p, b, 1.0, red, inv)
            p = M._smooth(lv, p, b, 1.0, interior & ~red, inv)
        return p

    got = np.asarray(pairs(jnp.asarray(p, jnp.float32),
                           jnp.asarray(b, jnp.float32)))
    want = oracle.rb_pairs_loops(p, b, prob.wE, prob.wW, prob.wN, prob.wS,
                                 lv.idx2, lv.idy2, 1.0, n_pairs, prob.nx,
                                 prob.ny)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_f32_residual_matches_oracle(flavor, shape):
    prob = _problem(flavor, *shape)
    lv = M._build_level(prob, jnp.float32)
    p, b = _fields(prob, seed=1)
    got = np.asarray(jax.jit(lambda p, b: M._residual(lv, p, b))(
        jnp.asarray(p, jnp.float32), jnp.asarray(b, jnp.float32)))
    want = oracle.residual_loops(p, b, prob.wE, prob.wW, prob.wN, prob.wS,
                                 lv.idx2, lv.idy2, prob.nx, prob.ny)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * _scale(prob, p))


@pytest.mark.parametrize("shape", [(16, 16), (24, 10), (64, 32), (8, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_f32_transfers_match_oracle(shape):
    nx, ny = shape
    fine = M.cavity_problem(nx, ny, 1 / nx, 1 / ny)
    coarse = M.coarsen_problem(fine)
    lf, lc = (M._build_level(q, jnp.float32) for q in (fine, coarse))
    r, e = _fields(fine, seed=2)
    rc = np.asarray(M._restrict(lf, lc, jnp.asarray(r, jnp.float32)))
    np.testing.assert_allclose(rc, oracle.restrict_loops(r, coarse.nx,
                                                         coarse.ny),
                               rtol=0, atol=1e-6)
    ec = oracle.restrict_loops(e, coarse.nx, coarse.ny)
    ef = np.asarray(M._prolong(lc, lf, jnp.asarray(ec, jnp.float32)))
    np.testing.assert_allclose(ef, oracle.prolong_loops(ec, coarse.nx,
                                                        coarse.ny),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(32, 32), (64, 32), (48, 16), (128, 64)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_f32_solve_matches_f64(flavor, shape):
    """A float32 V-cycle solve to 1e-5 of max|b| lands on the float64
    solution (1e-10) to the float32 tolerance's accuracy. Square cells, as
    every case has (a point smoother does not contract strongly
    anisotropic cells)."""
    nx, ny = shape
    prob = FLAVORS[flavor](nx, ny, 1.0 / ny, 1.0 / ny)
    _, b = _fields(prob, seed=3)
    pin = flavor == "neumann"
    if pin:  # pure Neumann: a compatible (mean-free) source
        b = np.where(M._interior_mask(nx, ny), b - b[1:-1, 1:-1].mean(), 0.0)
    cfg = M.MGConfig(tol_factor=1e-5, pin_mean=pin, post_sweeps=1)
    solve32 = jax.jit(M.make_multigrid_poisson(prob, cfg, jnp.float32))
    solve64 = jax.jit(M.make_multigrid_poisson(
        prob, dataclasses.replace(cfg, tol_factor=1e-10), jnp.float64))
    p32, it32, res32 = solve32(jnp.zeros(prob.shape, jnp.float32),
                               jnp.asarray(b, jnp.float32))
    p64, _, _ = solve64(jnp.zeros(prob.shape), jnp.asarray(b))
    assert float(res32) <= 1e-5 * np.abs(b).max()
    assert 1 <= int(it32) < cfg.max_cycles
    p64 = np.asarray(p64)
    np.testing.assert_allclose(np.asarray(p32), p64, rtol=0,
                               atol=1e-3 * np.abs(p64).max())


STEP_CASES = {
    "cavity32": lambda dt: make_cavity_case(
        n_interior=32, poisson="multigrid", dtype=dt, tolerance_factor=1e-6),
    "cavity48": lambda dt: make_cavity_case(
        n_interior=48, poisson="multigrid", dtype=dt, tolerance_factor=1e-6),
    "cavity64": lambda dt: make_cavity_case(
        n_interior=64, poisson="multigrid", dtype=dt, tolerance_factor=1e-6),
    "channel32x16": lambda dt: make_channel_case(
        nx=32, ny=16, poisson="multigrid", dtype=dt, tolerance_factor=1e-6,
        abs_tol=0.0),
    "channel64x32": lambda dt: make_channel_case(
        nx=64, ny=32, poisson="multigrid", dtype=dt, tolerance_factor=1e-6,
        abs_tol=0.0),
    "channel96x32": lambda dt: make_channel_case(
        nx=96, ny=32, poisson="multigrid", dtype=dt, tolerance_factor=1e-6,
        abs_tol=0.0),
    "step64x16": lambda dt: make_backwards_step_case(
        nx=64, ny=16, poisson="multigrid", dtype=dt, tolerance_factor=1e-6,
        abs_tol=0.0),
    "step64x32": lambda dt: make_backwards_step_case(
        nx=64, ny=32, poisson="multigrid", dtype=dt, tolerance_factor=1e-6,
        abs_tol=0.0),
    "step48x24": lambda dt: make_backwards_step_case(
        nx=48, ny=24, poisson="multigrid", dtype=dt, tolerance_factor=1e-6,
        abs_tol=0.0),
    "rb48x16": lambda dt: make_rayleigh_benard_case(
        nx=48, ny=16, rayleigh=1e5, dtype=dt, tolerance_factor=1e-6,
        abs_tol=0.0),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_f32_trajectory_matches_f64(name):
    """Five float32 steps of each flavor follow the float64 trajectory from
    the same initial state (RB's seeded noise differs by dtype): both solve
    each step to 1e-6 of max|b|; float32 rounding adds the rest."""
    runs = {}
    init = Simulation(STEP_CASES[name](jnp.float64),
                      log=lambda *a: None).initial_state()
    for dt in (jnp.float32, jnp.float64):
        sim = Simulation(STEP_CASES[name](dt), log=lambda *a: None)
        st = jax.tree.map(lambda x: x.astype(dt), init)
        for _ in range(5):
            st, _ = sim._step(st)
        runs[dt] = st
    for field in ("u", "v", "p", "T"):
        a = getattr(runs[jnp.float64], field)
        if a is None:
            continue
        a = np.asarray(a)
        b = np.asarray(getattr(runs[jnp.float32], field))
        assert np.isfinite(b).all(), field
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-3 * max(1.0, np.abs(a).max()),
                                   err_msg=field)


@pytest.mark.parametrize("flavor", ["cavity32", "channel32x16", "step64x16",
                                    "rb48x16"])
def test_f32_checkpoint_resume_bitwise(flavor, tmp_path):
    """The state a step carries is the logical one, so a checkpoint resumes
    bitwise onto the uninterrupted float32 trajectory."""
    from cfd_tpu.io.checkpoint import CheckpointManager

    case = dataclasses.replace(STEP_CASES[flavor](jnp.float32),
                               print_interval=2, save_interval=2)
    want = Simulation(case, log=lambda *a: None).run(n_steps=4)
    sim = Simulation(case, log=lambda *a: None)
    sim.checkpointer = CheckpointManager(tmp_path, interval=2)
    sim.run(n_steps=2)
    restored, k = CheckpointManager(tmp_path, interval=2).restore_latest(case)
    got = Simulation(case, log=lambda *a: None).run(
        state=restored, n_steps=2, start_step=k)
    for field in ("u", "v", "p", "T", "p_prev"):
        a = getattr(want, field)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                          np.asarray(a), err_msg=field)


@pytest.mark.parametrize("factory,sweeps", [
    (lambda: make_cavity_case(n_interior=32, poisson="multigrid"), (2, 1)),
    (lambda: make_rayleigh_benard_case(nx=48, ny=16), (2, 1)),
    (lambda: make_channel_case(nx=64, ny=32, poisson="multigrid"), (1, 2)),
    (lambda: make_backwards_step_case(nx=64, ny=16, poisson="multigrid"),
     (1, 2)),
], ids=["cavity", "rb", "channel", "step"])
def test_factory_sweep_defaults(factory, sweeps):
    """Each flavor's factory default sweeps, V(2,1) for cavity and RB and
    V(1,2) for channel and step, on every dtype and platform; overrides
    still win."""
    mg = factory().info["mg"]
    assert (mg.pre_sweeps, mg.post_sweeps) == sweeps


def test_factory_sweep_override():
    case = make_channel_case(nx=64, ny=32, poisson="multigrid",
                             mg_overrides={"post_sweeps": 3})
    assert (case.info["mg"].pre_sweeps, case.info["mg"].post_sweeps) == (1, 3)


def test_rb_extrapolated_warm_start_matches_plain():
    """The 2p - p_prev warm start changes the first guess only: both runs
    reach the same state to the solver tolerance."""
    kw = dict(nx=48, ny=16, rayleigh=1e5, dtype=jnp.float64,
              tolerance_factor=1e-10, abs_tol=0.0)
    runs = []
    for extrap in (False, True):
        sim = Simulation(make_rayleigh_benard_case(
            extrapolate_warm_start=extrap, **kw), log=lambda *a: None)
        st = sim.initial_state()
        for _ in range(4):
            st, _ = sim._step(st)
        runs.append(st)
    for field in ("u", "v", "T"):
        np.testing.assert_allclose(np.asarray(getattr(runs[1], field)),
                                   np.asarray(getattr(runs[0], field)),
                                   rtol=0, atol=1e-8)


def test_coarse_solve_runs_at_highest_precision():
    """The coarsest solve's float32 matmul asks for HIGHEST precision (the
    GPU would otherwise be free to run it in TF32)."""
    prob = M.cavity_problem(32, 32, 1 / 32, 1 / 32)
    solve = M.make_multigrid_poisson(prob, M.MGConfig(), jnp.float32)
    z = jnp.zeros(prob.shape, jnp.float32)
    text = str(jax.make_jaxpr(solve)(z, z))
    assert "dot_general" in text and "HIGHEST" in text


@pytest.mark.gpu
def test_one_v_cycle_is_float32_accurate_on_gpu():
    """On the GPU one float32 V-cycle, coarsest solve included, stays within
    float32 rounding of the float64 cycle: a TF32 matmul in the coarsest
    solve (10-bit mantissa) would put the gap near 1e-3."""
    prob = M.cavity_problem(64, 64, 1 / 64, 1 / 64)
    _, b = _fields(prob, seed=4)
    cfg = M.MGConfig(max_cycles=1, post_sweeps=1)
    got, want = (np.asarray(jax.jit(M.make_multigrid_poisson(prob, cfg, dt))(
        jnp.zeros(prob.shape, dt), jnp.asarray(b, dt))[0], np.float64)
        for dt in (jnp.float32, jnp.float64))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
