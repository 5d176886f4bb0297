"""Geometric multigrid: convergence rates, SOR agreement, case integration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfd_tpu.bc import channel_pressure_ghosts
from cfd_tpu.cases import make_cavity_case, make_channel_case
from cfd_tpu.grid import Grid, optimal_omega
from cfd_tpu.ops.stencil import StencilCoeffs
from cfd_tpu.poisson.multigrid import (
    MGConfig,
    cavity_problem,
    channel_problem,
    coarsen_problem,
    make_multigrid_poisson,
    mg_compatible,
    neumann_problem,
)
from cfd_tpu.poisson.sor import SORConfig, make_eps_neumann_poisson, make_ghost_poisson


def quiet(*a, **k):
    pass


def random_source(n, seed=0):
    rng = np.random.default_rng(seed)
    b = np.zeros((n + 2, n + 2))
    b[1 : n + 1, 1 : n + 1] = rng.standard_normal((n, n))
    return jnp.asarray(b)


@pytest.mark.parametrize("flavor", [cavity_problem, channel_problem])
def test_vcycle_convergence_factor_is_mesh_independent(flavor):
    """Asymptotic V(2,2) factor stays below 0.25 at 64 and 128 (textbook MG;
    a transfer-order or boundary-consistency bug shows up as >0.8 or
    divergence — see coarsen_problem docstring)."""
    for n in (64, 128):
        b = random_source(n)
        solve1 = make_multigrid_poisson(flavor(n, n, 1.0 / n, 1.0 / n),
                                        MGConfig(tol_factor=0.0, max_cycles=1),
                                        jnp.float64)
        p = jnp.zeros_like(b)
        hist = []
        for _ in range(10):
            p, _, res = solve1(p, b)
            hist.append(float(res))
        factor = hist[-1] / hist[-2]
        assert factor < 0.25, (n, factor)


def test_mg_matches_sor_cavity_flavor():
    n = 64
    b = random_source(n)
    dx = 1.0 / n
    mg = make_multigrid_poisson(cavity_problem(n, n, dx, dx),
                                MGConfig(tol_factor=1e-11), jnp.float64)
    p_mg, cycles, res = mg(jnp.zeros_like(b), b)
    grid = Grid.regular(n, n)
    coeffs = StencilCoeffs(dx=dx, dy=dx, dt=1.0, viscosity=1.0)
    sor = make_eps_neumann_poisson(
        grid, coeffs, SORConfig(omega=optimal_omega(n), tol_factor=1e-11,
                                max_iters=100000))
    p_sor, _, _ = sor(b, b)
    sl = np.s_[1 : n + 1, 1 : n + 1]
    np.testing.assert_allclose(np.asarray(p_mg)[sl], np.asarray(p_sor)[sl],
                               atol=1e-9)
    assert int(cycles) <= 15


def test_mg_matches_sor_channel_flavor():
    n = 64
    b = random_source(n)
    dx = 1.0 / n
    mg = make_multigrid_poisson(channel_problem(n, n, dx, dx),
                                MGConfig(tol_factor=1e-11), jnp.float64)
    p_mg, _, _ = mg(jnp.zeros_like(b), b)
    grid = Grid.regular(n, n)
    coeffs = StencilCoeffs(dx=dx, dy=dx, dt=1.0, viscosity=1.0)
    sor = make_ghost_poisson(
        grid, coeffs,
        SORConfig(omega=optimal_omega(n, n), tol_factor=1e-11, abs_tol=0.0,
                  max_iters=200000),
        channel_pressure_ghosts(grid))
    p_sor, _, _ = sor(jnp.zeros_like(b), b)
    sl = np.s_[1 : n + 1, 1 : n + 1]  # ghost rings differ by convention
    np.testing.assert_allclose(np.asarray(p_mg)[sl], np.asarray(p_sor)[sl],
                               atol=1e-9)


def test_pure_neumann_with_mean_pinning_converges():
    n = 32
    b = np.array(random_source(n))  # writable host copy
    b[1 : n + 1, 1 : n + 1] -= b[1 : n + 1, 1 : n + 1].mean()  # compatible
    mg = make_multigrid_poisson(neumann_problem(n, n, 1.0 / n, 1.0 / n),
                                MGConfig(tol_factor=1e-9, pin_mean=True),
                                jnp.float64, n_interior=n * n)
    p, cycles, res = mg(jnp.zeros((n + 2, n + 2)), jnp.asarray(b))
    assert float(res) <= 1e-9 * np.abs(b).max()
    # mean-pinned: interior mean ~ 0
    assert abs(float(jnp.sum(p)) / (n * n)) < 1e-10


def test_coarsening_preserves_boundary_encoding():
    p = channel_problem(16, 16, 1 / 16, 1 / 16)
    c = coarsen_problem(p)
    assert c.nx == 8 and c.dx == 2 / 16
    # Neumann walls stay 0
    assert c.wW[1:9, 1].max() == 0.0
    assert c.wN[8, 1:9].max() == 0.0
    # Dirichlet outlet strengthened by the consistent-pin rule 1 -> 4/3
    np.testing.assert_allclose(c.wE[1:9, 8], 4.0 / 3.0)
    # interior couplings stay 1
    assert c.wE[4, 4] == 1.0


def test_mg_compatible():
    assert mg_compatible(128, 64)
    assert not mg_compatible(63, 63)
    assert not mg_compatible(6, 6)


def test_cavity_case_multigrid_matches_sor_end_to_end():
    """Same physics through the full projection step with either solver."""
    from cfd_tpu.solver import Simulation

    n = 32
    kw = dict(n_interior=n, final_time=1.0, tolerance_factor=1e-11)
    sim_sor = Simulation(make_cavity_case(poisson="sor", **kw), log=quiet)
    sim_mg = Simulation(make_cavity_case(poisson="multigrid", **kw), log=quiet)
    s1 = sim_sor.initial_state()
    s2 = sim_mg.initial_state()
    for _ in range(5):
        s1, _ = sim_sor._step(s1)
        s2, _ = sim_mg._step(s2)
    np.testing.assert_allclose(np.asarray(s1.u), np.asarray(s2.u), atol=1e-10)
    np.testing.assert_allclose(np.asarray(s1.v), np.asarray(s2.v), atol=1e-10)


def test_channel_case_multigrid_matches_sor_end_to_end():
    from cfd_tpu.solver import Simulation

    kw = dict(nx=32, ny=16, final_time=1.0, tolerance_factor=1e-11, abs_tol=1e-13)
    sim_sor = Simulation(make_channel_case(poisson="sor", **kw), log=quiet)
    sim_mg = Simulation(make_channel_case(poisson="multigrid", **kw), log=quiet)
    s1 = sim_sor.initial_state()
    s2 = sim_mg.initial_state()
    for _ in range(5):
        s1, _ = sim_sor._step(s1)
        s2, _ = sim_mg._step(s2)
    np.testing.assert_allclose(np.asarray(s1.u), np.asarray(s2.u), atol=1e-10)
    np.testing.assert_allclose(np.asarray(s1.v), np.asarray(s2.v), atol=1e-10)


def test_masked_multigrid_matches_masked_sor_backwards_step():
    """Defect-correction masked MG and masked SOR share the exact operator's
    fixed point (step geometry)."""
    import jax.numpy as jnp
    from cfd_tpu.bc import step_pressure_ghosts
    from cfd_tpu.cases import make_backwards_step_case
    from cfd_tpu.poisson.multigrid import make_masked_multigrid_poisson

    case = make_backwards_step_case(nx=64, ny=16, final_time=1.0,
                                    tolerance_factor=1e-11, abs_tol=1e-12,
                                    poisson="sor")
    g, c = case.grid, case.coeffs
    mg = make_masked_multigrid_poisson(
        g, c, MGConfig(tol_factor=1e-11, abs_tol=1e-12),
        step_pressure_ghosts(g), jnp.float64)
    rng = np.random.default_rng(0)
    b = jnp.asarray(np.where(g.fluid, rng.standard_normal(g.shape), 0.0))
    p_mg, cycles, res = mg(jnp.zeros(g.shape), b)
    p_sor, _, _ = case.poisson_solve(jnp.zeros(g.shape), b)
    fl = np.asarray(g.fluid)
    assert np.abs(np.asarray(p_mg - p_sor))[fl].max() < 1e-8
    assert int(cycles) <= 40


def test_backwards_step_case_multigrid_matches_sor_end_to_end():
    from cfd_tpu.cases import make_backwards_step_case
    from cfd_tpu.solver import Simulation

    kw = dict(nx=64, ny=16, final_time=1.0, tolerance_factor=1e-11,
              abs_tol=1e-12)
    sim_sor = Simulation(make_backwards_step_case(poisson="sor", **kw), log=quiet)
    sim_mg = Simulation(make_backwards_step_case(poisson="multigrid", **kw), log=quiet)
    s1 = sim_sor.initial_state()
    s2 = sim_mg.initial_state()
    for _ in range(5):
        s1, _ = sim_sor._step(s1)
        s2, _ = sim_mg._step(s2)
    np.testing.assert_allclose(np.asarray(s1.u), np.asarray(s2.u), atol=1e-9)
    np.testing.assert_allclose(np.asarray(s1.v), np.asarray(s2.v), atol=1e-9)


@pytest.mark.slow
def test_stall_exit_survives_midsolve_plateau_channel_1536x512():
    """Regression: the production channel bench config (1536x512 f32,
    V(2,1)) contracts the step-1 residual by only ~0.84 between cycles 1
    and 2 (a transient plateau from the sharp inlet-layer source), then
    resumes at ~0.3-0.5/cycle down to the f32 floor.  The original
    stall_ratio=0.7 mistook that plateau for the roundoff floor, exited
    with res ~7.5e4x tolerance, and the unprojected velocity blew up the
    run within ~70 steps (NaN).  The 0.9 default must ride through the
    plateau and reach the floor (res ~7.5e3 here, vs 1.5e6 at the false
    exit)."""
    from cfd_tpu.ops.stencil import poisson_source, predictor
    from cfd_tpu.poisson.multigrid import channel_problem
    from cfd_tpu.solver import Simulation

    nx, ny = 1536, 512
    case = make_channel_case(nx=nx, ny=ny, poisson="multigrid",
                             tolerance_factor=1e-6, abs_tol=0.0,
                             dtype=jnp.float32)
    g, c = case.grid, case.coeffs
    sim = Simulation(case, log=quiet)
    st = sim.initial_state()
    us, vs = predictor(st.u, st.v, c, jnp.asarray(g.u_valid_mask),
                       jnp.asarray(g.v_valid_mask))
    us, vs = case.velocity_bc(us, vs)
    b = poisson_source(us, vs, c, jnp.asarray(g.cell_mask),
                       remove_mean=True, n_cells=nx * ny)
    # V(2,1) — the configuration where the plateau appears
    cfg = MGConfig(tol_factor=1e-6, abs_tol=0.0, post_sweeps=1)
    solve = make_multigrid_poisson(channel_problem(nx, ny, g.dx, g.dy),
                                   cfg, dtype=jnp.float32)
    p, iters, res = solve(jnp.zeros_like(b), b)
    # false exit: iters=2, res=1.5e6; true floor: ~7.5e3 after ~7 cycles
    assert int(iters) >= 4, int(iters)
    assert float(res) < 1e5, float(res)
