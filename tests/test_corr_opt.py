"""MGConfig.corr_opt — line-searched coarse-grid correction steplength on
the masked defect-correction hierarchies.

The masked coarse operator is a non-Galerkin approximation (Neumann-through-
solids weights) of the exact fine operator
(/root/reference/backwards_step-01.cpp:685-739 ghost semantics), so the
correction amplitude along the slowest mode is systematically off; scaling by
alpha = <rc, A1 ec>/<A1 ec, A1 ec> cannot move the fixed point (the update is
residual-driven) but improves the contraction rate. These tests pin the
fixed-point invariance, the cycle-count direction, and the loud guards on
paths that don't take the knob."""

import jax.numpy as jnp
import numpy as np
import pytest

from cfd_tpu.bc import step_pressure_ghosts
from cfd_tpu.cases import make_backwards_step_case
from cfd_tpu.poisson import multigrid as M


def _rand_b(g, dtype, seed=0, zero_mean=False):
    rng = np.random.default_rng(seed)
    inter = np.asarray(g.cell_mask)
    b = jnp.asarray(np.where(inter, rng.standard_normal(g.shape), 0), dtype)
    if zero_mean:
        b = b - jnp.where(jnp.asarray(inter), jnp.sum(b) / g.n_fluid, 0.0)
    return b


def test_corr_opt_same_fixed_point_and_not_slower():
    """corr_opt converges to the masked SOR fixed point (the exact
    operator's solution) and does not cost cycles on the step geometry."""
    case = make_backwards_step_case(nx=64, ny=16, final_time=1.0,
                                    tolerance_factor=1e-11, abs_tol=1e-12,
                                    poisson="sor")
    g, c = case.grid, case.coeffs
    cfg = M.MGConfig(tol_factor=1e-11, abs_tol=1e-12)
    mk = lambda cf: M.make_masked_multigrid_poisson(
        g, c, cf, step_pressure_ghosts(g), jnp.float64)
    b = _rand_b(g, jnp.float64)
    p_off, it_off, _ = mk(cfg)(jnp.zeros(g.shape), b)
    import dataclasses

    p_on, it_on, _ = mk(dataclasses.replace(cfg, corr_opt=True))(
        jnp.zeros(g.shape), b)
    p_sor, _, _ = case.poisson_solve(jnp.zeros(g.shape), b)
    fl = np.asarray(g.fluid)
    assert np.abs(np.asarray(p_on - p_sor))[fl].max() < 1e-8
    assert int(it_on) <= int(it_off) + 1


def test_corr_opt_guards():
    """Separable hierarchies (the factories and the plain builder) reject
    corr_opt loudly; the masked builder takes it."""
    from cfd_tpu.cases import make_cavity_case

    with pytest.raises(ValueError, match="corr_opt"):
        make_cavity_case(n_interior=32, poisson="multigrid",
                         mg_overrides={"corr_opt": True})
    cfg = M.MGConfig(tol_factor=1e-5, corr_opt=True)
    prob = M.cavity_problem(32, 32, 1 / 32, 1 / 32)
    with pytest.raises(ValueError, match="corr_opt"):
        M.make_multigrid_poisson(prob, cfg)
    case = make_backwards_step_case(nx=64, ny=16, dtype=jnp.float32,
                                    poisson="multigrid",
                                    tolerance_factor=1e-5,
                                    mg_overrides={"corr_opt": True})
    b = _rand_b(case.grid, jnp.float32)
    p, it, res = case.poisson_solve(jnp.zeros(case.grid.shape, jnp.float32), b)
    assert np.isfinite(np.asarray(p)).all() and int(it) >= 1
