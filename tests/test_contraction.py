"""Solver-efficiency regression guards.

Floor-terminated f32 solves of differently-compiled programs legitimately
exit cycles apart, so cycle counts alone leave convergence-RATE drift
invisible to CI. These tests pin two deterministic signals, both immune to
floor-termination noise:

1. Per-flavor asymptotic V-cycle contraction factors on a fixed seeded
   source in f64 (no roundoff floor in range), cycle-by-cycle via
   ``max_cycles=1`` (no stall detector in the loop), asserted against the
   measured value + margin.  A 25% cycle-count regression means the
   per-cycle factor rho worsens to rho**0.8, which every bound here
   catches (e.g. cavity 0.13 -> 0.196 > 0.17).

2. A stall-detector honesty guard: a production-config f32 channel solve
   must terminate within a small factor of the TRUE floor residual that a
   stall-free reference run reaches.  The round-3 bug (stall_ratio=0.7
   mistaking a mid-solve plateau for the floor, exiting at 7.5e4x
   tolerance) fails this by four orders of
   magnitude.

Measured factors (this machine, f64, seeds below; geometric mean over
cycles 2..N):

    cavity   V(2,2) 128^2      0.131   (mesh-independent, round-1 band
                                        0.12-0.16)
    channel  V(1,2) 192x64 sq  0.238   (384x128: 0.270 — bound covers both)
    neumann  V(2,1) 128^2      0.104   (the Rayleigh-Benard flavor)
    step     V(1,2) 256x32 dc  0.308   (monotone, with the _solid_fill
                                        mask-aware prolongation; the
                                        pre-fill mask-blind transfer
                                        oscillated 0.39-0.65/cycle around
                                        a 0.475 geomean — the
                                        barely-contracting masked mode)

Reference anchor for the step bound: the capped SOR loop it must dominate,
/root/reference/backwards_step-01.cpp:872-939.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from cfd_tpu.bc import step_pressure_ghosts
from cfd_tpu.cases import make_backwards_step_case
from cfd_tpu.poisson import multigrid as M


def rand_b(shape, seed):
    rng = np.random.default_rng(seed)
    b = np.zeros(shape)
    b[1:-1, 1:-1] = rng.standard_normal((shape[0] - 2, shape[1] - 2))
    return jnp.asarray(b)


def geomean_factor(solve1, b, p0, n_cycles, skip=1):
    """Geometric-mean residual contraction over cycles ``skip+1 .. n_cycles``
    (cycle-by-cycle warm restarts; max_cycles=1 keeps the stall detector
    out of the measurement)."""
    p = p0
    hist = []
    for _ in range(n_cycles):
        p, _, res = solve1(p, b)
        hist.append(float(res))
    logs = [math.log(hist[i + 1] / hist[i]) for i in range(skip, len(hist) - 1)]
    return math.exp(sum(logs) / len(logs))


CFG1 = dict(tol_factor=0.0, max_cycles=1)


@pytest.mark.parametrize(
    "name,factory,cfg_kw,seed,bound",
    [
        # production cavity default V(2,2); measured 0.131
        ("cavity", lambda: M.cavity_problem(128, 128, 1 / 128, 1 / 128),
         {}, 2, 0.17),
        # production channel default V(1,2), square spacing; measured 0.238
        ("channel", lambda: M.channel_problem(192, 64, 3 / 192, 1 / 64),
         dict(pre_sweeps=1, post_sweeps=2), 1, 0.30),
        # Rayleigh-Benard flavor: pure Neumann + pin_mean, V(2,1); 0.104
        ("neumann", lambda: M.neumann_problem(128, 128, 1 / 128, 1 / 128),
         dict(pre_sweeps=2, post_sweeps=1, pin_mean=True), 3, 0.15),
    ],
)
def test_separable_contraction_factor(name, factory, cfg_kw, seed, bound):
    problem = factory()
    cfg = M.MGConfig(**CFG1, **cfg_kw)
    kw = {"n_interior": problem.nx * problem.ny} if cfg.pin_mean else {}
    solve1 = M.make_multigrid_poisson(problem, cfg, jnp.float64, **kw)
    b = np.array(rand_b((problem.ny + 2, problem.nx + 2), seed))
    if cfg.pin_mean:
        b[1:-1, 1:-1] -= b[1:-1, 1:-1].mean()  # compatible RHS
    factor = geomean_factor(solve1, jnp.asarray(b),
                            jnp.zeros_like(jnp.asarray(b)), n_cycles=8)
    assert factor <= bound, (name, factor)


def test_masked_step_contraction_factor():
    """Defect-correction masked hierarchy at the reference geometry
    (256x32, step at i=64), with the mask-aware solid-fill prolongation:
    measured geomean 0.308 (monotone), bound 0.36 — a 25% cycle
    regression (0.308**0.8 = 0.39) fails it, and so does losing the
    solid fill (0.475 oscillating without it)."""
    case = make_backwards_step_case(nx=256, ny=32, poisson="sor")
    g, c = case.grid, case.coeffs
    cfg = M.MGConfig(**CFG1, pre_sweeps=1, post_sweeps=2)
    solve1 = M.make_masked_multigrid_poisson(g, c, cfg,
                                             step_pressure_ghosts(g),
                                             jnp.float64)
    rng = np.random.default_rng(5)
    b = jnp.asarray(np.where(g.fluid, rng.standard_normal(g.shape), 0.0))
    b = b - jnp.where(jnp.asarray(np.asarray(g.fluid)),
                      jnp.sum(b) / g.n_fluid, 0.0)
    factor = geomean_factor(solve1, b, jnp.zeros(g.shape), n_cycles=12)
    assert factor <= 0.36, factor


def test_stall_exit_terminates_near_true_floor_f32():
    """The guard that would have caught the round-3 stall bug: the
    production-config f32 channel solve (V(1,2), stall detection ACTIVE)
    must stop within a small factor of the residual a stall-free run of
    the same program reaches.  A false stall exit leaves the residual
    orders of magnitude above the floor (round 3: 7.5e4x tolerance)."""
    nx, ny = 384, 128
    problem = M.channel_problem(nx, ny, 3 / nx, 1 / ny)
    b = rand_b((ny + 2, nx + 2), 7).astype(jnp.float32)
    common = dict(tol_factor=1e-6, abs_tol=0.0, pre_sweeps=1, post_sweeps=2)
    solve = M.make_multigrid_poisson(problem, M.MGConfig(**common),
                                     jnp.float32)
    p, iters, res = solve(jnp.zeros_like(b), b)
    # stall-free reference: same config, detector disabled, generous cap
    ref = M.make_multigrid_poisson(
        problem, M.MGConfig(**common, stall_ratio=1e9, max_cycles=60),
        jnp.float32)
    _, _, res_floor = ref(jnp.zeros_like(b), b)
    tol = 1e-6 * float(jnp.max(jnp.abs(b)))
    assert float(res) <= max(tol, 3.0 * float(res_floor)), (
        float(res), float(res_floor), tol)
    # and it must actually do work, not exit on the first plateau
    assert int(iters) >= 4, int(iters)
