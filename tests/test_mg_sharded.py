"""Explicit sharded multigrid (parallel.mg_sharded) vs the single-device
solver: same cycle counts, (near-)bitwise iterates, on the 8-device CPU mesh.

Sharded == single-device multigrid equivalence at >= 256^2 with identical cycle counts, including a hierarchy
that exercises the coarse switch (all_gather + replicated tail)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from cfd_tpu.cases.cavity import make_cavity_case
from cfd_tpu.parallel.mesh import make_mesh
from cfd_tpu.parallel.mg_sharded import make_local_mg_solve
from cfd_tpu.parallel.sharded import ShardedCavity, _shard_map
from cfd_tpu.poisson import multigrid as M
from cfd_tpu.solver import Simulation

pytestmark = pytest.mark.skipif(
    len(jax.devices("cpu")) < 8, reason="needs 8 virtual CPU devices")


def quiet(*a, **k):
    pass


def _sharded_solve(problem, cfg, mesh, guess, b, dtype):
    """Run make_local_mg_solve over the mesh on interior-shaped global
    arrays, returning (p_padded, cycles, res) as host values."""
    mdy, mdx = mesh.shape["dy"], mesh.shape["dx"]
    solve = make_local_mg_solve(problem, cfg, (mdy, mdx), dtype)

    def body(guess_l, b_l):
        jy = jax.lax.axis_index("dy")
        jx = jax.lax.axis_index("dx")
        p, iters, res = solve(jnp.pad(guess_l, 1), jnp.pad(b_l, 1), jy, jx)
        return p[1:-1, 1:-1], iters, res

    spec = P("dy", "dx")
    fn = jax.jit(_shard_map(body, mesh, in_specs=(spec, spec),
                            out_specs=(spec, P(), P())))
    p_int, iters, res = fn(guess[1:-1, 1:-1], b[1:-1, 1:-1])
    return np.pad(np.asarray(p_int), 1), int(iters), float(res)


@pytest.mark.parametrize("n,mesh_shape", [
    (64, (2, 4)),   # whole hierarchy divisible: switch at the pinv level
    (48, (2, 4)),   # 48->24->12->6: 6 % 4 != 0 -> coarse switch above pinv
])
def test_sharded_solver_matches_single_device(n, mesh_shape):
    prob = M.cavity_problem(n, n, 1.0 / n, 1.0 / n)
    cfg = M.MGConfig(tol_factor=1e-10)
    dtype = jnp.float64
    rng = np.random.default_rng(3)
    b_np = np.zeros((n + 2, n + 2))
    b_np[1:-1, 1:-1] = rng.standard_normal((n, n))
    b = jnp.asarray(b_np, dtype)
    guess = jnp.zeros_like(b)

    ref_solve = M.make_multigrid_poisson(prob, cfg, dtype)
    p_ref, it_ref, res_ref = ref_solve(guess, b)

    mesh = make_mesh(devices=jax.devices("cpu")[:8], shape=mesh_shape)
    p_sh, it_sh, res_sh = _sharded_solve(prob, cfg, mesh, guess, b, dtype)

    assert it_sh == int(it_ref), "cycle counts must match exactly"
    np.testing.assert_allclose(p_sh, np.asarray(p_ref), rtol=0, atol=1e-12)
    assert abs(res_sh - float(res_ref)) <= 1e-12 * max(1.0, abs(float(res_ref)))


@pytest.mark.slow
def test_sharded_cavity_mg_step_equivalence_256():
    """Full sharded MG projection step at 256^2 vs Simulation's single-device
    multigrid path: same trajectory and same per-step cycle counts."""
    n, steps = 256, 3
    case = make_cavity_case(n_interior=n, poisson="multigrid",
                            dtype=jnp.float64, final_time=1.0)
    sim = Simulation(case, log=quiet)
    state = sim.initial_state()

    mesh = make_mesh(devices=jax.devices("cpu")[:8], shape=(2, 4))
    solver = ShardedCavity(case, mesh, poisson="multigrid")
    u, v, p, p_prev = solver.initial_state()

    for k in range(steps):
        state, diag_ref = sim._step(state)
        u, v, p, p_prev, diag_sh = solver.step(u, v, p, p_prev)
        assert int(diag_sh["poisson_iters"]) == int(diag_ref.poisson_iters), \
            f"cycle count mismatch at step {k}"

    np.testing.assert_allclose(np.asarray(u), np.asarray(state.u)[1:-1, 1:-1],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(v), np.asarray(state.v)[1:-1, 1:-1],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(p), np.asarray(state.p)[1:-1, 1:-1],
                               rtol=0, atol=1e-10)


def test_sharded_cavity_mg_step_equivalence_small():
    """Fast-tier variant of the 256^2 check (64^2, 2 steps)."""
    n = 64
    case = make_cavity_case(n_interior=n, poisson="multigrid",
                            dtype=jnp.float64, final_time=1.0)
    sim = Simulation(case, log=quiet)
    state = sim.initial_state()
    mesh = make_mesh(devices=jax.devices("cpu")[:8], shape=(2, 4))
    solver = ShardedCavity(case, mesh, poisson="multigrid")
    u, v, p, p_prev = solver.initial_state()
    for _ in range(2):
        state, diag_ref = sim._step(state)
        u, v, p, p_prev, diag_sh = solver.step(u, v, p, p_prev)
        assert int(diag_sh["poisson_iters"]) == int(diag_ref.poisson_iters)
    np.testing.assert_allclose(np.asarray(p), np.asarray(state.p)[1:-1, 1:-1],
                               rtol=0, atol=1e-10)
