"""Sharding: halo exchange, shard_map step == single-device step, GSPMD path.

All on the 8-device virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfd_tpu.cases import make_cavity_case, make_rayleigh_benard_case
from cfd_tpu.parallel import ShardedCavity, gspmd_step, make_mesh
from cfd_tpu.parallel.halo import exchange_halos, pad_local
from cfd_tpu.parallel.mesh import factor_2d, grid_sharding
from cfd_tpu.solver import Simulation

try:
    from jax import shard_map as _sm

    def shard_map(f, mesh, in_specs, out_specs):
        return _sm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
except ImportError:
    from jax.experimental.shard_map import shard_map as _esm

    def shard_map(f, mesh, in_specs, out_specs):
        return _esm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs)

from jax.sharding import PartitionSpec as P


def cpu_mesh(n=8, shape=None):
    return make_mesh(n, shape=shape, devices=jax.devices("cpu"))


def quiet(*a, **k):
    pass


def test_factor_2d():
    assert factor_2d(8) == (2, 4)
    assert factor_2d(4) == (2, 2)
    assert factor_2d(7) == (1, 7)


def test_halo_exchange_reconstructs_global_neighbors():
    """Global consecutive integers: after exchange, every local ghost cell
    facing another device holds the correct global neighbor value,
    including the diagonal corners (y-then-x ordering)."""
    mesh = cpu_mesh(8, shape=(2, 4))
    ny, nx = 8, 16
    g = np.arange(ny * nx, dtype=np.float64).reshape(ny, nx)
    gs = jax.device_put(jnp.asarray(g), grid_sharding(mesh))

    def body(block):
        return exchange_halos(pad_local(block))

    out = jax.jit(shard_map(body, mesh, in_specs=P("dy", "dx"),
                            out_specs=P("dy", "dx")))(gs)
    # output is (2*(4+2), 4*(4+2)) = blocks concatenated with their ghosts
    blocks = np.asarray(out).reshape(2, 6, 4, 6).transpose(0, 2, 1, 3)
    gp = np.full((ny + 2, nx + 2), -1.0)
    gp[1:-1, 1:-1] = g
    for by in range(2):
        for bx in range(4):
            blk = blocks[by, bx]
            # interior must be untouched
            np.testing.assert_array_equal(
                blk[1:-1, 1:-1], g[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4])
            # interior-facing ghosts (incl. corners) equal global neighbors
            for (dj, di) in [(0, 1), (0, 2), (0, 3), (0, 4), (1, 0), (1, 5),
                             (5, 1), (5, 4), (0, 0), (5, 5), (0, 5), (5, 0),
                             (2, 0), (3, 5)]:
                gyy = by * 4 + dj
                gxx = bx * 4 + di
                if 1 <= gyy <= ny and 1 <= gxx <= nx:  # inside global interior
                    expected = gp[gyy, gxx]
                    if expected >= 0:
                        assert blk[dj, di] == expected, (by, bx, dj, di)


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (4, 2)])
def test_sharded_cavity_matches_single_device(shape):
    """3 projection steps on an 8-device mesh reproduce the single-device
    trajectory to roundoff, with identical Poisson iteration counts."""
    n = 32
    case = make_cavity_case(n_interior=n, final_time=1.0)
    sc = ShardedCavity(case, cpu_mesh(8, shape=shape))
    u, v, p = sc.initial_state()
    for _ in range(3):
        u, v, p, diag = sc.step(u, v, p)

    sim = Simulation(case, log=quiet)
    st = sim.initial_state()
    for _ in range(3):
        st, ref_diag = sim._step(st)
    sl = np.s_[1 : n + 1, 1 : n + 1]
    np.testing.assert_allclose(np.asarray(u), np.asarray(st.u)[sl], atol=1e-13)
    np.testing.assert_allclose(np.asarray(v), np.asarray(st.v)[sl], atol=1e-13)
    np.testing.assert_allclose(np.asarray(p), np.asarray(st.p)[sl], atol=1e-12)
    assert int(diag["poisson_iters"]) == int(ref_diag.poisson_iters)


def test_gspmd_cavity_multigrid_matches_single_device():
    """The auto-partitioned (GSPMD) path with the multigrid solver."""
    n = 32
    case = make_cavity_case(n_interior=n, poisson="multigrid", final_time=1.0,
                            tolerance_factor=1e-10)
    mesh = cpu_mesh(8, shape=(2, 4))
    step = gspmd_step(case, mesh)
    sim = Simulation(case, log=quiet)

    st_sharded = sim.initial_state()
    st = sim.initial_state()
    for _ in range(3):
        st_sharded, _ = step(st_sharded)
        st, _ = sim._step(st)
    np.testing.assert_allclose(np.asarray(st_sharded.u), np.asarray(st.u), atol=1e-12)
    np.testing.assert_allclose(np.asarray(st_sharded.p), np.asarray(st.p), atol=1e-11)


def test_gspmd_rayleigh_benard_runs_sharded():
    """Boussinesq step (temperature transport + mean-pinned MG) under GSPMD."""
    case = make_rayleigh_benard_case(nx=32, ny=16, aspect=2.0, final_time=1.0,
                                     dtype=jnp.float64)
    mesh = cpu_mesh(8, shape=(2, 4))
    step = gspmd_step(case, mesh)
    sim = Simulation(case, log=quiet)
    st_sharded = sim.initial_state()
    st = sim.initial_state()
    for _ in range(3):
        st_sharded, _ = step(st_sharded)
        st, _ = sim._step(st)
    np.testing.assert_allclose(np.asarray(st_sharded.T), np.asarray(st.T),
                               atol=1e-12)


def test_sharded_rejects_indivisible_grid():
    case = make_cavity_case(n_interior=30, final_time=1.0)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedCavity(case, cpu_mesh(8, shape=(4, 2)))  # 30 % 4 != 0


def test_gspmd_masked_step_matches_single_device():
    """Masked geometry (backward-facing step) under GSPMD at the REFERENCE
    size 256x32 on the 8-device mesh: the solid-mask stencils, masked
    source mean removal and defect-correction multigrid all partition to
    the single-device trajectory."""
    from cfd_tpu.cases import make_backwards_step_case

    case = make_backwards_step_case(nx=256, ny=32, poisson="multigrid",
                                    final_time=1.0)
    mesh = cpu_mesh(8, shape=(2, 4))
    step = gspmd_step(case, mesh)
    sim = Simulation(case, log=quiet)
    st_sharded = sim.initial_state()
    st = sim.initial_state()
    for _ in range(5):
        st_sharded, sd = step(st_sharded)
        st, rd = sim._step(st)
        assert int(sd.poisson_iters) == int(rd.poisson_iters)
    np.testing.assert_allclose(np.asarray(st_sharded.u), np.asarray(st.u),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(st_sharded.v), np.asarray(st.v),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(st_sharded.p), np.asarray(st.p),
                               atol=1e-11)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_defaults_to_row_bands(n):
    """Devices of one host reach each other all to all: the default mesh
    follows the grid, one band of rows per device."""
    mesh = cpu_mesh(n)
    assert mesh.axis_names == ("dy", "dx")
    assert mesh.devices.shape == (n, 1)


def test_make_mesh_raises_without_enough_devices():
    """No quiet fallback to other devices when too few are there."""
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        cpu_mesh(16)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(2, devices=jax.devices("cpu")[:1])
