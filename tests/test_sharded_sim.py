"""Multi-device Simulation/CLI integration: ``Simulation(case, mesh=...)``
runs the XLA-partitioned step (parallel.sharded.shard_step) through the SAME
time loop, stats rows, export and checkpoint machinery as one device — the
equivalent of the reference's OpenFOAM decomposePar + mpirun workflow
(reference README.md:129-131). Virtual CPU meshes (conftest)."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfd_tpu.cases import (make_backwards_step_case, make_cavity_case,
                           make_channel_case, make_rayleigh_benard_case)
from cfd_tpu.parallel.mesh import make_mesh
from cfd_tpu.solver import Simulation


def rows_mesh(n: int):
    return make_mesh(n, devices=jax.devices("cpu"))


def make_case(n=64):
    return make_cavity_case(n_interior=n, dtype=jnp.float32,
                            poisson="multigrid", print_interval=2)


FLAVORS = {
    "cavity": lambda: make_cavity_case(n_interior=32, poisson="multigrid",
                                       final_time=1.0, print_interval=2),
    "channel": lambda: make_channel_case(nx=48, ny=16, poisson="multigrid",
                                         final_time=1.0, print_interval=2),
    "step": lambda: make_backwards_step_case(nx=64, ny=16,
                                             poisson="multigrid",
                                             final_time=1.0,
                                             print_interval=2),
    "rb": lambda: make_rayleigh_benard_case(nx=48, ny=16, rayleigh=1e5,
                                            dtype=jnp.float64,
                                            final_time=1.0, print_interval=2),
}


@pytest.mark.parametrize("n_devices", [2, 4, 8])
@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_simulation_mesh_matches_single_device(flavor, n_devices):
    """Every flavor, float64, on (n, 1) row bands (padded rows do not divide
    the mesh, so the last shard is short): the partitioned run's stats rows
    and final state equal the single-device run's to rounding."""
    case = FLAVORS[flavor]()
    ref = Simulation(case, log=lambda *a: None)
    want = ref.run(n_steps=4, steps_per_call=2)
    sim = Simulation(case, log=lambda *a: None, mesh=rows_mesh(n_devices))
    got = sim.run(n_steps=4, steps_per_call=2)
    assert [r["step"] for r in sim.history] == [r["step"] for r in ref.history]
    for g, w in zip(sim.history, ref.history):
        assert g["poisson_iters"] == w["poisson_iters"]
    for name in ("u", "v", "p", "T"):
        a, b = getattr(want, name), getattr(got, name)
        if a is None:
            continue
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0,
                                   atol=1e-10 * max(1.0, float(np.abs(a).max())),
                                   err_msg=name)


def test_sharded_simulation_matches_single_device():
    """Simulation(mesh=4-device) history rows and final state == the
    single-device float32 Simulation."""
    case = make_case(64)

    ref = Simulation(case, log=lambda *a: None)
    ref_state = ref.run(n_steps=4, steps_per_call=2)

    sim = Simulation(case, log=lambda *a: None, mesh=rows_mesh(4))
    got = sim.run(n_steps=4, steps_per_call=2)
    assert len(got.u.sharding.device_set) == 4

    assert len(sim.history) == len(ref.history)
    for got_row, ref_row in zip(sim.history, ref.history):
        assert got_row["step"] == ref_row["step"]
        for key in ("max_divergence", "avg_kinetic_energy"):
            np.testing.assert_allclose(got_row[key], ref_row[key],
                                       rtol=1e-4, atol=1e-7, err_msg=key)
    for name in ("u", "v", "p"):
        a = np.asarray(getattr(ref_state, name))
        b = np.asarray(getattr(got, name))
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-5 * max(
            1.0, float(np.abs(a).max())), err_msg=name)


def test_sharded_simulation_checkpoint_resume(tmp_path):
    """A checkpoint written by a sharded run resumes (re-sharded by
    Simulation.place) to the uninterrupted sharded trajectory."""
    from cfd_tpu.io.checkpoint import CheckpointManager

    case = make_case(64)
    mesh = rows_mesh(4)

    full = Simulation(case, log=lambda *a: None, mesh=mesh)
    want = full.run(n_steps=4, steps_per_call=2)

    sim1 = Simulation(case, log=lambda *a: None, mesh=mesh)
    sim1.checkpointer = CheckpointManager(tmp_path, interval=2)
    sim1.run(n_steps=2, steps_per_call=2)

    sim2 = Simulation(case, log=lambda *a: None, mesh=mesh)
    restored, start = CheckpointManager(tmp_path, interval=2).restore_latest(case)
    assert start == 2
    got = sim2.run(state=restored, n_steps=2, start_step=start,
                   steps_per_call=2)
    for name in ("u", "v", "p"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_cli_mesh_guards():
    """--mesh fails fast with actionable messages: adaptive dt is not
    supported over a mesh, and a mesh needs that many devices."""
    from cfd_tpu import cli

    with pytest.raises(SystemExit, match="adaptive"):
        cli.main(["cavity", "--mesh", "2", "--precision", "f32",
                  "--adaptive-dt", "0.5", "--steps", "1", "--no-vtk",
                  "--no-color"])
    with pytest.raises(ValueError, match="need 64 devices"):
        cli.main(["cavity", "--mesh", "64", "--steps", "1", "--no-vtk",
                  "--no-color"])


def test_adaptive_on_mesh_raises():
    from cfd_tpu.adaptive import run_adaptive

    sim = Simulation(make_case(32), log=lambda *a: None, mesh=rows_mesh(2))
    with pytest.raises(ValueError, match="mesh"):
        run_adaptive(sim, n_steps=1)


@pytest.mark.slow
def test_cli_mesh_smoke(tmp_path):
    """`cfd_tpu.cli cavity --mesh 2 --precision f32` runs end-to-end on the
    virtual CPU mesh and prints stats rows."""
    import os

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    out = subprocess.run(
        [sys.executable, "-m", "cfd_tpu.cli", "cavity", "--mesh", "2",
         "--precision", "f32", "--poisson", "multigrid", "--Nx", "32",
         "--Ny", "32", "--steps", "2", "--print-interval", "1",
         "--no-vtk", "--no-color"],
        capture_output=True, text=True, env=env, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "mesh: 2x1 row-band decomposition" in out.stdout
    assert "Step      2/" in out.stdout


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_initial_state_is_sharded_by_rows(n_devices):
    """Simulation(mesh=...) lays the state out as the partitioned step
    expects it: every field spread over all devices of the mesh, in bands
    of rows (30 interior rows: 32 padded rows divide every mesh; JAX keeps
    arrays in even shards only)."""
    from cfd_tpu.parallel.sharded import state_sharding

    mesh = rows_mesh(n_devices)
    st = Simulation(make_case(30), log=lambda *a: None,
                    mesh=mesh).initial_state()
    for x in (st.u, st.v, st.p):
        assert len(x.sharding.device_set) == n_devices
        assert x.sharding.is_equivalent_to(state_sharding(mesh), x.ndim)
