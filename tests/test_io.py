"""Checkpoint/resume, metrics logging, CLI surface, and failure detection."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cfd_tpu.cases import make_cavity_case, make_channel_case
from cfd_tpu.io.checkpoint import CheckpointManager
from cfd_tpu.io.metrics import MetricsLog
from cfd_tpu.solver import Simulation


def quiet(*a, **k):
    pass


def test_checkpoint_exact_resume(tmp_path):
    """Resume from a checkpoint reproduces the uninterrupted trajectory
    bitwise (the step is pure; (u, v, p) is the complete state)."""
    case = make_channel_case(nx=16, ny=8, final_time=1.0)
    sim = Simulation(case, log=quiet)

    state = sim.initial_state()
    for _ in range(6):
        state, _ = sim._step(state)
    uninterrupted = state

    ckpt = CheckpointManager(tmp_path, interval=3)
    state = sim.initial_state()
    for k in range(1, 4):
        state, _ = sim._step(state)
        ckpt.maybe_save(state, k)
    assert ckpt.latest_step() == 3

    restored, step = ckpt.restore_latest(case)
    assert step == 3
    for _ in range(3):
        restored, _ = sim._step(restored)

    np.testing.assert_array_equal(np.asarray(restored.u), np.asarray(uninterrupted.u))
    np.testing.assert_array_equal(np.asarray(restored.v), np.asarray(uninterrupted.v))
    np.testing.assert_array_equal(np.asarray(restored.p), np.asarray(uninterrupted.p))


def test_checkpoint_prune_keeps_latest(tmp_path):
    case = make_channel_case(nx=16, ny=8, final_time=1.0)
    sim = Simulation(case, log=quiet)
    state = sim.initial_state()
    ckpt = CheckpointManager(tmp_path, interval=1, keep=2)
    for k in range(1, 6):
        state, _ = sim._step(state)
        ckpt.maybe_save(state, k)
    steps = sorted(int(f.name[5:13]) for f in Path(tmp_path).glob("ckpt_*.npz"))
    assert steps == [4, 5]


def test_metrics_jsonl_and_csv(tmp_path):
    case = make_channel_case(nx=16, ny=8, final_time=1.0, print_interval=2)
    log = MetricsLog(jsonl_path=tmp_path / "m.jsonl", csv_path=tmp_path / "m.csv")
    sim = Simulation(case, log=quiet, metrics=log)
    sim.run(n_steps=4)
    log.close()
    rows = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [2, 4]
    for col in ["max_divergence", "avg_kinetic_energy", "poisson_iters",
                "poisson_residual", "wall_seconds", "cell_updates_per_sec"]:
        assert col in rows[0]
    header = (tmp_path / "m.csv").read_text().splitlines()[0].split(",")
    assert "step" in header and "cell_updates_per_sec" in header


def test_blowup_detection():
    """A CFL-violating dt must abort with a diagnosable error instead of
    silently streaming NaNs (reference behavior: continues anyway,
    cavity-01.cpp:681-684)."""
    with pytest.warns(UserWarning, match="stability limit"):
        case = make_cavity_case(n_interior=15, dt=1.0, final_time=10.0,
                                print_interval=1)
    sim = Simulation(case, log=quiet)
    with pytest.raises(RuntimeError, match="diverged"):
        sim.run(n_steps=10)


def test_cli_smoke(tmp_path):
    """Drive the README-advertised CLI surface end-to-end in a subprocess."""
    out = tmp_path / "vtk"
    r = subprocess.run(
        [sys.executable, "-m", "cfd_tpu.cli", "cavity", "--Re", "100",
         "--Nx", "15", "--Ny", "15", "--steps", "4", "--print-interval", "2",
         "--save-interval", "2", "--out", str(out),
         "--metrics-jsonl", str(tmp_path / "m.jsonl")],
        capture_output=True, text=True, timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin",
             "PYTHONPATH": str(Path(__file__).resolve().parent.parent)},
    )
    assert r.returncode == 0, r.stderr
    # reference banner (cavity-01.cpp:501-518) + completion summary
    # (cavity-01.cpp:404-410), uncolored off-tty
    assert "=== Lid-Driven Cavity Flow Simulation ===" in r.stdout
    assert "\033[" not in r.stdout  # subprocess pipe is not a tty
    assert "Simulation completed successfully!" in r.stdout
    assert (out / "cavity_flow_000004.vtk").exists()
    assert (out / "cavity_flow_animation.pvd").exists()
    assert (tmp_path / "m.jsonl").exists()


def test_cli_rejects_rectangular_cavity():
    from cfd_tpu.cli import build_parser, make_case_from_args

    args = build_parser().parse_args(["cavity", "--Nx", "32", "--Ny", "16"])
    with pytest.raises(SystemExit):
        make_case_from_args(args)


def test_cli_mg_overrides():
    """--mg K=V[,K=V] parses into mg_overrides: typed values reach
    MGConfig, unknown fields are rejected with the valid-field list."""
    from cfd_tpu.cli import build_parser, make_case_from_args

    args = build_parser().parse_args(
        ["cavity", "--Nx", "128", "--Ny", "128", "--poisson", "multigrid",
         "--mg", "pre_sweeps=3,tol_factor=1e-5,corr_opt=false"])
    case = make_case_from_args(args)  # builds without error
    assert case.poisson_solve is not None

    args = build_parser().parse_args(
        ["cavity", "--Nx", "128", "--Ny", "128", "--mg", "bogus=1"])
    with pytest.raises(SystemExit, match="bogus"):
        make_case_from_args(args)

    # values must be numbers or booleans
    args = build_parser().parse_args(
        ["cavity", "--Nx", "128", "--Ny", "128", "--poisson", "multigrid",
         "--mg", "omega=fast"])
    with pytest.raises(SystemExit, match="omega"):
        make_case_from_args(args)


def test_async_exporter_produces_identical_files(tmp_path):
    """AsyncExporter output is byte-identical to synchronous export and the
    collection contains every frame."""
    from cfd_tpu.io.async_writer import AsyncExporter
    from cfd_tpu.io.vtk import exporter_for_case

    case = make_channel_case(nx=16, ny=8, final_time=1.0)
    sim_sync = Simulation(case, exporter=exporter_for_case(case, tmp_path / "sync"),
                          log=quiet)
    sim_async = Simulation(
        case, exporter=AsyncExporter(exporter_for_case(case, tmp_path / "async")),
        log=quiet)
    sim_sync.run(n_steps=4)
    sim_async.run(n_steps=4)
    sync_files = sorted((tmp_path / "sync").glob("*.vtk"))
    async_files = sorted((tmp_path / "async").glob("*.vtk"))
    assert [f.name for f in sync_files] == [f.name for f in async_files]
    for a, b in zip(sync_files, async_files):
        assert a.read_text() == b.read_text(), a.name
    assert (tmp_path / "async" / "channel_flow_animation.pvd").read_text() == \
        (tmp_path / "sync" / "channel_flow_animation.pvd").read_text()


def test_async_exporter_surfaces_worker_errors(tmp_path):
    from cfd_tpu.io.async_writer import AsyncExporter

    def boom(state, step, t):
        raise RuntimeError("disk full")

    exp = AsyncExporter(boom)
    case = make_channel_case(nx=16, ny=8, final_time=1.0)
    sim = Simulation(case, log=quiet)
    st = sim.initial_state()
    exp(st, 1, 0.1)
    import time as _t

    _t.sleep(0.2)
    with pytest.raises(RuntimeError, match="disk full"):
        exp.close()


def test_png_exporter(tmp_path):
    """PNG contour frames (the reference's published figure surface,
    README.md:38): one file per save call, masked solids blanked, multi-
    exporter fan-out keeps the VTK collection contract."""
    import jax.numpy as jnp

    from cfd_tpu.cases import make_backwards_step_case
    from cfd_tpu.io.png import MultiExporter, png_exporter_for_case
    from cfd_tpu.io.vtk import exporter_for_case
    from cfd_tpu.solver import Simulation

    case = make_backwards_step_case(nx=32, ny=8, dtype=jnp.float32,
                                    final_time=0.05)
    png = png_exporter_for_case(case, out_dir=tmp_path)
    vtk = exporter_for_case(case, out_dir=tmp_path)
    multi = MultiExporter([vtk, png])
    sim = Simulation(case, exporter=multi, log=lambda *a: None)
    st = sim.initial_state()
    multi(st, 0, 0.0)
    f = tmp_path / "backwards_step_000000.png"
    assert f.exists() and f.stat().st_size > 1000
    assert (tmp_path / "backwards_step_000000.vtk").exists()
    assert multi.write_collection() is not None
