"""Command-line entry point.

The reference README advertises a CLI (`./cavity_flow --Re 100 --Nx 128 --Ny
128 --dt 1e-3`, README.md:125-126) that its binaries do not implement (all
parameters are compile-time constants, cavity-01.cpp:309-320). This CLI
honors exactly that advertised surface, with the reference constants as
per-case defaults, plus the knobs the framework adds (precision, Poisson
solver selection, output/metrics paths, checkpointing).

Usage:
    python -m cfd_tpu.cli cavity --Re 1000 --Nx 63 --Ny 63
    python -m cfd_tpu.cli channel --Re 100 --Nx 93 --Ny 31 --T 10
    python -m cfd_tpu.cli backwards_step
    python -m cfd_tpu.cli rayleigh_benard --Ra 1e6 --Pr 0.7 --Nx 192 --Ny 64
"""

from __future__ import annotations

import argparse
import sys
import time

import jax


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cfd_tpu",
        description="Incompressible Navier-Stokes solvers in JAX",
    )
    sub = p.add_subparsers(dest="case", required=True)

    def common(sp, nx, ny, re, t):
        sp.add_argument("--Re", type=float, default=re, help="Reynolds number")
        sp.add_argument("--Nx", type=int, default=nx, help="interior cells in x")
        sp.add_argument("--Ny", type=int, default=ny, help="interior cells in y")
        sp.add_argument("--dt", type=float, default=None,
                        help="time step (default: reference CFL rule)")
        sp.add_argument("--T", type=float, default=t, help="final time")
        sp.add_argument("--steps", type=int, default=None,
                        help="run exactly N steps instead of to final time")
        sp.add_argument("--precision", choices=["f32", "f64"], default="f64",
                        help="f64 matches the C++ reference; f32 for speed")
        sp.add_argument("--out", default="vtk_output", help="VTK output directory")
        sp.add_argument("--no-vtk", action="store_true", help="disable VTK export")
        sp.add_argument("--png", action="store_true",
                        help="also render PNG contour frames (|V|, vorticity"
                             "[, T]) at save cadence — the figure surface the"
                             " reference publishes (README.md:38)")
        sp.add_argument("--adaptive-dt", type=float, default=None, metavar="MAX_CO",
                        help="Courant-limited adaptive time stepping toward "
                             "this max Courant number (the OpenFOAM-workflow "
                             "adjustTimeStep/maxCo knob, reference "
                             "README.md:112-114); disables checkpointing")
        sp.add_argument("--adaptive-controller", choices=["exact", "lagged"],
                        default="exact",
                        help="Courant feedback: 'exact' measures the step "
                             "just produced; 'lagged' uses the step before "
                             "(one-step-stale feedback = OpenFOAM "
                             "adjustTimeStep semantics), on device")
        sp.add_argument("--steps-per-call", type=int, default=1,
                        help="advance N steps per device dispatch (lax.scan); "
                             "must divide print/save intervals")
        sp.add_argument("--mesh", type=int, default=None, metavar="N",
                        help="shard the domain over N devices in bands of "
                             "rows (XLA-partitioned step; the equivalent of "
                             "decomposePar+mpirun, reference "
                             "README.md:129-131)")
        sp.add_argument("--sync-io", action="store_true",
                        help="write VTK snapshots synchronously in the time "
                             "loop (default: background writer thread)")
        sp.add_argument("--metrics-jsonl", default=None, help="write metric rows to JSONL")
        sp.add_argument("--metrics-csv", default=None, help="write metric rows to CSV")
        sp.add_argument("--print-interval", type=int, default=None)
        sp.add_argument("--save-interval", type=int, default=None)
        sp.add_argument("--poisson", choices=["auto", "sor", "multigrid"],
                        default="auto",
                        help="pressure solver (auto: SOR at reference sizes, "
                             "multigrid at scale)")
        sp.add_argument("--poisson-check-every", type=int, default=1,
                        help="sweeps between residual checks (amortizes the "
                             "global reduction; reference checks every sweep)")
        sp.add_argument("--mg", default=None, metavar="K=V[,K=V...]",
                        help="multigrid tuning overrides (MGConfig fields), "
                             "e.g. --mg pre_sweeps=2,post_sweeps=1")
        sp.add_argument("--profile-dir", default=None,
                        help="capture a jax.profiler trace of the run")
        sp.add_argument("--checkpoint-dir", default=None,
                        help="periodic checkpoints + resume from latest")
        sp.add_argument("--checkpoint-interval", type=int, default=500)
        color = sp.add_mutually_exclusive_group()
        color.add_argument("--color", dest="color", action="store_true",
                           default=None,
                           help="force ANSI-colored banner/summary (the "
                                "reference paints its stdout, "
                                "cavity-01.cpp:35-41; default: only on a tty)")
        color.add_argument("--no-color", dest="color", action="store_false")
        return sp

    common(sub.add_parser("cavity", help="lid-driven cavity (cavity-01.cpp)"),
           63, 63, 1000.0, 20.0)
    common(sub.add_parser("channel", help="channel / Poiseuille start-up (channel-01.cpp)"),
           93, 31, 100.0, 10.0)
    common(sub.add_parser("backwards_step", help="backward-facing step (backwards_step-01.cpp)"),
           256, 32, 100.0, 15.0)
    rb = common(sub.add_parser("rayleigh_benard", help="Rayleigh-Benard convection (README.md:79-94)"),
                192, 64, 0.0, 50.0)
    rb.add_argument("--Ra", type=float, default=1e6, help="Rayleigh number")
    rb.add_argument("--Pr", type=float, default=0.71, help="Prandtl number")
    rb.add_argument("--ftle-window", type=int, default=0,
                    help="compute backward FTLE over the last N saved frames "
                         "and write <out>/ftle_XXXXXX.vtk (the reference RB "
                         "FTLE animations, README.md:87-94)")
    return p


def make_case_from_args(args):
    kw = dict(dt=args.dt, final_time=args.T,
              poisson_check_every=args.poisson_check_every,
              poisson=args.poisson)
    kw = {k: v for k, v in kw.items() if v is not None}
    if args.precision == "f32":
        import jax.numpy as jnp

        kw["dtype"] = jnp.float32
    if args.print_interval is not None:
        kw["print_interval"] = args.print_interval
    if args.save_interval is not None:
        kw["save_interval"] = args.save_interval
    if args.mg:
        import dataclasses

        from cfd_tpu.poisson.multigrid import MGConfig

        fields = {f.name: f.type for f in dataclasses.fields(MGConfig)}
        ov = {}
        for item in args.mg.split(","):
            k, _, v = item.partition("=")
            k = k.strip()
            if k not in fields:
                raise SystemExit(
                    f"--mg: unknown MGConfig field {k!r} "
                    f"(valid: {', '.join(sorted(fields))})")
            v = v.strip()
            if v.lower() in ("true", "false"):
                ov[k] = v.lower() == "true"
            elif v.lower() in ("none", ""):
                ov[k] = None
            else:
                try:
                    ov[k] = float(v) if any(c in v for c in ".e") else int(v)
                except ValueError:
                    raise SystemExit(f"--mg: {k}={v!r} is not a number "
                                     "or a boolean")
        kw["mg_overrides"] = ov

    if args.case == "cavity":
        from cfd_tpu.cases import make_cavity_case

        if args.Nx != args.Ny:
            raise SystemExit("cavity requires Nx == Ny (square grid)")
        return make_cavity_case(n_interior=args.Nx, reynolds_number=args.Re, **kw)
    if args.case == "channel":
        from cfd_tpu.cases import make_channel_case

        return make_channel_case(nx=args.Nx, ny=args.Ny, reynolds_number=args.Re, **kw)
    if args.case == "backwards_step":
        from cfd_tpu.cases import make_backwards_step_case

        return make_backwards_step_case(nx=args.Nx, ny=args.Ny, reynolds_number=args.Re, **kw)
    if args.case == "rayleigh_benard":
        from cfd_tpu.cases import make_rayleigh_benard_case

        kw.pop("final_time", None)
        kw.pop("poisson_check_every", None)  # RB uses multigrid (cycle-based)
        kw.pop("poisson", None)
        return make_rayleigh_benard_case(
            nx=args.Nx, ny=args.Ny, rayleigh=args.Ra, prandtl=args.Pr,
            final_time=args.T, **kw)
    raise SystemExit(f"unknown case {args.case}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from cfd_tpu.runtime import device_info, enable_compile_cache

    enable_compile_cache()
    case = make_case_from_args(args)

    from cfd_tpu.io.metrics import MetricsLog
    from cfd_tpu.io.vtk import exporter_for_case
    from cfd_tpu.solver import Simulation

    exporter = None if args.no_vtk else exporter_for_case(case, out_dir=args.out)
    if getattr(args, "png", False):
        from cfd_tpu.io.png import MultiExporter, png_exporter_for_case

        png = png_exporter_for_case(case, out_dir=args.out)
        exporter = png if exporter is None else MultiExporter([exporter, png])
    if exporter is not None and not args.sync_io:
        from cfd_tpu.io.async_writer import AsyncExporter

        exporter = AsyncExporter(exporter)
    collector = None
    if getattr(args, "ftle_window", 0):
        from cfd_tpu.physics.ftle import FrameCollector

        collector = FrameCollector(case.grid, inner=exporter,
                                   max_frames=args.ftle_window)
        exporter = collector
    metrics = None
    if args.metrics_jsonl or args.metrics_csv:
        metrics = MetricsLog(jsonl_path=args.metrics_jsonl, csv_path=args.metrics_csv)

    # reference printSimulationInfo banner (cavity-01.cpp:501-518) + the
    # framework's own device line
    from cfd_tpu.io import console

    console.print_banner(case, color=args.color)
    device = device_info()
    where = (f"{device['kind']} x{device['count']}"
             + (f" ({device['card']})" if device["card"] else ""))
    print(f"device: {device['platform']} {where}")

    mesh = None
    if args.mesh:
        if args.adaptive_dt is not None:
            raise SystemExit("--adaptive-dt is not supported with --mesh yet: "
                             "run adaptive cases on one device")
        from cfd_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(n_devices=args.mesh)
        print(f"mesh: {args.mesh}x1 row-band decomposition over "
              f"{mesh.devices.flat[0].platform}")

    sim = Simulation(case, exporter=exporter, metrics=metrics, mesh=mesh)

    state = None
    start_step = 0
    if args.checkpoint_dir:
        from cfd_tpu.io.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.checkpoint_dir,
                                 interval=args.checkpoint_interval)
        sim.checkpointer = ckpt
        if args.adaptive_dt is None:
            state, start_step = ckpt.restore_latest(case)
            if start_step:
                print(f"resumed from checkpoint at step {start_step}")

    t0 = time.perf_counter()
    if args.adaptive_dt is not None:
        # run_adaptive resumes (state, step, dt, t) from sim.checkpointer
        # itself: dt/t live in the checkpoint extras
        from cfd_tpu.adaptive import run_adaptive

        run_adaptive(sim, max_courant=args.adaptive_dt, n_steps=args.steps,
                     final_time=None if args.steps else case.final_time,
                     steps_per_call=args.steps_per_call,
                     controller=args.adaptive_controller)
    elif args.profile_dir:
        with jax.profiler.trace(args.profile_dir):
            sim.run(state=state, n_steps=args.steps, start_step=start_step,
                    steps_per_call=args.steps_per_call)
    else:
        sim.run(state=state, n_steps=args.steps, start_step=start_step,
                steps_per_call=args.steps_per_call)
    if sim.history:
        last = sim.history[-1]
        steps = last["step"] - start_step
        wall = time.perf_counter() - t0
        print(f"{steps} steps in {wall:.2f} s, compilation included: "
              f"{steps / wall:.2f} steps/s on {where}")
    if collector is not None and len(collector.times) >= 2:
        from pathlib import Path

        from cfd_tpu.physics.ftle import write_ftle_vtk

        ftle, _, _ = collector.ftle(case.grid, backward=True)
        out = Path(args.out) / f"ftle_{len(collector.times):06d}.vtk"
        write_ftle_vtk(out, case.grid, ftle, collector.times[-1])
        print(f"backward FTLE over {len(collector.times)} frames -> {out}")
    if metrics is not None:
        metrics.close()
    if exporter is not None:
        console.print_completion(case, args.out, color=args.color)
    return 0


if __name__ == "__main__":
    sys.exit(main())
