"""Smoke test of the solver on one NVIDIA GPU: does the main path run on the
card, and is what it computes right?

Phases, each printing its own line:

  device   JAX's device and the card's name and power limit (nvidia-smi)
  flavor   each of the four flavors at full width — cavity 2048^2, channel
           1536x512, backward step 2048x256, Rayleigh-Benard 1536x512 at
           Ra=1e6 — float32 multigrid, 300 steps in jitted lax.scan chunks
           of 100: finite state, the last step's pressure solve at or below
           its tolerance (steps above it are counted and printed: a solve
           that reaches the float32 floor first ends on its stall test),
           V-cycles/step and steps/s
  golden   the reference 63^2 cavity in float64 (SOR, reference defaults),
           100 steps, matched to golden/cavity/stdout.log at printed
           precision
  f64      the 2048^2 cavity after 100 steps in float32 against the same
           run in float64

With --four-cards only one phase runs: cavity 2048^2 and step 2048x256
through Simulation(case, mesh=make_mesh(4)) against one device, 50 steps.

The last line is one JSON object: {"ok": true, "device": {...}}. Any
failure raises and exits non-zero without it.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Pressure-solve tolerance of the float32 runs, relative to max|b|. The
# channel and step operators stall at the float32 rounding floor above
# 1e-6 (the solver then exits on its stall test), so they are held to 1e-5.
TOL = {"cavity": 1e-6, "channel": 1e-5, "step": 1e-5, "rb": 1e-6}
# f32 against f64 after 100 steps at 2048^2: max|a - b| <= F64_RTOL *
# max|b| per field. Both runs stop each pressure solve at 1e-6 max|source|;
# that solver error, not f32 rounding, sets the gap, and 100 steps of it
# stay well inside 1e-3 of the field's scale.
F64_RTOL = 1e-3
# Sharded against one device after 50 steps: the partitioned program sums
# and maximises in another order, so the two agree to rounding, amplified
# by the solver's tolerance exits: 1e-4 of each field's scale.
MESH_RTOL = 1e-4


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def device_phase(jax, want_count: int) -> dict:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX's first device is {dev.platform})")
    if len(jax.devices()) < want_count:
        sys.exit(f"chip_smoke: need {want_count} GPUs, "
                 f"found {len(jax.devices())}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    log("device", kind=dev.device_kind, count=len(jax.devices()))
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def golden_phase(jnp) -> None:
    from cfd_tpu.cases import make_cavity_case
    from cfd_tpu.solver import Simulation

    want = next(line for line in
                (ROOT / "golden/cavity/stdout.log").read_text().splitlines()
                if line.startswith("Step    100/"))
    want_div = want.split("max(div)=")[1].split("|")[0].strip()
    want_ke = want.split("avg_KE=")[1].split("|")[0].strip()
    sim = Simulation(make_cavity_case(dtype=jnp.float64), log=lambda *a: None)
    t0 = time.perf_counter()
    sim.run(n_steps=100, steps_per_call=100)
    row = sim.history[-1]
    got_div = f"{row['max_divergence']:.2e}"
    got_ke = f"{row['avg_kinetic_energy']:.6f}"
    log("golden", step=row["step"], max_div=got_div, avg_ke=got_ke,
        want_max_div=want_div, want_avg_ke=want_ke,
        seconds=time.perf_counter() - t0)
    if (row["step"], got_div, got_ke) != (100, want_div, want_ke):
        raise AssertionError(f"golden cavity mismatch at step 100: "
                             f"{got_div} {got_ke} vs {want_div} {want_ke}")


def build(name: str, dtype):
    from cfd_tpu.cases import (make_backwards_step_case, make_cavity_case,
                               make_channel_case, make_rayleigh_benard_case)

    if name == "cavity":
        return make_cavity_case(n_interior=2048, poisson="multigrid",
                                dtype=dtype, tolerance_factor=TOL[name])
    if name == "channel":
        return make_channel_case(nx=1536, ny=512, poisson="multigrid",
                                 dtype=dtype, tolerance_factor=TOL[name],
                                 abs_tol=0.0)
    if name == "step":
        return make_backwards_step_case(nx=2048, ny=256, poisson="multigrid",
                                        dtype=dtype, tolerance_factor=TOL[name],
                                        abs_tol=0.0)
    return make_rayleigh_benard_case(nx=1536, ny=512, rayleigh=1e6,
                                     dtype=dtype, tolerance_factor=TOL[name],
                                     abs_tol=0.0)


def with_relative_residual(case, tol, jnp):
    """The case, its pressure solve reporting residual / tolerance (the
    solver's own criterion: tol * max|b|, abs_tol 0)."""
    solve = case.poisson_solve

    def wrapped(p, b):
        p, iters, res = solve(p, b)
        return p, iters, res / (tol * jnp.max(jnp.abs(b)))

    return dataclasses.replace(case, poisson_solve=wrapped)


def run_chunks(jax, case, n_chunks: int, chunk: int = 100, mesh=None):
    """(states after each chunk, cycles, residual/tol per step, steps/s
    over the chunks after the first, compile seconds)."""
    import numpy as np

    from cfd_tpu.parallel.sharded import shard_step
    from cfd_tpu.solver import Simulation, make_step

    step = make_step(case)
    if mesh is not None:
        step = shard_step(step, mesh)
    multi = jax.jit(lambda s: jax.lax.scan(lambda s, _: step(s), s, None,
                                           length=chunk))
    st = Simulation(case, log=lambda *a: None, mesh=mesh).initial_state()
    states, iters, ratios = [], [], []
    t0 = time.perf_counter()
    for k in range(n_chunks):
        if k == 1:
            jax.block_until_ready(st)
            t1 = time.perf_counter()
        st, d = multi(st)
        states.append(st)
        iters.append(d.poisson_iters)
        ratios.append(d.poisson_residual)
        if k == 0:
            jax.block_until_ready(st)
            compile_s = time.perf_counter() - t0
    jax.block_until_ready(st)
    sps = (n_chunks - 1) * chunk / (time.perf_counter() - t1) \
        if n_chunks > 1 else float("nan")
    cycles = float(sum(int(i.sum()) for i in iters)) / (n_chunks * chunk)
    return states, cycles, np.concatenate(ratios), sps, compile_s


def finite(jax, jnp, state) -> bool:
    return all(bool(jnp.isfinite(x).all()) for x in jax.tree.leaves(state))


def flavor_phase(jax, jnp) -> dict:
    cavity_100 = None
    for name in ("cavity", "channel", "step", "rb"):
        case = with_relative_residual(build(name, jnp.float32), TOL[name],
                                      jnp)
        states, cycles, ratio, sps, compile_s = run_chunks(jax, case, 3)
        ok = finite(jax, jnp, states[-1])
        log("flavor", flavor=name, grid=[case.grid.nx, case.grid.ny],
            steps=300, tol=TOL[name], finite=ok, v_cycles_per_step=cycles,
            residual_over_tol=float(ratio[-1]),
            worst_residual_over_tol=float(ratio.max()),
            steps_over_tol=int((ratio > 1.0).sum()), steps_per_s=sps,
            compile_s=compile_s)
        if not ok:
            raise AssertionError(f"{name}: non-finite state")
        if not ratio[-1] <= 1.0:
            raise AssertionError(f"{name}: the last pressure solve ended at "
                                 f"{ratio[-1]} x its tolerance")
        if name == "cavity":
            cavity_100 = states[0]
    return cavity_100


def f64_phase(jax, jnp, cavity_f32_100) -> None:
    case = build("cavity", jnp.float64)
    states, cycles, _, _, compile_s = run_chunks(jax, case, 1)
    ref = states[0]
    errs = {}
    for name in ("u", "v", "p"):
        a = getattr(cavity_f32_100, name).astype(jnp.float64)
        b = getattr(ref, name)
        errs[name] = float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))
    log("f64", grid=[2048, 2048], steps=100, rel_err=errs, rtol=F64_RTOL,
        f64_v_cycles_per_step=cycles, compile_s=compile_s)
    bad = {k: e for k, e in errs.items() if not e <= F64_RTOL}
    if bad:
        raise AssertionError(f"f32 vs f64 beyond {F64_RTOL}: {bad}")


def four_cards_phase(jax, jnp) -> None:
    from cfd_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4)
    for name in ("cavity", "step"):
        case = build(name, jnp.float32)
        one, cyc1, _, sps1, _ = run_chunks(jax, case, 2, chunk=25)
        four, cyc4, _, sps4, c4 = run_chunks(jax, case, 2, chunk=25,
                                             mesh=mesh)
        errs = {}
        for f in ("u", "v", "p"):
            a = getattr(four[-1], f)
            b = getattr(one[-1], f)
            errs[f] = float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))
        log("four_cards", flavor=name, steps=50, rel_err=errs,
            rtol=MESH_RTOL, steps_per_s_one=sps1, steps_per_s_four=sps4,
            v_cycles_one=cyc1, v_cycles_four=cyc4, compile_s_four=c4,
            finite=finite(jax, jnp, four[-1]))
        bad = {k: e for k, e in errs.items() if not e <= MESH_RTOL}
        if bad or not finite(jax, jnp, four[-1]):
            raise AssertionError(f"{name}: sharded vs one device {bad}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args()
    if not (ROOT / "cfd_tpu").is_dir():
        sys.exit("chip_smoke: the cfd_tpu package is not beside this script")
    sys.path.insert(0, str(ROOT))
    import jax
    import jax.numpy as jnp

    device = device_phase(jax, 4 if args.four_cards else 1)
    from cfd_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    if args.four_cards:
        four_cards_phase(jax, jnp)
    else:
        # float32 phases first, before the float64 ones turn on x64
        cavity_f32_100 = flavor_phase(jax, jnp)
        golden_phase(jnp)
        f64_phase(jax, jnp, cavity_f32_100)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
