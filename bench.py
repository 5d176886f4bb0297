"""Benchmark: projection steps at scale on one GPU.

Prints one JSON line per secondary case (channel, backwards step,
Rayleigh-Benard) followed by the headline line LAST (the last line is the
recorded result):
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": null,
   "device": {"platform", "kind", "count", "card"}}
("card" is nvidia-smi's name and power limit of the GPU.)

Headline metric: cell-updates/sec of the 2048^2 cavity. One cell-update =
one stencil update of one cell. Per projection step the solver performs
  predictor (u*, v*)            2 updates/cell
  divergence source             1
  corrector (u, v)              2
  Poisson V(2,1) cycles         (2 pre + 1 post smoothing pairs + 1
                                 residual) = 4 updates/cell per level visit
                                 x 4/3 (geometric level sum) per cycle
so updates/step/cell = 5 + (16/3) * cycles, with the cycle count read back
from the solver's diagnostics. Secondary lines report fluid cell-steps/sec.
Wall time is measured over timed steps after a compile+warmup phase, with
block_until_ready fencing. There is no baseline yet: vs_baseline is null.

The run refuses to time anything but a GPU.

Env knobs: BENCH_N (default 2048), BENCH_STEPS (default 300),
BENCH_WARMUP_STEPS (default 400 — past the startup V-cycle transient),
BENCH_DTYPE (f32|bf16, default f32; bf16 is a validated ~5%-KE-band
throughput mode, tests/test_bf16.py — not a validation mode),
BENCH_TOL (default 1e-6 relative),
BENCH_CHUNK (steps per dispatch via lax.scan, default 100 = the reference
print cadence),
BENCH_CASES (comma list or "none"; default "channel,step,rb" at
BENCH_N=2048, "none" otherwise — the secondary lines only make sense at the
recorded scales).
"""

from __future__ import annotations

import json
import os
import time


def _timed_steps(step_fn, state, steps: int, chunk: int,
                 warmup_steps: int | None = None):
    """(state, mean_cycles, wall_s, compile_s, timed_steps) for a case."""
    import jax

    @jax.jit
    def multi(state):
        def body(s, _):
            s2, d = step_fn(s)
            return s2, d.poisson_iters

        return jax.lax.scan(body, state, None, length=chunk)

    t0 = time.perf_counter()
    state, iters = multi(state)
    jax.block_until_ready(jax.tree.leaves(state)[0])
    compile_s = time.perf_counter() - t0
    # Warm past the startup V-cycle transient before timing (the step case
    # runs ~4 cycles/step over its first ~50 steps).
    if warmup_steps is None:
        warmup_steps = int(os.environ.get("BENCH_WARMUP_STEPS", 400))
    for _ in range(max(1, -(-warmup_steps // chunk) - 1)):
        state, iters = multi(state)
    jax.block_until_ready(jax.tree.leaves(state)[0])

    n_chunks = max(1, steps // chunk)
    steps = n_chunks * chunk
    cycles = []
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        state, iters = multi(state)
        cycles.append(iters)
    jax.block_until_ready(jax.tree.leaves(state)[0])
    wall = time.perf_counter() - t0
    mean_cycles = float(sum(int(c.sum()) for c in cycles)) / steps
    # NaN throughput is not throughput: refuse to time a diverged run.
    # Scalar-only transfer.
    import jax.numpy as jnp

    for leaf in jax.tree.leaves(state):
        if not bool(jnp.isfinite(leaf).all()):
            raise RuntimeError(
                "benchmark state is non-finite after the timed steps — "
                "refusing to record throughput for a diverged run")
    return state, mean_cycles, wall, compile_s, steps


def _secondary_cases(names: list[str], device: dict) -> None:
    """One JSON line per non-flagship case."""
    import jax.numpy as jnp

    from cfd_tpu.solver import Simulation, make_step

    # chunk 50: at the secondary-case sizes dispatch latency is a
    # first-order cost
    steps = int(os.environ.get("BENCH_CASE_STEPS", 150))
    chunk = int(os.environ.get("BENCH_CASE_CHUNK", 50))
    for name in names:
        # configs identical to benchmarks/case_bench.py
        if name == "channel":
            from cfd_tpu.cases import make_channel_case

            case = make_channel_case(nx=1536, ny=512, poisson="multigrid",
                                     tolerance_factor=1e-6, abs_tol=0.0,
                                     dtype=jnp.float32)
        elif name == "step":
            from cfd_tpu.cases import make_backwards_step_case

            case = make_backwards_step_case(nx=2048, ny=256,
                                            poisson="multigrid",
                                            tolerance_factor=1e-6,
                                            abs_tol=0.0, dtype=jnp.float32)
        elif name == "rb":
            from cfd_tpu.physics.boussinesq import make_rayleigh_benard_case

            case = make_rayleigh_benard_case(nx=1536, ny=512, rayleigh=1e6,
                                             dtype=jnp.float32)
        else:
            continue
        state = Simulation(case, log=lambda *a: None).initial_state()
        _, cyc, wall, compile_s, n = _timed_steps(make_step(case), state,
                                                  steps, chunk)
        sps = n / wall
        cells = case.grid.n_fluid
        print(json.dumps({
            "metric": f"cell-steps/sec, {name} "
                      f"{case.grid.nx}x{case.grid.ny} f32 "
                      f"({cyc:.1f} cycles/step, {sps:.1f} steps/s, "
                      f"compile {compile_s:.0f}s)",
            "value": round(cells * sps, 0),
            "unit": "cell-steps/sec",
            "vs_baseline": None,
            "device": device,
        }), flush=True)


def main() -> None:
    import jax.numpy as jnp

    from cfd_tpu.cases import make_cavity_case
    from cfd_tpu.runtime import device_info, enable_compile_cache
    from cfd_tpu.solver import Simulation, make_step

    device = device_info()
    if device["platform"] != "gpu":
        raise SystemExit(f"bench.py times a GPU; JAX found "
                         f"{device['platform']!r}")
    enable_compile_cache()
    n = int(os.environ.get("BENCH_N", 2048))
    steps = int(os.environ.get("BENCH_STEPS", 300))
    tol = float(os.environ.get("BENCH_TOL", 1e-6))
    dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[
        os.environ.get("BENCH_DTYPE", "f32")]
    chunk = int(os.environ.get("BENCH_CHUNK", 100))
    cases_env = os.environ.get(
        "BENCH_CASES", "channel,step,rb" if n == 2048 else "none")

    # The headline is measured first in the process (before other compiled
    # programs and their buffers exist) and printed last.
    case = make_cavity_case(n_interior=n, poisson="multigrid", dtype=dtype,
                            tolerance_factor=tol)
    state = Simulation(case, log=lambda *a: None).initial_state()
    _, mean_cycles, wall, compile_s, steps = _timed_steps(
        make_step(case), state, steps, chunk)
    del case, state

    if cases_env not in ("", "none"):
        _secondary_cases([c.strip() for c in cases_env.split(",")], device)

    updates_per_cell_step = 5.0 + (16.0 / 3.0) * mean_cycles
    cells = n * n
    value = cells * updates_per_cell_step * steps / wall
    steps_per_sec = steps / wall

    result = {
        "metric": f"cell-updates/sec, {n}^2 cavity f32 multigrid "
                  f"(tol {tol:g} rel, {mean_cycles:.1f} V-cycles/step, "
                  f"{steps_per_sec:.2f} steps/s, compile {compile_s:.0f}s)",
        "value": round(value, 0),
        "unit": "cell-updates/sec",
        "vs_baseline": None,
        "device": device,
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
