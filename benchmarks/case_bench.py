"""At-scale throughput for the non-flagship cases (channel, backwards step,
Rayleigh-Benard) on one device.

Prints one JSON line per case:
  {"case": ..., "grid": ..., "steps_per_sec": ..., "cell_steps_per_sec": ...,
   "mean_poisson_cycles": ...}

cell_steps_per_sec = fluid cells x steps / wall (scheme-agnostic; the cavity
bench's cell-UPDATES metric additionally multiplies by the per-step update
count, which differs per case).

Usage: python benchmarks/case_bench.py [channel] [step] [rb]
Env: CB_STEPS (timed steps, default 40), CB_CHUNK (default 10).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def bench_case(name: str, case, steps: int, chunk: int):
    import jax

    from cfd_tpu.solver import Simulation, make_step

    step_fn = make_step(case)

    @jax.jit
    def multi(state):
        def body(s, _):
            s2, d = step_fn(s)
            return s2, d.poisson_iters

        return jax.lax.scan(body, state, None, length=chunk)

    state = Simulation(case, log=lambda *a: None).initial_state()
    t0 = time.perf_counter()
    state, iters = multi(state)
    jax.block_until_ready(state.u)
    compile_s = time.perf_counter() - t0

    n_chunks = max(1, steps // chunk)
    steps = n_chunks * chunk
    cycles = []
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        state, iters = multi(state)
        cycles.append(iters)
    jax.block_until_ready(state.u)
    wall = time.perf_counter() - t0

    mean_cycles = float(sum(int(c.sum()) for c in cycles)) / steps
    cells = case.grid.n_fluid
    print(json.dumps({
        "case": name,
        "grid": f"{case.grid.nx}x{case.grid.ny}",
        "steps_per_sec": round(steps / wall, 2),
        "cell_steps_per_sec": round(cells * steps / wall, 0),
        "mean_poisson_cycles": round(mean_cycles, 2),
        "compile_s": round(compile_s, 1),
    }), flush=True)


def main():
    import jax.numpy as jnp

    from cfd_tpu.cases import (
        make_backwards_step_case, make_channel_case, make_rayleigh_benard_case)

    wanted = sys.argv[1:] or ["channel", "step", "rb"]
    steps = int(os.environ.get("CB_STEPS", 40))
    chunk = int(os.environ.get("CB_CHUNK", 10))
    if "channel" in wanted:
        bench_case("channel", make_channel_case(
            nx=1536, ny=512, dtype=jnp.float32, poisson="multigrid",
            tolerance_factor=1e-6, abs_tol=0.0), steps, chunk)
    if "step" in wanted:
        bench_case("backwards_step", make_backwards_step_case(
            nx=2048, ny=256, dtype=jnp.float32, poisson="multigrid",
            tolerance_factor=1e-6, abs_tol=0.0), steps, chunk)
    if "rb" in wanted:
        bench_case("rayleigh_benard", make_rayleigh_benard_case(
            nx=1536, ny=512, rayleigh=1e6, dtype=jnp.float32), steps, chunk)


if __name__ == "__main__":
    main()
