"""MG knob sweep at 2048^2 on the GPU.

For each (pre_sweeps, post_sweeps, min_coarse) variant: compile the fused
cavity step, run warmup + timed chunks, report steps/s, mean V-cycles/step,
and the final residual vs tolerance so a faster-but-nonconverging config is
visible immediately. Usage: python tools/mg_tune.py [N]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import time

import jax
import jax.numpy as jnp

from cfd_tpu.cases import make_cavity_case
from cfd_tpu.solver import Simulation, make_step


def run_variant(n, overrides, steps=200, chunk=100):
    case = make_cavity_case(n_interior=n, poisson="multigrid",
                            dtype=jnp.float32, tolerance_factor=1e-6,
                            mg_overrides=overrides)
    step_fn = make_step(case)

    @jax.jit
    def multi(state):
        def body(s, _):
            s2, d = step_fn(s)
            return s2, (d.poisson_iters, d.poisson_residual)
        return jax.lax.scan(body, state, None, length=chunk)

    state = Simulation(case, log=lambda *a: None).initial_state()
    t0 = time.perf_counter()
    state, _ = multi(state)
    jax.block_until_ready(state.u)
    compile_s = time.perf_counter() - t0
    n_chunks = max(1, steps // chunk)
    iters_all, res_last = [], None
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        state, (iters, res) = multi(state)
        iters_all.append(iters)
        res_last = res
    jax.block_until_ready(state.u)
    wall = time.perf_counter() - t0
    sps = n_chunks * chunk / wall
    mean_cycles = float(sum(int(i.sum()) for i in iters_all)) / (n_chunks * chunk)
    return sps, mean_cycles, float(res_last[-1]), compile_s


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    from cfd_tpu.runtime import device_info, enable_compile_cache

    enable_compile_cache()
    print(device_info(), flush=True)
    variants = [
        # overrides apply to the cavity factory's default V(2,1), min_coarse 4
        ("V(2,1) mc4 (default)", {}),
        ("V(2,2) mc4", {"post_sweeps": 2}),
        ("V(1,2) mc4", {"pre_sweeps": 1, "post_sweeps": 2}),
        ("V(1,1) mc4", {"pre_sweeps": 1}),
        ("V(2,1) mc16", {"min_coarse": 16}),
        ("V(2,1) mc32", {"min_coarse": 32}),
        ("V(1,2) mc32", {"pre_sweeps": 1, "post_sweeps": 2, "min_coarse": 32}),
        ("V(1,1) mc32", {"pre_sweeps": 1, "min_coarse": 32}),
    ]
    for name, ov in variants:
        try:
            sps, cyc, res, comp = run_variant(n, ov)
            print(f"{name:24s} {sps:8.1f} steps/s  {cyc:5.2f} cyc/step  "
                  f"res={res:9.2e}  compile={comp:.0f}s", flush=True)
        except Exception as e:  # noqa: BLE001
            print(f"{name:24s} FAILED: {type(e).__name__}: {e}", flush=True)


if __name__ == "__main__":
    main()
