"""Poisson solver benchmark: multigrid solves/sec and sweep-equivalents/sec
to 1e-6 relative residual, across grid sizes, plus the SOR comparison at reference scale.

Usage: python benchmarks/poisson_bench.py [sizes...]
Prints one JSON line per size.
"""

from __future__ import annotations

import json
import sys
import time


def main(sizes):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cfd_tpu.poisson.multigrid import MGConfig, cavity_problem, make_multigrid_poisson

    for n in sizes:
        prob = cavity_problem(n, n, 1.0 / n, 1.0 / n)
        cfg = MGConfig(tol_factor=1e-6)
        solve = jax.jit(make_multigrid_poisson(prob, cfg, jnp.float32))
        rng = np.random.default_rng(0)
        b = jnp.asarray(
            np.pad(rng.standard_normal((n, n)), 1), jnp.float32)
        p0 = jnp.zeros_like(b)
        p, cycles, res = solve(p0, b)
        jax.block_until_ready(p)
        k = 20
        t0 = time.perf_counter()
        for _ in range(k):
            p, cycles, res = solve(p0, b)
        jax.block_until_ready(p)
        dt = (time.perf_counter() - t0) / k
        cyc = int(cycles)
        # one V(2,2) cycle ~ (2+2+1) * 4/3 sweep-equivalents over n^2 cells
        sweep_equiv = cyc * (5 * 4 / 3)
        print(json.dumps({
            "metric": f"poisson multigrid {n}^2 to 1e-6 rel",
            "solve_ms": round(dt * 1e3, 2),
            "cycles": cyc,
            "residual": float(res),
            "cell_sweeps_per_sec": round(n * n * sweep_equiv / dt, 0),
            "solves_per_sec": round(1.0 / dt, 2),
        }))


if __name__ == "__main__":
    sizes = [int(a) for a in sys.argv[1:]] or [256, 512, 1024, 2048]
    main(sizes)
