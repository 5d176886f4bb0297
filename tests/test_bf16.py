"""bfloat16 compute-path accuracy band (gates the BENCH_DTYPE=bf16 knob).

bf16 (8-bit mantissa) cannot meet the reference's 1e-6-relative divergence
tolerances — the Poisson stall cutoff floors at bf16 roundoff — but the
integral flow quantities track f32 closely: measured KE deviation at 128^2
after 200 cavity steps is ~3.3%. This test pins that band so the bench knob
is a validated throughput/experimentation mode, not a trap: KE within 5%
of f32, divergence bounded, no blowup.
"""

import jax.numpy as jnp
import pytest

from cfd_tpu.cases import make_cavity_case
from cfd_tpu.solver import Simulation


def _march(dtype, n=128, steps=200):
    case = make_cavity_case(n_interior=n, poisson="multigrid", dtype=dtype,
                            tolerance_factor=1e-6)
    sim = Simulation(case, log=lambda *a: None)
    st = sim.initial_state()
    for _ in range(steps):
        st, _ = sim._step(st)
    return sim.statistics(st)


@pytest.mark.slow
def test_bf16_trajectory_band_vs_f32():
    f32 = _march(jnp.float32)
    bf16 = _march(jnp.bfloat16)
    ke_f, ke_b = f32["avg_kinetic_energy"], bf16["avg_kinetic_energy"]
    assert ke_b == ke_b, "bf16 KE is NaN"
    assert abs(ke_b / ke_f - 1.0) < 0.05, (ke_b, ke_f)
    # divergence floors at bf16 roundoff, far above f32, but must stay
    # bounded (projection keeps acting)
    assert bf16["max_divergence"] < 1.0
