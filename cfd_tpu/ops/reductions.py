"""Jitted flow diagnostics returning scalar dicts.

Vectorized equivalent of logStatistics (cavity-01.cpp:741-774,
channel-01.cpp:733-769, masked variant backwards_step-01.cpp:1018-1061):
max |div(u)| on staggered faces and total/average kinetic energy at cell
centers, restricted to fluid cells. Under GSPMD sharding these reductions
lower to psum/pmax collectives automatically.
"""

from __future__ import annotations

import jax.numpy as jnp

from cfd_tpu.ops.stencil import StencilCoeffs, divergence, interpolate_to_centers


def flow_statistics(
    u: jnp.ndarray,
    v: jnp.ndarray,
    c: StencilCoeffs,
    cell_mask: jnp.ndarray,
    n_cells: int,
) -> dict[str, jnp.ndarray]:
    """Returns {max_divergence, avg_kinetic_energy, total_kinetic_energy}.

    ``n_cells``: the reference's KE divisor — nx*ny for cavity/channel
    (cavity-01.cpp:766, channel-01.cpp:760), fluid-cell count for the
    masked step solver (backwards_step-01.cpp:1055).
    """
    uc, vc = interpolate_to_centers(u, v, cell_mask)
    ke = 0.5 * jnp.sum(uc * uc + vc * vc)  # 0 outside mask already
    div = divergence(u, v, c, cell_mask)
    return {
        "max_divergence": jnp.max(jnp.abs(div)),
        "total_kinetic_energy": ke,
        "avg_kinetic_energy": ke / n_cells,
    }
