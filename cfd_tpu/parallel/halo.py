"""One-cell halo exchange for local ghost-ring blocks inside shard_map.

The CFD analog of sequence-parallel ring communication (SURVEY.md section
2.3): every stencil sweep needs the 1-cell-wide ghost strips of the four
mesh neighbors, exchanged with ``lax.ppermute`` neighbor shifts.
Physical domain boundaries have no neighbor; their ghost entries are left
untouched (the BC functors own them) by masking the ppermute result with the
device's mesh coordinates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _shift_perm(n: int, direction: int) -> list[tuple[int, int]]:
    """Non-periodic neighbor permutation: direction +1 sends to index+1."""
    if direction > 0:
        return [(i, i + 1) for i in range(n - 1)]
    return [(i + 1, i) for i in range(n - 1)]


def exchange_halos(f: jnp.ndarray, axis_y: str = "dy", axis_x: str = "dx") -> jnp.ndarray:
    """Fill the ghost ring of a local padded block from mesh neighbors.

    ``f`` is (ly+2, lx+2) with a 1-cell ghost ring. Interior-facing ghosts
    are overwritten with neighbor edge strips; domain-facing ghosts keep
    their current (BC-owned) values. The y-then-x ordering also fills the
    diagonal ghost corners without explicit corner messages: the x exchange
    ships full columns whose ghost rows were just filled by the y exchange,
    so a corner ghost receives the x-neighbor's already-correct y-ghost
    value (the MAC predictor reads diagonals: v[j-1,i+1], u[j+1,i-1]).
    """
    jy = lax.axis_index(axis_y)
    ny_dev = lax.axis_size(axis_y)
    jx = lax.axis_index(axis_x)
    nx_dev = lax.axis_size(axis_x)

    # --- y axis: send top interior row up, bottom interior row down ---
    if ny_dev > 1:
        top_row = f[-2:-1, :]
        from_south = lax.ppermute(top_row, axis_y, _shift_perm(ny_dev, +1))
        f = f.at[0:1, :].set(jnp.where(jy > 0, from_south, f[0:1, :]))
        bottom_row = f[1:2, :]
        from_north = lax.ppermute(bottom_row, axis_y, _shift_perm(ny_dev, -1))
        f = f.at[-1:, :].set(jnp.where(jy < ny_dev - 1, from_north, f[-1:, :]))

    # --- x axis ---
    if nx_dev > 1:
        right_col = f[:, -2:-1]
        from_west = lax.ppermute(right_col, axis_x, _shift_perm(nx_dev, +1))
        f = f.at[:, 0:1].set(jnp.where(jx > 0, from_west, f[:, 0:1]))
        left_col = f[:, 1:2]
        from_east = lax.ppermute(left_col, axis_x, _shift_perm(nx_dev, -1))
        f = f.at[:, -1:].set(jnp.where(jx < nx_dev - 1, from_east, f[:, -1:]))

    return f


def pad_local(block: jnp.ndarray) -> jnp.ndarray:
    """Add a zero ghost ring around a local interior block."""
    return jnp.pad(block, 1)


def unpad_local(f: jnp.ndarray) -> jnp.ndarray:
    return f[1:-1, 1:-1]


def global_max(x: jnp.ndarray, axis_y: str = "dy", axis_x: str = "dx") -> jnp.ndarray:
    """max over all devices (the residual/divergence infinity-norm reduction,
    channel-01.cpp:672-681 made collective)."""
    return lax.pmax(lax.pmax(x, axis_y), axis_x)


def global_sum(x: jnp.ndarray, axis_y: str = "dy", axis_x: str = "dx") -> jnp.ndarray:
    """sum over all devices (mean-source removal, KE totals)."""
    return lax.psum(lax.psum(x, axis_y), axis_x)
