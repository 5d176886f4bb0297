"""Vectorized ghost-cell boundary conditions.

The reference's L2 boundary layer: each BC is a pure function
``(u, v) -> (u, v)`` (or ``p -> p`` for pressure ghosts) made of index
updates (``put``), applied in the reference's exact sequence so the produced
arrays match the C++ loops bit-for-bit (up to dtype).

Reference code: cavity-01.cpp:523-543, channel-01.cpp:513-541,
backwards_step-01.cpp:616-740.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from cfd_tpu.grid import Grid
from cfd_tpu.ops.stencil import _sh

VelocityBC = Callable[[jnp.ndarray, jnp.ndarray], tuple[jnp.ndarray, jnp.ndarray]]
PressureBC = Callable[[jnp.ndarray], jnp.ndarray]


def put(a: jnp.ndarray, rows: slice, cols: slice, value) -> jnp.ndarray:
    """``a.at[rows, cols].set(value[rows, cols])`` as a select over the
    whole array; ``value`` is a scalar or an array of a's shape (a shifted
    copy of ``a`` for ghost reflections). A select partitions over row and
    column shards as it stands, where XLA's SPMD partitioner miscompiles the
    row-slice scatter on row-sharded arrays."""
    jj = jax.lax.broadcasted_iota(jnp.int32, a.shape, 0)
    ii = jax.lax.broadcasted_iota(jnp.int32, a.shape, 1)
    m = ((jj >= rows.start) & (jj < rows.stop)
         & (ii >= cols.start) & (ii < cols.stop))
    return jnp.where(m, jnp.asarray(value, a.dtype), a)


def _r(j):  # one row or column
    return slice(j, j + 1)


def lid_cavity_bc(grid: Grid, lid_velocity: float) -> VelocityBC:
    """Moving-lid + no-slip ghost BCs (cavity-01.cpp:523-543).

    North lid u-ghost = 2*U_lid - u_interior; south u-ghost antisymmetric;
    east/west v-ghosts antisymmetric. Wall-normal face velocities (u at
    i=0/i_max, v at j=0/j_max) are never written — they stay 0 from init.
    """
    nx, ny = grid.nx, grid.ny

    def bc(u: jnp.ndarray, v: jnp.ndarray):
        u = put(u, _r(ny + 1), slice(0, nx + 1), 2.0 * lid_velocity - _sh(u, -1, 0))
        u = put(u, _r(0), slice(0, nx + 1), -_sh(u, 1, 0))
        v = put(v, slice(0, ny + 1), _r(nx + 1), -_sh(v, 0, -1))
        v = put(v, slice(0, ny + 1), _r(0), -_sh(v, 0, 1))
        return u, v

    return bc


def channel_bc(grid: Grid, inlet_velocity: float) -> VelocityBC:
    """Inflow/outflow channel BCs (channel-01.cpp:513-529), in the
    reference's update order: inlet u/v, outlet u/v (zero-gradient), bottom
    wall v/u, top wall v/u."""
    nx, ny = grid.nx, grid.ny

    def bc(u: jnp.ndarray, v: jnp.ndarray):
        u = put(u, slice(1, ny + 1), _r(0), inlet_velocity)
        v = put(v, slice(0, ny + 1), _r(0), 0.0)
        u = put(u, slice(1, ny + 1), _r(nx), _sh(u, 0, -1))
        v = put(v, slice(0, ny + 1), _r(nx + 1), _sh(v, 0, -1))
        v = put(v, _r(0), slice(1, nx + 1), 0.0)
        u = put(u, _r(0), slice(0, nx + 1), -_sh(u, 1, 0))
        v = put(v, _r(ny), slice(1, nx + 1), 0.0)
        u = put(u, _r(ny + 1), slice(0, nx + 1), -_sh(u, -1, 0))
        return u, v

    return bc


def step_bc(grid: Grid, inlet_velocity: float, inlet_j_max: int) -> VelocityBC:
    """Channel BCs restricted to the inlet rows plus solid-interface
    face zeroing (backwards_step-01.cpp:616-683).

    The interface sweep is precomputed into face masks (grid.u_zero_mask /
    v_zero_mask) and applied as a single vectorized select.
    """
    nx, ny = grid.nx, grid.ny
    u_zero = jnp.asarray(grid.u_zero_mask)
    v_zero = jnp.asarray(grid.v_zero_mask)

    def bc(u: jnp.ndarray, v: jnp.ndarray):
        u = put(u, slice(1, inlet_j_max + 1), _r(0), inlet_velocity)
        u = put(u, slice(inlet_j_max + 1, ny + 1), _r(0), 0.0)
        v = put(v, slice(0, ny + 1), _r(0), 0.0)
        u = put(u, slice(1, ny + 1), _r(nx), _sh(u, 0, -1))
        v = put(v, slice(0, ny + 1), _r(nx + 1), _sh(v, 0, -1))
        v = put(v, _r(0), slice(1, nx + 1), 0.0)
        u = put(u, _r(0), slice(0, nx + 1), -_sh(u, 1, 0))
        v = put(v, _r(ny), slice(1, nx + 1), 0.0)
        u = put(u, _r(ny + 1), slice(0, nx + 1), -_sh(u, -1, 0))
        u = jnp.where(u_zero, jnp.zeros_like(u), u)
        v = jnp.where(v_zero, jnp.zeros_like(v), v)
        return u, v

    return bc


def channel_pressure_ghosts(grid: Grid) -> PressureBC:
    """Inlet Neumann, outlet Dirichlet p=0 in the ghost column (the
    reference pressure pin), wall Neumann (channel-01.cpp:531-541)."""
    nx, ny = grid.nx, grid.ny

    def ghosts(p: jnp.ndarray) -> jnp.ndarray:
        p = put(p, slice(1, ny + 1), _r(0), _sh(p, 0, 1))
        p = put(p, slice(1, ny + 1), _r(nx + 1), 0.0)
        p = put(p, _r(0), slice(1, nx + 1), _sh(p, 1, 0))
        p = put(p, _r(ny + 1), slice(1, nx + 1), _sh(p, -1, 0))
        return p

    return ghosts


def step_pressure_ghosts(grid: Grid) -> PressureBC:
    """Channel domain ghosts plus solid-cell pressure = mean of fluid
    neighbors (Neumann across internal walls, backwards_step-01.cpp:685-740).

    The solid-cell averaging reads only fluid-cell values, so it is
    sweep-order independent and vectorizes exactly.
    """
    nx, ny = grid.nx, grid.ny
    base = channel_pressure_ghosts(grid)
    wE, wW, wN, wS, count = (jnp.asarray(w) for w in grid.solid_neighbor_weights)
    update_mask = jnp.asarray(grid.solid_interior_mask) & (count > 0)
    safe_count = jnp.where(count > 0, count, 1.0)

    def ghosts(p: jnp.ndarray) -> jnp.ndarray:
        p = base(p)
        pE = jnp.roll(p, -1, axis=1)
        pW = jnp.roll(p, 1, axis=1)
        pN = jnp.roll(p, -1, axis=0)
        pS = jnp.roll(p, 1, axis=0)
        avg = (wE * pE + wW * pW + wN * pN + wS * pS) / safe_count
        return jnp.where(update_mask, avg.astype(p.dtype), p)

    return ghosts
