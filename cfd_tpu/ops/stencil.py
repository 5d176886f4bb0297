"""MAC-grid stencil operators as whole-array shifted expressions.

Vectorized equivalent of the reference's per-cell C++ loops (L1 numerics
layer): predictor (advection + diffusion + Forward-Euler,
cavity-01.cpp:548-603 / channel-01.cpp:546-603 / masked variant
backwards_step-01.cpp:745-820), divergence source build
(cavity-01.cpp:622-630, channel-01.cpp:608-629), pressure-gradient corrector
(cavity-01.cpp:695-711, channel-01.cpp:693-702, masked
backwards_step-01.cpp:944-976), center interpolation (cavity-01.cpp:717-733)
and writer-side vorticity (cavity-01.cpp:184-224).

Each operator evaluates the stencil over the full padded array via
``jnp.roll`` shifts and selects the written region with precomputed masks —
one fused pass under XLA, and automatically halo-exchanged under GSPMD
sharding.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from cfd_tpu.grid import Grid


def iota_masks(grid: Grid) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(cell, u_valid, v_valid) masks as broadcasted-iota expressions for
    RECTANGLE (mask-free) grids.

    Called INSIDE a jitted step these fuse to in-register compares — unlike
    the precomputed numpy mask arrays, which are program constants streamed
    from HBM on every use (~4 MB each at 2048^2, several reads per step).
    Masked-geometry grids must keep the array masks (grid.u_valid_mask).
    """
    ny, nx = grid.ny, grid.nx
    jj = jax.lax.broadcasted_iota(jnp.int32, grid.shape, 0)
    ii = jax.lax.broadcasted_iota(jnp.int32, grid.shape, 1)
    cell = (jj >= 1) & (jj <= ny) & (ii >= 1) & (ii <= nx)
    u_valid = (jj >= 1) & (jj <= ny) & (ii >= 1) & (ii <= nx - 1)
    v_valid = (jj >= 1) & (jj <= ny - 1) & (ii >= 1) & (ii <= nx)
    return cell, u_valid, v_valid


def _sh(a: jnp.ndarray, dj: int, di: int) -> jnp.ndarray:
    """shifted[j, i] = a[j + dj, i + di] (wraparound never read: all
    consumers mask to regions where the stencil stays in bounds)."""
    return jnp.roll(a, shift=(-dj, -di), axis=(0, 1))


@dataclasses.dataclass(frozen=True)
class StencilCoeffs:
    """Host-side scalar coefficients shared by the stencil ops."""

    dx: float
    dy: float
    dt: float
    viscosity: float
    density: float = 1.0

    @property
    def idx(self) -> float:
        return 1.0 / self.dx

    @property
    def idy(self) -> float:
        return 1.0 / self.dy

    @property
    def idx2(self) -> float:
        return 1.0 / (self.dx * self.dx)

    @property
    def idy2(self) -> float:
        return 1.0 / (self.dy * self.dy)


def predictor(
    u: jnp.ndarray,
    v: jnp.ndarray,
    c: StencilCoeffs,
    u_valid: jnp.ndarray,
    v_valid: jnp.ndarray,
    fx: jnp.ndarray | None = None,
    fy: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Tentative velocities u*, v*: 2nd-order central diffusion plus
    flux-form (skew-symmetric) central convection, Forward-Euler update
    (cavity-01.cpp:548-603 with anisotropic spacings per
    channel-01.cpp:546-603).

    ``fx``/``fy``: optional body-force (momentum source) arrays on the
    u-/v-faces, added as +dt*f — the framework extension the reference has
    no analog for (body forces, MMS verification sources; see
    cfd_tpu.validation.manufactured_solution).

    Outside the valid-face masks the result is 0, matching the reference's
    zeroed invalid faces (backwards_step-01.cpp:758-761) and the
    never-written boundary faces that stay 0 from allocation.
    """
    nu, dt, idx, idy, idx2, idy2 = c.viscosity, c.dt, c.idx, c.idy, c.idx2, c.idy2

    uE, uW, uN, uS = _sh(u, 0, 1), _sh(u, 0, -1), _sh(u, 1, 0), _sh(u, -1, 0)
    vE, vW, vN, vS = _sh(v, 0, 1), _sh(v, 0, -1), _sh(v, 1, 0), _sh(v, -1, 0)

    # --- u-momentum on x-faces (cavity-01.cpp:553-575) ---
    lap_u = (uE - 2.0 * u + uW) * idx2 + (uN - 2.0 * u + uS) * idy2
    u_e = 0.5 * (u + uE)
    u_w = 0.5 * (uW + u)
    conv_ux = (u_e * u_e - u_w * u_w) * idx
    v_n = 0.5 * (v + vE)
    v_s = 0.5 * (vS + _sh(v, -1, 1))  # v[j-1,i], v[j-1,i+1]
    u_n = 0.5 * (uN + u)
    u_s = 0.5 * (uS + u)
    conv_uy = (v_n * u_n - v_s * u_s) * idy
    u_star = u + dt * (nu * lap_u - conv_ux - conv_uy
                       + (fx if fx is not None else 0.0))

    # --- v-momentum on y-faces (cavity-01.cpp:579-601) ---
    lap_v = (vE - 2.0 * v + vW) * idx2 + (vN - 2.0 * v + vS) * idy2
    v_nn = 0.5 * (v + vN)
    v_ss = 0.5 * (vS + v)
    conv_vy = (v_nn * v_nn - v_ss * v_ss) * idy
    u_e2 = 0.5 * (u + uN)  # u[j,i], u[j+1,i]
    u_w2 = 0.5 * (uW + _sh(u, 1, -1))  # u[j,i-1], u[j+1,i-1]
    v_e2 = 0.5 * (v + vE)
    v_w2 = 0.5 * (vW + v)
    conv_vx = (u_e2 * v_e2 - u_w2 * v_w2) * idx
    v_star = v + dt * (nu * lap_v - conv_vy - conv_vx
                       + (fy if fy is not None else 0.0))

    zero = jnp.zeros_like(u)
    return jnp.where(u_valid, u_star, zero), jnp.where(v_valid, v_star, zero)


def divergence(u: jnp.ndarray, v: jnp.ndarray, c: StencilCoeffs, cell_mask: jnp.ndarray) -> jnp.ndarray:
    """Discrete divergence at cell centers:
    (u[j,i]-u[j,i-1])/dx + (v[j,i]-v[j-1,i])/dy on masked cells
    (cavity-01.cpp:624-627, channel-01.cpp:614-615)."""
    div = (u - _sh(u, 0, -1)) * c.idx + (v - _sh(v, -1, 0)) * c.idy
    return jnp.where(cell_mask, div, jnp.zeros_like(div))


def poisson_source(
    u_star: jnp.ndarray,
    v_star: jnp.ndarray,
    c: StencilCoeffs,
    cell_mask: jnp.ndarray,
    remove_mean: bool,
    n_cells: int,
) -> jnp.ndarray:
    """b = (rho/dt) * div(u*), optionally minus its fluid-cell mean
    (the channel compatibility trick, channel-01.cpp:608-629; masked
    variant backwards_step-01.cpp:825-866: reference only subtracts when
    max|b| > 0, which holds except in the trivial all-zero case where
    subtracting the zero mean is a no-op anyway)."""
    b = (c.density / c.dt) * divergence(u_star, v_star, c, cell_mask)
    if remove_mean:
        mean = jnp.sum(b) / n_cells  # b is 0 outside mask
        b = jnp.where(cell_mask, b - mean, b)
    return b


def pressure_correction(
    u_star: jnp.ndarray,
    v_star: jnp.ndarray,
    p: jnp.ndarray,
    c: StencilCoeffs,
    u_valid: jnp.ndarray,
    v_valid: jnp.ndarray,
    u_else: jnp.ndarray,
    v_else: jnp.ndarray,
    cavity_form: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Projection: u = u* - dt/(rho*dx) * (p[j,i+1]-p[j,i]) on valid u-faces
    (channel-01.cpp:693-702). ``cavity_form`` reproduces the cavity's
    rho-multiplied variant dt/h * rho * dp (cavity-01.cpp:701,708) —
    identical at rho=1 but kept for exact parity.

    ``u_else``/``v_else``: values outside the valid masks — the pre-step
    BC-applied fields for mask-free cases (reference leaves those entries
    untouched) or zeros on invalid faces for masked geometry
    (backwards_step-01.cpp:956,972).
    """
    if cavity_form:
        cu = c.dt / c.dx * c.density
        cv = c.dt / c.dy * c.density
    else:
        cu = c.dt / (c.density * c.dx)
        cv = c.dt / (c.density * c.dy)
    u_new = u_star - cu * (_sh(p, 0, 1) - p)
    v_new = v_star - cv * (_sh(p, 1, 0) - p)
    return jnp.where(u_valid, u_new, u_else), jnp.where(v_valid, v_new, v_else)


def interpolate_to_centers(
    u: jnp.ndarray, v: jnp.ndarray, cell_mask: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Two-point face-to-center averages on masked cells, zero elsewhere
    (cavity-01.cpp:717-733; masked zero-fill backwards_step-01.cpp:985-1009)."""
    uc = 0.5 * (_sh(u, 0, -1) + u)
    vc = 0.5 * (_sh(v, -1, 0) + v)
    zero = jnp.zeros_like(u)
    return jnp.where(cell_mask, uc, zero), jnp.where(cell_mask, vc, zero)


def vorticity_centers(
    uc: jnp.ndarray, vc: jnp.ndarray, grid: Grid, c: StencilCoeffs
) -> jnp.ndarray:
    """Vorticity dv/dx - du/dy from center velocities: central differences
    in the interior, one-sided at domain boundaries, exactly as the VTK
    writer computes it (cavity-01.cpp:184-224; rectangular variant
    channel-01.cpp:176-207).

    Note the reference uses ``1/grid_spacing`` for both directions in the
    cavity writer and dx/dy in the channel/step writers; this takes dx, dy
    from the coefficients, which coincide for the cavity's square grid.

    Returns vorticity on the padded array (interior cells only; 0 outside).
    """
    nx, ny = grid.nx, grid.ny
    idx, idy = c.idx, c.idy

    central_x = (_sh(vc, 0, 1) - _sh(vc, 0, -1)) * (0.5 * idx)
    fwd_x = (_sh(vc, 0, 1) - vc) * idx
    bwd_x = (vc - _sh(vc, 0, -1)) * idx
    col = jnp.arange(vc.shape[1])[None, :]
    row = jnp.arange(vc.shape[0])[:, None]
    dvdx = jnp.where(col == 1, fwd_x, jnp.where(col == nx, bwd_x, central_x))

    central_y = (_sh(uc, 1, 0) - _sh(uc, -1, 0)) * (0.5 * idy)
    fwd_y = (_sh(uc, 1, 0) - uc) * idy
    bwd_y = (uc - _sh(uc, -1, 0)) * idy
    dudy = jnp.where(row == 1, fwd_y, jnp.where(row == ny, bwd_y, central_y))

    w = dvdx - dudy
    interior = (row >= 1) & (row <= ny) & (col >= 1) & (col <= nx)
    return jnp.where(interior, w, jnp.zeros_like(w))
