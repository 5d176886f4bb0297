"""Finite-Time Lyapunov Exponent (FTLE) fields from saved velocity frames.

The reference shows FTLE animations for the Rayleigh-Benard case with no
code in its repo (README.md:87-94; RB1_FTLE.gif,
FTLE_HeatedBottomCooledTop_192x64_Ra1E6.gif in .MISSING_LARGE_BLOBS). Built
from the standard definition: seed a particle grid, advect through the
time-resolved velocity, take the flow-map Jacobian by finite differences on
the seed grid, and report ln(sqrt(lambda_max(C))) / |T| with C the
Cauchy-Green tensor.

Design: particles are dense (S_y, S_x) coordinate arrays, RK4
advection with bilinear space + linear time interpolation is a `lax.scan`
over frame intervals — one jitted program for the whole integration, no
per-particle Python.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.ndimage import map_coordinates

from cfd_tpu.grid import Grid


def _sample(field: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
            dx: float, dy: float) -> jnp.ndarray:
    """Bilinear sample of a padded cell-center field at physical (x, y).

    Center (j, i) sits at x = (i - 0.5) dx, y = (j - 0.5) dy; the ghost ring
    carries BC-consistent values so near-wall samples interpolate correctly.
    """
    fi = x / dx + 0.5
    fj = y / dy + 0.5
    return map_coordinates(field, [fj, fi], order=1, mode="nearest")


@partial(jax.jit, static_argnames=("n_sub",))
def _advect(xy, frames_u, frames_v, dts, dx, dy, lx, ly, n_sub: int):
    """RK4 particle advection through consecutive frames (scan over frame
    intervals, fori over substeps). dts[k] spans frames k -> k+1."""

    def vel(k, frac, x, y):
        """velocity at time-fraction frac within interval k (linear blend)."""
        u0 = _sample(frames_u[k], x, y, dx, dy)
        v0 = _sample(frames_v[k], x, y, dx, dy)
        u1 = _sample(frames_u[k + 1], x, y, dx, dy)
        v1 = _sample(frames_v[k + 1], x, y, dx, dy)
        return u0 * (1 - frac) + u1 * frac, v0 * (1 - frac) + v1 * frac

    def interval(carry, k):
        x, y = carry
        h = dts[k] / n_sub

        def substep(s, xy):
            x, y = xy
            f0 = s / n_sub
            fh = (s + 0.5) / n_sub
            f1 = (s + 1.0) / n_sub
            k1u, k1v = vel(k, f0, x, y)
            k2u, k2v = vel(k, fh, x + 0.5 * h * k1u, y + 0.5 * h * k1v)
            k3u, k3v = vel(k, fh, x + 0.5 * h * k2u, y + 0.5 * h * k2v)
            k4u, k4v = vel(k, f1, x + h * k3u, y + h * k3v)
            x = x + h / 6.0 * (k1u + 2 * k2u + 2 * k3u + k4u)
            y = y + h / 6.0 * (k1v + 2 * k2v + 2 * k3v + k4v)
            # particles stay in the closed domain (no-slip walls)
            return jnp.clip(x, 0.0, lx), jnp.clip(y, 0.0, ly)

        xy2 = jax.lax.fori_loop(0, n_sub, substep, (x, y))
        return xy2, None

    (x, y), _ = jax.lax.scan(interval, xy, jnp.arange(dts.shape[0]))
    return x, y


def ftle_field(frames_u: jnp.ndarray, frames_v: jnp.ndarray,
               times: jnp.ndarray, grid: Grid,
               n_seed_x: int = 192, n_seed_y: int = 64,
               n_sub: int = 2, backward: bool = False):
    """FTLE over the frame window.

    Args:
      frames_u, frames_v: (F, ny+2, nx+2) padded CENTER velocities at the
        saved times (use ops.interpolate_to_centers on saved states).
      times: (F,) frame times, increasing.
      backward: True computes the backward FTLE (attracting structures —
        what the reference GIFs visualize) by reversing frames and velocity
        sign.
    Returns:
      (ftle, xs, ys): (n_seed_y, n_seed_x) field and seed coordinates.
    """
    frames_u = jnp.asarray(frames_u)
    frames_v = jnp.asarray(frames_v)
    times = jnp.asarray(times)
    if backward:
        frames_u = -frames_u[::-1]
        frames_v = -frames_v[::-1]
        times = times[-1] - times[::-1]
    dts = times[1:] - times[:-1]

    dx_seed = grid.lx / n_seed_x
    dy_seed = grid.ly / n_seed_y
    xs = (jnp.arange(n_seed_x) + 0.5) * dx_seed
    ys = (jnp.arange(n_seed_y) + 0.5) * dy_seed
    x0, y0 = jnp.meshgrid(xs, ys)

    xf, yf = _advect((x0, y0), frames_u, frames_v, dts,
                     grid.dx, grid.dy, grid.lx, grid.ly, n_sub)

    # flow-map Jacobian by central differences on the seed grid (one-sided
    # at the boundary via edge padding of the final positions)
    def grad(a, axis, h):
        ap = jnp.pad(a, 1, mode="edge")
        if axis == 0:
            d = (ap[2:, 1:-1] - ap[:-2, 1:-1]) / (2 * h)
            # one-sided rows at the boundary used a copied edge -> halve span
            d = d.at[0, :].multiply(2.0).at[-1, :].multiply(2.0)
        else:
            d = (ap[1:-1, 2:] - ap[1:-1, :-2]) / (2 * h)
            d = d.at[:, 0].multiply(2.0).at[:, -1].multiply(2.0)
        return d

    dxdx0 = grad(xf, 1, dx_seed)
    dxdy0 = grad(xf, 0, dy_seed)
    dydx0 = grad(yf, 1, dx_seed)
    dydy0 = grad(yf, 0, dy_seed)

    # Cauchy-Green C = F^T F, largest eigenvalue of the 2x2 SPD matrix
    a = dxdx0**2 + dydx0**2
    b = dxdx0 * dxdy0 + dydx0 * dydy0
    d = dxdy0**2 + dydy0**2
    lam_max = 0.5 * (a + d) + jnp.sqrt(jnp.maximum(0.25 * (a - d) ** 2 + b * b, 0.0))
    span = jnp.abs(times[-1] - times[0])
    return jnp.log(jnp.maximum(lam_max, 1e-30)) / (2.0 * span), xs, ys


class FrameCollector:
    """Exporter-chainable callback that stores padded center-velocity frames
    for FTLE post-processing (the reference's FTLE GIFs are rendered from
    the saved velocity time series)."""

    def __init__(self, grid: Grid, inner=None, max_frames: int | None = None):
        from cfd_tpu.ops.stencil import interpolate_to_centers

        cell = jnp.asarray(grid.cell_mask)
        self._interp = jax.jit(lambda u, v: interpolate_to_centers(u, v, cell))
        self.inner = inner  # optional wrapped exporter (e.g. VTKExporter)
        self.max_frames = max_frames
        self.times: list[float] = []
        self.frames_u: list = []
        self.frames_v: list = []

    def __call__(self, state, step: int, time_value: float):
        uc, vc = self._interp(state.u, state.v)
        self.times.append(time_value)
        self.frames_u.append(uc)
        self.frames_v.append(vc)
        if self.max_frames is not None and len(self.times) > self.max_frames:
            self.times.pop(0)
            self.frames_u.pop(0)
            self.frames_v.pop(0)
        if self.inner is not None:
            self.inner(state, step, time_value)

    def write_collection(self):
        if self.inner is not None and hasattr(self.inner, "write_collection"):
            self.inner.write_collection()

    def ftle(self, grid: Grid, backward: bool = True, n_sub: int = 2,
             n_seed_x: int | None = None, n_seed_y: int | None = None):
        return ftle_field(jnp.stack(self.frames_u), jnp.stack(self.frames_v),
                          jnp.asarray(self.times), grid,
                          n_seed_x=n_seed_x or grid.nx,
                          n_seed_y=n_seed_y or grid.ny,
                          n_sub=n_sub, backward=backward)


def write_ftle_vtk(path, grid: Grid, ftle, time_value: float,
                   title: str = "FTLE Data"):
    """Minimal STRUCTURED_POINTS snapshot of an FTLE field (same format
    family as the flow snapshots, loadable in the same ParaView pipeline)."""
    import io as _io
    from pathlib import Path

    import numpy as np

    f = np.asarray(ftle)
    sy, sx = f.shape
    buf = _io.StringIO()
    buf.write("# vtk DataFile Version 3.0\n")
    buf.write(f"{title} - Time: {time_value:.6f}\n")
    buf.write("ASCII\nDATASET STRUCTURED_POINTS\n")
    buf.write(f"DIMENSIONS {sx} {sy} 1\n")
    buf.write(f"ORIGIN {grid.lx / sx / 2:.6f} {grid.ly / sy / 2:.6f} 0.0\n")
    buf.write(f"SPACING {grid.lx / sx:.6f} {grid.ly / sy:.6f} 1.0\n")
    buf.write(f"POINT_DATA {sx * sy}\n")
    buf.write("SCALARS ftle double 1\nLOOKUP_TABLE default\n")
    buf.write("\n".join(np.char.mod("%.6f", f.ravel())) + "\n")
    Path(path).write_text(buf.getvalue())


def center_frames(states, grid: Grid):
    """Stack padded center velocities from a list of States (helper for
    driving ftle_field from Simulation history/checkpoints)."""
    from cfd_tpu.ops.stencil import interpolate_to_centers

    cell = jnp.asarray(grid.cell_mask)
    us, vs = [], []
    for s in states:
        uc, vc = interpolate_to_centers(s.u, s.v, cell)
        us.append(uc)
        vs.append(vc)
    return jnp.stack(us), jnp.stack(vs)
