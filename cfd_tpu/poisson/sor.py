"""Red-black SOR pressure-Poisson solvers.

The reference sweeps lexicographically (Gauss-Seidel ordering with stale
east/north values, cavity-01.cpp:640-656, channel-01.cpp:650-664), which is
inherently sequential. This solver uses red-black ordering: two
masked whole-array half-sweeps per iteration, each a fused whole-array pass. The
fixed point is the same linear system, so converged pressures match the
reference to solver tolerance (iteration counts differ by design —
SURVEY.md section 7 "hard parts").

Two reference-faithful flavors:

* ``make_eps_neumann_poisson`` — the cavity's indicator-function form
  (cavity-01.cpp:640-677): pure-Neumann handled via per-cell neighbor
  counts, with the reference's ``eps_s = 1`` quirk (cavity-01.cpp:647)
  whereby every interior cell counts a south neighbor; at j=1 that coupling
  reads the never-updated zero ghost row, which acts as a Dirichlet-0 pin
  and removes the Neumann nullspace. Cold-started from zero each solve
  (cavity-01.cpp:610-611 allocates fresh fields).

* ``make_ghost_poisson`` — the channel/step form (channel-01.cpp:635-688,
  backwards_step-01.cpp:872-939): standard anisotropic 5-point stencil,
  warm-started from the previous pressure, ghost cells refreshed via a BC
  functor every sweep, optional solid mask restricting updates/residuals to
  fluid cells.

Both run as ``lax.while_loop`` with a device-resident convergence flag — no
host syncs inside the solve. ``check_every`` amortizes the residual norm
(and its global reduction when sharded) over several sweeps; the default 1
mirrors the reference's per-sweep check.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from cfd_tpu.bc import PressureBC
from cfd_tpu.grid import Grid
from cfd_tpu.ops.stencil import StencilCoeffs, _sh


@dataclasses.dataclass(frozen=True)
class SORConfig:
    omega: float
    tol_factor: float  # relative tolerance vs max|b|
    abs_tol: float = 0.0  # floor (channel-01.cpp:647); 0 for cavity
    max_iters: int = 10000
    check_every: int = 1  # sweeps between residual checks


def _checkerboard(shape: tuple[int, int]) -> np.ndarray:
    j = np.arange(shape[0])[:, None]
    i = np.arange(shape[1])[None, :]
    return (i + j) % 2 == 0


def make_eps_neumann_poisson(
    grid: Grid, coeffs: StencilCoeffs, cfg: SORConfig
) -> Callable[[jnp.ndarray, jnp.ndarray], tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """Cavity-flavor Poisson solve. Returns fn(p_ignored, b) -> (p, iters, residual).

    The first argument is accepted for API uniformity but ignored — the
    cavity solve cold-starts from zeros (cavity-01.cpp:610-611).
    """
    if abs(grid.dx - grid.dy) > 1e-15 * max(grid.dx, grid.dy):
        raise ValueError("eps-Neumann (cavity) form requires a square grid")
    if grid.has_solids:
        raise ValueError("eps-Neumann form does not support solid masks")

    nx, ny = grid.nx, grid.ny
    shape = grid.shape
    h2 = grid.dx * grid.dy
    ih2 = 1.0 / h2
    omega = cfg.omega

    # Indicator functions (cavity-01.cpp:644-647)
    jj = np.arange(shape[0])[:, None]
    ii = np.arange(shape[1])[None, :]
    interior = (jj >= 1) & (jj <= ny) & (ii >= 1) & (ii <= nx)
    eps_e = ((ii < nx) & interior).astype(np.float64)
    eps_w = ((ii > 1) & interior).astype(np.float64)
    eps_n = ((jj < ny) & interior).astype(np.float64)
    eps_s = interior.astype(np.float64)  # the reference's always-on south
    ncount = eps_e + eps_w + eps_n + eps_s
    ncount_safe = np.where(ncount > 0, ncount, 1.0)

    red = jnp.asarray(_checkerboard(shape) & interior)
    black = jnp.asarray(~_checkerboard(shape) & interior)
    interior_j = jnp.asarray(interior)
    eE, eW, eN, eS = (jnp.asarray(e) for e in (eps_e, eps_w, eps_n, eps_s))
    ncount_j = jnp.asarray(ncount_safe)

    def half_sweep(p, b, mask):
        pE, pW = _sh(p, 0, 1), _sh(p, 0, -1)
        pN, pS = _sh(p, 1, 0), _sh(p, -1, 0)
        gs = (eE * pE + eW * pW + eN * pN + eS * pS - b * h2) / ncount_j
        upd = (1.0 - omega) * p + omega * gs
        return jnp.where(mask, upd.astype(p.dtype), p)

    def residual_inf(p, b):
        # eps-weighted Laplacian minus source (cavity-01.cpp:670-673)
        pE, pW = _sh(p, 0, 1), _sh(p, 0, -1)
        pN, pS = _sh(p, 1, 0), _sh(p, -1, 0)
        r = ih2 * (eE * (pE - p) + eW * (pW - p) + eN * (pN - p) + eS * (pS - p)) - b
        return jnp.max(jnp.abs(jnp.where(interior_j, r, jnp.zeros_like(r))))

    def solve(p0: jnp.ndarray, b: jnp.ndarray):
        del p0
        dtype = b.dtype
        tol = cfg.tol_factor * jnp.max(jnp.abs(b))
        p_init = jnp.zeros(shape, dtype=dtype)

        def cond(carry):
            _, res, it = carry
            return (res > tol) & (it < cfg.max_iters)

        def body(carry):
            p, _, it = carry

            def one(k, p):
                del k
                p = half_sweep(p, b, red)
                return half_sweep(p, b, black)

            p = jax.lax.fori_loop(0, cfg.check_every, one, p)
            return p, residual_inf(p, b), it + cfg.check_every

        init = (p_init, jnp.asarray(1.0, dtype), jnp.asarray(0, jnp.int32))
        p, res, iters = jax.lax.while_loop(cond, body, init)
        return p, iters, res

    return solve


def make_ghost_poisson(
    grid: Grid,
    coeffs: StencilCoeffs,
    cfg: SORConfig,
    ghosts: PressureBC,
) -> Callable[[jnp.ndarray, jnp.ndarray], tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """Channel/step-flavor Poisson solve. Returns fn(p_warm, b) -> (p, iters, residual)."""
    shape = grid.shape
    idx2, idy2 = coeffs.idx2, coeffs.idy2
    denom = 2.0 * (idx2 + idy2)
    omega = cfg.omega

    fluid = jnp.asarray(grid.cell_mask)
    cb = _checkerboard(shape)
    red = jnp.asarray(cb) & fluid
    black = jnp.asarray(~cb) & fluid

    def half_sweep(p, b, mask):
        pE, pW = _sh(p, 0, 1), _sh(p, 0, -1)
        pN, pS = _sh(p, 1, 0), _sh(p, -1, 0)
        gs = (idx2 * (pE + pW) + idy2 * (pN + pS) - b) / denom
        upd = (1.0 - omega) * p + omega * gs
        return jnp.where(mask, upd.astype(p.dtype), p)

    def residual_inf(p, b):
        # plain 5-point Laplacian minus source over fluid cells
        # (channel-01.cpp:672-681, backwards_step-01.cpp:917-930)
        lap = (_sh(p, 0, 1) - 2.0 * p + _sh(p, 0, -1)) * idx2 + (
            _sh(p, 1, 0) - 2.0 * p + _sh(p, -1, 0)
        ) * idy2
        r = lap - b
        return jnp.max(jnp.abs(jnp.where(fluid, r, jnp.zeros_like(r))))

    def solve(p_warm: jnp.ndarray, b: jnp.ndarray):
        dtype = b.dtype
        max_b = jnp.max(jnp.abs(b))
        tol = jnp.maximum(
            cfg.tol_factor * jnp.where(max_b > 0, max_b, jnp.ones_like(max_b)),
            jnp.asarray(cfg.abs_tol, dtype),
        )

        def cond(carry):
            _, res, it = carry
            return (res > tol) & (it < cfg.max_iters)

        def body(carry):
            p, _, it = carry

            def one(k, p):
                del k
                p = half_sweep(p, b, red)
                p = half_sweep(p, b, black)
                return ghosts(p)

            p = jax.lax.fori_loop(0, cfg.check_every, one, p)
            return p, residual_inf(p, b), it + cfg.check_every

        init = (p_warm, tol + jnp.asarray(1.0, dtype), jnp.asarray(0, jnp.int32))
        p, res, iters = jax.lax.while_loop(cond, body, init)
        return p, iters, res

    return solve
