"""Geometric multigrid pressure-Poisson solver.

The reference's own TODO list names "switch to multigrid Poisson" as the
scaling fix for SOR's O(N) iteration growth (README.md:39); this module is
that solver: every smoothing sweep, restriction, prolongation and residual
is a whole-array fused pass, the V-cycle is a static unrolled loop over
levels (compile-time level count), and the outer tolerance loop is a
device-resident ``lax.while_loop`` — one XLA program per solve, no host
syncs.

Unified operator
----------------
All three reference Poisson flavors are instances of one weighted 5-point
operator on the padded grid (ghost ring identically zero):

    A(p) = idx2*(wE*(pE - p) + wW*(pW - p)) + idy2*(wN*(pN - p) + wS*(pS - p))

* Neumann side (wall/inlet ghosts copying the interior,
  channel-01.cpp:531-541): coupling weight w = 0.
* Dirichlet-0 side (channel outlet ghost column pinned to the reference
  pressure 0, channel-01.cpp:535): w = 1 with the neighbor read from the
  zero ghost.
* The cavity's ``eps_s = 1`` quirk (cavity-01.cpp:647) — every interior cell
  counts a south neighbor, so the bottom row couples to the zero ghost — is
  just wS = 1 at j = 1.
* Fluid-fluid interior couplings: w = 1.

Coarsening rediscretizes the same weights: an interface coupling on the
coarse grid is the average of the two fine couplings it covers, which
preserves the boundary encoding on every level.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from cfd_tpu.ops.stencil import _sh


@dataclasses.dataclass(frozen=True)
class PoissonProblem:
    """Host-side spec of one weighted-Poisson level."""

    nx: int
    ny: int
    dx: float
    dy: float
    wE: np.ndarray  # (ny+2, nx+2) float; coupling weights, 0 outside interior
    wW: np.ndarray
    wN: np.ndarray
    wS: np.ndarray

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ny + 2, self.nx + 2)


def mg_compatible(nx: int, ny: int, min_coarse: int = 4) -> bool:
    """True when at least one factor-2 coarsening is possible."""
    return nx % 2 == 0 and ny % 2 == 0 and nx // 2 >= min_coarse and ny // 2 >= min_coarse


def _interior_mask(nx: int, ny: int) -> np.ndarray:
    m = np.zeros((ny + 2, nx + 2), dtype=bool)
    m[1 : ny + 1, 1 : nx + 1] = True
    return m


def cavity_problem(nx: int, ny: int, dx: float, dy: float) -> PoissonProblem:
    """The cavity flavor: Neumann sides except the always-on south coupling
    (cavity-01.cpp:644-647)."""
    jj = np.arange(ny + 2)[:, None]
    ii = np.arange(nx + 2)[None, :]
    interior = _interior_mask(nx, ny)
    wE = ((ii < nx) & interior).astype(np.float64)
    wW = ((ii > 1) & interior).astype(np.float64)
    wN = ((jj < ny) & interior).astype(np.float64)
    wS = interior.astype(np.float64)  # reference quirk: couples j=1 to 0-ghost
    return PoissonProblem(nx, ny, dx, dy, wE, wW, wN, wS)


def neumann_problem(nx: int, ny: int, dx: float, dy: float) -> PoissonProblem:
    """Pure-Neumann box (use with mean-pinning / mean-removed sources)."""
    jj = np.arange(ny + 2)[:, None]
    ii = np.arange(nx + 2)[None, :]
    interior = _interior_mask(nx, ny)
    wE = ((ii < nx) & interior).astype(np.float64)
    wW = ((ii > 1) & interior).astype(np.float64)
    wN = ((jj < ny) & interior).astype(np.float64)
    wS = ((jj > 1) & interior).astype(np.float64)
    return PoissonProblem(nx, ny, dx, dy, wE, wW, wN, wS)


def channel_problem(nx: int, ny: int, dx: float, dy: float) -> PoissonProblem:
    """Channel flavor: inlet/walls Neumann, outlet Dirichlet-0 through the
    ghost column (channel-01.cpp:531-541)."""
    p = neumann_problem(nx, ny, dx, dy)
    wE = p.wE.copy()
    wE[1 : ny + 1, nx] = 1.0  # outlet column couples to the 0-pinned ghost
    return dataclasses.replace(p, wE=wE)


@dataclasses.dataclass(frozen=True)
class _Level:
    """Device-side constants for one level (jnp arrays, closed over by jit).

    HBM-bandwidth design: for separable (rectangle) problems the coupling
    weights are stored as broadcastable 1D vectors — wE/wW as (1, nx+2),
    wN/wS as (ny+2, 1) — and the diagonal, interior mask and red/black
    parity are (re)computed inline from iotas. A smoothing half-sweep then
    streams only p and b from HBM instead of p, b, four full-size weight
    arrays, the inverse diagonal and a parity mask (~3x less traffic on the
    dominant cost of the whole solver). Non-separable (masked-geometry)
    problems fall back to full 2D weights.
    """

    wE: jnp.ndarray
    wW: jnp.ndarray
    wN: jnp.ndarray
    wS: jnp.ndarray
    idx2: float
    idy2: float
    shape: tuple[int, int]  # padded (ny+2, nx+2)
    separable: bool
    ny: int
    nx: int


def _is_separable(p: PoissonProblem) -> bool:
    """True when every weight is constant along the non-edge axis over the
    interior (all rectangle problems and their coarsenings)."""
    inter = np.s_[1 : p.ny + 1, 1 : p.nx + 1]

    def rows_equal(w):  # w[j, i] independent of j on the interior
        return bool((w[inter] == w[inter][0:1, :]).all())

    def cols_equal(w):
        return bool((w[inter] == w[inter][:, 0:1]).all())

    return (rows_equal(p.wE) and rows_equal(p.wW)
            and cols_equal(p.wN) and cols_equal(p.wS))


def _build_level(p: PoissonProblem, dtype) -> _Level:
    idx2 = 1.0 / (p.dx * p.dx)
    idy2 = 1.0 / (p.dy * p.dy)
    H, W = (p.ny + 2, p.nx + 2)
    if _is_separable(p):
        wE = np.zeros((1, W))
        wE[0, 1 : p.nx + 1] = p.wE[1, 1 : p.nx + 1]
        wW = np.zeros((1, W))
        wW[0, 1 : p.nx + 1] = p.wW[1, 1 : p.nx + 1]
        wN = np.zeros((H, 1))
        wN[1 : p.ny + 1, 0] = p.wN[1 : p.ny + 1, 1]
        wS = np.zeros((H, 1))
        wS[1 : p.ny + 1, 0] = p.wS[1 : p.ny + 1, 1]
        sep = True
    else:
        wE, wW, wN, wS = p.wE, p.wW, p.wN, p.wS
        sep = False
    return _Level(
        wE=jnp.asarray(wE, dtype), wW=jnp.asarray(wW, dtype),
        wN=jnp.asarray(wN, dtype), wS=jnp.asarray(wS, dtype),
        idx2=idx2, idy2=idy2, shape=(H, W), separable=sep,
        ny=p.ny, nx=p.nx,
    )


def _inline_masks(level: _Level):
    """(interior, red, black) from iotas — fused by XLA, zero HBM traffic."""
    ny, nx = level.ny, level.nx
    jj = jax.lax.broadcasted_iota(jnp.int32, level.shape, 0)
    ii = jax.lax.broadcasted_iota(jnp.int32, level.shape, 1)
    interior = (jj >= 1) & (jj <= ny) & (ii >= 1) & (ii <= nx)
    if not level.separable:
        denom = (level.idx2 * (level.wE + level.wW)
                 + level.idy2 * (level.wN + level.wS))
        interior = interior & (denom > 0)
    even = ((jj + ii) % 2) == 0
    return interior, interior & even, interior & ~even


def _inv_diag(level: _Level, interior):
    denom = (level.idx2 * (level.wE + level.wW)
             + level.idy2 * (level.wN + level.wS))
    denom = jnp.broadcast_to(denom, level.shape)
    return jnp.where(interior, 1.0 / jnp.where(denom > 0, denom, 1.0), 0.0)


def coarsen_problem(p: PoissonProblem) -> PoissonProblem:
    """Factor-2 coarsening with interface-averaged couplings.

    A coarse east coupling spans the two fine east interfaces of the right
    column of the 2x2 block; averaging the fine weights preserves
    Neumann (0), Dirichlet (1) and fractional masked couplings.
    """
    assert p.nx % 2 == 0 and p.ny % 2 == 0
    nx, ny = p.nx // 2, p.ny // 2

    def block(a: np.ndarray) -> np.ndarray:
        """(ny, 2, nx, 2): [J, j_child, I, i_child] over the fine interior."""
        return a[1 : p.ny + 1, 1 : p.nx + 1].reshape(ny, 2, nx, 2)

    def pad(interior: np.ndarray) -> np.ndarray:
        w = np.zeros((ny + 2, nx + 2))
        w[1 : ny + 1, 1 : nx + 1] = interior
        return w

    # A coarse E/W coupling spans the two fine interfaces of the right/left
    # child column (averaged over the j-children); N/S analogously.
    wE = pad(block(p.wE)[:, :, :, 1].mean(axis=1))
    wW = pad(block(p.wW)[:, :, :, 0].mean(axis=1))
    wN = pad(block(p.wN)[:, 1, :, :].mean(axis=-1))
    wS = pad(block(p.wS)[:, 0, :, :].mean(axis=-1))

    # Domain-edge Dirichlet couplings pin the value at a ghost CENTER of the
    # finer grid — a fixed physical location. Plain averaging would re-anchor
    # the pin at the coarse ghost center, weakening it each level; that
    # inconsistency makes the smooth (near-nullspace) mode's coarse
    # correction wrong by an O(1) factor and the V-cycle convergence factor
    # roughly doubles per level (measured: 0.23 -> 0.46 -> divergence).
    # Consistency: a coupling w at spacing H encodes pin distance d = H/w;
    # the coarse center sits H/2 further away, so
    #   w_c = (2H) / (d + H/2) = 4 w / (2 + w),
    # which maps 1 -> 4/3 -> 8/5 -> ... (and fixes 0 = Neumann).
    def edge_fix(w):
        return 4.0 * w / (2.0 + w)

    wS[1, 1 : nx + 1] = edge_fix(wS[1, 1 : nx + 1])
    wN[ny, 1 : nx + 1] = edge_fix(wN[ny, 1 : nx + 1])
    wW[1 : ny + 1, 1] = edge_fix(wW[1 : ny + 1, 1])
    wE[1 : ny + 1, nx] = edge_fix(wE[1 : ny + 1, nx])
    return PoissonProblem(nx, ny, p.dx * 2, p.dy * 2, wE, wW, wN, wS)


def _smooth(level: _Level, p, b, omega, parity_mask, inv_diag):
    pE, pW = _sh(p, 0, 1), _sh(p, 0, -1)
    pN, pS = _sh(p, 1, 0), _sh(p, -1, 0)
    gs = (level.idx2 * (level.wE * pE + level.wW * pW)
          + level.idy2 * (level.wN * pN + level.wS * pS) - b) * inv_diag
    upd = p + omega * (gs - p)
    return jnp.where(parity_mask, upd.astype(p.dtype), p)


def _apply(level: _Level, p, interior=None):
    if interior is None:
        interior, _, _ = _inline_masks(level)
    pE, pW = _sh(p, 0, 1), _sh(p, 0, -1)
    pN, pS = _sh(p, 1, 0), _sh(p, -1, 0)
    a = (level.idx2 * (level.wE * (pE - p) + level.wW * (pW - p))
         + level.idy2 * (level.wN * (pN - p) + level.wS * (pS - p)))
    return jnp.where(interior, a, jnp.zeros_like(a))


def _residual(level: _Level, p, b, interior=None):
    if interior is None:
        interior, _, _ = _inline_masks(level)
    return jnp.where(interior, b - _apply(level, p, interior), jnp.zeros_like(b))


def _restrict(fine: _Level, coarse: _Level, r):
    """Full-weighting: coarse cell value = mean of its 4 fine children.

    Implemented with ``lax.reduce_window``, which reads the offset-sliced
    interior in place; ``reshape(ny_c, 2, nx_c, 2).mean((1, 3))`` makes
    the compiler materialise a relayout of it first."""
    ny_f, nx_f = fine.ny, fine.nx
    ny_c, nx_c = coarse.ny, coarse.nx
    inner = r[1 : ny_f + 1, 1 : nx_f + 1]
    rc = jax.lax.reduce_window(inner, jnp.zeros((), r.dtype), jax.lax.add,
                               (2, 2), (2, 2), "VALID") * 0.25
    out = jnp.zeros(coarse.shape, dtype=r.dtype)
    return out.at[1 : ny_c + 1, 1 : nx_c + 1].set(rc)


def _solid_fill(coarse: _Level, e):
    """Neumann-extend the coarse correction into solid cells before
    prolongation (masked hierarchies only): replace each solid interior
    cell's value with the average of its FLUID 4-neighbors.

    Without this, the mask-blind bilinear stencil below interpolates
    wall-adjacent fine fluid children from solid coarse cells whose
    correction is identically 0 (the smoother masks them out), damping the
    near-wall correction by up to 4/16 every level.  That under-correction
    compounds per level and was THE barely-contracting masked mode:
    measured f64 V(1,2) factors at 256x32
    go 0.47-oscillating -> 0.31-monotone with the fill (V(2,2): 0.36 ->
    0.21).  The fill mirrors the exact fine operator's own ghost
    semantics — solid-cell pressure = average of fluid neighbors
    (/root/reference/backwards_step-01.cpp:708-739) — so the two
    operators of the defect correction finally agree about what a
    correction means next to a wall."""
    ny, nx = coarse.ny, coarse.nx
    jj = jax.lax.broadcasted_iota(jnp.int32, coarse.shape, 0)
    ii = jax.lax.broadcasted_iota(jnp.int32, coarse.shape, 1)
    geom = (jj >= 1) & (jj <= ny) & (ii >= 1) & (ii <= nx)
    denom = (coarse.idx2 * (coarse.wE + coarse.wW)
             + coarse.idy2 * (coarse.wN + coarse.wS))
    fluid = geom & (jnp.broadcast_to(denom, coarse.shape) > 0)
    f = fluid.astype(e.dtype)
    ef = e * f
    num = _sh(ef, 0, 1) + _sh(ef, 0, -1) + _sh(ef, 1, 0) + _sh(ef, -1, 0)
    den = _sh(f, 0, 1) + _sh(f, 0, -1) + _sh(f, 1, 0) + _sh(f, -1, 0)
    fill = num / jnp.maximum(den, jnp.ones_like(den))
    return jnp.where(geom & ~fluid & (den > 0), fill.astype(e.dtype), e)


def _prolong(coarse: _Level, fine: _Level, e):
    """Bilinear (cell-centered 9-3-3-1) interpolation of the coarse
    correction. Piecewise-constant transfer violates the transfer-order rule
    (prolongation+restriction order must exceed the PDE order) and caps the
    V-cycle at ~0.86/cycle; bilinear restores mesh-independent rates.
    Boundary ghosts are edge-extrapolated (Neumann in the correction), which
    post-smoothing localizes to O(h) boundary error per cycle.  Masked
    (non-separable) hierarchies first Neumann-extend the correction into
    solid cells (see _solid_fill)."""
    if not coarse.separable:
        e = _solid_fill(coarse, e)
    ny_c, nx_c = coarse.ny, coarse.nx
    ny_f, nx_f = fine.ny, fine.nx
    ce = jnp.pad(e[1 : ny_c + 1, 1 : nx_c + 1], 1, mode="edge")
    c = ce[1:-1, 1:-1]
    cw, ceast = ce[1:-1, :-2], ce[1:-1, 2:]
    cs, cn = ce[:-2, 1:-1], ce[2:, 1:-1]
    csw, cse = ce[:-2, :-2], ce[:-2, 2:]
    cnw, cne = ce[2:, :-2], ce[2:, 2:]
    k = 1.0 / 16.0
    c00 = k * (9 * c + 3 * cw + 3 * cs + csw)  # child (j-lo, i-lo)
    c01 = k * (9 * c + 3 * ceast + 3 * cs + cse)
    c10 = k * (9 * c + 3 * cw + 3 * cn + cnw)
    c11 = k * (9 * c + 3 * ceast + 3 * cn + cne)
    bottom = jnp.stack([c00, c01], axis=-1).reshape(ny_c, nx_f)
    top = jnp.stack([c10, c11], axis=-1).reshape(ny_c, nx_f)
    ef = jnp.stack([bottom, top], axis=1).reshape(ny_f, nx_f)
    out = jnp.zeros(fine.shape, dtype=e.dtype)
    out = out.at[1 : ny_f + 1, 1 : nx_f + 1].set(ef)
    interior, _, _ = _inline_masks(fine)
    return jnp.where(interior, out, jnp.zeros_like(out))


@dataclasses.dataclass(frozen=True)
class MGConfig:
    omega: float = 1.0  # smoother relaxation (GS); >1 can destabilize rb-MG
    pre_sweeps: int = 2  # red+black pairs before coarse correction
    post_sweeps: int = 2
    coarse_sweeps: int = 32
    max_cycles: int = 100
    tol_factor: float = 1e-9  # relative to max|b|
    abs_tol: float = 0.0
    min_coarse: int = 4  # stop coarsening when a side would drop below this
    pin_mean: bool = False  # subtract interior mean each cycle (pure Neumann)
    # Stop when a cycle no longer contracts the residual by at least this
    # factor — float32 runs hit the roundoff floor long before a
    # 1e-9-relative tolerance, and burning further cycles there is pure
    # waste.  At the floor the measured cycle-to-cycle ratios are >= 0.94
    # (channel 1536x512 f32: 1.00/1.06/0.94/0.97), while a MID-SOLVE
    # transient plateau can contract as slowly as 0.84 for one cycle and
    # then resume at ~0.3-0.5 (channel 1536x512 V(2,1), cycle 1->2 on the
    # sharp inlet-layer source).  The original 0.7 threshold mistook that
    # plateau for the floor, exited with the residual 7.5e4x tolerance,
    # and the un-projected velocity blew the simulation up within ~70
    # steps.  0.9 sits between the worst measured plateau (0.84) and the
    # floor band (>= 0.94).
    stall_ratio: float = 0.9
    # Residual-minimizing coarse-correction steplength for the masked
    # DEFECT-CORRECTION hierarchies (the backwards-step geometry): the
    # coarse operator there is a non-Galerkin approximation (Neumann-
    # through-solids weights, masked_channel_problem) of the exact fine
    # operator (backwards_step-01.cpp:685-739 ghost semantics), so the
    # correction returned for the seam equation A1 ec = rc has a
    # systematically wrong amplitude along the slowest error mode. Scaling
    # it by the 1-D line-search optimum
    #   alpha = <rc, A1 ec> / <A1 ec, A1 ec>
    # (minimizes ||rc - alpha A1 ec||_2 before prolongation) costs one
    # level-1 operator apply + two reductions per cycle and cannot move
    # the fixed point (the update is residual-driven: rc = 0 -> ec = 0).
    # Honored by the masked path; separable hierarchies (their coarsening
    # is consistent, see coarsen_problem edge_fix) reject it loudly.
    corr_opt: bool = False


def _corr_alpha(level1: _Level, rc, ec):
    """Clamped line-search steplength for the coarse-grid correction
    (corr_opt). The raw optimum alpha = <rc, A1 ec>/<A1 ec, A1 ec> is
    measured at ~1.10-1.15 SUSTAINED on the step geometry (the coarse
    hierarchy systematically under-corrects by ~13%) — but on the first
    cycle of a solve the correction is only weakly aligned with rc under
    the level-1 operator (cos ~0.4, raw alpha ~0.2), and applying that
    tiny alpha wipes a correction whose unseen components were doing real
    work: the un-clamped search measured cascading NEGATIVE alphas and
    solves stall-exiting at 400-1000x the baseline floor. The [1.0, 1.5]
    clamp makes the anomalous cycles a no-op (alpha 1 = plain correction)
    while keeping the systematic over-relaxation where the search is
    trustworthy."""
    Aec = _apply(level1, ec)
    num = jnp.sum(rc * Aec)
    den = jnp.sum(Aec * Aec)
    raw = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0),
                    jnp.ones_like(num))
    return jnp.clip(raw, 1.0, 1.5)


def _apply_np(p: PoissonProblem, x: np.ndarray) -> np.ndarray:
    """numpy twin of _apply for host-side dense-matrix probing."""
    idx2, idy2 = 1.0 / (p.dx * p.dx), 1.0 / (p.dy * p.dy)
    xE = np.roll(x, -1, axis=1)
    xW = np.roll(x, 1, axis=1)
    xN = np.roll(x, -1, axis=0)
    xS = np.roll(x, 1, axis=0)
    a = idx2 * (p.wE * (xE - x) + p.wW * (xW - x)) + idy2 * (p.wN * (xN - x) + p.wS * (xS - x))
    m = _interior_mask(p.nx, p.ny)
    return np.where(m, a, 0.0)


def _dense_pinv(p: PoissonProblem) -> np.ndarray:
    """Pseudo-inverse of the coarsest operator over interior cells.

    The weighted cavity/Neumann operators are nearly (or exactly) singular —
    the near-constant mode makes iterative coarse solves arbitrarily slow,
    which is the classic V-cycle killer. The coarsest grid is tiny
    (<= min_coarse^2-ish cells), so an exact solve is one small matmul,
    nullspace-safe via pinv."""
    n = p.nx * p.ny
    A = np.zeros((n, n))
    for k in range(n):
        e = np.zeros((p.ny + 2, p.nx + 2))
        e[1 + k // p.nx, 1 + k % p.nx] = 1.0
        A[:, k] = _apply_np(p, e)[1 : p.ny + 1, 1 : p.nx + 1].ravel()
    return np.linalg.pinv(A, rcond=1e-12)


def build_hierarchy(problem: PoissonProblem, cfg: MGConfig, dtype=jnp.float32
                    ) -> tuple[list[_Level], jnp.ndarray]:
    """Returns (levels, coarsest pseudo-inverse)."""
    probs = [problem]
    while (probs[-1].nx % 2 == 0 and probs[-1].ny % 2 == 0
           and probs[-1].nx // 2 >= cfg.min_coarse and probs[-1].ny // 2 >= cfg.min_coarse):
        probs.append(coarsen_problem(probs[-1]))
    pinv = jnp.asarray(_dense_pinv(probs[-1]), dtype)
    return [_build_level(p, dtype) for p in probs], pinv


def make_multigrid_poisson(
    problem: PoissonProblem,
    cfg: MGConfig,
    dtype=jnp.float32,
    n_interior: int | None = None,
    exact_level0: tuple[Callable, Callable] | None = None,
) -> Callable[[jnp.ndarray, jnp.ndarray], tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """Returns solve(p_warm, b) -> (p, cycles, residual_inf).

    Matches the SOR solver call contract in cfd_tpu.poisson.sor so cases can
    swap solvers freely. ``cycles`` counts V-cycles (not sweeps).

    ``exact_level0``: optional (smooth_pairs(p, b, n), residual(p, b))
    overrides for the finest level — the defect-correction pattern used by
    the masked-geometry solver: the fine level smooths and measures
    convergence with the EXACT operator (ghost refresh incl. solid-cell
    averaging), while the coarse hierarchy uses the weighted approximation
    (Neumann through solids). Fixed point = exact solution, since the update
    is residual-driven.
    """
    levels, coarse_pinv = build_hierarchy(problem, cfg, dtype)
    n_int = n_interior or (problem.nx * problem.ny)
    bot = levels[-1]
    bot_ny, bot_nx = bot.ny, bot.nx

    if cfg.corr_opt and exact_level0 is None:
        raise ValueError("corr_opt is a masked defect-correction knob — "
                         "separable hierarchies coarsen consistently "
                         "(coarsen_problem edge_fix) and do not take it")

    def smooth_pair(level, p, b, n):
        interior, red, black = _inline_masks(level)
        inv = _inv_diag(level, interior)

        def body(_, p):
            p = _smooth(level, p, b, cfg.omega, red, inv)
            return _smooth(level, p, b, cfg.omega, black, inv)

        return jax.lax.fori_loop(0, n, body, p)

    def coarse_solve(b):
        vec = b[1 : bot_ny + 1, 1 : bot_nx + 1].reshape(-1)
        # HIGHEST: a float32 product may otherwise run in TF32 on the GPU
        e = jnp.matmul(coarse_pinv.astype(b.dtype), vec,
                       precision=jax.lax.Precision.HIGHEST)
        out = jnp.zeros(bot.shape, dtype=b.dtype)
        return out.at[1 : bot_ny + 1, 1 : bot_nx + 1].set(
            e.reshape(bot_ny, bot_nx))

    top = levels[0]
    if exact_level0 is not None:
        smooth0, residual0 = exact_level0
    else:
        smooth0 = lambda p, b, n: smooth_pair(top, p, b, n)
        residual0 = lambda p, b: _residual(top, p, b)

    def vcycle(k: int, p, b):
        level = levels[k]
        if k == len(levels) - 1:
            return coarse_solve(b)
        if k == 0:
            p = smooth0(p, b, cfg.pre_sweeps)
            r = residual0(p, b)
        else:
            p = smooth_pair(level, p, b, cfg.pre_sweeps)
            r = _residual(level, p, b)
        rc = _restrict(level, levels[k + 1], r)
        ec = vcycle(k + 1, jnp.zeros(levels[k + 1].shape, dtype=rc.dtype), rc)
        if cfg.corr_opt and k == 0:
            # exact/weighted defect-correction seam: line-search the
            # correction amplitude (see the MGConfig.corr_opt docstring)
            ec = _corr_alpha(levels[1], rc, ec) * ec
        p = p + _prolong(levels[k + 1], level, ec)
        if k == 0:
            return smooth0(p, b, cfg.post_sweeps)
        return smooth_pair(level, p, b, cfg.post_sweeps)

    def solve(p_warm, b):
        dtype_ = b.dtype
        max_b = jnp.max(jnp.abs(b))
        tol = jnp.maximum(cfg.tol_factor * jnp.where(max_b > 0, max_b, jnp.ones_like(max_b)),
                          jnp.asarray(cfg.abs_tol, dtype_))
        top_interior, _, _ = _inline_masks(top)
        p0 = jnp.where(top_interior, p_warm, jnp.zeros_like(p_warm)) \
            if exact_level0 is None else p_warm

        def cond(carry):
            _, res, prev, it = carry
            return (res > tol) & (it < cfg.max_cycles) & (res < cfg.stall_ratio * prev)

        def body(carry):
            p, res, _, it = carry
            p = vcycle(0, p, b)
            if cfg.pin_mean:
                mean = jnp.sum(p) / n_int  # p is 0 outside interior
                p = jnp.where(top_interior, p - mean, p)
            new_res = jnp.max(jnp.abs(residual0(p, b)))
            return p, new_res.astype(dtype_), res, it + 1

        # Finite sentinel: with inf the stall check (res < stall_ratio *
        # prev) would read inf < inf = False and end the loop after zero
        # cycles.
        big = jnp.asarray(1e30, dtype_)
        init = (p0, big / 2, big, jnp.asarray(0, jnp.int32))
        p, res, _, iters = jax.lax.while_loop(cond, body, init)
        return p, iters, res

    return solve


def masked_channel_problem(grid, dx: float, dy: float) -> PoissonProblem:
    """Weighted operator for masked geometry with channel-style domain BCs:
    fluid-fluid couplings 1, couplings through solid cells 0 (Neumann across
    internal walls, the elimination of backwards_step-01.cpp:708-739 up to
    convex-corner diagonal terms), inlet/wall Neumann, outlet Dirichlet-0.
    Used as the COARSE-hierarchy operator under exact fine-level smoothing
    (see make_masked_multigrid_poisson)."""
    f = grid.fluid.astype(np.float64)
    nx, ny = grid.nx, grid.ny
    wE = f * np.roll(f, -1, axis=1)
    wW = f * np.roll(f, 1, axis=1)
    wN = f * np.roll(f, -1, axis=0)
    wS = f * np.roll(f, 1, axis=0)
    wE[1 : ny + 1, nx] = grid.fluid[1 : ny + 1, nx]  # outlet Dirichlet-0 ghost
    return PoissonProblem(nx, ny, dx, dy, wE, wW, wN, wS)


def step_rect_params(grid) -> tuple[int, int] | None:
    """If the grid's solid raster is exactly the reference's backward-step
    rectangle ``solid = {i <= step_i and j > inlet_j_max}``
    (backwards_step-01.cpp:499-520), return (step_i, inlet_j_max); else
    None."""
    nx, ny = grid.nx, grid.ny
    interior = grid.fluid[1 : ny + 1, 1 : nx + 1]
    solid = ~interior
    if not solid.any():
        return None
    jj, ii = np.nonzero(solid)
    step_i = int(ii.max()) + 1  # back to 1-based padded indexing
    inlet_j_max = int(jj.min())  # first solid row is inlet_j_max + 1
    jj1 = np.arange(1, ny + 1)[:, None]
    ii1 = np.arange(1, nx + 1)[None, :]
    expected = (ii1 <= step_i) & (jj1 > inlet_j_max)
    if (solid == expected).all():
        return step_i, inlet_j_max
    return None


def make_masked_multigrid_poisson(grid, coeffs, cfg: MGConfig, ghosts,
                                  dtype=jnp.float32):
    """Defect-correction multigrid for masked geometry (the reference's
    backward-facing step): the finest level smooths with the exact
    reference operator — plain 5-point sweeps over fluid cells with the
    ghost functor (domain ghosts + solid-cell fluid-neighbor averaging,
    backwards_step-01.cpp:685-739) refreshed every pair — and measures the
    exact residual; coarser levels correct with the weighted approximation.
    Converges to the same fixed point as the masked SOR solver."""
    nx, ny = grid.nx, grid.ny
    idx2, idy2 = coeffs.idx2, coeffs.idy2
    denom = 2.0 * (idx2 + idy2)
    fluid = jnp.asarray(grid.cell_mask)
    jj = np.arange(ny + 2)[:, None]
    ii = np.arange(nx + 2)[None, :]
    cb = jnp.asarray((ii + jj) % 2 == 0)
    red = cb & fluid
    black = (~cb) & fluid
    omega = cfg.omega

    def half(p, b, mask):
        gs = (idx2 * (_sh(p, 0, 1) + _sh(p, 0, -1))
              + idy2 * (_sh(p, 1, 0) + _sh(p, -1, 0)) - b) / denom
        upd = (1.0 - omega) * p + omega * gs
        return jnp.where(mask, upd.astype(p.dtype), p)

    def smooth0(p, b, n):
        def body(_, p):
            p = ghosts(p)
            p = half(p, b, red)
            p = half(p, b, black)
            return p

        return ghosts(jax.lax.fori_loop(0, n, body, p))

    def residual0(p, b):
        p = ghosts(p)
        lap = (_sh(p, 0, 1) - 2.0 * p + _sh(p, 0, -1)) * idx2 + (
            _sh(p, 1, 0) - 2.0 * p + _sh(p, -1, 0)) * idy2
        return jnp.where(fluid, b - lap, jnp.zeros_like(b))

    prob = masked_channel_problem(grid, coeffs.dx, coeffs.dy)
    return make_multigrid_poisson(prob, cfg, dtype, n_interior=grid.n_fluid,
                                  exact_level0=(smooth0, residual0))
