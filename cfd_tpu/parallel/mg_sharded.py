"""Explicit sharded geometric multigrid (per-level halo exchange).

The SURVEY.md section 5.7 design, implemented rather than delegated to the
GSPMD partitioner: the V-cycle runs inside a ``shard_map`` body on local
ghost-ring blocks —

* every red/black half-sweep and every residual at a DISTRIBUTED level
  refreshes its 1-cell halo with ``lax.ppermute`` neighbor shifts
  (parallel.halo.exchange_halos);
* restriction and prolongation between distributed levels are purely local
  (factor-2 coarsening preserves block alignment while the local interior
  stays even; bilinear prolongation needs only the 1-cell coarse halo plus
  edge replication at physical boundaries);
* below the COARSE SWITCH — the first level whose global size no longer
  divides the mesh — the residual is ``lax.all_gather``-ed and the remaining
  tiny hierarchy (down to the dense-pinv coarsest solve,
  poisson.multigrid._dense_pinv) runs replicated on every device: identical
  redundant FLOPs beat any further communication at those sizes;
* the tolerance loop is one device-resident ``lax.while_loop`` whose
  residual/stall scalars are ``pmax`` collectives — every device sees the
  SAME scalars, so the loop is lockstep and the cycle count matches the
  single-device solver exactly (max/elementwise arithmetic is order-exact,
  unlike sums).

All arithmetic is elementwise or 2x2-window local, so the sharded iterates
are bitwise-equal to the single-device XLA multigrid path on matching
hierarchies (asserted by tests/test_mg_sharded.py at 256^2 on the 8-device
CPU mesh).

Reference anchor: the only global reductions per solve in the reference are
the tolerance from max|b| and the residual infinity-norm
(channel-01.cpp:647,672-681); both become pmax collectives here.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from cfd_tpu.parallel.halo import exchange_halos, global_max, global_sum
from cfd_tpu.poisson import multigrid as M


@dataclasses.dataclass(frozen=True)
class _DistLevel:
    """One distributed level: global separable weight vectors (replicated,
    tiny) + sizes. Local slices are taken inside the body with the device's
    mesh coordinates."""

    ny: int  # global interior
    nx: int
    lny: int  # local interior (ny // mdy)
    lnx: int
    wE: jnp.ndarray  # (nx+2,) global padded coupling vectors
    wW: jnp.ndarray
    wN: jnp.ndarray  # (ny+2,)
    wS: jnp.ndarray
    idx2: float
    idy2: float


def _vectors(p: M.PoissonProblem) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Separable (interior-constant along the non-edge axis) weight vectors."""
    wE = np.zeros(p.nx + 2)
    wE[1 : p.nx + 1] = p.wE[1, 1 : p.nx + 1]
    wW = np.zeros(p.nx + 2)
    wW[1 : p.nx + 1] = p.wW[1, 1 : p.nx + 1]
    wN = np.zeros(p.ny + 2)
    wN[1 : p.ny + 1] = p.wN[1 : p.ny + 1, 1]
    wS = np.zeros(p.ny + 2)
    wS[1 : p.ny + 1] = p.wS[1 : p.ny + 1, 1]
    return wE, wW, wN, wS


def make_local_mg_solve(problem: M.PoissonProblem, cfg: M.MGConfig,
                        mesh_shape: tuple[int, int], dtype,
                        axis_y: str = "dy", axis_x: str = "dx"):
    """Build solve_local(guess, b, jy, jx) for use INSIDE a shard_map body.

    ``guess``/``b`` are local padded (lny+2, lnx+2) blocks (ghost ring zero
    on physical boundaries, stale-or-anything on interior faces — the solver
    refreshes halos itself). Returns (p_local_padded, cycles, residual_inf);
    the scalars are replicated (identical on every device).
    """
    mdy, mdx = mesh_shape
    if problem.ny % mdy or problem.nx % mdx:
        raise ValueError(
            f"grid {problem.ny}x{problem.nx} not divisible by mesh {mdy}x{mdx}")

    probs = [problem]
    while (probs[-1].nx % 2 == 0 and probs[-1].ny % 2 == 0
           and probs[-1].nx // 2 >= cfg.min_coarse
           and probs[-1].ny // 2 >= cfg.min_coarse):
        probs.append(M.coarsen_problem(probs[-1]))

    # Coarse switch: first level handled replicated. The dense-pinv coarsest
    # solve needs the full right-hand side, so the last level is always
    # replicated; earlier levels switch as soon as the mesh stops dividing.
    switch = len(probs) - 1
    for k, p in enumerate(probs):
        if k == len(probs) - 1 or p.nx % mdx or p.ny % mdy:
            switch = k
            break
    if switch < 1:
        raise ValueError("level 0 must be distributable over the mesh")
    for p in probs[:switch]:
        if not M._is_separable(p):
            raise ValueError("sharded multigrid requires separable levels")

    dist = []
    for p in probs[:switch]:
        wE, wW, wN, wS = _vectors(p)
        dist.append(_DistLevel(
            ny=p.ny, nx=p.nx, lny=p.ny // mdy, lnx=p.nx // mdx,
            wE=jnp.asarray(wE, dtype), wW=jnp.asarray(wW, dtype),
            wN=jnp.asarray(wN, dtype), wS=jnp.asarray(wS, dtype),
            idx2=1.0 / (p.dx * p.dx), idy2=1.0 / (p.dy * p.dy)))

    # Replicated tail of the hierarchy (plus the switch-level's fine twin,
    # used only for the replicated restrict/prolong across the switch).
    gate_fine = M._build_level(probs[switch - 1], dtype)
    rep_levels = [M._build_level(p, dtype) for p in probs[switch:]]
    rep_pinv = jnp.asarray(M._dense_pinv(probs[-1]), dtype)
    bot = rep_levels[-1]
    bot_ny, bot_nx = bot.shape[0] - 2, bot.shape[1] - 2

    xch = partial(exchange_halos, axis_y=axis_y, axis_x=axis_x)
    gmax = partial(global_max, axis_y=axis_y, axis_x=axis_x)

    # ---------- replicated sub-hierarchy (plain single-device ops) ----------

    def rep_smooth(level, p, b, n):
        interior, red, black = M._inline_masks(level)
        inv = M._inv_diag(level, interior)

        def body(_, p):
            p = M._smooth(level, p, b, cfg.omega, red, inv)
            return M._smooth(level, p, b, cfg.omega, black, inv)

        return lax.fori_loop(0, n, body, p)

    def coarse_solve(b):
        vec = b[1 : bot_ny + 1, 1 : bot_nx + 1].reshape(-1)
        e = (rep_pinv.astype(b.dtype) @ vec).reshape(bot_ny, bot_nx)
        out = jnp.zeros(bot.shape, dtype=b.dtype)
        return out.at[1 : bot_ny + 1, 1 : bot_nx + 1].set(e)

    def rep_vcycle(k, p, b):
        level = rep_levels[k]
        if k == len(rep_levels) - 1:
            return coarse_solve(b)
        p = rep_smooth(level, p, b, cfg.pre_sweeps)
        r = M._residual(level, p, b)
        rc = M._restrict(level, rep_levels[k + 1], r)
        ec = rep_vcycle(k + 1, jnp.zeros(rep_levels[k + 1].shape, dtype=rc.dtype), rc)
        p = p + M._prolong(rep_levels[k + 1], level, ec)
        return rep_smooth(level, p, b, cfg.post_sweeps)

    # ---------- distributed levels (halo exchange per half-sweep) ----------

    def local_geom(k, jy, jx):
        """(interior, red, black, inv_diag, wE, wW, wN, wS) on the local
        padded block, from the device's mesh coordinates."""
        L = dist[k]
        shape = (L.lny + 2, L.lnx + 2)
        lr = lax.broadcasted_iota(jnp.int32, shape, 0)
        lc = lax.broadcasted_iota(jnp.int32, shape, 1)
        interior = (lr >= 1) & (lr <= L.lny) & (lc >= 1) & (lc <= L.lnx)
        gj = jy * L.lny + lr  # local row r -> global row jy*lny + r
        gi = jx * L.lnx + lc
        even = ((gj + gi) % 2) == 0
        wE = lax.dynamic_slice(L.wE, (jx * L.lnx,), (L.lnx + 2,)).reshape(1, -1)
        wW = lax.dynamic_slice(L.wW, (jx * L.lnx,), (L.lnx + 2,)).reshape(1, -1)
        wN = lax.dynamic_slice(L.wN, (jy * L.lny,), (L.lny + 2,)).reshape(-1, 1)
        wS = lax.dynamic_slice(L.wS, (jy * L.lny,), (L.lny + 2,)).reshape(-1, 1)
        denom = L.idx2 * (wE + wW) + L.idy2 * (wN + wS)
        denom = jnp.broadcast_to(denom, shape)
        inv = jnp.where(interior, 1.0 / jnp.where(denom > 0, denom, 1.0),
                        jnp.zeros(shape, dtype))
        return interior, interior & even, interior & ~even, inv, wE, wW, wN, wS

    def dist_smooth(k, p, b, n, geom):
        interior, red, black, inv, wE, wW, wN, wS = geom
        L = dist[k]

        def half(p, mask):
            gs = (L.idx2 * (wE * M._sh(p, 0, 1) + wW * M._sh(p, 0, -1))
                  + L.idy2 * (wN * M._sh(p, 1, 0) + wS * M._sh(p, -1, 0))
                  - b) * inv
            upd = p + cfg.omega * (gs - p)
            return jnp.where(mask, upd.astype(p.dtype), p)

        def body(_, p):
            p = xch(p)
            p = half(p, red)
            p = xch(p)
            return half(p, black)

        # trailing exchange so the caller's residual reads a fresh ring
        return xch(lax.fori_loop(0, n, body, p))

    def dist_residual(k, p, b, geom):
        """p must be halo-fresh (dist_smooth guarantees it)."""
        interior, _, _, _, wE, wW, wN, wS = geom
        L = dist[k]
        a = (L.idx2 * (wE * (M._sh(p, 0, 1) - p) + wW * (M._sh(p, 0, -1) - p))
             + L.idy2 * (wN * (M._sh(p, 1, 0) - p) + wS * (M._sh(p, -1, 0) - p)))
        return jnp.where(interior, b - a, jnp.zeros_like(b))

    def dist_restrict(k, r):
        """Local full-weighting: block alignment makes it communication-free
        (each coarse cell's 4 fine children live on the same device)."""
        Lf, Lc = dist[k], dist[k + 1]
        inner = r[1 : Lf.lny + 1, 1 : Lf.lnx + 1]
        rc = lax.reduce_window(inner, jnp.zeros((), r.dtype), lax.add,
                               (2, 2), (2, 2), "VALID") * 0.25
        out = jnp.zeros((Lc.lny + 2, Lc.lnx + 2), dtype=r.dtype)
        return out.at[1 : Lc.lny + 1, 1 : Lc.lnx + 1].set(rc)

    def _ring_edge_fill(e, jy, jx):
        """Reproduce the single-device edge-padded coarse array locally: the
        ring holds neighbor interior values (halo) or edge-replicated own
        values at physical boundaries. y first, then x shipping FULL columns,
        so diagonal ring corners arrive without corner messages (same trick
        as halo.exchange_halos)."""
        mdy_, mdx_ = mdy, mdx
        if mdy_ > 1:
            from_south = lax.ppermute(e[-2:-1, :], axis_y,
                                      [(i, i + 1) for i in range(mdy_ - 1)])
            from_north = lax.ppermute(e[1:2, :], axis_y,
                                      [(i + 1, i) for i in range(mdy_ - 1)])
            e = e.at[0:1, :].set(jnp.where(jy > 0, from_south, e[1:2, :]))
            e = e.at[-1:, :].set(jnp.where(jy < mdy_ - 1, from_north, e[-2:-1, :]))
        else:
            e = e.at[0:1, :].set(e[1:2, :])
            e = e.at[-1:, :].set(e[-2:-1, :])
        if mdx_ > 1:
            from_west = lax.ppermute(e[:, -2:-1], axis_x,
                                     [(i, i + 1) for i in range(mdx_ - 1)])
            from_east = lax.ppermute(e[:, 1:2], axis_x,
                                     [(i + 1, i) for i in range(mdx_ - 1)])
            e = e.at[:, 0:1].set(jnp.where(jx > 0, from_west, e[:, 1:2]))
            e = e.at[:, -1:].set(jnp.where(jx < mdx_ - 1, from_east, e[:, -2:-1]))
        else:
            e = e.at[:, 0:1].set(e[:, 1:2])
            e = e.at[:, -1:].set(e[:, -2:-1])
        return e

    def dist_prolong(k, e, jy, jx):
        """Bilinear 9-3-3-1 children of the coarse correction at dist level
        k+1, returned as the fine local padded correction at level k."""
        Lf, Lc = dist[k], dist[k + 1]
        ce = _ring_edge_fill(e, jy, jx)
        c = ce[1:-1, 1:-1]
        cw, ceast = ce[1:-1, :-2], ce[1:-1, 2:]
        cs, cn = ce[:-2, 1:-1], ce[2:, 1:-1]
        csw, cse = ce[:-2, :-2], ce[:-2, 2:]
        cnw, cne = ce[2:, :-2], ce[2:, 2:]
        w = 1.0 / 16.0
        c00 = w * (9 * c + 3 * cw + 3 * cs + csw)
        c01 = w * (9 * c + 3 * ceast + 3 * cs + cse)
        c10 = w * (9 * c + 3 * cw + 3 * cn + cnw)
        c11 = w * (9 * c + 3 * ceast + 3 * cn + cne)
        bottom = jnp.stack([c00, c01], axis=-1).reshape(Lc.lny, Lf.lnx)
        top = jnp.stack([c10, c11], axis=-1).reshape(Lc.lny, Lf.lnx)
        ef = jnp.stack([bottom, top], axis=1).reshape(Lf.lny, Lf.lnx)
        out = jnp.zeros((Lf.lny + 2, Lf.lnx + 2), dtype=e.dtype)
        return out.at[1 : Lf.lny + 1, 1 : Lf.lnx + 1].set(ef)

    def gather_global(x_interior):
        """all_gather a (lny, lnx) block into the full (ny, nx) interior on
        every device (tiled concatenation in mesh-axis order)."""
        g = x_interior
        if mdy > 1:
            g = lax.all_gather(g, axis_y, axis=0, tiled=True)
        if mdx > 1:
            g = lax.all_gather(g, axis_x, axis=1, tiled=True)
        return g

    def dvcycle(k, p, b, jy, jx):
        geom = local_geom(k, jy, jx)
        p = dist_smooth(k, p, b, cfg.pre_sweeps, geom)
        r = dist_residual(k, p, b, geom)
        if k == switch - 1:
            # coarse switch: replicate the residual, run the tiny tail
            # hierarchy redundantly on every device, slice the local part of
            # the prolonged correction back out
            L = dist[k]
            r_g = jnp.pad(gather_global(r[1:-1, 1:-1]), 1)
            rc = M._restrict(gate_fine, rep_levels[0], r_g)
            ec = rep_vcycle(0, jnp.zeros(rep_levels[0].shape, dtype=rc.dtype), rc)
            ef_g = M._prolong(rep_levels[0], gate_fine, ec)
            ef = lax.dynamic_slice(ef_g, (jy * L.lny, jx * L.lnx),
                                   (L.lny + 2, L.lnx + 2))
            interior = geom[0]
            p = p + jnp.where(interior, ef, jnp.zeros_like(ef))
        else:
            rc = dist_restrict(k, r)
            ec = dvcycle(k + 1, jnp.zeros_like(rc), rc, jy, jx)
            ef = dist_prolong(k, ec, jy, jx)
            interior = geom[0]
            p = p + jnp.where(interior, ef, jnp.zeros_like(ef))
        return dist_smooth(k, p, b, cfg.post_sweeps, geom)

    n_int = problem.nx * problem.ny

    def solve_local(guess, b, jy, jx):
        geom0 = local_geom(0, jy, jx)
        interior0 = geom0[0]
        dtype_ = b.dtype
        max_b = gmax(jnp.max(jnp.abs(b)))
        tol = jnp.maximum(
            cfg.tol_factor * jnp.where(max_b > 0, max_b, jnp.ones_like(max_b)),
            jnp.asarray(cfg.abs_tol, dtype_))
        p0 = jnp.where(interior0, guess, jnp.zeros_like(guess))

        def cond(carry):
            _, res, prev, it = carry
            return (res > tol) & (it < cfg.max_cycles) & (res < cfg.stall_ratio * prev)

        def body(carry):
            p, res, _, it = carry
            p = dvcycle(0, p, b, jy, jx)
            if cfg.pin_mean:
                mean = global_sum(jnp.sum(jnp.where(interior0, p, 0.0)),
                                  axis_y=axis_y, axis_x=axis_x) / n_int
                p = jnp.where(interior0, p - mean, p)
            # p is halo-fresh after the trailing exchange in dist_smooth
            new_res = gmax(jnp.max(jnp.abs(dist_residual(0, p, b, geom0))))
            return p, new_res.astype(dtype_), res, it + 1

        # finite sentinel (see the single-device solve)
        big = jnp.asarray(1e30, dtype_)
        init = (p0, big / 2, big, jnp.asarray(0, jnp.int32))
        p, res, _, iters = lax.while_loop(cond, body, init)
        return p, iters, res

    return solve_local
