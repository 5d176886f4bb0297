"""Slow, loop-based numpy oracles mirroring the reference C++ semantics.

These are independent re-implementations of the reference solvers' per-step
math (written from the discretization spec in SURVEY.md section 2, with the
same loop extents and update orders as cavity-01.cpp / channel-01.cpp /
backwards_step-01.cpp) used as correctness oracles for the vectorized
ops. Everything is float64 and deliberately naive.
"""

from __future__ import annotations

import numpy as np


def predictor_loops(u, v, dx, dy, dt, nu, nx, ny, fluid=None):
    """u*, v* via per-face loops (cavity-01.cpp:548-603; masked variant
    backwards_step-01.cpp:745-820). Returns same-shape arrays, zero outside
    the written region."""
    us = np.zeros_like(u)
    vs = np.zeros_like(v)
    idx, idy = 1.0 / dx, 1.0 / dy
    idx2, idy2 = idx * idx, idy * idy
    for j in range(1, ny + 1):
        for i in range(1, nx):
            if fluid is not None and not (fluid[j, i] or fluid[j, i + 1]):
                continue
            diff = nu * (
                (u[j, i + 1] - 2 * u[j, i] + u[j, i - 1]) * idx2
                + (u[j + 1, i] - 2 * u[j, i] + u[j - 1, i]) * idy2
            )
            u_e = 0.5 * (u[j, i] + u[j, i + 1])
            u_w = 0.5 * (u[j, i - 1] + u[j, i])
            cx = (u_e * u_e - u_w * u_w) * idx
            v_n = 0.5 * (v[j, i] + v[j, i + 1])
            v_s = 0.5 * (v[j - 1, i] + v[j - 1, i + 1])
            u_n = 0.5 * (u[j + 1, i] + u[j, i])
            u_s = 0.5 * (u[j - 1, i] + u[j, i])
            cy = (v_n * u_n - v_s * u_s) * idy
            us[j, i] = u[j, i] + dt * (diff - cx - cy)
    for j in range(1, ny):
        for i in range(1, nx + 1):
            if fluid is not None and not (fluid[j, i] or fluid[j + 1, i]):
                continue
            diff = nu * (
                (v[j, i + 1] - 2 * v[j, i] + v[j, i - 1]) * idx2
                + (v[j + 1, i] - 2 * v[j, i] + v[j - 1, i]) * idy2
            )
            v_n = 0.5 * (v[j, i] + v[j + 1, i])
            v_s = 0.5 * (v[j - 1, i] + v[j, i])
            cy = (v_n * v_n - v_s * v_s) * idy
            u_e = 0.5 * (u[j, i] + u[j + 1, i])
            u_w = 0.5 * (u[j, i - 1] + u[j + 1, i - 1])
            v_e = 0.5 * (v[j, i] + v[j, i + 1])
            v_w = 0.5 * (v[j, i - 1] + v[j, i])
            cx = (u_e * v_e - u_w * v_w) * idx
            vs[j, i] = v[j, i] + dt * (diff - cy - cx)
    return us, vs


def source_loops(us, vs, dx, dy, dt, rho, nx, ny, fluid=None, remove_mean=False):
    """Poisson source (cavity-01.cpp:622-630; channel mean removal
    channel-01.cpp:608-629; masked backwards_step-01.cpp:825-866)."""
    b = np.zeros_like(us)
    idx, idy = 1.0 / dx, 1.0 / dy
    coeff = rho / dt
    for j in range(1, ny + 1):
        for i in range(1, nx + 1):
            if fluid is not None and not fluid[j, i]:
                continue
            b[j, i] = coeff * ((us[j, i] - us[j, i - 1]) * idx + (vs[j, i] - vs[j - 1, i]) * idy)
    if remove_mean and np.abs(b).max() > 0:
        if fluid is None:
            mean = b[1 : ny + 1, 1 : nx + 1].mean()
            b[1 : ny + 1, 1 : nx + 1] -= mean
        else:
            m = fluid[1 : ny + 1, 1 : nx + 1]
            sub = b[1 : ny + 1, 1 : nx + 1]
            mean = sub[m].mean()
            sub[m] -= mean
    return b


def sor_eps_lexicographic(b, h, omega, tol_factor, max_iters, nx, ny):
    """Cavity SOR with indicator functions and the eps_s=1 quirk, exactly
    lexicographic as the reference (cavity-01.cpp:609-690). Cold start."""
    p_new = np.zeros_like(b)
    tol = tol_factor * np.abs(b).max()
    ih2 = 1.0 / (h * h)
    res = 1.0
    it = 0
    while res > tol and it < max_iters:
        it += 1
        p_old = p_new.copy()
        for j in range(1, ny + 1):
            for i in range(1, nx + 1):
                eps_w = 1 if i > 1 else 0
                eps_e = 1 if i < nx else 0
                eps_n = 1 if j < ny else 0
                eps_s = 1
                cnt = eps_w + eps_e + eps_n + eps_s
                p_new[j, i] = p_old[j, i] * (1 - omega) + (omega / cnt) * (
                    eps_e * p_old[j, i + 1]
                    + eps_w * p_new[j, i - 1]
                    + eps_n * p_old[j + 1, i]
                    + eps_s * p_new[j - 1, i]
                    - b[j, i] * h * h
                )
        res = 0.0
        for j in range(1, ny + 1):
            for i in range(1, nx + 1):
                eps_w = 1 if i > 1 else 0
                eps_e = 1 if i < nx else 0
                eps_n = 1 if j < ny else 0
                r = ih2 * (
                    eps_e * (p_new[j, i + 1] - p_new[j, i])
                    + eps_w * (p_new[j, i - 1] - p_new[j, i])
                    + eps_n * (p_new[j + 1, i] - p_new[j, i])
                    + (p_new[j - 1, i] - p_new[j, i])
                ) - b[j, i]
                res = max(res, abs(r))
    return p_new, it, res


def sor_ghost_lexicographic(
    p0, b, dx, dy, omega, tol_factor, abs_tol, max_iters, nx, ny, ghosts_fn, fluid=None
):
    """Channel/step SOR: warm start, stale-E/N Gauss-Seidel, ghost refresh
    per sweep, plain-Laplacian residual (channel-01.cpp:635-688,
    backwards_step-01.cpp:872-939)."""
    p_new = p0.copy()
    idx2, idy2 = 1.0 / dx**2, 1.0 / dy**2
    denom = 2 * (idx2 + idy2)
    max_b = np.abs(b).max()
    tol = max(tol_factor * (max_b if max_b > 0 else 1.0), abs_tol)
    res = tol + 1.0
    it = 0
    while res > tol and it < max_iters:
        it += 1
        p_prev = p_new.copy()
        for j in range(1, ny + 1):
            for i in range(1, nx + 1):
                if fluid is not None and not fluid[j, i]:
                    continue
                s = idx2 * (p_prev[j, i + 1] + p_new[j, i - 1]) + idy2 * (
                    p_prev[j + 1, i] + p_new[j - 1, i]
                )
                gs = (s - b[j, i]) / denom
                p_new[j, i] = (1 - omega) * p_new[j, i] + omega * gs
        ghosts_fn(p_new)
        res = 0.0
        for j in range(1, ny + 1):
            for i in range(1, nx + 1):
                if fluid is not None and not fluid[j, i]:
                    continue
                lap = (p_new[j, i + 1] - 2 * p_new[j, i] + p_new[j, i - 1]) * idx2 + (
                    p_new[j + 1, i] - 2 * p_new[j, i] + p_new[j - 1, i]
                ) * idy2
                res = max(res, abs(lap - b[j, i]))
    return p_new, it, res


def corrector_loops(us, vs, p, dx, dy, dt, rho, nx, ny, cavity_form, fluid=None,
                    u_prev=None, v_prev=None):
    """Projection update (cavity-01.cpp:695-711, channel-01.cpp:693-702,
    masked backwards_step-01.cpp:944-976)."""
    u = np.zeros_like(us) if u_prev is None else u_prev.copy()
    v = np.zeros_like(vs) if v_prev is None else v_prev.copy()
    cu = dt / dx * rho if cavity_form else dt / (rho * dx)
    cv = dt / dy * rho if cavity_form else dt / (rho * dy)
    for j in range(1, ny + 1):
        for i in range(1, nx):
            if fluid is not None and not (fluid[j, i] or fluid[j, i + 1]):
                u[j, i] = 0.0
                continue
            u[j, i] = us[j, i] - cu * (p[j, i + 1] - p[j, i])
    for j in range(1, ny):
        for i in range(1, nx + 1):
            if fluid is not None and not (fluid[j, i] or fluid[j + 1, i]):
                v[j, i] = 0.0
                continue
            v[j, i] = vs[j, i] - cv * (p[j + 1, i] - p[j, i])
    return u, v


def cavity_bc_loops(u, v, nx, ny, lid):
    """cavity-01.cpp:523-543."""
    u = u.copy()
    v = v.copy()
    for i in range(0, nx + 1):
        u[ny + 1, i] = 2.0 * lid - u[ny, i]
        u[0, i] = -u[1, i]
    for j in range(0, ny + 1):
        v[j, nx + 1] = -v[j, nx]
        v[j, 0] = -v[j, 1]
    return u, v


def channel_bc_loops(u, v, nx, ny, uin):
    """channel-01.cpp:513-529 in reference order."""
    u = u.copy()
    v = v.copy()
    for j in range(1, ny + 1):
        u[j, 0] = uin
    for j in range(0, ny + 1):
        v[j, 0] = 0.0
    for j in range(1, ny + 1):
        u[j, nx] = u[j, nx - 1]
    for j in range(0, ny + 1):
        v[j, nx + 1] = v[j, nx]
    for i in range(1, nx + 1):
        v[0, i] = 0.0
    for i in range(0, nx + 1):
        u[0, i] = -u[1, i]
    for i in range(1, nx + 1):
        v[ny, i] = 0.0
    for i in range(0, nx + 1):
        u[ny + 1, i] = -u[ny, i]
    return u, v


def step_bc_loops(u, v, nx, ny, uin, inlet_j_max, fluid):
    """backwards_step-01.cpp:616-683 in reference order."""
    u = u.copy()
    v = v.copy()
    for j in range(1, inlet_j_max + 1):
        u[j, 0] = uin
    for j in range(inlet_j_max + 1, ny + 1):
        u[j, 0] = 0.0
    for j in range(0, ny + 1):
        v[j, 0] = 0.0
    for j in range(1, ny + 1):
        u[j, nx] = u[j, nx - 1]
    for j in range(0, ny + 1):
        v[j, nx + 1] = v[j, nx]
    for i in range(1, nx + 1):
        v[0, i] = 0.0
    for i in range(0, nx + 1):
        u[0, i] = -u[1, i]
    for i in range(1, nx + 1):
        v[ny, i] = 0.0
    for i in range(0, nx + 1):
        u[ny + 1, i] = -u[ny, i]
    for j in range(1, ny + 1):
        for i in range(1, nx + 1):
            if not fluid[j, i]:
                if i < nx and fluid[j, i + 1]:
                    u[j, i] = 0.0
                if i > 1 and fluid[j, i - 1]:
                    u[j, i - 1] = 0.0
                if j < ny and fluid[j + 1, i]:
                    v[j, i] = 0.0
                if j > 1 and fluid[j - 1, i]:
                    v[j - 1, i] = 0.0
    return u, v


def channel_pressure_ghosts_loops(p, nx, ny):
    """channel-01.cpp:531-541 (in place)."""
    for j in range(1, ny + 1):
        p[j, 0] = p[j, 1]
    for j in range(1, ny + 1):
        p[j, nx + 1] = 0.0
    for i in range(1, nx + 1):
        p[0, i] = p[1, i]
        p[ny + 1, i] = p[ny, i]
    return p


def step_pressure_ghosts_loops(p, nx, ny, fluid):
    """backwards_step-01.cpp:685-740 (in place)."""
    channel_pressure_ghosts_loops(p, nx, ny)
    for j in range(1, ny + 1):
        for i in range(1, nx + 1):
            if not fluid[j, i]:
                s = 0.0
                cnt = 0
                if i > 1 and fluid[j, i - 1]:
                    s += p[j, i - 1]
                    cnt += 1
                if i < nx and fluid[j, i + 1]:
                    s += p[j, i + 1]
                    cnt += 1
                if j > 1 and fluid[j - 1, i]:
                    s += p[j - 1, i]
                    cnt += 1
                if j < ny and fluid[j + 1, i]:
                    s += p[j + 1, i]
                    cnt += 1
                if cnt > 0:
                    p[j, i] = s / cnt
    return p


def rb_pairs_loops(p, b, wE, wW, wN, wS, idx2, idy2, omega, n_pairs, nx, ny):
    """``n_pairs`` red+black Gauss-Seidel pairs of the weighted 5-point
    operator (poisson.multigrid module docstring; full (ny+2, nx+2) weight
    arrays). Red cells have (i + j) even; a cell with no coupling is left
    alone. Same-colour cells do not read each other, so each half-sweep
    reads the array as it stood before it."""
    p = p.copy()
    for _ in range(n_pairs):
        for parity in (0, 1):
            new = p.copy()
            for j in range(1, ny + 1):
                for i in range(1, nx + 1):
                    if (i + j) % 2 != parity:
                        continue
                    d = idx2 * (wE[j, i] + wW[j, i]) + idy2 * (wN[j, i] + wS[j, i])
                    if d <= 0:
                        continue
                    gs = (idx2 * (wE[j, i] * p[j, i + 1] + wW[j, i] * p[j, i - 1])
                          + idy2 * (wN[j, i] * p[j + 1, i] + wS[j, i] * p[j - 1, i])
                          - b[j, i]) / d
                    new[j, i] = p[j, i] + omega * (gs - p[j, i])
            p = new
    return p


def residual_loops(p, b, wE, wW, wN, wS, idx2, idy2, nx, ny):
    """b - A p of the weighted operator on the interior, 0 elsewhere."""
    r = np.zeros_like(p)
    for j in range(1, ny + 1):
        for i in range(1, nx + 1):
            ap = (idx2 * (wE[j, i] * (p[j, i + 1] - p[j, i])
                          + wW[j, i] * (p[j, i - 1] - p[j, i]))
                  + idy2 * (wN[j, i] * (p[j + 1, i] - p[j, i])
                            + wS[j, i] * (p[j - 1, i] - p[j, i])))
            r[j, i] = b[j, i] - ap
    return r


def restrict_loops(r, nx_c, ny_c):
    """Full weighting: each coarse interior cell is the mean of its four
    fine children; padded coarse shape, ghosts 0."""
    out = np.zeros((ny_c + 2, nx_c + 2))
    for J in range(1, ny_c + 1):
        for I in range(1, nx_c + 1):
            j, i = 2 * J - 1, 2 * I - 1
            out[J, I] = 0.25 * (r[j, i] + r[j, i + 1] + r[j + 1, i] + r[j + 1, i + 1])
    return out


def prolong_loops(e, nx_c, ny_c):
    """Cell-centred bilinear (9-3-3-1)/16 interpolation of a coarse
    correction, coarse ghosts replaced by edge extrapolation."""
    ce = np.pad(e[1:ny_c + 1, 1:nx_c + 1], 1, mode="edge")
    out = np.zeros((2 * ny_c + 2, 2 * nx_c + 2))
    for J in range(1, ny_c + 1):
        for I in range(1, nx_c + 1):
            for cj in (0, 1):
                for ci in (0, 1):
                    sj = 1 if cj else -1
                    si = 1 if ci else -1
                    out[2 * J - 1 + cj, 2 * I - 1 + ci] = (
                        9 * ce[J, I] + 3 * ce[J, I + si] + 3 * ce[J + sj, I]
                        + ce[J + sj, I + si]) / 16.0
    return out
