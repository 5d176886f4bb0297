"""Rayleigh-Benard convection: Boussinesq momentum + temperature transport.

The reference documents this case with figures only — no code exists in its
repo (README.md:79-94; artifact filename implies 192x64, Ra=1e6, heated
bottom / cooled top, SURVEY.md component #35). Built here from the physics
spec on the same staggered projection core.

Nondimensionalization (FREE-FALL units: with the buoyancy velocity as the
unit, every field is O(1) and the whole solve is float32-clean, where
thermal-diffusion units put the pressure at O(Ra*Pr) and push the Poisson
residual past f32 resolution): lengths by the layer
height H, velocity by U_ff = sqrt(g alpha dT H), time by H/U_ff. Then

    du/dt + div(u u) = -grad p + sqrt(Pr/Ra) lap(u)
    dv/dt + div(u v) = -grad p + sqrt(Pr/Ra) lap(v) + T
    dT/dt + div(u T) =           1/sqrt(Ra Pr) lap(T)

with T=1 at the bottom wall, T=0 at the top, adiabatic no-slip sidewalls.
The expected heat transport at Ra=1e6, Pr~0.7 is Nu ~ 8-9 (classical 2D
steady-roll benchmarks), which the Nusselt diagnostics reproduce.

The projection core is the channel-style ordering with a pure-Neumann
pressure problem: mean-removed source + mean-pinned multigrid.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from cfd_tpu.bc import _r, put
from cfd_tpu.grid import Grid
from cfd_tpu.ops.stencil import StencilCoeffs, _sh, poisson_source, pressure_correction
from cfd_tpu.poisson.multigrid import MGConfig, make_multigrid_poisson, mg_compatible, neumann_problem
from cfd_tpu.precision import ensure_dtype_enabled
from cfd_tpu.solver import Case
from cfd_tpu.state import State, StepDiagnostics


def box_noslip_bc(grid: Grid):
    """No-slip on all four walls: wall-normal faces stay 0, tangential
    ghosts antisymmetric."""
    nx, ny = grid.nx, grid.ny

    def bc(u, v):
        u = put(u, _r(0), slice(0, nx + 1), -_sh(u, 1, 0))
        u = put(u, _r(ny + 1), slice(0, nx + 1), -_sh(u, -1, 0))
        u = put(u, slice(1, ny + 1), _r(0), 0.0)
        u = put(u, slice(1, ny + 1), _r(nx), 0.0)
        v = put(v, slice(0, ny + 1), _r(0), -_sh(v, 0, 1))
        v = put(v, slice(0, ny + 1), _r(nx + 1), -_sh(v, 0, -1))
        v = put(v, _r(0), slice(1, nx + 1), 0.0)
        v = put(v, _r(ny), slice(1, nx + 1), 0.0)
        return u, v

    return bc


def temperature_bc(grid: Grid, t_bottom: float = 1.0, t_top: float = 0.0):
    """Dirichlet bottom/top via ghost reflection, adiabatic (Neumann) sides."""
    nx, ny = grid.nx, grid.ny

    def bc(T):
        T = put(T, _r(0), slice(1, nx + 1), 2.0 * t_bottom - _sh(T, 1, 0))
        T = put(T, _r(ny + 1), slice(1, nx + 1), 2.0 * t_top - _sh(T, -1, 0))
        T = put(T, slice(1, ny + 1), _r(0), _sh(T, 0, 1))
        T = put(T, slice(1, ny + 1), _r(nx + 1), _sh(T, 0, -1))
        return T

    return bc


def advect_diffuse_scalar(T, u, v, c: StencilCoeffs, kappa: float, cell_mask):
    """Flux-form central advection + central diffusion + Forward Euler for a
    cell-centered scalar, mirroring the momentum scheme's structure
    (cavity-01.cpp:561-571 applied to T on the MAC grid)."""
    idx, idy, idx2, idy2 = c.idx, c.idy, c.idx2, c.idy2
    TE, TW = _sh(T, 0, 1), _sh(T, 0, -1)
    TN, TS = _sh(T, 1, 0), _sh(T, -1, 0)
    # face fluxes: u[j,i] carries 0.5*(T[j,i]+T[j,i+1]) across the east face
    flux_e = u * 0.5 * (T + TE)
    flux_n = v * 0.5 * (T + TN)
    adv = (flux_e - _sh(flux_e, 0, -1)) * idx + (flux_n - _sh(flux_n, -1, 0)) * idy
    lap = (TE - 2.0 * T + TW) * idx2 + (TN - 2.0 * T + TS) * idy2
    T_new = T + c.dt * (kappa * lap - adv)
    return jnp.where(cell_mask, T_new, T)


@dataclasses.dataclass(frozen=True)
class RBParams:
    rayleigh: float
    prandtl: float
    t_bottom: float = 1.0
    t_top: float = 0.0


def nusselt_numbers(state: State, grid: Grid, params: RBParams,
                    kappa: float = 1.0) -> dict:
    """Heat-transport diagnostics: wall Nusselt numbers from one-sided
    gradients (ghosts encode the Dirichlet values) and the volume-averaged
    convective Nu = 1 + <v T>/kappa (conductive flux kappa*dT/H)."""
    T = state.T
    ny = grid.ny
    dy = grid.dy
    dT = params.t_bottom - params.t_top
    # wall gradient from ghost-cell reflection: dT/dy|wall = (T[1]-T[0])/dy;
    # Nu = (-dT/dy|wall) / (dT/H), conductive profile gives exactly 1.
    nu_bottom = -jnp.mean((T[1, 1:-1] - T[0, 1:-1]) / dy) / dT
    nu_top = -jnp.mean((T[ny + 1, 1:-1] - T[ny, 1:-1]) / dy) / dT
    # center v and T product
    vc = 0.5 * (state.v + _sh(state.v, -1, 0))
    cell = jnp.zeros(T.shape, bool).at[1 : ny + 1, 1 : grid.nx + 1].set(True)
    vt = jnp.sum(jnp.where(cell, vc * T, 0.0)) / (grid.nx * ny)
    return {
        "nusselt_bottom": nu_bottom,
        "nusselt_top": nu_top,
        "nusselt_volume": 1.0 + vt / (kappa * dT),
        "temperature_min": jnp.min(jnp.where(cell, T, params.t_bottom)),
        "temperature_max": jnp.max(jnp.where(cell, T, params.t_top)),
    }


def streamfunction(u: jnp.ndarray, grid: Grid) -> jnp.ndarray:
    """psi at cell centers from psi(y) = integral of u dy per column, psi=0
    at the bottom wall (visualization diagnostic; README.md:88 lists
    streamfunction among the RB outputs)."""
    ny, nx = grid.ny, grid.nx
    # u at cell centers
    uc = 0.5 * (u + _sh(u, 0, -1))
    interior = uc[1 : ny + 1, 1 : nx + 1]
    psi = jnp.cumsum(interior, axis=0) * grid.dy - 0.5 * grid.dy * interior
    out = jnp.zeros_like(u)
    return out.at[1 : ny + 1, 1 : nx + 1].set(psi)


def make_rayleigh_benard_case(
    nx: int = 192,
    ny: int = 64,
    aspect: float = 3.0,
    rayleigh: float = 1e6,
    prandtl: float = 0.71,
    cfl: float = 0.4,
    final_time: float = 100.0,
    dt: float | None = None,
    tolerance_factor: float = 1e-7,
    abs_tol: float = 1e-10,
    print_interval: int = 100,
    save_interval: int = 100,
    perturbation: float = 1e-2,
    seed: int = 0,
    dtype=jnp.float32,
    mg_overrides: dict | None = None,
    extrapolate_warm_start: bool = False,
) -> Case:
    """192x64 Ra=1e6 heated-bottom/cooled-top per the reference artifact
    (.MISSING_LARGE_BLOBS:1); final_time in thermal-diffusion units.

    ``extrapolate_warm_start``: warm-start each pressure solve from the
    extrapolated guess 2 p_n - p_{n-1} instead of plain p_n (the cavity
    default). At 1536x512 Ra=1e6 both reach the tolerance in the same
    cycles/step, so the default stays False (no p_prev state)."""
    ensure_dtype_enabled(dtype)
    from cfd_tpu.params import validate_case_params

    validate_case_params(
        cfl=cfl, final_time=final_time, tolerance_factor=tolerance_factor,
        dt=dt, print_interval=print_interval, save_interval=save_interval,
        rayleigh=rayleigh, prandtl=prandtl, aspect=aspect)
    grid = Grid.regular(nx, ny, aspect, 1.0)
    params = RBParams(rayleigh=rayleigh, prandtl=prandtl)
    # free-fall-unit transport coefficients
    nu = float(np.sqrt(prandtl / rayleigh))
    kappa = float(1.0 / np.sqrt(rayleigh * prandtl))
    # dt: diffusive limits for momentum and heat, plus the advective limit
    # with the O(1) free-fall velocity.
    h = min(grid.dx, grid.dy)
    if dt is None:
        dt = cfl * min(0.25 * h * h / max(nu, kappa), h / 1.0)
    coeffs = StencilCoeffs(dx=grid.dx, dy=grid.dy, dt=dt, viscosity=nu)

    if not mg_compatible(nx, ny):
        raise ValueError("rayleigh_benard requires multigrid-compatible nx, ny "
                         "(even, >= 8)")
    # V(2,1), as the cavity flavor (same separable smoother, pure-Neumann
    # weights; mean pinned every cycle)
    mg = MGConfig(tol_factor=tolerance_factor, abs_tol=abs_tol, pin_mean=True,
                  post_sweeps=1)
    if mg_overrides:
        mg = dataclasses.replace(mg, **mg_overrides)
    problem = neumann_problem(nx, ny, grid.dx, grid.dy)
    poisson = make_multigrid_poisson(problem, mg, dtype=dtype,
                                     n_interior=nx * ny)
    vel_bc = box_noslip_bc(grid)
    temp_bc = temperature_bc(grid, params.t_bottom, params.t_top)
    cell = jnp.asarray(grid.cell_mask)
    u_valid = jnp.asarray(grid.u_valid_mask)
    v_valid = jnp.asarray(grid.v_valid_mask)
    buoy = 1.0  # free-fall units

    def custom_step(case: Case):
        from cfd_tpu.ops.stencil import predictor

        def step(state: State, dt=None):
            c = coeffs if dt is None else dataclasses.replace(coeffs, dt=dt)
            u, v, T = state.u, state.v, state.T
            us, vs = predictor(u, v, c, u_valid, v_valid)
            # buoyancy on v-faces: T averaged to the face between
            # rows (j) and (j+1)
            T_face = 0.5 * (T + _sh(T, 1, 0))
            vs = jnp.where(v_valid, vs + c.dt * buoy * T_face, vs)
            us, vs = vel_bc(us, vs)
            b = poisson_source(us, vs, c, cell, remove_mean=True,
                               n_cells=nx * ny)
            guess = (2.0 * state.p - state.p_prev
                     if extrapolate_warm_start and state.p_prev is not None
                     else state.p)
            p, iters, res = poisson(guess, b)
            u2, v2 = pressure_correction(us, vs, p, c, u_valid,
                                         v_valid, u_else=us, v_else=vs)
            u2, v2 = vel_bc(u2, v2)
            T2 = advect_diffuse_scalar(T, u2, v2, c, kappa=kappa,
                                       cell_mask=cell)
            T2 = temp_bc(T2)
            p_prev = state.p if extrapolate_warm_start else None
            return State(u2, v2, p, T2, p_prev), \
                StepDiagnostics(iters, res)

        return step

    def initial_state_fn() -> State:
        z = jnp.zeros(grid.shape, dtype=dtype)
        # conductive profile + seeded perturbation to break symmetry
        y = (jnp.arange(grid.shape[0], dtype=dtype) - 0.5) * grid.dy
        T0 = params.t_bottom + (params.t_top - params.t_bottom) * y[:, None]
        key = jax.random.PRNGKey(seed)
        noise = perturbation * jax.random.uniform(key, grid.shape, dtype=dtype,
                                                  minval=-1.0, maxval=1.0)
        T = jnp.where(cell, (T0 + noise).astype(dtype), z)
        T = temp_bc(T)
        u, v = vel_bc(z, z)
        # p_prev pre-filled (= p at t=0) so the scan-carry structure stays
        # static across steps when the extrapolated warm start is on
        return State(u, v, z, T, z if extrapolate_warm_start else None)

    def extra_stats(state: State):
        return nusselt_numbers(state, grid, params, kappa=kappa)

    def vtk_extra_fields(state: State):
        return {
            "temperature": jnp.where(cell, state.T, jnp.zeros_like(state.T)),
            "streamfunction": streamfunction(state.u, grid),
        }

    return Case(
        name="rayleigh_benard",
        grid=grid,
        coeffs=coeffs,
        ordering="channel",  # unused (custom_step) but a valid tag
        velocity_bc=vel_bc,
        poisson_solve=poisson,
        remove_source_mean=True,
        cavity_corrector=False,
        ke_divisor=nx * ny,
        final_time=final_time,
        total_steps=int(final_time / dt),
        print_interval=print_interval,
        save_interval=save_interval,
        dtype=dtype,
        vtk_basename="rayleigh_benard",
        vtk_title="Rayleigh-Benard Convection Data",
        info=dict(banner_title="Rayleigh-Benard Convection Simulation",
                  length=aspect, height=1.0, rayleigh=rayleigh,
                  prandtl=prandtl, cfl=cfl, mg=mg),
        custom_step=custom_step,
        extrapolate_warm_start=extrapolate_warm_start,
        adaptive_diffusivity=max(nu, kappa),
        extra_stats=extra_stats,
        initial_state_fn=initial_state_fn,
        vtk_extra_fields=vtk_extra_fields,
    )
