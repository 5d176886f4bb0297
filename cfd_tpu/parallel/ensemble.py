"""Data-parallel ensembles: batched independent simulations via vmap.

The DP row of the parallelism inventory (SURVEY.md section 2.3): parameter
sweeps (Reynolds number, lid speed) run as ONE vmapped step over a stacked
state batch — one XLA program advancing every member per call — optionally
sharded over a mesh axis so members ride separate chips.

The per-member physics parameter (viscosity) is a traced scalar, so a single
compiled program serves the whole sweep; dt is shared across the batch (the
most restrictive member's CFL bound, as stability demands anyway).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cfd_tpu.bc import lid_cavity_bc
from cfd_tpu.grid import Grid, cfl_time_step, optimal_omega
from cfd_tpu.ops.stencil import StencilCoeffs, poisson_source, predictor, pressure_correction
from cfd_tpu.poisson.sor import SORConfig, make_eps_neumann_poisson
from cfd_tpu.state import State


def make_cavity_ensemble_step(
    grid: Grid,
    dt: float,
    lid_velocity: float = 1.0,
    tolerance_factor: float = 1e-9,
    max_iters: int = 10000,
    dtype=jnp.float64,
) -> Callable:
    """Returns step(states, viscosities) -> (states, iters, residuals), all
    batched on the leading axis. ``viscosities`` is a (B,) array — each
    member integrates its own Reynolds number through one shared program."""
    bc = lid_cavity_bc(grid, lid_velocity)
    u_valid = jnp.asarray(grid.u_valid_mask)
    v_valid = jnp.asarray(grid.v_valid_mask)
    cell = jnp.asarray(grid.cell_mask)
    omega = optimal_omega(grid.nx)
    sor = SORConfig(omega=omega, tol_factor=tolerance_factor, max_iters=max_iters)

    def one(state: State, viscosity):
        # StencilCoeffs is a plain container: traced viscosity flows through
        c = StencilCoeffs(dx=grid.dx, dy=grid.dy, dt=dt, viscosity=viscosity)
        u, v = bc(state.u, state.v)
        us, vs = predictor(u, v, c, u_valid, v_valid)
        b = poisson_source(us, vs, c, cell, remove_mean=False, n_cells=grid.n_fluid)
        solve = make_eps_neumann_poisson(grid, c, sor)
        p, iters, res = solve(state.p, b)
        u2, v2 = pressure_correction(us, vs, p, c, u_valid, v_valid,
                                     u_else=u, v_else=v, cavity_form=True)
        return State(u2, v2, p, state.T), iters, res

    return jax.jit(jax.vmap(one, in_axes=(0, 0)))


def make_rb_ensemble(
    rayleighs,
    nx: int = 96,
    ny: int = 32,
    aspect: float = 3.0,
    prandtl: float = 0.71,
    cfl: float = 0.4,
    tolerance_factor: float = 1e-6,
    abs_tol: float = 1e-8,
    perturbation: float = 1e-2,
    seed: int = 0,
    dtype=jnp.float32,
    mesh: Mesh | None = None,
):
    """Rayleigh-number sweep of the Boussinesq case as a vmapped ensemble
    (the reference README's own RB TODO is "Nu vs Ra", README.md:91).

    Ra enters the step as a traced per-member scalar (through
    nu = sqrt(Pr/Ra) and kappa = 1/sqrt(Ra*Pr) in free-fall units), so one
    compiled program integrates the whole sweep; dt is the most restrictive
    member's bound. Returns (step, states, ras, dt, nusselt) where
    step(states, ras) -> (states, iters, res) and nusselt(states, ras) gives
    per-member volume/wall Nusselt numbers.
    """
    from cfd_tpu.physics.boussinesq import (
        RBParams, advect_diffuse_scalar, box_noslip_bc, nusselt_numbers,
        temperature_bc)
    from cfd_tpu.poisson.multigrid import MGConfig, make_multigrid_poisson, neumann_problem

    ras = np.asarray(rayleighs, dtype=np.float64)
    grid = Grid.regular(nx, ny, aspect, 1.0)
    params = RBParams(rayleigh=float(ras[0]), prandtl=prandtl)
    h = min(grid.dx, grid.dy)
    diff = [max(np.sqrt(prandtl / ra), 1.0 / np.sqrt(ra * prandtl)) for ra in ras]
    dt = float(min(cfl * min(0.25 * h * h / d, h / 1.0) for d in diff))

    poisson = make_multigrid_poisson(
        neumann_problem(nx, ny, grid.dx, grid.dy),
        MGConfig(tol_factor=tolerance_factor, abs_tol=abs_tol, pin_mean=True),
        dtype=dtype, n_interior=nx * ny,
    )
    vel_bc = box_noslip_bc(grid)
    temp_bc = temperature_bc(grid, params.t_bottom, params.t_top)
    cell = jnp.asarray(grid.cell_mask)
    u_valid = jnp.asarray(grid.u_valid_mask)
    v_valid = jnp.asarray(grid.v_valid_mask)

    def one(state: State, rayleigh):
        nu = jnp.sqrt(prandtl / rayleigh)
        kappa = 1.0 / jnp.sqrt(rayleigh * prandtl)
        c = StencilCoeffs(dx=grid.dx, dy=grid.dy, dt=dt, viscosity=nu)
        u, v, T = state.u, state.v, state.T
        us, vs = predictor(u, v, c, u_valid, v_valid)
        from cfd_tpu.ops.stencil import _sh
        T_face = 0.5 * (T + _sh(T, 1, 0))
        vs = jnp.where(v_valid, vs + dt * T_face, vs)  # buoyancy, free-fall units
        us, vs = vel_bc(us, vs)
        b = poisson_source(us, vs, c, cell, remove_mean=True, n_cells=nx * ny)
        p, iters, res = poisson(state.p, b)
        u2, v2 = pressure_correction(us, vs, p, c, u_valid, v_valid,
                                     u_else=us, v_else=vs)
        u2, v2 = vel_bc(u2, v2)
        T2 = advect_diffuse_scalar(T, u2, v2, c, kappa=kappa, cell_mask=cell)
        T2 = temp_bc(T2)
        return State(u2, v2, p, T2), iters, res

    step = jax.jit(jax.vmap(one, in_axes=(0, 0)))

    def one_nusselt(state: State, rayleigh):
        kappa = 1.0 / jnp.sqrt(rayleigh * prandtl)
        return nusselt_numbers(state, grid, params, kappa=kappa)

    nusselt = jax.jit(jax.vmap(one_nusselt, in_axes=(0, 0)))

    b = len(ras)
    z = jnp.zeros((b, grid.ny + 2, grid.nx + 2), dtype=dtype)
    y = (jnp.arange(grid.shape[0], dtype=dtype) - 0.5) * grid.dy
    T0 = params.t_bottom + (params.t_top - params.t_bottom) * y[:, None]
    noise = perturbation * jax.random.uniform(
        jax.random.PRNGKey(seed), (b,) + grid.shape, dtype=dtype,
        minval=-1.0, maxval=1.0)
    T = jnp.where(cell, (T0[None] + noise).astype(dtype), z)
    T = jax.vmap(temp_bc)(T)
    u0, v0 = jax.vmap(vel_bc)(z, z)
    states = State(u=u0, v=v0, p=z, T=T)
    ras_j = jnp.asarray(ras, dtype=dtype)
    if mesh is not None:
        axis = list(mesh.axis_names)[0]
        batch_sharding = NamedSharding(mesh, P(axis))
        states = State(*(None if x is None else jax.device_put(x, batch_sharding)
                         for x in states))
        ras_j = jax.device_put(ras_j, NamedSharding(mesh, P(axis)))
    return step, states, ras_j, dt, nusselt


def ensemble_cavity_sweep(
    reynolds_numbers,
    n_interior: int = 63,
    lid_velocity: float = 1.0,
    cfl: float = 0.5,
    dtype=jnp.float64,
    mesh: Mesh | None = None,
):
    """Build (step, initial_states, dt) for a Reynolds sweep.

    dt uses the most restrictive (lowest-Re, highest-viscosity) member's CFL
    rule (cavity-01.cpp:359-360) so every member is stable. With ``mesh``
    given, the batch axis is sharded over its first axis (pure data
    parallelism: zero cross-member communication)."""
    res = np.asarray(reynolds_numbers, dtype=np.float64)
    grid = Grid.regular(n_interior, n_interior)
    viscosities = lid_velocity * 1.0 / res  # nu = U*L/Re, L=1 (cavity-01.cpp:356)
    dt = min(cfl_time_step(grid.dx, grid.dy, float(nu), lid_velocity, cfl)
             for nu in viscosities)
    step = make_cavity_ensemble_step(grid, dt, lid_velocity, dtype=dtype)

    b = len(res)
    z = jnp.zeros((b, grid.ny + 2, grid.nx + 2), dtype=dtype)
    bc = lid_cavity_bc(grid, lid_velocity)
    u0, v0 = jax.vmap(bc)(z, z)
    states = State(u=u0, v=v0, p=z, T=None)
    nus = jnp.asarray(viscosities, dtype=dtype)
    if mesh is not None:
        axis = list(mesh.axis_names)[0]
        batch_sharding = NamedSharding(mesh, P(axis))
        states = State(*(None if x is None else jax.device_put(x, batch_sharding)
                         for x in states))
        nus = jax.device_put(nus, NamedSharding(mesh, P(axis)))
    return step, states, nus, dt
