"""Backward-facing step case with internal solid geometry.

Reference: BackwardsStepSolver (backwards_step-01.cpp:316-1061). Geometry:
solid block occupying {i <= step_i_location and j > inlet_j_max}
(backwards_step-01.cpp:499-520); everything else is the general masked
machinery (face-validity masks, interface zeroing, solid-cell pressure
extrapolation), so arbitrary rasterized solids work through Grid.masked.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from cfd_tpu.bc import step_bc, step_pressure_ghosts
from cfd_tpu.grid import Grid, cfl_time_step, optimal_omega
from cfd_tpu.ops.stencil import StencilCoeffs
from cfd_tpu.precision import ensure_dtype_enabled
from cfd_tpu.poisson.multigrid import MGConfig, make_masked_multigrid_poisson, mg_compatible
from cfd_tpu.poisson.sor import SORConfig, make_ghost_poisson
from cfd_tpu.solver import Case


def make_backwards_step_case(
    nx: int = 256,
    ny: int = 32,
    length: float = 8.0,
    height_inlet: float = 1.0,
    height_total: float = 2.0,
    step_location: float = 2.0,
    reynolds_number: float = 100.0,
    inlet_velocity: float = 1.0,
    density: float = 1.0,
    cfl: float = 0.2,
    final_time: float = 15.0,
    tolerance_factor: float = 1e-7,
    abs_tol: float = 1e-10,
    max_sor_iterations: int = 10000,
    print_interval: int = 10,
    save_interval: int = 10,
    dt: float | None = None,
    poisson_check_every: int = 1,
    poisson: str = "auto",  # "auto" | "sor" | "multigrid" (defect-correction masked MG)
    dtype=jnp.float64,
    mg_overrides: dict | None = None,  # MGConfig field overrides (tuning)
) -> Case:
    ensure_dtype_enabled(dtype)
    from cfd_tpu.params import check_cfl, validate_case_params

    validate_case_params(
        reynolds_number=reynolds_number, density=density, cfl=cfl,
        final_time=final_time, tolerance_factor=tolerance_factor, dt=dt,
        max_iterations=max_sor_iterations, print_interval=print_interval,
        save_interval=save_interval, length=length,
        height_inlet=height_inlet, height_total=height_total,
        step_location=step_location, inlet_velocity=inlet_velocity)
    # geometry bounds (backwards_step-01.cpp:455-461)
    if not (height_inlet < height_total):
        raise ValueError(
            f"height_inlet ({height_inlet}) must be < height_total "
            f"({height_total})")
    if not (step_location < length):
        raise ValueError(
            f"step_location ({step_location}) must be < length ({length})")
    dx = length / nx
    dy = height_total / ny
    step_i = int(step_location / dx)  # backwards_step-01.cpp:387
    inlet_j_max = int(height_inlet / dy)  # backwards_step-01.cpp:493

    # fluid raster (backwards_step-01.cpp:508-520): before the step only the
    # lower (inlet) rows are fluid; after it, full height.
    fluid = np.zeros((ny, nx), dtype=bool)
    jj = np.arange(1, ny + 1)[:, None]
    ii = np.arange(1, nx + 1)[None, :]
    fluid[:, :] = np.where(ii <= step_i, jj <= inlet_j_max, True)

    grid = Grid.masked(nx, ny, length, height_total, fluid)
    viscosity = inlet_velocity * height_inlet / reynolds_number  # backwards_step-01.cpp:379
    if dt is None:
        dt = cfl_time_step(dx, dy, viscosity, inlet_velocity, cfl)
    else:
        check_cfl(dt, dx, dy, viscosity, abs(inlet_velocity))
    coeffs = StencilCoeffs(dx=dx, dy=dy, dt=dt, viscosity=viscosity, density=density)
    omega = optimal_omega(nx, ny)
    sor = SORConfig(
        omega=omega,
        tol_factor=tolerance_factor,
        abs_tol=abs_tol,
        max_iters=max_sor_iterations,
        check_every=poisson_check_every,
    )
    if poisson == "auto":
        poisson = "multigrid" if mg_compatible(nx, ny) and max(nx, ny) >= 128 else "sor"
    if poisson == "multigrid":
        # Defect-correction masked MG: exact reference operator on the fine
        # level (ghost refresh incl. solid-cell averaging), weighted
        # approximation on the coarse hierarchy (SURVEY.md "masked multigrid"
        # hard part).
        # V(1,2): with honest stall exits (MGConfig.stall_ratio) the
        # masked defect correction leaves a barely-contracting mode that
        # post-smoothing handles best; V(2,2) and V(2,1) need more cycles.
        mg = MGConfig(tol_factor=tolerance_factor, abs_tol=abs_tol,
                      pre_sweeps=1, post_sweeps=2)
        if mg_overrides:
            mg = dataclasses.replace(mg, **mg_overrides)
        solve = make_masked_multigrid_poisson(
            grid, coeffs, mg, step_pressure_ghosts(grid), dtype=dtype)
        poisson_cap = mg.max_cycles
    elif poisson == "sor":
        solve = make_ghost_poisson(grid, coeffs, sor, step_pressure_ghosts(grid))
        poisson_cap = sor.max_iters
    else:
        raise ValueError(f"unknown poisson solver: {poisson}")

    return Case(
        name="backwards_step",
        poisson_max_iters=poisson_cap,
        # Plain previous-p warm start (the channel ordering's default,
        # channel-01.cpp:636): the 2p - p_prev extrapolation was measured
        # to raise this case's cycles/step at 2048x256 (4.0 -> 5.75) — it
        # doubles the f32 stall-floor noise that the masked
        # defect-correction V-cycle then re-contracts.
        extrapolate_warm_start=False,
        grid=grid,
        coeffs=coeffs,
        ordering="channel",
        velocity_bc=step_bc(grid, inlet_velocity, inlet_j_max),
        poisson_solve=solve,
        remove_source_mean=True,
        cavity_corrector=False,
        ke_divisor=grid.n_fluid,  # backwards_step-01.cpp:1055
        final_time=final_time,
        total_steps=int(final_time / dt),
        print_interval=print_interval,
        save_interval=save_interval,
        dtype=dtype,
        vtk_basename="backwards_step",
        vtk_title="Backwards Step Flow Data",
        info=dict(banner_title="Backwards Step Flow Simulation",
                  length=length, height=height_total,
                  step_height=height_total - height_inlet,
                  step_location=step_location, reynolds=reynolds_number,
                  cfl=cfl, omega=omega, inlet_velocity=inlet_velocity,
                  mg=(mg if poisson == "multigrid" else None)),
    )
