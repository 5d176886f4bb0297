"""Channel (Poiseuille start-up) case.

Reference: ChannelSolver (channel-01.cpp:283-770). Defaults reproduce
channel-01.cpp:286-303 with derived quantities per channel-01.cpp:336-344.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from cfd_tpu.bc import channel_bc, channel_pressure_ghosts
from cfd_tpu.grid import Grid, cfl_time_step, optimal_omega
from cfd_tpu.ops.stencil import StencilCoeffs
from cfd_tpu.precision import ensure_dtype_enabled
from cfd_tpu.poisson.multigrid import MGConfig, channel_problem, make_multigrid_poisson, mg_compatible
from cfd_tpu.poisson.sor import SORConfig, make_ghost_poisson
from cfd_tpu.solver import Case


def make_channel_case(
    nx: int = 93,
    ny: int = 31,
    length: float = 3.0,
    height: float = 1.0,
    reynolds_number: float = 100.0,
    inlet_velocity: float = 1.0,
    density: float = 1.0,
    cfl: float = 0.25,
    final_time: float = 10.0,
    tolerance_factor: float = 1e-7,
    abs_tol: float = 1e-10,
    max_sor_iterations: int = 10000,
    print_interval: int = 100,
    save_interval: int = 100,
    dt: float | None = None,
    poisson_check_every: int = 1,
    poisson: str = "auto",  # "auto" | "sor" | "multigrid"
    dtype=jnp.float64,
    mg_overrides: dict | None = None,  # MGConfig field overrides (tuning)
) -> Case:
    ensure_dtype_enabled(dtype)
    from cfd_tpu.params import check_cfl, validate_case_params

    validate_case_params(
        reynolds_number=reynolds_number, density=density, cfl=cfl,
        final_time=final_time, tolerance_factor=tolerance_factor, dt=dt,
        max_iterations=max_sor_iterations, print_interval=print_interval,
        save_interval=save_interval, length=length, height=height,
        inlet_velocity=inlet_velocity)
    grid = Grid.regular(nx, ny, length, height)
    # nu = U*H/Re (channel-01.cpp:337)
    viscosity = inlet_velocity * height / reynolds_number
    if dt is None:
        dt = cfl_time_step(grid.dx, grid.dy, viscosity, inlet_velocity, cfl)
    else:
        check_cfl(dt, grid.dx, grid.dy, viscosity, abs(inlet_velocity))
    coeffs = StencilCoeffs(dx=grid.dx, dy=grid.dy, dt=dt, viscosity=viscosity, density=density)
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
        # V(1,2): post-smoothing is what kills the slowest error mode of
        # this problem. Measured first-cycle contraction on the step-1
        # source at 1536x512: V(1,2) 0.035, V(2,2) 0.084, V(2,1) 0.84 — so
        # V(1,2) converges like V(2,2) at V(2,1)'s three pairs per cycle,
        # while V(2,1) cannot contract that mode and the run diverges.
        mg = MGConfig(tol_factor=tolerance_factor, abs_tol=abs_tol,
                      pre_sweeps=1, post_sweeps=2)
        if mg_overrides:
            mg = dataclasses.replace(mg, **mg_overrides)
        solve = make_multigrid_poisson(
            channel_problem(nx, ny, grid.dx, grid.dy), mg, dtype=dtype)
        poisson_cap = mg.max_cycles
    elif poisson == "sor":
        solve = make_ghost_poisson(grid, coeffs, sor, channel_pressure_ghosts(grid))
        poisson_cap = sor.max_iters
    else:
        raise ValueError(f"unknown poisson solver: {poisson}")

    return Case(
        name="channel",
        poisson_max_iters=poisson_cap,
        extrapolate_warm_start=(poisson == "multigrid"),
        grid=grid,
        coeffs=coeffs,
        ordering="channel",
        velocity_bc=channel_bc(grid, inlet_velocity),
        poisson_solve=solve,
        remove_source_mean=True,
        cavity_corrector=False,
        ke_divisor=nx * ny,
        final_time=final_time,
        total_steps=int(final_time / dt),
        print_interval=print_interval,
        save_interval=save_interval,
        dtype=dtype,
        vtk_basename="channel_flow",
        vtk_title="Channel Flow Data",
        info=dict(banner_title="Channel Flow Simulation",
                  length=length, height=height, reynolds=reynolds_number,
                  cfl=cfl, omega=omega, inlet_velocity=inlet_velocity,
                  mg=(mg if poisson == "multigrid" else None)),
    )
