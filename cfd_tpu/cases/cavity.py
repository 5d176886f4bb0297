"""Lid-driven cavity case.

Reference: CavitySolver (cavity-01.cpp:306-775). Defaults reproduce the
reference's compile-time constants exactly (cavity-01.cpp:309-320) and the
derived quantities use the same float64 host arithmetic expression shapes
(cavity-01.cpp:355-363), so dt and step counts match bit-for-bit.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from cfd_tpu.bc import lid_cavity_bc
from cfd_tpu.grid import Grid, cfl_time_step, optimal_omega
from cfd_tpu.ops.stencil import StencilCoeffs
from cfd_tpu.precision import ensure_dtype_enabled
from cfd_tpu.poisson.multigrid import MGConfig, cavity_problem, make_multigrid_poisson, mg_compatible
from cfd_tpu.poisson.sor import SORConfig, make_eps_neumann_poisson
from cfd_tpu.solver import Case


def make_cavity_case(
    n_interior: int = 63,
    reynolds_number: float = 1000.0,
    cavity_length: float = 1.0,
    cavity_height: float = 1.0,
    lid_velocity: float = 1.0,
    density: float = 1.0,
    cfl_number: float = 0.5,
    final_time: float = 20.0,
    tolerance_factor: float = 1e-9,
    max_sor_iterations: int = 10000,
    print_interval: int = 100,
    save_interval: int = 100,
    dt: float | None = None,
    poisson_check_every: int = 1,
    poisson: str = "auto",  # "auto" | "sor" | "multigrid"
    dtype=jnp.float64,
    mg_overrides: dict | None = None,  # MGConfig field overrides (tuning)
    forcing: tuple | None = None,  # (fx, fy) body-force arrays on u/v faces
) -> Case:
    ensure_dtype_enabled(dtype)
    # systematic constructor checks (cavity-01.cpp:417-425 made runtime)
    from cfd_tpu.params import check_cfl, validate_case_params

    validate_case_params(
        reynolds_number=reynolds_number, density=density, cfl=cfl_number,
        final_time=final_time, tolerance_factor=tolerance_factor, dt=dt,
        max_iterations=max_sor_iterations, print_interval=print_interval,
        save_interval=save_interval, cavity_length=cavity_length,
        cavity_height=cavity_height)
    grid = Grid.regular(n_interior, n_interior, cavity_length, cavity_height)
    # nu = rho*U*L/Re (cavity-01.cpp:356)
    viscosity = density * lid_velocity * cavity_length / reynolds_number
    if dt is None:
        dt = cfl_time_step(grid.dx, grid.dy, viscosity, lid_velocity, cfl_number)
    else:
        check_cfl(dt, grid.dx, grid.dy, viscosity, abs(lid_velocity))
    coeffs = StencilCoeffs(dx=grid.dx, dy=grid.dy, dt=dt, viscosity=viscosity, density=density)
    omega = optimal_omega(n_interior)  # square form, cavity-01.cpp:74-78
    sor = SORConfig(
        omega=omega,
        tol_factor=tolerance_factor,
        abs_tol=0.0,
        max_iters=max_sor_iterations,
        check_every=poisson_check_every,
    )
    if poisson == "auto":
        # SOR matches the reference's iteration behavior and wins on small
        # grids; multigrid's O(N) advantage takes over at scale (the
        # reference's own TODO, README.md:39). The reference 63^2 config is
        # odd-sized and stays on SOR.
        poisson = "multigrid" if mg_compatible(n_interior, n_interior) and n_interior >= 128 else "sor"
    if poisson == "multigrid":
        # V(2,1): at 2048^2 it reaches the tolerance in the same
        # cycles/step as MGConfig's V(2,2) with one smoothing pair fewer
        # per cycle (PERF.md).
        mg = MGConfig(tol_factor=tolerance_factor, abs_tol=0.0, post_sweeps=1)
        if mg_overrides:
            mg = dataclasses.replace(mg, **mg_overrides)
        solve = make_multigrid_poisson(
            cavity_problem(n_interior, n_interior, grid.dx, grid.dy), mg,
            dtype=dtype)
        poisson_cap = mg.max_cycles
    elif poisson == "sor":
        solve = make_eps_neumann_poisson(grid, coeffs, sor)
        poisson_cap = sor.max_iters
    else:
        raise ValueError(f"unknown poisson solver: {poisson}")

    return Case(
        poisson_max_iters=poisson_cap,
        forcing=forcing,
        name="cavity",
        extrapolate_warm_start=(poisson == "multigrid"),
        grid=grid,
        coeffs=coeffs,
        ordering="cavity",
        velocity_bc=lid_cavity_bc(grid, lid_velocity),
        poisson_solve=solve,
        remove_source_mean=False,
        cavity_corrector=True,
        ke_divisor=n_interior * n_interior,
        final_time=final_time,
        total_steps=int(final_time / dt),
        print_interval=print_interval,
        save_interval=save_interval,
        dtype=dtype,
        vtk_basename="cavity_flow",
        vtk_title="Lid-Driven Cavity Flow Data",
        info=dict(banner_title="Lid-Driven Cavity Flow Simulation",
                  length=cavity_length, height=cavity_height,
                  square_spacing=True, reynolds=reynolds_number,
                  cfl=cfl_number, omega=omega, lid_velocity=lid_velocity,
                  mg=(mg if poisson == "multigrid" else None)),
    )
