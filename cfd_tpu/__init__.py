"""cfd_tpu — incompressible Navier-Stokes framework in JAX.

A JAX/XLA re-design of the capabilities of the reference
C++ CFD portfolio (tjjones6/Computational-Fluid-Dynamics): staggered-MAC-grid
explicit projection method, SOR/multigrid pressure-Poisson solvers, vectorized
ghost-cell boundary conditions, internal solid geometry via masks, Boussinesq
thermal convection with FTLE diagnostics, VTK/ParaView output, and 2D spatial
domain decomposition over device meshes.

Reference layer map: SURVEY.md section 1 (cavity-01.cpp, channel-01.cpp,
backwards_step-01.cpp).
"""

from cfd_tpu.grid import Grid, cfl_time_step, optimal_omega
from cfd_tpu.state import State

__version__ = "0.1.0"

__all__ = ["Grid", "State", "cfl_time_step", "optimal_omega", "__version__"]
