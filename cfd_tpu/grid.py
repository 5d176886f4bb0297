"""Staggered MAC grid, geometry masks, and face-validity derivation.

Vectorized equivalent of the reference's L0 field/memory layer
(``create_field`` + implicit staggered shapes, cavity-01.cpp:45-67,
channel-01.cpp:46-68) and L2 geometry layer (``is_fluid`` raster + masked
stencils, backwards_step-01.cpp:492-532, 745-976).

Design: every field is a dense ``(ny+2, nx+2)`` array (row j = y index,
col i = x index), with a one-cell ghost ring, regardless of whether it
lives at cell centers (p), x-faces (u) or y-faces (v):

* ``p[j, i]``   — pressure at center of cell (j, i); interior j in [1, ny],
  i in [1, nx].
* ``u[j, i]``   — x-velocity on the EAST face of cell (j, i); physical face
  columns i in [0, nx] (reference shape (ny+2, nx+1), cavity-01.cpp:436);
  column nx+1 is structural padding, kept identically zero.
* ``v[j, i]``   — y-velocity on the NORTH face of cell (j, i); physical face
  rows j in [0, ny] (reference shape (ny+1, nx+2), cavity-01.cpp:439);
  row ny+1 is structural padding, kept identically zero.

Uniform padded shapes keep every stencil a same-shape shifted-array
expression, which XLA fuses into single VPU passes and GSPMD shards with
automatic halo exchange. Geometry is expressed purely as precomputed boolean
masks (the reference's backwards-step solver proves masks subsume geometry).

All masks are built host-side with numpy, mirroring the reference's loop
predicates exactly (cited per mask), then used as constants inside jit.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static description of a 2D staggered MAC grid with optional solid mask.

    Attributes:
      nx, ny: interior cell counts in x / y.
      lx, ly: domain extents.
      fluid: bool (ny+2, nx+2); True on interior fluid cells. Ghost ring is
        always False. For mask-free cases every interior cell is fluid.
    """

    nx: int
    ny: int
    lx: float
    ly: float
    fluid: np.ndarray

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #

    @staticmethod
    def regular(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0) -> "Grid":
        """All-fluid rectangular grid (cavity / channel cases)."""
        if nx <= 0 or ny <= 0:
            raise ValueError("Grid dimensions must be positive")
        fluid = np.zeros((ny + 2, nx + 2), dtype=bool)
        fluid[1 : ny + 1, 1 : nx + 1] = True
        return Grid(nx=nx, ny=ny, lx=float(lx), ly=float(ly), fluid=fluid)

    @staticmethod
    def masked(nx: int, ny: int, lx: float, ly: float, fluid_interior: np.ndarray) -> "Grid":
        """Grid with an arbitrary rasterized solid region.

        Args:
          fluid_interior: bool (ny, nx), True where the cell is fluid.
            General mechanism for internal geometry (the reference hardcodes
            a step raster, backwards_step-01.cpp:492-532).
        """
        if fluid_interior.shape != (ny, nx):
            raise ValueError(f"fluid_interior must be ({ny}, {nx}), got {fluid_interior.shape}")
        fluid = np.zeros((ny + 2, nx + 2), dtype=bool)
        fluid[1 : ny + 1, 1 : nx + 1] = fluid_interior
        return Grid(nx=nx, ny=ny, lx=float(lx), ly=float(ly), fluid=fluid)

    # ------------------------------------------------------------------ #
    # basic geometry
    # ------------------------------------------------------------------ #

    @property
    def dx(self) -> float:
        return self.lx / self.nx

    @property
    def dy(self) -> float:
        return self.ly / self.ny

    @property
    def shape(self) -> tuple[int, int]:
        """Padded array shape shared by every field."""
        return (self.ny + 2, self.nx + 2)

    @property
    def n_fluid(self) -> int:
        """Fluid-cell count (reference prints this, backwards_step-01.cpp:523-531)."""
        return int(self.fluid.sum())

    @property
    def has_solids(self) -> bool:
        return self.n_fluid != self.nx * self.ny

    # ------------------------------------------------------------------ #
    # masks (numpy bool, shape (ny+2, nx+2)); converted to jnp by consumers
    # ------------------------------------------------------------------ #

    @cached_property
    def cell_mask(self) -> np.ndarray:
        """Interior fluid cells — where p/b/diagnostics live."""
        return self.fluid.copy()

    @cached_property
    def u_range_mask(self) -> np.ndarray:
        """Predictor/corrector loop extent for u-faces: j in [1, ny],
        i in [1, nx-1] (cavity-01.cpp:553-554)."""
        m = np.zeros(self.shape, dtype=bool)
        m[1 : self.ny + 1, 1 : self.nx] = True
        return m

    @cached_property
    def v_range_mask(self) -> np.ndarray:
        """Loop extent for v-faces: j in [1, ny-1], i in [1, nx]
        (cavity-01.cpp:579-580)."""
        m = np.zeros(self.shape, dtype=bool)
        m[1 : self.ny, 1 : self.nx + 1] = True
        return m

    @cached_property
    def u_valid_mask(self) -> np.ndarray:
        """u-faces where the momentum update applies: loop extent AND the
        face touches at least one fluid cell
        (``is_fluid[j][i] || is_fluid[j][i+1]``, backwards_step-01.cpp:755-757).
        Equals u_range_mask for mask-free grids."""
        f = self.fluid
        touches = f | np.roll(f, -1, axis=1)  # fluid[j,i] | fluid[j,i+1]
        return self.u_range_mask & touches

    @cached_property
    def v_valid_mask(self) -> np.ndarray:
        """v-faces in loop extent touching fluid
        (``is_fluid[j][i] || is_fluid[j+1][i]``, backwards_step-01.cpp:789-791)."""
        f = self.fluid
        touches = f | np.roll(f, -1, axis=0)
        return self.v_range_mask & touches

    @cached_property
    def u_zero_mask(self) -> np.ndarray:
        """u-faces pinned to zero because they sit on a solid-fluid interface.

        Mirrors the reference's solid-cell sweep (backwards_step-01.cpp:655-683):
        for every interior solid cell (j,i):
          * east check  (i < i_max  and fluid[j][i+1]): zero u[j][i]
          * west check  (i > 1      and fluid[j][i-1]): zero u[j][i-1]
        """
        ny, nx = self.ny, self.nx
        f = self.fluid
        solid = ~f
        solid[:1, :] = False
        solid[ny + 1 :, :] = False
        solid[:, :1] = False
        solid[:, nx + 1 :] = False  # interior solid cells only
        m = np.zeros(self.shape, dtype=bool)
        # east: solid at (j,i), i<nx, fluid at (j,i+1) -> face (j,i)
        east = solid & np.roll(f, -1, axis=1)
        east[:, nx:] = False  # i < i_max
        m |= east
        # west: solid at (j,i), i>1, fluid at (j,i-1) -> face (j,i-1)
        west = solid & np.roll(f, 1, axis=1)
        west[:, :2] = False  # i > 1
        m |= np.roll(west, -1, axis=1)  # mark face column i-1
        return m

    @cached_property
    def v_zero_mask(self) -> np.ndarray:
        """v-faces pinned to zero on solid-fluid interfaces
        (backwards_step-01.cpp:667-681, north/south checks)."""
        ny, nx = self.ny, self.nx
        f = self.fluid
        solid = ~f
        solid[:1, :] = False
        solid[ny + 1 :, :] = False
        solid[:, :1] = False
        solid[:, nx + 1 :] = False
        m = np.zeros(self.shape, dtype=bool)
        north = solid & np.roll(f, -1, axis=0)
        north[ny:, :] = False  # j < j_max
        m |= north
        south = solid & np.roll(f, 1, axis=0)
        south[:2, :] = False  # j > 1
        m |= np.roll(south, -1, axis=0)
        return m

    @cached_property
    def solid_interior_mask(self) -> np.ndarray:
        """Interior solid cells (for pressure extrapolation ghosts,
        backwards_step-01.cpp:708-739)."""
        m = ~self.fluid
        m[0, :] = False
        m[-1, :] = False
        m[:, 0] = False
        m[:, -1] = False
        return m

    @cached_property
    def solid_neighbor_weights(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(wE, wW, wN, wS, count) for solid-cell pressure = mean of fluid
        neighbors, with the reference's exact neighbor predicates
        (backwards_step-01.cpp:712-731: west needs i>1, east i<i_max,
        south j>1, north j<j_max)."""
        ny, nx = self.ny, self.nx
        f = self.fluid.astype(np.float64)
        wE = np.roll(f, -1, axis=1)
        wE[:, nx:] = 0.0  # i < i_max
        wW = np.roll(f, 1, axis=1)
        wW[:, :2] = 0.0  # i > 1
        wN = np.roll(f, -1, axis=0)
        wN[ny:, :] = 0.0  # j < j_max
        wS = np.roll(f, 1, axis=0)
        wS[:2, :] = 0.0  # j > 1
        s = self.solid_interior_mask
        wE, wW, wN, wS = (w * s for w in (wE, wW, wN, wS))
        count = wE + wW + wN + wS
        return wE, wW, wN, wS, count


def cfl_time_step(dx: float, dy: float, viscosity: float, velocity_scale: float, cfl: float) -> float:
    """Reference dt rule (cavity-01.cpp:359-360, channel-01.cpp:342-343):
    dt = CFL * min(0.25*h^2/nu, h/U) with h = min(dx, dy).
    Computed in float64 host arithmetic to match the C++ exactly."""
    h = min(dx, dy)
    return cfl * min(0.25 * h * h / viscosity, h / max(1e-12, velocity_scale))


def optimal_omega(nx: int, ny: int | None = None) -> float:
    """Optimal SOR relaxation for the 5-point Laplacian.

    Square variant, ny=None (cavity-01.cpp:74-78): rho_J = cos(pi/(N+1)).
    Anisotropic variant (channel-01.cpp:76-81; backwards_step-01.cpp:77-82):
    rho_J = (cos(pi/(nx+1)) + cos(pi/(ny+1))) / 2.
    """
    if ny is None:
        rho = np.cos(np.pi / (nx + 1))
    else:
        rho = 0.5 * (np.cos(np.pi / (nx + 1)) + np.cos(np.pi / (ny + 1)))
    return float(2.0 / (1.0 + np.sqrt(1.0 - rho * rho)))
