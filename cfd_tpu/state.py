"""Flow state pytree.

The reference holds nine mutable ``Field`` members (cavity-01.cpp:336-344);
this design carries only the physical state (u, v, p, and optional
temperature T) through pure step functions — tentative fields, sources and
residuals are internal values of the jitted step, fused away by XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp


class State(NamedTuple):
    """Flow fields on the padded staggered grid (see grid.Grid docstring)."""

    u: jnp.ndarray  # x-velocity on x-faces, shape (ny+2, nx+2)
    v: jnp.ndarray  # y-velocity on y-faces, shape (ny+2, nx+2)
    p: jnp.ndarray  # pressure at cell centers, shape (ny+2, nx+2)
    T: Optional[jnp.ndarray] = None  # temperature (Boussinesq cases only)
    # previous-step pressure, carried only by cases using extrapolated
    # Poisson warm starts (p_guess = 2 p_n - p_{n-1}; same fixed point,
    # fewer cycles to tolerance)
    p_prev: Optional[jnp.ndarray] = None

    @staticmethod
    def zeros(shape: tuple[int, int], dtype=jnp.float32, with_temperature: bool = False) -> "State":
        z = jnp.zeros(shape, dtype=dtype)
        return State(u=z, v=z, p=z, T=z if with_temperature else None)


class StepDiagnostics(NamedTuple):
    """Per-step scalars, mirroring the reference's stats row
    (cavity-01.cpp:769-773; channel adds the PPE residual,
    channel-01.cpp:762-768)."""

    poisson_iters: jnp.ndarray  # int32
    poisson_residual: jnp.ndarray
