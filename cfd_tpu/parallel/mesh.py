"""Device-mesh construction for 2D spatial domain decomposition.

The reference's only distribution story is OpenFOAM documentation (scotch
decomposition + mpirun, README.md:114, 129-131). The equivalent here is a
``jax.sharding.Mesh`` whose axes ("dy", "dx") tile the grid in y and x
(SURVEY.md section 2.3). GPUs of one host reach each other all to all over
NVLink, so the mesh follows the grid, not a network topology: by default
(N, 1), one band of rows per device.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def factor_2d(n: int) -> tuple[int, int]:
    """Near-square factorization (ny_dev, nx_dev) of n devices."""
    best = (1, n)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def make_mesh(n_devices: int | None = None, shape: tuple[int, int] | None = None,
              devices=None) -> Mesh:
    """2D mesh with axes ("dy", "dx") over the default devices (or
    ``devices``); ``shape`` defaults to (N, 1) row bands. Raises when there
    are fewer devices than asked for."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    if shape is None:
        shape = (len(devices), 1)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names=("dy", "dx"))


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for interior-shaped (ny, nx) field arrays."""
    return NamedSharding(mesh, P("dy", "dx"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
