import numpy as np
import jax.numpy as jnp
import pytest

import oracle
from cfd_tpu.bc import (
    channel_bc,
    channel_pressure_ghosts,
    lid_cavity_bc,
    put,
    step_bc,
    step_pressure_ghosts,
)
from cfd_tpu.cases.backwards_step import make_backwards_step_case
from cfd_tpu.grid import Grid

RNG = np.random.default_rng(1)


def test_cavity_bc_matches_loops():
    g = Grid.regular(7, 7)
    u = RNG.normal(size=g.shape)
    v = RNG.normal(size=g.shape)
    bu, bv = lid_cavity_bc(g, 1.5)(jnp.asarray(u), jnp.asarray(v))
    ou, ov = oracle.cavity_bc_loops(u, v, g.nx, g.ny, 1.5)
    np.testing.assert_allclose(np.asarray(bu), ou, atol=1e-15)
    np.testing.assert_allclose(np.asarray(bv), ov, atol=1e-15)


def test_channel_bc_matches_loops():
    g = Grid.regular(9, 5, 3.0, 1.0)
    u = RNG.normal(size=g.shape)
    v = RNG.normal(size=g.shape)
    bu, bv = channel_bc(g, 2.0)(jnp.asarray(u), jnp.asarray(v))
    ou, ov = oracle.channel_bc_loops(u, v, g.nx, g.ny, 2.0)
    np.testing.assert_allclose(np.asarray(bu), ou, atol=1e-15)
    np.testing.assert_allclose(np.asarray(bv), ov, atol=1e-15)


def test_step_bc_matches_loops():
    case = make_backwards_step_case(nx=24, ny=12)
    g = case.grid
    inlet_j_max = int(1.0 / g.dy)
    u = RNG.normal(size=g.shape)
    v = RNG.normal(size=g.shape)
    bu, bv = step_bc(g, 1.0, inlet_j_max)(jnp.asarray(u), jnp.asarray(v))
    ou, ov = oracle.step_bc_loops(u, v, g.nx, g.ny, 1.0, inlet_j_max, g.fluid)
    np.testing.assert_allclose(np.asarray(bu), ou, atol=1e-15)
    np.testing.assert_allclose(np.asarray(bv), ov, atol=1e-15)


def test_channel_pressure_ghosts_match_loops():
    g = Grid.regular(9, 5, 3.0, 1.0)
    p = RNG.normal(size=g.shape)
    gp = channel_pressure_ghosts(g)(jnp.asarray(p))
    op = oracle.channel_pressure_ghosts_loops(p.copy(), g.nx, g.ny)
    np.testing.assert_allclose(np.asarray(gp), op, atol=1e-15)


def test_step_pressure_ghosts_match_loops():
    case = make_backwards_step_case(nx=24, ny=12)
    g = case.grid
    p = RNG.normal(size=g.shape)
    gp = step_pressure_ghosts(g)(jnp.asarray(p))
    op = oracle.step_pressure_ghosts_loops(p.copy(), g.nx, g.ny, g.fluid)
    np.testing.assert_allclose(np.asarray(gp), op, atol=1e-15)


@pytest.mark.parametrize("rows,cols", [
    (slice(0, 1), slice(0, 8)),      # bottom ghost row
    (slice(5, 6), slice(0, 9)),      # top ghost row, full width
    (slice(1, 5), slice(0, 1)),      # left ghost column, interior rows
    (slice(0, 6), slice(8, 9)),      # right ghost column
    (slice(2, 4), slice(3, 7)),      # interior block
    (slice(0, 6), slice(0, 9)),      # everything
])
@pytest.mark.parametrize("kind", ["scalar", "shifted"])
def test_put_matches_indexed_set(rows, cols, kind):
    """bc.put, the select the BCs are built of, writes exactly what
    ``a.at[rows, cols].set(value[rows, cols])`` writes."""
    a = RNG.normal(size=(6, 9))
    value = 0.75 if kind == "scalar" else np.roll(a, 1, axis=0)
    got = put(jnp.asarray(a), rows, cols,
              value if kind == "scalar" else jnp.asarray(value))
    want = a.copy()
    want[rows, cols] = value if kind == "scalar" else value[rows, cols]
    np.testing.assert_array_equal(np.asarray(got), want)
