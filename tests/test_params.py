"""Factory parameter validation: the reference's
constructor-time checks (cavity-01.cpp:417-425, backwards_step-01.cpp:455-461)
made systematic — bad scalars fail fast with the offending name."""

import pytest

from cfd_tpu.cases import (
    make_backwards_step_case,
    make_cavity_case,
    make_channel_case,
)
from cfd_tpu.physics.boussinesq import make_rayleigh_benard_case


@pytest.mark.parametrize("kwargs,needle", [
    (dict(reynolds_number=-100.0), "reynolds_number"),
    (dict(final_time=0.0), "final_time"),
    (dict(tolerance_factor=-1e-9), "tolerance_factor"),
    (dict(dt=0.0), "dt"),
    (dict(density=0.0), "density"),
    (dict(max_sor_iterations=0), "max_iterations"),
    (dict(print_interval=-5), "print_interval"),
    (dict(cavity_length=-1.0), "cavity_length"),
])
def test_cavity_rejects_bad_params(kwargs, needle):
    with pytest.raises(ValueError, match=needle):
        make_cavity_case(n_interior=15, **kwargs)


def test_channel_rejects_bad_params():
    with pytest.raises(ValueError, match="reynolds_number"):
        make_channel_case(nx=16, ny=8, reynolds_number=0.0)
    with pytest.raises(ValueError, match="inlet_velocity"):
        make_channel_case(nx=16, ny=8, inlet_velocity=-1.0)


def test_step_rejects_bad_geometry():
    with pytest.raises(ValueError, match="height_inlet"):
        make_backwards_step_case(nx=32, ny=8, height_inlet=3.0,
                                 height_total=2.0)
    with pytest.raises(ValueError, match="step_location"):
        make_backwards_step_case(nx=32, ny=8, step_location=9.0, length=8.0)
    with pytest.raises(ValueError, match="tolerance_factor"):
        make_backwards_step_case(nx=32, ny=8, tolerance_factor=0.0)


def test_rb_rejects_bad_params():
    with pytest.raises(ValueError, match="rayleigh"):
        make_rayleigh_benard_case(nx=16, ny=8, rayleigh=-1e6)
    with pytest.raises(ValueError, match="prandtl"):
        make_rayleigh_benard_case(nx=16, ny=8, prandtl=0.0)


def test_cfl_warning_on_unstable_dt():
    """A user-passed dt past the explicit stability limit warns (the
    blowup-detection failure path then catches the divergence at runtime)."""
    with pytest.warns(UserWarning, match="stability limit"):
        make_cavity_case(n_interior=15, dt=1.0)


def test_cfl_warning_on_cfl_ge_1():
    with pytest.warns(UserWarning, match="stability bound"):
        make_cavity_case(n_interior=15, cfl_number=1.5)


def test_defaults_emit_no_warnings(recwarn):
    make_cavity_case(n_interior=15)
    make_channel_case(nx=16, ny=8)
    assert not [w for w in recwarn if issubclass(w.category, UserWarning)]
