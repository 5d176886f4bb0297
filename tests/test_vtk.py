"""VTK/ParaView output parity vs the golden C++ reference files.

Two tiers: (a) byte-identical t=0 snapshots and .pvd collections — format
parity; (b) numeric field agreement after real simulation steps against the
reference binary's own VTK output — end-to-end solver+writer regression at
a 1e-5 accuracy target.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from cfd_tpu.cases import make_backwards_step_case, make_cavity_case, make_channel_case
from cfd_tpu.io.vtk import exporter_for_case, write_paraview_collection
from cfd_tpu.solver import Simulation

GOLDEN = Path(__file__).resolve().parent.parent / "golden"


def quiet(*a, **k):
    pass


def parse_vtk(path: Path) -> dict[str, np.ndarray]:
    """Parse a legacy-VTK STRUCTURED_POINTS ASCII file into field arrays."""
    lines = path.read_text().splitlines()
    fields: dict[str, np.ndarray] = {}
    n = None
    i = 0
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("POINT_DATA"):
            n = int(ln.split()[1])
        elif ln.startswith("SCALARS"):
            name = ln.split()[1]
            vals = np.array([float(x) for x in lines[i + 2 : i + 2 + n]])
            fields[name] = vals
            i += 1 + n
        elif ln.startswith("VECTORS"):
            name = ln.split()[1]
            rows = [list(map(float, lines[k].split())) for k in range(i + 1, i + 1 + n)]
            fields[name] = np.array(rows)
            i += n
        i += 1
    return fields


CASES = [
    ("cavity", make_cavity_case, "cavity_flow"),
    ("channel", make_channel_case, "channel_flow"),
    ("backwards_step", make_backwards_step_case, "backwards_step"),
]


@pytest.mark.parametrize("name,factory,base", CASES)
def test_t0_snapshot_is_byte_identical_to_reference(tmp_path, name, factory, base):
    case = factory()
    sim = Simulation(case, log=quiet)
    exp = exporter_for_case(case, out_dir=tmp_path)
    exp(sim.initial_state(), 0, 0.0)
    ours = (tmp_path / f"{base}_000000.vtk").read_text()
    golden = (GOLDEN / name / "vtk_output" / f"{base}_000000.vtk").read_text()
    # Compare line-by-line (a plain == on 60k-line strings sends pytest's
    # difflib-based assertion rewriting into quadratic time on mismatch).
    ol, gl = ours.splitlines(), golden.splitlines()
    assert len(ol) == len(gl)
    for i, (a, b) in enumerate(zip(ol, gl)):
        assert a == b, f"first mismatch at line {i}: {a!r} != {b!r}"


def test_pvd_collection_is_byte_identical_to_reference():
    golden = (GOLDEN / "cavity" / "vtk_output" / "cavity_flow_animation.pvd").read_text()
    entries = [
        (float(m.group(1)), m.group(2))
        for m in re.finditer(r'timestep="([\d.]+)" group="" part="0" file="([^"]+)"', golden)
    ]
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "cavity_flow_animation.pvd"
        write_paraview_collection(p, entries)
        assert p.read_text() == golden


@pytest.mark.parametrize(
    "name,factory,base,steps,atol",
    [
        # cavity PPE tol is 1e-9-relative -> iterate-level solver differences
        # are negligible and the 1e-5 accuracy target applies even
        # mid-transient.
        ("cavity", make_cavity_case, "cavity_flow", 100, 2e-5),
        # channel/step PPE tol is only 1e-7-relative (channel-01.cpp:296-297):
        # the reference stops at residual ~1.5e-5 (golden stdout), so two
        # correct solvers' *iterates* legitimately differ by O(1e-4) on
        # velocity during the startup transient. Steady-state agreement at
        # 1e-5 is asserted separately below.
        ("backwards_step", make_backwards_step_case, "backwards_step", 10, 5e-4),
    ],
)
def test_simulated_snapshot_matches_reference_fields(tmp_path, name, factory, base, steps, atol):
    """Run the reference config for `steps` steps and compare every VTK field
    against the reference binary's snapshot. Exercises solver + BCs +
    Poisson + writer end-to-end."""
    case = factory()
    sim = Simulation(case, log=quiet)
    state = sim.initial_state()
    for _ in range(steps):
        state, _ = sim._step(state)
    exp = exporter_for_case(case, out_dir=tmp_path)
    exp(state, steps, steps * case.dt)
    ours = parse_vtk(tmp_path / f"{base}_{steps:06d}.vtk")
    golden = parse_vtk(GOLDEN / name / "vtk_output" / f"{base}_{steps:06d}.vtk")
    assert set(ours) == set(golden)
    for k in golden:
        # vorticity is a finite-difference derivative of the compared
        # velocities: iterate-level noise is amplified by 1/min(dx,dy).
        amp = 1.0 / min(case.grid.dx, case.grid.dy) if k == "vorticity" else 1.0
        np.testing.assert_allclose(ours[k], golden[k], atol=atol * amp, err_msg=k)


@pytest.mark.slow
def test_channel_steady_state_matches_reference_to_1e5(tmp_path):
    """Steady-state field parity at the 1e-5 target: by step 1500
    the channel is stationary (golden avg_KE constant from step 800), so
    Poisson-iterate differences have washed out."""
    case = make_channel_case()
    sim = Simulation(case, log=quiet)
    state = sim.initial_state()
    for _ in range(1500):
        state, _ = sim._step(state)
    exp = exporter_for_case(case, out_dir=tmp_path)
    exp(state, 1500, 1500 * case.dt)
    ours = parse_vtk(tmp_path / "channel_flow_001500.vtk")
    golden = parse_vtk(GOLDEN / "channel" / "vtk_output" / "channel_flow_001500.vtk")
    for k in golden:
        np.testing.assert_allclose(ours[k], golden[k], atol=1e-5, err_msg=k)
