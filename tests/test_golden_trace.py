"""Stats-trace parity vs the reference binaries' stdout (golden/).

The per-interval stats row is the reference's de-facto regression signal
(SURVEY.md section 4.2). Field snapshots can agree while the *trajectory*
diverges later (e.g. a zero-cycle Poisson exit shows up only in the running
trace), so these tests march each case and compare max(div) and
avg_KE against the parsed golden rows at the reference's print intervals,
at the reference's printed precision.
"""

import os
import re
from pathlib import Path

import pytest

from cfd_tpu.cases import make_backwards_step_case, make_cavity_case, make_channel_case
from cfd_tpu.io.checkpoint import CheckpointManager
from cfd_tpu.solver import Simulation

GOLDEN = Path(__file__).resolve().parent.parent / "golden"

# Opt-in full-trajectory parity (the documented full-parity claim, verified
# continuously rather than by one-off manual runs): CFD_TPU_FULL_TRACE=1
# marches every case to its golden log's final row (~20 min total).
FULL_TRACE = os.environ.get("CFD_TPU_FULL_TRACE") == "1"

ROW_RE = re.compile(
    r"Step\s+(\d+)/\d+ \| t=\s*[\d.]+ \| max\(div\)=\s*([\d.e+-]+) "
    r"\| avg_KE=\s*([\d.-]+)")


def golden_rows(name: str) -> dict[int, tuple[float, float]]:
    rows = {}
    for line in (GOLDEN / name / "stdout.log").read_text().splitlines():
        m = ROW_RE.search(line)
        if m:
            rows[int(m.group(1))] = (float(m.group(2)), float(m.group(3)))
    return rows


def _compare_row(sim, st, k, gold):
    s = sim.statistics(st)
    gd, gke = gold[k]
    # golden prints div as %.2e and KE as %.6f
    assert abs(s["max_divergence"] - gd) <= 0.005 * abs(gd) + 1e-12, \
        (k, s["max_divergence"], gd)
    assert abs(s["avg_kinetic_energy"] - gke) <= 5e-6, \
        (k, s["avg_kinetic_energy"], gke)


def march_and_compare(case, name, n_steps=None):
    gold = golden_rows(name)
    if n_steps is None:
        n_steps = max(gold)
    expected = sum(1 for k in gold if k <= n_steps)
    sim = Simulation(case, log=lambda *a: None)
    st = sim.initial_state()
    compared = 0
    for k in range(1, n_steps + 1):
        st, _ = sim._step(st)
        if k in gold:
            _compare_row(sim, st, k, gold)
            compared += 1
    assert compared == expected


def march_window(case, name, seed_step):
    """Tail-window regression: restore the committed seed checkpoint (saved
    by tools/make_trace_seeds.py during a full validated run) and compare
    the remaining golden rows — catches late-trajectory divergence without
    re-marching the prefix (round-1 gap: only run prefixes were in CI)."""
    gold = golden_rows(name)
    ckpt = CheckpointManager(GOLDEN / name, interval=0)
    if not ckpt._path(seed_step).exists():
        pytest.skip(f"seed checkpoint for {name}@{seed_step} not generated yet")
    st, k0 = ckpt.restore(seed_step, case)
    assert k0 == seed_step
    sim = Simulation(case, log=lambda *a: None)
    compared = 0
    for k in range(k0 + 1, max(gold) + 1):
        st, _ = sim._step(st)
        if k in gold:
            _compare_row(sim, st, k, gold)
            compared += 1
    assert compared == sum(1 for k in gold if k > seed_step)


@pytest.mark.slow
def test_cavity_trace_matches_golden():
    march_and_compare(make_cavity_case(), "cavity", 300)


@pytest.mark.slow
def test_channel_trace_matches_golden():
    march_and_compare(make_channel_case(), "channel", 300)


@pytest.mark.slow
@pytest.mark.parametrize("poisson", ["sor", "multigrid"])
def test_backwards_step_trace_matches_golden(poisson):
    """Both the reference-faithful SOR and the masked multigrid trajectory
    reproduce the golden trace (the reference's own early Poisson solves hit
    the 10000-iteration cap without converging; the stats still agree at
    printed precision)."""
    march_and_compare(make_backwards_step_case(poisson=poisson),
                      "backwards_step", 50)


@pytest.mark.slow
def test_cavity_tail_window_matches_golden():
    """Final print intervals (steps 2400-2520) from the seed checkpoint."""
    march_window(make_cavity_case(), "cavity", 2400)


@pytest.mark.slow
def test_channel_tail_window_matches_golden():
    """Final print intervals (steps 1400-1537) from the seed checkpoint."""
    march_window(make_channel_case(), "channel", 1400)


@pytest.mark.slow
def test_backwards_step_tail_window_matches_golden():
    """Final print intervals (steps 3000-3072) from the seed checkpoint
    (requires the completed full golden run)."""
    march_window(make_backwards_step_case(), "backwards_step", 3000)


@pytest.mark.slow
@pytest.mark.skipif(not FULL_TRACE, reason="set CFD_TPU_FULL_TRACE=1")
@pytest.mark.parametrize("name,factory", [
    ("cavity", make_cavity_case),
    ("channel", make_channel_case),
    ("backwards_step", make_backwards_step_case),
])
def test_full_trace_matches_golden(name, factory):
    """The complete documented full-parity claim, opt-in (~20 min total)."""
    march_and_compare(factory(), name)
