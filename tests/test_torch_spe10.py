"""The toy SPE10-like deck end to end on the port's CPU path, through the
CPR Newton route, against the JAX package's run of the same deck
(data/spe10like_toy_reference_cpu.json, written by
tools/make_torch_reference.py; chip_smoke.py holds the card's run to the
same fixture and limits).

Per report step: Newton and substep counts equal and no failed substep;
linear iterations within 2% (BiCGStab's count depends on the order of
roundoff, ROADMAP "What must match"); FPR within 1e-4 relative, FOPR and
FWPR within 1e-3 relative."""

import json
import os

import pytest
import torch

from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
from opm_tpu_torch.sim.testcases import spe10like_case

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "data", "spe10like_toy_reference_cpu.json")


@pytest.fixture(scope="module")
def run():
    with open(FIXTURE) as f:
        ref = json.load(f)
    sim = SimulatorFullyImplicitBlackoil(spe10like_case(**ref["deck_kwargs"]),
                                         device="cpu")
    lin = []
    sim.events.event("report_step_completed").add(
        lambda s, step: lin.append(sim.report.linear_iterations))
    sim.run()
    # each signal comes before that step's totals are added
    lin = lin[1:] + [sim.report.linear_iterations]
    lin = [b - a for a, b in zip([0] + lin[:-1], lin)]
    return sim, ref, lin


def test_cpr_route_and_size(run):
    sim, ref, _ = run
    assert sim.solver.linear_solver == ref["linear_solver"] == "cpr"
    assert sim.model.nc > sim.solver.DENSE_LIMIT
    assert len(sim.solver.amg.levels) >= 3


def test_counts_match_fixture(run):
    sim, ref, lin = run
    assert len(sim._step_timing) == len(ref["report_steps"])
    assert sim.report.failed_substeps == ref["failed_substeps"] == 0
    for st, r, li in zip(sim._step_timing, ref["report_steps"], lin):
        assert (st[3], st[4]) == (r["substeps"], r["newtons"]), st[0]
        assert abs(li - r["linear"]) <= 0.02 * r["linear"], (st[0], li)


@pytest.mark.parametrize("key,tol", [("FPR", 1e-4), ("FOPR", 1e-3),
                                     ("FWPR", 1e-3)])
def test_summary_matches_fixture(run, key, tol):
    sim, ref, _ = run
    for row, r in zip(sim.summary.rows, ref["report_steps"]):
        assert abs(row[key] - r[key]) <= tol * abs(r[key]), \
            (row["time"], row[key], r[key])
