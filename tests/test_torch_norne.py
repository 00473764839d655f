"""The toy Norne-like corner-point deck (norne_like_deck(nx=12, ny=24,
nz=22, tsteps="1 2 5"): two stair-step faults, ACTNUM holes, 6336 box
cells of which 4176 are active) end to end on the port's CPU path, in both
representations, against the JAX package's runs of the same deck
(data/nornelike_toy_reference_cpu.json, written by
tools/make_torch_reference.py --case nornetoy; chip_smoke.py holds the
card's runs to the same fixture and limits):

- embedded (OPM_TPU_EMBED unset): the full box with inert padding cells,
  the structured stencil plus 1408 extra fault faces, structured GMG;
- gather (OPM_TPU_EMBED=0): the active cells and their 11793 faces,
  aggregation AMG.

Per report step: substep and Newton counts equal and no failed substep;
linear iterations within 2% (BiCGStab's count depends on the order of
roundoff); FPR within 1e-4 relative, FOPR, FWPR and FGOR within 1e-3.
The padding cells of the embedded run keep their initial pressure and
water saturation."""

import json
import os

import pytest
import torch

from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
from opm_tpu_torch.sim.init import initial_state
from opm_tpu_torch.sim.testcases import norne_like_case

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "data", "nornelike_toy_reference_cpu.json")
REPS = [("embedded", None), ("gather", "0")]


def _build(kwargs, knob):
    old = os.environ.pop("OPM_TPU_EMBED", None)
    if knob is not None:
        os.environ["OPM_TPU_EMBED"] = knob
    try:
        return SimulatorFullyImplicitBlackoil(norne_like_case(**kwargs),
                                              device="cpu")
    finally:
        os.environ.pop("OPM_TPU_EMBED", None)
        if old is not None:
            os.environ["OPM_TPU_EMBED"] = old


@pytest.fixture(scope="module", params=REPS, ids=[r[0] for r in REPS])
def run(request):
    rep, knob = request.param
    with open(FIXTURE) as f:
        fix = json.load(f)
    sim = _build(fix["deck_kwargs"], knob)
    st0 = initial_state(sim.grid, sim.props, sim.case, len(sim.well_names))
    lin = []
    sim.events.event("report_step_completed").add(
        lambda s, step: lin.append(sim.report.linear_iterations))
    state = sim.run(st0)
    # each signal comes before that step's totals are added
    lin = lin[1:] + [sim.report.linear_iterations]
    lin = [b - a for a, b in zip([0] + lin[:-1], lin)]
    return rep, sim, fix[rep], lin, st0, state


def test_representation(run):
    rep, sim, ref, _, _, _ = run
    assert sim.solver.linear_solver == ref["linear_solver"] == "cpr"
    assert (sim.model.nc, sim.grid.n_real, sim.model.trans.shape[0]) == \
        (ref["nc"], ref["n_real"], ref["nf"])
    gmg = type(sim.solver.amg).__name__
    assert gmg == ("StructuredGmg" if rep == "embedded" else "DeviceAmg")
    assert sim.model.faces is not None and sim.model.faces.n > 0


def test_counts_match_fixture(run):
    _, sim, ref, lin, _, _ = run
    assert len(sim._step_timing) == len(ref["report_steps"])
    assert sim.report.failed_substeps == ref["failed_substeps"] == 0
    for st, r, li in zip(sim._step_timing, ref["report_steps"], lin):
        assert (st[3], st[4]) == (r["substeps"], r["newtons"]), st[0]
        assert abs(li - r["linear"]) <= 0.02 * r["linear"], (st[0], li)


@pytest.mark.parametrize("key,tol", [("FPR", 1e-4), ("FOPR", 1e-3),
                                     ("FWPR", 1e-3), ("FGOR", 1e-3)])
def test_summary_matches_fixture(run, key, tol):
    _, sim, ref, _, _, _ = run
    for row, r in zip(sim.summary.rows, ref["report_steps"]):
        assert abs(row[key] - r[key]) <= tol * abs(r[key]), \
            (row["time"], row[key], r[key])


def test_padding_frozen(run):
    rep, sim, _, _, st0, state = run
    am = sim.grid.active_mask
    if rep == "gather":
        assert am is None
        return
    pad = torch.as_tensor(~am)
    assert int(pad.sum()) == sim.model.nc - sim.grid.n_real > 0
    # the reference's test_embed.py checks and bounds (pressure rtol,
    # sw atol 1e-12); x and hcstate may switch (a water-zone padding cell's
    # dissolved-gas variable is reset by the update's phase switch, as in
    # the reference)
    torch.testing.assert_close(state.pressure[pad], st0.pressure[pad],
                               rtol=1e-12, atol=0.0)
    torch.testing.assert_close(state.sw[pad], st0.sw[pad], rtol=0.0,
                               atol=1e-12)
