"""Schedule geology modifiers in the port (MULTFLT in SCHEDULE rebuilds the
grid, the model and the solver mid-run) against the JAX package on the
CPU: tests/test_schedule_geo.py's two cases, and the rebuilt model's
transmissibilities equal to the JAX package's after the MULTFLT step.

- the parse of the modifier into its report step's geo_mods;
- MULTFLT 'F1' 1e-6 before the fourth report step: the fault faces'
  transmissibilities scaled, the others unchanged, the run healthy and
  held per report step to the JAX package's run of the deck
  (data/wellctrl_reference_cpu.json, the op-by-op run to 1e-9), the sealed
  side pressurised against an unmodified run; after the step the port's
  model.trans bit for bit the JAX package's after its own
  _apply_geo_modifiers on the same case, and the solver rebuilt with
  it; the caller's case left as it was (a second simulator built from it
  starts from the unmodified transmissibilities)."""

import json
import os

import numpy as np
import pytest
import torch

from opm_tpu.io.eclstate import load_case_string as ref_load
from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil as RefSim
from opm_tpu_torch.io.eclstate import load_case_string
from opm_tpu_torch.io.schedule import build_schedule
from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
from opm_tpu_torch.sim.testcases import _geo_deck, wellctrl_decks

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "data", "wellctrl_reference_cpu.json")) as _f:
    FX = json.load(_f)


def test_schedule_parses_geo_mods():
    sched = build_schedule(load_case_string(
        _geo_deck("MULTFLT\n 'F1' 0.001 /\n/\n")))
    assert len(sched.report_steps) == 6
    assert not sched.report_steps[0].geo_mods
    mods = sched.report_steps[3].geo_mods
    assert mods and mods[0][0] == "MULTFLT"
    assert mods[0][1] == [("F1", 0.001)]
    assert "GEO_MODIFIER" in sched.report_steps[3].events


def test_multflt_mid_run_changes_trans_and_solution():
    text, _ = wellctrl_decks()["multflt"]
    case = load_case_string(text)
    mults0 = dict(case.fault_mults)
    sim = SimulatorFullyImplicitBlackoil(case, device="cpu")
    t_before = sim.model.trans.numpy().copy()
    solver0 = sim.solver
    fc = np.asarray(sim.grid.face_cells)
    fd = np.asarray(sim.grid.face_dir)
    ctrl = []
    sim.events.event("report_step_completed").add(
        lambda s, step: ctrl.append(s.control.tolist()))
    state = sim.run()
    t_after = sim.model.trans.numpy()
    gi = np.asarray(sim.grid.global_cell)[fc[:, 0]] % 4
    on_fault = (fd == 0) & (gi == 1)
    assert on_fault.sum() == 6
    assert np.allclose(t_after[on_fault], 1e-6 * t_before[on_fault],
                       rtol=1e-12)
    assert np.allclose(t_after[~on_fault], t_before[~on_fault])
    assert sim.solver is not solver0 and sim.solver.model is sim.model
    assert case.fault_mults == mults0 and sim.case is not case
    np.testing.assert_array_equal(
        SimulatorFullyImplicitBlackoil(case, device="cpu").model.trans
        .numpy(), t_before)
    assert sim.report.failed_substeps == 0
    assert bool(torch.isfinite(state.pressure).all())
    # the rebuilt transmissibilities equal the JAX package's after its
    # own modifier step on the same deck
    ref = RefSim(ref_load(text), fused=False)
    ref._apply_geo_modifiers(ref.schedule.report_steps[3].geo_mods)
    np.testing.assert_array_equal(t_after, np.asarray(ref.model.trans))
    np.testing.assert_array_equal(sim.model.pv.numpy(),
                                  np.asarray(ref.model.pv))
    # per report step against the reference's run
    rows = FX["runs"]["multflt"]["eager"]["report_steps"]
    assert [list(s[3:5]) for s in sim._step_timing] == \
        [[r["substeps"], r["newtons"]] for r in rows]
    assert ctrl == [r["control"] for r in rows]
    for row, r in zip(sim.summary.rows, rows):
        for k in ("FPR", "FOPR", "FWPR", "FGOR"):
            assert row[k] == pytest.approx(r[k], rel=1e-9)
    # the sealed half (injector side) pressurises against an open run
    sim2 = SimulatorFullyImplicitBlackoil(load_case_string(_geo_deck("")),
                                          device="cpu")
    state2 = sim2.run()
    gi_cell = np.asarray(sim.grid.global_cell) % 4
    p_sealed, p_open = state.pressure.numpy(), state2.pressure.numpy()
    assert p_sealed[gi_cell < 2].mean() > p_open[gi_cell < 2].mean()
    assert p_sealed[gi_cell >= 2].mean() < p_open[gi_cell >= 2].mean()

