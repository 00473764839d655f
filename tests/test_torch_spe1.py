"""The SPE1 slice as a whole: the port (CPU, plain kernel versions) against
the JAX package's per-step path.

- initial_state: identical hcstate, p/sw/x to 1e-13 relative (the EQUIL
  column march and the K1 lookups run the reference's operation order);
- substep 0's Newton updates, each from the reference's own state at the
  start of the iteration: 1e-13 relative (measured 1.9e-15 in pressure,
  2.6e-15 in bhp at the first update, 6.8e-16 at the second), so every
  stage of an update (well solve, residual, Jacobian through K1/K3,
  LU solve, K9) holds to roundoff;
- the node tie that ends bitwise agreement: all 300 cells start
  undersaturated at rs = 226.19666 sm3/sm3 (1.27 Mscf/stb), node 7 of
  the PVTO table. The first update leaves rs within 4 ulps of the node
  in 298 cells, where the two packages' values differ by up to 4 ulps
  (the LU solves' summation order) and lie on opposite sides of the node
  in 99 cells of layers 2 and 3 (1-based). There the lookup takes the other
  segment's one-sided slope (d b_o / d rs differs by 7%), and the next
  update differs by 1.5e-7 relative in pressure (0-based cell 110);
- two report steps: equal Newton and substep counts per report step, and
  states within the tolerances the reference's own tests give one
  trajectory on two execution paths (tests/test_span_production.py:68-71,
  305-308: pressure and bhp rtol 1e-5, sw atol 1e-6, qs rtol 1e-4; sg
  atol 5e-6, measured 1.4e-6 after two report steps). After the node tie
  both runs still converge in the same iterations, but each accepted
  substep carries its last inexact update's difference, so a 1e-8
  relative bound on the trajectory is out of reach (ROADMAP Queue 3);
- the committed reference fixture (data/spe1_reference_cpu.json, read by
  chip_smoke.py on the GPU machine) agrees with the reference's own run."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opm_tpu.io.eclstate import load_case as ref_load_case
from opm_tpu.models.blackoil import make_well_device_arrays as ref_wd
from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil as RefSim
from opm_tpu.sim.blackoil import fluid_in_place as ref_fluid_in_place
from opm_tpu.sim.init import initial_state as ref_initial_state
from opm_tpu_torch.io.eclstate import load_case
from opm_tpu_torch.models.blackoil import make_well_device_arrays
from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                        fluid_in_place, report_step_wells)
from opm_tpu_torch.sim.init import initial_state
from opm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE1 = os.path.join(ROOT, "data", "SPE1CASE2.DATA")
FIXTURE = os.path.join(ROOT, "data", "spe1_reference_cpu.json")
NSTEPS = 2
# PVTO node 7 (1.27 Mscf/stb), where every cell's rs starts
RS_NODE = 226.19666048237468


@pytest.fixture(scope="module")
def runs():
    ref = RefSim(ref_load_case(SPE1), fused=False)
    port = SimulatorFullyImplicitBlackoil(load_case(SPE1), device="cpu")
    ends = {"ref": [], "port": [], "ref_dt": []}
    ref.events.event("timestep_completed").add(
        lambda s, tl, dt: ends["ref_dt"].append(float(dt)))
    ref.events.event("report_step_completed").add(
        lambda s, step: ends["ref"].append(
            {f: np.asarray(getattr(s, f)) for f in
             ("pressure", "sw", "x", "hcstate", "bhp", "qs")}))
    port.events.event("report_step_completed").add(
        lambda s, step: ends["port"].append(state_to_numpy(s)))
    nw = len(ref.well_names)
    ends["ref_init"] = ref_initial_state(ref.grid, ref.props, ref.case, nw)
    ends["port_init"] = initial_state(port.grid, port.props, port.case, nw)
    ends["ref_state"] = ref.run(ends["ref_init"], report_step_limit=NSTEPS)
    ends["port_state"] = port.run(ends["port_init"],
                                  report_step_limit=NSTEPS)
    return ref, port, ends


def _np_state(s):
    return {f: (None if getattr(s, f) is None else np.array(getattr(s, f)))
            for f in s._fields}


@pytest.fixture(scope="module")
def substep0(runs):
    """Substep 0's first two Newton updates: the reference's (its jitted
    per-step functions, as its step() runs them) and the port's, each
    from the reference's state at the start of the iteration."""
    ref, port, ends = runs
    step = ref.schedule.report_steps[0]
    ws_r = ref._pad_well_set(ref._well_set_for(step))
    wd_r = ref_wd(ws_r, ref.grid.gravity)
    ws_p = report_step_wells(step, port.grid, port.well_names,
                             port.max_perf)
    wd_p = make_well_device_arrays(ws_p, port.grid.gravity, "cpu")
    rsol, psol = ref.solver, port.solver
    dt = ends["ref_dt"][0]
    dtj = jnp.asarray(dt, dtype=jnp.float64)
    s_r = ref._init_well_state(ends["ref_init"], ws_r, True)
    s_p = state_from_numpy(_np_state(s_r), "cpu")
    acc0_r, acc0_p = ref.model.accumulation(s_r), port.model.accumulation(s_p)
    cdp_r, cdp_p = rsol._cdp_jit(s_r, wd_r), psol._cdp(s_p, wd_p)
    s_r = rsol._welleq_jit(s_r, acc0_r, dtj, wd_r, cdp_r)
    s_p = psol._solve_welleq(s_p, acc0_p, dt, wd_p, cdp_p)
    out = []
    for _ in range(2):
        _, _, ctrl, tgt = rsol._assemble_jit(s_r, acc0_r, dtj, wd_r, cdp_r)
        s_r, _, _ = rsol._solve_jit(s_r._replace(control=ctrl, target=tgt),
                                    acc0_r, dtj, wd_r, cdp_r,
                                    jnp.asarray(1.0))
        _, _, ctrl, tgt = psol._assemble(s_p, acc0_p, dt, wd_p, cdp_p)
        s_p = psol._solve_dense(s_p._replace(control=ctrl, target=tgt),
                                acc0_p, dt, wd_p, cdp_p, 1.0)
        out.append((_np_state(s_r), state_to_numpy(s_p)))
        s_p = state_from_numpy(out[-1][0], "cpu")
    return out


@pytest.mark.parametrize("it", [0, 1])
def test_newton_update_from_reference_state(substep0, it):
    sr, sp = substep0[it]
    assert np.array_equal(sp["hcstate"], sr["hcstate"])
    for f in ("pressure", "sw", "x", "bhp"):
        np.testing.assert_allclose(sp[f], sr[f], rtol=1e-13, atol=0, err_msg=f)
    assert np.abs(sp["qs"] - sr["qs"]).max() <= 1e-13 * np.abs(sr["qs"]).max()


def test_first_update_ties_at_pvto_node(substep0):
    """After the first update 298 of the 300 cells stay within 4 ulps of
    the PVTO node, the two packages' rs differ there by at most 4 ulps,
    and they sit on opposite sides of the node in 99 cells of layers 2
    and 3 (module docstring)."""
    sr, sp = substep0[0]
    under = sr["hcstate"] == 1
    assert under.all()
    ulp = np.spacing(RS_NODE)
    near = np.abs(sr["x"] - RS_NODE) <= 4 * ulp
    assert near.sum() == 298
    assert np.all(np.abs(sp["x"] - sr["x"])[near] <= 4 * ulp)
    flip = np.nonzero(under & ((sp["x"] >= RS_NODE) != (sr["x"] >= RS_NODE)))
    assert len(flip[0]) == 99
    assert set((flip[0] // 100).tolist()) == {1, 2}


def test_initial_state_identical(runs):
    sr, sp = runs[2]["ref_init"], state_to_numpy(runs[2]["port_init"])
    assert np.array_equal(sp["hcstate"], np.asarray(sr.hcstate))
    for f in ("pressure", "sw", "x"):
        a, b = sp[f], np.asarray(getattr(sr, f))
        assert np.all(np.abs(a - b) <= 1e-13 * np.abs(b)), f


def test_two_report_steps_match(runs):
    ref, port, ends = runs
    assert [r[3:] for r in port._step_timing] == \
        [r[3:] for r in ref._step_timing]
    assert port.report.failed_substeps == ref.report.failed_substeps == 0
    assert len(ends["ref"]) == len(ends["port"]) == NSTEPS
    for sr, sp in zip(ends["ref"], ends["port"]):
        assert np.array_equal(sp["hcstate"], sr["hcstate"])
        np.testing.assert_allclose(sp["pressure"], sr["pressure"], rtol=1e-5)
        np.testing.assert_allclose(sp["bhp"], sr["bhp"], rtol=1e-5)
        np.testing.assert_allclose(sp["sw"], sr["sw"], atol=1e-6)
        sg = sr["hcstate"] == 0
        np.testing.assert_allclose(sp["x"][sg], sr["x"][sg], atol=5e-6)
        np.testing.assert_allclose(sp["x"][~sg], sr["x"][~sg], rtol=1e-5)
        np.testing.assert_allclose(sp["qs"], sr["qs"], rtol=1e-4,
                                   atol=1e-12)


def test_summary_rows_match(runs):
    ref, port, _ = runs
    for rr, rp in zip(ref.summary.rows, port.summary.rows):
        # chip_smoke.py's limits for the whole schedule
        assert abs(rp["FPR"] - rr["FPR"]) <= 1e-4 * rr["FPR"]
        for key in ("FOPR", "FGOR"):
            assert abs(rp[key] - rr[key]) <= 1e-3 * abs(rr[key])


def test_fluid_in_place(runs):
    ref, port, ends = runs
    fr = ref_fluid_in_place(ref.model, ends["ref_state"])
    fp = fluid_in_place(port.model, ends["port_state"])
    # the trajectories' own difference (module docstring) bounds this
    np.testing.assert_allclose(fp, fr, rtol=1e-5)


def test_reference_fixture_matches_reference(runs):
    ref = runs[0]
    with open(FIXTURE) as f:
        fx = json.load(f)
    assert (fx["total_newtons"], fx["total_substeps"],
            fx["failed_substeps"]) == (339, 124, 0)
    assert len(fx["report_steps"]) == 120
    assert fx["well_names"] == ref.well_names
    for row, step, fr in zip(ref.summary.rows, ref._step_timing,
                             fx["report_steps"]):
        assert (step[3], step[4]) == (fr["substeps"], fr["newtons"])
        assert abs(row["FPR"] - fr["FPR"]) <= 1e-10 * fr["FPR"]
