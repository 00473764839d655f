"""The SPE3 gas-condensate slice (wet gas PVTG, VAPOIL, RVVD/PDVD): the port
(CPU, plain kernel versions) against the JAX package on the same inputs.

- WetGasPVT's arrays (SPE3's table, and two regions of unequal size with a
  record that borrows its undersaturated rows) and b, mu and rv_sat on
  seeded (p, rv) points with PVTG's nodes, drv = 0 and both
  extrapolations: 1e-13 relative;
- the cell quantities on a seeded SPE3 state in all three hydrocarbon
  states (GASONLY cells at drv = 0 too), and their jvp tangents against
  jax.jvp: 1e-12 of each field's max;
- models/state.py's rs_rv, saturations and init_hcstate on that state;
- update_state from a seeded increment that switches cells GASOIL <->
  GASONLY: equal hcstate, values 1e-13 relative;
- initial_state on data/SPE3.DATA (RVVD) and on its PDVD variant: equal
  hcstate, p, sw and x 1e-12 relative (the two packages' columns on a
  200-point depth grid, as tests/test_torch_equil_jit.py runs them);
- the first report steps up to the first one with condensate (GASOIL
  cells) in the fixture, run live in both packages from the reference's
  initial state: equal substep and Newton counts, states within the
  reference's own two-path tolerances (tests/test_torch_spe1.py) before
  the condensate appears; at the onset sg within the reference's own
  roundoff spread (the fixture's: its runs with one-ulp state noise);
- the onset itself: each Newton update of that step, from the
  reference's own state, 1e-13 relative; a one-ulp change of sw or sg in
  the reference's own state entering its third Newton update moves that
  update's sg by more than 1e-5 (the step is ill-conditioned: cells with
  so of about 1e-4, where the oil relperm jumps from 0);
- the port's parse of data/SPE3.DATA against the JAX package's load_case;
- the committed fixture (data/spe3_reference_cpu.json, read by
  chip_smoke.py on the GPU machine) against the reference's own run."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opm_tpu.io.eclstate import load_case as ref_load_case
from opm_tpu.models.blackoil import compute_cell_quantities as ref_ccq
from opm_tpu.models.blackoil import make_well_device_arrays as ref_wd
from opm_tpu.models.state import BlackoilState as RefState
from opm_tpu.props.blackoil import BlackoilProps as RefProps
from opm_tpu.props.pvt import WetGasPVT as RefWetGas
from opm_tpu.sim import init as ref_init
from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil as RefSim
from opm_tpu.solver.update import update_state as ref_update
from opm_tpu_torch.io.eclstate import load_case, load_case_string
from opm_tpu_torch.models import blackoil as mb
from opm_tpu_torch.models.blackoil import make_well_device_arrays
from opm_tpu_torch.props.blackoil import BlackoilProps
from opm_tpu_torch.props.pvt import WetGasPVT
from opm_tpu_torch.sim import init as port_init
from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                        report_step_wells)
from opm_tpu_torch.sim.testcases import spe3_pdvd_deck
from opm_tpu_torch.solver.update import update_state
from opm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE3 = os.path.join(ROOT, "data", "SPE3.DATA")
FIXTURE = os.path.join(ROOT, "data", "spe3_reference_cpu.json")
with open(FIXTURE) as _f:
    FX = json.load(_f)
# report steps run live: up to the first with condensate in the fixture
NSTEPS = 1 + next(i for i, r in enumerate(FX["report_steps"])
                  if r["gasoil_cells"] > 0)


def _np_state(s):
    return {f: (None if getattr(s, f) is None else np.asarray(getattr(s, f)))
            for f in s._fields}


def _rel_close(a, b, tol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b)
    assert np.all(err <= tol * np.abs(b)), \
        f"max rel {np.max(err / np.maximum(np.abs(b), 1e-300)):.3e}"


def _scaled_close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def text():
    with open(SPE3) as f:
        return f.read()


@pytest.fixture(scope="module")
def sims():
    """The reference's per-step simulator and the port's on the CPU."""
    return (RefSim(ref_load_case(SPE3), fused=False),
            SimulatorFullyImplicitBlackoil(load_case(SPE3), device="cpu"))


def _two_regions(recs):
    """SPE3's PVTG records as region 1, and a region 2 of three records
    (fewer, so it is padded) whose drv nodes differ and whose middle
    record has no undersaturated rows (it borrows its neighbours')."""
    r2 = []
    for k, (pg, rows) in enumerate(recs[1:4]):
        rows = np.array(rows, dtype=np.float64)
        if k == 1:
            rows = rows[:1]
        else:
            rows[1:, 0] *= 0.5
        r2.append((pg * 1.1, rows))
    return [recs, r2]


@pytest.mark.parametrize("regions", ["spe3", "two regions"])
def test_wet_gas_tables(sims, regions):
    recs = sims[0].case.tables["PVTG"]
    if regions == "two regions":
        recs = _two_regions(recs[0])
    ref = RefWetGas.from_tables(recs)
    port = WetGasPVT.from_tables(recs, "cpu")
    for a, b in ((port.pg_tab, ref.pg_tab), (port.rv_sat_tab, ref.rv_sat_tab),
                 (port.drv_grid, ref.drv_grid),
                 (port.grids[:, 0], ref.inv_b_grid),
                 (port.grids[:, 1], ref.inv_bmu_grid)):
        _rel_close(a.numpy(), b, 1e-13)
    # seeded (p, rv): the records' pressures, both extrapolations, rv at
    # rv_sat (drv = 0), below it, above it (drv clipped to 0) and far below
    # (drv beyond the grid)
    rng = np.random.default_rng(7)
    nreg = len(recs)
    pg = np.asarray(ref.pg_tab).reshape(-1)
    p = np.concatenate([pg, rng.uniform(0.5 * pg.min(), 1.3 * pg.max(),
                                        200)])
    reg = rng.integers(0, nreg, p.shape[0])
    rvs = np.asarray(ref.rv_sat(jnp.asarray(p), jnp.asarray(reg)))
    f = rng.choice([1.0, 0.999, 0.5, 1.05, -2.0], p.shape[0])
    f[:len(pg)] = 1.0
    rv = rvs * f
    _rel_close(port.rv_sat(torch.tensor(p), torch.tensor(reg)).numpy(), rvs,
               1e-13)
    b, mu = port.b_mu(torch.tensor(p), torch.tensor(rv), torch.tensor(reg))
    _rel_close(b.numpy(), ref.b(jnp.asarray(p), jnp.asarray(rv),
                                jnp.asarray(reg)), 1e-13)
    _rel_close(mu.numpy(), ref.mu(jnp.asarray(p), jnp.asarray(rv),
                                  jnp.asarray(reg)), 1e-13)


def test_props_gas_and_rv_sat(sims):
    rp, pp = sims[0].props, sims[1].props
    assert pp.vapoil and not pp.disgas and pp.gas_dead is None
    p = np.linspace(1e6, 3.2e7, 97)
    rv = np.asarray(rp.rv_sat(jnp.asarray(p), 0)) * 0.8
    b, mu = pp.gas_b_mu(torch.tensor(p), torch.tensor(rv), 0)
    _rel_close(b.numpy(), rp.b_gas(jnp.asarray(p), jnp.asarray(rv), 0),
               1e-13)
    _rel_close(mu.numpy(), rp.mu_gas(jnp.asarray(p), jnp.asarray(rv), 0),
               1e-13)
    _rel_close(pp.rv_sat(torch.tensor(p), 0).numpy(),
               rp.rv_sat(jnp.asarray(p), 0), 1e-13)


@pytest.mark.parametrize("kw,item", [
    ("VAPPARS\n 1.5 0.5 /\n", "Queue 1 items 2 and 8"),
    ("ROCKTAB\n 1000 0.99 1.0\n 5000 1.01 1.0 /\n", "Queue 1 items 2 and 8")])
def test_unported_keywords_still_raise(text, kw, item):
    case = load_case_string(text.replace("PROPS\n", "PROPS\n" + kw, 1))
    with pytest.raises(NotImplementedError, match=item):
        BlackoilProps.from_case(case, "cpu")


def _seeded_wet(props, nc, seed):
    """A seeded SPE3 state in every hydrocarbon state; GASONLY cells below
    rv_sat and, every tenth, at it (drv = 0)."""
    rng = np.random.default_rng(seed)
    hc = rng.integers(0, 3, nc).astype(np.int32)
    hc[:3] = [0, 1, 2]
    p = rng.uniform(4e6, 2.6e7, nc)
    sw = rng.uniform(0.16, 0.3, nc)
    rvs = np.asarray(props.rv_sat(jnp.asarray(p), 0))
    rv = np.where(np.arange(nc) % 10 == 2, rvs,
                  rvs * rng.uniform(0.3, 1.0, nc))
    x = np.where(hc == 0, rng.uniform(0.0, 0.8, nc),
                 np.where(hc == 1, rng.uniform(0.0, 50.0, nc), rv))
    return dict(pressure=p, sw=sw, x=x, hcstate=hc)


def test_cell_quantities_and_tangents(sims):
    rm, pm = sims[0].model, sims[1].model
    d = _seeded_wet(rm.props, rm.nc, 3)
    rng = np.random.default_rng(4)
    tan = [rng.standard_normal(rm.nc) * s for s in (1e5, 1e-2, 1e-3)]
    hc = jnp.asarray(d["hcstate"])

    def ref_q(p, sw, x):
        return ref_ccq(rm.props, p, sw, x, hc, rm.pvtnum, rm.satnum)

    qr, tr = jax.jvp(ref_q, tuple(jnp.asarray(d[k]) for k in
                                  ("pressure", "sw", "x")),
                     tuple(jnp.asarray(t) for t in tan))
    t = {k: torch.as_tensor(v) for k, v in d.items()}

    def port_q(p, sw, x):
        return mb.compute_cell_quantities(pm.props, p, sw, x, t["hcstate"],
                                          pm.pvtnum, pm.satnum)

    qp, tp = torch.func.jvp(port_q, (t["pressure"], t["sw"], t["x"]),
                            tuple(torch.as_tensor(a) for a in tan))
    for f in qr._fields:
        _scaled_close(getattr(qp, f).numpy(), getattr(qr, f), 1e-12)
        _scaled_close(getattr(tp, f).numpy(), getattr(tr, f), 1e-12)
    # rv is rv_sat(p) in the GASOIL cells and x in the GASONLY ones
    rvs = np.asarray(rm.props.rv_sat(jnp.asarray(d["pressure"]), 0))
    is_rv = d["hcstate"] == 2
    assert np.array_equal(qp.rv.numpy()[is_rv], d["x"][is_rv])
    _rel_close(qp.rv.numpy()[~is_rv], rvs[~is_rv], 1e-13)


def test_state_helpers_on_gasonly_cells(sims):
    """models/state.py's rs_rv, saturations and init_hcstate under VAPOIL
    (no DISGAS) against the reference's on the seeded state."""
    from opm_tpu.models import state as ref_state
    from opm_tpu_torch.models import state as port_state
    rm, pm = sims[0].model, sims[1].model
    d = _seeded_wet(rm.props, rm.nc, 6)
    nw = 2
    full = dict(d, bhp=np.zeros(nw), qs=np.zeros((nw, 3)),
                control=np.zeros(nw, np.int32), target=np.zeros(nw))
    sr = RefState(**{k: jnp.asarray(v) for k, v in full.items()})
    sp = state_from_numpy(full, "cpu")
    for a, b in zip(port_state.rs_rv(sp, pm.props, pm.pvtnum),
                    ref_state.rs_rv(sr, rm.props, rm.pvtnum)):
        _rel_close(a.numpy(), b, 1e-13)
    sats_p = port_state.saturations(sp)
    sats_r = ref_state.saturations(sr)
    for a, b in zip(sats_p, sats_r):
        assert np.array_equal(a.numpy(), np.asarray(b))
    hp = port_state.init_hcstate(sats_p[0], sats_p[2], disgas=False,
                                 vapoil=True)
    hr = ref_state.init_hcstate(sats_r[0], sats_r[2], disgas=False,
                                vapoil=True)
    assert np.array_equal(hp.numpy(), np.asarray(hr))
    assert set(hp.numpy().tolist()) == {0, 2}


def test_update_switches_both_ways(sims):
    rm, pm = sims[0].model, sims[1].model
    nc, nw = rm.nc, len(sims[0].well_names)
    rng = np.random.default_rng(5)
    p = rng.uniform(1.2e7, 2.4e7, nc)
    hc = np.where(rng.random(nc) < 0.5, 0, 2).astype(np.int32)
    rvs = np.asarray(rm.props.rv_sat(jnp.asarray(p), 0))
    x = np.where(hc == 0, 0.84 - rng.uniform(0.0, 1e-3, nc),
                 np.where(rng.random(nc) < 0.5, rvs, rvs * 0.99))
    d = dict(pressure=p, sw=np.full(nc, 0.16), x=x, hcstate=hc,
             bhp=rng.uniform(1e7, 2e7, nw), qs=rng.standard_normal((nw, 3)),
             control=np.zeros(nw, np.int32), target=np.zeros(nw))
    du = np.concatenate([rng.uniform(-1e6, 2e6, nc), np.zeros(nc),
                         np.where(hc == 0, -rng.uniform(0.0, 2e-3, nc),
                                  rng.standard_normal(nc) * 1e-8),
                         rng.standard_normal(4 * nw)])
    ref_state = RefState(**{k: jnp.asarray(v) for k, v in d.items()})
    sr = _np_state(ref_update(rm, ref_state, jnp.asarray(du)))
    sp = state_to_numpy(update_state(pm, state_from_numpy(
        _np_state(ref_state), "cpu"), torch.as_tensor(du)))
    assert np.array_equal(sp["hcstate"], sr["hcstate"])
    moved = (hc == 0) & (sr["hcstate"] == 2), (hc == 2) & (sr["hcstate"] == 0)
    assert moved[0].sum() > 0 and moved[1].sum() > 0
    for f in ("pressure", "sw", "x", "bhp", "qs"):
        _rel_close(sp[f], sr[f], 1e-13)


@pytest.mark.parametrize("deck", ["rvvd", "pdvd"])
def test_initial_state(text, deck, monkeypatch):
    src = text if deck == "rvvd" else spe3_pdvd_deck(text)
    # the reference's jitted column march and the port's on a 200-point
    # grid (both modules read _NZ at run time)
    monkeypatch.setattr(ref_init, "_NZ", 200)
    monkeypatch.setattr(port_init, "_NZ", 200)
    from opm_tpu.io.eclstate import load_case_string as ref_lcs
    rsim = RefSim(ref_lcs(src), fused=False)
    psim = SimulatorFullyImplicitBlackoil(load_case_string(src),
                                          device="cpu")
    assert (rsim.case.solution.pdvd if deck == "pdvd"
            else rsim.case.solution.rvvd)
    sr = ref_init.initial_state(rsim.grid, rsim.props, rsim.case, 2)
    sp = state_to_numpy(port_init.initial_state(psim.grid, psim.props,
                                                psim.case, 2))
    assert np.array_equal(sp["hcstate"], np.asarray(sr.hcstate))
    assert (sp["hcstate"] == 2).all()
    for f in ("pressure", "sw", "x"):
        _rel_close(sp[f], np.asarray(getattr(sr, f)), 1e-12)
    rvs = np.asarray(rsim.props.rv_sat(sr.pressure, 0))
    if deck == "rvvd":
        assert (sp["x"] > 0).all() and (sp["x"] < rvs).all()
    else:
        # rv_sat at the dew point where it is below the gas pressure
        assert (sp["x"] <= rvs * (1 + 1e-12)).all()
        assert (sp["x"] < rvs * (1 - 1e-6)).any()


@pytest.fixture(scope="module")
def runs(sims):
    """The first NSTEPS report steps in both packages, each from the
    reference's initial state."""
    ref, port = sims
    ends = {"ref": [], "port": []}
    ref.events.event("report_step_completed").add(
        lambda s, step: ends["ref"].append(_np_state(s)))
    port.events.event("report_step_completed").add(
        lambda s, step: ends["port"].append(state_to_numpy(s)))
    s0 = ref_init.initial_state(ref.grid, ref.props, ref.case,
                                len(ref.well_names))
    ends["ref_init"] = s0
    ref.run(s0, report_step_limit=NSTEPS)
    port.run(state_from_numpy(_np_state(s0), "cpu"),
             report_step_limit=NSTEPS)
    return ref, port, ends


def test_first_report_steps_match(runs):
    ref, port, ends = runs
    assert [r[3:] for r in port._step_timing] == \
        [r[3:] for r in ref._step_timing]
    assert port.report.failed_substeps == ref.report.failed_substeps == 0
    assert len(ends["ref"]) == len(ends["port"]) == NSTEPS
    assert (ends["port"][-1]["hcstate"] == 0).any()
    for k, (sr, sp) in enumerate(zip(ends["ref"], ends["port"])):
        assert np.array_equal(sp["hcstate"], sr["hcstate"])
        np.testing.assert_allclose(sp["pressure"], sr["pressure"], rtol=1e-5)
        np.testing.assert_allclose(sp["bhp"], sr["bhp"], rtol=1e-5)
        np.testing.assert_allclose(sp["sw"], sr["sw"], atol=1e-6)
        sg = sr["hcstate"] == 0
        # the two-path tolerance, or at the condensate's onset the
        # reference's own spread (module docstring)
        spread = FX["report_steps"][k]["spread"]["x_gasoil"]
        np.testing.assert_allclose(sp["x"][sg], sr["x"][sg],
                                   atol=max(5e-6, spread))
        np.testing.assert_allclose(sp["x"][~sg], sr["x"][~sg], rtol=1e-5)
        np.testing.assert_allclose(sp["qs"], sr["qs"], rtol=1e-4,
                                   atol=1e-12)
    for rr, rp in zip(ref.summary.rows, port.summary.rows):
        assert abs(rp["FPR"] - rr["FPR"]) <= 1e-4 * rr["FPR"]
        for key in ("FOPR", "FGPR"):
            assert abs(rp[key] - rr[key]) <= 1e-3 * abs(rr[key])


@pytest.fixture(scope="module")
def onset(runs):
    """The condensate's onset (report step NSTEPS - 1, one substep in the
    fixture) Newton by Newton from the reference's state at the end of the
    step before: per update the reference's (its jitted per-step
    functions) and the port's from the same state, and at each update the
    largest change of the reference's sg that a one-ulp change of sw or of
    sg in its own state makes."""
    ref, port, ends = runs
    k = NSTEPS - 1
    assert FX["report_steps"][k]["substeps"] == 1
    step = ref.schedule.report_steps[k]
    ws_r = ref._pad_well_set(ref._well_set_for(step))
    wd_r = ref_wd(ws_r, ref.grid.gravity)
    ws_p = report_step_wells(step, port.grid, port.well_names,
                             port.max_perf)
    wd_p = make_well_device_arrays(ws_p, port.grid.gravity, "cpu")
    rsol, psol = ref.solver, port.solver
    dt = step.end_time - step.start_time
    dtj = jnp.asarray(dt, dtype=jnp.float64)
    s_r = ref._init_well_state(RefState(**{
        f: (None if v is None else jnp.asarray(v))
        for f, v in ends["ref"][k - 1].items()}), ws_r, False)
    s_p = state_from_numpy(_np_state(s_r), "cpu")
    acc0_r, acc0_p = ref.model.accumulation(s_r), port.model.accumulation(
        s_p)
    cdp_r, cdp_p = rsol._cdp_jit(s_r, wd_r), psol._cdp(s_p, wd_p)
    s_r = rsol._welleq_jit(s_r, acc0_r, dtj, wd_r, cdp_r)
    out = []
    for _ in range(FX["report_steps"][k]["newtons"]):
        _, _, ctrl, tgt = rsol._assemble_jit(s_r, acc0_r, dtj, wd_r, cdp_r)
        s_in = s_r._replace(control=ctrl, target=tgt)

        def solve(s):
            return _np_state(rsol._solve_jit(s, acc0_r, dtj, wd_r, cdp_r,
                                             jnp.asarray(1.0))[0])

        sr = solve(s_in)
        sp = state_to_numpy(psol._solve_dense(
            state_from_numpy(_np_state(s_in), "cpu"), acc0_p, dt, wd_p,
            cdp_p, 1.0))
        ulp = max(float(np.abs(solve(s_in._replace(**{f: jnp.nextafter(
            getattr(s_in, f), jnp.inf)}))["x"] - sr["x"]).max())
            for f in ("sw", "x"))
        out.append((sr, sp, ulp))
        s_r = RefState(**{f: (None if v is None else jnp.asarray(v))
                          for f, v in sr.items()})
    return out


def test_onset_updates_from_reference_state(onset):
    for sr, sp, _ in onset:
        assert np.array_equal(sp["hcstate"], sr["hcstate"])
        for f in ("pressure", "sw", "x", "bhp"):
            np.testing.assert_allclose(sp[f], sr[f], rtol=1e-13, atol=0,
                                       err_msg=f)
    # the onset switches every cell GASONLY -> GASOIL in its second update
    assert (onset[0][0]["hcstate"] == 2).all()
    assert (onset[1][0]["hcstate"] == 0).all()


def test_onset_amplifies_one_ulp(onset):
    """A one-ulp change of sw or sg entering the third update moves the
    reference's own sg by more than 1e-5 (measured 1.1e-4); the first two
    updates move it by roundoff only."""
    ulps = [u for _, _, u in onset]
    assert max(ulps[:2]) < 1e-12
    assert ulps[2] > 1e-5


def test_parse_matches_reference():
    rc, pc = ref_load_case(SPE3), load_case(SPE3)
    assert pc.runspec.dims == rc.runspec.dims == (9, 9, 4)
    assert pc.runspec.phases == rc.runspec.phases
    assert pc.runspec.vapoil and not pc.runspec.disgas
    rt, pt = rc.tables["PVTG"], pc.tables["PVTG"]
    assert len(pt) == len(rt) == 1 and len(pt[0]) == len(rt[0]) == 5
    for (pg_p, rows_p), (pg_r, rows_r) in zip(pt[0], rt[0]):
        assert pg_p == pg_r
        assert np.array_equal(rows_p, np.asarray(rows_r))
    assert vars(pc.solution.equil[0]) == vars(rc.solution.equil[0])
    assert np.array_equal(pc.solution.rvvd[0], rc.solution.rvvd[0])


def _digest(state):
    spec = importlib.util.spec_from_file_location(
        "make_torch_reference",
        os.path.join(ROOT, "tools", "make_torch_reference.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.state_digest(state)


def test_reference_fixture_matches_reference(runs):
    ref, _, ends = runs
    assert (FX["total_newtons"], FX["total_substeps"],
            FX["failed_substeps"]) == (75, 40, 0)
    assert len(FX["report_steps"]) == 27
    assert FX["well_names"] == ref.well_names
    assert FX["initial_state"] == _digest(ends["ref_init"])
    for row, step, st, fr in zip(ref.summary.rows, ref._step_timing,
                                 ends["ref"], FX["report_steps"]):
        assert (step[3], step[4], 0) == (fr["substeps"], fr["newtons"],
                                         fr["failed"])
        assert int((st["hcstate"] == 0).sum()) == fr["gasoil_cells"]
        for key in ("FPR", "FOPR", "FGPR"):
            assert abs(row[key] - fr[key]) <= 1e-10 * abs(fr[key])
        assert row["FGIR"] == fr["FGIR"] == 0.0
