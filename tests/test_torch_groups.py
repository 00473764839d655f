"""Group controls of the port (opm_tpu_torch/wells/groups.py, the simulator's
resolution a report step and update_controls' in-Newton reallocation)
against the JAX package on the CPU: tests/test_groups.py's six cases.

- the group ORAT target shared by two GRUP producers: the port's run
  held per report step to the JAX package's run of the same deck
  (data/wellctrl_reference_cpu.json: counts, control codes and each
  well's BHP and rates; the op-by-op run, which the port's CPU path
  follows operation for operation, to 1e-9);
- REIN re-injection, WGRUPCON guide rates with WPIMULT, WLIST lists and
  the nested same-mode cascade: the port's resolve_group_controls, parse
  and well sets against the JAX package's on the same inputs;
- the sibling absorbing a BHP-limited member's share within the Newton
  iterations: the port's run with the test's checks, and its per-Newton
  reallocation (update_controls over the group arrays) against the JAX
  package's on the same inputs."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opm_tpu.io.eclstate import load_case_string as ref_load
from opm_tpu.io.schedule import build_schedule as ref_schedule
from opm_tpu.wells import groups as rgroups
from opm_tpu.wells import standard as rstd
from opm_tpu.wells.wells import build_well_set as ref_build
from opm_tpu_torch.grid.grid import build_grid
from opm_tpu_torch.io.eclstate import load_case_string
from opm_tpu_torch.io.schedule import (GRUP, INJECTOR, PRODUCER,
                                       SURFACE_RATE, GroupConfig, WellConfig,
                                       build_schedule)
from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
from opm_tpu_torch.sim.testcases import GROUPS_DECK, wellctrl_decks
from opm_tpu_torch.wells import groups
from opm_tpu_torch.wells import standard as stdwells
from opm_tpu_torch.wells.wells import CTRL_BHP, CTRL_ORAT, build_well_set

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "data", "wellctrl_reference_cpu.json")) as _f:
    FX = json.load(_f)
DAY = 86400.0
STB = 0.158987294928


def test_group_orat_distribution():
    text, limit = wellctrl_decks()["group_orat"]
    sim = SimulatorFullyImplicitBlackoil(load_case_string(text),
                                         device="cpu")
    ctrl = []
    sim.events.event("report_step_completed").add(
        lambda s, step: ctrl.append(s.control.tolist()))
    state = sim.run(report_step_limit=limit)
    qs = state.qs.numpy()
    prod_o = {n: -qs[i, 1] * DAY / STB for i, n in enumerate(sim.well_names)
              if n.startswith("P")}
    assert sum(prod_o.values()) == pytest.approx(4000, rel=1e-4), prod_o
    assert all(v > 100 for v in prod_o.values()), prod_o
    ref = FX["runs"]["group_orat"]["eager"]["report_steps"]
    assert [list(s[3:5]) for s in sim._step_timing] == \
        [[r["substeps"], r["newtons"]] for r in ref]
    assert ctrl == [r["control"] for r in ref]
    for row, r in zip(sim.summary.rows, ref):
        for k in ("FPR", "FOPR", "FWPR", "FGOR"):
            assert row[k] == pytest.approx(r[k], rel=1e-9)
        for i, n in enumerate(sim.well_names):
            assert row[f"WBHP:{n}"] == pytest.approx(r["WBHP"][i], rel=1e-9)
    assert sim.host_work["groups"][0] == len(ref)


def _both(fn_name, *args, **kw):
    """resolve_group_controls in both packages on the same configs (the
    port's configs and their JAX-package twins)."""
    from opm_tpu.io import schedule as rs

    def twin(obj):
        cls = getattr(rs, type(obj).__name__)
        import dataclasses
        return cls(**{f.name: getattr(obj, f.name)
                      for f in dataclasses.fields(obj)})

    wells, grps, *rest = args
    out = getattr(groups, fn_name)(wells, grps, *rest, **kw)
    ref = getattr(rgroups, fn_name)([twin(w) for w in wells],
                                    {k: twin(g) for k, g in grps.items()},
                                    *rest, **kw)
    for a, b in zip(out, ref):
        for f in ("control", "orat", "wrat", "grat", "lrat",
                  "surf_inj_rate", "resv_inj_rate"):
            x, y = getattr(a, f), getattr(b, f)
            assert x == y or (np.isnan(x) and np.isnan(y)) \
                if isinstance(x, float) else x == y, f
    return {w.name: w for w in out}


def test_group_rein_reinjection():
    wells = [
        WellConfig(name="P1", group="PLAT", type=PRODUCER, control="ORAT"),
        WellConfig(name="P2", group="PLAT", type=PRODUCER, control="ORAT"),
        WellConfig(name="I1", group="PLAT", type=INJECTOR,
                   injector_fluid="GAS", control=GRUP)]
    grps = {"PLAT": GroupConfig(name="PLAT", inj_fluid="GAS",
                                inj_control="REIN", inj_target=0.5)}
    rates = {"P1": np.array([0.0, -0.01, -2.0]),
             "P2": np.array([0.0, -0.02, -4.0]), "I1": np.zeros(3)}
    out = _both("resolve_group_controls", wells, grps, rates)
    assert out["I1"].control == SURFACE_RATE
    assert out["I1"].surf_inj_rate == pytest.approx(0.5 * 6.0)


def test_wgrupcon_guide_rates_and_wpimult():
    deck = GROUPS_DECK.replace("""WCONPROD
 'P1' 'OPEN' 'GRUP' 5* 500 /
 'P2' 'OPEN' 'GRUP' 5* 500 /
/""", """WCONPROD
 'P1' 'OPEN' 'GRUP' 5* 500 /
 'P2' 'OPEN' 'GRUP' 5* 500 /
/
WGRUPCON
 'P1' 'YES' 3.0 'OIL' /
 'P2' 'YES' 1.0 'OIL' /
/
WPIMULT
 'P1' 0.25 /
/""")
    case = load_case_string(deck)
    step = build_schedule(case).report_steps[0]
    wells = {w.name: w for w in step.wells}
    assert wells["P1"].guide_rate == 3.0 and wells["P2"].guide_rate == 1.0
    assert wells["P1"].completions[0].wi_mult == pytest.approx(0.25)
    out = _both("resolve_group_controls", step.wells, step.groups,
                {n: np.zeros(3) for n in wells})
    assert out["P1"].orat == pytest.approx(3 * out["P2"].orat, rel=1e-12)
    ws = build_well_set(step.wells, build_grid(case))
    rstep = ref_schedule(ref_load(deck)).report_steps[0]
    from opm_tpu.grid import build_grid as ref_grid
    rws = ref_build(rstep.wells, ref_grid(ref_load(deck)))
    np.testing.assert_allclose(np.asarray(ws.perf_wi),
                               np.asarray(rws.perf_wi), rtol=1e-14)
    i1, i2 = ws.names.index("P1"), ws.names.index("P2")
    assert ws.perf_wi[i1, 0] == pytest.approx(0.25 * ws.perf_wi[i2, 0],
                                              rel=1e-6)


def test_wlist_named_lists():
    deck = GROUPS_DECK.replace("""WCONPROD
 'P1' 'OPEN' 'GRUP' 5* 500 /
 'P2' 'OPEN' 'GRUP' 5* 500 /
/""", """WLIST
 '*MYPRODS' 'NEW' 'P1' 'P2' /
/
WCONPROD
 '*MYPRODS' 'OPEN' 'ORAT' 1234 4* 500 /
/""")
    wells = {w.name: w for w in build_schedule(
        load_case_string(deck)).report_steps[0].wells}
    for n in ("P1", "P2"):
        assert wells[n].control == "ORAT"
        assert wells[n].orat * DAY / STB == pytest.approx(1234, rel=1e-9)


def test_group_sibling_absorbs_bhp_limited_member():
    """P1 falls to its BHP floor within the step; the device-side group
    arrays redistribute the remaining ORAT target to P2 and the group
    stays on target. Then the reallocation alone, on the same inputs in
    both packages."""
    deck = GROUPS_DECK.replace("PERMX\n 50*200 /", "PERMX\n 4 49*200 /")
    deck = deck.replace(
        "GCONPROD",
        "WGRUPCON\n 'P1' 'YES' 1.0 'OIL' /\n 'P2' 'YES' 1.0 'OIL' /\n/\n"
        "GCONPROD")
    deck = deck.replace("'P1' 'OPEN' 'GRUP' 5* 500 /",
                        "'P1' 'OPEN' 'GRUP' 5* 3000 /")
    sim = SimulatorFullyImplicitBlackoil(load_case_string(deck),
                                         device="cpu")
    state = sim.run(report_step_limit=1)
    qs = state.qs.numpy()
    i1, i2 = sim.well_names.index("P1"), sim.well_names.index("P2")
    p1, p2 = -qs[i1, 1] * DAY / STB, -qs[i2, 1] * DAY / STB
    assert int(state.control[i1]) == CTRL_BHP
    assert p1 < 1800
    assert p1 + p2 == pytest.approx(4000, rel=2.5e-2), (p1, p2)
    assert p2 > 2200
    # the reallocation: P1 at its BHP limit making 0.002, P2 on ORAT
    collect = [dict(kind="prod", ctl="ORAT", total=0.01,
                    members=["P1", "P2"], guides=[1.0, 1.0], static=True)]
    names = ["P1", "P2", "I1"]
    specs = groups.make_group_device_arrays(collect, names, "cpu")
    rspecs = rgroups.make_group_device_arrays(collect, names)
    base = dict(is_injector=np.array([False, False, True]),
                primary_control=np.array([CTRL_ORAT, CTRL_ORAT, 7],
                                         dtype=np.int32),
                primary_target=np.array([0.005, 0.005, 1.0]),
                bhp_limit=np.array([2e7, 1e6, 6e8]),
                comp_frac=np.array([[0, 1, 0], [0, 1, 0], [0, 0, 1.0]]),
                open=np.ones(3), rate_targets=np.full((3, 5), np.nan),
                thp_limit=np.full(3, np.nan),
                inj_rate_target=np.full(3, np.nan),
                inj_resv_target=np.full(3, np.nan),
                is_history=np.zeros(3, dtype=bool))
    wp = {k: torch.as_tensor(v) for k, v in base.items()}
    wr = {k: jnp.asarray(v) for k, v in base.items()}
    wp["groups"], wr["groups"] = specs, rspecs
    bhp = np.array([1.5e7, 1.2e7, 3e7])
    qsw = np.array([[0.0, -0.002, 0.0], [0.0, -0.005, 0.0], [0, 0, 1.0]])
    ctl = np.array([CTRL_ORAT, CTRL_ORAT, 7], dtype=np.int32)
    tgt = np.array([0.005, 0.005, 1.0])
    c, t = stdwells.update_controls(wp, torch.as_tensor(bhp),
                                    torch.as_tensor(qsw),
                                    torch.as_tensor(ctl),
                                    torch.as_tensor(tgt))
    cr, tr = rstd.update_controls(wr, jnp.asarray(bhp), jnp.asarray(qsw),
                                  jnp.asarray(ctl), jnp.asarray(tgt))
    np.testing.assert_array_equal(c.numpy(), np.asarray(cr))
    np.testing.assert_allclose(t.numpy(), np.asarray(tr), rtol=1e-15)
    assert int(c[0]) == CTRL_BHP
    assert float(t[1]) == pytest.approx(0.01 - 0.002, rel=1e-12)


def test_nested_group_cascade_same_mode():
    def mk(a1, a2, b1, b2, ga_cap, field_tgt):
        wells = [WellConfig(name=n, group=g, type=PRODUCER, control=GRUP)
                 for n, g in (("A1", "GA"), ("A2", "GA"), ("B1", "GB"),
                              ("B2", "GB"))]
        grps = {"GA": GroupConfig(name="GA", parent="FIELD",
                                  prod_control="ORAT",
                                  prod_targets={"ORAT": ga_cap}),
                "GB": GroupConfig(name="GB", parent="FIELD"),
                "FIELD": GroupConfig(name="FIELD", prod_control="ORAT",
                                     prod_targets={"ORAT": field_tgt})}
        rates = {n: np.array([0.0, -r, 0.0]) for n, r in
                 (("A1", a1), ("A2", a2), ("B1", b1), ("B2", b2))}
        return _both("resolve_group_controls", wells, grps, rates)

    w = mk(1.0, 1.0, 1.0, 1.0, ga_cap=100.0, field_tgt=1000.0)
    assert all(w[n].control == "ORAT" for n in w)
    assert w["A1"].orat + w["A2"].orat == pytest.approx(100.0, rel=1e-12)
    assert w["B1"].orat + w["B2"].orat == pytest.approx(900.0, rel=1e-12)
    w = mk(1.0, 1.0, 1.0, 1.0, ga_cap=800.0, field_tgt=1000.0)
    assert w["A1"].orat + w["A2"].orat == pytest.approx(500.0, rel=1e-12)
    w = mk(3.0, 3.0, 1.0, 1.0, ga_cap=600.0, field_tgt=1000.0)
    assert w["A1"].orat + w["A2"].orat == pytest.approx(600.0, rel=1e-12)
    assert w["B1"].orat + w["B2"].orat == pytest.approx(400.0, rel=1e-12)
