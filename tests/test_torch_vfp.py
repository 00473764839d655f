"""VFP tables and THP control (opm_tpu_torch/wells/vfp.py): the port (CPU)
against the JAX package on the same inputs.

- the port forms of tests/test_vfp.py's cases (its span-path case waits
  for the port's report-step spans): the multilinear interpolation exact
  on a linear table, bhp_at's value and derivative in the rates, the
  deck parse (every array against the JAX package's parse), the
  injection table, THP back-calculation round trips, and the WTHP of a
  rate-controlled well with a table, run in the port and held to the JAX
  package's run of the same deck (data/wellctrl_reference_cpu.json);
- bhp_at's Jacobian in the rates by torch.func.jacfwd against jax.jacfwd
  on the same table and rates, at 1e-12, with rates on table nodes and
  zero phase rates (the derivative's ties, where jnp.maximum and
  jnp.clip give one half) among them;
- tests/test_well_switching.py's VFP datum correction: a THP-controlled
  well with its table's datum 100 m above its BHP reference depth, and
  at it, both runs held per report step to the fixture (as
  tests/test_torch_wellctrl.py holds the other switching decks)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opm_tpu.io.deck import parse_deck_string as ref_parse
from opm_tpu.utils.units import UnitSystem as RefUnits
from opm_tpu.wells import vfp as rvfp
from opm_tpu_torch.io.deck import parse_deck_string
from opm_tpu_torch.io.eclstate import load_case_string
from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
from opm_tpu_torch.sim.testcases import wellctrl_decks
from opm_tpu_torch.utils.units import UnitSystem
from opm_tpu_torch.wells import vfp
from opm_tpu_torch.wells.wells import CTRL_THP

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "data", "wellctrl_reference_cpu.json")) as _f:
    FX = json.load(_f)
PSI = 6894.757293168361

AXES = dict(flo=[1.0, 10.0, 100.0], thp=[100.0, 200.0], wfr=[0.0, 0.5],
            gfr=[0.0, 2.0], alq=[0.0, 1.0])


def _bhp_grid(curved):
    flo, thp, wfr, gfr, alq = (np.array(AXES[k]) for k in
                               ("flo", "thp", "wfr", "gfr", "alq"))
    b = (thp[:, None, None, None, None] + 2 * flo[None, None, None, None]
         + 10 * wfr[None, :, None, None, None]
         + 20 * gfr[None, None, :, None, None]
         + alq[None, None, None, :, None])
    if curved:
        b = b + 0.01 * flo ** 2 * (1.0 + wfr[None, :, None, None, None])
    return b


def _tables(curved=False, flo_type=vfp.FLO_LIQ, wfr_type=vfp.WFR_WCT,
            gfr_type=vfp.GFR_GOR):
    """The same production table in both packages."""
    b = _bhp_grid(curved)
    kw = dict(table_id=1, datum_depth=0.0, flo_type=flo_type,
              wfr_type=wfr_type, gfr_type=gfr_type)
    port = vfp.VFPProdTable(
        **kw, bhp=torch.as_tensor(b),
        **{k: torch.as_tensor(AXES[k], dtype=torch.float64) for k in AXES})
    ref = rvfp.VFPProdTable(
        **kw, bhp=jnp.asarray(b),
        **{k: jnp.asarray(np.array(AXES[k])) for k in AXES})
    return port, ref


def test_multilinear_exact_on_linear_function():
    port, ref = _tables()
    args = (55.0, 150.0, 0.25, 1.0, 0.5)
    v = float(port.eval(*(torch.tensor(a, dtype=torch.float64)
                          for a in args)))
    assert v == pytest.approx(150 + 2 * 55 + 10 * 0.25 + 20 * 1.0 + 0.5,
                              rel=1e-12)
    assert v == pytest.approx(float(ref.eval(*(jnp.asarray(a)
                                               for a in args))), rel=1e-14)


def test_vfp_differentiable_in_rates():
    port, ref = _tables()
    qs = [-0.25, -0.75, -1.0]
    v = float(port.bhp_at(torch.tensor(qs, dtype=torch.float64), 150.0))
    assert v == pytest.approx(150 + 2 * 1.0 + 10 * 0.25 + 20 * (1.0 / 0.75),
                              rel=1e-9)
    g = torch.func.jacfwd(lambda q: port.bhp_at(q, 150.0))(
        torch.tensor(qs, dtype=torch.float64))
    g_ref = jax.grad(lambda q: ref.bhp_at(q, jnp.asarray(150.0)))(
        jnp.asarray(qs))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-12,
                               atol=0.0)


# (flo, wfr, gfr) types x rates: interior, on table nodes (flo 10, wct
# 0.5), zero water (wct on its first node, the clip's tie), zero gas, all
# zero (every floor and clip at a tie), an injecting phase
RATES = [[-0.25, -0.75, -1.0], [-5.0, -5.0, -2.0], [0.0, -3.0, -3.0],
         [-1.0, -2.0, 0.0], [0.0, 0.0, 0.0], [0.5, -4.0, -1.5],
         [-40.0, -20.0, -90.0]]
TYPES = [(vfp.FLO_LIQ, vfp.WFR_WCT, vfp.GFR_GOR),
         (vfp.FLO_OIL, vfp.WFR_WOR, vfp.GFR_GLR),
         (vfp.FLO_GAS, vfp.WFR_WGR, vfp.GFR_OGR)]


@pytest.mark.parametrize("types", TYPES, ids=["liq", "oil", "gas"])
def test_bhp_at_jacfwd_matches_jax(types):
    """bhp_at's Jacobian in the rates (nw, 3), for a batch of wells at one
    THP, by torch.func.jacfwd against jax.jacfwd: 1e-12 of each row's
    max."""
    port, ref = _tables(curved=True, flo_type=types[0], wfr_type=types[1],
                        gfr_type=types[2])
    q = np.array(RATES)
    thp = np.array([150.0, 100.0, 137.0, 200.0, 160.0, 120.0, 180.0])
    jp = torch.func.jacfwd(lambda x: port.bhp_at(x, torch.as_tensor(thp)))(
        torch.as_tensor(q))
    jr = jax.jacfwd(lambda x: ref.bhp_at(x, jnp.asarray(thp)))(
        jnp.asarray(q))
    jp, jr = jp.numpy(), np.asarray(jr)
    scale = np.maximum(np.abs(jr).max(axis=(1, 2), keepdims=True), 1e-300)
    assert np.abs(jp - jr).max() == 0.0 or \
        float((np.abs(jp - jr) / scale).max()) <= 1e-12
    vp = port.bhp_at(torch.as_tensor(q), torch.as_tensor(thp)).numpy()
    vr = np.asarray(ref.bhp_at(jnp.asarray(q), jnp.asarray(thp)))
    np.testing.assert_allclose(vp, vr, rtol=1e-14)


VFP_DECK = """
SCHEDULE
VFPPROD
 1 7000 'LIQ' 'WCT' 'GOR' 'THP' ' ' 'FIELD' 'BHP' /
 100 1000 /
 200 400 /
 0.0 0.5 /
 0.0 1.0 /
 0.0 /
 1 1 1 1  500  600 /
 1 2 1 1  520  620 /
 2 1 1 1  700  800 /
 2 2 1 1  720  820 /
 1 1 2 1  510  610 /
 1 2 2 1  530  630 /
 2 1 2 1  710  810 /
 2 2 2 1  730  830 /
VFPINJ
 2 7000 'WAT' 'THP' 'FIELD' 'BHP' /
 100 1000 /
 200 400 /
 1 500 600 /
 2 700 800 /
END
"""


def test_vfp_deck_parsing():
    tables = vfp.parse_vfp_tables(parse_deck_string(VFP_DECK),
                                  UnitSystem("FIELD"))
    refs = rvfp.parse_vfp_tables(ref_parse(VFP_DECK), RefUnits("FIELD"))
    assert sorted(tables) == sorted(refs) == [1, 2]
    t = tables[1]
    assert t.bhp.shape == (2, 2, 2, 1, 2)
    assert float(t.thp[0]) == pytest.approx(200 * PSI)
    assert float(t.bhp[0, 0, 0, 0, 0]) == pytest.approx(500 * PSI)
    for k in tables:
        for f in ("flo", "thp", "bhp") + (("wfr", "gfr", "alq")
                                         if k == 1 else ()):
            np.testing.assert_array_equal(getattr(tables[k], f).numpy(),
                                          np.asarray(getattr(refs[k], f)))
        for f in ("datum_depth", "flo_type"):
            assert getattr(tables[k], f) == getattr(refs[k], f)
    args = (550 * 0.158987294928 / 86400, 300 * PSI, 0.25,
            0.5 * 28.316846592 / 0.158987294928, 0.0)
    v = float(t.eval(*(torch.tensor(a, dtype=torch.float64) for a in args)))
    assert 500 * PSI < v < 830 * PSI
    assert v == pytest.approx(float(refs[1].eval(*(jnp.asarray(a)
                                                   for a in args))),
                              rel=1e-14)


def _inj_tables():
    flo = np.array([10.0, 100.0])
    thp = np.array([50.0, 150.0])
    bhp = thp[:, None] + 3 * flo[None, :]
    kw = dict(table_id=2, datum_depth=0.0, flo_type=2)
    return (vfp.VFPInjTable(**kw, flo=torch.as_tensor(flo),
                            thp=torch.as_tensor(thp),
                            bhp=torch.as_tensor(bhp)),
            rvfp.VFPInjTable(**kw, flo=jnp.asarray(flo),
                             thp=jnp.asarray(thp), bhp=jnp.asarray(bhp)))


def test_inj_table():
    port, ref = _inj_tables()
    v = float(port.eval(torch.tensor(55.0, dtype=torch.float64), 100.0))
    assert v == pytest.approx(100 + 3 * 55, rel=1e-12)
    assert v == pytest.approx(float(ref.eval(jnp.asarray(55.0),
                                             jnp.asarray(100.0))), rel=1e-15)


def test_thp_roundtrip_prod_and_inj():
    """thp_at inverts bhp_at (the WTHP back-calculation): tables linear in
    thp round-trip to machine precision, and the port's inversion equals
    the JAX package's."""
    port, ref = _tables()
    qs = [-0.25, -0.75, -1.0]
    for thp_true in (100.0, 137.0, 200.0, 90.0, 250.0):
        bhp = port.bhp_at(torch.tensor(qs, dtype=torch.float64), thp_true)
        back = float(port.thp_at(torch.tensor(qs, dtype=torch.float64),
                                 bhp))
        if 100.0 <= thp_true <= 200.0:
            assert back == pytest.approx(thp_true, abs=1e-6)
        rb = float(ref.thp_at(jnp.asarray(qs), jnp.asarray(float(bhp))))
        assert back == pytest.approx(rb, rel=1e-13)
    iport, iref = _inj_tables()
    qs_inj = [0.0, 0.0, 55.0]
    bhp = iport.bhp_at(torch.tensor(qs_inj, dtype=torch.float64), 120.0)
    back = float(iport.thp_at(torch.tensor(qs_inj, dtype=torch.float64),
                              bhp))
    assert back == pytest.approx(120.0, abs=1e-6)
    assert back == pytest.approx(float(iref.thp_at(
        jnp.asarray(qs_inj), jnp.asarray(float(bhp)))), rel=1e-13)


def test_wthp_reported_for_bhp_rate_controlled_vfp_well():
    """A well with a VFP table that is not on THP control reports WTHP,
    back-computed from the converged BHP and rates: it round-trips through
    the forward lookup, and the run equals the JAX package's run of the
    same deck (the fixture's op-by-op run; the compiled one within the
    parity limits)."""
    text, limit = wellctrl_decks()["wthp"]
    sim = SimulatorFullyImplicitBlackoil(load_case_string(text),
                                         device="cpu")
    state = sim.run(report_step_limit=limit)
    row = sim.summary.rows[-1]
    thp = row["WTHP:PROD"]
    assert thp > 0.0
    tables, slots, dp_corr = sim._vfp_report
    iw = sim.well_names.index("PROD")
    assert slots[iw] >= 0
    tab = tables[slots[iw]]
    bhp_round = float(tab.bhp_at(state.qs[iw], thp)) + dp_corr[iw]
    assert bhp_round == pytest.approx(float(state.bhp[iw]), rel=1e-6)
    ref = FX["runs"]["wthp"]["eager"]["report_steps"]
    assert [list(s[3:5]) for s in sim._step_timing] == \
        [[r["substeps"], r["newtons"]] for r in ref]
    for r, fr in zip(sim.summary.rows, ref):
        for i, n in enumerate(sim.well_names):
            assert r[f"WTHP:{n}"] == pytest.approx(fr["WTHP"][i], rel=1e-9)
            assert r[f"WBHP:{n}"] == pytest.approx(fr["WBHP"][i], rel=1e-9)
        assert r["FOPR"] == pytest.approx(fr["FOPR"], rel=1e-9)


def test_vfp_datum_correction_e2e():
    from test_torch_wellctrl import _hold_to_fixture, _run
    out = {}
    for name in ("vfp_datum_same", "vfp_datum_off"):
        sim, state, ctrl = _run(name)
        _hold_to_fixture(name, sim, ctrl)
        ip = sim.well_names.index("P1")
        assert int(state.control[ip]) == CTRL_THP
        out[name] = float(state.bhp[ip])
    shift = out["vfp_datum_off"] - out["vfp_datum_same"]
    assert 1.0e5 < shift < 1.2e6, shift
