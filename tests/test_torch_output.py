"""The port's output layer (CPU) against the JAX package's:

- the ECL writers (SMSPEC, UNSMRY, UNRST, INIT, EGRID) write byte-identical
  files from the same rows and arrays (INIT and EGRID from each package's
  own grid and case, which are equal), and each package's reader reads
  the other's files;
- ``expand_requests`` and the SUMMARY collector's set-up give the same
  keys, unsupported mnemonics, needs, block cells and region spec;
- a run with FIPNUM regions and BPR requests (tests/test_summary_config.py's
  deck): its summary rows, region and block vectors included, equal the
  JAX package's ``SummaryCollector.record`` on the same states within
  1e-12 relative (the region sums add in another order);
- output on changes no bit of the simulation (states, counts, rows);
- the files a run writes, the UNSMRY against the rows at float32 rounding,
  the UNRST against the state, the PRT's unsupported-mnemonic warning, the
  Matlab and VTK dumps, and the CLI's file set;
- an embedded grid's UNRST, INIT and EGRID cover the real cells only, and
  the UNRST round trip returns them unchanged;
- a failed write fails the run, and the writer thread takes no tensor.
"""

import datetime
import os
import sys

import numpy as np
import pytest
import torch

from opm_tpu.grid import build_grid as ref_build_grid
from opm_tpu.io import eclsum as ref_eclsum
from opm_tpu.io.eclstate import load_case as ref_load_case
from opm_tpu.io.eclstate import load_case_string as ref_load_case_string
from opm_tpu.io.summaryconfig import expand_requests as ref_expand
from opm_tpu.models.state import BlackoilState as RefState
from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil as RefSim
from opm_tpu.sim.blackoil import SummaryCollector as RefCollector
from opm_tpu.tools import compare_ecl as ref_compare
from opm_tpu_torch.grid.grid import build_grid
from opm_tpu_torch.io import eclsum
from opm_tpu_torch.io.eclstate import load_case, load_case_string
from opm_tpu_torch.io.summaryconfig import expand_requests
from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                        SummaryCollector, egrid_geometry)
from opm_tpu_torch.sim.testcases import mini_blackoil_deck, norne_like_case
from opm_tpu_torch.tools import compare_ecl
from opm_tpu_torch.utils.convert import state_to_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_summary_config import DECK as SC_DECK  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE1 = os.path.join(ROOT, "data", "SPE1CASE2.DATA")
PSI = 6894.757293168361
MINI = mini_blackoil_deck(nx=3, ny=3, nz=1, tsteps="3*10")
KINDS = ("SMSPEC", "UNSMRY", "UNRST", "INIT", "EGRID")


# ---------------------------------------------------------------------------
# the writers and readers on the same rows and arrays
def _rows(rng, n=4):
    rows = []
    for t in np.cumsum(rng.uniform(1.0, 30.0, n)):
        r = dict(time=float(t), FPR=rng.uniform(1e7, 3e7),
                 FOPR=rng.uniform(0.0, 0.05), FGOR=rng.uniform(0.0, 300.0))
        r["WBHP:PROD"] = rng.uniform(1e7, 2e7)
        r["WGIR:INJ"] = rng.uniform(0.0, 2.0)
        r["RPR:2"] = rng.uniform(1e7, 3e7)
        r["ROIP:1"] = rng.uniform(1e5, 1e6)
        r["BPR:3,3,2"] = rng.uniform(1e7, 3e7)
        rows.append(r)
    return rows


def _unrst_steps(rng, nc=75, nw=2):
    return [dict(seqnum=k, time_days=10.0 * (k + 1),
                 PRESSURE=rng.uniform(100.0, 300.0, nc),
                 SWAT=rng.uniform(0.0, 1.0, nc),
                 SGAS=rng.uniform(0.0, 0.3, nc),
                 RS=rng.uniform(0.0, 200.0, nc), RV=np.zeros(nc),
                 OPM_XWEL=rng.normal(size=6 * nw),
                 OPM_EXTRA=np.asarray([rng.uniform(1e4, 1e6)]))
            for k in range(3)]


def _write(pkg, kind, base, case_src, rng):
    """Write one file of ``kind`` with package ``pkg`` (the port's or the
    JAX package's eclsum); INIT and EGRID from that package's own case."""
    start = datetime.datetime(2020, 1, 1)
    if kind in ("SMSPEC", "UNSMRY"):
        rows = _rows(rng)
        pkg.write_summary(base, rows, dims=(5, 5, 3), start_date=start,
                          unit_system="FIELD")
        pkg.write_summary(base + "_REQ", rows, dims=(5, 5, 3),
                          start_date=start, unit_system="METRIC",
                          requested=["FPR", "WBHP:PROD", "RPR:2", "ROIP:1",
                                     "BPR:3,3,2", "FOPT"])
    elif kind == "UNRST":
        pkg.write_unrst(base, _unrst_steps(rng), dims=(5, 5, 3),
                        start_date=start)
    else:
        port = pkg is eclsum
        case = (load_case_string if port else ref_load_case_string)(
            case_src)
        if kind == "INIT":
            grid = (build_grid if port else ref_build_grid)(case)
            pkg.write_init(base, grid, unit_system=case.runspec.unit_system,
                           start_date=case.runspec.start_date)
        else:
            pkg.write_egrid(base, case)


@pytest.mark.parametrize("kind", KINDS)
def test_writers_byte_identical(kind, tmp_path):
    for src in (SC_DECK, MINI):
        files = {}
        for name, pkg in (("port", eclsum), ("ref", ref_eclsum)):
            base = str(tmp_path / name)
            _write(pkg, kind, base, src, np.random.default_rng(17))
            files[name] = [open(base + suffix + "." + kind, "rb").read()
                           for suffix in (("", "_REQ")
                                          if kind in ("SMSPEC", "UNSMRY")
                                          else ("",))]
        assert files["port"] == files["ref"]
        assert all(len(b) > 0 for b in files["port"])


@pytest.mark.parametrize("kind", KINDS)
def test_readers_read_each_other(kind, tmp_path):
    for name, pkg in (("port", eclsum), ("ref", ref_eclsum)):
        _write(pkg, kind, str(tmp_path / name), SC_DECK,
               np.random.default_rng(5))
    for writer in ("port", "ref"):
        base = str(tmp_path / writer)
        for mod in (eclsum, ref_eclsum):
            if kind in ("SMSPEC", "UNSMRY"):
                for suffix in ("", "_REQ"):
                    a = mod.read_summary(base + suffix)
                    b = eclsum.read_summary(str(tmp_path / "port") + suffix)
                    assert a.keys() == b.keys()
                    for k in a:
                        assert np.array_equal(a[k], b[k]), k
            elif kind == "UNRST":
                a = mod.read_unrst(base + ".UNRST")
                b = eclsum.read_unrst(str(tmp_path / "port") + ".UNRST")
                assert [s.keys() for s in a] == [s.keys() for s in b]
                for sa, sb in zip(a, b):
                    for k in sa:
                        assert np.array_equal(sa[k], sb[k]), k
            elif kind == "INIT":
                a = mod.read_init(base + ".INIT")
                b = eclsum.read_init(str(tmp_path / "port") + ".INIT")
                assert a.keys() == b.keys()
                for k in a:
                    assert np.array_equal(a[k], b[k]), k
            else:
                a = mod.read_ecl_file(base + ".EGRID")
                b = eclsum.read_ecl_file(str(tmp_path / "port") + ".EGRID")
                assert a == b


# ---------------------------------------------------------------------------
# SUMMARY configuration
_REQUESTS = {
    "families": [("FOPR", []), ("WBHP", []), ("WWCT", [["PROD", "/"]]),
                 ("RPR", []), ("ROIP", [["2", "/"]]),
                 ("BPR", [["1", "1", "1"]]), ("WXYZ", []), ("WOPT", [])],
    "all": [("ALL", [])],
    "unknown": [("WBHP", [["NOSUCH", "/"]]), ("RPR", [["7", "/"]]),
                ("BPR", [["9", "9", "9"]]), ("FXYZ", [])],
}


@pytest.mark.parametrize("name", sorted(_REQUESTS))
def test_expand_requests_matches_reference(name):
    reqs = _REQUESTS[name]
    wells = ["PROD", "INJ"]

    def ijk(i, j, k):
        return 0 if max(i, j, k) < 5 else None

    assert expand_requests(reqs, wells, 2, ijk) == ref_expand(
        reqs, wells, 2, ijk)


@pytest.mark.parametrize("deck", ["summary_config", "spe1"])
def test_collector_setup_matches_reference(deck):
    """The deck's parsed requests and the collector built from them (keys,
    unsupported with the PRT warning's text, needs, block cells, region
    spec with FIPNUM)."""
    if deck == "spe1":
        case, ref_case = load_case(SPE1), ref_load_case(SPE1)
    else:
        case, ref_case = (load_case_string(SC_DECK),
                          ref_load_case_string(SC_DECK))
    assert case.summary_requests == ref_case.summary_requests
    wells = ["PROD", "INJ"]
    c = SummaryCollector(wells, requests=case.summary_requests,
                         grid=build_grid(case))
    r = RefCollector(wells, requests=ref_case.summary_requests,
                     grid=ref_build_grid(ref_case))
    assert c.requested_keys == r.requested_keys
    assert c.unsupported == r.unsupported
    assert c._need == r._need
    assert c.block_spec() == r.block_spec()
    rs, rr = c.region_spec(), r.region_spec()
    assert (rs is None) == (rr is None)
    if rs is not None:
        assert np.array_equal(rs[0], rr[0]) and rs[1] == rr[1]


# ---------------------------------------------------------------------------
# a run with regions and block pressures, output off and on
@pytest.fixture(scope="module")
def sc_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sc_out"))
    runs = {}
    for key, kw in (("off", {}),
                    ("on", dict(write_restart=True, write_vtk=True,
                                write_matlab=True))):
        sim = SimulatorFullyImplicitBlackoil(
            load_case_string(SC_DECK), device="cpu",
            output_dir=out if key == "on" else None)
        states = []
        sim.events.event("report_step_completed").add(
            lambda s, step, _st=states: _st.append((step, state_to_numpy(s))))
        sim.run(**kw)
        runs[key] = (sim, states)
    return runs, out


def test_output_changes_no_bit(sc_runs):
    runs, _ = sc_runs
    (off, s_off), (on, s_on) = runs["off"], runs["on"]
    assert len(s_off) == len(s_on) == 2
    for (_, a), (_, b) in zip(s_off, s_on):
        for name, v in a.items():
            if v is not None:
                assert np.array_equal(v, b[name]), name
    assert [t[3:] for t in off._step_timing] == \
        [t[3:] for t in on._step_timing]
    for f in ("substeps", "failed_substeps", "newton_iterations",
              "linear_iterations"):
        assert getattr(off.report, f) == getattr(on.report, f)
    assert off.summary.rows == on.summary.rows


def test_rows_match_reference_collector(sc_runs):
    """Every vector of the port's rows (the region and block ones
    included) against the JAX package's SummaryCollector.record on the
    same states."""
    runs, _ = sc_runs
    sim, states = runs["on"]
    ref = RefSim(ref_load_case_string(SC_DECK), fused=False)
    for (step, s), row in zip(states, sim.summary.rows):
        rst = RefState(**{k: v for k, v in s.items() if v is not None})
        rrow = ref.summary.record(step.end_time, rst, ref.model)
        assert row.keys() == rrow.keys()
        for k in ("RPR:1", "RPR:2", "ROIP:2", "RWIP:1", "RGIP:2",
                  "BPR:1,1,1", "BPR:3,3,2"):
            assert k in row
        for k, v in row.items():
            assert abs(v - rrow[k]) <= 1e-12 * abs(rrow[k]), k


def test_run_files(sc_runs):
    runs, out = sc_runs
    sim, states = runs["on"]
    base = os.path.join(out, sim._out_base())
    names = set(os.listdir(out))
    expected = {f"{sim._out_base()}.{x}" for x in
                ("PRT", "SMSPEC", "UNSMRY", "UNRST", "INIT", "EGRID")}
    expected |= {"summary.csv", "fip_report.txt", "step_timing.txt",
                 "walltime.txt", "restart_0000.npz", "restart_0001.npz",
                 "step_0000.vtr", "step_0001.vtr", "pressure", "saturation",
                 "rs", "rv", "velocity", "bhp", "wellrates"}
    assert names == expected
    # exactly TIME and the supported requested vectors
    data = eclsum.read_summary(base)
    assert list(data) == ["TIME"] + sim.summary.requested_keys
    assert set(data) == {"TIME", "FOPR", "FGOR", "WBHP:PROD", "WBHP:INJ",
                         "WWCT:PROD", "RPR:1", "RPR:2", "ROIP:2",
                         "BPR:1,1,1", "BPR:3,3,2"}
    for k in sim.summary.requested_keys:
        _, fac = eclsum._unit_for(k.split(":")[0], "METRIC")
        want = np.float32([r[k] * fac for r in sim.summary.rows])
        assert np.array_equal(np.float32(data[k]), want), k
    prt = open(base + ".PRT").read()
    assert "WARNING: SUMMARY mnemonic not supported, ignored: WXYZ" in prt
    assert "SimulatorReport" in prt and "report step" in prt
    # the UNRST against the states (METRIC: bar)
    unrst = eclsum.read_unrst(base + ".UNRST")
    assert [u["seqnum"] for u in unrst] == [0, 1]
    for u, (step, s) in zip(unrst, states):
        assert np.array_equal(u["PRESSURE"], s["pressure"] * 1e-5)
        assert np.array_equal(u["SWAT"], s["sw"])
        assert u["time_days"] == step.end_time / 86400.0
        xwel = u["OPM_XWEL"].reshape(-1, 6)
        assert np.array_equal(xwel[:, 0], s["bhp"])
        assert np.array_equal(xwel[:, 1:4], s["qs"])
    from opm_tpu_torch.io.matlab import read_matlab_file
    p = read_matlab_file(out, "pressure", 1)
    assert np.allclose(p, states[-1][1]["pressure"], rtol=1e-14)
    assert read_matlab_file(out, "velocity", 1).size == 3 * 75
    with open(os.path.join(out, "step_0001.vtr")) as f:
        assert "RectilinearGrid" in f.read(200)
    # compare_ecl on the run's own files: the port's tool and the JAX
    # package's agree
    for mod in (compare_ecl, ref_compare):
        shared, fails = mod.compare_summary(base, base, abs_tol=0.0,
                                            rel_tol=0.0)
        assert len(shared) == 11 and not fails
        n, fails = mod.compare_restart(base + ".UNRST", base + ".UNRST",
                                       abs_tol=0.0, rel_tol=0.0)
        assert n == 14 and not fails
        n, fails = mod.compare_init(base + ".INIT", base + ".INIT",
                                    abs_tol=0.0, rel_tol=0.0)
        assert n > 5 and not fails


def test_compare_ecl_tool(tmp_path):
    """compare_ecl's exit codes and deviations, as the JAX package's."""
    rows = _rows(np.random.default_rng(3))
    a, b = str(tmp_path / "A"), str(tmp_path / "B")
    eclsum.write_summary(a, rows, unit_system="FIELD")
    eclsum.write_summary(b, rows, unit_system="FIELD")
    assert compare_ecl.main([a, b]) == 0
    bad = [dict(r) for r in rows]
    bad[2]["FPR"] *= 1.01
    eclsum.write_summary(b, bad, unit_system="FIELD")
    assert compare_ecl.main([a, b]) == 1
    assert compare_ecl.compare_summary(a, b, abs_tol=2e-2, rel_tol=1e-5) \
        == ref_compare.compare_summary(a, b, abs_tol=2e-2, rel_tol=1e-5)


def test_cli_writes_the_file_set(tmp_path, capsys):
    """python -m opm_tpu_torch.tools.flow DECK --output-dir out
    --write-restart --vtk --matlab on the CPU writes the JAX CLI's file
    set for the same flags."""
    from opm_tpu_torch.tools import flow
    deck = tmp_path / "MINI.DATA"
    deck.write_text(MINI)
    out = tmp_path / "out"
    assert flow.main([str(deck), "--device", "cpu", "--output-dir",
                      str(out), "--report-steps", "1", "--write-restart",
                      "--vtk", "--matlab", "--quiet"]) == 0
    assert '"newton_iterations"' in capsys.readouterr().out
    assert set(os.listdir(out)) == {
        "MINI.PRT", "MINI.SMSPEC", "MINI.UNSMRY", "MINI.UNRST", "MINI.INIT",
        "MINI.EGRID", "summary.csv", "fip_report.txt", "step_timing.txt",
        "walltime.txt", "restart_0000.npz", "step_0000.vtr", "pressure",
        "saturation", "rs", "rv", "velocity", "bhp", "wellrates"}


def test_unrst_roundtrip_from_run(tmp_path):
    """The port form of tests/test_eclsum.py::test_unrst_roundtrip_from_run:
    the last UNRST step's PRESSURE is the final state's, in PSIA."""
    case = load_case_string(MINI)
    sim = SimulatorFullyImplicitBlackoil(case, output_dir=str(tmp_path),
                                         device="cpu")
    state = sim.run(write_restart=True)
    steps = eclsum.read_unrst(str(tmp_path / "MINI.UNRST"))
    assert len(steps) == 3
    assert steps[-1]["time_days"] == 30.0
    assert np.allclose(steps[-1]["PRESSURE"], state.pressure.numpy() / PSI,
                       rtol=1e-12)
    assert np.all(steps[0]["SWAT"] >= 0.0)
    assert "RS" in steps[0]


# ---------------------------------------------------------------------------
def test_embedded_grid_roundtrip(tmp_path):
    """The toy Norne-like deck on its embedded grid, from its initial state
    (no run): the UNRST, INIT and EGRID cover the real active cells only,
    and loading the UNRST returns the real cells unchanged (the padding
    through the donor map)."""
    from types import SimpleNamespace

    from opm_tpu_torch.io.restart import load_restart_unrst
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.utils.threadhandle import ThreadHandle
    case = norne_like_case(nx=12, ny=24, nz=22, tsteps="1 2 5")
    sim = SimulatorFullyImplicitBlackoil(case, device="cpu",
                                         output_dir=str(tmp_path))
    g = sim.grid
    assert g.active_mask is not None and g.n_real < g.nc
    st = initial_state(g, sim.props, case, len(sim.well_names))
    writer = ThreadHandle()
    step = SimpleNamespace(index=0, end_time=86400.0)
    sim._write_step_outputs(st, step, writer, True, False, False)
    writer.close()
    sim._write_run_outputs(st)
    base = str(tmp_path / sim._out_base())
    u = eclsum.read_unrst(base + ".UNRST")[0]
    assert u["PRESSURE"].size == g.n_real
    init = eclsum.read_init(base + ".INIT")
    assert init["INTEHEAD"][11] == g.n_real
    assert init["DEPTH"].size == g.n_real
    porv = init["PORV"]
    assert porv.size == np.prod(g.dims)
    assert np.count_nonzero(porv) == g.n_real
    egrid = {n: v for n, _, v in eclsum.read_ecl_file(base + ".EGRID")}
    assert np.count_nonzero(egrid["ACTNUM"]) == g.n_real
    back, meta = load_restart_unrst(base + ".UNRST", 0, case, sim.model)
    a, b = state_to_numpy(st), state_to_numpy(back)
    rc = g.real_cells
    assert np.all(np.abs(b["pressure"][rc] - a["pressure"][rc])
                  <= np.spacing(a["pressure"][rc]))
    for name in ("sw", "x", "hcstate"):
        assert np.array_equal(b[name][rc], a[name][rc]), name
    # the padding cells read their donor's values (grid.global_cell is the
    # donor map on an embedded grid)
    donor = np.asarray(g.global_cell)
    pad = np.setdiff1d(np.arange(g.nc), rc)
    assert np.array_equal(b["sw"][pad], b["sw"][donor[pad]])
    assert meta["report_step"] == 0


# ---------------------------------------------------------------------------
def test_egrid_written_where_geometry_exists(tmp_path):
    """egrid_geometry says where an EGRID is written: exactly where the JAX
    package's write_egrid succeeds (its driver swallows the failure)."""
    from types import SimpleNamespace
    cases = [(load_case(SPE1), ref_load_case(SPE1)),
             (load_case_string(MINI), ref_load_case_string(MINI))]
    bare = SimpleNamespace(
        grid_arrays={"PORO": np.ones(8)},
        runspec=SimpleNamespace(dims=(2, 2, 2), unit_system="METRIC"))
    cases.append((bare, bare))
    for port, ref in cases:
        try:
            ref_eclsum.write_egrid(str(tmp_path / "R"), ref)
            ok = True
        except Exception:
            ok = False
        assert (egrid_geometry(port) is not None) == ok


def test_failed_write_fails_the_run(tmp_path, monkeypatch):
    from opm_tpu_torch.io import vtk

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(vtk, "write_vtr", broken)
    sim = SimulatorFullyImplicitBlackoil(load_case_string(MINI),
                                         output_dir=str(tmp_path),
                                         device="cpu")
    with pytest.raises(RuntimeError, match="async output failed"):
        sim.run(report_step_limit=1, write_vtk=True)


def test_writer_thread_takes_host_data_only():
    from opm_tpu_torch.utils.threadhandle import ThreadHandle
    w = ThreadHandle()
    with pytest.raises(TypeError):
        w.submit(print, torch.zeros(2))
    with pytest.raises(TypeError):
        w.submit(print, cells=dict(p=torch.zeros(2)))
    hits = []
    w.submit(hits.append, np.zeros(2))
    w.submit(lambda: 1 / 0)
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        w.close()
    assert len(hits) == 1
