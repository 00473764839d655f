"""K1's EQUIL column march on the CPU: the port's plain twin
(``sim/init.py`` ``equil_columns_plain``, the oracle of the kernel in
``csrc/equil.cu``) and ``equilibrate_region`` against the JAX package's
march, on SPE1 (live oil, RSVD), SPE1 with PBVD in place of RSVD (the
bubble point its RSVD gives through PVTO, ``testcases.spe1_pbvd_deck``),
SPE1CASE2_2P (dead oil, no DISGAS, no gas), the toy SPE10-like deck and
the toy Norne-like deck (capillary pressure in
SWOF and SGOF: both inversions of the cell pass, ``equil_cells_plain``,
the oracle of the cell pass kernel in ``csrc/equil.cu``).

- Eager identity: the reference's march run op by op under
  ``jax.disable_jit()`` (its two masked scans as Python loops) gives the
  three columns, recorded from its ``_integrate_column``, and its
  region outputs; the twin and ``equilibrate_region`` equal them bit for
  bit on the same grid (``equilibrate_region`` is the column march, then
  the cell pass's twin). The reference's eager march takes 50-60 s a
  region on a 200-point grid on a CPU (``tools/equil_jit_eager.py``: its
  lookups are segment-sum masks of some hundreds of primitives, and its
  scans evaluate every step both ways), so this check runs on a depth
  grid of NZ_EAGER points: the same code, anchors and legs as on the
  long grid, fewer steps.
- Against the reference's jitted march (its scans compiled by XLA, whose
  CPU code may fuse products into sums): the columns and the region
  outputs within 1e-13 relative, on a grid of NZ points, on SPE1 here
  and on the other three decks in ``tests/test_torch_equil_jit.py`` (a
  file of its own, for time; the full 2000-point SPE1 state stays held
  by ``tests/test_torch_spe1.py::test_initial_state_identical``). SPE9's
  jitted march departs from its eager one (ROADMAP Queue 3), so SPE9 is
  held to neither here.

- ``equilibrate_region`` reads nothing back from the tensors once its
  columns are marched (the capillary curves' ranges come from the props,
  taken from the deck's tables): with the column march replaced by its
  recorded result, every Tensor method that reads values to the host
  raises.

The grids are cut by setting ``_NZ`` of both modules at run time.
"""

import os

import jax
import numpy as np
import pytest
import torch

import opm_tpu.sim.init as ref_init
from opm_tpu.grid import build_grid as ref_build_grid
from opm_tpu.io.eclstate import load_case_string as ref_load_case_string
from opm_tpu.props.blackoil import BlackoilProps as RefProps
from opm_tpu_torch.grid.grid import build_grid
from opm_tpu_torch.io.eclstate import load_case_string
from opm_tpu_torch.props.blackoil import BlackoilProps
from opm_tpu_torch.sim import init as port_init
from opm_tpu_torch.sim.testcases import (norne_like_deck, spe1_pbvd_deck,
                                         spe10like_deck)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NZ = 200
NZ_EAGER = 8


def _read(name):
    with open(os.path.join(ROOT, "data", name)) as f:
        return f.read()


def _deck(name):
    if name == "spe1":
        return _read("SPE1CASE2.DATA")
    if name == "spe1_pbvd":
        return spe1_pbvd_deck(_read("SPE1CASE2.DATA"))
    if name == "spe1_2p":
        return _read("SPE1CASE2_2P.DATA")
    if name == "norne_toy":
        return norne_like_deck(nx=12, ny=24, nz=22, tsteps="1")
    return spe10like_deck(nx=15, ny=44, nz=4, tsteps="3*1")


DECKS = ("spe1", "spe1_pbvd", "spe1_2p", "spe10_toy", "norne_toy")


def _region(case, grid):
    sol = case.solution
    cells = np.nonzero(np.asarray(grid.eqlnum) == 0)[0]
    return (sol.equil[0], cells, sol.rsvd[0] if sol.rsvd else None,
            sol.pbvd[0] if sol.pbvd else None)


def _reference(text, nz, eager, mp):
    """The reference's three columns (recorded from its _integrate_column),
    its grid and its region outputs on an nz-point grid."""
    case = ref_load_case_string(text)
    grid = ref_build_grid(case)
    props = RefProps.from_case(case)
    rec, cells, rsvd, pbvd = _region(case, grid)
    march = ref_init._integrate_column
    cols = []

    def recorded(z, z0, p0, rho_fn):
        out = march(z, z0, p0, rho_fn)
        cols.append((np.asarray(z), np.asarray(out)))
        return out

    mp.setattr(ref_init, "_NZ", nz)
    mp.setattr(ref_init, "_integrate_column", recorded)
    if eager:
        with jax.disable_jit():
            out = ref_init.equilibrate_region(grid, props, rec, cells,
                                              rsvd=rsvd, pbvd=pbvd)
    else:
        out = ref_init.equilibrate_region(grid, props, rec, cells,
                                          rsvd=rsvd, pbvd=pbvd)
    assert len(cols) == 3
    return dict(z=cols[0][0], cols=np.stack([c for _, c in cols]),
                out=[np.asarray(a) for a in out])


def _port(text, nz, mp):
    """The twin's columns, its grid and equilibrate_region's outputs on an
    nz-point grid (the CPU path)."""
    case = load_case_string(text)
    grid = build_grid(case)
    props = BlackoilProps.from_case(case, "cpu")
    rec, cells, rsvd, pbvd = _region(case, grid)
    mp.setattr(port_init, "_NZ", nz)
    args = port_init.march_args(grid, props, rec, cells, rsvd, pbvd)
    cols = port_init.equil_columns_plain(*args)
    out = port_init.equilibrate_region(grid, props, rec, cells, rsvd=rsvd,
                                       pbvd=pbvd)
    return dict(z=args[1].numpy(), cols=cols.numpy(),
                out=[a.numpy() for a in out])


@pytest.fixture(scope="module")
def runs():
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in DECKS:
            text = _deck(name)
            res[name] = dict(eager=_reference(text, NZ_EAGER, True, mp),
                             port_eager=_port(text, NZ_EAGER, mp))
        res["spe1"].update(jit=_reference(_deck("spe1"), NZ, False, mp),
                           port=_port(_deck("spe1"), NZ, mp))
    return res


def _rel(a, b):
    d = np.abs(a - b)
    return float(np.max(np.where(d == 0, 0.0, d / np.abs(b))))


@pytest.mark.parametrize("deck", DECKS)
def test_twin_columns_equal_reference_eager(runs, deck):
    r, p = runs[deck]["eager"], runs[deck]["port_eager"]
    assert np.array_equal(p["z"], r["z"])
    assert p["cols"].shape == r["cols"].shape == (3, NZ_EAGER)
    assert np.array_equal(p["cols"], r["cols"])


@pytest.mark.parametrize("deck", DECKS)
def test_equilibrate_region_equals_reference_eager(runs, deck):
    r, p = runs[deck]["eager"], runs[deck]["port_eager"]
    for k, (a, b) in enumerate(zip(p["out"], r["out"])):
        assert np.array_equal(a, b), k


def assert_within_1e13_of_jit(r, p, what):
    """The port's columns or region outputs (p) within 1e-13 relative of
    the reference's jitted run (r), on grids a few ulps apart."""
    assert _rel(p["z"], r["z"]) <= 1e-15
    pairs = [(p["cols"], r["cols"])] if what == "cols" else \
        list(zip(p["out"], r["out"]))
    for a, b in pairs:
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-13


@pytest.mark.parametrize("what", ["cols", "out"])
def test_spe1_within_1e13_of_reference_jit(runs, what):
    assert_within_1e13_of_jit(runs["spe1"]["jit"], runs["spe1"]["port"],
                              what)


# the Tensor methods that read values back to the host
_READS = ("item", "tolist", "numpy", "cpu", "__float__", "__int__",
          "__bool__", "__index__")


@pytest.mark.parametrize("deck", ["spe1", "norne_toy"])
def test_equilibrate_region_reads_nothing_back(deck, monkeypatch):
    case = load_case_string(_deck(deck))
    grid = build_grid(case)
    props = BlackoilProps.from_case(case, "cpu")
    sf = props.satfunc
    assert isinstance(sf.pcow_range, float)
    assert isinstance(sf.pcgo_range, float)
    assert (sf.pcow_range > 1e-9) == (deck == "norne_toy")
    rec, cells, rsvd, pbvd = _region(case, grid)
    monkeypatch.setattr(port_init, "_NZ", NZ_EAGER)
    args = port_init.march_args(grid, props, rec, cells, rsvd, pbvd)
    cols = port_init.equil_columns_plain(*args)
    want = port_init.equilibrate_region(grid, props, rec, cells, rsvd=rsvd,
                                        pbvd=pbvd)
    monkeypatch.setattr(port_init, "equil_columns", lambda *a: cols)

    def read(*a, **k):
        raise AssertionError("a host read inside equilibrate_region")

    with monkeypatch.context() as mp:
        for name in _READS:
            mp.setattr(torch.Tensor, name, read)
        got = port_init.equilibrate_region(grid, props, rec, cells,
                                           rsvd=rsvd, pbvd=pbvd)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
