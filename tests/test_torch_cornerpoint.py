"""The port's corner-point grids (grid/cornerpoint.py, the host builder
csrc/cornerpoint.cpp, grid/grid.py) against the JAX package's.

- The geometry checks of tests/test_cornerpoint.py in port form: a regular
  box reproduces the cartesian grid, and a thrown column connects by
  interval overlap with clipped face areas.
- The port's native connection builder against its Python twin on
  conforming and stair-step-faulted grids (tests/test_native_cornerpoint.py
  in port form): the same connection set, |area| and face centroids to
  1e-9 (the two paths orient the quads oppositely and sum in other
  orders).
- build_grid field by field against the reference on data/SPE9.DATA
  (conforming, so it reorders to the structured stencil) and on the toy
  Norne-like deck (norne_like_deck(nx=12, ny=24, nz=22): two stair-step
  faults, ACTNUM holes), with OPM_TPU_EMBED unset and set to 0: integer
  fields equal, float fields to 1e-12 relative."""

import os

import numpy as np
import pytest

from opm_tpu.grid import build_grid as ref_build_grid
from opm_tpu.io.eclstate import load_case as ref_load_case
from opm_tpu.io.eclstate import load_case_string as ref_load_case_string
from opm_tpu.sim.testcases import norne_like_deck as ref_norne_like_deck
from opm_tpu_torch.grid import cornerpoint as cp
from opm_tpu_torch.grid.grid import build_grid
from opm_tpu_torch.io.eclstate import load_case, load_case_string
from opm_tpu_torch.sim.testcases import norne_like_deck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE9 = os.path.join(ROOT, "data", "SPE9.DATA")
TOY = dict(nx=12, ny=24, nz=22, tsteps="1 2 5")
FIELDS_INT = ["face_cells", "face_dir", "active_mask", "global_cell",
              "cart_to_active", "satnum", "pvtnum", "eqlnum", "fipnum"]
FIELDS_F64 = ["trans", "pore_volume", "depth", "dx", "dy", "dz", "volume",
              "poro", "ntg", "permx", "permy", "permz"]


def _box_coord_zcorn(nx, ny, nz, dx, dy, dz, top=1000.0):
    coord = []
    for j in range(ny + 1):
        for i in range(nx + 1):
            x, y = i * dx, j * dy
            coord += [x, y, top, x, y, top + nz * dz]
    zcorn = np.zeros((nz, 2, ny, 2, nx, 2))
    for k in range(nz):
        zcorn[k, 0] = top + k * dz
        zcorn[k, 1] = top + (k + 1) * dz
    return np.asarray(coord), zcorn.reshape(-1)


def _faulted(nx, ny, nz, fault):
    coord = np.zeros((ny + 1, nx + 1, 6))
    X, Y = np.meshgrid(np.arange(nx + 1) * 100.0, np.arange(ny + 1) * 100.0)
    coord[:, :, 0] = X
    coord[:, :, 1] = Y
    coord[:, :, 2] = 1000.0
    coord[:, :, 3] = X
    coord[:, :, 4] = Y
    coord[:, :, 5] = 4000.0
    zc = np.zeros((nz, 2, ny, 2, nx, 2))
    for k in range(nz):
        zc[k, 0] = 1000 + k * 10.0
        zc[k, 1] = 1000 + (k + 1) * 10.0
    if fault:
        # 1.5-layer throw for the right half: stair-step fault faces
        zc[:, :, :, :, nx // 2:, :] += 15.0
    return coord.ravel(), zc.reshape(-1)


def test_regular_box_geometry():
    nx, ny, nz = 3, 2, 2
    coord, zcorn = _box_coord_zcorn(nx, ny, nz, 100.0, 50.0, 10.0)
    geom = cp.process_corner_point((nx, ny, nz), coord, zcorn)
    assert np.allclose(geom["volume"], 100 * 50 * 10)
    cent = geom["centroid"].reshape(nz, ny, nx, 3)
    assert np.allclose(cent[0, 0, 0], [50, 25, 1005])
    assert np.allclose(cent[1, 1, 2], [250, 75, 1015])
    n_expected = (nx - 1) * ny * nz + nx * (ny - 1) * nz + nx * ny * (nz - 1)
    assert len(geom["conn_arrays"][0]) == n_expected


def test_cornerpoint_matches_cartesian_trans():
    """The same box as COORD/ZCORN and as DX/DY/DZ/TOPS: equal volumes,
    depths and transmissibilities."""
    nx, ny, nz = 4, 3, 2
    coord, zcorn = _box_coord_zcorn(nx, ny, nz, 100.0, 100.0, 10.0)
    n = nx * ny * nz

    def deck(grid_keywords):
        return load_case_string(f"""
RUNSPEC
DIMENS
 {nx} {ny} {nz} /
METRIC
GRID
{grid_keywords}
PORO
 {n}*0.25 /
PERMX
 {n}*100 /
""")

    cp_kw = ("COORD\n " + " ".join(f"{v:.6g}" for v in coord) + " /\n"
             + "ZCORN\n " + " ".join(f"{v:.6g}" for v in zcorn) + " /\n")
    cart_kw = (f"DX\n {n}*100 /\nDY\n {n}*100 /\nDZ\n {n}*10 /\n"
               f"TOPS\n {nx * ny}*1000 /\n")
    g_cp = build_grid(deck(cp_kw))
    g_ca = build_grid(deck(cart_kw))
    assert g_cp.nc == g_ca.nc and g_cp.structured and g_ca.structured
    assert np.allclose(g_cp.volume, g_ca.volume)
    assert np.allclose(g_cp.trans, g_ca.trans, rtol=1e-9)
    assert np.allclose(g_cp.depth, g_ca.depth)


@pytest.mark.parametrize("native", [True, False])
def test_fault_overlap_connections(native):
    """One column thrown down by half a cell: three stair-step connections,
    each with the clipped face area."""
    nx, ny, nz = 2, 1, 2
    dy = 100.0
    coord, zcorn = _box_coord_zcorn(nx, ny, nz, 100.0, dy, 10.0)
    zc = zcorn.reshape(nz, 2, ny, 2, nx, 2)
    zc[:, :, :, :, 1, :] += 5.0
    geom = cp.process_corner_point((nx, ny, nz), coord, zc.reshape(-1),
                                   native=native)
    _, _, area, _, dr = geom["conn_arrays"]
    a = np.linalg.norm(area[dr == 0], axis=1)
    assert len(a) == 3
    np.testing.assert_allclose(a, 5.0 * dy, rtol=1e-9)


@pytest.mark.parametrize("fault", [False, True], ids=["conforming",
                                                      "faulted"])
def test_native_matches_python_twin(fault):
    dims = (12, 10, 8)
    coordv, zcornv = _faulted(*dims, fault)
    nat = cp.process_corner_point(dims, coordv, zcornv)
    twin = cp.process_corner_point(dims, coordv, zcornv, native=False)
    for k in ("volume", "centroid", "extent"):
        np.testing.assert_array_equal(nat[k], twin[k])

    def canon(arrays):
        g1, g2, area, fc, dr = arrays
        return {(int(a), int(b), int(d)): (np.abs(ar), f)
                for a, b, ar, f, d in zip(g1, g2, area, fc, dr)}

    cn, ct = canon(nat["conn_arrays"]), canon(twin["conn_arrays"])
    assert len(cn) == len(nat["conn_arrays"][0])
    assert set(cn) == set(ct)
    if fault:
        nxy = dims[0] * dims[1]
        assert any(g1 // nxy != g2 // nxy for (g1, g2, d) in cn if d == 0)
    for k in cn:
        np.testing.assert_allclose(cn[k][0], ct[k][0], atol=1e-9)
        np.testing.assert_allclose(cn[k][1], ct[k][1], atol=1e-9)


@pytest.fixture(scope="module")
def toy_decks():
    deck = norne_like_deck(**TOY)
    assert deck == ref_norne_like_deck(**TOY)
    return load_case_string(deck), ref_load_case_string(deck)


@pytest.fixture(scope="module")
def spe9_cases():
    return load_case(SPE9), ref_load_case(SPE9)


def _build_both(cases, knob):
    old = os.environ.pop("OPM_TPU_EMBED", None)
    if knob is not None:
        os.environ["OPM_TPU_EMBED"] = knob
    try:
        return build_grid(cases[0]), ref_build_grid(cases[1])
    finally:
        os.environ.pop("OPM_TPU_EMBED", None)
        if old is not None:
            os.environ["OPM_TPU_EMBED"] = old


def _assert_grid_equal(g, r):
    assert tuple(g.dims) == tuple(r.dims)
    assert (g.nc, g.nf, g.nf_canonical, g.structured, g.n_real) == \
        (r.nc, r.nf, r.nf_canonical, r.structured, r.n_real)
    for f in FIELDS_INT:
        a, b = getattr(g, f), getattr(r, f)
        if b is None:
            assert a is None, f
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
    for f in FIELDS_F64:
        a, b = np.asarray(getattr(g, f)), np.asarray(getattr(r, f))
        assert a.shape == b.shape and a.dtype == np.float64, f
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=f)


@pytest.mark.parametrize("knob", [None, "0"], ids=["auto", "embed0"])
def test_spe9_grid_matches_reference(spe9_cases, knob):
    g, r = _build_both(spe9_cases, knob)
    _assert_grid_equal(g, r)
    # conforming and fully active: the structured stencil either way
    assert g.structured and g.active_mask is None and g.nc == 9000


@pytest.mark.parametrize("knob", [None, "0"], ids=["embedded", "gather"])
def test_norne_toy_grid_matches_reference(toy_decks, knob):
    g, r = _build_both(toy_decks, knob)
    _assert_grid_equal(g, r)
    if knob is None:
        # the full box, padding cells inert, the fault faces by gather
        assert g.structured and g.nc == 12 * 24 * 22 and g.n_real == 4176
        assert g.nf > g.nf_canonical
        pad = ~g.active_mask
        assert np.all(g.trans[:g.nf_canonical][
            pad[g.face_cells[:g.nf_canonical]].any(axis=1)] == 0.0)
    else:
        assert not g.structured and g.nc == g.n_real == 4176
        assert g.active_mask is None
