"""The port's aggregation AMG (linalg/amg.py) against the JAX package's on
the toy Norne-like deck's gather grid (norne_like_deck(nx=12, ny=24,
nz=22), OPM_TPU_EMBED=0: 4176 active cells, 11793 faces), both on the CPU
in float64.

The hierarchy is host numpy on both sides and must be identical: every
level's aggregates, coarse entries and merge maps, and the ELL packing.
The value coarsening (K10's twin) is held to 1e-12 relative (summation
order of the segment sums); the refresh's plain version (the kernel's
gathers over the composed maps, into the hierarchy's buffers) to the
per-level composition bit for bit and to the reference as the twin is;
the level operations ell_spmv and
jacobi_sweep to 1e-12 of max, and one whole V-cycle to 1e-6 of max: its
coarsest level is solved by a float32 inverse on both sides (LAPACK's and
XLA's float32 inverses differ in the last bits; the inverse itself is held
to 1e-5 of max), as for the structured GMG in tests/test_torch_cpr.py."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from opm_tpu.linalg import amg as ramg
from opm_tpu_torch.grid.grid import build_grid
from opm_tpu_torch.linalg import amg
from opm_tpu_torch.sim.testcases import norne_like_case

torch.set_num_threads(2)

TOY = dict(nx=12, ny=24, nz=22, tsteps="1 2 5")
TOL_F32_INV = 1e-5
TOL_F32_COARSE = 1e-6


def _gather_grid():
    old = os.environ.get("OPM_TPU_EMBED")
    os.environ["OPM_TPU_EMBED"] = "0"
    try:
        return build_grid(norne_like_case(**TOY))
    finally:
        if old is None:
            del os.environ["OPM_TPU_EMBED"]
        else:
            os.environ["OPM_TPU_EMBED"] = old


def _scaled(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _pressure_values(g, rows0, rng):
    """An M-matrix-like pressure system from ``rng`` (negative couplings,
    dominant diag): (diag0, off0) as tensors."""
    t = np.asarray(g.trans) / np.asarray(g.trans).max()
    off0 = -np.concatenate([t, t]) * (1.0 + 0.1 * rng.random(2 * len(t)))
    diag0 = np.zeros(g.nc)
    np.add.at(diag0, rows0, -off0)
    diag0 += 1e-3 * rng.random(g.nc)
    return torch.as_tensor(diag0), torch.as_tensor(off0)


@pytest.fixture(scope="module")
def setup():
    g = _gather_grid()
    assert not g.structured and g.nc == 4176
    hp = amg.build_hierarchy(g.nc, g.face_cells, g.trans)
    hr = ramg.build_hierarchy(g.nc, np.asarray(g.face_cells),
                              np.asarray(g.trans))
    rng = np.random.default_rng(3)
    diag0, off0 = _pressure_values(g, hp.rows0, rng)
    dev_p = hp.device("cpu")
    dev_r = hr.device()
    vals_p = dev_p.coarsen_values(diag0, off0)
    vals_r = dev_r.coarsen_values(jnp.asarray(diag0.numpy()),
                                  jnp.asarray(off0.numpy()))
    return g, hp, hr, (diag0, off0), dev_p, dev_r, vals_p, vals_r, rng


def test_hierarchy_identical(setup):
    g, hp, hr, *_ = setup
    assert np.array_equal(hp.rows0, hr.rows0)
    assert np.array_equal(hp.cols0, hr.cols0)
    assert hp.coarsest_n == hr.coarsest_n
    assert len(hp.levels) == len(hr.levels) >= 4
    for lp, lr in zip(hp.levels, hr.levels):
        assert (lp.n_fine, lp.n_coarse) == (lr.n_fine, lr.n_coarse)
        for f in ("agg", "off_to_coarse", "off_diag_row", "off_is_diag",
                  "rows_c", "cols_c"):
            assert np.array_equal(getattr(lp, f), getattr(lr, f)), f


def test_pack_ell_identical(setup):
    g, hp, hr, *_ = setup
    pairs = [(hp.nc, hp.rows0, hp.cols0)] + [
        (lv.n_coarse, lv.rows_c, lv.cols_c) for lv in hp.levels]
    widths = []
    for n, rows, cols in pairs:
        cp, sp = amg.pack_ell(n, rows, cols)
        cr, sr = ramg.pack_ell(n, rows, cols)
        assert np.array_equal(cp, cr) and np.array_equal(sp, sr)
        widths.append(cp.shape[0])
    # no assumed ELL width: the fault faces widen level 0 past 7
    assert widths[0] > 7 and max(widths) > widths[0]


def test_coarsen_values(setup):
    *_, dev_p, dev_r, vals_p, vals_r, _ = setup
    nl = dev_p.n_levels
    assert len(vals_p) == len(vals_r) == nl + 1
    for k in range(nl):
        (dp, ep), (dr, er) = vals_p[k], vals_r[k]
        for a, b in ((dp, dr), (ep, er)):
            a, b = a.numpy(), np.asarray(b)
            assert a.shape == b.shape
            tol = 1e-12 * np.abs(b) + 1e-14 * np.abs(b).max()
            assert np.all(np.abs(a - b) <= tol), k
    assert _scaled(vals_p[-1].numpy(), vals_r[-1]) <= TOL_F32_INV


def _refreshed(dev_p, diag0, off0, R=None):
    """refresh_plain of (diag0, off0) into R (a fresh Refresh on the CPU
    when None), the inverse formed as the card forms it."""
    if R is None:
        R = amg.Refresh(dev_p, "cpu")
    amg.refresh_plain(R, diag0, off0)
    R.invert()
    return R


def test_refresh_plain_is_the_composition(setup):
    """K10's refresh in plain torch (the kernel's gathers over the composed
    maps: level k's entries read at their ELL slots, each coarse entry
    written into its slot) writes every level's values into the
    hierarchy's layout bit for bit as the per-level composition of the
    twins, the float32 dense coarsest matrix bit for bit as
    invert_coarsest forms it, and inv_ex into the buffers gives
    torch.linalg.inv's bits in its layout (a V-cycle on the buffers equals
    one on the composition); ``vals`` are views of the buffers."""
    _, _, _, (diag0, off0), dev_p, _, vals_p, _, _ = setup
    R = _refreshed(dev_p, diag0, off0)
    nl = dev_p.n_levels
    assert len(R.vals) == nl + 1 and R.vals[-1] is R.inv
    for k in range(nl):
        assert R.vals[k][0] is R.diag[k] and R.vals[k][1] is R.ell[k]
        assert torch.equal(R.diag[k], vals_p[k][0]), k
        assert torch.equal(R.ell[k], vals_p[k][1]), k
    A = amg.dense_coarsest(*vals_p[nl - 1], dev_p.ell[-1]["cols"])
    assert torch.equal(R.dense, A.to(torch.float32))
    assert torch.equal(R.inv, vals_p[-1]) and int(R.inv_info) == 0
    # the inverse's layout too: the coarsest product sums in its order
    assert R.inv.stride() == vals_p[-1].stride()
    b = torch.as_tensor(np.random.default_rng(8).standard_normal(dev_p.n0))
    assert torch.equal(dev_p.vcycle(R.vals, b), dev_p.vcycle(vals_p, b))


def test_refresh_plain_matches_reference(setup):
    """The refresh's values against the JAX package's coarsen_values at the
    twin's tolerances: every level 1e-12 relative, the float32 inverse
    1e-5 of max."""
    _, _, _, (diag0, off0), dev_p, _, _, vals_r, _ = setup
    R = _refreshed(dev_p, diag0, off0)
    for k in range(dev_p.n_levels):
        for a, b in zip(R.vals[k], vals_r[k]):
            a, b = a.numpy(), np.asarray(b)
            tol = 1e-12 * np.abs(b) + 1e-14 * np.abs(b).max()
            assert np.all(np.abs(a - b) <= tol), k
    assert _scaled(R.inv.numpy(), vals_r[-1]) <= TOL_F32_INV


def test_refresh_padding_stays_zero(setup):
    """Two refreshes into the same buffers with other seeded values: the
    padding slots (self-loops) stay 0 and the second refresh leaves no
    value of the first: it equals the per-level composition of its own
    inputs bit for bit."""
    g, hp, _, _, dev_p, *_ = setup
    R = None
    for seed in (11, 12):
        d, o = _pressure_values(g, hp.rows0, np.random.default_rng(seed))
        R = _refreshed(dev_p, d, o, R)
        vals = dev_p.coarsen_values(d, o)
        for k, e in enumerate(dev_p.ell):
            K, n = e["cols"].shape
            pad = torch.ones(K * n, dtype=torch.bool)
            pad[e["slot"]] = False
            assert not R.ell[k].reshape(-1)[pad].any(), (seed, k)
            assert torch.equal(R.ell[k], vals[k][1])
            assert torch.equal(R.diag[k], vals[k][0])
        assert torch.equal(R.inv, vals[-1])


def test_ell_spmv_and_sweep(setup):
    *_, dev_p, dev_r, vals_p, vals_r, rng = setup
    for k in (0, 2, dev_p.n_levels - 1):
        diag, ev = vals_p[k]
        cols = dev_p.ell[k]["cols"]
        n = diag.shape[0]
        x = rng.standard_normal(n)
        b = rng.standard_normal(n)
        xt, bt = torch.as_tensor(x), torch.as_tensor(b)
        cr = jnp.asarray(cols.numpy())
        dr, er = vals_r[k]
        y_p = amg.ell_spmv_plain(diag, xt, ev, cols)
        y_r = ramg.ell_spmv(dr, jnp.asarray(x), er, jnp.asarray(x)[cr])
        assert _scaled(y_p.numpy(), y_r) <= 1e-12
        s_p = amg.sweep_plain(diag, ev, cols, xt, bt)
        s_r = ramg.jacobi_sweep(0.8, dr, jnp.asarray(x), jnp.asarray(b),
                                er, jnp.asarray(x)[cr])
        assert _scaled(s_p.numpy(), s_r) <= 1e-12
        # the zero iterate (the pre-smoothing sweep of a V-cycle)
        z_r = ramg.jacobi_sweep(0.8, dr, jnp.zeros(n), jnp.asarray(b), er,
                                jnp.zeros(n)[cr])
        z_p = amg.sweep_plain(diag, ev, cols, None, bt)
        assert _scaled(z_p.numpy(), z_r) <= 1e-12


def test_vcycle(setup):
    *_, dev_p, dev_r, vals_p, vals_r, rng = setup
    b = rng.standard_normal(dev_p.n0)
    x_p = dev_p.vcycle(vals_p, torch.as_tensor(b))
    x_r = dev_r.vcycle(vals_r, jnp.asarray(b))
    assert _scaled(x_p.numpy(), x_r) <= TOL_F32_COARSE
    # the same V-cycle through the level-operation twins directly
    x_t = dev_p.vcycle(vals_p, torch.as_tensor(b), twin=True)
    assert torch.equal(x_t, x_p)


def _ref_sweep(dr, er, cols, x, b):
    return ramg.jacobi_sweep(0.8, dr, x, b, er, x[cols])


def test_vcycle_legs(setup):
    """K10's two legs by their plain versions (``vcycle`` on the CPU) equal
    the per-level composition bit for bit (above); each level's right-hand
    side of the down leg and correction of the up leg (from the port's
    float32 coarsest correction) against the JAX package's level
    operations (``jacobi_sweep``, ``ell_spmv``, ``segment_sum``) at 1e-12
    of max; two V-cycles in a row equal."""
    *_, dev_p, dev_r, vals_p, vals_r, rng = setup
    b = torch.as_tensor(rng.standard_normal(dev_p.n0))
    x = dev_p.vcycle(vals_p, b)
    assert torch.equal(x, dev_p.vcycle(vals_p, b))
    bs, bc = dev_p.vcycle_down_plain(vals_p, b)
    assert bc.dtype == torch.float32 and len(bs) == dev_p.n_levels
    xl, es = dev_p.vcycle_up_plain(vals_p, bs, vals_p[-1] @ bc)
    assert torch.equal(xl, x) and torch.equal(es[0], x)
    cols = [jnp.asarray(e["cols"].numpy()) for e in dev_p.ell]
    rb = jnp.asarray(b.numpy())
    for k, lv in enumerate(dev_p.levels):
        dr, er = vals_r[k]
        assert _scaled(bs[k].numpy(), rb) <= 1e-12
        rx = _ref_sweep(dr, er, cols[k], jnp.zeros_like(rb), rb)
        rb = jax.ops.segment_sum(
            rb - ramg.ell_spmv(dr, rx, er, rx[cols[k]]),
            jnp.asarray(lv["agg"].numpy()), num_segments=lv["n_coarse"])
    assert _scaled(bc.numpy(), rb.astype(jnp.float32)) <= 1e-7
    re_ = jnp.asarray(es[-1].numpy())
    for k in reversed(range(len(dev_p.levels))):
        dr, er = vals_r[k]
        rbk = jnp.asarray(bs[k].numpy())
        rx = _ref_sweep(dr, er, cols[k], jnp.zeros_like(rbk), rbk)
        re_ = _ref_sweep(dr, er, cols[k],
                         rx + re_[jnp.asarray(dev_p.levels[k]["agg"]
                                              .numpy())], rbk)
        assert _scaled(es[k].numpy(), re_) <= 1e-12


def test_vcycle_sweeps_branch(setup):
    """A hierarchy cut short (max_levels=2) leaves a coarsest level of more
    than DENSE_COARSEST cells, solved by 1 + 10 sweeps at the end of the
    down leg instead of the float32 inverse: the legs equal the per-level
    composition bit for bit, and the whole V-cycle (all float64) the JAX
    package's within 1e-12 of max (segment sums in another order)."""
    g, *_, rng = setup
    hp = amg.build_hierarchy(g.nc, g.face_cells, g.trans, max_levels=2)
    hr = ramg.build_hierarchy(g.nc, np.asarray(g.face_cells),
                              np.asarray(g.trans), max_levels=2)
    assert hp.coarsest_n == hr.coarsest_n > amg.DENSE_COARSEST
    dp, dr = hp.device("cpu"), hr.device()
    t = np.asarray(g.trans) / np.asarray(g.trans).max()
    off0 = -np.concatenate([t, t])
    diag0 = np.zeros(g.nc)
    np.add.at(diag0, hp.rows0, -off0)
    diag0 += 1e-3
    vp = dp.coarsen_values(torch.as_tensor(diag0), torch.as_tensor(off0))
    vr = dr.coarsen_values(jnp.asarray(diag0), jnp.asarray(off0))
    assert len(vp) == dp.n_levels
    b = rng.standard_normal(g.nc)
    x = dp.vcycle(vp, torch.as_tensor(b))
    assert torch.equal(x, dp.vcycle(vp, torch.as_tensor(b), twin=True))
    assert _scaled(x.numpy(), dr.vcycle(vr, jnp.asarray(b))) <= 1e-12


def test_vcycle_from_weighted_residual(setup):
    """The V-cycle from the CPR apply's weights and cell residual (the
    right-hand side the card's down leg forms in its first phase) equals
    K6's pressure_rhs_plain followed by the V-cycle on its result, bit for
    bit, through the legs' plain versions and through the per-level
    twins."""
    from opm_tpu_torch.linalg import precond
    *_, dev_p, dev_r, vals_p, vals_r, rng = setup
    w = torch.as_tensor(rng.uniform(0.2, 2.0, (3, dev_p.n0)))
    rc = torch.as_tensor(rng.standard_normal((3, dev_p.n0)))
    rp = precond.pressure_rhs_plain(w, rc)
    for twin in (False, True):
        assert torch.equal(dev_p.vcycle(vals_p, None, w=w, rc=rc, twin=twin),
                           dev_p.vcycle(vals_p, rp, twin=twin))
