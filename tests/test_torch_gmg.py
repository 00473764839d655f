"""The port's structured geometric multigrid against the JAX package's,
on grids of its own: the toy SPE10-like grid (15x44x4, levels ordered by
transmissibility strength) and the same dims without transmissibilities
(levels by argmax, whose 44 -> 22 -> 11 coarsening pads a level), both
with a seeded 7-point pressure stencil, and a 2-D Poisson problem as a
BiCGStab preconditioner (tests/test_linalg.py:224 in port form); K7's
refresh buffers (``Refresh``) filled by the refresh's plain version on
both grids.

Tolerances: the level list exactly; Galerkin values and each level's
operations (damped-Jacobi sweep, residual restriction with the next
level's ghost slab) 1e-12 of max. The coarsest level is inverted in
float32 on both sides (a reference caveat, ROADMAP Queue 3) by LAPACK
and by XLA, which differ in the last float32 bits: the inverse is held
to 1e-5 of its max and a whole V-cycle to 1e-6 of max, on stencils
shifted by 5% of their diagonal so that the coarsest matrix is well
conditioned."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from opm_tpu.linalg.gmg import StructuredGmg as RefGmg
from opm_tpu.linalg.gmg import _pad_axis as ref_pad_axis
from opm_tpu.linalg.gmg import _pairsum as ref_pairsum
from opm_tpu.linalg.gmg import _repeat2 as ref_repeat2
from opm_tpu.linalg.krylov import bicgstab as ref_bicgstab
from opm_tpu_torch.grid.grid import build_grid
from opm_tpu_torch.linalg import gmg
from opm_tpu_torch.linalg.krylov import bicgstab
from opm_tpu_torch.sim.testcases import spe10like_case

torch.set_num_threads(2)


def _scaled(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    scale = max(np.abs(b).max(), 1e-300) if b.size else 1.0
    assert err <= tol * scale, f"{err / scale:.3e} of max"



def _poisson(dims, seed, shift=1e-3):
    """A 7-point stencil with seeded positive couplings in grid face
    order, as the pressure system carries it: (trans, diag, off)."""
    nx, ny, nz = dims
    nf = (nx - 1) * ny * nz + nx * (ny - 1) * nz + nx * ny * (nz - 1)
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.5, 2.0, nf)
    diag = np.zeros(nx * ny * nz)
    ofs = 0
    cells = np.arange(nx * ny * nz).reshape(nz, ny, nx)
    for lo, hi in (((slice(None), slice(None), slice(None, -1)),
                    (slice(None), slice(None), slice(1, None))),
                   ((slice(None), slice(None, -1)), (slice(None),
                                                     slice(1, None))),
                   ((slice(None, -1),), (slice(1, None),))):
        c1, c2 = cells[lo].reshape(-1), cells[hi].reshape(-1)
        np.add.at(diag, c1, t[ofs:ofs + len(c1)])
        np.add.at(diag, c2, t[ofs:ofs + len(c1)])
        ofs += len(c1)
    return t, diag + shift * (diag if shift > 1e-2 else 1.0), \
        np.concatenate([-t, -t])


@pytest.fixture(scope="module")
def toy_grid():
    return build_grid(spe10like_case(nx=15, ny=44, nz=4))


@pytest.mark.parametrize("case", ["toy_strength", "padded"])
def test_gmg_levels_and_values_match_reference(toy_grid, case):
    dims = (15, 44, 4)
    trans = toy_grid.trans if case == "toy_strength" else None
    g = gmg.StructuredGmg(dims, trans)
    r = RefGmg(dims, trans)
    assert [(lv.dims, lv.axis, lv.pad) for lv in g.levels] == \
        [(lv.dims, lv.axis, lv.pad) for lv in r.levels]
    assert len(g.levels) >= 3
    if case == "padded":
        assert any(lv.pad for lv in g.levels)
    _, diag, off = _poisson(dims, 3, shift=0.05)
    vals = g.coarsen_values(torch.from_numpy(diag), torch.from_numpy(off))
    rvals = r.coarsen_values(jnp.asarray(diag), jnp.asarray(off))
    for (d3, offs), (rd3, roffs) in zip(vals[:-1], rvals[:-1]):
        _scaled(d3.numpy(), rd3, 1e-12)
        for (aL, aR), (raL, raR) in zip(offs, roffs):
            _scaled(aL.numpy(), raL, 1e-12)
            _scaled(aR.numpy(), raR, 1e-12)
    # float32 inverses by LAPACK and by XLA
    _scaled(vals[-1].numpy(), rvals[-1], 1e-5)
    b = np.random.default_rng(5).standard_normal(g.nc)
    _scaled(g.vcycle(vals, torch.from_numpy(b)).numpy(),
            r.vcycle(rvals, jnp.asarray(b)), 1e-6)
    # each level's operations, padded levels included, at 1e-12
    for k, lv in enumerate(g.levels):
        d3, offs = vals[k]
        rng = np.random.default_rng(10 + k)
        x = rng.standard_normal(tuple(d3.shape))
        bb = rng.standard_normal(tuple(d3.shape))
        rd3 = jnp.asarray(d3.numpy())
        roffs = tuple((jnp.asarray(a.numpy()), jnp.asarray(c.numpy()))
                      for a, c in offs)
        xt, bt = torch.from_numpy(x), torch.from_numpy(bb)
        _scaled(gmg.smooth_plain(d3, offs, xt, bt).numpy(),
                r._smooth(rd3, roffs, jnp.asarray(x), jnp.asarray(bb)),
                1e-12)
        nxt = g.levels[k + 1] if k + 1 < len(g.levels) else None
        pad_axis = nxt.axis if nxt is not None and nxt.pad else -1
        rc = ref_pairsum(jnp.asarray(bb)
                         - RefGmg._matvec(rd3, roffs, jnp.asarray(x)),
                         lv.axis)
        if pad_axis >= 0:
            rc = ref_pad_axis(rc, pad_axis, 1)
        _scaled(gmg.restrict_plain(d3, offs, xt, bt, lv.axis,
                                   pad_axis).numpy(), rc, 1e-12)


def test_gmg_poisson():
    """tests/test_linalg.py:224 in port form: the V-cycle as a BiCGStab
    preconditioner on a 2-D Poisson problem with odd dims (ghost padding);
    converges in under 30 iterations, as many as the reference takes."""
    dims = (33, 31, 1)
    _, diag, off = _poisson(dims, 0)
    nx, ny, nz = dims
    g = gmg.StructuredGmg(dims)
    r = RefGmg(dims)
    vals = g.coarsen_values(torch.from_numpy(diag), torch.from_numpy(off))
    rvals = r.coarsen_values(jnp.asarray(diag), jnp.asarray(off))
    rd3 = jnp.asarray(diag.reshape(nz, ny, nx))
    nf = off.shape[0] // 2
    t = -off[:nf]
    nfx = (nx - 1) * ny * nz
    pairs = ((t[nfx + (nx * (ny - 1) * nz):].reshape(0, ny, nx),) * 2,
             (t[nfx:nfx + nx * (ny - 1) * nz].reshape(nz, ny - 1, nx),) * 2,
             (t[:nfx].reshape(nz, ny, nx - 1),) * 2)
    offs = tuple((torch.from_numpy(-a).contiguous(),
                  torch.from_numpy(-c).contiguous()) for a, c in pairs)
    roffs = tuple((jnp.asarray(-a), jnp.asarray(-c)) for a, c in pairs)
    d3 = torch.from_numpy(diag.reshape(nz, ny, nx))

    def mv(x):
        return gmg.stencil_plain(d3, offs, x.reshape(nz, ny, nx)).reshape(-1)

    def rmv(x):
        return RefGmg._matvec(rd3, roffs, x.reshape(nz, ny, nx)).reshape(-1)

    b = np.random.default_rng(5).standard_normal(g.nc)
    res = bicgstab(mv, torch.from_numpy(b),
                   precond=lambda v: g.vcycle(vals, v), tol=1e-8, maxiter=60)
    rres = ref_bicgstab(rmv, jnp.asarray(b),
                        precond=lambda v: r.vcycle(rvals, v), tol=1e-8,
                        maxiter=60)
    assert res.converged and res.iterations < 30
    assert res.iterations == int(rres.iterations)


@pytest.mark.parametrize("case", ["toy_strength", "padded"])
def test_gmg_vcycle_legs(toy_grid, case):
    """K7's two legs by their plain versions (``vcycle`` on the CPU): the
    per-level composition (``vcycle(..., twin=True)``) bit for bit, so
    evaluating the pre-smoothed iterate from b where it is needed changes
    no bit; each level's right-hand side of the down leg and correction of
    the up leg against the JAX package's level operations at 1e-12 of max
    (the up leg from the port's float32 coarsest correction); the whole
    V-cycle against the reference's within 1e-6 of max (the float32
    coarsest, as above); two V-cycles in a row equal."""
    dims = (15, 44, 4)
    trans = toy_grid.trans if case == "toy_strength" else None
    g = gmg.StructuredGmg(dims, trans)
    r = RefGmg(dims, trans)
    _, diag, off = _poisson(dims, 3, shift=0.05)
    vals = g.coarsen_values(torch.from_numpy(diag), torch.from_numpy(off))
    rvals = r.coarsen_values(jnp.asarray(diag), jnp.asarray(off))
    b = np.random.default_rng(7).standard_normal(g.nc)
    bt = torch.from_numpy(b)
    x = g.vcycle(vals, bt)
    assert torch.equal(x, g.vcycle(vals, bt, twin=True))
    assert torch.equal(x, g.vcycle(vals, bt))
    _scaled(x.numpy(), r.vcycle(rvals, jnp.asarray(b)), 1e-6)

    bs, bc = g.vcycle_down_plain(vals, bt)
    xl, es = g.vcycle_up_plain(vals, bs, vals[-1] @ bc)
    assert torch.equal(xl, x) and bc.dtype == torch.float32
    assert len(bs) == len(es) == len(g.levels)
    rv = [tuple(jnp.asarray(a.numpy()) for a in (d3,)) + (tuple(
        (jnp.asarray(aL.numpy()), jnp.asarray(aR.numpy()))
        for aL, aR in offs),) for d3, offs in vals[:-1]]
    rb = jnp.asarray(bs[0].numpy())
    for k, lv in enumerate(g.levels):
        rd3, roffs = rv[k]
        _scaled(bs[k].numpy(), rb, 1e-12)
        rx = r._smooth(rd3, roffs, jnp.zeros_like(rb), rb)
        rb = ref_pairsum(rb - RefGmg._matvec(rd3, roffs, rx), lv.axis)
        pad_axis = g._pad_axis_after(k)
        if pad_axis >= 0:
            rb = ref_pad_axis(rb, pad_axis, 1)
    _scaled(bc.numpy(), rb.reshape(-1).astype(jnp.float32), 1e-7)
    re_ = jnp.asarray((vals[-1] @ bc).numpy().astype(np.float64)).reshape(
        g.coarse_dims)
    for k in reversed(range(len(g.levels))):
        rd3, roffs = rv[k]
        rbk = jnp.asarray(bs[k].numpy())
        rx = r._smooth(rd3, roffs, jnp.zeros_like(rbk), rbk)
        axis = g.levels[k].axis
        c = list(bs[k].shape)
        c[axis] //= 2          # the coarse level's real cells
        re_ = r._smooth(rd3, roffs, rx + ref_repeat2(
            re_[:c[0], :c[1], :c[2]], axis), rbk)
        _scaled(es[k].numpy(), re_, 1e-12)


@pytest.mark.parametrize("case", ["toy_strength", "padded"])
def test_gmg_vcycle_from_weighted_residual(toy_grid, case):
    """The V-cycle from the CPR apply's weights and cell residual (the
    right-hand side the card's down leg forms itself) equals K6's
    pressure_rhs_plain followed by the V-cycle on its result, bit for bit,
    through the legs' plain versions and through the per-level twins; the
    weighted residual against the reference's CPR expression at 1e-15 of
    max (the same three products and two sums)."""
    from opm_tpu_torch.linalg import precond
    dims = (15, 44, 4)
    g = gmg.StructuredGmg(dims,
                          toy_grid.trans if case == "toy_strength" else None)
    _, diag, off = _poisson(dims, 3, shift=0.05)
    vals = g.coarsen_values(torch.from_numpy(diag), torch.from_numpy(off))
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.uniform(0.2, 2.0, (3, g.nc)))
    rc = torch.from_numpy(rng.standard_normal((3, g.nc)))
    rp = precond.pressure_rhs_plain(w, rc)
    wn, rn = w.numpy(), rc.numpy()
    _scaled(rp.numpy(), (wn[0] * rn[0] + wn[1] * rn[1]) + wn[2] * rn[2],
            1e-15)
    for twin in (False, True):
        assert torch.equal(g.vcycle(vals, None, w=w, rc=rc, twin=twin),
                           g.vcycle(vals, rp, twin=twin))


@pytest.mark.parametrize("case", ["toy_strength", "padded"])
def test_gmg_refresh_plain_into_buffers(toy_grid, case):
    """K7's refresh buffers (``Refresh``: every level's padded values and
    the float32 dense coarsest matrix, allocated and zeroed once) filled by
    ``refresh_plain``: bit for bit the per-level composition
    (``coarsen_values`` on the CPU), whose dense matrix is the float32
    cast of ``_dense_coarsest``; against the JAX package's coarsen_values
    at 1e-12 of max for the levels and 1e-5 for the float32 inverse formed
    into the buffer (``Refresh.invert``, info 0); over two refreshes with
    other seeded values every ghost slab stays 0 and the buffers stay the
    same tensors."""
    dims = (15, 44, 4)
    trans = toy_grid.trans if case == "toy_strength" else None
    g = gmg.StructuredGmg(dims, trans)
    r = RefGmg(dims, trans)
    R = gmg.Refresh(g, "cpu")
    bufs = [t for d3, offs in R.vals[:-1] for t in (d3,) + sum(offs, ())]
    for shift in (0.05, 0.2):
        _, diag, off = _poisson(dims, 3 if shift < 0.1 else 4, shift=shift)
        d0, o0 = torch.from_numpy(diag), torch.from_numpy(off)
        gmg.refresh_plain(R, d0, o0)
        R.invert()
        assert int(R.inv_info) == 0
        vals = g.coarsen_values(d0, o0)
        levels, A = g.compose(d0, o0)
        assert torch.equal(R.dense, A.to(torch.float32))
        assert torch.equal(R.inv, vals[-1])
        rvals = r.coarsen_values(jnp.asarray(diag), jnp.asarray(off))
        for k, ((d3, offs), (bd, boffs), (rd3, roffs)) in enumerate(
                zip(vals[:-1], R.vals[:-1], rvals[:-1])):
            assert torch.equal(bd, d3)
            _scaled(bd.numpy(), rd3, 1e-12)
            for (aL, aR), (bL, bR), (raL, raR) in zip(offs, boffs, roffs):
                assert torch.equal(bL, aL) and torch.equal(bR, aR)
                _scaled(bL.numpy(), raL, 1e-12)
                _scaled(bR.numpy(), raR, 1e-12)
            lv = g.levels[k]
            if lv.pad:           # the ghost slab along the level's axis
                ghost = [slice(None)] * 3
                ghost[lv.axis] = slice(-1, None)
                ghost = tuple(ghost)
                assert not bd[ghost].any()
                for bL, bR in boffs:
                    assert not bL[ghost].any() and not bR[ghost].any()
        _scaled(R.inv.numpy(), rvals[-1], 1e-5)
    assert case != "padded" or any(lv.pad for lv in g.levels)
    assert [t for d3, offs in R.vals[:-1]
            for t in (d3,) + sum(offs, ())] == bufs
