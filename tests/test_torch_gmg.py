"""The port's structured geometric multigrid against the JAX package's,
on grids of its own: the toy SPE10-like grid (15x44x4, levels ordered by
transmissibility strength) and the same dims without transmissibilities
(levels by argmax, whose 44 -> 22 -> 11 coarsening pads a level), both
with a seeded 7-point pressure stencil, and a 2-D Poisson problem as a
BiCGStab preconditioner (tests/test_linalg.py:224 in port form).

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
