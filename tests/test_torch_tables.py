"""K1's plain version against the JAX package's utils/tables.py, values
and slopes, and torch.func.jacfwd through the K1 autograd Functions.

Tolerances: values 5e-13 relative (the reference's own two forms agree to
5e-13); slopes 1e-12 relative against jax.jacfwd (the port multiplies a
saved slope by the tangent where jax differentiates the formula)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opm_tpu.utils import tables as ref
from opm_tpu_torch.utils import tables as port

torch.set_num_threads(2)

VAL_TOL = 5e-13
SLOPE_TOL = 1e-12


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    fin = ~np.isnan(b)
    err = np.abs(a[fin] - b[fin])
    assert np.all(err <= tol * np.abs(b[fin]) + tol * 1e-300), err.max()


def _table(rng, n):
    xs = np.sort(rng.uniform(0.0, 10.0, n))
    return xs, rng.normal(size=n)


def _queries(rng, xs):
    lo, hi = xs[0], xs[-1]
    span = hi - lo
    return np.concatenate([
        rng.uniform(lo - 0.3 * span, hi + 0.3 * span, 64),  # below/above
        xs,                                     # exactly on the nodes
        [lo - 1e6, hi + 1e6, np.nan]])


@pytest.mark.parametrize("extrap", ["linear", "clamp"])
@pytest.mark.parametrize("n", [2, 9, 65, 200])
def test_interp_values_and_slopes(extrap, n):
    rng = np.random.default_rng(n)
    xs, ys = _table(rng, n)
    x = _queries(rng, xs)
    r = ref.interp(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(x),
                   extrap=extrap)
    p = port.interp(torch.tensor(xs), torch.tensor(ys), torch.tensor(x),
                    extrap=extrap)
    if n - 1 <= ref._GATHER_FREE_MAX_SEGMENTS:
        _close(p.numpy(), r, VAL_TOL)
    else:
        # the reference's bracket path returns y0 + (y1-y0) t style values
        # for NaN queries too; compare the finite ones
        fin = ~np.isnan(x)
        _close(p.numpy()[fin], np.asarray(r)[fin], VAL_TOL)
    fin = ~np.isnan(x)
    jr = jax.vmap(jax.grad(lambda q: ref.interp(
        jnp.asarray(xs), jnp.asarray(ys), q, extrap=extrap)))(
            jnp.asarray(x[fin]))
    jp = torch.func.vmap(torch.func.jacfwd(lambda q: port.interp(
        torch.tensor(xs), torch.tensor(ys), q, extrap=extrap)))(
            torch.tensor(x[fin]))
    np.testing.assert_allclose(jp.numpy(), np.asarray(jr), rtol=SLOPE_TOL,
                               atol=SLOPE_TOL * np.abs(ys).max())


@pytest.mark.parametrize("extrap", ["linear", "clamp"])
def test_interp_multi(extrap):
    rng = np.random.default_rng(7)
    xs, _ = _table(rng, 12)
    cols = rng.normal(size=(12, 3))
    x = _queries(rng, xs)
    r = ref.interp_multi(jnp.asarray(xs), jnp.asarray(cols),
                         jnp.asarray(x), extrap=extrap)
    p = port.interp_multi(torch.tensor(xs), torch.tensor(cols),
                          torch.tensor(x), extrap=extrap)
    _close(p.numpy(), r, VAL_TOL)


def _grid(rng, n, m):
    xs = np.sort(rng.uniform(0.0, 150.0, n))
    ys = np.concatenate([[0.0], np.sort(rng.uniform(1e5, 3e7, m - 1))])
    return xs, ys, rng.uniform(0.5, 1.5, (n, m)), rng.uniform(0.5, 1.5, (n, m))


@pytest.mark.parametrize("extrap", ["linear", "clamp"])
def test_interp2_multi_values_and_slopes(extrap):
    rng = np.random.default_rng(11)
    xs, ys, z1, z2 = _grid(rng, 9, 4)
    qx = np.concatenate([rng.uniform(-20, 170, 40), xs[:4], [np.nan]])
    qy = np.concatenate([rng.uniform(-1e6, 3.3e7, 40), ys, [1e6]])
    kw = dict(extrap_x=extrap, extrap_y=extrap)
    r = ref.interp2_multi(jnp.asarray(xs), jnp.asarray(ys),
                          [jnp.asarray(z1), jnp.asarray(z2)],
                          jnp.asarray(qx), jnp.asarray(qy), **kw)
    p = port.interp2_multi(torch.tensor(xs), torch.tensor(ys),
                           [torch.tensor(z1), torch.tensor(z2)],
                           torch.tensor(qx), torch.tensor(qy), **kw)
    for a, b in zip(p, r):
        _close(a.numpy(), b, VAL_TOL)
    single = port.interp2(torch.tensor(xs), torch.tensor(ys),
                          torch.tensor(z2), torch.tensor(qx),
                          torch.tensor(qy), **kw)
    _close(single.numpy(), r[1], VAL_TOL)

    nq = 40
    q = np.concatenate([qx[:nq], qy[:nq]])

    def fr(v):
        return ref.interp2_multi(jnp.asarray(xs), jnp.asarray(ys),
                                 [jnp.asarray(z1), jnp.asarray(z2)],
                                 v[:nq], v[nq:], **kw)[0]

    def fp(v):
        return port.interp2_multi(torch.tensor(xs), torch.tensor(ys),
                                  [torch.tensor(z1), torch.tensor(z2)],
                                  v[:nq], v[nq:], **kw)[0]

    Jr = np.asarray(jax.jacfwd(fr)(jnp.asarray(q)))
    Jp = torch.func.jacfwd(fp)(torch.tensor(q)).numpy()
    for blk in (slice(0, nq), slice(nq, 2 * nq)):
        a, b = Jp[:, blk], Jr[:, blk]
        assert np.abs(a - b).max() <= SLOPE_TOL * np.abs(b).max()


def test_region_rows_match_batched_reference_tables():
    """Per-query region rows (nreg > 1) equal the reference's batched
    tables xs[reg], ys[reg]."""
    rng = np.random.default_rng(5)
    nreg, n = 3, 8
    xs = np.sort(rng.uniform(0, 1, (nreg, n)), axis=1)
    ys = rng.normal(size=(nreg, n))
    x = rng.uniform(-0.2, 1.2, 50)
    reg = rng.integers(0, nreg, 50)
    for extrap in ("linear", "clamp"):
        r = ref.interp(jnp.asarray(xs[reg]), jnp.asarray(ys[reg]),
                       jnp.asarray(x), extrap=extrap)
        p = port.interp(torch.tensor(xs), torch.tensor(ys), torch.tensor(x),
                        extrap=extrap, reg=torch.tensor(reg))
        _close(p.numpy(), r, VAL_TOL)


def test_jacfwd_through_k1_function_vmaps():
    """jacfwd of a composition (the PVT chain b(p, rs(p))) runs the K1
    Functions' jvp and vmap rules and equals jax.jacfwd."""
    rng = np.random.default_rng(9)
    xs, ys = _table(rng, 10)
    gx, gy, z1, _ = _grid(rng, 7, 3)
    p = rng.uniform(0.0, 10.0, 30)

    def fr(v):
        rs = ref.interp(jnp.asarray(xs), jnp.asarray(ys), v) * 15.0 + 75.0
        return ref.interp2(jnp.asarray(gx), jnp.asarray(gy),
                           jnp.asarray(z1), rs, v * 1e6)

    def fp(v):
        rs = port.interp(torch.tensor(xs), torch.tensor(ys), v) * 15.0 + 75.0
        return port.interp2(torch.tensor(gx), torch.tensor(gy),
                            torch.tensor(z1), rs, v * 1e6)

    Jr = np.asarray(jax.jacfwd(fr)(jnp.asarray(p)))
    Jp = torch.func.jacfwd(fp)(torch.tensor(p)).numpy()
    assert np.abs(Jp - Jr).max() <= SLOPE_TOL * np.abs(Jr).max()
    _close(fp(torch.tensor(p)).numpy(), fr(jnp.asarray(p)), VAL_TOL)
