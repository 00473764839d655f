"""Piecewise-linear and bilinear table lookup: kernel K1 and its plain twin.

Port of the JAX package's utils/tables.py. Every PVT and saturation table
of the deck goes through two lookups here:

* ``lookup1``: 1-D tables with one or several value columns sharing one
  abscissa (``interp``, ``interp_multi``);
* ``lookup2``: bilinear tables with one or several grids sharing both axes
  (``interp2``, ``interp2_multi``; the PVTO inv_b/inv_bmu pair).

Each returns the values and the derivatives with respect to the query in
one pass. On a CUDA tensor the hand-written kernel of ``csrc/tables.cu``
runs (``interp1_cuda``/``interp2_cuda``); on a CPU tensor the plain PyTorch
version below, which is also the kernel's oracle on the card. The two are
wrapped in ``torch.autograd.Function``s whose ``jvp`` multiplies the query
tangents by the saved slopes and whose ``vmap`` folds a batch axis into the
query axis, so ``torch.func.jacfwd`` of any function built on them goes
through the kernel.

Semantics (the reference's segment-sum form): the active segment is
xs[k] <= x < xs[k+1]; queries below/above the table use the first/last
segment; zero-width segments are never active; t = (x - lo) / width
(width 0 -> 1); 'clamp' extrapolation clips t to [0, 1], with the slope
factor jax.jacfwd of jnp.clip gives (0 outside, 1/2 at t == 0 or 1); the
result is v + 0 * x, so NaN queries stay NaN with slope 0.

Tables carry a leading region axis: xs (nreg, n), value columns
(nreg, ncol, n), grids (nreg, ngrid, n, m); ``reg`` (same shape as the
query, integer) picks each query's row where nreg > 1.
"""

from __future__ import annotations

import torch

from opm_tpu_torch.utils import cuda_lib

_EXTRAP = {"linear": 0, "clamp": 1}
_SMEM_LIMIT = 48 * 1024


def _check_table(t, name, device):
    if t.dtype != torch.float64 or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float64 tensor on "
                         f"{device}")


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the kernel's oracle on the card)

def _segment(xs, x, reg):
    """Active-segment index per query: #{xs <= x} - 1 clipped to [0, n-2]."""
    n = xs.shape[-1]
    if reg is None:
        i = torch.searchsorted(xs[0], x, right=True) - 1
    else:
        i = (xs[reg] <= x[:, None]).sum(-1) - 1
    return i.clamp(0, n - 2)


def _row_take(tab, reg, i):
    """tab (nreg, k, n) -> (k, nq) values at segment node i of each query's
    region row."""
    if reg is None:
        return tab[0][:, i]
    return tab[reg, :, i].T


def _coord(xs, reg, i, x, clamp):
    lo = _row_take(xs[:, None, :], reg, i)[0]
    hi = _row_take(xs[:, None, :], reg, i + 1)[0]
    w = hi - lo
    ws = torch.where(w == 0.0, 1.0, w)
    t = (x - lo) / ws
    f = torch.ones_like(t)
    if clamp:
        out = (t < 0.0) | (t > 1.0)
        tie = (t == 0.0) | (t == 1.0)
        f = torch.where(out, 0.0, torch.where(tie, 0.5, 1.0))
        t = t.clamp(0.0, 1.0)
    return t, f * (1.0 / ws)


def lookup1_plain(xs, ys, x, reg, clamp):
    """xs (nreg, n), ys (nreg, ncol, n), x (nq,), reg (nq,) or None ->
    (values, slopes), each (ncol, nq)."""
    i = _segment(xs, x, reg)
    t, dt = _coord(xs, reg, i, x, clamp)
    y0 = _row_take(ys, reg, i)
    y1 = _row_take(ys, reg, i + 1)
    v = (1.0 - t) * y0 + t * y1 + 0.0 * x
    s = (-dt) * y0 + dt * y1
    s = torch.where(torch.isnan(x), 0.0, s)
    return v, s


def lookup2_plain(xs, ys, z, x, y, reg, clamp_x, clamp_y):
    """xs (nreg, n), ys (nreg, m), z (nreg, ngrid, n, m), x/y (nq,) ->
    (values, d/dx, d/dy), each (ngrid, nq)."""
    n, m = xs.shape[-1], ys.shape[-1]
    i = _segment(xs, x, reg)
    j = _segment(ys, y, reg)
    tx, dtx = _coord(xs, reg, i, x, clamp_x)
    ty, dty = _coord(ys, reg, j, y, clamp_y)
    zf = z.reshape(z.shape[0], z.shape[1], n * m)

    def zz(a, b):
        return _row_take(zf, reg, a * m + b)

    z00, z01 = zz(i, j), zz(i, j + 1)
    z10, z11 = zz(i + 1, j), zz(i + 1, j + 1)
    v0 = (1.0 - ty) * z00 + ty * z01
    v1 = (1.0 - ty) * z10 + ty * z11
    v = ((1.0 - tx) * v0 + tx * v1 + 0.0 * x) + 0.0 * y
    dx = (-dtx) * v0 + dtx * v1
    d0 = (-dty) * z00 + dty * z01
    d1 = (-dty) * z10 + dty * z11
    dy = (1.0 - tx) * d0 + tx * d1
    bad = torch.isnan(x) | torch.isnan(y)
    return v, torch.where(bad, 0.0, dx), torch.where(bad, 0.0, dy)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers (csrc/tables.cu)

_SIGS = {
    "opm_interp1": [cuda_lib.P, cuda_lib.P, cuda_lib.I, cuda_lib.I,
                    cuda_lib.I, cuda_lib.P, cuda_lib.P, cuda_lib.L,
                    cuda_lib.I, cuda_lib.P, cuda_lib.P, cuda_lib.P],
    "opm_interp2": [cuda_lib.P, cuda_lib.P, cuda_lib.P, cuda_lib.I,
                    cuda_lib.I, cuda_lib.I, cuda_lib.I, cuda_lib.P,
                    cuda_lib.P, cuda_lib.P, cuda_lib.L, cuda_lib.I,
                    cuda_lib.I, cuda_lib.P, cuda_lib.P, cuda_lib.P,
                    cuda_lib.P],
}


def _reg32(reg, nq, device):
    if reg is None:
        return None
    if reg.shape != (nq,) or reg.device != device:
        raise ValueError("reg must be (nq,) on the query's device")
    return reg.to(torch.int32).contiguous()


def interp1_cuda(xs, ys, x, reg, clamp):
    """K1 1-D lookup on the card; same contract as lookup1_plain."""
    dev = x.device
    for t, nm in ((xs, "xs"), (ys, "ys"), (x, "x")):
        _check_table(t, nm, dev)
    nreg, n = xs.shape
    ncol = ys.shape[1]
    if ys.shape != (nreg, ncol, n) or n < 2 or x.dim() != 1:
        raise ValueError("interp1_cuda: bad table or query shapes")
    if 8 * nreg * n * (1 + ncol) > _SMEM_LIMIT:
        raise ValueError("interp1_cuda: tables exceed shared memory")
    nq = x.shape[0]
    reg32 = _reg32(reg, nq, dev)
    val = torch.empty((ncol, nq), dtype=torch.float64, device=dev)
    slope = torch.empty_like(val)
    if nq:
        lib = cuda_lib.load("tables", _SIGS)
        err = lib.opm_interp1(
            cuda_lib.ptr(xs), cuda_lib.ptr(ys), nreg, n, ncol,
            cuda_lib.ptr(x), None if reg32 is None else cuda_lib.ptr(reg32),
            nq, int(clamp), cuda_lib.ptr(val), cuda_lib.ptr(slope),
            cuda_lib.stream_ptr(dev))
        cuda_lib.check(err, "opm_interp1")
        interp1_cuda.launches += 1
    return val, slope


interp1_cuda.launches = 0


def interp2_cuda(xs, ys, z, x, y, reg, clamp_x, clamp_y):
    """K1 bilinear lookup on the card; same contract as lookup2_plain."""
    dev = x.device
    for t, nm in ((xs, "xs"), (ys, "ys"), (z, "z"), (x, "x"), (y, "y")):
        _check_table(t, nm, dev)
    nreg, n = xs.shape
    m = ys.shape[1]
    ngrid = z.shape[1]
    if (ys.shape[0] != nreg or z.shape != (nreg, ngrid, n, m) or n < 2
            or m < 2 or x.dim() != 1 or y.shape != x.shape):
        raise ValueError("interp2_cuda: bad table or query shapes")
    if 8 * nreg * (n + m + ngrid * n * m) > _SMEM_LIMIT:
        raise ValueError("interp2_cuda: tables exceed shared memory")
    nq = x.shape[0]
    reg32 = _reg32(reg, nq, dev)
    val = torch.empty((ngrid, nq), dtype=torch.float64, device=dev)
    dvdx = torch.empty_like(val)
    dvdy = torch.empty_like(val)
    if nq:
        lib = cuda_lib.load("tables", _SIGS)
        err = lib.opm_interp2(
            cuda_lib.ptr(xs), cuda_lib.ptr(ys), cuda_lib.ptr(z), nreg, n, m,
            ngrid, cuda_lib.ptr(x), cuda_lib.ptr(y),
            None if reg32 is None else cuda_lib.ptr(reg32), nq,
            int(clamp_x), int(clamp_y), cuda_lib.ptr(val),
            cuda_lib.ptr(dvdx), cuda_lib.ptr(dvdy),
            cuda_lib.stream_ptr(dev))
        cuda_lib.check(err, "opm_interp2")
        interp2_cuda.launches += 1
    return val, dvdx, dvdy


interp2_cuda.launches = 0


# ---------------------------------------------------------------------------
# autograd Functions: forward-mode rules through the kernels

class _Lookup1(torch.autograd.Function):
    @staticmethod
    def forward(x, xs, ys, reg, clamp):
        return cuda_lib.dispatch(x, interp1_cuda, lookup1_plain, xs, ys, x,
                                 reg, clamp, what="K1 table lookup")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_forward(output[1])

    @staticmethod
    def jvp(ctx, x_t, xs_t, ys_t, reg_t, clamp_t):
        slope, = ctx.saved_tensors
        return slope * x_t, None

    @staticmethod
    def vmap(info, in_dims, x, xs, ys, reg, clamp):
        xd, xsd, ysd, rd, _ = in_dims
        if xsd is not None or ysd is not None:
            raise NotImplementedError("K1 lookup with batched tables")
        B = info.batch_size
        xb = cuda_lib.batched(x, xd, B)
        nq = xb.shape[1]
        rb = (None if reg is None
              else cuda_lib.batched(reg, rd, B).reshape(-1))
        v, s = _Lookup1.apply(xb.reshape(-1), xs, ys, rb, clamp)
        k = v.shape[0]
        return (v.reshape(k, B, nq), s.reshape(k, B, nq)), (1, 1)


class _Lookup2(torch.autograd.Function):
    @staticmethod
    def forward(x, y, xs, ys, z, reg, clamp_x, clamp_y):
        return cuda_lib.dispatch(x, interp2_cuda, lookup2_plain, xs, ys, z,
                                 x, y, reg, clamp_x, clamp_y,
                                 what="K1 table lookup")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1], output[2])
        ctx.save_for_forward(output[1], output[2])

    @staticmethod
    def jvp(ctx, x_t, y_t, *rest):
        dx, dy = ctx.saved_tensors
        v_t = None
        if x_t is not None:
            v_t = dx * x_t
        if y_t is not None:
            v_t = dy * y_t if v_t is None else v_t + dy * y_t
        return v_t, None, None

    @staticmethod
    def vmap(info, in_dims, x, y, xs, ys, z, reg, clamp_x, clamp_y):
        xd, yd, xsd, ysd, zd, rd = in_dims[:6]
        if xsd is not None or ysd is not None or zd is not None:
            raise NotImplementedError("K1 lookup with batched tables")
        B = info.batch_size
        xb = cuda_lib.batched(x, xd, B)
        yb = cuda_lib.batched(y, yd, B)
        nq = xb.shape[1]
        rb = (None if reg is None
              else cuda_lib.batched(reg, rd, B).reshape(-1))
        v, dx, dy = _Lookup2.apply(xb.reshape(-1), yb.reshape(-1), xs, ys,
                                   z, rb, clamp_x, clamp_y)
        k = v.shape[0]
        return ((v.reshape(k, B, nq), dx.reshape(k, B, nq),
                 dy.reshape(k, B, nq)), (1, 1, 1))


# ---------------------------------------------------------------------------
# public lookups

def _flat_reg(reg, shape, device):
    if reg is None:
        return None
    reg = torch.as_tensor(reg, dtype=torch.long, device=device)
    return torch.broadcast_to(reg, shape).reshape(-1)


def lookup1(xs, ys, x, *, extrap="linear", reg=None):
    """Columns of a 1-D table at x: xs (nreg, n), ys (nreg, ncol, n) ->
    tuple of ncol tensors shaped like x."""
    shape = x.shape
    # the kernel takes contiguous queries (a strided column is copied)
    v, _ = _Lookup1.apply(x.reshape(-1).contiguous(), xs, ys,
                          _flat_reg(reg if xs.shape[0] > 1 else None, shape, x.device),
                          _EXTRAP[extrap])
    return tuple(v[c].reshape(shape) for c in range(v.shape[0]))


def lookup2(xs, ys, z, x, y, *, extrap_x="linear", extrap_y="linear",
            reg=None):
    """Grids of a bilinear table at (x, y): xs (nreg, n), ys (nreg, m),
    z (nreg, ngrid, n, m) -> tuple of ngrid tensors."""
    x, y = torch.broadcast_tensors(x, y)
    shape = x.shape
    v, _, _ = _Lookup2.apply(
        x.reshape(-1).contiguous(), y.reshape(-1).contiguous(), xs, ys, z,
        _flat_reg(reg if xs.shape[0] > 1 else None, shape, x.device),
        _EXTRAP[extrap_x], _EXTRAP[extrap_y])
    return tuple(v[g].reshape(shape) for g in range(v.shape[0]))


def _rows(t):
    return t.reshape(1, -1) if t.dim() == 1 else t


def interp(xs, ys, x, *, extrap: str = "linear", reg=None):
    """Piecewise-linear interpolation of ys(xs) at x (reference
    ``interp``); xs, ys: (n,) or (nreg, n)."""
    xs, ys = _rows(xs), _rows(ys)
    return lookup1(xs, ys[:, None, :].contiguous(), x, extrap=extrap,
                   reg=reg)[0]


def interp_multi(xs, ys_cols, x, *, extrap: str = "linear"):
    """Several columns sharing one abscissa (reference ``interp_multi``);
    ys_cols: (n, ncol) -> (..., ncol)."""
    cols = lookup1(_rows(xs), ys_cols.T.contiguous()[None], x,
                   extrap=extrap)
    return torch.stack(cols, dim=-1)


def interp2_multi(xs, ys, zgrids, x, y, *, extrap_x="linear",
                  extrap_y="linear", reg=None):
    """Bilinear interpolation of several grids sharing both axes
    (reference ``interp2_multi``); xs (n,)|(nreg, n), ys (m,)|(nreg, m),
    zgrids: list of (n, m)|(nreg, n, m). Returns a list."""
    xs, ys = _rows(xs), _rows(ys)
    z = torch.stack([zz if zz.dim() == 3 else zz[None] for zz in zgrids],
                    dim=1).contiguous()
    return list(lookup2(xs, ys, z, x, y, extrap_x=extrap_x,
                        extrap_y=extrap_y, reg=reg))


def interp2(xs, ys, zgrid, x, y, *, extrap_x="linear", extrap_y="linear",
            reg=None):
    """Bilinear interpolation on a rectangular grid (reference
    ``interp2``)."""
    return interp2_multi(xs, ys, [zgrid], x, y, extrap_x=extrap_x,
                         extrap_y=extrap_y, reg=reg)[0]
