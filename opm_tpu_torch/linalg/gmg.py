"""Structured geometric multigrid for the CPR pressure system.

Port of the JAX package's linalg/gmg.py (``StructuredGmg``). On a
fully-active cartesian grid the TPFA pressure operator is a 7-point
stencil; levels semicoarsen by 2 along one axis (the strongest coupling
first, chosen once on the host from the transmissibilities), Galerkin
values coarsen by pair sums (once per Newton, plain torch), an odd axis
gets one ghost slab (diagonal 0, couplings 0), and the coarsest level
(at most ``coarsest`` cells) is solved by a precomputed dense inverse.

The inverse is float32 and applied in float32 on every backend, as the
reference does (``jnp.linalg.inv(A.astype(float32))``): a known reference
caveat (ROADMAP Queue 3), kept so the linear iteration counts match.

Kernel K7 (``csrc/gmg.cu``) does the level work of the V-cycle: the damped
Jacobi sweep (omega = 0.8), the residual fused with the pair-sum
restriction, and the replicate prolongation fused with the post-smoothing
sweep. The plain twins below follow the reference's slice arithmetic.
Arrays stay in their padded level shape through the cycle; a ghost slab
has zero couplings, so it never reaches a real cell.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from opm_tpu_torch.utils import cuda_lib

OMEGA = 0.8


@dataclass(frozen=True)
class _Level:
    dims: Tuple[int, int, int]     # logical (nz, ny, nx) at level entry
    axis: int                      # array axis coarsened (0=z, 1=y, 2=x)
    pad: bool                      # logical dim along axis is odd


def _pairsum(a, axis):
    sh = a.shape
    new = sh[:axis] + (sh[axis] // 2, 2) + sh[axis + 1:]
    return a.reshape(new).sum(dim=axis + 1)


def _repeat2(a, axis):
    return torch.repeat_interleave(a, 2, dim=axis)


def _pad_axis(a, axis, extra):
    if extra == 0:
        return a
    shape = list(a.shape)
    shape[axis] = extra
    return torch.cat([a, torch.zeros(shape, dtype=a.dtype, device=a.device)],
                     dim=axis)


def _take(a, axis, sl):
    idx = [slice(None)] * a.dim()
    idx[axis] = sl
    return a[tuple(idx)]


# ---------------------------------------------------------------------------
# K7: plain versions of the level kernels. offs = ((aLz, aRz), (aLy, aRy),
# (aLx, aRx)), each face array one shorter than the level along its axis.

def stencil_plain(diag3, offs, x3):
    """7-point apply in the reference's order (``_matvec``, CPU branch)."""
    y = diag3 * x3
    for ax in range(3):
        aL, aR = offs[ax]
        if aL.shape[ax] == 0:
            continue
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(None, -1)
        hi[ax] = slice(1, None)
        lo, hi = tuple(lo), tuple(hi)
        y[lo] += aL * x3[hi]
        y[hi] += aR * x3[lo]
    return y


def _sweep(diag3, offs, x3, b3):
    safe = torch.where(torch.abs(diag3) > 1e-300, diag3,
                       torch.ones_like(diag3))
    y = stencil_plain(diag3, offs, x3)
    return x3 + OMEGA * (b3 - y) / safe


def smooth_plain(diag3, offs, x3, b3):
    """One damped-Jacobi sweep; x3 None is a zero first iterate."""
    if x3 is None:
        x3 = torch.zeros_like(b3)
    return _sweep(diag3, offs, x3, b3)


def restrict_plain(diag3, offs, x3, b3, axis, pad_axis):
    """Pair-summed residual b - A x along ``axis`` (the next level's right
    hand side), with the next level's ghost slab along ``pad_axis`` (or
    -1 for none)."""
    rc = _pairsum(b3 - stencil_plain(diag3, offs, x3), axis)
    return _pad_axis(rc, pad_axis, 1) if pad_axis >= 0 else rc


def prolong_smooth_plain(diag3, offs, x3, e_c, axis, b3):
    """x + replicated coarse correction (its real cells), then one sweep."""
    c = list(x3.shape)
    c[axis] //= 2
    e = e_c[:c[0], :c[1], :c[2]]
    return _sweep(diag3, offs, x3 + _repeat2(e, axis), b3)


# ---------------------------------------------------------------------------
# K7: CUDA wrappers (csrc/gmg.cu)

_P, _I = cuda_lib.P, cuda_lib.I
_SIGS = {
    "opm_gmg_smooth": [_I, _I, _I] + [_P] * 7 + [_P, _P, _P, _P],
    "opm_gmg_restrict": [_I, _I, _I] + [_P] * 7
    + [_P, _P, _P, _I, _I, _I, _I, _P],
    "opm_gmg_prolong_smooth": [_I, _I, _I] + [_P] * 7
    + [_P, _P, _I, _I, _I, _I, _P, _P, _P],
}


def _level_args(diag3, offs):
    ts = [diag3] + [a for pair in offs for a in pair]
    dev = diag3.device
    for t in ts:
        if (t.dtype != torch.float64 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError("K7: level arrays must be contiguous float64 "
                             f"tensors on {dev}")
    nz, ny, nx = diag3.shape
    for ax, (aL, aR) in enumerate(offs):
        want = list(diag3.shape)
        want[ax] = max(want[ax] - 1, 0)
        if list(aL.shape) != want or list(aR.shape) != want:
            raise ValueError("K7: face arrays must be one shorter than the "
                             "level along their axis")
    return [nz, ny, nx] + [cuda_lib.ptr(t) for t in ts]


def _vec(t, shape, dev):
    if (t.dtype != torch.float64 or t.device != dev or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"K7: expected a contiguous float64 {tuple(shape)} "
                         f"tensor on {dev}")


def smooth_cuda(diag3, offs, x3, b3):
    args = _level_args(diag3, offs)
    dev = diag3.device
    _vec(b3, diag3.shape, dev)
    if x3 is not None:
        _vec(x3, diag3.shape, dev)
    out = torch.empty_like(b3)
    lib = cuda_lib.load("gmg", _SIGS)
    err = lib.opm_gmg_smooth(
        *args, cuda_lib.ptr(x3) if x3 is not None else cuda_lib.P(0),
        cuda_lib.ptr(b3), cuda_lib.ptr(out), cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "opm_gmg_smooth")
    smooth_cuda.launches += 1
    return out


smooth_cuda.launches = 0


def restrict_cuda(diag3, offs, x3, b3, axis, pad_axis):
    args = _level_args(diag3, offs)
    dev = diag3.device
    _vec(b3, diag3.shape, dev)
    _vec(x3, diag3.shape, dev)
    c = list(diag3.shape)
    if c[axis] & 1:
        raise ValueError("K7 restrict: the coarsened axis must be even")
    c[axis] //= 2
    if pad_axis >= 0:
        c[pad_axis] += 1
    out = torch.empty(c, dtype=torch.float64, device=dev)
    lib = cuda_lib.load("gmg", _SIGS)
    err = lib.opm_gmg_restrict(*args, cuda_lib.ptr(x3), cuda_lib.ptr(b3),
                               cuda_lib.ptr(out), axis, *c,
                               cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "opm_gmg_restrict")
    restrict_cuda.launches += 1
    return out


restrict_cuda.launches = 0


def prolong_smooth_cuda(diag3, offs, x3, e_c, axis, b3):
    args = _level_args(diag3, offs)
    dev = diag3.device
    _vec(b3, diag3.shape, dev)
    _vec(x3, diag3.shape, dev)
    c = list(diag3.shape)
    c[axis] //= 2
    if (e_c.dtype != torch.float64 or not e_c.is_contiguous()
            or e_c.device != dev or e_c.dim() != 3
            or any(e_c.shape[i] < c[i] for i in range(3))):
        raise ValueError("K7 prolong: the coarse correction must be a "
                         "contiguous float64 level array covering the "
                         "coarse cells")
    out = torch.empty_like(b3)
    lib = cuda_lib.load("gmg", _SIGS)
    err = lib.opm_gmg_prolong_smooth(
        *args, cuda_lib.ptr(x3), cuda_lib.ptr(e_c), axis, *e_c.shape,
        cuda_lib.ptr(b3), cuda_lib.ptr(out), cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "opm_gmg_prolong_smooth")
    prolong_smooth_cuda.launches += 1
    return out


prolong_smooth_cuda.launches = 0


def smooth(diag3, offs, x3, b3):
    return cuda_lib.dispatch(b3, smooth_cuda, smooth_plain, diag3, offs, x3,
                             b3, what="K7 smooth")


def restrict(diag3, offs, x3, b3, axis, pad_axis):
    return cuda_lib.dispatch(b3, restrict_cuda, restrict_plain, diag3, offs,
                             x3, b3, axis, pad_axis, what="K7 restrict")


def prolong_smooth(diag3, offs, x3, e_c, axis, b3):
    return cuda_lib.dispatch(b3, prolong_smooth_cuda, prolong_smooth_plain,
                             diag3, offs, x3, e_c, axis, b3,
                             what="K7 prolong_smooth")


# ---------------------------------------------------------------------------

class StructuredGmg:
    """Semicoarsened geometric multigrid on a fully-active cartesian grid.

    dims: (nx, ny, nz) grid dims (ECL order); level-0 face values follow
    grid.build_grid's order: x-faces (nz, ny, nx-1), then y-faces
    (nz, ny-1, nx), then z-faces (nz-1, ny, nx)."""

    COARSEST = 512      # cells of the dense coarsest level, at most
    MAX_LEVELS = 40
    # the pressure system over the stencil faces only: an embedded grid's
    # extra faces are dropped from the hierarchy (precond.py
    # _pressure_off_for), never from the Krylov operator
    wants_canonical_faces = True

    def __init__(self, dims, trans=None):
        nx, ny, nz = dims
        self.dims = (nz, ny, nx)               # internal (z, y, x) order
        self.nc = nx * ny * nz
        self.levels: List[_Level] = []
        d = list(self.dims)
        st = self._host_strength(dims, trans)
        while int(np.prod(d)) > self.COARSEST \
                and len(self.levels) < self.MAX_LEVELS \
                and max(d) > 1:
            if st is not None:
                # strongest direction that can still be coarsened
                order = np.argsort([-s.mean() if s.size else -0.0
                                    for s in st])
                a = next(int(ax) for ax in order if d[ax] > 1)
            else:
                a = int(np.argmax(d))
            self.levels.append(_Level(dims=tuple(d), axis=a,
                                      pad=bool(d[a] & 1)))
            d[a] = (d[a] + 1) // 2
            if st is not None:
                st = self._host_coarsen_strength(st, a)
        self.coarse_dims = tuple(d)
        self.coarsest_n = int(np.prod(d))

    @staticmethod
    def _host_strength(dims, trans):
        if trans is None:
            return None
        nx, ny, nz = dims
        nfx = (nx - 1) * ny * nz
        nfy = nx * (ny - 1) * nz
        t = np.abs(np.asarray(trans))
        return [t[nfx + nfy:].reshape(max(nz - 1, 0), ny, nx),
                t[nfx:nfx + nfy].reshape(nz, max(ny - 1, 0), nx),
                t[:nfx].reshape(nz, ny, max(nx - 1, 0))]

    @staticmethod
    def _host_coarsen_strength(st, a):
        """Mirror the value coarsening on the host strength arrays."""
        def pad_to(x, n):
            pads = [(0, 0)] * 3
            pads[a] = (0, n - x.shape[a])
            return np.pad(x, pads)

        m = st[a].shape[a] + 1
        m_even = m + (m & 1)
        out = []
        sl_odd = [slice(None)] * 3
        sl_odd[a] = slice(1, None, 2)
        for ax in range(3):
            s = st[ax]
            if ax == a:
                s = pad_to(s, m_even - 1)
                out.append(s[tuple(sl_odd)])
            else:
                s = pad_to(s, m_even)
                sh = list(s.shape)
                new = sh[:a] + [m_even // 2, 2] + sh[a + 1:]
                out.append(s.reshape(new).sum(axis=a + 1))
        return out

    # -- Galerkin value semicoarsening (plain, once per Newton) -----------
    @staticmethod
    def _coarsen_level(diag3, offs, a):
        diag_c = _pairsum(diag3, a)
        aL, aR = offs[a]
        if aL.shape[a] > 0:
            diag_c = diag_c + _take(aL, a, slice(0, None, 2)) \
                + _take(aR, a, slice(0, None, 2))
            aL_c = _take(aL, a, slice(1, None, 2))
            aR_c = _take(aR, a, slice(1, None, 2))
        else:
            aL_c, aR_c = aL, aR
        out = []
        for ax in range(3):
            if ax == a:
                out.append((aL_c, aR_c))
            else:
                bL, bR = offs[ax]
                out.append((_pairsum(bL, a), _pairsum(bR, a)))
        return diag_c, tuple(out)

    @staticmethod
    def _pad_level(diag3, offs, a):
        return (_pad_axis(diag3, a, 1),
                tuple((_pad_axis(bL, a, 1), _pad_axis(bR, a, 1))
                      for bL, bR in offs))

    def coarsen_values(self, diag0, off0, *, twin=False):
        """diag0 (nc,), off0 (2 nf,) = [a_LR | a_RL] in grid face order.
        Returns per-level (diag3, offs), contiguous, then the float32
        inverse of the dense coarsest matrix (plain torch on every device;
        ``twin`` is accepted for the AMG's interface)."""
        nz, ny, nx = self.dims
        nfx = (nx - 1) * ny * nz
        nfy = nx * (ny - 1) * nz
        nf = nfx + nfy + nx * ny * (nz - 1)
        aLf, aRf = off0[:nf], off0[nf:]

        def split(v):
            return (v[nfx + nfy:].reshape(max(nz - 1, 0), ny, nx),
                    v[nfx:nfx + nfy].reshape(nz, max(ny - 1, 0), nx),
                    v[:nfx].reshape(nz, ny, max(nx - 1, 0)))

        aLz, aLy, aLx = split(aLf)
        aRz, aRy, aRx = split(aRf)
        diag3 = diag0.reshape(nz, ny, nx)
        offs = ((aLz, aRz), (aLy, aRy), (aLx, aRx))
        vals = []
        for lv in self.levels:
            if lv.pad:
                diag3, offs = self._pad_level(diag3, offs, lv.axis)
            diag3 = diag3.contiguous()
            offs = tuple((aL.contiguous(), aR.contiguous())
                         for aL, aR in offs)
            vals.append((diag3, offs))
            diag3, offs = self._coarsen_level(diag3, offs, lv.axis)
        vals.append(self.invert_coarsest(self._dense_coarsest(diag3, offs)))
        return vals

    @staticmethod
    def invert_coarsest(A):
        """float32 inverse of the dense coarsest matrix (see module
        docstring)."""
        return torch.linalg.inv(A.to(torch.float32))

    @staticmethod
    def _dense_coarsest(diag3, offs):
        cz, cy, cx = diag3.shape
        n = cz * cy * cx
        dev = diag3.device
        idx = torch.arange(n, device=dev).reshape(cz, cy, cx)
        A = torch.zeros((n, n), dtype=diag3.dtype, device=dev)
        ar = torch.arange(n, device=dev)
        A[ar, ar] = diag3.reshape(-1)
        for ax in range(3):
            aL, aR = offs[ax]
            if aL.shape[ax] == 0:
                continue
            lo = _take(idx, ax, slice(None, -1)).reshape(-1)
            hi = _take(idx, ax, slice(1, None)).reshape(-1)
            A.index_put_((lo, hi), aL.reshape(-1), accumulate=True)
            A.index_put_((hi, lo), aR.reshape(-1), accumulate=True)
        # regularize all-ghost rows (from odd-dim padding)
        d = torch.abs(torch.diagonal(A))
        return A + torch.diag(torch.where(d > 1e-300, 0.0, 1.0)
                              .to(A.dtype))

    # -- the V-cycle (pre = post = 1, one cycle) ---------------------------
    def _coarsest(self, Ainv, b3):
        x = Ainv @ b3.reshape(-1).to(torch.float32)
        return x.to(b3.dtype).reshape(b3.shape)

    def _vcycle3(self, vals, b3, level, ops):
        if level == len(self.levels):
            return self._coarsest(vals[-1], b3)
        sm, rs, ps = ops
        lv = self.levels[level]
        diag3, offs = vals[level]
        x3 = sm(diag3, offs, None, b3)
        nxt = self.levels[level + 1] \
            if level + 1 < len(self.levels) else None
        pad_axis = nxt.axis if nxt is not None and nxt.pad else -1
        bc = rs(diag3, offs, x3, b3, lv.axis, pad_axis)
        e_c = self._vcycle3(vals, bc, level + 1, ops)
        return ps(diag3, offs, x3, e_c, lv.axis, b3)

    def vcycle(self, vals, b, *, twin=False):
        """One V-cycle on b (nc,); ``twin``: the level operations by K7's
        plain twins on any device (the card's whole-solve comparison)."""
        ops = ((smooth_plain, restrict_plain, prolong_smooth_plain) if twin
               else (smooth, restrict, prolong_smooth))
        nz, ny, nx = self.dims
        b3 = b.reshape(nz, ny, nx)
        if not self.levels:
            return self._coarsest(vals[-1], b3).reshape(-1)
        lv0 = self.levels[0]
        if lv0.pad:
            b3 = _pad_axis(b3, lv0.axis, 1)
        x3 = self._vcycle3(vals, b3.contiguous(), 0, ops)
        if lv0.pad:
            x3 = _take(x3, lv0.axis, slice(None, -1))
        return x3.reshape(-1)
