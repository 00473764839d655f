"""Structured geometric multigrid for the CPR pressure system.

Port of the JAX package's linalg/gmg.py (``StructuredGmg``). On a
fully-active cartesian grid the TPFA pressure operator is a 7-point
stencil; levels semicoarsen by 2 along one axis (the strongest coupling
first, chosen once on the host from the transmissibilities), Galerkin
values coarsen by pair sums (once per Newton), an odd axis gets one ghost
slab (diagonal 0, couplings 0), and the coarsest level (at most
``coarsest`` cells) is solved by a precomputed dense inverse.

The inverse is float32 and applied in float32 on every backend, as the
reference does (``jnp.linalg.inv(A.astype(float32))``): a known reference
caveat (ROADMAP Queue 3), kept so the linear iteration counts match.

Kernel K7 (``csrc/gmg.cu``) is the level work of the V-cycle in two
cooperative launches around the float32 coarsest product: the down leg
(per level the pair-summed residual of the zero-start damped-Jacobi sweep,
omega = 0.8, the next level's right-hand side; in its right-hand side
entry, which the CPR apply calls, first level 0's right-hand side, the
weighted pressure residual of K6's ``pressure_rhs``, into the workspace,
and a grid barrier) and the up leg (per level
the replicated coarse correction plus that sweep, then one sweep). The
pre-smoothed iterate is evaluated from the level's right-hand side where
it is needed, never stored. The per-level plain twins below follow the
reference's slice arithmetic; ``vcycle_down_plain`` and
``vcycle_up_plain`` compose them in the kernel's order (the CPU path), and
their per-level composition ``vcycle(..., twin=True)`` is the oracle.
Arrays stay in their padded level shape through the cycle; a ghost slab
has zero couplings, so it never reaches a real cell.

The per-Newton value coarsening is K7's refresh (``opm_gmg_refresh``):
one cooperative launch, a phase per level and the last one the float32
dense coarsest matrix, into buffers the hierarchy owns (``Refresh``, made
once per device with the V-cycle workspace over them); the inverse is one
library call (``torch.linalg.inv_ex``, no host sync). Its values are
valid until the next refresh of the same hierarchy. ``compose`` is the
per-level composition (the CPU path, the oracle, ``refresh_plain``).
"""

from __future__ import annotations

import ctypes
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
# K7: the V-cycle's two legs on the card (csrc/gmg.cu)

_P, _I, _L = cuda_lib.P, cuda_lib.I, cuda_lib.L
_SIGS = {
    "opm_gmg_grid": [_L, _L, _P],
    "opm_gmg_down": [_P, _I, _I, _I, _P, _P, _I, _P],
    "opm_gmg_down_rhs": [_P, _I, _P, _P, _P, _L, _P, _I, _P],
    "opm_gmg_up": [_P, _I, _I, _I, _P, _P, _P, _I, _P],
    "opm_gmg_refresh_grid": [_L, _P],
    "opm_gmg_refresh": [_P, _I, _P, _P, _P, _I, _P],
}
_grids: dict = {}


def pressure_rhs_plain(w, r):
    """The CPR apply's weighted pressure residual rp = sum_i w_i r_i (nc,)
    (K6's ``pressure_rhs``; the V-cycles' right-hand side entries form it
    in their down legs)."""
    return (w[0] * r[0] + w[1] * r[1]) + w[2] * r[2]


def check_weighted(ws, w, rc, n):
    """w and rc: contiguous float64 (3, n) tensors on the workspace's
    device."""
    for t in (w, rc):
        if (t.dtype != torch.float64 or t.device != ws.device
                or not t.is_contiguous() or tuple(t.shape) != (3, n)):
            raise ValueError("the weighted right-hand side needs contiguous "
                             f"float64 (3, {n}) w and r on {ws.device}")


class LevelValues(list):
    """``coarsen_values``' result: per level its values, then the coarsest
    float32 inverse; ``ws`` holds the card's V-cycle workspace of these
    values once a V-cycle has run on them."""

    ws = None


def leg_grids(name, sigs, device, work_down, work_up):
    """(G_down, G_up, info) of the V-cycle legs of csrc/<name>.cu (K7's or
    K10's) whose largest level has ``work_down`` and ``work_up`` outputs,
    on a CUDA device: the fixed grid of each leg and the occupancy query
    behind it (SMs, blocks per SM and registers per thread of each leg)."""
    key = (name, torch.device(device).index, work_down, work_up)
    if key not in _grids:
        lib = cuda_lib.load(name, sigs)
        out = (ctypes.c_int * 7)()
        with torch.cuda.device(device):
            cuda_lib.check(getattr(lib, f"opm_{name}_grid")(
                work_down, work_up, out), f"opm_{name}_grid")
        _grids[key] = (out[0], out[1], dict(
            sms=out[2], blocks_per_sm=dict(down=out[3], up=out[4]),
            registers=dict(down=out[5], up=out[6])))
    return _grids[key]


class Workspace:
    """K7's state for one set of level values on the card: per level l >= 1
    its right-hand side ``b[l]`` and correction ``e[l]`` (the ghost-padded
    level shape), level 0's right-hand side ``b0`` (nc,) where the
    right-hand side entry forms it, the coarsest right-hand side ``bc``
    and correction ``ec`` (float32, flat), the V-cycle's output ``out``
    (nc,), the table of
    level records on the device (csrc/gmg.cu ``LevelRec``: 16 eight-byte
    fields each, the coarsest dims last) and both legs' grids. The level
    values are checked once, here; nothing is allocated per V-cycle, and
    ``out`` is overwritten by the next V-cycle on these values."""

    def __init__(self, gmg, vals):
        Ainv = vals[-1]
        dev = Ainv.device
        n_c = gmg.coarsest_n
        if Ainv.dtype != torch.float32 or tuple(Ainv.shape) != (n_c, n_c):
            raise ValueError("K7: the coarsest inverse must be a "
                             f"float32 ({n_c}, {n_c}) tensor")
        self.device, self.nc, self.L = dev, gmg.nc, len(gmg.levels)
        f64 = dict(dtype=torch.float64, device=dev)
        recs = []
        self.b, self.e = [None], [None]
        for l, lv in enumerate(gmg.levels):
            d3, offs = vals[l]
            shape = gmg.level_shape(lv)
            _check_level(d3, offs, shape, dev)
            if l > 0:
                self.b.append(torch.empty(shape, **f64))
                self.e.append(torch.empty(shape, **f64))
            real = list(gmg.dims) if l == 0 else shape
            recs.append([d3.data_ptr()]
                        + [offs[a][0].data_ptr() for a in range(3)]
                        + [offs[a][1].data_ptr() for a in range(3)]
                        + [0 if l == 0 else self.b[l].data_ptr(),
                           0 if l == 0 else self.e[l].data_ptr()]
                        + shape + [lv.axis] + real)
        cd = list(gmg.coarse_dims)
        recs.append([0] * 9 + cd + [0] + cd)
        self.table = torch.tensor(recs, dtype=torch.int64).reshape(-1).to(dev)
        self.bc = torch.empty(n_c, dtype=torch.float32, device=dev)
        self.ec = torch.empty_like(self.bc)
        self.out = torch.empty(gmg.nc, **f64)
        self.b0 = torch.empty(gmg.nc, **f64)
        self.vals = list(vals)          # the table's arrays stay alive
        # the down leg's work per level: the next level's cells; the up
        # leg's: the level's (level 0's real cells)
        nxt = [int(np.prod(r[9:12])) for r in recs]
        own = [int(np.prod(r[13:16])) for r in recs]
        self.grid_down, self.grid_up, self.info = leg_grids(
            "gmg", _SIGS, dev, max(nxt[1:] or nxt), max(own[:-1] or own))
        self.lib = cuda_lib.load("gmg", _SIGS)


def _check_level(d3, offs, shape, dev):
    for t in [d3] + [a for pair in offs for a in pair]:
        if (t.dtype != torch.float64 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError("K7: level arrays must be contiguous float64 "
                             f"tensors on {dev}")
    if list(d3.shape) != shape:
        raise ValueError(f"K7: a level's diagonal must be {tuple(shape)}")
    for ax, (aL, aR) in enumerate(offs):
        want = list(shape)
        want[ax] = max(want[ax] - 1, 0)
        if list(aL.shape) != want or list(aR.shape) != want:
            raise ValueError("K7: face arrays must be one shorter than the "
                             "level along their axis")


def _check_rhs(ws, b):
    if (b.dtype != torch.float64 or b.device != ws.device
            or not b.is_contiguous() or tuple(b.shape) != (ws.nc,)):
        raise ValueError(f"K7: the right-hand side must be a contiguous "
                         f"float64 ({ws.nc},) tensor on {ws.device}")


def vcycle_down_cuda(ws, b, levels=None):
    """K7's down leg on the card: the workspace's b[l] (l >= 1) and bc from
    the right-hand side b (nc,); ``levels`` = (lo, hi) runs only those
    levels (a measurement of their share). Returns bc."""
    lo, hi = levels or (0, ws.L)
    _check_rhs(ws, b)
    cuda_lib.check(ws.lib.opm_gmg_down(
        ws.table.data_ptr(), ws.L, lo, hi, b.data_ptr(), ws.bc.data_ptr(),
        ws.grid_down, cuda_lib.stream_ptr(ws.device)), "opm_gmg_down")
    vcycle_down_cuda.launches += 1
    return ws.bc


def vcycle_up_cuda(ws, b, levels=None):
    """K7's up leg on the card: the workspace's e[l] (l >= 1) and the
    V-cycle's result ``out`` (returned) from ec and the right-hand sides
    (b, the level-0 one, and the workspace's b[l])."""
    lo, hi = levels or (0, ws.L)
    _check_rhs(ws, b)
    cuda_lib.check(ws.lib.opm_gmg_up(
        ws.table.data_ptr(), ws.L, lo, hi, b.data_ptr(), ws.ec.data_ptr(),
        ws.out.data_ptr(), ws.grid_up, cuda_lib.stream_ptr(ws.device)),
        "opm_gmg_up")
    vcycle_up_cuda.launches += 1
    return ws.out


def vcycle_down_rhs_cuda(ws, w, rc):
    """K7's down leg from the CPR apply's weights and cell residual (w, rc
    (3, nc)): level 0's right-hand side, (w0 r0 + w1 r1) + w2 r2, into the
    workspace's b0 first, then the whole leg. Returns bc."""
    check_weighted(ws, w, rc, ws.nc)
    cuda_lib.check(ws.lib.opm_gmg_down_rhs(
        ws.table.data_ptr(), ws.L, w.data_ptr(), rc.data_ptr(),
        ws.b0.data_ptr(), ws.nc, ws.bc.data_ptr(), ws.grid_down,
        cuda_lib.stream_ptr(ws.device)), "opm_gmg_down_rhs")
    vcycle_down_rhs_cuda.launches += 1
    return ws.bc


vcycle_down_cuda.launches = 0
vcycle_up_cuda.launches = 0
vcycle_down_rhs_cuda.launches = 0


def coarsest_product(Ainv, bc, ec):
    """The coarsest solve between the card's legs: one float32
    matrix-vector product into ec (a library call, as the reference leaves
    the product to XLA)."""
    torch.mv(Ainv, bc, out=ec)
    coarsest_product.calls += 1
    return ec


coarsest_product.calls = 0


# ---------------------------------------------------------------------------
# K7: the per-Newton value refresh on the card (csrc/gmg.cu)

def _face_shape(shape, ax):
    """A level's face array along ``ax``: one shorter along it."""
    s = list(shape)
    s[ax] = max(s[ax] - 1, 0)
    return s


class CoarsestInverse:
    """The coarsest level's float32 dense matrix ``dense`` (n, n), zeroed
    once, its inverse ``inv`` (column-major, the layout torch.linalg.inv
    returns, so the coarsest product sums as on the per-level
    composition) and the inverse's int32 ``inv_info``, allocated once on
    one device; all three None where n is None (a coarsest level solved
    by sweeps). The base of K7's and K10's refresh buffers."""

    def __init__(self, n, device):
        self.dense = self.inv = self.inv_info = None
        if n is not None:
            self.dense = torch.zeros((n, n), dtype=torch.float32,
                                     device=device)
            self.inv = torch.empty_like(self.dense).mT
            self.inv_info = torch.empty((), dtype=torch.int32, device=device)

    def invert(self):
        """The float32 inverse of the dense matrix into its buffer, on the
        caller's stream and without a host sync (torch.linalg.inv_ex: a
        singular matrix gives non-finite values and a nonzero info, as
        the reference's jnp.linalg.inv gives no error)."""
        if self.dense is not None:
            torch.linalg.inv_ex(self.dense, out=(self.inv, self.inv_info))


class SetupOut:
    """The per-Newton CPR setup's outputs (K6, ``linalg/precond.py``) for
    one pressure hierarchy on one device, allocated once with its refresh's
    buffers: dinv (9, n), w (3, n), diag_p (n,) and off (m,), the level-0
    couplings in face order. Every setup of that hierarchy overwrites
    them: a setup's outputs are valid until the next one."""

    def __init__(self, n, m, device):
        f64 = dict(dtype=torch.float64, device=device)
        self.dinv = torch.empty((9, n), **f64)
        self.w = torch.empty((3, n), **f64)
        self.diag_p = torch.empty(n, **f64)
        self.off = torch.empty(m, **f64)

    def tensors(self):
        return self.dinv, self.w, self.diag_p, self.off


class Refresh(CoarsestInverse):
    """The value refresh's outputs for one hierarchy on one device,
    allocated and zeroed once (a padded level's ghost slabs are never
    written again): per level its padded diag3 and six face arrays, and
    the coarsest's dense matrix (only its diagonal and stencil positions
    are written), inverse and info (``CoarsestInverse``); ``vals`` the
    LevelValues over them, which the next refresh overwrites; the CPR
    setup's outputs over the stencil faces (``setup``, a ``SetupOut``). On
    a CUDA device also the V-cycle workspace over them (``vals.ws``) and
    the kernel's table (csrc/gmg.cu ``PhaseRec``, one per phase), uploaded
    here once, with its grid and each phase's outputs ``work``."""

    def __init__(self, gmg, device):
        dev = torch.device(device)
        f64 = dict(dtype=torch.float64, device=dev)
        self.gmg, self.nc = gmg, gmg.nc
        self.nf = sum(int(np.prod(_face_shape(gmg.dims, ax)))
                      for ax in range(3))
        self.vals = LevelValues()
        for lv in gmg.levels:
            shape = gmg.level_shape(lv)
            self.vals.append((torch.zeros(shape, **f64), tuple(
                (torch.zeros(_face_shape(shape, ax), **f64),
                 torch.zeros(_face_shape(shape, ax), **f64))
                for ax in range(3))))
        super().__init__(gmg.coarsest_n, dev)
        self.vals.append(self.inv)
        self.device = self.dense.device
        self.setup = SetupOut(self.nc, 2 * self.nf, dev)
        if dev.type == "cuda":
            self._bind(dev)

    def records(self):
        """The kernel's phase records (csrc/gmg.cu ``PhaseRec``: 24
        eight-byte fields each) over these buffers, and each phase's
        outputs."""
        g, L = self.gmg, len(self.gmg.levels)

        def ptrs(level):
            if level is None:
                return [0] * 7
            d3, offs = level
            return ([d3.data_ptr()] + [o[0].data_ptr() for o in offs]
                    + [o[1].data_ptr() for o in offs])

        recs, work = [], []
        for p in range(L + 1):
            src = list(g.dims) if p == 0 else g.level_shape(g.levels[p - 1])
            # the real outputs: the level's dims (level 0's: the grid's)
            real = list(g.levels[p].dims if p < L else g.coarse_dims)
            dst = g.level_shape(g.levels[p]) if p < L else real
            recs.append(ptrs(None if p == 0 else self.vals[p - 1])
                        + ptrs(self.vals[p] if p < L else None)
                        + src + [-1 if p == 0 else g.levels[p - 1].axis]
                        + dst + real)
            work.append(int(np.prod(real)) + sum(
                int(np.prod(_face_shape(real, ax))) for ax in range(3)))
        return recs, work

    def _bind(self, dev):
        """The card's part: the kernel's table and grid, and the V-cycle
        workspace over the buffers."""
        recs, work = self.records()
        self.table = torch.tensor(recs, dtype=torch.int64).reshape(-1).to(dev)
        self.lib = cuda_lib.load("gmg", _SIGS)
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            cuda_lib.check(self.lib.opm_gmg_refresh_grid(max(work), out),
                           "opm_gmg_refresh_grid")
        self.grid = out[0]
        self.grid_info = dict(sms=out[1], blocks_per_sm=out[2],
                              registers=out[3])
        self.work = work
        self.vals.ws = Workspace(self.gmg, self.vals)


def refresh_cuda(R, diag0, off0):
    """K7's per-Newton value refresh on the card, one launch into the
    buffers of ``R`` (the hierarchy's ``Refresh``): every level's values
    and the float32 dense coarsest matrix from the pressure system's diag0
    (nc,) and off0 (2 nf,) = [a_LR | a_RL] in grid face order, on the
    current stream. Returns ``R.vals``, whose inverse is not formed
    here."""
    for t, n in ((diag0, R.nc), (off0, 2 * R.nf)):
        if (t.dtype != torch.float64 or not t.is_contiguous()
                or t.device != R.device or tuple(t.shape) != (n,)):
            raise ValueError("K7: the refresh needs contiguous float64 "
                             f"diag0 ({R.nc},) and off0 ({2 * R.nf},) on "
                             f"{R.device}")
    cuda_lib.check(R.lib.opm_gmg_refresh(
        R.table.data_ptr(), len(R.gmg.levels), diag0.data_ptr(),
        off0.data_ptr(), R.dense.data_ptr(), R.grid,
        cuda_lib.stream_ptr(R.device)), "opm_gmg_refresh")
    refresh_cuda.launches += 1
    return R.vals


refresh_cuda.launches = 0


def refresh_plain(R, diag0, off0):
    """The per-level composition (``coarsen_values(..., twin=True)``'s
    levels and dense coarsest matrix) copied into the buffers of ``R`` on
    any device; not the inverse. What the kernel is held to."""
    levels, A = R.gmg.compose(diag0.contiguous(), off0.contiguous())
    for (d3, offs), (bd, boffs) in zip(levels, R.vals):
        bd.copy_(d3)
        for (aL, aR), (bL, bR) in zip(offs, boffs):
            bL.copy_(aL)
            bR.copy_(aR)
    R.dense.copy_(A.to(torch.float32))


def refresh_bytes(gmg):
    """The bytes K7's value refresh must move on ``gmg``, each input read
    once and each output written once: the inputs diag0 and off0 (level
    0's real cells' diagonal and both couplings of each real face,
    float64), every level's values written (level 0's copy included), and
    the float32 dense coarsest matrix's written entries (its diagonal and
    two per face). A coarser level read back by the next phase is the
    kernel's choice, not the function's, and is not counted."""
    def entries(dims):
        return int(np.prod(dims)) + 2 * sum(
            int(np.prod(_face_shape(dims, ax))) for ax in range(3))

    return 8 * entries(gmg.dims) \
        + sum(8 * entries(lv.dims) for lv in gmg.levels) \
        + 4 * entries(gmg.coarse_dims)


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
        self._refreshes = {}

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

    def compose(self, diag0, off0):
        """The per-level composition of the value coarsening: diag0 (nc,),
        off0 (2 nf,) = [a_LR | a_RL] in grid face order. Returns (levels,
        A): per level (diag3, offs), contiguous and ghost-padded, and the
        float64 dense coarsest matrix."""
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
        levels = []
        for lv in self.levels:
            if lv.pad:
                diag3, offs = self._pad_level(diag3, offs, lv.axis)
            diag3 = diag3.contiguous()
            offs = tuple((aL.contiguous(), aR.contiguous())
                         for aL, aR in offs)
            levels.append((diag3, offs))
            diag3, offs = self._coarsen_level(diag3, offs, lv.axis)
        return levels, self._dense_coarsest(diag3, offs)

    def coarsen_values(self, diag0, off0, *, twin=False):
        """diag0 (nc,), off0 (2 nf,) = [a_LR | a_RL] in grid face order.
        Returns per level (diag3, offs), contiguous and ghost-padded, then
        the float32 inverse of the dense coarsest matrix. On the card K7's
        refresh into the hierarchy's buffers (one launch) and the inverse
        into its buffer (torch.linalg.inv_ex, no host sync): the same
        ``Refresh.vals`` every call, its workspace made once, valid until
        the next refresh of this hierarchy on that device (two alive at
        once alias). On the CPU, and with ``twin`` on any device, the
        per-level composition in fresh tensors (torch.linalg.inv: a
        singular coarsest matrix raises)."""
        diag0, off0 = diag0.contiguous(), off0.contiguous()
        if twin:
            return self._coarsen_levels(diag0, off0)
        return cuda_lib.dispatch(diag0, self._refresh, self._coarsen_levels,
                                 diag0, off0, what="K7 refresh")

    def _coarsen_levels(self, diag0, off0):
        levels, A = self.compose(diag0, off0)
        vals = LevelValues(levels)
        vals.append(self.invert_coarsest(A))
        return vals

    def refresh(self, device):
        """The hierarchy's ``Refresh`` on ``device``, made on first use."""
        dev = torch.device(device)
        if dev not in self._refreshes:
            self._refreshes[dev] = Refresh(self, dev)
        return self._refreshes[dev]

    def setup_out(self, device):
        """The CPR setup's outputs on ``device`` (its ``Refresh``'s
        ``SetupOut``, made on first use)."""
        return self.refresh(device).setup

    def _refresh(self, diag0, off0):
        R = self.refresh(diag0.device)
        refresh_cuda(R, diag0, off0)
        R.invert()
        return R.vals

    def level_shape(self, lv):
        """A level's array shape: its dims, one ghost slab more along its
        axis when that is odd."""
        shape = list(lv.dims)
        shape[lv.axis] += int(lv.pad)
        return shape

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
    def _pad_axis_after(self, level):
        """The next level's ghost-slab axis after ``level`` (-1: none)."""
        nxt = self.levels[level + 1] \
            if level + 1 < len(self.levels) else None
        return nxt.axis if nxt is not None and nxt.pad else -1

    def _level0_rhs(self, b):
        b3 = b.reshape(self.dims)
        if self.levels and self.levels[0].pad:
            b3 = _pad_axis(b3, self.levels[0].axis, 1)
        return b3.contiguous()

    def _vcycle3(self, vals, b3, level):
        """The per-level composition of the plain twins (the oracle)."""
        if level == len(self.levels):
            x = vals[-1] @ b3.reshape(-1).to(torch.float32)
            return x.to(b3.dtype).reshape(b3.shape)
        lv = self.levels[level]
        diag3, offs = vals[level]
        x3 = smooth_plain(diag3, offs, None, b3)
        bc = restrict_plain(diag3, offs, x3, b3, lv.axis,
                            self._pad_axis_after(level))
        e_c = self._vcycle3(vals, bc, level + 1)
        return prolong_smooth_plain(diag3, offs, x3, e_c, lv.axis, b3)

    def vcycle_down_plain(self, vals, b):
        """K7's down leg, plain, in the kernel's order: per level the
        zero-start sweep and the pair-summed residual, the next level's
        right-hand side. Returns (bs, bc): bs[l] level l's (ghost-padded)
        right-hand side for l < L, bc the coarsest one, flat, in float32."""
        bs = [self._level0_rhs(b)]
        for l, lv in enumerate(self.levels):
            diag3, offs = vals[l]
            x3 = smooth_plain(diag3, offs, None, bs[l])
            bs.append(restrict_plain(diag3, offs, x3, bs[l], lv.axis,
                                     self._pad_axis_after(l)))
        return bs[:-1], bs[-1].reshape(-1).to(torch.float32)

    def vcycle_up_plain(self, vals, bs, ec):
        """K7's up leg, plain, in the kernel's order: from the coarsest
        correction ec (float32, flat), per level l = L-1 .. 0 the zero-start
        sweep of bs[l] again, plus the replicated coarse correction, then
        one sweep. Returns (x, es): the V-cycle's result (nc,) and es[l]
        level l's (ghost-padded) correction."""
        e = ec.to(torch.float64).reshape(self.coarse_dims)
        es = [None] * len(self.levels)
        for l in reversed(range(len(self.levels))):
            lv = self.levels[l]
            diag3, offs = vals[l]
            x3 = smooth_plain(diag3, offs, None, bs[l])
            e = es[l] = prolong_smooth_plain(diag3, offs, x3, e, lv.axis,
                                             bs[l])
        if self.levels and self.levels[0].pad:
            e = _take(e, self.levels[0].axis, slice(None, -1))
        return e.reshape(-1), es

    def _vcycle_legs_plain(self, vals, b):
        bs, bc = self.vcycle_down_plain(vals, b)
        return self.vcycle_up_plain(vals, bs, vals[-1] @ bc)[0]

    def workspace(self, vals):
        """The card's V-cycle workspace of ``vals`` (made on first use)."""
        if vals.ws is None:
            vals.ws = Workspace(self, vals)
        return vals.ws

    def _vcycle_cuda(self, vals, b, w=None, rc=None):
        ws = self.workspace(vals)
        if w is None:
            vcycle_down_cuda(ws, b)
        else:
            vcycle_down_rhs_cuda(ws, w, rc)
            b = ws.b0
        coarsest_product(vals[-1], ws.bc, ws.ec)
        return vcycle_up_cuda(ws, b)

    def vcycle(self, vals, b, *, w=None, rc=None, twin=False):
        """One V-cycle on b (nc,), or with ``w`` and ``rc`` (3, nc) on the
        CPR apply's weighted residual b = (w0 rc0 + w1 rc1) + w2 rc2: on the
        card K7's two legs around the float32 coarsest product (the down
        leg's right-hand side entry forms b itself; the result is the
        workspace's ``out``, valid until the next V-cycle on ``vals``), on
        the CPU their plain versions; ``twin``: the per-level composition
        of the plain twins on any device (the card's oracle)."""
        if w is not None:
            if not twin and w.device.type == "cuda":
                return self._vcycle_cuda(vals, None, w, rc)
            b = pressure_rhs_plain(w, rc)
        b = b.contiguous()
        if twin:
            x3 = self._vcycle3(vals, self._level0_rhs(b), 0)
            if self.levels and self.levels[0].pad:
                x3 = _take(x3, self.levels[0].axis, slice(None, -1))
            return x3.reshape(-1)
        return cuda_lib.dispatch(b, self._vcycle_cuda,
                                 self._vcycle_legs_plain, vals, b,
                                 what="K7 V-cycle")
