"""Aggregation AMG for the CPR pressure system of grids with a face list.

Port of the JAX package's linalg/amg.py. The hierarchy (pairwise
aggregates from the static transmissibility graph, the coarse sparsity
patterns and the merge maps) is built once per grid on the host, call for
call as the reference builds it, so the aggregates are the reference's.
Per Newton only the matrix values are refreshed on the card (Galerkin
products of piecewise-constant aggregation collapse to entry merges),
each level's in ELL layout, one (K, n) value array per level with K the
level's widest row (9 at level 0 of the Norne-class gather grid, up to 26
below; padding slots are self-loops whose values stay 0), then the
float32 inverse of the dense coarsest matrix.

The refresh is kernel K10's ``opm_amg_refresh`` (``csrc/amg.cu``): one
cooperative launch, a phase per coarsening step, writing every level's
values and the float32 dense coarsest matrix into buffers the hierarchy
owns (``Refresh``, made once with the V-cycle workspace over them); the
inverse is one library call. Its values are valid until the next refresh
of the same hierarchy.

The V-cycle (the reference's CPU settings: one cycle, one pre- and one
post-smoothing damped-Jacobi sweep with omega = 0.8) is K10 too, the
repository's former Pallas ``ell_spmv`` and ``jacobi_sweep``, in two
cooperative launches: the down leg (per level the zero-start sweep into
the workspace, then its residual restricted by aggregate; in its
right-hand side entry, which the CPR apply calls, level 0's right-hand
side is the weighted pressure residual of K6's ``pressure_rhs``, formed by
each cell's thread of the first phase and written to the workspace) and
the up leg (per level the prolongation by gather plus that sweep, then the
post-smoothing sweep). The coarsest level (at most 256 cells) is solved
between them by its float32 dense inverse, applied as one matmul, as the
reference does on every backend; a larger coarsest level gets 1 + 10
sweeps at the end of the down leg.
Each kernel has its plain twins here, in the reference's order of
operations: the per-level ones (their composition ``vcycle(...,
twin=True)`` and ``coarsen_values(..., twin=True)`` is the oracle and the
CPU path of the refresh) and those composed from them (the legs' CPU
path, the refresh's plain version).

Every sum of a kernel is a gather over a CSR built once on the host in the
order the reference's segment sums run (children by fine index, entries by
entry index): one thread per output, no atomics.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from opm_tpu_torch.linalg.gmg import (CoarsestInverse, LevelValues,
                                     SetupOut, check_weighted,
                                     coarsest_product, leg_grids,
                                     pressure_rhs_plain)
from opm_tpu_torch.utils import cuda_lib

OMEGA = 0.8
DENSE_COARSEST = 256     # coarsest levels up to this size are inverted


# ---------------------------------------------------------------------------
# host structure (numpy; the reference's functions, call for call)

def pack_ell(n, rows, cols):
    """Static ELL structure for directed entries (rows -> cols): per-row
    column ids padded with self-loops (their value slots stay 0). Returns
    (cols_ell (K, n) int32, slot (nnz,) int64 flat index into (K, n))."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    nnz = len(rows)
    deg = np.bincount(rows, minlength=n) if nnz else np.zeros(n, int)
    K = max(int(deg.max()) if nnz else 0, 1)
    cols_ell = np.tile(np.arange(n, dtype=np.int64)[None, :], (K, 1))
    slot = np.empty(nnz, dtype=np.int64)
    if nnz:
        order = np.argsort(rows, kind="stable")
        sr = rows[order]
        starts = np.zeros(nnz, dtype=np.int64)
        newgrp = np.nonzero(np.diff(sr))[0] + 1
        starts[newgrp] = newgrp
        starts = np.maximum.accumulate(starts)
        k_in_row = np.arange(nnz, dtype=np.int64) - starts
        slot[order] = k_in_row * n + sr
        cols_ell[k_in_row, sr] = cols[order]
    return cols_ell.astype(np.int32), slot


@dataclass
class AmgLevel:
    """Static (host-built) structure for one coarsening step k -> k+1."""

    n_fine: int
    n_coarse: int
    agg: np.ndarray            # (n_fine,) aggregate id of each fine cell
    off_to_coarse: np.ndarray  # (nnz_fine,) coarse off-entry id or -1
    off_diag_row: np.ndarray   # (nnz_fine,) coarse diag row for folded, or 0
    off_is_diag: np.ndarray    # (nnz_fine,) bool
    rows_c: np.ndarray         # (nnz_coarse,)
    cols_c: np.ndarray


@dataclass
class AmgHierarchy:
    nc: int
    rows0: np.ndarray          # level-0 directed entries
    cols0: np.ndarray
    levels: List[AmgLevel]
    coarsest_n: int

    def device(self, device) -> "DeviceAmg":
        """Upload the static index arrays once, with the ELL layout of
        every level and the gather CSRs of the kernels."""
        return DeviceAmg(self, device)


def _pairwise_aggregate(n, rows, cols, weights):
    """Greedy heavy-edge matching: each cell pairs with its strongest
    unmatched neighbor (the core of pairwise-aggregation AMG)."""
    order = np.argsort(-np.abs(weights))
    agg = np.full(n, -1, dtype=np.int64)
    next_id = 0
    for e in order:
        i, j = rows[e], cols[e]
        if agg[i] < 0 and agg[j] < 0:
            agg[i] = agg[j] = next_id
            next_id += 1
    # attach singletons to the strongest already-aggregated neighbor
    best = {}
    for e in order:
        i, j = rows[e], cols[e]
        if agg[i] < 0 and agg[j] >= 0 and i not in best:
            best[i] = agg[j]
        if agg[j] < 0 and agg[i] >= 0 and j not in best:
            best[j] = agg[i]
    for i in range(n):
        if agg[i] < 0:
            if i in best:
                agg[i] = best[i]
            else:
                agg[i] = next_id
                next_id += 1
    return agg, next_id


def build_hierarchy(nc, face_cells, trans, *, coarsest=128,
                    max_levels=12) -> AmgHierarchy:
    """Host-side setup from the static TPFA graph (transmissibilities as the
    strength-of-connection measure)."""
    c1 = face_cells[:, 0].astype(np.int64)
    c2 = face_cells[:, 1].astype(np.int64)
    rows0 = np.concatenate([c1, c2])
    cols0 = np.concatenate([c2, c1])
    w0 = np.concatenate([trans, trans])

    levels: List[AmgLevel] = []
    n = nc
    rows, cols, w = rows0, cols0, w0
    while n > coarsest and len(levels) < max_levels:
        agg, n_c = _pairwise_aggregate(n, rows, cols, w)
        if n_c >= n:  # no coarsening progress
            break
        ra = agg[rows]
        ca = agg[cols]
        is_diag = ra == ca
        keys = ra * n_c + ca
        off_keys = keys[~is_diag]
        uniq, inv = np.unique(off_keys, return_inverse=True)
        off_to_coarse = np.full(len(rows), -1, dtype=np.int64)
        off_to_coarse[~is_diag] = inv
        rows_c = (uniq // n_c).astype(np.int64)
        cols_c = (uniq % n_c).astype(np.int64)
        levels.append(AmgLevel(
            n_fine=n, n_coarse=n_c, agg=agg,
            off_to_coarse=off_to_coarse,
            off_diag_row=np.where(is_diag, ra, 0),
            off_is_diag=is_diag, rows_c=rows_c, cols_c=cols_c))
        # coarse weights for next-level aggregation
        w_c = np.zeros(len(uniq))
        np.add.at(w_c, inv, np.abs(w[~is_diag]))
        rows, cols, w = rows_c, cols_c, w_c
        n = n_c
    return AmgHierarchy(nc=nc, rows0=rows0, cols0=cols0, levels=levels,
                        coarsest_n=n)


def _at(slot, entries):
    """The entries' positions in their level's values: the entry index
    itself at level 0 (``slot`` None: face order), its ELL slot below."""
    return entries if slot is None else slot[entries]


def csr_by(keys, n):
    """(ptr (n+1,), idx): the positions of ``keys`` grouped by key value,
    each group in ascending position (the order of a sequential segment
    sum)."""
    keys = np.asarray(keys, dtype=np.int64)
    idx = np.argsort(keys, kind="stable")
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(keys, minlength=n), out=ptr[1:])
    return ptr, idx


# ---------------------------------------------------------------------------
# K10 plain twins (the reference's jnp forms, in its order of operations)

def _ell_sum(vals, xg):
    """sum_k vals[k] * xg[k], accumulated k = 0, 1, ... (the kernel's
    order)."""
    acc = vals[0] * xg[0]
    for k in range(1, vals.shape[0]):
        acc = acc + vals[k] * xg[k]
    return acc


def ell_spmv_plain(diag, x, vals, cols):
    """y = diag x + sum_k vals[k] x[cols[k]] (the reference's ell_spmv)."""
    return diag * x + _ell_sum(vals, x[cols])


def sweep_plain(diag, vals, cols, x, b):
    """Damped Jacobi x + omega (b - A x) / diag with the |diag| > 1e-300
    guard; x None is the zero iterate (the reference's jacobi_sweep)."""
    if x is None:
        x = torch.zeros_like(b)
    y = ell_spmv_plain(diag, x, vals, cols)
    safe = torch.where(torch.abs(diag) > 1e-300, diag, 1.0)
    return x + OMEGA * (b - y) / safe


def restrict_plain(diag, vals, cols, x, b, agg, n_c):
    """r_c = segment_sum(b - A x, agg)."""
    r = b - ell_spmv_plain(diag, x, vals, cols)
    return torch.zeros(n_c, dtype=r.dtype, device=r.device) \
        .index_add_(0, agg, r)


def prolong_sweep_plain(diag, vals, cols, x, e_c, agg, b):
    """The post-smoothing sweep of x + e_c[agg]."""
    return sweep_plain(diag, vals, cols, x + e_c[agg], b)


def coarsen_plain(diag, off, lv):
    """(diag_c, off_c): Galerkin values of one coarsening step (the
    reference's segment sums)."""
    n_c = lv["n_coarse"]
    diag_c = torch.zeros(n_c, dtype=diag.dtype, device=diag.device) \
        .index_add_(0, lv["agg"], diag)
    folded = torch.where(lv["off_is_diag"], off, 0.0)
    diag_c = diag_c + torch.zeros_like(diag_c).index_add_(
        0, lv["off_diag_row"], folded)
    idx = torch.where(lv["off_is_diag"], 0, lv["off_to_coarse"])
    kept = torch.where(lv["off_is_diag"], 0.0, off)
    off_c = torch.zeros(lv["nnz_coarse"], dtype=off.dtype,
                        device=off.device).index_add_(0, idx, kept)
    return diag_c, off_c


def ell_pack_plain(off, ell):
    """The (K, n) ELL value array of entry values ``off``."""
    K, n = ell["cols"].shape
    return torch.zeros(K * n, dtype=off.dtype, device=off.device) \
        .index_put_((ell["slot"],), off).reshape(K, n)


def dense_coarsest(diag, ell_vals, cols):
    """The dense (n, n) matrix of one level's diag and ELL values (the
    reference's: the diagonal set, then every slot added at (row, column)
    in float64)."""
    K, n = cols.shape
    ar = torch.arange(n, device=diag.device)
    A = torch.zeros((n, n), dtype=diag.dtype, device=diag.device)
    A[ar, ar] = diag
    return A.index_put_((ar.repeat(K), cols.reshape(-1)),
                        ell_vals.reshape(-1), accumulate=True)


def _csr_sum(ptr, idx, v):
    """Per output t the sum of v[idx[e]] over e = ptr[t] .. ptr[t+1]-1, in
    that order (the kernel's ``csr_sum``; the +0.0 of an exhausted row
    changes no bit of a sum that starts from +0.0)."""
    ptr = ptr.long()
    lens = ptr[1:] - ptr[:-1]
    acc = torch.zeros(lens.numel(), dtype=v.dtype, device=v.device)
    idx = idx.long()
    for j in range(int(lens.max()) if lens.numel() else 0):
        has = lens > j
        acc = acc + torch.where(has, v[idx[torch.where(has, ptr[:-1] + j,
                                                       0)]], 0.0)
    return acc


def refresh_plain(R, diag0, off0):
    """K10's refresh in plain torch, the kernel's gathers in its order over
    the same composed maps, into the buffers of ``R`` (a ``Refresh``):
    every level's diag and ELL values (padding slots untouched) and the
    float32 dense coarsest matrix; not the inverse. Equals the per-level
    composition (``coarsen_values(..., twin=True)``) bit for bit where
    index_add_ adds in index order, as on the CPU."""
    amg = R.amg
    R.diag[0].copy_(diag0)
    src = amg.ell[0]["src"].long()
    has = src >= 0
    R.ell[0].view(-1)[has] = off0[src[has]]
    for k, lv in enumerate(amg.levels):
        dv = diag0 if k == 0 else R.diag[k]
        ov = off0 if k == 0 else R.ell[k].view(-1)
        R.diag[k + 1].copy_(_csr_sum(lv["child_ptr"], lv["child_idx"], dv)
                            + _csr_sum(lv["fold_ptr"], lv["fold_pos"], ov))
        R.ell[k + 1].view(-1)[lv["ent_dst"].long()] = _csr_sum(
            lv["ent_ptr"], lv["ent_pos"], ov)
    if R.dense is not None:
        R.dense.copy_(dense_coarsest(R.diag[-1], R.ell[-1],
                                     amg.ell[-1]["cols"]))


# ---------------------------------------------------------------------------
# K10 CUDA wrappers (csrc/amg.cu)

_P, _I, _L = cuda_lib.P, cuda_lib.I, cuda_lib.L
_SIGS = {
    "opm_amg_grid": [_L, _L, _P],
    "opm_amg_down": [_P, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    "opm_amg_down_rhs": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P],
    "opm_amg_up": [_P, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    "opm_amg_refresh_grid": [_L, _I, _P],
    "opm_amg_refresh": [_P, _I, _P, _P, _I, _P],
    "opm_amg_refresh_setup": [_P, _I, _L, _L, _L, _L] + [_P] * 9 + [_I, _P],
}


def _f64(*ts):
    for t in ts:
        if t is not None and (t.dtype != torch.float64
                              or not t.is_contiguous()):
            raise ValueError("K10: vectors must be contiguous float64")


class Workspace:
    """K10's state for one set of level values on the card (the
    hierarchy's refreshed values: made once per hierarchy): per level
    0 < k < nL its right-hand side ``b[k]`` and correction ``e[k]`` (the
    coarsest's too, and a second sweep buffer, when it is not inverted),
    per level k < nL its pre-smoothed iterate ``x[k]``, the residuals'
    scratch ``r`` (n0,), level 0's right-hand side ``b0`` (n0,) where the
    right-hand side entry forms it, the float32
    coarsest right-hand side ``bc`` and correction ``ec`` when it is
    inverted, the V-cycle's output ``out`` (n0,), the table of level
    records on the device (csrc/amg.cu ``LevelRec``: 12 eight-byte fields
    each) and both legs' grids. The level values are checked once, here;
    nothing is allocated per V-cycle, and ``out`` is overwritten by the
    next V-cycle on these values."""

    def __init__(self, amg, vals):
        dev = vals[0][0].device
        nL = len(amg.levels)
        self.device, self.n0, self.nL = dev, amg.n0, nL
        self.dense = amg.coarsest_n <= DENSE_COARSEST
        f64 = dict(dtype=torch.float64, device=dev)
        self.b, self.e, self.x, recs = [], [], [], []
        for k in range(nL + 1):
            diag, ev = vals[k]
            ell = amg.ell[k]
            K, n = ell["cols"].shape
            _f64(diag, ev)
            if (diag.device != dev or ev.device != dev
                    or tuple(diag.shape) != (n,)
                    or tuple(ev.shape) != (K, n)):
                raise ValueError(f"K10: level {k}'s values must be (n,) and "
                                 f"(K, n) = ({K}, {n}) on {dev}")
            step = amg.levels[k] if k < nL else None
            sweeps = k == nL and not self.dense
            inner = 0 < k < nL
            self.b.append(torch.empty(n, **f64) if inner or sweeps and k
                          else None)
            self.e.append(torch.empty(n, **f64) if inner or sweeps
                          else None)
            self.x.append(torch.empty(n, **f64) if k < nL else None)
            if sweeps:
                self.s = torch.empty(n, **f64)
            recs.append([
                diag.data_ptr(), ev.data_ptr(), ell["cols32"].data_ptr()]
                + [step[f].data_ptr() if step else 0
                   for f in ("agg32", "child_ptr", "child_idx")]
                + [t.data_ptr() if t is not None else 0
                   for t in (self.b[k], self.e[k], self.x[k])]
                + [self.s.data_ptr() if sweeps else 0, n, K])
        if self.dense:
            Ainv, n_c = vals[-1], amg.coarsest_n
            if (Ainv.dtype != torch.float32
                    or tuple(Ainv.shape) != (n_c, n_c)):
                raise ValueError("K10: the coarsest inverse must be a "
                                 f"float32 ({n_c}, {n_c}) tensor")
            self.bc = torch.empty(n_c, dtype=torch.float32, device=dev)
            self.ec = torch.empty_like(self.bc)
        else:
            self.bc = self.ec = torch.empty(0, dtype=torch.float32,
                                            device=dev)
        self.table = torch.tensor(recs, dtype=torch.int64).reshape(-1).to(dev)
        self.out = torch.empty(amg.n0, **f64)
        self.r = torch.empty(amg.n0, **f64)     # the down leg's residuals
        self.b0 = torch.empty(amg.n0, **f64)
        self.vals = list(vals)          # the table's arrays stay alive
        sizes = [r[10] for r in recs]
        self.grid_down, self.grid_up, self.info = leg_grids(
            "amg", _SIGS, dev, max(sizes), max(sizes[:-1] or sizes))
        self.lib = cuda_lib.load("amg", _SIGS)


def _check_rhs(ws, b):
    if (b.dtype != torch.float64 or b.device != ws.device
            or not b.is_contiguous() or tuple(b.shape) != (ws.n0,)):
        raise ValueError(f"K10: the right-hand side must be a contiguous "
                         f"float64 ({ws.n0},) tensor on {ws.device}")


def vcycle_down_cuda(ws, b, levels=None):
    """K10's down leg on the card: the workspace's b[k] (k >= 1) and bc (or,
    when the coarsest is not inverted, its sweeps into e[nL]) from the
    right-hand side b (n0,); ``levels`` = (lo, hi) runs only those levels
    (a measurement of their share). Returns bc."""
    lo, hi = levels or (0, ws.nL)
    _check_rhs(ws, b)
    cuda_lib.check(ws.lib.opm_amg_down(
        ws.table.data_ptr(), ws.nL, int(ws.dense), lo, hi, b.data_ptr(),
        ws.r.data_ptr(), ws.bc.data_ptr(), ws.grid_down,
        cuda_lib.stream_ptr(ws.device)), "opm_amg_down")
    vcycle_down_cuda.launches += 1
    return ws.bc


def vcycle_up_cuda(ws, b, levels=None):
    """K10's up leg on the card: the workspace's e[k] (k >= 1) and the
    V-cycle's result ``out`` (returned) from the coarsest correction and
    the right-hand sides (b, the level-0 one, and the workspace's b[k])."""
    lo, hi = levels or (0, ws.nL)
    _check_rhs(ws, b)
    cuda_lib.check(ws.lib.opm_amg_up(
        ws.table.data_ptr(), ws.nL, int(ws.dense), lo, hi, b.data_ptr(),
        ws.ec.data_ptr(), ws.out.data_ptr(), ws.grid_up,
        cuda_lib.stream_ptr(ws.device)), "opm_amg_up")
    vcycle_up_cuda.launches += 1
    return ws.out


def vcycle_down_rhs_cuda(ws, w, rc):
    """K10's down leg from the CPR apply's weights and cell residual (w, rc
    (3, n0)): level 0's right-hand side, (w0 r0 + w1 r1) + w2 r2, formed
    by each cell's thread of the leg's first phase into the workspace's
    b0, then the whole leg. Returns bc."""
    check_weighted(ws, w, rc, ws.n0)
    cuda_lib.check(ws.lib.opm_amg_down_rhs(
        ws.table.data_ptr(), ws.nL, int(ws.dense), w.data_ptr(),
        rc.data_ptr(), ws.b0.data_ptr(), ws.r.data_ptr(), ws.bc.data_ptr(),
        ws.grid_down, cuda_lib.stream_ptr(ws.device)), "opm_amg_down_rhs")
    vcycle_down_rhs_cuda.launches += 1
    return ws.bc


vcycle_down_cuda.launches = 0
vcycle_up_cuda.launches = 0
vcycle_down_rhs_cuda.launches = 0


class Refresh(CoarsestInverse):
    """The per-Newton refresh's outputs for one hierarchy on one device,
    allocated once: per level its diag (n,) and ELL values (K, n) (zeroed
    once: the padding slots are never written), and where the coarsest is
    inverted its dense matrix, inverse and info (``CoarsestInverse``);
    ``vals`` the LevelValues over them (views that the
    next refresh overwrites); the CPR setup's outputs (``setup``, a
    ``SetupOut``: off over every face). On a CUDA device also the V-cycle
    workspace over them (``vals.ws``) and the kernel's table (csrc/amg.cu
    ``RefreshHead``, then one ``StepRec`` per coarsening step), uploaded
    here once, with its grids (``grid``; ``grid_setup``, of the launch
    with K6's setup as its first phases) and each phase's outputs
    ``work``."""

    def __init__(self, amg, device):
        dev = torch.device(device)
        f64 = dict(dtype=torch.float64, device=dev)
        self.amg, self.n0, self.nnz0 = amg, amg.n0, amg.nnz0
        self.nL = len(amg.levels)
        self.diag = [torch.empty(e["cols"].shape[1], **f64) for e in amg.ell]
        self.ell = [torch.zeros(tuple(e["cols"].shape), **f64)
                    for e in amg.ell]
        self.vals = LevelValues(zip(self.diag, self.ell))
        n_c = amg.coarsest_n
        super().__init__(n_c if n_c <= DENSE_COARSEST else None, dev)
        if self.dense is not None:
            self.vals.append(self.inv)
        self.device = self.diag[0].device
        self.setup = SetupOut(self.n0, self.nnz0, dev)
        if dev.type == "cuda":
            self._bind(dev)

    def _bind(self, dev):
        """The card's part: the kernel's table and grid, and the
        V-cycle workspace over the buffers."""
        amg = self.amg
        e0, ec = amg.ell[0], amg.ell[-1]
        K_c, n_c = ec["cols"].shape
        recs = [e0["src"].data_ptr(), self.diag[0].data_ptr(),
                self.ell[0].data_ptr(), self.diag[-1].data_ptr(),
                self.ell[-1].data_ptr(), ec["cols32"].data_ptr(),
                self.dense.data_ptr() if self.dense is not None else 0,
                self.n0, e0["cols"].numel(), n_c, K_c]
        work = [self.n0 + e0["cols"].numel()] + [0] * max(self.nL - 1, 0)
        for k, lv in enumerate(amg.levels):
            recs += [0 if k == 0 else self.diag[k].data_ptr(),
                     0 if k == 0 else self.ell[k].data_ptr()]
            recs += [lv[f].data_ptr() for f in (
                "child_ptr", "child_idx", "fold_ptr", "fold_pos", "ent_ptr",
                "ent_pos", "ent_dst")]
            recs += [self.diag[k + 1].data_ptr(),
                     self.ell[k + 1].data_ptr(), lv["n_coarse"],
                     lv["nnz_coarse"]]
            work[k] += lv["n_coarse"] + lv["nnz_coarse"]
        self.table = torch.tensor(recs, dtype=torch.int64).to(dev)
        self.lib = cuda_lib.load("amg", _SIGS)
        most = max(work + [n_c * n_c if self.dense is not None else 0])
        grids = []
        for setup in (0, 1):
            out = (ctypes.c_int * 4)()
            with torch.cuda.device(dev):
                cuda_lib.check(self.lib.opm_amg_refresh_grid(most, setup,
                                                             out),
                               "opm_amg_refresh_grid")
            grids.append((out[0], dict(sms=out[1], blocks_per_sm=out[2],
                                       registers=out[3])))
        (self.grid, self.grid_info), (self.grid_setup,
                                      self.grid_setup_info) = grids
        self.work = work
        self.vals.ws = Workspace(amg, self.vals)


def refresh_cuda(R, diag0, off0):
    """K10's per-Newton value refresh on the card, one launch into the
    buffers of ``R`` (the hierarchy's ``Refresh``): every level's diag and
    ELL values and the float32 dense coarsest matrix from the pressure
    system's diag0 (n0,) and off0 (the level-0 entries in face order), on
    the current stream. Returns ``R.vals``, whose inverse is not formed
    here."""
    for t, n in ((diag0, R.n0), (off0, R.nnz0)):
        if (t.dtype != torch.float64 or not t.is_contiguous()
                or t.device != R.device or tuple(t.shape) != (n,)):
            raise ValueError("K10: the refresh needs contiguous float64 "
                             f"diag0 ({R.n0},) and off0 ({R.nnz0},) on "
                             f"{R.device}")
    cuda_lib.check(R.lib.opm_amg_refresh(
        R.table.data_ptr(), R.nL, diag0.data_ptr(), off0.data_ptr(), R.grid,
        cuda_lib.stream_ptr(R.device)),
        "opm_amg_refresh")
    refresh_cuda.launches += 1
    return R.vals


refresh_cuda.launches = 0


def refresh_setup_cuda(R, fl, diag, face_L, face_R):
    """K10's refresh with K6's setup on the face list ``fl`` as its first
    phases, one cooperative launch: the setup's dinv, w, diag_p and off
    (``linalg/precond.py`` ``cpr_setup_plain``'s: the cell part, a grid
    barrier, the face list's couplings) into ``R.setup``, a grid barrier,
    then the refresh from that diag_p and off into the buffers of ``R``,
    on the current stream. Returns ``R.vals``, whose inverse is not formed
    here. The arguments are checked by the caller
    (``precond._face_refresh``)."""
    S, ptr = R.setup, cuda_lib.ptr
    cuda_lib.check(R.lib.opm_amg_refresh_setup(
        R.table.data_ptr(), R.nL, R.n0, fl.n, fl.first, face_L.shape[1],
        ptr(fl.c1_32), ptr(fl.c2_32), ptr(diag), ptr(face_L), ptr(face_R),
        ptr(S.dinv), ptr(S.w), ptr(S.diag_p), ptr(S.off), R.grid_setup,
        cuda_lib.stream_ptr(R.device)), "opm_amg_refresh_setup")
    refresh_setup_cuda.launches += 1
    return R.vals


refresh_setup_cuda.launches = 0


def refresh_bytes(sizes, widths, entries):
    """The bytes K10's value refresh must move on a hierarchy whose levels
    have ``sizes`` cells, ELL ``widths`` and ``entries`` off-diagonal
    entries (level 0 first), each input read once and each output written
    once: diag0 and off0 (float64), the int32 maps (level 0's slot
    entries; per coarsening step the children and their CSR pointers,
    each fine entry once as a folded or merged position, the two CSRs'
    pointers and each coarse entry's slot; the coarsest's column ids) and
    the outputs (every level's diag and entries, level 0's copy included,
    and the float32 dense coarsest matrix where it is inverted)."""
    ns, Ks, nnz = sizes, widths, entries
    b = 8 * (ns[0] + nnz[0]) + 4 * Ks[0] * ns[0]
    for k in range(len(ns) - 1):
        b += 4 * (2 * (ns[k + 1] + 1) + ns[k] + nnz[k]
                  + (nnz[k + 1] + 1) + nnz[k + 1])
    b += sum(8 * (n + z) for n, z in zip(ns, nnz))
    if ns[-1] <= DENSE_COARSEST:
        b += 4 * Ks[-1] * ns[-1] + 4 * ns[-1] ** 2
    return b

# ---------------------------------------------------------------------------

class DeviceAmg:
    """The hierarchy's index arrays on one device and the per-Newton work:
    ``coarsen_values`` (on the card K10's refresh into the hierarchy's
    ``Refresh``, then the float32 coarsest inverse) and ``vcycle`` (K10's
    two legs)."""

    wants_canonical_faces = False

    def __init__(self, h: AmgHierarchy, device):
        dev = torch.device(device)
        self.device = dev
        self.hierarchy = h
        self.n0 = h.nc
        self.nnz0 = len(h.rows0)
        self.coarsest_n = h.coarsest_n

        def t(a, dtype=torch.long):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        def ell_of(n, rows, cols):
            cols_ell, slot = pack_ell(n, rows, cols)
            return dict(cols=t(cols_ell), cols32=t(cols_ell, torch.int32),
                        slot=t(slot)), slot

        # self.ell[k]: level k's ELL layout (level 0's with the entry of
        # each slot, -1 at padding); self.levels[k]: the coarsening step
        # k -> k + 1 (with level k's ELL and aggregates for the V-cycle
        # kernels, and the refresh's gather CSRs: each summed entry as its
        # position in level k's values, off0's face order at k = 0 and its
        # ELL slot below, each coarse entry's ELL slot at level k + 1)
        e0, slot0 = ell_of(h.nc, h.rows0, h.cols0)
        src = np.full(e0["cols"].numel(), -1, dtype=np.int64)
        src[slot0] = np.arange(len(slot0))
        e0["src"] = t(src, torch.int32)
        self.ell = [e0]
        self.levels = []
        fine_slot = None        # level k's entry -> its ELL slot (k >= 1)
        for lv in h.levels:
            n_c = lv.n_coarse
            cptr, cidx = csr_by(lv.agg, n_c)
            diag_e = np.nonzero(lv.off_is_diag)[0]
            fptr, fsel = csr_by(lv.off_diag_row[diag_e], n_c)
            kept = np.nonzero(~lv.off_is_diag)[0]
            eptr, esel = csr_by(lv.off_to_coarse[kept], len(lv.rows_c))
            ell_c, slot_c = ell_of(n_c, lv.rows_c, lv.cols_c)
            self.levels.append(dict(
                n_fine=lv.n_fine, n_coarse=n_c, nnz_coarse=len(lv.rows_c),
                agg=t(lv.agg), agg32=t(lv.agg, torch.int32),
                off_to_coarse=t(lv.off_to_coarse),
                off_diag_row=t(lv.off_diag_row),
                off_is_diag=t(lv.off_is_diag, torch.bool),
                child_ptr=t(cptr, torch.int32),
                child_idx=t(cidx, torch.int32),
                fold_ptr=t(fptr, torch.int32),
                fold_pos=t(_at(fine_slot, diag_e[fsel]), torch.int32),
                ent_ptr=t(eptr, torch.int32),
                ent_pos=t(_at(fine_slot, kept[esel]), torch.int32),
                ent_dst=t(slot_c, torch.int32)))
            self.ell.append(ell_c)
            fine_slot = slot_c
        for k, lv in enumerate(self.levels):
            lv.update(cols=self.ell[k]["cols"], cols32=self.ell[k]["cols32"])
        self.refresh = Refresh(self, dev) if dev.type == "cuda" else None

    @property
    def n_levels(self):
        return len(self.levels) + 1

    # ------------------------------------------------------------------
    def coarsen_values(self, diag0, off0, *, twin=False):
        """Per-Newton Galerkin value coarsening: per level (diag, ell_vals
        (K, n)), level 0 first, then the float32 inverse of the dense
        coarsest matrix when it has at most DENSE_COARSEST cells. On the
        card K10's refresh into the hierarchy's buffers and the inverse
        into its buffer: the same ``Refresh.vals`` every call (its
        workspace made once), valid until the next refresh; on the CPU,
        and with ``twin`` on any device, the per-level composition of the
        plain twins in fresh tensors. A singular coarsest matrix raises on
        the CPU (torch.linalg.inv); on the card the inverse is
        torch.linalg.inv_ex, which leaves the host unsynced and, like the
        reference's jnp.linalg.inv, gives non-finite values with no error
        (its info in ``refresh.inv_info``)."""
        diag0, off0 = diag0.contiguous(), off0.contiguous()
        if twin:
            return self._coarsen_levels(diag0, off0)
        return cuda_lib.dispatch(diag0, self._refresh, self._coarsen_levels,
                                 diag0, off0, what="K10 refresh")

    def card_refresh(self, device=None):
        """The hierarchy's ``Refresh`` (on the card it was put on; raises
        where that is not ``device`` or not a card)."""
        R = self.refresh
        if R is None or (device is not None
                         and torch.device(device) != R.device):
            raise ValueError(f"K10: this hierarchy was put on {self.device}, "
                             f"not on the card {device}")
        return R

    def setup_out(self, device):
        """The CPR setup's outputs on the card ``device`` (the
        ``Refresh``'s ``SetupOut``)."""
        return self.card_refresh(device).setup

    def _refresh(self, diag0, off0):
        R = self.card_refresh(diag0.device)
        refresh_cuda(R, diag0, off0)
        R.invert()
        return R.vals

    def _coarsen_levels(self, diag, off):
        """The per-level composition of coarsen_plain, ell_pack_plain and
        invert_coarsest."""
        vals = LevelValues()
        for k in range(self.n_levels):
            vals.append((diag, ell_pack_plain(off, self.ell[k])))
            if k == len(self.levels):
                break
            diag, off = coarsen_plain(diag, off, self.levels[k])
        if self.coarsest_n <= DENSE_COARSEST:
            vals.append(self.invert_coarsest(*vals[-1], self.ell[-1]))
        return vals

    @staticmethod
    def invert_coarsest(diag, ell_vals, ell):
        """float32 inverse of the dense coarsest matrix (the reference's
        jnp.linalg.inv(A.astype(float32)))."""
        return torch.linalg.inv(dense_coarsest(diag, ell_vals, ell["cols"])
                                .to(torch.float32))

    # ------------------------------------------------------------------
    def _coarsest_plain(self, vals, k, bk):
        """The coarsest solve of the plain versions: the float32 inverse's
        product, or 1 + 10 sweeps."""
        if self.coarsest_n <= DENSE_COARSEST:
            return (vals[-1] @ bk.to(torch.float32)).to(bk.dtype)
        diag, ev = vals[k]
        cols = self.ell[k]["cols"]
        x = sweep_plain(diag, ev, cols, None, bk)
        for _ in range(10):
            x = sweep_plain(diag, ev, cols, x, bk)
        return x

    def _vcycle_levels(self, vals, b):
        """The per-level composition of the plain twins (the oracle)."""
        def cycle(k, bk):
            if k == len(self.levels):
                return self._coarsest_plain(vals, k, bk)
            diag, ev = vals[k]
            lv = self.levels[k]
            x = sweep_plain(diag, ev, lv["cols"], None, bk)
            r_c = restrict_plain(diag, ev, lv["cols"], x, bk, lv["agg"],
                                 lv["n_coarse"])
            e_c = cycle(k + 1, r_c)
            return prolong_sweep_plain(diag, ev, lv["cols"], x, e_c,
                                       lv["agg"], bk)

        return cycle(0, b)

    def vcycle_down_plain(self, vals, b):
        """K10's down leg, plain, in the kernel's order: per level the
        zero-start sweep and its residual summed by aggregate, the next
        level's right-hand side. Returns (bs, c): bs[k] level k's
        right-hand side (k <= nL), and c the coarsest right-hand side in
        float32 when the coarsest is inverted, else its 1 + 10 sweeps."""
        bs = [b]
        for k, lv in enumerate(self.levels):
            diag, ev = vals[k]
            x = sweep_plain(diag, ev, lv["cols"], None, bs[k])
            bs.append(restrict_plain(diag, ev, lv["cols"], x, bs[k],
                                     lv["agg"], lv["n_coarse"]))
        if self.coarsest_n <= DENSE_COARSEST:
            return bs, bs[-1].to(torch.float32)
        return bs, self._coarsest_plain(vals, len(self.levels), bs[-1])

    def vcycle_up_plain(self, vals, bs, ec):
        """K10's up leg, plain, in the kernel's order: from the coarsest
        correction ec (float32 when inverted), per level k = nL-1 .. 0 the
        zero-start sweep of bs[k] again plus ec[agg], then one sweep.
        Returns (x, es): the V-cycle's result (n0,) and es[k] level k's
        correction (es[0] is x, es[nL] the coarsest one in float64)."""
        es = [None] * len(self.levels) + [ec.to(torch.float64)]
        for k in reversed(range(len(self.levels))):
            diag, ev = vals[k]
            lv = self.levels[k]
            x = sweep_plain(diag, ev, lv["cols"], None, bs[k])
            es[k] = prolong_sweep_plain(diag, ev, lv["cols"], x, es[k + 1],
                                        lv["agg"], bs[k])
        return es[0], es

    def _vcycle_legs_plain(self, vals, b):
        bs, c = self.vcycle_down_plain(vals, b)
        if self.coarsest_n <= DENSE_COARSEST:
            c = vals[-1] @ c
        return self.vcycle_up_plain(vals, bs, c)[0]

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
        if ws.dense:
            coarsest_product(vals[-1], ws.bc, ws.ec)
        return vcycle_up_cuda(ws, b)

    def vcycle(self, vals, b, *, w=None, rc=None, twin=False):
        """One V-cycle on b (n0,), or with ``w`` and ``rc`` (3, n0) on the
        CPR apply's weighted residual b = (w0 rc0 + w1 rc1) + w2 rc2 (pre =
        post = 1, one cycle): on the card K10's two legs around the float32
        coarsest product (the down leg's right-hand side entry forms b
        itself; the result is the workspace's ``out``, valid until the next
        V-cycle on ``vals``), on the CPU their plain versions; ``twin``:
        the per-level composition of the plain twins on any device (the
        card's oracle)."""
        if w is not None:
            if not twin and w.device.type == "cuda":
                return self._vcycle_cuda(vals, None, w, rc)
            b = pressure_rhs_plain(w, rc)
        b = b.contiguous()
        if twin:
            return self._vcycle_levels(vals, b)
        return cuda_lib.dispatch(b, self._vcycle_cuda,
                                 self._vcycle_legs_plain, vals, b,
                                 what="K10 V-cycle")
