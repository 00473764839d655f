"""Block-Jacobi and CPR preconditioning of the well-eliminated system.

Port of the JAX package's linalg/precond.py: the closed-form block
inverses (``inv3x3``, the equilibrated and regularised ``inv4x4``), the
quasi-IMPES CPR weights, the weighted pressure system (over the stencil
of a structured grid, an embedded grid's extra faces, or a gather grid's
face list), and ``make_cpr_cells``: one V-cycle of the pressure
hierarchy (structured GMG, or aggregation AMG on a gather grid) on the
weighted pressure residual, then block-Jacobi smoothing of the cell
system. The settings are the reference's CPU ones: two smoothing steps,
one V-cycle with one pre- and one post-smoothing sweep, float64.

Kernel K6 (``csrc/cpr.cu``, ``csrc/block7.cu``) does the per-Newton setup
(block-Jacobi inverses, weights, pressure diagonal and face couplings: in
one pass over the cells, a thread per cell, over the stencil of a
structured grid; on a gather grid the cell part, then K6-faces a thread
per face, which the main path runs as the first phases of K10's value
refresh, ``cpr_setup_refresh_cuda``) into buffers the pressure hierarchy
owns (``gmg.SetupOut``), and the apply's smoothing
step x <- x + D^-1 (r - A x), fused with K4's stencil, or with K4-faces
(``csrc/faces.cu``) over a face list. The apply's weighted pressure
residual is formed in the V-cycle's down leg (the right-hand side entry
of K7 and K10; ``pressure_rhs_plain`` is its plain form). Each K6 kernel
has its plain twin here. The non-Schur
``make_cpr`` (and the ``block_jacobi`` and ``cpr_weights`` selector only
it needs), the red-black smoother, true-IMPES weights and the frozen
preconditioner were measured TPU knobs and are not ported (ROADMAP).
"""

from __future__ import annotations

import torch

from opm_tpu_torch.linalg import amg as k10
from opm_tpu_torch.linalg.gmg import SetupOut, pressure_rhs_plain
from opm_tpu_torch.models import linearize
from opm_tpu_torch.models.blackoil import _dir_segments
from opm_tpu_torch.utils import cuda_lib

_TINY = 1e-300


def _nonzero_or_one(det):
    return torch.where(torch.abs(det) > _TINY, det, torch.ones_like(det))


def inv3x3(m):
    """Batched closed-form 3x3 inverse, (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = _nonzero_or_one(a * A + b * B + c * C)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def inv4x4(m):
    """Batched 4x4 inverse by 2x2 block elimination, after max-abs row and
    column equilibration and a 1e-10 Tikhonov shift in the equilibrated
    metric; 2x2 determinants are clamped relative to the block scale (the
    reference's guards for rank-deficient well blocks, copied exactly)."""
    r = torch.clamp(torch.amax(torch.abs(m), dim=-1, keepdim=True),
                    min=_TINY)
    m = m / r
    c = torch.clamp(torch.amax(torch.abs(m), dim=-2, keepdim=True),
                    min=_TINY)
    m = m / c + 1e-10 * torch.eye(4, dtype=m.dtype, device=m.device)
    A = m[..., :2, :2]
    B = m[..., :2, 2:]
    C = m[..., 2:, :2]
    D = m[..., 2:, 2:]

    def inv2(x):
        a, b = x[..., 0, 0], x[..., 0, 1]
        c_, d = x[..., 1, 0], x[..., 1, 1]
        det = a * d - b * c_
        scale = torch.maximum(torch.abs(a * d), torch.abs(b * c_))
        floor = torch.clamp(1e-10 * scale, min=_TINY)
        det = torch.where(torch.abs(det) >= floor, det,
                          torch.where(det < 0, -floor, floor))
        return torch.stack([torch.stack([d, -b], dim=-1),
                            torch.stack([-c_, a], dim=-1)],
                           dim=-2) / det[..., None, None]

    Ai = inv2(A)
    S = D - C @ Ai @ B
    Si = inv2(S)
    TL = Ai + Ai @ B @ Si @ C @ Ai
    TR = -Ai @ B @ Si
    BL = -Si @ C @ Ai
    BR = Si
    inv = torch.cat([torch.cat([TL, TR], dim=-1),
                     torch.cat([BL, BR], dim=-1)], dim=-2)
    return inv / c.transpose(-1, -2) / r.transpose(-1, -2)


def inv3x3_rows(m):
    """Closed-form inverse of a (9, n) row-major 3x3 block family, as a
    (9, n) tensor."""
    a, b, c, d, e, f, g, h, i = m
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = _nonzero_or_one(a * A + b * B + c * C)
    inv_det = 1.0 / det
    return torch.stack([
        A * inv_det, -(b * i - c * h) * inv_det, (b * f - c * e) * inv_det,
        B * inv_det, (a * i - c * g) * inv_det, -(a * f - c * d) * inv_det,
        C * inv_det, -(a * h - b * g) * inv_det, (a * e - b * d) * inv_det])


def quasi_impes_weights(diag):
    """Per-cell CPR weights (3, nc) with w^T D = e_p^T: row 0 of D^-1 from
    the first-row cofactors."""
    a, b, c, d, e, f, g, h, i = diag
    A = e * i - f * h
    det = _nonzero_or_one(a * A + b * -(d * i - f * g) + c * (d * h - e * g))
    return torch.stack([A, -(b * i - c * h), (b * f - c * e)]) / det


def cpr_pressure_system(sys: linearize.BlockSystem, w, dims):
    """Weighted pressure matrix: diag (nc,) and off (2 nf,) = [a_LR | a_RL]
    in grid face order, aligned with the AMG level-0 directed entries
    [rows c1 | c2, cols c2 | c1]: the stencil faces by shifted slices
    (dims given), the face list past them by gather."""
    pR = (sys.face_R[0], sys.face_R[3], sys.face_R[6])
    pL = (sys.face_L[0], sys.face_L[3], sys.face_L[6])
    diag_p = w[0] * sys.diag[0] + w[1] * sys.diag[3] + w[2] * sys.diag[6]
    aLR, aRL = [], []
    if dims is not None:
        nx, ny, nz = dims
        w3 = [wi.reshape(nz, ny, nx) for wi in w]
        ofs = 0
        for slL, slR, nf_d in _dir_segments(dims):
            aLR.append(sum(w3[i][slL].reshape(-1) * pR[i][ofs:ofs + nf_d]
                           for i in range(3)))
            aRL.append(-sum(w3[i][slR].reshape(-1) * pL[i][ofs:ofs + nf_d]
                            for i in range(3)))
            ofs += nf_d
    if sys.faces is not None:
        fLR, fRL = cpr_faces_plain(sys.faces, w, sys.face_L, sys.face_R)
        aLR.append(fLR)
        aRL.append(fRL)
    return diag_p, torch.cat(aLR + aRL)


def cpr_faces_plain(fl, w, face_L, face_R):
    """(a_LR, a_RL) of the list's faces: the plain version of K6-faces
    (cpr_pressure_system's face-list branch)."""
    f = fl.first
    a_LR = sum(w[i][fl.c1] * face_R[3 * i][f:] for i in range(3))
    a_RL = -sum(w[i][fl.c2] * face_L[3 * i][f:] for i in range(3))
    return a_LR, a_RL


def _pressure_off_for(amg, off_p, dims):
    """Structured GMG consumes only the canonical stencil faces; extra
    faces of an embedded grid (stair-step faults / NNCs) are dropped from
    the pressure hierarchy, a preconditioner-quality approximation only
    (the Krylov operator keeps them)."""
    if dims is None or not getattr(amg, "wants_canonical_faces", False):
        return off_p
    nx, ny, nz = dims
    nfc = (nx - 1) * ny * nz + nx * (ny - 1) * nz + nx * ny * (nz - 1)
    nf_all = off_p.shape[0] // 2
    if nf_all == nfc:
        return off_p
    return torch.cat([off_p[:nfc], off_p[nf_all:nf_all + nfc]])


# ---------------------------------------------------------------------------
# K6 setup: plain version and CUDA wrappers (csrc/cpr.cu)

def cpr_setup_plain(diag, face_L, face_R, dims, faces=None):
    """(dinv (9, nc), w (3, nc), diag_p (nc,), off (2 nf,)): the per-Newton
    CPR setup of make_cpr_cells, off over every face (``faces``: the
    FaceList past the stencil, or of a gather grid)."""
    sys = linearize.BlockSystem(None, None, diag, face_L, face_R, None,
                                None, None, None, None, faces)
    dinv, w, _ = cpr_setup_cells_plain(diag)
    diag_p, off = cpr_pressure_system(sys, w, dims)
    return dinv, w, diag_p, off


def cpr_setup_cells_plain(diag):
    """(dinv, w, diag_p): the cell part of the setup."""
    w = quasi_impes_weights(diag)
    diag_p = w[0] * diag[0] + w[1] * diag[3] + w[2] * diag[6]
    return inv3x3_rows(diag), w, diag_p


_P, _I, _L = cuda_lib.P, cuda_lib.I, cuda_lib.L
CPR_SIGS = {
    "opm_cpr_setup": [_I, _I, _I, _L] + [_P] * 7 + [_P],
    "opm_cpr_setup_cells": [_L] + [_P] * 4 + [_P],
    "opm_cpr_faces": [_L, _L, _L, _L] + [_P] * 6 + [_P],
}


def cpr_setup_cuda(diag, face_L, face_R, dims, out=None):
    """K6 setup on a structured grid on the card: cpr_setup_plain's dinv,
    w and diag_p, and off over the stencil faces only (an embedded grid's
    extra faces are what _pressure_off_for drops for the GMG), into the
    tensors of ``out`` (a ``gmg.SetupOut``: the hierarchy's, which the
    next setup overwrites) or fresh ones."""
    linearize.check_block_operator(diag, face_L, face_R, dims)
    nx, ny, nz = dims
    nc = nx * ny * nz
    nf = (nx - 1) * ny * nz + nx * (ny - 1) * nz + nx * ny * (nz - 1)
    if out is None:
        out = SetupOut(nc, 2 * nf, diag.device)
    elif (out.diag_p.shape != (nc,) or out.off.shape != (2 * nf,)
          or out.off.device != diag.device):
        raise ValueError(f"K6: the setup's buffers are not for {nc} cells "
                         f"and {2 * nf} couplings on {diag.device}")
    dinv, w, diag_p, off = out.tensors()
    lib = cuda_lib.load("cpr", CPR_SIGS)
    ptr = cuda_lib.ptr
    err = lib.opm_cpr_setup(nx, ny, nz, face_L.shape[1], ptr(diag),
                            ptr(face_L), ptr(face_R), ptr(dinv), ptr(w),
                            ptr(diag_p), ptr(off),
                            cuda_lib.stream_ptr(diag.device))
    cuda_lib.check(err, "opm_cpr_setup")
    cpr_setup_cuda.launches += 1
    return dinv, w, diag_p, off


cpr_setup_cuda.launches = 0


def cpr_setup_cells_cuda(diag):
    """K6 setup's cell part on the card: (dinv, w, diag_p)."""
    if (diag.dtype != torch.float64 or not diag.is_contiguous()
            or diag.dim() != 2 or diag.shape[0] != 9):
        raise ValueError("K6 setup: diag must be a contiguous float64 "
                         "(9, nc) tensor")
    dinv, w, diag_p, _ = SetupOut(diag.shape[1], 0, diag.device).tensors()
    lib = cuda_lib.load("cpr", CPR_SIGS)
    ptr = cuda_lib.ptr
    err = lib.opm_cpr_setup_cells(diag.shape[1], ptr(diag), ptr(dinv),
                                  ptr(w), ptr(diag_p),
                                  cuda_lib.stream_ptr(diag.device))
    cuda_lib.check(err, "opm_cpr_setup_cells")
    cpr_setup_cells_cuda.launches += 1
    return dinv, w, diag_p


cpr_setup_cells_cuda.launches = 0


def cpr_faces_cuda(fl, w, face_L, face_R):
    """K6-faces on the card: off = [a_LR | a_RL] (2 n,) of the list's
    faces, as cpr_pressure_system's face-list branch."""
    nc = w.shape[1]
    linearize.check_block_operator(face_L, face_L, face_R, None)
    if (w.dtype != torch.float64 or not w.is_contiguous()
            or w.device != face_L.device):
        raise ValueError("K6-faces: w must be a contiguous float64 (3, nc) "
                         "tensor beside the face blocks")
    off = torch.empty(2 * fl.n, dtype=torch.float64, device=w.device)
    lib = cuda_lib.load("cpr", CPR_SIGS)
    ptr = cuda_lib.ptr
    err = lib.opm_cpr_faces(fl.n, fl.first, face_L.shape[1], nc,
                            ptr(fl.c1_32), ptr(fl.c2_32), ptr(w),
                            ptr(face_L), ptr(face_R), ptr(off),
                            cuda_lib.stream_ptr(w.device))
    cuda_lib.check(err, "opm_cpr_faces")
    cpr_faces_cuda.launches += 1
    return off


cpr_faces_cuda.launches = 0


def _face_refresh(amg, fl, diag, face_L, face_R):
    """The hierarchy's ``Refresh`` on the blocks' card, checked for K6 as
    the first phases of its refresh on the face list ``fl``."""
    linearize.check_block_operator(diag, face_L, face_R, None)
    if (face_L.shape[1] < fl.first + fl.n
            or fl.c1_32.device != diag.device):
        raise ValueError("K6 on a face list: the list must be on the "
                         "blocks' device, and the face arrays hold every "
                         "face of the list")
    R = amg.card_refresh(diag.device)
    if R.n0 != diag.shape[1] or R.nnz0 != 2 * fl.n:
        raise ValueError("K6 in K10's refresh: the hierarchy is not the "
                         "face list's")
    return R


def cpr_setup_refresh_cuda(amg, fl, diag, face_L, face_R):
    """K6 on a face list as the first phases of K10's value refresh (one
    cooperative launch, ``amg.refresh_setup_cuda``), then the float32
    coarsest inverse: (dinv, w, vals), the setup's outputs in the
    hierarchy's ``SetupOut`` and its refreshed ``Refresh.vals``, valid
    until the next setup of that hierarchy."""
    R = _face_refresh(amg, fl, diag, face_L, face_R)
    vals = k10.refresh_setup_cuda(R, fl, diag, face_L, face_R)
    R.invert()
    return R.setup.dinv, R.setup.w, vals


def cpr_setup_refresh_plain(R, fl, diag, face_L, face_R):
    """The plain version of ``k10.refresh_setup_cuda`` (K10's refresh with
    K6 on the face list as its first phases), into the buffers of ``R`` (a
    ``k10.Refresh`` on any device): cpr_setup_plain (the cell part, then
    the face list's couplings) copied into ``R.setup``, then
    ``k10.refresh_plain`` from its diag_p and off; not the inverse.
    Returns ``R.vals``."""
    S = R.setup
    for dst, src in zip(S.tensors(), cpr_setup_plain(diag, face_L, face_R,
                                                     None, fl)):
        dst.copy_(src)
    k10.refresh_plain(R, S.diag_p, S.off)
    return R.vals


def cpr_setup(sys: linearize.BlockSystem, dims, amg, *, twin=False):
    """The per-Newton setup (dinv, w, diag_p, off as the pressure
    hierarchy takes it): on the card K6 on a structured grid (off over the
    stencil: the structured GMG drops an embedded grid's extra faces), and
    on a gather grid the main path's launch, K6 as the first phases of
    K10's refresh (which refreshes the hierarchy's values too), into the
    hierarchy's ``SetupOut`` (valid until its next setup); the plain twin,
    in fresh tensors, for CPU tensors or when ``twin``. The CPR
    preconditioner runs ``pressure_setup``."""
    ops = (sys.diag, sys.face_L, sys.face_R)
    dev = sys.diag.device
    if twin or dev.type == "cpu":
        dinv, w, diag_p, off = cpr_setup_plain(*ops, dims, sys.faces)
        return dinv, w, diag_p, _pressure_off_for(amg, off, dims)
    if dev.type != "cuda":
        raise RuntimeError(f"no K6 kernel for device {dev}")
    if dims is not None:
        return cpr_setup_cuda(*ops, tuple(dims), amg.setup_out(dev))
    R = _face_refresh(amg, sys.faces, *ops)
    k10.refresh_setup_cuda(R, sys.faces, *ops)
    return R.setup.tensors()


def pressure_setup(sys: linearize.BlockSystem, dims, amg, *, twin=False):
    """The per-Newton CPR setup and the pressure hierarchy's value refresh:
    (dinv, w, vals). On the card on a gather grid one launch (K6 as the
    first phases of K10's refresh: ``cpr_setup_refresh_cuda``) and the
    coarsest inverse; otherwise ``cpr_setup``, then the hierarchy's
    ``coarsen_values``."""
    if not twin and dims is None and sys.diag.device.type == "cuda":
        return cpr_setup_refresh_cuda(amg, sys.faces, sys.diag, sys.face_L,
                                      sys.face_R)
    dinv, w, diag_p, off = cpr_setup(sys, dims, amg, twin=twin)
    return dinv, w, amg.coarsen_values(diag_p, off, twin=twin)


# ---------------------------------------------------------------------------
# K6 apply: the fused smoothing step

def smooth_step_plain(diag, face_L, face_R, dinv, x, r, dims):
    """x + D^-1 (r - A x) for the cells-only stencil operator; x (3, nc),
    or (nc,) for a pressure-only iterate (the other two rows zero)."""
    x = linearize.full3(x)
    ac = linearize.matvec_cells_plain(diag, face_L, face_R, x, dims)
    return x + linearize.bapply_rows(dinv, r - ac)


def smooth_step_cuda(diag, face_L, face_R, dinv, x, r, dims):
    """K4 + K6 smoothing step on the card; same contract as
    smooth_step_plain."""
    p_only = x.dim() == 1
    nc = r.shape[1]
    if p_only:
        linearize.check_iterate(x, nc, r.device)
    linearize.check_block_operator(diag, face_L, face_R, dims, r,
                                   *(() if p_only else (x,)))
    if (dinv.shape != diag.shape or dinv.dtype != torch.float64
            or not dinv.is_contiguous() or dinv.device != diag.device):
        raise ValueError("K6 smoothing: dinv must be a contiguous float64 "
                         "(9, nc) tensor beside diag")
    nx, ny, nz = dims
    out = torch.empty_like(r)
    lib = cuda_lib.load("block7", linearize.BLOCK7_SIGS)
    ptr = cuda_lib.ptr
    err = lib.opm_block7_smooth(nx, ny, nz, face_L.shape[1], int(p_only),
                                ptr(diag), ptr(face_L), ptr(face_R),
                                ptr(dinv), ptr(x), ptr(r), ptr(out),
                                cuda_lib.stream_ptr(r.device))
    cuda_lib.check(err, "opm_block7_smooth")
    smooth_step_cuda.launches += 1
    return out


smooth_step_cuda.launches = 0


def smooth_step(sys: linearize.BlockSystem, dinv, x, r, dims, *,
                twin=False):
    """One block-Jacobi smoothing step x + D^-1 (r - A x) of the cell
    operator: K6's fused stencil step on a structured grid; K4-faces' fused
    step over a gather grid's faces; on an embedded grid K4 (the stencil
    product) then K4-faces (the extra faces and the step). ``twin``: the
    plain twins on any device."""
    ops = (sys.diag, sys.face_L, sys.face_R)
    fl = sys.faces
    if fl is None:
        args = (*ops, dinv, x, r, tuple(dims))
        return (smooth_step_plain(*args) if twin else cuda_lib.dispatch(
            r, smooth_step_cuda, smooth_step_plain, *args,
            what="K6 smoothing"))
    base = None
    if dims is not None:
        args = (*ops, x, tuple(dims))
        base = (linearize.matvec_cells_plain(*args) if twin else
                cuda_lib.dispatch(r, linearize.matvec_cells_cuda,
                                  linearize.matvec_cells_plain, *args,
                                  what="K4"))
    def plain():
        return linearize.faces_smooth_plain(fl, *ops, dinv, x, r, base)
    return plain() if twin else cuda_lib.dispatch(
        r, lambda: linearize.faces_smooth_cuda(sys.packed, dinv, x, r, base),
        plain, what="K4-faces smoothing")


SMOOTHER_STEPS = 2       # the reference's CPU setting


def make_cpr_cells(sys: linearize.BlockSystem, amg, dims, *, twin=False):
    """CPR preconditioner of the well-eliminated system: weighted pressure
    residual, one V-cycle of ``amg`` (the structured GMG with dims, the
    aggregation AMG's DeviceAmg on a gather grid; pre = post = 1, one
    cycle), then SMOOTHER_STEPS block-Jacobi steps on the cell diagonal.
    ``twin``: every step by its plain twin on any device (the card's
    whole-solve comparison)."""
    dims = tuple(dims) if dims is not None else None
    dinv, w, vals = pressure_setup(sys, dims, amg, twin=twin)

    def apply(rc):
        rc = rc.contiguous()
        # the weighted pressure residual is formed in the V-cycle's down leg
        xc = amg.vcycle(vals, None, w=w, rc=rc, twin=twin)
        for _ in range(SMOOTHER_STEPS):
            xc = smooth_step(sys, dinv, xc, rc, dims, twin=twin)
        return xc

    return apply
