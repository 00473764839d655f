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
(block-Jacobi inverses, weights, pressure diagonal and stencil face
couplings in one pass over the cells; on a gather grid the cell part,
then K6-faces over the face list) and the apply's smoothing step x <- x +
D^-1 (r - A x), fused with K4's stencil, or with K4-faces
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

from opm_tpu_torch.linalg.gmg import pressure_rhs_plain
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


def _setup_outputs(diag):
    nc = diag.shape[1]
    dev = diag.device
    return (torch.empty_like(diag),
            torch.empty((3, nc), dtype=torch.float64, device=dev),
            torch.empty(nc, dtype=torch.float64, device=dev))


def cpr_setup_cuda(diag, face_L, face_R, dims):
    """K6 setup on a structured grid on the card: cpr_setup_plain's dinv,
    w and diag_p, and off over the stencil faces only (an embedded grid's
    extra faces are what _pressure_off_for drops for the GMG)."""
    linearize.check_block_operator(diag, face_L, face_R, dims)
    nx, ny, nz = dims
    nf = (nx - 1) * ny * nz + nx * (ny - 1) * nz + nx * ny * (nz - 1)
    dinv, w, diag_p = _setup_outputs(diag)
    off = torch.empty(2 * nf, dtype=torch.float64, device=diag.device)
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
    dinv, w, diag_p = _setup_outputs(diag)
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


def cpr_setup(sys: linearize.BlockSystem, dims, amg, *, twin=False):
    """The per-Newton setup (dinv, w, diag_p, off as the pressure
    hierarchy takes it): K6 on a structured grid (off over the stencil:
    the structured GMG drops an embedded grid's extra faces); K6's cell
    part and K6-faces on a gather grid; the plain twin for CPU tensors or
    when ``twin``."""
    ops = (sys.diag, sys.face_L, sys.face_R)
    dev = sys.diag.device.type
    if twin or dev == "cpu":
        dinv, w, diag_p, off = cpr_setup_plain(*ops, dims, sys.faces)
        return dinv, w, diag_p, _pressure_off_for(amg, off, dims)
    if dev != "cuda":
        raise RuntimeError(f"no K6 kernel for device {sys.diag.device}")
    if dims is not None:
        return cpr_setup_cuda(*ops, tuple(dims))
    dinv, w, diag_p = cpr_setup_cells_cuda(sys.diag)
    return dinv, w, diag_p, cpr_faces_cuda(sys.faces, w, sys.face_L,
                                           sys.face_R)


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
    dinv, w, diag_p, off = cpr_setup(sys, dims, amg, twin=twin)
    vals = amg.coarsen_values(diag_p, off, twin=twin)

    def apply(rc):
        rc = rc.contiguous()
        # the weighted pressure residual is formed in the V-cycle's down leg
        xc = amg.vcycle(vals, None, w=w, rc=rc, twin=twin)
        for _ in range(SMOOTHER_STEPS):
            xc = smooth_step(sys, dinv, xc, rc, dims, twin=twin)
        return xc

    return apply
