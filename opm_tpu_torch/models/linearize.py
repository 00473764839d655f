"""Block-sparse Jacobian assembly and the block operator.

Port of the JAX package's models/linearize.py: ``assemble`` builds the
residual and the exact Jacobian as 3x3 cell-diagonal blocks, 3x3
left/right face blocks and the well coupling blocks; ``matvec`` applies
it; ``schur_eliminate_wells`` gives the cells-only reduced operator
A - C D^-1 B, its right-hand side and the well recovery. ``dims`` is the
structured grid's (nx, ny, nz), or None on a gather grid.

Every derivative is exact forward-mode differentiation of the same local
formulas as the residual, on the card in hand kernels: K2
(``csrc/cells.cu``) evaluates the cell quantities and the accumulation
with their three tangent columns in (p, sw, x) per cell (the reference
seeds ``jax.linearize`` with all-ones per primary), giving r_cell and the
accumulation's diagonal blocks; the K3 face blocks chain the face-flux
tangent with those columns per face (``csrc/blocks.cu`` over the stencil,
``csrc/faces.cu`` over a face list) and fold the fluxes and blocks into
r_cell and the diagonal. Their plain twins (``cells_assemble_plain``, a
batched ``torch.func.jvp``; ``face_blocks_plain``, ``faces_blocks_plain``)
run on the CPU. The perforation fluxes are differentiated by seeding each
of the seven perforation-local variables over all perforations at once
(the reference's ``vmap(jacfwd(perf_local))``), through K2's forward-mode
rule. K5 (``csrc/wells.cu``) applies the Schur complement of the wells.

The cell-block part of the operator is kernel K4 (``csrc/block7.cu``)
over the 7-point stencil, with ``matvec_cells_plain`` as its twin, and
K4-faces (``csrc/faces.cu``) over a face list: a gather grid's faces, or an
embedded grid's extra faces after K4 (``faces_matvec_plain`` its twin).
K4-faces reads the face blocks from a sliced-ELL copy in row order
(``FacesOperator``, a ``BlockSystem.packed`` field that is None on the
CPU), which the face-list face blocks' row phase writes on the card. The
3x3 block families are stored as (9, n) tensors, row-major over
(equation, variable): row 3*i+j is dF_i/du_j, the reference's nine flat
arrays stacked; face blocks follow the grid's face order (on an embedded
grid the stencil faces, then the extra faces).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from opm_tpu_torch.models.blackoil import (_FACES_SIGS, SELL_PAD, FaceList,
                                           SellLayout, _cells3,
                                           _dir_segments,
                                           _face_flux_tangent, _ptr_or_null,
                                           _slice,
                                           cell_assembly,
                                           cell_quantities_plain,
                                           cells_assemble_plain,
                                           compute_cell_quantities,
                                           csr_args, degenerate_x_weight,
                                           face_flux_from_q)
from opm_tpu_torch.models.state import saturations
from opm_tpu_torch.utils import cuda_lib
from opm_tpu_torch.wells import standard as stdwells
from opm_tpu_torch.wells.wells import CTRL_BHP, CTRL_THP

_P, _I, _L = cuda_lib.P, cuda_lib.I, cuda_lib.L


def degenerate_x_mask(model, state):
    """Continuous regularization weight in [0, 1] for the (gas-eq, x)
    diagonal of cells whose x variable is losing its equation
    (``degenerate_x_weight`` at the state's saturations); only the
    Jacobian is touched, never the residual."""
    _, so, sg = saturations(state)
    return degenerate_x_weight(state.hcstate, so, sg)


class BlockSystem(NamedTuple):
    """Assembled block-sparse Jacobian and residual."""

    r_cell: torch.Tensor     # (3, nc) phase-leading
    r_well: torch.Tensor     # (nw, 4) [flux eqs (3), control eq]
    diag: torch.Tensor       # (9, nc) block diagonal, row 3*eq + var
    face_L: torch.Tensor     # (9, nf) dF/du_L
    face_R: torch.Tensor     # (9, nf) dF/du_R
    cw: torch.Tensor         # (nw, mp, 3, 4) cell rows x well vars
    wc: torch.Tensor         # (nw, mp, 3, 3) well flux rows x cell vars
    wd_diag: torch.Tensor    # (nw, 4, 4) well rows x well vars
    perf_cell: torch.Tensor  # (nw, mp)
    perf_mask: torch.Tensor  # (nw, mp) float
    faces: object = None     # FaceList of the faces past the stencil
    perf_order: object = None  # (npf) perforations stably sorted by cell
    packed: object = None    # FacesOperator on the card (K4-faces)

    @property
    def nc(self):
        return self.diag.shape[-1]

    @property
    def nw(self):
        return self.wd_diag.shape[0]


def assemble(model, state, acc0, dt, wd, cdp, *, twin=False) -> BlockSystem:
    """Residual and exact Jacobian blocks at ``state`` (the reference's
    ``assemble``: the stencil faces by direction on a structured grid, then
    the face list by gather): K2 and the K3 face blocks on the card, their
    plain twins on the CPU or, with ``twin``, on any device (the card's
    before/after comparison)."""
    if state.sgmax is not None or state.somax is not None:
        raise NotImplementedError(
            "hysteresis/VAPPARS memory is not ported yet "
            "(ROADMAP Queue 1 item 2)")
    props = model.props
    dims = model.dims
    dev = state.pressure.device
    hc, pvt, sat = state.hcstate, model.pvtnum, model.satnum
    p, sw, x = state.pressure, state.sw, state.x

    # ---- cells (K2): the face inputs and their three tangent columns,
    # r_cell = pv/dt (acc - acc0) and the accumulation's diagonal blocks
    cells_args = (p, sw, x, hc, pvt, sat, acc0, model.pv, dt)
    fv, fc, r_cell, diag = (cells_assemble_plain(props, *cells_args) if twin
                            else cell_assembly(props, *cells_args))
    # ---- faces (K3 face blocks): the fluxes and face_L / face_R chained
    # through the per-cell tangent columns, folded into r_cell and diag in
    # place; the stencil faces by direction, then the face list by gather
    nf = model.trans.shape[0]
    face_L = torch.empty((9, nf), dtype=torch.float64, device=dev)
    face_R = torch.empty_like(face_L)
    fargs = (fv, fc, model.depth, model.trans, model.gravity, r_cell, diag,
             face_L, face_R)
    # THPRES: the faces' thresholds (None: the zero threshold's tangent)
    thr = model.threshold_dp
    if model.structured:
        if twin:
            face_blocks_plain(dims, *fargs, thr=thr)
        else:
            cuda_lib.dispatch(fv, face_blocks_cuda, face_blocks_plain, dims,
                              *fargs, thr=thr, what="K3 face blocks")
    # (the face list's, with K4-faces' packed copy on the card)
    fl = model.faces
    blk = None
    if fl is not None:
        if twin:
            faces_blocks_plain(fl, *fargs, thr=thr)
        else:
            blk = cuda_lib.dispatch(fv, faces_blocks_cuda,
                                    faces_blocks_plain, fl, *fargs, thr=thr,
                                    what="K3-faces face blocks")

    # ---- wells: perforation-local fluxes and their exact derivatives
    nw, mp = wd["perf_cell"].shape
    pc = wd["perf_cell"]
    mask = wd["perf_mask"] * wd["open"][:, None]
    pc_f = pc.reshape(-1)
    u_pf = torch.stack([p[pc_f], sw[pc_f], x[pc_f]], dim=-1)    # (npf, 3)
    wv = torch.cat([state.qs, state.bhp[:, None]], dim=1)       # (nw, 4)
    wv_f = torch.repeat_interleave(wv, mp, dim=0)               # (npf, 4)
    cf_f = torch.repeat_interleave(wd["comp_frac"], mp, dim=0)
    ii_f = torch.repeat_interleave(wd["is_injector"], mp)
    wi_f = wd["perf_wi"].reshape(-1)
    cdp_f = cdp.reshape(-1)
    hc_f, pvt_f, sat_f = hc[pc_f], pvt[pc_f], sat[pc_f]
    xflow = model.params.allow_crossflow

    ccq = cell_quantities_plain if twin else compute_cell_quantities

    def perf_local(u, wvars):
        q = ccq(props, u[:, 0], u[:, 1], u[:, 2], hc_f, pvt_f, sat_f)
        cmix = stdwells.wellbore_mixture(wvars[:, :3], cf_f, ii_f)
        return stdwells.perf_flux_formula(
            q.po, q.b.T, q.mob.T, q.rs, q.rv, wi_f, wvars[:, 3] + cdp_f,
            cmix, ii_f, allow_crossflow=xflow)                  # (npf, 3)

    # the seven perforation-local variables as one batched jvp
    eye7 = torch.eye(7, dtype=torch.float64, device=dev)
    npf = u_pf.shape[0]
    su = eye7[:, None, :3].expand(7, npf, 3)
    sw_ = eye7[:, None, 3:].expand(7, npf, 4)

    def perf_tangent(du, dw):
        return torch.func.jvp(perf_local, (u_pf, wv_f), (du, dw))

    cq_b, cols = torch.func.vmap(perf_tangent)(su, sw_)
    cq_val = cq_b[0]
    jac_u = torch.movedim(cols[:3], 0, -1)                   # (npf, 3, 3)
    jac_wv = torch.movedim(cols[3:], 0, -1)                  # (npf, 3, 4)
    m_f = mask.reshape(-1)
    cq_val = cq_val * m_f[:, None]
    jac_u = jac_u * m_f[:, None, None]
    jac_wv = jac_wv * m_f[:, None, None]
    r_cell = r_cell.index_add(1, pc_f, -cq_val.T)
    diag = diag.index_add(1, pc_f, -jac_u.reshape(-1, 9).T)
    cw = (-jac_wv).reshape(nw, mp, 3, 4)
    wc = (-jac_u).reshape(nw, mp, 3, 3)

    # well equations: flux rows q - sum cq, control row
    cq_sum = cq_val.reshape(nw, mp, 3).sum(dim=1)
    flux_res = state.qs - cq_sum
    inj = wd["is_injector"].to(torch.bool)
    g = stdwells.control_distribution(state.control, wd["comp_frac"])
    g = stdwells.resv_distribution(g, state.control, inj,
                                   wd.get("resv_coef"))
    g = stdwells.effective_distribution(g, state.control, inj,
                                        cq_val.reshape(nw, mp, 3))
    is_bhp = (state.control == CTRL_BHP) | (state.control == CTRL_THP)
    closed = wd["open"] < 0.5
    rate = torch.einsum("wp,wp->w", g, state.qs) - state.target
    bhp_t, dbhp_t = _control_bhp(wd.get("vfp"), state)
    ctrl_res = torch.where(is_bhp, state.bhp - bhp_t, rate)
    ctrl_jq = torch.where(is_bhp[:, None], -dbhp_t, g)
    ctrl_jb = torch.where(is_bhp, 1.0, 0.0).to(torch.float64)
    flux_res = torch.where(closed[:, None], state.qs, flux_res)
    ctrl_res = torch.where(closed, state.bhp - wd["bhp_limit"], ctrl_res)
    r_well = torch.cat([flux_res, ctrl_res[:, None]], dim=1)

    eye34 = torch.zeros((3, 4), dtype=torch.float64, device=dev)
    eye34[:, :3] = torch.eye(3, dtype=torch.float64, device=dev)
    dwv_sum = jac_wv.reshape(nw, mp, 3, 4).sum(dim=1)
    flux_rows = torch.where(closed[:, None, None], eye34[None],
                            eye34[None] - dwv_sum)
    ctrl_row = torch.cat([ctrl_jq, ctrl_jb[:, None]], dim=1)
    ctrl_bhp = torch.eye(4, dtype=torch.float64, device=dev)[3]
    ctrl_row = torch.where(closed[:, None], ctrl_bhp[None], ctrl_row)
    wd_diag = torch.cat([flux_rows, ctrl_row[:, None, :]], dim=1)
    cw = (cw * wd["open"][:, None, None, None]).contiguous()
    wc = (wc * wd["open"][:, None, None, None]).contiguous()
    diag = diag.contiguous()
    # K4-faces' operator over the copy the face blocks wrote, on the card
    packed = (FacesOperator(fl, diag, face_L, face_R, blk)
              if blk is not None else None)
    return BlockSystem(r_cell=r_cell, r_well=r_well, diag=diag,
                       face_L=face_L, face_R=face_R, cw=cw, wc=wc,
                       wd_diag=wd_diag, perf_cell=pc, perf_mask=mask,
                       faces=fl, perf_order=torch.argsort(pc_f, stable=True),
                       packed=packed)


def _control_bhp(vfp, state):
    """The BHP target of the control row and its derivative in the well's
    rates (nw, 3): the target itself (rates play no part) or, for a
    THP-controlled well with a VFP table, the table's BHP at its THP
    target plus the datum correction, differentiated by forward mode
    (the reference's jacfwd of ctrl_local, models/linearize.py:
    383-433)."""
    target = state.target
    if vfp is None:
        return target, torch.zeros_like(state.qs)
    is_thp = state.control == CTRL_THP

    def bhp_t(qs):
        return torch.where(is_thp, stdwells.vfp_bhp(vfp, qs, target),
                           target)

    eye = torch.eye(3, dtype=torch.float64, device=target.device)
    seeds = eye[:, None, :].expand(3, target.shape[0], 3)
    val, cols = torch.func.vmap(
        lambda d: torch.func.jvp(bhp_t, (state.qs,), (d,)))(seeds)
    return val[0], cols.T


# ---------------------------------------------------------------------------
# K3 face blocks: the fluxes and face_L / face_R of the assembly, folded into
# r_cell and diag (plain versions, CUDA wrappers: csrc/blocks.cu stencil
# form, csrc/faces.cu face-list form)

def _face_inputs(fv, fc):
    """(p3, rho, b mob, rs, rv) of the (11, n) face-input rows, and of
    their (3, 11, n) tangent columns (a leading variable axis)."""
    return ((fv[0:3], fv[3:6], fv[6:9], fv[9], fv[10]),
            (fc[:, 0:3], fc[:, 3:6], fc[:, 6:9], fc[:, 9], fc[:, 10]))


def _blocks(args, T, dz, gravity, tans_L, tans_R, thr=None):
    """face_L, face_R (9, n) (rows 3 eq + var) of faces with the gathered
    face inputs ``args`` (L, R pairs) and the tangent columns at the left
    and right cells, through the faces' THPRES clip ``thr`` or, without
    THPRES, the zero-THPRES tangent (the reference assembles through a
    zero threshold, whose clip has a zero derivative on faces with
    dphi == 0 exactly)."""
    tL, tR = [], []
    for aL, aR in zip(tans_L, tans_R):
        tL += [aL, torch.zeros_like(aL)]
        tR += [torch.zeros_like(aR), aR]
    fL = _face_flux_tangent(*args, T, dz, gravity, *tL, zero_threshold=True,
                            thr=thr)
    fR = _face_flux_tangent(*args, T, dz, gravity, *tR, zero_threshold=True,
                            thr=thr)
    n = T.shape[-1]
    # (3 var, 3 eq, n) -> rows 3*eq + var
    return fL.transpose(0, 1).reshape(9, n), fR.transpose(0, 1).reshape(9, n)


def face_blocks_plain(dims, fv, fc, depth, trans, gravity, r_cell, diag,
                      face_L, face_R, thr=None):
    """The stencil faces' fluxes and blocks from K2's face inputs fv (11,
    nc) and tangent columns fc (3, 11, nc), by direction in the
    reference's order: r_cell += F and diag += face_L on the left cells,
    r_cell += -F and diag += -face_R on the right cells (in place); face_L
    and face_R (9, nf) are written at the stencil faces. thr: every
    face's THPRES threshold (the grid's face order), or None."""
    prim, tans = _face_inputs(fv, fc)
    prim = [_cells3(a, dims) for a in prim]
    tans = [_cells3(a, dims) for a in tans]
    dep = _cells3(depth, dims)
    r3 = _cells3(r_cell, dims)
    diag3 = _cells3(diag, dims)
    ofs = 0
    for slL, slR, nf_d in _dir_segments(dims):
        T = trans[ofs:ofs + nf_d]
        th = None if thr is None else thr[ofs:ofs + nf_d]
        dz = (dep[slL] - dep[slR]).reshape(-1)
        args = []
        for a in prim:
            args += [_slice(a, slL), _slice(a, slR)]
        flux = face_flux_from_q(*args, T, dz, gravity, th)
        fL, fR = _blocks(args, T, dz, gravity,
                         [_slice(a, slL) for a in tans],
                         [_slice(a, slR) for a in tans], th)
        shp = r3[(slice(None),) + slL].shape
        r3[(slice(None),) + slL] += flux.reshape(shp)
        r3[(slice(None),) + slR] += -flux.reshape(shp)
        diag3[(slice(None),) + slL] += fL.reshape((9,) + shp[1:])
        diag3[(slice(None),) + slR] += -fR.reshape((9,) + shp[1:])
        face_L[:, ofs:ofs + nf_d] = fL
        face_R[:, ofs:ofs + nf_d] = fR
        ofs += nf_d


def faces_blocks_plain(fl: FaceList, fv, fc, depth, trans, gravity, r_cell,
                       diag, face_L, face_R, thr=None):
    """The list's faces (all faces of a gather grid, an embedded grid's
    extra faces after the stencil) by gather, chained through the same
    per-cell tangent columns: r_cell and diag updated in place by
    scatter-adds (left cells, then right cells), face_L and face_R written
    at the list's faces."""
    c1, c2 = fl.c1, fl.c2
    prim, tans = _face_inputs(fv, fc)
    T = trans[fl.first:]
    th = None if thr is None else thr[fl.first:]
    dz = depth[c1] - depth[c2]
    args = []
    for a in prim:
        args += [a[..., c1], a[..., c2]]
    flux = face_flux_from_q(*args, T, dz, gravity, th)
    fL, fR = _blocks(args, T, dz, gravity, [a[..., c1] for a in tans],
                     [a[..., c2] for a in tans], th)
    r_cell.index_add_(1, c1, flux).index_add_(1, c2, -flux)
    diag.index_add_(1, c1, fL).index_add_(1, c2, -fR)
    face_L[:, fl.first:] = fL
    face_R[:, fl.first:] = fR


def faces_blocks_packed_plain(fl: FaceList, fv, fc, depth, trans, gravity,
                              r_cell, diag, face_L, face_R, thr=None):
    """faces_blocks_plain, then K4-faces' sliced-ELL copy of the blocks it
    wrote (faces_pack_plain): the oracle of faces_blocks_cuda; returns the
    copy."""
    faces_blocks_plain(fl, fv, fc, depth, trans, gravity, r_cell, diag,
                       face_L, face_R, thr)
    return faces_pack_plain(fl.sell, face_L, face_R)


def _check_face_blocks(nc, nf, fv, fc, depth, trans, r_cell, diag, face_L,
                       face_R, thr=None):
    dev = fv.device
    checks = [(fv, (11, nc)), (fc, (3, 11, nc)), (depth, (nc,)),
              (trans, (nf,)), (r_cell, (3, nc)), (diag, (9, nc)),
              (face_L, (9, nf)), (face_R, (9, nf))]
    if thr is not None:
        checks.append((thr, (nf,)))
    for t, shape in checks:
        if (t.dtype != torch.float64 or t.device != dev
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"K3 face blocks: expected a contiguous float64 "
                             f"{shape} tensor on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


BLOCKS_SIGS = {
    "opm_face_blocks": [_I, _I, _I, _L] + [_P] * 5 + [cuda_lib.D]
    + [_P] * 5,
}


def face_blocks_cuda(dims, fv, fc, depth, trans, gravity, r_cell, diag,
                     face_L, face_R, thr=None):
    """K3 face blocks, stencil form, on the card; same contract as
    face_blocks_plain (trans and the face blocks span every face of the
    grid; the stencil faces come first)."""
    nx, ny, nz = dims
    nc = nx * ny * nz
    nf = trans.shape[0]
    _check_face_blocks(nc, nf, fv, fc, depth, trans, r_cell, diag, face_L,
                       face_R, thr)
    nf_d = sum(n for _, _, n in _dir_segments(dims))
    if nf < nf_d:
        raise ValueError(f"K3 face blocks: {nf} faces, the stencil of "
                         f"{tuple(dims)} has {nf_d}")
    lib = cuda_lib.load("blocks", BLOCKS_SIGS)
    ptr = cuda_lib.ptr
    err = lib.opm_face_blocks(nx, ny, nz, nf, ptr(fv), ptr(fc), ptr(depth),
                              ptr(trans), _ptr_or_null(thr), float(gravity),
                              ptr(r_cell),
                              ptr(diag), ptr(face_L), ptr(face_R),
                              cuda_lib.stream_ptr(fv.device))
    cuda_lib.check(err, "opm_face_blocks")
    face_blocks_cuda.launches += 1
    if thr is not None:
        face_blocks_cuda.thr_launches += 1


face_blocks_cuda.launches = 0
# launches with a THPRES threshold (of those counted in launches)
face_blocks_cuda.thr_launches = 0


def faces_blocks_cuda(fl: FaceList, fv, fc, depth, trans, gravity, r_cell,
                      diag, face_L, face_R, thr=None):
    """K3 face blocks, face-list form, on the card (over the rows of the
    cells the list's faces touch: every cell of a gather grid, an embedded
    grid's epilogue); same contract as faces_blocks_packed_plain: the row
    phase also writes the signed off-diagonal blocks into the list's
    sliced-ELL layout (K4-faces' operator), returned as a fresh
    (288 n_chunks,) tensor. The assembly's CPU path runs
    faces_blocks_plain, which writes no copy (the operator runs only on
    the card)."""
    nc = diag.shape[-1]
    nf = trans.shape[0]
    _check_face_blocks(nc, nf, fv, fc, depth, trans, r_cell, diag, face_L,
                       face_R, thr)
    if nf != fl.first + fl.n:
        raise ValueError("K3-faces face blocks: trans must span every face "
                         "of the grid")
    flux = torch.empty((3, fl.n), dtype=torch.float64, device=fv.device)
    sell = fl.sell
    blk = torch.empty(288 * sell.n_chunks, dtype=torch.float64,
                      device=fv.device)
    lib = cuda_lib.load("faces", _FACES_SIGS)
    ptr = cuda_lib.ptr
    err = lib.opm_faces_blocks(
        *csr_args(fl.touched), fl.first, fl.n, ptr(fl.c1_32), ptr(fl.c2_32),
        nc, nf, ptr(fv), ptr(fc), ptr(depth), ptr(trans), _ptr_or_null(thr),
        float(gravity), ptr(flux), ptr(r_cell), ptr(diag), ptr(face_L),
        ptr(face_R),
        ptr(sell.chunk0), ptr(blk), cuda_lib.stream_ptr(fv.device))
    cuda_lib.check(err, "opm_faces_blocks")
    faces_blocks_cuda.launches += 1
    if thr is not None:
        faces_blocks_cuda.thr_launches += 1
    return blk


faces_blocks_cuda.launches = 0
# launches with a THPRES threshold (of those counted in launches)
faces_blocks_cuda.thr_launches = 0


def bapply_rows(rows9, v):
    """(9, n) row-major 3x3 blocks applied to v (3, n) -> (3, n)."""
    return torch.stack([
        rows9[0] * v[0] + rows9[1] * v[1] + rows9[2] * v[2],
        rows9[3] * v[0] + rows9[4] * v[1] + rows9[5] * v[2],
        rows9[6] * v[0] + rows9[7] * v[1] + rows9[8] * v[2]])


# ---------------------------------------------------------------------------
# K4: the block 7-point operator (plain version)

def full3(v):
    """A pressure-only iterate (nc,) as (3, nc) with rows 1 and 2 zero."""
    if v.dim() == 1:
        return torch.stack([v, torch.zeros_like(v), torch.zeros_like(v)])
    return v


def matvec_cells_plain(diag, face_L, face_R, v, dims):
    """Cells-only block stencil y = A v (3, nc) in the reference's order
    (``_matvec_cells_structured``): the diagonal product, then per
    direction x, y, z the right neighbour's +face_R term on the left cell
    and the left neighbour's -face_L term on the right cell. Face blocks
    past the stencil (an embedded grid's extra faces) are not visited;
    v (nc,) is a pressure-only iterate."""
    v = full3(v)
    out = _cells3(bapply_rows(diag, v), dims)
    v3 = _cells3(v, dims)
    ofs = 0
    for slL, slR, nf_d in _dir_segments(dims):
        shp = out[(slice(None),) + slL].shape
        fL = face_L[:, ofs:ofs + nf_d].reshape((9,) + shp[1:])
        fR = face_R[:, ofs:ofs + nf_d].reshape((9,) + shp[1:])
        out[(slice(None),) + slL] += bapply_rows(fR, v3[(slice(None),) + slR])
        out[(slice(None),) + slR] -= bapply_rows(fL, v3[(slice(None),) + slL])
        ofs += nf_d
    return out.reshape(3, -1)


# ---------------------------------------------------------------------------
# K4 (and the K6 smoothing step, precond.py): CUDA wrappers (csrc/block7.cu)

# the parts of the well term a cell operator's launch runs (csrc/wells.cuh
# kPrologue, kEpilogue)
PROLOGUE, EPILOGUE = 1, 2
WELL_TERM = PROLOGUE | EPILOGUE


BLOCK7_SIGS = {
    "opm_block7_matvec": [_I, _I, _I, _L, _I] + [_P] * 6 + [_I, _P],
    "opm_block7_smooth": [_I, _I, _I, _L, _I] + [_P] * 7 + [_P],
}


def check_block_operator(diag, face_L, face_R, dims, *vecs):
    """Contiguous float64 (9, nc)/(9, nf) blocks, with nf at least the
    stencil's faces on a structured grid, and (3, nc) vectors on one
    device (the contract of the block7 and faces kernels)."""
    nc = diag.shape[-1]
    nf = face_L.shape[-1]
    if dims is not None:
        nx, ny, nz = dims
        nc_d = nx * ny * nz
        nf_d = (nx - 1) * ny * nz + nx * (ny - 1) * nz + nx * ny * (nz - 1)
        if nc != nc_d or nf < nf_d:
            raise ValueError(f"block7: blocks of {nc} cells and {nf} faces "
                             f"do not fit the grid {tuple(dims)}")
    dev = diag.device
    for t, shape in [(diag, (9, nc)), (face_L, (9, nf)), (face_R, (9, nf))] \
            + [(v, (3, nc)) for v in vecs]:
        if (t.dtype != torch.float64 or t.device != dev
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"block7: expected a contiguous float64 {shape} "
                             f"tensor on {dev}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


def check_iterate(x, nc, dev):
    """A pressure-only iterate: a contiguous float64 (nc,) tensor."""
    if (x.shape != (nc,) or x.dtype != torch.float64
            or not x.is_contiguous() or x.device != dev):
        raise ValueError("a pressure-only iterate must be a contiguous "
                         "float64 (nc,) tensor")


def matvec_cells_cuda(diag, face_L, face_R, v, dims, wells=None,
                      phases=WELL_TERM):
    """K4 on the card; same contract as matvec_cells_plain. With ``wells``
    (a WellTerm of the same system) the launch carries the reduced
    operator's well term, or the ``phases`` of it: with both the result is
    reduced_matvec_plain's."""
    nc = diag.shape[-1]
    p_only = v.dim() == 1
    if p_only:
        check_iterate(v, nc, diag.device)
    check_block_operator(diag, face_L, face_R, dims,
                         *(() if p_only else (v,)))
    nx, ny, nz = dims
    out = torch.empty((3, nc), dtype=torch.float64, device=v.device)
    lib = cuda_lib.load("block7", BLOCK7_SIGS)
    ptr = cuda_lib.ptr
    err = lib.opm_block7_matvec(nx, ny, nz, face_L.shape[1], int(p_only),
                                ptr(diag), ptr(face_L), ptr(face_R), ptr(v),
                                ptr(out), _well_arg(wells, v, nc), phases,
                                cuda_lib.stream_ptr(v.device))
    cuda_lib.check(err, "opm_block7_matvec")
    matvec_cells_cuda.launches += 1
    return out


matvec_cells_cuda.launches = 0


# ---------------------------------------------------------------------------
# K4-faces: the block operator over a face list (csrc/faces.cu)

def faces_matvec_plain(fl: FaceList, diag, face_L, face_R, v, out=None):
    """y = A v over the list's faces (the reference's gather matvec): the
    diagonal product, the left cells' +face_R v_R terms in face order, then
    the right cells' -face_L v_L terms; with ``out`` (the stencil product
    of an embedded grid, not modified) the face terms are added onto it
    instead (``_matvec_cells_structured``'s extra-face correction)."""
    v = full3(v)
    f = fl.first
    y = bapply_rows(diag, v) if out is None else out.clone()
    y.index_add_(1, fl.c1, bapply_rows(face_R[:, f:], v[:, fl.c2]))
    y.index_add_(1, fl.c2, -bapply_rows(face_L[:, f:], v[:, fl.c1]))
    return y


def faces_smooth_plain(fl: FaceList, diag, face_L, face_R, dinv, x, r,
                       base=None):
    """x + D^-1 (r - A x), A x by faces_matvec_plain (onto ``base``, the
    stencil product of an embedded grid, when given); x (nc,) is a
    pressure-only iterate."""
    x = full3(x)
    ac = faces_matvec_plain(fl, diag, face_L, face_R, x, out=base)
    return x + bapply_rows(dinv, r - ac)


def faces_pack_plain(sell: SellLayout, face_L, face_R):
    """The signed face blocks in the sliced-ELL layout (a torch gather):
    (288 n_chunks,), padded entry e's block entry b at 288 (e // 32) +
    32 b + e % 32; pads 0. The reference of the copy that
    faces_blocks_cuda's row phase writes."""
    src = sell.src.long()
    pad = src == SELL_PAD
    left = src >= 0
    f = torch.where(left | pad, src.clamp(min=0), -src - 1)
    vals = torch.where(left, face_R[:, f], -face_L[:, f])
    vals[:, pad] = 0.0
    return vals.reshape(9, -1, 32).permute(1, 0, 2).reshape(-1)


class FacesOperator:
    """K4-faces' operator of one Newton system on the card: the face
    list's sliced-ELL layout (``FaceList.sell``) with the signed face
    blocks in it, ``blk`` as the face blocks' row phase wrote it
    (``faces_blocks_cuda``), beside the diagonal. The blocks are checked
    here, once; a call checks only its vectors and passes the cached
    pointers. A launch runs a thread per row of the layout for an in-place
    update (only the rows the faces touch change), else a thread per
    cell."""

    def __init__(self, fl: FaceList, diag, face_L, face_R, blk):
        check_block_operator(diag, face_L, face_R, None)
        sell = fl.sell
        if sell.nc != diag.shape[1]:
            raise ValueError("K4-faces: the layout's cells are not the "
                             "system's")
        self.nc = diag.shape[1]
        self.device = diag.device
        self.diag = diag
        if (blk.shape != (288 * sell.n_chunks,)
                or blk.dtype != torch.float64 or blk.device != diag.device
                or not blk.is_contiguous()):
            raise ValueError("K4-faces: the packed blocks do not fit the "
                             "layout")
        self.blk = blk
        self.lib = cuda_lib.load("faces", _FACES_SIGS)
        self.stream = cuda_lib.stream_ptr(diag.device)
        self.layout = (sell.chunk0.data_ptr(), sell.ptr.data_ptr(),
                       sell.col.data_ptr(), self.blk.data_ptr(), self.nc)
        # (threads, rows, row_of)
        self.by_row = (sell.n_rows,
                       0 if sell.rows is None else sell.rows.data_ptr(), 0)
        self.by_cell = (self.by_row if sell.row_of is None else
                        (self.nc, 0, sell.row_of.data_ptr()))
        self.dinv = None
        self.sell = sell     # owns the layout behind the cached pointers

    def vec(self, t, shape):
        """A vector's data pointer, after the check of its contract."""
        if (t.shape != shape or t.dtype != torch.float64
                or t.device != self.device or not t.is_contiguous()):
            raise ValueError(f"K4-faces: expected a contiguous float64 "
                             f"{shape} tensor on {self.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        return t.data_ptr()

    def apply(self, x, base, dinv, r, out, in_place=False, wells=None,
              phases=0):
        nc = self.nc
        p_only = x.dim() == 1
        err = self.lib.opm_faces_sell_apply(
            *(self.by_row if in_place else self.by_cell), *self.layout,
            0 if base is not None else self.diag.data_ptr(), base,
            self.vec(x, (nc,) if p_only else (3, nc)), int(p_only), dinv, r,
            out, _well_arg(wells, x, nc), phases, self.stream)
        cuda_lib.check(err, "opm_faces_sell_apply")


def faces_matvec_cuda(op: FacesOperator, v, out=None, wells=None,
                      phases=0):
    """K4-faces on the card; the contract of faces_matvec_plain over the
    packed operator, except that ``out`` (the stencil product of an
    embedded grid) is updated in place. With ``wells`` (a WellTerm of the
    same system) the launch carries the ``phases`` of the reduced
    operator's well term."""
    shape = (3, op.nc)
    y = torch.empty(shape, dtype=torch.float64, device=op.device) \
        if out is None else out
    yp = op.vec(y, shape)
    op.apply(v, None if out is None else yp, None, None, yp,
             in_place=out is not None, wells=wells, phases=phases)
    faces_matvec_cuda.launches += 1
    return y


faces_matvec_cuda.launches = 0


def faces_smooth_cuda(op: FacesOperator, dinv, x, r, base=None):
    """K4-faces smoothing step on the card; the contract of
    faces_smooth_plain over the packed operator."""
    shape = (3, op.nc)
    if dinv is not op.dinv:
        op.vec(dinv, (9, op.nc))
        op.dinv = dinv
    out = torch.empty(shape, dtype=torch.float64, device=op.device)
    op.apply(x, None if base is None else op.vec(base, shape),
             dinv.data_ptr(), op.vec(r, shape), out.data_ptr())
    faces_smooth_cuda.launches += 1
    return out


faces_smooth_cuda.launches = 0


def matvec_cells(sys: BlockSystem, v, dims, *, twin=False):
    """Cell-block part of the operator, (3, nc) -> (3, nc): K4 over the
    stencil (dims given) and K4-faces over the face list; ``twin``: their
    plain twins on any device."""
    v = v.contiguous()
    ops = (sys.diag, sys.face_L, sys.face_R)
    out = None
    if dims is not None:
        out = (matvec_cells_plain(*ops, v, tuple(dims)) if twin else
               cuda_lib.dispatch(v, matvec_cells_cuda, matvec_cells_plain,
                                 *ops, v, tuple(dims), what="K4"))
    if sys.faces is not None:
        def plain():
            return faces_matvec_plain(sys.faces, *ops, v, out)
        out = plain() if twin else cuda_lib.dispatch(
            v, lambda: faces_matvec_cuda(sys.packed, v, out), plain,
            what="K4-faces")
    return out


# ---------------------------------------------------------------------------
# wells: the coupling blocks B and C (plain: at most nw * mp perforations),
# and K5, the Schur complement of the well unknowns (csrc/wells.cu)

def well_apply_B(sys: BlockSystem, v_cell):
    """Well-equation rows x cell vars: B v_cell -> (nw, 4)."""
    nw, mp = sys.perf_cell.shape
    pc_f = sys.perf_cell.reshape(-1)
    vc_perf = v_cell[:, pc_f].T                                # (npf, 3)
    wf = torch.einsum("pij,pj->pi", sys.wc.reshape(-1, 3, 3), vc_perf)
    out = torch.zeros((nw, 4), dtype=v_cell.dtype, device=v_cell.device)
    out[:, :3] += wf.reshape(nw, mp, 3).sum(dim=1)
    return out


def well_apply_C(sys: BlockSystem, v_well):
    """Cell rows x well vars: C v_well scattered to cells -> (3, nc)."""
    nw, mp = sys.perf_cell.shape
    pc_f = sys.perf_cell.reshape(-1)
    vw_rep = torch.repeat_interleave(v_well, mp, dim=0)        # (npf, 4)
    cw_add = torch.einsum("pij,pj->pi", sys.cw.reshape(-1, 3, 4), vw_rep)
    out = torch.zeros((3, sys.nc), dtype=v_well.dtype, device=v_well.device)
    return out.index_add(1, pc_f, cw_add.T)


def matvec(sys: BlockSystem, v_cell, v_well, dims):
    """J [v_cell (3, nc); v_well (nw, 4)] -> (out_cell, out_well); dims
    None on a gather grid."""
    out_c = matvec_cells(sys, v_cell, dims) + well_apply_C(sys, v_well)
    out_w = torch.einsum("wij,wj->wi", sys.wd_diag, v_well) \
        + well_apply_B(sys, v_cell)
    return out_c, out_w


def _dinv_apply(Dinv, rw):
    return torch.einsum("wij,wj->wi", Dinv, rw)


def schur_matvec_plain(sys: BlockSystem, Dinv, v, out):
    """The reduced operator's well term: out - C D^-1 (B v) (a new
    tensor)."""
    return out - well_apply_C(sys, _dinv_apply(Dinv, well_apply_B(sys, v)))


def schur_rhs_plain(sys: BlockSystem, Dinv):
    """The reduced right-hand side r_cell - C D^-1 r_well."""
    return sys.r_cell - well_apply_C(sys, _dinv_apply(Dinv, sys.r_well))


def schur_recover_plain(sys: BlockSystem, Dinv, x):
    """The well unknowns x_w = D^-1 (r_well - B x) (recoverVariable)."""
    return _dinv_apply(Dinv, sys.r_well - well_apply_B(sys, x))


def reduced_matvec_plain(sys: BlockSystem, Dinv, v, dims):
    """The Schur-reduced operator (A - C D^-1 B) v: the cell operator's
    twins (matvec_cells), then schur_matvec_plain; what the fused operator
    on the card is held to."""
    return schur_matvec_plain(sys, Dinv, v,
                              matvec_cells(sys, v, dims, twin=True))


def run_lengths(sorted_cell):
    """(n,) int32: at the first position of each run of equal values of
    the sorted ``sorted_cell`` the run's length, elsewhere 0 (device ops,
    no host read)."""
    n = sorted_cell.numel()
    idx = torch.arange(n, device=sorted_cell.device)
    start = torch.ones(n, dtype=torch.bool, device=sorted_cell.device)
    start[1:] = sorted_cell[1:] != sorted_cell[:-1]
    # the next run's first position after each position, then the nearest
    # one to its right: the end of the run holding it
    nxt = torch.where(start, idx, n)
    after = torch.cat([nxt[1:], nxt.new_full((1,), n)])
    end = torch.flip(torch.cummin(torch.flip(after, [0]), 0).values, [0])
    return torch.where(start, end - idx, 0).to(torch.int32).contiguous()


class _WellsC(ctypes.Structure):
    """opm_wells::Wells of csrc/wells.cuh, field for field."""

    _fields_ = [("nw", ctypes.c_int), ("mp", ctypes.c_int),
                ("phases", ctypes.c_int)] + [
        (f, ctypes.c_void_p) for f in ("perf_cell", "wc", "cw", "dinv",
                                        "order", "sorted_cell", "run_len",
                                        "wf", "ct", "w4", "ticket")]


class WellTerm:
    """K5's arguments of one Newton system: the well arrays and D^-1,
    checked once here (contiguous float64 blocks, int64 perforation
    indices and (3, nc) / (nw, 4) residuals on the system's device), and
    the workspace of the well term (the perforated cells in the order of
    ``perf_order`` and the length of each cell's run at its first
    position, B v per perforation, C w per position, the well vector, the
    last-block ticket), made once. A launch passes ``arg``, the address
    of the C structure (None without wells: no well term).

    ``Dinv`` None (the main path on the card): ``Dinv`` is a buffer that
    K5's right-hand-side launch (schur_rhs_cuda) fills from the system's
    well blocks before its own use; every other K5 entry raises until then
    (``formed``)."""

    def __init__(self, sys: BlockSystem, Dinv=None):
        nw, mp = sys.perf_cell.shape
        nc = sys.nc
        dev = sys.r_cell.device
        formed = Dinv is not None
        if not formed:
            Dinv = torch.empty((nw, 4, 4), dtype=torch.float64, device=dev)
        for t, shape in ((sys.wc, (nw, mp, 3, 3)), (sys.cw, (nw, mp, 3, 4)),
                         (Dinv, (nw, 4, 4)), (sys.r_well, (nw, 4)),
                         (sys.r_cell, (3, nc))) + (
                () if formed else ((sys.wd_diag, (nw, 4, 4)),)):
            if (t.dtype != torch.float64 or t.device != dev
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(f"K5: expected a contiguous float64 {shape} "
                                 f"tensor on {dev}, got {tuple(t.shape)} "
                                 f"{t.dtype} on {t.device}")
        for t in (sys.perf_cell, sys.perf_order):
            if (t is None or t.dtype != torch.int64 or not t.is_contiguous()
                    or t.device != dev or t.numel() != nw * mp):
                raise ValueError("K5: perf_cell and perf_order must be "
                                 f"contiguous int64 tensors of {nw * mp} "
                                 f"perforations on {dev}")
        self.sys, self.Dinv, self.nc, self.device = sys, Dinv, nc, dev
        self.formed = formed
        self.sorted_cell = sys.perf_cell.reshape(-1)[sys.perf_order]
        self.run_len = run_lengths(self.sorted_cell)
        self.wf = torch.empty(3 * nw * mp, dtype=torch.float64, device=dev)
        self.ct = torch.empty_like(self.wf)
        self.w4 = torch.empty((nw, 4), dtype=torch.float64, device=dev)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        ptrs = [t.data_ptr() for t in (sys.perf_cell, sys.wc, sys.cw, Dinv,
                                       sys.perf_order, self.sorted_cell,
                                       self.run_len, self.wf, self.ct,
                                       self.w4, self.ticket)]
        self.c = _WellsC(nw, mp, WELL_TERM, *ptrs)
        self.arg = ctypes.addressof(self.c) if nw else None

    def check_formed(self):
        """Raise unless D^-1 is in place (given, or formed by the
        right-hand side's launch)."""
        if not self.formed and self.arg is not None:
            raise ValueError("K5: D^-1 is formed by the right-hand side's "
                             "launch (schur_rhs_cuda); run it first")

    def vec(self, t, shape):
        """A vector's data pointer, after the check of its contract."""
        if (tuple(t.shape) != shape or t.dtype != torch.float64
                or t.device != self.device or not t.is_contiguous()):
            raise ValueError(f"K5: expected a contiguous float64 {shape} "
                             f"tensor on {self.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        return t.data_ptr()


def _well_arg(wells, v, nc):
    """A launch's well-term argument: the WellTerm's C structure (v must
    be a (3, nc) vector of its device), or None."""
    if wells is None or wells.arg is None:
        return None
    if v.shape != (3, nc) or wells.nc != nc or wells.device != v.device:
        raise ValueError("K5: the well term needs a (3, nc) vector of its "
                         "system's device")
    wells.check_formed()
    return wells.arg


WELLS_SIGS = {
    "opm_schur_matvec": [_P, _L, _P, _P, _P],
    "opm_schur_recover": [_P, _L, _P, _P, _P, _P],
    "opm_schur_rhs": [_P, _L, _P, _P, _P, _P, _P, _P],
}


def schur_matvec_cuda(wt: WellTerm, v, out):
    """K5's stand-alone reduced-operator entry on the card (one block); the
    contract of schur_matvec_plain with the WellTerm's system and D^-1,
    except that ``out`` is updated in place (only the perforated cells'
    rows) and returned. The main path runs the same term inside the cell
    operator's launches (reduced_matvec_cuda)."""
    shape = (3, wt.nc)
    vp, op = wt.vec(v, shape), wt.vec(out, shape)
    wt.check_formed()
    if wt.arg is not None:
        lib = cuda_lib.load("wells", WELLS_SIGS)
        err = lib.opm_schur_matvec(wt.arg, wt.nc, vp, op,
                                   cuda_lib.stream_ptr(v.device))
        cuda_lib.check(err, "opm_schur_matvec")
        schur_matvec_cuda.launches += 1
    return out


schur_matvec_cuda.launches = 0


def schur_rhs_cuda(wt: WellTerm):
    """K5's right-hand-side entry on the card; the contract of
    schur_rhs_plain with the WellTerm's system and D^-1. Where the
    WellTerm was made without D^-1, the first launch forms it into
    ``wt.Dinv`` from the system's well blocks (the contract of the plain
    ``inv4x4``) before its own use; ``inverses`` counts those launches."""
    sys = wt.sys
    out = torch.empty_like(sys.r_cell)
    lib = cuda_lib.load("wells", WELLS_SIGS)
    ptr = cuda_lib.ptr
    form = not wt.formed and wt.arg is not None
    err = lib.opm_schur_rhs(
        wt.arg, wt.nc, ptr(sys.r_cell), ptr(sys.r_well),
        ptr(sys.wd_diag) if form else None, ptr(wt.Dinv) if form else None,
        ptr(out), cuda_lib.stream_ptr(out.device))
    cuda_lib.check(err, "opm_schur_rhs")
    wt.formed = True
    schur_rhs_cuda.launches += 1
    schur_rhs_cuda.inverses += int(form)
    return out


schur_rhs_cuda.launches = 0
schur_rhs_cuda.inverses = 0


def schur_recover_cuda(wt: WellTerm, x):
    """K5's recovery entry on the card; the contract of
    schur_recover_plain with the WellTerm's system and D^-1."""
    sys = wt.sys
    xp = wt.vec(x, (3, wt.nc))
    wt.check_formed()
    xw = torch.empty_like(sys.r_well)
    if wt.arg is not None:
        lib = cuda_lib.load("wells", WELLS_SIGS)
        err = lib.opm_schur_recover(wt.arg, wt.nc, xp,
                                    cuda_lib.ptr(sys.r_well),
                                    cuda_lib.ptr(xw),
                                    cuda_lib.stream_ptr(x.device))
        cuda_lib.check(err, "opm_schur_recover")
        schur_recover_cuda.launches += 1
    return xw


schur_recover_cuda.launches = 0


def reduced_matvec_cuda(wt: WellTerm, v, dims):
    """The Schur-reduced operator on the card, the contract of
    reduced_matvec_plain: the cell operator's launches carry K5's well
    term, its well vector in the first one's block 0 and the subtraction
    at the perforated cells in the last one's last block (K4 on a
    structured grid, K4-faces on a gather grid, K4 then K4-faces on an
    embedded grid), so a reduced matvec is one launch on structured and
    gather grids and two on embedded grids. Counts the reduced matvecs
    that carry the well term."""
    sys = wt.sys
    wt.check_formed()
    ops = (sys.diag, sys.face_L, sys.face_R)
    out = None
    first = WELL_TERM
    if dims is not None:
        last = sys.faces is None
        out = matvec_cells_cuda(*ops, v, tuple(dims), wells=wt,
                                phases=WELL_TERM if last else PROLOGUE)
        first = EPILOGUE
    if sys.faces is not None:
        out = faces_matvec_cuda(sys.packed, v, out, wells=wt, phases=first)
    if wt.arg is not None:
        reduced_matvec_cuda.launches += 1
    return out


reduced_matvec_cuda.launches = 0


def schur_eliminate_wells(sys: BlockSystem, dims, *, twin=False):
    """Schur-eliminate the well unknowns (per-well dense D^-1; reduced cell
    operator A - C D^-1 B). Returns (reduced_matvec, rhs (3, nc),
    recover(x_cell) -> x_well (nw, 4)): on the card the right-hand side's
    K5 launch forms D^-1 first, the cell operator by K4/K4-faces with K5's
    well term carried by its launches, the recovery by K5's entry, all
    over one WellTerm (the well arrays checked once, the workspace made
    once); on the CPU, and with ``twin`` on any device, D^-1 by the plain
    ``inv4x4`` and everything by the plain twins (``twin``: the card's
    whole-solve comparison)."""
    from opm_tpu_torch.linalg.precond import inv4x4

    on_card = not twin and sys.r_cell.device.type == "cuda"
    Dinv = None if on_card else inv4x4(sys.wd_diag).contiguous()
    wt = None if twin else WellTerm(sys, Dinv)

    def k5(cuda_fn, plain_fn, *args):
        if twin:
            return plain_fn(sys, Dinv, *args)
        return cuda_lib.dispatch(
            sys.r_cell, lambda: cuda_fn(wt, *args),
            lambda: plain_fn(sys, Dinv, *args), what="K5")

    rhs = k5(schur_rhs_cuda, schur_rhs_plain)

    def recover(x_cell):
        return k5(schur_recover_cuda, schur_recover_plain,
                  x_cell.contiguous())

    def reduced_matvec(v_cell):
        return k5(reduced_matvec_cuda, reduced_matvec_plain,
                  v_cell.contiguous(), dims)

    return reduced_matvec, rhs, recover
