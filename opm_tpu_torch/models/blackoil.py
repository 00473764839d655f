"""Fully-implicit black-oil model: residual assembly on tensors.

Port of the JAX package's models/blackoil.py. Cell quantities are kernel
K2 (``csrc/cells.cu``: the values, and their tangent columns in the
primaries for the forward-mode rule and the assembly), wrapped in a
``torch.autograd.Function`` whose ``jvp`` contracts K2's columns with the
input tangents; its plain twin goes through the K1 table lookups (props).
On the structured stencil (a fully-active or
embedded cartesian grid) face fluxes and their divergence are kernel K3
(``csrc/tpfa.cu``), wrapped in a ``torch.autograd.Function`` whose ``jvp``
launches K3's tangent entry and whose ``vmap`` folds the batch of tangent
sets into the kernel's B, so the dense Newton route's ``torch.func.jacfwd``
goes through the kernel. Faces outside the stencil (all faces of a gather
grid, the stair-step fault and NNC "extra" faces of an embedded grid) go
through K3-faces (``csrc/faces.cu``), a gather over each cell's incident
faces (``FaceList``). The convergence check is kernel K9's convergence
entry (``solver/kernels_k9.py``, ``csrc/newton.cu``): one launch forms the
MB/CNV norms (masked on embedded grids so the inert padding cells do not
count), the well norms and both flags into the Newton loop's history row.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from opm_tpu_torch.models.state import (GAS, HC_GASOIL, HC_GASONLY,
                                        HC_OILONLY, OIL, WATER,
                                        BlackoilState)
from opm_tpu_torch.props.pvt import reg_pick
from opm_tpu_torch.utils import cuda_lib
from opm_tpu_torch.wells import standard as stdwells
from opm_tpu_torch.wells.wells import WellSet


@dataclass
class ModelParams:
    """Nonlinear/model tolerances; defaults from
    opm/autodiff/BlackoilModelParameters.cpp:76-103."""

    dp_max_rel: float = 0.3
    ds_max: float = 0.2
    dr_max_rel: float = 1e9
    max_residual_allowed: float = 1e7
    tolerance_mb: float = 1e-5
    tolerance_cnv: float = 1e-2
    tolerance_wells: float = 1e-4
    max_iter: int = 15
    max_welleq_iter: int = 15
    solve_welleq_initially: bool = True
    allow_crossflow: bool = True


class CellQuantities(NamedTuple):
    """Phase-indexed fields are phase-leading: (3, nc)."""

    pw: torch.Tensor
    po: torch.Tensor
    pg: torch.Tensor
    b: torch.Tensor        # (3, nc)
    mob: torch.Tensor      # (3, nc)
    rho: torch.Tensor      # (3, nc)
    rs: torch.Tensor
    rv: torch.Tensor
    sat: torch.Tensor      # (3, nc)
    pv_mult: torch.Tensor


class Residual(NamedTuple):
    cell: torch.Tensor       # (3, nc) surface-volume rate residuals
    well_flux: torch.Tensor  # (nw, 3)
    well_ctrl: torch.Tensor  # (nw,)
    b: torch.Tensor          # (3, nc) inverse FVFs (for convergence norms)


def cell_quantities_plain(props, p, sw, x, hcstate, pvtnum,
                          satnum) -> CellQuantities:
    """Secondary variables from the switched primaries (the reference's
    compute_cell_quantities without hysteresis and VAPPARS memory): the
    plain version of K2, through the props' K1 lookups."""
    is_sg = hcstate == HC_GASOIL
    is_rs = hcstate == HC_OILONLY
    is_rv = hcstate == HC_GASONLY
    sg = torch.where(is_sg, x, torch.where(is_rv, 1.0 - sw, 0.0))
    so = 1.0 - sw - sg
    rs = torch.where(is_rs, x, props.rs_sat(p, pvtnum))
    rv = torch.where(is_rv, x, props.rv_sat(p, pvtnum))
    krw, kro, krg, pcow, pcgo = props.satfunc.evaluate(sw, so, sg, satnum)
    pw = p - pcow
    pg = p + pcgo
    bw, muw = props.water_b_mu(pw, pvtnum)
    bo, muo = props.oil_b_mu(p, rs, pvtnum)
    bg, mug = props.gas_b_mu(pg, rv, pvtnum)
    mob = torch.stack([krw / muw, kro / muo, krg / mug], dim=0)
    sd = props.surface_density
    sd_w = reg_pick(sd[:, WATER], pvtnum)
    sd_o = reg_pick(sd[:, OIL], pvtnum)
    sd_g = reg_pick(sd[:, GAS], pvtnum)
    rho = torch.stack([
        sd_w * bw,
        (sd_o + rs * sd_g) * bo,
        (sd_g + rv * sd_o) * bg,
    ], dim=0)
    b = torch.stack([bw, bo, bg], dim=0)
    sat = torch.stack([sw, so, sg], dim=0)
    pvm = props.pv_mult(p, pvtnum)
    return CellQuantities(pw=pw, po=p, pg=pg, b=b, mob=mob, rho=rho,
                          rs=rs, rv=rv, sat=sat, pv_mult=pvm)


def accumulation_from_q(q: CellQuantities) -> torch.Tensor:
    """Surface volume per pore volume, phase-leading (3, ...)."""
    bw, bo, bg = q.b[WATER], q.b[OIL], q.b[GAS]
    sw, so, sg = q.sat[WATER], q.sat[OIL], q.sat[GAS]
    acc_w = bw * sw
    acc_o = bo * so + q.rv * bg * sg
    acc_g = bg * sg + q.rs * bo * so
    return q.pv_mult * torch.stack([acc_w, acc_o, acc_g], dim=0)


# ---------------------------------------------------------------------------
# K2: cell quantities with their tangent columns (plain versions)

N_Q = 18          # CellQuantities rows: pw, po, pg, b, mob, rho, rs, rv,
#                   sat, pv_mult
N_F = 11          # face-input rows: p3, rho, b mob, rs, rv


def q_rows(q: CellQuantities) -> torch.Tensor:
    """CellQuantities as its (18, n) rows."""
    return torch.cat([torch.stack([q.pw, q.po, q.pg]), q.b, q.mob, q.rho,
                      torch.stack([q.rs, q.rv]), q.sat, q.pv_mult[None]])


def q_of_rows(rows, shape) -> CellQuantities:
    """The (18, n) rows as CellQuantities (views), reshaped to ``shape``."""
    shape = tuple(shape)

    def one(i):
        return rows[i].reshape(shape)

    def three(i):
        return rows[i:i + 3].reshape((3,) + shape)

    return CellQuantities(pw=one(0), po=one(1), pg=one(2), b=three(3),
                          mob=three(6), rho=three(9), rs=one(12),
                          rv=one(13), sat=three(14), pv_mult=one(17))


def face_rows(q: CellQuantities) -> torch.Tensor:
    """The face inputs (p3, rho, b mob, rs, rv) as (11, n) rows."""
    return torch.cat([torch.stack([q.pw, q.po, q.pg]), q.rho, q.b * q.mob,
                      torch.stack([q.rs, q.rv])])


def face_tangent_rows(q: CellQuantities, t: CellQuantities) -> torch.Tensor:
    """The face inputs' tangent (11, n) from the quantities' tangent t;
    b mob by the product rule."""
    return torch.cat([torch.stack([t.pw, t.po, t.pg]), t.rho,
                      t.b * q.mob + q.b * t.mob, torch.stack([t.rs, t.rv])])


def cell_quantities_tangents_plain(props, p, sw, x, hcstate, pvtnum,
                                   satnum):
    """The plain version of K2 with tangents: the cell quantities and the
    accumulation with their three per-cell tangent columns in (p, sw, x),
    by one batched ``torch.func.jvp`` seeded with all-ones per primary (the
    reference's ``jax.linearize`` seeding). Returns (q, q_tan, acc,
    acc_tan): q_tan the three tangent CellQuantities, acc (3, n) and
    acc_tan (3 var, 3 eq, n)."""
    n = p.shape[-1]

    def q_all(pc, swc, xc):
        q = cell_quantities_plain(props, pc, swc, xc, hcstate, pvtnum,
                                  satnum)
        return q, accumulation_from_q(q)

    seeds = torch.eye(3, dtype=p.dtype, device=p.device)[:, :, None] \
        .expand(3, 3, n)

    def tangent(seed):
        return torch.func.jvp(q_all, (p, sw, x), tuple(seed))

    (q_b, acc_b), (q_t, acc_t) = torch.func.vmap(tangent)(seeds)
    q_val = CellQuantities(*(a[0] for a in q_b))
    q_tan = [CellQuantities(*(a[j] for a in q_t)) for j in range(3)]
    return q_val, q_tan, acc_b[0], acc_t


def cells_values_plain(props, p, sw, x, hcstate, pvtnum, satnum):
    """K2's values entry, plain: the (18, n) CellQuantities rows."""
    return q_rows(cell_quantities_plain(props, p, sw, x, hcstate, pvtnum,
                                        satnum))


def cells_columns_plain(props, p, sw, x, hcstate, pvtnum, satnum):
    """K2's values entry with columns, plain: the (3, 18, n) tangent
    columns of the CellQuantities rows in p, sw and x."""
    _, q_tan, _, _ = cell_quantities_tangents_plain(
        props, p, sw, x, hcstate, pvtnum, satnum)
    return torch.stack([q_rows(t) for t in q_tan])


def degenerate_x_weight(hcstate, so, sg):
    """Continuous regularization weight in [0, 1] for the (gas-eq, x)
    diagonal of cells whose x variable is losing its equation: in an rs
    cell the gas-equation x-column scales with so, in an rv cell with sg.
    weight = clip(1 - s_scaling / 1e-5, 0, 1)."""
    is_rs = hcstate == HC_OILONLY
    is_rv = hcstate == HC_GASONLY
    s_scale = torch.where(is_rs, so, torch.where(is_rv, sg,
                                                 torch.ones_like(so)))
    # a true division: tensor / python float is a multiplication by the
    # reciprocal on the card, one rounding off the reference's quotient
    return torch.clamp(1.0 - s_scale / torch.full_like(s_scale, 1e-5),
                       0.0, 1.0)


def cells_assemble_plain(props, p, sw, x, hcstate, pvtnum, satnum, acc0,
                         pv, dt):
    """K2's assembly entry, plain: the face inputs fv (11, n) and their
    tangent columns fc (3, 11, n), r_cell = pv/dt (acc - acc0) (3, n) and
    the nine diag rows pv/dt d acc_i / d u_j (row 3 i + j), with the
    degenerate-x weight times pv/dt added to row 8."""
    q, q_tan, acc, acc_tan = cell_quantities_tangents_plain(
        props, p, sw, x, hcstate, pvtnum, satnum)
    fv = face_rows(q)
    fc = torch.stack([face_tangent_rows(q, t) for t in q_tan])
    # a true division on every device (the reference divides by a traced
    # dt; on the card tensor / float multiplies by the reciprocal)
    pvdt = pv / torch.full_like(pv, dt)
    r_cell = pvdt * (acc - acc0)
    diag = torch.stack([pvdt * acc_tan[j][i] for i in range(3)
                        for j in range(3)])
    diag[8] = diag[8] + degenerate_x_weight(hcstate, q.sat[OIL],
                                            q.sat[GAS]) * pvdt
    return fv, fc, r_cell, diag


# ---------------------------------------------------------------------------
# K2: CUDA wrappers (csrc/cells.cu)

_CELLS_SIGS = {
    "opm_cells_meta_len": ([], cuda_lib.I),
    "opm_cells_eval": [cuda_lib.P, cuda_lib.P, cuda_lib.L]
    + [cuda_lib.P] * 9,
    "opm_cells_assemble": [cuda_lib.P, cuda_lib.P, cuda_lib.L]
    + [cuda_lib.P] * 8 + [cuda_lib.D] + [cuda_lib.P] * 5,
    "opm_cells_occupancy": [cuda_lib.P],
}


def cells_occupancy(device):
    """K2's three kernels on a CUDA device: per entry (values, columns,
    assemble) its threads per block, resident blocks per SM, registers per
    thread and local memory per thread in bytes (spills)."""
    lib = cuda_lib.load("cells", _CELLS_SIGS)
    out = (ctypes.c_int * 12)()
    with torch.cuda.device(device):
        cuda_lib.check(lib.opm_cells_occupancy(out), "opm_cells_occupancy")
    keys = ("threads", "blocks_per_sm", "registers", "local_bytes")
    return {e: dict(zip(keys, out[4 * k:4 * k + 4]))
            for k, e in enumerate(("values", "columns", "assemble"))}


def _cells_lib(pack):
    lib = cuda_lib.load("cells", _CELLS_SIGS)
    if lib.opm_cells_meta_len() != len(pack.meta):
        raise RuntimeError("K2: the table layout of props/blackoil.py "
                           "CellPack and csrc/cells.cu disagree")
    return lib, ctypes.cast(pack.c_meta, ctypes.c_void_p)


def _cells_inputs(pack, p, sw, x, hcstate, pvtnum, satnum):
    """Checked K2 inputs: contiguous float64 (n,) primaries on the tables'
    device, the hydrocarbon state as int32 and the regions as int64."""
    n = p.shape[0]
    dev = p.device
    if pack.tab.device != dev:
        raise ValueError(f"K2: the tables are on {pack.tab.device}, the "
                         f"cells on {dev}")
    for t in (p, sw, x):
        if (t.dtype != torch.float64 or t.device != dev or t.dim() != 1
                or t.shape[0] != n or not t.is_contiguous()):
            raise ValueError("K2: p, sw and x must be contiguous float64 "
                             f"(n,) tensors on {dev}")
    ints = []
    for t, dt in ((hcstate, torch.int32), (pvtnum, torch.int64),
                  (satnum, torch.int64)):
        if t.device != dev or t.shape != (n,):
            raise ValueError(f"K2: hcstate and the regions must be (n,) "
                             f"tensors on {dev}")
        ints.append(t.to(dt).contiguous())
    return n, ints


def cells_values_cuda(pack, p, sw, x, hcstate, pvtnum, satnum):
    """K2's values entry on the card; same contract as cells_values_plain
    (with ``pack`` = props.cell_pack() in place of props)."""
    n, (hc, pvt, sat) = _cells_inputs(pack, p, sw, x, hcstate, pvtnum,
                                      satnum)
    out = torch.empty((N_Q, n), dtype=torch.float64, device=p.device)
    if n:
        lib, meta = _cells_lib(pack)
        ptr = cuda_lib.ptr
        err = lib.opm_cells_eval(ptr(pack.tab), meta, n, ptr(p), ptr(sw),
                                 ptr(x), ptr(hc), ptr(pvt), ptr(sat),
                                 ptr(out), cuda_lib.P(0),
                                 cuda_lib.stream_ptr(p.device))
        cuda_lib.check(err, "opm_cells_eval")
        cells_values_cuda.launches += 1
    return out


cells_values_cuda.launches = 0


def cells_columns_cuda(pack, p, sw, x, hcstate, pvtnum, satnum):
    """K2's values entry with columns on the card; same contract as
    cells_columns_plain (the kernel writes the columns only)."""
    n, (hc, pvt, sat) = _cells_inputs(pack, p, sw, x, hcstate, pvtnum,
                                      satnum)
    cols = torch.empty((3, N_Q, n), dtype=torch.float64, device=p.device)
    if n:
        lib, meta = _cells_lib(pack)
        ptr = cuda_lib.ptr
        err = lib.opm_cells_eval(ptr(pack.tab), meta, n, ptr(p), ptr(sw),
                                 ptr(x), ptr(hc), ptr(pvt), ptr(sat),
                                 cuda_lib.P(0), ptr(cols),
                                 cuda_lib.stream_ptr(p.device))
        cuda_lib.check(err, "opm_cells_eval")
        cells_columns_cuda.launches += 1
    return cols


cells_columns_cuda.launches = 0


def cells_assemble_cuda(pack, p, sw, x, hcstate, pvtnum, satnum, acc0, pv,
                        dt):
    """K2's assembly entry on the card; same contract as
    cells_assemble_plain."""
    n, (hc, pvt, sat) = _cells_inputs(pack, p, sw, x, hcstate, pvtnum,
                                      satnum)
    dev = p.device
    for t, shape in ((acc0, (3, n)), (pv, (n,))):
        if (t.dtype != torch.float64 or t.device != dev
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"K2 assembly: acc0 (3, n) and pv (n,) must "
                             f"be contiguous float64 on {dev}")
    fv = torch.empty((N_F, n), dtype=torch.float64, device=dev)
    fc = torch.empty((3, N_F, n), dtype=torch.float64, device=dev)
    r_cell = torch.empty((3, n), dtype=torch.float64, device=dev)
    diag = torch.empty((9, n), dtype=torch.float64, device=dev)
    if n:
        lib, meta = _cells_lib(pack)
        ptr = cuda_lib.ptr
        err = lib.opm_cells_assemble(
            ptr(pack.tab), meta, n, ptr(p), ptr(sw), ptr(x), ptr(hc),
            ptr(pvt), ptr(sat), ptr(acc0), ptr(pv), float(dt), ptr(fv),
            ptr(fc), ptr(r_cell), ptr(diag), cuda_lib.stream_ptr(dev))
        cuda_lib.check(err, "opm_cells_assemble")
        cells_assemble_cuda.launches += 1
    return fv, fc, r_cell, diag


cells_assemble_cuda.launches = 0


def _k2(fn_cuda, fn_plain, props, *args):
    """K2 on the card (with the packed tables), the plain version on the
    CPU."""
    return cuda_lib.dispatch(
        args[0], lambda *a: fn_cuda(props.cell_pack(), *a),
        lambda *a: fn_plain(props, *a), *args, what="K2")


class _CellQuantities(torch.autograd.Function):
    """The (18, n) CellQuantities rows through K2; the forward-mode rule
    contracts K2's tangent columns with the input tangents (the quantities
    of a cell depend on that cell's primaries only), and the vmap rule
    folds a batch of primaries into the cell axis."""

    @staticmethod
    def forward(p, sw, x, hcstate, pvtnum, satnum, props):
        return _k2(cells_values_cuda, cells_values_plain, props, p, sw, x,
                   hcstate, pvtnum, satnum)

    @staticmethod
    def setup_context(ctx, inputs, output):
        p, sw, x, hcstate, pvtnum, satnum, props = inputs
        ctx.save_for_forward(p, sw, x, hcstate, pvtnum, satnum)
        ctx.props = props

    @staticmethod
    def jvp(ctx, dp, dsw, dx, *rest):
        cols = _CellColumns.apply(*ctx.saved_tensors, ctx.props)
        out = None
        for col, t in zip(cols, (dp, dsw, dx)):
            if t is not None:
                out = col * t if out is None else out + col * t
        return torch.zeros_like(cols[0]) if out is None else out

    @staticmethod
    def vmap(info, in_dims, p, sw, x, hcstate, pvtnum, satnum, props):
        B = info.batch_size
        args = [cuda_lib.batched(a, d, B).reshape(-1).contiguous()
                for a, d in zip((p, sw, x, hcstate, pvtnum, satnum),
                                in_dims[:6])]
        rows = _CellQuantities.apply(*args, props)
        return rows.reshape(N_Q, B, -1), 1


class _CellColumns(torch.autograd.Function):
    """The (3, 18, n) tangent columns of the CellQuantities rows through
    K2 (a Function of its own, so that the forward-mode rule above hands
    K2 unwrapped tensors under torch.func transforms)."""

    @staticmethod
    def forward(p, sw, x, hcstate, pvtnum, satnum, props):
        return _k2(cells_columns_cuda, cells_columns_plain, props, p, sw, x,
                   hcstate, pvtnum, satnum)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, p, sw, x, hcstate, pvtnum, satnum, props):
        B = info.batch_size
        args = [cuda_lib.batched(a, d, B).reshape(-1).contiguous()
                for a, d in zip((p, sw, x, hcstate, pvtnum, satnum),
                                in_dims[:6])]
        cols = _CellColumns.apply(*args, props)
        return cols.reshape(3, N_Q, B, -1), 2


def compute_cell_quantities(props, p, sw, x, hcstate, pvtnum,
                            satnum) -> CellQuantities:
    """Secondary variables from the switched primaries (the reference's
    compute_cell_quantities without hysteresis and VAPPARS memory): K2 on
    any batch of cells, with forward-mode and vmap rules, so the dense
    route's ``jacfwd`` and the perforation rows' jvp go through it."""
    shape = p.shape

    def flat(t, dtype):
        t = torch.as_tensor(t, device=p.device)
        return torch.broadcast_to(t, shape).reshape(-1).to(dtype) \
            .contiguous()

    rows = _CellQuantities.apply(
        flat(p, torch.float64), flat(sw, torch.float64),
        flat(x, torch.float64), flat(hcstate, torch.int32),
        flat(pvtnum, torch.int64), flat(satnum, torch.int64), props)
    return q_of_rows(rows, shape)


def cell_assembly(props, p, sw, x, hcstate, pvtnum, satnum, acc0, pv, dt):
    """K2's assembly entry (cells_assemble_plain's contract) on the
    primaries' device."""
    return _k2(cells_assemble_cuda, cells_assemble_plain, props, p, sw, x,
               hcstate, pvtnum, satnum, acc0, pv, dt)


# ---------------------------------------------------------------------------
# K3: TPFA face fluxes + divergence (plain versions)

def _dir_segments(dims):
    """Per direction: (L-slice, R-slice on the (nz, ny, nx) suffix, face
    count), in grid.build_grid's face order."""
    nx, ny, nz = dims
    S = slice(None)
    return [
        ((S, S, slice(None, -1)), (S, S, slice(1, None)), (nx - 1) * ny * nz),
        ((S, slice(None, -1), S), (S, slice(1, None), S), nx * (ny - 1) * nz),
        ((slice(None, -1), S, S), (slice(1, None), S, S), nx * ny * (nz - 1)),
    ]


def thpres_clip(dphi, thr):
    """The THPRES clip sign(dphi) max(|dphi| - thr, 0) (the reference's
    face_flux_from_q, :194-198) and its factor on the dphi tangent, as
    jax.jacfwd gives it through jnp.sign and jnp.maximum: 0 where dphi ==
    0 or |dphi| < thr, 1/2 where |dphi| == thr, 1 beyond."""
    a = torch.abs(dphi)
    tw = torch.where(a > thr, 1.0, torch.where(a == thr, 0.5, 0.0))
    tw = torch.where(dphi == 0.0, 0.0, tw)
    return torch.sign(dphi) * torch.maximum(a - thr,
                                            torch.zeros_like(a)), tw


def face_flux_from_q(p3L, p3R, rhoL, rhoR, bmL, bmR, rsL, rsR, rvL, rvR,
                     trans, dz, gravity, thr=None):
    """TPFA phase fluxes from the two cells' quantities; phase arrays
    (..., 3, nf), rs/rv (..., nf). Phase-potential upwinding on
    dphi = (p_L - p_R) - rho_face g dz, clipped by the faces' THPRES
    thresholds ``thr`` (nf,) when given; oil/gas get the rv/rs cross
    terms."""
    rho_face = 0.5 * (rhoL + rhoR)
    dphi = (p3L - p3R) - rho_face * gravity * dz
    if thr is not None:
        dphi = thpres_clip(dphi, thr)[0]
    up = dphi >= 0.0
    bm = torch.where(up, bmL, bmR)
    vf = trans * dphi
    F = bm * vf
    rs_up = torch.where(up[..., OIL, :], rsL, rsR)
    rv_up = torch.where(up[..., GAS, :], rvL, rvR)
    flux_o = F[..., OIL, :] + rv_up * bm[..., GAS, :] * vf[..., GAS, :]
    flux_g = F[..., GAS, :] + rs_up * bm[..., OIL, :] * vf[..., OIL, :]
    return torch.stack([F[..., WATER, :], flux_o, flux_g], dim=-2)


def _face_flux_tangent(p3L, p3R, rhoL, rhoR, bmL, bmR, rsL, rsR, rvL, rvR,
                       trans, dz, gravity, dp3L, dp3R, drhoL, drhoR, dbmL,
                       dbmR, drsL, drsR, drvL, drvR, zero_threshold=False,
                       thr=None):
    """Tangent of face_flux_from_q with the upwind direction fixed by the
    primal; tangent arrays carry a leading batch axis. ``zero_threshold``:
    the tangent through a THPRES clip with threshold 0,
    sign(dphi) max(|dphi| - 0, 0), as the reference's block assembly
    takes it: equal to the plain tangent except where dphi == 0 exactly
    (a face in hydrostatic equilibrium), where it is 0. ``thr``: the
    tangent through the clip with the faces' thresholds (thpres_clip)."""
    rho_face = 0.5 * (rhoL + rhoR)
    dphi = (p3L - p3R) - rho_face * gravity * dz
    tw = None
    if thr is not None:
        dphi, tw = thpres_clip(dphi, thr)
    up = dphi >= 0.0
    bm = torch.where(up, bmL, bmR)
    vf = trans * dphi
    rs_up = torch.where(up[..., OIL, :], rsL, rsR)
    rv_up = torch.where(up[..., GAS, :], rvL, rvR)
    dphi_t = (dp3L - dp3R) - (0.5 * (drhoL + drhoR)) * gravity * dz
    if tw is not None:
        dphi_t = torch.where(tw == 1.0, dphi_t,
                             torch.where(tw == 0.0, 0.0, 0.5 * dphi_t))
    elif zero_threshold:
        dphi_t = torch.where(dphi == 0.0, 0.0, dphi_t)
    bm_t = torch.where(up, dbmL, dbmR)
    vf_t = trans * dphi_t
    F_t = bm_t * vf + bm * vf_t
    rs_up_t = torch.where(up[..., OIL, :], drsL, drsR)
    rv_up_t = torch.where(up[..., GAS, :], drvL, drvR)
    o_t = F_t[..., OIL, :] + (
        (rv_up_t * bm[..., GAS, :] + rv_up * bm_t[..., GAS, :])
        * vf[..., GAS, :] + (rv_up * bm[..., GAS, :]) * vf_t[..., GAS, :])
    g_t = F_t[..., GAS, :] + (
        (rs_up_t * bm[..., OIL, :] + rs_up * bm_t[..., OIL, :])
        * vf[..., OIL, :] + (rs_up * bm[..., OIL, :]) * vf_t[..., OIL, :])
    return torch.stack([F_t[..., WATER, :], o_t, g_t], dim=-2)


def _cells3(a, dims):
    nx, ny, nz = dims
    return a.reshape(a.shape[:-1] + (nz, ny, nx))


def _slice(a, sl):
    return a[(Ellipsis,) + sl].reshape(a.shape[:-3] + (-1,))


def face_fluxes(dims, p3, rho, bmob, rs, rv, depth, trans, gravity,
                tangents=None, thr=None):
    """Per-face fluxes (..., 3, nf) in grid face order; with ``tangents``
    (dp3, drho, dbmob, drs, drv), their tangents instead; ``thr`` the
    stencil faces' THPRES thresholds or None."""
    cells = [_cells3(a, dims) for a in (p3, rho, bmob, rs, rv)]
    dep = _cells3(depth, dims)
    tcells = (None if tangents is None
              else [_cells3(a, dims) for a in tangents])
    segs = []
    ofs = 0
    for slL, slR, nf_d in _dir_segments(dims):
        args = []
        for a in cells:
            args += [_slice(a, slL), _slice(a, slR)]
        T = trans[ofs:ofs + nf_d]
        th = None if thr is None else thr[ofs:ofs + nf_d]
        dz = (dep[slL] - dep[slR]).reshape(-1)
        if tcells is None:
            segs.append(face_flux_from_q(*args, T, dz, gravity, th))
        else:
            targs = []
            for a in tcells:
                targs += [_slice(a, slL), _slice(a, slR)]
            segs.append(_face_flux_tangent(*args, T, dz, gravity, *targs,
                                           thr=th))
        ofs += nf_d
    return torch.cat(segs, dim=-1)


def divergence(dims, face_flux):
    """Signed slice-add of (..., k, nf) face fluxes to cells, in the
    reference's order (x then y then z; left += f, right += -f)."""
    nx, ny, nz = dims
    lead = face_flux.shape[:-1]
    out = torch.zeros(lead + (nz, ny, nx), dtype=face_flux.dtype,
                      device=face_flux.device)
    ofs = 0
    for slL, slR, nf_d in _dir_segments(dims):
        f = face_flux[..., ofs:ofs + nf_d]
        view_L = out[(Ellipsis,) + slL]
        f3 = f.reshape(view_L.shape)
        out[(Ellipsis,) + slL] += f3
        out[(Ellipsis,) + slR] -= f3
        ofs += nf_d
    return out.reshape(lead + (nx * ny * nz,))


def tpfa_div_plain(dims, p3, rho, bmob, rs, rv, depth, trans, gravity,
                   thr=None):
    """div F (3, nc): the plain version of K3's forward entry (thr: the
    stencil faces' THPRES thresholds, or None)."""
    return divergence(dims, face_fluxes(dims, p3, rho, bmob, rs, rv, depth,
                                        trans, gravity, thr=thr))


def tpfa_div_tangent_plain(dims, p3, rho, bmob, rs, rv, depth, trans,
                           gravity, dp3, drho, dbmob, drs, drv, thr=None):
    """(B, 3, nc) tangent divergences: the plain version of K3's tangent
    entry (tangents (B, 3, nc) and (B, nc))."""
    return divergence(dims, face_fluxes(
        dims, p3, rho, bmob, rs, rv, depth, trans, gravity,
        tangents=(dp3, drho, dbmob, drs, drv), thr=thr))


# ---------------------------------------------------------------------------
# K3: CUDA wrappers (csrc/tpfa.cu)

_P, _I, _D = cuda_lib.P, cuda_lib.I, cuda_lib.D
_SIGS = {
    "opm_tpfa_div": [_I] * 9 + [_P] * 8 + [_D, _P, _P],
    "opm_tpfa_div_occupancy": [_I, _I, _P],
    "opm_tpfa_div_tangent": [_I] * 12 + [_P] * 13 + [_D, _P, _P],
    "opm_tpfa_tangent_occupancy": [_I, _I, _I, _P],
}

# the forward entry's tile: a warp along i, 8 rows along j; its shared
# memory: two planes of the cells' 12 values (p3, rho3, bmob3, rs, rv,
# depth), the x and y faces' fluxes
DIV_TILE_X, DIV_TILE_Y = 32, 8
DIV_SMEM = 8 * (2 * 12 + 2 * 3) * DIV_TILE_X * DIV_TILE_Y


class DivTiles(NamedTuple):
    """The forward K3 kernel's launch geometry (csrc/tpfa.cu): blocks of
    (tx, ty) threads over (i, j) tiles stepping by tx - 2 and ty - 2 (the
    first and last column and row of threads are halo),
    ``tiles_x * tiles_y`` tiles, each marched over ``runs`` runs of
    ``zrun`` z planes; ``smem`` bytes of shared memory a block."""

    tx: int
    ty: int
    tiles_x: int
    tiles_y: int
    zrun: int
    runs: int
    smem: int


def div_tiles(dims, resident) -> DivTiles:
    """The tiles of an (nx, ny, nz) grid, its z planes cut into as many
    runs as fill ``resident`` blocks (the card's SMs times the kernel's
    blocks per SM) once, at most nz."""
    nx, ny, nz = dims
    tiles_x = -(-nx // (DIV_TILE_X - 2))
    tiles_y = -(-ny // (DIV_TILE_Y - 2))
    runs = max(1, min(nz, resident // (tiles_x * tiles_y)))
    zrun = -(-nz // runs)
    return DivTiles(DIV_TILE_X, DIV_TILE_Y, tiles_x, tiles_y, zrun,
                    -(-nz // zrun), DIV_SMEM)


# the tangent entry's march: the forward's tile, its plane buffers also
# carrying a tangent set's 11 rows
TAN_MARCH_SMEM = 8 * (2 * (12 + 11) + 2 * 3) * DIV_TILE_X * DIV_TILE_Y


class TangentGeometry(NamedTuple):
    """The K3 tangent kernel's launch (csrc/tpfa.cu): ``whole``, one block
    of ``block`` = (nx, ny, 3 nz) threads is the whole grid and ``grid``
    = (chunks, 1, 1) blocks take ``dirs`` tangent sets each (the last one
    the rest); otherwise the forward's tile march, blocks ``block`` =
    (32, 8) over ``grid`` = (tiles, runs, B), one tangent set a block,
    ``tiles_x`` tiles along i and runs of ``zrun`` z planes; ``smem``
    bytes of shared memory a block."""

    whole: bool
    block: tuple
    grid: tuple
    dirs: int
    tiles_x: int
    zrun: int
    smem: int


def tangent_kernel(dims):
    """(whole, threads, smem) of the tangent kernel an (nx, ny, nz) grid
    takes: the whole-grid one where 3 threads a cell fit a block's 1024
    and 3 nz blockDim.z's 64 (31 doubles of shared memory a cell), else
    the march (the forward's 32 x 8 tile)."""
    nx, ny, nz = dims
    nc = nx * ny * nz
    if 3 * nc <= 1024 and 3 * nz <= 64:
        return True, 3 * nc, 8 * 31 * nc
    return False, DIV_TILE_X * DIV_TILE_Y, TAN_MARCH_SMEM


def tangent_geometry(dims, B, resident) -> TangentGeometry:
    """The tangent kernel's launch for B tangent sets on an (nx, ny, nz)
    grid, ``resident`` the card's SMs times the blocks an SM holds of the
    geometry's kernel: the whole grid a block, with the sets cut into
    chunks that fill ``resident`` blocks once; else div_tiles' tiles and
    runs with the sets as the grid's third axis, the runs filling
    ``resident`` blocks about four times (on an H100 at SPE10-2's B = 3
    faster than one wave of whole-depth runs or eight of short ones)."""
    nx, ny, nz = dims
    whole, _, smem = tangent_kernel(dims)
    if whole:
        chunks = max(1, min(B, resident))
        dirs = -(-B // chunks)
        return TangentGeometry(True, (nx, ny, 3 * nz), (-(-B // dirs), 1, 1),
                               dirs, 1, nz, smem)
    t = div_tiles(dims, max(1, 4 * resident // max(B, 1)))
    return TangentGeometry(False, (t.tx, t.ty),
                           (t.tiles_x * t.tiles_y, t.runs, B), 1, t.tiles_x,
                           t.zrun, smem)


_resident = {}
_tangent_geoms = {}


def _occupancy(lib, dev, key, query):
    """SMs times resident blocks per SM of a kernel on ``dev``, asked once
    per device and ``key`` (``query(out)`` fills the SM count and the
    blocks per SM)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if (idx, key) not in _resident:
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(idx):
            cuda_lib.check(query(ctypes.cast(out, ctypes.c_void_p)),
                           "K3 occupancy")
        _resident[idx, key] = out[0] * out[1]
    return _resident[idx, key]


def _resident_blocks(lib, dev):
    """SMs times the forward kernel's resident blocks per SM on ``dev``."""
    return _occupancy(lib, dev, "div", lambda out: lib.opm_tpfa_div_occupancy(
        DIV_TILE_Y, DIV_SMEM, out))


def _tangent_resident(lib, dev, dims):
    """SMs times the tangent kernel's resident blocks per SM on ``dev``, for
    the kernel ``dims`` takes."""
    whole, threads, smem = tangent_kernel(dims)
    return _occupancy(lib, dev, ("tangent", whole, threads, smem),
                      lambda out: lib.opm_tpfa_tangent_occupancy(
                          int(whole), threads, smem, out))


def _check_cells(tensors, dev, nc):
    for t in tensors:
        if (t.dtype != torch.float64 or t.device != dev
                or not t.is_contiguous() or t.shape[-1] != nc):
            raise ValueError("K3 inputs must be contiguous float64 tensors "
                             f"on {dev} with a trailing cell axis of {nc}")


def _check_primal(dims, p3, rho, bmob, rs, rv, depth, trans, thr=None):
    """Checks shared by both K3 entries: (3, nc) phase arrays, (nc,) rs,
    rv and depth, and one transmissibility (and threshold, when given) per
    canonical face."""
    nc = dims[0] * dims[1] * dims[2]
    dev = p3.device
    _check_cells((p3, rho, bmob, rs, rv, depth), dev, nc)
    if (p3.shape != (3, nc) or rho.shape != (3, nc) or bmob.shape != (3, nc)
            or rs.shape != (nc,) or rv.shape != (nc,)
            or depth.shape != (nc,)):
        raise ValueError("K3: phase arrays must be (3, nc), rs/rv/depth "
                         "(nc,)")
    nf = sum(n for _, _, n in _dir_segments(dims))
    for t, name in ((trans, "trans"), (thr, "thr")):
        if t is not None and (t.dtype != torch.float64 or t.device != dev
                              or not t.is_contiguous() or t.shape != (nf,)):
            raise ValueError(f"K3: {name} must be a contiguous float64 "
                             f"({nf},) tensor on {dev}")


def _ptr_or_null(t):
    return cuda_lib.P(0) if t is None else cuda_lib.ptr(t)


def tpfa_div_cuda(dims, p3, rho, bmob, rs, rv, depth, trans, gravity,
                  thr=None):
    """K3 forward entry on the card; same contract as tpfa_div_plain."""
    nx, ny, nz = dims
    nc = nx * ny * nz
    dev = p3.device
    _check_primal(dims, p3, rho, bmob, rs, rv, depth, trans, thr)
    if 3 * nc + 3 >= 2 ** 31:
        raise ValueError(f"K3: {nc} cells exceed the kernel's 32-bit "
                         "indices")
    div = torch.empty((3, nc), dtype=torch.float64, device=dev)
    lib = cuda_lib.load("tpfa", _SIGS)
    g = div_tiles(dims, _resident_blocks(lib, dev))
    ptr = cuda_lib.ptr
    err = lib.opm_tpfa_div(nx, ny, nz, g.ty, g.tiles_x, g.tiles_y, g.zrun,
                           g.runs, g.smem, ptr(p3), ptr(rho),
                           ptr(bmob), ptr(rs), ptr(rv), ptr(depth),
                           ptr(trans), _ptr_or_null(thr), float(gravity),
                           ptr(div), cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "opm_tpfa_div")
    tpfa_div_cuda.launches += 1
    if thr is not None:
        tpfa_div_cuda.thr_launches += 1
    return div


tpfa_div_cuda.launches = 0
# launches with a THPRES threshold (of those counted in launches)
tpfa_div_cuda.thr_launches = 0


def tpfa_div_tangent_cuda(dims, p3, rho, bmob, rs, rv, depth, trans, gravity,
                          dp3, drho, dbmob, drs, drv, thr=None):
    """K3 tangent entry on the card; same contract as
    tpfa_div_tangent_plain."""
    nx, ny, nz = dims
    nc = nx * ny * nz
    dev = p3.device
    B = dp3.shape[0]
    _check_primal(dims, p3, rho, bmob, rs, rv, depth, trans, thr)
    _check_cells((dp3, drho, dbmob, drs, drv), dev, nc)
    if (dp3.shape != (B, 3, nc) or drho.shape != (B, 3, nc)
            or dbmob.shape != (B, 3, nc) or drs.shape != (B, nc)
            or drv.shape != (B, nc)):
        raise ValueError("K3 tangent: tangents must be (B, 3, nc)/(B, nc)")
    if 3 * nc * B + 3 >= 2 ** 31 or B > 65535:
        raise ValueError(f"K3 tangent: {B} sets of {nc} cells exceed the "
                         "kernel's 32-bit indices or its grid")
    ddiv = torch.empty((B, 3, nc), dtype=torch.float64, device=dev)
    if B:
        lib = cuda_lib.load("tpfa", _SIGS)
        key = (dev.index, tuple(dims), B)
        g = _tangent_geoms.get(key)
        if g is None:
            g = _tangent_geoms[key] = tangent_geometry(
                dims, B, _tangent_resident(lib, dev, dims))
        ptr = cuda_lib.ptr
        err = lib.opm_tpfa_div_tangent(
            nx, ny, nz, B, int(g.whole), g.block[1], g.grid[0], g.grid[1],
            g.dirs, g.tiles_x, g.zrun, g.smem, ptr(p3), ptr(rho), ptr(bmob),
            ptr(rs), ptr(rv), ptr(dp3), ptr(drho), ptr(dbmob), ptr(drs),
            ptr(drv), ptr(depth), ptr(trans), _ptr_or_null(thr),
            float(gravity), ptr(ddiv), cuda_lib.stream_ptr(dev))
        cuda_lib.check(err, "opm_tpfa_div_tangent")
        tpfa_div_tangent_cuda.launches += 1
        if thr is not None:
            tpfa_div_tangent_cuda.thr_launches += 1
    return ddiv


tpfa_div_tangent_cuda.launches = 0
# launches with a THPRES threshold (of those counted in launches)
tpfa_div_tangent_cuda.thr_launches = 0


class _TpfaDivTangent(torch.autograd.Function):
    """Tangent divergences; the tangent inputs carry any number of leading
    batch axes, folded into K3's B."""

    @staticmethod
    def forward(p3, rho, bmob, rs, rv, depth, trans, gravity, dims, thr,
                dp3, drho, dbmob, drs, drv):
        nc = rs.shape[-1]
        lead = drs.shape[:-1]
        t3 = [a.reshape(-1, 3, nc).contiguous() for a in (dp3, drho, dbmob)]
        t1 = [a.reshape(-1, nc).contiguous() for a in (drs, drv)]
        out = cuda_lib.dispatch(
            p3, tpfa_div_tangent_cuda, tpfa_div_tangent_plain, dims, p3,
            rho, bmob, rs, rv, depth, trans, gravity, *t3, *t1, thr=thr,
            what="K3")
        return out.reshape(lead + (3, nc))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, p3, rho, bmob, rs, rv, depth, trans, gravity,
             dims, thr, dp3, drho, dbmob, drs, drv):
        if any(d is not None for d in in_dims[:7] + in_dims[9:10]):
            raise NotImplementedError("K3 tangent with a batched primal")
        B = info.batch_size
        tans = [cuda_lib.batched(a, d, B)
                for a, d in zip((dp3, drho, dbmob, drs, drv), in_dims[10:])]
        out = _TpfaDivTangent.apply(p3, rho, bmob, rs, rv, depth, trans,
                                    gravity, dims, thr, *tans)
        return out, 0


class _TpfaDiv(torch.autograd.Function):
    """div F (3, nc) through K3; forward-mode rule through K3's tangent
    entry."""

    @staticmethod
    def forward(p3, rho, bmob, rs, rv, depth, trans, gravity, dims, thr):
        return cuda_lib.dispatch(p3, tpfa_div_cuda, tpfa_div_plain, dims,
                                 p3, rho, bmob, rs, rv, depth, trans,
                                 gravity, thr=thr, what="K3")

    @staticmethod
    def setup_context(ctx, inputs, output):
        p3, rho, bmob, rs, rv, depth, trans, gravity, dims, thr = inputs
        ctx.save_for_forward(p3, rho, bmob, rs, rv, depth, trans)
        ctx.gravity = gravity
        ctx.dims = dims
        ctx.thr = thr

    @staticmethod
    def jvp(ctx, dp3, drho, dbmob, drs, drv, *rest):
        p3, rho, bmob, rs, rv, depth, trans = ctx.saved_tensors
        tans = [torch.zeros_like(ref) if t is None else t
                for t, ref in zip((dp3, drho, dbmob, drs, drv),
                                  (p3, rho, bmob, rs, rv))]
        return _TpfaDivTangent.apply(p3, rho, bmob, rs, rv, depth, trans,
                                     ctx.gravity, ctx.dims, ctx.thr, *tans)

    @staticmethod
    def vmap(info, in_dims, *args):
        raise NotImplementedError("K3 with a batched primal")


def tpfa_divergence(dims, p3, rho, bmob, rs, rv, depth, trans, gravity,
                    thr=None):
    """div F (3, nc) of the TPFA phase fluxes (K3), clipped by the stencil
    faces' THPRES thresholds ``thr`` when given."""
    return _TpfaDiv.apply(p3.contiguous(), rho.contiguous(),
                          bmob.contiguous(), rs.contiguous(),
                          rv.contiguous(), depth, trans, float(gravity),
                          tuple(dims), thr)


# ---------------------------------------------------------------------------
# face lists: the faces a kernel visits by gather

@dataclass
class FaceCsr:
    """Per output row (cell ``rows[t]``, or t when rows is None) its
    incident faces ent[ptr[t]:ptr[t+1]] (f >= 0 where the cell is the left
    cell, -f-1 where it is the right one) and the neighbour cells nbr;
    int32 tensors."""

    n_rows: int
    rows: Optional[torch.Tensor]
    ptr: torch.Tensor
    ent: torch.Tensor
    nbr: torch.Tensor


def face_csr(face_cells, nc, first, device, touched_only=False) -> FaceCsr:
    """The incidence CSR of faces ``first:`` in the order of the plain
    version's scatter-adds: a cell's left-side faces in face order, then
    its right-side faces in face order. ``touched_only``: rows for the
    cells with at least one such face only (an in-place update)."""
    fc = np.asarray(face_cells, dtype=np.int64)[first:]
    f = np.arange(first, first + len(fc), dtype=np.int64)
    keys = np.concatenate([fc[:, 0], fc[:, 1]])
    ent = np.concatenate([f, -f - 1])
    nbr = np.concatenate([fc[:, 1], fc[:, 0]])
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=nc)
    rows = np.nonzero(counts)[0] if touched_only else None
    per_row = counts[rows] if touched_only else counts
    ptr = np.zeros(len(per_row) + 1, dtype=np.int64)
    np.cumsum(per_row, out=ptr[1:])

    def i32(a):
        return torch.as_tensor(a.astype(np.int32), device=device)

    return FaceCsr(n_rows=len(per_row),
                   rows=None if rows is None else i32(rows), ptr=i32(ptr),
                   ent=i32(ent[order]), nbr=i32(nbr[order]))


SELL_PAD = np.iinfo(np.int32).min


@dataclass
class SellLayout:
    """A sliced-ELL layout of a cell CSR (``FaceList.touched``: every cell
    on a gather grid, the cells the extra faces touch on an embedded grid),
    built once per grid for K4-faces: the CSR's rows in slices of 32, slice
    s padded to its longest row, chunk0[s+1] - chunk0[s] slots of 32
    entries; slot j of row t (lane i = t % 32 of slice s = t // 32) is
    padded entry e = 32 (chunk0[s] + j) + i. Per padded entry: ``src``,
    the CSR's entry (f >= 0: +face_R of face f; -f-1: -face_L of face f)
    or SELL_PAD, and ``col``, the neighbour cell (0 at a pad). ``ptr`` is
    the CSR's (row t has ptr[t+1] - ptr[t] slots); ``rows`` the cell of
    row t and ``row_of`` the row of cell c (-1: none), both None where row
    t is cell t; int32 tensors."""

    nc: int
    n_rows: int
    n_chunks: int
    chunk0: torch.Tensor
    ptr: torch.Tensor
    src: torch.Tensor
    col: torch.Tensor
    rows: Optional[torch.Tensor]
    row_of: Optional[torch.Tensor]


def sell_layout(csr: FaceCsr, nc) -> SellLayout:
    """The sliced-ELL layout of a cell CSR over nc cells, its slots in the
    CSR's order."""
    ptr = csr.ptr.cpu().numpy().astype(np.int64)
    ent = csr.ent.cpu().numpy()
    nbr = csr.nbr.cpu().numpy()
    n = csr.n_rows
    lens = np.diff(ptr)
    ns = -(-n // 32)
    width = np.zeros(ns * 32, dtype=np.int64)
    width[:n] = lens
    chunk0 = np.zeros(ns + 1, dtype=np.int64)
    np.cumsum(width.reshape(ns, 32).max(axis=1, initial=0), out=chunk0[1:])
    row = np.repeat(np.arange(n, dtype=np.int64), lens)
    slot = np.arange(len(ent), dtype=np.int64) - ptr[row]
    e = 32 * (chunk0[row // 32] + slot) + row % 32
    n_pad = 32 * int(chunk0[-1])
    src = np.full(n_pad, SELL_PAD, dtype=np.int32)
    col = np.zeros(n_pad, dtype=np.int32)
    src[e] = ent
    col[e] = nbr
    dev = csr.ptr.device

    def i32(a):
        return torch.as_tensor(a.astype(np.int32), device=dev)

    row_of = None
    if csr.rows is not None:
        row_of = np.full(nc, -1, dtype=np.int64)
        row_of[csr.rows.cpu().numpy()] = np.arange(n)
        row_of = i32(row_of)
    return SellLayout(nc=int(nc), n_rows=n, n_chunks=int(chunk0[-1]),
                      chunk0=i32(chunk0), ptr=csr.ptr, src=i32(src),
                      col=i32(col), rows=csr.rows, row_of=row_of)


class FaceList:
    """Faces ``first:`` of a grid's face list: all faces of a gather grid
    (first = 0) or an embedded grid's extra faces (first = nf_canonical),
    with their cells and incidence CSRs (``full``: a row per cell;
    ``touched``: rows of the cells the faces touch, for the in-place
    epilogues after the structured kernels) and ``touched``'s sliced-ELL
    layout ``sell`` (K4-faces)."""

    def __init__(self, face_cells, nc, first, device):
        fc = np.asarray(face_cells)[first:]
        self.first = int(first)
        self.n = len(fc)
        self.c1 = torch.as_tensor(fc[:, 0], dtype=torch.long, device=device)
        self.c2 = torch.as_tensor(fc[:, 1], dtype=torch.long, device=device)
        self.c1_32 = self.c1.to(torch.int32)
        self.c2_32 = self.c2.to(torch.int32)
        self.full = face_csr(face_cells, nc, first, device)
        self.touched = (self.full if first == 0 else
                        face_csr(face_cells, nc, first, device, True))
        self.sell = sell_layout(self.touched, nc)


# ---------------------------------------------------------------------------
# K3-faces: the face-list flux divergence (plain version, CUDA wrapper)

def faces_flux_plain(fl: FaceList, p3, rho, bmob, rs, rv, depth, trans,
                     gravity, thr=None):
    """(3, n) fluxes of the list's faces (the reference's gather branch);
    thr: every face's THPRES threshold (the grid's face order), or
    None."""
    c1, c2 = fl.c1, fl.c2
    return face_flux_from_q(p3[:, c1], p3[:, c2], rho[:, c1], rho[:, c2],
                            bmob[:, c1], bmob[:, c2], rs[c1], rs[c2],
                            rv[c1], rv[c2], trans[fl.first:],
                            depth[c1] - depth[c2], gravity,
                            None if thr is None else thr[fl.first:])


def faces_div_plain(fl: FaceList, p3, rho, bmob, rs, rv, depth, trans,
                    gravity, out=None, thr=None):
    """Signed scatter-add of the list's face fluxes (left += f, right -= f)
    onto zeros, or onto ``out`` (the structured divergence of an embedded
    grid; not modified)."""
    flux = faces_flux_plain(fl, p3, rho, bmob, rs, rv, depth, trans, gravity,
                            thr)
    base = torch.zeros_like(p3) if out is None else out.clone()
    return base.index_add_(1, fl.c1, flux).index_add_(1, fl.c2, -flux)


_FACES_SIGS = {
    "opm_faces_div": [_I, _P, _P, _P, _P, cuda_lib.L] + [_P] * 8
    + [_D, _I, _P, _P],
    # the operator over the sliced-ELL layout (models/linearize.py)
    "opm_faces_sell_apply": [_I] + [_P] * 6 + [cuda_lib.L] + [_P] * 3
    + [_I] + [_P] * 3 + [_P, _I, _P],
    # the face blocks of the assembly, with the operator's packed copy
    # (models/linearize.py)
    "opm_faces_blocks": [_I, _P, _P, _P, _P, cuda_lib.L, cuda_lib.L, _P, _P,
                         cuda_lib.L, cuda_lib.L] + [_P] * 5 + [_D]
    + [_P] * 8,
}


def csr_args(csr: FaceCsr):
    ptr = cuda_lib.ptr
    return (csr.n_rows, ptr(csr.rows) if csr.rows is not None else _P(0),
            ptr(csr.ptr), ptr(csr.ent), ptr(csr.nbr))


def faces_div_cuda(fl: FaceList, p3, rho, bmob, rs, rv, depth, trans,
                   gravity, out=None, thr=None):
    """K3-faces on the card; same contract as faces_div_plain, except that
    ``out`` is updated in place."""
    nc = rs.shape[0]
    dev = p3.device
    _check_cells((p3, rho, bmob, rs, rv, depth), dev, nc)
    if (trans.dtype != torch.float64 or trans.device != dev
            or not trans.is_contiguous()
            or trans.shape[0] != fl.first + fl.n):
        raise ValueError("K3-faces: trans must be contiguous float64 over "
                         "every face of the grid")
    if thr is not None and (thr.dtype != torch.float64 or thr.device != dev
                            or not thr.is_contiguous()
                            or thr.shape != trans.shape):
        raise ValueError("K3-faces: thr must be contiguous float64 over "
                         "every face of the grid")
    if out is not None:
        _check_cells((out,), dev, nc)
    div = torch.empty_like(p3) if out is None else out
    lib = cuda_lib.load("faces", _FACES_SIGS)
    ptr = cuda_lib.ptr
    err = lib.opm_faces_div(
        *csr_args(fl.full if out is None else fl.touched), nc, ptr(p3),
        ptr(rho), ptr(bmob), ptr(rs), ptr(rv), ptr(depth), ptr(trans),
        _ptr_or_null(thr), float(gravity), int(out is not None), ptr(div),
        cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "opm_faces_div")
    faces_div_cuda.launches += 1
    if thr is not None:
        faces_div_cuda.thr_launches += 1
    return div


faces_div_cuda.launches = 0
# launches with a THPRES threshold (of those counted in launches)
faces_div_cuda.thr_launches = 0


def faces_divergence(fl: FaceList, p3, rho, bmob, rs, rv, depth, trans,
                     gravity, out=None, thr=None):
    """div F (3, nc) of the list's faces (K3-faces), added onto ``out``
    when given; thr: every face's THPRES threshold, or None."""
    args = (fl, p3.contiguous(), rho.contiguous(), bmob.contiguous(),
            rs.contiguous(), rv.contiguous(), depth, trans, gravity, out)
    return cuda_lib.dispatch(p3, faces_div_cuda, faces_div_plain, *args,
                             thr=thr, what="K3-faces")


# ---------------------------------------------------------------------------

class BlackoilModel:
    """Static model data (tensors on one device) and pure functions over
    states, on a structured grid (fully active or embedded, ``op_dims``
    its (nx, ny, nz)) or a gather grid (``op_dims`` None)."""

    def __init__(self, grid, props, params: Optional[ModelParams] = None,
                 device=None):
        self.device = torch.device(device if device is not None
                                   else props.device)
        self.grid = grid
        self.props = props
        self.params = params or ModelParams()
        self.nc = grid.nc
        self.dims = tuple(grid.dims)
        dev = self.device

        def f64(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=torch.float64, device=dev)

        self.face_cells = torch.as_tensor(grid.face_cells, dtype=torch.long,
                                          device=dev)
        self.trans = f64(grid.trans)
        self.pv = f64(grid.pore_volume)
        self.depth = f64(grid.depth)
        self.pvtnum = torch.as_tensor(grid.pvtnum, dtype=torch.long,
                                      device=dev)
        self.satnum = torch.as_tensor(grid.satnum, dtype=torch.long,
                                      device=dev)
        self.gravity = float(grid.gravity)
        # (nf,) THPRES thresholds in the grid's face order, set by the
        # simulator (None: no clip)
        self.threshold_dp = None
        self.structured = bool(getattr(grid, "structured", False))
        self.op_dims = self.dims if self.structured else None
        # faces past the stencil go by gather: all of a gather grid's, an
        # embedded grid's extra faces (stair-step faults, NNCs)
        self.nf_canonical = grid.nf_canonical
        first = self.nf_canonical if self.structured else 0
        self.n_extra_faces = grid.nf - self.nf_canonical
        self.faces = (FaceList(grid.face_cells, self.nc, first, dev)
                      if grid.nf > first or not self.structured else None)
        self.trans_stencil = self.trans[:self.nf_canonical] \
            if self.structured else None
        # embedded grids: the padding cells are masked out of the
        # convergence norms and the reported pore volume
        am = getattr(grid, "active_mask", None)
        self.conv_mask = None if am is None else f64(am)
        self.pv_out = self.pv if am is None else self.pv * self.conv_mask

    # ------------------------------------------------------------------
    def cell_quantities(self, state: BlackoilState) -> CellQuantities:
        if state.sgmax is not None or state.somax is not None:
            raise NotImplementedError(
                "hysteresis/VAPPARS memory is not ported yet "
                "(ROADMAP Queue 1 item 2)")
        return compute_cell_quantities(
            self.props, state.pressure, state.sw, state.x, state.hcstate,
            self.pvtnum, self.satnum)

    def accumulation(self, state: BlackoilState) -> torch.Tensor:
        """Surface volumes per pore volume, (3, nc)."""
        return accumulation_from_q(self.cell_quantities(state))

    def flux_divergence(self, q: CellQuantities, threshold_dp=None):
        """div of the TPFA face fluxes, (3, nc), through K3 (and K3-faces),
        clipped by the faces' THPRES thresholds when given."""
        p3 = torch.stack([q.pw, q.po, q.pg], dim=0)
        bmob = q.b * q.mob
        div = None
        if self.structured:
            div = tpfa_divergence(
                self.dims, p3, q.rho, bmob, q.rs, q.rv, self.depth,
                self.trans_stencil, self.gravity,
                None if threshold_dp is None
                else threshold_dp[:self.nf_canonical].contiguous())
        if self.faces is not None:
            div = faces_divergence(self.faces, p3, q.rho, bmob, q.rs, q.rv,
                                   self.depth, self.trans, self.gravity,
                                   out=div, thr=threshold_dp)
        return div

    def face_fluxes(self, q: CellQuantities, threshold_dp=None):
        """Per-face fluxes (3, nf) in grid face order (plain; for output
        and tests), clipped by the faces' THPRES thresholds when given."""
        p3 = torch.stack([q.pw, q.po, q.pg], dim=0)
        bmob = q.b * q.mob
        thr = threshold_dp
        segs = []
        if self.structured:
            segs.append(face_fluxes(
                self.dims, p3, q.rho, bmob, q.rs, q.rv, self.depth,
                self.trans_stencil, self.gravity,
                thr=None if thr is None else thr[:self.nf_canonical]))
        if self.faces is not None:
            segs.append(faces_flux_plain(self.faces, p3, q.rho, bmob, q.rs,
                                         q.rv, self.depth, self.trans,
                                         self.gravity, thr))
        return torch.cat(segs, dim=-1)

    # ------------------------------------------------------------------
    def well_cell_quantities(self, q: CellQuantities):
        sd = torch.stack([
            torch.broadcast_to(reg_pick(self.props.surface_density[:, k],
                                        self.pvtnum), self.pvtnum.shape)
            for k in range(3)])
        rho_avg = torch.sum(q.sat * q.rho, dim=0)
        return dict(p_oil=q.po, mob=q.mob, b=q.b, rs=q.rs, rv=q.rv,
                    rho_avg=rho_avg, surface_density=sd)

    def perf_quantities(self, state: BlackoilState, wd):
        """Cell quantities at the (nw*mp) perforated cells only."""
        pc_f = wd["perf_cell"].reshape(-1)
        return compute_cell_quantities(
            self.props, state.pressure[pc_f], state.sw[pc_f],
            state.x[pc_f], state.hcstate[pc_f], self.pvtnum[pc_f],
            self.satnum[pc_f])

    def well_cell_quantities_local(self, state: BlackoilState, wd):
        """Perf-local well cell quantities (the reference's
        well_cell_quantities_local)."""
        nw, mp = wd["perf_cell"].shape
        pvt_p = self.pvtnum[wd["perf_cell"].reshape(-1)]
        q = self.perf_quantities(state, wd)
        sd = self.props.surface_density.T[:, pvt_p]
        rho_avg = torch.sum(q.sat * q.rho, dim=0)

        def pm(a3):
            return torch.movedim(a3, 0, -1).reshape(nw, mp, 3)

        return dict(perf_local=True,
                    p_oil=q.po.reshape(nw, mp), mob=pm(q.mob),
                    b=pm(q.b), rs=q.rs.reshape(nw, mp),
                    rv=q.rv.reshape(nw, mp),
                    rho_avg=rho_avg.reshape(nw, mp),
                    surface_density=pm(sd))

    # ------------------------------------------------------------------
    def residual(self, state: BlackoilState, acc0, dt, wd, cdp,
                 threshold_dp=None) -> Residual:
        """Full nonlinear residual."""
        if threshold_dp is None:
            threshold_dp = self.threshold_dp
        q = self.cell_quantities(state)
        acc = accumulation_from_q(q)
        pvdt = self.pv / dt
        cell_res = pvdt * (acc - acc0)
        cell_res = cell_res + self.flux_divergence(q, threshold_dp)
        cq_s = stdwells.perforation_fluxes(
            wd, self.well_cell_quantities(q), state.bhp, state.qs, cdp,
            allow_crossflow=self.params.allow_crossflow)
        flat_cells = wd["perf_cell"].reshape(-1)
        flat_cq = cq_s.reshape(-1, 3)
        cell_res = cell_res.index_add(1, flat_cells, -flat_cq.T)
        well_flux, well_ctrl = stdwells.well_residuals(
            wd, state.qs, state.bhp, cq_s, state.control, state.target,
            resv_coef=wd.get("resv_coef"), vfp=wd.get("vfp"))
        return Residual(cell=cell_res, well_flux=well_flux,
                        well_ctrl=well_ctrl, b=q.b)

    # ------------------------------------------------------------------
    def convergence(self, res: Residual, dt, state: BlackoilState):
        """MB/CNV norms (padding cells masked out on embedded grids), the
        well norms and the two flags: K9's one launch on the card. Returns
        a dict of views of the history row ``row`` = [mb(3), cnv(3),
        well_flux, well_ctrl, finite, converged] (float64; the flags 1.0
        or 0.0)."""
        from opm_tpu_torch.solver import kernels_k9 as k9

        row = k9.convergence_row(
            self.k9_workspace() if self.device.type == "cuda" else None,
            *k9.conv_args(self, res, dt, state))
        mb, cnv, rest = row.split((3, 3, 4))
        wf, wc, finite, converged = rest.unbind()
        return dict(row=row, mb=mb, cnv=cnv, well_flux=wf, well_ctrl=wc,
                    finite=finite, converged=converged)

    def k9_workspace(self):
        """K9's convergence workspace on the card (made on first use)."""
        if getattr(self, "_k9_ws", None) is None:
            from opm_tpu_torch.solver.kernels_k9 import Workspace
            self._k9_ws = Workspace(self.nc, self.device)
        return self._k9_ws

    # ------------------------------------------------------------------
    # flat vector <-> state (for the dense-Jacobian Newton)
    def flatten(self, state: BlackoilState):
        return torch.cat([state.pressure, state.sw, state.x, state.bhp,
                          state.qs.reshape(-1)])

    def unflatten(self, u, template: BlackoilState) -> BlackoilState:
        nc = self.nc
        nw = template.bhp.shape[0]
        return template._replace(
            pressure=u[:nc], sw=u[nc:2 * nc], x=u[2 * nc:3 * nc],
            bhp=u[3 * nc:3 * nc + nw],
            qs=u[3 * nc + nw:3 * nc + nw + 3 * nw].reshape(nw, 3))

    def residual_vector(self, res: Residual):
        """Equation-major cell block [all water eqs, all oil, all gas]."""
        return torch.cat([res.cell.reshape(-1), res.well_flux.reshape(-1),
                          res.well_ctrl])


def make_well_device_arrays(ws: WellSet, gravity: float, device) -> dict:
    """WellSet -> dict of padded tensors consumed by the residual."""
    dev = torch.device(device)

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=dev)

    return dict(
        perf_cell=torch.as_tensor(ws.perf_cell, dtype=torch.long,
                                  device=dev),
        perf_mask=f64(ws.perf_mask),
        perf_wi=f64(ws.perf_wi),
        perf_depth=f64(ws.perf_depth),
        is_injector=torch.as_tensor(ws.is_injector, dtype=torch.bool,
                                    device=dev),
        comp_frac=f64(ws.comp_frac),
        bhp_limit=f64(ws.bhp_limit),
        ref_depth=f64(ws.ref_depth),
        open=f64(ws.open_mask),
        primary_control=torch.as_tensor(ws.control, dtype=torch.int32,
                                        device=dev),
        primary_target=f64(ws.target),
        gravity=torch.tensor(float(gravity), dtype=torch.float64,
                             device=dev),
        rate_targets=f64(ws.rate_targets),
        thp_limit=f64(ws.thp_limit),
        inj_rate_target=f64(ws.inj_rate_target),
        inj_resv_target=f64(ws.inj_resv_target),
        is_history=torch.as_tensor(ws.is_history, dtype=torch.bool,
                                   device=dev),
    )
