"""Initial-state computation: EQUIL equilibration and explicit deck init.

Port of the JAX package's sim/init.py: per-EQLNUM-region integration of
hydrostatic phase-pressure columns from the datum (a fixed-step midpoint
march on a 2000-point depth grid; the gas column's density with rv =
rv_sat(p) under VAPOIL), RSVD/PBVD dissolved-gas and RVVD/PDVD
vaporized-oil columns, capillary-pressure inversion for the saturation
profile (sharp contacts when the capillary curves are flat), and explicit
PRESSURE/SWAT/SGAS/RS/RV init. On the card a region is two launches of
``csrc/equil.cu``: K1's column march (``equil_columns_cuda``: the three
columns), then the cell pass (``equil_cells_cuda``: the columns' K1
lookups onto the region's cells, the capillary inversions, rs_sat and
RSVD/PBVD, rv_sat and RVVD/PDVD, written straight into the initial state's
arrays), with no host read; on the CPU their plain twins
``equil_columns_plain`` and ``equil_cells_plain`` run. SWATINIT is not
ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opm_tpu_torch.models.state import GAS, OIL, BlackoilState, init_hcstate
from opm_tpu_torch.utils import cuda_lib
from opm_tpu_torch.utils.tables import lookup1_plain, lookup2_plain

_NZ = 2000  # column resolution
# the dissolved-gas and the vaporized-oil column of a region (csrc/equil.cu
# Mode)
_MODES = {None: 0, "rsvd": 1, "pbvd": 2}
_VMODES = {None: 0, "rvvd": 1, "pdvd": 2}


def _linspace(start, stop, num, device):
    """The reference's depth grid: start*(1 - i/div) + stop*(i/div), with
    the last point exactly ``stop``."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float64, device=device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.tensor([stop], dtype=torch.float64,
                                        device=device)])


def np_interp(xp, fp, x):
    """numpy.interp's formula (slope * (x - xp[j]) + fp[j], end values
    beyond the ends) on tensors, for the deck's RSVD/PBVD/RVVD/PDVD
    columns: xp, fp (n,) float64 on x's device."""
    n = xp.shape[0]
    if n == 1:
        return fp[:1].expand(x.shape)
    j = (torch.searchsorted(xp, x, right=True) - 1).clamp(0, n - 2)
    slope = (fp[j + 1] - fp[j]) / (xp[j + 1] - xp[j])
    out = slope * (x - xp[j]) + fp[j]
    out = torch.where(x >= xp[-1], fp[-1], out)
    return torch.where(x < xp[0], fp[0], out)


def _integrate_column(z_grid, z0, p0, rho_fn):
    """March p along z_grid (ascending depth) from anchor (z0, p0):
    dp/dz = rho(p, z) * g, midpoint rule, both directions. Only the steps
    the reference's masked scans take are evaluated (the others leave p
    unchanged there)."""
    n = z_grid.shape[0]
    zc = z_grid.cpu().numpy()
    i0 = int(np.clip(np.searchsorted(zc, z0), 0, n - 1))
    z0t = torch.tensor(z0, dtype=torch.float64, device=z_grid.device)
    p0t = torch.as_tensor(p0, dtype=torch.float64,
                          device=z_grid.device).reshape(())
    p_at = p0t + rho_fn(p0t, z0t) * (z_grid[i0] - z0t)
    out = [None] * n
    out[i0] = p_at
    p = p_at
    for i in range(i0 + 1, n):
        dz = z_grid[i] - z_grid[i - 1]
        p_mid = p + rho_fn(p, z_grid[i - 1]) * 0.5 * dz
        p = p + rho_fn(p_mid, z_grid[i - 1] + 0.5 * dz) * dz
        out[i] = p
    p = p_at
    for i in range(i0 - 1, -1, -1):
        dz = z_grid[i + 1] - z_grid[i]
        p_mid = p - rho_fn(p, z_grid[i + 1]) * 0.5 * dz
        p = p - rho_fn(p_mid, z_grid[i + 1] - 0.5 * dz) * dz
        out[i] = p
    return torch.stack(out)


def _row(t, pvt0):
    """Region pvt0's row of a per-region table (the row every region takes
    when the table has one), kept as a one-row table."""
    return t[:1] if t.shape[0] == 1 else t[pvt0:pvt0 + 1]


def _look1(xs, ys, x, clamp=0):
    """Column 0 of a one-row 1-D table at the 0-d query x, K1's plain
    lookup."""
    return lookup1_plain(xs, ys, x.reshape(1), None, clamp)[0][0, 0]


def equil_columns_plain(props, z, g, pvt0, rec, mode=None, vz=None,
                        vv=None, vmode=None, wz=None, wv=None):
    """The oil, water and gas pressure columns (3, nz) of one EQUIL region
    over the depth grid z: the reference's three _integrate_column marches
    with its densities rho_o, rho_w and rho_g at PVT region pvt0 (rho_g
    with rv = rv_sat(p) under VAPOIL, so wet gas is read at drv = 0),
    water anchored at the WOC and gas at the GOC on the oil column.
    ``mode`` is the region's dissolved-gas column, None (saturated), "rsvd"
    or "pbvd", with its depths vz and values vv; the vaporized-oil column
    (vmode, wz, wv) is the cell pass's only. Plain torch on either device,
    through K1's plain lookups: the kernel's twin."""
    sd = props.surface_density[pvt0]
    live, dead, gas = props.oil_live, props.oil_dead, props.gas_dead
    wet = props.gas_wet

    def rs_sat(p):
        if live is None:
            return torch.zeros_like(p)
        return _look1(_row(live.pbub_tab, pvt0), _row(live.rs_col, pvt0), p)

    def oil_b(p, rs):
        if live is None:
            return _look1(_row(dead.p, pvt0), _row(dead.cols, pvt0), p)
        pb = _look1(_row(live.rs_tab, pvt0), _row(live._pbub_col, pvt0), rs)
        dp = torch.maximum(p - pb, torch.zeros_like(p))
        return lookup2_plain(_row(live.rs_tab, pvt0), _row(live.dp_grid, pvt0),
                             _row(live.grids, pvt0), rs.reshape(1),
                             dp.reshape(1), None, 0, 0)[0][0, 0]

    def rho_o(p, zz):
        if not props.disgas:
            rs = torch.zeros_like(p)
        elif mode == "rsvd":
            rs = torch.minimum(_look1(vz[None], vv[None, None], zz, 1),
                               rs_sat(p))
        elif mode == "pbvd":
            rs = rs_sat(torch.minimum(_look1(vz[None], vv[None, None], zz, 1),
                                      p))
        else:
            rs = rs_sat(p)
        return (sd[OIL] + rs * sd[GAS]) * oil_b(p, rs) * g

    def rho_w(p, zz):
        return props.rho_water(p, pvt0) * g     # PVTW: no table lookup

    def rv_sat(p):
        return _look1(_row(wet.pg_tab, pvt0), _row(wet.rv_col, pvt0), p)

    def gas_b(p, rv):
        if wet is None:
            return _look1(_row(gas.p, pvt0), _row(gas.cols, pvt0), p)
        drv = torch.maximum(rv_sat(p) - rv, torch.zeros_like(p))
        return lookup2_plain(_row(wet.pg_tab, pvt0), _row(wet.drv_grid, pvt0),
                             _row(wet.grids, pvt0), p.reshape(1),
                             drv.reshape(1), None, 0, 0)[0][0, 0]

    def rho_g(p, zz):
        rv = (rv_sat(p) if props.rv_gas is not None
              else torch.zeros_like(p))
        return (sd[GAS] + rv * sd[OIL]) * gas_b(p, rv) * g

    def at(zz):
        return torch.tensor(zz, dtype=torch.float64, device=z.device)

    po = _integrate_column(z, rec.datum_depth, rec.datum_pressure, rho_o)
    # water anchored at the WOC, gas at the GOC (K1's lookup over the grid)
    po_woc = _look1(z[None], po[None, None], at(rec.woc_depth))
    pw = _integrate_column(z, rec.woc_depth, po_woc - rec.woc_pc, rho_w)
    po_goc = _look1(z[None], po[None, None], at(rec.goc_depth))
    pg = _integrate_column(z, rec.goc_depth, po_goc + rec.goc_pc, rho_g)
    return torch.stack([po, pw, pg])


_EQUIL_SIGS = {
    "opm_equil_meta_len": ([], cuda_lib.I),
    "opm_equil_smem_bytes": ([cuda_lib.P, cuda_lib.I, cuda_lib.I],
                             cuda_lib.L),
    "opm_equil_march": [cuda_lib.P, cuda_lib.P, cuda_lib.P, cuda_lib.I,
                        cuda_lib.P, cuda_lib.P, cuda_lib.I, cuda_lib.I,
                        cuda_lib.I, cuda_lib.I, cuda_lib.D, cuda_lib.D,
                        cuda_lib.D, cuda_lib.D, cuda_lib.D, cuda_lib.D,
                        cuda_lib.D, cuda_lib.P, cuda_lib.P],
    # the cell pass (equil_cells_cuda)
    "opm_equil_cells": [cuda_lib.P, cuda_lib.I, cuda_lib.P, cuda_lib.P,
                        cuda_lib.P] + [cuda_lib.I] * 5
    + [cuda_lib.D] * 2 + [cuda_lib.P] * 5 + [cuda_lib.I] * 3
    + [cuda_lib.P] * 2 + [cuda_lib.I] * 2
    + [cuda_lib.P] * 2 + [cuda_lib.I] * 3 + [cuda_lib.P] * 2
    + [cuda_lib.I] * 2 + [cuda_lib.P, cuda_lib.L]
    + [cuda_lib.P] * 3 + [cuda_lib.L, cuda_lib.P, cuda_lib.P],
}
# the shared memory one block may take on an H100
_SMEM_LIMIT = 227 * 1024


def equil_columns_cuda(props, z, g, pvt0, rec, mode=None, vz=None,
                       vv=None, vmode=None, wz=None, wv=None):
    """K1's column march on the card: one launch writes the (3, nz)
    columns of ``equil_columns_plain`` (same contract), with no host
    read."""
    dev = z.device
    if mode not in _MODES:
        raise ValueError(f"equil_columns_cuda: unknown mode {mode!r}")
    pack = props.cell_pack()
    if pack.tab.device != dev:
        raise ValueError(f"equil_columns_cuda: the tables are on "
                         f"{pack.tab.device}, the grid on {dev}")
    ts = [(z, "z")] + ([(vz, "vz"), (vv, "vv")] if mode else [])
    for t, nm in ts:
        if (t.dtype != torch.float64 or t.device != dev or t.dim() != 1
                or not t.is_contiguous()):
            raise ValueError(f"equil_columns_cuda: {nm} must be a "
                             f"contiguous float64 (n,) tensor on {dev}")
    nz = z.shape[0]
    nv = vz.shape[0] if mode else 0
    if nz < 2 or (mode and (nv < 2 or vv.shape != vz.shape)):
        raise ValueError("equil_columns_cuda: bad grid or column shapes")
    # pvt0's row of each table, as the twin indexes it: a table with one
    # region serves every region, the surface densities are indexed as they
    # stand
    nregs = dict(zip(pack.META, pack.meta))
    for key in ("w_nreg", "gw_nreg" if nregs["wet"] else "g_nreg", "d_nreg",
                "ol_nreg" if nregs["live"] else "od_nreg"):
        n = nregs[key]
        if not (0 <= pvt0 < n or (n == 1 and key != "d_nreg")):
            raise ValueError(f"equil_columns_cuda: PVT region {pvt0} "
                             f"outside the tables ({key} {n})")
    lib = cuda_lib.load("equil", _EQUIL_SIGS)
    if lib.opm_equil_meta_len() != len(pack.meta):
        raise RuntimeError("K1 column march: the table layout of "
                           "props/blackoil.py CellPack and csrc/pack.cuh "
                           "disagree")
    meta = ctypes.cast(pack.c_meta, ctypes.c_void_p)
    if lib.opm_equil_smem_bytes(meta, nz, nv) > _SMEM_LIMIT:
        raise ValueError("equil_columns_cuda: the grid and tables exceed "
                         "shared memory")
    out = torch.empty((3, nz), dtype=torch.float64, device=dev)
    err = lib.opm_equil_march(
        cuda_lib.ptr(pack.tab), meta, cuda_lib.ptr(z), nz,
        cuda_lib.ptr(vz) if mode else None,
        cuda_lib.ptr(vv) if mode else None, nv, _MODES[mode],
        int(bool(props.disgas)), int(pvt0), float(g),
        float(rec.datum_depth), float(rec.datum_pressure),
        float(rec.woc_depth), float(rec.woc_pc), float(rec.goc_depth),
        float(rec.goc_pc), cuda_lib.ptr(out), cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "opm_equil_march")
    equil_columns_cuda.launches += 1
    return out


equil_columns_cuda.launches = 0


def equil_columns(props, z, g, pvt0, rec, mode=None, vz=None, vv=None,
                  vmode=None, wz=None, wv=None):
    """The (3, nz) oil, water and gas pressure columns of one EQUIL region:
    K1's column march on a CUDA grid, its plain twin on the CPU."""
    return cuda_lib.dispatch(z, equil_columns_cuda, equil_columns_plain,
                             props, z, g, pvt0, rec, mode, vz, vv, vmode,
                             wz, wv, what="K1 EQUIL column march")


def _column(vd, dev):
    """A depth table's (depths, values) as float64 tensors on dev."""
    return tuple(torch.as_tensor(np.ascontiguousarray(vd[:, k]),
                                 dtype=torch.float64, device=dev)
                 for k in (0, 1))


def march_args(grid, props, rec, cells, rsvd=None, pbvd=None, rvvd=None,
               pdvd=None):
    """The arguments of ``equil_columns`` for the EQUIL region ``rec`` over
    its active ``cells``: (props, z, g, pvt0, rec, mode, vz, vv, vmode, wz,
    wv), with the depth grid z from 1 m above to 1 m below the cells and
    the contacts (``_NZ`` points), pvt0 the region's most frequent PVT
    region, its RSVD or PBVD column (mode, vz, vv) and its RVVD or PDVD
    column (vmode, wz, wv)."""
    dev = props.device
    depth = np.asarray(grid.depth)[cells]
    reg_pvt = np.asarray(grid.pvtnum)[cells]
    pvt0 = int(np.bincount(reg_pvt).argmax()) if len(reg_pvt) else 0
    zmin = min(depth.min(), rec.datum_depth, rec.woc_depth,
               rec.goc_depth) - 1.0
    zmax = max(depth.max(), rec.datum_depth, rec.woc_depth,
               rec.goc_depth) + 1.0
    z = _linspace(float(zmin), float(zmax), _NZ, dev)
    mode, vd = (("rsvd", rsvd) if rsvd is not None
                else ("pbvd", pbvd) if pbvd is not None else (None, None))
    vmode, wd = (("rvvd", rvvd) if rvvd is not None
                 else ("pdvd", pdvd) if pdvd is not None else (None, None))
    vz, vv = _column(vd, dev) if mode else (None, None)
    wz, wv = _column(wd, dev) if vmode else (None, None)
    return (props, z, grid.gravity, pvt0, rec, mode, vz, vv, vmode, wz,
            wv)


def equil_regions(grid, case):
    """(rec, cells, columns) of each EQUIL region that has cells; columns
    holds its RSVD, PBVD, RVVD and PDVD tables (None where the deck has
    none), ``march_args``'s keywords."""
    sol = case.solution
    eql = np.asarray(grid.eqlnum)
    out = []
    for ireg, rec in enumerate(sol.equil):
        idx = np.nonzero(eql == ireg)[0]
        if len(idx) == 0:
            continue
        cols = {k: (getattr(sol, k)[ireg] if ireg < len(getattr(sol, k))
                    else None) for k in ("rsvd", "pbvd", "rvvd", "pdvd")}
        out.append((rec, idx, cols))
    return out


def equil_cell_data(grid, device):
    """The cells' depth (float64) and PVT and SAT region numbers (int32)
    over the whole grid on ``device``: what the cell pass reads at a
    region's cells."""
    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    return (t(grid.depth, torch.float64), t(grid.pvtnum, torch.int32),
            t(grid.satnum, torch.int32))


def _look(xs, ys, x, reg, clamp):
    """Column 0 of a per-region 1-D table at the queries x (K1's plain
    lookup; reg picks each query's row where the table has several)."""
    return lookup1_plain(xs, ys, x, reg if xs.shape[0] > 1 else None,
                         clamp)[0][0]


def equil_cells_plain(args, cols, cells, cell_data, out):
    """The cell side of one EQUIL region: the columns ``cols`` (3, nz) of
    the march over its depth grid onto the region's ``cells`` (int32), the
    capillary inversions (sw from pcow where the deck's pcow is not flat,
    else a sharp WOC; sg from pcgo above the GOC), the saturated rs at
    each cell's PVT region and the RSVD/PBVD column, under VAPOIL rv from
    the RVVD column capped by rv_sat(pg), or from PDVD as rv_sat(min(pd,
    pg)), or rv_sat(pg); p, sw, sg, rs and rv written at the cells into
    the rows of ``out`` (5, nc). ``args`` are the region's ``march_args``,
    ``cell_data`` the grid's ``equil_cell_data``. Plain torch on either
    device through K1's plain lookups: the kernel's twin."""
    props, z, _, _, rec, mode, vz, vv, vmode, wz, wv = args
    depth, pvtnum, satnum = cell_data
    idx = cells.long()
    zc = depth[idx]
    reg_pvt, reg_sat = pvtnum[idx].long(), satnum[idx].long()
    po_c, pw_c, pg_c = lookup1_plain(z[None], cols[None], zc, None, 0)[0]

    sf = props.satfunc
    swco = (sf.swco[reg_sat] if sf is not None
            else torch.zeros_like(zc))
    if sf is not None and sf.pcow_range > 1e-9:
        # sw(pcow): pcow is non-increasing in sw, so the negated curve
        sw = _look(sf.pcow_neg, sf.sw[:, None], -(po_c - pw_c), reg_sat, 1)
    else:
        sw = torch.where(zc > rec.woc_depth, 1.0, swco)
    if sf is not None and sf.pcgo_range > 1e-9:
        sg = _look(sf.pcgo_x, sf.sg[:, None], pg_c - po_c, reg_sat, 1)
        sg = torch.where(zc < rec.goc_depth, sg, 0.0)
    else:
        sg = torch.where(zc < rec.goc_depth, 1.0 - swco, 0.0)
    sg = torch.minimum(torch.clamp(sg, min=0.0), 1.0 - sw)

    lo = props.oil_live

    def rs_sat(p):
        if props.disgas and lo is not None:
            return _look(lo.pbub_tab, lo.rs_col, p, reg_pvt, 0)
        return torch.zeros_like(p)

    rssat_c = rs_sat(po_c)
    if props.disgas:
        if mode == "rsvd":
            rs_c = torch.minimum(np_interp(vz, vv, zc), rssat_c)
        elif mode == "pbvd":
            pb = np_interp(vz, vv, zc)
            rs_c = rs_sat(torch.minimum(pb, po_c))
        else:
            rs_c = rssat_c
    else:
        rs_c = torch.zeros_like(zc)
    gw = props.rv_gas
    if gw is not None:
        def rv_sat(p):
            return _look(gw.pg_tab, gw.rv_col, p, reg_pvt, 0)

        rvsat_c = rv_sat(pg_c)
        if vmode == "rvvd":
            rv_c = torch.minimum(np_interp(wz, wv, zc), rvsat_c)
        elif vmode == "pdvd":
            rv_c = rv_sat(torch.minimum(np_interp(wz, wv, zc), pg_c))
        else:
            rv_c = rvsat_c
    else:
        rv_c = torch.zeros_like(zc)
    out[:, idx] = torch.stack([po_c, sw, sg, rs_c, rv_c])


def equil_cells_cuda(args, cols, cells, cell_data, out):
    """The cell pass on the card: one launch writes what
    ``equil_cells_plain`` writes (same contract), with no host read."""
    props, z, _, _, rec, mode, vz, vv, vmode, wz, wv = args
    depth, pvtnum, satnum = cell_data
    dev = z.device
    nz, nc = z.shape[0], depth.shape[0]
    nv = vz.shape[0] if mode else 0
    nw = wz.shape[0] if vmode else 0
    if mode not in _MODES or vmode not in _VMODES:
        raise ValueError(f"equil_cells_cuda: unknown modes {mode!r}, "
                         f"{vmode!r}")
    for t, nm, shape in ((z, "z", (nz,)), (cols, "cols", (3, nz)),
                         (depth, "depth", (nc,)), (out, "out", (5, nc)),
                         *([(vz, "vz", (nv,)), (vv, "vv", (nv,))]
                           if mode else []),
                         *([(wz, "wz", (nw,)), (wv, "wv", (nw,))]
                           if vmode else [])):
        if (t.dtype != torch.float64 or t.device != dev
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"equil_cells_cuda: {nm} must be a contiguous "
                             f"float64 {shape} tensor on {dev}")
    for t, nm in ((pvtnum, "pvtnum"), (satnum, "satnum"), (cells, "cells")):
        if (t.dtype != torch.int32 or t.device != dev or t.dim() != 1
                or not t.is_contiguous()):
            raise ValueError(f"equil_cells_cuda: {nm} must be a contiguous "
                             f"int32 (n,) tensor on {dev}")
    if pvtnum.shape != (nc,) or satnum.shape != (nc,):
        raise ValueError("equil_cells_cuda: the region numbers do not "
                         "span the grid")
    if 8 * (4 * nz + 2 * nv + 2 * nw) > _SMEM_LIMIT:
        raise ValueError("equil_cells_cuda: the columns exceed shared "
                         "memory")
    sf, lo, gw = props.satfunc, props.oil_live, props.rv_gas
    if sf is None:
        raise NotImplementedError("EQUIL's cell pass without SWOF/SGOF is "
                                  "not ported (ROADMAP Queue 1 item 2)")
    live = bool(props.disgas) and lo is not None
    tabs = [(sf.pcow_neg, "pcow_neg"), (sf.sw, "sw"), (sf.pcgo_x, "pcgo_x"),
            (sf.sg, "sg"), (sf.swco, "swco")]
    o_tabs = ([(lo.pbub_tab, "pbub_tab"), (lo.rs_tab, "rs_tab")] if live
              else [(None, "")] * 2)
    vap = gw is not None
    g_tabs = ([(gw.pg_tab, "pg_tab"), (gw.rv_sat_tab, "rv_sat_tab")] if vap
              else [(None, "")] * 2)
    for t, nm in tabs + o_tabs + g_tabs:
        if t is not None and (t.dtype != torch.float64 or t.device != dev
                              or not t.is_contiguous()):
            raise ValueError(f"equil_cells_cuda: the table {nm} is not a "
                             f"contiguous float64 tensor on {dev}")
    o_dims = tuple(lo.rs_tab.shape) if live else (0, 0)
    g_dims = tuple(gw.pg_tab.shape) if vap else (0, 0)

    def p(t):
        return None if t is None else cuda_lib.ptr(t)

    lib = cuda_lib.load("equil", _EQUIL_SIGS)
    err = lib.opm_equil_cells(
        p(z), nz, p(cols), p(vz) if mode else None, p(vv) if mode else None,
        nv, _MODES[mode], int(bool(props.disgas)),
        int(sf.pcow_range > 1e-9), int(sf.pcgo_range > 1e-9),
        float(rec.woc_depth), float(rec.goc_depth),
        *(p(t) for t, _ in tabs), sf.sw.shape[0], sf.sw.shape[1],
        sf.sg.shape[1], *(p(t) for t, _ in o_tabs), *o_dims,
        p(wz) if vmode else None, p(wv) if vmode else None, nw,
        _VMODES[vmode], int(vap), *(p(t) for t, _ in g_tabs), *g_dims,
        p(cells), cells.shape[0], p(depth), p(pvtnum), p(satnum), nc,
        p(out), cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "opm_equil_cells")
    equil_cells_cuda.launches += 1


equil_cells_cuda.launches = 0


def equil_cells(args, cols, cells, cell_data, out):
    """The cell side of one EQUIL region into ``out`` (5, nc): the cell
    pass on a CUDA grid, its plain twin on the CPU."""
    return cuda_lib.dispatch(args[1], equil_cells_cuda, equil_cells_plain,
                             args, cols, cells, cell_data, out,
                             what="K1 EQUIL cell pass")


def equilibrate_region(grid, props, rec, cells, rsvd=None, pbvd=None,
                       rvvd=None, pdvd=None):
    """Phase pressures + saturations + rs/rv for the active cells of one
    equilibration region: the column march, then the cell pass. Returns
    tensors over ``cells``."""
    dev = props.device
    args = march_args(grid, props, rec, cells, rsvd, pbvd, rvvd, pdvd)
    ti = torch.as_tensor(cells, dtype=torch.int32, device=dev)
    out = torch.zeros((5, grid.nc), dtype=torch.float64, device=dev)
    equil_cells(args, equil_columns(*args), ti, equil_cell_data(grid, dev),
                out)
    return tuple(out[:, ti.long()])


def initial_state(grid, props, case, nw: int) -> BlackoilState:
    """Full initial BlackoilState from the deck SOLUTION section, on the
    props' device."""
    dev = props.device
    nc = grid.nc
    sol = case.solution

    def cells(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)
                               [grid.global_cell], device=dev)

    if "SWATINIT" in case.grid_arrays and sol.equil:
        raise NotImplementedError(
            "SWATINIT is not ported yet (ROADMAP Queue 1 item 3)")
    if sol.pressure is not None:
        p = cells(sol.pressure)
        sw = cells(sol.swat) if sol.swat is not None else \
            torch.zeros(nc, dtype=torch.float64, device=dev)
        sg = cells(sol.sgas) if sol.sgas is not None else \
            torch.zeros(nc, dtype=torch.float64, device=dev)
        pvtnum = torch.as_tensor(grid.pvtnum, dtype=torch.long, device=dev)
        rs = cells(sol.rs) if sol.rs is not None else \
            props.rs_sat(p, pvtnum)
        rv = cells(sol.rv) if sol.rv is not None else \
            torch.zeros(nc, dtype=torch.float64, device=dev)
    elif sol.equil:
        # every region's inputs first (the host-to-device copies), then a
        # march and a cell pass a region writing into out's rows
        cell_data = equil_cell_data(grid, dev)
        regions = [(march_args(grid, props, rec, idx, **vd),
                    torch.as_tensor(idx, dtype=torch.int32, device=dev))
                   for rec, idx, vd in equil_regions(grid, case)]
        out = torch.zeros((5, nc), dtype=torch.float64, device=dev)
        for args, ti in regions:
            equil_cells(args, equil_columns(*args), ti, cell_data, out)
        p, sw, sg, rs, rv = out
    else:
        raise ValueError("deck has neither EQUIL nor explicit initial state")

    hc = init_hcstate(sw, sg, disgas=props.disgas, vapoil=props.vapoil)
    x = torch.where(hc == 1, rs, torch.where(hc == 2, rv, sg))
    return BlackoilState(
        pressure=p, sw=sw, x=x, hcstate=hc,
        bhp=torch.zeros(nw, dtype=torch.float64, device=dev),
        qs=torch.zeros((nw, 3), dtype=torch.float64, device=dev),
        control=torch.zeros(nw, dtype=torch.int32, device=dev),
        target=torch.zeros(nw, dtype=torch.float64, device=dev))
