"""Initial-state computation: EQUIL equilibration and explicit deck init.

Port of the JAX package's sim/init.py: per-EQLNUM-region integration of
hydrostatic phase-pressure columns from the datum (a fixed-step midpoint
march on a 2000-point depth grid), RSVD/PBVD dissolved-gas columns,
capillary-pressure inversion for the saturation profile (sharp contacts
when the capillary curves are flat), and explicit PRESSURE/SWAT/SGAS/RS
init. The column lookups onto the cells go through K1 on the model's
device. SWATINIT and the RVVD/PDVD wet-gas columns are not ported yet
(ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import numpy as np
import torch

from opm_tpu_torch.models.state import BlackoilState, init_hcstate
from opm_tpu_torch.utils.tables import interp

_NZ = 2000  # column resolution


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
    beyond the ends) on tensors, for the deck's RSVD/PBVD columns."""
    xp = torch.as_tensor(np.ascontiguousarray(xp), dtype=torch.float64,
                         device=x.device)
    fp = torch.as_tensor(np.ascontiguousarray(fp), dtype=torch.float64,
                         device=x.device)
    n = xp.shape[0]
    if n == 1:
        return torch.full_like(x, float(fp[0]))
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
    p0t = torch.tensor(p0, dtype=torch.float64, device=z_grid.device)
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


def equilibrate_region(grid, props, rec, cells, rsvd=None, pbvd=None):
    """Phase pressures + saturations + rs/rv for the active cells of one
    equilibration region. Returns tensors over ``cells``."""
    dev = props.device
    g = grid.gravity
    depth_np = np.asarray(grid.depth)[cells]
    reg_pvt_np = np.asarray(grid.pvtnum)[cells]
    pvt0 = int(np.bincount(reg_pvt_np).argmax()) if len(reg_pvt_np) else 0
    reg_pvt = torch.as_tensor(reg_pvt_np, dtype=torch.long, device=dev)
    reg_sat = torch.as_tensor(np.asarray(grid.satnum)[cells],
                              dtype=torch.long, device=dev)

    zmin = min(depth_np.min(), rec.datum_depth, rec.woc_depth,
               rec.goc_depth) - 1.0
    zmax = max(depth_np.max(), rec.datum_depth, rec.woc_depth,
               rec.goc_depth) + 1.0
    z = _linspace(float(zmin), float(zmax), _NZ, dev)

    def tab(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=dev)

    rs_of_z = pb_of_z = None
    if rsvd is not None:
        rsvd_z, rsvd_v = tab(rsvd[:, 0]), tab(rsvd[:, 1])
        rs_of_z = lambda zz: interp(rsvd_z, rsvd_v, zz,  # noqa: E731
                                    extrap="clamp")
    if pbvd is not None:
        pbvd_z, pbvd_v = tab(pbvd[:, 0]), tab(pbvd[:, 1])
        pb_of_z = lambda zz: interp(pbvd_z, pbvd_v, zz,  # noqa: E731
                                    extrap="clamp")

    def rho_o(p, zz):
        if not props.disgas:
            return props.rho_oil(p, torch.zeros_like(p), pvt0) * g
        if rs_of_z is not None:
            rs = torch.minimum(rs_of_z(zz), props.rs_sat(p, pvt0))
        elif pb_of_z is not None:
            rs = props.rs_sat(torch.minimum(pb_of_z(zz), p), pvt0)
        else:
            rs = props.rs_sat(p, pvt0)
        return props.rho_oil(p, rs, pvt0) * g

    def rho_w(p, zz):
        return props.rho_water(p, pvt0) * g

    def rho_g(p, zz):
        return props.rho_gas(p, torch.zeros_like(p), pvt0) * g

    po = _integrate_column(z, rec.datum_depth, rec.datum_pressure, rho_o)
    woc = torch.tensor(rec.woc_depth, dtype=torch.float64, device=dev)
    goc = torch.tensor(rec.goc_depth, dtype=torch.float64, device=dev)
    po_woc = interp(z, po, woc)
    pw = _integrate_column(z, rec.woc_depth,
                           float(po_woc - rec.woc_pc), rho_w)
    po_goc = interp(z, po, goc)
    pg = _integrate_column(z, rec.goc_depth,
                           float(po_goc + rec.goc_pc), rho_g)

    zc = tab(depth_np)
    po_c = interp(z, po, zc)
    pw_c = interp(z, pw, zc)
    pg_c = interp(z, pg, zc)

    sf = props.satfunc
    swco = (sf.swco[reg_sat] if sf is not None
            else torch.zeros_like(zc))
    pcow_range = float(sf.pcow.abs().max()) if sf is not None else 0.0
    pcgo_range = float(sf.pcgo.abs().max()) if sf is not None else 0.0
    if sf is not None and pcow_range > 1e-9:
        sw = sf.pcow_inverse(po_c - pw_c, reg_sat)
    else:
        sw = torch.where(zc > rec.woc_depth, 1.0, swco)
    if sf is not None and pcgo_range > 1e-9:
        sg = sf.sg_of_pcgo(pg_c - po_c, reg_sat)
        sg = torch.where(zc < rec.goc_depth, sg, 0.0)
    else:
        sg = torch.where(zc < rec.goc_depth, 1.0 - swco, 0.0)
    sg = torch.minimum(torch.clamp(sg, min=0.0), 1.0 - sw)

    rssat_c = props.rs_sat(po_c, reg_pvt)
    if props.disgas:
        if rsvd is not None:
            rs_c = torch.minimum(np_interp(rsvd[:, 0], rsvd[:, 1], zc),
                                 rssat_c)
        elif pbvd is not None:
            pb = np_interp(pbvd[:, 0], pbvd[:, 1], zc)
            rs_c = props.rs_sat(torch.minimum(pb, po_c), reg_pvt)
        else:
            rs_c = rssat_c
    else:
        rs_c = torch.zeros_like(zc)
    rv_c = torch.zeros_like(zc)
    return po_c, sw, sg, rs_c, rv_c


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
        rv = torch.zeros(nc, dtype=torch.float64, device=dev)
    elif sol.equil:
        z = torch.zeros(nc, dtype=torch.float64, device=dev)
        p, sw, sg, rs, rv = (z.clone() for _ in range(5))
        eql = np.asarray(grid.eqlnum)
        for ireg, rec in enumerate(sol.equil):
            idx = np.nonzero(eql == ireg)[0]
            if len(idx) == 0:
                continue
            if (ireg < len(sol.rvvd) and sol.rvvd[ireg] is not None) or \
                    (ireg < len(sol.pdvd) and sol.pdvd[ireg] is not None):
                raise NotImplementedError(
                    "RVVD/PDVD are not ported yet (ROADMAP Queue 1 item 3)")
            rsvd = sol.rsvd[ireg] if ireg < len(sol.rsvd) else None
            pbvd = sol.pbvd[ireg] if ireg < len(sol.pbvd) else None
            out = equilibrate_region(grid, props, rec, idx, rsvd=rsvd,
                                     pbvd=pbvd)
            ti = torch.as_tensor(idx, dtype=torch.long, device=dev)
            for dst, src in zip((p, sw, sg, rs, rv), out):
                dst[ti] = src
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
