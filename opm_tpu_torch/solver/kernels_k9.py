"""K9: the Newton update and the convergence check, one CUDA launch each
(``csrc/newton.cu``), with their plain PyTorch twins.

Replaces the JAX package's solver/update.py ``update_state`` (:19-149)
and models/blackoil.py ``BlackoilModel.convergence`` (:447-465), which XLA
fused on the TPU.

* update: ``update_cuda`` reads the state and the cell increments ((3, nc):
  the CPR route's du_c, or a view of the dense route's flat du) in place,
  applies omega, chops the pressure, looks up rs_sat and rv_sat at the old
  and the new pressure (K1's device code), scales and switches, and an
  extra block does the well rows; its twin ``update_plain`` composes
  ``update_pressure_plain``, K1's rs_sat and rv_sat lookups and
  ``update_cells_plain``
  (the CPU path, and the kernel's oracle on the card, bit for bit);
* convergence: ``convergence_cuda`` / ``convergence_masked_cuda`` reduce
  the cells to per-block partials, and the block that finishes last forms
  the norms, the well norms and both flags into the Newton loop's history
  row [mb(3), cnv(3), well_flux, well_ctrl, finite, converged];
  ``convergence_plain`` is the reference's expression. The partials and
  the last block's ticket live in a ``Workspace`` made once per model.

On a CPU tensor every entry runs its twin; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from opm_tpu_torch.utils import cuda_lib
from opm_tpu_torch.utils.tables import lookup1
from opm_tpu_torch.wells.wells import CTRL_BHP

_EPS_SW = 1.4901161193847656e-08   # sqrt(double machine epsilon)
_THREADS = 256
_PARTS = 11

_P, _I, _L, _D = cuda_lib.P, cuda_lib.I, cuda_lib.L, cuda_lib.D
_SIGS = {
    "opm_k9_update": [_L, _I, _P, _P, _P, _P, _P, _P, _L, _P, _L, _P, _P,
                      _P, _P, _I, _P, _P, _P, _I, _P, _D, _D, _D, _D, _I,
                      _I, _P, _P, _P, _P, _P, _P, _P],
    "opm_k9_convergence": [_L, _I, _P, _P, _P, _P, _D, _I, _P, _P, _P, _P,
                           _D, _D, _D, _D, _P, _P, _P, _P],
    "opm_k9_grid": [_P],
}
_grids: dict = {}


def grid_info(device):
    """(SMs, co-resident blocks per SM, registers) of the convergence
    kernel on a CUDA device (the occupancy query, once per device)."""
    import ctypes
    dev = torch.device(device)
    if dev not in _grids:
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(dev):
            cuda_lib.check(_lib().opm_k9_grid(out), "opm_k9_grid")
        _grids[dev] = tuple(out)
    return _grids[dev]


class Tols(NamedTuple):
    """The convergence check's limits (ModelParams)."""

    mb: float
    cnv: float
    wells: float
    max_residual: float


def conv_tols(params) -> Tols:
    return Tols(params.tolerance_mb, params.tolerance_cnv,
                params.tolerance_wells, params.max_residual_allowed)


class UpdateConsts(NamedTuple):
    """The update's chops and switches (ModelParams, BlackoilProps)."""

    dp_max_rel: float
    ds_max: float
    dr_max_rel: float
    disgas: bool
    vapoil: bool


def update_consts(model) -> UpdateConsts:
    p = model.params
    return UpdateConsts(p.dp_max_rel, p.ds_max, p.dr_max_rel,
                        model.props.disgas, model.props.vapoil)


class SatTable(NamedTuple):
    """A saturated ratio's table as K1 reads it: rs_sat's bubble pressures
    (or rv_sat's gas pressures) xs (nreg, n), the saturated rs (rv) column
    ys (nreg, 1, n), the cells' PVT regions (nc,) int64 (or None with one
    region)."""

    xs: torch.Tensor
    ys: torch.Tensor
    reg: Optional[torch.Tensor]


def rs_table(props, pvtnum) -> Optional[SatTable]:
    """The rs_sat table of ``props`` (None where rs_sat is 0: no DISGAS or
    no live oil, props/blackoil.py ``rs_sat``)."""
    lo = props.oil_live
    if not (props.disgas and lo is not None):
        return None
    return SatTable(lo.pbub_tab, lo.rs_col,
                   pvtnum if lo.pbub_tab.shape[0] > 1 else None)


def rv_table(props, pvtnum) -> Optional[SatTable]:
    """The rv_sat table of ``props`` (None where rv_sat is 0: no VAPOIL or
    no wet gas, props/blackoil.py ``rv_sat``)."""
    gw = props.rv_gas
    if gw is None:
        return None
    return SatTable(gw.pg_tab, gw.rv_col,
                   pvtnum if gw.pg_tab.shape[0] > 1 else None)


class Workspace:
    """K9's convergence state on one card for nc cells: the per-block
    partials (G, 11) float64 and the last block's ticket (0 between
    launches; reset by the block that takes the last one). G: the cells'
    blocks of 256, at most the co-resident ones (one wave). Nothing is
    allocated per check but its output row."""

    def __init__(self, nc, device):
        dev = torch.device(device)
        if dev.index is None:           # a tensor's device has its index
            dev = torch.device(dev.type, torch.cuda.current_device())
        sms, per_sm, _ = grid_info(dev)
        self.device, self.nc = dev, nc
        self.grid = max(1, min(-(-nc // _THREADS), per_sm * sms))
        self.part = torch.empty(self.grid * _PARTS, dtype=torch.float64,
                                device=dev)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self.lib = cuda_lib.load("newton", _SIGS)
        self.stream = torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# convergence

def conv_norms_plain(R, b, pv, dt, mask=None):
    """(cnv (3,), mb (3,), b_avg (3,)) as the reference's convergence
    computes them; ``mask`` (nc,) 0/1 float64 drops cells (the padding of
    an embedded grid) from every norm."""
    B = 1.0 / torch.clamp(b, min=1e-300)
    if mask is None:
        pv_sum = torch.sum(pv)
        cnv = dt * torch.amax(torch.abs(R) * B / pv, dim=1)
        b_avg = torch.mean(B, dim=1)
        mb = dt * torch.abs(torch.sum(R, dim=1)) * b_avg / pv_sum
        return cnv, mb, b_avg
    pv_sum = torch.sum(pv * mask)
    cnv = dt * torch.amax(torch.abs(R) * B / pv * mask, dim=1)
    b_avg = torch.sum(B * mask, dim=1) / torch.sum(mask)
    mb = dt * torch.abs(torch.sum(R * mask, dim=1)) * b_avg / pv_sum
    return cnv, mb, b_avg


def convergence_plain(R, b, pv, dt, mask, well_flux, well_ctrl, control,
                      target, tols):
    """The history row [mb(3), cnv(3), well_flux, well_ctrl, finite,
    converged] (float64, flags 1.0 / 0.0) as the reference's convergence
    forms it."""
    cnv, mb, b_avg = conv_norms_plain(R, b, pv, dt, mask)
    zero = torch.zeros((), dtype=torch.float64, device=R.device)
    if well_flux.numel():
        max_nw = torch.amax(torch.abs(well_flux), dim=0)
        wf = torch.amax(b_avg * max_nw)
    else:
        wf = zero
    is_bhp = control == CTRL_BHP
    if well_ctrl.numel():
        ctrl_p = torch.where(is_bhp, torch.abs(well_ctrl), 0.0)
        tgt_scale = torch.clamp(torch.abs(target), min=1e-8)
        ctrl_r = torch.where(is_bhp, 0.0, torch.abs(well_ctrl) / tgt_scale)
        wc = torch.amax(ctrl_p) / torch.full_like(zero, 1e5) \
            + torch.amax(ctrl_r)
    else:
        wc = zero
    converged = (torch.all(mb < tols.mb) & torch.all(cnv < tols.cnv)
                 & (wf < tols.wells) & (wc < 1e-3))
    finite = (torch.all(torch.isfinite(mb)) & torch.all(torch.isfinite(cnv))
              & torch.isfinite(wf) & torch.all(mb < tols.max_residual)
              & torch.all(cnv < tols.max_residual))
    return torch.cat([mb, cnv, wf.reshape(1), wc.reshape(1),
                      finite.reshape(1).to(torch.float64),
                      converged.reshape(1).to(torch.float64)])


def _f64(t, shape, dev, what):
    if (t.dtype != torch.float64 or t.device != dev or not t.is_contiguous()
            or tuple(t.shape) != shape):
        raise ValueError(f"K9: {what} must be a contiguous float64 "
                         f"{shape} tensor on {dev}")


def _convergence_launch(ws, R, b, pv, dt, mask, well_flux, well_ctrl,
                        control, target, tols):
    nc, dev = ws.nc, ws.device
    _f64(R, (3, nc), dev, "R")
    _f64(b, (3, nc), dev, "b")
    _f64(pv, (nc,), dev, "pv")
    if mask is not None:
        _f64(mask, (nc,), dev, "the mask")
    nw = well_ctrl.shape[0]
    _f64(well_flux, (nw, 3), dev, "well_flux")
    _f64(well_ctrl, (nw,), dev, "well_ctrl")
    _f64(target, (nw,), dev, "target")
    if (control.dtype != torch.int32 or control.device != dev
            or not control.is_contiguous() or tuple(control.shape) != (nw,)):
        raise ValueError(f"K9: control must be a contiguous int32 ({nw},) "
                         f"tensor on {dev}")
    row = torch.empty(10, dtype=torch.float64, device=dev)
    cuda_lib.check(ws.lib.opm_k9_convergence(
        nc, ws.grid, R.data_ptr(), b.data_ptr(), pv.data_ptr(),
        None if mask is None else mask.data_ptr(), float(dt), nw,
        well_flux.data_ptr(), well_ctrl.data_ptr(), control.data_ptr(),
        target.data_ptr(), float(tols.mb), float(tols.cnv),
        float(tols.wells), float(tols.max_residual), ws.part.data_ptr(),
        ws.ticket.data_ptr(), row.data_ptr(), ws.stream),
        "opm_k9_convergence")
    return row


def convergence_cuda(ws, R, b, pv, dt, well_flux, well_ctrl, control,
                     target, tols):
    """K9's check on the card (no mask); same row as convergence_plain."""
    row = _convergence_launch(ws, R, b, pv, dt, None, well_flux, well_ctrl,
                              control, target, tols)
    convergence_cuda.launches += 1
    return row


convergence_cuda.launches = 0


def convergence_masked_cuda(ws, R, b, pv, dt, mask, well_flux, well_ctrl,
                            control, target, tols):
    """K9's check on the card with the padding mask of an embedded grid."""
    row = _convergence_launch(ws, R, b, pv, dt, mask, well_flux, well_ctrl,
                              control, target, tols)
    convergence_masked_cuda.launches += 1
    return row


convergence_masked_cuda.launches = 0


def conv_args(model, res, dt, state):
    """convergence_row's arguments after ``ws`` for a model's residual."""
    return (res.cell.contiguous(), res.b.contiguous(), model.pv, dt,
            model.conv_mask, res.well_flux.contiguous(),
            res.well_ctrl.contiguous(), state.control.contiguous(),
            state.target.contiguous(), conv_tols(model.params))


def convergence_row(ws, R, b, pv, dt, mask, well_flux, well_ctrl, control,
                    target, tols):
    """The history row: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    dev = R.device.type
    if dev == "cpu":
        return convergence_plain(R, b, pv, dt, mask, well_flux, well_ctrl,
                                 control, target, tols)
    if dev != "cuda":
        raise RuntimeError(f"no K9 convergence kernel for device {R.device}")
    if mask is None:
        return convergence_cuda(ws, R, b, pv, dt, well_flux, well_ctrl,
                                control, target, tols)
    return convergence_masked_cuda(ws, R, b, pv, dt, mask, well_flux,
                                   well_ctrl, control, target, tols)


# ---------------------------------------------------------------------------
# Newton update

def update_pressure_plain(p, dp, dp_max_rel):
    lim = dp_max_rel * torch.abs(p)
    return p - torch.clamp(dp, -lim, lim)


def update_cells_plain(sw0, x, hc, dsw, dx, rssat0, rssat, rvsat0, rvsat,
                       ds_max, dr_max_rel, disgas, vapoil):
    """(sw, x, hcstate) after the chopped update and the phase switch
    (the reference's update_state between :40 and :149)."""
    is_sg = hc == 0
    is_rs = hc == 1
    is_rv = hc == 2
    sg_old = torch.where(is_sg, x, torch.where(is_rv, 1.0 - sw0, 0.0))
    so_old = 1.0 - sw0 - sg_old
    dsg = torch.where(is_sg, dx, 0.0) - torch.where(is_rv, dsw, 0.0)
    dso = -(dsw + dsg)
    max_ds = torch.maximum(torch.maximum(torch.abs(dsw), torch.abs(dsg)),
                           torch.abs(dso))
    # a true division (python float / tensor would be reciprocal * float,
    # one rounding more than the reference's and the kernel's quotient)
    scale = torch.full_like(max_ds, ds_max) / torch.clamp(max_ds,
                                                           min=ds_max)
    sw = sw0 - scale * dsw
    sg_new = sg_old - scale * dsg
    so_upd = so_old - scale * dso
    neg_g = torch.clamp(sg_new, max=0.0)
    sw = sw / (1.0 - neg_g)
    so_upd = so_upd / (1.0 - neg_g)
    sg_new = torch.clamp(sg_new, min=0.0)
    neg_o = torch.clamp(so_upd, max=0.0)
    sw = sw / (1.0 - neg_o)
    sg_new = sg_new / (1.0 - neg_o)
    so_upd = torch.clamp(so_upd, min=0.0)
    neg_w = torch.clamp(sw, max=0.0)
    so_upd = so_upd / (1.0 - neg_w)
    sg_new = sg_new / (1.0 - neg_w)
    sw = torch.clamp(sw, min=0.0)
    rs_old = torch.where(is_rs, x, 0.0)
    drs = torch.where(is_rs, dx, 0.0)
    lim_rs = torch.clamp(torch.abs(rs_old) * dr_max_rel, min=1.0)
    rs_new = rs_old - torch.clamp(drs, -lim_rs, lim_rs)
    rv_old = torch.where(is_rv, x, 0.0)
    drv = torch.where(is_rv, dx, 0.0)
    lim_rv = torch.clamp(torch.abs(rv_old) * dr_max_rel, min=1e-3)
    rv_new = rv_old - torch.clamp(drv, -lim_rv, lim_rv)
    eps = _EPS_SW
    wat_only = sw > (1.0 - eps)
    hc_new = torch.zeros_like(hc)
    if disgas:
        has_gas = (sg_new > 0.0) & ~is_rs
        gas_vap = (is_rs & (rs_new > rssat * (1.0 + eps))
                   & (rs_old > rssat0 * (1.0 - eps)))
        use_sg = wat_only | has_gas | gas_vap
        hc_new = torch.where(use_sg, hc_new, 1).to(hc.dtype)
    if vapoil:
        has_oil = (so_upd > 0.0) & ~is_rv
        oil_cond = (is_rv & (rv_new > rvsat * (1.0 + eps))
                    & (rv_old > rvsat0 * (1.0 - eps)))
        use_sg_v = wat_only | has_oil | oil_cond
        hc_new = torch.where(use_sg_v, hc_new, 2).to(hc.dtype)
    x_new = torch.where(hc_new == 0,
                        torch.where(wat_only, 0.0,
                                    torch.clamp(sg_new, 0.0, 1.0)), 0.0)
    rs_new = torch.maximum(rs_new, -0.05 * rssat)
    rv_new = torch.maximum(rv_new, -0.05 * rvsat)
    x_new = torch.where(hc_new == 1, torch.where(is_rs, rs_new, rssat),
                        x_new)
    x_new = torch.where(hc_new == 2, torch.where(is_rv, rv_new, rvsat),
                        x_new)
    sw = torch.clamp(sw, 0.0, 1.0)
    return sw, x_new, hc_new


def _sat_pair(tab, p, pressure):
    """A saturated ratio at the old and the new pressure (K1's lookups;
    0 without its table)."""
    if tab is None:
        zero = torch.zeros_like(p)
        return zero, zero
    return (lookup1(tab.xs, tab.ys, p, reg=tab.reg)[0],
            lookup1(tab.xs, tab.ys, pressure, reg=tab.reg)[0])


def update_plain(p, sw, x, hc, bhp, qs, du_c, dbhp, dqs, omega, consts,
                 rs, rv=None):
    """(p, sw, x, hcstate, bhp, qs) after the Newton update x <- x -
    omega dx (the reference's sign convention): the twins' composition,
    ``update_pressure_plain``, K1's rs_sat and rv_sat lookups at the old
    and the new pressure (``rs``, ``rv``: their tables, None where the
    ratio is 0) and ``update_cells_plain``, then the well rows."""
    c = consts
    pressure = update_pressure_plain(p, omega * du_c[0], c.dp_max_rel)
    rssat0, rssat = _sat_pair(rs, p, pressure)
    rvsat0, rvsat = _sat_pair(rv, p, pressure)
    sw_n, x_n, hc_n = update_cells_plain(
        sw, x, hc, omega * du_c[1], omega * du_c[2], rssat0, rssat, rvsat0,
        rvsat, c.ds_max, c.dr_max_rel, c.disgas, c.vapoil)
    # well rows (StandardWells_impl.hpp:613-703)
    lim = c.dp_max_rel * torch.abs(bhp)
    bhp_n = bhp - torch.clamp(omega * dbhp, -lim, lim)
    return pressure, sw_n, x_n, hc_n, bhp_n, qs - omega * dqs


def update_cuda(p, sw, x, hc, bhp, qs, du_c, dbhp, dqs, omega, consts, rs,
                rv=None):
    """K9's update on the card, one launch; same contract as
    update_plain. du_c (3, nc) contiguous; dbhp (nw,) and dqs (nw, 3) may
    be strided views (dqs's rows contiguous)."""
    nc, nw, dev = p.shape[0], bhp.shape[0], p.device
    for t, nm in ((p, "p"), (sw, "sw"), (x, "x")):
        _f64(t, (nc,), dev, nm)
    _f64(du_c, (3, nc), dev, "du_c")
    _f64(bhp, (nw,), dev, "bhp")
    _f64(qs, (nw, 3), dev, "qs")
    if (hc.dtype != torch.int32 or hc.device != dev
            or not hc.is_contiguous() or tuple(hc.shape) != (nc,)):
        raise ValueError(f"K9: hcstate must be a contiguous int32 ({nc},) "
                         f"tensor on {dev}")
    for t, shape, nm in ((dbhp, (nw,), "dbhp"), (dqs, (nw, 3), "dqs")):
        if (t.dtype != torch.float64 or t.device != dev
                or tuple(t.shape) != shape
                or (nw and t.dim() == 2 and t.stride(1) != 1)):
            raise ValueError(f"K9: {nm} must be a float64 {shape} tensor "
                             f"on {dev} (rows contiguous)")
    rs_args = _sat_args(rs, "rs_sat", nc, dev)
    rv_args = _sat_args(rv, "rv_sat", nc, dev)
    cells = torch.empty((3, nc), dtype=torch.float64, device=dev)
    p_out, sw_out, x_out = cells.unbind(0)
    hc_out, bhp_out, qs_out = (torch.empty_like(hc), torch.empty_like(bhp),
                               torch.empty_like(qs))
    c = consts
    cuda_lib.check(_lib().opm_k9_update(
        nc, nw, p.data_ptr(), sw.data_ptr(), x.data_ptr(), hc.data_ptr(),
        du_c.data_ptr(), dbhp.data_ptr(), dbhp.stride(0) if nw else 1,
        dqs.data_ptr(), dqs.stride(0) if nw else 3, bhp.data_ptr(),
        qs.data_ptr(), *rs_args, *rv_args, float(omega),
        float(c.dp_max_rel), float(c.ds_max), float(c.dr_max_rel),
        int(bool(c.disgas)), int(bool(c.vapoil)), p_out.data_ptr(),
        sw_out.data_ptr(), x_out.data_ptr(), hc_out.data_ptr(),
        bhp_out.data_ptr(), qs_out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "opm_k9_update")
    update_cuda.launches += 1
    return p_out, sw_out, x_out, hc_out, bhp_out, qs_out


update_cuda.launches = 0


def _sat_args(tab, what, nc, dev):
    """A saturated ratio's table as the kernel's (xs, ys, n, reg) pointers
    (null, null, 0, null without one), checked."""
    if tab is None:
        return None, None, 0, None
    xs, ys, reg = tab
    n = xs.shape[1]
    _f64(xs, tuple(xs.shape), dev, f"the {what} abscissae")
    _f64(ys, (xs.shape[0], 1, n), dev, f"the {what} column")
    if (xs.shape[0] > 1) != (reg is not None) or (reg is not None and (
            reg.dtype != torch.int64 or not reg.is_contiguous()
            or tuple(reg.shape) != (nc,) or reg.device != dev)):
        raise ValueError("K9: the PVT regions must be a contiguous "
                         f"int64 ({nc},) tensor with several regions")
    return (xs.data_ptr(), ys.data_ptr(), n,
            None if reg is None else reg.data_ptr())


def _lib():
    return cuda_lib.load("newton", _SIGS)


def update_args(model, state, du_c, dbhp, dqs, omega):
    """update_cuda's / update_plain's arguments for a model and a state."""
    return (state.pressure, state.sw, state.x, state.hcstate, state.bhp,
            state.qs, du_c, dbhp, dqs, omega, update_consts(model),
            rs_table(model.props, model.pvtnum),
            rv_table(model.props, model.pvtnum))


def update(*args):
    return cuda_lib.dispatch(args[0], update_cuda, update_plain, *args,
                             what="K9 update")
