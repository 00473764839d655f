"""K9: the Newton update and the convergence norms, in Triton, with their
plain PyTorch twins.

Replaces the JAX package's solver/update.py ``update_state`` (:19-149,
cell part) and models/blackoil.py ``BlackoilModel.convergence`` (:447-465,
the CNV max and MB sum norms), which XLA fused on the TPU.

What bounds them on the card: memory traffic; both are elementwise passes
or a single reduction with no data reuse (a few loads and stores of 8
bytes per cell). Design:

* update: launch A chops the pressure increment; the rs_sat lookups at
  the old and new pressure then go through K1; launch B does the
  saturation scaling, the renormalisation of negative saturations, the
  rs/rv chops and the double-conditioned hydrocarbon-state switch in one
  pass per cell;
* norms: each program reduces a block of cells to per-phase partials
  (max |R|/b/pv, sum R, sum 1/b) plus sum pv; a second one-program pass
  reduces the partials and forms CNV and MB. On an embedded grid a 0/1
  mask multiplies every cell term (the padding cells drop out of the max,
  the sums and the cell count of the 1/b average), the reference's masked
  branch (models/blackoil.py:452-460).

Triton is imported inside the launching functions only (the CPU path and
the tests import this module without it). Launches pass
``enable_fp_fusion=False`` so products and sums round as the plain
version's separate elementwise operations do. Triton types Python float
arguments and most float literals as float32, so every float64 constant
of the update reaches the kernels through a small float64 tensor
(``_params``).
"""

from __future__ import annotations

import torch

from opm_tpu_torch.utils import cuda_lib

_BLOCK = 1024
_EPS_SW = 1.4901161193847656e-08   # sqrt(double machine epsilon)
_kernels: dict = {}


def _triton():
    """Define (once) and return the Triton kernels."""
    if _kernels:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit
    def _max(a, b):
        # NaN-propagating maximum, like jnp.maximum / torch.maximum
        return tl.where((a > b) | (a != a), a, b)

    @triton.jit
    def _min(a, b):
        return tl.where((a < b) | (a != a), a, b)

    @triton.jit
    def norms_partial(R, b, pv, mask, part, nc, MASKED: tl.constexpr,
                      BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < nc
        v = tl.load(pv + offs, mask=m, other=1.0)
        if MASKED:
            mk = tl.load(mask + offs, mask=m, other=0.0)
        for ph in tl.static_range(3):
            r = tl.load(R + ph * nc + offs, mask=m, other=0.0)
            bb = tl.load(b + ph * nc + offs, mask=m, other=1.0)
            B = 1.0 / _max(bb, 1e-300)
            c = tl.abs(r) * B / v
            if MASKED:
                c = c * mk
                r = r * mk
                B = B * mk
            c = tl.where(m, c, 0.0)
            tl.store(part + pid * 11 + ph, tl.max(c, axis=0))
            tl.store(part + pid * 11 + 3 + ph, tl.sum(r, axis=0))
            tl.store(part + pid * 11 + 6 + ph,
                     tl.sum(tl.where(m, B, 0.0), axis=0))
        if MASKED:
            v = v * mk
            tl.store(part + pid * 11 + 10, tl.sum(mk, axis=0))
        tl.store(part + pid * 11 + 9, tl.sum(tl.where(m, v, 0.0), axis=0))

    @triton.jit
    def norms_final(part, out, nparts, nc, MASKED: tl.constexpr,
                    BLOCK: tl.constexpr):
        offs0 = tl.arange(0, BLOCK)
        pvs = tl.zeros([BLOCK], dtype=tl.float64)
        ms = tl.zeros([BLOCK], dtype=tl.float64)
        for start in range(0, nparts, BLOCK):
            offs = start + offs0
            m = offs < nparts
            pvs += tl.load(part + offs * 11 + 9, mask=m, other=0.0)
            if MASKED:
                ms += tl.load(part + offs * 11 + 10, mask=m, other=0.0)
        pv_sum = tl.sum(pvs, axis=0)
        for ph in tl.static_range(3):
            cm = tl.zeros([BLOCK], dtype=tl.float64)
            rs = tl.zeros([BLOCK], dtype=tl.float64)
            bs = tl.zeros([BLOCK], dtype=tl.float64)
            for start in range(0, nparts, BLOCK):
                offs = start + offs0
                m = offs < nparts
                cm = _max(cm, tl.load(part + offs * 11 + ph, mask=m,
                                      other=0.0))
                rs += tl.load(part + offs * 11 + 3 + ph, mask=m, other=0.0)
                bs += tl.load(part + offs * 11 + 6 + ph, mask=m, other=0.0)
            tl.store(out + ph, tl.max(cm, axis=0))
            tl.store(out + 3 + ph, tl.abs(tl.sum(rs, axis=0)))
            if MASKED:
                tl.store(out + 6 + ph,
                         tl.sum(bs, axis=0) / tl.sum(ms, axis=0))
            else:
                tl.store(out + 6 + ph, tl.sum(bs, axis=0) / nc)
        tl.store(out + 9, pv_sum)

    @triton.jit
    def update_pressure(p, dp, out, prm, nc, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < nc
        dp_max_rel = tl.load(prm)
        pp = tl.load(p + offs, mask=m, other=1.0)
        d = tl.load(dp + offs, mask=m, other=0.0)
        lim = dp_max_rel * tl.abs(pp)
        d = _min(_max(d, -lim), lim)
        tl.store(out + offs, pp - d, mask=m)

    @triton.jit
    def update_cells(sw_p, x_p, hc_p, dsw_p, dx_p, rssat0_p, rssat_p,
                     rvsat0_p, rvsat_p, sw_out, x_out, hc_out, prm, nc,
                     DISGAS: tl.constexpr, VAPOIL: tl.constexpr,
                     BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < nc
        ds_max = tl.load(prm + 0)
        dr_max_rel = tl.load(prm + 1)
        one_m_eps = tl.load(prm + 2)
        one_p_eps = tl.load(prm + 3)
        frac_neg = tl.load(prm + 4)
        rv_floor = tl.load(prm + 5)
        sw0 = tl.load(sw_p + offs, mask=m, other=0.0)
        x = tl.load(x_p + offs, mask=m, other=0.0)
        hc = tl.load(hc_p + offs, mask=m, other=0)
        dsw = tl.load(dsw_p + offs, mask=m, other=0.0)
        dx = tl.load(dx_p + offs, mask=m, other=0.0)
        rssat0 = tl.load(rssat0_p + offs, mask=m, other=0.0)
        rssat = tl.load(rssat_p + offs, mask=m, other=0.0)
        rvsat0 = tl.load(rvsat0_p + offs, mask=m, other=0.0)
        rvsat = tl.load(rvsat_p + offs, mask=m, other=0.0)
        is_sg = hc == 0
        is_rs = hc == 1
        is_rv = hc == 2
        sg_old = tl.where(is_sg, x, tl.where(is_rv, 1.0 - sw0, 0.0))
        so_old = 1.0 - sw0 - sg_old
        dsg = tl.where(is_sg, dx, 0.0) - tl.where(is_rv, dsw, 0.0)
        dso = -(dsw + dsg)
        max_ds = _max(_max(tl.abs(dsw), tl.abs(dsg)), tl.abs(dso))
        scale = ds_max / _max(max_ds, ds_max)
        sw = sw0 - scale * dsw
        sg_new = sg_old - scale * dsg
        so_upd = so_old - scale * dso
        neg_g = _min(sg_new, 0.0)
        sw = sw / (1.0 - neg_g)
        so_upd = so_upd / (1.0 - neg_g)
        sg_new = _max(sg_new, 0.0)
        neg_o = _min(so_upd, 0.0)
        sw = sw / (1.0 - neg_o)
        sg_new = sg_new / (1.0 - neg_o)
        so_upd = _max(so_upd, 0.0)
        neg_w = _min(sw, 0.0)
        so_upd = so_upd / (1.0 - neg_w)
        sg_new = sg_new / (1.0 - neg_w)
        sw = _max(sw, 0.0)
        rs_old = tl.where(is_rs, x, 0.0)
        drs = tl.where(is_rs, dx, 0.0)
        lim_rs = _max(tl.abs(rs_old) * dr_max_rel, 1.0)
        rs_new = rs_old - _min(_max(drs, -lim_rs), lim_rs)
        rv_old = tl.where(is_rv, x, 0.0)
        drv = tl.where(is_rv, dx, 0.0)
        lim_rv = _max(tl.abs(rv_old) * dr_max_rel, rv_floor)
        rv_new = rv_old - _min(_max(drv, -lim_rv), lim_rv)
        wat_only = sw > one_m_eps
        hc_new = tl.zeros([BLOCK], dtype=tl.int32)
        if DISGAS:
            has_gas = (sg_new > 0.0) & (~is_rs)
            gas_vap = (is_rs & (rs_new > rssat * one_p_eps)
                       & (rs_old > rssat0 * one_m_eps))
            use_sg = wat_only | has_gas | gas_vap
            hc_new = tl.where(use_sg, hc_new, 1)
        if VAPOIL:
            has_oil = (so_upd > 0.0) & (~is_rv)
            oil_cond = (is_rv & (rv_new > rvsat * one_p_eps)
                        & (rv_old > rvsat0 * one_m_eps))
            use_sg_v = wat_only | has_oil | oil_cond
            hc_new = tl.where(use_sg_v, hc_new, 2)
        x_new = tl.where(hc_new == 0,
                         tl.where(wat_only, 0.0,
                                  _min(_max(sg_new, 0.0), 1.0)), 0.0)
        rs_new = _max(rs_new, -frac_neg * rssat)
        rv_new = _max(rv_new, -frac_neg * rvsat)
        x_new = tl.where(hc_new == 1, tl.where(is_rs, rs_new, rssat), x_new)
        x_new = tl.where(hc_new == 2, tl.where(is_rv, rv_new, rvsat), x_new)
        sw = _min(_max(sw, 0.0), 1.0)
        tl.store(sw_out + offs, sw, mask=m)
        tl.store(x_out + offs, x_new, mask=m)
        tl.store(hc_out + offs, hc_new, mask=m)

    _kernels.update(norms_partial=norms_partial, norms_final=norms_final,
                    update_pressure=update_pressure,
                    update_cells=update_cells, cdiv=triton.cdiv)
    return _kernels


_param_cache: dict = {}


def _params(values, dev):
    """Float64 constants for a kernel, as a cached device tensor."""
    key = (tuple(values), str(dev))
    t = _param_cache.get(key)
    if t is None:
        t = torch.tensor(values, dtype=torch.float64, device=dev)
        _param_cache[key] = t
    return t


def _check(tensors, dev, nc):
    """Contiguous float64 (nc,) tensors on dev (int32 for hcstate)."""
    for t in tensors:
        if (t.device != dev or not t.is_contiguous() or t.shape != (nc,)
                or t.dtype not in (torch.float64, torch.int32)):
            raise ValueError(f"K9 inputs must be contiguous (nc,) float64 "
                             f"tensors on {dev}")


# ---------------------------------------------------------------------------
# convergence norms

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


def _conv_norms_launch(R, b, pv, dt, mask):
    dev = R.device
    nc = pv.shape[0]
    _check((pv,) if mask is None else (pv, mask), dev, nc)
    for t in (R, b):
        if (t.shape != (3, nc) or t.dtype != torch.float64
                or t.device != dev or not t.is_contiguous()):
            raise ValueError("K9 norms: R and b must be contiguous (3, nc) "
                             "float64 tensors beside pv (nc,)")
    k = _triton()
    nparts = k["cdiv"](nc, _BLOCK)
    part = torch.empty((nparts, 11), dtype=torch.float64, device=dev)
    out = torch.empty(10, dtype=torch.float64, device=dev)
    masked = mask is not None
    k["norms_partial"][(nparts,)](R, b, pv, mask if masked else pv, part,
                                  nc, MASKED=masked, BLOCK=_BLOCK,
                                  num_warps=8, enable_fp_fusion=False)
    k["norms_final"][(1,)](part, out, nparts, nc, MASKED=masked, BLOCK=1024,
                           num_warps=8, enable_fp_fusion=False)
    # the reference's final products: cnv = dt * max, mb = dt |sum R|
    # b_avg / pv_sum
    cnv = dt * out[:3]
    mb = dt * out[3:6] * out[6:9] / out[9]
    return cnv, mb, out[6:9]


def conv_norms_triton(R, b, pv, dt):
    """K9 norms on the card; same contract as conv_norms_plain."""
    out = _conv_norms_launch(R, b, pv, dt, None)
    conv_norms_triton.launches += 1
    return out


conv_norms_triton.launches = 0


def conv_norms_masked_triton(R, b, pv, dt, mask):
    """K9 masked norms on the card; same contract as conv_norms_plain with
    a mask."""
    out = _conv_norms_launch(R, b, pv, dt, mask)
    conv_norms_masked_triton.launches += 1
    return out


conv_norms_masked_triton.launches = 0


def conv_norms(R, b, pv, dt, mask=None):
    if mask is None:
        return cuda_lib.dispatch(R, conv_norms_triton, conv_norms_plain, R,
                                 b, pv, dt, what="K9 norms")
    return cuda_lib.dispatch(R, conv_norms_masked_triton, conv_norms_plain,
                             R, b, pv, dt, mask, what="K9 norms")


# ---------------------------------------------------------------------------
# Newton update, cell part

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


def update_pressure_triton(p, dp, dp_max_rel):
    """K9 launch A on the card; same contract as update_pressure_plain."""
    dev = p.device
    nc = p.shape[0]
    _check((p, dp), dev, nc)
    if p.dtype != torch.float64 or dp.dtype != torch.float64:
        raise ValueError("K9 update: p and dp must be float64")
    out = torch.empty_like(p)
    k = _triton()
    k["update_pressure"][(k["cdiv"](nc, _BLOCK),)](
        p, dp, out, _params([dp_max_rel], dev), nc, BLOCK=_BLOCK,
        num_warps=4, enable_fp_fusion=False)
    update_pressure_triton.launches += 1
    return out


update_pressure_triton.launches = 0


def update_cells_triton(sw0, x, hc, dsw, dx, rssat0, rssat, rvsat0, rvsat,
                        ds_max, dr_max_rel, disgas, vapoil):
    """K9 launch B on the card; same contract as update_cells_plain."""
    dev = sw0.device
    nc = sw0.shape[0]
    ins = (sw0, x, hc, dsw, dx, rssat0, rssat, rvsat0, rvsat)
    _check(ins, dev, nc)
    if hc.dtype != torch.int32 or any(t.dtype != torch.float64
                                      for t in ins if t is not hc):
        raise ValueError("K9 update: hcstate int32, the rest float64")
    sw = torch.empty_like(sw0)
    x_new = torch.empty_like(x)
    hc_new = torch.empty_like(hc)
    k = _triton()
    k["update_cells"][(k["cdiv"](nc, _BLOCK),)](
        *ins, sw, x_new, hc_new,
        _params([ds_max, dr_max_rel, 1.0 - _EPS_SW, 1.0 + _EPS_SW, 0.05,
                 1e-3], dev), nc,
        DISGAS=bool(disgas), VAPOIL=bool(vapoil), BLOCK=_BLOCK,
        num_warps=4, enable_fp_fusion=False)
    update_cells_triton.launches += 1
    return sw, x_new, hc_new


update_cells_triton.launches = 0


def update_pressure(p, dp, dp_max_rel):
    return cuda_lib.dispatch(p, update_pressure_triton, update_pressure_plain,
                             p, dp, dp_max_rel, what="K9 update")


def update_cells(*args):
    return cuda_lib.dispatch(args[0], update_cells_triton, update_cells_plain,
                             *args, what="K9 update")
