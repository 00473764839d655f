"""StandardWells on tensors (port of the JAX package's wells/standard.py).

Perforation fluxes, well equations (with the VFP lookup of THP control
and the voidage coefficients of RESV control), wellbore densities, well
potentials and control switching (the THP constraint, history rules and
the in-Newton group reallocation) over padded (nw, max_perf) arrays.
"""

from __future__ import annotations

import torch

from opm_tpu_torch.wells.wells import (CTRL_BHP, CTRL_GRAT, CTRL_LRAT,
                                       CTRL_ORAT, CTRL_RESERVOIR_RATE,
                                       CTRL_RESV, CTRL_SURFACE_RATE,
                                       CTRL_THP, CTRL_WRAT)

WATER, OIL, GAS = 0, 1, 2
_EPS = 1e-14


def _gather_ph(a3, c):
    """(3, nc) cell array at (nw, mp) cells -> (nw, mp, 3)."""
    return torch.movedim(a3[:, c], 0, -1)


def _perf_fields(cellq, c, keys):
    if cellq.get("perf_local"):
        return tuple(cellq[k] for k in keys)
    return tuple(_gather_ph(cellq[k], c) if cellq[k].dim() == 2
                 else cellq[k][c] for k in keys)


def wellbore_mixture(qs, comp_frac, is_injector=None):
    """Surface-volume fractions of the wellbore mixture: current rates for
    producers, the specified injection composition for injectors."""
    total = torch.sum(qs, dim=-1, keepdim=True)
    flowing = torch.abs(total) > _EPS
    frac = qs / torch.where(flowing, total, 1.0)
    mix = torch.where(flowing, frac, comp_frac)
    if is_injector is not None:
        inj = is_injector.to(torch.bool)
        mix = torch.where(inj[..., None] if inj.dim() < mix.dim() else inj,
                          comp_frac, mix)
    return mix


def perf_flux_formula(p_cell, b, mob, rs, rv, wi, bhp_plus_cdp, cmix,
                      is_injector, *, allow_crossflow=True):
    """Perforation surface rates cq_s (..., 3), positive = injection."""
    ddn = p_cell - bhp_plus_cdp
    cq_r = -wi[..., None] * mob * ddn[..., None]
    base = b * cq_r
    prod = torch.stack([
        base[..., WATER],
        base[..., OIL] + rv * base[..., GAS],
        base[..., GAS] + rs * base[..., OIL],
    ], dim=-1)
    totmob = torch.sum(mob, dim=-1)
    cqt_r = -wi * totmob * ddn
    cw = cmix[..., WATER]
    co = cmix[..., OIL]
    cg = cmix[..., GAS]
    eps = torch.full_like(rs, _EPS)
    d = torch.maximum(1.0 - rs * rv, eps)
    volrat = (cw / torch.maximum(b[..., WATER], eps)
              + (co - rv * cg) / d / torch.maximum(b[..., OIL], eps)
              + (cg - rs * co) / d / torch.maximum(b[..., GAS], eps))
    cqt_s = cqt_r / torch.maximum(volrat, eps)
    inj = cmix * cqt_s[..., None]
    producing = ddn > 0.0
    cq_s = torch.where(producing[..., None], prod, inj)
    if not allow_crossflow:
        keep = torch.where(is_injector, ~producing, producing)
        cq_s = torch.where(keep[..., None], cq_s, 0.0)
    return cq_s


def perforation_fluxes(wd, cellq, bhp, qs, cdp, *, allow_crossflow=True):
    """Padded-array perforation fluxes cq_s (nw, mp, 3)."""
    c = wd["perf_cell"]
    mask = wd["perf_mask"] * wd["open"][:, None]
    cmix = wellbore_mixture(qs, wd["comp_frac"], wd["is_injector"])
    po_p, b_p, mob_p, rs_p, rv_p = _perf_fields(
        cellq, c, ("p_oil", "b", "mob", "rs", "rv"))
    cq_s = perf_flux_formula(
        po_p, b_p, mob_p, rs_p, rv_p, wd["perf_wi"], bhp[:, None] + cdp,
        torch.broadcast_to(cmix[:, None, :], c.shape + (3,)),
        torch.broadcast_to(wd["is_injector"][:, None], c.shape),
        allow_crossflow=allow_crossflow)
    return cq_s * mask[..., None]


def effective_distribution(g, control, is_injector, cq_s):
    """Dead-well fallback: a rate-controlled producer that cannot flow at
    all gets a total-rate distribution."""
    prod_rates = torch.clamp(-torch.sum(cq_s, dim=1), min=0.0)
    total = torch.sum(prod_rates, dim=1)
    is_rate_prod = (~is_injector) & (torch.sum(torch.abs(g), dim=1) > 0)
    dead = is_rate_prod & (total <= 1e-14)
    return torch.where(dead[:, None], -1.0, g)


_RATE_ROWS = {}


def _rate_rows(dev):
    """The distribution rows of ORAT, WRAT, GRAT and LRAT (4, 3), made once
    a device from an identity on it: no host-to-device copy inside a
    Newton iteration. 0 - e keeps the zeros +0.0."""
    rows = _RATE_ROWS.get(dev)
    if rows is None:
        eye = torch.eye(3, dtype=torch.float64, device=dev)
        rows = _RATE_ROWS[dev] = 0.0 - torch.stack(
            [eye[OIL], eye[WATER], eye[GAS], eye[WATER] + eye[OIL]])
    return rows


def control_distribution(control, comp_frac):
    """Rate-distribution vector g with rate residual g.qs - target."""
    nw = control.shape[0]
    dev = comp_frac.device
    g = torch.zeros((nw, 3), dtype=torch.float64, device=dev)
    rows = _rate_rows(dev)
    for k, code in enumerate((CTRL_ORAT, CTRL_WRAT, CTRL_GRAT, CTRL_LRAT)):
        g = torch.where((control == code)[:, None], rows[k], g)
    g = torch.where((control == CTRL_SURFACE_RATE)[:, None], comp_frac, g)
    return g


def resv_distribution(g, control, is_injector, resv_coef):
    """g with the RESV-controlled wells' rows replaced by their signed
    voidage coefficients (+ for injectors, - for producers)."""
    if resv_coef is None:
        return g
    is_resv = ((control == CTRL_RESV)
               | (control == CTRL_RESERVOIR_RATE))[:, None]
    sign = torch.where(is_injector, 1.0, -1.0)[:, None]
    return torch.where(is_resv, sign * resv_coef, g)


def vfp_bhp(vfp, qs, thp):
    """The BHP each well's VFP table gives at rates qs (nw, 3) and THP
    thp (nw,), plus its datum correction (0 where a well has no table):
    vfp = (tables tuple, slot (nw,), dp_corr (nw,)), slot -1 = none."""
    tables, slot, dp_corr = vfp
    out = torch.zeros_like(thp)
    for si, tab in enumerate(tables):
        out = torch.where(slot == si, tab.bhp_at(qs, thp) + dp_corr, out)
    return out


def well_residuals(wd, qs, bhp, cq_s, control, target, *, resv_coef=None,
                   vfp=None):
    """(flux_res (nw, 3), ctrl_res (nw,)): q_s - sum_perf cq_s, and
    bhp - target (BHP), g.qs - target (rate controls; RESV through the
    voidage coefficients) or bhp - VFP(target, rates) - dp_datum (THP
    control, addWellControlEq's THP branch, StandardWells_impl.hpp:
    884-960). vfp: optional (tables, slot (nw,), dp_corr (nw,))."""
    flux_res = qs - torch.sum(cq_s, dim=1)
    inj = wd["is_injector"].to(torch.bool)
    g = control_distribution(control, wd["comp_frac"])
    g = resv_distribution(g, control, inj, resv_coef)
    g = effective_distribution(g, control, inj, cq_s)
    is_bhp = (control == CTRL_BHP) | (control == CTRL_THP)
    rate_res = torch.einsum("wp,wp->w", g, qs) - target
    # a rate-controlled well that cannot flow at all is pinned to its BHP
    # limit (structurally singular well block otherwise)
    tot_flow = torch.sum(torch.abs(torch.sum(cq_s, dim=1)), dim=1)
    is_rate = torch.sum(torch.abs(g), dim=1) > 0
    dead_all = is_rate & (tot_flow <= torch.clamp(1e-6 * torch.abs(target),
                                                  min=1e-14))
    bhp_target = target
    if vfp is not None:
        bhp_target = torch.where(control == CTRL_THP,
                                 vfp_bhp(vfp, qs, target), target)
    ctrl_res = torch.where(is_bhp, bhp - bhp_target, rate_res)
    ctrl_res = torch.where(dead_all, bhp - wd["bhp_limit"], ctrl_res)
    closed = ~wd["open"].to(torch.bool)
    flux_res = torch.where(closed[:, None], qs, flux_res)
    ctrl_res = torch.where(closed, bhp - wd["bhp_limit"], ctrl_res)
    return flux_res, ctrl_res


def wellbore_mixture_density(wd, cellq, qs, perf_rates=None):
    """Per-connection wellbore mixture densities rho_mix (nw, mp)."""
    c = wd["perf_cell"]
    b, rs, rv, rho_cell, sd = _perf_fields(
        cellq, c, ("b", "rs", "rv", "rho_avg", "surface_density"))
    if perf_rates is not None:
        seg = torch.flip(torch.cumsum(torch.flip(perf_rates, [1]), dim=1),
                         [1])
        tot = torch.sum(seg, dim=-1, keepdim=True)
        ok = torch.abs(tot) > _EPS
        frac = torch.abs(seg) / torch.clamp(
            torch.sum(torch.abs(seg), dim=-1, keepdim=True), min=_EPS)
        fallback = wellbore_mixture(qs, wd["comp_frac"],
                                    wd["is_injector"])[:, None, :]
        mix3 = torch.where(ok, frac, fallback)
        qw, qo, qg = mix3[..., WATER], mix3[..., OIL], mix3[..., GAS]
    else:
        mix = wellbore_mixture(qs, wd["comp_frac"], wd["is_injector"])
        qw, qo, qg = mix[:, None, WATER], mix[:, None, OIL], mix[:, None, GAS]
    d = torch.clamp(1.0 - rs * rv, min=_EPS)
    vol_w = qw / torch.clamp(b[..., WATER], min=_EPS)
    vol_o = (qo - rv * qg) / d / torch.clamp(b[..., OIL], min=_EPS)
    vol_g = (qg - rs * qo) / d / torch.clamp(b[..., GAS], min=_EPS)
    vol = vol_w + vol_o + vol_g
    mass = qw * sd[..., WATER] + qo * sd[..., OIL] + qg * sd[..., GAS]
    return torch.where(vol > _EPS, mass / torch.clamp(vol, min=_EPS),
                       rho_cell)


def connection_pressure_offsets(wd, cellq, qs, perf_rates=None):
    """Explicit wellbore hydrostatic pressure offsets cdp (nw, mp)."""
    mask = wd["perf_mask"].to(torch.float64)
    rho_mix = wellbore_mixture_density(wd, cellq, qs, perf_rates)
    z = wd["perf_depth"]
    zprev = torch.cat([wd["ref_depth"][:, None], z[:, :-1]], dim=1)
    dz = (z - zprev) * mask
    dp = wd["gravity"] * rho_mix * dz
    return torch.cumsum(dp, dim=1)


def well_potentials(wd, cellq, cdp):
    """Phase production/injection potentials at the wells' BHP limits
    (computeWellPotentials, StandardWells_impl.hpp:1005): the surface rates
    each well could deliver with its pressure constraint active; guide
    rates. (nw, 3), production positive for producers."""
    bhp = wd["bhp_limit"]
    qs0 = torch.zeros((bhp.shape[0], 3), dtype=torch.float64,
                      device=bhp.device)
    cq = perforation_fluxes(wd, cellq, bhp, qs0, cdp, allow_crossflow=False)
    tot = torch.sum(cq, dim=1)
    return torch.where(wd["is_injector"][:, None], tot, -tot)


def update_controls(wd, bhp, qs, control, target, cq_sum=None):
    """First-broken-constraint switching (updateWellControls,
    StandardWells_impl.hpp:712-790): the BHP limit, the THP limit (its BHP
    through the VFP tables), the producer ORAT/WRAT/GRAT/LRAT/RESV limits
    (WCONHIST's observed rates are no limits) and the injector surface and
    reservoir rate limits, in that order; the first one broken that is not
    the active control becomes it. cq_sum (nw, 3), the summed perforation
    rates, also sends rate producers whose controlled phase cannot flow to
    their BHP limit. Then the per-Newton group reallocation over
    wd["groups"] (updateWellTargets, BlackoilModelBase_impl.hpp:779-792,
    2548-2596): the members at their BHP limit keep what they make, the
    rest of the group's target goes to the members on group control in
    proportion to their current targets (else their guides)."""
    is_inj = wd["is_injector"].to(torch.bool)
    primary = wd["primary_control"]
    primary_target = wd["primary_target"]
    prod = torch.clamp(-qs, min=0.0)
    inj = torch.clamp(qs, min=0.0)
    eps = 1e-10

    viol_bhp = torch.where(is_inj, bhp > wd["bhp_limit"],
                           bhp < wd["bhp_limit"])
    if cq_sum is not None:
        gd = control_distribution(control, wd["comp_frac"])
        cprod = torch.clamp(-cq_sum, min=0.0)
        sel = (torch.abs(gd) > 0.0).to(cprod.dtype)
        controlled = torch.sum(sel * cprod, dim=1)
        total = torch.sum(cprod, dim=1)
        ctrl_dead = (~is_inj & (torch.sum(torch.abs(gd), dim=1) > 0)
                     & (controlled <= 1e-10 * torch.clamp(total, min=1e-30))
                     & (total > 1e-14))
        viol_bhp = viol_bhp | ctrl_dead

    candidates = [(CTRL_BHP, viol_bhp, wd["bhp_limit"])]
    thp_lim = wd.get("thp_limit")
    vfp = wd.get("vfp")
    if vfp is not None and thp_lim is not None:
        # the BHP the well would need to sustain its THP limit
        bhp_thp = vfp_bhp(vfp, qs, thp_lim)
        has = torch.isfinite(thp_lim) & (vfp[1] >= 0)
        viol_thp = has & torch.where(is_inj, bhp > bhp_thp, bhp < bhp_thp)
        candidates.append((CTRL_THP, viol_thp, thp_lim))

    rt = wd["rate_targets"]
    is_hist = wd["is_history"]
    cur = {CTRL_ORAT: (prod[:, OIL], rt[:, 0]),
           CTRL_WRAT: (prod[:, WATER], rt[:, 1]),
           CTRL_GRAT: (prod[:, GAS], rt[:, 2]),
           CTRL_LRAT: (prod[:, OIL] + prod[:, WATER], rt[:, 3])}
    resv_coef = wd.get("resv_coef")
    if resv_coef is not None:
        cur[CTRL_RESV] = (torch.sum(prod * resv_coef, dim=1), rt[:, 4])
    for code, (rate, lim) in cur.items():
        # the primary control's target may have been recomputed (group
        # distribution, WCONHIST RESV voidage): prefer it
        lim = torch.where(primary == code, primary_target, lim)
        mask = ~is_inj & torch.isfinite(lim)
        mask = mask & (~is_hist.to(torch.bool) | (primary == code))
        viol = mask & (rate > lim * (1.0 + eps))
        candidates.append((code, viol, lim))
    irt = wd["inj_rate_target"]
    lim = torch.where(primary == CTRL_SURFACE_RATE, primary_target, irt)
    viol = (is_inj & torch.isfinite(lim)
            & (torch.sum(inj, dim=1) > lim * (1.0 + eps)))
    candidates.append((CTRL_SURFACE_RATE, viol, lim))
    irv = wd.get("inj_resv_target")
    if irv is not None and resv_coef is not None:
        lim = torch.where(primary == CTRL_RESERVOIR_RATE, primary_target,
                          irv)
        viol = (is_inj & torch.isfinite(lim)
                & (torch.sum(inj * resv_coef, dim=1) > lim * (1.0 + eps)))
        candidates.append((CTRL_RESERVOIR_RATE, viol, lim))

    new_control, new_target = control, target
    chosen = torch.zeros(bhp.shape, dtype=torch.bool, device=bhp.device)
    for code, viol, tgt in candidates:
        hit = viol & (control != code) & ~chosen
        new_control = torch.where(hit, torch.full_like(control, code),
                                  new_control)
        new_target = torch.where(hit, tgt, new_target)
        chosen = chosen | hit
    closed = ~wd["open"].to(torch.bool)
    new_control = torch.where(closed, control, new_control)
    new_target = torch.where(closed, target, new_target)

    for spec in wd.get("groups", ()):
        code, pv, total, mask, guides, sign = spec[:6]
        on_grp = (mask > 0.0) & (new_control == code)
        on_bhp = (mask > 0.0) & (new_control == CTRL_BHP)
        made = torch.clamp(sign * (qs @ pv), min=0.0)
        absorbed = torch.sum(torch.where(on_bhp, made, 0.0))
        remaining = torch.clamp(total - absorbed, min=0.0)
        g_dyn = torch.where(on_grp, torch.abs(new_target), 0.0)
        g_dyn = torch.where(torch.sum(g_dyn) > 0.0, g_dyn,
                            torch.where(on_grp, guides, 0.0))
        share = g_dyn / torch.clamp(torch.sum(g_dyn), min=1e-300)
        new_target = torch.where(on_grp, remaining * share, new_target)
    return new_control, new_target
