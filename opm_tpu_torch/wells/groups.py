"""Group controls: GRUP wells inherit distributed group targets.

Port of the JAX package's wells/groups.py: the host-side resolution a
report step is a copy (numpy only); the per-Newton reallocation arrays are
tensors on the simulator's device. The capability the reference gets from
opm-core's WellCollection (guide rates, group targets; hooks
setupGroupControl / applyVREPGroupControl / updateWellTargets at
opm/autodiff/BlackoilModelBase_impl.hpp:779-792, :2548-2596):
wells under GRUP control receive a share of their group's target,
distributed by guide rates (current phase rates, falling back to equal
shares), re-resolved at every report step. Supported group modes: production
ORAT/WRAT/GRAT/LRAT/RESV, injection RATE/RESV/VREP (voidage replacement) /
REIN (re-injection).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

import torch

from opm_tpu_torch.io.schedule import (BHP, GRAT, GRUP, INJECTOR, LRAT,
                                       ORAT, PRODUCER, RESERVOIR_RATE,
                                       SURFACE_RATE, WRAT, GroupConfig,
                                       WellConfig)
from opm_tpu_torch.wells.wells import _CTRL_CODE, CTRL_SURFACE_RATE

_PHASE_OF = {ORAT: 1, WRAT: 0, GRAT: 2, LRAT: 1}


def _in_group(well: WellConfig, group: str,
              groups: Dict[str, GroupConfig]) -> bool:
    g = well.group
    seen = set()
    while g and g not in seen:
        if g == group:
            return True
        seen.add(g)
        g = groups[g].parent if g in groups else None
    return group == "FIELD"


def resolve_group_controls(step_wells: List[WellConfig],
                           groups: Dict[str, GroupConfig],
                           rates: Dict[str, np.ndarray],
                           voidage_rate: float = 0.0,
                           potentials: Dict[str, np.ndarray] = None,
                           collect: List[dict] = None
                           ) -> List[WellConfig]:
    """Return well configs with GRUP controls replaced by concrete targets.

    rates: current surface rates per well name (production negative), used
    as guide rates; wells with no flow yet fall back to their production
    POTENTIALS (computeWellPotentials guide rates,
    StandardWells_impl.hpp:1005 + WellCollection), then to equal shares.
    voidage_rate: total reservoir voidage of the field's producers (for
    VREP), computed by the caller from the rate converter.
    """
    wells = [w.copy() for w in step_wells]

    # --- production groups: HIERARCHICAL same-mode allocation ----------
    # A parent group's target binds through nested child groups with
    # their own targets (the reference's WellCollection group tree,
    # applyGroupControls): each level distributes its allocation by
    # guide rates among its direct capped children + directly-governed
    # wells; a child whose own target is tighter keeps its target and
    # the excess redistributes to its siblings. Groups whose control
    # mode differs from every ancestor target remain independent roots
    # (cross-mode cascades need the reference's guide-rate phase
    # conversion and are distributed per mode, as before).
    ptargets = {}
    for gname, g in groups.items():
        if g.prod_control and g.prod_control not in ("NONE", "FLD"):
            tgt = g.prod_targets.get(g.prod_control, np.nan)
            if np.isfinite(tgt):
                ptargets[gname] = (g.prod_control, float(tgt))

    def _group_under(child, anc):
        p = child
        seen = set()
        while p and p not in seen:
            seen.add(p)
            p = groups[p].parent if p in groups else None
            if p == anc:
                return True
        return anc == "FIELD" and child != "FIELD"

    def _ancestor_with_target(gname, ctl):
        p = groups[gname].parent if gname in groups else None
        seen = {gname}
        while p and p not in seen:
            if p in ptargets and ptargets[p][0] == ctl:
                return p
            seen.add(p)
            p = groups[p].parent if p in groups else None
        if ("FIELD" in ptargets and gname != "FIELD"
                and "FIELD" not in seen
                and ptargets["FIELD"][0] == ctl):
            return "FIELD"
        return None

    def _members(gname):
        return [w for w in wells
                if w.type == PRODUCER and w.control == GRUP
                and _in_group(w, gname, groups)]

    def _well_guides(members, ph):
        # explicit WGRUPCON guide rates take precedence, then current
        # rates, then potentials (computeWellPotentials guide rates,
        # StandardWells_impl.hpp:1005), then equal shares
        explicit = np.array([getattr(w, "guide_rate", np.nan)
                             for w in members])
        static_guides = bool(np.isfinite(explicit).all()
                             and explicit.sum() > 0)
        if static_guides:
            return explicit, True
        guides = np.array([
            max(-rates.get(w.name, np.zeros(3))[ph], 0.0)
            for w in members])
        if guides.sum() <= 0 and potentials:
            guides = np.array([
                max(potentials.get(w.name, np.zeros(3))[ph], 0.0)
                for w in members])
        if guides.sum() <= 0:
            guides = np.ones(len(members))
        return guides, False

    def _assign_prod(gname, ctl, amount):
        ph = _PHASE_OF.get(ctl, 1)
        members = _members(gname)
        if not members:
            return
        capped = [c for c in ptargets
                  if c != gname and ptargets[c][0] == ctl
                  and _group_under(c, gname)
                  and _ancestor_with_target(c, ctl) == gname]
        capped_members = {c: _members(c) for c in capped}
        capped = [c for c in capped if capped_members[c]]
        in_capped = {w.name for c in capped for w in capped_members[c]}
        free = [w for w in members if w.name not in in_capped]
        guides_free, static = (_well_guides(free, ph) if free
                               else (np.zeros(0), False))
        cap_gsum = [
            float(_well_guides(capped_members[c], ph)[0].sum())
            for c in capped]
        tot = float(guides_free.sum()) + sum(cap_gsum)
        if tot <= 0:
            tot = 1.0
        excess = 0.0
        alloc_c = []
        for c, gsum in zip(capped, cap_gsum):
            want = amount * gsum / tot
            cap = ptargets[c][1]
            alloc_c.append(min(want, cap))
            excess += max(want - cap, 0.0)
        for c, a in zip(capped, alloc_c):
            _assign_prod(c, ctl, a)
        if free:
            free_amount = amount * float(guides_free.sum()) / tot + excess
            shares = guides_free / max(float(guides_free.sum()), 1e-300)
            for w, s in zip(free, shares):
                w.control = ctl
                setattr(w, ctl.lower(), free_amount * s)
            if collect is not None:
                # device-side per-Newton reallocation metadata
                # (updateWellTargets, BlackoilModelBase_impl.hpp:
                # 2548-2596): when a member switches to BHP inside
                # the substep, siblings absorb its share
                collect.append(dict(
                    kind="prod", ctl=ctl, total=float(free_amount),
                    members=[w.name for w in free],
                    guides=list(np.asarray(guides_free, dtype=float)),
                    static=static))

    for gname, (ctl, tgt) in ptargets.items():
        if _ancestor_with_target(gname, ctl) is None:
            _assign_prod(gname, ctl, tgt)

    for gname, g in groups.items():
        # --- injection groups -------------------------------------------
        if g.inj_control and g.inj_control not in ("NONE", "FLD"):
            members = [w for w in wells
                       if w.type == INJECTOR and w.control == GRUP
                       and _in_group(w, gname, groups)
                       and (g.inj_fluid is None
                            or w.injector_fluid == g.inj_fluid)]
            if members:
                if g.inj_control == "RATE" and np.isfinite(g.inj_target):
                    tgt = g.inj_target
                    per = tgt / len(members)
                    for w in members:
                        w.control = SURFACE_RATE
                        w.surf_inj_rate = per
                    if collect is not None:
                        collect.append(dict(
                            kind="inj", ctl="RATE", total=float(tgt),
                            fluid=(g.inj_fluid or "WATER"),
                            members=[w.name for w in members],
                            guides=[1.0] * len(members)))
                elif g.inj_control == "RESV" and np.isfinite(g.inj_target):
                    per = g.inj_target / len(members)
                    for w in members:
                        w.control = RESERVOIR_RATE
                        w.resv_inj_rate = per
                elif g.inj_control == "REIN" and np.isfinite(g.inj_target):
                    # re-inject a fraction of the group's produced volume
                    # of the injection phase (GCONINJE REIN)
                    ph = {"WATER": 0, "OIL": 1,
                          "GAS": 2}.get(g.inj_fluid or "GAS", 2)
                    produced = sum(
                        max(-rates.get(w.name, np.zeros(3))[ph], 0.0)
                        for w in wells if w.type == PRODUCER
                        and _in_group(w, gname, groups))
                    per = g.inj_target * produced / len(members)
                    for w in members:
                        w.control = SURFACE_RATE
                        w.surf_inj_rate = per
                elif g.inj_control == "VREP":
                    # replace the group's production voidage
                    per = g.voidage_frac * voidage_rate / len(members)
                    for w in members:
                        w.control = RESERVOIR_RATE
                        w.resv_inj_rate = per
    # any remaining GRUP wells: fall back to BHP limits
    for w in wells:
        if w.control == GRUP:
            w.control = BHP
    return wells


def make_group_device_arrays(collected: List[dict], name_order: List[str],
                             device):
    """Collected group distributions -> tuple of per-group specs consumed
    by wells.standard.update_controls every Newton iteration:
    (ctl_code, phase_vec (3,), total, member_mask (nw,), guides (nw,),
    sign, guide_phase_vec-or-None), the tensors float64 on ``device``.
    guide_phase_vec None marks explicit/static (WGRUPCON) guides. The group
    structure is fixed for the report step; only the masks and targets are
    tensors."""
    idx = {n: i for i, n in enumerate(name_order)}
    nw = len(name_order)
    out = []
    phase_vec = {ORAT: (0.0, 1.0, 0.0), WRAT: (1.0, 0.0, 0.0),
                 GRAT: (0.0, 0.0, 1.0), LRAT: (1.0, 1.0, 0.0)}
    # guide rates use the SINGLE phase of _PHASE_OF (LRAT guides on oil)
    guide_vec = {ORAT: (0.0, 1.0, 0.0), WRAT: (1.0, 0.0, 0.0),
                 GRAT: (0.0, 0.0, 1.0), LRAT: (0.0, 1.0, 0.0)}

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=device)

    for g in collected:
        mask = np.zeros(nw)
        guides = np.zeros(nw)
        for n, gd in zip(g["members"], g["guides"]):
            if n in idx:
                mask[idx[n]] = 1.0
                guides[idx[n]] = max(gd, 0.0)
        if mask.sum() == 0:
            continue
        if guides[mask > 0].sum() <= 0:
            guides = mask.copy()
        if g["kind"] == "prod":
            code = _CTRL_CODE[g["ctl"]]
            pv = phase_vec.get(g["ctl"], (0.0, 1.0, 0.0))
            gpv = guide_vec.get(g["ctl"], (0.0, 1.0, 0.0))
            sign = -1.0       # production rates are negative in qs
        else:
            code = CTRL_SURFACE_RATE
            pv = {"WATER": (1.0, 0.0, 0.0), "WAT": (1.0, 0.0, 0.0),
                  "OIL": (0.0, 1.0, 0.0),
                  "GAS": (0.0, 0.0, 1.0)}.get(g.get("fluid", "WATER"),
                                              (1.0, 0.0, 0.0))
            gpv = pv
            sign = 1.0
        static = bool(g.get("static", False)) or g["kind"] != "prod"
        out.append((int(code), t(pv), t(g["total"]), t(mask), t(guides),
                    float(sign), None if static else t(gpv)))
    return tuple(out)
