"""Device-friendly well structure: padded [well, perf] arrays.

Replaces the reference's C `struct Wells` perforation-CSR layout
(external opm/core/wells.h, built per report step by WellsManager at
opm/autodiff/SimulatorBase_impl.hpp:161) with fixed-shape
padded arrays so the whole well model vmaps/jits without retraces when the
active well set changes. Defaulted connection factors are computed with the
Peaceman formula (as WellsManager does in opm-core).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from opm_tpu_torch.io.schedule import (BHP, GRAT, GRUP, INJECTOR, LRAT,
                                       ORAT, RESERVOIR_RATE, RESV,
                                       SURFACE_RATE, THP, WRAT, WellConfig)

# integer control codes used on device
CTRL_BHP = 0
CTRL_THP = 1
CTRL_ORAT = 2
CTRL_WRAT = 3
CTRL_GRAT = 4
CTRL_LRAT = 5
CTRL_RESV = 6
CTRL_SURFACE_RATE = 7   # injector total surface rate
CTRL_RESERVOIR_RATE = 8
CTRL_GRUP = 9

_CTRL_CODE = {BHP: CTRL_BHP, THP: CTRL_THP, ORAT: CTRL_ORAT, WRAT: CTRL_WRAT,
              GRAT: CTRL_GRAT, LRAT: CTRL_LRAT, RESV: CTRL_RESV,
              SURFACE_RATE: CTRL_SURFACE_RATE,
              RESERVOIR_RATE: CTRL_RESERVOIR_RATE, GRUP: CTRL_GRUP}

# phase indices (canonical ordering water, oil, gas — matches the reference's
# Aqua/Liquid/Vapour in BlackoilPhases)
WATER, OIL, GAS = 0, 1, 2


def peaceman_wi(kx, ky, kz, dx, dy, dz, ntg, rw, skin, direction="Z",
                kh=None):
    """Peaceman well index for one completion (WellsManager semantics)."""
    if direction == "Z":
        k1, k2, d1, d2, h = kx, ky, dx, dy, dz * ntg
    elif direction == "X":
        k1, k2, d1, d2, h = ky, kz, dy, dz, dx
    else:
        k1, k2, d1, d2, h = kx, kz, dx, dz, dy
    k = np.sqrt(k1 * k2)
    r0 = 0.28 * np.sqrt(np.sqrt(k2 / k1) * d1**2 + np.sqrt(k1 / k2) * d2**2) \
        / (np.power(k2 / k1, 0.25) + np.power(k1 / k2, 0.25))
    if kh is None:
        kh = k * h
    return 2 * np.pi * kh / (np.log(r0 / rw) + skin)


@dataclass
class WellSet:
    """Padded arrays describing all wells active in one report step."""

    names: List[str]
    nw: int
    max_perf: int
    # (nw, max_perf)
    perf_cell: np.ndarray     # active-cell index, 0 for padding
    perf_mask: np.ndarray     # bool
    perf_wi: np.ndarray       # connection trans factor (SI)
    perf_depth: np.ndarray
    # (nw,)
    is_injector: np.ndarray   # bool
    comp_frac: np.ndarray     # (nw, 3) injection composition (w,o,g)
    control: np.ndarray       # int codes
    target: np.ndarray        # target value for 'control'
    bhp_limit: np.ndarray     # min (producer) / max (injector)
    thp_limit: np.ndarray
    ref_depth: np.ndarray
    open_mask: np.ndarray     # well OPEN (SHUT wells kept for shape stability)
    # all rate targets for control switching (nw, 3): orat, wrat, grat + lrat
    rate_targets: np.ndarray  # (nw, 5): orat wrat grat lrat resv
    inj_rate_target: np.ndarray  # (nw,) surface; reservoir in col
    inj_resv_target: np.ndarray
    polymer_conc: np.ndarray
    # WCONHIST/WCONINJH: producer rate_targets[:, :3] are OBSERVED rates;
    # the driver recomputes the RESV target from voidage coefficients
    is_history: np.ndarray = None  # (nw,) bool

    @property
    def empty(self):
        return self.nw == 0


def build_well_set(wells: List[WellConfig], grid, *, max_perf=None,
                   name_order=None) -> WellSet:
    """Build padded arrays from schedule WellConfigs on a given grid."""
    wells = [w for w in wells]
    if name_order is not None:
        order = {n: i for i, n in enumerate(name_order)}
        wells.sort(key=lambda w: order.get(w.name, 1 << 30))
    names = [w.name for w in wells]
    nw = len(wells)
    mp = max_perf or max((len(w.completions) for w in wells), default=1)
    mp = max(mp, 1)

    perf_cell = np.zeros((nw, mp), dtype=np.int32)
    perf_mask = np.zeros((nw, mp), dtype=bool)
    perf_wi = np.zeros((nw, mp))
    perf_depth = np.zeros((nw, mp))
    is_inj = np.zeros(nw, dtype=bool)
    comp_frac = np.zeros((nw, 3))
    control = np.zeros(nw, dtype=np.int32)
    target = np.zeros(nw)
    bhp_limit = np.zeros(nw)
    thp_limit = np.full(nw, np.nan)
    ref_depth = np.zeros(nw)
    open_mask = np.zeros(nw, dtype=bool)
    rate_targets = np.full((nw, 5), np.nan)
    inj_rate = np.full(nw, np.nan)
    inj_resv = np.full(nw, np.nan)
    poly = np.zeros(nw)
    is_hist = np.zeros(nw, dtype=bool)

    for iw, w in enumerate(wells):
        comps = [c for c in w.completions if c.status.upper() == "OPEN"]
        # sort perforations by depth (wellbore pressure integration order,
        # WellDensitySegmented.cpp semantics)
        def cdepth(c):
            a = grid.active_index(c.i, c.j, c.k)
            return grid.depth[a] if a >= 0 else 1e30
        comps.sort(key=cdepth)
        for ip, c in enumerate(comps[:mp]):
            a = grid.active_index(c.i, c.j, c.k)
            if a < 0:
                continue
            perf_cell[iw, ip] = a
            perf_mask[iw, ip] = True
            perf_depth[iw, ip] = grid.depth[a]
            wi = c.cf if c.cf is not None else peaceman_wi(
                grid.permx[a], grid.permy[a], grid.permz[a],
                grid.dx[a], grid.dy[a], grid.dz[a], grid.ntg[a],
                rw=0.5 * c.diameter, skin=c.skin, direction=c.direction,
                kh=c.kh)
            perf_wi[iw, ip] = wi * c.wi_mult   # WPIMULT
        is_inj[iw] = w.type == INJECTOR
        if is_inj[iw]:
            fl = w.injector_fluid.upper()
            comp_frac[iw, {"WATER": WATER, "WAT": WATER, "OIL": OIL,
                           "GAS": GAS}.get(fl, WATER)] = 1.0
        else:
            # producers: preferred phase as the zero-rate mixture fallback
            ph = {"WATER": WATER, "WAT": WATER, "OIL": OIL, "GAS": GAS,
                  "LIQ": OIL}.get(w.preferred_phase.upper(), OIL)
            comp_frac[iw, ph] = 1.0
        control[iw] = _CTRL_CODE.get(w.control, CTRL_BHP)
        bhp_limit[iw] = w.bhp_limit if np.isfinite(w.bhp_limit) else (
            1.0e5 if not is_inj[iw] else 1.0e9)
        thp_limit[iw] = w.thp_limit
        rate_targets[iw] = [w.orat, w.wrat, w.grat, w.lrat, w.resv]
        inj_rate[iw] = w.surf_inj_rate
        inj_resv[iw] = w.resv_inj_rate
        target[iw] = _target_value(w)
        if w.ref_depth is not None:
            ref_depth[iw] = w.ref_depth
        elif perf_mask[iw].any():
            ref_depth[iw] = perf_depth[iw][perf_mask[iw]].min()
        open_mask[iw] = (w.status.upper() in ("OPEN", "AUTO")
                         and perf_mask[iw].any())
        poly[iw] = w.polymer_conc
        is_hist[iw] = getattr(w, "history", False)

    return WellSet(
        names=names, nw=nw, max_perf=mp, perf_cell=perf_cell,
        perf_mask=perf_mask, perf_wi=perf_wi, perf_depth=perf_depth,
        is_injector=is_inj, comp_frac=comp_frac, control=control,
        target=target, bhp_limit=bhp_limit, thp_limit=thp_limit,
        ref_depth=ref_depth, open_mask=open_mask, rate_targets=rate_targets,
        inj_rate_target=inj_rate, inj_resv_target=inj_resv,
        polymer_conc=poly, is_history=is_hist)


def _target_value(w: WellConfig) -> float:
    m = {BHP: w.bhp_limit, THP: w.thp_limit, ORAT: w.orat, WRAT: w.wrat,
         GRAT: w.grat, LRAT: w.lrat, RESV: w.resv,
         SURFACE_RATE: w.surf_inj_rate, RESERVOIR_RATE: w.resv_inj_rate}
    v = m.get(w.control, np.nan)
    return v if np.isfinite(v) else 0.0
