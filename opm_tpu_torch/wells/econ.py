"""Economic limits for producers (WECON); a copy of the JAX package's
wells/econ.py (numpy only).

The reference's StandardWells econ checks (opm/autodiff/
StandardWells_impl.hpp:1209-1380):
  * checkRateEconLimits — minimum oil / gas / liquid surface rates; any
    violation shuts the well (:1217-1245).
  * checkRatioEconLimits / checkMaxWaterCutLimit — well-level max
    water-cut violation locates the WORST-OFFENDING CONNECTION (largest
    violation extent wct/limit); the workover procedure (WECON item 7)
    then closes that connection ('CON'), that connection plus all below
    ('+CON'), or the well (:1261-1380).

Pure host-side functions over reported rates; the simulator applies the
outcome by shutting wells / completions at the next report-step rebuild
(padded well arrays — no retrace)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class EconResult:
    shut_well: bool = False
    closed_connections: Tuple[int, ...] = ()   # perf indices to close
    reason: str = ""


def check_rate_limits(qo, qw, qg, *, min_orat=np.nan, min_grat=np.nan,
                      min_lrat=np.nan) -> Optional[str]:
    """checkRateEconLimits: returns the violated limit name or None.
    Rates are positive production surface rates."""
    if np.isfinite(min_orat) and abs(qo) < min_orat:
        return "MIN_OIL_RATE"
    if np.isfinite(min_grat) and abs(qg) < min_grat:
        return "MIN_GAS_RATE"
    if np.isfinite(min_lrat) and abs(qo + qw) < min_lrat:
        return "MIN_LIQUID_RATE"
    return None


def worst_water_cut_connection(perf_qw, perf_qo, open_mask, max_wct):
    """checkMaxWaterCutLimit (:1320-1380): well-level water cut above the
    limit locates the worst-offending open connection by violation extent
    wct_conn / limit. Returns (violated, worst_idx, last_connection)."""
    perf_qw = np.asarray(perf_qw, dtype=float)
    perf_qo = np.asarray(perf_qo, dtype=float)
    open_mask = np.asarray(open_mask, dtype=bool)
    qw = perf_qw[open_mask].sum()
    qo = perf_qo[open_mask].sum()
    liquid = qw + qo
    if liquid <= 1e-30 or (qw / liquid) <= max_wct:
        return False, -1, False
    liq_c = perf_qw + perf_qo
    with np.errstate(divide="ignore", invalid="ignore"):
        wct_c = np.where(liq_c > 1e-30, perf_qw / liq_c, 0.0)
    extent = np.where(open_mask, wct_c / max(max_wct, 1e-30), -1.0)
    worst = int(np.argmax(extent))
    last = int(open_mask.sum()) <= 1
    return True, worst, last


def check_econ_limits(qo, qw, qg, perf_qw, perf_qo, open_mask, *,
                      min_orat=np.nan, min_grat=np.nan, min_lrat=np.nan,
                      max_wct=np.nan, max_gor=np.nan,
                      workover="NONE") -> EconResult:
    """Full producer check. Rate violations shut the well; ratio
    violations follow the workover procedure."""
    reason = check_rate_limits(qo, qw, qg, min_orat=min_orat,
                               min_grat=min_grat, min_lrat=min_lrat)
    if reason is not None:
        return EconResult(shut_well=True, reason=reason)
    workover = (workover or "NONE").upper()
    if np.isfinite(max_wct):
        violated, worst, last = worst_water_cut_connection(
            perf_qw, perf_qo, open_mask, max_wct)
        if violated:
            if workover in ("CON", "+CON") and not last:
                if workover == "+CON":
                    conns = tuple(k for k in range(len(open_mask))
                                  if k >= worst and open_mask[k])
                else:
                    conns = (worst,)
                return EconResult(closed_connections=conns,
                                  reason="MAX_WATER_CUT")
            return EconResult(shut_well=True, reason="MAX_WATER_CUT")
    if np.isfinite(max_gor) and abs(qo) > 1e-12 and qg / qo > max_gor:
        # the reference logs max-GOR as not-supported for per-connection
        # workover (:1294) — well shut
        return EconResult(shut_well=True, reason="MAX_GOR")
    return EconResult()
