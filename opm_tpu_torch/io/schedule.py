"""Schedule: report steps and per-step well configuration snapshots.

Re-implements the role of opm-common's Schedule + the per-report-step
WellsManager rebuild in the reference driver
(opm/autodiff/SimulatorBase_impl.hpp:161). The SCHEDULE
section is processed sequentially; every TSTEP/DATES boundary emits a report
step, and each report step carries a full snapshot of the well set
(completions + active controls) valid over that step.
"""

from __future__ import annotations

import datetime
import fnmatch
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

import numpy as np

from opm_tpu_torch.io.eclstate import EclipseCase, _parse_date, _val

# control modes (match reference semantics of WellControls,
# opm/autodiff/StandardWells_impl.hpp:838 addWellControlEq)
BHP, THP, ORAT, WRAT, GRAT, LRAT, RESV, SURFACE_RATE, RESERVOIR_RATE, GRUP = (
    "BHP", "THP", "ORAT", "WRAT", "GRAT", "LRAT", "RESV", "RATE", "RESV_INJ",
    "GRUP")

PRODUCER, INJECTOR = "PRODUCER", "INJECTOR"


@dataclass
class Completion:
    i: int  # 0-based
    j: int
    k: int
    cf: Optional[float]  # connection transmissibility factor (SI); None = compute
    diameter: float = 0.3048 * 0.5  # well bore diameter (default 1 ft? ECL: 1 ft)
    kh: Optional[float] = None
    skin: float = 0.0
    direction: str = "Z"
    sat_table: int = 0
    status: str = "OPEN"
    wi_mult: float = 1.0      # WPIMULT productivity-index multiplier


@dataclass
class WellConfig:
    name: str
    group: str = "FIELD"
    i: int = 0   # heel, 0-based
    j: int = 0
    ref_depth: Optional[float] = None
    preferred_phase: str = "OIL"
    type: str = PRODUCER
    injector_fluid: str = "WATER"
    status: str = "OPEN"
    control: str = BHP
    # targets/limits (SI); NaN = unset
    orat: float = np.nan
    wrat: float = np.nan
    grat: float = np.nan
    lrat: float = np.nan
    resv: float = np.nan
    bhp_limit: float = np.nan
    thp_limit: float = np.nan
    vfp_table: int = 0
    alq: float = 0.0
    surf_inj_rate: float = np.nan
    resv_inj_rate: float = np.nan
    polymer_conc: float = 0.0
    # WGRUPCON guide rate (NaN = derive from rates/potentials)
    guide_rate: float = np.nan
    guide_phase: str = "OIL"
    avail_group_control: bool = True
    # WECON economic limits (NaN = unset)
    econ_min_orat: float = np.nan
    econ_min_grat: float = np.nan
    econ_max_wct: float = np.nan
    econ_max_gor: float = np.nan
    econ_workover: str = "NONE"       # item 7: NONE | CON | +CON | WELL
    # history mode (WCONHIST/WCONINJH): producer rates in orat/wrat/grat are
    # OBSERVED surface rates -> RESV target computed per report step from
    # voidage coefficients (SimulatorBase_impl.hpp:557-605)
    history: bool = False
    completions: List[Completion] = field(default_factory=list)

    def copy(self):
        w = replace(self)
        w.completions = [replace(c) for c in self.completions]
        return w


@dataclass
class GroupConfig:
    """Group target snapshot (GCONPROD/GCONINJE; the reference reaches these
    through the external WellCollection — BlackoilModelBase_impl.hpp:779-792
    setupGroupControl)."""
    name: str
    parent: str = "FIELD"
    prod_control: Optional[str] = None       # ORAT/WRAT/GRAT/LRAT/RESV
    prod_targets: dict = field(default_factory=dict)
    inj_fluid: Optional[str] = None
    inj_control: Optional[str] = None        # RATE/RESV/REIN/VREP
    inj_target: float = np.nan
    voidage_frac: float = 1.0


@dataclass
class ReportStep:
    index: int
    start_time: float  # seconds since simulation start
    end_time: float
    wells: List[WellConfig] = field(default_factory=list)
    groups: Dict[str, "GroupConfig"] = field(default_factory=dict)
    events: List[str] = field(default_factory=list)  # e.g. WELL_CHANGE
    # schedule-time geology modifiers applied at the start of this step
    # (GEO_MODIFIER events, SimulatorBase_impl.hpp:258-268):
    # ("MULTFLT", [(fault, mult)...]) | ("ARRAY", name, values)
    # | ("EQUALS"/"MULTIPLY", name, value, box6-or-None)
    geo_mods: List[tuple] = field(default_factory=list)


@dataclass
class Schedule:
    start_date: datetime.datetime
    report_steps: List[ReportStep] = field(default_factory=list)
    tuning: Optional[dict] = None

    @property
    def total_time(self):
        return self.report_steps[-1].end_time if self.report_steps else 0.0


def build_schedule(case: EclipseCase) -> Schedule:
    deck = case.deck
    u = case.units
    sched = Schedule(start_date=case.runspec.start_date)
    wells: Dict[str, WellConfig] = {}
    groups: Dict[str, GroupConfig] = {}
    wlists: Dict[str, list] = {}       # WLIST named well lists
    t = 0.0
    cur_date = case.runspec.start_date
    step_idx = 0
    pending_events: List[str] = []

    p_f = u.factor("Pressure")
    liq_f = u.factor("LiquidSurfaceVolume/Time")
    gas_f = u.factor("GasSurfaceVolume/Time")
    res_f = u.factor("ReservoirVolume/Time")
    len_f = u.factor("Length")
    trans_f = u.factor("Transmissibility")
    kh_f = u.factor("Permeability*Length")
    day = u.factor("Time")

    in_schedule = False
    pending_geo: List[tuple] = []
    GEO_ARRAYS = {"MULTX", "MULTY", "MULTZ", "MULTX-", "MULTY-", "MULTZ-",
                  "MULTPV"}
    for kw in deck:
        name = kw.name
        if name == "SCHEDULE":
            in_schedule = True
            continue
        if not in_schedule:
            continue
        # schedule-time geology modifiers -> GEO_MODIFIER events
        # (SimulatorBase_impl.hpp:258-268 rebuilds DerivedGeology)
        if name == "MULTFLT":
            pending_geo.append(("MULTFLT", [
                (str(r[0]).upper(), float(r[1])) for r in kw.records]))
            pending_events.append("GEO_MODIFIER")
            continue
        if name in GEO_ARRAYS and kw.array is not None:
            pending_geo.append(
                ("ARRAY", name, np.asarray(kw.array, dtype=np.float64)))
            pending_events.append("GEO_MODIFIER")
            continue
        if name in ("EQUALS", "MULTIPLY"):
            for r in kw.records:
                tgt = str(r[0]).upper()
                if tgt in GEO_ARRAYS:
                    box = None
                    if len(r) > 2 and r[2] is not None:
                        try:
                            box = [int(r[i]) - 1 for i in range(2, 8)]
                        except (TypeError, ValueError, IndexError):
                            box = None
                    pending_geo.append((name, tgt, float(r[1]), box))
                    pending_events.append("GEO_MODIFIER")
            continue
        if name == "WELSPECS":
            for r in kw.records:
                wname = str(r[0])
                w = wells.get(wname) or WellConfig(name=wname)
                w.group = str(_val(r, 1, "FIELD"))
                w.i = int(_val(r, 2, 1)) - 1
                w.j = int(_val(r, 3, 1)) - 1
                rd = _val(r, 4, None)
                w.ref_depth = rd * len_f if rd is not None else None
                w.preferred_phase = str(_val(r, 5, "OIL"))
                wells[wname] = w
                pending_events.append("WELL_CHANGE")
        elif name == "COMPDAT":
            for r in kw.records:
                pat = str(r[0])
                for w in _match_wells(wells, wlists, pat):
                    i = int(_val(r, 1, w.i + 1)) - 1
                    j = int(_val(r, 2, w.j + 1)) - 1
                    k1 = int(_val(r, 3, 1)) - 1
                    k2 = int(_val(r, 4, k1 + 1)) - 1
                    status = str(_val(r, 5, "OPEN"))
                    sat_tab = int(_val(r, 6, 0))
                    cf = _val(r, 7, None)
                    diam = _val(r, 8, None)
                    kh = _val(r, 9, None)
                    skin = float(_val(r, 10, 0.0))
                    direction = str(_val(r, 12, "Z"))
                    for k in range(k1, k2 + 1):
                        comp = Completion(
                            i=i, j=j, k=k,
                            cf=cf * trans_f if cf is not None else None,
                            diameter=(diam * len_f) if diam is not None
                            else 0.3048,
                            kh=kh * kh_f if kh is not None else None,
                            skin=skin, direction=direction,
                            sat_table=sat_tab, status=status)
                        _upsert_completion(w, comp)
                    pending_events.append("WELL_CHANGE")
        elif name == "WCONPROD":
            for r in kw.records:
                for w in _match_wells(wells, wlists, str(r[0])):
                    w.type = PRODUCER
                    w.status = str(_val(r, 1, "OPEN"))
                    w.history = False
                    w.control = str(_val(r, 2, "ORAT")).upper()
                    w.orat = _sival(r, 3, liq_f)
                    w.wrat = _sival(r, 4, liq_f)
                    w.grat = _sival(r, 5, gas_f)
                    w.lrat = _sival(r, 6, liq_f)
                    w.resv = _sival(r, 7, res_f)
                    w.bhp_limit = _sival(r, 8, p_f, default=101325.0)
                    w.thp_limit = _sival(r, 9, p_f)
                    w.vfp_table = int(_val(r, 10, 0))
                    w.alq = float(_val(r, 11, 0.0))
                    pending_events.append("WELL_CHANGE")
        elif name == "WCONHIST":
            # history-matching producer: observed surface rates; the
            # reference converts them to a RESERVOIR_RATE (RESV) target
            # via voidage coefficients each report step, BHP limit 1 atm
            # unless WELTARG overrides (SimulatorBase_impl.hpp:557-605)
            for r in kw.records:
                for w in _match_wells(wells, wlists, str(r[0])):
                    w.type = PRODUCER
                    w.status = str(_val(r, 1, "OPEN"))
                    w.history = True
                    w.control = RESV
                    w.orat = _sival(r, 3, liq_f, default=0.0)
                    w.wrat = _sival(r, 4, liq_f, default=0.0)
                    w.grat = _sival(r, 5, gas_f, default=0.0)
                    w.lrat = np.nan
                    w.resv = np.nan     # target computed at runtime
                    w.vfp_table = int(_val(r, 6, 0))
                    w.alq = float(_val(r, 7, 0.0))
                    w.bhp_limit = 101325.0
                    pending_events.append("WELL_CHANGE")
        elif name == "WCONINJH":
            # history-matching injector: observed rate becomes a plain
            # surface RATE control with an effectively-unbounded BHP limit
            for r in kw.records:
                for w in _match_wells(wells, wlists, str(r[0])):
                    w.type = INJECTOR
                    w.injector_fluid = str(_val(r, 1, "WATER")).upper()
                    w.status = str(_val(r, 2, "OPEN"))
                    w.history = True
                    w.control = SURFACE_RATE
                    rate_f = gas_f if w.injector_fluid == "GAS" else liq_f
                    w.surf_inj_rate = _sival(r, 3, rate_f, default=0.0)
                    w.bhp_limit = 6.895e8
                    pending_events.append("WELL_CHANGE")
        elif name in ("WCONINJE", "WCONINJ"):
            for r in kw.records:
                for w in _match_wells(wells, wlists, str(r[0])):
                    w.type = INJECTOR
                    w.injector_fluid = str(_val(r, 1, "WATER")).upper()
                    w.status = str(_val(r, 2, "OPEN"))
                    w.history = False
                    w.control = {"RATE": SURFACE_RATE, "RESV": RESERVOIR_RATE,
                                 "BHP": BHP, "THP": THP, "GRUP": GRUP}.get(
                                     str(_val(r, 3, "RATE")).upper(), SURFACE_RATE)
                    rate_f = gas_f if w.injector_fluid == "GAS" else liq_f
                    w.surf_inj_rate = _sival(r, 4, rate_f)
                    w.resv_inj_rate = _sival(r, 5, res_f)
                    w.bhp_limit = _sival(r, 6, p_f, default=6.895e8)
                    w.thp_limit = _sival(r, 7, p_f)
                    w.vfp_table = int(_val(r, 8, 0))
                    pending_events.append("WELL_CHANGE")
        elif name == "WELTARG":
            for r in kw.records:
                for w in _match_wells(wells, wlists, str(r[0])):
                    ctl = str(_val(r, 1, "ORAT")).upper()
                    v = float(_val(r, 2, 0.0))
                    if ctl == "ORAT":
                        w.orat = v * liq_f
                    elif ctl == "WRAT":
                        w.wrat = v * liq_f
                    elif ctl == "GRAT":
                        w.grat = v * gas_f
                    elif ctl == "LRAT":
                        w.lrat = v * liq_f
                    elif ctl == "RESV":
                        w.resv = v * res_f
                    elif ctl == "BHP":
                        w.bhp_limit = v * p_f
                    elif ctl == "THP":
                        w.thp_limit = v * p_f
                    pending_events.append("WELL_CHANGE")
        elif name == "WECON":
            for r in kw.records:
                for w in _match_wells(wells, wlists, str(r[0])):
                    w.econ_min_orat = _sival(r, 1, liq_f)
                    w.econ_min_grat = _sival(r, 2, gas_f)
                    w.econ_max_wct = float(_val(r, 3, np.nan)) \
                        if _val(r, 3, None) is not None else np.nan
                    w.econ_max_gor = _sival(r, 4, gas_f / liq_f)
                    wo = _val(r, 6, None)
                    if wo is not None:
                        w.econ_workover = str(wo).upper()
        elif name == "WGRUPCON":
            for r in kw.records:
                for w in _match_wells(wells, wlists, str(r[0])):
                    w.avail_group_control = str(_val(r, 1, "YES")).upper() \
                        in ("YES", "Y", "1", "TRUE")
                    gr = _val(r, 2, None)
                    w.guide_rate = float(gr) if gr is not None else np.nan
                    w.guide_phase = str(_val(r, 3, "OIL")).upper()
        elif name == "WPIMULT":
            for r in kw.records:
                f = float(_val(r, 1, 1.0))
                for w in _match_wells(wells, wlists, str(r[0])):
                    # multiply connection factors (all connections; the
                    # optional I/J/K filters restrict when present)
                    ci = _val(r, 2, None)
                    cj = _val(r, 3, None)
                    ck = _val(r, 4, None)
                    for c in w.completions:
                        if ci is not None and c.i != int(ci) - 1:
                            continue
                        if cj is not None and c.j != int(cj) - 1:
                            continue
                        if ck is not None and c.k != int(ck) - 1:
                            continue
                        c.wi_mult *= f
                    pending_events.append("WELL_CHANGE")
        elif name == "WLIST":
            # named well lists: '*NAME' NEW|ADD|DEL W1 W2 ...
            for r in kw.records:
                lname = str(_val(r, 0, "")).strip()
                action = str(_val(r, 1, "NEW")).upper()
                members = [str(x) for x in list(r)[2:]
                           if x is not None and str(x).strip()]
                cur = wlists.setdefault(lname, [])
                if action == "NEW":
                    cur.clear()
                if action == "DEL":
                    for m in members:
                        if m in cur:
                            cur.remove(m)
                else:
                    for m in members:
                        if m not in cur:
                            cur.append(m)
        elif name == "WELOPEN":
            for r in kw.records:
                for w in _match_wells(wells, wlists, str(r[0])):
                    w.status = str(_val(r, 1, "OPEN"))
                    pending_events.append("WELL_CHANGE")
        elif name == "WPOLYMER":
            for r in kw.records:
                for w in _match_wells(wells, wlists, str(r[0])):
                    w.polymer_conc = float(_val(r, 1, 0.0)) * u.factor(
                        "PolymerDensity")
                    pending_events.append("WELL_CHANGE")
        elif name == "GRUPTREE":
            for r in kw.records:
                g = str(_val(r, 0, "FIELD"))
                groups.setdefault(g, GroupConfig(name=g)).parent = \
                    str(_val(r, 1, "FIELD"))
        elif name == "GCONPROD":
            for r in kw.records:
                g = groups.setdefault(str(r[0]),
                                      GroupConfig(name=str(r[0])))
                g.prod_control = str(_val(r, 1, "NONE")).upper()
                g.prod_targets = dict(
                    ORAT=_sival(r, 2, liq_f), WRAT=_sival(r, 3, liq_f),
                    GRAT=_sival(r, 4, gas_f), LRAT=_sival(r, 5, liq_f),
                    RESV=_sival(r, 6, res_f))
                pending_events.append("WELL_CHANGE")
        elif name == "GCONINJE":
            for r in kw.records:
                g = groups.setdefault(str(r[0]),
                                      GroupConfig(name=str(r[0])))
                g.inj_fluid = str(_val(r, 1, "WATER")).upper()
                g.inj_control = str(_val(r, 2, "RATE")).upper()
                fl_f = gas_f if g.inj_fluid == "GAS" else liq_f
                if g.inj_control == "RATE":
                    g.inj_target = _sival(r, 3, fl_f)
                elif g.inj_control == "RESV":
                    g.inj_target = _sival(r, 4, res_f)
                elif g.inj_control == "REIN":
                    g.inj_target = float(_val(r, 5, 1.0))
                elif g.inj_control == "VREP":
                    g.voidage_frac = float(_val(r, 6, 1.0))
                pending_events.append("WELL_CHANGE")
        elif name == "TUNING":
            r0 = kw.records[0] if kw.records else []
            # record 1: TSINIT TSMAXZ TSMINZ TSMCHP TSFMAX ... (Eclipse
            # TUNING layout); TSFMAX = max dt increase factor, consumed by
            # AdaptiveTimeStepping as growth/max-growth (the reference's
            # TUNING mapping, AdaptiveTimeStepping_impl.hpp:82-84)
            r2 = kw.records[2] if len(kw.records) > 2 else []
            sched.tuning = dict(
                tsinit=_val(r0, 0, 1.0) * day,
                tsmaxz=_val(r0, 1, 365.0) * day,
                tsminz=_val(r0, 2, 0.1) * day,
                tsfmax=_val(r0, 4, 3.0),
                # record 3 item 1: NEWTMX, max Newton iterations per
                # substep (the reference consumes it via the TUNING ->
                # solver-parameter mapping; flow's newton-max-iterations)
                newtmx=int(_val(r2, 0, 0) or 0),
                # TFDIFF (item 8, default 1.25): the reference maps it to
                # growthFactor_ — the dt growth cap right after a chopped
                # restart (AdaptiveTimeStepping_impl.hpp:83-84); TSFMAX
                # maps only to maxGrowth_ (the general cap)
                tfdiff=_val(r0, 7, 1.25),
            )
        elif name == "TSTEP":
            for dt in kw.array:
                dt_si = float(dt) * day
                sched.report_steps.append(ReportStep(
                    index=step_idx, start_time=t, end_time=t + dt_si,
                    wells=[w.copy() for w in wells.values()],
                    groups={k: replace(v) for k, v in groups.items()},
                    events=pending_events, geo_mods=pending_geo))
                pending_events = []
                pending_geo = []
                t += dt_si
                step_idx += 1
            cur_date = case.runspec.start_date + datetime.timedelta(
                seconds=t)
        elif name == "DATES":
            for r in kw.records:
                date = _parse_date(r)
                dt_si = (date - cur_date).total_seconds()
                if dt_si <= 0:
                    continue
                sched.report_steps.append(ReportStep(
                    index=step_idx, start_time=t, end_time=t + dt_si,
                    wells=[w.copy() for w in wells.values()],
                    groups={k: replace(v) for k, v in groups.items()},
                    events=pending_events, geo_mods=pending_geo))
                pending_events = []
                pending_geo = []
                t += dt_si
                cur_date = date
                step_idx += 1
    return sched


def _match_wells(wells: Dict[str, WellConfig], wlists, pattern: str):
    pattern = pattern.strip()
    # WLIST names ('*NAME') take precedence over glob patterns
    if wlists and pattern in wlists:
        return [wells[n] for n in wlists[pattern] if n in wells]
    if any(ch in pattern for ch in "*?["):
        return [w for n, w in wells.items() if fnmatch.fnmatch(n, pattern)]
    if pattern not in wells:
        wells[pattern] = WellConfig(name=pattern)
    return [wells[pattern]]


def _upsert_completion(w: WellConfig, comp: Completion):
    for idx, c in enumerate(w.completions):
        if (c.i, c.j, c.k) == (comp.i, comp.j, comp.k):
            w.completions[idx] = comp
            return
    w.completions.append(comp)


def _sival(rec, i, factor, default=np.nan):
    v = _val(rec, i, None)
    return float(v) * factor if v is not None else default
