"""SimulatorFullyImplicitBlackoil: the report-step driver on tensors.

Port of the per-step path of the JAX package's sim/blackoil.py (the branch
the reference takes on CPU, where ``fused`` is off): report-step loop,
per-step well rebuild, adaptive sub-stepping, summary collection and the
iteration totals. Not ported yet, and raising where a deck reaches them:
report-step spans and the fused substep (ROADMAP Queue 1 item 7); THPRES,
geology modifiers, group control, economic limits, RESV controls and
restart (item 8); the output writers (item 5).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from opm_tpu_torch.grid.grid import build_grid
from opm_tpu_torch.io.eclstate import EclipseCase, load_case
from opm_tpu_torch.io.schedule import build_schedule
from opm_tpu_torch.models.blackoil import (BlackoilModel, ModelParams,
                                           make_well_device_arrays)
from opm_tpu_torch.models.state import GAS, OIL, WATER, BlackoilState
from opm_tpu_torch.props.blackoil import BlackoilProps
from opm_tpu_torch.sim.init import initial_state
from opm_tpu_torch.solver.newton import NonlinearSolver, SolverReport
from opm_tpu_torch.solver.timestepping import (AdaptiveTimeStepping,
                                               TimeStepControlParams)
from opm_tpu_torch.utils.events import EventSource
from opm_tpu_torch.wells.wells import (CTRL_BHP, CTRL_GRAT, CTRL_LRAT,
                                       CTRL_ORAT, CTRL_RESERVOIR_RATE,
                                       CTRL_RESV, CTRL_SURFACE_RATE,
                                       CTRL_WRAT, WellSet, build_well_set)

DAY = 86400.0


@dataclass
class SimulatorReportTotals:
    """Aggregated timing/iteration report (SimulatorReport analogue)."""
    total_time: float = 0.0
    assemble_time: float = 0.0
    linear_solve_time: float = 0.0
    substeps: int = 0
    failed_substeps: int = 0
    newton_iterations: int = 0
    linear_iterations: int = 0


def summary_arrays(model, state):
    """(qs, bhp, fpr, fip) of one report step, on the model's device (the
    padding cells of an embedded grid carry no pore volume here)."""
    pv = model.pv_out
    fpr = torch.sum(state.pressure * pv) / torch.sum(pv)
    fip = torch.sum(model.accumulation(state) * pv[None, :], dim=1)
    return state.qs, state.bhp, fpr, fip


class SummaryCollector:
    """Accumulates the field and well time series per report step (field
    rates, GOR/WCT, cumulatives, fluid in place, per-well BHP and rates)."""

    def __init__(self, well_names: List[str]):
        self.well_names = well_names
        self.rows: List[dict] = []
        self._totals = dict(FOPT=0.0, FWPT=0.0, FGPT=0.0, FWIT=0.0,
                            FGIT=0.0, FLPT=0.0)
        self._last_t = 0.0

    def record(self, t, state: BlackoilState, model):
        """One summary row from the device state (one host pull)."""
        qs, bhp, fpr, fip = summary_arrays(model, state)
        flat = torch.cat([qs.reshape(-1), bhp, fpr.reshape(1),
                          fip]).cpu().numpy()
        nw = bhp.shape[0]
        return self.record_arrays(t, flat[:3 * nw].reshape(nw, 3),
                                  flat[3 * nw:4 * nw], float(flat[4 * nw]),
                                  flat[4 * nw + 1:])

    def record_arrays(self, t, qs, bhp, fpr, fip):
        row = dict(time=t / DAY)
        row["FPR"] = float(fpr)
        prod = np.clip(-qs, 0.0, None)
        inj = np.clip(qs, 0.0, None)
        row["FOPR"] = prod[:, OIL].sum()
        row["FWPR"] = prod[:, WATER].sum()
        row["FGPR"] = prod[:, GAS].sum()
        row["FLPR"] = row["FOPR"] + row["FWPR"]
        row["FOIR"] = inj[:, OIL].sum()
        row["FWIR"] = inj[:, WATER].sum()
        row["FGIR"] = inj[:, GAS].sum()
        fopr = row["FOPR"]
        row["FGOR"] = row["FGPR"] / fopr if fopr > 1e-12 else 0.0
        row["FWCT"] = (row["FWPR"] / (row["FWPR"] + fopr)
                       if row["FWPR"] + fopr > 1e-12 else 0.0)
        dt = t - self._last_t
        self._last_t = t
        self._totals["FOPT"] += row["FOPR"] * dt
        self._totals["FWPT"] += row["FWPR"] * dt
        self._totals["FGPT"] += row["FGPR"] * dt
        self._totals["FWIT"] += row["FWIR"] * dt
        self._totals["FGIT"] += row["FGIR"] * dt
        self._totals["FLPT"] += row["FLPR"] * dt
        row.update(self._totals)
        row["FWIP"] = float(fip[WATER])
        row["FOIP"] = float(fip[OIL])
        row["FGIP"] = float(fip[GAS])
        for iw, name in enumerate(self.well_names):
            row[f"WBHP:{name}"] = bhp[iw]
            row[f"WOPR:{name}"] = prod[iw, OIL]
            row[f"WWPR:{name}"] = prod[iw, WATER]
            row[f"WGPR:{name}"] = prod[iw, GAS]
            row[f"WGIR:{name}"] = inj[iw, GAS]
            row[f"WWIR:{name}"] = inj[iw, WATER]
            row[f"WGOR:{name}"] = (prod[iw, GAS] / prod[iw, OIL]
                                   if prod[iw, OIL] > 1e-12 else 0.0)
        self.rows.append(row)
        return row

    def series(self, key):
        return np.array([r.get(key, np.nan) for r in self.rows])


def fluid_in_place(model, state: BlackoilState):
    """Surface-volume fluid in place per phase (w, o, g), on the host."""
    acc = model.accumulation(state)
    return torch.sum(acc * model.pv_out[None, :], dim=1).cpu().numpy()


def schedule_wells(schedule):
    """(names, max_perf): the schedule's global well superset, so the well
    arrays keep one shape across all report steps."""
    names = []
    max_perf = 1
    for step in schedule.report_steps:
        for w in step.wells:
            if w.name not in names:
                names.append(w.name)
            max_perf = max(max_perf, len(w.completions))
    return names, max_perf


def report_step_wells(step, grid, names, max_perf) -> WellSet:
    """The report step's WellSet, extended to the global well list
    (wells missing from this step are shut)."""
    ws = build_well_set(step.wells, grid, max_perf=max_perf,
                        name_order=names)
    nw = len(names)
    if ws.nw == nw and ws.names == names:
        return ws
    idx = {n: i for i, n in enumerate(ws.names)}

    def pad2(a, fill=0.0):
        out = np.full((nw,) + a.shape[1:], fill, dtype=a.dtype)
        for i, n in enumerate(names):
            if n in idx:
                out[i] = a[idx[n]]
        return out

    return WellSet(
        names=list(names), nw=nw, max_perf=ws.max_perf,
        perf_cell=pad2(ws.perf_cell), perf_mask=pad2(ws.perf_mask, False),
        perf_wi=pad2(ws.perf_wi), perf_depth=pad2(ws.perf_depth),
        is_injector=pad2(ws.is_injector, False),
        comp_frac=pad2(ws.comp_frac), control=pad2(ws.control),
        target=pad2(ws.target), bhp_limit=pad2(ws.bhp_limit, 1e5),
        thp_limit=pad2(ws.thp_limit, np.nan),
        ref_depth=pad2(ws.ref_depth), open_mask=pad2(ws.open_mask, False),
        rate_targets=pad2(ws.rate_targets, np.nan),
        inj_rate_target=pad2(ws.inj_rate_target, np.nan),
        inj_resv_target=pad2(ws.inj_resv_target, np.nan),
        polymer_conc=pad2(ws.polymer_conc),
        is_history=pad2(ws.is_history, False))


def init_well_state(state: BlackoilState, ws: WellSet,
                    first: bool) -> BlackoilState:
    """Reset controls to the schedule and give fresh wells a sane guess
    (WellStateFullyImplicitBlackoil::init semantics)."""
    dev = state.pressure.device
    nw = ws.nw
    control_np = np.asarray(ws.control, dtype=np.int32).copy()
    target_np = np.asarray(ws.target, dtype=np.float64).copy()
    bhp = state.bhp.cpu().numpy().copy()
    qs = state.qs.cpu().numpy().copy()
    perf0 = [ws.perf_cell[iw][ws.perf_mask[iw]] for iw in range(nw)]
    p0 = state.pressure[torch.as_tensor(
        [int(c[0]) if len(c) else 0 for c in perf0],
        dtype=torch.long, device=dev)].cpu().numpy()
    for iw in range(nw):
        if not ws.open_mask[iw]:
            control_np[iw] = CTRL_BHP
            target_np[iw] = ws.bhp_limit[iw]
            bhp[iw] = ws.bhp_limit[iw]
            qs[iw] = 0.0
            continue
        p_ref = p0[iw] if len(perf0[iw]) else 1e7
        if ws.control[iw] == CTRL_BHP:
            bhp[iw] = ws.target[iw]
        elif first or bhp[iw] == 0.0:
            bhp[iw] = p_ref * (1.05 if ws.is_injector[iw] else 0.95)
        if first or not np.any(qs[iw]):
            t = ws.target[iw]
            if ws.is_injector[iw]:
                qs[iw] = ws.comp_frac[iw] * (
                    t if ws.control[iw] == CTRL_SURFACE_RATE else 0.0)
            else:
                sgn = {CTRL_ORAT: OIL, CTRL_WRAT: WATER,
                       CTRL_GRAT: GAS, CTRL_LRAT: OIL}.get(
                           int(ws.control[iw]))
                if sgn is not None:
                    qs[iw, sgn] = -t
    return state._replace(
        bhp=torch.as_tensor(bhp, device=dev),
        qs=torch.as_tensor(qs, device=dev),
        control=torch.as_tensor(control_np, device=dev),
        target=torch.as_tensor(target_np, device=dev))


def resolve_device(device) -> torch.device:
    """The torch device to run on: the card unless the caller asks for the
    CPU. Raises when a CUDA device is asked for and none is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is visible; pass "
            "device='cpu' to run on the CPU")
    return dev


class SimulatorFullyImplicitBlackoil:
    def __init__(self, case: EclipseCase, *,
                 params: Optional[ModelParams] = None,
                 ts_params: Optional[TimeStepControlParams] = None,
                 device="cuda"):
        self.case = case
        self.device = resolve_device(device)
        if case.solution.thpres:
            raise NotImplementedError(
                "THPRES is not ported yet (ROADMAP Queue 1 item 8)")
        self.grid = build_grid(case)
        self.props = BlackoilProps.from_case(case, self.device)
        self.model = BlackoilModel(self.grid, self.props, params,
                                   device=self.device)
        self.schedule = build_schedule(case)
        names, self.max_perf = schedule_wells(self.schedule)
        self.well_names = names
        self.ts = AdaptiveTimeStepping(ts_params, tuning=self.schedule.tuning)
        # TUNING record 3 NEWTMX: deck-driven max Newton iterations
        if self.schedule.tuning and self.schedule.tuning.get("newtmx"):
            self.model.params.max_iter = int(self.schedule.tuning["newtmx"])
        # dense Newton route at most DENSE_LIMIT cells, CPR above
        self.solver = NonlinearSolver(self.model)
        self.events = EventSource("timestep_completed",
                                  "report_step_completed")
        self._step_timing: list = []
        self.summary = SummaryCollector(names)
        self.report = SimulatorReportTotals()

    @staticmethod
    def _check_step_ported(step):
        if step.geo_mods:
            raise NotImplementedError(
                "schedule geology modifiers are not ported yet "
                "(ROADMAP Queue 1 item 8)")
        for w in step.wells:
            if w.control in ("GRUP", "RESV", "THP") or w.history:
                raise NotImplementedError(
                    f"well {w.name}: {w.control} control / history mode "
                    "is not ported yet (ROADMAP Queue 1 item 8)")
            if any(np.isfinite(v) for v in (w.econ_min_orat, w.econ_min_grat,
                                            w.econ_max_wct, w.econ_max_gor)):
                raise NotImplementedError(
                    f"well {w.name}: WECON is not ported yet "
                    "(ROADMAP Queue 1 item 8)")

    # ------------------------------------------------------------------
    def run(self, state: Optional[BlackoilState] = None, *,
            report_step_limit: Optional[int] = None, verbose: bool = False):
        """Run the schedule (per report step: wells, adaptive substeps,
        summary row). Returns the final state."""
        t_start = time.perf_counter()
        nw = len(self.well_names)
        if state is None:
            state = initial_state(self.grid, self.props, self.case, nw)
        steps = self.schedule.report_steps
        if report_step_limit is not None:
            steps = steps[:report_step_limit]
        first = True
        for step in steps:
            self._check_step_ported(step)
            ws = report_step_wells(step, self.grid, self.well_names,
                                   self.max_perf)
            if np.any(np.isin(ws.control, (CTRL_RESV, CTRL_RESERVOIR_RATE))):
                raise NotImplementedError(
                    "RESV controls are not ported yet (ROADMAP Queue 1 "
                    "item 8)")
            wd = make_well_device_arrays(ws, self.grid.gravity, self.device)
            state = init_well_state(state, ws, first)
            first = False

            def solve_fn(s, dt, _wd=wd):
                rep = SolverReport()
                s2, rep = self.solver.step(s, dt, _wd, report=rep)
                self.report.assemble_time += rep.assemble_time
                self.report.linear_solve_time += rep.linear_solve_time
                return s2, rep

            def _substep_cb(s, tl, dts, sr):
                self.events.signal("timestep_completed", s, tl, dts)

            t_step0 = time.perf_counter()
            state, subrep = self.ts.step(
                solve_fn, state, step.end_time - step.start_time,
                had_event=bool(step.events), substep_callback=_substep_cb)
            self._step_timing.append(
                (step.index, step.end_time / DAY,
                 time.perf_counter() - t_step0, subrep.substeps,
                 subrep.total_newton))
            self.events.signal("report_step_completed", state, step)
            self.report.substeps += subrep.substeps
            self.report.failed_substeps += subrep.failed_substeps
            self.report.newton_iterations += subrep.total_newton
            self.report.linear_iterations += subrep.total_linear
            row = self.summary.record(step.end_time, state, self.model)
            if verbose:
                print(f"step {step.index:4d} t={step.end_time / DAY:9.1f} d "
                      f"newton={subrep.total_newton:3d} "
                      f"FPR={row['FPR'] / 1e5:8.2f} bar "
                      f"FOPR={row['FOPR'] * DAY:10.1f} "
                      f"FGOR={row['FGOR']:8.2f}")
        self.report.total_time = time.perf_counter() - t_start
        return state


def run_deck(path: str, *, device="cuda", verbose=False, **kw):
    """flow-style entry: load the deck, build, run."""
    case = load_case(path)
    sim = SimulatorFullyImplicitBlackoil(case, device=device, **kw)
    state = sim.run(verbose=verbose)
    return sim, state
