"""SimulatorFullyImplicitBlackoil: the report-step driver on tensors.

Port of the per-step path of the JAX package's sim/blackoil.py (the branch
the reference takes on CPU, where ``fused`` is off): report-step loop,
per-step well rebuild, adaptive sub-stepping, summary collection and the
iteration totals, and the output layer: the deck-driven SUMMARY vectors,
the ECL SMSPEC/UNSMRY, UNRST, INIT and EGRID files, the PRT run log,
.npz checkpoints, VTK and Matlab dumps (an asynchronous writer thread on
host arrays), and resume from a checkpoint, an UNRST or a deck RESTART.
Field-style controls as the reference's per-step path runs them: THPRES
thresholds between equilibration regions (defaulted ones from the initial
state's pressure jump), VFP tables with THP control and the WTHP summary
values, group targets resolved a report step and reallocated in each
Newton, history-mode (WCONHIST/WCONINJH) and RESV controls through the
rate converter, WECON economic limits and schedule geology modifiers
(MULTFLT and the like), which rebuild the grid, the model and the solver
with its CPR hierarchy. Each report step's host work of these pieces is
counted in ``host_work`` (host reads and seconds). Not ported yet, and
raising where a deck reaches them: report-step spans and the fused
substep (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import copy
import gc
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from opm_tpu_torch.grid.grid import build_grid, estimate_cell_velocity
from opm_tpu_torch.io import eclsum, matlab, restart, vtk
from opm_tpu_torch.io.eclstate import EclipseCase, load_case
from opm_tpu_torch.io.prt import PrtLogger
from opm_tpu_torch.io.schedule import build_schedule
from opm_tpu_torch.io.summaryconfig import block_cells, expand_requests
from opm_tpu_torch.models.blackoil import (BlackoilModel, ModelParams,
                                           make_well_device_arrays)
from opm_tpu_torch.models.state import (GAS, OIL, WATER, BlackoilState,
                                        rs_rv, saturations)
from opm_tpu_torch.props.blackoil import BlackoilProps
from opm_tpu_torch.sim.init import initial_state
from opm_tpu_torch.solver.newton import NonlinearSolver, SolverReport
from opm_tpu_torch.solver.timestepping import (AdaptiveTimeStepping,
                                               TimeStepControlParams)
from opm_tpu_torch.utils.events import EventSource
from opm_tpu_torch.utils.threadhandle import ThreadHandle
from opm_tpu_torch.wells import standard as stdwells
from opm_tpu_torch.wells.econ import check_econ_limits
from opm_tpu_torch.wells.groups import (make_group_device_arrays,
                                        resolve_group_controls)
from opm_tpu_torch.wells.rateconv import (region_averages,
                                          voidage_coefficients,
                                          well_resv_coefficients)
from opm_tpu_torch.wells.vfp import tables_to
from opm_tpu_torch.wells.wells import (CTRL_BHP, CTRL_GRAT, CTRL_LRAT,
                                       CTRL_ORAT, CTRL_RESERVOIR_RATE,
                                       CTRL_RESV, CTRL_SURFACE_RATE,
                                       CTRL_THP, CTRL_WRAT, WellSet,
                                       build_well_set)

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


def region_masks(fipnum: np.ndarray, nreg: int, device) -> torch.Tensor:
    """(nreg, nc) float64 0/1 rows: cell c in FIPNUM region r (0-based;
    cells at -1, the padding of an embedded grid, in none). The region
    sums are masked row sums, so every region adds its cells in one fixed
    order on each device (no scatter)."""
    fip = torch.as_tensor(np.asarray(fipnum), dtype=torch.long,
                          device=device)
    regs = torch.arange(nreg, dtype=torch.long, device=device)
    return (fip[None, :] == regs[:, None]).to(torch.float64)


def summary_arrays(model, state, masks=None, cells=None):
    """(qs, bhp, fpr, fip, region, block) of one report step, on the
    model's device (the padding cells of an embedded grid carry no pore
    volume here). region = (rpr, rfip): the pore-volume-weighted pressure
    (nreg,) and the surface volumes in place (nreg, 3) of each row of
    ``masks`` (``region_masks``); block = the pressures at ``cells``.
    Both None unless asked for."""
    pv = model.pv_out
    fpr = torch.sum(state.pressure * pv) / torch.sum(pv)
    vol = model.accumulation(state) * pv[None, :]            # (3, nc)
    fip = torch.sum(vol, dim=1)
    region = None
    if masks is not None:
        rpv = torch.sum(masks * pv[None, :], dim=1)
        rppv = torch.sum(masks * (state.pressure * pv)[None, :], dim=1)
        rpr = rppv / torch.clamp_min(rpv, 1e-300)
        rfip = torch.sum(masks[:, None, :] * vol[None, :, :], dim=2)
        region = (rpr, rfip)
    block = None
    if cells is not None:
        block = state.pressure[cells]
    return state.qs, state.bhp, fpr, fip, region, block


class SummaryCollector:
    """Accumulates well/field time series (the BlackoilOutputWriter summary
    role, SimulatorFullyImplicitBlackoilOutput.hpp:206).

    With ``requests`` (the deck SUMMARY section, io/eclstate.py
    summary_requests) the collector additionally computes every requested
    vector it supports (per-well ratios/cumulatives, per-FIPNUM region
    pressure and in-place volumes, block pressures), and
    ``requested_keys``/``unsupported`` drive the ECL writer's vector
    selection and the PRT warning (the reference's SummaryConfig role)."""

    def __init__(self, well_names: List[str], requests=None, grid=None):
        self.well_names = well_names
        self.rows: List[dict] = []
        self._totals = dict(FOPT=0.0, FWPT=0.0, FGPT=0.0, FWIT=0.0,
                            FGIT=0.0, FLPT=0.0)
        self._last_t = 0.0
        self.requested_keys: Optional[List[str]] = None
        self.unsupported: List[str] = []
        self._need: set = set()
        self._block = []              # [(key, active_cell_index)]
        self._fipnum = None
        self._nreg = 1
        self._well_totals = {}        # key -> per-well cumulative array
        self._device_spec = {}        # device -> (masks, block cells)
        if requests:
            nreg = 1
            ijk_to_cell = None
            if grid is not None:
                fip = (np.zeros(grid.nc, dtype=np.int64)
                       if grid.fipnum is None else np.asarray(grid.fipnum))
                if grid.active_mask is not None:
                    self._fipnum = np.where(np.asarray(grid.active_mask),
                                            fip, -1)
                else:
                    self._fipnum = fip
                nreg = int(fip.max()) + 1 if fip.size else 1
                nx, ny, nz = grid.dims
                cart = np.full(nx * ny * nz, -1, dtype=np.int64)
                rc = grid.real_cells
                cart[np.asarray(grid.global_cell)[rc]] = rc

                def ijk_to_cell(i, j, k, _cart=cart, _d=(nx, ny, nz)):
                    nx_, ny_, nz_ = _d
                    if not (0 <= i < nx_ and 0 <= j < ny_ and 0 <= k < nz_):
                        return None
                    c = _cart[(k * ny_ + j) * nx_ + i]
                    return None if c < 0 else int(c)

            self._nreg = nreg
            keys, unsup, need = expand_requests(
                requests, well_names, nreg, ijk_to_cell)
            self.requested_keys = keys
            self.unsupported = unsup
            self._need = need
            if ijk_to_cell is not None:
                self._block = block_cells(keys, ijk_to_cell)
            if "well_totals" in need:
                nw = len(well_names)
                for k in ("WOPT", "WWPT", "WGPT", "WWIT", "WGIT"):
                    self._well_totals[k] = np.zeros(nw)

    def region_spec(self):
        """(fipnum, nreg) when region vectors are requested, else None."""
        if "region" in self._need and self._fipnum is not None:
            return self._fipnum, self._nreg
        return None

    def block_spec(self):
        """[(key, cell)] block-pressure requests."""
        return self._block if "block" in self._need else []

    def _spec_on(self, device):
        """The region masks and the block cells on ``device``, made once."""
        spec = self._device_spec.get(device)
        if spec is None:
            rs = self.region_spec()
            masks = None if rs is None else region_masks(rs[0], rs[1],
                                                         device)
            bl = self.block_spec()
            cells = (torch.as_tensor([c for _, c in bl], dtype=torch.long,
                                     device=device) if bl else None)
            spec = self._device_spec[device] = (masks, cells)
        return spec

    def record(self, t, state: BlackoilState, model, extra=None):
        """One summary row from the device state: the arrays computed on
        the model's device, then one host pull."""
        masks, cells = self._spec_on(model.device)
        qs, bhp, fpr, fip, region, block = summary_arrays(
            model, state, masks, cells)
        parts = [qs.reshape(-1), bhp, fpr.reshape(1), fip]
        if region is not None:
            parts += [region[0], region[1].reshape(-1)]
        if block is not None:
            parts.append(block)
        flat = torch.cat(parts).cpu().numpy()
        nw = bhp.shape[0]
        nreg = self._nreg
        o = 4 * nw + 4
        reg_h = None
        if region is not None:
            reg_h = (flat[o:o + nreg], flat[o + nreg:o + 4 * nreg].reshape(
                nreg, 3))
            o += 4 * nreg
        return self.record_arrays(
            t, flat[:3 * nw].reshape(nw, 3), flat[3 * nw:4 * nw],
            float(flat[4 * nw]), flat[4 * nw + 1:4 * nw + 4], extra,
            region=reg_h, block=None if block is None else flat[o:])

    def record_arrays(self, t, qs, bhp, fpr, fip, extra=None, *,
                      region=None, block=None):
        """Build a summary row from arrays on the host."""
        qs = np.asarray(qs)
        bhp = np.asarray(bhp)
        row = dict(time=t / DAY)
        row["FPR"] = float(fpr)
        # field rates: production reported positive (OPM sign convention:
        # qs negative for producers)
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
        # cumulative totals (rectangle rule over report steps)
        dt = t - self._last_t
        self._last_t = t
        self._totals["FOPT"] += row["FOPR"] * dt
        self._totals["FWPT"] += row["FWPR"] * dt
        self._totals["FGPT"] += row["FGPR"] * dt
        self._totals["FWIT"] += row["FWIR"] * dt
        self._totals["FGIT"] += row["FGIR"] * dt
        self._totals["FLPT"] += row["FLPR"] * dt
        row.update(self._totals)
        if self._well_totals:
            self._well_totals["WOPT"] += prod[:, OIL] * dt
            self._well_totals["WWPT"] += prod[:, WATER] * dt
            self._well_totals["WGPT"] += prod[:, GAS] * dt
            self._well_totals["WWIT"] += inj[:, WATER] * dt
            self._well_totals["WGIT"] += inj[:, GAS] * dt
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
            if self.requested_keys is not None:
                liq = prod[iw, OIL] + prod[iw, WATER]
                row[f"WLPR:{name}"] = liq
                row[f"WWCT:{name}"] = (prod[iw, WATER] / liq
                                       if liq > 1e-12 else 0.0)
                row[f"WGLR:{name}"] = (prod[iw, GAS] / liq
                                       if liq > 1e-12 else 0.0)
                row[f"WOIR:{name}"] = inj[iw, OIL]
                # THP is only defined through a VFP back-solve; wells
                # without VFP report 0, as the reference does
                row.setdefault(f"WTHP:{name}", 0.0)
                for k, tot in self._well_totals.items():
                    row[f"{k}:{name}"] = tot[iw]
        if region is not None:
            rpr, rfip = region
            for r in range(self._nreg):
                row[f"RPR:{r + 1}"] = float(rpr[r])
                row[f"ROIP:{r + 1}"] = float(rfip[r, OIL])
                row[f"RWIP:{r + 1}"] = float(rfip[r, WATER])
                row[f"RGIP:{r + 1}"] = float(rfip[r, GAS])
        if block is not None:
            for (key, _c), val in zip(self._block, np.asarray(block)):
                row[key] = float(val)
        if extra:
            row.update(extra)
        self.rows.append(row)
        return row

    def series(self, key):
        return np.array([r.get(key, np.nan) for r in self.rows])

    def to_csv(self, path):
        keys = sorted({k for r in self.rows for k in r},
                      key=lambda k: (k != "time", k))
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for r in self.rows:
                f.write(",".join(f"{r.get(k, float('nan')):.10g}"
                                 for k in keys) + "\n")


def fluid_in_place(model, state: BlackoilState, regions=None):
    """Surface-volume fluid in place per phase (w, o, g), on the host. With
    ``regions`` (nc,) 0-based FIPNUM: (nreg, 3) per-region volumes (the
    reference's per-FIPNUM report), summed on the host from one pull of
    the cell volumes, in the reference's order."""
    acc = model.accumulation(state)
    if regions is None:
        return torch.sum(acc * model.pv_out[None, :], dim=1).cpu().numpy()
    vol = (acc * model.pv_out[None, :]).cpu().numpy().T     # (nc, 3)
    regions = np.asarray(regions)
    out = np.zeros((int(regions.max()) + 1, 3))
    np.add.at(out, regions, vol)
    return out


def output_arrays(model, state: BlackoilState, face_flux: bool = False):
    """(sg, rs, rv[, face fluxes (3, nf)]) of a report step's output on the
    model's device: the saturations from the switched variables, rs and rv
    from K1's rs_sat/rv_sat lookups where the phase is saturated, and for
    the Matlab velocity the plain K3 face fluxes."""
    _, _, sg = saturations(state)
    rs, rv = rs_rv(state, model.props, model.pvtnum)
    out = [sg, rs, rv]
    if face_flux:
        out.append(model.face_fluxes(model.cell_quantities(state)))
    return out


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


def report_step_wells(step, grid, names, max_perf, wells=None) -> WellSet:
    """The report step's WellSet (of ``wells``, the step's own by
    default), extended to the global well list (wells missing from this
    step are shut)."""
    ws = build_well_set(step.wells if wells is None else wells, grid,
                        max_perf=max_perf, name_order=names)
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


def egrid_geometry(case) -> Optional[str]:
    """Where an EGRID's geometry comes from: 'COORD/ZCORN' (corner-point
    decks), 'DX/DY/DZ' (per-cell block sizes, with TOPS or a zero top) or
    'DXV/DYV/DZV' (vectors); None when the case carries none of them, and
    then no EGRID is written."""
    ga = case.grid_arrays
    nx, ny, nz = case.runspec.dims
    if "COORD" in ga and "ZCORN" in ga:
        return "COORD/ZCORN"
    if "TOPS" in ga and np.size(ga["TOPS"]) < nx * ny:
        return None
    if all(k in ga and np.size(ga[k]) == nx * ny * nz
           for k in ("DX", "DY", "DZ")):
        return "DX/DY/DZ"
    if "DX" not in ga and all(k in ga for k in ("DXV", "DYV", "DZV")):
        return "DXV/DYV/DZV"
    return None


class SimulatorFullyImplicitBlackoil:
    def __init__(self, case: EclipseCase, *,
                 params: Optional[ModelParams] = None,
                 ts_params: Optional[TimeStepControlParams] = None,
                 output_dir: Optional[str] = None,
                 device="cuda"):
        """output_dir: where the run writes its files (none when None):
        the PRT log, summary.csv, SMSPEC/UNSMRY, INIT, EGRID, the FIP and
        timing reports, and with ``run``'s flags the checkpoints, UNRST,
        VTK and Matlab dumps."""
        self.case = case
        self.device = resolve_device(device)
        # the grid's embedding policy as it was built (a geology rebuild
        # keeps the representation)
        self._embed_knob = os.environ.get("OPM_TPU_EMBED", "auto")
        self.grid = build_grid(case, self._embed_knob)
        # a geology modifier edits a copy of the case, made at the first
        self._owns_case = False
        self.props = BlackoilProps.from_case(case, self.device)
        self.model = BlackoilModel(self.grid, self.props, params,
                                   device=self.device)
        self._thpres_default_pairs = []
        if case.solution.thpres:
            self._thpres_setup()
        self.vfp_tables = tables_to(case.vfp_tables, self.device)
        self.schedule = build_schedule(case)
        self.output_dir = output_dir
        names, self.max_perf = schedule_wells(self.schedule)
        self.well_names = names
        # wells shut by economic limits, and (i, j, k) completions closed
        # by a WECON workover per well
        self._econ_shut: set = set()
        self._econ_closed_conns: Dict[str, set] = {}
        self._vfp_report = None
        # per piece of a report step's host work: [host reads, seconds]
        self.host_work: Dict[str, list] = {}
        self.ts = AdaptiveTimeStepping(ts_params, tuning=self.schedule.tuning)
        # TUNING record 3 NEWTMX: deck-driven max Newton iterations
        if self.schedule.tuning and self.schedule.tuning.get("newtmx"):
            self.model.params.max_iter = int(self.schedule.tuning["newtmx"])
        # dense Newton route at most DENSE_LIMIT cells, CPR above
        self.solver = NonlinearSolver(self.model)
        self.events = EventSource("timestep_completed",
                                  "report_step_completed")
        self._step_timing: list = []
        self._unrst_steps: list = []
        self.summary = SummaryCollector(
            names, requests=getattr(case, "summary_requests", None),
            grid=self.grid)
        self.report = SimulatorReportTotals()

    # ------------------------------------------------------------------
    # THPRES, host work, economic limits, groups, RESV, VFP
    def _thpres_setup(self):
        """Per-face threshold pressures between equilibration regions
        (thresholdPressures.hpp:47,321; the reference's sim/blackoil.py :333-350),
        in the grid's face order on model.threshold_dp; defaulted pairs
        wait for the initial state (_thpres_defaults)."""
        eql = np.asarray(self.grid.eqlnum)
        fc = np.asarray(self.grid.face_cells)
        thp = np.zeros(len(fc))
        for (r1, r2, val) in self.case.solution.thpres:
            m = (((eql[fc[:, 0]] == r1 - 1) & (eql[fc[:, 1]] == r2 - 1))
                 | ((eql[fc[:, 0]] == r2 - 1) & (eql[fc[:, 1]] == r1 - 1)))
            if val is None:
                self._thpres_default_pairs.append(m)
            else:
                thp[m] = val
        self.model.threshold_dp = torch.as_tensor(thp, device=self.device)

    def _thpres_defaults(self, state):
        """Defaulted THPRES: the sustained equilibrium pressure jump across
        the barrier, max |p1 - p2| over the region interface (computeMaxDp
        from the equilibrated columns, thresholdPressures.hpp:47)."""
        fc = np.asarray(self.grid.face_cells)
        p0 = state.pressure.cpu().numpy()
        dp_face = np.abs(p0[fc[:, 0]] - p0[fc[:, 1]])
        thp = self.model.threshold_dp.cpu().numpy()
        for m in self._thpres_default_pairs:
            if m.any():
                thp = np.where(m, dp_face[m].max(), thp)
        self.model.threshold_dp = torch.as_tensor(thp, device=self.device)
        self._thpres_default_pairs = []

    def _pull(self, piece, *tensors):
        """One host read of the tensors (concatenated flat), counted under
        ``piece`` in host_work; the host arrays back in order."""
        flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
        host = flat.cpu().numpy()
        self.host_work.setdefault(piece, [0, 0.0])[0] += 1
        return np.split(host, np.cumsum([t.numel() for t in tensors])[:-1])

    def _timed(self, piece, t0):
        self.host_work.setdefault(piece, [0, 0.0])[1] += \
            time.perf_counter() - t0

    def _step_wells_for(self, step):
        """The step's wells, with the wells and connections that economic
        limits shut kept shut."""
        if not (self._econ_shut or self._econ_closed_conns):
            return step.wells
        step_wells = [w.copy() for w in step.wells]
        for w in step_wells:
            if w.name in self._econ_shut:
                w.status = "SHUT"
            closed = self._econ_closed_conns.get(w.name)
            if closed:
                for c in w.completions:
                    if (c.i, c.j, c.k) in closed:
                        c.status = "SHUT"
        return step_wells

    def _check_econ_limits(self, step_wells, state, ws, wd):
        """WECON economic limits after a report step: rate violations shut
        the producer; a max-water-cut violation follows the workover
        procedure, closing the worst-offending connection
        (checkRateEconLimits / checkMaxWaterCutLimit,
        StandardWells_impl.hpp:1209-1380; wells/econ.py). One host read,
        and none on a step without WECON wells."""
        econ = [w for w in step_wells
                if w.type == "PRODUCER" and w.status.upper() == "OPEN"
                and w.name not in self._econ_shut
                and any(np.isfinite(v) for v in (
                    w.econ_min_orat, w.econ_min_grat, w.econ_max_wct,
                    w.econ_max_gor))]
        if not econ:
            return
        t0 = time.perf_counter()
        idx = {n: i for i, n in enumerate(self.well_names)}
        need_cq = any(np.isfinite(w.econ_max_wct)
                      and w.econ_workover in ("CON", "+CON") for w in econ)
        parts = [state.qs]
        if need_cq:
            cellq = self.model.well_cell_quantities(
                self.model.cell_quantities(state))
            cdp = stdwells.connection_pressure_offsets(wd, cellq, state.qs)
            parts.append(stdwells.perforation_fluxes(
                wd, cellq, state.bhp, state.qs, cdp))
        host = self._pull("econ", *parts)
        qs = host[0].reshape(-1, 3)
        cq = host[1].reshape(ws.nw, ws.max_perf, 3) if need_cq else None
        for w in econ:
            i = idx.get(w.name)
            if i is None:
                continue
            qo = max(-qs[i, OIL], 0.0)
            qw = max(-qs[i, WATER], 0.0)
            qg = max(-qs[i, GAS], 0.0)
            if cq is not None:
                perf_qw = np.clip(-cq[i, :, WATER], 0.0, None)
                perf_qo = np.clip(-cq[i, :, OIL], 0.0, None)
                open_mask = np.asarray(ws.perf_mask[i])
            else:
                perf_qw = np.array([qw])
                perf_qo = np.array([qo])
                open_mask = np.array([True])
            res = check_econ_limits(
                qo, qw, qg, perf_qw, perf_qo, open_mask,
                min_orat=w.econ_min_orat, min_grat=w.econ_min_grat,
                max_wct=w.econ_max_wct, max_gor=w.econ_max_gor,
                workover=w.econ_workover)
            if res.shut_well:
                self._econ_shut.add(w.name)
            elif res.closed_connections:
                # closed_connections index the padded perf arrays, which
                # build_well_set fills depth-sorted: (i, j, k) from
                # perf_cell
                closed = self._econ_closed_conns.setdefault(w.name, set())
                pm = np.asarray(ws.perf_mask[i])
                pc = np.asarray(ws.perf_cell[i])
                for k in res.closed_connections:
                    if k < pm.shape[0] and pm[k]:
                        ci, cj, ck = self.grid.ijk(int(pc[k]))
                        closed.add((int(ci), int(cj), int(ck)))
                if len(closed) >= len(w.completions):
                    self._econ_shut.add(w.name)
        self._timed("econ", t0)

    def _resolve_groups(self, step, step_wells, state):
        """GRUP wells' targets from their groups' (resolve_group_controls,
        once a report step) and the in-Newton reallocation specs: the
        current rates as guide rates, the wells' potentials at their BHP
        limits (computeWellPotentials, from the first report step's wells
        as the reference) as the fallback, the field's producer voidage
        (for VREP) from the rate converter: one host read."""
        t0 = time.perf_counter()
        dev = self.device
        # the field's voidage: one region over every cell
        p_avg, rs_avg, rv_avg = region_averages(
            self.model, state, np.zeros(self.model.nc, dtype=np.int64))
        coef = voidage_coefficients(self.props, p_avg, rs_avg, rv_avg)[0]
        voidage = torch.sum(torch.clamp(-state.qs, min=0.0) * coef[None, :])
        ws0 = report_step_wells(self.schedule.report_steps[0], self.grid,
                                self.well_names, self.max_perf)
        wd0 = make_well_device_arrays(ws0, self.grid.gravity, dev)
        cellq = self.model.well_cell_quantities(
            self.model.cell_quantities(state))
        cdp = stdwells.connection_pressure_offsets(wd0, cellq, state.qs)
        pots = stdwells.well_potentials(wd0, cellq, cdp)
        qs_h, pots_h, void_h = self._pull("groups", state.qs, pots, voidage)
        nw = len(self.well_names)
        qs_h = qs_h.reshape(nw, 3)
        pots_h = pots_h.reshape(nw, 3)
        rates = {n: qs_h[i] for i, n in enumerate(self.well_names)}
        potentials = {n: pots_h[i] for i, n in enumerate(self.well_names)}
        collect = []
        wells = resolve_group_controls(step_wells, step.groups, rates,
                                       float(void_h[0]),
                                       potentials=potentials,
                                       collect=collect)
        specs = (make_group_device_arrays(collect, self.well_names, dev)
                 if collect else None)
        self._timed("groups", t0)
        return wells, specs

    def _resv_targets(self, ws, wd, state):
        """RESV controls: the voidage coefficients of each well's FIP
        region (computeRESV, SimulatorBase_impl.hpp:196), and WCONHIST
        producers' targets, the observed surface rates at reservoir
        conditions (SimulatorBase_impl.hpp:569-596); on the card, no host
        read."""
        t0 = time.perf_counter()
        coef = well_resv_coefficients(self.model, state, ws)
        wd["resv_coef"] = coef
        hist = ws.is_history & ~ws.is_injector & ws.open_mask
        if np.any(hist):
            q_obs = torch.as_tensor(
                np.nan_to_num(ws.rate_targets[:, [1, 0, 2]]),
                device=self.device)
            tgt = torch.where(torch.as_tensor(hist, device=self.device),
                              torch.sum(coef * q_obs, dim=1), state.target)
            wd["primary_target"] = tgt
            state = state._replace(target=tgt)
        self._timed("resv", t0)
        return state

    def _wire_vfp(self, wd, ws, state, step_wells):
        """The VFP data of the step's wells (each well's table slot and its
        hydrostatic datum correction, computeHydrostaticCorrection,
        StandardWells_impl.hpp:918-960: rho_wellbore g (bhp_ref_depth -
        table_datum_depth) with the mixture density at the shallowest
        connection, once a report step): on wd when a well is on THP
        control or carries a THP limit, and kept for the WTHP values. One
        host read."""
        self._vfp_report = None
        if not self.vfp_tables:
            return
        tables = tuple(self.vfp_tables[k] for k in sorted(self.vfp_tables))
        tid_to_slot = {t.table_id: i for i, t in enumerate(tables)}
        slots = np.array(
            [tid_to_slot.get(next((w.vfp_table for w in step_wells
                                   if w.name == n), 0), -1)
             for n in self.well_names], dtype=np.int64)
        if not np.any(slots >= 0):
            return
        t0 = time.perf_counter()
        need_vfp = bool(np.any(ws.control == CTRL_THP)
                        or np.any(np.isfinite(ws.thp_limit) & ws.open_mask))
        cellq = self.model.well_cell_quantities(
            self.model.cell_quantities(state))
        rho_top = self._pull("vfp", stdwells.wellbore_mixture_density(
            wd, cellq, state.qs)[:, 0])[0]
        datum = np.array([tables[k].datum_depth if k >= 0 else 0.0
                          for k in slots])
        dp_corr = np.where(slots >= 0, rho_top * float(self.grid.gravity)
                           * (np.asarray(ws.ref_depth) - datum), 0.0)
        self._vfp_report = (tables, slots, dp_corr)
        if need_vfp:
            wd["vfp"] = (tables, torch.as_tensor(slots, device=self.device),
                         torch.as_tensor(dp_corr, device=self.device))
        self._timed("vfp", t0)

    def _thp_report_extra(self, state):
        """WTHP summary values of every well with a VFP table: the table
        inverted for THP at the converged rates and datum-corrected BHP
        (StandardWells_impl.hpp:613-703), on the card, one host read."""
        if self._vfp_report is None:
            return None
        t0 = time.perf_counter()
        tables, slots, dp_corr = self._vfp_report
        iws = [iw for iw in range(len(self.well_names)) if slots[iw] >= 0]
        thp = [tables[slots[iw]].thp_at(state.qs[iw],
                                        state.bhp[iw] - float(dp_corr[iw]))
               for iw in iws]
        vals = self._pull("wthp", torch.stack(thp))[0]
        self._timed("wthp", t0)
        return {f"WTHP:{self.well_names[iw]}": float(v)
                for iw, v in zip(iws, vals)}

    # ------------------------------------------------------------------
    def _apply_geo_modifiers(self, mods):
        """GEO_MODIFIER schedule events (SimulatorBase_impl.hpp:258-268,
        the reference's sim/blackoil.py :563-615): apply MULTFLT / ARRAY / EQUALS /
        MULTIPLY to the simulator's own copy of the case (the caller's is
        left as it was), rebuild the grid with the embedding policy the
        first grid was built with, then the model (keeping the
        thresholds) and the solver with its CPR stack (the structured GMG
        hierarchy and K7's buffers, or the AMG hierarchy, K10's buffers and
        K4-faces' sliced-ELL layout on a gather grid), after the old ones
        are released. Raises, as the reference, when the active topology
        changes."""
        if not self._owns_case:
            self.case = copy.deepcopy(self.case)
            self._owns_case = True
        case = self.case
        nx, ny, nz = case.runspec.dims
        ncg = nx * ny * nz

        def ensure(name):
            if name not in case.grid_arrays:
                case.grid_arrays[name] = np.ones(ncg)
            return case.grid_arrays[name]

        def box_idx(b):
            if b is None:
                return slice(None)
            i1, i2, j1, j2, k1, k2 = b
            K, J, I = np.meshgrid(np.arange(k1, k2 + 1),
                                  np.arange(j1, j2 + 1),
                                  np.arange(i1, i2 + 1), indexing="ij")
            return ((K * ny + J) * nx + I).ravel()

        for mod in mods:
            if mod[0] == "MULTFLT":
                for nm, v in mod[1]:
                    case.fault_mults[nm] = v
            elif mod[0] == "ARRAY":
                _, name, vals = mod
                ensure(name)[: len(vals)] = vals
            elif mod[0] == "EQUALS":
                _, name, value, b = mod
                ensure(name)[box_idx(b)] = value
            elif mod[0] == "MULTIPLY":
                _, name, value, b = mod
                ensure(name)[box_idx(b)] *= value
        thr = self.model.threshold_dp
        params = self.model.params
        old_nc, old_nf = self.grid.nc, self.grid.nf
        grid = build_grid(case, self._embed_knob)
        if grid.nc != old_nc or grid.nf != old_nf:
            raise ValueError(
                "schedule geology modifier changed the active topology "
                f"(nc {old_nc}->{grid.nc}, nf {old_nf}->{grid.nf}); only "
                "transmissibility/pore-volume changes are supported mid-run")
        linear_solver = self.solver.linear_solver
        timing = self.solver.timing
        # release the old model and solver (and the CPR hierarchy's device
        # buffers) before their successors are made
        self.model = self.solver = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.grid = grid
        self.model = BlackoilModel(grid, self.props, params,
                                   device=self.device)
        self.model.threshold_dp = thr
        self.solver = NonlinearSolver(self.model,
                                      linear_solver=linear_solver)
        self.solver.timing = timing

    def _out_base(self) -> str:
        """Output-file basename: the deck filename (ECL convention),
        falling back to the deck TITLE for synthetic cases."""
        if getattr(self.case, "path", None):
            return os.path.splitext(os.path.basename(self.case.path))[0]
        return (self.case.runspec.title or "CASE").split()[0] or "CASE"

    def _deck_restart(self):
        """(file, step, tried): the deck RESTART's BASENAME.UNRST beside the
        deck or in the working directory, as the reference looks for it;
        file is None when neither exists."""
        base, rstep = self.case.solution.restart
        root = os.path.dirname(self.case.path or ".")
        tried = (os.path.join(root, base + ".UNRST"), base + ".UNRST")
        for cand in tried:
            if os.path.exists(cand):
                return cand, rstep, tried
        return None, rstep, tried

    def _write_step_outputs(self, state, step, writer, write_restart,
                            write_vtk, write_matlab):
        """Per-report-step output (restart checkpoint + UNRST accumulation,
        VTK, Matlab): the derived arrays on the device, one host pull of
        them with the state, then the writes queued on the writer thread
        (host arrays only)."""
        if not ((write_restart or write_vtk or write_matlab)
                and self.output_dir):
            return
        derived = output_arrays(self.model, state, face_flux=write_matlab)
        nc, nw = state.nc, state.nw
        parts = [state.pressure, state.sw, state.x,
                 state.hcstate.to(torch.float64), state.bhp,
                 state.qs.reshape(-1), state.control.to(torch.float64),
                 state.target] + [a.reshape(-1) for a in derived]
        flat = torch.cat(parts).cpu().numpy()
        sizes = [nc, nc, nc, nc, nw, 3 * nw, nw, nw, nc, nc, nc]
        if write_matlab:
            sizes.append(derived[3].numel())
        cut = np.split(flat, np.cumsum(sizes)[:-1])
        host = dict(pressure=cut[0], sw=cut[1], x=cut[2],
                    hcstate=cut[3].astype(np.int32), bhp=cut[4],
                    qs=cut[5].reshape(nw, 3),
                    control=cut[6].astype(np.int32), target=cut[7],
                    sgmax=None, somax=None)
        sw_, sg_, rs_, rv_ = host["sw"], cut[8], cut[9], cut[10]
        # embedded grids: the ECL arrays and dumps cover the REAL active
        # cells only (padding is an internal layout)
        rc = (slice(None) if self.grid.active_mask is None
              else self.grid.real_cells)
        os.makedirs(self.output_dir, exist_ok=True)
        if write_restart:
            writer.submit(
                restart.save_restart,
                os.path.join(self.output_dir,
                             f"restart_{step.index:04d}.npz"),
                host, report_step=step.index, time=step.end_time,
                suggested_dt=self.ts.suggested_dt)
            # accumulate ECL unified-restart solution steps
            p_unit = restart.pressure_unit(self.case.runspec.unit_system)
            xwel = np.concatenate([
                host["bhp"][:, None], host["qs"],
                host["control"].astype(np.float64)[:, None],
                host["target"][:, None]], axis=1)
            self._unrst_steps.append(dict(
                seqnum=step.index,
                time_days=step.end_time / DAY,
                PRESSURE=host["pressure"][rc] * p_unit,
                SWAT=sw_[rc], SGAS=sg_[rc],
                RS=rs_[rc], RV=rv_[rc],
                # well state + stepper extras (SI), the analogue of the
                # reference's OPM_XWEL/OPM_EXTRA restart data
                OPM_XWEL=xwel.reshape(-1),
                OPM_EXTRA=np.asarray([self.ts.suggested_dt])))
        if write_vtk:
            writer.submit(
                vtk.write_vtr,
                os.path.join(self.output_dir, f"step_{step.index:04d}.vtr"),
                self.grid,
                dict(PRESSURE=host["pressure"], SWAT=sw_, SGAS=sg_))
        if write_matlab:
            # Matlab sub-writer (BlackoilMatlabWriter,
            # SimulatorFullyImplicitBlackoilOutput.hpp:175-195):
            # per-variable NNN.txt dumps + estimated cell velocity
            so_m = 1.0 - sw_ - sg_
            flux_m = cut[11].reshape(3, -1).sum(axis=0)
            vel = estimate_cell_velocity(self.grid, flux_m)
            sat = np.stack([sw_[rc], so_m[rc], sg_[rc]], axis=1)
            writer.submit(
                matlab.output_state_matlab, self.output_dir, step.index,
                pressure=host["pressure"][rc], saturation=sat, rs=rs_[rc],
                rv=rv_[rc], velocity=vel[rc])
            writer.submit(
                matlab.output_well_state_matlab, self.output_dir,
                step.index, bhp=host["bhp"], wellrates=host["qs"])

    def _write_run_outputs(self, state):
        """End-of-run files (on the main thread, after the writer has
        drained): summary.csv, SMSPEC/UNSMRY, UNRST, INIT, EGRID where the
        case carries the geometry, the per-FIPNUM fluid in place and the
        timing reports."""
        out = self.output_dir
        base = os.path.join(out, self._out_base())
        rs = self.case.runspec
        fip_reg = fluid_in_place(self.model, state, regions=self.grid.fipnum)
        os.makedirs(out, exist_ok=True)
        self.summary.to_csv(os.path.join(out, "summary.csv"))
        eclsum.write_summary(base, self.summary.rows, dims=rs.dims,
                             start_date=rs.start_date,
                             unit_system=rs.unit_system,
                             requested=self.summary.requested_keys)
        if self._unrst_steps:
            eclsum.write_unrst(base, self._unrst_steps, dims=rs.dims,
                               start_date=rs.start_date)
        # static geology snapshot + geometry (writeInit role:
        # FlowMain.hpp writeInit -> EclipseIO INIT/EGRID)
        eclsum.write_init(base, self.grid, unit_system=rs.unit_system,
                          start_date=rs.start_date)
        if egrid_geometry(self.case) is not None:
            eclsum.write_egrid(base, self.case)
        with open(os.path.join(out, "fip_report.txt"), "w") as f:
            f.write("# FIPNUM  water[sm3]  oil[sm3]  gas[sm3]  (end of "
                    "run)\n")
            for r in range(fip_reg.shape[0]):
                f.write(f"{r + 1:6d}  {fip_reg[r, WATER]:.6e}  "
                        f"{fip_reg[r, OIL]:.6e}  "
                        f"{fip_reg[r, GAS]:.6e}\n")
        # per-step timing breakdown (step_timing.txt / walltime.txt,
        # SimulatorBase_impl.hpp:108,302-304)
        with open(os.path.join(out, "step_timing.txt"), "w") as f:
            f.write("# step  end_days  wall_s  substeps  newtons\n")
            for row in self._step_timing:
                f.write("%5d %10.2f %8.3f %5d %5d\n" % row)
        with open(os.path.join(out, "walltime.txt"), "w") as f:
            f.write(f"{self.report.total_time:.3f}\n")

    # ------------------------------------------------------------------
    def run(self, state: Optional[BlackoilState] = None, *,
            report_step_limit: Optional[int] = None, verbose: bool = False,
            restart_file: Optional[str] = None,
            restart_step: Optional[int] = None,
            write_restart: bool = False, write_vtk: bool = False,
            write_matlab: bool = False):
        """Run the schedule (per report step: wells, adaptive substeps,
        summary row, output). Returns the final state.

        restart_file resumes mid-run from a checkpoint: this package's
        .npz, or an ECL .UNRST with restart_step selecting the SEQNUM; a
        deck RESTART keyword does the same from BASENAME.UNRST (the
        RESTART/SKIPREST capability, SimulatorBase_impl.hpp:96-131,
        FlowMain.hpp:845-846). A restart_file that does not exist raises;
        a deck RESTART whose UNRST is missing starts from the initial
        state, as the reference does, with a warning on stdout and in the
        PRT. write_restart emits .npz checkpoints and the unified ECL
        restart per report step into output_dir; write_vtk and
        write_matlab the VTK and Matlab dumps."""
        t_start = time.perf_counter()
        nw = len(self.well_names)
        self._unrst_steps = []
        missing = None
        if restart_file is None and state is None \
                and self.case.solution.restart is not None:
            restart_file, restart_step, tried = self._deck_restart()
            if restart_file is None:
                missing = (f"deck RESTART {self.case.solution.restart[0]} "
                           f"{restart_step}: no restart file at "
                           f"{' or '.join(tried)}; starting from the "
                           "initial state")
        if restart_file is not None and not os.path.exists(restart_file):
            raise FileNotFoundError(f"restart file {restart_file} does not "
                                    "exist")
        writer = prt = None
        if self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            # async output worker (the reference's BlackoilOutputWriter
            # asyncOutput_ / ThreadHandle): report-step writes overlap the
            # next step's device work
            writer = ThreadHandle()
            prt = PrtLogger(os.path.join(self.output_dir,
                                         self._out_base() + ".PRT"),
                            self.case.runspec.title or "")
            for m in self.summary.unsupported:
                prt.warning(f"SUMMARY mnemonic not supported, ignored: {m}")
        if missing is not None:
            print(f"WARNING: {missing}")
            if prt is not None:
                prt.warning(missing)
        try:
            state = self._run_steps(state, nw, report_step_limit, verbose,
                                    restart_file, restart_step, writer, prt,
                                    write_restart, write_vtk, write_matlab)
            if writer is not None:
                writer.close()      # raises a write that failed
            self.report.total_time = time.perf_counter() - t_start
            if prt is not None:
                prt.final_report(self.report)
        finally:
            if writer is not None:
                # a run that failed: stop the worker (a write error it
                # raises here is chained to the run's)
                writer.close()
            if prt is not None:
                prt.close()
        if self.output_dir:
            self._write_run_outputs(state)
        return state

    def _run_steps(self, state, nw, report_step_limit, verbose,
                   restart_file, restart_step, writer, prt, write_restart,
                   write_vtk, write_matlab):
        start_step = 0
        if restart_file is not None:
            if restart_file.upper().endswith(".UNRST"):
                state, meta = restart.load_restart_unrst(
                    restart_file, restart_step, self.case, self.model)
            else:
                state, meta = restart.load_restart(restart_file,
                                                   self.device)
            start_step = meta["report_step"] + 1
            self.ts.suggested_dt = meta["suggested_dt"]
        elif state is None:
            state = initial_state(self.grid, self.props, self.case, nw)
        if self._thpres_default_pairs:
            self._thpres_defaults(state)
        steps = self.schedule.report_steps
        if report_step_limit is not None:
            steps = steps[:report_step_limit]
        steps = steps[start_step:]
        first = start_step == 0
        for step in steps:
            if step.geo_mods:
                self._apply_geo_modifiers(step.geo_mods)
            step_wells = self._step_wells_for(step)
            groups = None
            if step.groups and any(w.control == "GRUP" for w in step_wells):
                step_wells, groups = self._resolve_groups(step, step_wells,
                                                          state)
            ws = report_step_wells(step, self.grid, self.well_names,
                                   self.max_perf, wells=step_wells)
            wd = make_well_device_arrays(ws, self.grid.gravity, self.device)
            if groups:
                wd["groups"] = groups
            state = init_well_state(state, ws, first)
            first = False
            self._wire_vfp(wd, ws, state, step_wells)
            if np.any(np.isin(ws.control, (CTRL_RESV, CTRL_RESERVOIR_RATE))):
                state = self._resv_targets(ws, wd, state)

            def solve_fn(s, dt, _wd=wd):
                rep = SolverReport()
                s2, rep = self.solver.step(s, dt, _wd, report=rep)
                self.report.assemble_time += rep.assemble_time
                self.report.linear_solve_time += rep.linear_solve_time
                return s2, rep

            def _substep_cb(s, tl, dts, sr, _step=step):
                self.events.signal("timestep_completed", s, tl, dts)
                if prt is not None:
                    prt.substep(_step.index,
                                (_step.start_time + tl) / DAY, dts / DAY,
                                sr.iterations, sr.converged,
                                sr.convergence_history)

            def _fail_cb(tl, dts, exc, _step=step):
                if prt is not None:
                    prt.substep(_step.index,
                                (_step.start_time + tl) / DAY, dts / DAY,
                                0, False, None,
                                failure=type(exc).__name__)

            t_step0 = time.perf_counter()
            state, subrep = self.ts.step(
                solve_fn, state, step.end_time - step.start_time,
                had_event=bool(step.events), substep_callback=_substep_cb,
                failure_callback=_fail_cb)
            self._step_timing.append(
                (step.index, step.end_time / DAY,
                 time.perf_counter() - t_step0, subrep.substeps,
                 subrep.total_newton))
            self.events.signal("report_step_completed", state, step)
            self.report.substeps += subrep.substeps
            self.report.failed_substeps += subrep.failed_substeps
            self.report.newton_iterations += subrep.total_newton
            self.report.linear_iterations += subrep.total_linear
            row = self.summary.record(step.end_time, state, self.model,
                                      extra=self._thp_report_extra(state))
            if prt is not None:
                prt.report_step(step.index, step.end_time / DAY, row,
                                fip=[row["FWIP"], row["FOIP"],
                                     row["FGIP"]])
            self._check_econ_limits(step_wells, state, ws, wd)
            self._write_step_outputs(state, step, writer, write_restart,
                                     write_vtk, write_matlab)
            if verbose:
                print(f"step {step.index:4d} t={step.end_time / DAY:9.1f} d "
                      f"newton={subrep.total_newton:3d} "
                      f"FPR={row['FPR'] / 1e5:8.2f} bar "
                      f"FOPR={row['FOPR'] * DAY:10.1f} "
                      f"FGOR={row['FGOR']:8.2f}")
        return state


def run_deck(path: str, *, device="cuda", verbose=False, **kw):
    """flow-style entry: load the deck, build, run (``kw`` go to the
    simulator: params, ts_params, output_dir)."""
    case = load_case(path)
    sim = SimulatorFullyImplicitBlackoil(case, device=device, **kw)
    state = sim.run(verbose=verbose)
    return sim, state
