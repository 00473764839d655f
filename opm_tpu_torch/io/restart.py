"""Checkpoint / restart (port of the JAX package's io/restart.py).

The reference writes ECL-format restart files each report step and can
resume mid-run (BlackoilOutputWriter::writeTimeStep / initFromRestartFile,
opm/autodiff/SimulatorFullyImplicitBlackoilOutput.hpp:229-288, restart
regression tests in compareECLFiles.cmake:123-136). The full solution state
and the stepper state are checkpointed as .npz; a run also resumes from an
ECL unified-restart file (UNRST) through ``load_restart_unrst``.

The writers take numpy arrays (the driver pulls the state to the host
first); the loaders return port states on the device they are given.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from opm_tpu_torch.models.state import (HC_GASOIL, HC_OILONLY, BlackoilState,
                                        init_hcstate)
from opm_tpu_torch.utils.convert import state_from_numpy

FORMAT_VERSION = 1


def save_restart(path: str, state: dict, *, report_step: int, time: float,
                 suggested_dt: float, extra: Optional[dict] = None):
    """Write the .npz checkpoint of ``state``, a dict of numpy arrays named
    as BlackoilState's fields (``utils/convert.state_to_numpy``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = dict(
        version=FORMAT_VERSION, report_step=report_step, time=time,
        suggested_dt=suggested_dt,
        **{k: np.asarray(state[k]) for k in
           ("pressure", "sw", "x", "hcstate", "bhp", "qs", "control",
            "target")})
    for k in ("sgmax", "somax"):
        if state.get(k) is not None:
            payload[k] = np.asarray(state[k])
    if extra:
        for k, v in extra.items():
            payload["extra_" + k] = np.asarray(v)
    np.savez_compressed(path, **payload)


def load_restart(path: str, device):
    """Returns (state on ``device``, meta dict)."""
    z = np.load(path)
    state = state_from_numpy({k: z[k] for k in z.files
                              if k in BlackoilState._fields}, device)
    meta = dict(report_step=int(z["report_step"]), time=float(z["time"]),
                suggested_dt=float(z["suggested_dt"]))
    meta["extra"] = {k[6:]: z[k] for k in z.files if k.startswith("extra_")}
    return state, meta


def pressure_unit(unit_system: str) -> float:
    """Deck pressure units per Pa of the UNRST PRESSURE array (bar for
    METRIC, psia otherwise, as the writer stores it)."""
    return 1e-5 if unit_system == "METRIC" else 1.0 / 6894.757293168361


def load_restart_unrst(path: str, report_step: int, case, model):
    """Resume from an ECL unified-restart file (the reference's
    initFromRestartFile path, SimulatorFullyImplicitBlackoilOutput.hpp:
    229-288 + FlowMain.hpp:845-846 RESTART/SKIPREST): rebuild the switched
    primary-variable state from PRESSURE/SWAT/SGAS/RS/RV, re-derive the
    hydroCarbonState classification (initHydroCarbonState), and recover
    well state + suggested dt from the OPM_XWEL/OPM_EXTRA extra arrays
    written by this package's writer.

    The arrays are expanded and the pressure converted to SI on the host
    (numpy's division, as the reference's); the classification runs on
    ``model.device``. Returns (state, meta) like load_restart."""
    from opm_tpu_torch.io.eclsum import read_unrst

    steps = read_unrst(path)
    match = [s for s in steps if s["seqnum"] == report_step]
    if not match:
        raise FileNotFoundError(
            f"report step {report_step} not in {path} "
            f"(has {[s['seqnum'] for s in steps]})")
    st = match[-1]
    p_unit = pressure_unit(case.runspec.unit_system)
    dev = model.device

    grid = model.grid
    if grid.active_mask is not None:
        # embedded grid: file arrays cover the real active cells; padding
        # cells read through the donor map (grid.global_cell), exactly as
        # at initialization
        rc = grid.real_cells

        def expand(a):
            tmp = np.zeros(grid.nc)
            tmp[rc] = np.asarray(a)
            return tmp[np.asarray(grid.global_cell)]
    else:
        def expand(a):
            return np.asarray(a)

    def f64(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                               device=dev)

    p = f64(np.asarray(expand(st["PRESSURE"])) / p_unit)
    sw = f64(expand(st["SWAT"]))
    sg = f64(expand(st["SGAS"]))
    rs = f64(expand(st.get("RS", np.zeros_like(st["SWAT"]))))
    rv = f64(expand(st.get("RV", np.zeros_like(st["SWAT"]))))
    hc = init_hcstate(sw, sg, disgas=case.runspec.disgas,
                      vapoil=case.runspec.vapoil)
    x = torch.where(hc == HC_GASOIL, sg,
                    torch.where(hc == HC_OILONLY, rs, rv))
    xwel = np.asarray(st.get("OPM_XWEL", np.zeros(0)))
    nw = xwel.shape[0] // 6 if xwel.size else 0
    xwel = xwel.reshape(nw, 6) if nw else np.zeros((0, 6))
    state = BlackoilState(
        pressure=p, sw=sw, x=x, hcstate=hc,
        bhp=f64(xwel[:, 0]), qs=f64(xwel[:, 1:4]),
        control=torch.as_tensor(xwel[:, 4].astype(np.int32), device=dev),
        target=f64(xwel[:, 5]))
    extra = np.asarray(st.get("OPM_EXTRA", [86400.0]))
    meta = dict(report_step=int(st["seqnum"]),
                time=float(st["time_days"]) * 86400.0,
                suggested_dt=float(extra[0]), extra={})
    return state, meta
