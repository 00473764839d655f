"""Numpy <-> port tensors, so that tests can hand both packages the same
arrays (states and static model data taken from the JAX package with
``np.asarray``). Arrays are copied: the JAX package's are read-only."""

from __future__ import annotations

import numpy as np
import torch

from opm_tpu_torch.models.state import BlackoilState

_STATE_INT = {"hcstate", "control"}


def state_from_numpy(d, device) -> BlackoilState:
    """A BlackoilState from a dict of numpy arrays (field names as in
    models/state.py; sgmax/somax may be absent or None)."""
    dev = torch.device(device)
    out = {}
    for name in BlackoilState._fields:
        a = d.get(name)
        if a is None:
            out[name] = None
        elif name in _STATE_INT:
            out[name] = torch.tensor(np.asarray(a, dtype=np.int32),
                                        device=dev)
        else:
            out[name] = torch.tensor(np.asarray(a, dtype=np.float64),
                                        device=dev)
    return BlackoilState(**out)


def state_to_numpy(state: BlackoilState) -> dict:
    return {name: (None if getattr(state, name) is None
                   else getattr(state, name).detach().cpu().numpy())
            for name in BlackoilState._fields}


_WD_BOOL = {"is_injector", "is_history"}
_WD_INT = {"perf_cell": torch.long, "primary_control": torch.int32}


def model_arrays_from_numpy(d, device) -> dict:
    """pv, trans, face_cells, depth, pvtnum, satnum and the padded well
    dict ``wd`` from numpy arrays, as the port's model and residual hold
    them."""
    dev = torch.device(device)

    def f64(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)

    out = dict(
        pv=f64(d["pv"]), trans=f64(d["trans"]), depth=f64(d["depth"]),
        face_cells=torch.tensor(np.asarray(d["face_cells"]),
                                   dtype=torch.long, device=dev),
        pvtnum=torch.tensor(np.asarray(d["pvtnum"]), dtype=torch.long,
                               device=dev),
        satnum=torch.tensor(np.asarray(d["satnum"]), dtype=torch.long,
                               device=dev))
    if "wd" in d:
        wd = {}
        for k, a in d["wd"].items():
            a = np.asarray(a)
            if k in _WD_BOOL:
                wd[k] = torch.tensor(a.astype(bool), device=dev)
            elif k in _WD_INT:
                wd[k] = torch.tensor(a, dtype=_WD_INT[k], device=dev)
            else:
                wd[k] = f64(a)
        out["wd"] = wd
    return out
