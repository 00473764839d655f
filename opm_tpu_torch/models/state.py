"""Simulation state container (port of the JAX package's models/state.py).

Primary variables follow the reference's switched scheme:
  p   — oil-phase pressure
  sw  — water saturation
  x   — sg (HC_GASOIL) | rs (HC_OILONLY) | rv (HC_GASONLY)
Well variables: qs (nw, 3) surface rates (injection positive) and bhp (nw,).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# hydroCarbonState enum (initHydroCarbonState.hpp:10-44)
HC_GASOIL = 0   # free gas and oil present: x = sg
HC_OILONLY = 1  # undersaturated oil, no free gas: x = rs
HC_GASONLY = 2  # no oil, vaporized oil in gas: x = rv

WATER, OIL, GAS = 0, 1, 2


class BlackoilState(NamedTuple):
    pressure: torch.Tensor   # (nc,) oil pressure [Pa]
    sw: torch.Tensor         # (nc,)
    x: torch.Tensor          # (nc,) sg | rs | rv
    hcstate: torch.Tensor    # (nc,) int32
    bhp: torch.Tensor        # (nw,) [Pa]
    qs: torch.Tensor         # (nw, 3) surface rates [m3/s], injection > 0
    control: torch.Tensor    # (nw,) int32 active control code
    target: torch.Tensor     # (nw,) active control target
    # hysteresis / VAPPARS memory (not ported yet; always None)
    sgmax: Optional[torch.Tensor] = None
    somax: Optional[torch.Tensor] = None

    @property
    def nc(self):
        return self.pressure.shape[0]

    @property
    def nw(self):
        return self.bhp.shape[0]


def saturations(state: BlackoilState):
    """(sw, so, sg) from switched primary variables."""
    is_sg = state.hcstate == HC_GASOIL
    is_rv = state.hcstate == HC_GASONLY
    sg = torch.where(is_sg, state.x,
                     torch.where(is_rv, 1.0 - state.sw, 0.0))
    so = 1.0 - state.sw - sg
    return state.sw, so, sg


def rs_rv(state: BlackoilState, props, pvtnum):
    """(rs, rv): saturated values where the respective phase is present."""
    is_rs = state.hcstate == HC_OILONLY
    is_rv = state.hcstate == HC_GASONLY
    rs = torch.where(is_rs, state.x, props.rs_sat(state.pressure, pvtnum))
    rv = torch.where(is_rv, state.x, props.rv_sat(state.pressure, pvtnum))
    return rs, rv


def init_hcstate(sw, sg, so=None, *, disgas=True, vapoil=False):
    """Classify cells (initHydroCarbonState.hpp:10-44)."""
    if so is None:
        so = 1.0 - sw - sg
    st = torch.full(sw.shape, HC_GASOIL, dtype=torch.int32, device=sw.device)
    if disgas:
        st = torch.where(sg <= 0.0, HC_OILONLY, st).to(torch.int32)
    if vapoil:
        st = torch.where(so <= 0.0, HC_GASONLY, st).to(torch.int32)
    return st
