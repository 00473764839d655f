"""BlackoilProps: the bundled fluid/rock property facade on tensors.

Port of the JAX package's props/blackoil.py. Phase indexing is canonical
(water=0, oil=1, gas=2). Each ``*_b_mu`` method returns (b, mu) of one
phase from one K1 lookup.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from opm_tpu_torch.props.pvt import (DeadPVT, LiveOilPVT, RockPVT, WaterPVT,
                                     _t)
from opm_tpu_torch.props.satfunc import SatFuncFamily1

WATER, OIL, GAS = 0, 1, 2

_NOT_PORTED = {
    "PVCDO": "dead oil with constant compressibility",
    "PVTG": "wet gas",
    "ROCKTAB": "tabulated rock compaction",
    "VAPPARS": "VAPPARS",
}


def _inert_gas_pvt(device):
    """Placeholder gas PVT for two-phase (water-oil) decks: B = 1,
    mu = 0.02 cp (the reference's construction)."""
    return DeadPVT.from_tables(
        [np.array([[1.0e5, 1.0, 2.0e-5], [1.0e8, 1.0, 2.0e-5]])], device)


@dataclass
class BlackoilProps:
    phases: tuple
    disgas: bool
    vapoil: bool
    surface_density: torch.Tensor      # (nreg, 3) order (w, o, g)
    water: Optional[WaterPVT]
    oil_dead: Optional[DeadPVT]
    oil_live: Optional[LiveOilPVT]
    gas_dead: Optional[DeadPVT]
    rock: Optional[RockPVT]
    satfunc: Optional[SatFuncFamily1]
    device: torch.device = torch.device("cpu")

    @classmethod
    def from_case(cls, case, device):
        device = torch.device(device)
        t = case.tables
        rs = case.runspec
        for kw, what in _NOT_PORTED.items():
            if kw in t:
                raise NotImplementedError(
                    f"{kw} ({what}) is not ported yet "
                    "(ROADMAP Queue 1 items 2 and 8)")
        if rs.vapoil:
            raise NotImplementedError(
                "VAPOIL is not ported yet (ROADMAP Queue 1 item 8)")
        dens = t.get("DENSITY", [dict(oil=600.0, water=1000.0, gas=1.0)])
        sd = _t([[d["water"], d["oil"], d["gas"]] for d in dens], device)
        gas = (DeadPVT.from_tables(t["PVDG"], device) if "PVDG" in t
               else _inert_gas_pvt(device) if "GAS" not in rs.phases
               else None)
        return cls(
            phases=rs.phases, disgas=rs.disgas, vapoil=rs.vapoil,
            surface_density=sd,
            water=(WaterPVT.from_tables(t["PVTW"], device)
                   if "PVTW" in t else None),
            oil_dead=(DeadPVT.from_tables(t["PVDO"], device)
                      if "PVDO" in t else None),
            oil_live=(LiveOilPVT.from_tables(t["PVTO"], device)
                      if "PVTO" in t else None),
            gas_dead=gas,
            rock=RockPVT.from_tables(t["ROCK"], device) if "ROCK" in t
            else None,
            satfunc=SatFuncFamily1.from_case(case, device),
            device=device)

    # -- (b, mu) per phase -------------------------------------------------
    def water_b_mu(self, p, reg):
        return self.water.b(p, reg), self.water.mu(p, reg)

    def oil_b_mu(self, p, rs, reg):
        if self.oil_live is not None:
            return self.oil_live.b_mu(p, rs, reg)
        return self.oil_dead.b_mu(p, reg)

    def gas_b_mu(self, p, rv, reg):
        return self.gas_dead.b_mu(p, reg)

    # -- saturated dissolution ratios ------------------------------------
    def rs_sat(self, p, reg):
        if self.disgas and self.oil_live is not None:
            return self.oil_live.rs_sat(p, reg)
        return torch.zeros_like(p)

    def rv_sat(self, p, reg):
        return torch.zeros_like(p)

    # -- phase mass densities at reservoir conditions ---------------------
    def rho_water(self, p, reg):
        return self.surface_density[reg, WATER] * self.water.b(p, reg)

    def rho_oil(self, p, rs, reg):
        return ((self.surface_density[reg, OIL]
                 + rs * self.surface_density[reg, GAS])
                * self.oil_b_mu(p, rs, reg)[0])

    def rho_gas(self, p, rv, reg):
        return ((self.surface_density[reg, GAS]
                 + rv * self.surface_density[reg, OIL])
                * self.gas_b_mu(p, rv, reg)[0])

    # -- rock --------------------------------------------------------------
    def pv_mult(self, p, reg):
        if self.rock is None:
            return torch.ones_like(p)
        return self.rock.pv_mult(p, reg)
