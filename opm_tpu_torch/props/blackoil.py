"""BlackoilProps: the bundled fluid/rock property facade on tensors.

Port of the JAX package's props/blackoil.py. Phase indexing is canonical
(water=0, oil=1, gas=2). Each ``*_b_mu`` method returns (b, mu) of one
phase from one K1 lookup. ``cell_pack`` gives the ported tables as one
device buffer for kernel K2 (``csrc/cells.cu``), which evaluates the cell
quantities without going through these methods.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from opm_tpu_torch.props.pvt import (DeadPVT, LiveOilPVT, RockPVT, WaterPVT,
                                     WetGasPVT, _t)
from opm_tpu_torch.props.satfunc import SatFuncFamily1

WATER, OIL, GAS = 0, 1, 2

_NOT_PORTED = {
    "PVCDO": "dead oil with constant compressibility",
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
    gas_wet: Optional[WetGasPVT]
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
        dens = t.get("DENSITY", [dict(oil=600.0, water=1000.0, gas=1.0)])
        sd = _t([[d["water"], d["oil"], d["gas"]] for d in dens], device)
        gas = (DeadPVT.from_tables(t["PVDG"], device) if "PVDG" in t
               else _inert_gas_pvt(device)
               if "GAS" not in rs.phases and "PVTG" not in t else None)
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
            gas_wet=(WetGasPVT.from_tables(t["PVTG"], device)
                     if "PVTG" in t else None),
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
        if self.gas_wet is not None:
            return self.gas_wet.b_mu(p, rv, reg)
        return self.gas_dead.b_mu(p, reg)

    # -- saturated dissolution ratios ------------------------------------
    def rs_sat(self, p, reg):
        if self.disgas and self.oil_live is not None:
            return self.oil_live.rs_sat(p, reg)
        return torch.zeros_like(p)

    @property
    def rv_gas(self) -> Optional[WetGasPVT]:
        """PVTG where rv_sat is its saturated curve (VAPOIL), else None
        (rv_sat is 0)."""
        return self.gas_wet if self.vapoil else None

    def rv_sat(self, p, reg):
        if self.rv_gas is not None:
            return self.rv_gas.rv_sat(p, reg)
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

    # -- the packed form read by kernel K2 -----------------------------------
    def cell_pack(self) -> "CellPack":
        """The ported tables as K2's input, built once per props object."""
        if getattr(self, "_cell_pack", None) is None:
            self._cell_pack = CellPack(self)
        return self._cell_pack


class CellPack:
    """The tables of ``BlackoilProps`` as K2 reads them: one contiguous
    float64 buffer ``tab`` on the props' device and ``meta`` (and
    ``c_meta``, the same as a C int array), the offsets and sizes of each
    table in it, in the order of ``META`` (the field order of ``Layout``
    in csrc/pack.cuh). Per-region arrays keep
    their (nreg, ...) layout; K2 takes row 0 of a table with one region
    and the cell's PVTNUM/SATNUM row otherwise, as ``reg_pick`` and the
    lookups do."""

    META = ("live", "disgas", "rock",
            "w_nreg", "w_pref", "w_bref", "w_comp", "w_muref", "w_visc",
            "od_nreg", "od_n", "od_x", "od_y",
            "ol_nreg", "ol_nrec", "ol_ndp", "ol_rs", "ol_pbub", "ol_dp",
            "ol_grid",
            "g_nreg", "g_n", "g_x", "g_y",
            "s_nreg", "s_nw", "s_sw", "s_wc", "s_ng", "s_sg", "s_gc",
            "s_swco",
            "r_nreg", "r_pref", "r_comp",
            "d_nreg", "d_sd",
            # PVTG (wet gas; appended so the other offsets stay): wet when
            # the deck has it, vapoil when rv_sat is PVTG's curve
            "wet", "vapoil", "gw_nreg", "gw_nrec", "gw_nd", "gw_pg",
            "gw_rv", "gw_drv", "gw_grid")

    def __init__(self, props: BlackoilProps):
        missing = [name for name, t in (("PVTW", props.water),
                                        ("PVDO/PVTO", props.oil_dead
                                         or props.oil_live),
                                        ("PVDG/PVTG", props.gas_dead
                                         or props.gas_wet),
                                        ("SWOF/SGOF", props.satfunc))
                   if t is None]
        if missing:
            raise NotImplementedError(
                f"cell quantities without {', '.join(missing)} are not "
                "ported (ROADMAP Queue 1 item 2)")
        parts = []
        size = 0
        m = dict.fromkeys(self.META, 0)

        def add(t):
            nonlocal size
            a = t.detach().to("cpu", torch.float64).contiguous().reshape(-1)
            parts.append(a)
            size += a.numel()
            return size - a.numel()

        w = props.water
        m["w_nreg"] = w.p_ref.shape[0]
        for key, t in (("w_pref", w.p_ref), ("w_bref", w.b_ref),
                       ("w_comp", w.comp), ("w_muref", w.mu_ref),
                       ("w_visc", w.viscosibility)):
            m[key] = add(t)
        if props.oil_live is not None:
            lo = props.oil_live
            m["live"] = 1
            m["disgas"] = int(bool(props.disgas))
            m["ol_nreg"], m["ol_nrec"] = lo.rs_tab.shape
            m["ol_ndp"] = lo.dp_grid.shape[1]
            m["ol_rs"] = add(lo.rs_tab)
            m["ol_pbub"] = add(lo.pbub_tab)
            m["ol_dp"] = add(lo.dp_grid)
            m["ol_grid"] = add(lo.grids)
        else:
            od = props.oil_dead
            m["od_nreg"], m["od_n"] = od.p.shape
            m["od_x"] = add(od.p)
            m["od_y"] = add(od.cols)
        g = props.gas_dead
        if g is not None:
            m["g_nreg"], m["g_n"] = g.p.shape
            m["g_x"] = add(g.p)
            m["g_y"] = add(g.cols)
        sf = props.satfunc
        m["s_nreg"], m["s_nw"] = sf.sw.shape
        m["s_ng"] = sf.sg.shape[1]
        m["s_sw"] = add(sf.sw)
        m["s_wc"] = add(sf.w_cols)
        m["s_sg"] = add(sf.sg)
        m["s_gc"] = add(sf.g_cols)
        m["s_swco"] = add(sf.swco)
        if props.rock is not None:
            m["rock"] = 1
            m["r_nreg"] = props.rock.p_ref.shape[0]
            m["r_pref"] = add(props.rock.p_ref)
            m["r_comp"] = add(props.rock.comp)
        m["d_nreg"] = props.surface_density.shape[0]
        m["d_sd"] = add(props.surface_density)
        gw = props.gas_wet
        if gw is not None:
            m["wet"] = 1
            m["vapoil"] = int(props.rv_gas is not None)
            m["gw_nreg"], m["gw_nrec"] = gw.pg_tab.shape
            m["gw_nd"] = gw.drv_grid.shape[1]
            m["gw_pg"] = add(gw.pg_tab)
            m["gw_rv"] = add(gw.rv_sat_tab)
            m["gw_drv"] = add(gw.drv_grid)
            m["gw_grid"] = add(gw.grids)
        self.tab = torch.cat(parts).to(props.device)
        self.meta = [int(m[k]) for k in self.META]
        # the layout as the C array K2's entry points read
        self.c_meta = (ctypes.c_int * len(self.meta))(*self.meta)
