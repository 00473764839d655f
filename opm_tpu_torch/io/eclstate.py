"""EclipseCase: interpreted, SI-converted view of a parsed deck.

Plays the role of opm-common's EclipseState + TableManager for the rebuild
(consumed by the reference at opm/autodiff/FlowMain.hpp:553
setupGridAndProps and BlackoilPropsAdFromDeck). Grid-section array processing
implements BOX/ENDBOX/EQUALS/COPY/ADD/MULTIPLY semantics.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from opm_tpu_torch.io.deck import DEFAULT, Deck, parse_deck, parse_deck_string
from opm_tpu_torch.utils.units import UnitSystem
from opm_tpu_torch.wells.vfp import parse_vfp_tables

# dimension of each grid-property array (for unit conversion, incl. via EQUALS)
_ARRAY_DIMS = {
    "DX": "Length", "DY": "Length", "DZ": "Length", "TOPS": "Length",
    "DXV": "Length", "DYV": "Length", "DZV": "Length", "DEPTHZ": "Length",
    "PERMX": "Permeability", "PERMY": "Permeability", "PERMZ": "Permeability",
    "PORO": "1", "NTG": "1", "ACTNUM": "1", "MULTX": "1", "MULTY": "1",
    "MULTZ": "1", "MULTX-": "1", "MULTY-": "1", "MULTZ-": "1", "MULTPV": "1",
    "PRESSURE": "Pressure", "SWAT": "1", "SGAS": "1", "SOIL": "1",
    "RS": "GasSurfaceVolume/LiquidSurfaceVolume",
    "RV": "LiquidSurfaceVolume/GasSurfaceVolume",
    "SATNUM": "1", "PVTNUM": "1", "EQLNUM": "1", "FIPNUM": "1",
    "IMBNUM": "1",
    "SWL": "1", "SWU": "1", "SGL": "1", "SGU": "1", "SWCR": "1", "SGCR": "1",
    "SOWCR": "1", "SOGCR": "1", "SWATINIT": "1", "MINPVV": "Length",
    "KRW": "1", "KRO": "1", "KRG": "1",
    "PCW": "Pressure", "PCG": "Pressure", "ROCKNUM": "1",
    "ZCORN": "Length", "COORD": "Length",
}

_MONTHS = {m: i + 1 for i, m in enumerate(
    ["JAN", "FEB", "MAR", "APR", "MAY", "JUN",
     "JLY", "AUG", "SEP", "OCT", "NOV", "DEC"])}
_MONTHS["JUL"] = 7


def _val(rec, i, default=None):
    if rec is not None and i < len(rec) and rec[i] is not DEFAULT:
        return rec[i]
    return default


@dataclass
class Runspec:
    dims: tuple = (1, 1, 1)
    phases: tuple = ("OIL", "WATER", "GAS")
    disgas: bool = False
    vapoil: bool = False
    polymer: bool = False
    unit_system: str = "METRIC"
    start_date: datetime.datetime = datetime.datetime(1983, 1, 1)
    title: str = ""

    @property
    def num_phases(self):
        return len(self.phases)


@dataclass
class EquilRecord:
    """EQUIL keyword record (SI). Reference consumer:
    opm/core/simulator/initStateEquil.hpp:233."""
    datum_depth: float = 0.0
    datum_pressure: float = 0.0
    woc_depth: float = 0.0
    woc_pc: float = 0.0
    goc_depth: float = 0.0
    goc_pc: float = 0.0
    rs_init: int = 0   # live-oil init: 0 => RS = RsSat at Pb=p; >0 => RSVD table
    rv_init: int = 0
    n_accuracy: int = -5


@dataclass
class Solution:
    equil: List[EquilRecord] = field(default_factory=list)
    rsvd: List[np.ndarray] = field(default_factory=list)   # per eql region (depth, rs)
    rvvd: List[np.ndarray] = field(default_factory=list)
    pbvd: List[np.ndarray] = field(default_factory=list)
    pdvd: List[np.ndarray] = field(default_factory=list)   # dew point vs depth
    pressure: Optional[np.ndarray] = None
    swat: Optional[np.ndarray] = None
    sgas: Optional[np.ndarray] = None
    rs: Optional[np.ndarray] = None
    rv: Optional[np.ndarray] = None
    thpres: List[tuple] = field(default_factory=list)
    # deck RESTART: (basename, report_step) to resume from; SKIPREST
    # fast-forwards the schedule to that step (FlowMain.hpp:845-846)
    restart: Optional[tuple] = None
    skiprest: bool = False


class EclipseCase:
    """Structured, SI-unit view of a deck."""

    def __init__(self, deck: Deck):
        self.deck = deck
        self.path: Optional[str] = None   # deck file path (load_case)
        self.runspec = self._parse_runspec(deck)
        self.units = UnitSystem(self.runspec.unit_system)
        self.grid_arrays: Dict[str, np.ndarray] = {}
        # geology surface beyond plain arrays (GeoProps.hpp:140-160):
        # named fault face sets + their multipliers, and explicit NNCs
        self.faults: Dict[str, list] = {}       # name -> [(box6, face_str)]
        self.fault_mults: Dict[str, float] = {}  # name -> multiplier
        self.nncs: list = []                     # [(g1, g2, trans_SI)]
        self._parse_grid_section(deck)
        self.tables = self._parse_props(deck)
        self.regions = self._parse_regions(deck)
        self.solution = self._parse_solution(deck)
        self.summary_requests = self._parse_summary(deck)
        # VFPPROD/VFPINJ tables, SI, float64 tensors on the CPU (the
        # simulator puts them on its device)
        self.vfp_tables = parse_vfp_tables(deck, self.units)

    # ------------------------------------------------------------------
    def _parse_runspec(self, deck: Deck) -> Runspec:
        rs = Runspec()
        names = [kw.name for kw in deck]
        phases = []
        for ph in ("WATER", "OIL", "GAS"):
            if ph in names:
                phases.append(ph)
        if not phases:
            phases = ["WATER", "OIL"]
        rs.phases = tuple(phases)
        rs.disgas = "DISGAS" in names
        rs.vapoil = "VAPOIL" in names
        rs.polymer = "POLYMER" in names
        for sysname in ("METRIC", "FIELD", "LAB"):
            if sysname in names:
                rs.unit_system = sysname
        kw = deck.get("DIMENS")
        if kw:
            r = kw.records[0]
            rs.dims = (int(r[0]), int(r[1]), int(r[2]))
        kw = deck.get("START")
        if kw and kw.records:
            rs.start_date = _parse_date(kw.records[0])
        kw = deck.get("TITLE")
        if kw and kw.records:
            rs.title = str(kw.records[0][0])
        return rs

    # ------------------------------------------------------------------
    def _parse_grid_section(self, deck: Deck):
        nx, ny, nz = self.runspec.dims
        ncg = nx * ny * nz
        arrays = self.grid_arrays
        u = UnitSystem(self.runspec.unit_system)
        box = [0, nx - 1, 0, ny - 1, 0, nz - 1]

        def box_slice(b):
            ii = np.arange(b[0], b[1] + 1)
            jj = np.arange(b[2], b[3] + 1)
            kk = np.arange(b[4], b[5] + 1)
            K, J, I = np.meshgrid(kk, jj, ii, indexing="ij")
            return (K * ny * nx + J * nx + I).ravel()

        def ensure(name, fill=0.0):
            if name not in arrays:
                dtype = np.int64 if name in ("ACTNUM", "SATNUM", "PVTNUM",
                                             "EQLNUM", "FIPNUM",
                                             "IMBNUM") else np.float64
                arrays[name] = np.full(ncg, fill, dtype=dtype)
            return arrays[name]

        sections = _section_spans(deck)
        for kw in deck:
            in_grid = sections.get(id(kw)) in ("GRID", "EDIT", "REGIONS",
                                               "SOLUTION", "PROPS")
            if not in_grid:
                continue
            name = kw.name
            if name == "BOX":
                r = kw.records[0]
                box = [int(_val(r, 0, 1)) - 1, int(_val(r, 1, nx)) - 1,
                       int(_val(r, 2, 1)) - 1, int(_val(r, 3, ny)) - 1,
                       int(_val(r, 4, 1)) - 1, int(_val(r, 5, nz)) - 1]
            elif name == "ENDBOX":
                box = [0, nx - 1, 0, ny - 1, 0, nz - 1]
            elif kw.array is not None and name in _ARRAY_DIMS:
                fac = u.factor(_ARRAY_DIMS[name])
                vals = kw.array.astype(np.float64) * fac
                if name in ("DXV",):
                    arrays[name] = vals
                    continue
                if name in ("DYV", "DZV", "ZCORN", "COORD", "DEPTHZ"):
                    arrays[name] = vals
                    continue
                if name == "TOPS":
                    # keep raw: TOPS usually covers only the top layer(s);
                    # deeper layers are stacked from DZ in build_grid
                    arrays[name] = vals
                    continue
                idx = box_slice(box)
                if len(vals) < len(idx):
                    idx = idx[: len(vals)]
                a = ensure(name, 1.0 if name.startswith(("MULT", "NTG", "ACTNUM")) else 0.0)
                if a.dtype == np.int64:
                    a[idx] = vals[: len(idx)].astype(np.int64)
                else:
                    a[idx] = vals[: len(idx)]
            elif name == "EQUALS":
                for r in kw.records:
                    tgt = str(r[0]).upper()
                    value = float(r[1])
                    b = _rec_box(r, 2, box)
                    fac = u.factor(_ARRAY_DIMS.get(tgt, "1"))
                    a = ensure(tgt, 1.0 if tgt.startswith(("MULT", "NTG")) else 0.0)
                    a[box_slice(b)] = value * fac
            elif name == "COPY":
                for r in kw.records:
                    src, dst = str(r[0]).upper(), str(r[1]).upper()
                    b = _rec_box(r, 2, box)
                    idx = box_slice(b)
                    sa = ensure(src)
                    da = ensure(dst)
                    da[idx] = sa[idx]
            elif name == "ADD":
                for r in kw.records:
                    tgt = str(r[0]).upper()
                    value = float(r[1]) * u.factor(_ARRAY_DIMS.get(tgt, "1"))
                    b = _rec_box(r, 2, box)
                    ensure(tgt)[box_slice(b)] += value
            elif name == "MULTIPLY":
                for r in kw.records:
                    tgt = str(r[0]).upper()
                    value = float(r[1])
                    b = _rec_box(r, 2, box)
                    ensure(tgt)[box_slice(b)] *= value
            elif name == "FAULTS":
                # named fault face sets (opm-common FaultCollection role):
                # NAME ix1 ix2 iy1 iy2 iz1 iz2 FACE
                for r in kw.records:
                    fname = str(r[0]).upper()
                    b = [int(r[1]) - 1, int(r[2]) - 1, int(r[3]) - 1,
                         int(r[4]) - 1, int(r[5]) - 1, int(r[6]) - 1]
                    face = str(r[7]).upper()
                    self.faults.setdefault(fname, []).append((b, face))
            elif name == "MULTFLT":
                # NAME multiplier — later records override (TransMult role)
                for r in kw.records:
                    self.fault_mults[str(r[0]).upper()] = float(r[1])
            elif name == "NNC":
                # explicit non-neighbor connections with deck trans
                # (GeoProps.hpp:140-160 NNC trans; AutoDiffHelpers.hpp:60-90)
                tf = u.factor("Transmissibility")
                for r in kw.records:
                    i1, j1, k1 = int(r[0]) - 1, int(r[1]) - 1, int(r[2]) - 1
                    i2, j2, k2 = int(r[3]) - 1, int(r[4]) - 1, int(r[5]) - 1
                    t = float(_val(r, 6, 0.0)) * tf
                    g1 = (k1 * ny + j1) * nx + i1
                    g2 = (k2 * ny + j2) * nx + i2
                    self.nncs.append((g1, g2, t))

        # defaults
        if "ACTNUM" not in arrays:
            arrays["ACTNUM"] = np.ones(ncg, dtype=np.int64)
        if "NTG" not in arrays:
            arrays["NTG"] = np.ones(ncg)
        for m in ("MULTX", "MULTY", "MULTZ", "MULTPV"):
            if m not in arrays:
                arrays[m] = np.ones(ncg)
        if "PERMY" not in arrays and "PERMX" in arrays:
            arrays["PERMY"] = arrays["PERMX"].copy()
        if "PERMZ" not in arrays and "PERMX" in arrays:
            arrays["PERMZ"] = arrays["PERMX"].copy()
        minpv_kw = deck.get("MINPV")
        self.minpv = (float(_val(minpv_kw.records[0], 0, 1e-6)) *
                      u.factor("ReservoirVolume")) if minpv_kw else 1e-6

    # ------------------------------------------------------------------
    def _parse_props(self, deck: Deck) -> dict:
        u = self.units
        t: dict = {}
        p_f = u.factor("Pressure")
        visc_f = u.factor("Viscosity")
        lsv = u.factor("LiquidSurfaceVolume")
        gsv = u.factor("GasSurfaceVolume")
        rv_f = u.factor("ReservoirVolume")
        rs_f = gsv / lsv   # Mscf/stb -> sm3/sm3
        rvv_f = lsv / gsv
        bo_f = rv_f / lsv  # rb/stb
        bg_f = rv_f / gsv  # rb/Mscf
        dens_f = u.factor("Density")

        kw = deck.get("PVTW")
        if kw:
            t["PVTW"] = []
            for r in kw.records:
                t["PVTW"].append(dict(
                    p_ref=_val(r, 0, 1.0) * p_f,
                    b_ref=_val(r, 1, 1.0) * bo_f,
                    comp=_val(r, 2, 0.0) / p_f,
                    mu_ref=_val(r, 3, 0.5) * visc_f,
                    viscosibility=_val(r, 4, 0.0) / p_f,
                ))
        kw = deck.get("PVCDO")
        if kw:
            t["PVCDO"] = []
            for r in kw.records:
                t["PVCDO"].append(dict(
                    p_ref=_val(r, 0, 1.0) * p_f,
                    b_ref=_val(r, 1, 1.0) * bo_f,
                    comp=_val(r, 2, 0.0) / p_f,
                    mu_ref=_val(r, 3, 1.0) * visc_f,
                    viscosibility=_val(r, 4, 0.0) / p_f,
                ))
        kw = deck.get("PVDG")
        if kw:
            t["PVDG"] = []
            for r in kw.records:
                a = np.asarray([x for x in r if x is not DEFAULT],
                               dtype=np.float64).reshape(-1, 3)
                a[:, 0] *= p_f
                a[:, 1] *= bg_f
                a[:, 2] *= visc_f
                t["PVDG"].append(a)
        kw = deck.get("PVDO")
        if kw:
            t["PVDO"] = []
            for r in kw.records:
                a = np.asarray(r, dtype=np.float64).reshape(-1, 3)
                a[:, 0] *= p_f
                a[:, 1] *= bo_f
                a[:, 2] *= visc_f
                t["PVDO"].append(a)
        kw = deck.get("PVTO")
        if kw:
            t["PVTO"] = []
            for region in kw.records:
                recs = []
                for r in region:
                    vals = np.asarray(r, dtype=np.float64)
                    rs = vals[0] * rs_f
                    rest = vals[1:].reshape(-1, 3)
                    rest[:, 0] *= p_f
                    rest[:, 1] *= bo_f
                    rest[:, 2] *= visc_f
                    recs.append((rs, rest))
                t["PVTO"].append(recs)
        kw = deck.get("VAPPARS")
        if kw and kw.records:
            r = kw.records[0]
            # item 1: oil vaporization (rv) exponent, item 2: gas
            # dissolution (rs) exponent (BlackoilPropsAdFromDeck.cpp:170)
            t["VAPPARS"] = (float(_val(r, 0, 0.0)), float(_val(r, 1, 0.0)))
        kw = deck.get("PVTG")
        if kw:
            t["PVTG"] = []
            for region in kw.records:
                recs = []
                for r in region:
                    vals = np.asarray(r, dtype=np.float64)
                    pg = vals[0] * p_f
                    rest = vals[1:].reshape(-1, 3)
                    rest[:, 0] *= rvv_f
                    rest[:, 1] *= bg_f
                    rest[:, 2] *= visc_f
                    recs.append((pg, rest))
                t["PVTG"].append(recs)
        # thermal keywords (ThermalWaterPvtWrapper / ThermalOilPvtWrapper,
        # opm/core/props/pvt/Thermal*PvtWrapper.hpp):
        # VISCREF reference pressure, *VISCT temperature-viscosity tables,
        # WATDENT / THERMEX1 thermal expansion
        def to_kelvin(a):
            us = self.runspec.unit_system
            a = np.asarray(a, dtype=np.float64)
            if us == "FIELD":
                return (a - 32.0) * (5.0 / 9.0) + 273.15
            if us == "LAB":
                return a + 273.15
            return a + 273.15      # METRIC degC
        kw = deck.get("VISCREF")
        if kw:
            t["VISCREF"] = [dict(p_ref=_val(r, 0, 1.0) * p_f,
                                 rs_ref=_val(r, 1, 0.0) * rs_f)
                            for r in kw.records]
        for name in ("OILVISCT", "WATVISCT", "GASVISCT"):
            kw = deck.get(name)
            if kw:
                t[name] = []
                for r in kw.records:
                    a = np.asarray(r, dtype=np.float64).reshape(-1, 2)
                    a[:, 0] = to_kelvin(a[:, 0])
                    a[:, 1] *= visc_f
                    t[name].append(a)
        kw = deck.get("WATDENT")
        if kw:
            t["WATDENT"] = [dict(t_ref=to_kelvin(_val(r, 0, 20.0)),
                                 c1=_val(r, 1, 3e-4) * (9.0 / 5.0 if
                                 self.runspec.unit_system == "FIELD"
                                 else 1.0),
                                 c2=_val(r, 2, 3e-6) * ((9.0 / 5.0) ** 2 if
                                 self.runspec.unit_system == "FIELD"
                                 else 1.0))
                            for r in kw.records]
        kw = deck.get("THERMEX1")
        if kw:
            c = _val(kw.records[0], 0, 0.0)
            if self.runspec.unit_system == "FIELD":
                c *= 9.0 / 5.0
            t["THERMEX1"] = c
            tr = deck.get("TREF")
            t["TREF"] = to_kelvin(_val(tr.records[0], 0, 20.0)) if tr \
                else 293.15
        kw = deck.get("RTEMP") or deck.get("RTEMPA")
        if kw:
            t["RTEMP"] = float(to_kelvin(_val(kw.records[0], 0, 15.56)))

        kw = deck.get("ROCKTAB")
        if kw:
            # (p, pv_mult, trans_mult) per ROCKNUM region
            t["ROCKTAB"] = []
            for r in kw.records:
                a = np.asarray([x for x in r if x is not DEFAULT],
                               dtype=np.float64).reshape(-1, 3)
                a[:, 0] *= p_f
                t["ROCKTAB"].append(a)
        kw = deck.get("ROCK")
        if kw:
            t["ROCK"] = [dict(p_ref=_val(r, 0, 1.0) * p_f,
                              comp=_val(r, 1, 0.0) / p_f) for r in kw.records]
        kw = deck.get("DENSITY")
        if kw:
            t["DENSITY"] = [dict(oil=_val(r, 0, 600.0) * dens_f,
                                 water=_val(r, 1, 1000.0) * dens_f,
                                 gas=_val(r, 2, 1.0) * dens_f)
                            for r in kw.records]
        for name in ("SWOF", "SGOF", "SLGOF"):
            kw = deck.get(name)
            if kw:
                t[name] = []
                for r in kw.records:
                    a = np.asarray([x for x in r if x is not DEFAULT],
                                   dtype=np.float64).reshape(-1, 4)
                    a[:, 3] *= p_f
                    t[name].append(a)
        for name in ("SWFN", "SGFN"):
            kw = deck.get(name)
            if kw:
                t[name] = []
                for r in kw.records:
                    a = np.asarray(r, dtype=np.float64).reshape(-1, 3)
                    a[:, 2] *= p_f
                    t[name].append(a)
        for name, ncol in (("SOF2", 2), ("SOF3", 3)):
            kw = deck.get(name)
            if kw:
                t[name] = [np.asarray(r, dtype=np.float64).reshape(-1, ncol)
                           for r in kw.records]
        # polymer tables
        kw = deck.get("PLYVISC")
        if kw:
            t["PLYVISC"] = [np.asarray(r, dtype=np.float64).reshape(-1, 2)
                            * np.array([u.factor("PolymerDensity"), 1.0])
                            for r in kw.records]
        kw = deck.get("PLYROCK")
        if kw:
            t["PLYROCK"] = [dict(dead_pore_vol=_val(r, 0, 0.0),
                                 res_rrf=_val(r, 1, 1.0),
                                 rock_density=_val(r, 2, 1000.0) * dens_f,
                                 adsorption_index=int(_val(r, 3, 1)),
                                 max_ads=_val(r, 4, 0.0))
                            for r in kw.records]
        kw = deck.get("PLYADS")
        if kw:
            t["PLYADS"] = [np.asarray(r, dtype=np.float64).reshape(-1, 2)
                           * np.array([u.factor("PolymerDensity"), 1.0])
                           for r in kw.records]
        kw = deck.get("PLYMAX")
        if kw:
            t["PLYMAX"] = [dict(c_max=_val(r, 0, 0.0) * u.factor("PolymerDensity"))
                           for r in kw.records]
        kw = deck.get("TLMIXPAR")
        if kw:
            t["TLMIXPAR"] = [dict(omega=_val(r, 0, 1.0)) for r in kw.records]
        return t

    # ------------------------------------------------------------------
    def _parse_regions(self, deck: Deck) -> dict:
        ncg = int(np.prod(self.runspec.dims))
        out = {}
        for name in ("SATNUM", "PVTNUM", "EQLNUM", "FIPNUM"):
            if name in self.grid_arrays:
                out[name] = self.grid_arrays[name].astype(np.int64)
            else:
                out[name] = np.ones(ncg, dtype=np.int64)
        if "IMBNUM" in self.grid_arrays:
            out["IMBNUM"] = self.grid_arrays["IMBNUM"].astype(np.int64)
        return out

    # ------------------------------------------------------------------
    def _parse_solution(self, deck: Deck) -> Solution:
        u = self.units
        sol = Solution()
        kw = deck.get("RESTART")
        if kw and kw.records:
            r = kw.records[0]
            sol.restart = (str(r[0]), int(_val(r, 1, 0)))
        sol.skiprest = deck.get("SKIPREST") is not None
        p_f = u.factor("Pressure")
        rs_f = u.factor("GasSurfaceVolume") / u.factor("LiquidSurfaceVolume")
        rv_f = 1.0 / rs_f
        len_f = u.factor("Length")
        kw = deck.get("EQUIL")
        if kw:
            for r in kw.records:
                sol.equil.append(EquilRecord(
                    datum_depth=_val(r, 0, 0.0) * len_f,
                    datum_pressure=_val(r, 1, 0.0) * p_f,
                    woc_depth=_val(r, 2, 0.0) * len_f,
                    woc_pc=_val(r, 3, 0.0) * p_f,
                    goc_depth=_val(r, 4, 0.0) * len_f,
                    goc_pc=_val(r, 5, 0.0) * p_f,
                    rs_init=int(_val(r, 6, 0)),
                    rv_init=int(_val(r, 7, 0)),
                    n_accuracy=int(_val(r, 8, -5)),
                ))
        for name, attr, fac in (("RSVD", "rsvd", rs_f), ("RVVD", "rvvd", rv_f),
                                ("PBVD", "pbvd", p_f),
                                ("PDVD", "pdvd", p_f)):
            kw = deck.get(name)
            if kw:
                for r in kw.records:
                    a = np.asarray(r, dtype=np.float64).reshape(-1, 2)
                    a[:, 0] *= len_f
                    a[:, 1] *= fac
                    getattr(sol, attr).append(a)
        for name, attr in (("PRESSURE", "pressure"), ("SWAT", "swat"),
                           ("SGAS", "sgas"), ("RS", "rs"), ("RV", "rv")):
            if name in self.grid_arrays:
                setattr(sol, attr, self.grid_arrays[name])
        kw = deck.get("THPRES")
        if kw:
            for r in kw.records:
                v = _val(r, 2, None)
                # defaulted value => computeMaxDp at runtime
                sol.thpres.append((int(_val(r, 0, 1)), int(_val(r, 1, 1)),
                                   None if v is None else v * p_f))
        return sol

    # ------------------------------------------------------------------
    def _parse_summary(self, deck: Deck) -> list:
        """[(mnemonic, records)] with records a list of string-token
        records ([] for flag mnemonics) — the SummaryConfig input
        consumed by io/summaryconfig.expand_requests."""
        reqs = []
        sections = _section_spans(deck)
        for kw in deck:
            if sections.get(id(kw)) != "SUMMARY":
                continue
            if kw.name in ("SUMMARY", "RUNSUM", "EXCEL", "SEPARATE"):
                continue
            recs = [[str(x) for x in r] for r in kw.records]
            reqs.append((kw.name, recs))
        return reqs


def _rec_box(rec, i0, cur_box):
    b = list(cur_box)
    for k in range(6):
        v = _val(rec, i0 + k, None)
        if v is not None:
            b[k] = int(v) - 1
    return b


def _section_spans(deck: Deck) -> dict:
    """Map id(keyword) -> section name it belongs to."""
    sections = {}
    cur = "RUNSPEC"
    for kw in deck:
        if kw.name in ("RUNSPEC", "GRID", "EDIT", "PROPS", "REGIONS",
                       "SOLUTION", "SUMMARY", "SCHEDULE"):
            cur = kw.name
        sections[id(kw)] = cur
    return sections


def _parse_date(rec) -> datetime.datetime:
    day = int(_val(rec, 0, 1))
    mon = str(_val(rec, 1, "JAN")).upper().strip("'\"")
    year = int(_val(rec, 2, 1983))
    return datetime.datetime(year, _MONTHS.get(mon[:3], 1), day)


def load_case(path: str) -> EclipseCase:
    case = EclipseCase(parse_deck(path))
    case.path = path
    return case


def load_case_string(text: str) -> EclipseCase:
    return EclipseCase(parse_deck_string(text))
