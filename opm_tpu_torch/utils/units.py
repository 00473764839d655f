"""Unit systems and conversions.

Internally everything is SI (m, s, kg, Pa, Pa.s, m^2, m^3). Eclipse decks
declare one of METRIC / FIELD / LAB in RUNSPEC; every keyword column carries a
dimension string that is converted to SI at parse time and back at output time.

Mirrors the role of opm-common's UnitSystem (used by the reference via
EclipseState; see opm/core/props/BlackoilPropertiesFromDeck.hpp
usage) — re-implemented from physical constants, not ported.
"""

from __future__ import annotations

# --- physical constants / base factors (exact where defined exactly) ---
METER = 1.0
INCH = 0.0254
FEET = 12 * INCH  # 0.3048 m
DAY = 86400.0
HOUR = 3600.0
YEAR = 365.0 * DAY
PSIA = 6894.757293168361  # Pa
BAR = 1.0e5  # Pa
ATM = 101325.0
CP = 1.0e-3  # Pa.s
POISE = 0.1
DARCY = 9.869232667160130e-13  # m^2
MILLIDARCY = DARCY * 1e-3
STB = 0.158987294928  # m^3 (42 US gallons)
MSCF = 1000 * FEET**3  # 28.316846592 m^3
SCF = FEET**3
LBM = 0.45359237  # kg
LB_PER_FT3 = LBM / FEET**3  # 16.0184633739601 kg/m^3
GRAVITY = 9.80665  # m/s^2 (same constant as opm-parser's unit system)
PSI_PER_FT = PSIA / FEET

# Dimension strings follow a tiny algebra: products of named atoms with an
# optional sign for "inverse" via the '1/...' prefix, e.g.
#   'Pressure', 'Length', 'Viscosity', 'GasSurfaceVolume/Time',
#   'OilSurfaceVolume/GasSurfaceVolume' (rv), ...
# Each unit system maps atoms -> SI factor.

_METRIC = {
    "Length": METER,
    "Time": DAY,
    "Pressure": BAR,
    "Temperature": 1.0,  # offsets ignored (isothermal simulator)
    "Density": 1.0,
    "Viscosity": CP,
    "Permeability": MILLIDARCY,
    "LiquidSurfaceVolume": 1.0,
    "GasSurfaceVolume": 1.0,
    "ReservoirVolume": 1.0,
    "Energy": 1000.0,
    "Mass": 1.0,
    "Transmissibility": CP * 1.0 / (DAY * BAR),
    "PolymerDensity": 1.0,  # kg/sm3
    "Dimensionless": 1.0,
}

_FIELD = {
    "Length": FEET,
    "Time": DAY,
    "Pressure": PSIA,
    "Temperature": 1.0,
    "Density": LB_PER_FT3,
    "Viscosity": CP,
    "Permeability": MILLIDARCY,
    "LiquidSurfaceVolume": STB,
    "GasSurfaceVolume": MSCF,
    "ReservoirVolume": STB,
    "Energy": 1.0,
    "Mass": LBM,
    "Transmissibility": CP * STB / (DAY * PSIA),
    "PolymerDensity": LBM / STB,
    "Dimensionless": 1.0,
}

_LAB = {
    "Length": 0.01,
    "Time": HOUR,
    "Pressure": ATM,
    "Temperature": 1.0,
    "Density": 1000.0,  # g/cc -> kg/m3
    "Viscosity": CP,
    "Permeability": MILLIDARCY,
    "LiquidSurfaceVolume": 1e-6,  # scc
    "GasSurfaceVolume": 1e-6,
    "ReservoirVolume": 1e-6,
    "Energy": 1.0,
    "Mass": 1e-3,
    "Transmissibility": CP * 1e-6 / (HOUR * ATM),
    "PolymerDensity": 1.0,
    "Dimensionless": 1.0,
}

SYSTEMS = {"METRIC": _METRIC, "FIELD": _FIELD, "LAB": _LAB}


class UnitSystem:
    """Converts deck values (in METRIC/FIELD/LAB) to SI and back."""

    def __init__(self, name: str = "METRIC"):
        name = name.upper()
        if name not in SYSTEMS:
            raise ValueError(f"unknown unit system {name!r}")
        self.name = name
        self._atoms = SYSTEMS[name]

    def factor(self, dim: str) -> float:
        """SI factor for a dimension expression like 'Viscosity*ReservoirVolume/Time'."""
        if not dim or dim == "1":
            return 1.0
        num, _, den = dim.partition("/")
        f = 1.0
        for part in num.split("*"):
            part = part.strip()
            if part and part != "1":
                f *= self._atom(part)
        if den:
            for part in den.replace("/", "*").split("*"):
                part = part.strip()
                if part and part != "1":
                    f /= self._atom(part)
        return f

    def _atom(self, name: str) -> float:
        if name not in self._atoms:
            raise KeyError(f"unknown dimension atom {name!r}")
        return self._atoms[name]


def si_factor(system: str, dim: str) -> float:
    """SI factor of dimension ``dim`` in unit system ``system`` (the output
    writers divide by it to store deck units)."""
    return UnitSystem(system).factor(dim)
