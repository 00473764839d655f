"""Matlab-format per-step text output.

The reference's Matlab sub-writer (BlackoilMatlabWriter,
opm/autodiff/SimulatorFullyImplicitBlackoilOutput.hpp:175-195,
outputStateMatlab :84-123 and outputWellStateMatlab in
SimulatorFullyImplicitBlackoilOutput.cpp:92-114) dumps one plain-text file
per variable per report step: ``<output_dir>/<name>/NNN.txt`` with one value
per line at 15-digit precision — trivially loadable from Matlab/Octave with
``load``. Cell vectors are written flattened in the reference's interleaved
order (saturation: per-cell [sw, so, sg]; velocity: per-cell [vx, vy, vz];
wellrates: per-well [qw, qo, qg]).
"""

from __future__ import annotations

import os

import numpy as np


def write_matlab_step(output_dir: str, step: int, data: dict) -> None:
    """Write each ``name -> array`` entry to ``output_dir/name/NNN.txt``
    (the reference's DataMap loop, SimulatorCompressibleTwophase.cpp:184-196).
    Arrays are flattened C-order; one value per line, 15 significant digits.
    """
    for name, arr in data.items():
        d = os.path.join(output_dir, name)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{step:03d}.txt")
        vals = np.asarray(arr, dtype=np.float64).reshape(-1)
        with open(path, "w") as f:
            f.write("\n".join(f"{v:.15g}" for v in vals))
            if vals.size:
                f.write("\n")


def output_state_matlab(output_dir: str, step: int, *, pressure,
                        saturation, rs=None, rv=None,
                        velocity=None, extra: dict | None = None) -> None:
    """Cell-state dump matching outputStateMatlab's DataMap: pressure,
    saturation (interleaved per cell), rs ("GASOILRATIO"), rv, and the
    estimated cell velocity (miscUtilities estimateCellVelocity role)."""
    dm = {"pressure": pressure, "saturation": saturation}
    if rs is not None:
        dm["rs"] = rs
    if rv is not None:
        dm["rv"] = rv
    if velocity is not None:
        dm["velocity"] = velocity
    if extra:
        dm.update(extra)
    write_matlab_step(output_dir, step, dm)


def output_well_state_matlab(output_dir: str, step: int, *, bhp,
                             wellrates) -> None:
    """Well-state dump matching outputWellStateMatlab (bhp + wellRates)."""
    write_matlab_step(output_dir, step, {"bhp": bhp, "wellrates": wellrates})


def read_matlab_file(output_dir: str, name: str, step: int) -> np.ndarray:
    """Load one variable back (test/analysis helper)."""
    path = os.path.join(output_dir, name, f"{step:03d}.txt")
    return np.loadtxt(path, ndmin=1)

