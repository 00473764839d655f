"""Legacy VTK output for visualization.

Counterpart of opm/simulators/vtk/writeVtkData.{hpp,cpp}
(legacy VTK XML writer for cartesian/unstructured output): writes
RectilinearGrid .vtr files with per-cell solution arrays, blanking inactive
cells via a mask array.
"""

from __future__ import annotations

import os

import numpy as np


def write_vtr(path: str, grid, cell_data: dict):
    """Write cell data on the structural (nx, ny, nz) grid as VTK
    RectilinearGrid XML (ASCII)."""
    nx, ny, nz = grid.dims

    # active-cell arrays scattered to the cartesian box (embedded grids:
    # scatter REAL cells only — padding slots share donor cartesian ids)
    rc = grid.real_cells
    gc = grid.real_global_cell

    def to_cart(a, fill=np.nan):
        out = np.full(nx * ny * nz, fill)
        out[gc] = np.asarray(a)[rc]
        return out

    dxc = to_cart(grid.dx, 0.0).reshape(nz, ny, nx)
    dyc = to_cart(grid.dy, 0.0).reshape(nz, ny, nx)
    dzc = to_cart(grid.dz, 0.0).reshape(nz, ny, nx)
    x = np.concatenate([[0.0], np.cumsum(dxc.max(axis=(0, 1)))])
    y = np.concatenate([[0.0], np.cumsum(dyc.max(axis=(0, 2)))])
    z = np.concatenate([[0.0], np.cumsum(dzc.max(axis=(1, 2)))])

    lines = []
    lines.append('<?xml version="1.0"?>')
    lines.append('<VTKFile type="RectilinearGrid" version="0.1" '
                 'byte_order="LittleEndian">')
    lines.append(f'  <RectilinearGrid WholeExtent="0 {nx} 0 {ny} 0 {nz}">')
    lines.append(f'    <Piece Extent="0 {nx} 0 {ny} 0 {nz}">')
    lines.append('      <CellData>')
    active = np.zeros(nx * ny * nz)
    active[gc] = 1.0
    all_data = dict(cell_data)
    all_data["ACTIVE"] = active
    for name, arr in all_data.items():
        arr = np.asarray(arr)
        vals = arr if arr.size == nx * ny * nz else to_cart(arr, 0.0)
        lines.append(f'        <DataArray type="Float64" Name="{name}" '
                     'format="ascii">')
        lines.append("          " + " ".join(f"{v:.8g}" for v in vals))
        lines.append("        </DataArray>")
    lines.append("      </CellData>")
    lines.append("      <Coordinates>")
    for axis_name, coords in (("x", x), ("y", y), ("z", z)):
        lines.append(f'        <DataArray type="Float64" Name="{axis_name}" '
                     'format="ascii">')
        lines.append("          " + " ".join(f"{v:.8g}" for v in coords))
        lines.append("        </DataArray>")
    lines.append("      </Coordinates>")
    lines.append("    </Piece>")
    lines.append("  </RectilinearGrid>")
    lines.append("</VTKFile>")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))
