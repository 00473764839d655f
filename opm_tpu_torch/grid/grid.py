"""Grid topology, geometry, and derived geology (host numpy arrays).

Replaces the reference's UnstructuredGrid/Dune::CpGrid accessors
(opm/autodiff/GridHelpers.hpp) and DerivedGeology
(opm/autodiff/GeoProps.hpp:58-270: pore volume =
MULTPV*NTG*PORO*vol, harmonic face transmissibilities with MULT[XYZ]
multipliers, cell depths, gravity). Instead of sparse HelperOps matrices
(AutoDiffHelpers.hpp:44-174), connectivity is plain int32 index arrays
(face -> (cell1, cell2)) consumed by gather/segment_sum in the models.

All arrays are NumPy on host; models move them to device once per case.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

GRAVITY = 9.80665


@dataclass
class Grid:
    dims: Tuple[int, int, int]
    nc: int                       # number of active cells
    global_cell: np.ndarray       # (nc,) active -> cartesian index
    cart_to_active: np.ndarray    # (nx*ny*nz,) cartesian -> active or -1
    # geometry per active cell
    dx: np.ndarray
    dy: np.ndarray
    dz: np.ndarray
    depth: np.ndarray             # cell-center depth (positive downwards)
    volume: np.ndarray
    poro: np.ndarray
    ntg: np.ndarray
    pore_volume: np.ndarray       # MULTPV*NTG*PORO*volume (GeoProps.hpp:140)
    permx: np.ndarray
    permy: np.ndarray
    permz: np.ndarray
    # interior-face topology (includes NNCs appended at the end)
    face_cells: np.ndarray        # (nf, 2) int32 active-cell indices
    trans: np.ndarray             # (nf,) face transmissibility (SI)
    face_dir: np.ndarray          # (nf,) 0=x,1=y,2=z,3=nnc
    # True when the cell axis is the full cartesian box and the FIRST
    # nf_canonical faces follow the build_grid cartesian slicing order
    # (x block, y block, z block, C-ordered): solvers may then use
    # static-slice stencil kernels instead of gather/scatter
    # (models/linearize.py matvec dims=, linalg/gmg.py). Faces beyond
    # nf_canonical ("extra faces": stair-step fault connections, NNCs)
    # are handled by a small gather-based correction.
    structured: bool = False
    gravity: float = GRAVITY
    satnum: Optional[np.ndarray] = None  # (nc,) 0-based saturation region
    pvtnum: Optional[np.ndarray] = None
    eqlnum: Optional[np.ndarray] = None
    fipnum: Optional[np.ndarray] = None

    @property
    def nf(self) -> int:
        return self.face_cells.shape[0]

    @property
    def nf_canonical(self) -> int:
        """Number of leading faces in canonical cartesian slicing order
        (= all faces unless this is a structured grid with extra faces)."""
        if not self.structured:
            return self.nf
        nx, ny, nz = self.dims
        return ((nx - 1) * ny * nz + nx * (ny - 1) * nz
                + nx * ny * (nz - 1))

    def active_index(self, i, j, k) -> int:
        nx, ny, _ = self.dims
        return int(self.cart_to_active[(k * ny + j) * nx + i])


_FAULT_FACE = {"X": (0, +1), "I": (0, +1), "X-": (0, -1), "I-": (0, -1),
               "Y": (1, +1), "J": (1, +1), "Y-": (1, -1), "J-": (1, -1),
               "Z": (2, +1), "K": (2, +1), "Z-": (2, -1), "K-": (2, -1)}


def _fault_face_multipliers(case, nx, ny, nz):
    """Per-cell, per-direction fault transmissibility multipliers from
    FAULTS + MULTFLT (the TransMult fault path the reference consumes in
    GeoProps.hpp:466 multiplyHalfIntersections_). Returns (fpos, fneg),
    each (3, ncg): the multiplier on a cell's positive/negative-direction
    face; a connection c1->c2 along +d gets fpos[d][c1] * fneg[d][c2].
    Distinct faults sharing a face multiply together; repeated MULTFLT
    records for one fault override (last wins, opm-common semantics)."""
    ncg = nx * ny * nz
    fpos = np.ones((3, ncg))
    fneg = np.ones((3, ncg))
    faults = getattr(case, "faults", {}) or {}
    mults = getattr(case, "fault_mults", {}) or {}
    for name, recs in faults.items():
        m = mults.get(name)
        if m is None or m == 1.0:
            continue
        for (b, face) in recs:
            d, sgn = _FAULT_FACE[str(face).upper()]
            i1, i2, j1, j2, k1, k2 = b
            ii = np.arange(max(i1, 0), min(i2, nx - 1) + 1)
            jj = np.arange(max(j1, 0), min(j2, ny - 1) + 1)
            kk = np.arange(max(k1, 0), min(k2, nz - 1) + 1)
            K, J, I = np.meshgrid(kk, jj, ii, indexing="ij")
            idx = ((K * ny + J) * nx + I).ravel()
            (fpos if sgn > 0 else fneg)[d, idx] *= m
    return fpos, fneg


def _nnc_faces(case, cart_to_active):
    """Deck NNC records -> (face_cells (n,2), trans (n,), dir=3 (n,)),
    dropping connections to inactive cells (AutoDiffHelpers.hpp:60-90
    appends NNC rows to the grad/div operators; here they are ordinary
    faces with face_dir=3)."""
    fc, tr = [], []
    for (g1, g2, t) in getattr(case, "nncs", []) or []:
        a1 = int(cart_to_active[g1])
        a2 = int(cart_to_active[g2])
        if a1 < 0 or a2 < 0 or t <= 0.0 or a1 == a2:
            continue
        fc.append((a1, a2))
        tr.append(t)
    if not fc:
        return (np.zeros((0, 2), dtype=np.int32), np.zeros(0),
                np.zeros(0, dtype=np.int8))
    return (np.asarray(fc, dtype=np.int32), np.asarray(tr),
            np.full(len(tr), 3, dtype=np.int8))


def _expand_v(vec, nx, ny, nz, axis):
    """DXV/DYV/DZV (per-slab spacing) -> full nx*ny*nz array."""
    out = np.empty((nz, ny, nx))
    if axis == 0:
        out[:] = np.asarray(vec)[None, None, :]
    elif axis == 1:
        out[:] = np.asarray(vec)[None, :, None]
    else:
        out[:] = np.asarray(vec)[:, None, None]
    return out.ravel()


def build_grid(case) -> Grid:
    """Build an active-cell grid + derived geology from an EclipseCase.
    Dispatches to the corner-point path when COORD/ZCORN are present."""
    ga = case.grid_arrays
    if "COORD" in ga and "ZCORN" in ga:
        raise NotImplementedError(
            "corner-point grids are not ported yet "
            "(ROADMAP Queue 1 item 9)")
    nx, ny, nz = case.runspec.dims
    ncg = nx * ny * nz

    def full(name, default=None):
        if name in ga:
            return np.asarray(ga[name], dtype=np.float64)
        if default is None:
            raise KeyError(f"grid array {name} missing from deck")
        return np.full(ncg, default)

    if "DX" in ga:
        dx, dy, dz = full("DX"), full("DY"), full("DZ")
    else:
        dx = _expand_v(ga["DXV"], nx, ny, nz, 0)
        dy = _expand_v(ga["DYV"], nx, ny, nz, 1)
        dz = _expand_v(ga["DZV"], nx, ny, nz, 2)

    # cell-top depths: stack dz below TOPS of layer 0 (column-wise)
    tops = np.zeros(ncg)
    if "TOPS" in ga:
        t = np.asarray(ga["TOPS"], dtype=np.float64)
        tops3 = tops.reshape(nz, ny, nx)
        nlayers_given = min(len(t) // (nx * ny), nz)
        for k in range(nlayers_given):
            tops3[k] = t[k * nx * ny:(k + 1) * nx * ny].reshape(ny, nx)
        dz3 = dz.reshape(nz, ny, nx)
        for k in range(max(1, nlayers_given), nz):
            tops3[k] = tops3[k - 1] + dz3[k - 1]
        tops = tops3.ravel()
    depth = tops + 0.5 * dz

    volume = dx * dy * dz
    poro = full("PORO", 0.0)
    ntg = full("NTG", 1.0)
    multpv = full("MULTPV", 1.0)
    pv_all = multpv * ntg * poro * volume

    actnum = np.asarray(ga.get("ACTNUM", np.ones(ncg)), dtype=np.int64).copy()
    minpv = getattr(case, "minpv", 0.0)
    actnum[pv_all < max(minpv, 1e-30)] = 0  # MINPV deactivation (GeoProps.hpp:412)

    active_mask = actnum > 0
    global_cell = np.nonzero(active_mask)[0].astype(np.int32)
    nc = len(global_cell)
    cart_to_active = np.full(ncg, -1, dtype=np.int32)
    cart_to_active[global_cell] = np.arange(nc, dtype=np.int32)

    permx = full("PERMX")
    permy = full("PERMY", None) if "PERMY" in ga else permx
    permz = full("PERMZ", None) if "PERMZ" in ga else permx
    multx = full("MULTX", 1.0)
    multy = full("MULTY", 1.0)
    multz = full("MULTZ", 1.0)
    # negative-direction multipliers (MULT[XYZ]-) apply to the SECOND
    # cell's half of each connection (GeoProps.hpp:466
    # multiplyHalfIntersections_: cell half-trans gets its own-direction
    # multiplier; harmonic combination multiplies both)
    multxm = full("MULTX-", 1.0)
    multym = full("MULTY-", 1.0)
    multzm = full("MULTZ-", 1.0)
    fpos, fneg = _fault_face_multipliers(case, nx, ny, nz)

    # interior faces between cartesian neighbors (both active)
    fc, tr, fdir, gc1 = [], [], [], []
    idx3 = np.arange(ncg).reshape(nz, ny, nx)
    geom = dict(dx=dx, dy=dy, dz=dz, ntg=ntg)

    def add_faces(c1, c2, axis):
        a1 = cart_to_active[c1]
        a2 = cart_to_active[c2]
        ok = (a1 >= 0) & (a2 >= 0)
        c1, c2, a1, a2 = c1[ok], c2[ok], a1[ok], a2[ok]
        gc1.append(c1)
        if axis == 0:
            area1 = dy[c1] * dz[c1] * ntg[c1]
            area2 = dy[c2] * dz[c2] * ntg[c2]
            h1 = permx[c1] * area1 / (0.5 * dx[c1])
            h2 = permx[c2] * area2 / (0.5 * dx[c2])
            mult = multx[c1] * multxm[c2]
        elif axis == 1:
            area1 = dx[c1] * dz[c1] * ntg[c1]
            area2 = dx[c2] * dz[c2] * ntg[c2]
            h1 = permy[c1] * area1 / (0.5 * dy[c1])
            h2 = permy[c2] * area2 / (0.5 * dy[c2])
            mult = multy[c1] * multym[c2]
        else:
            area1 = dx[c1] * dy[c1]
            area2 = dx[c2] * dy[c2]
            h1 = permz[c1] * area1 / (0.5 * dz[c1])
            h2 = permz[c2] * area2 / (0.5 * dz[c2])
            mult = multz[c1] * multzm[c2]
        mult = mult * fpos[axis, c1] * fneg[axis, c2]
        with np.errstate(divide="ignore"):
            t = mult / (1.0 / np.maximum(h1, 1e-300) +
                        1.0 / np.maximum(h2, 1e-300))
        t = np.where((h1 <= 0) | (h2 <= 0), 0.0, t)
        fc.append(np.stack([a1, a2], axis=1))
        tr.append(t)
        fdir.append(np.full(len(t), axis, dtype=np.int8))

    if nx > 1:
        add_faces(idx3[:, :, :-1].ravel(), idx3[:, :, 1:].ravel(), 0)
    if ny > 1:
        add_faces(idx3[:, :-1, :].ravel(), idx3[:, 1:, :].ravel(), 1)
    if nz > 1:
        add_faces(idx3[:-1, :, :].ravel(), idx3[1:, :, :].ravel(), 2)

    nnc_fc, nnc_tr, nnc_fd = _nnc_faces(case, cart_to_active)

    if fc or len(nnc_tr):
        face_cells = np.concatenate(
            ([np.concatenate(fc).astype(np.int32)] if fc else [])
            + ([nnc_fc] if len(nnc_tr) else [])).astype(np.int32)
        trans = np.concatenate(
            ([np.concatenate(tr)] if tr else [])
            + ([nnc_tr] if len(nnc_tr) else []))
        face_dir = np.concatenate(
            ([np.concatenate(fdir)] if fdir else [])
            + ([nnc_fd] if len(nnc_tr) else []))
    else:
        face_cells = np.zeros((0, 2), dtype=np.int32)
        trans = np.zeros(0)
        face_dir = np.zeros(0, dtype=np.int8)

    regions = getattr(case, "regions", {})

    def reg(name):
        arr = regions.get(name)
        return (arr[global_cell] - 1).astype(np.int32) if arr is not None else \
            np.zeros(nc, dtype=np.int32)

    return Grid(
        dims=(nx, ny, nz), nc=nc, global_cell=global_cell,
        cart_to_active=cart_to_active,
        dx=dx[global_cell], dy=dy[global_cell], dz=dz[global_cell],
        depth=depth[global_cell], volume=volume[global_cell],
        poro=poro[global_cell], ntg=ntg[global_cell],
        pore_volume=pv_all[global_cell],
        permx=permx[global_cell], permy=permy[global_cell],
        permz=permz[global_cell],
        face_cells=face_cells, trans=trans, face_dir=face_dir,
        # NNC faces break the cartesian slicing assumption of the
        # structured stencil/GMG fast path -> gather path
        structured=(nc == ncg and len(nnc_tr) == 0),
        satnum=reg("SATNUM"), pvtnum=reg("PVTNUM"),
        eqlnum=reg("EQLNUM"), fipnum=reg("FIPNUM"),
    )
