"""Grid topology, geometry, and derived geology (host numpy arrays).

Port of the JAX package's grid/grid.py: cartesian (DX/DY/DZ, DXV...) and
corner-point (COORD/ZCORN) grids, ACTNUM holes, FAULTS/MULTFLT and NNCs.
Replaces the reference's UnstructuredGrid/Dune::CpGrid accessors
(opm/autodiff/GridHelpers.hpp) and DerivedGeology
(opm/autodiff/GeoProps.hpp:58-270: pore volume =
MULTPV*NTG*PORO*vol, harmonic face transmissibilities with MULT[XYZ]
multipliers, cell depths, gravity). Instead of sparse HelperOps matrices
(AutoDiffHelpers.hpp:44-174), connectivity is plain int32 index arrays
(face -> (cell1, cell2)) consumed by gather/segment_sum in the models.

Two representations of a grid with holes or non-conforming faults, chosen
by ``_embed_wanted`` (knob OPM_TPU_EMBED=0/1/auto, the JAX package's):
EMBEDDED into the full cartesian box (padding cells inert, the structured
stencil path plus a few "extra" gather faces), or the GATHER form (active
cells only, an arbitrary face list).

All arrays are NumPy on host; models move them to device once per case.
"""

from __future__ import annotations

import os
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
    # EMBEDDED grids (ACTNUM-holed grids ridden on the structured path):
    # (nc,) bool, True for genuinely-active cells; None = all real.
    # Padding cells carry donor-cell properties, zero transmissibility on
    # every face, and no perforations — they stay frozen at their initial
    # state and are masked out of convergence norms, FIP, and output.
    active_mask: Optional[np.ndarray] = None

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

    @property
    def n_real(self) -> int:
        """Number of genuinely-active cells (excludes embedding padding)."""
        return (self.nc if self.active_mask is None
                else int(self.active_mask.sum()))

    @property
    def real_cells(self) -> np.ndarray:
        """Indices (into the nc cell axis) of genuinely-active cells."""
        return (np.arange(self.nc, dtype=np.int32)
                if self.active_mask is None
                else np.nonzero(self.active_mask)[0].astype(np.int32))

    @property
    def real_global_cell(self) -> np.ndarray:
        """Cartesian indices of genuinely-active cells (output/ACTNUM)."""
        return np.asarray(self.global_cell)[self.real_cells]

    def ijk(self, active_idx):
        nx, ny, _ = self.dims
        g = self.global_cell[active_idx]
        return g % nx, (g // nx) % ny, g // (nx * ny)

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


def _donor_map(real_mask: np.ndarray) -> np.ndarray:
    """Nearest genuinely-active cell (in flattened C-order) for every
    cartesian cell — identity on active cells. Padding cells of an
    embedded grid read ALL their per-cell properties (regions, endpoint
    scaling, equilibration inputs) through this map, so every deck-array
    lookup lands on a valid cell and the padding state is finite by
    construction."""
    ncg = real_mask.size
    ar = np.arange(ncg)
    real_idx = np.nonzero(real_mask)[0]
    if len(real_idx) == 0:
        raise ValueError("grid has no active cells")
    pos = np.searchsorted(real_idx, ar)
    left = real_idx[np.clip(pos - 1, 0, len(real_idx) - 1)]
    right = real_idx[np.clip(pos, 0, len(real_idx) - 1)]
    donor = np.where(np.abs(ar - left) <= np.abs(right - ar), left, right)
    donor[real_mask] = ar[real_mask]
    return donor.astype(np.int32)


def _canonical_faces(nx, ny, nz):
    """Full cartesian face list in build_grid slicing order (x block,
    y block, z block, each C-ordered) with cartesian cell ids."""
    idx3 = np.arange(nx * ny * nz, dtype=np.int32).reshape(nz, ny, nx)
    fc = np.concatenate([
        np.stack([idx3[:, :, :-1].ravel(), idx3[:, :, 1:].ravel()], 1),
        np.stack([idx3[:, :-1, :].ravel(), idx3[:, 1:, :].ravel()], 1),
        np.stack([idx3[:-1].ravel(), idx3[1:].ravel()], 1)])
    fdir = np.concatenate([
        np.zeros((nx - 1) * ny * nz, np.int8),
        np.ones(nx * (ny - 1) * nz, np.int8),
        np.full(nx * ny * (nz - 1), 2, np.int8)])
    return fc, fdir


def _canonical_slot(g1, dk, nx, ny, nz):
    """Slot of the conforming connection (g1 -> g1+stride[dk]) in the
    canonical face ordering."""
    i = g1 % nx
    j = (g1 // nx) % ny
    k = g1 // (nx * ny)
    nfx = (nx - 1) * ny * nz
    nfy = nx * (ny - 1) * nz
    return np.where(
        dk == 0, (k * ny + j) * (nx - 1) + i,
        np.where(dk == 1, nfx + (k * (ny - 1) + j) * nx + i,
                 nfx + nfy + (k * ny + j) * nx + i))


def _embed_wanted(nc, ncg, conf, n_extra_nnc=0, knob=None):
    """Embedding policy ``knob`` "0"/"1"/"auto" (None: OPM_TPU_EMBED, the
    JAX package's knob, default auto). auto: embed when at least a quarter
    of the box is active and at least 80% of the connections are
    conforming."""
    if knob is None:
        knob = os.environ.get("OPM_TPU_EMBED", "auto")
    if knob == "0":
        return False
    if knob == "1":
        return True
    ntot = conf.size + n_extra_nnc
    if ntot == 0:
        return False
    frac_active = nc / max(ncg, 1)
    frac_conf = float(conf.sum()) / ntot
    return frac_active >= 0.25 and frac_conf >= 0.8


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


def _build_embedded_grid(case, dims, real_mask, *, pv_all, volume, depth,
                         dx, dy, dz, poro, ntg, permx, permy, permz,
                         conf_slot, conf_tr, extra_fc, extra_tr, extra_dir,
                         nnc_fc, nnc_tr, nnc_fd) -> Grid:
    """Assemble an EMBEDDED structured grid: the cell axis is the full
    cartesian box; the canonical face set carries the conforming
    transmissibilities (zero on any face touching padding), and
    non-conforming connections (stair-step faults) + NNCs are appended as
    gather-path extra faces. Padding cells read every property through the
    nearest-active donor map, so props/equilibration stay finite, and have
    zero transmissibility everywhere — they are frozen spectators.

    Same derived-geology semantics as the reference's GeoProps
    (opm/autodiff/GeoProps.hpp): the embedding is a data-layout choice."""
    nx, ny, nz = dims
    ncg = nx * ny * nz
    donor = _donor_map(real_mask)
    nf_can = (nx - 1) * ny * nz + nx * (ny - 1) * nz + nx * ny * (nz - 1)
    tcan = np.zeros(nf_can)
    # duplicate conforming sub-faces between one cell pair (split fault
    # faces) sum like parallel conductances
    np.add.at(tcan, conf_slot, conf_tr)
    fc_can, fd_can = _canonical_faces(nx, ny, nz)
    face_cells = np.concatenate([
        fc_can, np.asarray(extra_fc, dtype=np.int32).reshape(-1, 2),
        np.asarray(nnc_fc, dtype=np.int32).reshape(-1, 2)])
    trans = np.concatenate([tcan, extra_tr, nnc_tr])
    face_dir = np.concatenate([
        fd_can, np.asarray(extra_dir, dtype=np.int8),
        np.asarray(nnc_fd, dtype=np.int8)])

    cart_to_active = np.where(real_mask, np.arange(ncg, dtype=np.int32),
                              np.int32(-1)).astype(np.int32)
    regions = getattr(case, "regions", {})

    def reg(name):
        arr = regions.get(name)
        if arr is None:
            return np.zeros(ncg, dtype=np.int32)
        return np.maximum(np.asarray(arr)[donor] - 1, 0).astype(np.int32)

    return Grid(
        dims=(nx, ny, nz), nc=ncg, global_cell=donor,
        cart_to_active=cart_to_active,
        dx=dx[donor], dy=dy[donor], dz=dz[donor],
        depth=depth[donor], volume=volume[donor],
        poro=poro[donor], ntg=ntg[donor],
        pore_volume=pv_all[donor],
        permx=permx[donor], permy=permy[donor], permz=permz[donor],
        face_cells=face_cells.astype(np.int32), trans=trans,
        face_dir=face_dir, structured=True,
        satnum=reg("SATNUM"), pvtnum=reg("PVTNUM"),
        eqlnum=reg("EQLNUM"), fipnum=reg("FIPNUM"),
        active_mask=real_mask.copy(),
    )


def build_grid(case, embed=None) -> Grid:
    """Build an active-cell grid + derived geology from an EclipseCase.
    Dispatches to the corner-point path when COORD/ZCORN are present.
    ``embed``: the embedding policy (_embed_wanted's knob)."""
    ga = case.grid_arrays
    if "COORD" in ga and "ZCORN" in ga:
        return build_corner_point_grid(case, embed)
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

    if nc < ncg and fc and _embed_wanted(
            nc, ncg, np.ones(sum(len(a) for a in gc1), dtype=bool),
            len(nnc_tr), embed):
        # ACTNUM-holed cartesian grid: embed into the full box so the
        # structured stencil/GMG fast path applies (padding cells inert)
        gall = np.concatenate(gc1)
        dall = np.concatenate(fdir).astype(np.int64)
        tall = np.concatenate(tr)
        slots = _canonical_slot(gall, dall, nx, ny, nz)
        # NNC cartesian ids: re-derive against the identity embedding
        cart_emb = np.where(actnum > 0, np.arange(ncg, dtype=np.int32),
                            np.int32(-1))
        nnc_fce, nnc_tre, nnc_fde = _nnc_faces(case, cart_emb)
        return _build_embedded_grid(
            case, (nx, ny, nz), actnum > 0,
            pv_all=pv_all, volume=volume, depth=depth, dx=dx, dy=dy, dz=dz,
            poro=poro, ntg=ntg, permx=permx, permy=permy, permz=permz,
            conf_slot=slots, conf_tr=tall,
            extra_fc=np.zeros((0, 2), np.int32), extra_tr=np.zeros(0),
            extra_dir=np.zeros(0, np.int8),
            nnc_fc=nnc_fce, nnc_tr=nnc_tre, nnc_fd=nnc_fde)

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


def build_corner_point_grid(case, embed=None) -> Grid:
    """Corner-point (COORD/ZCORN) grid + NEWTRAN transmissibilities
    (grid/cornerpoint.py does the geometry; this assembles the active-cell
    arrays and harmonic face transmissibilities with MULT/NTG factors)."""
    from opm_tpu_torch.grid.cornerpoint import (half_trans,
                                                process_corner_point)

    nx, ny, nz = case.runspec.dims
    ncg = nx * ny * nz
    ga = case.grid_arrays

    geom = process_corner_point((nx, ny, nz), ga["COORD"], ga["ZCORN"],
                                ga.get("ACTNUM"))
    volume = geom["volume"]
    centroid = geom["centroid"]

    def full(name, default):
        return (np.asarray(ga[name], dtype=np.float64) if name in ga
                else np.full(ncg, default))

    poro = full("PORO", 0.0)
    ntg = full("NTG", 1.0)
    multpv = full("MULTPV", 1.0)
    permx = full("PERMX", 0.0)
    permy = np.asarray(ga.get("PERMY", permx), dtype=np.float64)
    permz = np.asarray(ga.get("PERMZ", permx), dtype=np.float64)
    mults = (full("MULTX", 1.0), full("MULTY", 1.0), full("MULTZ", 1.0))
    mults_neg = (full("MULTX-", 1.0), full("MULTY-", 1.0),
                 full("MULTZ-", 1.0))
    fpos, fneg = _fault_face_multipliers(case, nx, ny, nz)
    pv_all = multpv * ntg * poro * volume
    actnum = np.asarray(ga.get("ACTNUM", np.ones(ncg)), dtype=np.int64).copy()
    actnum[pv_all < max(getattr(case, "minpv", 0.0), 1e-30)] = 0
    actnum[volume <= 0.0] = 0
    active_mask = actnum > 0
    global_cell = np.nonzero(active_mask)[0].astype(np.int32)
    nc = len(global_cell)
    cart_to_active = np.full(ncg, -1, dtype=np.int32)
    cart_to_active[global_cell] = np.arange(nc, dtype=np.int32)

    # vectorized NEWTRAN half-trans + harmonic assembly over the native
    # connection arrays (the old per-connection Python loop was the wall
    # at SPE10/Norne scale)
    g1a, g2a, area_a, fca, dir_a = geom["conn_arrays"]
    a1 = cart_to_active[g1a]
    a2 = cart_to_active[g2a]
    ok = (a1 >= 0) & (a2 >= 0)
    g1a, g2a, area_a, fca, dir_a = (g1a[ok], g2a[ok], area_a[ok],
                                    fca[ok], dir_a[ok])
    a1, a2 = a1[ok], a2[ok]
    perm_sel = np.stack([permx, permy, permz])      # (3, ncg)
    scale1 = np.where(dir_a < 2, ntg[g1a], 1.0)
    scale2 = np.where(dir_a < 2, ntg[g2a], 1.0)
    h1 = half_trans(perm_sel[dir_a, g1a], area_a * scale1[:, None], fca,
                    centroid[g1a])
    h2 = half_trans(perm_sel[dir_a, g2a], area_a * scale2[:, None], fca,
                    centroid[g2a])
    ok2 = (h1 > 0) & (h2 > 0)
    mult_pos = np.stack(mults)
    mult_neg = np.stack(mults_neg)
    m = (mult_pos[dir_a, g1a] * mult_neg[dir_a, g2a]
         * fpos[dir_a, g1a] * fneg[dir_a, g2a])
    with np.errstate(divide="ignore"):
        t = m / (1.0 / np.maximum(h1, 1e-300)
                 + 1.0 / np.maximum(h2, 1e-300))
    nnc_fc, nnc_tr, nnc_fd = _nnc_faces(case, cart_to_active)

    # cell extents for Peaceman well indices from the actual corner
    # geometry (the reference derives dx/dy/dz from cell vertices,
    # WellsManager/GridHelpers; cbrt(volume) is off by ~an order of
    # magnitude for pancake cells like SPE9's 300ft x few-ft layers)
    ext = geom.get("extent")
    if ext is not None:
        dx, dy, dz = ext[:, 0].copy(), ext[:, 1].copy(), ext[:, 2].copy()
        tiny = np.cbrt(np.maximum(volume, 1e-30))
        for a in (dx, dy, dz):
            np.copyto(a, tiny, where=a <= 0.0)
    else:
        dx = np.cbrt(np.maximum(volume, 1e-30))
        dy = dx.copy()
        dz = dx.copy()

    face_cells = np.concatenate([
        np.stack([a1[ok2], a2[ok2]], axis=1).astype(np.int32)
        .reshape(-1, 2), nnc_fc])
    trans = np.concatenate([t[ok2], nnc_tr])
    face_dir = np.concatenate([dir_a[ok2].astype(np.int8), nnc_fd])

    # Conforming fully-active corner-point grids (e.g. SPE9: a dipped but
    # vertically-conforming horizon) have EXACTLY the cartesian stencil
    # topology: reorder the faces into build_grid's canonical slicing
    # order (x block, y block, z block, C-ordered) and the structured
    # path (stencil matvec + semicoarsened GMG, models/linearize.py)
    # applies unchanged. ACTNUM-holed and stair-step-faulted grids
    # (Norne-class) EMBED instead when _embed_wanted says so: padding
    # cells + canonical zero-trans faces + extra gather faces for the
    # non-conforming connections.
    structured = False
    g1k = g1a[ok2]
    g2k = g2a[ok2]
    dk = dir_a[ok2].astype(np.int64)
    tk = t[ok2]
    stride = np.choose(dk, [1, nx, nx * ny])
    conf = (g2k - g1k) == stride
    nfx = (nx - 1) * ny * nz
    nfy = nx * (ny - 1) * nz
    nfz = nx * ny * (nz - 1)
    if nc == ncg and len(nnc_tr) == 0 and conf.all() and \
            len(g1k) == nfx + nfy + nfz and \
            (np.bincount(dk, minlength=3)
             == np.array([nfx, nfy, nfz])).all():
        slot = _canonical_slot(g1k, dk, nx, ny, nz)
        order = np.argsort(slot)
        assert np.array_equal(slot[order], np.arange(len(slot)))
        face_cells = face_cells[order]
        trans = trans[order]
        face_dir = face_dir[order]
        structured = True
    elif _embed_wanted(nc, ncg, conf, len(nnc_tr), embed):
        real_mask = active_mask
        cart_emb = np.where(real_mask, np.arange(ncg, dtype=np.int32),
                            np.int32(-1))
        nnc_fce, nnc_tre, nnc_fde = _nnc_faces(case, cart_emb)
        depth_all = np.where(np.isfinite(centroid[:, 2]),
                             centroid[:, 2], 0.0)
        return _build_embedded_grid(
            case, (nx, ny, nz), real_mask,
            pv_all=pv_all, volume=volume, depth=depth_all,
            dx=dx, dy=dy, dz=dz, poro=poro, ntg=ntg,
            permx=permx, permy=permy, permz=permz,
            conf_slot=_canonical_slot(g1k[conf], dk[conf], nx, ny, nz),
            conf_tr=tk[conf],
            extra_fc=np.stack([g1k[~conf], g2k[~conf]], axis=1)
            .reshape(-1, 2),
            extra_tr=tk[~conf], extra_dir=dk[~conf].astype(np.int8),
            nnc_fc=nnc_fce, nnc_tr=nnc_tre, nnc_fd=nnc_fde)

    regions = getattr(case, "regions", {})

    def reg(name):
        arr = regions.get(name)
        return (arr[global_cell] - 1).astype(np.int32) if arr is not None \
            else np.zeros(nc, dtype=np.int32)

    return Grid(
        dims=(nx, ny, nz), nc=nc, global_cell=global_cell,
        cart_to_active=cart_to_active,
        dx=dx[global_cell], dy=dy[global_cell], dz=dz[global_cell],
        depth=centroid[global_cell, 2], volume=volume[global_cell],
        poro=poro[global_cell], ntg=ntg[global_cell],
        pore_volume=pv_all[global_cell],
        permx=permx[global_cell], permy=permy[global_cell],
        permz=permz[global_cell],
        face_cells=face_cells, trans=trans, face_dir=face_dir,
        structured=structured,
        satnum=reg("SATNUM"), pvtnum=reg("PVTNUM"),
        eqlnum=reg("EQLNUM"), fipnum=reg("FIPNUM"),
    )


def estimate_cell_velocity(grid: Grid, face_flux):
    """Cell-centered Darcy velocity vectors (nc, 3) from signed face fluxes
    — the miscUtilities estimateCellVelocity capability
    (opm/core/utility/miscUtilities.hpp: flux ->
    cell-velocity interpolation for output/visualization). Per direction,
    the velocity is the average of the two bounding faces' fluxes divided
    by the face area (sealed boundary faces contribute zero flux)."""
    flux = np.asarray(face_flux)
    v = np.zeros((grid.nc, 3))
    area = {0: np.asarray(grid.dy) * np.asarray(grid.dz)
            * np.asarray(grid.ntg),
            1: np.asarray(grid.dx) * np.asarray(grid.dz)
            * np.asarray(grid.ntg),
            2: np.asarray(grid.dx) * np.asarray(grid.dy)}
    fd = np.asarray(grid.face_dir)
    fc = np.asarray(grid.face_cells)
    for d in range(3):
        sel = fd == d
        c1 = fc[sel, 0]
        c2 = fc[sel, 1]
        f = flux[sel]
        np.add.at(v[:, d], c1, f)
        np.add.at(v[:, d], c2, f)
        # every cell has two bounding faces per direction; sealed boundary
        # faces count as zero-flux samples
        v[:, d] /= 2.0
        v[:, d] /= area[d]
    return v
