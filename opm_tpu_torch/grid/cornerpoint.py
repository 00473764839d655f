"""Corner-point (COORD/ZCORN) geometry processing.

Port of the JAX package's grid/cornerpoint.py (host numpy, the same
formulas): pillar interpolation of cell corners, hexahedral volumes and
centroids by tetrahedral decomposition, cell extents for the Peaceman well
index, face area vectors, and NEWTRAN-style half-transmissibilities
    h = K_dir * (A . c) / (c . c),   c = face centroid - cell centroid.

Fault handling: lateral connections are built for every (kL, kR) layer pair
whose face intervals overlap on the shared pillar edges (stair-step faults),
with the face clipped to the overlapping depth interval. The connection list
comes from the native builder ``csrc/cornerpoint.cpp`` (host C++, built at
first use by utils/cuda_lib.py); the Python loops below are its plain twin
(``native=False``), used by the tests only: at the Norne-class size they
take tens of seconds where the native builder takes under one. A failed
native build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from opm_tpu_torch.utils import cuda_lib


def _pillar_xy(coord, zc):
    """Interpolate (x, y) on pillars at depths zc.
    coord: (..., 6) [xt, yt, zt, xb, yb, zb]; zc broadcastable."""
    xt, yt, zt = coord[..., 0], coord[..., 1], coord[..., 2]
    xb, yb, zb = coord[..., 3], coord[..., 4], coord[..., 5]
    dz = zb - zt
    t = np.where(np.abs(dz) > 1e-12, (zc - zt) / np.where(dz == 0, 1, dz),
                 0.0)
    return xt + t * (xb - xt), yt + t * (yb - yt)


def corner_coordinates(dims, coord, zcorn):
    """(nz, ny, nx, 2, 2, 2, 3) corner xyz: [k][j][i][kc][jc][ic]."""
    nx, ny, nz = dims
    coord = np.asarray(coord, dtype=np.float64).reshape(ny + 1, nx + 1, 6)
    zc = np.asarray(zcorn, dtype=np.float64).reshape(nz, 2, ny, 2, nx, 2)
    # reorder to [k, j, i, kc, jc, ic]
    zc = zc.transpose(0, 2, 4, 1, 3, 5)
    out = np.empty((nz, ny, nx, 2, 2, 2, 3))
    for jc in range(2):
        for ic in range(2):
            pil = coord[np.arange(ny) + jc][:, np.arange(nx) + ic]  # (ny,nx,6)
            z = zc[:, :, :, :, jc, ic]                  # (nz, ny, nx, 2)
            x, y = _pillar_xy(pil[None, :, :, None, :], z)
            out[:, :, :, :, jc, ic, 0] = x
            out[:, :, :, :, jc, ic, 1] = y
            out[:, :, :, :, jc, ic, 2] = z
    return out


_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_CP_SIGS = {"cp_connections": (
    [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _F64P, ctypes.c_int64,
     _I64P, _I64P, _F64P, _F64P, _I64P], ctypes.c_int64)}


def cp_connections(dims, corners):
    """Native corner-point connection builder (csrc/cornerpoint.cpp).
    corners: (nz, ny, nx, 2, 2, 2, 3) float64. Returns the connection
    arrays (g1, g2, area (n, 3), face centroid (n, 3), dir)."""
    lib = cuda_lib.load("cornerpoint", _CP_SIGS)
    nx, ny, nz = dims
    c = np.ascontiguousarray(corners, dtype=np.float64)
    if c.shape != (nz, ny, nx, 2, 2, 2, 3):
        raise ValueError(f"corners must be (nz, ny, nx, 2, 2, 2, 3), got "
                         f"{c.shape}")
    # one face per conforming neighbour pair; a stair-step column pairs
    # each cell with at most two overlapping neighbours per side
    cap = ((nz - 1) * ny * nx + (nx - 1) * ny * 2 * nz
           + nx * (ny - 1) * 2 * nz + 16)
    g1 = np.empty(cap, dtype=np.int64)
    g2 = np.empty(cap, dtype=np.int64)
    area = np.empty((cap, 3), dtype=np.float64)
    fc = np.empty((cap, 3), dtype=np.float64)
    dr = np.empty(cap, dtype=np.int64)
    n = lib.cp_connections(
        nx, ny, nz, c.ctypes.data_as(_F64P), cap, g1.ctypes.data_as(_I64P),
        g2.ctypes.data_as(_I64P), area.ctypes.data_as(_F64P),
        fc.ctypes.data_as(_F64P), dr.ctypes.data_as(_I64P))
    if n < 0:
        raise RuntimeError("corner-point connection capacity exceeded "
                           "(a column pairs with more than two neighbour "
                           "cells per side)")
    return (g1[:n].copy(), g2[:n].copy(), area[:n].copy(), fc[:n].copy(),
            dr[:n].copy())


def _quad_geometry(p00, p01, p10, p11):
    """Area vector (diagonal cross product / 2) + centroid of a quad with
    corners in (u, v) orientation p[u][v]."""
    area = 0.5 * np.cross(p11 - p00, p01 - p10)
    centroid = 0.25 * (p00 + p01 + p10 + p11)
    return area, centroid


def cell_geometry(corners):
    """Volumes and centroids from the 8 corners.

    corners: (..., 2, 2, 2, 3) [kc][jc][ic]. Tetrahedral decomposition:
    centre + 2 triangles per face x 6 faces."""
    c = corners
    centre = c.reshape(c.shape[:-4] + (8, 3)).mean(axis=-2)
    # six faces as corner quadruples (quad orientation outward-ish;
    # orientation consistency is irrelevant for |volume|)
    faces = [
        (c[..., 0, 0, 0, :], c[..., 0, 0, 1, :],
         c[..., 0, 1, 0, :], c[..., 0, 1, 1, :]),   # top (k-)
        (c[..., 1, 0, 0, :], c[..., 1, 0, 1, :],
         c[..., 1, 1, 0, :], c[..., 1, 1, 1, :]),   # bottom (k+)
        (c[..., 0, 0, 0, :], c[..., 0, 1, 0, :],
         c[..., 1, 0, 0, :], c[..., 1, 1, 0, :]),   # x-
        (c[..., 0, 0, 1, :], c[..., 0, 1, 1, :],
         c[..., 1, 0, 1, :], c[..., 1, 1, 1, :]),   # x+
        (c[..., 0, 0, 0, :], c[..., 0, 0, 1, :],
         c[..., 1, 0, 0, :], c[..., 1, 0, 1, :]),   # y-
        (c[..., 0, 1, 0, :], c[..., 0, 1, 1, :],
         c[..., 1, 1, 0, :], c[..., 1, 1, 1, :]),   # y+
    ]
    vol = np.zeros(c.shape[:-4])
    cent = np.zeros(c.shape[:-4] + (3,))
    for (a, b, d, e) in faces:
        # two triangles (a,b,e) and (a,e,d); tet volume with apex = centre
        for tri in ((a, b, e), (a, e, d)):
            v0 = tri[0] - centre
            v1 = tri[1] - centre
            v2 = tri[2] - centre
            tv = np.abs(np.einsum("...i,...i->...", v0,
                                  np.cross(v1, v2))) / 6.0
            tc = (tri[0] + tri[1] + tri[2] + centre) / 4.0
            vol += tv
            cent += tv[..., None] * tc
    cent = cent / np.maximum(vol, 1e-300)[..., None]
    return vol, cent


def process_corner_point(dims, coord, zcorn, actnum=None, *, native=True):
    """Full geometry: per-cell volume, centroid and extents, and the
    connection arrays (g1, g2, area_vec (n, 3), face centroid (n, 3), dir)
    in global (cartesian) cell indices, lateral faces clipped by interval
    overlap. ``native=False``: the connections by the Python loops (the
    native builder's plain twin; the order of the connections differs, the
    set does not)."""
    nx, ny, nz = dims
    corners = corner_coordinates(dims, coord, zcorn)
    vol, cent = cell_geometry(corners)
    volf = vol.reshape(-1)
    centf = cent.reshape(-1, 3)
    # axis-aligned cell extents (mean over the 4 corner pairs per axis)
    # for Peaceman well-index geometry
    ext = np.stack([
        np.abs(corners[..., :, :, 1, 0] - corners[..., :, :, 0, 0])
        .mean(axis=(-2, -1)),
        np.abs(corners[..., :, 1, :, 1] - corners[..., :, 0, :, 1])
        .mean(axis=(-2, -1)),
        np.abs(corners[..., 1, :, :, 2] - corners[..., 0, :, :, 2])
        .mean(axis=(-2, -1)),
    ], axis=-1).reshape(-1, 3)

    def gid(i, j, k):
        return (k * ny + j) * nx + i

    if native:
        return dict(volume=volf, centroid=centf,
                    conn_arrays=cp_connections(dims, corners), extent=ext)

    conns = []

    # vertical (k-direction) faces: between (k) bottom and (k+1) top of the
    # same column — conforming by construction in corner-point grids
    for k in range(nz - 1):
        cb = corners[k, :, :, 1]        # (ny, nx, 2, 2, 3) bottom corners
        area, fc = _quad_geometry(cb[:, :, 0, 0], cb[:, :, 0, 1],
                                  cb[:, :, 1, 0], cb[:, :, 1, 1])
        for j in range(ny):
            for i in range(nx):
                conns.append((gid(i, j, k), gid(i, j, k + 1),
                              area[j, i], fc[j, i], fc[j, i], 2))

    # lateral faces: fast vectorized path for vertically conforming
    # interfaces (zcorn matches across the shared pillars), stair-step
    # fault pairing by z-interval overlap otherwise
    for axis, (di, dj) in ((0, (1, 0)), (1, (0, 1))):
        if axis == 0:
            faceL = corners[:, :, :-1, :, :, 1]    # (nz, ny, nx-1, kc, jc, 3)
            faceR = corners[:, :, 1:, :, :, 0]
        else:
            faceL = corners[:, :-1, :, :, 1, :]
            faceR = corners[:, 1:, :, :, 0, :]
        conforming = np.allclose(faceL[..., 2], faceR[..., 2], atol=1e-9)
        if conforming:
            area, fc = _quad_geometry(faceL[..., 0, 0, :], faceL[..., 0, 1, :],
                                      faceL[..., 1, 0, :], faceL[..., 1, 1, :])
            nzl, nyl, nxl = area.shape[:3]
            for k in range(nzl):
                for j in range(nyl):
                    for i in range(nxl):
                        conns.append((gid(i, j, k), gid(i + di, j + dj, k),
                                      area[k, j, i], fc[k, j, i],
                                      fc[k, j, i], axis))
            continue
        for j in range(ny - dj):
            for i in range(nx - di):
                for kL in range(nz):
                    # left cell's + side face corner depths on both edges
                    if axis == 0:
                        cL = corners[kL, j, i, :, :, 1]      # (kc, jc, 3)
                    else:
                        cL = corners[kL, j, i, :, 1, :]      # (kc, ic, 3)
                    zL_top = cL[0, :, 2]
                    zL_bot = cL[1, :, 2]
                    for kR in range(nz):
                        if axis == 0:
                            cR = corners[kR, j + dj, i + di, :, :, 0]
                        else:
                            cR = corners[kR, j + dj, i + di, :, 0, :]
                        zR_top = cR[0, :, 2]
                        zR_bot = cR[1, :, 2]
                        zt = np.maximum(zL_top, zR_top)
                        zb = np.minimum(zL_bot, zR_bot)
                        if np.all(zb - zt <= 1e-12):
                            continue
                        zt_c = np.minimum(zt, zb)
                        # clipped quad on the shared pillar pair: corners at
                        # (edge 0/1, top/bot) — xy from the left face edges
                        p = np.empty((2, 2, 3))
                        for e in range(2):
                            xy_t = cL[0, e, :2]
                            xy_b = cL[1, e, :2]
                            span = max(zL_bot[e] - zL_top[e], 1e-12)
                            for tb, zv in enumerate((zt_c[e], zb[e])):
                                t = np.clip((zv - zL_top[e]) / span, 0, 1)
                                p[e, tb, :2] = xy_t + t * (xy_b - xy_t)
                                p[e, tb, 2] = zv
                        area, fc = _quad_geometry(p[0, 0], p[0, 1],
                                                  p[1, 0], p[1, 1])
                        conns.append((gid(i, j, kL),
                                      gid(i + di, j + dj, kR),
                                      area, fc, fc, axis))
    g1 = np.asarray([c[0] for c in conns], dtype=np.int64)
    g2 = np.asarray([c[1] for c in conns], dtype=np.int64)
    area_a = (np.stack([np.asarray(c[2]) for c in conns])
              if conns else np.zeros((0, 3)))
    fc_a = (np.stack([np.asarray(c[3]) for c in conns])
            if conns else np.zeros((0, 3)))
    dir_a = np.asarray([c[5] for c in conns], dtype=np.int64)
    return dict(volume=volf, centroid=centf,
                conn_arrays=(g1, g2, area_a, fc_a, dir_a), extent=ext)


def half_trans(perm_dir, area_vec, face_centroid, cell_centroid):
    """NEWTRAN half-transmissibility for one cell side."""
    c = face_centroid - cell_centroid
    cc = np.einsum("...i,...i->...", c, c)
    ac = np.abs(np.einsum("...i,...i->...", area_vec, c))
    return perm_dir * ac / np.maximum(cc, 1e-300)
