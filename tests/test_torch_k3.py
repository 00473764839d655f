"""The launch geometry of K3's structured divergence (csrc/tpfa.cu
tpfa_div_kernel), on the CPU: models/blackoil.py div_tiles gives the
tiles and z runs, and this file mirrors the kernel's thread-to-cell map
(block (bx, by) of the tiles, run r; thread (ti, tj) at cell (bx (tx - 2)
- 1 + ti, by (ty - 2) - 1 + tj); outputs where 0 < ti < tx - 1 and 0 <
tj < ty - 1; the +x faces of the cells of threads ti < tx - 1 in the
output rows, the +y faces of the cells of threads tj < ty - 1 in the
output columns, the +z faces of the output cells and a run's first -z
faces). For each grid every cell is an output
of exactly one (tile, run); every face is evaluated by the block that
owns its left cell, and again only by the one block whose halo holds its
left cell (the halo column's +x, the halo row's +y and a run's first -z
faces); every face an output cell sums is evaluated in its block.

The same for the tangent entry's geometry (tangent_geometry, csrc/tpfa.cu
tpfa_tangent_whole_kernel and tpfa_tangent_march_kernel) at B tangent
sets: the whole-grid block's thread (i, j, z) is cell (i, j, z mod nz),
its face in direction z div nz as the left cell and its output component
z div nz, and the blocks' chunks of sets cover every set once; the march
is the forward's thread map with a block per set. No arrays, no kernel:
the kernels' bits are held on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest

from opm_tpu_torch.models.blackoil import (TAN_MARCH_SMEM, DivTiles,
                                          _dir_segments, div_tiles,
                                          tangent_geometry)

# an H100's 132 SMs times 2 or 3 resident blocks, and one block
RESIDENT = (264, 396, 1)
DIMS = [(1, 1, 1), (1, 7, 1), (7, 1, 1), (10, 10, 3), (15, 44, 4),
        (60, 220, 85)]


def _block_work(g, dims, bx, by, r):
    """(output cells, faces evaluated as their block's own, faces
    evaluated as halo) of one block, as flat indices."""
    nx, ny, nz = dims
    area = nx * ny
    nfx = (nx - 1) * ny * nz
    nfz0 = nfx + nx * (ny - 1) * nz
    ti, tj = np.meshgrid(np.arange(g.tx), np.arange(g.ty), indexing="xy")
    i = bx * (g.tx - 2) - 1 + ti
    j = by * (g.ty - 2) - 1 + tj
    inn = (i >= 0) & (i < nx) & (j >= 0) & (j < ny)
    mid_i = (ti > 0) & (ti < g.tx - 1)
    mid_j = (tj > 0) & (tj < g.ty - 1)
    out = inn & mid_i & mid_j
    k0 = r * g.zrun
    ks = np.arange(k0, min(nz, k0 + g.zrun))
    col = j * nx + i
    cells = (ks[:, None] * area + col[out][None, :]).ravel()
    own, halo = [], []
    for sel, idx in (
            (inn & mid_j & (ti < g.tx - 1) & (i + 1 < nx),
             lambda k, m: (k * ny + j[m]) * (nx - 1) + i[m]),
            (inn & mid_i & (tj < g.ty - 1) & (j + 1 < ny),
             lambda k, m: nfx + (k * (ny - 1) + j[m]) * nx + i[m])):
        for k in ks:
            f = idx(k, sel)
            left_out = out[sel]
            own.append(f[left_out])
            halo.append(f[~left_out])
    for k in ks:
        if k + 1 < nz:
            own.append(nfz0 + k * area + col[out])
    if k0 > 0 and len(ks):
        halo.append(nfz0 + (k0 - 1) * area + col[out])
    cat = lambda a: (np.concatenate(a) if a  # noqa: E731
                     else np.zeros(0, dtype=np.int64))
    return cells, cat(own), cat(halo)


def _faces_of(dims, cells):
    """The faces the given cells sum (all six directions, where they
    exist)."""
    nx, ny, nz = dims
    area = nx * ny
    nfx = (nx - 1) * ny * nz
    nfz0 = nfx + nx * (ny - 1) * nz
    i, j, k = cells % nx, (cells // nx) % ny, cells // area
    out = []
    for m, f in (
            (i + 1 < nx, (k * ny + j) * (nx - 1) + i),
            (i > 0, (k * ny + j) * (nx - 1) + i - 1),
            (j + 1 < ny, nfx + (k * (ny - 1) + j) * nx + i),
            (j > 0, nfx + (k * (ny - 1) + j - 1) * nx + i),
            (k + 1 < nz, nfz0 + k * area + j * nx + i),
            (k > 0, nfz0 + (k - 1) * area + j * nx + i)):
        out.append(f[m])
    return np.concatenate(out)


@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
def test_div_tiles_cover_every_cell_and_face(dims, resident):
    nx, ny, nz = dims
    nc = nx * ny * nz
    nf = sum(n for _, _, n in _dir_segments(dims))
    g = div_tiles(dims, resident)
    tiles = g.tiles_x * g.tiles_y
    # the launch: blocks (32, 8) within the kernel's __launch_bounds__,
    # the grid within CUDA's limits, shared memory (two planes of 12
    # values and the x and y faces' 3 fluxes a thread) within the 227 KB
    # a block may opt in to, runs covering every plane
    assert (g.tx, g.ty) == (32, 8) and g.tx * g.ty <= 256
    assert 0 < tiles < 2 ** 31 and 0 < g.runs <= min(nz, 65535)
    assert g.smem == 8 * (2 * 12 + 6) * g.tx * g.ty
    assert g.smem <= 232448
    assert (g.runs - 1) * g.zrun < nz <= g.runs * g.zrun
    assert tiles * g.runs <= max(resident, tiles)
    owner = np.zeros(nc, dtype=np.int64)
    own = np.zeros(nf, dtype=np.int64)
    evals = np.zeros(nf, dtype=np.int64)
    for r in range(g.runs):
        for by in range(g.tiles_y):
            for bx in range(g.tiles_x):
                cells, f_own, f_halo = _block_work(g, dims, bx, by, r)
                np.add.at(owner, cells, 1)
                np.add.at(own, f_own, 1)
                mine = np.concatenate([f_own, f_halo])
                np.add.at(evals, mine, 1)
                # a face is evaluated at most once a block
                assert len(np.unique(mine)) == len(mine)
                # every face the block's outputs sum is evaluated there
                assert np.isin(_faces_of(dims, cells), mine).all()
    assert (owner == 1).all()
    assert (own == 1).all()
    assert ((evals == 1) | (evals == 2)).all()
    # the faces evaluated twice are the halo's: at most the tiles' edges
    # (a column and a row of faces a tile and plane) and the runs' first
    # planes
    twice = int((evals == 2).sum())
    assert twice <= tiles * nz * (g.ty + g.tx) + g.runs * nx * ny
    if dims == (60, 220, 85) and resident == 396:
        assert (g.tiles_x, g.tiles_y, g.zrun, g.runs) == (2, 37, 17, 5)
        assert twice / nf < 0.2


def _whole_work(dims):
    """(output (component, cell) pairs as 3 c + r, faces evaluated) of the
    whole-grid tangent block, mirroring its thread map."""
    nx, ny, nz = dims
    area = nx * ny
    nfx = (nx - 1) * ny * nz
    nfy = nx * (ny - 1) * nz
    i, j, z = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(3 * nz),
                          indexing="ij")
    r = np.where(z >= 2 * nz, 2, np.where(z >= nz, 1, 0))
    k = z - r * nz
    c = k * area + j * nx + i
    has = np.where(r == 0, i + 1 < nx, np.where(r == 1, j + 1 < ny,
                                                k + 1 < nz))
    fi = np.where(r == 0, (k * ny + j) * (nx - 1) + i,
                  np.where(r == 1, nfx + (k * (ny - 1) + j) * nx + i,
                           nfx + nfy + c))
    return (3 * c + r).ravel(), fi[has]


# an H100's 132 SMs times one block (the whole-grid kernel) or two (the
# march), and one block
TAN_RESIDENT = (132, 264, 1)


@pytest.mark.parametrize("resident", TAN_RESIDENT)
@pytest.mark.parametrize("B", (1, 3, 7, 908))
@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
def test_tangent_geometry_covers_sets_cells_and_faces(dims, B, resident):
    nx, ny, nz = dims
    nc = nx * ny * nz
    nf = sum(n for _, _, n in _dir_segments(dims))
    g = tangent_geometry(dims, B, resident)
    assert g.whole == (dims in ((1, 1, 1), (1, 7, 1), (7, 1, 1),
                                (10, 10, 3)))
    bx, by, bz = (tuple(g.block) + (1,))[:3]
    gx, gy, gz = g.grid
    # the launch within CUDA's limits and the 227 KB of shared memory a
    # block may opt in to
    assert bx * by * bz <= 1024 and bz <= 64
    assert 0 < gx < 2 ** 31 and 0 < gy <= 65535 and 0 < gz <= 65535
    assert g.smem <= 232448
    if g.whole:
        assert g.block == (nx, ny, 3 * nz) and (gy, gz) == (1, 1)
        assert g.smem == 8 * 31 * nc
        # every set in exactly one block's chunk, no chunk empty, the
        # chunks within the resident blocks
        sets = np.zeros(B, dtype=np.int64)
        for x in range(gx):
            lo, hi = x * g.dirs, min(B, (x + 1) * g.dirs)
            assert lo < hi
            sets[lo:hi] += 1
        assert (sets == 1).all()
        assert gx <= max(1, min(B, resident))
        outs, faces = _whole_work(dims)
        # every (cell, component) an output of the block, every face
        # evaluated once there (the block owns them all)
        assert np.array_equal(np.sort(outs), np.arange(3 * nc))
        assert np.array_equal(np.sort(faces), np.arange(nf))
        return
    # the march: the forward's thread map, a block per set
    assert g.block == (32, 8) and gz == B and g.dirs == 1
    assert g.smem == TAN_MARCH_SMEM == 8 * (2 * 23 + 6) * 256
    t = DivTiles(32, 8, g.tiles_x, gx // g.tiles_x, g.zrun, gy, g.smem)
    assert t.tiles_x * t.tiles_y == gx
    assert (gy - 1) * g.zrun < nz <= gy * g.zrun
    assert gx * gy * B <= max(4 * resident, gx * B)
    owner = np.zeros(nc, dtype=np.int64)
    own = np.zeros(nf, dtype=np.int64)
    evals = np.zeros(nf, dtype=np.int64)
    for r in range(gy):
        for y in range(t.tiles_y):
            for x in range(t.tiles_x):
                cells, f_own, f_halo = _block_work(t, dims, x, y, r)
                np.add.at(owner, cells, 1)
                np.add.at(own, f_own, 1)
                mine = np.concatenate([f_own, f_halo])
                np.add.at(evals, mine, 1)
                assert len(np.unique(mine)) == len(mine)
                assert np.isin(_faces_of(dims, cells), mine).all()
    # per set (each block one set, every set a grid slice): every cell an
    # output once, every face's tangent evaluated by its owner and at most
    # once more as halo
    assert (owner == 1).all()
    assert (own == 1).all()
    assert ((evals == 1) | (evals == 2)).all()
