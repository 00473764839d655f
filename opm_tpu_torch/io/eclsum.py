"""ECL binary summary files (SMSPEC + UNSMRY).

The reference writes summary data through opm-common's EclipseIO
(BlackoilOutputWriter, opm/autodiff/
SimulatorFullyImplicitBlackoilOutput.hpp:139-206). This module implements the
(publicly documented) ECLIPSE file layout directly: big-endian Fortran
unformatted records, keyword blocks of (8-char name, count, 4-char type)
headers followed by 1000-element (105 for CHAR) data records — so the output
loads in ResInsight / opm-common / ecl tooling. A reader is included for
round-trip tests.
"""

from __future__ import annotations

import datetime
import os
import struct
from typing import Dict, List

import numpy as np

_MAX_BLOCK = {"INTE": 1000, "REAL": 1000, "DOUB": 1000, "LOGI": 1000,
              "CHAR": 105}
_ITEM = {"INTE": (">i4", 4), "REAL": (">f4", 4), "DOUB": (">f8", 8),
         "LOGI": (">i4", 4), "CHAR": (None, 8)}


def _write_rec(f, payload: bytes):
    n = struct.pack(">i", len(payload))
    f.write(n)
    f.write(payload)
    f.write(n)


def write_keyword(f, name: str, typ: str, values):
    """One keyword block: header record + chunked data records."""
    hdr = struct.pack(">8si4s", name.ljust(8).encode(), len(values),
                      typ.encode())
    _write_rec(f, hdr)
    if typ == "MESS":   # marker keyword: header only, no data records
        return
    mx = _MAX_BLOCK[typ]
    for i in range(0, len(values), mx):
        chunk = values[i:i + mx]
        if typ == "CHAR":
            payload = b"".join(str(v).ljust(8)[:8].encode() for v in chunk)
        else:
            payload = np.asarray(chunk).astype(_ITEM[typ][0]).tobytes()
        _write_rec(f, payload)


def _read_rec(f):
    raw = f.read(4)
    if len(raw) < 4:
        return None
    n = struct.unpack(">i", raw)[0]
    payload = f.read(n)
    f.read(4)
    return payload


def read_ecl_file(path) -> List[tuple]:
    """All (keyword, type, values) blocks of an ECL binary file."""
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = _read_rec(f)
            if hdr is None or len(hdr) != 16:
                break
            name, count, typ = struct.unpack(">8si4s", hdr)
            name = name.decode().strip()
            typ = typ.decode()
            vals = []
            remaining = count
            while remaining > 0:
                payload = _read_rec(f)
                if typ == "CHAR":
                    k = len(payload) // 8
                    vals.extend(payload[i * 8:(i + 1) * 8].decode().strip()
                                for i in range(k))
                    remaining -= k
                else:
                    arr = np.frombuffer(payload, dtype=_ITEM[typ][0])
                    vals.extend(arr.tolist())
                    remaining -= len(arr)
            out.append((name, typ, vals))
    return out


# mnemonic -> (display unit FIELD, SI -> FIELD factor) ; rates are per day
_DAY = 86400.0
_STB = 0.158987294928
_MSCF = 28.316846592
_PSI = 6894.757293168361
_FIELD_UNITS = {
    "PR": ("PSIA", 1.0 / _PSI),
    "BHP": ("PSIA", 1.0 / _PSI),
    "THP": ("PSIA", 1.0 / _PSI),
    "OPR": ("STB/DAY", _DAY / _STB),
    "WPR": ("STB/DAY", _DAY / _STB),
    "LPR": ("STB/DAY", _DAY / _STB),
    "OIR": ("STB/DAY", _DAY / _STB),
    "WIR": ("STB/DAY", _DAY / _STB),
    "GPR": ("MSCF/DAY", _DAY / _MSCF),
    "GIR": ("MSCF/DAY", _DAY / _MSCF),
    "GOR": ("MSCF/STB", _STB / _MSCF),
    "WCT": ("", 1.0),
    "OPT": ("STB", 1.0 / _STB),
    "WPT": ("STB", 1.0 / _STB),
    "WIT": ("STB", 1.0 / _STB),
    "GPT": ("MSCF", 1.0 / _MSCF),
    "GIT": ("MSCF", 1.0 / _MSCF),
}
_METRIC_UNITS = {
    "PR": ("BARSA", 1e-5), "BHP": ("BARSA", 1e-5), "THP": ("BARSA", 1e-5),
    "OPR": ("SM3/DAY", _DAY), "WPR": ("SM3/DAY", _DAY),
    "LPR": ("SM3/DAY", _DAY), "OIR": ("SM3/DAY", _DAY),
    "WIR": ("SM3/DAY", _DAY), "GPR": ("SM3/DAY", _DAY),
    "GIR": ("SM3/DAY", _DAY), "GOR": ("SM3/SM3", 1.0), "WCT": ("", 1.0),
    "OPT": ("SM3", 1.0), "WPT": ("SM3", 1.0), "WIT": ("SM3", 1.0),
    "GPT": ("SM3", 1.0), "GIT": ("SM3", 1.0),
}


def _unit_for(mnemonic: str, system: str):
    table = _FIELD_UNITS if system == "FIELD" else _METRIC_UNITS
    for suffix, val in table.items():
        if mnemonic[1:].startswith(suffix):
            return val
    return ("", 1.0)


def write_summary(base_path: str, rows: List[dict], *, dims=(1, 1, 1),
                  start_date=None, unit_system="METRIC", requested=None):
    """Write CASE.SMSPEC + CASE.UNSMRY from SummaryCollector rows (SI).

    With `requested` (the deck SUMMARY section expanded by
    io/summaryconfig.expand_requests) the files carry EXACTLY those
    vectors plus TIME — the reference's SummaryConfig-driven output;
    region keys ("RPR:3") map to SMSPEC NUMS, block keys ("BPR:i,j,k")
    to the 1-based cartesian cell index."""
    start_date = start_date or datetime.datetime(1983, 1, 1)
    if requested is not None:
        keys = list(requested)
    else:
        keys = sorted({k for r in rows for k in r if k != "time"})
    mnemonics = ["TIME"]
    wgnames = [":+:+:+:+"]
    units = ["DAYS"]
    factors = [1.0]
    nums = [0]
    for k in keys:
        if ":" in k:
            mnem, rest = k.split(":", 1)
        else:
            mnem, rest = k, ""
        well = ":+:+:+:+"
        num = 0
        if mnem.startswith("R") and rest.isdigit():
            num = int(rest)
        elif mnem.startswith("B") and "," in rest:
            i, j, kk = (int(t) for t in rest.split(","))
            num = (kk - 1) * dims[0] * dims[1] + (j - 1) * dims[0] + i
        elif rest:
            well = rest
        u, f = _unit_for(mnem, unit_system)
        mnemonics.append(mnem)
        wgnames.append(well)
        units.append(u)
        factors.append(f)
        nums.append(num)
    nlist = len(mnemonics)

    os.makedirs(os.path.dirname(os.path.abspath(base_path)), exist_ok=True)
    with open(base_path + ".SMSPEC", "wb") as f:
        write_keyword(f, "RESTART", "CHAR", [""] * 9)
        write_keyword(f, "DIMENS", "INTE",
                      [nlist, dims[0], dims[1], dims[2], 0, -1])
        write_keyword(f, "KEYWORDS", "CHAR", mnemonics)
        write_keyword(f, "WGNAMES", "CHAR", wgnames)
        write_keyword(f, "NUMS", "INTE", nums)
        write_keyword(f, "UNITS", "CHAR", units)
        write_keyword(f, "STARTDAT", "INTE",
                      [start_date.day, start_date.month, start_date.year,
                       0, 0, 0])

    with open(base_path + ".UNSMRY", "wb") as f:
        for i, r in enumerate(rows):
            write_keyword(f, "SEQHDR", "INTE", [1])
            write_keyword(f, "MINISTEP", "INTE", [i])
            params = [r["time"] / 1.0]  # already days in the collector
            for k, fac in zip(keys, factors[1:]):
                params.append(r.get(k, 0.0) * fac)
            write_keyword(f, "PARAMS", "REAL", params)


def read_summary(base_path: str) -> Dict[str, np.ndarray]:
    """Read back (own) SMSPEC/UNSMRY into {key: series} (display units)."""
    spec = {n: v for n, t, v in read_ecl_file(base_path + ".SMSPEC")}
    mnemonics = spec["KEYWORDS"]
    wgnames = spec["WGNAMES"]
    nums = spec.get("NUMS", [0] * len(mnemonics))
    nxy = None
    if "DIMENS" in spec:
        d = spec["DIMENS"]
        nxy = (int(d[1]), int(d[2]))
    keys = []
    for m, w, n in zip(mnemonics, wgnames, nums):
        if m.startswith("R") and n > 0:
            keys.append(f"{m}:{int(n)}")
        elif m.startswith("B") and n > 0 and nxy:
            g = int(n) - 1
            i = g % nxy[0] + 1
            j = (g // nxy[0]) % nxy[1] + 1
            k = g // (nxy[0] * nxy[1]) + 1
            keys.append(f"{m}:{i},{j},{k}")
        else:
            keys.append(m if w in ("", ":+:+:+:+") else f"{m}:{w}")
    series = {k: [] for k in keys}
    for name, typ, vals in read_ecl_file(base_path + ".UNSMRY"):
        if name == "PARAMS":
            for k, v in zip(keys, vals):
                series[k].append(v)
    return {k: np.asarray(v) for k, v in series.items()}


# ---------------------------------------------------------------------------
# ECL unified restart (UNRST) — minimal SOLUTION-section writer/reader
# ---------------------------------------------------------------------------
def write_unrst(base_path: str, steps: List[dict], *, dims=(1, 1, 1),
                start_date=(1, 1, 2000)):
    """Unified restart file with per-step SEQNUM + headers + solution
    arrays (the role the reference fills through EclipseIO restart output,
    BlackoilOutputWriter::writeTimeStep -> RestartIO; file layout per the
    ECL unified-restart convention: SEQNUM, INTEHEAD, then cell arrays).

    steps: list of dicts with keys 'seqnum', 'time_days', and cell arrays
    ('PRESSURE' [bar], 'SWAT', 'SGAS', 'RS', 'RV', ...). Arrays are written
    as DOUB in the given order.
    """
    nx, ny, nz = dims
    path = base_path + ".UNRST"
    with open(path, "wb") as f:
        for st in steps:
            write_keyword(f, "SEQNUM", "INTE", [int(st["seqnum"])])
            ih = [0] * 95
            ih[8] = nx
            ih[9] = ny
            ih[10] = nz
            ih[11] = nx * ny * nz
            if hasattr(start_date, "day"):      # datetime-like
                sd = (start_date.day, start_date.month, start_date.year)
            else:
                sd = tuple(start_date)
            ih[64] = sd[0]   # day
            ih[65] = sd[1]   # month
            ih[66] = sd[2]   # year
            ih[94] = 100             # simulator id
            write_keyword(f, "INTEHEAD", "INTE", ih)
            write_keyword(f, "DOUBHEAD", "DOUB", [float(st["time_days"])])
            write_keyword(f, "STARTSOL", "MESS", [])
            for name, arr in st.items():
                if name in ("seqnum", "time_days"):
                    continue
                write_keyword(f, name[:8].upper(), "DOUB",
                              np.asarray(arr, dtype=np.float64))
            write_keyword(f, "ENDSOL", "MESS", [])
    return path


def read_unrst(path: str) -> List[dict]:
    """Parse a UNRST file back into per-step dicts (restart consumption +
    the regression-comparison role of the reference's compareECLFiles)."""
    steps: List[dict] = []
    cur = None
    in_sol = False
    for name, typ, vals in read_ecl_file(path):
        if name == "SEQNUM":
            cur = dict(seqnum=int(vals[0]))
            steps.append(cur)
            in_sol = False
        elif cur is None:
            continue
        elif name == "DOUBHEAD":
            cur["time_days"] = float(vals[0])
        elif name == "STARTSOL":
            in_sol = True
        elif name == "ENDSOL":
            in_sol = False
        elif in_sol and typ == "DOUB":
            cur[name] = np.asarray(vals)
    return steps


# ---------------------------------------------------------------------------
# ECL INIT file — static geology/property snapshot
# (the reference writes it through EclipseIO at FlowMain writeInit;
#  compared by the Norne-init regression, compareECLFiles.cmake:141-146)
# ---------------------------------------------------------------------------
def write_init(base_path: str, grid, *, unit_system="METRIC",
               start_date=(1, 1, 2000)):
    """INIT file: INTEHEAD/LOGIHEAD/DOUBHEAD + PORV on the FULL cartesian
    grid + per-active-cell static arrays (DEPTH/DX/DY/DZ/PORO/PERM*/NTG)
    + directional transmissibilities TRANX/TRANY/TRANZ (trans of the face
    to the +direction neighbor, 0 at domain/inactive boundaries), all in
    deck output units."""
    from opm_tpu_torch.utils.units import si_factor

    nx, ny, nz = grid.dims
    ncg = nx * ny * nz
    # embedded grids: the file covers the REAL active cells only; slot ->
    # compressed active rank for cell/NNC indexing
    rc = grid.real_cells
    nc = len(rc)
    rank = np.full(grid.nc, -1, dtype=np.int64)
    rank[rc] = np.arange(nc)
    u_len = 1.0 / si_factor(unit_system, "Length")
    u_vol = 1.0 / si_factor(unit_system, "ReservoirVolume")
    u_perm = 1.0 / si_factor(unit_system, "Permeability")
    u_tran = 1.0 / si_factor(unit_system, "Transmissibility")

    path = base_path + ".INIT"
    with open(path, "wb") as f:
        ih = [0] * 95
        ih[8], ih[9], ih[10], ih[11] = nx, ny, nz, nc
        ih[14] = 1  # phase indicator slot (unused placeholder)
        if hasattr(start_date, "day"):
            sd = (start_date.day, start_date.month, start_date.year)
        else:
            sd = tuple(start_date)
        ih[64], ih[65], ih[66] = sd
        ih[94] = 100
        write_keyword(f, "INTEHEAD", "INTE", ih)
        write_keyword(f, "LOGIHEAD", "LOGI", [0] * 15)
        write_keyword(f, "DOUBHEAD", "DOUB", [0.0])
        porv = np.zeros(ncg)
        porv[grid.real_global_cell] = np.asarray(grid.pore_volume)[rc]
        write_keyword(f, "PORV", "REAL", porv * u_vol)
        write_keyword(f, "DEPTH", "REAL", np.asarray(grid.depth)[rc] * u_len)
        write_keyword(f, "DX", "REAL", np.asarray(grid.dx)[rc] * u_len)
        write_keyword(f, "DY", "REAL", np.asarray(grid.dy)[rc] * u_len)
        write_keyword(f, "DZ", "REAL", np.asarray(grid.dz)[rc] * u_len)
        write_keyword(f, "PORO", "REAL", np.asarray(grid.poro)[rc])
        write_keyword(f, "PERMX", "REAL",
                      np.asarray(grid.permx)[rc] * u_perm)
        write_keyword(f, "PERMY", "REAL",
                      np.asarray(grid.permy)[rc] * u_perm)
        write_keyword(f, "PERMZ", "REAL",
                      np.asarray(grid.permz)[rc] * u_perm)
        write_keyword(f, "NTG", "REAL", np.asarray(grid.ntg)[rc])
        # TRANX/TRANY/TRANZ: active-cell arrays, face assigned to the
        # lower-index cell of each +direction CONFORMING connection;
        # non-conforming extras (stair-step faults) join the NNC list,
        # which is how the reference exports them too
        fc = np.asarray(grid.face_cells)
        fd = np.asarray(grid.face_dir)
        tr = np.asarray(grid.trans)
        g = np.asarray(grid.global_cell)
        stride = {0: 1, 1: nx, 2: nx * ny}
        nnc_sel = (fd == 3) & (tr != 0.0)
        real = (rank[fc[:, 0]] >= 0) & (rank[fc[:, 1]] >= 0)
        for d, name in ((0, "TRANX"), (1, "TRANY"), (2, "TRANZ")):
            a = np.zeros(nc)
            sel = (fd == d) & real
            conf = sel & (g[fc[:, 1]] - g[fc[:, 0]] == stride[d])
            a[rank[fc[conf, 0]]] = tr[conf]
            write_keyword(f, name, "REAL", a * u_tran)
            nnc_sel |= sel & ~conf & (tr != 0.0)
        # NNC list (if any): cell pairs (1-based active index) + trans
        if nnc_sel.any():
            write_keyword(f, "NNC1", "INTE", rank[fc[nnc_sel, 0]] + 1)
            write_keyword(f, "NNC2", "INTE", rank[fc[nnc_sel, 1]] + 1)
            write_keyword(f, "TRANNNC", "REAL", tr[nnc_sel] * u_tran)
    return path


def read_init(path: str) -> Dict[str, np.ndarray]:
    """INIT arrays keyed by keyword name (compare_ecl / regression use)."""
    out: Dict[str, np.ndarray] = {}
    for name, typ, vals in read_ecl_file(path):
        out[name] = np.asarray(vals)
    return out


# ---------------------------------------------------------------------------
# EGRID — geometry export (FILEHEAD/GRIDHEAD/COORD/ZCORN/ACTNUM/ENDGRID)
# ---------------------------------------------------------------------------
def write_egrid(base_path: str, case, *, unit_system=None):
    """EGRID from the case's geometry: pass COORD/ZCORN through for
    corner-point decks, or synthesize pillars from DX/DY/DZ/TOPS for
    block-cartesian ones (the writeInit/EclipseIO EGRID role)."""
    ga = case.grid_arrays
    nx, ny, nz = case.runspec.dims
    ncg = nx * ny * nz
    us = unit_system or case.runspec.unit_system
    from opm_tpu_torch.utils.units import si_factor
    u_len = 1.0 / si_factor(us, "Length")

    if "COORD" in ga and "ZCORN" in ga:
        coord = np.asarray(ga["COORD"], dtype=np.float64)
        zcorn = np.asarray(ga["ZCORN"], dtype=np.float64)
    else:
        # synthesize a block-cartesian corner-point description
        def line(vec, n, axis):
            # cumulative cell edges along one axis from per-cell sizes
            sizes = np.asarray(vec, dtype=np.float64).reshape(nz, ny, nx)
            if axis == 0:
                edge = np.concatenate([[0.0], np.cumsum(sizes[0, 0, :])])
            elif axis == 1:
                edge = np.concatenate([[0.0], np.cumsum(sizes[0, :, 0])])
            else:
                edge = np.concatenate([[0.0], np.cumsum(sizes[:, 0, 0])])
            return edge

        if "DX" in ga:
            xs = line(ga["DX"], nx, 0)
            ys = line(ga["DY"], ny, 1)
            dz3 = np.asarray(ga["DZ"], dtype=np.float64).reshape(nz, ny, nx)
        else:
            xs = np.concatenate([[0.0], np.cumsum(np.asarray(ga["DXV"]))])
            ys = np.concatenate([[0.0], np.cumsum(np.asarray(ga["DYV"]))])
            dzv = np.asarray(ga["DZV"], dtype=np.float64)
            dz3 = np.broadcast_to(dzv[:, None, None], (nz, ny, nx)).copy()
        tops = np.asarray(ga.get("TOPS", np.zeros(nx * ny)),
                          dtype=np.float64)
        top0 = tops[:nx * ny].reshape(ny, nx)
        # layer interfaces per column
        zfaces = np.empty((nz + 1, ny, nx))
        zfaces[0] = top0
        for k in range(nz):
            zfaces[k + 1] = zfaces[k] + dz3[k]
        coord = np.empty((ny + 1, nx + 1, 6))
        X, Y = np.meshgrid(xs, ys)
        coord[:, :, 0] = X
        coord[:, :, 1] = Y
        coord[:, :, 2] = zfaces[0].min()
        coord[:, :, 3] = X
        coord[:, :, 4] = Y
        coord[:, :, 5] = zfaces[-1].max()
        coord = coord.reshape(-1)
        zc = np.empty((nz, 2, ny, 2, nx, 2))
        for k in range(nz):
            for kc in range(2):
                zf = zfaces[k + kc]
                # corner depth = column interface depth (block grid)
                zc[k, kc, :, 0, :, 0] = zf
                zc[k, kc, :, 0, :, 1] = zf
                zc[k, kc, :, 1, :, 0] = zf
                zc[k, kc, :, 1, :, 1] = zf
        zcorn = zc.reshape(-1)

    path = base_path + ".EGRID"
    with open(path, "wb") as f:
        fh = [0] * 100
        fh[0] = 3    # version
        fh[1] = 2026
        fh[4] = 0    # corner-point type
        write_keyword(f, "FILEHEAD", "INTE", fh)
        gh = [0] * 100
        gh[0] = 1    # grid type: corner point
        gh[1], gh[2], gh[3] = nx, ny, nz
        write_keyword(f, "GRIDHEAD", "INTE", gh)
        write_keyword(f, "COORD", "REAL",
                      np.asarray(coord, dtype=np.float64) * u_len)
        write_keyword(f, "ZCORN", "REAL",
                      np.asarray(zcorn, dtype=np.float64) * u_len)
        act = np.asarray(ga.get("ACTNUM", np.ones(ncg)), dtype=np.int64)
        write_keyword(f, "ACTNUM", "INTE", act)
        write_keyword(f, "ENDGRID", "INTE", [])
    return path
