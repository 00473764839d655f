"""Eclipse .DATA deck tokenizer and keyword parser.

The reference consumes decks through opm-common's Parser/Deck/EclipseState
(an out-of-repo dependency, wired in at
opm/autodiff/FlowMain.hpp:430 readDeckInput). This module is a
self-contained re-implementation of the subset of the deck language needed by
the SPE1/SPE3/SPE9-class benchmark decks plus the two-phase / polymer example
decks: sections, records, repeat counts (``n*v``), defaults (``n*``),
quoted strings, comments (``--``), INCLUDE files, grid arrays, and the
multi-record PVT tables.

Output is a :class:`Deck` — an ordered list of :class:`DeckKeyword` with raw
(unit-unconverted) values; interpretation and SI conversion happen in
``opm_tpu_torch.io.eclstate``.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np


class _Default:
    """Sentinel for a defaulted record item."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "DEFAULT"


DEFAULT = _Default()

_KEYWORD_RE = re.compile(r"^[A-Z][A-Z0-9]{0,7}$")
_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eEdD][+-]?\d+)?$")


def _to_number(tok: str):
    t = tok.replace("D", "E").replace("d", "e")
    f = float(t)
    if re.match(r"^[+-]?\d+$", tok):
        return int(tok)
    return f


@dataclass
class DeckKeyword:
    name: str
    records: List[List[Any]] = field(default_factory=list)
    array: Optional[np.ndarray] = None

    def __repr__(self):
        n = len(self.array) if self.array is not None else len(self.records)
        kind = "array" if self.array is not None else "records"
        return f"DeckKeyword({self.name}, {kind}={n})"


@dataclass
class Deck:
    keywords: List[DeckKeyword] = field(default_factory=list)

    def __iter__(self):
        return iter(self.keywords)

    def __contains__(self, name):
        return any(kw.name == name for kw in self.keywords)

    def get(self, name) -> Optional[DeckKeyword]:
        for kw in self.keywords:
            if kw.name == name:
                return kw
        return None


# ---------------------------------------------------------------------------
# Keyword registry: how each keyword's data is shaped.
#   flag          — no data
#   rec:N         — exactly N slash-terminated records
#   rec:tabdims:X — X in {ntpvt, ntsfun, nteql, ntrocc} records
#   list          — records until a lone '/'
#   array         — one stream of numbers ending in '/'
#   table:ntpvt   — multi-record tables (PVTO/PVTG): per region, records until
#                   an empty record terminates the region
#   title         — TITLE (one raw text line)
# ---------------------------------------------------------------------------

FLAG_KEYWORDS = {
    "RUNSPEC", "GRID", "EDIT", "PROPS", "REGIONS", "SOLUTION", "SUMMARY",
    "SCHEDULE", "END", "ENDBOX", "INIT", "OIL", "WATER", "GAS", "DISGAS",
    "VAPOIL", "POLYMER", "BRINE", "METRIC", "FIELD", "LAB", "NONNC", "ECHO",
    "NOECHO", "NOSIM", "UNIFOUT", "UNIFIN", "FMTIN", "FMTOUT", "RUNSUM",
    "SEPARATE", "SKIPREST", "NOGRAV", "EXCEL", "IMPES", "NOGGF", "NEWTRAN",
    "THERMAL", "TEMP",
    "OLDTRAN", "NOINSPEC", "NORSSPEC", "MONITOR", "RSSPEC", "MSGFILE",
    "ALL", "FOPR", "FWPR", "FGPR", "FOPT", "FWPT", "FGPT", "FWCT", "FGOR",
    "FVPR", "FVPT", "FPR", "FWIR", "FGIR", "FWIT", "FGIT", "FOE",
    "PERFORMA", "WATCUT",
}

# SUMMARY-section keywords that take a well/group list record (or are flags).
SUMMARY_WELL_KEYWORDS = {
    "WOPR", "WWPR", "WGPR", "WBHP", "WTHP", "WWCT", "WGOR", "WWIR", "WGIR",
    "WOPT", "WWPT", "WGPT", "WWIT", "WGIT", "WPI", "WBP", "WBP4", "WBP5",
    "WBP9", "GOPR", "GWPR", "GGPR", "GWCT", "GGOR", "GOPT", "GWIR", "GGIR",
    "WOPRS", "WGPRS", "WGLR",
}
SUMMARY_BLOCK_KEYWORDS = {"BPR", "BOSAT", "BWSAT", "BGSAT", "BWKR", "BOKR",
                          "BGKR", "BRS", "BRV", "BPBUB", "BPDEW"}
SUMMARY_REGION_KEYWORDS = {"RPR", "ROIP", "RWIP", "RGIP", "ROE"}

REC1_KEYWORDS = {
    "RESTART", "VAPPARS",
    "DIMENS", "START", "WELLDIMS", "TABDIMS", "EQLDIMS", "ENDSCALE",
    "NSTACK", "GRIDFILE", "MINPV", "PLYMAX", "TLMIXPAR", "ROCKCOMP",
    "RPTRST", "RPTSCHED", "RPTSOL", "RPTGRID", "RPTPROPS", "RPTSMRY",
    "DRSDT", "DRVDT", "BOX", "GRIDUNIT", "MAPUNITS", "SATOPTS", "AQUDIMS",
    "EHYSTR",
    "REGDIMS", "MISCIBLE", "VFPIDIMS", "VFPPDIMS", "FAULTDIM", "PIMTDIMS",
    "NUPCOL", "MESSAGES", "OPTIONS", "RTEMP", "RTEMPA", "THERMEX1",
    "TREF",
}

LIST_KEYWORDS = {
    "WELSPECS", "COMPDAT", "WCONPROD", "WCONINJE", "WCONINJ", "WCONINJH",
    "WCONHIST", "WELTARG", "WECON", "WELOPEN", "WPOLYMER", "GRUPTREE",
    "GCONPROD", "GCONINJE", "DATES", "EQUALS", "COPY", "ADD", "MULTIPLY",
    "THPRES", "WELSEGS", "COMPSEGS", "MULTIPLY", "FAULTS", "MULTFLT",
    "NNC", "WLIST", "WTEST", "WGRUPCON", "WPIMULT", "WTRACER", "WSEGVALV",
}

# records counted by a TABDIMS/EQLDIMS quantity
REC_COUNTED = {
    "PVTW": "ntpvt",
    "PVCDO": "ntpvt",
    "DENSITY": "ntpvt",
    "GRAVITY": "ntpvt",
    "ROCK": "ntpvt",
    "VISCREF": "ntpvt",
    "WATDENT": "ntpvt",
    "EQUIL": "nteql",
    "PLYROCK": "ntsfun",
    "PLYMAX": "ntmix",
}

# one long numeric record per table region
TABLE_LIST = {
    "SWOF": "ntsfun",
    "SGOF": "ntsfun",
    "SLGOF": "ntsfun",
    "SWFN": "ntsfun",
    "SGFN": "ntsfun",
    "SOF2": "ntsfun",
    "SOF3": "ntsfun",
    "PVDG": "ntpvt",
    "PVDO": "ntpvt",
    "RSVD": "nteql",
    "RVVD": "nteql",
    "PBVD": "nteql",
    "PDVD": "nteql",
    "PLYVISC": "ntpvt",
    "OILVISCT": "ntpvt",
    "WATVISCT": "ntpvt",
    "GASVISCT": "ntpvt",
    "PLYADS": "ntsfun",
    "PLYSHLOG": "ntpvt",
    "ROCKTAB": "ntrocc",
}

MULTIREC_TABLES = {"PVTO": "ntpvt", "PVTG": "ntpvt"}

ARRAY_KEYWORDS = {
    "DX", "DY", "DZ", "DXV", "DYV", "DZV", "TOPS", "DEPTHZ", "PERMX",
    "PERMY", "PERMZ", "PORO", "NTG", "ACTNUM", "MULTX", "MULTY", "MULTZ",
    "MULTX-", "MULTY-", "MULTZ-", "MULTPV", "PRESSURE", "SWAT", "SGAS",
    "SOIL", "RS", "RV", "SATNUM", "PVTNUM", "EQLNUM", "FIPNUM", "ROCKNUM",
    "IMBNUM",
    "SWL", "SWU", "SGL", "SGU", "SWCR", "SGCR", "SOWCR", "SOGCR", "KRW",
    "KRO", "KRG", "PCW", "PCG", "SWATINIT", "TSTEP", "ZCORN", "COORD",
    "SPOLY", "PLYCONC", "SALT", "TEMPI", "MINPVV",
}

INT_ARRAYS = {"ACTNUM", "SATNUM", "PVTNUM", "EQLNUM", "FIPNUM", "ROCKNUM",
              "IMBNUM"}


class _TokenStream:
    """Streams raw whitespace tokens from deck text, handling comments,
    quoted strings, and INCLUDE expansion."""

    def __init__(self, text: str, base_dir: str = "."):
        self.base_dir = base_dir
        self._lines: List[str] = []
        self._push_text(text)
        self._line_tokens: List[str] = []
        self._line_is_fresh = False  # token starts a new line

    def _push_text(self, text: str):
        self._lines = text.splitlines()[::-1] + getattr(self, "_lines", [])

    def next_line(self) -> Optional[str]:
        while self._lines:
            raw = self._lines.pop()
            line = raw.split("--", 1)[0].rstrip()
            if line.strip():
                return line
        return None

    def peek_line(self) -> Optional[str]:
        line = self.next_line()
        if line is not None:
            self._lines.append(line)
        return line

    @staticmethod
    def split_tokens(line: str) -> List[str]:
        toks = []
        i, n = 0, len(line)
        while i < n:
            c = line[i]
            if c.isspace():
                i += 1
                continue
            if c in "'\"":
                j = line.find(c, i + 1)
                if j < 0:
                    j = n
                toks.append(line[i + 1 : j])
                i = j + 1
            elif c == "/":
                toks.append("/")
                # everything after an un-quoted '/' on the line is comment
                break
            else:
                j = i
                while j < n and not line[j].isspace() and line[j] not in "'\"/":
                    j += 1
                toks.append(line[i:j])
                i = j
        return toks


def _parse_record_tokens(toks: List[str]) -> List[Any]:
    """Expand repeats/defaults and type-convert one record's tokens."""
    out: List[Any] = []
    for t in toks:
        if t == "/":
            break
        m = re.match(r"^(\d+)\*(.*)$", t)
        if m:
            count = int(m.group(1))
            val = m.group(2)
            if val == "":
                out.extend([DEFAULT] * count)
            elif _NUM_RE.match(val):
                out.extend([_to_number(val)] * count)
            else:
                out.extend([val] * count)
        elif t == "*":
            out.append(DEFAULT)
        elif _NUM_RE.match(t):
            out.append(_to_number(t))
        else:
            out.append(t)
    return out


class DeckParser:
    def __init__(self):
        self.counts = {"ntpvt": 1, "ntsfun": 1, "nteql": 1, "ntrocc": 1,
                       "ntmix": 1}

    # -- record readers ----------------------------------------------------

    def _read_record(self, ts: _TokenStream) -> Optional[List[Any]]:
        """Read tokens until '/'. Returns None on EOF."""
        toks: List[str] = []
        while True:
            line = ts.next_line()
            if line is None:
                return _parse_record_tokens(toks) if toks else None
            ltoks = _TokenStream.split_tokens(line)
            toks.extend(ltoks)
            if "/" in ltoks:
                return _parse_record_tokens(toks)

    def _read_list(self, ts: _TokenStream) -> List[List[Any]]:
        """Records until a lone '/' record."""
        recs = []
        while True:
            line = ts.peek_line()
            if line is None:
                break
            stripped = _TokenStream.split_tokens(line)
            if stripped and stripped[0] == "/":
                ts.next_line()
                break
            rec = self._read_record(ts)
            if rec is None:
                break
            if not rec:  # empty record == terminator
                break
            recs.append(rec)
        return recs

    def _read_array(self, ts: _TokenStream, name: str) -> np.ndarray:
        vals: List[float] = []
        while True:
            line = ts.next_line()
            if line is None:
                break
            done = False
            for t in _TokenStream.split_tokens(line):
                if t == "/":
                    done = True
                    break
                m = re.match(r"^(\d+)\*(.+)$", t)
                if m:
                    vals.extend([_to_number(m.group(2))] * int(m.group(1)))
                else:
                    vals.append(_to_number(t))
            if done:
                break
        dtype = np.int64 if name in INT_ARRAYS else np.float64
        return np.asarray(vals, dtype=dtype)

    def _read_multirec_table(self, ts: _TokenStream, nregions: int) -> List[List[List[Any]]]:
        """PVTO/PVTG: per region, records each '/'-terminated; region ends
        with an empty record (lone '/')."""
        regions = []
        for _ in range(nregions):
            recs = self._read_list(ts)
            regions.append(recs)
        return regions

    # -- main --------------------------------------------------------------

    def parse(self, text: str, base_dir: str = ".") -> Deck:
        ts = _TokenStream(text, base_dir)
        deck = Deck()
        while True:
            line = ts.next_line()
            if line is None:
                break
            toks = _TokenStream.split_tokens(line)
            if not toks:
                continue
            name = toks[0].upper()
            if not _KEYWORD_RE.match(name):
                continue  # stray data outside any known keyword
            if name == "INCLUDE":
                rec = self._read_record(ts) if len(toks) == 1 else _parse_record_tokens(toks[1:])
                fname = str(rec[0])
                path = os.path.join(base_dir, fname)
                with open(path) as f:
                    ts._push_text(f.read())
                continue
            if name == "TITLE":
                title_line = ts.next_line() or ""
                deck.keywords.append(DeckKeyword("TITLE", [[title_line.strip()]]))
                continue
            if name == "END":
                deck.keywords.append(DeckKeyword("END"))
                break
            kw = self._parse_keyword(ts, name)
            if kw is not None:
                deck.keywords.append(kw)
                if name == "TABDIMS":
                    r = kw.records[0]
                    self.counts["ntsfun"] = _get(r, 0, 1)
                    self.counts["ntpvt"] = _get(r, 1, 1)
                    self.counts["ntrocc"] = _get(r, 12, 1) or 1
                elif name == "EQLDIMS":
                    self.counts["nteql"] = _get(kw.records[0], 0, 1)
                elif name == "DIMENS":
                    r = kw.records[0]
                    self._dims = (int(r[0]), int(r[1]), int(r[2]))
        return deck

    def _parse_keyword(self, ts: _TokenStream, name: str) -> Optional[DeckKeyword]:
        if name in FLAG_KEYWORDS:
            return DeckKeyword(name)
        if name in SUMMARY_WELL_KEYWORDS or name in SUMMARY_REGION_KEYWORDS:
            # optional single record listing wells/regions (or lone '/').
            # A quoted well name ('PROD') tokenizes to a keyword-shaped
            # string, so a line CONTAINING '/' is always a record — keyword
            # lines never carry the record terminator.
            line = ts.peek_line()
            recs = []
            if line is not None:
                t0 = _TokenStream.split_tokens(line)
                if t0 and t0[0] == "/":
                    ts.next_line()
                elif t0 and ("/" in t0
                             or not _KEYWORD_RE.match(t0[0].upper())):
                    rec = self._read_record(ts)
                    if rec:
                        recs = [rec]
            return DeckKeyword(name, recs)
        if name in SUMMARY_BLOCK_KEYWORDS:
            return DeckKeyword(name, self._read_list(ts))
        if name in REC1_KEYWORDS:
            rec = self._read_record(ts)
            return DeckKeyword(name, [rec] if rec is not None else [])
        if name == "TUNING":
            return DeckKeyword(name, [self._read_record(ts) or [] for _ in range(3)])
        if name in REC_COUNTED:
            n = self.counts[REC_COUNTED[name]]
            return DeckKeyword(name, [self._read_record(ts) or [] for _ in range(n)])
        if name in LIST_KEYWORDS:
            return DeckKeyword(name, self._read_list(ts))
        if name in TABLE_LIST:
            n = self.counts[TABLE_LIST[name]]
            return DeckKeyword(name, [self._read_record(ts) or [] for _ in range(n)])
        if name in ("VFPPROD", "VFPINJ"):
            # fixed-count record streams: header + axis records + one bhp
            # record per upper-axis combination
            recs = [self._read_record(ts)]  # header
            n_axes = 5 if name == "VFPPROD" else 2
            axis_lens = []
            for _ in range(n_axes):
                r = self._read_record(ts)
                recs.append(r)
                axis_lens.append(len(r))
            # combinations of all axes except FLO (the first axis record)
            ncomb = 1
            for ln in axis_lens[1:]:
                ncomb *= max(ln, 1)
            for _ in range(ncomb):
                recs.append(self._read_record(ts))
            return DeckKeyword(name, recs)
        if name in MULTIREC_TABLES:
            n = MULTIREC_TABLES[name]
            n = self.counts[n] if isinstance(n, str) else n
            regions = self._read_multirec_table(ts, n)
            kw = DeckKeyword(name)
            kw.records = regions  # list[region][record][item]
            return kw
        if name in ARRAY_KEYWORDS:
            return DeckKeyword(name, array=self._read_array(ts, name))
        # Unknown keyword: skip records until a line that looks like a keyword
        while True:
            line = ts.peek_line()
            if line is None:
                return DeckKeyword(name)
            t0 = _TokenStream.split_tokens(line)
            if t0 and _KEYWORD_RE.match(t0[0].upper()) and not _NUM_RE.match(t0[0]):
                return DeckKeyword(name)
            ts.next_line()


def _get(rec, i, default=None):
    if i < len(rec) and rec[i] is not DEFAULT:
        return rec[i]
    return default


def parse_deck_string(text: str, base_dir: str = ".") -> Deck:
    return DeckParser().parse(text, base_dir)


def parse_deck(path: str) -> Deck:
    with open(path) as f:
        text = f.read()
    return DeckParser().parse(text, os.path.dirname(os.path.abspath(path)))
