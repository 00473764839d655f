"""Deck SUMMARY-section configuration.

The reference honors the deck's SUMMARY section through opm-parser's
SummaryConfig consumed by BlackoilOutputWriter (FlowMain.hpp readDeckInput
-> eclIO; SURVEY.md §2.J): the SMSPEC/UNSMRY vectors are exactly what the
deck requested.  Here `expand_requests` turns the parsed request list
(io/eclstate.py _parse_summary) into the concrete vector keys the
SummaryCollector computes and the ECL writer emits, plus the set of extra
computations they require ('region', 'block', 'well_totals') and the
mnemonics we cannot honor (reported as a PRT warning, never an error —
the graceful-fallback behavior of the reference's summary evaluator).

Key naming: field vectors are the bare mnemonic ("FOPR"); well vectors are
"MNEM:WELL"; region vectors "MNEM:N" (1-based FIPNUM region); block
vectors "MNEM:i,j,k" (1-based deck coordinates).  io/eclsum.write_summary
maps these onto SMSPEC KEYWORDS/WGNAMES/NUMS.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

# field mnemonics the collector computes directly
FIELD_SUPPORTED = {
    "FOPR", "FWPR", "FGPR", "FLPR", "FVPR",
    "FOPT", "FWPT", "FGPT", "FLPT",
    "FOIR", "FWIR", "FGIR", "FWIT", "FGIT",
    "FWCT", "FGOR", "FPR", "FOIP", "FWIP", "FGIP", "FOE",
}
# well mnemonics (an empty well list in the deck means "all wells")
WELL_SUPPORTED = {
    "WOPR", "WWPR", "WGPR", "WLPR", "WWIR", "WGIR", "WOIR",
    "WBHP", "WTHP", "WWCT", "WGOR", "WGLR",
    "WOPT", "WWPT", "WGPT", "WWIT", "WGIT",
}
REGION_SUPPORTED = {"RPR", "ROIP", "RWIP", "RGIP"}
BLOCK_SUPPORTED = {"BPR"}

# the ECL 'ALL' mnemonic expansion (field + per-well production/injection
# rates, totals, ratios, bhp)
_ALL_FIELD = ["FOPR", "FWPR", "FGPR", "FOPT", "FWPT", "FGPT", "FWCT",
              "FGOR", "FWIR", "FGIR", "FWIT", "FGIT", "FPR"]
_ALL_WELL = ["WOPR", "WWPR", "WGPR", "WOPT", "WWPT", "WGPT", "WWCT",
             "WGOR", "WWIR", "WGIR", "WWIT", "WGIT", "WBHP"]


def expand_requests(
        requests: Sequence[Tuple[str, list]],
        well_names: Sequence[str],
        nreg: int = 1,
        ijk_to_cell=None,
) -> Tuple[List[str], List[str], set]:
    """-> (keys, unsupported, need).

    requests: [(mnemonic, records)] where records is a list of string-token
    records ([] for flag mnemonics).  ijk_to_cell(i, j, k) -> active cell
    index or None (0-based input), used to validate BPR requests.
    need ⊆ {'region', 'block', 'well_totals'}.
    """
    keys: List[str] = []
    unsupported: List[str] = []
    need = set()

    def add(k):
        if k not in keys:
            keys.append(k)

    for mnem, recs in requests:
        mnem = mnem.upper()
        if mnem == "ALL":
            for k in _ALL_FIELD:
                add(k)
            for m in _ALL_WELL:
                for w in well_names:
                    add(f"{m}:{w}")
            need.add("well_totals")
            continue
        if mnem in FIELD_SUPPORTED:
            add(mnem)
            continue
        if mnem in WELL_SUPPORTED:
            wells = [t for t in (recs[0] if recs else [])
                     if t not in ("/", "*")]
            wells = wells or list(well_names)
            known = [w for w in wells if w in well_names]
            for w in wells:
                if w not in well_names:
                    unsupported.append(f"{mnem}:{w} (unknown well)")
            for w in known:
                add(f"{mnem}:{w}")
            if mnem in ("WOPT", "WWPT", "WGPT", "WWIT", "WGIT"):
                need.add("well_totals")
            continue
        if mnem in REGION_SUPPORTED:
            regs = [int(float(t)) for t in (recs[0] if recs else [])
                    if t not in ("/",)]
            regs = regs or list(range(1, nreg + 1))
            for r in regs:
                if 1 <= r <= nreg:
                    add(f"{mnem}:{r}")
                else:
                    unsupported.append(f"{mnem}:{r} (no such FIPNUM region)")
            need.add("region")
            continue
        if mnem in BLOCK_SUPPORTED:
            for rec in recs:
                toks = [t for t in rec if t != "/"]
                try:
                    i, j, k = (int(float(t)) for t in toks[:3])
                except (ValueError, TypeError):
                    unsupported.append(
                        f"{mnem} (malformed block record {toks})")
                    continue
                cell = (ijk_to_cell(i - 1, j - 1, k - 1)
                        if ijk_to_cell is not None else None)
                if cell is None:
                    unsupported.append(
                        f"{mnem}:{i},{j},{k} (inactive or out of range)")
                else:
                    add(f"{mnem}:{i},{j},{k}")
            need.add("block")
            continue
        unsupported.append(mnem)
    return keys, unsupported, need


def block_cells(keys: Sequence[str], ijk_to_cell) -> List[Tuple[str, int]]:
    """[(key, active_cell_index)] for the BPR-style keys in `keys`."""
    out = []
    for k in keys:
        mnem, _, rest = k.partition(":")
        if mnem in BLOCK_SUPPORTED and rest:
            i, j, kk = (int(t) for t in rest.split(","))
            c = ijk_to_cell(i - 1, j - 1, kk - 1)
            if c is not None:
                out.append((k, int(c)))
    return out
