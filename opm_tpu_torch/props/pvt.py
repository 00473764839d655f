"""Black-oil PVT on tensors (port of the JAX package's props/pvt.py).

Conventions (all SI), as in the reference:
  b_alpha = 1/B_alpha  (inverse formation-volume factor)
  rho_o = (rho_o_surf + rs*rho_g_surf) * b_o,  rho_g = (rho_g_surf + rv*rho_o_surf) * b_g
Tables interpolate 1/B and 1/(B*mu) linearly in p, so mu = (1/B)/(1/(B*mu)).

Every table lookup goes through kernel K1 (utils/tables.py); one lookup
returns both inverse-FVF and inverse-(FVF*mu) columns (or grids), so b and
mu of a phase cost one launch. Ported here: PVTW, PVDO/PVDG, PVTO, PVTG and
ROCK. PVCDO and ROCKTAB are not ported yet (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from opm_tpu_torch.utils.tables import lookup1, lookup2


def _pad_rows(arrs, ncol):
    """Stack per-region (n_i, ncol) tables into (nreg, nmax, ncol), repeating
    the last row with a nudged abscissa (strictly increasing)."""
    nmax = max(a.shape[0] for a in arrs)
    out = np.empty((len(arrs), nmax, ncol))
    for r, a in enumerate(arrs):
        out[r, : a.shape[0]] = a
        if a.shape[0] < nmax:
            last = a[-1].copy()
            for k in range(a.shape[0], nmax):
                last = last.copy()
                last[0] *= 1.0 + 1e-7  # keep abscissa strictly increasing
                out[r, k] = last
    return out


def reg_pick(vals, reg):
    """Per-region scalar vals[reg]; a single region broadcasts as a 0-d
    tensor."""
    if vals.shape[0] == 1:
        return vals[0]
    return vals[reg]


def _t(a, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                           device=device)


@dataclass
class WaterPVT:
    """PVTW: b_w and mu_w from reference values + compressibilities."""

    p_ref: torch.Tensor      # (nreg,)
    b_ref: torch.Tensor
    comp: torch.Tensor
    mu_ref: torch.Tensor
    viscosibility: torch.Tensor

    @classmethod
    def from_tables(cls, recs, device):
        g = lambda k: _t([r[k] for r in recs], device)  # noqa: E731
        return cls(g("p_ref"), g("b_ref"), g("comp"), g("mu_ref"),
                   g("viscosibility"))

    def b(self, p, reg):
        x = reg_pick(self.comp, reg) * (p - reg_pick(self.p_ref, reg))
        return (1.0 + x + 0.5 * x * x) / reg_pick(self.b_ref, reg)

    def mu(self, p, reg):
        y = (reg_pick(self.viscosibility, reg)
             * (p - reg_pick(self.p_ref, reg)))
        return reg_pick(self.mu_ref, reg) / (1.0 + y + 0.5 * y * y)


@dataclass
class DeadPVT:
    """PVDO/PVDG: p -> (1/B, 1/(B mu)) tables, one per PVT region."""

    p: torch.Tensor         # (nreg, n)
    cols: torch.Tensor      # (nreg, 2, n): inv_b, inv_bmu

    @classmethod
    def from_tables(cls, tables, device):
        padded = _pad_rows(tables, 3)
        p = padded[..., 0]
        inv_b = 1.0 / padded[..., 1]
        inv_bmu = inv_b / padded[..., 2]
        return cls(_t(p, device), _t(np.stack([inv_b, inv_bmu], 1), device))

    def b_mu(self, p, reg):
        ib, ibm = lookup1(self.p, self.cols, p, reg=reg)
        return ib, ib / ibm


@dataclass
class LiveOilPVT:
    """PVTO: live oil with dissolved gas rs; saturated curve per region plus
    a dense undersaturated grid over (record, dp = p - p_bub(rs)) (the
    reference's construction, copied)."""

    rs_tab: torch.Tensor      # (nreg, nrec) saturated rs (increasing)
    pbub_tab: torch.Tensor    # (nreg, nrec) bubble pressure
    dp_grid: torch.Tensor     # (nreg, ndp) pressure offsets >= 0
    grids: torch.Tensor       # (nreg, 2, nrec, ndp): inv_b, inv_bmu

    def __post_init__(self):
        # single-column (nreg, 1, nrec) tables for the K1 lookups: rs
        # (rs_sat's values, also EQUIL's and K9's) and the bubble pressure
        self.rs_col = self.rs_tab[:, None, :].contiguous()
        self._pbub_col = self.pbub_tab[:, None, :].contiguous()

    @classmethod
    def from_tables(cls, regions, device):
        nreg = len(regions)
        nrec = max(len(recs) for recs in regions)
        reg_data = []
        max_ndp = 2
        for recs in regions:
            dps = {0.0}
            for rs, rows in recs:
                psat = rows[0, 0]
                for p in rows[1:, 0]:
                    dps.add(float(p - psat))
            dp = np.array(sorted(dps))
            if len(dp) == 1:
                dp = np.array([0.0, 1.0e5])
            max_ndp = max(max_ndp, len(dp))
            reg_data.append(dp)
        ndp = max_ndp

        rs_tab = np.zeros((nreg, nrec))
        pbub_tab = np.zeros((nreg, nrec))
        dp_grid = np.zeros((nreg, ndp))
        ib_grid = np.zeros((nreg, nrec, ndp))
        ibm_grid = np.zeros((nreg, nrec, ndp))

        for r, recs in enumerate(regions):
            dp = reg_data[r]
            if len(dp) < ndp:
                extra = dp[-1] + np.arange(1, ndp - len(dp) + 1) * max(dp[-1], 1e5)
                dp = np.concatenate([dp, extra])
            dp_grid[r] = dp
            n = len(recs)
            rel_ib = np.ones((n, ndp))
            rel_ibm = np.ones((n, ndp))
            has_usat = np.zeros(n, dtype=bool)
            for i, (rs, rows) in enumerate(recs):
                rs_tab[r, i] = rs
                pbub_tab[r, i] = rows[0, 0]
                ib0 = 1.0 / rows[0, 1]
                ibm0 = ib0 / rows[0, 2]
                ib_grid[r, i, 0] = ib0
                ibm_grid[r, i, 0] = ibm0
                if rows.shape[0] > 1:
                    has_usat[i] = True
                    d = rows[:, 0] - rows[0, 0]
                    ib = 1.0 / rows[:, 1]
                    ibm = ib / rows[:, 2]
                    rel_ib[i] = np.interp(dp, d, ib / ib0)
                    rel_ibm[i] = np.interp(dp, d, ibm / ibm0)
            # donor: nearest record with undersaturated data
            donors = np.nonzero(has_usat)[0]
            for i in range(n):
                if has_usat[i]:
                    src = i
                elif len(donors):
                    src = donors[np.argmin(np.abs(donors - i))]
                else:
                    src = None
                if src is None:
                    ib_grid[r, i, :] = ib_grid[r, i, 0]
                    ibm_grid[r, i, :] = ibm_grid[r, i, 0]
                else:
                    ib_grid[r, i, :] = ib_grid[r, i, 0] * rel_ib[src]
                    ibm_grid[r, i, :] = ibm_grid[r, i, 0] * rel_ibm[src]
            for i in range(n, nrec):
                rs_tab[r, i] = rs_tab[r, n - 1] * (1 + 1e-7 * (i - n + 1))
                pbub_tab[r, i] = pbub_tab[r, n - 1] * (1 + 1e-7 * (i - n + 1))
                ib_grid[r, i] = ib_grid[r, n - 1]
                ibm_grid[r, i] = ibm_grid[r, n - 1]

        return cls(_t(rs_tab, device), _t(pbub_tab, device),
                   _t(dp_grid, device),
                   _t(np.stack([ib_grid, ibm_grid], 1), device))

    def rs_sat(self, p, reg):
        """Saturated (maximum) dissolved gas-oil ratio at pressure p."""
        return lookup1(self.pbub_tab, self.rs_col, p, reg=reg)[0]

    def p_bub(self, rs, reg):
        return lookup1(self.rs_tab, self._pbub_col, rs, reg=reg)[0]

    def b_mu(self, p, rs, reg):
        pb = self.p_bub(rs, reg)
        dp = torch.maximum(p - pb, torch.zeros_like(p))
        ib, ibm = lookup2(self.rs_tab, self.dp_grid, self.grids, rs, dp,
                          reg=reg)
        return ib, ib / ibm


@dataclass
class WetGasPVT:
    """PVTG: wet gas with vaporized oil rv. Records are indexed by gas
    pressure; within a record, rows vary rv downward from the saturated
    rv. A dense grid over (pressure record, drv = rv_sat(pg) - rv) (the
    reference's construction, copied: the drv nodes of every record, short
    regions padded, records without undersaturated rows borrowing the
    relative variation of the nearest record that has them)."""

    pg_tab: torch.Tensor      # (nreg, nrec) gas pressure of each record
    rv_sat_tab: torch.Tensor  # (nreg, nrec) saturated rv at pg
    drv_grid: torch.Tensor    # (nreg, ndrv) >= 0
    grids: torch.Tensor       # (nreg, 2, nrec, ndrv): inv_b, inv_bmu

    def __post_init__(self):
        # the single-column (nreg, 1, nrec) table of rv_sat for the K1
        # lookups (also EQUIL's and K9's)
        self.rv_col = self.rv_sat_tab[:, None, :].contiguous()

    @classmethod
    def from_tables(cls, regions, device):
        nreg = len(regions)
        nrec = max(len(recs) for recs in regions)
        reg_drv = []
        max_nd = 2
        for recs in regions:
            ds = {0.0}
            for pg, rows in recs:
                rvsat = rows[0, 0]
                for rv in rows[1:, 0]:
                    ds.add(float(rvsat - rv))
            d = np.array(sorted(ds))
            if len(d) == 1:
                d = np.array([0.0, max(1e-6, 1.0)])
            max_nd = max(max_nd, len(d))
            reg_drv.append(d)
        nd = max_nd

        pg_tab = np.zeros((nreg, nrec))
        rv_tab = np.zeros((nreg, nrec))
        drv_grid = np.zeros((nreg, nd))
        ib_grid = np.zeros((nreg, nrec, nd))
        ibm_grid = np.zeros((nreg, nrec, nd))
        for r, recs in enumerate(regions):
            d = reg_drv[r]
            if len(d) < nd:
                extra = d[-1] + np.arange(1, nd - len(d) + 1) * max(d[-1],
                                                                   1e-3)
                d = np.concatenate([d, extra])
            drv_grid[r] = d
            n = len(recs)
            rel_ib = np.ones((n, nd))
            rel_ibm = np.ones((n, nd))
            has = np.zeros(n, dtype=bool)
            for i, (pg, rows) in enumerate(recs):
                pg_tab[r, i] = pg
                rv_tab[r, i] = rows[0, 0]
                ib0 = 1.0 / rows[0, 1]
                ibm0 = ib0 / rows[0, 2]
                ib_grid[r, i, 0] = ib0
                ibm_grid[r, i, 0] = ibm0
                if rows.shape[0] > 1:
                    has[i] = True
                    dd = rows[0, 0] - rows[:, 0]
                    ib = 1.0 / rows[:, 1]
                    ibm = ib / rows[:, 2]
                    order = np.argsort(dd)
                    rel_ib[i] = np.interp(d, dd[order], (ib / ib0)[order])
                    rel_ibm[i] = np.interp(d, dd[order],
                                           (ibm / ibm0)[order])
            # donor: nearest record with undersaturated data
            donors = np.nonzero(has)[0]
            for i in range(n):
                src = i if has[i] else (donors[np.argmin(np.abs(donors - i))]
                                        if len(donors) else None)
                if src is None:
                    ib_grid[r, i, :] = ib_grid[r, i, 0]
                    ibm_grid[r, i, :] = ibm_grid[r, i, 0]
                else:
                    ib_grid[r, i, :] = ib_grid[r, i, 0] * rel_ib[src]
                    ibm_grid[r, i, :] = ibm_grid[r, i, 0] * rel_ibm[src]
            for i in range(n, nrec):
                pg_tab[r, i] = pg_tab[r, n - 1] * (1 + 1e-7 * (i - n + 1))
                rv_tab[r, i] = rv_tab[r, n - 1]
                ib_grid[r, i] = ib_grid[r, n - 1]
                ibm_grid[r, i] = ibm_grid[r, n - 1]
        return cls(_t(pg_tab, device), _t(rv_tab, device),
                   _t(drv_grid, device),
                   _t(np.stack([ib_grid, ibm_grid], 1), device))

    def rv_sat(self, p, reg):
        """Saturated (maximum) vaporized oil-gas ratio at gas pressure p."""
        return lookup1(self.pg_tab, self.rv_col, p, reg=reg)[0]

    def b_mu(self, p, rv, reg):
        """(b, mu) at gas pressure p and rv, over (p, drv = max(rv_sat(p)
        - rv, 0))."""
        rvs = self.rv_sat(p, reg)
        drv = torch.maximum(rvs - rv, torch.zeros_like(p))
        ib, ibm = lookup2(self.pg_tab, self.drv_grid, self.grids, p, drv,
                          reg=reg)
        return ib, ib / ibm


@dataclass
class RockPVT:
    """ROCK: pore-volume multiplier vs pressure (quadratic expansion)."""

    p_ref: torch.Tensor
    comp: torch.Tensor

    @classmethod
    def from_tables(cls, recs, device):
        return cls(_t([r["p_ref"] for r in recs], device),
                   _t([r["comp"] for r in recs], device))

    def pv_mult(self, p, reg):
        x = reg_pick(self.comp, reg) * (p - reg_pick(self.p_ref, reg))
        return 1.0 + x + 0.5 * x * x
