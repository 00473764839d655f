"""Relative permeability and capillary pressure from SWOF/SGOF (family 1).

Port of the JAX package's props/satfunc.py ``SatFuncFamily1`` without
endpoint scaling and hysteresis (ROADMAP Queue 1 item 2 carries those and
family 2). Three-phase oil relperm uses the ECLIPSE default model:

    kro = ((sw - swco) * krow(sw) + sg * krog(sg)) / (sw - swco + sg)

Capillary sign conventions: pcow = po - pw (SWOF col 4), pcgo = pg - po
(SGOF col 4). The three water-axis curves (krw, krow, pcow) are one K1
lookup with three columns, the gas-axis curves (krg, krog, pcgo) another,
both with clamped extrapolation. EQUIL's capillary inversions read the
tables prepared once here from the deck's arrays: the negated pcow
curve and the pcgo curve as abscissae over the saturation axes, and
whether each curve is flat (its largest magnitude).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from opm_tpu_torch.props.pvt import _pad_rows, _t, reg_pick
from opm_tpu_torch.utils.tables import lookup1


@dataclass
class SatFuncFamily1:
    """SWOF + SGOF tables stacked per SATNUM region."""

    sw: torch.Tensor        # (nreg, n)
    w_cols: torch.Tensor    # (nreg, 3, n): krw, krow, pcow
    sg: torch.Tensor        # (nreg, m)
    g_cols: torch.Tensor    # (nreg, 3, m): krg, krog, pcgo
    swco: torch.Tensor      # (nreg,) connate water
    # EQUIL's inversions sw(pcow) and sg(pcgo) as K1 tables: the
    # abscissae (nreg, n) -pcow (pcow is non-increasing in sw) and pcgo,
    # the values sw and sg (one column each); max |pcow| and max |pcgo|
    pcow_neg: torch.Tensor
    pcgo_x: torch.Tensor
    pcow_range: float
    pcgo_range: float

    @property
    def pcow(self):
        return self.w_cols[:, 2]

    @property
    def pcgo(self):
        return self.g_cols[:, 2]

    @classmethod
    def from_tables(cls, swof_tables, sgof_tables, device):
        if swof_tables is not None:
            swof = _pad_rows(swof_tables, 4)
        else:
            # gas-oil only: trivial water table
            nreg = len(sgof_tables)
            swof = np.zeros((nreg, 2, 4))
            swof[:, 1, 0] = 1.0
            swof[:, 1, 1] = 1.0
            swof[:, 0, 2] = 1.0
        if sgof_tables is not None:
            sgof = _pad_rows(sgof_tables, 4)
        else:
            nreg = swof.shape[0]
            sgof = np.zeros((nreg, 2, 4))
            sgof[:, 1, 0] = 1.0
            sgof[:, 1, 1] = 1.0
            sgof[:, 0, 2] = 1.0
        return cls(
            sw=_t(swof[..., 0], device),
            w_cols=_t(np.moveaxis(swof[..., 1:], -1, 1), device),
            sg=_t(sgof[..., 0], device),
            g_cols=_t(np.moveaxis(sgof[..., 1:], -1, 1), device),
            swco=_t(swof[:, 0, 0], device),
            pcow_neg=_t(-swof[..., 3], device),
            pcgo_x=_t(sgof[..., 3], device),
            pcow_range=float(np.abs(swof[..., 3]).max()),
            pcgo_range=float(np.abs(sgof[..., 3]).max()))

    @classmethod
    def from_case(cls, case, device):
        t = case.tables
        names = {kw.name for kw in case.deck}
        if names & {"ENDSCALE", "EHYSTR"}:
            raise NotImplementedError(
                "endpoint scaling and hysteresis are not ported yet "
                "(ROADMAP Queue 1 item 2)")
        if "SWOF" in t or "SGOF" in t:
            return cls.from_tables(t.get("SWOF"), t.get("SGOF"), device)
        if "SWFN" in t or "SGFN" in t:
            raise NotImplementedError(
                "saturation-function family 2 is not ported yet "
                "(ROADMAP Queue 1 item 2)")
        return None

    def evaluate(self, sw, so, sg, reg):
        """(krw, kro, krg, pcow, pcgo) at the cell saturations."""
        krw, krow, pcow = lookup1(self.sw, self.w_cols, sw, extrap="clamp",
                                  reg=reg)
        krg, krog, pcgo = lookup1(self.sg, self.g_cols, sg, extrap="clamp",
                                  reg=reg)
        swco = reg_pick(self.swco, reg)
        ssw = torch.maximum(sw - swco, torch.zeros_like(sw))
        den = ssw + sg
        safe = den > 1e-12
        kro = torch.where(
            safe, (ssw * krow + sg * krog) / torch.where(safe, den, 1.0),
            krow)
        # an absent phase has zero mobility (see the reference's note on
        # dry-gas cells exporting nonexistent oil)
        kro = torch.where(so > 0.0, kro, 0.0)
        krg = torch.where(sg > 0.0, krg, 0.0)
        krw = torch.where(sw > 0.0, krw, 0.0)
        return krw, kro, krg, pcow, pcgo
