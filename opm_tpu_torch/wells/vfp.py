"""Vertical-flow-performance (VFP) tables: THP <-> BHP, on tensors.

Port of the JAX package's wells/vfp.py (the reference's VFP stack,
VFPProdPropertiesLegacy.hpp, VFPInjPropertiesLegacy.hpp,
VFPHelpersLegacy.hpp): 5-D (prod) / 2-D (inj) multilinear interpolation
of BHP(thp, wfr, gfr, alq, flo), differentiable in the rates under
``torch.func.jvp``/``jacfwd`` so THP control equations take part in the
Newton Jacobian. The tables are float64 tensors on the simulator's device.
The clips and floors are ``torch.maximum``/``torch.minimum`` of tensors,
whose derivative at a tie is one half, as ``jnp.maximum``'s and
``jnp.clip``'s are in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

WATER, OIL, GAS = 0, 1, 2

# flo/wfr/gfr type codes
FLO_OIL, FLO_LIQ, FLO_GAS = 0, 1, 2
WFR_WOR, WFR_WCT, WFR_WGR = 0, 1, 2
GFR_GOR, GFR_GLR, GFR_OGR = 0, 1, 2


def _max(x, c):
    return torch.maximum(x, torch.full_like(x, c))


def _clip01(t):
    return torch.minimum(_max(t, 0.0), torch.ones_like(t))


def _as(x, ref):
    """x as a float64 tensor on ref's device (broadcast later); a Python
    number by a fill on the device, not a copy from the host (which
    synchronizes)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float64, device=ref.device)
    return torch.full((), float(x), dtype=torch.float64, device=ref.device)


def _axis_interp_weights(axis, x):
    n = axis.shape[0]
    i = torch.clamp(torch.searchsorted(axis, x.detach().contiguous(),
                                       right=True) - 1, 0, n - 2)
    a0, a1 = axis[i], axis[i + 1]
    t = (x - a0) / torch.where(a1 == a0, torch.ones_like(a0), a1 - a0)
    return i, _clip01(t)


@dataclass
class VFPProdTable:
    table_id: int
    datum_depth: float
    flo_type: int
    wfr_type: int
    gfr_type: int
    flo: torch.Tensor     # (nflo,)
    thp: torch.Tensor     # (nthp,)
    wfr: torch.Tensor
    gfr: torch.Tensor
    alq: torch.Tensor
    bhp: torch.Tensor     # (nthp, nwfr, ngfr, nalq, nflo)

    def eval(self, flo, thp, wfr, gfr, alq):
        """Multilinear interpolation; broadcasts over inputs."""
        ref = self.bhp
        xs = torch.broadcast_tensors(*(_as(v, ref) for v in
                                       (thp, wfr, gfr, alq, flo)))
        axes = (self.thp, self.wfr, self.gfr, self.alq, self.flo)
        idx, ts = [], []
        for a, x in zip(axes, xs):
            i, t = _axis_interp_weights(a, x)
            idx.append(i)
            ts.append(t)
        out = torch.zeros_like(xs[0])
        for corner in range(32):
            w = 1.0
            ii = []
            for d in range(5):
                hi = (corner >> d) & 1
                ii.append(idx[d] + hi)
                w = w * (ts[d] if hi else 1.0 - ts[d])
            out = out + w * self.bhp[tuple(ii)]
        return out

    def flo_value(self, qs):
        """The table's FLO coordinate from signed surface rates
        (production negative)."""
        prod = _max(-qs, 0.0)
        if self.flo_type == FLO_OIL:
            return prod[..., OIL]
        if self.flo_type == FLO_LIQ:
            return prod[..., OIL] + prod[..., WATER]
        return prod[..., GAS]

    def wfr_value(self, qs):
        prod = _max(-qs, 0.0)
        o, w, g = prod[..., OIL], prod[..., WATER], prod[..., GAS]
        if self.wfr_type == WFR_WOR:
            return w / _max(o, 1e-12)
        if self.wfr_type == WFR_WCT:
            return w / _max(o + w, 1e-12)
        return w / _max(g, 1e-12)

    def gfr_value(self, qs):
        prod = _max(-qs, 0.0)
        o, w, g = prod[..., OIL], prod[..., WATER], prod[..., GAS]
        if self.gfr_type == GFR_GOR:
            return g / _max(o, 1e-12)
        if self.gfr_type == GFR_GLR:
            return g / _max(o + w, 1e-12)
        return o / _max(g, 1e-12)

    def bhp_at(self, qs, thp, alq=0.0):
        return self.eval(self.flo_value(qs), thp, self.wfr_value(qs),
                         self.gfr_value(qs), alq)

    def thp_at(self, qs, bhp, alq=0.0, *, n=64):
        """Inverse lookup THP(bhp) by sampling the THP axis and inverting
        the (monotone) bhp(thp) curve (VFPHelpersLegacy getTHP; the WTHP
        back-calculation, StandardWells_impl.hpp:613-703). qs is one well's
        signed surface rates (3,); bhp a scalar."""
        thps = _samples(self.thp, n)
        bhps = self.eval(self.flo_value(qs), thps, self.wfr_value(qs),
                         self.gfr_value(qs), alq)
        return interp_clamp(bhps, thps, _as(bhp, thps))


@dataclass
class VFPInjTable:
    table_id: int
    datum_depth: float
    flo_type: int
    flo: torch.Tensor
    thp: torch.Tensor
    bhp: torch.Tensor     # (nthp, nflo)

    def eval(self, flo, thp):
        ref = self.bhp
        flo, thp = torch.broadcast_tensors(_as(flo, ref), _as(thp, ref))
        i_t, t_t = _axis_interp_weights(self.thp, thp)
        i_f, t_f = _axis_interp_weights(self.flo, flo)
        return ((1 - t_t) * (1 - t_f) * self.bhp[i_t, i_f]
                + (1 - t_t) * t_f * self.bhp[i_t, i_f + 1]
                + t_t * (1 - t_f) * self.bhp[i_t + 1, i_f]
                + t_t * t_f * self.bhp[i_t + 1, i_f + 1])

    def flo_value(self, qs):
        inj = _max(qs, 0.0)
        if self.flo_type == FLO_GAS:
            return inj[..., GAS]
        if self.flo_type == FLO_OIL:
            return inj[..., OIL]
        return inj[..., WATER] + inj[..., OIL]

    def bhp_at(self, qs, thp):
        return self.eval(self.flo_value(qs), thp)

    def thp_at(self, qs, bhp, alq=0.0, *, n=64):
        """Inverse lookup THP(bhp) at the well's injection rate."""
        thps = _samples(self.thp, n)
        bhps = self.eval(self.flo_value(qs), thps)
        return interp_clamp(bhps, thps, _as(bhp, thps))


def _samples(axis, n):
    """n evenly spaced points from the axis' first value to its last, on
    the axis' device (no host read of the ends)."""
    u = torch.linspace(0.0, 1.0, n, dtype=torch.float64, device=axis.device)
    return axis[0] + (axis[-1] - axis[0]) * u


def interp_clamp(xs, ys, x):
    """ys(xs) at x, piecewise linear, constant beyond the ends: the
    reference's gather-free ``interp(..., extrap='clamp')`` (its path for
    tables of at most 64 segments): the segment with xs[k] <= x <
    xs[k+1] (zero-width segments never), the first below the table and
    the last above it."""
    lo, hi = xs[:-1], xs[1:]
    ind = (x >= lo) & (x < hi)
    first = torch.zeros_like(ind)
    first[0] = True
    last = torch.zeros_like(ind)
    last[-1] = True
    ind = (ind | (torch.all(x < xs) & first)
           | (torch.all(x >= xs) & last))
    width = hi - lo
    t = (x - lo) / torch.where(width == 0, torch.ones_like(width), width)
    t = torch.clamp(t, 0.0, 1.0)
    seg = torch.where(ind, (1.0 - t) * ys[:-1] + t * ys[1:],
                      torch.zeros_like(t))
    return torch.sum(seg) + 0.0 * x


_FLO_CODES = {"OIL": FLO_OIL, "LIQ": FLO_LIQ, "GAS": FLO_GAS,
              "WAT": FLO_LIQ}
_WFR_CODES = {"WOR": WFR_WOR, "WCT": WFR_WCT, "WGR": WFR_WGR}
_GFR_CODES = {"GOR": GFR_GOR, "GLR": GFR_GLR, "OGR": GFR_OGR}


def parse_vfp_tables(deck, units) -> Dict[int, object]:
    """All VFPPROD/VFPINJ tables from the deck, SI-converted, as float64
    tensors on the CPU (``tables_to`` puts them on a device)."""
    out: Dict[int, object] = {}
    p_f = units.factor("Pressure")
    liq_f = units.factor("LiquidSurfaceVolume/Time")
    gas_f = units.factor("GasSurfaceVolume/Time")
    len_f = units.factor("Length")
    gor_f = units.factor("GasSurfaceVolume/LiquidSurfaceVolume")

    def clean(rec):
        return np.asarray([x for x in rec], dtype=np.float64)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    for kw in (k for k in deck if k.name == "VFPPROD"):
        hdr = kw.records[0]
        tid = int(hdr[0])
        datum = float(hdr[1]) * len_f
        flo_t = _FLO_CODES.get(str(hdr[2]).upper(), FLO_LIQ)
        wfr_t = _WFR_CODES.get(str(hdr[3]).upper(), WFR_WCT)
        gfr_t = _GFR_CODES.get(str(hdr[4]).upper(), GFR_GOR)
        flo_fac = gas_f if flo_t == FLO_GAS else liq_f
        wfr_fac = 1.0 if wfr_t in (WFR_WOR, WFR_WCT) else 1.0 / gor_f
        gfr_fac = gor_f if gfr_t in (GFR_GOR, GFR_GLR) else 1.0 / gor_f
        flo = clean(kw.records[1]) * flo_fac
        thp = clean(kw.records[2]) * p_f
        wfr = clean(kw.records[3]) * wfr_fac
        gfr = clean(kw.records[4]) * gfr_fac
        alq = clean(kw.records[5])
        bhp = np.zeros((len(thp), len(wfr), len(gfr), len(alq), len(flo)))
        for rec in kw.records[6:]:
            it, iw, ig, ia = (int(rec[0]) - 1, int(rec[1]) - 1,
                              int(rec[2]) - 1, int(rec[3]) - 1)
            bhp[it, iw, ig, ia, :] = np.asarray(rec[4:4 + len(flo)]) * p_f
        out[tid] = VFPProdTable(
            table_id=tid, datum_depth=datum, flo_type=flo_t, wfr_type=wfr_t,
            gfr_type=gfr_t, flo=t(flo), thp=t(thp), wfr=t(wfr), gfr=t(gfr),
            alq=t(alq), bhp=t(bhp))
    for kw in (k for k in deck if k.name == "VFPINJ"):
        hdr = kw.records[0]
        tid = int(hdr[0])
        datum = float(hdr[1]) * len_f
        flo_t = _FLO_CODES.get(str(hdr[2]).upper(), FLO_LIQ)
        flo_fac = gas_f if flo_t == FLO_GAS else liq_f
        flo = clean(kw.records[1]) * flo_fac
        thp = clean(kw.records[2]) * p_f
        bhp = np.zeros((len(thp), len(flo)))
        for rec in kw.records[3:]:
            bhp[int(rec[0]) - 1, :] = np.asarray(rec[1:1 + len(flo)]) * p_f
        out[tid] = VFPInjTable(table_id=tid, datum_depth=datum,
                               flo_type=flo_t, flo=t(flo), thp=t(thp),
                               bhp=t(bhp))
    return out


def tables_to(tables: Dict[int, object], device) -> Dict[int, object]:
    """The tables with their tensors on ``device``."""
    import dataclasses

    def move(tab):
        return dataclasses.replace(tab, **{
            f.name: getattr(tab, f.name).to(device)
            for f in dataclasses.fields(tab)
            if isinstance(getattr(tab, f.name), torch.Tensor)})

    return {k: move(v) for k, v in tables.items()}
