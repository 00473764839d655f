"""Surface-rate -> reservoir-voidage conversion (RESV controls), on tensors.

Port of the JAX package's wells/rateconv.py (the reference's
RateConverterLegacy.hpp, SurfaceToReservoirVoidage +
AverageIncrementCalculator): per FIP region, pore-volume-weighted
averages of (p, rs, rv) define linear coefficients such that reservoir
voidage = coef . q_surface:

    V_w = q_w / b_w
    V_o = (q_o - rv q_g) / (d b_o)          d = 1 - rs rv
    V_g = (q_g - rs q_o) / (d b_g)

    coef = [1/b_w,  1/(d b_o) - rs/(d b_g),  1/(d b_g) - rv/(d b_o)]

Used by computeRESV (SimulatorBase_impl.hpp:196) and VREP group control.
The region sums are masked row sums on the model's device (one fixed
order on each device, no scatter).
"""

from __future__ import annotations

import numpy as np
import torch


def region_averages(model, state, region):
    """PV-weighted (p, rs, rv) per FIP region (region: (nc,) 0-based host
    array), each (nreg,) on the model's device."""
    q = model.cell_quantities(state)
    dev = state.pressure.device
    region = np.asarray(region)
    nreg = int(region.max()) + 1
    region = torch.as_tensor(region, dtype=torch.long, device=dev)
    masks = (region[None, :] == torch.arange(nreg, device=dev)[:, None]
             ).to(torch.float64)
    w = model.pv_out
    den = torch.clamp_min(torch.sum(masks * w[None, :], dim=1), 1e-300)

    def avg(x):
        return torch.sum(masks * (w * x)[None, :], dim=1) / den

    return avg(q.po), avg(q.rs), avg(q.rv)


def voidage_coefficients(props, p_avg, rs_avg, rv_avg):
    """(nreg, 3) coefficients in (w, o, g) surface-rate order (PVT region
    1's tables, as the reference's converter)."""
    reg = torch.zeros(p_avg.shape, dtype=torch.long, device=p_avg.device)
    bw = props.water_b_mu(p_avg, reg)[0]
    bo = props.oil_b_mu(p_avg, rs_avg, reg)[0]
    bg = props.gas_b_mu(p_avg, rv_avg, reg)[0]
    d = torch.clamp_min(1.0 - rs_avg * rv_avg, 1e-14)
    coef_w = 1.0 / bw
    coef_o = 1.0 / (d * bo) - rs_avg / (d * bg)
    coef_g = 1.0 / (d * bg) - rv_avg / (d * bo)
    return torch.stack([coef_w, coef_o, coef_g], dim=-1)


def well_resv_coefficients(model, state, well_set):
    """(nw, 3) voidage coefficients per well, from the FIP region of the
    well's first perforation (computeRESV semantics), on the model's
    device."""
    region = (np.zeros(model.nc, dtype=np.int64)
              if model.grid.fipnum is None else np.asarray(model.grid.fipnum))
    p_avg, rs_avg, rv_avg = region_averages(model, state, region)
    coefs = voidage_coefficients(model.props, p_avg, rs_avg, rv_avg)
    wreg = region[np.asarray(well_set.perf_cell)[:, 0]]
    return coefs[torch.as_tensor(wreg, dtype=torch.long,
                                 device=coefs.device)]
