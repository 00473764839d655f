"""Newton state update: chopped increments and primary-variable switching.

Port of the JAX package's solver/update.py. The cell part is kernel K9
(solver/kernels_triton.py): launch A chops the pressure, K1 evaluates
rs_sat/rv_sat at the old and new pressure, launch B applies the saturation
scaling, the renormalisation of negative saturations, the rs/rv chops and
the hydrocarbon-state switch. The well rows are a handful of numbers and
stay plain torch.
"""

from __future__ import annotations

import torch

from opm_tpu_torch.models.state import BlackoilState
from opm_tpu_torch.solver.kernels_triton import update_cells, update_pressure


def update_state(model, state: BlackoilState, du) -> BlackoilState:
    """Apply the Newton increment du (x <- x - dx, the reference's sign
    convention)."""
    if state.somax is not None:
        raise NotImplementedError(
            "VAPPARS memory is not ported yet (ROADMAP Queue 1 item 8)")
    p = model.params
    nc = model.nc
    nw = state.bhp.shape[0]
    dp = du[:nc]
    dsw = du[nc:2 * nc]
    dx = du[2 * nc:3 * nc]
    dbhp = du[3 * nc:3 * nc + nw]
    dqs = du[3 * nc + nw:3 * nc + nw + 3 * nw].reshape(nw, 3)

    pressure = update_pressure(state.pressure, dp.contiguous(), p.dp_max_rel)
    props = model.props
    rssat0 = props.rs_sat(state.pressure, model.pvtnum)
    rvsat0 = props.rv_sat(state.pressure, model.pvtnum)
    rssat = props.rs_sat(pressure, model.pvtnum)
    rvsat = props.rv_sat(pressure, model.pvtnum)
    sw, x, hc = update_cells(
        state.sw, state.x, state.hcstate, dsw.contiguous(), dx.contiguous(),
        rssat0, rssat, rvsat0, rvsat, p.ds_max, p.dr_max_rel, props.disgas,
        props.vapoil)

    # well rows (StandardWells_impl.hpp:613-703)
    lim = p.dp_max_rel * torch.abs(state.bhp)
    bhp = state.bhp - torch.clamp(dbhp, -lim, lim)
    qs = state.qs - dqs
    return state._replace(pressure=pressure, sw=sw, x=x, hcstate=hc,
                          bhp=bhp, qs=qs)
