"""Newton state update: chopped increments and primary-variable switching.

Port of the JAX package's solver/update.py. The whole update is kernel K9's
update entry (solver/kernels_k9.py, csrc/newton.cu): one launch that
applies omega to the increments, chops the pressure, looks up rs_sat and
rv_sat at the old and the new pressure (K1's device code), scales and
renormalises the saturations, chops rs/rv, switches the hydrocarbon state,
and in an extra block updates the well rows. On the CPU its plain twin composes the
same steps in torch.
"""

from __future__ import annotations

from opm_tpu_torch.models.state import BlackoilState
from opm_tpu_torch.solver import kernels_k9


def update_state(model, state: BlackoilState, du, omega=1.0,
                 du_w=None) -> BlackoilState:
    """Apply the Newton increment omega * du (x <- x - omega dx, the
    reference's sign convention). ``du`` is the flat increment (3 nc + 4
    nw: cells equation-major, bhp, qs) or, with ``du_w``, the cell
    increments (3, nc) and the well increments (nw, 4) = [dqs | dbhp] as
    the CPR route's well recovery gives them."""
    if state.somax is not None:
        raise NotImplementedError(
            "VAPPARS memory is not ported yet (ROADMAP Queue 1 item 8)")
    nc, nw = model.nc, state.bhp.shape[0]
    if du_w is None:
        du_c = du[:3 * nc].view(3, nc)
        dbhp = du[3 * nc:3 * nc + nw]
        dqs = du[3 * nc + nw:3 * nc + 4 * nw].view(nw, 3)
    else:
        du_c, dbhp, dqs = du, du_w[:, 3], du_w[:, :3]
    p, sw, x, hc, bhp, qs = kernels_k9.update(*kernels_k9.update_args(
        model, state, du_c.contiguous(), dbhp, dqs, omega))
    return state._replace(pressure=p, sw=sw, x=x, hcstate=hc, bhp=bhp,
                          qs=qs)
