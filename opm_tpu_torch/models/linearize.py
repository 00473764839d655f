"""Jacobian helpers of the dense Newton route.

Only ``degenerate_x_mask`` is ported so far; the block-sparse assembly of
the JAX package's models/linearize.py is ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import torch

from opm_tpu_torch.models.state import HC_GASONLY, HC_OILONLY, saturations


def degenerate_x_mask(model, state):
    """Continuous regularization weight in [0, 1] for the (gas-eq, x)
    diagonal of cells whose x variable is losing its equation: in an rs
    cell the gas-equation x-column scales with so, in an rv cell with sg.
    weight = clip(1 - s_scaling / 1e-5, 0, 1); only the Jacobian is
    touched, never the residual."""
    sw, so, sg = saturations(state)
    is_rs = state.hcstate == HC_OILONLY
    is_rv = state.hcstate == HC_GASONLY
    s_scale = torch.where(is_rs, so, torch.where(is_rv, sg,
                                                 torch.ones_like(so)))
    # a true division: tensor / python float is a multiplication by the
    # reciprocal, one rounding off the reference's quotient
    return torch.clamp(1.0 - s_scale / torch.full_like(s_scale, 1e-5),
                       0.0, 1.0)
