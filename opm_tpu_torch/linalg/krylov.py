"""Right-preconditioned BiCGStab (port of the JAX package's
linalg/krylov.py ``bicgstab``).

The loop runs on the host; each iteration is two preconditioner applies,
two operator applies and the K8 vector steps (``kernels_triton.py``),
whose scalars stay on the device. The loop condition reads ||r||^2 once
per iteration: ``rnorm > tol * ||b||``, ``it < maxiter`` and rnorm
finite, as the reference's ``lax.while_loop`` condition. The breakdown
guards (1e-300) are the reference's. ``bicgstab_mp`` and ``gmres`` were
TPU measures and are not ported (ROADMAP).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from opm_tpu_torch.linalg import kernels_triton as k8


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    rel_residual: float
    converged: bool


def bicgstab(matvec: Callable, b, precond: Callable = None, *,
             tol: float = 1e-2, maxiter: int = 50,
             twin: bool = False) -> KrylovResult:
    """Solve A x = b with x = M^-1 y updates; tol is the relative reduction
    of ||r|| (the reference's linear_solver_reduction). ``twin``: the K8
    steps by their plain twins on any device (the card's whole-solve
    comparison)."""
    if precond is None:
        def precond(v):
            return v
    ops = k8.PLAIN if twin else k8.DISPATCH
    b = b.contiguous()
    sc = k8.new_scalars(b.device)
    ops.init(b, sc)
    x = torch.zeros_like(b)
    r = b.clone()
    rhat = b
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    b_norm = math.sqrt(float(sc[k8.BB]))
    rnorm = b_norm
    it = 0
    while rnorm > tol * b_norm and it < maxiter and math.isfinite(rnorm):
        p = ops.p_update(p, r, v, sc)
        phat = precond(p)
        v = matvec(phat).contiguous()
        ops.dot_alpha(rhat, v, sc)
        s = ops.s_update(r, v, sc)
        shat = precond(s)
        t = matvec(shat).contiguous()
        ops.dot_omega(t, s, sc)
        x, r = ops.xr_update(x, r, s, t, phat.contiguous(),
                            shat.contiguous(), rhat, sc)
        it += 1
        rr = float(sc[k8.RR])
        rnorm = math.sqrt(rr) if rr >= 0 else math.nan
    rel = rnorm / (b_norm if b_norm != 0 else 1.0)
    return KrylovResult(x=x, iterations=it, rel_residual=rel,
                        converged=bool(rel <= tol))
