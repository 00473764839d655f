"""Right-preconditioned BiCGStab (port of the JAX package's
linalg/krylov.py ``bicgstab``).

The loop runs on the host; each iteration is two preconditioner applies,
two operator applies and two K8 steps (``kernels_k8.py``,
``csrc/krylov.cu``): ``alpha_s`` (alpha, then s) after the first matvec
and ``omega_xr_p`` (omega, x, r, the next rho1 and beta, then the next
iteration's p) after the second. A solve adds ``init`` and the first
``p_update``. The reference updates p at the top of an iteration; here
the update closes the one before, so after the last iteration p is
updated once more than the reference updates it, and nothing reads it.
The scalars stay on the device; the loop condition reads ||r||^2 once
per iteration: ``rnorm > tol * ||b||``, ``it < maxiter`` and rnorm
finite, as the reference's ``lax.while_loop`` condition. The breakdown
guards (1e-300) are the reference's. ``bicgstab_mp`` and ``gmres`` were
TPU measures and are not ported (ROADMAP).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from opm_tpu_torch.linalg import kernels_k8 as k8


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
    ws = k8.Workspace(b, kernels=not twin and b.device.type == "cuda")
    x, r, p, v = ws.x, ws.r, ws.p, ws.v
    rhat = b
    ops.init(ws, b)
    b_norm = math.sqrt(float(ws.sc[k8.BB]))
    rnorm = b_norm
    p = ops.p_update(ws, p, r, v)
    it = 0
    while rnorm > tol * b_norm and it < maxiter and math.isfinite(rnorm):
        phat = precond(p).contiguous()
        v = matvec(phat).contiguous()
        s = ops.alpha_s(ws, rhat, v, r)
        shat = precond(s).contiguous()
        t = matvec(shat).contiguous()
        x, r, p = ops.omega_xr_p(ws, t, s, x, r, phat, shat, rhat, p, v)
        it += 1
        rr = float(ws.sc[k8.RR])
        rnorm = math.sqrt(rr) if rr >= 0 else math.nan
    rel = rnorm / (b_norm if b_norm != 0 else 1.0)
    return KrylovResult(x=x, iterations=it, rel_residual=rel,
                        converged=bool(rel <= tol))
