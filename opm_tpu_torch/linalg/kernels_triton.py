"""K8: the BiCGStab vector recurrences in Triton, with their plain twins.

Replaces the vector work of the JAX package's linalg/krylov.py
``bicgstab`` (:68-93): the axpys and the ``jnp.vdot`` reductions that XLA
fused around the matvec and the preconditioner on the TPU. Each step is
one pass over (3, nc) float64 vectors, its dot products fused in:

* ``init``: <b, b> (rho1 and ||b||^2) and the first beta;
* ``p_update``: p = r + beta (p - omega v), in place;
* ``dot_alpha``: <rhat, v> and alpha = rho1 / <rhat, v>;
* ``s_update``: s = r - alpha v;
* ``dot_omega``: <t, t> and <t, s> together, and omega;
* ``xr_update``: x += alpha phat + omega shat and r = s - omega t, in
  place, with <r, r> and <rhat, r> (the next rho1), then the next beta.

The scalars (rho1, rho, alpha, omega, beta, ||r||^2, ||b||^2 and the
breakdown threshold 1e-300) live in one float64 device tensor ``sc`` of
``NSC`` slots; each reduction's second pass also does the scalar algebra,
with the reference's breakdown guards, so a whole iteration needs one
host read (||r||^2, for the loop condition).

What bounds it on the card: memory traffic, 3 to 7 vector reads or writes
of 8 bytes per unknown per step. Reductions are deterministic: each
program sums a fixed block in a fixed tree order into a partial, and one
program sums the partials in a fixed order; no atomics, so repeated runs
give the same iteration counts. Launches pass ``enable_fp_fusion=False``
(products and sums round as the twins' separate operations) and every
float64 constant comes through ``sc`` (Triton types literals as float32).
Triton is imported inside the launchers only.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from opm_tpu_torch.utils import cuda_lib

RHO1, RHO, ALPHA, OMEGA, BETA, RR, BB, EPS = range(8)
NSC = 8
_BLOCK = 1024
_kernels: dict = {}


def new_scalars(device):
    """The scalar slots, with the breakdown threshold set."""
    sc = torch.zeros(NSC, dtype=torch.float64, device=device)
    sc[EPS] = 1e-300
    return sc


def _triton():
    if _kernels:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit
    def dot_partial(a, b, c, d, part, n, TWO: tl.constexpr,
                    BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        x = tl.load(a + offs, mask=m, other=0.0)
        y = tl.load(b + offs, mask=m, other=0.0)
        tl.store(part + pid * 2, tl.sum(x * y, axis=0))
        if TWO:
            x2 = tl.load(c + offs, mask=m, other=0.0)
            y2 = tl.load(d + offs, mask=m, other=0.0)
            tl.store(part + pid * 2 + 1, tl.sum(x2 * y2, axis=0))
        else:
            tl.store(part + pid * 2 + 1, 0.0)

    @triton.jit
    def finish(part, nparts, sc, MODE: tl.constexpr, BLOCK: tl.constexpr):
        offs0 = tl.arange(0, BLOCK)
        acc0 = tl.zeros([BLOCK], dtype=tl.float64)
        acc1 = tl.zeros([BLOCK], dtype=tl.float64)
        for start in range(0, nparts, BLOCK):
            offs = start + offs0
            m = offs < nparts
            acc0 += tl.load(part + offs * 2, mask=m, other=0.0)
            acc1 += tl.load(part + offs * 2 + 1, mask=m, other=0.0)
        s0 = tl.sum(acc0, axis=0)
        s1 = tl.sum(acc1, axis=0)
        eps = tl.load(sc + 7)
        if MODE == 0:      # init: rho1 = rr = bb = <b, b>; rho = alpha =
            one = eps * 0.0 + 1.0   # omega = 1, so beta = rho1
            beta = (s0 / one) * (one / one)
            tl.store(sc + 0, s0)
            tl.store(sc + 1, one)
            tl.store(sc + 2, one)
            tl.store(sc + 3, one)
            tl.store(sc + 4, beta)
            tl.store(sc + 5, s0)
            tl.store(sc + 6, s0)
        if MODE == 1:      # alpha = rho1 / <rhat, v>
            rho1 = tl.load(sc + 0)
            ok = tl.abs(s0) > eps
            tl.store(sc + 2, tl.where(ok, rho1 / tl.where(ok, s0, 1.0), 0.0))
        if MODE == 2:      # omega = <t, s> / <t, t>
            ok = s0 > eps
            tl.store(sc + 3, tl.where(ok, s1 / tl.where(ok, s0, 1.0), 0.0))
        if MODE == 3:      # rr, next rho1, next beta
            rho = tl.load(sc + 0)
            alpha = tl.load(sc + 2)
            omega = tl.load(sc + 3)
            ok = (tl.abs(rho) > eps) & (tl.abs(omega) > eps)
            beta = tl.where(ok, (s1 / tl.where(ok, rho, 1.0))
                            * (alpha / tl.where(ok, omega, 1.0)), 0.0)
            tl.store(sc + 1, rho)
            tl.store(sc + 0, s1)
            tl.store(sc + 4, beta)
            tl.store(sc + 5, s0)

    @triton.jit
    def p_update(p, r, v, sc, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        beta = tl.load(sc + 4)
        omega = tl.load(sc + 3)
        pp = tl.load(p + offs, mask=m, other=0.0)
        rr = tl.load(r + offs, mask=m, other=0.0)
        vv = tl.load(v + offs, mask=m, other=0.0)
        tl.store(p + offs, rr + beta * (pp + (-omega) * vv), mask=m)

    @triton.jit
    def s_update(r, v, s, sc, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        alpha = tl.load(sc + 2)
        rr = tl.load(r + offs, mask=m, other=0.0)
        vv = tl.load(v + offs, mask=m, other=0.0)
        tl.store(s + offs, (-alpha) * vv + rr, mask=m)

    @triton.jit
    def xr_update(x, r, s, t, phat, shat, rhat, sc, part, n,
                  BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        alpha = tl.load(sc + 2)
        omega = tl.load(sc + 3)
        xx = tl.load(x + offs, mask=m, other=0.0)
        ph = tl.load(phat + offs, mask=m, other=0.0)
        sh = tl.load(shat + offs, mask=m, other=0.0)
        tl.store(x + offs, (xx + alpha * ph) + omega * sh, mask=m)
        ss = tl.load(s + offs, mask=m, other=0.0)
        tt = tl.load(t + offs, mask=m, other=0.0)
        rn = (-omega) * tt + ss
        tl.store(r + offs, rn, mask=m)
        rh = tl.load(rhat + offs, mask=m, other=0.0)
        tl.store(part + pid * 2, tl.sum(rn * rn, axis=0))
        tl.store(part + pid * 2 + 1, tl.sum(rh * rn, axis=0))

    _kernels.update(dot_partial=dot_partial, finish=finish,
                    p_update=p_update, s_update=s_update,
                    xr_update=xr_update, cdiv=triton.cdiv)
    return _kernels


def _check(vecs, sc):
    dev = sc.device
    n = vecs[0].numel()
    for t in vecs:
        if (t.dtype != torch.float64 or t.device != dev
                or not t.is_contiguous() or t.numel() != n):
            raise ValueError("K8: vectors must be contiguous float64 tensors "
                             f"of one size on {dev}")
    if sc.shape != (NSC,) or sc.dtype != torch.float64:
        raise ValueError(f"K8: sc must be a float64 ({NSC},) tensor")
    return n


_F = dict(num_warps=4, enable_fp_fusion=False)


def _grid(n):
    return (_triton()["cdiv"](n, _BLOCK),)


def _reduce(a, b, c, d, sc, mode):
    """Two-pass deterministic <a, b> (and <c, d>) into sc (mode algebra)."""
    k = _triton()
    n = a.numel()
    nparts = k["cdiv"](n, _BLOCK)
    part = torch.empty((nparts, 2), dtype=torch.float64, device=a.device)
    two = c is not None
    k["dot_partial"][(nparts,)](a, b, c if two else a, d if two else b,
                                part, n, TWO=two, BLOCK=_BLOCK, **_F)
    k["finish"][(1,)](part, nparts, sc, MODE=mode, BLOCK=1024, num_warps=8,
                      enable_fp_fusion=False)


# ---------------------------------------------------------------------------
# plain twins: the same arithmetic on torch tensors; sc is updated in place

def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _beta(rho1, rho, alpha, omega, eps):
    ok = (torch.abs(rho) > eps) & (torch.abs(omega) > eps)
    one = torch.ones_like(rho)
    return torch.where(ok, (rho1 / torch.where(ok, rho, one))
                       * (alpha / torch.where(ok, omega, one)),
                       torch.zeros_like(rho))


def init_plain(b, sc):
    bb = _dot(b, b)
    one = torch.ones_like(bb)
    sc[RHO1] = bb
    sc[RHO] = sc[ALPHA] = sc[OMEGA] = one
    sc[BETA] = _beta(bb, one, one, one, sc[EPS])
    sc[RR] = bb
    sc[BB] = bb


def p_update_plain(p, r, v, sc):
    return r + sc[BETA] * (p + (-sc[OMEGA]) * v)


def dot_alpha_plain(rhat, v, sc):
    denom = _dot(rhat, v)
    ok = torch.abs(denom) > sc[EPS]
    sc[ALPHA] = torch.where(ok, sc[RHO1] / torch.where(
        ok, denom, torch.ones_like(denom)), torch.zeros_like(denom))


def s_update_plain(r, v, sc):
    return (-sc[ALPHA]) * v + r


def dot_omega_plain(t, s, sc):
    tt = _dot(t, t)
    ts = _dot(t, s)
    ok = tt > sc[EPS]
    sc[OMEGA] = torch.where(ok, ts / torch.where(ok, tt, torch.ones_like(tt)),
                            torch.zeros_like(tt))


def xr_update_plain(x, r, s, t, phat, shat, rhat, sc):
    x = (x + sc[ALPHA] * phat) + sc[OMEGA] * shat
    r = (-sc[OMEGA]) * t + s
    rr = _dot(r, r)
    rho1 = _dot(rhat, r)
    beta = _beta(rho1, sc[RHO1], sc[ALPHA], sc[OMEGA], sc[EPS])
    sc[RHO] = sc[RHO1].clone()
    sc[RHO1] = rho1
    sc[BETA] = beta
    sc[RR] = rr
    return x, r


# ---------------------------------------------------------------------------
# Triton launchers (same contracts as the twins)

def init_triton(b, sc):
    _check((b,), sc)
    _reduce(b, b, None, None, sc, 0)
    init_triton.launches += 1


def p_update_triton(p, r, v, sc):
    n = _check((p, r, v), sc)
    _triton()["p_update"][_grid(n)](p, r, v, sc, n, BLOCK=_BLOCK, **_F)
    p_update_triton.launches += 1
    return p


def dot_alpha_triton(rhat, v, sc):
    _check((rhat, v), sc)
    _reduce(rhat, v, None, None, sc, 1)
    dot_alpha_triton.launches += 1


def s_update_triton(r, v, sc):
    n = _check((r, v), sc)
    s = torch.empty_like(r)
    _triton()["s_update"][_grid(n)](r, v, s, sc, n, BLOCK=_BLOCK, **_F)
    s_update_triton.launches += 1
    return s


def dot_omega_triton(t, s, sc):
    _check((t, s), sc)
    _reduce(t, t, t, s, sc, 2)
    dot_omega_triton.launches += 1


def xr_update_triton(x, r, s, t, phat, shat, rhat, sc):
    n = _check((x, r, s, t, phat, shat, rhat), sc)
    k = _triton()
    nparts = k["cdiv"](n, _BLOCK)
    part = torch.empty((nparts, 2), dtype=torch.float64, device=x.device)
    k["xr_update"][(nparts,)](x, r, s, t, phat, shat, rhat, sc, part, n,
                              BLOCK=_BLOCK, **_F)
    k["finish"][(1,)](part, nparts, sc, MODE=3, BLOCK=1024, num_warps=8,
                      enable_fp_fusion=False)
    xr_update_triton.launches += 1
    return x, r


for _f in (init_triton, p_update_triton, dot_alpha_triton, s_update_triton,
           dot_omega_triton, xr_update_triton):
    _f.launches = 0


def _dispatch(name):
    cuda_fn = globals()[name + "_triton"]
    plain_fn = globals()[name + "_plain"]

    def run(*args):
        return cuda_lib.dispatch(args[0], cuda_fn, plain_fn, *args,
                                 what=f"K8 {name}")

    run.__name__ = name
    return run


STEPS = ("init", "p_update", "dot_alpha", "s_update", "dot_omega",
         "xr_update")
# the steps by device (kernel on the card, twin on the CPU), and the twins
DISPATCH = SimpleNamespace(**{n: _dispatch(n) for n in STEPS})
PLAIN = SimpleNamespace(**{n: globals()[n + "_plain"] for n in STEPS})
