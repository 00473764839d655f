"""K8: the BiCGStab vector steps (``csrc/krylov.cu``), with their plain
twins.

Replaces the vector work of the JAX package's linalg/krylov.py
``bicgstab`` (:59-93): the axpys and the ``jnp.vdot`` reductions that XLA
fused around the matvec and the preconditioner on the TPU. The iteration
runs as two steps, each ending where the next needs a matvec or a
preconditioner apply:

* ``alpha_s``: <rhat, v> -> alpha, then s = r - alpha v;
* ``omega_xr_p``: <t, t> and <t, s> -> omega; x += alpha phat + omega
  shat and r = s - omega t in place, with <r, r> and <rhat, r> (the next
  rho1) and the next beta; then the next iteration's p = r + beta (p -
  omega v), in place;

and a solve adds ``init`` (<b, b> and the initial scalars) and the first
``p_update``. The scalars (rho1, rho, alpha, omega, beta, ||r||^2,
||b||^2 and the breakdown threshold 1e-300) live in one float64 device
tensor ``sc`` of ``NSC`` slots, so an iteration needs one host read
(||r||^2, for the loop condition).

The single-step twins (``init_plain`` .. ``xr_update_plain``) are the
plain arithmetic; ``alpha_s_plain`` and ``omega_xr_p_plain`` compose them
in the order the loop ran them before the steps were fused, so the CPU
path computes what it always computed. A ``Workspace`` per solve holds
the scalars, the solve's first x, r, p and v and, on the card, s, the
kernels' partial sums, their ticket counter, the grid (sized once per
device and length) and the stream: no step allocates. ``DISPATCH`` runs the
kernels for CUDA tensors and the twins for CPU tensors; ``PLAIN`` the
twins on any device.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from opm_tpu_torch.utils import cuda_lib

RHO1, RHO, ALPHA, OMEGA, BETA, RR, BB, EPS = range(8)
NSC = 8

_P, _I, _L = cuda_lib.P, cuda_lib.I, cuda_lib.L
_SIGS = {
    "opm_k8_grid": [_L, _P],
    "opm_k8_init": [_P, _L, _I, _P, _P, _P, _P],
    "opm_k8_p_update": [_P, _P, _P, _P, _L, _I, _P],
    "opm_k8_alpha_s": [_P] * 6 + [_L, _I, _P],
    "opm_k8_omega_xr_p": [_P] * 11 + [_L, _I, _P],
}
_grids: dict = {}


def new_scalars(device):
    """The scalar slots, with the breakdown threshold set."""
    sc = torch.zeros(NSC, dtype=torch.float64, device=device)
    sc[EPS] = 1e-300
    return sc


def grid_info(device, n):
    """(G, info) for vectors of n values on a CUDA device: the fixed grid
    of every K8 launch, and the occupancy query behind it (SMs, blocks per
    SM and registers per thread of init, p_update, alpha_s, omega_xr_p)."""
    key = (torch.device(device).index, n)
    if key not in _grids:
        lib = cuda_lib.load("krylov", _SIGS)
        out = (ctypes.c_int * 10)()
        with torch.cuda.device(device):
            cuda_lib.check(lib.opm_k8_grid(n, out), "opm_k8_grid")
        names = ("init", "p_update", "alpha_s", "omega_xr_p")
        _grids[key] = (out[0], dict(
            sms=out[1], blocks_per_sm=dict(zip(names, out[2:6])),
            registers=dict(zip(names, out[6:10]))))
    return _grids[key]


class Workspace:
    """One solve's K8 state for the right-hand side ``b``: the scalars
    ``sc``, the solve's first vectors x = 0, r = b, p = 0, v = 0 and, with
    ``kernels``, s (which alpha_s writes), the partial sums (4 G float64),
    the ticket counter and the stream, each checked once."""

    def __init__(self, b, kernels):
        self.device = b.device
        self.shape = b.shape
        self.n = b.numel()
        self.sc = new_scalars(b.device)
        self.x = torch.zeros_like(b)
        self.r = b.clone()
        self.p = torch.zeros_like(b)
        self.v = torch.zeros_like(b)
        self.kernels = kernels
        if not kernels:
            return
        self.lib = cuda_lib.load("krylov", _SIGS)
        self.grid, _ = grid_info(b.device, self.n)
        self.s = torch.empty_like(b)
        self.part = torch.empty(4 * self.grid, dtype=torch.float64,
                                device=b.device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=b.device)
        _check(self, b, self.x, self.r, self.p, self.v, self.s)
        self.stream = torch.cuda.current_stream(b.device).cuda_stream


def _check(ws, *ts):
    """Contiguous, 16-byte aligned float64 vectors of the solve's shape on
    its device; returns their data pointers."""
    out = []
    for t in ts:
        if (t.shape != ws.shape or t.dtype != torch.float64
                or t.device != ws.device or not t.is_contiguous()
                or t.data_ptr() & 15):
            raise ValueError("K8: vectors must be contiguous, 16-byte "
                             f"aligned float64 tensors of shape "
                             f"{tuple(ws.shape)} on {ws.device}")
        out.append(t.data_ptr())
    return out


# ---------------------------------------------------------------------------
# plain twins: the arithmetic on torch tensors; sc is updated in place

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


def alpha_s_plain(rhat, v, r, sc):
    """alpha = rho1 / <rhat, v>, then s = r - alpha v (returned)."""
    dot_alpha_plain(rhat, v, sc)
    return s_update_plain(r, v, sc)


def omega_xr_p_plain(t, s, x, r, phat, shat, rhat, p, v, sc):
    """omega, x and r with rr, rho1 and beta, then the next p: returns
    (x, r, p)."""
    dot_omega_plain(t, s, sc)
    x, r = xr_update_plain(x, r, s, t, phat, shat, rhat, sc)
    return x, r, p_update_plain(p, r, v, sc)


# ---------------------------------------------------------------------------
# CUDA wrappers: the workspace's tensors were checked when it was made; a
# step checks only the vectors it is handed (the matvec's and the
# preconditioner's outputs) and passes pointers

def init_cuda(ws, b):
    (pb,) = _check(ws, b)
    cuda_lib.check(ws.lib.opm_k8_init(
        pb, ws.n, ws.grid, ws.sc.data_ptr(), ws.part.data_ptr(),
        ws.ticket.data_ptr(), ws.stream), "opm_k8_init")
    init_cuda.launches += 1


def p_update_cuda(ws, p, r, v):
    """p (the workspace's) updated in place and returned."""
    pp, pr, pv = _check(ws, p, r, v)
    cuda_lib.check(ws.lib.opm_k8_p_update(
        pp, pr, pv, ws.sc.data_ptr(), ws.n, ws.grid, ws.stream),
        "opm_k8_p_update")
    p_update_cuda.launches += 1
    return p


def alpha_s_cuda(ws, rhat, v, r):
    """s into the workspace's s (returned)."""
    ph, pv, pr = _check(ws, rhat, v, r)
    cuda_lib.check(ws.lib.opm_k8_alpha_s(
        ph, pv, pr, ws.s.data_ptr(), ws.sc.data_ptr(), ws.part.data_ptr(),
        ws.n, ws.grid, ws.stream), "opm_k8_alpha_s")
    alpha_s_cuda.launches += 1
    return ws.s


def omega_xr_p_cuda(ws, t, s, x, r, phat, shat, rhat, p, v):
    """x, r and p updated in place and returned."""
    ptrs = _check(ws, t, s, x, r, phat, shat, rhat, p, v)
    cuda_lib.check(ws.lib.opm_k8_omega_xr_p(
        *ptrs, ws.sc.data_ptr(), ws.part.data_ptr(), ws.n, ws.grid,
        ws.stream), "opm_k8_omega_xr_p")
    omega_xr_p_cuda.launches += 1
    return x, r, p


for _f in (init_cuda, p_update_cuda, alpha_s_cuda, omega_xr_p_cuda):
    _f.launches = 0


STEPS = ("init", "p_update", "alpha_s", "omega_xr_p")

# the steps as the loop calls them, with the workspace first: the twins on
# any device (PLAIN), or by device (DISPATCH: the kernel on the card, the
# twin on the CPU)
PLAIN = SimpleNamespace(
    init=lambda ws, b: init_plain(b, ws.sc),
    p_update=lambda ws, p, r, v: p_update_plain(p, r, v, ws.sc),
    alpha_s=lambda ws, rhat, v, r: alpha_s_plain(rhat, v, r, ws.sc),
    omega_xr_p=lambda ws, *vecs: omega_xr_p_plain(*vecs, ws.sc))


def _init(ws, b):
    return cuda_lib.dispatch(b, init_cuda, PLAIN.init, ws, b,
                             what="K8 init")


def _p_update(ws, p, r, v):
    return cuda_lib.dispatch(p, p_update_cuda, PLAIN.p_update, ws, p, r, v,
                             what="K8 p_update")


def _alpha_s(ws, rhat, v, r):
    return cuda_lib.dispatch(rhat, alpha_s_cuda, PLAIN.alpha_s, ws, rhat, v,
                             r, what="K8 alpha_s")


def _omega_xr_p(ws, *vecs):
    return cuda_lib.dispatch(vecs[0], omega_xr_p_cuda, PLAIN.omega_xr_p, ws,
                             *vecs, what="K8 omega_xr_p")


DISPATCH = SimpleNamespace(init=_init, p_update=_p_update, alpha_s=_alpha_s,
                           omega_xr_p=_omega_xr_p)
