"""K8's fused BiCGStab steps and the port's ``bicgstab`` on the CPU.

- ``alpha_s_plain`` and ``omega_xr_p_plain`` (the twins of the kernels'
  two steps per iteration) equal the composition of the single-step twins
  in the order the loop ran them before the steps were fused, bit for bit
  (``torch.equal`` on every vector and scalar slot), on seeded vectors: a
  healthy step and each breakdown guard (zero <rhat, v>, zero <t, t>, a
  collapsed rho, a collapsed omega).
- ``bicgstab`` makes exactly one ``alpha_s`` and one ``omega_xr_p`` per
  iteration, and one ``init`` and one ``p_update`` per solve, counted
  through a recording namespace in place of the dispatching one.
- ``bicgstab`` matches the JAX package's ``bicgstab`` on a small seeded,
  diagonally dominant system, with and without a Jacobi preconditioner:
  the same iteration count and x within 1e-10 of max|x| (the two sum
  their dot products in other orders).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from opm_tpu.linalg.krylov import bicgstab as ref_bicgstab
from opm_tpu_torch.linalg import kernels_k8 as k8
from opm_tpu_torch.linalg.krylov import bicgstab

torch.set_num_threads(2)

NC = 40


def _vecs(seed, k):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((3, NC))) for _ in range(k)]


def _case(name):
    """(sc, rhat, v, r, t, phat, shat, x, p, s or None): the inputs of one
    iteration's two steps, s None where alpha_s makes it."""
    rhat, v, r, t, phat, shat, x, p = _vecs(7, 8)
    sc = k8.new_scalars("cpu")
    k8.init_plain(rhat, sc)
    sc[k8.ALPHA] = 0.7
    sc[k8.OMEGA] = 0.3
    s = None
    if name == "zero_rhat_v":
        v = torch.zeros_like(v)
    elif name == "zero_tt":
        t = torch.zeros_like(t)
    elif name == "collapsed_rho":
        sc[k8.RHO1] = 0.0
    elif name == "collapsed_omega":
        # <t, s> == 0 exactly: disjoint supports
        t[:, NC // 2:] = 0.0
        s = r.clone()
        s[:, :NC // 2] = 0.0
    return sc, rhat, v, r, t, phat, shat, x, p, s


CASES = ["healthy", "zero_rhat_v", "zero_tt", "collapsed_rho",
         "collapsed_omega"]


@pytest.mark.parametrize("case", CASES)
def test_fused_twins_equal_single_steps(case):
    sc, rhat, v, r, t, phat, shat, x, p, s_in = _case(case)
    sc_a, sc_b = sc.clone(), sc.clone()
    # the single steps, in the loop's former order
    k8.dot_alpha_plain(rhat, v, sc_a)
    s_a = k8.s_update_plain(r, v, sc_a)
    s_use = s_a if s_in is None else s_in
    k8.dot_omega_plain(t, s_use, sc_a)
    x_a, r_a = k8.xr_update_plain(x, r, s_use, t, phat, shat, rhat, sc_a)
    p_a = k8.p_update_plain(p, r_a, v, sc_a)
    # the fused twins
    s_b = k8.alpha_s_plain(rhat, v, r, sc_b)
    s_use_b = s_b if s_in is None else s_in
    x_b, r_b, p_b = k8.omega_xr_p_plain(t, s_use_b, x, r, phat, shat, rhat,
                                        p, v, sc_b)
    for a, b in ((s_a, s_b), (x_a, x_b), (r_a, r_b), (p_a, p_b),
                 (sc_a, sc_b)):
        assert torch.equal(a, b)
    # the guard of the case took its branch
    if case == "zero_rhat_v":
        assert float(sc_b[k8.ALPHA]) == 0.0
    elif case in ("zero_tt", "collapsed_omega"):
        assert float(sc_b[k8.OMEGA]) == 0.0 and float(sc_b[k8.BETA]) == 0.0
    elif case == "collapsed_rho":
        assert float(sc_b[k8.BETA]) == 0.0 and float(sc_b[k8.OMEGA]) != 0.0
    else:
        assert all(float(sc_b[i]) != 0.0 for i in (k8.ALPHA, k8.OMEGA,
                                                    k8.BETA))


def _system(seed=3):
    """A diagonally dominant (3 NC)^2 system, its right-hand side and its
    diagonal."""
    rng = np.random.default_rng(seed)
    n = 3 * NC
    A = rng.standard_normal((n, n)) * 0.3
    A[np.diag_indices(n)] = np.abs(A).sum(axis=1) + 1.0
    b = rng.standard_normal((3, NC))
    return A, b


def test_bicgstab_launches_two_steps_per_iteration(monkeypatch):
    A, b = _system()
    At = torch.as_tensor(A)
    counts = dict.fromkeys(k8.STEPS, 0)
    real = k8.DISPATCH

    def recording(name):
        def run(*args):
            counts[name] += 1
            return getattr(real, name)(*args)
        return run

    monkeypatch.setattr(k8, "DISPATCH", SimpleNamespace(
        **{n: recording(n) for n in k8.STEPS}))
    res = bicgstab(lambda v: (At @ v.reshape(-1)).reshape(3, NC),
                   torch.as_tensor(b), tol=1e-10, maxiter=50)
    assert res.converged and res.iterations >= 3
    assert counts == dict(init=1, p_update=1, alpha_s=res.iterations,
                          omega_xr_p=res.iterations)


@pytest.mark.parametrize("jacobi", [False, True], ids=["none", "jacobi"])
def test_bicgstab_matches_reference(jacobi):
    A, b = _system()
    d = np.diag(A).reshape(3, NC).copy()
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    Aj, dj = jnp.asarray(A), jnp.asarray(d)

    def mv(v):
        return (At @ v.reshape(-1)).reshape(3, NC)

    def mv_ref(v):
        return (Aj @ v.reshape(-1)).reshape(3, NC)

    res = bicgstab(mv, torch.as_tensor(b),
                   precond=(lambda v: v / dt) if jacobi else None,
                   tol=1e-9, maxiter=50)
    ref = ref_bicgstab(mv_ref, jnp.asarray(b),
                       precond=(lambda v: v / dj) if jacobi else None,
                       tol=1e-9, maxiter=50)
    assert res.converged and bool(ref.converged)
    assert res.iterations == int(ref.iterations) >= 3
    xr = np.asarray(ref.x)
    assert np.abs(res.x.numpy() - xr).max() <= 1e-10 * np.abs(xr).max()


def test_bicgstab_equals_single_step_loop():
    """On the CPU the fused steps change nothing: the loop over the
    single-step twins, p updated at the top of an iteration as before the
    steps were fused, gives the same iterations and the same x bit for
    bit."""
    A, b = _system(seed=5)
    d = torch.as_tensor(np.diag(A).reshape(3, NC).copy())
    At, bt = torch.as_tensor(A), torch.as_tensor(b)

    def mv(v):
        return (At @ v.reshape(-1)).reshape(3, NC)

    def pc(v):
        return v / d

    tol, maxiter = 1e-9, 50
    sc = k8.new_scalars("cpu")
    k8.init_plain(bt, sc)
    x, r = torch.zeros_like(bt), bt.clone()
    p, v = torch.zeros_like(bt), torch.zeros_like(bt)
    b_norm = float(sc[k8.BB]) ** 0.5
    rnorm, it = b_norm, 0
    while rnorm > tol * b_norm and it < maxiter:
        p = k8.p_update_plain(p, r, v, sc)
        phat = pc(p)
        v = mv(phat)
        k8.dot_alpha_plain(bt, v, sc)
        s = k8.s_update_plain(r, v, sc)
        shat = pc(s)
        t = mv(shat)
        k8.dot_omega_plain(t, s, sc)
        x, r = k8.xr_update_plain(x, r, s, t, phat, shat, bt, sc)
        it += 1
        rnorm = float(sc[k8.RR]) ** 0.5
    res = bicgstab(mv, bt, precond=pc, tol=tol, maxiter=maxiter)
    assert res.iterations == it >= 3
    assert torch.equal(res.x, x)
