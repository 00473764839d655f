"""The port's block assembly and CPR linear-solver layer against the JAX
package on SPE1, and its structured GMG on its own: both packages on the
CPU in float64 with the reference's CPU settings, the same inputs handed
to both as numpy arrays.

SPE1 (300 cells) has no GMG level: its pressure stage is the dense
coarsest solve alone. The multi-level hierarchy is held on grids of its
own in tests/test_torch_gmg.py and on the toy deck's real system in
tests/test_torch_cpr.py.

Tolerances: assembly fields 1e-11 of each field's max (summation order),
and the block operator against the dense torch.func.jacfwd Jacobian 1e-9
of max|J v| (the reference test's own bound); the operator, Schur pieces,
inv3x3/inv4x4 (healthy blocks), CPR weights and pressure system 1e-12.
The coarsest level is solved in float32 on both sides (a reference
caveat), so what goes through it (a CPR apply, BiCGStab's x and the
Newton increment) is held to float32-level bounds, each stated where it
is used."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from opm_tpu.io.eclstate import load_case as ref_load_case
from opm_tpu.linalg import precond as rprecond
from opm_tpu.linalg.gmg import StructuredGmg as RefGmg
from opm_tpu.linalg.krylov import bicgstab as ref_bicgstab
from opm_tpu.models import linearize as rlin
from opm_tpu.models.blackoil import make_well_device_arrays as ref_wd
from opm_tpu.models.state import BlackoilState as RefState
from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil as RefSim
from opm_tpu.solver.update import update_state as ref_update
from opm_tpu_torch.io.eclstate import load_case
from opm_tpu_torch.linalg import precond
from opm_tpu_torch.linalg.krylov import bicgstab
from opm_tpu_torch.models import linearize
from opm_tpu_torch.models.blackoil import make_well_device_arrays
from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                        init_well_state, report_step_wells)
from opm_tpu_torch.solver.newton import NonlinearSolver, connection_offsets
from opm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE1 = os.path.join(ROOT, "data", "SPE1CASE2.DATA")
DT = 86400.0 * 5


def _scaled(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    scale = max(np.abs(b).max(), 1e-300) if b.size else 1.0
    assert err <= tol * scale, f"{err / scale:.3e} of max"


def spe1_state_np(depth, nw, seed=0):
    """Near SPE1's initial equilibrium (connate water, undersaturated oil
    at rs ~ 200 sm3/sm3, oil gradient) with seeded noise and free gas in
    a fifth of the cells."""
    rng = np.random.default_rng(seed)
    nc = depth.shape[0]
    hc = (rng.random(nc) >= 0.2).astype(np.int32)
    sw = 0.12 + rng.uniform(0.0, 0.05, nc)
    x = np.where(hc == 0, rng.uniform(0.01, 0.1, nc),
                 200.0 * (1.0 + 0.01 * rng.standard_normal(nc)))
    p = 3.3e7 + 7.0e3 * (depth - depth.mean()) \
        + 1.0e4 * rng.standard_normal(nc)
    return dict(pressure=p, sw=sw, x=x, hcstate=hc, bhp=np.zeros(nw),
                qs=np.zeros((nw, 3)), control=np.zeros(nw, np.int32),
                target=np.zeros(nw))


def _ref_state(snp):
    return RefState(**{k: (None if snp.get(k) is None
                           else jnp.asarray(snp[k]))
                       for k in RefState._fields})


@pytest.fixture(scope="module")
def spe1():
    port = SimulatorFullyImplicitBlackoil(load_case(SPE1), device="cpu")
    ref = RefSim(ref_load_case(SPE1), fused=False)
    solver = NonlinearSolver(port.model, linear_solver="cpr")
    ws = report_step_wells(port.schedule.report_steps[0], port.grid,
                           port.well_names, port.max_perf)
    wd_p = make_well_device_arrays(ws, port.grid.gravity, "cpu")
    ws_r = ref._pad_well_set(ref._well_set_for(ref.schedule.report_steps[0]))
    wd_r = ref_wd(ws_r, ref.grid.gravity)
    s_p = init_well_state(state_from_numpy(
        spe1_state_np(port.grid.depth, ws.nw), "cpu"), ws, True)
    snp = state_to_numpy(s_p)
    acc0 = port.model.accumulation(s_p)
    cdp = connection_offsets(port.model, s_p, wd_p)
    dims = tuple(port.model.dims)
    amg_r = RefGmg(dims, ref.grid.trans[:ref.grid.nf_canonical])
    rng = np.random.default_rng(1)
    nc, nw = port.model.nc, ws.nw
    v = rng.standard_normal((3, nc))
    vw = rng.standard_normal((nw, 4))

    def ref_all(state, acc0, wd, cdp, v, vw):
        sys = rlin.assemble(ref.model, state, acc0, jnp.asarray(DT), wd,
                            cdp)
        mv, rhs, rec = rlin.schur_eliminate_wells(sys, dims=dims)
        w = rprecond.quasi_impes_weights(sys.diag)
        diag_p, off = rprecond.cpr_pressure_system(sys, w, dims=dims)
        M = rprecond.make_cpr_cells(sys, amg_r, dims=dims)
        kr = ref_bicgstab(mv, rhs, precond=M, tol=1e-2, maxiter=50)
        du_w = rec(kr.x)
        new = ref_update(ref.model, state, jnp.concatenate([
            kr.x[0], kr.x[1], kr.x[2], du_w[:, 3], du_w[:, :3].reshape(-1)]))
        return dict(sys=sys, rhs=rhs, mv=mv(v), rec=rec(v), w=w,
                    diag_p=diag_p, off=off, M=M(v),
                    full=rlin.matvec(sys, v, vw, dims=dims), x=kr.x,
                    its=kr.iterations, ok=kr.converged, new=new)

    out = jax.jit(ref_all)(_ref_state(snp), jnp.asarray(acc0.numpy()), wd_r,
                           jnp.asarray(cdp.numpy()), jnp.asarray(v),
                           jnp.asarray(vw))
    sys = linearize.assemble(port.model, s_p, acc0, DT, wd_p, cdp)
    return dict(port=port, solver=solver, s=s_p, acc0=acc0, wd=wd_p,
                cdp=cdp, dims=dims, v=torch.from_numpy(v),
                vw=torch.from_numpy(vw), sys=sys,
                ref=jax.tree.map(np.asarray, out))


@pytest.mark.parametrize("field", ["r_cell", "r_well", "diag", "face_L",
                                   "face_R", "cw", "wc", "wd_diag"])
def test_assembly_matches_reference(spe1, field):
    r = getattr(spe1["ref"]["sys"], field)
    if isinstance(r, tuple):
        r = np.stack(r)
    _scaled(getattr(spe1["sys"], field).numpy(), r, 1e-11)


def test_assembly_matches_dense_jacobian(spe1):
    """The block operator equals the dense torch.func.jacfwd Jacobian of
    the residual (the dense route's) on random probes
    (tests/test_linalg.py:145 in port form)."""
    port, sys = spe1["port"], spe1["sys"]
    model = port.model
    nc, nw = model.nc, spe1["s"].bhp.shape[0]
    J, r = port.solver.jacobian(spe1["s"], spe1["acc0"], DT, spe1["wd"],
                                spe1["cdp"])
    _scaled(sys.r_cell.reshape(-1).numpy(), r[:3 * nc].numpy(), 1e-12)
    rng = np.random.default_rng(4)
    for _ in range(3):
        u = torch.from_numpy(rng.standard_normal(J.shape[1]))
        vc = u[:3 * nc].reshape(3, nc)
        vw = torch.cat([u[3 * nc + nw:].reshape(nw, 3),
                        u[3 * nc:3 * nc + nw, None]], dim=1)
        oc, ow = linearize.matvec(sys, vc, vw, spe1["dims"])
        ref = (J @ u).numpy()
        got = np.concatenate([oc.reshape(-1).numpy(),
                              ow[:, :3].reshape(-1).numpy(),
                              ow[:, 3].numpy()])
        assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()


def test_operator_matches_reference(spe1):
    oc, ow = linearize.matvec(spe1["sys"], spe1["v"], spe1["vw"],
                              spe1["dims"])
    rc, rw = spe1["ref"]["full"]
    _scaled(oc.numpy(), rc, 1e-12)
    _scaled(ow.numpy(), rw, 1e-12)


def test_schur_matches_reference(spe1):
    mv, rhs, rec = linearize.schur_eliminate_wells(spe1["sys"], spe1["dims"])
    ref = spe1["ref"]
    _scaled(rhs.numpy(), ref["rhs"], 1e-12)
    _scaled(mv(spe1["v"]).numpy(), ref["mv"], 1e-12)
    _scaled(rec(spe1["v"]).numpy(), ref["rec"], 1e-12)


def test_cpr_weights_and_pressure_system(spe1):
    sys = spe1["sys"]
    w = precond.quasi_impes_weights(sys.diag)
    diag_p, off = precond.cpr_pressure_system(sys, w, spe1["dims"])
    ref = spe1["ref"]
    np.testing.assert_allclose(w.numpy(), ref["w"], rtol=1e-12, atol=0)
    np.testing.assert_allclose(diag_p.numpy(), ref["diag_p"], rtol=1e-12,
                               atol=0)
    _scaled(off.numpy(), ref["off"], 1e-12)
    # the K6 setup's plain version gives the same, plus D^-1
    dinv, w2, dp2, off2 = precond.cpr_setup_plain(
        sys.diag, sys.face_L, sys.face_R, spe1["dims"])
    assert torch.equal(w2, w) and torch.equal(dp2, diag_p)
    assert torch.equal(off2, off)
    eye = torch.einsum("ijn,jkn->ikn", sys.diag.reshape(3, 3, -1),
                       dinv.reshape(3, 3, -1))
    _scaled(eye.numpy(), np.broadcast_to(np.eye(3)[:, :, None], eye.shape),
            1e-12)


def test_cpr_apply_matches_reference(spe1):
    """SPE1 has no GMG level: the pressure stage is the float32 coarsest
    solve of all 300 cells, so one apply is held to 1e-5 of max (measured
    2.8e-6)."""
    M = precond.make_cpr_cells(spe1["sys"], spe1["solver"].amg,
                               spe1["dims"])
    assert not spe1["solver"].amg.levels
    _scaled(M(spe1["v"]).numpy(), spe1["ref"]["M"], 1e-5)


def test_bicgstab_and_increment_match_reference(spe1):
    """Same iteration count; x and the Newton increment within 1e-5 of max
    (the float32 coarse solve and the dot-product order separate the
    iterates, see tests/test_torch_cpr.py)."""
    sys = spe1["sys"]
    mv, rhs, _ = linearize.schur_eliminate_wells(sys, spe1["dims"])
    M = precond.make_cpr_cells(sys, spe1["solver"].amg, spe1["dims"])
    res = bicgstab(mv, rhs, precond=M, tol=1e-2, maxiter=50)
    ref = spe1["ref"]
    assert res.converged and bool(ref["ok"])
    assert res.iterations == int(ref["its"])
    _scaled(res.x.numpy(), ref["x"], 1e-5)
    new, its, ok = spe1["solver"]._solve_cpr(
        spe1["s"], spe1["acc0"], DT, spe1["wd"], spe1["cdp"], 1.0)
    assert ok and its == res.iterations
    old, new = state_to_numpy(spe1["s"]), state_to_numpy(new)
    np.testing.assert_array_equal(new["hcstate"],
                                  np.asarray(ref["new"].hcstate))
    for f in ("pressure", "sw", "x", "bhp", "qs"):
        _scaled(new[f] - old[f], np.asarray(getattr(ref["new"], f)) - old[f],
                1e-5)


# ---------------------------------------------------------------------------
# block inverses

def test_inv3x3_matches_reference():
    rng = np.random.default_rng(0)
    m = rng.standard_normal((10, 3, 3)) + 3 * np.eye(3)
    _scaled(precond.inv3x3(torch.from_numpy(m)).numpy(),
            rprecond.inv3x3(jnp.asarray(m)), 1e-12)
    rows = torch.from_numpy(m.transpose(1, 2, 0).reshape(9, -1).copy())
    _scaled(precond.inv3x3_rows(rows).numpy(),
            np.stack(rprecond.inv3x3_rows(tuple(jnp.asarray(r.numpy())
                                                for r in rows))), 1e-12)


def test_inv4x4_healthy_and_rank_deficient():
    """tests/test_linalg.py:439 in port form: exact on a healthy well
    block, bounded and consistent on a rank-deficient one, and equal to
    the reference's inverse on both."""
    rng = np.random.default_rng(7)
    healthy = np.eye(4) + 0.1 * rng.normal(size=(4, 4))
    healthy[:, 3] *= 1e-7
    healthy[3] = [0.0, -1.0, 0.0, 0.0]
    v = np.array([219.0, 42.3, 1.02, -1.6e-7])
    sick = np.stack([0.001 * v, -0.0008 * v, v,
                     np.array([0.0, -1.0, 0.0, 0.0])])
    m = np.stack([healthy, sick])
    inv = precond.inv4x4(torch.from_numpy(m)).numpy()
    ref = np.asarray(rprecond.inv4x4(jnp.asarray(m)))
    # healthy: the reference's inverse to 1e-12, a true inverse to ~lam
    _scaled(inv[0], ref[0], 1e-12)
    assert np.abs(inv[0] @ healthy - np.eye(4)).max() < 2e-2
    # sick: a bounded pseudo-inverse (the reference's own bound on the
    # equilibrated amplification). Its entries are set by roundoff at
    # this conditioning (the two packages' differ by O(1) relative), so
    # only the bound is compared.
    r = np.abs(sick).max(axis=1)
    c = np.abs(sick / r[:, None]).max(axis=0)
    assert np.abs(r[None, :] * inv[1] * c[:, None]).max() < 1e13
    assert np.isfinite(inv).all()
