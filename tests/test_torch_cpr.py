"""The port's CPR Newton route against the JAX package on the toy
SPE10-like deck (15x44x4 = 2640 cells, above the dense limit, three
structured-GMG levels), both on the CPU in float64 with the reference's
CPU settings.

Inputs: one numpy-seeded state with free-gas and undersaturated cells
(pressure hydrostatic plus noise), the deck's first-report-step wells, dt = 1 day,
the same arrays handed to both packages. The reference runs once, in one
jitted function over every quantity compared (its jit compile is most of
this file's time).

The coarsest GMG level is inverted in float32 and applied to a float32
copy of its right-hand side on both sides (a reference caveat, ROADMAP
Queue 3). LAPACK's and XLA's float32 inverses differ in the last bits, and
a last-bit difference of a float64 input can round the float32 right-hand
side the other way, so the inverse is held to 1e-5 of its max and the
V-cycle and one CPR apply to 1e-6 of max (measured: 6.2e-7 and 8.7e-8);
the level operations the V-cycle is made of are held to 1e-12 on their
own.

Tolerances otherwise: assembly fields 1e-11 of each field's max
(summation order); the operator, Schur pieces, CPR weights, pressure
system and Galerkin values 1e-12 of max. BiCGStab: the same iteration
count, and x and the whole Newton increment (new - old state, every
primary variable) within 1e-5 of max (measured 2.2e-6): BiCGStab
amplifies roundoff, and the reference's own x moves by up to 2e-3 of
max|x| under a 1e-15 relative perturbation of its right-hand side on this
deck's t = 0 system (measured), so the packages' dot-product summation
orders and the float32 coarse solve alone separate their iterates."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from opm_tpu.linalg import precond as rprecond
from opm_tpu.linalg.krylov import bicgstab as ref_bicgstab
from opm_tpu.models import linearize as rlin
from opm_tpu.models.blackoil import make_well_device_arrays as ref_wd
from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil as RefSim
from opm_tpu.sim.testcases import spe10like_case as ref_spe10like_case
from opm_tpu.solver.update import update_state as ref_update
from opm_tpu_torch.linalg import precond
from opm_tpu_torch.linalg import gmg
from opm_tpu_torch.linalg.krylov import bicgstab
from opm_tpu_torch.models import linearize
from opm_tpu_torch.models.blackoil import make_well_device_arrays
from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                        init_well_state, report_step_wells)
from opm_tpu_torch.sim.testcases import spe10like_case
from opm_tpu_torch.solver.newton import connection_offsets
from opm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

TOY = dict(nx=15, ny=44, nz=4, tsteps="3*1")
DT = 86400.0
TOL_F32_INV = 1e-5
TOL_F32_COARSE = 1e-6
TOL_KRYLOV = 1e-5


def seeded_state_np(nc, depth, nw, seed=0):
    """Near the deck's equilibrium (connate water, rs of its RSVD, oil
    gradient) with seeded noise and free gas in a tenth of the cells (the
    deck is DISGAS without VAPOIL)."""
    rng = np.random.default_rng(seed)
    hc = (rng.random(nc) >= 0.1).astype(np.int32)
    sw = 0.2 + rng.uniform(0.0, 0.05, nc)
    x = np.where(hc == 0, rng.uniform(0.01, 0.1, nc),
                 71.24 * (1.0 + 0.01 * rng.standard_normal(nc)))
    p = 4.1e7 + 7.0e3 * (depth - depth.mean()) \
        + 1.0e4 * rng.standard_normal(nc)
    return dict(pressure=p, sw=sw, x=x, hcstate=hc, bhp=np.zeros(nw),
                qs=np.zeros((nw, 3)), control=np.zeros(nw, np.int32),
                target=np.zeros(nw))


@pytest.fixture(scope="module")
def toy():
    port = SimulatorFullyImplicitBlackoil(spe10like_case(**TOY), device="cpu")
    ref = RefSim(ref_spe10like_case(**TOY), fused=False)
    step = port.schedule.report_steps[0]
    ws = report_step_wells(step, port.grid, port.well_names, port.max_perf)
    wd_p = make_well_device_arrays(ws, port.grid.gravity, "cpu")
    ws_r = ref._pad_well_set(ref._well_set_for(ref.schedule.report_steps[0]))
    wd_r = ref_wd(ws_r, ref.grid.gravity)
    s0 = state_from_numpy(seeded_state_np(port.model.nc, port.grid.depth,
                                          ws.nw), "cpu")
    s_p = init_well_state(s0, ws, True)
    snp = state_to_numpy(s_p)
    s_r = _ref_state(snp)
    acc0_p = port.model.accumulation(s_p)
    cdp_p = connection_offsets(port.model, s_p, wd_p)
    acc0_r = jnp.asarray(acc0_p.numpy())
    cdp_r = jnp.asarray(cdp_p.numpy())
    dims = tuple(port.model.dims)
    rng = np.random.default_rng(1)
    v = rng.standard_normal((3, port.model.nc))
    vw = rng.standard_normal((ws.nw, 4))
    amg_r = ref.solver.amg

    def ref_all(state, acc0, wd, cdp, v, vw):
        dt = jnp.asarray(DT)
        sys = rlin.assemble(ref.model, state, acc0, dt, wd, cdp)
        mv, rhs, rec = rlin.schur_eliminate_wells(sys, dims=dims)
        w = rprecond.quasi_impes_weights(sys.diag)
        diag_p, off = rprecond.cpr_pressure_system(sys, w, dims=dims)
        vals = amg_r.coarsen_values(diag_p, off)
        M = rprecond.make_cpr_cells(sys, amg_r, dims=dims)
        kr = ref_bicgstab(mv, rhs, precond=M, tol=1e-2, maxiter=50)
        # the rest of the reference's _solve_cpr (Schur branch)
        du_w = rec(kr.x)
        new = ref_update(ref.model, state, jnp.concatenate([
            kr.x[0], kr.x[1], kr.x[2], du_w[:, 3], du_w[:, :3].reshape(-1)]))
        return dict(sys=sys, rhs=rhs, mv=mv(v), rec=rec(v), w=w,
                    diag_p=diag_p, off=off, vals=vals,
                    vcycle=amg_r.vcycle(vals, v[0]), M=M(v),
                    full=rlin.matvec(sys, v, vw, dims=dims), x=kr.x,
                    its=kr.iterations, ok=kr.converged, new=new)

    out = jax.jit(ref_all)(s_r, acc0_r, wd_r, cdp_r, jnp.asarray(v),
                           jnp.asarray(vw))
    out = jax.tree.map(np.asarray, out)
    return dict(port=port, ref_amg=amg_r, ref_model=ref.model, s=s_p,
                s_ref=s_r, acc0=acc0_p, wd=wd_p, cdp=cdp_p,
                dims=dims, v=torch.from_numpy(v), vw=torch.from_numpy(vw),
                ref=out)


def _ref_state(snp):
    from opm_tpu.models.state import BlackoilState
    return BlackoilState(**{k: (None if snp.get(k) is None
                                else jnp.asarray(snp[k]))
                            for k in BlackoilState._fields})


@pytest.fixture(scope="module")
def system(toy):
    m = toy["port"].model
    sys = linearize.assemble(m, toy["s"], toy["acc0"], DT, toy["wd"],
                             toy["cdp"])
    return sys


def _scaled(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= tol * max(np.abs(b).max(), 1e-300), \
        f"{err / max(np.abs(b).max(), 1e-300):.3e} of max"


@pytest.mark.parametrize("field", ["r_cell", "r_well", "diag", "face_L",
                                   "face_R", "cw", "wc", "wd_diag"])
def test_assembly_matches_reference(toy, system, field):
    ref = toy["ref"]["sys"]
    r = getattr(ref, field)
    if isinstance(r, tuple):
        r = np.stack(r)
    _scaled(getattr(system, field).numpy(), r, 1e-11)


def test_operator_matches_reference(toy, system):
    oc, ow = linearize.matvec(system, toy["v"], toy["vw"], toy["dims"])
    rc, rw = toy["ref"]["full"]
    _scaled(oc.numpy(), rc, 1e-12)
    _scaled(ow.numpy(), rw, 1e-12)


def test_schur_matches_reference(toy, system):
    mv, rhs, rec = linearize.schur_eliminate_wells(system, toy["dims"])
    _scaled(rhs.numpy(), toy["ref"]["rhs"], 1e-12)
    _scaled(mv(toy["v"]).numpy(), toy["ref"]["mv"], 1e-12)
    _scaled(rec(toy["v"]).numpy(), toy["ref"]["rec"], 1e-12)


def test_cpr_setup_matches_reference(toy, system):
    dinv, w, diag_p, off = precond.cpr_setup_plain(
        system.diag, system.face_L, system.face_R, toy["dims"])
    ref = toy["ref"]
    _scaled(w.numpy(), ref["w"], 1e-12)
    np.testing.assert_allclose(diag_p.numpy(), ref["diag_p"], rtol=1e-12,
                               atol=0)
    _scaled(off.numpy(), ref["off"], 1e-12)
    # dinv is the block-Jacobi inverse
    rinv = np.stack(rprecond.inv3x3_rows(tuple(jnp.asarray(np.asarray(d))
                                              for d in system.diag)))
    np.testing.assert_allclose(dinv.numpy(), rinv, rtol=1e-12, atol=1e-300)


@pytest.fixture(scope="module")
def gmg_vals(toy, system):
    _, _, diag_p, off = precond.cpr_setup_plain(
        system.diag, system.face_L, system.face_R, toy["dims"])
    return toy["port"].solver.amg.coarsen_values(diag_p, off)


def test_gmg_values_match_reference(toy, gmg_vals):
    amg = toy["port"].solver.amg
    assert len(amg.levels) >= 3
    rvals = toy["ref"]["vals"]
    for (d3, offs), (rd3, roffs) in zip(gmg_vals[:-1], rvals[:-1]):
        _scaled(d3.numpy(), rd3, 1e-12)
        for (aL, aR), (raL, raR) in zip(offs, roffs):
            _scaled(aL.numpy(), raL, 1e-12)
            _scaled(aR.numpy(), raR, 1e-12)
    # float32 inverses by LAPACK and by XLA: float32 accuracy
    _scaled(gmg_vals[-1].numpy(), rvals[-1], TOL_F32_INV)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_gmg_level_ops_match_reference(toy, gmg_vals, level):
    """K7's plain level operations against the reference's stencil,
    damped-Jacobi sweep and pair-sum restriction on the real hierarchy's
    values."""
    from opm_tpu.linalg.gmg import StructuredGmg as RefGmg
    from opm_tpu.linalg.gmg import _pairsum as ref_pairsum

    lv = toy["port"].solver.amg.levels[level]
    d3, offs = gmg_vals[level]
    rng = np.random.default_rng(2 + level)
    x = rng.standard_normal(tuple(d3.shape))
    b = rng.standard_normal(tuple(d3.shape))
    rd3 = jnp.asarray(d3.numpy())
    roffs = tuple((jnp.asarray(aL.numpy()), jnp.asarray(aR.numpy()))
                  for aL, aR in offs)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    ax = RefGmg._matvec(rd3, roffs, jnp.asarray(x))
    _scaled(gmg.stencil_plain(d3, offs, xt).numpy(), ax, 1e-12)
    ref_sweep = toy["ref_amg"]._smooth(rd3, roffs, jnp.asarray(x),
                                       jnp.asarray(b))
    _scaled(gmg.smooth_plain(d3, offs, xt, bt).numpy(), ref_sweep, 1e-12)
    _scaled(gmg.restrict_plain(d3, offs, xt, bt, lv.axis, -1).numpy(),
            ref_pairsum(jnp.asarray(b) - ax, lv.axis), 1e-12)


def test_gmg_vcycle_matches_reference(toy, gmg_vals):
    _scaled(toy["port"].solver.amg.vcycle(gmg_vals, toy["v"][0]).numpy(),
            toy["ref"]["vcycle"], TOL_F32_COARSE)


def test_cpr_apply_matches_reference(toy, system):
    M = precond.make_cpr_cells(system, toy["port"].solver.amg, toy["dims"])
    _scaled(M(toy["v"]).numpy(), toy["ref"]["M"], TOL_F32_COARSE)


def test_bicgstab_matches_reference(toy, system):
    mv, rhs, _ = linearize.schur_eliminate_wells(system, toy["dims"])
    M = precond.make_cpr_cells(system, toy["port"].solver.amg, toy["dims"])
    res = bicgstab(mv, rhs, precond=M, tol=1e-2, maxiter=50)
    assert res.converged
    assert res.iterations == int(toy["ref"]["its"])
    _scaled(res.x.numpy(), toy["ref"]["x"], TOL_KRYLOV)


def test_newton_increment_matches_reference(toy):
    """_solve_cpr -> update_state from the same state: the increments
    (new - old) of every primary variable agree."""
    port = toy["port"]
    new, its, ok = port.solver._solve_cpr(toy["s"], toy["acc0"], DT,
                                          toy["wd"], toy["cdp"], 1.0)
    ref = toy["ref"]
    assert ok and bool(ref["ok"]) and its == int(ref["its"])
    old = state_to_numpy(toy["s"])
    new = state_to_numpy(new)
    rnew = ref["new"]
    np.testing.assert_array_equal(new["hcstate"], np.asarray(rnew.hcstate))
    for f in ("pressure", "sw", "x", "bhp", "qs"):
        _scaled(new[f] - old[f], np.asarray(getattr(rnew, f)) - old[f],
                TOL_KRYLOV)


def test_update_plain_matches_reference_on_toy(toy):
    """K9's update twins composed from the CPR route's call form ((3, nc)
    cell increments, the well recovery's (nw, 4) increments, omega 0.8
    applied inside) against the reference's update_state on omega * du
    over the toy deck's free-gas and undersaturated cells, with increments
    large enough to chop and switch: hcstate exact, 1e-14 relative."""
    from opm_tpu_torch.solver.update import update_state
    port = toy["port"]
    nc, nw = port.model.nc, toy["s"].bhp.shape[0]
    rng = np.random.default_rng(9)
    du_c = rng.standard_normal((3, nc)) * np.array([[5e6], [0.2], [0.2]])
    hc = toy["s"].hcstate.numpy()
    du_c[2] = np.where(hc == 1, du_c[2] * 200.0, du_c[2])
    du_w = rng.standard_normal((nw, 4)) * np.array([1e-3, 1e-3, 1e-3, 1e6])
    omega = 0.8
    flat = np.concatenate([du_c.reshape(-1), du_w[:, 3],
                           du_w[:, :3].reshape(-1)])
    new_r = ref_update(toy["ref_model"], toy["s_ref"],
                       jnp.asarray(omega * flat))
    new_p = state_to_numpy(update_state(
        port.model, toy["s"], torch.from_numpy(du_c), omega,
        du_w=torch.from_numpy(du_w)))
    assert np.array_equal(new_p["hcstate"], np.asarray(new_r.hcstate))
    assert np.any(new_p["hcstate"] != hc)
    for f in ("pressure", "sw", "x", "bhp", "qs"):
        a, b = new_p[f], np.asarray(getattr(new_r, f))
        assert np.all(np.abs(a - b) <= 1e-14 * np.abs(b) + 1e-300), f
