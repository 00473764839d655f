"""The port's residual path against the JAX package on SPE1: cell
quantities in all three hydrocarbon states, K3's plain face fluxes,
divergence and tangent, the residual and convergence norms and
update_state on states from the reference's own first report step, and
the dense Jacobian (torch.func.jacfwd through the K1/K3 Functions) against
jax.jacfwd.

Tolerances: cell quantities, residual and convergence 1e-11 relative
(summation order); the Jacobian 1e-10 of max|J|; update_state exact on
hcstate and 1e-14 relative elsewhere."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opm_tpu.io.eclstate import load_case as ref_load_case
from opm_tpu.models.blackoil import compute_cell_quantities as ref_ccq
from opm_tpu.models.blackoil import make_well_device_arrays as ref_wd
from opm_tpu.models.linearize import degenerate_x_mask as ref_mask
from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil as RefSim
from opm_tpu.solver.update import update_state as ref_update
from opm_tpu_torch.io.eclstate import load_case
from opm_tpu_torch.models import blackoil as mb
from opm_tpu_torch.models.linearize import degenerate_x_mask
from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                        report_step_wells)
from opm_tpu_torch.solver import kernels_k9 as k9
from opm_tpu_torch.solver.newton import connection_offsets
from opm_tpu_torch.solver.update import update_state
from opm_tpu_torch.utils.convert import (model_arrays_from_numpy,
                                         state_from_numpy, state_to_numpy)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE1 = os.path.join(ROOT, "data", "SPE1CASE2.DATA")
TOL = 1e-11


def _np_state(s):
    return {f: (None if getattr(s, f) is None else np.asarray(getattr(s, f)))
            for f in s._fields}


def _rel_close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b)
    assert np.all(err <= tol * np.abs(b) + 1e-300), \
        f"max rel {np.max(err / np.maximum(np.abs(b), 1e-300)):.3e}"


def _scaled_close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def ref_run():
    """The reference's first SPE1 report step, per-step path, with the
    state after every substep."""
    sim = RefSim(ref_load_case(SPE1), fused=False)
    step = sim.schedule.report_steps[0]
    ws = sim._pad_well_set(sim._well_set_for(step))
    from opm_tpu.sim.init import initial_state as ref_init
    s0 = sim._init_well_state(
        ref_init(sim.grid, sim.props, sim.case, ws.nw), ws, True)
    subs = []
    sim.events.event("timestep_completed").add(
        lambda s, tl, dt: subs.append((s, dt)))
    sim.run(report_step_limit=1)
    # (state at substep start, state at its end, dt)
    pairs = [(s0, subs[0][0], subs[0][1])]
    pairs += [(subs[k][0], subs[k + 1][0], subs[k + 1][1])
              for k in range(len(subs) - 1)]
    return sim, ref_wd(ws, sim.grid.gravity), pairs


@pytest.fixture(scope="module")
def port():
    sim = SimulatorFullyImplicitBlackoil(load_case(SPE1), device="cpu")
    step = sim.schedule.report_steps[0]
    ws = report_step_wells(step, sim.grid, sim.well_names, sim.max_perf)
    return sim, mb.make_well_device_arrays(ws, sim.grid.gravity, "cpu")


def test_model_arrays_from_reference(ref_run, port):
    """The reference's static arrays and padded well dict, handed over
    with model_arrays_from_numpy, equal the port's own."""
    rsim, wd_r, _ = ref_run
    psim, wd_p = port
    rm, pm = rsim.model, psim.model
    got = model_arrays_from_numpy(dict(
        pv=np.asarray(rm.pv), trans=np.asarray(rm.trans),
        face_cells=np.asarray(rm.face_cells), depth=np.asarray(rm.depth),
        pvtnum=np.asarray(rm.pvtnum), satnum=np.asarray(rm.satnum),
        wd={k: np.asarray(v) for k, v in wd_r.items()}), "cpu")
    for k in ("pv", "trans", "face_cells", "depth", "pvtnum", "satnum"):
        assert torch.equal(got[k], getattr(pm, k)), k
    assert got["wd"].keys() == wd_p.keys()
    for k, v in wd_p.items():
        assert got["wd"][k].dtype == v.dtype, k
        assert np.array_equal(got["wd"][k].numpy(), v.numpy(),
                              equal_nan=v.is_floating_point()), k


def _seeded(nc, seed):
    rng = np.random.default_rng(seed)
    hc = rng.integers(0, 3, nc).astype(np.int32)
    return dict(pressure=rng.uniform(1.5e7, 4.0e7, nc),
                sw=rng.uniform(0.12, 0.7, nc),
                x=np.where(hc == 0, rng.uniform(0.0, 0.3, nc),
                           np.where(hc == 1, rng.uniform(5.0, 150.0, nc),
                                    rng.uniform(0.0, 1e-4, nc))),
                hcstate=hc)


def test_cell_quantities_all_hcstates(ref_run, port):
    rsim, psim = ref_run[0], port[0]
    d = _seeded(rsim.model.nc, 0)
    assert set(d["hcstate"]) == {0, 1, 2}
    rm, pm = rsim.model, psim.model
    qr = ref_ccq(rm.props, *(jnp.asarray(d[k]) for k in
                             ("pressure", "sw", "x", "hcstate")),
                 rm.pvtnum, rm.satnum)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    qp = mb.compute_cell_quantities(pm.props, t["pressure"], t["sw"], t["x"],
                                    t["hcstate"], pm.pvtnum, pm.satnum)
    for f in qr._fields:
        _rel_close(getattr(qp, f).numpy(),
                   np.broadcast_to(getattr(qr, f), getattr(qp, f).shape))


def _states(ref_run, k):
    s_prev, s, dt = ref_run[2][k]
    return s_prev, s, dt, state_from_numpy(_np_state(s_prev), "cpu"), \
        state_from_numpy(_np_state(s), "cpu")


def test_face_fluxes_divergence_and_tangent(ref_run, port):
    rsim, psim = ref_run[0], port[0]
    rm, pm = rsim.model, psim.model
    _, s, _, _, ps = _states(ref_run, 1)
    qr, qp = rm.cell_quantities(s), pm.cell_quantities(ps)
    fr = rm.face_fluxes(qr)
    _scaled_close(pm.face_fluxes(qp).numpy(), fr)
    _scaled_close(mb.divergence(pm.dims, pm.face_fluxes(qp)).numpy(),
                  rm.divergence(fr))
    _scaled_close(pm.flux_divergence(qp).numpy(), rm.divergence(fr))

    # K3's tangent entry vs jax.jvp of the reference's flux + divergence
    rng = np.random.default_rng(1)
    nc = pm.nc
    prim = [np.stack([np.asarray(qr.pw), np.asarray(qr.po),
                      np.asarray(qr.pg)]), np.asarray(qr.rho),
            np.asarray(qr.b * qr.mob), np.asarray(qr.rs), np.asarray(qr.rv)]
    B = 2
    tans = [rng.standard_normal((B,) + a.shape) * np.abs(a).mean()
            for a in prim]

    def ref_div(p3, rho, bmob, rs, rv):
        q = qr._replace(pw=p3[0], po=p3[1], pg=p3[2], rho=rho, b=bmob,
                        mob=jnp.ones_like(bmob), rs=rs, rv=rv)
        return rm.divergence(rm.face_fluxes(q))

    pt = mb.tpfa_div_tangent_plain(
        pm.dims, *(torch.as_tensor(a) for a in prim), pm.depth, pm.trans,
        pm.gravity, *(torch.as_tensor(t) for t in tans)).numpy()
    for b in range(B):
        _, jt = jax.jvp(ref_div, tuple(jnp.asarray(a) for a in prim),
                        tuple(jnp.asarray(t[b]) for t in tans))
        _scaled_close(pt[b], jt)
    assert pt.shape == (B, 3, nc)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_residual_and_convergence(ref_run, port, k):
    rsim, wd_r, _ = ref_run
    psim, wd_p = port
    rm, pm = rsim.model, psim.model
    s_prev, s, dt, ps_prev, ps = _states(ref_run, k)
    cdp_r = rsim.solver._cdp(s_prev, wd_r)
    cdp_p = connection_offsets(pm, ps_prev, wd_p)
    _rel_close(cdp_p.numpy(), cdp_r)
    acc0_r, acc0_p = rm.accumulation(s_prev), pm.accumulation(ps_prev)
    _rel_close(acc0_p.numpy(), acc0_r)
    rr = rm.residual(s, acc0_r, jnp.asarray(dt), wd_r, cdp_r)
    rp = pm.residual(ps, acc0_p, dt, wd_p, cdp_p)
    for f in ("cell", "well_flux", "well_ctrl", "b"):
        _scaled_close(getattr(rp, f).numpy(), getattr(rr, f))
    cr = rm.convergence(rr, jnp.asarray(dt), s)
    cp = pm.convergence(rp, dt, ps)
    for f in ("mb", "cnv", "well_flux", "well_ctrl"):
        _rel_close(cp[f].numpy(), cr[f])
    for f in ("converged", "finite"):
        assert bool(cp[f]) == bool(cr[f])


def test_update_state(ref_run, port):
    rsim, psim = ref_run[0], port[0]
    rm, pm = rsim.model, psim.model
    _, s, _, _, ps = _states(ref_run, 1)
    rng = np.random.default_rng(2)
    nc, nw = pm.nc, ps.bhp.shape[0]
    # large enough to trip every chop and switch
    du = np.concatenate([rng.standard_normal(nc) * 5e6,
                         rng.standard_normal(nc) * 0.3,
                         np.where(np.asarray(s.hcstate) == 1,
                                  rng.standard_normal(nc) * 30.0,
                                  rng.standard_normal(nc) * 0.3),
                         rng.standard_normal(nw) * 1e6,
                         rng.standard_normal(3 * nw) * 1e-3])
    sr = _np_state(ref_update(rm, s, jnp.asarray(du)))
    sp = state_to_numpy(update_state(pm, ps, torch.as_tensor(du)))
    assert np.array_equal(sp["hcstate"], sr["hcstate"])
    assert len(set(sr["hcstate"])) > 1
    for f in ("pressure", "sw", "x", "bhp", "qs"):
        _rel_close(sp[f], sr[f], 1e-14)


def test_update_plain_with_omega_matches_reference(ref_run, port):
    """K9's update twins composed (``update_plain``: update_pressure_plain,
    K1's rs_sat, update_cells_plain, the well rows) from the CPR route's
    call form ((3, nc) cell increments, (nw, 4) well increments and omega
    applied inside), and ``update_state``'s dense call form (a flat
    increment and omega), against the reference's update_state on omega *
    du: hcstate exact, 1e-14 relative."""
    rsim, psim = ref_run[0], port[0]
    rm, pm = rsim.model, psim.model
    _, s, _, _, ps = _states(ref_run, 1)
    rng = np.random.default_rng(5)
    nc, nw = pm.nc, ps.bhp.shape[0]
    du_c = np.stack([rng.standard_normal(nc) * 5e6,
                     rng.standard_normal(nc) * 0.3,
                     np.where(np.asarray(s.hcstate) == 1,
                              rng.standard_normal(nc) * 30.0,
                              rng.standard_normal(nc) * 0.3)])
    du_w = rng.standard_normal((nw, 4)) * np.array([1e-3, 1e-3, 1e-3, 1e6])
    omega = 0.7
    flat = np.concatenate([du_c.reshape(-1), du_w[:, 3],
                           du_w[:, :3].reshape(-1)])
    sr = _np_state(ref_update(rm, s, jnp.asarray(omega * flat)))
    dw = torch.as_tensor(du_w)
    out = k9.update_plain(*k9.update_args(pm, ps, torch.as_tensor(du_c),
                                          dw[:, 3], dw[:, :3], omega))
    plain = dict(zip(("pressure", "sw", "x", "hcstate", "bhp", "qs"),
                     (t.numpy() for t in out)))
    cpr = state_to_numpy(update_state(pm, ps, torch.as_tensor(du_c), omega,
                                      du_w=dw))
    dense = state_to_numpy(update_state(pm, ps, torch.as_tensor(flat),
                                        omega))
    assert len(set(sr["hcstate"])) > 1
    for sp in (plain, cpr, dense):
        assert np.array_equal(sp["hcstate"], sr["hcstate"])
        for f in ("pressure", "sw", "x", "bhp", "qs"):
            _rel_close(sp[f], sr[f], 1e-14)


def test_convergence_row_nan_cell_and_no_wells(ref_run, port):
    """``convergence``'s row (K9's plain version on the CPU) against the
    reference's convergence on a residual with a NaN cell (finite false in
    both, so a diverging substep is chopped) and with the wells dropped
    (nw = 0: both well norms 0); the dict's entries are views of the
    row."""
    rsim, wd_r, _ = ref_run
    psim, wd_p = port
    rm, pm = rsim.model, psim.model
    s_prev, s, dt, ps_prev, ps = _states(ref_run, 0)
    cdp_r = rsim.solver._cdp(s_prev, wd_r)
    cdp_p = connection_offsets(pm, ps_prev, wd_p)
    rr = rm.residual(s, rm.accumulation(s_prev), jnp.asarray(dt), wd_r,
                     cdp_r)
    rp = pm.residual(ps, pm.accumulation(ps_prev), dt, wd_p, cdp_p)
    cell = rp.cell.clone()
    cell[1, 7] = float("nan")
    cases = [
        (rr._replace(cell=rr.cell.at[1, 7].set(jnp.nan)), s,
         rp._replace(cell=cell), ps),
        (rr._replace(well_flux=rr.well_flux[:0], well_ctrl=rr.well_ctrl[:0]),
         s._replace(control=s.control[:0], target=s.target[:0]),
         rp._replace(well_flux=rp.well_flux[:0], well_ctrl=rp.well_ctrl[:0]),
         ps._replace(control=ps.control[:0], target=ps.target[:0]))]
    for k, (r_r, st_r, r_p, st_p) in enumerate(cases):
        cr = rm.convergence(r_r, jnp.asarray(dt), st_r)
        cp = pm.convergence(r_p, dt, st_p)
        for f in ("converged", "finite"):
            assert bool(cp[f]) == bool(cr[f]), (k, f)
        for f in ("mb", "cnv", "well_flux", "well_ctrl"):
            a, b = cp[f].numpy(), np.asarray(cr[f])
            assert np.array_equal(np.isnan(a), np.isnan(b)), (k, f)
            ok = ~np.isnan(b)
            _rel_close(a[ok], b[ok])
        assert cp["row"].shape == (10,)
        assert cp["mb"].data_ptr() == cp["row"].data_ptr()
    nan_case = pm.convergence(cases[0][2], dt, ps)
    assert not bool(nan_case["finite"]) and not bool(nan_case["converged"])
    assert float(cp["well_flux"]) == 0.0 and float(cp["well_ctrl"]) == 0.0


def test_k9_wrappers_reject_bad_arguments(port):
    """K9's card entries check their arguments before any launch: a wrong
    dtype, shape or layout raises ValueError (on the CPU, before the
    library is built)."""
    import types
    pm = port[0].model
    nc = pm.nc
    f64 = dict(dtype=torch.float64)
    p = torch.full((nc,), 2e7, **f64)
    hc = torch.zeros(nc, dtype=torch.int32)
    bhp, qs = torch.zeros(2, **f64), torch.zeros((2, 3), **f64)
    du_c, du_w = torch.zeros((3, nc), **f64), torch.zeros((2, 4), **f64)
    consts, rs = k9.update_consts(pm), k9.rs_table(pm.props, pm.pvtnum)

    def upd(**kw):
        a = dict(p=p, sw=p, x=p, hc=hc, bhp=bhp, qs=qs, du_c=du_c,
                 dbhp=du_w[:, 3], dqs=du_w[:, :3])
        a.update(kw)
        return k9.update_cuda(*a.values(), 0.9, consts, rs)

    for bad in (dict(p=p.float()), dict(hc=hc.long()),
                dict(du_c=du_c[:, :-1]), dict(du_c=du_c.T.contiguous().T),
                dict(qs=qs.T), dict(dqs=du_w[:, :2]),
                dict(dbhp=du_w[:, 3].float())):
        with pytest.raises(ValueError):
            upd(**bad)
    ws = types.SimpleNamespace(nc=nc, device=torch.device("cpu"))
    R = torch.zeros((3, nc), **f64)
    ctrl, tgt = torch.zeros(2, dtype=torch.int32), torch.ones(2, **f64)
    wf, wc = torch.zeros((2, 3), **f64), torch.zeros(2, **f64)
    tols = k9.conv_tols(pm.params)
    good = (R, R, pm.pv, 1.0, wf, wc, ctrl, tgt, tols)
    for k, bad in ((0, R[:, :-1]), (1, R.float()), (2, pm.pv[:-1]),
                   (4, wf[:, :2]), (5, wc[:1]), (6, ctrl.long()),
                   (7, tgt.float())):
        a = list(good)
        a[k] = bad
        with pytest.raises(ValueError):
            k9.convergence_cuda(ws, *a)
    with pytest.raises(ValueError):
        k9.convergence_masked_cuda(ws, R, R, pm.pv, 1.0, pm.pv.float(), wf,
                                   wc, ctrl, tgt, tols)


@pytest.mark.parametrize("k", [0, 2])
def test_dense_jacobian_matches_jax(ref_run, port, k):
    rsim, wd_r, _ = ref_run
    psim, wd_p = port
    rm, pm = rsim.model, psim.model
    s_prev, s, dt, ps_prev, ps = _states(ref_run, k)
    cdp_r = rsim.solver._cdp(s_prev, wd_r)
    acc0_r = rm.accumulation(s_prev)

    @jax.jit
    def ref_jac(u):
        def rfun(v):
            return rm.residual_vector(rm.residual(
                rm.unflatten(v, s), acc0_r, jnp.asarray(dt), wd_r, cdp_r))
        return jax.jacfwd(rfun)(u), rfun(u)

    Jr, r_r = ref_jac(rm.flatten(s))
    acc0_p = pm.accumulation(ps_prev)
    Jp, r_p = psim.solver.jacobian(ps, acc0_p, dt, wd_p,
                                   connection_offsets(pm, ps_prev, wd_p))
    Jr = np.asarray(Jr)
    assert np.abs(Jp.numpy() - Jr).max() <= 1e-10 * np.abs(Jr).max()
    # near convergence r is a small difference of large terms: hold it to
    # the size of the accumulation term (the jitted reference reorders)
    scale = float((pm.pv / dt * acc0_p).abs().max())
    assert np.abs(r_p.numpy() - np.asarray(r_r)).max() <= TOL * scale
    _rel_close(degenerate_x_mask(pm, ps).numpy(), ref_mask(rm, s), 1e-14)
