"""THPRES threshold pressures through K3 (the face flux's clip): the port
(CPU, the kernels' plain versions) against the JAX package.

- the face flux with a per-face threshold, primal and tangent (the K3
  twins' face_flux_from_q and _face_flux_tangent), against JAX's
  face_flux_from_q and jax.jvp through it, on seeded faces with the
  threshold 0, above |dphi| and exactly |dphi| (the tie, where the
  tangent is one half): 1e-13 of each row's max;
- the structured divergence and its tangent entry with a threshold
  (tpfa_div_plain, tpfa_div_tangent_plain) against the JAX model's
  face_fluxes/divergence with the same thresholds;
- the CPR assembly's face blocks, r_cell and diagonal with a nonzero
  threshold (ties included) against JAX's linearize.assemble on a small
  structured deck, and the face-list form on its gather representation;
- tests/test_spe1.py's 8x1x1 deck with THPRES 1 2 defaulted and with
  THPRES 1 2 200 end to end, held to the JAX package's runs
  (data/wellctrl_reference_cpu.json), and the defaulted threshold equal
  to the initial state's pressure jump across the region interface."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opm_tpu.io.eclstate import load_case_string as ref_load
from opm_tpu.models import linearize as rlz
from opm_tpu.models.blackoil import CellQuantities as RefQ
from opm_tpu.models.blackoil import face_flux_from_q as ref_flux
from opm_tpu.models.blackoil import make_well_device_arrays as ref_wd
from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil as RefSim
from opm_tpu_torch.grid.grid import build_grid
from opm_tpu_torch.io.eclstate import load_case_string
from opm_tpu_torch.io.schedule import build_schedule
from opm_tpu_torch.models import blackoil as mb
from opm_tpu_torch.models import linearize as lz
from opm_tpu_torch.models.blackoil import (BlackoilModel,
                                           make_well_device_arrays)
from opm_tpu_torch.props.blackoil import BlackoilProps
from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                        report_step_wells, schedule_wells)
from opm_tpu_torch.sim.testcases import mini_blackoil_deck, wellctrl_decks
from opm_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "data", "wellctrl_reference_cpu.json")) as _f:
    FX = json.load(_f)
G = 9.80665


def seeded_thresholds(dphi, rng, ties=True):
    """(nf,) thresholds for faces with per-phase potentials dphi (3, nf):
    a third 0, a third above every phase's |dphi|, the rest exactly one
    phase's |dphi| (a tie) or, without ties, half the smallest (a partial
    clip)."""
    a = np.abs(dphi)
    nf = a.shape[1]
    kind = rng.integers(0, 3, nf)
    thr = np.where(kind == 1, 1.5 * a.max(axis=0) + 1.0, 0.0)
    tie = (a[rng.integers(0, 3, nf), np.arange(nf)] if ties
           else 0.5 * a.min(axis=0))
    return np.where(kind == 2, tie, thr)


def _faces(rng, nf):
    p3L, p3R = (2e7 + 1e5 * rng.standard_normal((3, nf)) for _ in range(2))
    rhoL, rhoR = (700 + 100 * rng.standard_normal((3, nf)) for _ in range(2))
    bmL, bmR = (np.abs(rng.standard_normal((3, nf))) for _ in range(2))
    rsL, rsR = (50 * np.abs(rng.standard_normal(nf)) for _ in range(2))
    rvL, rvR = (1e-4 * np.abs(rng.standard_normal(nf)) for _ in range(2))
    T = 1e-12 * np.abs(rng.standard_normal(nf))
    dz = 10 * rng.standard_normal(nf)
    # a face in equilibrium (dphi == 0 in every phase)
    p3R[:, 0] = p3L[:, 0]
    rhoR[:, 0] = rhoL[:, 0]
    dz[0] = 0.0
    return p3L, p3R, rhoL, rhoR, bmL, bmR, rsL, rsR, rvL, rvR, T, dz


def _ref_q(p3, rho, bm, rs, rv):
    one = jnp.ones_like(jnp.asarray(rs))
    return RefQ(pw=jnp.asarray(p3[0]), po=jnp.asarray(p3[1]),
                pg=jnp.asarray(p3[2]), b=jnp.asarray(bm),
                mob=jnp.ones_like(jnp.asarray(bm)), rho=jnp.asarray(rho),
                rs=jnp.asarray(rs), rv=jnp.asarray(rv),
                sat=jnp.ones_like(jnp.asarray(bm)), pv_mult=one)


def test_face_flux_with_threshold_matches_jax():
    rng = np.random.default_rng(5)
    nf = 600
    (p3L, p3R, rhoL, rhoR, bmL, bmR, rsL, rsR, rvL, rvR, T,
     dz) = _faces(rng, nf)
    dphi = (p3L - p3R) - 0.5 * (rhoL + rhoR) * G * dz
    thr = seeded_thresholds(dphi, rng)
    assert (np.abs(dphi) == thr[None, :]).any(axis=0).sum() > nf // 5
    t = torch.as_tensor
    args = [t(a) for a in (p3L, p3R, rhoL, rhoR, bmL, bmR, rsL, rsR, rvL,
                           rvR, T, dz)]
    fp = mb.face_flux_from_q(*args, G, t(thr))
    qL = _ref_q(p3L, rhoL, bmL, rsL, rvL)
    qR = _ref_q(p3R, rhoR, bmR, rsR, rvR)
    fr = np.asarray(ref_flux(qL, qR, jnp.asarray(T), jnp.asarray(dz), G,
                             jnp.asarray(thr)))
    np.testing.assert_array_equal(fp.numpy(), fr)
    # tangents: seeded input tangents on both sides, batched
    B = 4
    tans = [rng.standard_normal((B,) + np.shape(a)) for a in
            (p3L, p3R, rhoL, rhoR, bmL, bmR, rsL, rsR, rvL, rvR)]
    tans[2] *= 10.0
    tans[3] *= 10.0
    tp = mb._face_flux_tangent(*args, G, *(t(a) for a in tans),
                               thr=t(thr)).numpy()
    for b in range(B):
        def f(pL, pR, rL, rR, bL, bR, sL, sR, vL, vR):
            return ref_flux(_ref_q(pL, rL, bL, sL, vL),
                            _ref_q(pR, rR, bR, sR, vR), jnp.asarray(T),
                            jnp.asarray(dz), G, jnp.asarray(thr))
        prim = [jnp.asarray(a) for a in (p3L, p3R, rhoL, rhoR, bmL, bmR,
                                         rsL, rsR, rvL, rvR)]
        _, tr = jax.jvp(f, tuple(prim),
                        tuple(jnp.asarray(a[b]) for a in tans))
        tr = np.asarray(tr)
        scale = np.maximum(np.abs(tr).max(axis=1, keepdims=True), 1e-300)
        assert float((np.abs(tp[b] - tr) / scale).max()) <= 1e-13
    # the tie's half slope, the equilibrium face's 0, inside 0
    single = [a[:1] for a in args[:10]]
    for th, want in ((abs(float(dphi[1, 5])), 0.5), (0.0, 1.0),
                     (2 * abs(float(dphi[1, 5])), 0.0)):
        one = [a[..., 5:6] for a in args[:12]]
        d = [torch.zeros_like(a) for a in one[:10]]
        d[0] = torch.ones_like(one[0])
        tan = mb._face_flux_tangent(*one, G, *d, thr=t([th]))
        clip = mb._face_flux_tangent(*one, G, *d)
        assert float(tan[0, 0]) == pytest.approx(want * float(clip[0, 0]),
                                                 rel=1e-15)
    assert single


def _mini(nx, ny, nz, rng, gather=False):
    """A small structured mini deck in both packages at a seeded state
    (pressure perturbed), with seeded thresholds from the JAX model's
    face potentials: with ties, and without them (for a comparison with
    the compiled reference, whose fused arithmetic may move |dphi| by an
    ulp off a tie)."""
    text = mini_blackoil_deck(nx, ny, nz, tsteps="1")
    if gather:
        # an inactive cell: a gather grid with OPM_TPU_EMBED=0
        n = nx * ny * nz
        text = text.replace("GRID\n", f"GRID\nACTNUM\n {n // 2}*1 0 "
                            f"{n - n // 2 - 1}*1 /\n", 1)
        os.environ["OPM_TPU_EMBED"] = "0"
    r = RefSim(ref_load(text), fused=False)
    # the port's model and wells (on a small gather grid the simulator
    # would take the dense route, which needs Queue 1 item 9)
    case = load_case_string(text)
    p = types.SimpleNamespace(grid=build_grid(case),
                              schedule=build_schedule(case))
    os.environ.pop("OPM_TPU_EMBED", None)
    p.props = BlackoilProps.from_case(case, "cpu")
    p.model = BlackoilModel(p.grid, p.props, device="cpu")
    p.well_names, p.max_perf = schedule_wells(p.schedule)
    from opm_tpu.sim.init import initial_state as rinit
    s0 = rinit(r.grid, r.props, r.case, len(r.well_names))
    s0 = s0._replace(pressure=s0.pressure + jnp.asarray(
        2e4 * rng.standard_normal(r.model.nc)))
    step = r.schedule.report_steps[0]
    ws = r._pad_well_set(r._well_set_for(step))
    s0 = r._init_well_state(s0, ws, True)
    q = r.model.cell_quantities(s0)
    fc = np.asarray(r.grid.face_cells)
    p3 = np.stack([np.asarray(q.pw), np.asarray(q.po), np.asarray(q.pg)])
    rho = np.asarray(q.rho)
    dep = np.asarray(r.model.depth)
    dz = dep[fc[:, 0]] - dep[fc[:, 1]]
    dphi = (p3[:, fc[:, 0]] - p3[:, fc[:, 1]]) \
        - 0.5 * (rho[:, fc[:, 0]] + rho[:, fc[:, 1]]) * r.grid.gravity * dz
    thr = (seeded_thresholds(dphi, rng), seeded_thresholds(dphi, rng, False))
    wsp = report_step_wells(p.schedule.report_steps[0], p.grid, p.well_names,
                            p.max_perf)
    sp = state_from_numpy({f: (None if getattr(s0, f) is None
                               else np.asarray(getattr(s0, f)))
                           for f in s0._fields}, "cpu")
    return r, p, s0, sp, ref_wd(ws, r.grid.gravity), \
        make_well_device_arrays(wsp, p.grid.gravity, "cpu"), thr


@pytest.fixture(scope="module")
def minis():
    """The small deck in both packages, stencil and face-list forms, made
    once for the module's tests."""
    return {g: _mini(6, 5, 3, np.random.default_rng(17), g)
            for g in (False, True)}


def test_tpfa_div_and_tangent_with_threshold_match_jax(minis):
    """The structured divergence with the thresholds (ties included) and
    its tangent entry against the JAX model's face_fluxes/divergence and
    jax.jvp of them in the face inputs, on the mini deck's cell
    quantities with seeded input tangents."""
    rng = np.random.default_rng(11)
    r, p, s0, sp, _, _, (thr, _) = minis[False]
    q = r.model.cell_quantities(s0)
    div_r = np.asarray(r.model.divergence(r.model.face_fluxes(
        q, jnp.asarray(thr))))
    qp = p.model.cell_quantities(sp)
    div_p = p.model.flux_divergence(qp, torch.as_tensor(thr))
    np.testing.assert_allclose(div_p.numpy(), div_r, rtol=1e-13,
                               atol=1e-13 * np.abs(div_r).max())
    # tangents of the face inputs (p3, rho, b mob with mob 1, rs, rv)
    one = jnp.ones_like(q.mob)
    qr = q._replace(b=q.b * q.mob, mob=one)
    nc = r.model.nc
    dp3, drho, dbm = (rng.standard_normal((3, nc)) * s for s in
                      (1e4, 1.0, 1e-3))
    drs, drv = rng.standard_normal(nc), 1e-6 * rng.standard_normal(nc)
    dq = jax.tree.map(jnp.zeros_like, qr)._replace(
        pw=jnp.asarray(dp3[0]), po=jnp.asarray(dp3[1]),
        pg=jnp.asarray(dp3[2]), rho=jnp.asarray(drho), b=jnp.asarray(dbm),
        rs=jnp.asarray(drs), rv=jnp.asarray(drv))
    _, tr = jax.jvp(lambda x: r.model.divergence(r.model.face_fluxes(
        x, jnp.asarray(thr))), (qr,), (dq,))
    t = torch.as_tensor
    p3 = torch.stack([qp.pw, qp.po, qp.pg])
    tp = mb.tpfa_div_tangent_plain(
        p.model.dims, p3, qp.rho, qp.b * qp.mob, qp.rs, qp.rv,
        p.model.depth, p.model.trans_stencil, p.model.gravity,
        t(dp3)[None], t(drho)[None], t(dbm)[None], t(drs)[None],
        t(drv)[None], thr=t(thr))[0]
    tr = np.asarray(tr)
    assert float(np.abs(tp.numpy() - tr).max()) <= 1e-12 * np.abs(tr).max()


@pytest.mark.parametrize("gather", [False, True], ids=["stencil", "list"])
def test_assembly_face_blocks_with_threshold_match_jax(minis, gather):
    """The CPR route's assembly (K3's face blocks through the threshold's
    clip) against JAX's linearize on the same state: r_cell, the block
    diagonal and face_L / face_R, 1e-12 of each row's max."""
    r, p, s0, sp, wdr, wdp, (_, thr) = minis[gather]
    assert p.model.structured != gather
    r.model.threshold_dp = jnp.asarray(thr)
    p.model.threshold_dp = torch.as_tensor(thr)
    dt = 86400.0
    acc0r = r.model.accumulation(s0) * 0.999
    acc0p = torch.as_tensor(np.asarray(acc0r))
    cdpr = r.solver._cdp(s0, wdr)
    cdpp = torch.as_tensor(np.asarray(cdpr))
    sr = jax.jit(lambda st, a, c: rlz.assemble(r.model, st, a, dt, wdr, c))(
        s0, acc0r, cdpr)
    sp_ = lz.assemble(p.model, sp, acc0p, dt, wdp, cdpp)

    def rows(x):
        return np.stack([np.asarray(a) for a in x]) if isinstance(
            x, tuple) else np.asarray(x)

    for name in ("r_cell", "diag", "face_L", "face_R"):
        a = getattr(sp_, name).numpy()
        b = rows(getattr(sr, name))
        scale = np.maximum(np.abs(b).max(axis=1, keepdims=True), 1e-300)
        assert float((np.abs(a - b) / scale).max()) <= 1e-12, name
    # some faces inside the threshold (blocks 0) and on the tie
    assert (thr > 0).any() and (thr == 0).any()


@pytest.fixture(scope="module")
def thpres_runs():
    """The two 8x1x1 decks run in the port, with their initial states."""
    from opm_tpu_torch.sim.init import initial_state
    out = {}
    for name in ("thpres_default", "thpres_explicit"):
        text, limit = wellctrl_decks()[name]
        sim = SimulatorFullyImplicitBlackoil(load_case_string(text),
                                             device="cpu")
        state0 = initial_state(sim.grid, sim.props, sim.case,
                               len(sim.well_names))
        sim.run(state0, report_step_limit=limit)
        out[name] = (sim, state0)
    return out


@pytest.mark.parametrize("name", ["thpres_default", "thpres_explicit"])
def test_thpres_decks_end_to_end(thpres_runs, name):
    """The 8x1x1 decks: the port's run against the JAX package's, the
    thresholds equal, counts equal to the op-by-op run's, the summary
    within the parity limits of the compiled run too."""
    sim = thpres_runs[name][0]
    fx = FX["runs"][name]
    thr = sim.model.threshold_dp.numpy()
    assert sorted({float(v) for v in thr[thr > 0]}) == \
        pytest.approx(fx["eager"]["thresholds"], rel=1e-12)
    eager, jit = fx["eager"]["report_steps"], fx["jit"]["report_steps"]
    assert [list(s[3:5]) for s in sim._step_timing] == \
        [[r["substeps"], r["newtons"]] for r in eager]
    for row, e, j in zip(sim.summary.rows, eager, jit):
        assert row["FPR"] == pytest.approx(e["FPR"], rel=1e-9)
        assert row["FPR"] == pytest.approx(j["FPR"], rel=1e-4)


def test_thpres_defaulted_compute_max_dp(thpres_runs):
    """Defaulted THPRES values come from the equilibrated initial state
    (computeMaxDp): the threshold equals the largest initial pressure jump
    across the region interface (tests/test_spe1.py's expected value)."""
    sim, state = thpres_runs["thpres_default"]
    assert sim.case.solution.thpres == [(1, 2, None)]
    thp = sim.model.threshold_dp.numpy()
    fc = sim.grid.face_cells
    eql = np.asarray(sim.grid.eqlnum)
    iface = eql[fc[:, 0]] != eql[fc[:, 1]]
    assert iface.sum() == 1
    p0 = state.pressure.numpy()
    dp_iface = abs(p0[fc[iface, 0]] - p0[fc[iface, 1]])[0]
    assert dp_iface > 1e6
    assert thp[iface][0] == pytest.approx(dp_iface, rel=1e-12)
    assert np.all(thp[~iface] == 0.0)
    assert thp[iface][0] == pytest.approx(
        FX["runs"]["thpres_default"]["jit"]["thresholds"][0], rel=1e-12)
