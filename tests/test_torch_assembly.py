"""The CPR route's assembly pieces that run as hand kernels on the card
(K2, the K3 face blocks, K5), through their plain twins on the CPU, against
the JAX package:

- K2's twin (``cell_quantities_tangents_plain``): the cell quantities and
  the accumulation with their three tangent columns against the
  reference's ``jax.linearize`` seeded with all-ones per primary, on SPE1
  and the toy SPE10-like deck, at seeded states in all three hydrocarbon
  states plus the kinks: a cell on a PVTO node, saturated cells with
  p == p_bub(rs_sat(p)) (a tie of max(p - p_bub, 0)), saturations at and
  beyond both ends of the clamped SWOF/SGOF tables, sw at connate water;
- the assembled system (K2's assembly entry, the K3 face blocks, the
  wells) against the reference's ``assemble`` on the toy SPE10-like deck,
  field by field, and K5's twin (the reduced operator, its right-hand side
  and the well recovery) against the reference's
  ``schur_eliminate_wells``, and the plain composition the card's fused
  reduced operator is held to (``reduced_matvec_plain`` over the prepared
  well arguments ``WellTerm``, which raise on mismatched well arrays);
  on the toy Norne-like deck in both
  representations (the face-list form of the face blocks: an embedded
  grid's extra faces, a gather grid's every face) the same comparisons
  are ``tests/test_torch_faces.py``'s ``test_assembly_matches_reference``
  and ``test_schur_matches_reference``, which run through these twins;
- the forward-mode and vmap rules of K2's autograd Function against the
  plain formula, and SPE1's dense Jacobian through them against
  ``jax.jacfwd``.

Tolerances: values 1e-13 relative (the same operations in the same
order); tangent columns 1e-12 of each field's max (jvp and
``jax.linearize`` order some sums differently); assembled fields 1e-11 of
each field's max and the Schur pieces 1e-12 of max (summation order, as
``tests/test_torch_cpr.py``); the dense Jacobian 1e-10 of max|J| (as
``tests/test_torch_residual.py``). The Function's rules reproduce the plain
formula's jvp bit for bit at basis seeds, and to 1e-12 of each field's max
at random tangents."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opm_tpu.io.eclstate import load_case as ref_load_case
from opm_tpu.models import linearize as rlin
from opm_tpu.models.blackoil import accumulation_from_q as ref_acc
from opm_tpu.models.blackoil import compute_cell_quantities as ref_ccq
from opm_tpu.models.blackoil import make_well_device_arrays as ref_wd
from opm_tpu.models.state import BlackoilState as RefState
from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil as RefSim
from opm_tpu.sim.testcases import spe10like_case as ref_spe10like_case
from opm_tpu_torch.io.eclstate import load_case
from opm_tpu_torch.linalg.precond import inv4x4
from opm_tpu_torch.models import blackoil as mb
from opm_tpu_torch.models import linearize
from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                        init_well_state, report_step_wells)
from opm_tpu_torch.sim.init import initial_state
from opm_tpu_torch.sim.testcases import spe10like_case
from opm_tpu_torch.solver.newton import connection_offsets
from opm_tpu_torch.utils.convert import state_to_numpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE1 = os.path.join(ROOT, "data", "SPE1CASE2.DATA")
SPE10_TOY = dict(nx=15, ny=44, nz=4, tsteps="3*1")
DT = 86400.0


def _rel_close(a, b, tol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b)
    bad = err > tol * np.abs(b)
    assert not bad.any(), \
        f"max rel {np.max(err / np.maximum(np.abs(b), 1e-300)):.3e}"


def _scaled_close(a, b, tol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    scale = max(np.abs(b).max() if b.size else 0.0, 1e-300)
    assert err <= tol * scale, f"{err / scale:.3e} of max"


def _ref_state(snp):
    return RefState(**{k: (None if snp.get(k) is None
                           else jnp.asarray(snp[k]))
                       for k in RefState._fields})


# ---------------------------------------------------------------------------
# K2: cell quantities and their tangent columns

def _kink_cells(props, nc, seed):
    """Primaries in all three hydrocarbon states, the first cells placed on
    the tables' kinks (PVTO nodes, p == p_bub(rs_sat(p)), the ends of the
    clamped saturation tables, connate water)."""
    rng = np.random.default_rng(seed)
    hc = rng.integers(0, 3, nc).astype(np.int32)
    p = rng.uniform(1.5e7, 4.0e7, nc)
    sw = rng.uniform(0.15, 0.7, nc)
    x = np.where(hc == 0, rng.uniform(0.0, 0.25, nc),
                 np.where(hc == 1, rng.uniform(20.0, 120.0, nc),
                          rng.uniform(0.0, 1e-4, nc)))
    lo = props.oil_live
    sf = props.satfunc
    rs_nodes = lo.rs_tab[0].numpy()
    pb_nodes = lo.pbub_tab[0].numpy()
    sw_nodes = sf.sw[0].numpy()
    sg_nodes = sf.sg[0].numpy()
    n = len(rs_nodes)

    def node(i):
        return i % n

    kinks = [
        # undersaturated on a PVTO node, above its bubble point
        (1, pb_nodes[node(3)] + 2.0e6, 0.3, rs_nodes[node(3)]),
        # undersaturated exactly at its bubble point (dp = 0)
        (1, pb_nodes[node(4)], 0.3, rs_nodes[node(4)]),
        # saturated at a node pressure: p == p_bub(rs_sat(p))
        (0, pb_nodes[node(2)], 0.3, 0.1),
        (0, pb_nodes[node(5)], 0.25, 0.0),
        (2, pb_nodes[node(3)], 0.3, 0.0),
        # the ends of the clamped tables and beyond
        (0, 2.0e7, sw_nodes[0], sg_nodes[-1]),
        (0, 2.0e7, sw_nodes[-1], 0.0),
        (1, 3.0e7, sw_nodes[0] - 0.05, 60.0),
        (0, 2.0e7, 0.3, sg_nodes[0]),
        (2, 2.0e7, sw_nodes[-1] + 0.1, 0.0),
        # connate water: max(sw - swco, 0) at its tie
        (0, 2.5e7, float(sf.swco[0]), 0.2),
    ]
    for i, (h, pp, s, xx) in enumerate(kinks):
        hc[i], p[i], sw[i], x[i] = h, pp, s, xx
    return dict(pressure=p, sw=sw, x=x, hcstate=hc)


@pytest.fixture(scope="module")
def spe1():
    port = SimulatorFullyImplicitBlackoil(load_case(SPE1), device="cpu")
    ref = RefSim(ref_load_case(SPE1), fused=False)
    return port, ref


@pytest.fixture(scope="module")
def spe10():
    """The toy SPE10-like deck: the port, the reference, and the
    reference's assembled first Newton system with its Schur pieces."""
    port = SimulatorFullyImplicitBlackoil(spe10like_case(**SPE10_TOY),
                                          device="cpu")
    ref = RefSim(ref_spe10like_case(**SPE10_TOY), fused=False)
    return _system(port, ref, seed=0)


def _system(port, ref, seed):
    """The first report step's wells, the initial state with its pressure
    perturbed by seeded noise (both upwind directions on every kind of
    face), and the reference's assembly and Schur pieces at it."""
    step = port.schedule.report_steps[0]
    ws = report_step_wells(step, port.grid, port.well_names, port.max_perf)
    wd_p = mb.make_well_device_arrays(ws, port.grid.gravity, "cpu")
    ws_r = ref._pad_well_set(ref._well_set_for(ref.schedule.report_steps[0]))
    wd_r = ref_wd(ws_r, ref.grid.gravity)
    st = init_well_state(initial_state(port.grid, port.props, port.case,
                                       ws.nw), ws, True)
    acc0 = port.model.accumulation(st)
    rng = np.random.default_rng(seed)
    st = st._replace(pressure=st.pressure + torch.as_tensor(
        rng.standard_normal(port.model.nc) * 2.0e4))
    cdp = connection_offsets(port.model, st, wd_p)
    v = rng.standard_normal((3, port.model.nc))
    dims = port.model.op_dims

    def ref_all(state, acc0, cdp, v):
        sys = rlin.assemble(ref.model, state, acc0, jnp.asarray(DT), wd_r,
                            cdp)
        mv, rhs, rec = rlin.schur_eliminate_wells(sys, dims=dims)
        return dict(sys=sys, rhs=rhs, mv=mv(v), rec=rec(v))

    out = jax.jit(ref_all)(_ref_state(state_to_numpy(st)),
                           jnp.asarray(acc0.numpy()),
                           jnp.asarray(cdp.numpy()), jnp.asarray(v))
    return dict(port=port, ref=ref, state=st, acc0=acc0, wd=wd_p, cdp=cdp,
                v=torch.from_numpy(v),
                out=jax.tree.map(np.asarray, out))


def _k2_against_linearize(port_model, ref_model, d):
    props = port_model.props
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    args = (t["pressure"], t["sw"], t["x"], t["hcstate"], port_model.pvtnum,
            port_model.satnum)
    q, q_tan, acc, acc_tan = mb.cell_quantities_tangents_plain(props, *args)

    # op by op, as the port's twin: under jit XLA contracts the lookups'
    # products into fused multiply-adds, and the ties at the kinks (p ==
    # p_bub(rs_sat(p)) exactly) then fall an ulp to either side
    def ref_columns(p, sw, x, hc):
        def q_all(p, sw, x):
            qr = ref_ccq(ref_model.props, p, sw, x, hc, ref_model.pvtnum,
                         ref_model.satnum)
            return qr, ref_acc(qr)

        val, lin = jax.linearize(q_all, p, sw, x)
        ones, zeros = jnp.ones_like(p), jnp.zeros_like(p)
        return val, [lin(ones, zeros, zeros), lin(zeros, ones, zeros),
                     lin(zeros, zeros, ones)]

    (qr, accr), tans = ref_columns(*(jnp.asarray(d[k]) for k in
                                     ("pressure", "sw", "x", "hcstate")))
    for f in qr._fields:
        shape = getattr(q, f).shape
        _rel_close(getattr(q, f).numpy(),
                   np.broadcast_to(getattr(qr, f), shape), 1e-13)
    _rel_close(acc.numpy(), accr, 1e-13)
    for j, (qt_r, acct_r) in enumerate(tans):
        for f in qr._fields:
            shape = getattr(q, f).shape
            _scaled_close(getattr(q_tan[j], f).numpy(),
                          np.broadcast_to(getattr(qt_r, f), shape), 1e-12)
        _scaled_close(acc_tan[j].numpy(), acct_r, 1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_k2_twin_matches_linearize_spe1(spe1, seed):
    port, ref = spe1
    d = _kink_cells(port.props, port.model.nc, seed)
    assert set(d["hcstate"]) == {0, 1, 2}
    _k2_against_linearize(port.model, ref.model, d)


def test_k2_twin_matches_linearize_spe10(spe10):
    port, ref = spe10["port"], spe10["ref"]
    d = _kink_cells(port.props, port.model.nc, 2)
    _k2_against_linearize(port.model, ref.model, d)


def test_k2_function_rules_reproduce_the_formula(spe1):
    """The forward-mode rule (K2's columns contracted with the input
    tangents) gives the plain formula's own jvp: bit for bit at basis
    seeds (what jacfwd and the perforation rows use), to 1e-12 of each
    field's max at random tangents (the contraction sums the three
    columns, the formula's jvp carries their combination through each
    operation); the vmap rule (a batch of primaries folded into the cell
    axis) gives each state's values bit for bit."""
    port = spe1[0]
    m = port.model
    d = _kink_cells(m.props, m.nc, 3)
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    rng = np.random.default_rng(4)

    def through_k2(p, sw, x):
        return tuple(mb.compute_cell_quantities(m.props, p, sw, x,
                                                t["hcstate"], m.pvtnum,
                                                m.satnum))

    def plain(p, sw, x):
        return tuple(mb.cell_quantities_plain(m.props, p, sw, x,
                                              t["hcstate"], m.pvtnum,
                                              m.satnum))

    prim = (t["pressure"], t["sw"], t["x"])
    zeros = torch.zeros(m.nc, dtype=torch.float64)
    for j in range(3):
        seed = [zeros] * 3
        seed[j] = torch.ones(m.nc, dtype=torch.float64)
        v1, j1 = torch.func.jvp(through_k2, prim, tuple(seed))
        v2, j2 = torch.func.jvp(plain, prim, tuple(seed))
        for a, b in zip(v1 + j1, v2 + j2):
            assert torch.equal(a, b)
    tans = tuple(torch.as_tensor(rng.standard_normal(m.nc)) * s
                 for s in (1e5, 0.01, 1.0))
    _, j1 = torch.func.jvp(through_k2, prim, tans)
    _, j2 = torch.func.jvp(plain, prim, tans)
    for a, b in zip(j1, j2):
        _scaled_close(a.numpy(), b.numpy(), 1e-12)
    # a batch of states (perturbed pressures) through the vmap rule
    P = t["pressure"][None] * torch.as_tensor([[1.0], [1.01], [0.97]])
    vb = torch.func.vmap(lambda p: through_k2(p, t["sw"], t["x"]))(P)
    for k in range(3):
        one = plain(P[k], t["sw"], t["x"])
        for a, b in zip(vb, one):
            assert torch.equal(a[k], b)


def test_spe1_dense_jacobian_through_k2(spe1):
    """torch.func.jacfwd of the residual (K2's and K3's forward-mode rules)
    at SPE1's initial state after the well initialisation, against
    jax.jacfwd of the reference's residual; finite everywhere."""
    port, ref = spe1
    pm, rm = port.model, ref.model
    step = port.schedule.report_steps[0]
    ws = report_step_wells(step, port.grid, port.well_names, port.max_perf)
    wd_p = mb.make_well_device_arrays(ws, port.grid.gravity, "cpu")
    ws_r = ref._pad_well_set(ref._well_set_for(ref.schedule.report_steps[0]))
    wd_r = ref_wd(ws_r, ref.grid.gravity)
    st = init_well_state(initial_state(port.grid, port.props, port.case,
                                       ws.nw), ws, True)
    acc0 = pm.accumulation(st)
    cdp = connection_offsets(pm, st, wd_p)
    Jp, _ = port.solver.jacobian(st, acc0, DT, wd_p, cdp)
    s_r = _ref_state(state_to_numpy(st))
    acc0_r = jnp.asarray(acc0.numpy())
    cdp_r = jnp.asarray(cdp.numpy())

    @jax.jit
    def ref_jac(u):
        def rfun(v):
            return rm.residual_vector(rm.residual(
                rm.unflatten(v, s_r), acc0_r, jnp.asarray(DT), wd_r, cdp_r))
        return jax.jacfwd(rfun)(u)

    Jr = np.asarray(ref_jac(rm.flatten(s_r)))
    assert bool(torch.isfinite(Jp).all())
    _scaled_close(Jp.numpy(), Jr, 1e-10)


# ---------------------------------------------------------------------------
# the assembled system (K2 assembly, K3 face blocks, wells) and K5

FIELDS = ["r_cell", "r_well", "diag", "face_L", "face_R", "cw", "wc",
          "wd_diag"]


def _assembly_matches(sysd, field):
    port = sysd["port"]
    sys = linearize.assemble(port.model, sysd["state"], sysd["acc0"], DT,
                             sysd["wd"], sysd["cdp"])
    r = getattr(sysd["out"]["sys"], field)
    if isinstance(r, tuple):
        r = np.stack(r)
    _scaled_close(getattr(sys, field).numpy(), r, 1e-11)
    return sys


@pytest.mark.parametrize("field", FIELDS)
def test_spe10_assembly_matches_reference(spe10, field):
    _assembly_matches(spe10, field)


def test_spe10_schur_matches_reference(spe10):
    port = spe10["port"]
    sys = linearize.assemble(port.model, spe10["state"], spe10["acc0"], DT,
                             spe10["wd"], spe10["cdp"])
    mv, rhs, rec = linearize.schur_eliminate_wells(sys, port.model.op_dims)
    out = spe10["out"]
    _scaled_close(rhs.numpy(), out["rhs"], 1e-12)
    _scaled_close(mv(spe10["v"]).numpy(), out["mv"], 1e-12)
    _scaled_close(rec(spe10["v"]).numpy(), out["rec"], 1e-12)


def _port_system(sysd):
    port = sysd["port"]
    return linearize.assemble(port.model, sysd["state"], sysd["acc0"], DT,
                              sysd["wd"], sysd["cdp"])


def test_spe10_fused_composition_matches_reference(spe10):
    """What the card's fused reduced operator is held to, the cell
    operator's twins and then the well term (reduced_matvec_plain), over
    the prepared well arguments (WellTerm, checked once, on CPU tensors),
    against the reference's schur_eliminate_wells operator and right-hand
    side (1e-12 of max); schur_eliminate_wells' CPU path gives the same
    bits."""
    sys = _port_system(spe10)
    Dinv = inv4x4(sys.wd_diag).contiguous()
    wt = linearize.WellTerm(sys, Dinv)
    assert wt.arg is not None and wt.wf.numel() == 3 * sys.perf_cell.numel()
    # the run of each perforated cell in perforation order: its length at
    # its first position (the padded perforations share cell 0)
    cells = sys.perf_cell.reshape(-1)[sys.perf_order].tolist()
    runs = [0] * len(cells)
    for i, c in enumerate(cells):
        if i == 0 or cells[i - 1] != c:
            runs[i] = cells[i:].count(c)
    assert wt.run_len.tolist() == runs
    dims = spe10["port"].model.op_dims
    y = linearize.reduced_matvec_plain(wt.sys, wt.Dinv, spe10["v"], dims)
    _scaled_close(y.numpy(), spe10["out"]["mv"], 1e-12)
    _scaled_close(linearize.schur_rhs_plain(wt.sys, wt.Dinv).numpy(),
                  spe10["out"]["rhs"], 1e-12)
    mv, _, _ = linearize.schur_eliminate_wells(sys, dims)
    assert torch.equal(mv(spe10["v"]), y)


@pytest.mark.parametrize("bad", ["wc_shape", "dinv_shape", "perf_order",
                                 "r_cell_dtype"])
def test_well_term_rejects_mismatched_arrays(spe10, bad):
    """The prepared well arguments raise on a system whose well arrays do
    not match it (checked once per Newton system, not per call)."""
    sys = _port_system(spe10)
    Dinv = inv4x4(sys.wd_diag).contiguous()
    if bad == "wc_shape":
        sys = sys._replace(wc=sys.wc[:, :-1].contiguous())
    elif bad == "dinv_shape":
        Dinv = Dinv[:-1].contiguous()
    elif bad == "perf_order":
        sys = sys._replace(perf_order=sys.perf_order[:-1].contiguous())
    else:
        sys = sys._replace(r_cell=sys.r_cell.to(torch.float32))
    with pytest.raises(ValueError, match="K5"):
        linearize.WellTerm(sys, Dinv)
    if bad != "dinv_shape":
        with pytest.raises(ValueError, match="K5"):
            linearize.schur_eliminate_wells(sys,
                                            spe10["port"].model.op_dims)


def test_well_term_without_dinv_waits_for_the_rhs(spe10):
    """A WellTerm made without D^-1 (the card's main path, where K5's
    right-hand-side launch forms it) holds a (nw, 4, 4) buffer and checks
    the well blocks it is formed from; every other K5 entry raises before
    the right-hand side has run (checked before any launch, so on CPU
    tensors too)."""
    sys = _port_system(spe10)
    wt = linearize.WellTerm(sys)
    assert wt.arg is not None and not wt.formed
    assert tuple(wt.Dinv.shape) == tuple(sys.wd_diag.shape)
    v = torch.zeros((3, sys.nc), dtype=torch.float64)
    dims = spe10["port"].model.op_dims
    for call in (lambda: linearize.schur_matvec_cuda(wt, v, v.clone()),
                 lambda: linearize.schur_recover_cuda(wt, v),
                 lambda: linearize.reduced_matvec_cuda(wt, v, dims)):
        with pytest.raises(ValueError, match="right-hand side"):
            call()
    with pytest.raises(ValueError, match="K5"):
        linearize.WellTerm(sys._replace(
            wd_diag=sys.wd_diag[:, :3].contiguous()))
    assert linearize.WellTerm(sys, wt.Dinv).formed
