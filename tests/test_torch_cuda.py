"""The port's kernels on the card, where chip_smoke.py does not reach:
K1 with per-query region rows (nreg > 1; SPE1 has one region), the dense
Jacobian through the kernels against the plain CPU path as a test of its
own, a CPR solve through the kernels against their twins and one with
only the V-cycle through K7, BiCGStab with no preconditioner through K8
against its twins, K8's steps at an odd length and at the toy SPE10-like
deck's, K7's two V-cycle legs on seeded stencils (a padded level, a
padded level 0) and its value refresh (one launch into the hierarchy's
buffers, bit for bit the per-level composition), the face-list kernels
(K4-faces' pack included) and K10
(its legs, and the coarsest sweeps of a hierarchy cut short) against
their twins on the toy Norne-like deck, the
assembly kernels (K2, the K3 face blocks in both forms, K5) against their
twins on the toy Norne-like deck in both representations, K2's three
entries at kink cells with one and two PVT/SAT regions, the
Schur-reduced operator with K5's well term fused into the cell operator's
last launch on structured, embedded and gather grids, D^-1 formed in K5's
right-hand-side launch bit for bit the plain inv4x4 (a rank-deficient
well block included), K9's update entry
bit for bit against its twins' composition (all three hydrocarbon states,
switching cells, one and two PVT regions, both call forms), K9's
convergence row against its plain version (masked and unmasked, a NaN
cell, no wells, ten launches in a row), and the V-cycle from the CPR
apply's weighted residual (K6's pressure_rhs folded into the down leg)
bit for bit the plain residual followed by the legs on all three grid
kinds, and K1's EQUIL column march bit for bit its twin on SPE1, SPE1
with PBVD, SPE1CASE2_2P and the toy SPE10-like deck (no host read in its
call, one march and at most 7 K1 lookups a region in initial_state, the
state bit for bit the one through the twin), EQUIL's cell pass bit for
bit its twin on those decks, the toy Norne-like deck and SPE9 (into
arrays of NaN, no host read in its call; initial_state one march and one
cell pass a region and no K1 lookup), the face-list face blocks' packed
copy for K4-faces (written into NaN) bit for bit the pack's twin, and
K2's three entries and K9's update with SPE3's wet gas (PVTG, VAPOIL)
against their twins, EQUIL's kernels on SPE3 with RVVD and with PDVD,
K3's tangent entry
bit for bit its twin in both launch geometries (SPE1's jacfwd batch and
ragged tile-march shapes) and K3-faces' divergence bit for bit its twin
on CPU copies on the toy Norne-like deck and seeded face lists, and K6
on a face list (its list launch, and as the first phase of K10's
refresh) bit for bit its twin and the former pair of kernels, with no
allocator request.
chip_smoke.py holds every kernel against its plain version at the SPE1,
SPE10-2 and full Norne-class shapes.

Needs an NVIDIA GPU and nvcc; skipped without a card. This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import gc
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE1 = os.path.join(ROOT, "data", "SPE1CASE2.DATA")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def sims(dev):
    from opm_tpu_torch.io.eclstate import load_case
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    case = load_case(SPE1)
    return (SimulatorFullyImplicitBlackoil(case, device=dev),
            SimulatorFullyImplicitBlackoil(case, device="cpu"))


def _rel(a, b):
    d = (a - b).abs()
    return float(torch.where(d == 0, 0.0, d / b.abs()).max())


# K1: relative 1e-13 (both run the same operation sequence; nvcc builds
# with --fmad=false)
def test_k1_region_rows_match_plain(dev):
    """Per-query region rows (nreg > 1) through both K1 entries."""
    from opm_tpu_torch.utils import tables as k1
    rng = np.random.default_rng(7)
    nreg, n, m, nq = 3, 9, 4, 5000

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    xs = t(np.sort(rng.uniform(0, 1, (nreg, n)), axis=1))
    ys = t(rng.normal(size=(nreg, 2, n)))
    gy = t(np.sort(rng.uniform(0, 1, (nreg, m)), axis=1))
    z = t(rng.normal(size=(nreg, 2, n, m)))
    x, y = t(rng.uniform(-0.2, 1.2, nq)), t(rng.uniform(-0.2, 1.2, nq))
    reg = t(rng.integers(0, nreg, nq))
    for clamp in (0, 1):
        kv = k1.interp1_cuda(xs, ys, x, reg, clamp)
        pv = k1.lookup1_plain(xs, ys, x, reg, clamp)
        k2 = k1.interp2_cuda(xs, gy, z, x, y, reg, clamp, clamp)
        p2 = k1.lookup2_plain(xs, gy, z, x, y, reg, clamp, clamp)
        torch.cuda.synchronize()
        for a, b in list(zip(kv, pv)) + list(zip(k2, p2)):
            assert _rel(a, b) <= 1e-13


def test_jacobian_through_kernels_matches_cpu(dev, sims):
    """torch.func.jacfwd of the residual on the card (through the
    forward-mode rules of K2, whose columns carry the table lookups, and
    K3) against the same Jacobian on the CPU's plain path: 1e-10 of
    max|J|."""
    from opm_tpu_torch.models.blackoil import (cells_columns_cuda,
                                               make_well_device_arrays,
                                               tpfa_div_tangent_cuda)
    from opm_tpu_torch.sim.blackoil import init_well_state, report_step_wells
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
    out = []
    for sim in sims:
        step = sim.schedule.report_steps[0]
        ws = report_step_wells(step, sim.grid, sim.well_names, sim.max_perf)
        wd = make_well_device_arrays(ws, sim.grid.gravity, sim.device)
        if not out:
            st = initial_state(sim.grid, sim.props, sim.case, ws.nw)
            st = init_well_state(st, ws, True)
            host = state_to_numpy(st)
        st = state_from_numpy(host, sim.device)
        acc0 = sim.model.accumulation(st)
        cdp = sim.solver._cdp(st, wd)
        n0 = (cells_columns_cuda.launches, tpfa_div_tangent_cuda.launches)
        J, r = sim.solver.jacobian(st, acc0, 86400.0, wd, cdp)
        if sim.device.type == "cuda":
            assert cells_columns_cuda.launches > n0[0]
            assert tpfa_div_tangent_cuda.launches > n0[1]
        out.append((J.cpu(), r.cpu()))
    (Jg, rg), (Jc, rc) = out
    scale = float(Jc.abs().max())
    assert float((Jg - Jc).abs().max()) <= 1e-10 * scale
    assert float((rg - rc).abs().max()) <= 1e-11 * float(rc.abs().max())


def test_cpr_solve_through_kernels_matches_twins(dev):
    """The toy SPE10-like deck's first Newton system (2640 cells, three
    GMG levels) solved on the card through K4, K6, K7 and K8, and again
    through their plain twins on the card. The kernels' dots are
    deterministic (two kernel solves agree bit for bit) but sum in
    another order than torch.dot, and BiCGStab amplifies that: on this
    system the summation order of the dots alone moves the count at tol
    1e-2 between 11 and 14 iterations, and du after 12 iterations by up
    to 6.27e-2 of max|du| between two orders (tools/krylov_order.py: four
    orders on the CPU through the twins). So both solves converge, their
    counts are at most one apart, each solution's true residual ||b - A
    x|| (through the plain operator) is within the tolerance, du after
    exactly 12 iterations agrees to 6.3e-2 of max|du| (that measured
    spread), and after three iterations (du 2.9e-11 from a 1e-15
    perturbation of b) to 1e-8."""
    from opm_tpu_torch.models import linearize

    sim, sys = _spe10_toy_system(dev)
    dims = sim.model.dims

    def solve(twin, tol, maxiter):
        return _cpr_solve(sys, sim.solver.amg, dims, twin, tol, maxiter)

    rel = _scaled

    tol = 1e-2
    rk, dk = solve(False, tol, 50)
    rk2, dk2 = solve(False, tol, 50)
    rp, dp = solve(True, tol, 50)
    assert rk.converged and rp.converged
    assert rk.iterations == rk2.iterations and torch.equal(dk, dk2)
    assert abs(rk.iterations - rp.iterations) <= 1
    mv, rhs, _ = linearize.schur_eliminate_wells(sys, dims, twin=True)
    for res in (rk, rp):
        assert float((rhs - mv(res.x)).norm()) <= tol * float(rhs.norm())
    (rk, dk), (rp, dp) = solve(False, 1e-30, 12), solve(True, 1e-30, 12)
    assert rk.iterations == rp.iterations == 12
    assert rel(dk, dp) <= 6.3e-2
    (_, dk), (_, dp) = solve(False, 1e-12, 3), solve(True, 1e-12, 3)
    assert rel(dk, dp) <= 1e-8


def _spe10_toy_system(dev):
    """The toy SPE10-like deck's first Newton system on the card (2640
    cells, three GMG levels)."""
    from opm_tpu_torch.models import linearize
    from opm_tpu_torch.models.blackoil import make_well_device_arrays
    from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                            init_well_state,
                                            report_step_wells)
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.sim.testcases import spe10like_case
    from opm_tpu_torch.solver.newton import connection_offsets

    case = spe10like_case(nx=15, ny=44, nz=4, tsteps="3*1")
    sim = SimulatorFullyImplicitBlackoil(case, device=dev)
    ws = report_step_wells(sim.schedule.report_steps[0], sim.grid,
                           sim.well_names, sim.max_perf)
    wd = make_well_device_arrays(ws, sim.grid.gravity, dev)
    st = init_well_state(initial_state(sim.grid, sim.props, case, ws.nw),
                         ws, True)
    acc0 = sim.model.accumulation(st)
    return sim, linearize.assemble(sim.model, st, acc0, 21600.0, wd,
                                   connection_offsets(sim.model, st, wd))


def _cpr_solve(sys, amg, dims, twin, tol, maxiter):
    """CPR-BiCGStab on the well-eliminated system: (result, du)."""
    from opm_tpu_torch.linalg import precond
    from opm_tpu_torch.linalg.krylov import bicgstab
    from opm_tpu_torch.models import linearize

    mv, rhs, rec = linearize.schur_eliminate_wells(sys, dims, twin=twin)
    M = precond.make_cpr_cells(sys, amg, dims, twin=twin)
    res = bicgstab(mv, rhs, precond=M, tol=tol, maxiter=maxiter, twin=twin)
    return res, torch.cat([res.x.reshape(-1), rec(res.x).reshape(-1)])


class _KernelVcycle:
    """A hierarchy whose V-cycle always runs its kernels: every other step
    of a ``twin`` solve stays a plain twin."""

    def __init__(self, amg):
        self.amg = amg

    def __getattr__(self, name):
        return getattr(self.amg, name)

    def vcycle(self, vals, b, w=None, rc=None, twin=False):
        return self.amg.vcycle(vals, b, w=w, rc=rc)


def test_cpr_solve_through_k7_matches_twins(dev):
    """The toy SPE10-like deck's Newton system solved on the card with
    every step by its plain twin except the V-cycle, through K7's two legs
    (two launches and one product per preconditioner apply, two applies
    per iteration), against the same solve all by twins: the same
    iteration count, and du within 1e-10 of max|du| (K7 sums in its twins'
    order; BiCGStab amplifies any last-bit difference of the float32
    coarsest product)."""
    from opm_tpu_torch.linalg import gmg as k7

    sim, sys = _spe10_toy_system(dev)
    dims = sim.model.dims
    n0 = _vcycle_launches(k7)
    rk, dk = _cpr_solve(sys, _KernelVcycle(sim.solver.amg), dims, True,
                        1e-2, 50)
    d = [a - c for a, c in zip(_vcycle_launches(k7), n0)]
    rp, dp = _cpr_solve(sys, sim.solver.amg, dims, True, 1e-2, 50)
    assert rk.converged and rk.iterations == rp.iterations
    assert d[0] == d[1] == d[2] == 2 * rk.iterations
    assert _scaled(dk, dp) <= 1e-10


def test_bicgstab_without_preconditioner_matches_twins(dev):
    """BiCGStab with no preconditioner on the card, where phat and shat
    are p and s themselves (omega_xr_p's aliased pointers), on a seeded,
    diagonally dominant system of 3 x 401 unknowns (odd: the tail): bit
    for bit the solve with an identity preconditioner that copies; against
    the twins' solve on the card the same iteration count, x within 1e-10
    of max|x| (the dots sum in another order) and both true residuals
    within the tolerance."""
    from opm_tpu_torch.linalg import kernels_k8 as k8
    from opm_tpu_torch.linalg.krylov import bicgstab

    nc = 401
    rng = np.random.default_rng(23)
    A = rng.standard_normal((3 * nc, 3 * nc)) * 0.3
    A[np.diag_indices(3 * nc)] = np.abs(A).sum(axis=1) + 1.0
    At = torch.as_tensor(A, device=dev)
    b = torch.as_tensor(rng.standard_normal((3, nc)), device=dev)

    def mv(v):
        return (At @ v.reshape(-1)).reshape(3, nc)

    tol = 1e-10
    n0 = k8.omega_xr_p_cuda.launches
    rk = bicgstab(mv, b, tol=tol, maxiter=100)
    assert k8.omega_xr_p_cuda.launches - n0 == rk.iterations >= 3
    rc = bicgstab(mv, b, precond=lambda v: v.clone(), tol=tol, maxiter=100)
    rp = bicgstab(mv, b, tol=tol, maxiter=100, twin=True)
    assert rk.converged and rp.converged
    assert rc.iterations == rk.iterations and torch.equal(rc.x, rk.x)
    assert rk.iterations == rp.iterations
    assert float((rk.x - rp.x).abs().max()) <= 1e-10 * float(
        rp.x.abs().max())
    for res in (rk, rp):
        assert float((b - mv(res.x)).norm()) <= tol * float(b.norm())


@pytest.mark.parametrize("nc", [7, 2640], ids=["odd", "toy"])
def test_k8_steps_match_twins(dev, nc):
    """K8's four steps on (3, nc) vectors against their twins on the card,
    each from the same vectors and scalars (21 values: the odd tail; 7920:
    the toy SPE10-like deck's): vectors within 1e-13 of max, scalars within
    1e-12 relative (the kernels' one-pass tree sums in another order than
    torch.dot); a repeated step gives the same bits; two launches per
    iteration."""
    from opm_tpu_torch.linalg import kernels_k8 as k8

    rng = np.random.default_rng(nc)
    b, r, p, v, t, s, phat, shat, x = (
        torch.as_tensor(rng.standard_normal((3, nc)), device=dev)
        for _ in range(9))
    ws = k8.Workspace(b, kernels=True)
    sp = k8.new_scalars(dev)

    def close(a, c, tol=1e-13):
        return float((a - c).abs().max()) <= tol * float(c.abs().max())

    k8.init_cuda(ws, b)
    k8.init_plain(b, sp)
    assert close(ws.sc, sp, 1e-12)
    sp[k8.ALPHA], sp[k8.OMEGA], sp[k8.BETA] = 0.7, 0.3, 0.5
    ws.sc.copy_(sp)
    assert close(k8.p_update_cuda(ws, p.clone(), r, v),
                 k8.p_update_plain(p, r, v, sp))
    n0 = (k8.alpha_s_cuda.launches, k8.omega_xr_p_cuda.launches)
    sk = k8.alpha_s_cuda(ws, b, v, r).clone()
    sck = ws.sc.clone()
    assert close(sk, k8.alpha_s_plain(b, v, r, sp))
    assert _rel(sck[k8.ALPHA], sp[k8.ALPHA]) <= 1e-12
    ws.sc.copy_(sck)
    assert torch.equal(k8.alpha_s_cuda(ws, b, v, r), sk)
    assert torch.equal(ws.sc, sck)
    ws.sc.copy_(sp)
    out = [a.clone() for a in (x, r, p)]
    k8.omega_xr_p_cuda(ws, t, s, *out[:2], phat, shat, b, out[2], v)
    for a, c in zip(out, k8.omega_xr_p_plain(t, s, x, r, phat, shat, b, p,
                                             v, sp)):
        assert close(a, c)
    for i in (k8.OMEGA, k8.RHO, k8.RHO1, k8.BETA, k8.RR):
        assert _rel(ws.sc[i], sp[i]) <= 1e-12
    assert (k8.alpha_s_cuda.launches - n0[0],
            k8.omega_xr_p_cuda.launches - n0[1]) == (2, 1)


def _norne_toy_system(dev, knob):
    """The toy Norne-like deck's first Newton system on the card in one
    representation (OPM_TPU_EMBED unset: embedded; "0": gather)."""
    from opm_tpu_torch.models import linearize
    from opm_tpu_torch.models.blackoil import make_well_device_arrays
    from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                            init_well_state,
                                            report_step_wells)
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.sim.testcases import norne_like_case
    from opm_tpu_torch.solver.newton import connection_offsets

    old = os.environ.pop("OPM_TPU_EMBED", None)
    if knob is not None:
        os.environ["OPM_TPU_EMBED"] = knob
    try:
        sim = SimulatorFullyImplicitBlackoil(
            norne_like_case(nx=12, ny=24, nz=22, tsteps="1 2 5"), device=dev)
    finally:
        os.environ.pop("OPM_TPU_EMBED", None)
        if old is not None:
            os.environ["OPM_TPU_EMBED"] = old
    ws = report_step_wells(sim.schedule.report_steps[0], sim.grid,
                           sim.well_names, sim.max_perf)
    wd = make_well_device_arrays(ws, sim.grid.gravity, dev)
    st = init_well_state(initial_state(sim.grid, sim.props, sim.case, ws.nw),
                         ws, True)
    sys = linearize.assemble(sim.model, st, sim.model.accumulation(st),
                             86400.0, wd, connection_offsets(sim.model, st,
                                                             wd))
    return sim, st, sys


def _scaled(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


@pytest.mark.parametrize("knob", [None, "0"], ids=["embedded", "gather"])
def test_face_kernels_match_twins_on_toy(dev, knob):
    """K3-faces, K4-faces (its sliced-ELL copy, written by the assembly's
    face blocks, bit for bit the pack's twin; matvec, on the embedded grid
    both in place over the touched rows and from the diagonal by cell, and
    the fused smoothing step, full and pressure-only iterates) and, on the
    gather grid, K6's cell part and K6-faces against their plain twins on
    the card, on the toy Norne-like deck's first Newton system: 1e-12 of
    max (the kernels sum in the twins' scatter order)."""
    from opm_tpu_torch.linalg import precond as k6
    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.models import linearize as k4

    sim, st, sys = _norne_toy_system(dev, knob)
    m = sim.model
    fl, dims = m.faces, m.op_dims
    q = m.cell_quantities(st)
    args = (torch.stack([q.pw, q.po, q.pg]).contiguous(),
            q.rho.contiguous(), (q.b * q.mob).contiguous(),
            q.rs.contiguous(), q.rv.contiguous(), m.depth, m.trans,
            m.gravity)
    base = None if dims is None else mb.tpfa_div_cuda(
        dims, *args[:6], m.trans_stencil, m.gravity)
    n0 = mb.faces_div_cuda.launches
    kd = mb.faces_div_cuda(fl, *args,
                           out=None if base is None else base.clone())
    assert mb.faces_div_cuda.launches == n0 + 1
    assert _scaled(kd, mb.faces_div_plain(fl, *args, out=base)) <= 1e-12
    rng = np.random.default_rng(3)
    ops = (sys.diag, sys.face_L, sys.face_R)
    x = torch.as_tensor(rng.standard_normal((3, m.nc)), device=dev)
    r = torch.as_tensor(rng.standard_normal((3, m.nc)), device=dev)
    dinv, w, diag_p, off = k6.cpr_setup_plain(*ops, dims, fl)
    op = sys.packed
    assert torch.equal(op.blk, k4.faces_pack_plain(fl.sell, sys.face_L,
                                                   sys.face_R))
    for xx in (x, x[0].contiguous()):
        kb = None if dims is None else k4.matvec_cells_cuda(*ops, xx, dims)
        if xx.dim() == 2:
            ky = k4.faces_matvec_cuda(op, xx,
                                      None if kb is None else kb.clone())
            assert _scaled(ky, k4.faces_matvec_plain(fl, *ops, xx,
                                                     kb)) <= 1e-12
            if kb is not None:
                # a thread per cell over the touched rows' layout
                assert _scaled(k4.faces_matvec_cuda(op, xx),
                               k4.faces_matvec_plain(fl, *ops, xx)) <= 1e-12
        ks = k4.faces_smooth_cuda(op, dinv, xx, r, kb)
        assert _scaled(ks, k4.faces_smooth_plain(fl, *ops, dinv, xx, r,
                                                 kb)) <= 1e-12
    if dims is None:
        kc = k6.cpr_setup_cells_cuda(sys.diag)
        for a, b in zip(kc, (dinv, w, diag_p)):
            assert _scaled(a, b) <= 1e-13
        ko = k6.cpr_faces_cuda(fl, w, sys.face_L, sys.face_R)
        assert _scaled(ko, off) <= 1e-13


def _vcycle_launches(mod):
    """(down, up, coarsest products) counted so far; the down leg through
    either entry (b, or the CPR apply's weighted residual)."""
    from opm_tpu_torch.linalg import gmg as k7
    return (mod.vcycle_down_cuda.launches
            + mod.vcycle_down_rhs_cuda.launches,
            mod.vcycle_up_cuda.launches, k7.coarsest_product.calls)


def _no_allocation(vcycle, x):
    """Ten V-cycles allocate nothing on the card and repeat x's bits."""
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    for _ in range(10):
        y = vcycle()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == m0
    assert torch.equal(y, x)


def test_k10_matches_twins_on_toy(dev):
    """K10 on the toy Norne-like deck's gather grid (4176 cells): one
    ``coarsen_values`` is one ``refresh_cuda`` launch into the hierarchy's
    buffers (the same LevelValues every call); every level's diag and ELL
    values and the float32 dense coarsest matrix bit for bit the per-level
    composition of the twins on CPU copies of the inputs (the CPU's
    index_add_ adds in index order, the kernel's order) and within 1e-12
    of max the twins on the card (index_add_ with atomics), the inverse
    bit for bit torch.linalg.inv of the same matrix (inv_ex's info 0) and
    within 1e-5 of max the CPU's; ten refreshes allocate nothing and leave the workspace's table
    as it was; a V-cycle after a refresh with other values equals one on
    a hierarchy put on the card afresh. One V-cycle through the two legs
    (exactly two K10 launches and one float32 product) against the
    per-level composition of the twins, and every level's right-hand side
    and correction in the workspace against the legs' twins, within 1e-6
    of max (the twins' restriction is an index_add with atomics on the
    card, which can round the float32 coarsest right-hand side the other
    way); ten more V-cycles allocate nothing and repeat the bits. A
    hierarchy cut at two levels (a coarsest level of more than
    DENSE_COARSEST cells, solved by 1 + 10 sweeps in the down leg): two
    launches, no product, and the V-cycle within 1e-10 of max of the
    twins' (all float64; the atomics' order alone)."""
    from opm_tpu_torch.linalg import amg as k10
    from opm_tpu_torch.linalg import precond as k6

    sim, _, sys = _norne_toy_system(dev, "0")
    amg = sim.solver.amg
    nl = amg.n_levels
    assert isinstance(amg, k10.DeviceAmg) and nl >= 4
    diag_p, off = k6.cpr_setup_plain(sys.diag, sys.face_L, sys.face_R, None,
                                     sys.faces)[2:]
    n0 = k10.refresh_cuda.launches
    vk = amg.coarsen_values(diag_p, off)
    assert k10.refresh_cuda.launches == n0 + 1 and vk is amg.refresh.vals
    R = amg.refresh
    hc = k10.DeviceAmg(amg.hierarchy, "cpu")
    vc = hc.coarsen_values(diag_p.cpu(), off.cpu())
    for (dk, ek), (dc, ec) in zip(vk[:nl], vc[:nl]):
        assert torch.equal(dk.cpu(), dc) and torch.equal(ek.cpu(), ec)
    assert torch.equal(R.dense.cpu(), k10.dense_coarsest(
        *vc[nl - 1], hc.ell[-1]["cols"]).to(torch.float32))
    inv = torch.linalg.inv(R.dense)
    assert torch.equal(vk[-1], inv) and vk[-1].stride() == inv.stride()
    assert int(R.inv_info) == 0
    assert _scaled(vk[-1].cpu(), vc[-1]) <= 1e-5
    # a V-cycle on the refreshed values is the one on the composition's
    # values with the card's torch.linalg.inv, bit for bit
    comp = k10.LevelValues([(d.to(dev), e.to(dev)) for d, e in vc[:nl]]
                           + [inv])
    rng = np.random.default_rng(5)
    b = torch.as_tensor(rng.standard_normal(amg.n0), device=dev)
    assert torch.equal(amg.vcycle(vk, b), amg.vcycle(comp, b))
    vp = amg.coarsen_values(diag_p, off, twin=True)
    for (dk, ek), (dp, ep) in zip(vk[:nl], vp[:nl]):
        assert _scaled(dk, dp) <= 1e-12 and _scaled(ek, ep) <= 1e-12
    table = vk.ws.table.clone()
    gc.collect()        # earlier cyclic garbage, freed at any moment
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    assert all(amg.coarsen_values(diag_p, off) is vk for _ in range(10))
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == m0
    assert torch.equal(vk.ws.table, table)
    f = torch.as_tensor(rng.uniform(0.9, 1.1, off.shape), device=dev)
    x2 = amg.vcycle(amg.coarsen_values(diag_p * 1.25, off * f), b).clone()
    fresh = k10.DeviceAmg(amg.hierarchy, dev)
    assert torch.equal(x2, fresh.vcycle(fresh.coarsen_values(
        diag_p * 1.25, off * f), b))
    assert amg.coarsen_values(diag_p, off) is vk
    n0 = _vcycle_launches(k10)
    x = amg.vcycle(vk, b).clone()
    assert tuple(a - c for a, c in zip(_vcycle_launches(k10), n0)) == \
        (1, 1, 1)
    assert _scaled(x, amg.vcycle(vk, b, twin=True)) <= 1e-6
    ws = vk.ws
    bs, bc = amg.vcycle_down_plain(vk, b)
    _, es = amg.vcycle_up_plain(vk, bs, vk[-1] @ bc)
    assert _scaled(ws.bc.double(), bc.double()) <= 1e-6
    for k in range(1, nl - 1):
        assert _scaled(ws.b[k], bs[k]) <= 1e-6
        assert _scaled(ws.e[k], es[k]) <= 1e-6
    _no_allocation(lambda: amg.vcycle(vk, b), x)

    h2 = k10.build_hierarchy(sim.model.nc, sim.grid.face_cells,
                             sim.grid.trans, max_levels=2).device(dev)
    assert h2.coarsest_n > k10.DENSE_COARSEST
    v2 = h2.coarsen_values(diag_p, off)
    n0 = _vcycle_launches(k10)
    x2 = h2.vcycle(v2, b).clone()
    assert tuple(a - c for a, c in zip(_vcycle_launches(k10), n0)) == \
        (1, 1, 0)
    assert _scaled(x2, h2.vcycle(v2, b, twin=True)) <= 1e-10


def _stencil(dims, seed):
    """A seeded 7-point pressure stencil in grid face order: (diag, off,
    face transmissibilities)."""
    nx, ny, nz = dims
    cells = np.arange(nx * ny * nz).reshape(nz, ny, nx)
    c1 = np.concatenate([cells[:, :, :-1].ravel(), cells[:, :-1].ravel(),
                         cells[:-1].ravel()])
    c2 = np.concatenate([cells[:, :, 1:].ravel(), cells[:, 1:].ravel(),
                         cells[1:].ravel()])
    t = np.random.default_rng(seed).uniform(0.5, 2.0, len(c1))
    diag = np.zeros(nx * ny * nz)
    np.add.at(diag, c1, t)
    np.add.at(diag, c2, t)
    return diag * 1.05, np.concatenate([-t, -t]), t


@pytest.mark.parametrize("case", ["strength", "padded", "level0_padded"])
def test_k7_legs_match_twins(dev, case):
    """K7's two legs on seeded stencils: the toy SPE10-like dims with levels
    by strength, the same dims by argmax (a padded level) and 17x9x7 (level
    0 padded): one V-cycle is exactly two K7 launches and one float32
    product; it, each level's right-hand side and correction in the
    workspace and the float32 coarsest right-hand side equal the twins' to
    1e-12 of max (the same operations in the same order); ten more
    V-cycles allocate nothing and repeat the bits."""
    from opm_tpu_torch.linalg import gmg as k7

    dims = (17, 9, 7) if case == "level0_padded" else (15, 44, 4)
    diag, off, t = _stencil(dims, 3)
    g = k7.StructuredGmg(dims, t if case == "strength" else None)
    assert len(g.levels) >= 2
    assert (case != "padded") or any(lv.pad for lv in g.levels)
    assert (case != "level0_padded") or g.levels[0].pad
    vals = g.coarsen_values(torch.as_tensor(diag, device=dev),
                            torch.as_tensor(off, device=dev))
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(g.nc),
                        device=dev)
    n0 = _vcycle_launches(k7)
    x = g.vcycle(vals, b).clone()
    assert tuple(a - c for a, c in zip(_vcycle_launches(k7), n0)) == \
        (1, 1, 1)
    assert _scaled(x, g.vcycle(vals, b, twin=True)) <= 1e-12
    ws = vals.ws
    bs, bc = g.vcycle_down_plain(vals, b)
    _, es = g.vcycle_up_plain(vals, bs, vals[-1] @ bc)
    assert _scaled(ws.bc.double(), bc.double()) <= 1e-12
    for lv in range(1, len(g.levels)):
        assert _scaled(ws.b[lv], bs[lv]) <= 1e-12
        assert _scaled(ws.e[lv], es[lv]) <= 1e-12
    _no_allocation(lambda: g.vcycle(vals, b), x)


@pytest.mark.parametrize("case", ["strength", "padded"])
def test_k7_refresh_matches_twins(dev, case):
    """K7's value refresh on seeded stencils of the toy SPE10-like dims
    (levels by strength; by argmax, with a padded level): one
    ``coarsen_values`` is one ``refresh_cuda`` launch into the hierarchy's
    buffers (the same LevelValues every call); every level and the
    float32 dense coarsest matrix bit for bit the per-level composition on
    CPU copies of the inputs, the inverse bit for bit torch.linalg.inv of
    the same matrix in its layout, inv_ex's info 0; ten launches of the
    kernel make no allocator request, ten refreshes (the inverse's pivots
    come from the cache) leave the memory allocated as it was and the
    workspace's table and the refresh's own as they were; a V-cycle after a second refresh with other values equals one on
    freshly composed values (the per-level composition on the card)."""
    from opm_tpu_torch.linalg import gmg as k7

    dims = (15, 44, 4)
    diag, off, t = _stencil(dims, 3)
    g = k7.StructuredGmg(dims, t if case == "strength" else None)
    assert (case != "padded") or any(lv.pad for lv in g.levels)
    d0 = torch.as_tensor(diag, device=dev)
    o0 = torch.as_tensor(off, device=dev)
    n0 = k7.refresh_cuda.launches
    vk = g.coarsen_values(d0, o0)
    R = g.refresh(dev)
    assert k7.refresh_cuda.launches == n0 + 1 and vk is R.vals
    levels, A = g.compose(d0.cpu(), o0.cpu())
    for (dk, ok), (dc, oc) in zip(vk[:-1], levels):
        assert torch.equal(dk.cpu(), dc)
        for (kL, kR), (cL, cR) in zip(ok, oc):
            assert torch.equal(kL.cpu(), cL) and torch.equal(kR.cpu(), cR)
    assert torch.equal(R.dense.cpu(), A.to(torch.float32))
    inv = torch.linalg.inv(R.dense)
    assert torch.equal(vk[-1], inv) and vk[-1].stride() == inv.stride()
    assert int(R.inv_info) == 0
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(g.nc),
                        device=dev)
    x = g.vcycle(vk, b).clone()
    tables = (vk.ws.table.clone(), R.table.clone())
    gc.collect()
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    assert all(k7.refresh_cuda(R, d0, o0) is vk for _ in range(10))
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats().get("allocation.all.allocated", 0) == a0
    m0 = torch.cuda.memory_allocated()
    assert all(g.coarsen_values(d0, o0) is vk for _ in range(10))
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == m0
    assert torch.equal(vk.ws.table, tables[0])
    assert torch.equal(R.table, tables[1])
    assert torch.equal(g.vcycle(vk, b), x)
    f = torch.as_tensor(np.random.default_rng(5).uniform(0.9, 1.1, off.shape),
                        device=dev)
    d2, o2 = d0 * 1.25, o0 * f
    x2 = g.vcycle(g.coarsen_values(d2, o2), b).clone()
    fresh = g.coarsen_values(d2, o2, twin=True)
    assert fresh is not vk
    assert torch.equal(x2, g.vcycle(fresh, b))


def test_k5_rhs_forms_dinv(dev):
    """K5's right-hand-side launch forms D^-1 itself (a WellTerm made
    without one, the main path): on the toy SPE10-like deck's well blocks,
    with the first two replaced by tests/test_torch_linalg.py's healthy
    and rank-deficient blocks, D^-1 bit for bit the plain inv4x4 on the
    card (cuBLAS's batched 2x2 products fuse each multiply-add, as the
    kernel's do); the right-hand side bit for bit the one from a WellTerm
    given that D^-1; one launch, counted once as forming D^-1; the
    recovery and the reduced operator from the formed D^-1 equal those
    from the given one."""
    from opm_tpu_torch.linalg.precond import inv4x4
    from opm_tpu_torch.models import linearize as lz

    sim, sys = _spe10_toy_system(dev)
    rng = np.random.default_rng(7)
    healthy = np.eye(4) + 0.1 * rng.normal(size=(4, 4))
    healthy[:, 3] *= 1e-7
    healthy[3] = [0.0, -1.0, 0.0, 0.0]
    v = np.array([219.0, 42.3, 1.02, -1.6e-7])
    sick = np.stack([0.001 * v, -0.0008 * v, v,
                     np.array([0.0, -1.0, 0.0, 0.0])])
    wd = sys.wd_diag.clone()
    assert wd.shape[0] >= 2
    wd[0] = torch.as_tensor(healthy, device=dev)
    wd[1] = torch.as_tensor(sick, device=dev)
    for s in (sys, sys._replace(wd_diag=wd)):
        D = inv4x4(s.wd_diag).contiguous()
        given = lz.WellTerm(s, D)
        wt = lz.WellTerm(s)
        n0 = (lz.schur_rhs_cuda.launches, lz.schur_rhs_cuda.inverses)
        rhs = lz.schur_rhs_cuda(wt)
        assert (lz.schur_rhs_cuda.launches - n0[0],
                lz.schur_rhs_cuda.inverses - n0[1]) == (1, 1)
        assert wt.formed and torch.equal(wt.Dinv, D)
        assert torch.equal(rhs, lz.schur_rhs_cuda(given))
        assert lz.schur_rhs_cuda.inverses - n0[1] == 1
        x = torch.as_tensor(rng.standard_normal((3, s.nc)), device=dev)
        assert torch.equal(lz.schur_recover_cuda(wt, x),
                           lz.schur_recover_cuda(given, x))
        dims = sim.model.op_dims
        assert torch.equal(lz.reduced_matvec_cuda(wt, x, dims),
                           lz.reduced_matvec_cuda(given, x, dims))


@pytest.mark.parametrize("knob", [None, "0"], ids=["embedded", "gather"])
def test_assembly_kernels_match_twins_on_toy(dev, knob):
    """K2 (values, tangent columns, the assembly entry), the K3 face blocks
    (the stencil form and the embedded epilogue, or the gather grid's face
    list) and K5's three entries against their plain twins on the card, on
    the toy Norne-like deck's first Newton system with seeded pressure
    noise: K2's values relative 1e-13, its tangents, the blocks and K5 1e-12
    of each row's max; and the whole assembly through the kernels against
    one through the twins, field by field (1e-12 of max)."""
    from opm_tpu_torch.linalg.precond import inv4x4
    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.models import linearize as lz
    from opm_tpu_torch.solver.newton import connection_offsets

    sim, st, _ = _norne_toy_system(dev, knob)
    m = sim.model
    rng = np.random.default_rng(11)
    st = st._replace(pressure=st.pressure + torch.as_tensor(
        rng.standard_normal(m.nc) * 2.0e4, device=dev))
    props, pack = m.props, m.props.cell_pack()
    a = (st.pressure, st.sw, st.x, st.hcstate, m.pvtnum, m.satnum)

    def row_scaled(x, y):
        x, y = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
        d = (x - y).abs().amax(dim=1)
        return float(torch.where(d == 0, 0.0,
                                 d / y.abs().amax(dim=1)).max())

    n0 = mb.cells_values_cuda.launches
    assert _rel(mb.cells_values_cuda(pack, *a),
                mb.cells_values_plain(props, *a)) <= 1e-13
    assert mb.cells_values_cuda.launches == n0 + 1
    assert row_scaled(mb.cells_columns_cuda(pack, *a),
                      mb.cells_columns_plain(props, *a)) <= 1e-12
    acc0 = m.accumulation(st) * 0.999
    ka = mb.cells_assemble_cuda(pack, *a, acc0, m.pv, 86400.0)
    pa = mb.cells_assemble_plain(props, *a, acc0, m.pv, 86400.0)
    assert _rel(ka[0], pa[0]) <= 1e-13
    for x, y in zip(ka[1:], pa[1:]):
        assert row_scaled(x, y) <= 1e-12
    fv, fc, r0, d0 = pa
    nf = m.trans.shape[0]

    def blocks(fn, lead, r, d):
        fL = torch.zeros((9, nf), dtype=torch.float64, device=dev)
        fR = torch.zeros_like(fL)
        fn(lead, fv, fc, m.depth, m.trans, m.gravity, r, d, fL, fR)
        return r, d, fL, fR

    r_s, d_s = r0, d0
    if m.op_dims is not None:
        ns = m.nf_canonical
        kb = blocks(lz.face_blocks_cuda, m.op_dims, r0.clone(), d0.clone())
        pb = blocks(lz.face_blocks_plain, m.op_dims, r0.clone(), d0.clone())
        for x, y in zip(kb[:2] + tuple(f[:, :ns] for f in kb[2:]),
                        pb[:2] + tuple(f[:, :ns] for f in pb[2:])):
            assert row_scaled(x, y) <= 1e-12
        r_s, d_s = pb[0], pb[1]
    f0 = m.faces.first
    kl = blocks(lz.faces_blocks_cuda, m.faces, r_s.clone(), d_s.clone())
    pl = blocks(lz.faces_blocks_plain, m.faces, r_s.clone(), d_s.clone())
    for x, y in zip(kl[:2] + tuple(f[:, f0:] for f in kl[2:]),
                    pl[:2] + tuple(f[:, f0:] for f in pl[2:])):
        assert row_scaled(x, y) <= 1e-12
    ws = sim.well_names
    assert len(ws) > 0
    from opm_tpu_torch.models.blackoil import make_well_device_arrays
    from opm_tpu_torch.sim.blackoil import report_step_wells
    w = report_step_wells(sim.schedule.report_steps[0], sim.grid, ws,
                          sim.max_perf)
    wd = make_well_device_arrays(w, sim.grid.gravity, dev)
    cdp = connection_offsets(m, st, wd)
    sys = lz.assemble(m, st, acc0, 86400.0, wd, cdp)
    tw = lz.assemble(m, st, acc0, 86400.0, wd, cdp, twin=True)
    for f in ("r_cell", "r_well", "diag", "face_L", "face_R", "cw", "wc",
              "wd_diag"):
        assert _scaled(getattr(sys, f), getattr(tw, f)) <= 1e-12, f
    Dinv = inv4x4(sys.wd_diag).contiguous()
    wt = lz.WellTerm(sys, Dinv)
    v = torch.as_tensor(rng.standard_normal((3, m.nc)), device=dev)
    out = torch.as_tensor(rng.standard_normal((3, m.nc)), device=dev)
    assert _scaled(lz.schur_matvec_cuda(wt, v, out.clone()),
                   lz.schur_matvec_plain(sys, Dinv, v, out)) <= 1e-12
    assert _scaled(lz.schur_rhs_cuda(wt),
                   lz.schur_rhs_plain(sys, Dinv)) <= 1e-12
    assert _scaled(lz.schur_recover_cuda(wt, v),
                   lz.schur_recover_plain(sys, Dinv, v)) <= 1e-12


def _two_regions(props):
    """``props`` with every per-region table doubled: region 1 is region
    0 scaled by 1.05 (monotone tables stay monotone)."""
    import dataclasses

    def grow(obj):
        kw = {f.name: torch.cat([t, t * 1.05]) for f in
              dataclasses.fields(obj)
              if isinstance(t := getattr(obj, f.name), torch.Tensor)
              and t.dim() and t.shape[0] == 1}
        return dataclasses.replace(obj, **kw)

    kw = {f.name: grow(getattr(props, f.name))
          for f in dataclasses.fields(props)
          if dataclasses.is_dataclass(getattr(props, f.name))}
    return dataclasses.replace(
        props, surface_density=torch.cat([props.surface_density,
                                          props.surface_density * 1.05]),
        **kw)


def _kinks(props, nc, seed, nreg):
    """Primaries in all three hydrocarbon states and their regions; the
    first cells of each region on its tables' kinks (PVTO nodes, p ==
    p_bub(rs_sat(p)), the clamped saturation tables' ends, connate
    water), as tests/test_torch_assembly.py's _kink_cells."""
    rng = np.random.default_rng(seed)
    hc = rng.integers(0, 3, nc).astype(np.int32)
    p = rng.uniform(1.5e7, 4.0e7, nc)
    sw = rng.uniform(0.15, 0.7, nc)
    x = np.where(hc == 0, rng.uniform(0.0, 0.25, nc),
                 np.where(hc == 1, rng.uniform(20.0, 120.0, nc),
                          rng.uniform(0.0, 1e-4, nc)))
    reg = rng.integers(0, nreg, nc)
    lo, sf = props.oil_live, props.satfunc
    i = 0
    for r in range(nreg):
        rs_n, pb_n = lo.rs_tab[r].cpu().numpy(), lo.pbub_tab[r].cpu().numpy()
        sw_n, sg_n = sf.sw[r].cpu().numpy(), sf.sg[r].cpu().numpy()
        k = len(rs_n)
        for h, pp, s, xx in (
                (1, pb_n[3 % k] + 2.0e6, 0.3, rs_n[3 % k]),
                (1, pb_n[4 % k], 0.3, rs_n[4 % k]),
                (0, pb_n[2 % k], 0.3, 0.1), (0, pb_n[5 % k], 0.25, 0.0),
                (2, pb_n[3 % k], 0.3, 0.0),
                (0, 2.0e7, sw_n[0], sg_n[-1]), (0, 2.0e7, sw_n[-1], 0.0),
                (1, 3.0e7, sw_n[0] - 0.05, 60.0), (0, 2.0e7, 0.3, sg_n[0]),
                (2, 2.0e7, sw_n[-1] + 0.1, 0.0),
                (0, 2.5e7, float(sf.swco[r]), 0.2)):
            hc[i], p[i], sw[i], x[i], reg[i] = h, pp, s, xx, r
            i += 1
    return p, sw, x, hc, reg


@pytest.mark.parametrize("nreg", [1, 2])
def test_k2_entries_bitwise_over_regions(dev, sims, nreg):
    """K2's values entry (plain double) equals cells_values_plain bit for
    bit, and its columns entry (Dual3, no value rows) and assembly entry
    equal theirs within 1e-12 of each row's max, over all
    three hydrocarbon states at the kink cells, with one PVT/SAT region
    (SPE1) and with two."""
    from opm_tpu_torch.models import blackoil as mb
    props = sims[0].model.props
    if nreg == 2:
        props = _two_regions(props)
    nc = 4000
    p, sw, x, hc, reg = _kinks(props, nc, 21, nreg)
    t = [torch.as_tensor(a, device=dev) for a in (p, sw, x, hc, reg, reg)]
    assert set(hc.tolist()) == {0, 1, 2}
    pack = props.cell_pack()
    assert bool((pack.c_meta[3] == nreg))     # w_nreg
    kv = mb.cells_values_cuda(pack, *t)
    assert torch.equal(kv, mb.cells_values_plain(props, *t))
    kc = mb.cells_columns_cuda(pack, *t)
    assert kc.shape == (3, mb.N_Q, nc)
    pc = mb.cells_columns_plain(props, *t)
    d = (kc - pc).abs().amax(dim=2)
    assert bool((d <= 1e-12 * pc.abs().amax(dim=2)).all())
    acc0 = torch.as_tensor(np.random.default_rng(2).uniform(
        0.5, 1.5, (3, nc)), device=dev)
    pv = torch.full((nc,), 250.0, dtype=torch.float64, device=dev)
    ka = mb.cells_assemble_cuda(pack, *t, acc0, pv, 86400.0)
    pa = mb.cells_assemble_plain(props, *t, acc0, pv, 86400.0)
    assert torch.equal(ka[0], pa[0]) and torch.equal(ka[2], pa[2])
    for a, b in (ka[1].reshape(-1, nc), pa[1].reshape(-1, nc)), (ka[3],
                                                                  pa[3]):
        d = (a - b).abs().amax(dim=1)
        assert bool((d <= 1e-12 * b.abs().amax(dim=1)).all())
    occ = mb.cells_occupancy(dev)
    assert all(o["blocks_per_sm"] >= 1 for o in occ.values())


@pytest.mark.parametrize("grid", ["structured", "embedded", "gather"])
def test_fused_reduced_operator(dev, grid):
    """The Schur-reduced operator with K5's well term in the cell
    operator's last launch equals the parent's pair (K4/K4-faces, then the
    stand-alone well term) bit for bit over ten launches in a row (the
    last-block ticket resets), and the twins' composition within 1e-12 of
    max; one launch per reduced matvec on structured and gather grids,
    two on embedded grids (K4, then K4-faces), none of the stand-alone
    entry; K5's right-hand side and recovery against their twins."""
    from opm_tpu_torch.linalg.precond import inv4x4
    from opm_tpu_torch.models import linearize as lz
    if grid == "structured":
        sim, sys = _spe10_toy_system(dev)
    else:
        sim, _, sys = _norne_toy_system(dev, None if grid == "embedded"
                                        else "0")
    dims = sim.model.op_dims
    Dinv = inv4x4(sys.wd_diag).contiguous()
    wt = lz.WellTerm(sys, Dinv)
    assert wt.arg is not None
    v = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (3, sys.nc)), device=dev)
    pair = lz.schur_matvec_cuda(wt, v, lz.matvec_cells(sys, v, dims))
    twin = lz.reduced_matvec_plain(sys, Dinv, v, dims)

    def launches():
        return [f.launches for f in (lz.matvec_cells_cuda,
                                     lz.faces_matvec_cuda,
                                     lz.schur_matvec_cuda,
                                     lz.reduced_matvec_cuda)]

    n0 = launches()
    outs = [lz.reduced_matvec_cuda(wt, v, dims) for _ in range(10)]
    torch.cuda.synchronize()
    k4, k4f, alone, fused = (b - a for a, b in zip(n0, launches()))
    assert (k4 + k4f, alone, fused) == (20 if grid == "embedded" else 10,
                                        0, 10)
    for out in outs:
        assert torch.equal(out, pair)
    assert _scaled(outs[0], twin) <= 1e-12
    assert int(wt.ticket) == 0
    mv, rhs, rec = lz.schur_eliminate_wells(sys, dims)
    assert torch.equal(mv(v), pair)
    assert _scaled(rhs, lz.schur_rhs_plain(sys, Dinv)) <= 1e-12
    assert _scaled(rec(v), lz.schur_recover_plain(sys, Dinv, v)) <= 1e-12


@pytest.mark.parametrize("nreg", [1, 2])
def test_k9_update_bitwise_over_regions(dev, sims, nreg):
    """K9's update entry equals its twins' composition (update_pressure_plain,
    K1's rs_sat on the card, update_cells_plain, the well rows) bit for bit
    in the CPR route's call form ((3, nc) and (nw, 4) increments) and the
    dense route's (views of one flat vector), at kink cells in all three
    hydrocarbon states (the first cells of each region untouched by the
    increment: rs_sat at PVTO nodes), with cells switching state, one and
    two PVT regions; three launches in a row repeat the bits, one launch
    each; ``update_state`` is one launch."""
    from opm_tpu_torch.solver import kernels_k9 as k9
    from opm_tpu_torch.solver.update import update_state
    props = sims[0].model.props
    if nreg == 2:
        props = _two_regions(props)
    nc, nw = 4000, 5
    p, sw, x, hc, reg = _kinks(props, nc, 23, nreg)
    rng = np.random.default_rng(24)
    du_c = np.stack([rng.standard_normal(nc) * 5e6,
                     rng.standard_normal(nc) * 0.3,
                     np.where(hc == 1, rng.standard_normal(nc) * 30.0,
                              rng.standard_normal(nc) * 0.3)])
    du_c[:, :11 * nreg] = 0.0
    du_w = rng.standard_normal((nw, 4)) * np.array([1e-3, 1e-3, 1e-3, 1e6])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    st = (t(p), t(sw), t(x), t(hc), t(rng.uniform(1e7, 3e7, nw)),
          t(rng.standard_normal((nw, 3))))
    rs = k9.rs_table(props, t(reg))
    assert (rs.reg is not None) == (nreg == 2)
    consts = k9.UpdateConsts(0.3, 0.2, 1e9, True, False)
    dw = t(du_w)
    flat = t(np.concatenate([du_c.reshape(-1), du_w[:, 3],
                             du_w[:, :3].reshape(-1)]))
    forms = ((t(du_c), dw[:, 3], dw[:, :3]),
             (flat[:3 * nc].view(3, nc), flat[3 * nc:3 * nc + nw],
              flat[3 * nc + nw:].view(nw, 3)))
    for inc in forms:
        args = (*st, *inc, 0.9, consts, rs)
        n0 = k9.update_cuda.launches
        outs = [k9.update_cuda(*args) for _ in range(3)]
        assert k9.update_cuda.launches == n0 + 3
        ref = k9.update_plain(*args)
        for out in outs:
            for a, b in zip(out, ref):
                assert torch.equal(a, b)
    assert set(hc.tolist()) == {0, 1, 2}
    assert int((outs[0][3] != st[3]).sum()) > 0
    from opm_tpu_torch.sim.init import initial_state
    s0 = sims[0]
    m = s0.model
    state = initial_state(s0.grid, s0.props, s0.case, nw)
    state = state._replace(bhp=st[4], qs=st[5])
    n0 = k9.update_cuda.launches
    update_state(m, state, t(du_c[:, :m.nc]), 0.9, du_w=dw)
    assert k9.update_cuda.launches == n0 + 1


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_k9_convergence_row(dev, sims, masked):
    """K9's convergence row on 50,001 seeded cells (several blocks, each
    thread over several cells) against its plain version on the card:
    within 1e-12 relative (summation order) with the flags equal, on a
    seeded residual, with a NaN cell (finite cleared in both) and with no
    wells (both well norms 0); ten launches in a row give the same bits
    (the last block resets its ticket); BlackoilModel.convergence is one
    launch."""
    from opm_tpu_torch.models.blackoil import Residual
    from opm_tpu_torch.solver import kernels_k9 as k9
    rng = np.random.default_rng(31)
    nc, nw = 50001, 5

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    pv = t(rng.uniform(50.0, 500.0, nc))
    R = t(rng.standard_normal((3, nc))) * pv * 1e-6
    b = t(rng.uniform(0.5, 2.0, (3, nc)))
    mask = t((rng.random(nc) > 0.3).astype(np.float64)) if masked else None
    wf, wc = t(rng.standard_normal((nw, 3)) * 1e-4), t(
        rng.standard_normal(nw) * 1e3)
    ctrl = t(np.array([0, 2, 0, 3, 2], np.int32))
    tgt = t(rng.uniform(1e-3, 1e-2, nw))
    tols = k9.Tols(1e-5, 1e-2, 1e-4, 1e7)
    ws = k9.Workspace(nc, dev)
    # a model on "cuda" (no index) gets a workspace on the tensors' device
    assert k9.Workspace(7, "cuda").device == dev
    Rn = R.clone()
    Rn[2, nc // 3] = float("nan")
    fn = k9.convergence_masked_cuda if masked else k9.convergence_cuda
    mk = (mask,) if masked else ()
    for RR, n in ((R, nw), (Rn, nw), (R, 0)):
        a = (RR, b, pv, 3600.0, *mk, wf[:n], wc[:n], ctrl[:n], tgt[:n],
             tols)
        n0 = fn.launches
        rows = [fn(ws, *a) for _ in range(10)]
        assert fn.launches == n0 + 10
        # bit for bit, NaN included
        assert all(torch.equal(r.view(torch.int64), rows[0].view(torch.int64))
                   for r in rows[1:])
        kr = rows[0]
        pr = k9.convergence_plain(RR, b, pv, 3600.0, mask, wf[:n], wc[:n],
                                  ctrl[:n], tgt[:n], tols)
        assert torch.equal(kr[8:], pr[8:])
        assert torch.equal(torch.isnan(kr), torch.isnan(pr))
        ok = ~torch.isnan(pr)
        assert _rel(kr[ok], pr[ok]) <= 1e-12
        if RR is Rn:
            assert float(kr[8]) == 0.0
        if n == 0:
            assert float(kr[6]) == 0.0 and float(kr[7]) == 0.0
    m = sims[0].model
    rng2 = np.random.default_rng(32)
    res = Residual(cell=t(rng2.standard_normal((3, m.nc))) * m.pv * 1e-6,
                   well_flux=wf, well_ctrl=wc,
                   b=t(rng2.uniform(0.5, 2.0, (3, m.nc))))
    from opm_tpu_torch.sim.init import initial_state
    s0 = sims[0]
    state = initial_state(s0.grid, s0.props, s0.case, nw)._replace(
        control=ctrl, target=tgt)
    n0 = k9.convergence_cuda.launches
    conv = m.convergence(res, 3600.0, state)
    assert k9.convergence_cuda.launches == n0 + 1
    assert conv["mb"].data_ptr() == conv["row"].data_ptr()


@pytest.mark.parametrize("grid", ["structured", "embedded", "gather"])
def test_vcycle_from_weighted_residual(dev, grid):
    """The V-cycle from the CPR apply's weights and cell residual (the down
    leg's right-hand side entry: K6's weighted residual folded into K7's
    down leg behind a grid barrier, or into K10's first phase) equals the
    plain weighted residual (pressure_rhs_plain on the card) followed by
    the legs, bit for bit, on the toy SPE10-like deck (structured GMG) and
    the toy Norne-like deck (embedded: GMG; gather: AMG), ten times in a
    row; one V-cycle launches the entry in place of the b entry, so a CPR
    apply is two launches (its counters: no b entry)."""
    from opm_tpu_torch.linalg import amg as k10
    from opm_tpu_torch.linalg import gmg as k7
    from opm_tpu_torch.linalg import precond as k6

    if grid == "structured":
        sim, sys = _spe10_toy_system(dev)
    else:
        sim, _, sys = _norne_toy_system(dev, None if grid == "embedded"
                                        else "0")
    m, amg = sim.model, sim.solver.amg
    dims = None if m.op_dims is None else tuple(m.op_dims)
    mod = k10 if isinstance(amg, k10.DeviceAmg) else k7
    assert (mod is k10) == (grid == "gather")
    _, w, diag_p, off = k6.cpr_setup(sys, dims, amg)
    vals = amg.coarsen_values(diag_p, off)
    rc = torch.as_tensor(np.random.default_rng(41).standard_normal(
        (3, m.nc)), device=dev)

    def counts():
        return (mod.vcycle_down_cuda.launches,
                mod.vcycle_down_rhs_cuda.launches,
                mod.vcycle_up_cuda.launches)

    pair = amg.vcycle(vals, k6.pressure_rhs_plain(w, rc)).clone()
    n0 = counts()
    fused = amg.vcycle(vals, None, w=w, rc=rc).clone()
    assert tuple(a - c for a, c in zip(counts(), n0)) == (0, 1, 1)
    assert torch.equal(fused, pair)
    _no_allocation(lambda: amg.vcycle(vals, None, w=w, rc=rc), fused)
    M = k6.make_cpr_cells(sys, amg, dims)
    n0 = counts()
    M(rc)
    assert tuple(a - c for a, c in zip(counts(), n0)) == (0, 1, 1)


# K1's EQUIL column march (csrc/equil.cu): SPE1 (live oil, RSVD), SPE1
# with PBVD in place of RSVD (the same bubble point, 4014.7 psia), dead oil
# with no DISGAS and no gas (SPE1CASE2_2P), the toy SPE10-like deck, and
# SPE3 (wet gas under VAPOIL: rho_g at rv_sat; RVVD, and PDVD in its place)
def _equil_deck(name):
    from opm_tpu_torch.io.eclstate import load_case, load_case_string
    from opm_tpu_torch.sim.testcases import (norne_like_case, spe1_pbvd_deck,
                                             spe3_pdvd_deck, spe10like_case)
    if name in ("spe3", "spe3_pdvd"):
        with open(os.path.join(ROOT, "data", "SPE3.DATA")) as f:
            text = f.read()
        return load_case_string(text if name == "spe3"
                                else spe3_pdvd_deck(text))
    if name == "spe10_toy":
        return spe10like_case(nx=15, ny=44, nz=4, tsteps="3*1")
    if name == "norne_toy":
        return norne_like_case(nx=12, ny=24, nz=22, tsteps="1")
    if name in ("spe1_2p", "spe9"):
        return load_case(os.path.join(
            ROOT, "data", "SPE1CASE2_2P.DATA" if name == "spe1_2p"
            else "SPE9.DATA"))
    with open(SPE1) as f:
        text = f.read()
    return load_case_string(text if name == "spe1" else spe1_pbvd_deck(text))


@pytest.mark.parametrize("deck", ["spe1", "spe1_pbvd", "spe1_2p",
                                  "spe10_toy", "spe3", "spe3_pdvd"])
def test_equil_march_matches_twin(dev, deck, monkeypatch):
    """The kernel's columns bit for bit the twin's on the card, the call
    making no host read; one march and at most 7 K1 lookups a region in
    initial_state, whose state is bit for bit the one through the twin."""
    from opm_tpu_torch.sim import init
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.utils import tables as k1
    sim = SimulatorFullyImplicitBlackoil(_equil_deck(deck), device=dev)
    regions = init.equil_regions(sim.grid, sim.case)
    assert len(regions) == 1
    for rec, cells, vd in regions:
        args = init.march_args(sim.grid, sim.props, rec, cells, **vd)
        init.equil_columns_cuda(*args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            cols = init.equil_columns_cuda(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        twin = init.equil_columns_plain(*args)
        assert cols.shape == (3, init._NZ)
        assert torch.equal(cols, twin)
    counted = (k1.interp1_cuda, k1.interp2_cuda, init.equil_columns_cuda)
    before = [f.launches for f in counted]
    st = init.initial_state(sim.grid, sim.props, sim.case,
                            len(sim.well_names))
    n = [f.launches - b for f, b in zip(counted, before)]
    assert n[2] == len(regions)
    assert n[0] + n[1] <= 7 * len(regions)
    monkeypatch.setattr(init, "equil_columns_cuda", init.equil_columns_plain)
    st_twin = init.initial_state(sim.grid, sim.props, sim.case,
                                 len(sim.well_names))
    for f in ("pressure", "sw", "x", "hcstate"):
        assert torch.equal(getattr(st, f), getattr(st_twin, f)), f


# EQUIL's cell pass (csrc/equil.cu): on the EQUIL decks above, the toy
# Norne-like deck (capillary pressure in SWOF and SGOF: both inversions)
# and SPE9 (an RSVD column and both inversions), written into arrays of
# NaN: the region's cells bit for bit the twin's, every other cell left
# alone, the call making no host read; initial_state makes one march and
# one cell pass a region and no K1 lookup, and its state is bit for bit
# the one through the cell pass's twin
@pytest.mark.parametrize("deck", ["spe1", "spe1_pbvd", "spe1_2p",
                                  "spe10_toy", "norne_toy", "spe9", "spe3",
                                  "spe3_pdvd"])
def test_equil_cells_match_twin(dev, deck, monkeypatch):
    from opm_tpu_torch.sim import init
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.utils import tables as k1
    sim = SimulatorFullyImplicitBlackoil(_equil_deck(deck), device=dev)
    grid = sim.grid
    regions = init.equil_regions(grid, sim.case)
    cd = init.equil_cell_data(grid, dev)
    nan = float("nan")
    for rec, cells, vd in regions:
        args = init.march_args(grid, sim.props, rec, cells, **vd)
        cols = init.equil_columns_cuda(*args)
        ti = torch.as_tensor(cells, dtype=torch.int32, device=dev)
        kout = torch.full((5, grid.nc), nan, dtype=torch.float64, device=dev)
        pout = kout.clone()
        init.equil_cells_cuda(args, cols, ti, cd, kout.clone())
        torch.cuda.synchronize()
        n0 = init.equil_cells_cuda.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            init.equil_cells_cuda(args, cols, ti, cd, kout)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert init.equil_cells_cuda.launches == n0 + 1
        init.equil_cells_plain(args, cols, ti, cd, pout)
        idx = ti.long()
        assert torch.equal(kout[:, idx], pout[:, idx])
        rest = torch.ones(grid.nc, dtype=torch.bool, device=dev)
        rest[idx] = False
        assert bool(torch.isnan(kout[:, rest]).all())
    counted = (k1.interp1_cuda, k1.interp2_cuda, init.equil_columns_cuda,
               init.equil_cells_cuda)
    before = [f.launches for f in counted]
    st = init.initial_state(grid, sim.props, sim.case, len(sim.well_names))
    n = [f.launches - b for f, b in zip(counted, before)]
    assert n == [0, 0, len(regions), len(regions)]
    monkeypatch.setattr(init, "equil_cells_cuda", init.equil_cells_plain)
    st_twin = init.initial_state(grid, sim.props, sim.case,
                                 len(sim.well_names))
    for f in ("pressure", "sw", "x", "hcstate"):
        assert torch.equal(getattr(st, f), getattr(st_twin, f)), f


# K2's three entries and K9's update with SPE3's tables: PVTG's gas over
# (pg, drv = max(rv_sat(pg) - rv, 0)), rv = rv_sat(p) under VAPOIL, and
# K9's rv_sat at the old and the new pressure with cells switching GASOIL
# <-> GASONLY
def _spe3_props(dev):
    from opm_tpu_torch.io.eclstate import load_case
    from opm_tpu_torch.props.blackoil import BlackoilProps
    return BlackoilProps.from_case(load_case(os.path.join(
        ROOT, "data", "SPE3.DATA")), dev)


def test_k2_entries_with_wet_gas(dev):
    """Values and the assembly's face inputs and r_cell bit for bit, the
    tangent columns and the diag within 1e-12 of each row's max, at 20,000
    seeded cells in all three states (every tenth GASONLY cell at drv =
    0, pressures past both ends of PVTG)."""
    from opm_tpu_torch.models import blackoil as mb
    props = _spe3_props(dev)
    pack = props.cell_pack()
    n = 20000
    rng = np.random.default_rng(31)
    hc = rng.integers(0, 3, n).astype(np.int32)
    p = rng.uniform(2e6, 2.8e7, n)
    rvs = props.rv_sat(torch.as_tensor(p, device=dev), 0).cpu().numpy()
    rv = np.where(np.arange(n) % 10 == 0, rvs, rvs * rng.uniform(0.3, 1, n))
    x = np.where(hc == 0, rng.uniform(0, 0.8, n),
                 np.where(hc == 1, rng.uniform(0, 50, n), rv))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    reg = torch.zeros(n, dtype=torch.int64, device=dev)
    a2 = (t(p), t(rng.uniform(0.16, 0.3, n)), t(x), t(hc), reg, reg)
    n0 = [f.launches for f in (mb.cells_values_cuda, mb.cells_columns_cuda,
                               mb.cells_assemble_cuda)]
    assert torch.equal(mb.cells_values_cuda(pack, *a2),
                       mb.cells_values_plain(props, *a2))

    def rows_close(a, b):
        a, b = a.reshape(-1, n), b.reshape(-1, n)
        return bool(((a - b).abs().amax(1)
                     <= 1e-12 * b.abs().amax(1)).all())
    assert rows_close(mb.cells_columns_cuda(pack, *a2),
                      mb.cells_columns_plain(props, *a2))
    a3 = a2 + (t(rng.uniform(0, 1, (3, n))), t(rng.uniform(1, 1e3, n)),
               86400.0)
    ka = mb.cells_assemble_cuda(pack, *a3)
    pa = mb.cells_assemble_plain(props, *a3)
    assert torch.equal(ka[0], pa[0]) and torch.equal(ka[2], pa[2])
    assert rows_close(ka[1], pa[1]) and rows_close(ka[3], pa[3])
    assert [f.launches - b for f, b in zip(
        (mb.cells_values_cuda, mb.cells_columns_cuda,
         mb.cells_assemble_cuda), n0)] == [1, 1, 1]


def test_k9_update_with_vapoil(dev):
    """K9's update bit for bit its twins' composition at 20,000 seeded
    GASOIL and GASONLY cells with increments that switch cells both ways,
    one launch a call."""
    from opm_tpu_torch.solver import kernels_k9 as k9
    props = _spe3_props(dev)
    n, nw = 20000, 2
    rng = np.random.default_rng(32)
    p = rng.uniform(1.2e7, 2.4e7, n)
    hc = np.where(rng.random(n) < 0.5, 0, 2).astype(np.int32)
    rvs = props.rv_sat(torch.as_tensor(p, device=dev), 0).cpu().numpy()
    x = np.where(hc == 0, 0.84 - rng.uniform(0, 1e-3, n),
                 np.where(rng.random(n) < 0.5, rvs, rvs * 0.99))
    du = np.stack([rng.uniform(-1e6, 2e6, n), np.zeros(n),
                   np.where(hc == 0, -rng.uniform(0, 2e-3, n),
                            rng.standard_normal(n) * 1e-8)])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    du_w = t(rng.standard_normal((nw, 4)))
    rv = k9.rv_table(props, None)
    assert rv is not None and k9.rs_table(props, None) is None
    a = (t(p), t(np.full(n, 0.16)), t(x), t(hc), t(rng.uniform(1e7, 2e7, nw)),
         t(rng.standard_normal((nw, 3))), t(du), du_w[:, 3], du_w[:, :3],
         0.9, k9.UpdateConsts(0.3, 0.2, 1e9, False, True), None, rv)
    n0 = k9.update_cuda.launches
    ku = k9.update_cuda(*a)
    assert k9.update_cuda.launches == n0 + 1
    for x_, y_ in zip(ku, k9.update_plain(*a)):
        if x_.dtype == torch.float64:
            x_, y_ = x_.view(torch.int64), y_.view(torch.int64)
        assert torch.equal(x_, y_)
    h0, h1 = a[3], ku[3]
    assert int(((h0 == 0) & (h1 == 2)).sum()) > 0
    assert int(((h0 == 2) & (h1 == 0)).sum()) > 0


def _k3_inputs(dev, dims, seed):
    """Seeded face inputs of a structured grid: both upwind directions
    in every phase, rs and rv cross terms."""
    from opm_tpu_torch.models.blackoil import _dir_segments
    rng = np.random.default_rng(seed)
    nc = dims[0] * dims[1] * dims[2]
    nf = sum(n for _, _, n in _dir_segments(dims))

    def t(*shape, scale=1.0, shift=0.0, pos=False):
        a = rng.standard_normal(shape)
        return torch.as_tensor(shift + scale * (np.abs(a) if pos else a),
                               device=dev)

    return (t(3, nc, scale=1e5, shift=2e7), t(3, nc, scale=100.0,
                                               shift=700.0),
            t(3, nc, pos=True), t(nc, scale=50.0, pos=True),
            t(nc, scale=1e-4, pos=True), t(nc, scale=10.0, shift=2500.0),
            t(nf, scale=1e-12, pos=True))


# K3's structured divergence (the tile march): bit for bit its twin at
# ragged shapes (one column or row, tiles cut at the grid's ends, runs of
# one plane, SPE1's and the toy SPE10-like deck's), one launch a call
@pytest.mark.parametrize("dims", [(1, 1, 1), (1, 9, 1), (9, 1, 1),
                                  (1, 1, 7), (10, 10, 3), (15, 44, 4),
                                  (33, 9, 7), (62, 15, 5), (31, 7, 13)],
                         ids=lambda d: "x".join(map(str, d)))
def test_tpfa_div_bitwise(dev, dims):
    from opm_tpu_torch.models import blackoil as mb
    a = _k3_inputs(dev, dims, sum(dims))
    n0 = mb.tpfa_div_cuda.launches
    kd = mb.tpfa_div_cuda(dims, *a, 9.80665)
    assert mb.tpfa_div_cuda.launches == n0 + 1
    assert torch.equal(kd, mb.tpfa_div_plain(dims, *a, 9.80665))


# K3-faces' face blocks (a face phase, then a row phase that also writes
# K4-faces' packed copy): bit for bit the twin (faces_blocks_packed_plain)
# on CPU copies of the same inputs (on the card its index_add_ adds in no
# fixed order), the copy, written into NaN, bit for bit faces_pack_plain
# of the blocks, on the toy Norne-like deck in both representations (the
# embedded grid's in-place epilogue over the touched rows, the gather
# grid's every cell) and on seeded face lists with rows of uneven length;
# one wrapper launch a call
@pytest.mark.parametrize("case", ["toy_embedded", "toy_gather",
                                  "seeded_gather", "seeded_epilogue"])
def test_faces_blocks_bitwise(dev, case):
    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.models import linearize as lz
    rng = np.random.default_rng(23)
    if case.startswith("toy"):
        sim, st, _ = _norne_toy_system(dev, None if case == "toy_embedded"
                                       else "0")
        m = sim.model
        st = st._replace(pressure=st.pressure + torch.as_tensor(
            rng.standard_normal(m.nc) * 2.0e4, device=dev))
        fv, fc, r0, d0 = mb.cells_assemble_plain(
            m.props, st.pressure, st.sw, st.x, st.hcstate, m.pvtnum,
            m.satnum, m.accumulation(st) * 0.999, m.pv, 86400.0)
        face_cells, nc, first = sim.grid.face_cells, m.nc, m.faces.first
        depth, trans, g = m.depth, m.trans, m.gravity
    else:
        nc, n = 3000, 9000
        first = 0 if case == "seeded_gather" else 400
        fcs = rng.integers(0, nc, (2 * n, 2))
        fcs = fcs[fcs[:, 0] != fcs[:, 1]][:n]
        face_cells = np.concatenate([np.tile([[0, 1]], (first, 1)), fcs])
        fv, fc, r0, d0, depth = (
            torch.as_tensor(rng.standard_normal(s), device=dev)
            for s in ((11, nc), (3, 11, nc), (3, nc), (9, nc), (nc,)))
        fv[:3] = 2e7 + 1e5 * fv[:3]
        fv[3:6] = 700.0 + 100.0 * fv[3:6]
        fv[6:] = fv[6:].abs()
        depth = 2500.0 + 10.0 * depth
        trans = torch.as_tensor(np.abs(rng.standard_normal(len(face_cells)))
                                * 1e-12, device=dev)
        g = 9.80665
    fl = mb.FaceList(face_cells, nc, first, dev)
    fl_cpu = mb.FaceList(face_cells, nc, first, "cpu")
    nf = trans.shape[0]

    def run(fn, lead, on):
        r, d = r0.to(on).clone(), d0.to(on).clone()
        fL = torch.zeros((9, nf), dtype=torch.float64, device=on)
        fR = torch.zeros_like(fL)
        blk = fn(lead, fv.to(on), fc.to(on), depth.to(on), trans.to(on), g,
                 r, d, fL, fR)
        return [x.cpu() for x in (r, d, fL, fR, blk)]

    # the packed copy the row phase writes into a buffer of NaN: every
    # slot written (the pads with 0), bit for bit the pack's
    empty = torch.empty

    def nan_empty(*a, **k):
        return empty(*a, **k).fill_(float("nan"))

    n0 = lz.faces_blocks_cuda.launches
    torch.empty = nan_empty
    try:
        k = run(lz.faces_blocks_cuda, fl, dev)
    finally:
        torch.empty = empty
    assert lz.faces_blocks_cuda.launches == n0 + 1
    assert k[4].shape == (288 * fl.sell.n_chunks,)
    assert torch.equal(k[4], lz.faces_pack_plain(fl_cpu.sell, k[2], k[3]))
    for x, y in zip(k, run(lz.faces_blocks_packed_plain, fl_cpu, "cpu")):
        assert torch.equal(x, y)


# K3's tangent entry (the whole grid a block on small grids, the tile
# march with a block per tangent set otherwise): bit for bit its twin, at
# SPE1's jacfwd batch B = 3 nc + 4 nw = 908 with seeded and all-ones
# tangents, and at ragged march shapes; one launch a call
@pytest.mark.parametrize("dims,B,tangents", [
    ((10, 10, 3), 908, "seeded"), ((10, 10, 3), 908, "ones"),
    ((1, 1, 1), 1, "seeded"), ((7, 1, 1), 7, "seeded"),
    ((1, 1, 21), 5, "seeded"), ((15, 44, 4), 3, "seeded"),
    ((33, 9, 7), 2, "seeded"), ((1, 1, 30), 1, "seeded"),
    ((62, 15, 5), 3, "seeded")],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_tpfa_div_tangent_bitwise(dev, dims, B, tangents):
    from opm_tpu_torch.models import blackoil as mb
    a = _k3_inputs(dev, dims, B + sum(dims))
    rng = np.random.default_rng(B)
    if tangents == "ones":
        tan = [torch.ones((B,) + x.shape, dtype=torch.float64, device=dev)
               for x in a[:5]]
    else:
        tan = [torch.as_tensor(rng.standard_normal((B,) + x.shape),
                               device=dev) * x.abs().mean() for x in a[:5]]
    n0 = mb.tpfa_div_tangent_cuda.launches
    kt = mb.tpfa_div_tangent_cuda(dims, *a, 9.80665, *tan)
    assert mb.tpfa_div_tangent_cuda.launches == n0 + 1
    assert torch.equal(kt, mb.tpfa_div_tangent_plain(dims, *a, 9.80665,
                                                     *tan))


# K3-faces' divergence: bit for bit the twin on CPU copies of the same
# inputs (on the card its index_add_ adds in no fixed order), on the toy
# Norne-like deck in both representations (the embedded grid's in-place
# epilogue over the touched rows after the stencil's tpfa_div, the gather
# grid's every cell) and on seeded face lists; one launch a call
@pytest.mark.parametrize("case", ["toy_embedded", "toy_gather",
                                  "seeded_gather", "seeded_epilogue"])
def test_faces_div_bitwise(dev, case):
    from opm_tpu_torch.models import blackoil as mb
    rng = np.random.default_rng(29)
    if case.startswith("toy"):
        sim, st, _ = _norne_toy_system(dev, None if case == "toy_embedded"
                                       else "0")
        m = sim.model
        st = st._replace(pressure=st.pressure + torch.as_tensor(
            rng.standard_normal(m.nc) * 2.0e4, device=dev))
        q = m.cell_quantities(st)
        args = (torch.stack([q.pw, q.po, q.pg]).contiguous(),
                q.rho.contiguous(), (q.b * q.mob).contiguous(),
                q.rs.contiguous(), q.rv.contiguous(), m.depth, m.trans,
                m.gravity)
        face_cells, nc, first = sim.grid.face_cells, m.nc, m.faces.first
        base = None if m.op_dims is None else mb.tpfa_div_cuda(
            m.op_dims, *args[:6], m.trans_stencil, m.gravity)
    else:
        nc, n = 3000, 9000
        first = 0 if case == "seeded_gather" else 400
        fcs = rng.integers(0, nc, (2 * n, 2))
        fcs = fcs[fcs[:, 0] != fcs[:, 1]][:n]
        face_cells = np.concatenate([np.tile([[0, 1]], (first, 1)), fcs])
        args = _k3_inputs(dev, (nc, 1, 1), 31)[:6] + (torch.as_tensor(
            np.abs(rng.standard_normal(len(face_cells))) * 1e-12,
            device=dev), 9.80665)
        base = None if first == 0 else torch.as_tensor(
            rng.standard_normal((3, nc)), device=dev)
    fl = mb.FaceList(face_cells, nc, first, dev)
    fl_cpu = mb.FaceList(face_cells, nc, first, "cpu")
    cpu = [x.cpu() if torch.is_tensor(x) else x for x in args]
    twin = mb.faces_div_plain(fl_cpu, *cpu,
                              out=None if base is None else base.cpu())
    n0 = mb.faces_div_cuda.launches
    kd = mb.faces_div_cuda(fl, *args,
                           out=None if base is None else base.clone())
    assert mb.faces_div_cuda.launches == n0 + 1
    assert torch.equal(kd.cpu(), twin)


def _poison_refresh(damg, R):
    """NaN into every value the refresh with K6 as its first phases writes
    (the padding slots, which no refresh writes, keep their zeros)."""
    nan = float("nan")
    for t in (*R.setup.tensors(), *R.diag):
        t.fill_(nan)
    R.ell[0].view(-1)[damg.ell[0]["src"] >= 0] = nan
    for k, lv in enumerate(damg.levels):
        R.ell[k + 1].view(-1)[lv["ent_dst"].long()] = nan
    if R.dense is not None:
        R.dense.fill_(nan)
        R.inv.fill_(nan)


@pytest.mark.parametrize("case", ["toy_gather", "seeded"])
def test_k6_refresh_setup_bitwise(dev, case):
    """K6 on a face list as the first phases of K10's refresh launch, into
    the hierarchy's buffers filled with NaN beforehand: its outputs bit
    for bit the twin (``cpr_setup_plain``) and the former pair of kernels
    (the cell part, then K6-faces), its levels, dense matrix and inverse
    bit for bit the refresh's plain version from the twin's diag_p and
    off; ``cpr_setup`` on the card the same launch into the same buffers;
    no allocator request."""
    from opm_tpu_torch.linalg import amg as k10
    from opm_tpu_torch.linalg import precond as k6
    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.models import linearize
    rng = np.random.default_rng(37)
    if case == "toy_gather":
        sim, _, sys = _norne_toy_system(dev, "0")
        fl, ops = sys.faces, (sys.diag, sys.face_L, sys.face_R)
        damg = sim.solver.amg
    else:
        nc, n = 3000, 9000
        fcs = rng.integers(1, nc, (2 * n, 2))
        fcs = fcs[fcs[:, 0] != fcs[:, 1]][:n]
        fl = mb.FaceList(fcs, nc, 0, dev)
        damg = k10.build_hierarchy(nc, fcs, np.abs(rng.standard_normal(
            len(fcs)))).device(dev)
        diag = rng.standard_normal((9, nc))
        diag[[0, 4, 8]] += 4.0
        ops = tuple(torch.as_tensor(a, device=dev) for a in (
            diag, rng.standard_normal((9, len(fcs))),
            rng.standard_normal((9, len(fcs)))))
        sys = linearize.BlockSystem(None, None, *ops, None, None, None, None,
                                    None, fl)
    twin = k6.cpr_setup_plain(*ops, None, fl)
    cells = k6.cpr_setup_cells_cuda(ops[0])
    pair = (*cells, k6.cpr_faces_cuda(fl, cells[1], ops[1], ops[2]))
    for a, b in zip(pair, twin):
        assert torch.equal(a, b)
    R = damg.card_refresh(dev)
    Rp = k10.Refresh(damg, dev)
    k10.refresh_plain(Rp, twin[2], twin[3])
    _poison_refresh(damg, R)
    n0 = k10.refresh_setup_cuda.launches
    dinv, w, vals = k6.cpr_setup_refresh_cuda(damg, fl, *ops)
    assert k10.refresh_setup_cuda.launches == n0 + 1 and vals is R.vals
    assert dinv is R.setup.dinv and w is R.setup.w
    for a, b in zip(R.setup.tensors(), twin):
        assert torch.equal(a, b)
    for k in range(damg.n_levels):
        for a, b in zip(vals[k], Rp.vals[k]):
            assert torch.equal(a, b), k
    if R.dense is not None:
        assert torch.equal(R.dense, Rp.dense)
        assert torch.equal(vals[-1], torch.linalg.inv(R.dense))
    _poison_refresh(damg, R)
    got = k6.cpr_setup(sys, None, damg)
    assert k10.refresh_setup_cuda.launches == n0 + 2
    assert [t.data_ptr() for t in got] == [t.data_ptr()
                                           for t in R.setup.tensors()]
    for a, b in zip(got, twin):
        assert torch.equal(a, b)
    gc.collect()
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(5):
        k10.refresh_setup_cuda(R, fl, *ops)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == a0
    if damg is None:
        return
    # the refresh form against the refresh's plain version from the twin
    R = damg.card_refresh(dev)
    Rp = k10.Refresh(damg, dev)
    k10.refresh_plain(Rp, twin[2], twin[3])
    n0 = k10.refresh_setup_cuda.launches
    dinv, w, vals = k6.cpr_setup_refresh_cuda(damg, fl, *ops)
    assert k10.refresh_setup_cuda.launches == n0 + 1 and vals is R.vals
    for a, b in zip((dinv, w, R.setup.diag_p, R.setup.off), twin):
        assert torch.equal(a, b)
    for k in range(damg.n_levels):
        for a, b in zip(vals[k], Rp.vals[k]):
            assert torch.equal(a, b), k
    if R.dense is not None:
        assert torch.equal(R.dense, Rp.dense)
        assert torch.equal(vals[-1], torch.linalg.inv(R.dense))
    a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(5):
        k10.refresh_setup_cuda(R, fl, *ops)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == a0


def _ties(dphi, seed):
    """THPRES thresholds for faces with per-phase potentials dphi (3, nf)
    on the CPU: a third 0, a third above every phase's |dphi|, the rest
    exactly one phase's |dphi| (the clip's tie)."""
    rng = np.random.default_rng(seed)
    a = dphi.abs()
    nf = a.shape[1]
    kind = torch.as_tensor(rng.integers(0, 3, nf))
    pick = torch.as_tensor(rng.integers(0, 3, nf))
    tie = a[pick, torch.arange(nf)]
    return torch.where(kind == 1, 1.5 * a.amax(dim=0) + 1.0,
                       torch.where(kind == 2, tie, 0.0))


def _dphi_list(p3, rho, depth, c1, c2, g):
    """The faces' potentials (3, nf) as the twins compute them."""
    return (p3[:, c1] - p3[:, c2]) - 0.5 * (rho[:, c1] + rho[:, c2]) * g * (
        depth[c1] - depth[c2])


def _stencil_cells(dims):
    from opm_tpu_torch.models.blackoil import _dir_segments
    nx, ny, nz = dims
    idx = np.arange(nx * ny * nz).reshape(nz, ny, nx)
    c1, c2 = [], []
    for slL, slR, _ in _dir_segments(dims):
        c1.append(idx[slL].ravel())
        c2.append(idx[slR].ravel())
    return (torch.as_tensor(np.concatenate(c1)),
            torch.as_tensor(np.concatenate(c2)))


# K3's five entries with a THPRES threshold (a third of the faces at 0, a
# third above |dphi|, the rest exactly at one phase's |dphi| as the twin
# computes it on a CPU copy): bit for bit their twins on the card (the
# face-list entries on CPU copies), one launch a call
@pytest.mark.parametrize("dims", [(10, 10, 3), (15, 44, 4), (33, 9, 7)],
                         ids=lambda d: "x".join(map(str, d)))
def test_k3_threshold_entries_bitwise(dev, dims):
    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.models import linearize as lz
    a = _k3_inputs(dev, dims, sum(dims) + 1)
    p3, rho, bmob, rs, rv, depth, trans = a
    g = 9.80665
    c1, c2 = _stencil_cells(dims)
    cpu = [x.cpu() for x in a]
    thr = _ties(_dphi_list(cpu[0], cpu[1], cpu[5], c1, c2, g),
                sum(dims)).to(dev)
    assert bool((thr > 0).any()) and bool((thr == 0).any())
    n0 = mb.tpfa_div_cuda.launches
    kd = mb.tpfa_div_cuda(dims, *a, g, thr=thr)
    assert mb.tpfa_div_cuda.launches == n0 + 1
    assert torch.equal(kd, mb.tpfa_div_plain(dims, *a, g, thr=thr))
    assert not torch.equal(kd, mb.tpfa_div_plain(dims, *a, g))
    # the tangent entry, both geometries' shapes
    nc = rs.shape[0]
    rng = np.random.default_rng(3)
    B = 5
    tans = [torch.as_tensor(rng.standard_normal((B,) + s), device=dev)
            for s in ((3, nc), (3, nc), (3, nc), (nc,), (nc,))]
    kt = mb.tpfa_div_tangent_cuda(dims, *a, g, *tans, thr=thr)
    assert torch.equal(kt, mb.tpfa_div_tangent_plain(dims, *a, g, *tans,
                                                     thr=thr))
    # the stencil face blocks
    nf = trans.shape[0]
    fv = torch.cat([p3, rho, bmob, rs[None], rv[None]])
    fc = torch.as_tensor(rng.standard_normal((3, 11, nc)), device=dev)
    r0 = torch.as_tensor(rng.standard_normal((3, nc)), device=dev)
    d0 = torch.as_tensor(rng.standard_normal((9, nc)), device=dev)

    def blocks(fn):
        r, d = r0.clone(), d0.clone()
        fL = torch.zeros((9, nf), dtype=torch.float64, device=dev)
        fR = torch.zeros_like(fL)
        fn(dims, fv, fc, depth, trans, g, r, d, fL, fR, thr=thr)
        return r, d, fL, fR

    for x, y in zip(blocks(lz.face_blocks_cuda),
                    blocks(lz.face_blocks_plain)):
        assert torch.equal(x, y)
    # the face-list entries over the same faces as a list (a gather grid's
    # form), against the twins on CPU copies
    fcells = torch.stack([c1, c2], dim=1).numpy()
    fl = mb.FaceList(fcells, nc, 0, dev)
    fl_cpu = mb.FaceList(fcells, nc, 0, "cpu")
    kd = mb.faces_div_cuda(fl, *a, g, thr=thr)
    assert torch.equal(kd.cpu(), mb.faces_div_plain(fl_cpu, *cpu, g,
                                                    thr=thr.cpu()))

    def fblocks(fn, lead, on):
        r, d = r0.to(on).clone(), d0.to(on).clone()
        fL = torch.zeros((9, nf), dtype=torch.float64, device=on)
        fR = torch.zeros_like(fL)
        blk = fn(lead, fv.to(on), fc.to(on), depth.to(on), trans.to(on), g,
                 r, d, fL, fR, thr=thr.to(on))
        return [x.cpu() for x in (r, d, fL, fR, blk)]

    for x, y in zip(fblocks(lz.faces_blocks_cuda, fl, dev),
                    fblocks(lz.faces_blocks_packed_plain, fl_cpu, "cpu")):
        assert torch.equal(x, y)
