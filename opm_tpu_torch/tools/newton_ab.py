"""The Newton layer's update, convergence check and CPR apply on one card,
or the initial state: an A/B of two trees in turns.

    python3 -m opm_tpu_torch.tools.newton_ab --trees BASE,CHANGE
        [--order ABBA] [--part newton|initial_state|cpr_setup]
        [--out newton_ab.json]

One leg per letter of ``--order`` (A: the first tree, B: the second), each
in a process of its own that imports ``opm_tpu_torch`` from its tree and
builds that tree's kernels into its own ``build/``. A leg measures, at SPE10
model 2's size (the seeded SPE10-like deck, 60x220x85 = 1.122M cells) and
on the Norne-class field (``norne_like_case()``) in both representations
(embedded E, gather G), from the first Newton system of the first report
step:

* ``BlackoilModel.convergence`` on the residual there, and the Newton
  update as the CPR route calls it (``update_state`` on a seeded increment,
  omega 0.9): host time per call (synced host clock around 50 calls in a
  row), device time per call in a run of 50 (CUDA events), device kernels
  per call and their device time (torch.profiler), and a digest of the
  output (the update's bits compared across legs);
* the K9 kernels one by one at these shapes (the tree's own entries: in a
  tree with ``solver/kernels_triton.py`` its Triton launches, in one with
  ``solver/kernels_k9.py`` the CUDA update and convergence entries), and
  the weighted pressure residual of a CPR apply (K6 ``pressure_rhs`` then
  the V-cycle's down leg, or the down leg from (w, r)), each one wrapper
  call and per launch in a run of 50;
* one CPR apply (``make_cpr_cells``) on a seeded residual: device kernels
  per apply, host time per apply, device time per apply in a run of 50,
  and a digest of its result (bits compared across legs);
* on G, the aggregation AMG's per-Newton value refresh
  (``DeviceAmg.coarsen_values`` on the first Newton system's pressure
  values, and the refresh followed by the first V-cycle on its values,
  which in a tree before the hierarchy-owned buffers builds the V-cycle
  workspace): host time per call, device kernels, host-to-device copies
  and device time per call, the refresh's bound (``linalg/amg.py``
  ``refresh_bytes`` of the levels' sizes at 3.35 TB/s, computed with
  this tool's tree), and digests of every level's values and of the inverse;
* at SPE10-2 and on E, K7's value refresh (``StructuredGmg.coarsen_values``
  on the first Newton system's pressure values: the parent's plain torch
  composition, or the refresh launch into the hierarchy's buffers and the
  inverse; and one followed by the first V-cycle on its values): host time
  per call, device kernels, host-to-device copies and device time per
  call, digests of every level and of the inverse, in a tree with the
  kernel the kernel alone, and its bound (``linalg/gmg.py``
  ``refresh_bytes`` of the level dims at 3.35 TB/s, computed with this
  tool's tree);
* everywhere, the Schur elimination's per-Newton setup
  (``schur_eliminate_wells``: D^-1, the WellTerm and the right-hand side;
  the parent's plain ``inv4x4`` then K5's launch, or K5's launch forming
  D^-1): host time, device kernels and device time per call, digests of
  the right-hand side and of D^-1;
* the plain torch pieces of the parent's pressure-stage work on the card:
  K5's ``inv4x4`` everywhere, and at SPE10-2 and on E K7's dense coarsest
  matrix and its float32 inverse alone: host time per call and device
  kernels per call;
* at SPE10-2, E and G, report step 0 after a warm-up run of the same
  step: wall, the Newton loop's synced sections (``assembly``,
  ``cpr_setup``, ``krylov``, ``update``), the residual + convergence time,
  the counts and a digest of the state.

With ``--part initial_state`` a leg measures instead ``initial_state``
(EQUIL) on SPE1, SPE1 with PBVD in place of RSVD, SPE1CASE2_2P, SPE9,
SPE10 model 2's size and the Norne-class field in both representations:
the simulator's construction from the parsed deck (host clock), the
seconds per call over 5 calls in a row (synced host clock, each ended by
a synchronize), device kernels per call, their device time in all and by
kernel, and the device-to-host copies per call (torch.profiler, one call
after a warm one), the launches of K1's lookups, of its column march and
of the cell pass per call (the tree's counters, where it has them), and a
digest of the state (pressure, sw, x, hcstate); then, but for the two
SPE1 variants, the time from the parsed deck to the end of the first
report step (a fresh simulator, its ``run`` computing the initial state;
synced host clock) with that step's counts and a digest of its state.

With ``--part cpr_setup`` a leg measures instead the per-Newton CPR
setup on the first Newton system of the Norne-class field's first report
step in both representations (E: K6 on the stencil, then K7's refresh; G:
K6 on the face list, then K10's refresh): each form the tree has (the
main path's K6 (on G in a tree with the refresh form, that launch: K6
as the refresh's first phases); K6 and the refresh launch; with the
inverse as ``make_cpr_cells`` runs them; on G also K6's cell part then
K6-faces, alone, with the refresh and with the inverse, and K6 as the
refresh's first phases, with and without the inverse): one call and per call
in a run of 50 (CUDA events), host ms per call over 50 (synchronized at
the end) and per call over 20 not synchronized (the host's own time),
device kernels and their device time per call (torch.profiler), the
caching allocator's requests per call, and a digest of the outputs (dinv,
w, and diag_p and off or every level's values and the inverse).

Prints one JSON line per leg and the card's name and power limit; writes
everything to --out.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

SPE10 = dict(nx=60, ny=220, nz=85)
OMEGA = 0.9
RUN = 50
HBM_BYTES_S = 3.35e12    # NVIDIA H100 SXM data sheet


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def two_ways(fn, reps=20, run=RUN, run_reps=5):
    """(ms of one call, ms per call over ``run`` back-to-back calls):
    CUDA events, medians of ``reps`` and ``run_reps``."""
    import torch
    fn()
    torch.cuda.synchronize()
    one, many = [], []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        one.append(s.elapsed_time(e))
    for _ in range(run_reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(run):
            fn()
        e.record()
        e.synchronize()
        many.append(s.elapsed_time(e) / run)
    return statistics.median(one), statistics.median(many)


def host_per_call(fn, run=RUN, reps=5):
    """Host-clock ms per call of ``run`` calls in a row, ended by a
    synchronize; median of ``reps``."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(run):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / run)
    return statistics.median(times)


def enqueue_ms(fn, run=20, reps=5):
    """Host-clock ms per call of ``run`` calls in a row, not synchronized:
    the host's own time per call while the card runs behind (20 calls stay
    well inside the launch queue); median of ``reps``."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(run):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / run)
        torch.cuda.synchronize()
    return statistics.median(times)


def device_kernels(fn, reps=10):
    """{"launches": device kernels per call, "us": their device time per
    call, "kernels": {name: launches per call}, "kernel_us": {name: device
    us per call}, "copies_h2d", "copies_d2h": host-to-device and
    device-to-host copies per call} under torch.profiler (after a warm
    call); None where no device event was recorded (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    evs = [ev for ev in dev if not ev.name.startswith("Memcpy")]
    if not evs:
        return None
    by, us = {}, {}
    for ev in evs:
        name = ev.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].split("::")[-1][:40]
        by[name] = by.get(name, 0) + 1 / reps
        us[name] = us.get(name, 0.0) + ev.time_range.elapsed_us() / reps
    return dict(launches=len(evs) / reps,
                us=sum(ev.time_range.elapsed_us() for ev in evs) / reps,
                kernels=by, kernel_us=us, copies_h2d=sum(
                    "HtoD" in ev.name for ev in dev) / reps,
                copies_d2h=sum("DtoH" in ev.name for ev in dev) / reps)


def digest(*ts):
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(fn, host=True):
    one, run = two_ways(fn)
    out = dict(one_call_ms=one, run_ms=run, device=device_kernels(fn))
    if host:
        out["host_ms"] = host_per_call(fn)
    return out


def _has(mod):
    return importlib.util.find_spec(mod) is not None


def _first_newton(sim, st0):
    """The first Newton iterate of report step 0: (state, wd, acc0, dt,
    cdp)."""
    from opm_tpu_torch.models.blackoil import make_well_device_arrays
    from opm_tpu_torch.sim.blackoil import init_well_state, report_step_wells
    from opm_tpu_torch.solver.newton import connection_offsets

    ws = report_step_wells(sim.schedule.report_steps[0], sim.grid,
                           sim.well_names, sim.max_perf)
    wd = make_well_device_arrays(ws, sim.grid.gravity, sim.device)
    st = init_well_state(st0, ws, True)
    dt = float(sim.ts.p.initial_dt)
    return st, wd, sim.model.accumulation(st), dt, \
        connection_offsets(sim.model, st, wd)


def _update_fn(m, st, du_c, du_w):
    """The CPR route's update as the tree's newton.py calls it."""
    import torch

    from opm_tpu_torch.solver.update import update_state
    if _has("opm_tpu_torch.solver.kernels_k9"):
        return lambda: update_state(m, st, du_c, OMEGA, du_w=du_w)
    return lambda: update_state(m, st, OMEGA * torch.cat(
        [du_c[0], du_c[1], du_c[2], du_w[:, 3], du_w[:, :3].reshape(-1)]))


def _kernel_rows(m, st, res, dt, du_c, du_w, label):
    """The tree's K9 entries one by one at these shapes."""
    import torch
    prm, props = m.params, m.props
    out = {}
    if _has("opm_tpu_torch.solver.kernels_k9"):
        from opm_tpu_torch.solver import kernels_k9 as k9
        ws = m.k9_workspace()
        a = k9.conv_args(m, res, dt, st)
        out["convergence"] = measure(lambda: k9.convergence_row(ws, *a),
                                     host=False)
        ua = k9.update_args(m, st, du_c, du_w[:, 3], du_w[:, :3], OMEGA)
        out["update"] = measure(lambda: k9.update_cuda(*ua), host=False)
        return out
    from opm_tpu_torch.solver import kernels_triton as k9
    bq = res.b.contiguous()
    if m.conv_mask is None:
        out["conv_norms"] = measure(lambda: k9.conv_norms_triton(
            res.cell, bq, m.pv, dt), host=False)
    else:
        out["conv_norms_masked"] = measure(
            lambda: k9.conv_norms_masked_triton(res.cell, bq, m.pv, dt,
                                                m.conv_mask), host=False)
    if label != "spe10":
        return out
    dp = (OMEGA * du_c[0]).contiguous()
    out["update_pressure"] = measure(lambda: k9.update_pressure_triton(
        st.pressure, dp, prm.dp_max_rel), host=False)
    p1 = k9.update_pressure_triton(st.pressure, dp, prm.dp_max_rel)
    rs0 = props.rs_sat(st.pressure, m.pvtnum)
    rs1 = props.rs_sat(p1, m.pvtnum)
    zero = torch.zeros_like(p1)
    uargs = (st.sw, st.x, st.hcstate, (OMEGA * du_c[1]).contiguous(),
             (OMEGA * du_c[2]).contiguous(), rs0, rs1, zero, zero,
             prm.ds_max, prm.dr_max_rel, props.disgas, props.vapoil)
    out["update_cells"] = measure(lambda: k9.update_cells_triton(*uargs),
                                  host=False)
    out["rs_sat"] = measure(lambda: props.rs_sat(p1, m.pvtnum), host=False)
    return out


def _cpr_rows(sim, sys_, rc):
    """One CPR apply, and the weighted pressure residual with the V-cycle's
    down leg (the parent's pair, or the down leg from (w, r))."""
    import torch

    from opm_tpu_torch.linalg import precond as k6
    m, amg = sim.model, sim.solver.amg
    dims = m.op_dims
    M = k6.make_cpr_cells(sys_, amg, dims)
    out = dict(apply=measure(lambda: M(rc)), apply_digest=digest(M(rc)))
    # a copy: M's setup lives in the hierarchy's buffers, which the next
    # setup overwrites
    dinv, w, diag_p, off = [t.clone() for t in k6.cpr_setup(
        sys_, tuple(dims) if dims else None, amg)]
    vals = amg.coarsen_values(diag_p, off)
    mod = __import__("opm_tpu_torch.linalg." + (
        "gmg" if dims is not None else "amg"), fromlist=["x"])
    amg.vcycle(vals, k6.pressure_rhs_plain(w, rc))
    ws = vals.ws
    rp = k6.pressure_rhs_plain(w, rc)
    out["down_b"] = measure(lambda: mod.vcycle_down_cuda(ws, rp), host=False)
    if hasattr(mod, "vcycle_down_rhs_cuda"):
        out["down_rhs"] = measure(
            lambda: mod.vcycle_down_rhs_cuda(ws, w, rc), host=False)
        out["vcycle_digest"] = digest(amg.vcycle(vals, None, w=w, rc=rc))
    else:
        out["pressure_rhs"] = measure(lambda: k6.pressure_rhs_cuda(w, rc),
                                      host=False)

        def pair():
            mod.vcycle_down_cuda(ws, k6.pressure_rhs_cuda(w, rc))
        out["pressure_rhs_then_down"] = measure(pair, host=False)
        out["vcycle_digest"] = digest(amg.vcycle(
            vals, k6.pressure_rhs_cuda(w, rc)))
    torch.cuda.synchronize()
    return out


def _refresh_rows(sim, sys_, rc):
    """The aggregation AMG's value refresh on the first Newton system: one
    ``coarsen_values``, and one with the first V-cycle on its values."""
    import torch

    from opm_tpu_torch.linalg import precond as k6
    amg = sim.solver.amg
    _, w, diag_p, off = k6.cpr_setup(sys_, None, amg)
    vals = amg.coarsen_values(diag_p, off)
    nl = amg.n_levels
    out = dict(
        refresh=measure(lambda: amg.coarsen_values(diag_p, off)),
        refresh_vcycle=measure(lambda: amg.vcycle(
            amg.coarsen_values(diag_p, off), None, w=w, rc=rc)),
        levels_digest=digest(*[t for lv in vals[:nl] for t in lv]),
        inverse_digest=digest(vals[nl]) if len(vals) > nl else None,
        sizes=[int(e["cols"].shape[1]) for e in amg.ell],
        widths=[int(e["cols"].shape[0]) for e in amg.ell],
        entries=[int(e["slot"].numel()) for e in amg.ell])
    torch.cuda.synchronize()
    return out


def _plain_rows(sim, sys_):
    """The plain torch pieces of the parent's per-Newton pressure-stage
    work on the card: K5's well-block inverses (``inv4x4``), and on a
    structured hierarchy K7's dense coarsest matrix and float32 inverse."""
    from opm_tpu_torch.linalg import precond as k6
    m, amg = sim.model, sim.solver.amg
    out = dict(inv4x4=measure(lambda: k6.inv4x4(sys_.wd_diag)))
    if m.op_dims is None:
        return out
    _, _, diag_p, off = k6.cpr_setup(sys_, tuple(m.op_dims), amg)
    vals = amg.coarsen_values(diag_p, off)
    L = len(amg.levels)
    dc, oc = amg._coarsen_level(*vals[L - 1], amg.levels[-1].axis)
    A = amg._dense_coarsest(dc, oc)
    out.update(
        levels=L, coarsest_n=amg.coarsest_n,
        gmg_dense_coarsest=measure(lambda: amg._dense_coarsest(dc, oc)),
        gmg_invert_coarsest=measure(lambda: amg.invert_coarsest(A)))
    return out


def _k7_rows(sim, sys_, rc):
    """K7's per-Newton value refresh on the first Newton system: one
    ``coarsen_values`` (the parent's plain torch, or the refresh launch and
    the inverse), one followed by the first V-cycle on its values (the
    parent builds the V-cycle workspace there), digests of every level and
    of the inverse, the level dims for the bound, and in a tree with the
    refresh kernel that kernel alone."""
    import torch

    from opm_tpu_torch.linalg import gmg as k7
    from opm_tpu_torch.linalg import precond as k6
    amg = sim.solver.amg
    _, w, diag_p, off = k6.cpr_setup(sys_, tuple(sim.model.op_dims), amg)
    diag_p, off = diag_p.contiguous(), off.contiguous()
    vals = amg.coarsen_values(diag_p, off)
    out = dict(
        refresh=measure(lambda: amg.coarsen_values(diag_p, off)),
        refresh_vcycle=measure(lambda: amg.vcycle(
            amg.coarsen_values(diag_p, off), None, w=w, rc=rc)),
        levels_digest=digest(*[t for d3, offs in vals[:-1]
                               for t in (d3,) + sum(offs, ())]),
        inverse_digest=digest(vals[-1]),
        level_dims=[list(lv.dims) for lv in amg.levels],
        coarse_dims=list(amg.coarse_dims))
    if hasattr(k7, "refresh_cuda"):
        R = amg.refresh(off.device)
        out["kernel"] = measure(lambda: k7.refresh_cuda(R, diag_p, off),
                                host=False)
    torch.cuda.synchronize()
    return out


def _rhs_rows(sim, sys_):
    """The Schur elimination's per-Newton setup on the card (D^-1, the
    WellTerm and the right-hand side: the parent's plain inv4x4 then K5's
    launch, or K5's launch forming D^-1), with digests of the right-hand
    side and of D^-1."""
    from opm_tpu_torch.linalg import precond as k6
    from opm_tpu_torch.models import linearize as lz
    dims = sim.model.op_dims
    _, rhs, _ = lz.schur_eliminate_wells(sys_, dims)
    if hasattr(lz.schur_rhs_cuda, "inverses"):
        wt = lz.WellTerm(sys_)
        lz.schur_rhs_cuda(wt)
        dinv = wt.Dinv
    else:
        dinv = k6.inv4x4(sys_.wd_diag)
    return dict(schur_eliminate=measure(
        lambda: lz.schur_eliminate_wells(sys_, dims)),
        rhs_digest=digest(rhs), dinv_digest=digest(dinv))


def alloc_requests(fn, reps=10):
    """The caching allocator's requests per call of fn over ``reps`` warm
    calls (``allocation.all.allocated``: every request, one served from
    the cache too)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    a1 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    return (a1 - a0) / reps


def _setup_forms(sim, sys_):
    """--part cpr_setup: the forms of the per-Newton CPR setup this tree
    has on one Newton system, each a function returning the tensors to
    digest. ``k6``: the tree's K6 on the main path (``cpr_setup``);
    ``k6_refresh``: that and the value refresh launch (no inverse);
    ``pressure``: the main path's setup and refresh with the inverse (as
    ``make_cpr_cells`` runs them). On a gather grid also, where the tree
    has them: ``pair`` (K6's cell part, then K6-faces), alone, with the
    refresh launch (``pair_refresh``) and with the inverse too
    (``pair_refresh_inv``), and ``fused`` (K6 as the refresh's first
    phases; ``fused_inv`` with the inverse)."""
    from opm_tpu_torch.linalg import amg as k10
    from opm_tpu_torch.linalg import gmg as k7
    from opm_tpu_torch.linalg import precond as k6
    amg, dims = sim.solver.amg, sim.model.op_dims
    dims = tuple(dims) if dims is not None else None
    ops = (sys_.diag, sys_.face_L, sys_.face_R)
    fl = sys_.faces
    gather = dims is None
    R = amg.refresh if gather else amg.refresh(sys_.diag.device)
    kr = k10 if gather else k7

    def levels(vals):
        nl = len(vals) - 1
        if gather:
            return [t for lv in vals[:nl] for t in lv] + [vals[nl]]
        return [t for d3, offs in vals[:-1]
                for t in (d3,) + sum(offs, ())] + [vals[-1]]

    def k6_main():
        return list(k6.cpr_setup(sys_, dims, amg))

    def k6_refresh():
        dinv, w, dp, off = k6.cpr_setup(sys_, dims, amg)
        return [dinv, w] + levels(kr.refresh_cuda(R, dp, off))[:-1]

    def pressure():
        if hasattr(k6, "pressure_setup"):
            dinv, w, vals = k6.pressure_setup(sys_, dims, amg)
        else:
            dinv, w, dp, off = k6.cpr_setup(sys_, dims, amg)
            vals = amg.coarsen_values(dp, off)
        return [dinv, w] + levels(vals)

    forms = dict(k6=k6_main, k6_refresh=k6_refresh, pressure=pressure)
    if not gather:
        return forms

    def pair():
        dinv, w, dp = k6.cpr_setup_cells_cuda(ops[0])
        return [dinv, w, dp, k6.cpr_faces_cuda(fl, w, ops[1], ops[2])]

    def pair_refresh():
        dinv, w, dp, off = pair()
        return [dinv, w] + levels(k10.refresh_cuda(R, dp, off))[:-1]

    def pair_refresh_inv():
        t = pair_refresh()
        R.invert()
        return t + [R.vals[-1]]

    forms.update(pair=pair, pair_refresh=pair_refresh,
                 pair_refresh_inv=pair_refresh_inv)
    if hasattr(k10, "refresh_setup_cuda"):
        def fused():
            vals = k10.refresh_setup_cuda(R, fl, *ops)
            return [R.setup.dinv, R.setup.w] + levels(vals)[:-1]
        forms["fused"] = fused
        forms["fused_inv"] = lambda: (
            lambda d, w, v: [d, w] + levels(v))(
                *k6.cpr_setup_refresh_cuda(amg, fl, *ops))
    return forms


def _setup_leg(tree):
    """--part cpr_setup: one leg over E and G (module docstring)."""
    import torch
    sys.path.insert(0, tree)
    from opm_tpu_torch.models import linearize
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.sim.testcases import norne_like_case
    from opm_tpu_torch.utils import cuda_lib

    csrc = os.path.join(tree, "opm_tpu_torch", "csrc")
    cuda_lib.build_all(sorted(f[:-3] for f in os.listdir(csrc)
                              if f.endswith(".cu")))
    norne = norne_like_case()
    out = dict(tree=tree)
    for label, knob in (("norne_embedded", None), ("norne_gather", "0")):
        os.environ.pop("OPM_TPU_EMBED", None)
        if knob is not None:
            os.environ["OPM_TPU_EMBED"] = knob
        sim = SimulatorFullyImplicitBlackoil(norne)
        init = initial_state(sim.grid, sim.props, norne,
                             len(sim.well_names))
        st, wd, acc0, dt, cdp = _first_newton(sim, init)
        sys_ = linearize.assemble(sim.model, st, acc0, dt, wd, cdp)
        r = dict(nc=sim.model.nc, faces=int(sim.model.trans.shape[0]))
        for name, fn in _setup_forms(sim, sys_).items():
            row = measure(fn)
            row["enqueue_ms"] = enqueue_ms(fn)
            row["alloc_requests"] = alloc_requests(fn)
            row["digest"] = digest(*fn())
            r[name] = row
        torch.cuda.synchronize()
        out[label] = r
        del sim, init, st, sys_
        torch.cuda.empty_cache()
    os.environ.pop("OPM_TPU_EMBED", None)
    print(json.dumps(out), flush=True)


def _leg(tree):
    import numpy as np
    import torch
    sys.path.insert(0, tree)
    from opm_tpu_torch.models import linearize
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.sim.testcases import norne_like_case, spe10like_case
    from opm_tpu_torch.utils import cuda_lib

    csrc = os.path.join(tree, "opm_tpu_torch", "csrc")
    cuda_lib.build_all(sorted(f[:-3] for f in os.listdir(csrc)
                              if f.endswith(".cu")))
    out = dict(tree=tree, k9=("cuda" if _has(
        "opm_tpu_torch.solver.kernels_k9") else "triton"))

    def fresh(case, knob):
        os.environ.pop("OPM_TPU_EMBED", None)
        if knob is not None:
            os.environ["OPM_TPU_EMBED"] = knob
        sim = SimulatorFullyImplicitBlackoil(case)
        return sim, initial_state(sim.grid, sim.props, case,
                                  len(sim.well_names))

    norne = norne_like_case()
    for label, case, knob in (("spe10", spe10like_case(**SPE10), None),
                              ("norne_embedded", norne, None),
                              ("norne_gather", norne, "0")):
        sim, init = fresh(case, knob)
        m = sim.model
        st, wd, acc0, dt, cdp = _first_newton(sim, init)
        res = m.residual(st, acc0, dt, wd, cdp)
        rng = np.random.default_rng(3)
        nc, nw = m.nc, st.bhp.shape[0]
        du_c = torch.as_tensor(rng.standard_normal((3, nc))
                               * np.array([[2e6], [0.1], [0.05]]),
                               device=m.device)
        du_w = torch.as_tensor(rng.standard_normal((nw, 4))
                               * np.array([1e-3, 1e-3, 1e-3, 1e6]),
                               device=m.device)
        upd = _update_fn(m, st, du_c, du_w)
        new = upd()
        r = dict(nc=nc, nw=nw,
                 convergence=measure(lambda: m.convergence(res, dt, st)),
                 convergence_row=[float(v) for v in torch.cat([
                     torch.as_tensor(v, dtype=torch.float64,
                                     device=m.device).reshape(-1)
                     for k, v in m.convergence(res, dt, st).items()
                     if k in ("mb", "cnv", "well_flux", "well_ctrl",
                              "finite", "converged")]).cpu()],
                 update=measure(upd),
                 update_digest=digest(new.pressure, new.sw, new.x,
                                      new.hcstate, new.bhp, new.qs),
                 kernels=_kernel_rows(m, st, res, dt, du_c, du_w, label))
        sys_ = linearize.assemble(m, st, acc0, dt, wd, cdp)
        rc = torch.as_tensor(rng.standard_normal((3, nc)), device=m.device)
        r["cpr"] = _cpr_rows(sim, sys_, rc)
        r["plain"] = _plain_rows(sim, sys_)
        r["rhs"] = _rhs_rows(sim, sys_)
        if label == "norne_gather":
            r["refresh"] = _refresh_rows(sim, sys_, rc)
        else:
            r["k7_refresh"] = _k7_rows(sim, sys_, rc)
        del sys_, res, new
        # report step 0 after a warm-up run of it
        sim.run(init, report_step_limit=1)          # warm-up
        sim, init = fresh(case, knob)
        sim.solver.timing = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin = sim.run(init, report_step_limit=1)
        torch.cuda.synchronize()
        rep = sim.report
        r.update(wall_s=time.perf_counter() - t0,
                 state_digest=digest(fin.pressure, fin.sw, fin.x,
                                     fin.hcstate, fin.bhp, fin.qs),
                 sections_s=dict(sim.solver.timing),
                 residual_convergence_s=rep.assemble_time,
                 newtons=rep.newton_iterations,
                 linear=rep.linear_iterations, substeps=rep.substeps,
                 failed=rep.failed_substeps)
        out[label] = r
        del sim, init, st
        torch.cuda.empty_cache()
    os.environ.pop("OPM_TPU_EMBED", None)
    print(json.dumps(out), flush=True)


def _init_leg(tree):
    """--part initial_state: one leg over the decks (module docstring)."""
    import torch
    sys.path.insert(0, tree)
    from opm_tpu_torch.io.eclstate import load_case, load_case_string
    from opm_tpu_torch.sim import init
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.sim.testcases import (norne_like_case,
                                             spe1_pbvd_deck, spe10like_case)
    from opm_tpu_torch.utils import cuda_lib
    from opm_tpu_torch.utils import tables as k1

    csrc = os.path.join(tree, "opm_tpu_torch", "csrc")
    cuda_lib.build_all(sorted(f[:-3] for f in os.listdir(csrc)
                              if f.endswith(".cu")))
    names = ("interp1", "interp2", "equil_march", "equil_cells")
    counters = [k1.interp1_cuda, k1.interp2_cuda,
                getattr(init, "equil_columns_cuda", None),
                getattr(init, "equil_cells_cuda", None)]
    data = os.path.join(tree, "data")
    with open(os.path.join(data, "SPE1CASE2.DATA")) as f:
        spe1_text = f.read()
    norne = norne_like_case()
    out = dict(tree=tree)
    for label, case, knob in (
            ("spe1", load_case(os.path.join(data, "SPE1CASE2.DATA")), None),
            ("spe1_pbvd", load_case_string(spe1_pbvd_deck(spe1_text)),
             None),
            ("spe1_2p", load_case(os.path.join(data, "SPE1CASE2_2P.DATA")),
             None),
            ("spe9", load_case(os.path.join(data, "SPE9.DATA")), None),
            ("spe10", spe10like_case(**SPE10), None),
            ("norne_embedded", norne, None), ("norne_gather", norne, "0")):
        os.environ.pop("OPM_TPU_EMBED", None)
        if knob is not None:
            os.environ["OPM_TPU_EMBED"] = knob
        t0 = time.perf_counter()
        sim = SimulatorFullyImplicitBlackoil(case)
        construct = time.perf_counter() - t0

        def call():
            return init.initial_state(sim.grid, sim.props, case,
                                      len(sim.well_names))
        st = call()
        torch.cuda.synchronize()
        secs = []
        for _ in range(5):
            before = [f and f.launches for f in counters]
            t0 = time.perf_counter()
            st = call()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = [f and f.launches - b for f, b in zip(counters, before)]
        out[label] = dict(
            nc=sim.grid.nc, construct_s=construct, seconds=secs,
            median_s=statistics.median(secs),
            device=device_kernels(call, reps=1),
            regions=len(init.equil_regions(sim.grid, case)),
            k1_launches=dict(zip(names, launches)),
            state_digest=digest(st.pressure, st.sw, st.x, st.hcstate))
        del sim, st
        torch.cuda.empty_cache()
        if label in ("spe1_pbvd", "spe1_2p"):
            continue        # EQUIL variants: the initial state alone
        # the run_deck user's time: a fresh simulator from the parsed deck
        # through the first report step, initial_state included
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = SimulatorFullyImplicitBlackoil(case)
        fin = sim.run(report_step_limit=1)
        torch.cuda.synchronize()
        rep = sim.report
        out[label].update(
            deck_to_first_step_s=time.perf_counter() - t0,
            first_step=[rep.substeps, rep.newton_iterations,
                        rep.linear_iterations, rep.failed_substeps],
            first_step_digest=digest(fin.pressure, fin.sw, fin.x,
                                     fin.hcstate, fin.bhp, fin.qs))
        del sim, fin
        torch.cuda.empty_cache()
    os.environ.pop("OPM_TPU_EMBED", None)
    print(json.dumps(out), flush=True)


def _bound(r, k7=False):
    """A refresh's bytes and bound, from a leg's level sizes (the same for
    every tree; K10's, or with ``k7`` K7's)."""
    if not r:
        return
    if k7:
        from types import SimpleNamespace

        from opm_tpu_torch.linalg.gmg import refresh_bytes
        r["bytes"] = refresh_bytes(SimpleNamespace(
            dims=(r["level_dims"] or [r["coarse_dims"]])[0],
            levels=[SimpleNamespace(dims=d) for d in r["level_dims"]],
            coarse_dims=r["coarse_dims"]))
    else:
        from opm_tpu_torch.linalg.amg import refresh_bytes
        r["bytes"] = refresh_bytes(r["sizes"], r["widths"], r["entries"])
    r["bound_ms"] = r["bytes"] / HBM_BYTES_S * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trees",
                    help="BASE,CHANGE: two repository roots (or one)")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default=None)
    ap.add_argument("--part", default="newton",
                    choices=("newton", "initial_state", "cpr_setup"))
    ap.add_argument("--leg", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("newton_ab: no CUDA device visible")
    if args.leg:
        dict(initial_state=_init_leg, cpr_setup=_setup_leg).get(
            args.part, _leg)(os.path.abspath(args.leg))
        return 0
    if not args.trees:
        ap.error("--trees is required")
    card = smi()
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    legs = []
    for letter in args.order:
        tree = trees["AB".index(letter)]
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--leg", tree,
             "--part", args.part],
            capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            raise SystemExit(f"newton_ab: leg {letter} failed:\n"
                             f"{proc.stderr[-4000:]}")
        leg = json.loads(proc.stdout.strip().splitlines()[-1])
        leg["leg"] = letter
        _bound(leg.get("norne_gather", {}).get("refresh"))
        for label in ("spe10", "norne_embedded"):
            _bound(leg.get(label, {}).get("k7_refresh"), k7=True)
        legs.append(leg)
        print(json.dumps(leg), flush=True)
    res = dict(device=card, order=args.order, part=args.part, trees=trees,
               legs=legs)
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
