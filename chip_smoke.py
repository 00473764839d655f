"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases (each prints a line of its own; any failure exits non-zero):

1. device: needs CUDA; prints the card's name and power limit (nvidia-smi)
   and turns TF32 off for matmul and cuDNN;
2. build: compiles the CUDA kernels (K1 tables.cu, K3 tpfa.cu) with nvcc
   and JIT-compiles the Triton kernels (K9);
3. kernel == plain on the card, at SPE1's shapes (K3's tangent also at
   the main path's jacfwd batch, B = 3 nc + 4 nw, and the whole dense
   Jacobian through the kernels against the plain CPU path) and at SPE10
   model 2's (60x220x85 = 1.122M cells, the seeded SPE10-like deck), with
   each kernel's median time against its plain PyTorch version (CUDA
   events, warm, 20 runs);
4. SPE1 end to end on the card through SimulatorFullyImplicitBlackoil,
   all report steps, held against data/spe1_reference_cpu.json (the JAX
   package's CPU run), with every kernel's launch counter read over that
   run;
5. the SPE10-2-size stages of the same path on the card: initial_state,
   one residual + convergence, one update_state.

The line before the last is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
JAX_PKG = "opm-simulators-legacy_tpu"

# tolerances (kernel vs plain on the card)
TOL_K1 = 1e-13       # relative, values and slopes
TOL_K3 = 1e-12       # of max|div| (sum order)
TOL_K9_UPD = 1e-14   # relative; hcstate exact
TOL_K9_NORM = 1e-12  # relative
# the dense Jacobian on the card against the plain CPU path (the CPU tests
# hold the plain path to the JAX package's jax.jacfwd at the same bound)
TOL_JAC = 1e-10      # of max|J|
# SPE1 against the JAX package's CPU run
TOL_FPR = 1e-4
TOL_RATE = 1e-3
TOL_NEWTON_TOTAL = 0.01


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def rel_err(a, b):
    """max |a - b| / |b| elementwise (exact zeros compare exactly)."""
    import torch
    d = (a - b).abs()
    scale = b.abs()
    r = torch.where(d == 0, torch.zeros_like(d), d / scale)
    return float(r.max()) if r.numel() else 0.0


def cuda_ms(fn, reps=20):
    """Median device time of fn over reps warm runs (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


class Kernels:
    """The kernels of the path: wrappers, sources, replaced functions."""

    def __init__(self):
        from opm_tpu_torch.models import blackoil as mb
        from opm_tpu_torch.solver import kernels_triton as k9
        from opm_tpu_torch.utils import tables as k1
        self.entries = [
            ("K1 interp1", "cuda", "opm_tpu_torch/csrc/tables.cu",
             f"{JAX_PKG}/utils/tables.py:97", k1.interp1_cuda),
            ("K1 interp2", "cuda", "opm_tpu_torch/csrc/tables.cu",
             f"{JAX_PKG}/utils/tables.py:217", k1.interp2_cuda),
            ("K3 tpfa_div", "cuda", "opm_tpu_torch/csrc/tpfa.cu",
             f"{JAX_PKG}/models/blackoil.py:176", mb.tpfa_div_cuda),
            ("K3 tpfa_div_tangent", "cuda", "opm_tpu_torch/csrc/tpfa.cu",
             f"{JAX_PKG}/models/blackoil.py:298",
             mb.tpfa_div_tangent_cuda),
            ("K9 update_pressure", "triton",
             "opm_tpu_torch/solver/kernels_triton.py",
             f"{JAX_PKG}/solver/update.py:19", k9.update_pressure_triton),
            ("K9 update_cells", "triton",
             "opm_tpu_torch/solver/kernels_triton.py",
             f"{JAX_PKG}/solver/update.py:19", k9.update_cells_triton),
            ("K9 conv_norms", "triton",
             "opm_tpu_torch/solver/kernels_triton.py",
             f"{JAX_PKG}/models/blackoil.py:447", k9.conv_norms_triton),
        ]
        self.err = {e[0]: 0.0 for e in self.entries}
        self.ms = {}
        self.plain_ms = {}
        self.launches = {}

    def reset(self):
        for e in self.entries:
            e[4].launches = 0

    def read(self):
        self.launches = {e[0]: e[4].launches for e in self.entries}

    def note(self, name, err):
        self.err[name] = max(self.err[name], err)

    def report(self):
        return {"kernels": [dict(
            name=n, route=route, source=src, replaces=rep,
            launches=int(self.launches.get(n, 0)),
            max_abs_err=self.err[n], ms=self.ms.get(n),
            plain_ms=self.plain_ms.get(n))
            for n, route, src, rep, _ in self.entries]}


# ---------------------------------------------------------------------------
def seeded_state(model, seed, dev):
    """A state in every hcstate, made from the seed with numpy."""
    import numpy as np

    from opm_tpu_torch.utils.convert import state_from_numpy
    rng = np.random.default_rng(seed)
    nc = model.nc
    hc = rng.integers(0, 3, nc).astype(np.int32)
    sw = rng.uniform(0.15, 0.7, nc)
    x = np.where(hc == 0, rng.uniform(0.0, 0.25, nc),
                 np.where(hc == 1, rng.uniform(20.0, 120.0, nc),
                          rng.uniform(0.0, 1e-4, nc)))
    return state_from_numpy(dict(
        pressure=rng.uniform(1.5e7, 4.0e7, nc), sw=sw, x=x, hcstate=hc,
        bhp=np.zeros(0), qs=np.zeros((0, 3)), control=np.zeros(0),
        target=np.zeros(0)), dev)


def compare_kernels(K, model, state, seed, label, timed, B):
    """Every kernel against its plain version on the same card inputs;
    B is the K3 tangent batch."""
    import numpy as np
    import torch

    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.solver import kernels_triton as k9
    from opm_tpu_torch.utils import tables as k1

    props = model.props
    rng = np.random.default_rng(seed + 1)
    dev = model.device
    nc = model.nc
    p, sw = state.pressure, state.sw
    q = model.cell_quantities(state)

    def chk(name, tol, pairs):
        for a, b in pairs:
            e = rel_err(a, b)
            K.note(name, float((a - b).abs().max()))
            if not e <= tol:
                fail(f"{label}: {name} differs from its plain version "
                     f"(rel {e:.3e} > {tol:g})")

    def time_pair(name, kfn, pfn):
        if timed:
            K.ms[name] = cuda_ms(kfn)
            K.plain_ms[name] = cuda_ms(pfn)

    # K1 1-D: the PVTO saturated curve (linear) and the SWOF columns (clamp)
    lo = props.oil_live
    sf = props.satfunc
    for xs, ys, xq, clamp in ((lo.pbub_tab, lo._rs_col, p, 0),
                              (sf.sw, sf.w_cols, sw, 1)):
        kv = k1.interp1_cuda(xs, ys, xq, None, clamp)
        pv = k1.lookup1_plain(xs, ys, xq, None, clamp)
        chk("K1 interp1", TOL_K1, zip(kv, pv))
    time_pair("K1 interp1",
              lambda: k1.interp1_cuda(sf.sw, sf.w_cols, sw, None, 1),
              lambda: k1.lookup1_plain(sf.sw, sf.w_cols, sw, None, 1))
    # K1 2-D: the PVTO inv_b/inv_bmu pair at (rs, p - p_bub(rs))
    rs = q.rs
    dpb = torch.clamp(p - lo.p_bub(rs, None), min=0.0)
    kv = k1.interp2_cuda(lo.rs_tab, lo.dp_grid, lo.grids, rs, dpb, None, 0, 0)
    pv = k1.lookup2_plain(lo.rs_tab, lo.dp_grid, lo.grids, rs, dpb, None,
                          0, 0)
    chk("K1 interp2", TOL_K1, zip(kv, pv))
    time_pair("K1 interp2",
              lambda: k1.interp2_cuda(lo.rs_tab, lo.dp_grid, lo.grids, rs,
                                      dpb, None, 0, 0),
              lambda: k1.lookup2_plain(lo.rs_tab, lo.dp_grid, lo.grids, rs,
                                       dpb, None, 0, 0))

    # K3 forward and tangent
    p3 = torch.stack([q.pw, q.po, q.pg]).contiguous()
    bmob = (q.b * q.mob).contiguous()
    rho = q.rho.contiguous()
    rsv, rvv = q.rs.contiguous(), q.rv.contiguous()
    args = (model.dims, p3, rho, bmob, rsv, rvv, model.depth, model.trans,
            model.gravity)
    kd = mb.tpfa_div_cuda(*args)
    pd = mb.tpfa_div_plain(*args)
    e3 = float((kd - pd).abs().max()) / float(pd.abs().max())
    K.note("K3 tpfa_div", float((kd - pd).abs().max()))
    if not e3 <= TOL_K3:
        fail(f"{label}: K3 tpfa_div off by {e3:.3e} of max|div|")
    tan = [torch.as_tensor(rng.standard_normal((B,) + a.shape), device=dev)
           * a.abs().mean() for a in (p3, rho, bmob, rsv, rvv)]
    kt = mb.tpfa_div_tangent_cuda(*args, *tan)
    pt = mb.tpfa_div_tangent_plain(*args, *tan)
    e3t = float((kt - pt).abs().max()) / float(pt.abs().max())
    K.note("K3 tpfa_div_tangent", float((kt - pt).abs().max()))
    if not e3t <= TOL_K3:
        fail(f"{label}: K3 tangent (B = {B}) off by {e3t:.3e} of max|ddiv|")
    time_pair("K3 tpfa_div", lambda: mb.tpfa_div_cuda(*args),
              lambda: mb.tpfa_div_plain(*args))
    time_pair("K3 tpfa_div_tangent",
              lambda: mb.tpfa_div_tangent_cuda(*args, *tan),
              lambda: mb.tpfa_div_tangent_plain(*args, *tan))

    # K9 update (seeded increment) and norms (the residual's shapes)
    du = [torch.as_tensor(rng.standard_normal(nc) * s, device=dev)
          for s in (2e6, 0.1, 0.05)]
    prm = model.params
    kp = k9.update_pressure_triton(p, du[0], prm.dp_max_rel)
    pp = k9.update_pressure_plain(p, du[0], prm.dp_max_rel)
    chk("K9 update_pressure", TOL_K9_UPD, [(kp, pp)])
    rs0 = props.rs_sat(p, model.pvtnum)
    rs1 = props.rs_sat(pp, model.pvtnum)
    zero = torch.zeros_like(p)
    uargs = (state.sw, state.x, state.hcstate, du[1], du[2], rs0, rs1, zero,
             zero, prm.ds_max, prm.dr_max_rel, props.disgas, props.vapoil)
    ku = k9.update_cells_triton(*uargs)
    pu = k9.update_cells_plain(*uargs)
    if not torch.equal(ku[2], pu[2]):
        fail(f"{label}: K9 update_cells hcstate differs from plain")
    chk("K9 update_cells", TOL_K9_UPD, [(ku[0], pu[0]), (ku[1], pu[1])])
    time_pair("K9 update_pressure",
              lambda: k9.update_pressure_triton(p, du[0], prm.dp_max_rel),
              lambda: k9.update_pressure_plain(p, du[0], prm.dp_max_rel))
    time_pair("K9 update_cells", lambda: k9.update_cells_triton(*uargs),
              lambda: k9.update_cells_plain(*uargs))
    R = torch.as_tensor(rng.standard_normal((3, nc)) + 1.0, device=dev) \
        * model.pv * 1e-6
    dt = 86400.0
    kn = k9.conv_norms_triton(R, q.b.contiguous(), model.pv, dt)
    pn = k9.conv_norms_plain(R, q.b, model.pv, dt)
    chk("K9 conv_norms", TOL_K9_NORM, zip(kn, pn))
    time_pair("K9 conv_norms",
              lambda: k9.conv_norms_triton(R, q.b.contiguous(), model.pv,
                                           dt),
              lambda: k9.conv_norms_plain(R, q.b, model.pv, dt))
    torch.cuda.synchronize()


def compare_jacobian(case, dev):
    """The dense Jacobian of SPE1's first Newton iteration on the card
    (torch.func.jacfwd through K1 and K3, the main path's own tangent
    batch) against the plain path on the CPU, from one initial state.
    Returns (relative error, K3 tangent launches on the card)."""
    import torch

    from opm_tpu_torch.models.blackoil import (make_well_device_arrays,
                                               tpfa_div_tangent_cuda)
    from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                            init_well_state,
                                            report_step_wells)
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.solver.newton import connection_offsets
    from opm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

    out = []
    host = None
    n0 = tpfa_div_tangent_cuda.launches
    for d in (dev, torch.device("cpu")):
        sim = SimulatorFullyImplicitBlackoil(case, device=d)
        step = sim.schedule.report_steps[0]
        ws = report_step_wells(step, sim.grid, sim.well_names, sim.max_perf)
        wd = make_well_device_arrays(ws, sim.grid.gravity, d)
        if host is None:
            st = initial_state(sim.grid, sim.props, case, ws.nw)
            host = state_to_numpy(init_well_state(st, ws, True))
        st = state_from_numpy(host, d)
        acc0 = sim.model.accumulation(st)
        cdp = connection_offsets(sim.model, st, wd)
        J, _ = sim.solver.jacobian(st, acc0, 86400.0, wd, cdp)
        out.append(J.cpu())
    Jg, Jc = out
    if not bool(torch.isfinite(Jg).all()):
        fail("SPE1 Jacobian on the card is not finite")
    err = float((Jg - Jc).abs().max()) / float(Jc.abs().max())
    return err, tpfa_div_tangent_cuda.launches - n0


# ---------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible")
    sys.path.insert(0, ROOT)
    import numpy as np

    from opm_tpu_torch.grid.grid import build_grid
    from opm_tpu_torch.io.eclstate import load_case
    from opm_tpu_torch.io.schedule import build_schedule
    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.props.blackoil import BlackoilProps
    from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                            init_well_state,
                                            report_step_wells,
                                            schedule_wells)
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.sim.testcases import spe10like_case
    from opm_tpu_torch.solver import kernels_triton as k9
    from opm_tpu_torch.solver.newton import connection_offsets
    from opm_tpu_torch.solver.update import update_state
    from opm_tpu_torch.utils import cuda_lib

    results = {}
    dev = torch.device("cuda", 0)

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    results["nvidia_smi"] = smi

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    for name in ("tables", "tpfa"):
        cuda_lib.build(name)
    K = Kernels()
    tiny = torch.linspace(1.0, 2.0, 8, dtype=torch.float64, device=dev)
    b3 = torch.stack([tiny, tiny, tiny]).contiguous()
    k9.update_pressure_triton(tiny, tiny, 0.3)
    k9.update_cells_triton(tiny, tiny, torch.zeros(8, dtype=torch.int32,
                                                   device=dev),
                           tiny, tiny, tiny, tiny, tiny, tiny, 0.2, 1e9,
                           True, False)
    k9.conv_norms_triton(b3, b3, tiny, 1.0)
    torch.cuda.synchronize()
    results["build_s"] = time.perf_counter() - t0
    log(f"build: {results['build_s']:.1f} s (nvcc sm_90a + Triton JIT)")

    # -- 3a. kernel == plain at SPE1's shapes -----------------------------------
    case1 = load_case(os.path.join(ROOT, "data", "SPE1CASE2.DATA"))
    sim_cmp = SimulatorFullyImplicitBlackoil(case1, device=dev)
    m1 = sim_cmp.model
    st1 = seeded_state(m1, args.seed, dev)
    # jacfwd folds every tangent column into one K3 tangent launch
    b_jac = 3 * m1.nc + 4 * len(sim_cmp.well_names)
    compare_kernels(K, m1, st1, args.seed, "SPE1", timed=False, B=b_jac)
    log(f"kernels == plain at SPE1 shapes (300 cells, K3 tangent B = "
        f"{b_jac}): ok")
    q1 = m1.cell_quantities(st1)
    a1 = (m1.dims, torch.stack([q1.pw, q1.po, q1.pg]).contiguous(),
          q1.rho.contiguous(), (q1.b * q1.mob).contiguous(),
          q1.rs.contiguous(), q1.rv.contiguous(), m1.depth, m1.trans,
          m1.gravity)
    t1 = [torch.ones((b_jac,) + a.shape, dtype=torch.float64, device=dev)
          for a in a1[1:6]]
    jac_ms = (cuda_ms(lambda: mb.tpfa_div_tangent_cuda(*a1, *t1)),
              cuda_ms(lambda: mb.tpfa_div_tangent_plain(*a1, *t1)))
    log(f"  K3 tangent at SPE1, B = {b_jac}: kernel {jac_ms[0]:.4f} ms   "
        f"plain {jac_ms[1]:.4f} ms")
    results["spe1_k3_tangent_ms"] = dict(B=b_jac, ms=jac_ms[0],
                                         plain_ms=jac_ms[1])
    ejac, n_tan = compare_jacobian(case1, dev)
    log(f"SPE1 Jacobian (jacfwd through K1/K3; K3 tangent launches: "
        f"{n_tan}) vs the plain CPU path: {ejac:.3e} of max|J|")
    results["spe1_jacobian_rel"] = ejac
    if not ejac <= TOL_JAC or n_tan < 1:
        fail(f"SPE1 Jacobian on the card off by {ejac:.3e} of max|J| "
             f"(> {TOL_JAC:g}) or not through K3 ({n_tan} launches)")

    # -- 3b. kernel == plain at SPE10-2 shapes ----------------------------------
    t0 = time.perf_counter()
    case10 = spe10like_case(nx=60, ny=220, nz=85)
    grid10 = build_grid(case10)
    props10 = BlackoilProps.from_case(case10, dev)
    m10 = mb.BlackoilModel(grid10, props10, device=dev)
    results["spe10_setup_s"] = time.perf_counter() - t0
    log(f"SPE10-2 setup (deck parse, grid, props on the host): "
        f"{results['spe10_setup_s']:.1f} s, {m10.nc} cells, "
        f"{m10.trans.shape[0]} faces")
    st10 = seeded_state(m10, args.seed, dev)
    compare_kernels(K, m10, st10, args.seed, "SPE10-2", timed=True, B=3)
    for n, *_ in K.entries:
        log(f"  {n:22s} kernel {K.ms[n]:9.4f} ms   plain {K.plain_ms[n]:9.4f}"
            f" ms   max_abs_err {K.err[n]:.3e}")
    log("kernels == plain at SPE10-2 shapes (1.122M cells): ok")

    # -- 4. SPE1 end to end -----------------------------------------------------
    with open(os.path.join(ROOT, "data", "spe1_reference_cpu.json")) as f:
        ref = json.load(f)
    sim = SimulatorFullyImplicitBlackoil(case1, device=dev)
    K.reset()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    K.read()
    rep = sim.report
    log(f"SPE1 end to end on the card: {wall:.1f} s, "
        f"{rep.newton_iterations} Newtons, {rep.substeps} substeps, "
        f"{rep.failed_substeps} failed (reference "
        f"{ref['total_newtons']}/{ref['total_substeps']}/"
        f"{ref['failed_substeps']})")
    log("  launches: " + ", ".join(f"{n}={c}" for n, c in K.launches.items()))
    results["spe1"] = dict(wall_s=wall, newtons=rep.newton_iterations,
                           substeps=rep.substeps,
                           failed=rep.failed_substeps,
                           launches=K.launches)
    rows = sim.summary.rows
    steps = sim._step_timing
    diffs = [(s[0], s[4], r["newtons"]) for s, r in
             zip(steps, ref["report_steps"]) if s[4] != r["newtons"]]
    if diffs:
        log(f"  first report step with another Newton count: {diffs[0]}")
    results["spe1"]["newton_diffs"] = diffs
    worst = dict(FPR=0.0, FOPR=0.0, FGOR=0.0)
    for row, r in zip(rows, ref["report_steps"]):
        for key in worst:
            e = abs(row[key] - r[key]) / max(abs(r[key]), 1e-30)
            worst[key] = max(worst[key], e)
    log("  worst relative summary error: "
        + ", ".join(f"{k}={v:.2e}" for k, v in worst.items()))
    results["spe1"]["worst_rel"] = worst
    if len(rows) != len(ref["report_steps"]):
        fail(f"SPE1 ran {len(rows)} report steps, reference "
             f"{len(ref['report_steps'])}")
    if rep.failed_substeps != 0 or rep.substeps != ref["total_substeps"]:
        fail("SPE1 substeps differ from the reference")
    if abs(rep.newton_iterations - ref["total_newtons"]) \
            > TOL_NEWTON_TOTAL * ref["total_newtons"]:
        fail("SPE1 Newton total more than 1% off the reference")
    if worst["FPR"] > TOL_FPR or worst["FOPR"] > TOL_RATE \
            or worst["FGOR"] > TOL_RATE:
        fail("SPE1 summary vectors outside tolerance")
    dead = [n for n, c in K.launches.items() if c <= 0]
    if dead:
        fail(f"kernels not launched by the SPE1 run: {dead}")

    # -- 5. SPE10-2-size stages of the path -------------------------------------
    stages = {}
    sched10 = build_schedule(case10)
    names10, max_perf10 = schedule_wells(sched10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = initial_state(grid10, props10, case10, len(names10))
    torch.cuda.synchronize()
    stages["initial_state_s"] = time.perf_counter() - t0
    ws = report_step_wells(sched10.report_steps[0], grid10, names10,
                           max_perf10)
    wd = mb.make_well_device_arrays(ws, grid10.gravity, dev)
    state = init_well_state(state, ws, True)
    dt = 86400.0
    acc0 = m10.accumulation(state)
    cdp = connection_offsets(m10, state, wd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = m10.residual(state, acc0, dt, wd, cdp)
    conv = m10.convergence(res, dt, state)
    flags = torch.stack([conv["finite"], conv["converged"]]).cpu()
    stages["residual_convergence_s"] = time.perf_counter() - t0
    if not bool(torch.isfinite(res.cell).all()) or not bool(flags[0]):
        fail("SPE10-2 residual is not finite")
    rng = np.random.default_rng(args.seed + 2)
    nc, nw = m10.nc, state.bhp.shape[0]
    du = torch.as_tensor(np.concatenate([
        rng.standard_normal(nc) * 1e5, rng.standard_normal(nc) * 0.02,
        rng.standard_normal(nc) * 0.01, np.zeros(4 * nw)]), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new = update_state(m10, state, du)
    torch.cuda.synchronize()
    stages["update_state_s"] = time.perf_counter() - t0
    if not (bool(torch.isfinite(new.pressure).all())
            and bool((new.sw >= 0).all()) and bool((new.sw <= 1).all())):
        fail("SPE10-2 update_state produced an invalid state")
    log("SPE10-2 stages on the card: " + ", ".join(
        f"{k}={v:.3f}" for k, v in stages.items()))
    results["spe10_stages"] = stages

    kern = K.report()
    results.update(kern)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(kern))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
