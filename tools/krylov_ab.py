"""A/B of the port's CPR Krylov layer between two trees on one card.

    python3 tools/krylov_ab.py --trees BASE,CHANGE [--order ABBA]
        [--out krylov_ab.json]

Runs one leg per letter of ``--order`` (A: the first tree, B: the second),
each in a process of its own that imports ``opm_tpu_torch`` from its tree
and builds that tree's kernels into its own ``build/``, so two versions of
the package are compared in turns on the same card. A leg measures:

- SPE10-2 (the seeded SPE10-like deck at 60x220x85 = 1.122M cells): its
  first Newton system solved by CPR-BiCGStab for exactly 10 iterations (an
  unreachable tolerance), median of 11 warm solves, host clock ended by a
  synchronize: ms per iteration (two preconditioner applies, two operator
  applies and the K8 steps), K8's two launches of one iteration alone
  on seeded vectors of the same length (CUDA events around 20 iterations,
  median of 5; null for a tree whose K8 is not ``linalg/kernels_k8.py``)
  and one pressure V-cycle of that system's hierarchy on a seeded
  right-hand side (CUDA events around 50 V-cycles, median of 5);
  then report step 0 after a warm-up run of the
  same step: wall, the Newton loop's synced sections (``krylov`` among
  them) and the counts;
- the Norne-class field (``norne_like_deck()``) in both representations:
  the same 10-iteration solve and V-cycle of the first Newton system and
  report step 0 after a warm-up.

Prints one JSON line per leg and the card's name and power limit; writes
every leg to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _first_system(sim, st0):
    from opm_tpu_torch.models import linearize
    from opm_tpu_torch.models.blackoil import make_well_device_arrays
    from opm_tpu_torch.sim.blackoil import init_well_state, report_step_wells
    from opm_tpu_torch.solver.newton import connection_offsets

    ws = report_step_wells(sim.schedule.report_steps[0], sim.grid,
                           sim.well_names, sim.max_perf)
    wd = make_well_device_arrays(ws, sim.grid.gravity, sim.device)
    st = init_well_state(st0, ws, True)
    return linearize.assemble(sim.model, st, sim.model.accumulation(st),
                              float(sim.ts.p.initial_dt), wd,
                              connection_offsets(sim.model, st, wd))


def _solve_ms(sim, sys_, its=10, reps=11):
    """ms per BiCGStab iteration over ``its`` iterations (median)."""
    import torch

    from opm_tpu_torch.linalg.krylov import bicgstab
    from opm_tpu_torch.linalg.precond import make_cpr_cells
    from opm_tpu_torch.models import linearize

    dims = sim.model.op_dims
    mv, rhs, _ = linearize.schur_eliminate_wells(sys_, dims)
    M = make_cpr_cells(sys_, sim.solver.amg, dims)
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bicgstab(mv, rhs, precond=M, tol=1e-30, maxiter=its)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / res.iterations)
    return statistics.median(times[1:])


def _vcycle_ms(sim, sys_, reps=5, its=50):
    """One pressure V-cycle of the first Newton system's hierarchy on a
    seeded right-hand side: ms per V-cycle (CUDA events around ``its``
    V-cycles in a row, median of ``reps``)."""
    import numpy as np
    import torch

    from opm_tpu_torch.linalg.precond import cpr_setup

    amg, dims = sim.solver.amg, sim.model.op_dims
    _, _, diag_p, off = cpr_setup(sys_, dims, amg)
    vals = amg.coarsen_values(diag_p, off)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(
        diag_p.numel()), device=diag_p.device)
    amg.vcycle(vals, b)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(its):
            amg.vcycle(vals, b)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / its)
    return statistics.median(times)


def _k8_ms(n, reps=5, its=20):
    """K8's two launches of one BiCGStab iteration alone, on seeded vectors
    of n values: ms per iteration (CUDA events around ``its`` iterations,
    median of ``reps``); None for a tree without linalg/kernels_k8.py."""
    import importlib.util

    import numpy as np
    import torch

    if importlib.util.find_spec("opm_tpu_torch.linalg.kernels_k8") is None:
        return None
    from opm_tpu_torch.linalg import kernels_k8 as k8

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    t, s, x, r, phat, shat, rhat, p, v = (
        torch.as_tensor(rng.standard_normal(n), device=dev)
        for _ in range(9))
    ws = k8.Workspace(rhat, kernels=True)
    k8.init_cuda(ws, rhat)

    def iteration():
        k8.alpha_s_cuda(ws, rhat, v, r)
        k8.omega_xr_p_cuda(ws, t, s, x, r, phat, shat, rhat, p, v)

    iteration()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(its):
            iteration()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / its)
    return statistics.median(times)


def _leg(tree):
    import torch
    sys.path.insert(0, tree)
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.sim.testcases import norne_like_case, spe10like_case

    def fresh(case, knob):
        os.environ.pop("OPM_TPU_EMBED", None)
        if knob is not None:
            os.environ["OPM_TPU_EMBED"] = knob
        sim = SimulatorFullyImplicitBlackoil(case)
        return sim, initial_state(sim.grid, sim.props, case,
                                  len(sim.well_names))

    out = dict(tree=tree)
    norne = norne_like_case()
    for label, case, knob in (("spe10", spe10like_case(nx=60, ny=220,
                                                       nz=85), None),
                              ("norne_embedded", norne, None),
                              ("norne_gather", norne, "0")):
        sim, init = fresh(case, knob)
        sys_ = _first_system(sim, init)
        per_it = _solve_ms(sim, sys_)
        k8_it = _k8_ms(sys_.r_cell.numel())
        vcycle = _vcycle_ms(sim, sys_)
        del sys_
        sim.run(init, report_step_limit=1)          # warm-up
        sim, init = fresh(case, knob)
        sim.solver.timing = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(init, report_step_limit=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = sim.report
        out[label] = dict(
            ms_per_iteration=per_it, k8_ms_per_iteration=k8_it,
            vcycle_ms=vcycle,
            wall_s=wall,
            sections_s=dict(sim.solver.timing),
            newtons=rep.newton_iterations, linear=rep.linear_iterations,
            substeps=rep.substeps, failed=rep.failed_substeps)
        del sim, init
        torch.cuda.empty_cache()
    os.environ.pop("OPM_TPU_EMBED", None)
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trees", help="BASE,CHANGE: two repository roots")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default=None)
    ap.add_argument("--leg", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("krylov_ab: no CUDA device visible")
    if args.leg:
        _leg(os.path.abspath(args.leg))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    legs = []
    for letter in args.order:
        tree = trees["AB".index(letter)]
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--leg", tree],
            capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            raise SystemExit(f"krylov_ab: leg {letter} failed:\n"
                             f"{proc.stderr[-4000:]}")
        leg = json.loads(proc.stdout.strip().splitlines()[-1])
        leg["leg"] = letter
        legs.append(leg)
        print(json.dumps(leg), flush=True)
    print(smi)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, order=args.order, trees=trees,
                           legs=legs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
