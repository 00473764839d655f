"""How far the summation order of BiCGStab's dot products moves a CPR
solve: the toy SPE10-like deck's first Newton system (15x44x4, three GMG
levels; the system of tests/test_torch_cuda.py's kernels-vs-twins solve)
solved on the CPU through the plain twins, with the K8 twins' dot products
summed in four orders: torch.dot, exactly (math.fsum of the rounded
products), torch.dot over the reversed vectors, and left to right.

For each order it prints the iteration count at tol 1e-2, the recurrence's
relative residual, the true relative residual ||b - A x|| / ||b|| and,
after exactly ``--its`` iterations, max|du - du_exact| / max|du_exact|;
then the largest max|du_a - du_b| / max|du_b| over two orders a, b after
``--its`` iterations.

    python3 tools/krylov_order.py [--its 12]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--its", type=int, default=12)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from opm_tpu_torch.linalg import kernels_k8 as k8
    from opm_tpu_torch.linalg import precond
    from opm_tpu_torch.linalg.krylov import bicgstab
    from opm_tpu_torch.models import linearize
    from opm_tpu_torch.models.blackoil import make_well_device_arrays
    from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                            init_well_state,
                                            report_step_wells)
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.sim.testcases import spe10like_case
    from opm_tpu_torch.solver.newton import connection_offsets

    case = spe10like_case(nx=15, ny=44, nz=4, tsteps="3*1")
    sim = SimulatorFullyImplicitBlackoil(case, device="cpu")
    ws = report_step_wells(sim.schedule.report_steps[0], sim.grid,
                           sim.well_names, sim.max_perf)
    wd = make_well_device_arrays(ws, sim.grid.gravity, "cpu")
    st = init_well_state(initial_state(sim.grid, sim.props, case, ws.nw),
                         ws, True)
    sys_ = linearize.assemble(sim.model, st, sim.model.accumulation(st),
                              21600.0, wd,
                              connection_offsets(sim.model, st, wd))
    dims = sim.model.dims
    mv, rhs, rec = linearize.schur_eliminate_wells(sys_, dims)
    M = precond.make_cpr_cells(sys_, sim.solver.amg, dims)
    nb = float(rhs.norm())

    def products(a, b):
        return (a.reshape(-1) * b.reshape(-1)).numpy()

    def left_to_right(a, b):
        s = 0.0
        for v in products(a, b).tolist():
            s += v
        return torch.tensor(s, dtype=torch.float64)

    orders = {
        "torch.dot": k8._dot,
        "exact": lambda a, b: torch.tensor(math.fsum(products(a, b)),
                                           dtype=torch.float64),
        "reversed": lambda a, b: torch.dot(a.reshape(-1).flip(0),
                                           b.reshape(-1).flip(0)),
        "left to right": left_to_right,
    }
    plain_dot = k8._dot
    out = {}
    try:
        for name, dot in orders.items():
            k8._dot = dot
            res = bicgstab(mv, rhs, precond=M, tol=1e-2, maxiter=50)
            fixed = bicgstab(mv, rhs, precond=M, tol=1e-30,
                             maxiter=args.its)
            du = torch.cat([fixed.x.reshape(-1),
                            rec(fixed.x).reshape(-1)])
            true = float((rhs - mv(res.x)).norm()) / nb
            out[name] = (res, true, du)
    finally:
        k8._dot = plain_dot
    ref = out["exact"][2]
    scale = float(ref.abs().max())
    for name, (res, true, du) in out.items():
        print(f"{name:14s} {res.iterations:3d} iterations, relative "
              f"residual {res.rel_residual:.6e} (true {true:.6e}); du after "
              f"{args.its} iterations off the exact order's by "
              f"{float((du - ref).abs().max()) / scale:.3e} of max")
    spread = max(
        float((out[a][2] - out[b][2]).abs().max())
        / float(out[b][2].abs().max())
        for a in out for b in out if a != b)
    print(f"largest difference of du after {args.its} iterations between "
          f"two orders: {spread:.3e} of max")
    return 0


if __name__ == "__main__":
    sys.exit(main())
