"""flow: the simulator CLI of the port.

Deck in, simulation out: runs the fully-implicit black-oil simulator on
the chosen device, writes its files into --output-dir (the PRT log,
summary.csv, CASE.SMSPEC/UNSMRY, CASE.INIT, CASE.EGRID, fip_report.txt,
step_timing.txt, walltime.txt; with --write-restart restart_NNNN.npz and
CASE.UNRST, with --vtk step_NNNN.vtr, with --matlab the per-variable
NNN.txt dumps), prints one summary row per report step (unless --quiet)
and a final JSON line of iteration totals and wall time.

    python -m opm_tpu_torch.tools.flow CASE.DATA [--output-dir out]
        [--device cuda|cpu] [--report-steps N] [--vtk] [--matlab]
        [--write-restart] [--restart-file F [--restart-step N]]
        [--param KEY=VALUE ...] [--quiet]

The default device is the card (cuda); --device cpu runs on the CPU.
--restart-file resumes from a restart_NNNN.npz checkpoint, or from an
.UNRST at the report step --restart-step names.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="flow", description=__doc__)
    ap.add_argument("deck")
    ap.add_argument("--output-dir", default="output")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cpu, cuda, cuda:1, ...)")
    ap.add_argument("--report-steps", type=int, default=None)
    ap.add_argument("--vtk", action="store_true")
    ap.add_argument("--matlab", action="store_true",
                    help="per-variable NNN.txt dumps per report step "
                         "(output_matlab, BlackoilMatlabWriter role)")
    ap.add_argument("--write-restart", action="store_true")
    ap.add_argument("--restart-file", default=None)
    ap.add_argument("--restart-step", type=int, default=None,
                    help="the report step (SEQNUM) to resume from when "
                         "--restart-file is an .UNRST")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--param", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="ParameterGroup override (repeatable), e.g. "
                         "tolerance_cnv=1e-3, max_iter=12, initial_dt=2.0")
    args = ap.parse_args(argv)
    if args.restart_file and args.restart_file.upper().endswith(".UNRST") \
            and args.restart_step is None:
        ap.error("--restart-file F.UNRST needs --restart-step")

    import torch

    from opm_tpu_torch.io.eclstate import load_case
    from opm_tpu_torch.models.blackoil import ModelParams
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.solver.timestepping import TimeStepControlParams
    from opm_tpu_torch.utils.param import ParameterGroup

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"flow: device {device} but no CUDA device is "
                         "visible; pass --device cpu to run on the CPU")
    pg = ParameterGroup.from_args(args.param)
    mparams = pg.apply_to_dataclass(ModelParams())
    DAY = 86400.0
    tsp = TimeStepControlParams()
    for f in ("initial_dt", "max_dt", "min_dt"):
        if pg.has(f):
            tsp = dataclasses.replace(
                tsp, **{f: pg.get_default(f, getattr(tsp, f) / DAY) * DAY})
    tsp = pg.apply_to_dataclass(tsp)

    case = load_case(args.deck)
    if not args.quiet:
        print(f"{case.runspec.title or args.deck}: "
              f"{case.runspec.dims} {'/'.join(case.runspec.phases)}"
              f"{' DISGAS' if case.runspec.disgas else ''}"
              f"{' VAPOIL' if case.runspec.vapoil else ''} on {device}")
    sim = SimulatorFullyImplicitBlackoil(case, params=mparams, ts_params=tsp,
                                         output_dir=args.output_dir,
                                         device=device)
    t0 = time.perf_counter()
    sim.run(report_step_limit=args.report_steps, verbose=not args.quiet,
            restart_file=args.restart_file, restart_step=args.restart_step,
            write_restart=args.write_restart, write_vtk=args.vtk,
            write_matlab=args.matlab)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    unused = pg.unused()
    if unused:
        print(f"WARNING: unused parameters: {', '.join(unused)}")
    rep = sim.report
    print(json.dumps(dict(
        device=str(device), wall_s=round(wall, 2), substeps=rep.substeps,
        failed_substeps=rep.failed_substeps,
        newton_iterations=rep.newton_iterations,
        assemble_s=round(rep.assemble_time, 2),
        linear_solve_s=round(rep.linear_solve_time, 2))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
