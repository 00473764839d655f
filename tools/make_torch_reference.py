"""Write the reference fixtures that the PyTorch port's end-to-end checks
are held against on a machine without JAX:

- data/spe1_reference_cpu.json: the full SPE1 schedule
  (data/SPE1CASE2.DATA), dense Newton route;
- data/spe10like_toy_reference_cpu.json: the toy SPE10-like deck
  (sim/testcases.py spe10like_deck with TOY_KWARGS: 2640 cells, three
  structured-GMG levels, three report steps of one day), CPR route.

Each runs opm_tpu.sim.blackoil.SimulatorFullyImplicitBlackoil on the CPU,
on its per-step path (fused=False), and records per report step the
Newton, substep and linear-iteration counts and FPR, FOPR, FWPR, FGOR and
WBHP, the totals, and the git commit it ran on.

    python tools/make_torch_reference.py [--case spe1|spe10toy|all]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the toy SPE10-like deck: above the dense limit (2000 cells), with three
# GMG levels (2640 -> 1320 -> 660 -> 330 cells)
TOY_KWARGS = dict(nx=15, ny=44, nz=4, tsteps="3*1")
OUT = {"spe1": os.path.join(ROOT, "data", "spe1_reference_cpu.json"),
       "spe10toy": os.path.join(ROOT, "data",
                                "spe10like_toy_reference_cpu.json")}


def run_case(name):
    from opm_tpu.io.eclstate import load_case
    from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu.sim.testcases import spe10like_case

    if name == "spe1":
        deck = dict(deck="data/SPE1CASE2.DATA")
        case = load_case(os.path.join(ROOT, deck["deck"]))
    else:
        deck = dict(deck="sim/testcases.py spe10like_deck",
                    deck_kwargs=TOY_KWARGS)
        case = spe10like_case(**TOY_KWARGS)
    sim = SimulatorFullyImplicitBlackoil(case, fused=False)
    # report_step_completed fires before the totals are updated: the
    # linear count at each signal closes the previous report step
    lin = []
    sim.events.event("report_step_completed").add(
        lambda s, step: lin.append(sim.report.linear_iterations))
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    lin = lin[1:] + [sim.report.linear_iterations]
    lin = [b - a for a, b in zip([0] + lin[:-1], lin)]
    return sim, deck, wall, lin


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--case", default="all",
                    choices=["spe1", "spe10toy", "all"])
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import opm_tpu  # noqa: F401  (x64)

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    for name in (["spe1", "spe10toy"] if args.case == "all"
                 else [args.case]):
        sim, deck, wall, lin = run_case(name)
        rows = sim.summary.rows
        steps = sim._step_timing      # (index, end_days, wall, subs, newtons)
        out = dict(
            **deck,
            generator="tools/make_torch_reference.py",
            package="opm_tpu (JAX, CPU, per-step path)",
            linear_solver=sim.solver.linear_solver,
            commit=commit,
            jax_version=jax.__version__,
            wall_s_cpu=round(wall, 1),
            total_newtons=int(sim.report.newton_iterations),
            total_substeps=int(sim.report.substeps),
            failed_substeps=int(sim.report.failed_substeps),
            total_linear=int(sim.report.linear_iterations),
            well_names=list(sim.well_names),
            report_steps=[dict(
                index=int(s[0]), end_days=float(s[1]), substeps=int(s[3]),
                newtons=int(s[4]), linear=int(li), FPR=float(r["FPR"]),
                FOPR=float(r["FOPR"]), FWPR=float(r["FWPR"]),
                FGOR=float(r["FGOR"]),
                WBHP=[float(r[f"WBHP:{n}"]) for n in sim.well_names])
                for s, r, li in zip(steps, rows, lin)],
        )
        with open(OUT[name], "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        print(f"wrote {OUT[name]}: {out['total_newtons']} Newtons, "
              f"{out['total_substeps']} substeps, {out['failed_substeps']} "
              f"failed, {out['total_linear']} linear, {wall:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
