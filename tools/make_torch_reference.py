"""Write data/spe1_reference_cpu.json: the JAX package's SPE1 run, the
reference that the PyTorch port's end-to-end check is held against on a
machine without JAX.

Runs the full SPE1 schedule (data/SPE1CASE2.DATA) through
opm_tpu.sim.blackoil.SimulatorFullyImplicitBlackoil on the CPU, on its
per-step path (fused=False), and records per report step the Newton and
substep counts and FPR, FOPR, FGOR and WBHP, the failed-substep total, and
the git commit it ran on.

    python tools/make_torch_reference.py [--out data/spe1_reference_cpu.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--deck", default=os.path.join(ROOT, "data",
                                                   "SPE1CASE2.DATA"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "data", "spe1_reference_cpu.json"))
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import opm_tpu  # noqa: F401  (x64)
    from opm_tpu.io.eclstate import load_case
    from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil

    case = load_case(args.deck)
    sim = SimulatorFullyImplicitBlackoil(case, fused=False)
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    rows = sim.summary.rows
    steps = sim._step_timing          # (index, end_days, wall, subs, newtons)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    out = dict(
        deck=os.path.relpath(args.deck, ROOT),
        generator="tools/make_torch_reference.py",
        package="opm_tpu (JAX, CPU, per-step path)",
        commit=commit,
        jax_version=jax.__version__,
        wall_s_cpu=round(wall, 1),
        total_newtons=int(sim.report.newton_iterations),
        total_substeps=int(sim.report.substeps),
        failed_substeps=int(sim.report.failed_substeps),
        well_names=list(sim.well_names),
        report_steps=[dict(
            index=int(s[0]), end_days=float(s[1]), substeps=int(s[3]),
            newtons=int(s[4]), FPR=float(r["FPR"]), FOPR=float(r["FOPR"]),
            FGOR=float(r["FGOR"]),
            WBHP=[float(r[f"WBHP:{n}"]) for n in sim.well_names])
            for s, r in zip(steps, rows)],
    )
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}: {out['total_newtons']} Newtons, "
          f"{out['total_substeps']} substeps, {out['failed_substeps']} "
          f"failed, {wall:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
