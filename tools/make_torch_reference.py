"""Write the reference fixtures that the PyTorch port's end-to-end checks
are held against on a machine without JAX:

- data/spe1_reference_cpu.json: the full SPE1 schedule
  (data/SPE1CASE2.DATA), dense Newton route;
- data/spe10like_toy_reference_cpu.json: the toy SPE10-like deck
  (sim/testcases.py spe10like_deck with TOY_KWARGS: 2640 cells, three
  structured-GMG levels, three report steps of one day), CPR route;
- data/nornelike_toy_reference_cpu.json: the toy Norne-like corner-point
  deck (sim/testcases.py norne_like_deck with NORNE_TOY_KWARGS: 6336 box
  cells, 4176 active, two stair-step faults), CPR route, in both
  representations: "embedded" (OPM_TPU_EMBED unset: structured GMG) and
  "gather" (OPM_TPU_EMBED=0: aggregation AMG);
- data/nornelike_full_reference_cpu.json: the Norne-class deck at its full
  size (norne_like_deck at its defaults: 46x112x22, 75,566 active cells),
  its first report step (5 days) in both representations.

Each runs opm_tpu.sim.blackoil.SimulatorFullyImplicitBlackoil on the CPU,
on its per-step path (fused=False), and records per report step the
Newton, substep and linear-iteration counts and FPR, FOPR, FWPR, FGOR and
WBHP, the totals, and the git commit it ran on.

    python tools/make_torch_reference.py
        [--case spe1|spe10toy|nornetoy|nornefull|all]
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
# the toy Norne-like deck: both representations above the dense limit;
# nz stays 22 (the injectors complete in layers 12-22)
NORNE_TOY_KWARGS = dict(nx=12, ny=24, nz=22, tsteps="1 2 5")
OUT = {"spe1": os.path.join(ROOT, "data", "spe1_reference_cpu.json"),
       "spe10toy": os.path.join(ROOT, "data",
                                "spe10like_toy_reference_cpu.json"),
       "nornetoy": os.path.join(ROOT, "data",
                                "nornelike_toy_reference_cpu.json"),
       "nornefull": os.path.join(ROOT, "data",
                                 "nornelike_full_reference_cpu.json")}
# report steps run per case (None: the whole schedule)
LIMIT = {"nornefull": 1}


def run_case(name):
    from opm_tpu.io.eclstate import load_case
    from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu.sim.testcases import norne_like_case, spe10like_case

    if name == "spe1":
        deck = dict(deck="data/SPE1CASE2.DATA")
        case = load_case(os.path.join(ROOT, deck["deck"]))
    elif name == "spe10toy":
        deck = dict(deck="sim/testcases.py spe10like_deck",
                    deck_kwargs=TOY_KWARGS)
        case = spe10like_case(**TOY_KWARGS)
    else:
        kw = NORNE_TOY_KWARGS if name == "nornetoy" else {}
        deck = dict(deck="sim/testcases.py norne_like_deck", deck_kwargs=kw)
        case = norne_like_case(**kw)
    sim = SimulatorFullyImplicitBlackoil(case, fused=False)
    # report_step_completed fires before the totals are updated: the
    # linear count at each signal closes the previous report step
    lin = []
    sim.events.event("report_step_completed").add(
        lambda s, step: lin.append(sim.report.linear_iterations))
    t0 = time.perf_counter()
    sim.run(report_step_limit=LIMIT.get(name))
    wall = time.perf_counter() - t0
    lin = lin[1:] + [sim.report.linear_iterations]
    lin = [b - a for a, b in zip([0] + lin[:-1], lin)]
    return sim, deck, wall, lin


def record(sim, deck, wall, lin, commit, jax_version):
    rows = sim.summary.rows
    steps = sim._step_timing      # (index, end_days, wall, subs, newtons)
    return dict(
        **deck,
        generator="tools/make_torch_reference.py",
        package="opm_tpu (JAX, CPU, per-step path)",
        linear_solver=sim.solver.linear_solver,
        commit=commit,
        jax_version=jax_version,
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--case", default="all",
                    choices=["spe1", "spe10toy", "nornetoy", "nornefull",
                             "all"])
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import opm_tpu  # noqa: F401  (x64)

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    for name in (["spe1", "spe10toy", "nornetoy"] if args.case == "all"
                 else [args.case]):
        if name.startswith("norne"):
            out = dict(deck="sim/testcases.py norne_like_deck",
                       deck_kwargs=(NORNE_TOY_KWARGS if name == "nornetoy"
                                    else {}),
                       report_step_limit=LIMIT.get(name))
            for rep, knob in (("embedded", None), ("gather", "0")):
                os.environ.pop("OPM_TPU_EMBED", None)
                if knob is not None:
                    os.environ["OPM_TPU_EMBED"] = knob
                sim, deck, wall, lin = run_case(name)
                out[rep] = record(sim, {}, wall, lin, commit,
                                  jax.__version__)
                out[rep].update(nc=int(sim.grid.nc),
                                n_real=int(sim.grid.n_real),
                                nf=int(sim.grid.face_cells.shape[0]))
                os.environ.pop("OPM_TPU_EMBED", None)
        else:
            sim, deck, wall, lin = run_case(name)
            out = record(sim, deck, wall, lin, commit, jax.__version__)
        with open(OUT[name], "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        for rep in ([out] if "report_steps" in out
                    else [out["embedded"], out["gather"]]):
            print(f"wrote {OUT[name]}: {rep['total_newtons']} Newtons, "
                  f"{rep['total_substeps']} substeps, "
                  f"{rep['failed_substeps']} failed, {rep['total_linear']} "
                  f"linear, {rep['wall_s_cpu']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
