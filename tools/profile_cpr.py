"""Profile the port's CPR Newton route on the card, report step 0, under
torch.profiler, after a warm-up of the same run:

- ``--deck spe10`` (default): SPE10-2, the seeded SPE10-like deck at
  60x220x85 = 1.122M cells;
- ``--deck norne``: the Norne-class corner-point field (norne_like_deck at
  its defaults, 46x112x22), parsed once, in each representation named by
  ``--representations``: ``embedded`` (OPM_TPU_EMBED unset: the full box,
  structured GMG) and ``gather`` (OPM_TPU_EMBED=0: the active cells,
  aggregation AMG).

Prints per run the wall of the profiled run, the device's busy time (the
sum of the CUDA kernels' and memory operations' self times) and its idle
share, and the time by kernel name (top entries); writes the same to
--out as JSON. The Newton loop's timed sections stay off (their
synchronizes would add idle time); chip_smoke.py reports those.

    python3 tools/profile_cpr.py [--deck spe10|norne]
        [--representations embedded,gather] [--out profile_cpr.json]
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
    ap.add_argument("--out", default=None)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--deck", default="spe10", choices=["spe10", "norne"])
    ap.add_argument("--representations", default="embedded,gather",
                    help="norne: comma list of embedded, gather")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_cpr: no CUDA device visible")
    sys.path.insert(0, ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.sim.testcases import norne_like_case, spe10like_case

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.deck == "spe10":
        case = spe10like_case(nx=60, ny=220, nz=85)
        runs = [("SPE10-2", None)]
    else:
        case = norne_like_case()
        knobs = {"embedded": None, "gather": "0"}
        runs = [(f"Norne-class {r}", knobs[r])
                for r in args.representations.split(",")]

    def fresh(knob):
        old = os.environ.pop("OPM_TPU_EMBED", None)
        if knob is not None:
            os.environ["OPM_TPU_EMBED"] = knob
        try:
            sim = SimulatorFullyImplicitBlackoil(case)
        finally:
            os.environ.pop("OPM_TPU_EMBED", None)
            if old is not None:
                os.environ["OPM_TPU_EMBED"] = old
        return sim, initial_state(sim.grid, sim.props, case,
                                  len(sim.well_names))

    out = dict(device=smi, runs=[])
    for label, knob in runs:
        sim, init = fresh(knob)
        sim.run(init, report_step_limit=1)      # warm-up: builds, JIT
        torch.cuda.synchronize()
        sim, init = fresh(knob)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim.run(init, report_step_limit=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []
        busy_us = 0.0
        for ev in prof.key_averages():
            # device-side events only (the CPU ops that launched them
            # carry the same time again)
            if ev.device_type != DeviceType.CUDA:
                continue
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
            if dev_us > 0:
                busy_us += dev_us
                rows.append((ev.key, ev.count, dev_us / 1e3))
        rows.sort(key=lambda r: -r[2])
        rep = sim.report
        run = dict(
            label=label, nc=sim.model.nc, wall_s=wall,
            newtons=rep.newton_iterations, linear=rep.linear_iterations,
            substeps=rep.substeps, failed=rep.failed_substeps,
            device_busy_s=busy_us / 1e6,
            device_idle_share=1.0 - busy_us / 1e6 / wall,
            top=[dict(name=n, calls=c, ms=m) for n, c, m in
                 rows[:args.top]])
        out["runs"].append(run)
        print(f"{smi}: {label} report step 0 under the profiler: "
              f"{wall:.2f} s wall, {rep.newton_iterations} Newtons, "
              f"{rep.linear_iterations} linear, {rep.substeps} substeps, "
              f"{rep.failed_substeps} failed")
        print(f"device busy {busy_us / 1e6:.3f} s, idle share "
              f"{run['device_idle_share']:.3f}")
        for n, c, m in rows[:args.top]:
            print(f"  {m:10.2f} ms {c:7d}x  {n[:90]}")
        del sim, init, prof
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
