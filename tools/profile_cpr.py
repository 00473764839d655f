"""Profile the port's CPR Newton route on the card: SPE10-2 (the seeded
SPE10-like deck at 60x220x85 = 1.122M cells), report step 0, under
torch.profiler, after a warm-up of the same run.

Prints the wall of the profiled run, the device's busy time (the sum of
the CUDA kernels' and memory operations' self times) and its idle share,
and the time by kernel name (top entries); writes the same to --out as
JSON. The Newton loop's timed sections stay off (their synchronizes would
add idle time); chip_smoke.py reports those.

    python3 tools/profile_cpr.py [--out profile_cpr.json]
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
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_cpr: no CUDA device visible")
    sys.path.insert(0, ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.sim.testcases import spe10like_case

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    case = spe10like_case(nx=60, ny=220, nz=85)

    def fresh():
        sim = SimulatorFullyImplicitBlackoil(case)
        return sim, initial_state(sim.grid, sim.props, case,
                                  len(sim.well_names))

    sim, init = fresh()
    sim.run(init, report_step_limit=1)          # warm-up: builds, JIT
    torch.cuda.synchronize()
    sim, init = fresh()
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
        # device-side events only (the CPU ops that launched them carry
        # the same time again)
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            busy_us += dev_us
            rows.append((ev.key, ev.count, dev_us / 1e3))
    rows.sort(key=lambda r: -r[2])
    rep = sim.report
    out = dict(
        device=smi, wall_s=wall, newtons=rep.newton_iterations,
        linear=rep.linear_iterations, substeps=rep.substeps,
        failed=rep.failed_substeps, device_busy_s=busy_us / 1e6,
        device_idle_share=1.0 - busy_us / 1e6 / wall,
        top=[dict(name=n, calls=c, ms=m) for n, c, m in rows[:args.top]])
    print(f"{smi}: SPE10-2 report step 0 under the profiler: {wall:.2f} s "
          f"wall, {rep.newton_iterations} Newtons, {rep.linear_iterations} "
          f"linear, {rep.substeps} substeps, {rep.failed_substeps} failed")
    print(f"device busy {busy_us / 1e6:.3f} s, idle share "
          f"{out['device_idle_share']:.3f}")
    for n, c, m in rows[:args.top]:
        print(f"  {m:10.2f} ms {c:7d}x  {n[:90]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
