"""output_ab: the cost of the output layer on the card, legs in turns.

    python3 -m opm_tpu_torch.tools.output_ab [--deck data/SPE1CASE2.DATA]
        [--order ABBA] [--out FILE]

Leg A runs the deck's whole schedule with output off, leg B with output
on into a temporary directory (the PRT, summary and ECL files,
``write_restart``, ``write_vtk``, ``write_matlab``), each through a fresh
``SimulatorFullyImplicitBlackoil`` on the card after one warm-up run of
two report steps. Per leg: the wall of ``run()`` (host clock, ending in a
synchronize), the counts and the final state's digest (every leg must
give the same), the main thread's seconds inside the summary row
(``SummaryCollector.record``), the report step's output
(``_write_step_outputs``: derived arrays, one pull, queueing) and the
end-of-run files (``_write_run_outputs``), and the writer thread's
seconds inside its jobs (.npz, VTK, Matlab). Prints one JSON line per leg
and a summary line with the median wall of each kind and their ratio,
beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time


def digest(state):
    h = hashlib.sha256()
    for name in state._fields:
        t = getattr(state, name)
        if t is not None:
            h.update(name.encode())
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def timed_writers(acc):
    """The writer thread's jobs timed into acc["writer_s"]."""
    from opm_tpu_torch.io import matlab, restart, vtk
    plain = [(restart, "save_restart"), (vtk, "write_vtr"),
             (matlab, "output_state_matlab"),
             (matlab, "output_well_state_matlab")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in plain]

    def wrap(fn):
        def job(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc["writer_s"] += time.perf_counter() - t0
        return job

    for mod, name, fn in saved:
        setattr(mod, name, wrap(fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def timed_method(obj, attr, acc, key):
    fn = getattr(obj, attr)

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[key] += time.perf_counter() - t0
    setattr(obj, attr, wrapped)


def leg(case, output: bool):
    import torch

    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    d = tempfile.mkdtemp(prefix="output_ab_") if output else None
    acc = dict(record_s=0.0, step_output_s=0.0, run_output_s=0.0,
               writer_s=0.0)
    try:
        sim = SimulatorFullyImplicitBlackoil(case, output_dir=d)
        timed_method(sim.summary, "record", acc, "record_s")
        timed_method(sim, "_write_step_outputs", acc, "step_output_s")
        timed_method(sim, "_write_run_outputs", acc, "run_output_s")
        kw = (dict(write_restart=True, write_vtk=True, write_matlab=True)
              if output else {})
        with timed_writers(acc):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            end = sim.run(**kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rep = sim.report
        files = sorted(os.listdir(d)) if output else []
        size = (sum(os.path.getsize(os.path.join(r, f))
                    for r, _, fs in os.walk(d) for f in fs)
                if output else 0)
        return dict(output=output, wall_s=wall,
                    report_steps=len(sim.summary.rows),
                    newtons=rep.newton_iterations, substeps=rep.substeps,
                    failed=rep.failed_substeps, digest=digest(end),
                    files=len(files), bytes=size, **acc)
    finally:
        if d is not None:
            shutil.rmtree(d, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--deck", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "data", "SPE1CASE2.DATA"))
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("output_ab: no CUDA device visible")
    from opm_tpu_torch.io.eclstate import load_case
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    case = load_case(args.deck)
    # warm-up: the kernels' build and first calls
    SimulatorFullyImplicitBlackoil(case).run(report_step_limit=2)
    legs = []
    for k in args.order:
        r = leg(case, output=(k == "B"))
        r["leg"] = k
        legs.append(r)
        print(json.dumps(r), flush=True)
    if len({(r["digest"], r["newtons"], r["substeps"], r["failed"])
            for r in legs}) != 1:
        raise SystemExit("output_ab: the legs' counts or final states "
                         "differ")
    walls = {k: [r["wall_s"] for r in legs if r["leg"] == k] for k in "AB"}
    med = {k: statistics.median(v) for k, v in walls.items() if v}
    summary = dict(deck=os.path.basename(args.deck), device=smi,
                   walls_off_s=walls["A"], walls_on_s=walls["B"],
                   median_off_s=med.get("A"), median_on_s=med.get("B"))
    if "A" in med and "B" in med:
        summary["ratio"] = med["B"] / med["A"]
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(legs=legs, summary=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
