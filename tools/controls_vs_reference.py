"""Hold the port's run of a Norne field-controls fixture's deck
(data/nornewells_reference_cpu.json or its full-size twin) to the
fixture, on the CPU by default: per report step the (substeps, Newtons)
counts, the control codes, and the relative departures of FPR, FOPR, FWPR
(these two of the field's liquid rate), FGOR and each well's WBHP and
WTHP from the reference's compiled run, printed beside the reference's
own roundoff spread at that step (the fixture's runs with one-ulp state
noise). A witness for chip_smoke.py's phase 8 that needs no card.

    python tools/controls_vs_reference.py
        [--fixture data/nornewells_reference_cpu.json]
        [--representations embedded,gather] [--device cpu] [--threads 4]
        [--out FILE]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOB = {"embedded": "auto", "gather": "0"}


def departures(row, ref):
    """Relative departures of one summary row from the reference's step,
    as chip_smoke.hold_controls measures them."""
    out = {}
    liq = ref["FOPR"] + ref["FWPR"]
    for k in ("FPR", "FOPR", "FWPR", "FGOR"):
        scale = max(abs(ref[k]), liq) if k in ("FOPR", "FWPR") \
            else abs(ref[k])
        out[k] = abs(row[k] - ref[k]) / max(scale, 1e-30)
    return out


def well_departures(row, ref, names, key):
    return [abs(row.get(f"{key}:{n}", 0.0) - w) / abs(w) if w
            else abs(row.get(f"{key}:{n}", 0.0))
            for n, w in zip(names, ref[key])]


def run(fx, rep, device):
    import torch

    from opm_tpu_torch.io.eclstate import load_case_string
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.sim.testcases import (norne_field_controls,
                                             norne_like_deck)

    text = norne_field_controls(norne_like_deck(**fx["deck_kwargs"]))
    if hashlib.sha256(text.encode()).hexdigest() != fx["deck_sha256"]:
        raise SystemExit("the deck is not the fixture's")
    prev = os.environ.get("OPM_TPU_EMBED")
    os.environ["OPM_TPU_EMBED"] = KNOB[rep]
    try:
        sim = SimulatorFullyImplicitBlackoil(load_case_string(text),
                                             device=device)
    finally:
        os.environ.pop("OPM_TPU_EMBED")
        if prev is not None:
            os.environ["OPM_TPU_EMBED"] = prev
    ctrl = []
    sim.events.event("report_step_completed").add(
        lambda s, step: ctrl.append(s.control.tolist()))
    t0 = time.perf_counter()
    sim.run(report_step_limit=fx["runs"][rep]["report_step_limit"])
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref = fx["runs"][rep]["jit"]["report_steps"]
    spread = fx["runs"][rep].get("spread") or [None] * len(ref)
    steps = []
    for j, (row, r, sp, t, c) in enumerate(zip(
            sim.summary.rows, ref, spread, sim._step_timing, ctrl)):
        d = departures(row, r)
        st = dict(step=j + 1, counts=[int(t[3]), int(t[4])],
                  ref_counts=[r["substeps"], r["newtons"]],
                  spread_counts=sp["counts"] if sp else None,
                  controls_equal=c == r["control"], **d)
        for key in ("WBHP", "WTHP"):
            w = well_departures(row, r, sim.well_names, key)
            i = max(range(len(w)), key=w.__getitem__)
            st[key] = w[i]
            st[key + "_well"] = sim.well_names[i]
            st[key + "_spread"] = sp[key][i] if sp else None
        if sp:
            st["spread"] = {k: sp[k] for k in ("FPR", "FOPR", "FWPR",
                                               "FGOR")}
        steps.append(st)
    return dict(representation=rep, device=device, wall_s=wall,
                newtons=sim.report.newton_iterations,
                substeps=sim.report.substeps, steps=steps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fixture", default=os.path.join(
        "data", "nornewells_reference_cpu.json"))
    ap.add_argument("--representations", default="embedded,gather")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(args.threads)
    with open(os.path.join(ROOT, args.fixture)
              if not os.path.isabs(args.fixture) else args.fixture) as f:
        fx = json.load(f)
    res = []
    for rep in args.representations.split(","):
        r = run(fx, rep, args.device)
        res.append(r)
        print(f"{rep} on {args.device}: {r['wall_s']:.1f} s, "
              f"{r['newtons']} Newtons, {r['substeps']} substeps")
        for st in r["steps"]:
            sp = st.get("spread") or {}
            print(f"  step {st['step']}: counts {st['counts']} (reference "
                  f"{st['ref_counts']}, its noise runs "
                  f"{st['spread_counts']}), control codes "
                  f"{'equal' if st['controls_equal'] else 'DIFFER'}; "
                  "departure (reference's spread): " + ", ".join(
                      f"{k} {st[k]:.3e} ({sp.get(k, float('nan')):.3e})"
                      for k in ("FPR", "FOPR", "FWPR", "FGOR"))
                  + "".join(
                      f", {k} {st[k]:.3e} at {st[k + '_well']} "
                      f"({st[k + '_spread'] or 0.0:.3e})"
                      for k in ("WBHP", "WTHP")))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
