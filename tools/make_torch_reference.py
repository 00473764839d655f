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
  its first report step (5 days) in both representations;
- data/spe3_reference_cpu.json: the SPE3 gas-condensate deck
  (data/SPE3.DATA: VAPOIL, PVTG, RVVD; 324 cells, dense route), its whole
  720-day schedule (depletion, dry-gas reinjection, blowdown), with per
  report step also FGPR, FGIR, the failed substeps and the count of GASOIL
  cells, and a digest of the initial state; and the reference's own
  roundoff spread: the same schedule run again SPREAD_SEEDS times, each
  with a fixed seeded pattern of one-ulp changes to sw and x after every
  Newton update (the size of the difference two machines' summation
  orders make), and per report step the largest departure of those runs
  from the unperturbed one (FPR, FOPR, FGPR, FGIR relative; x of the cells
  GASOIL in both, absolute) and the (substeps, Newtons) counts they took.

Each runs opm_tpu.sim.blackoil.SimulatorFullyImplicitBlackoil on the CPU,
on its per-step path (fused=False), and records per report step the
Newton, substep and linear-iteration counts and FPR, FOPR, FWPR, FGOR and
WBHP, the totals, and the git commit it ran on.

    python tools/make_torch_reference.py
        [--case spe1|spe10toy|nornetoy|nornefull|spe3|all]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

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
                                 "nornelike_full_reference_cpu.json"),
       "spe3": os.path.join(ROOT, "data", "spe3_reference_cpu.json")}
# report steps run per case (None: the whole schedule)
LIMIT = {"nornefull": 1}
# the seeds of SPE3's runs with one-ulp state noise (its roundoff spread)
SPREAD_SEEDS = (1, 2, 3, 4, 5, 6)


def run_case(name):
    from opm_tpu.io.eclstate import load_case
    from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu.sim.testcases import norne_like_case, spe10like_case

    if name in ("spe1", "spe3"):
        deck = dict(deck="data/SPE1CASE2.DATA" if name == "spe1"
                    else "data/SPE3.DATA")
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
    # linear (and failed-substep) count at each signal closes the previous
    # report step
    lin, failed, gasoil, states = [], [], [], []

    def on_step(s, step):
        lin.append(sim.report.linear_iterations)
        failed.append(sim.report.failed_substeps)
        gasoil.append(int((np.asarray(s.hcstate) == 0).sum()))
        states.append((np.asarray(s.hcstate), np.asarray(s.x)))

    sim.events.event("report_step_completed").add(on_step)
    t0 = time.perf_counter()
    sim.run(report_step_limit=LIMIT.get(name))
    wall = time.perf_counter() - t0

    def per_step(tot, last):
        tot = tot[1:] + [last]
        return [b - a for a, b in zip([0] + tot[:-1], tot)]

    sim.per_step = dict(failed=per_step(failed, sim.report.failed_substeps),
                        gasoil=gasoil, states=states)
    return sim, deck, wall, per_step(lin, sim.report.linear_iterations)


class _UlpNoise:
    """Inside the block, the JAX package's Newton update (as its solver
    module calls it) is followed by a seeded pattern of one-ulp changes:
    each cell's sw and x move one ulp up, one ulp down or not at all. The
    pattern is drawn when the update is traced, so it is the same at every
    Newton of a run. Nothing of the JAX package is edited."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __enter__(self):
        import jax.numpy as jnp
        import opm_tpu.solver.newton as nt
        self.nt, self.orig = nt, nt.update_state
        orig, rng = self.orig, self.rng

        def noisy(model, state, du):
            s = orig(model, state, du)
            moved = {}
            for f in ("sw", "x"):
                v = getattr(s, f)
                d = jnp.asarray(rng.choice([-np.inf, 0.0, np.inf],
                                           v.shape[0]))
                moved[f] = jnp.where(d == 0.0, v, jnp.nextafter(v, d))
            return s._replace(**moved)

        nt.update_state = noisy
        return self

    def __exit__(self, *exc):
        self.nt.update_state = self.orig


def spe3_spread(base):
    """SPE3's roundoff spread (module docstring) about the unperturbed
    run ``base`` (its rows, and its end states per report step)."""
    from opm_tpu.io.eclstate import load_case
    from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil

    rows0, states0 = base
    keys = ("FPR", "FOPR", "FGPR", "FGIR")
    n = len(rows0)
    dev = {k: [0.0] * n for k in keys}
    dx = [0.0] * n
    counts = [set() for _ in range(n)]
    for seed in SPREAD_SEEDS:
        with _UlpNoise(seed):
            sim = SimulatorFullyImplicitBlackoil(
                load_case(os.path.join(ROOT, "data", "SPE3.DATA")),
                fused=False)
            ends = []
            sim.events.event("report_step_completed").add(
                lambda s, step: ends.append(
                    (np.asarray(s.hcstate), np.asarray(s.x))))
            sim.run()
        for i, (r, r0, st, (hc, x), (hc0, x0)) in enumerate(zip(
                sim.summary.rows, rows0, sim._step_timing, ends, states0)):
            for k in keys:
                d = abs(r[k] - r0[k])
                dev[k][i] = max(dev[k][i], d / abs(r0[k]) if r0[k] else d)
            both = (hc == 0) & (hc0 == 0)
            if both.any():
                dx[i] = max(dx[i], float(np.abs(x - x0)[both].max()))
            counts[i].add((int(st[3]), int(st[4])))
    return [dict(**{k: dev[k][i] for k in keys}, x_gasoil=dx[i],
                 counts=sorted(list(c) for c in counts[i]))
            for i in range(n)]


def state_digest(state):
    """sha256 (16 hex digits) of a state's cell arrays (pressure, sw, x
    as float64, hcstate as int32, in that order), with the arrays' ranges
    for a comparison at a tolerance."""
    import hashlib

    h = hashlib.sha256()
    arrs = [np.asarray(state.pressure, np.float64),
            np.asarray(state.sw, np.float64), np.asarray(state.x, np.float64),
            np.asarray(state.hcstate, np.int32)]
    for a in arrs:
        h.update(np.ascontiguousarray(a).tobytes())
    return dict(sha256=h.hexdigest()[:16],
                **{f"{k}_{f.__name__}": float(f(a)) for k, a in
                   zip(("pressure", "sw", "x"), arrs[:3])
                   for f in (np.min, np.max, np.mean)},
                hc_counts=[int((arrs[3] == k).sum()) for k in range(3)])


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


def record_spe3(sim, deck, wall, lin, commit, jax_version, state0):
    """The SPE3 fixture: record()'s fields, and per report step FGPR,
    FGIR, the failed substeps and the GASOIL cells; the initial state's
    digest."""
    out = record(sim, deck, wall, lin, commit, jax_version)
    for k, (st, r) in enumerate(zip(out["report_steps"], sim.summary.rows)):
        st.update(FGPR=float(r["FGPR"]), FGIR=float(r["FGIR"]),
                  failed=int(sim.per_step["failed"][k]),
                  gasoil_cells=int(sim.per_step["gasoil"][k]))
    out["initial_state"] = state_digest(state0)
    out["spread_seeds"] = list(SPREAD_SEEDS)
    for st, sp in zip(out["report_steps"],
                      spe3_spread((sim.summary.rows, sim.per_step["states"]))):
        st["spread"] = sp
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--case", default="all",
                    choices=["spe1", "spe10toy", "nornetoy", "nornefull",
                             "spe3", "all"])
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import opm_tpu  # noqa: F401  (x64)

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    for name in (["spe1", "spe10toy", "nornetoy", "spe3"]
                 if args.case == "all" else [args.case]):
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
        elif name == "spe3":
            from opm_tpu.sim.init import initial_state

            sim, deck, wall, lin = run_case(name)
            state0 = initial_state(sim.grid, sim.props, sim.case,
                                   len(sim.well_names))
            out = record_spe3(sim, deck, wall, lin, commit, jax.__version__,
                              state0)
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
