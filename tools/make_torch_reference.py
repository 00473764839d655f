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

- data/wellctrl_reference_cpu.json: the small dense-route decks of the JAX
  package's tests of field-style controls (sim/testcases.py
  wellctrl_decks: THPRES defaulted and explicit, secondary-limit
  switching, the VFP datum correction, WTHP, a group ORAT target,
  WCONHIST/WCONINJH, MULTFLT mid-run), each run to the end its test uses;
- data/nornewells_reference_cpu.json: the Norne-like deck at the toy size
  (NORNE_TOY_KWARGS) under field-style controls (sim/testcases.py
  norne_field_controls: THP with a VFP table, a group ORAT target,
  WCONHIST RESV, WECON, WCONINJH, a RESV injector, THPRES between two
  EQLNUM regions, MULTFLT before the third report step), three report
  steps, in both representations, with the edit function's and the
  deck's sha256;
- data/nornewells_full_reference_cpu.json: the same deck at the full size
  (norne_like_deck at its defaults: 46x112x22, 75,566 active cells), its
  three report steps in both representations, with the same spread.

The wellctrl fixture records each deck twice: the reference as it runs
(compiled, "jit") and with jax_disable_jit (op by op, "eager"), whose
summation orders differ; on these decks the two can part by more than the
parity limits (the well equations' inner solve and the Newton tolerance
leave that much freedom), and the eager run is the one the port's CPU
path follows operation for operation (nornewells and nornewellsfull: the compiled run only,
with, per report step, the reference's own roundoff spread about it:
three runs with _UlpNoise's one-ulp state noise, their largest departure
of each summary vector and each well's WBHP and WTHP, and their counts).
Per report step both fixtures also keep WTHP and
each well's control code, the wells economic limits shut, and for the
THPRES decks the thresholds on the region interface.

Each runs opm_tpu.sim.blackoil.SimulatorFullyImplicitBlackoil on the CPU,
on its per-step path (fused=False), and records per report step the
Newton, substep and linear-iteration counts and FPR, FOPR, FWPR, FGOR and
WBHP, the totals, and the git commit it ran on.

    python tools/make_torch_reference.py
        [--case spe1|spe10toy|nornetoy|nornefull|spe3|wellctrl|nornewells
         |nornewellsfull|all]
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
       "spe3": os.path.join(ROOT, "data", "spe3_reference_cpu.json"),
       "wellctrl": os.path.join(ROOT, "data", "wellctrl_reference_cpu.json"),
       "nornewells": os.path.join(ROOT, "data",
                                  "nornewells_reference_cpu.json"),
       "nornewellsfull": os.path.join(ROOT, "data",
                                      "nornewells_full_reference_cpu.json")}
CONTROLS = ("wellctrl", "nornewells", "nornewellsfull")
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


def controls_spread(text, limit, base, seeds=SPREAD_SEEDS[:3]):
    """The nornewells runs' own roundoff spread about the compiled run
    ``base`` (run_controls' record): the deck run again once per seed of
    ``seeds`` with _UlpNoise, and per report step the largest
    relative departure of FPR, FOPR, FWPR (these two of the field's liquid
    rate), FGOR and of each well's WBHP and WTHP, and the (substeps,
    Newtons) counts the runs took."""
    out = []
    for seed in seeds:
        with _UlpNoise(seed):
            run = run_controls(text, limit, False)
        for k, (r, r0) in enumerate(zip(run["report_steps"],
                                        base["report_steps"])):
            if len(out) <= k:
                out.append(dict(counts=[], **{key: 0.0 for key in (
                    "FPR", "FOPR", "FWPR", "FGOR")},
                    WBHP=[0.0] * len(r0["WBHP"]),
                    WTHP=[0.0] * len(r0["WTHP"])))
            sp = out[k]
            liq = r0["FOPR"] + r0["FWPR"]
            for key in ("FPR", "FOPR", "FWPR", "FGOR"):
                scale = (max(abs(r0[key]), liq) if key in ("FOPR", "FWPR")
                         else abs(r0[key]))
                sp[key] = max(sp[key], abs(r[key] - r0[key])
                              / max(scale, 1e-30))
            for key in ("WBHP", "WTHP"):
                sp[key] = [max(a, abs(x - y) / abs(y) if y else abs(x))
                           for a, x, y in zip(sp[key], r[key], r0[key])]
            if [r["substeps"], r["newtons"]] not in sp["counts"]:
                sp["counts"].append([r["substeps"], r["newtons"]])
    return out


def run_controls(text, limit, eager):
    """One reference run of a field-controls deck (compiled, or op by op
    with ``eager``): the record() fields plus per report step WTHP, the
    control codes and the wells shut by economic limits, and the model's
    nonzero thresholds."""
    import jax

    from opm_tpu.io.eclstate import load_case_string
    from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil

    jax.config.update("jax_disable_jit", bool(eager))
    try:
        sim = SimulatorFullyImplicitBlackoil(load_case_string(text),
                                             fused=False)
        lin, ctrl, shut, zero = [], [], [], []

        def on_step(s, step):
            lin.append(sim.report.linear_iterations)
            ctrl.append([int(c) for c in np.asarray(s.control)])
            shut.append(sorted(sim._econ_shut))
            if sim.model.threshold_dp is not None and not zero:
                zero.append(thpres_zero_faces(sim, s))

        sim.events.event("report_step_completed").add(on_step)
        t0 = time.perf_counter()
        sim.run(report_step_limit=limit)
        wall = time.perf_counter() - t0
    finally:
        jax.config.update("jax_disable_jit", False)
    lin = lin[1:] + [sim.report.linear_iterations]
    lin = [b - a for a, b in zip([0] + lin[:-1], lin)]
    out = record(sim, {}, wall, lin, None, jax.__version__)
    del out["commit"], out["jax_version"], out["package"]
    # the econ check runs after the report-step event: shut[k] is what
    # step k - 1 shut
    shut = shut[1:] + [sorted(sim._econ_shut)]
    for k, (st, r) in enumerate(zip(out["report_steps"], sim.summary.rows)):
        st.update(WTHP=[float(r.get(f"WTHP:{n}", 0.0))
                        for n in sim.well_names],
                  control=ctrl[k], econ_shut=shut[k])
    thr = sim.model.threshold_dp
    if thr is not None:
        thr = np.asarray(thr)
        out["thresholds"] = sorted({float(v) for v in thr[thr > 0]})
        out["thpres_zero_faces_step1"] = zero[0] if zero else None
    return out


def thpres_zero_faces(sim, state):
    """(open faces on the EQLNUM interface, of them those the threshold
    holds at zero flow in every phase that would flow without it) at
    ``state``."""
    thr = np.asarray(sim.model.threshold_dp)
    q = sim.model.cell_quantities(state)
    flux = np.asarray(sim.model.face_fluxes(q, sim.model.threshold_dp))
    free = np.asarray(sim.model.face_fluxes(q))
    on = (thr > 0) & (np.asarray(sim.model.trans) > 0)
    held = on & np.all(flux == 0.0, axis=0) & np.any(free != 0.0, axis=0)
    return [int(on.sum()), int(held.sum())]


def controls_fixture(name, commit, only=None, seeds=SPREAD_SEEDS[:3]):
    """The wellctrl, nornewells or nornewellsfull fixture (module
    docstring); ``only``: the decks (wellctrl) or representations (the
    Norne-class ones) to run (all by default); ``seeds``: those of the
    Norne-class runs' roundoff spread."""
    import hashlib
    import inspect

    import jax

    from opm_tpu_torch.sim import testcases as port_cases

    if name == "wellctrl":
        decks = {k: dict(deck=t, report_step_limit=lim)
                 for k, (t, lim) in port_cases.wellctrl_decks().items()
                 if only is None or k in only}
        out = dict(decks="opm_tpu_torch/sim/testcases.py wellctrl_decks")
    else:
        from opm_tpu.sim.testcases import norne_like_deck

        kw = NORNE_TOY_KWARGS if name == "nornewells" else {}
        base = norne_like_deck(**kw)
        if base != port_cases.norne_like_deck(**kw):
            raise SystemExit("the two packages' norne_like_deck differ")
        text = port_cases.norne_field_controls(base)
        src = inspect.getsource(port_cases.norne_field_controls)
        out = dict(deck="opm_tpu_torch/sim/testcases.py norne_field_controls"
                   "(norne_like_deck(**deck_kwargs))",
                   deck_kwargs=kw,
                   edit_sha256=hashlib.sha256(src.encode()).hexdigest(),
                   deck_sha256=hashlib.sha256(text.encode()).hexdigest())
        decks = {}
        for rep, knob in (("embedded", None), ("gather", "0")):
            if only is None or rep in only:
                decks[rep] = dict(deck=text, report_step_limit=3, knob=knob)
    out.update(generator="tools/make_torch_reference.py",
               package="opm_tpu (JAX, CPU, per-step path)", commit=commit,
               jax_version=jax.__version__, runs={})
    for key, d in decks.items():
        os.environ.pop("OPM_TPU_EMBED", None)
        if d.get("knob") is not None:
            os.environ["OPM_TPU_EMBED"] = d["knob"]
        try:
            run = {m: run_controls(d["deck"], d["report_step_limit"],
                                   m == "eager")
                   for m in (("jit", "eager") if name == "wellctrl"
                             else ("jit",))}
        finally:
            os.environ.pop("OPM_TPU_EMBED", None)
        entry = dict(report_step_limit=d["report_step_limit"], **run)
        if name == "wellctrl":
            entry["deck"] = d["deck"]
        else:
            os.environ.pop("OPM_TPU_EMBED", None)
            if d.get("knob") is not None:
                os.environ["OPM_TPU_EMBED"] = d["knob"]
            try:
                entry["spread_seeds"] = list(seeds)
                entry["spread"] = controls_spread(
                    d["deck"], d["report_step_limit"], run["jit"], seeds)
            finally:
                os.environ.pop("OPM_TPU_EMBED", None)
        out["runs"][key] = entry
        for m, r in run.items():
            print(f"{name} {key} {m}: {r['total_newtons']} Newtons, "
                  f"{r['total_substeps']} substeps, {r['failed_substeps']} "
                  f"failed, {r['wall_s_cpu']:.1f} s"
                  + (f", THPRES faces (interface, held at 0) "
                     f"{r['thpres_zero_faces_step1']}"
                     if r.get("thpres_zero_faces_step1") else ""),
                  flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--case", default="all",
                    choices=["spe1", "spe10toy", "nornetoy", "nornefull",
                             "spe3", *CONTROLS, "all"])
    ap.add_argument("--decks", default=None,
                    help="wellctrl or nornewells(full): only these decks or "
                    "representations (comma list), into --out")
    ap.add_argument("--out", default=None,
                    help="write the fixture here instead")
    ap.add_argument("--spread-seeds", default=None,
                    help="nornewells(full): the seeds of the roundoff "
                    "spread's runs (comma list; default 1,2,3)")
    ap.add_argument("--merge", default=None,
                    help="wellctrl or nornewells(full) (--case): merge these "
                    "partial fixtures (comma list) into the fixture")
    args = ap.parse_args(argv)
    if args.merge:
        parts = []
        for f in args.merge.split(","):
            with open(f) as fh:
                parts.append(json.load(fh))
        out = dict(parts[0], runs={})
        for part in parts:
            out["runs"].update(part["runs"])
        if args.case == "wellctrl":
            from opm_tpu_torch.sim.testcases import wellctrl_decks
            out["runs"] = {k: out["runs"][k] for k in wellctrl_decks()}
        with open(args.out or OUT[args.case], "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        return 0

    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import opm_tpu  # noqa: F401  (x64)

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    for name in (["spe1", "spe10toy", "nornetoy", "spe3", "wellctrl",
                  "nornewells"]
                 if args.case == "all" else [args.case]):
        if name in CONTROLS:
            out = controls_fixture(
                name, commit,
                args.decks.split(",") if args.decks else None,
                tuple(int(x) for x in args.spread_seeds.split(","))
                if args.spread_seeds else SPREAD_SEEDS[:3])
            with open(args.out or OUT[name], "w") as f:
                json.dump(out, f, indent=1)
                f.write("\n")
            print(f"wrote {args.out or OUT[name]}")
            continue
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
