"""SPE3's condensate onset, Newton by Newton, in the JAX package and the
port (CPU, float64): where the two trajectories part and why.

Both packages run data/SPE3.DATA from the reference's initial state to
the start of the first report step with condensate (report step 7, 150
days), then that step's only substep Newton by Newton, three ways:

- each package from its own state (its own trajectory): per update the
  largest relative difference of pressure, sw, x (sg) and bhp, and the
  cell where it is largest;
- the port from the reference's state at each update: the same
  differences (the port's physics at the onset);
- the reference from its own state with one field (sw, then x) moved up
  one ulp in every cell: the largest change of its own update's x.

Then both packages' whole schedules from that initial state: per report
step the relative difference of FPR and FOPR and the substep and Newton
counts.

    python tools/spe3_onset.py        # about 1 min
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE3 = os.path.join(ROOT, "data", "SPE3.DATA")
ONSET = 7


def main():
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from opm_tpu.io.eclstate import load_case as ref_load_case
    from opm_tpu.models.blackoil import make_well_device_arrays as ref_wd
    from opm_tpu.models.state import BlackoilState as RefState
    from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil as RefSim
    from opm_tpu.sim.init import initial_state
    from opm_tpu_torch.io.eclstate import load_case
    from opm_tpu_torch.models.blackoil import make_well_device_arrays
    from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                            report_step_wells)
    from opm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

    torch.set_num_threads(4)

    def np_state(s):
        return {f: (None if getattr(s, f) is None
                    else np.asarray(getattr(s, f))) for f in s._fields}

    def ref_state(d):
        return RefState(**{f: (None if v is None else jnp.asarray(v))
                           for f, v in d.items()})

    def diff(a, b):
        out = []
        for f in ("pressure", "sw", "x", "bhp"):
            d = np.abs(a[f] - b[f])
            c = int(d.argmax())
            out.append(f"{f} {d.max() / np.abs(b[f]).max():.2e} "
                       f"(cell {c})")
        return ", ".join(out)

    ref = RefSim(ref_load_case(SPE3), fused=False)
    port = SimulatorFullyImplicitBlackoil(load_case(SPE3), device="cpu")
    s0 = initial_state(ref.grid, ref.props, ref.case, len(ref.well_names))
    starts = []
    ref.events.event("report_step_completed").add(
        lambda s, step: starts.append(np_state(s)))
    ref.run(s0, report_step_limit=ONSET)

    step = ref.schedule.report_steps[ONSET]
    ws_r = ref._pad_well_set(ref._well_set_for(step))
    wd_r = ref_wd(ws_r, ref.grid.gravity)
    ws_p = report_step_wells(step, port.grid, port.well_names,
                             port.max_perf)
    wd_p = make_well_device_arrays(ws_p, port.grid.gravity, "cpu")
    rsol, psol = ref.solver, port.solver
    dt = step.end_time - step.start_time
    dtj = jnp.asarray(dt, dtype=jnp.float64)
    s_r = ref._init_well_state(ref_state(starts[-1]), ws_r, False)
    s_p = state_from_numpy(np_state(s_r), "cpu")
    acc0_r = ref.model.accumulation(s_r)
    acc0_p = port.model.accumulation(s_p)
    cdp_r, cdp_p = rsol._cdp_jit(s_r, wd_r), psol._cdp(s_p, wd_p)
    s_r = rsol._welleq_jit(s_r, acc0_r, dtj, wd_r, cdp_r)
    s_p = state_from_numpy(np_state(s_r), "cpu")
    print(f"report step {ONSET} ({step.end_time / 86400:.0f} d), "
          f"dt {dt / 86400:.0f} d")
    for it in range(3):
        _, _, ctrl, tgt = rsol._assemble_jit(s_r, acc0_r, dtj, wd_r, cdp_r)
        _, _, ctrl_p, tgt_p = psol._assemble(s_p, acc0_p, dt, wd_p, cdp_p)
        s_in = s_r._replace(control=ctrl, target=tgt)

        def solve(s):
            return np_state(rsol._solve_jit(s, acc0_r, dtj, wd_r, cdp_r,
                                            jnp.asarray(1.0))[0])

        sr = solve(s_in)
        own = state_to_numpy(psol._solve_dense(
            s_p._replace(control=ctrl_p, target=tgt_p), acc0_p, dt, wd_p,
            cdp_p, 1.0))
        from_ref = state_to_numpy(psol._solve_dense(
            state_from_numpy(np_state(s_in), "cpu"), acc0_p, dt, wd_p,
            cdp_p, 1.0))
        ulp = {f: float(np.abs(solve(s_in._replace(**{f: jnp.nextafter(
            getattr(s_in, f), jnp.inf)}))["x"] - sr["x"]).max())
            for f in ("sw", "x")}
        counts = np.bincount(sr["hcstate"], minlength=3).tolist()
        print(f"update {it + 1}: hcstate counts {counts}")
        print(f"  own trajectories:        {diff(own, sr)}")
        print(f"  port from the reference: {diff(from_ref, sr)}")
        print(f"  one ulp in the reference's sw, x: its own x moves "
              f"{ulp['sw']:.2e}, {ulp['x']:.2e}")
        s_r = ref_state(sr)
        s_p = state_from_numpy(own, "cpu")

    ref = RefSim(ref_load_case(SPE3), fused=False)
    port = SimulatorFullyImplicitBlackoil(load_case(SPE3), device="cpu")
    ref.run(s0)
    port.run(state_from_numpy(np_state(s0), "cpu"))
    print("whole schedule from the reference's initial state "
          "(step: FPR, FOPR relative; substeps/Newtons ref, port)")
    for k, (rr, rp, tr, tp) in enumerate(zip(
            ref.summary.rows, port.summary.rows, ref._step_timing,
            port._step_timing)):
        print(f"  {k:2d}: {abs(rp['FPR'] - rr['FPR']) / rr['FPR']:.2e} "
              f"{abs(rp['FOPR'] - rr['FOPR']) / rr['FOPR']:.2e}  "
              f"{tr[3]}/{tr[4]} {tp[3]}/{tp[4]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
