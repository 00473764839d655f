"""EQUIL's column march in the JAX package, jitted against eager, and the
port's twin against both (CPU).

    python tools/equil_jit_eager.py [--nz 200] [--decks spe1,spe9,...]

For each deck the JAX package's ``equilibrate_region`` runs twice on a
depth grid of ``--nz`` points (its ``_NZ`` set at run time): as it runs
(its two masked ``lax.scan``s compiled by XLA) and under
``jax.disable_jit()`` (op by op). Its three columns are recorded from its
``_integrate_column``. Printed per deck: the largest relative gap between
the jitted and the eager columns and region outputs (pressure, sw, sg,
rs, rv), the eager run's seconds and seconds per density evaluation (its
scans evaluate every step both ways: 12 (nz - 1) + 3 evaluations), and,
where the port runs the deck, whether the port's twin
(``sim/init.py`` ``equil_columns_plain``) and ``equilibrate_region`` equal
the eager run bit for bit.

Decks: SPE1, SPE1 with PBVD in place of RSVD, SPE1CASE2_2P, the toy
SPE10-like and Norne-like decks, SPE9 and SPE3 (the port stops at SPE3's
PVTG).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = ("spe1", "spe1_pbvd", "spe1_2p", "spe10_toy", "norne_toy", "spe9",
         "spe3")


def deck(name):
    from opm_tpu_torch.sim.testcases import (norne_like_deck,
                                             spe1_pbvd_deck, spe10like_deck)
    files = dict(spe1="SPE1CASE2.DATA", spe1_2p="SPE1CASE2_2P.DATA",
                 spe9="SPE9.DATA", spe3="SPE3.DATA")
    if name == "spe10_toy":
        return spe10like_deck(nx=15, ny=44, nz=4, tsteps="3*1")
    if name == "norne_toy":
        return norne_like_deck(nx=12, ny=24, nz=22, tsteps="1 2 5")
    with open(os.path.join(ROOT, "data",
                           files.get(name, "SPE1CASE2.DATA"))) as f:
        text = f.read()
    return spe1_pbvd_deck(text) if name == "spe1_pbvd" else text


def rel(a, b):
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    d = np.abs(a - b)
    nz = d != 0
    return float(np.max(d[nz] / np.abs(b[nz]), initial=0.0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nz", type=int, default=200)
    ap.add_argument("--decks", default=",".join(DECKS))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    import opm_tpu  # noqa: F401  (float64)
    import opm_tpu.sim.init as ref_init
    from opm_tpu.grid import build_grid as ref_build_grid
    from opm_tpu.io.eclstate import load_case_string as ref_load
    from opm_tpu.props.blackoil import BlackoilProps as RefProps
    from opm_tpu_torch.grid.grid import build_grid
    from opm_tpu_torch.io.eclstate import load_case_string
    from opm_tpu_torch.props.blackoil import BlackoilProps
    from opm_tpu_torch.sim import init as port_init

    torch.set_num_threads(2)
    ref_init._NZ = port_init._NZ = args.nz
    march = ref_init._integrate_column
    cols = []

    def recorded(z, z0, p0, rho_fn):
        out = march(z, z0, p0, rho_fn)
        cols.append(np.asarray(out))
        return out

    ref_init._integrate_column = recorded
    for name in args.decks.split(","):
        text = deck(name)
        case = ref_load(text)
        grid = ref_build_grid(case)
        props = RefProps.from_case(case)
        sol = case.solution
        cells = np.nonzero(np.asarray(grid.eqlnum) == 0)[0]
        kw = dict(rsvd=sol.rsvd[0] if sol.rsvd else None,
                  pbvd=sol.pbvd[0] if sol.pbvd else None)
        runs = {}
        for how in ("eager", "jit"):
            cols.clear()
            t0 = time.perf_counter()
            if how == "eager":
                with jax.disable_jit():
                    out = ref_init.equilibrate_region(grid, props,
                                                      sol.equil[0], cells,
                                                      **kw)
            else:
                out = ref_init.equilibrate_region(grid, props, sol.equil[0],
                                                  cells, **kw)
            runs[how] = (np.stack(cols), [np.asarray(a) for a in out],
                         time.perf_counter() - t0)
        (ce, oe, te), (cj, oj, _) = runs["eager"], runs["jit"]
        line = (f"{name}: jitted vs eager columns {rel(cj, ce):.3e}, "
                "outputs " + ", ".join(f"{rel(a, b):.3e}"
                                       for a, b in zip(oj, oe))
                + f"; eager {te:.1f} s, "
                f"{te / (12 * (args.nz - 1) + 3):.4f} s a density")
        try:
            pcase = load_case_string(text)
            pgrid = build_grid(pcase)
            pprops = BlackoilProps.from_case(pcase, "cpu")
        except NotImplementedError as e:
            print(f"{line}; the port: {e}", flush=True)
            continue
        psol = pcase.solution
        pkw = dict(rsvd=psol.rsvd[0] if psol.rsvd else None,
                   pbvd=psol.pbvd[0] if psol.pbvd else None)
        a = port_init.march_args(pgrid, pprops, psol.equil[0], cells, **pkw)
        twin = port_init.equil_columns_plain(*a).numpy()
        pout = port_init.equilibrate_region(pgrid, pprops, psol.equil[0],
                                            cells, **pkw)
        same = np.array_equal(twin, ce) and all(
            np.array_equal(p.numpy(), b) for p, b in zip(pout, oe))
        print(f"{line}; the port's twin and outputs == eager: {same}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
