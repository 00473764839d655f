"""compare_ecl: summary/restart regression comparison with tolerances.

Counterpart of the reference's regression-test driver (`compare_ecl` tool
invoked by tests/run-regressionTest.sh and compareECLFiles.cmake:83-150:
compare summary and restart files of a run against reference results with
absolute + relative tolerances; the SPE1/SPE9 CI gates). Works on the
framework's binary SMSPEC/UNSMRY and unified-restart UNRST outputs.

    python -m opm_tpu_torch.tools.compare_ecl BASE1 BASE2 \
        [--abs-tol 2e-2] [--rel-tol 1e-5] [--restart] [--keys FOPR FPR]

Exit status 0 when all compared vectors are within
|a - b| <= abs_tol + rel_tol * max(|a|, |b|)  (the deviation measure the
reference tolerances apply to), 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def compare_vectors(a, b, abs_tol, rel_tol):
    """Largest violation of the combined tolerance; <= 0 passes."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    n = min(a.shape[0], b.shape[0])
    dev = np.abs(a[:n] - b[:n]) - (abs_tol + rel_tol
                                   * np.maximum(np.abs(a[:n]),
                                                np.abs(b[:n])))
    return float(dev.max()) if n else 0.0


def compare_summary(base1, base2, *, abs_tol, rel_tol, keys=None):
    from opm_tpu_torch.io.eclsum import read_summary

    s1 = read_summary(base1)
    s2 = read_summary(base2)
    shared = sorted(set(s1) & set(s2))
    if keys:
        shared = [k for k in shared if any(k.startswith(p) for p in keys)]
    failures = []
    for k in shared:
        viol = compare_vectors(s1[k], s2[k], abs_tol, rel_tol)
        if viol > 0:
            failures.append((k, viol))
    return shared, failures


def compare_restart(path1, path2, *, abs_tol, rel_tol):
    from opm_tpu_torch.io.eclsum import read_unrst

    r1 = read_unrst(path1)
    r2 = read_unrst(path2)
    failures = []
    nstep = min(len(r1), len(r2))
    arrays = 0
    for i in range(nstep):
        for k in set(r1[i]) & set(r2[i]):
            v1 = r1[i][k]
            if not isinstance(v1, np.ndarray) or v1.dtype.kind not in "fd":
                continue
            arrays += 1
            viol = compare_vectors(v1, r2[i][k], abs_tol, rel_tol)
            if viol > 0:
                failures.append((f"step{i}:{k}", viol))
    return arrays, failures


def compare_init(path1, path2, *, abs_tol, rel_tol):
    """INIT-file comparison (the Norne-init regression class,
    compareECLFiles.cmake:141-146 run-init-regressionTest.sh)."""
    from opm_tpu_torch.io.eclsum import read_init

    i1 = read_init(path1)
    i2 = read_init(path2)
    failures = []
    arrays = 0
    for k in sorted(set(i1) & set(i2)):
        v1 = np.asarray(i1[k])
        if v1.dtype.kind not in "fd" or k in ("DOUBHEAD",):
            continue
        arrays += 1
        viol = compare_vectors(v1, i2[k], abs_tol, rel_tol)
        if viol > 0:
            failures.append((k, viol))
    return arrays, failures


def main(argv=None):
    ap = argparse.ArgumentParser(prog="compare_ecl", description=__doc__)
    ap.add_argument("base1")
    ap.add_argument("base2")
    ap.add_argument("--abs-tol", type=float, default=2e-2)
    ap.add_argument("--rel-tol", type=float, default=1e-5)
    ap.add_argument("--restart", action="store_true",
                    help="compare UNRST files instead of summaries")
    ap.add_argument("--init", action="store_true",
                    help="compare INIT files instead of summaries")
    ap.add_argument("--keys", nargs="*", default=None,
                    help="restrict to vectors with these prefixes")
    args = ap.parse_args(argv)

    if args.init:
        n, failures = compare_init(args.base1, args.base2,
                                   abs_tol=args.abs_tol,
                                   rel_tol=args.rel_tol)
        print(f"compared {n} INIT arrays")
    elif args.restart:
        n, failures = compare_restart(args.base1, args.base2,
                                      abs_tol=args.abs_tol,
                                      rel_tol=args.rel_tol)
        print(f"compared {n} restart arrays")
    else:
        shared, failures = compare_summary(args.base1, args.base2,
                                           abs_tol=args.abs_tol,
                                           rel_tol=args.rel_tol,
                                           keys=args.keys)
        print(f"compared {len(shared)} summary vectors")
    for k, viol in failures:
        print(f"DEVIATION {k}: exceeds tolerance by {viol:.6g}")
    print("PASS" if not failures else "FAIL")
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
