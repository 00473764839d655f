"""Synthetic test decks (port of the JAX package's sim/testcases.py;
only the SPE10-like generator so far)."""

from __future__ import annotations

from opm_tpu_torch.io.eclstate import EclipseCase, load_case_string


def spe10like_deck(nx=60, ny=220, nz=20, seed=10, tsteps="5*20") -> str:
    """SPE10-model-2-class scaling case: the published model's 60x220x85
    channelized permeability field is an external download, so a seeded
    lognormal field with channel streaks stands in at the same areal size
    (nz configurable: 85 = full-size 1.122M cells). Waterflood five-spot:
    4 corner producers + 1 center injector (the SPE10 well pattern)."""
    import numpy as np

    n = nx * ny * nz
    rng = np.random.RandomState(seed)
    # channelized-ish lognormal: smooth noise along y (channels run in y)
    perm = np.empty((nz, ny, nx))
    for k in range(nz):
        base = rng.normal(0.0, 1.0, size=(ny, nx))
        for _ in range(3):  # cheap smoothing -> correlated streaks
            base = 0.5 * base + 0.25 * np.roll(base, 1, axis=0) \
                + 0.25 * np.roll(base, 2, axis=0)
        perm[k] = np.exp(3.0 + 2.0 * base)
    perm = np.clip(perm.ravel(), 1e-3, 2e4)
    poro = np.clip(0.05 + 0.25 * (np.log(perm) - np.log(perm).min())
                   / (np.log(perm).max() - np.log(perm).min()), 0.05, 0.35)

    def arr(a):
        return "\n ".join(" ".join(f"{v:.5g}" for v in a[i:i + 16])
                          for i in range(0, len(a), 16))

    ci, cj = nx // 2 + 1, ny // 2 + 1
    prods = [(1, 1), (nx, 1), (1, ny), (nx, ny)]
    wells = [f" 'P{i+1}' 'G1' {pi} {pj} 12000 'OIL' /"
             for i, (pi, pj) in enumerate(prods)]
    wells.append(f" 'I1' 'G1' {ci} {cj} 12000 'WATER' /")
    comps = [f" 'P{i+1}' {pi} {pj} 1 {nz} 'OPEN' 1* 1* 0.5 /"
             for i, (pi, pj) in enumerate(prods)]
    comps.append(f" 'I1' {ci} {cj} 1 {nz} 'OPEN' 1* 1* 0.5 /")
    wcon = "\n".join(f" 'P{i+1}' 'OPEN' 'BHP' 5* 4000 /" for i in range(4))

    return f"""
RUNSPEC
TITLE
  SPE10-LIKE {nx}x{ny}x{nz} (seeded channels)
DIMENS
 {nx} {ny} {nz} /
EQLDIMS
/
TABDIMS
/
OIL
GAS
WATER
DISGAS
FIELD
WELLDIMS
 5 {nz} 1 5 /
GRID
DX
 {n}*20 /
DY
 {n}*10 /
DZ
 {n}*2 /
TOPS
 {nx * ny}*12000 /
PORO
 {arr(poro)} /
PERMX
 {arr(perm)} /
PERMY
 {arr(perm)} /
PERMZ
 {arr(perm * 0.1)} /
PROPS
PVTW
 6000 1.01 3E-6 0.3 0 /
ROCK
 6000 1E-6 /
SWOF
 0.2  0     1     0
 0.4  0.06  0.5   0
 0.6  0.24  0.15  0
 0.8  0.54  0.01  0
 1.0  1.0   0.0   0 /
SGOF
 0    0     1     0
 0.05 0     0.85  0
 0.3  0.12  0.3   0
 0.6  0.5   0.02  0
 0.8  0.9   0.0   0 /
DENSITY
 53 64 0.06 /
PVDG
 14.7   180  0.012
 2000   1.1  0.016
 6000   0.35 0.025
 9000   0.23 0.030 /
PVTO
 0.01  14.7  1.05  1.8 /
 0.3   2000  1.15  1.2 /
 0.8   6000  1.35  0.8
       9000  1.33  0.85 /
/
SOLUTION
EQUIL
 12030 6000 12500 0 11000 0 1 0 0 /
RSVD
 11000 0.4
 12500 0.4 /
SUMMARY
FOPR
SCHEDULE
TUNING
 0.25 365 0.1 1* 1.5 /
/
 20 /
WELSPECS
{chr(10).join(wells)}
/
COMPDAT
{chr(10).join(comps)}
/
WCONPROD
{wcon}
/
WCONINJE
 'I1' 'WATER' 'OPEN' 'RATE' 5000 1* 10000 /
/
TSTEP
 {tsteps} /
END
"""


def spe10like_case(**kw) -> EclipseCase:
    return load_case_string(spe10like_deck(**kw))
