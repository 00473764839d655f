"""Synthetic test decks (port of the JAX package's sim/testcases.py: the
mini black-oil, the SPE10-like, the Norne-like and the SPE3-like
generators so far), SPE1 with PBVD in place of RSVD, SPE3 with PDVD in
place of RVVD, the small decks of the JAX package's tests of field-style
well controls (wellctrl_decks) and the Norne-class field under them
(norne_field_controls)."""

from __future__ import annotations

from opm_tpu_torch.io.eclstate import EclipseCase, load_case_string


def mini_blackoil_deck(nx=10, ny=10, nz=3, *, inj_rate=100000,
                       prod_rate=20000, tsteps="10*30") -> str:
    """SPE1-like three-phase DISGAS case, scalable grid dimensions."""
    n = nx * ny * nz
    nlay = nx * ny
    return f"""
RUNSPEC
TITLE
  MINI BLACKOIL {nx}x{ny}x{nz}
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
 2 {nz} 1 2 /
GRID
DX
 {n}*{10000.0 / nx} /
DY
 {n}*{10000.0 / ny} /
DZ
 {n}*{100.0 / nz} /
TOPS
 {nlay}*8325 /
PORO
 {n}*0.3 /
PERMX
 {n}*500 /
PERMY
 {n}*500 /
PERMZ
 {n}*50 /
PROPS
PVTW
 4014.7 1.029 3.13D-6 0.31 0 /
ROCK
 14.7 3D-6 /
SWOF
 0.12 0       1     0
 0.3  0.0002  0.8   0
 0.5  0.005   0.35  0
 0.7  0.05    0.05  0
 0.88 0.15    0.0   0
 1.0  0.30    0.0   0 /
SGOF
 0    0     1     0
 0.02 0     0.95  0
 0.2  0.08  0.35  0
 0.4  0.3   0.05  0
 0.6  0.6   0.005 0
 0.88 0.95  0.0   0 /
DENSITY
 53.66 64.49 0.0533 /
PVDG
 14.700 166.666 0.008
 1014.7 3.19700 0.0140
 2014.7 1.61400 0.0189
 3014.7 1.08000 0.0228
 4014.7 0.81100 0.0268
 5014.7 0.64900 0.0309
 9014.7 0.38600 0.0470 /
PVTO
 0.0010 14.7   1.0620 1.0400 /
 0.1800 514.7  1.2070 0.9100 /
 0.3710 1014.7 1.2950 0.8300 /
 0.6360 2014.7 1.4350 0.6950 /
 0.9300 3014.7 1.5650 0.5940 /
 1.2700 4014.7 1.6950 0.5100
        5014.7 1.6710 0.5490
        9014.7 1.5790 0.7400 /
 1.6180 5014.7 1.8270 0.4490
        9014.7 1.7370 0.6310 /
/
SOLUTION
EQUIL
 8400 4800 8500 0 8200 0 1 0 0 /
RSVD
 8200 1.270
 8500 1.270 /
SUMMARY
FOPR
SCHEDULE
WELSPECS
 'PROD' 'G1' {nx} {ny} 8400 'OIL' /
 'INJ'  'G1' 1 1 8335 'GAS' /
/
COMPDAT
 'PROD' {nx} {ny} {nz} {nz} 'OPEN' 1* 1* 0.5 /
 'INJ'  1 1 1 1 'OPEN' 1* 1* 0.5 /
/
WCONPROD
 'PROD' 'OPEN' 'ORAT' {prod_rate} 4* 1000 /
/
WCONINJE
 'INJ' 'GAS' 'OPEN' 'RATE' {inj_rate} 1* 9014 /
/
TSTEP
 {tsteps} /
END
"""


def mini_blackoil_case(nx=10, ny=10, nz=3, **kw) -> EclipseCase:
    return load_case_string(mini_blackoil_deck(nx, ny, nz, **kw))


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


def norne_like_deck(nx=46, ny=112, nz=22, seed=7, tsteps="5 10 3*30") -> str:
    """Norne-class synthetic: a faulted, partially-inactive corner-point
    field at the real Norne's grid dimensions (46x112x22, 75,566 active
    after ACTNUM carving at the default seed; the reference's Norne
    regression target, compareECLFiles.cmake:141-146; the real deck is
    licensed data). Two
    stair-step fault planes (one sealed by MULTFLT), a dipping horizon
    with a dome, lognormal layered permeability, water-oil-gas with
    DISGAS, 8 producers + 4 water injectors."""
    import numpy as np

    rng = np.random.RandomState(seed)
    dx = dy = 100.0          # meters (METRIC)
    dzl = rng.uniform(3.0, 12.0, nz)
    cum = np.concatenate([[0.0], np.cumsum(dzl)])

    # dome-shaped top surface + regional dip along y
    xe = np.arange(nx + 1) * dx
    ye = np.arange(ny + 1) * dy
    X, Y = np.meshgrid(xe, ye)              # (ny+1, nx+1)
    top = (2600.0 + 0.03 * Y
           - 120.0 * np.exp(-(((X - 2300.0) / 1500.0) ** 2
                              + ((Y - 5600.0) / 3000.0) ** 2)))
    # two fault planes along x = const: the throw is PER-CELL so the two
    # sides of the shared pillar disagree — a true stair-step fault (a
    # pillar-based offset would only ramp the cells continuously)
    f1, f2 = nx // 3, 2 * nx // 3
    cell_throw = np.zeros(nx)
    cell_throw[f1:] += 18.0
    cell_throw[f2:] += 25.0
    zpil = top                               # pillar-top depth

    coord = np.empty((ny + 1, nx + 1, 6))
    coord[:, :, 0] = X
    coord[:, :, 1] = Y
    coord[:, :, 2] = zpil
    coord[:, :, 3] = X
    coord[:, :, 4] = Y
    coord[:, :, 5] = zpil + cum[-1] + cell_throw.max()

    # zcorn: layers parallel to the (faulted) top; per-cell corner depths
    # follow the pillar tops so the fault offset is a true stair-step
    zc = np.empty((nz, 2, ny, 2, nx, 2))
    for k in range(nz):
        for kc in range(2):
            zlayer = zpil + cum[k + kc]      # (ny+1, nx+1)
            zc[k, kc, :, 0, :, 0] = zlayer[:-1, :-1] + cell_throw
            zc[k, kc, :, 0, :, 1] = zlayer[:-1, 1:] + cell_throw
            zc[k, kc, :, 1, :, 0] = zlayer[1:, :-1] + cell_throw
            zc[k, kc, :, 1, :, 1] = zlayer[1:, 1:] + cell_throw

    n = nx * ny * nz
    # ACTNUM carving: an erosional edge (inactive ring) + random holes
    act = np.ones((nz, ny, nx), dtype=int)
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    rim = (((ii - nx / 2) / (nx / 2.2)) ** 2
           + ((jj - ny / 2) / (ny / 2.05)) ** 2) > 1.0
    act[:, rim] = 0
    holes = rng.rand(nz, ny, nx) < 0.04
    act[holes] = 0

    perm = np.empty((nz, ny, nx))
    poro = np.empty((nz, ny, nx))
    for k in range(nz):
        mu = rng.uniform(2.0, 6.0)
        perm[k] = np.exp(rng.normal(mu, 1.0, (ny, nx)))
        poro[k] = np.clip(rng.normal(0.24, 0.04), 0.05, 0.35)

    def arr(a, fmt="{:.6g}"):
        a = np.asarray(a).ravel()
        return "\n ".join(" ".join(fmt.format(v) for v in a[i:i + 10])
                          for i in range(0, len(a), 10))

    # wells on active columns: producers near the dome crest, injectors
    # on the flanks
    def find_col(i0, j0):
        for r in range(0, 30):
            for di in range(-r, r + 1):
                for dj in range(-r, r + 1):
                    i, j = i0 + di, j0 + dj
                    if 0 <= i < nx and 0 <= j < ny and act[:, j, i].sum() > 8:
                        return i, j
        raise RuntimeError("no active column")

    prod_pos = [find_col(nx // 2 + di, ny // 2 + dj)
                for (di, dj) in ((-8, -20), (4, -12), (-2, 0), (8, 8),
                                 (-10, 14), (3, 22), (-5, 30), (9, -28))]
    inj_pos = [find_col(i, j) for (i, j) in
               ((6, ny // 4), (nx - 7, ny // 4), (6, 3 * ny // 4),
                (nx - 7, 3 * ny // 4))]
    wells, comps, wcon = [], [], []
    for w, (i, j) in enumerate(prod_pos):
        wells.append(f" 'P{w+1}' 'PROD' {i+1} {j+1} 2650 'OIL' /")
        comps.append(f" 'P{w+1}' {i+1} {j+1} 1 8 'OPEN' 1* 1* 0.2 /")
        wcon.append(f" 'P{w+1}' 'OPEN' 'ORAT' 1200 4* 120 /")
    for w, (i, j) in enumerate(inj_pos):
        wells.append(f" 'I{w+1}' 'INJ' {i+1} {j+1} 2700 'WATER' /")
        comps.append(f" 'I{w+1}' {i+1} {j+1} 12 22 'OPEN' 1* 1* 0.2 /")

    return f"""
RUNSPEC
TITLE
  NORNE-LIKE synthetic (faulted corner-point)
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
METRIC
WELLDIMS
 12 22 1 12 /
GRID
COORD
 {arr(coord, "{:.2f}")} /
ZCORN
 {arr(zc, "{:.2f}")} /
ACTNUM
 {arr(act.ravel(), "{:d}")} /
PORO
 {arr(poro)} /
PERMX
 {arr(perm)} /
PERMY
 {arr(perm)} /
PERMZ
 {arr(perm * 0.1)} /
FAULTS
 'FA' {f1} {f1} 1 {ny} 1 {nz} 'X' /
 'FB' {f2} {f2} 1 {ny} 1 {nz} 'X' /
/
MULTFLT
 'FA' 0.001 /
 'FB' 0.2 /
/
PROPS
PVTW
 270 1.03 4.0E-5 0.38 0 /
ROCK
 270 4.0E-5 /
SWOF
 0.15 0      0.95  2.5
 0.3  0.008  0.6   0.9
 0.5  0.09   0.2   0.35
 0.7  0.3    0.03  0.15
 0.9  0.7    0.0   0.05
 1.0  1.0    0.0   0.0 /
SGOF
 0    0     1     0
 0.05 0     0.75  0.05
 0.2  0.09  0.35  0.15
 0.4  0.3   0.1   0.3
 0.6  0.6   0.01  0.45
 0.85 0.92  0.0   0.6 /
DENSITY
 860 1025 1.02 /
PVDG
 30   0.043 0.014
 100  0.012 0.016
 200  0.0058 0.019
 300  0.0038 0.023
 400  0.0028 0.027 /
PVTO
 30   30   1.12 1.1 /
 60   75   1.18 0.9 /
 90   120  1.24 0.75 /
 120  165  1.30 0.62
      250  1.28 0.68 /
/
SOLUTION
EQUIL
 2650 270 2850 0 2500 0 1 0 0 /
RSVD
 2400 90
 2900 90 /
SUMMARY
FOPR
FPR
SCHEDULE
WELSPECS
{chr(10).join(wells)}
/
COMPDAT
{chr(10).join(comps)}
/
WCONPROD
{chr(10).join(wcon)}
/
WCONINJE
 'I1' 'WATER' 'OPEN' 'RATE' 3000 1* 420 /
 'I2' 'WATER' 'OPEN' 'RATE' 3000 1* 420 /
 'I3' 'WATER' 'OPEN' 'RATE' 3000 1* 420 /
 'I4' 'WATER' 'OPEN' 'RATE' 3000 1* 420 /
/
TSTEP
 {tsteps} /
END
"""


def norne_like_case(**kw) -> EclipseCase:
    return load_case_string(norne_like_deck(**kw))


# SPE1's RSVD table (data/SPE1CASE2.DATA) and a PBVD table of the bubble
# point that rs gives through SPE1's PVTO table: rs 1.270 Mscf/stb is the
# node at 4014.7 psia
SPE1_RSVD = "RSVD\n   8300 1.270\n   8450 1.270 /"
SPE1_PBVD = "PBVD\n   8300 4014.7\n   8450 4014.7 /"


def spe1_pbvd_deck(spe1_text: str) -> str:
    """SPE1's deck text with PBVD in place of RSVD (the EQUIL branch of a
    bubble-point column, which no deck of the repository has)."""
    if SPE1_RSVD not in spe1_text:
        raise ValueError("SPE1's RSVD table not found in the deck text")
    return spe1_text.replace(SPE1_RSVD, SPE1_PBVD)


def spe3like_deck(tsteps="5 10 3*15 22*30", cycling=False,
                  cycle_tsteps="10*30", blowdown_tsteps="6*30") -> str:
    """SPE3-class retrograde gas-condensate depletion (Kenyon & Behie,
    SPE-12278, black-oil conversion as in the reference's SPE3 regression,
    compareECLFiles.cmake:107-112): 9x9x4 grid, wet gas with vaporized
    oil (VAPOIL + PVTG), dead condensate oil (PVDO), immobile connate
    water. The whole column initializes as UNDERSATURATED gas (rv below
    the dew-point rv_sat via RVVD); drawdown below the dew point drops
    condensate out — the HC_GASONLY <-> HC_GASOIL switching path.

    cycling=True adds the PUBLISHED study's gas-cycling structure
    (Kenyon & Behie: separator gas reinjected dry, then blowdown) on an
    accelerated clock: `tsteps` of depletion drops condensate out, then
    the injector opens at 1.5x the offtake (45 MMscf/d dry gas:
    full reinjection plus makeup gas, so the cycle genuinely
    repressurizes) for
    `cycle_tsteps`, then shuts for a `blowdown_tsteps` blowdown — the
    harder VAPOIL direction: rv RISES where the dry front repressurizes
    saturated cells / re-vaporizes dropped-out condensate, then falls
    again in blowdown."""
    n = 9 * 9 * 4
    nlay = 9 * 9
    wspec_inj = "\n 'INJ'  'G1' 1 1 7530 'GAS' /" if cycling else ""
    compdat_inj = ("\n 'INJ'  1 1 1 2 'OPEN' 1* 1* 0.5 /"
                   if cycling else "")
    # injector exists from t=0 but stays explicitly SHUT through the
    # depletion period
    inje = ("\nWCONINJE\n 'INJ' 'GAS' 'SHUT' 'RATE' 45000 1* 6000 /\n/"
            if cycling else "")
    shut_and_blowdown = (
        "\nWCONINJE\n 'INJ' 'GAS' 'OPEN' 'RATE' 45000 1* 6000 /\n/"
        "\nTSTEP\n " + cycle_tsteps + " /"
        "\nWCONINJE\n 'INJ' 'GAS' 'SHUT' 'RATE' 45000 1* 6000 /\n/"
        "\nTSTEP\n " + blowdown_tsteps + " /" if cycling else "")
    return f"""
RUNSPEC
TITLE
  SPE3-LIKE gas condensate (VAPOIL)
DIMENS
 9 9 4 /
EQLDIMS
/
TABDIMS
/
OIL
GAS
WATER
VAPOIL
FIELD
WELLDIMS
 2 4 1 2 /
GRID
DX
 {n}*293.3 /
DY
 {n}*293.3 /
DZ
 {nlay}*30 {nlay}*30 {nlay}*50 {nlay}*50 /
TOPS
 {nlay}*7500 /
PORO
 {n}*0.13 /
PERMX
 {nlay}*130 {nlay}*40 {nlay}*20 {nlay}*150 /
PERMY
 {nlay}*130 {nlay}*40 {nlay}*20 {nlay}*150 /
PERMZ
 {nlay}*13 {nlay}*4 {nlay}*2 {nlay}*15 /
PROPS
PVTW
 3550 1.0 3E-6 0.7 0 /
ROCK
 3550 4E-6 /
SWOF
 0.16  0       1     50
 0.30  0.02    0.6   8
 0.50  0.12    0.2   3
 0.70  0.35    0.02  1
 0.90  0.8     0.0   0.2
 1.0   1.0     0.0   0.0 /
SGOF
 0.0   0.0     1.0    0
 0.05  0.0     0.65   0
 0.2   0.05    0.35   0
 0.4   0.18    0.1    0
 0.6   0.40    0.01   0
 0.78  0.75    0.0    0
 0.84  0.90    0.0    0 /
DENSITY
 45.0 63.0 0.0702 /
PVDO
 1000  1.12  0.30
 2000  1.10  0.34
 3000  1.08  0.38
 3600  1.07  0.40 /
PVTG
 500   0.0001  5.9    0.0135
       0.0     5.88   0.0134 /
 1500  0.0006  1.85   0.0150
       0.0     1.84   0.0148 /
 2500  0.0018  1.05   0.0170
       0.0009  1.045  0.0167
       0.0     1.04   0.0165 /
 3000  0.0028  0.86   0.0185
       0.0014  0.855  0.0182
       0.0     0.85   0.0180 /
 3600  0.0042  0.72   0.0210
       0.0021  0.715  0.0205
       0.0     0.71   0.0200 /
/
SOLUTION
EQUIL
 7500 3550 8600 0 8590 0 1 1 0 /
RVVD
 7400 0.0030
 8600 0.0030 /
SUMMARY
FGPR
FOPR
SCHEDULE
WELSPECS
 'PROD' 'G1' 7 7 7530 'GAS' /{wspec_inj}
/
COMPDAT
 'PROD' 7 7 3 4 'OPEN' 1* 1* 0.5 /{compdat_inj}
/
WCONPROD
 'PROD' 'OPEN' 'GRAT' 2* 30000 2* 500 /
/{inje}
TSTEP
 {tsteps} /{shut_and_blowdown}
END
"""


def spe3like_case(**kw) -> EclipseCase:
    return load_case_string(spe3like_deck(**kw))


# SPE3's vaporized-oil column (data/SPE3.DATA, spe3like_deck) and a
# dew-point column in its place: 3500 psi at the top of the column, 3700 at
# its base, so rv_sat(min(pd, pg)) is capped by pd in the upper cells and
# by pg below
SPE3_RVVD = "RVVD\n 7400 0.0030\n 8600 0.0030 /"
SPE3_PDVD = "PDVD\n 7400 3500\n 8600 3700 /"


def spe3_pdvd_deck(spe3_text: str) -> str:
    """SPE3's deck text with PDVD in place of RVVD (the EQUIL branch of a
    dew-point column, which no deck of the repository has)."""
    if SPE3_RVVD not in spe3_text:
        raise ValueError("SPE3's RVVD table not found in the deck text")
    return spe3_text.replace(SPE3_RVVD, SPE3_PDVD)


# ---------------------------------------------------------------------------
# field-style well controls and schedule geology: the small decks of the
# JAX package's tests (tests/test_spe1.py THPRES, test_well_switching.py,
# test_vfp.py, test_groups.py, test_wconhist.py, test_schedule_geo.py),
# text for text, and the Norne-class field's edit

# tests/test_spe1.py::test_thpres_defaulted_compute_max_dp (8x1x1, two
# EQLNUM regions, THPRES 1 2 defaulted)
THPRES_DECK = """
RUNSPEC
TITLE
 THPRES-DEFAULT
DIMENS
 8 1 1 /
OIL
WATER
GAS
DISGAS
FIELD
EQLDIMS
 2 /
TABDIMS
 1 1 /
WELLDIMS
 1 1 1 1 /
GRID
DXV
 8*100 /
DYV
 100 /
DZV
 50 /
TOPS
 8*8300 /
PORO
 8*0.3 /
PERMX
 8*100 /
REGIONS
EQLNUM
 4*1 4*2 /
PROPS
PVTW
 4000 1.0 3.0E-6 0.5 0 /
ROCK
 4000 4.0E-6 /
SWOF
 0.12 0    1   0
 0.8  0.9  0.0 0 /
SGOF
 0    0    1   0
 0.85 0.9  0.0 0 /
DENSITY
 53.66 64.49 0.0533 /
PVDG
 14.7   166.666 0.008
 9014.7 0.386   0.0470 /
PVTO
 0.20 1014.7 1.20 0.90 /
 1.27 4014.7 1.695 0.51
      9014.7 1.579 0.74 /
/
SOLUTION
EQUIL
 8325 4000 8600 0 8200 0 1 0 0 /
 8325 4400 8600 0 8200 0 1 0 0 /
THPRES
 1 2 /
/
SUMMARY
FOPR
SCHEDULE
TSTEP
 1 /
END
"""

# tests/test_well_switching.py's deck-driven cases (10x1x1)
SWITCHING_TMPL = """
RUNSPEC
DIMENS
 10 1 1 /
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
 2 1 2 2 /
GRID
DX
 10*500 /
DY
 10*500 /
DZ
 10*50 /
TOPS
 10*8325 /
PORO
 10*0.3 /
PERMX
 10*200 /
PERMY
 10*200 /
PERMZ
 10*200 /
PROPS
PVTW
 4014.7 1.029 3.13D-6 0.31 0 /
ROCK
 14.7 3D-6 /
SWOF
 0.12 0    1    0
 0.5  0.1  0.4  0
 1.0  0.5  0    0 /
SGOF
 0    0    1     0
 0.3  0.1  0.3   0
 0.88 0.8  0.0   0 /
DENSITY
 53.66 64.49 0.0533 /
PVDG
 14.7   166.666 0.008
 5014.7 0.48    0.0161 /
PVTO
 0.001  14.7   1.062  1.04 /
 0.0905 264.7  1.15   0.975 /
 0.18   514.7  1.207  0.91 /
 0.371  1014.7 1.295  0.83 /
 0.636  2014.7 1.435  0.695 /
 0.775  2514.7 1.5    0.641 /
 0.93   3014.7 1.565  0.594 /
 1.270  4014.7 1.695  0.51
        5014.7 1.671  0.549 /
 1.618  5014.7 1.827  0.449 /
/
SOLUTION
EQUIL
 8400 4800 8450 0 8300 0 1 0 0 /
SUMMARY
SCHEDULE
WELSPECS
 'P1' 'G' 10 1 8350 'OIL' /
 'I1' 'G' 1 1 8350 'WAT' /
/
COMPDAT
 'P1' 10 1 1 1 'OPEN' 1* 1* 0.5 /
 'I1' 1 1 1 1 'OPEN' 1* 1* 0.5 /
/
{schedule}
TSTEP
 {tsteps} /
END
"""

# tests/test_groups.py (10x5x1, GRUPTREE/GCONPROD)
GROUPS_DECK = """
RUNSPEC
DIMENS
 10 5 1 /
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
 3 1 2 3 /
GRID
DX
 50*500 /
DY
 50*500 /
DZ
 50*50 /
TOPS
 50*8325 /
PORO
 50*0.3 /
PERMX
 50*200 /
PERMY
 50*200 /
PERMZ
 50*200 /
PROPS
PVTW
 4014.7 1.029 3.13D-6 0.31 0 /
ROCK
 14.7 3D-6 /
SWOF
 0.12 0    1    0
 0.5  0.02 0.4  0
 1.0  0.3  0    0 /
SGOF
 0    0    1     0
 0.3  0.1  0.3   0
 0.88 0.8  0.0   0 /
DENSITY
 53.66 64.49 0.0533 /
PVDG
 14.7   166.666 0.008
 2014.7 1.614   0.0189
 9014.7 0.386   0.0470 /
PVTO
 0.20 1014.7 1.20 0.90 /
 0.60 2514.7 1.45 0.65 /
 1.27 4014.7 1.695 0.51
      9014.7 1.579 0.74 /
/
SOLUTION
EQUIL
 8350 4000 8500 0 8200 0 1 0 0 /
RSVD
 8200 0.6
 8500 0.6 /
SUMMARY
FOPR
SCHEDULE
GRUPTREE
 'PLAT' 'FIELD' /
/
WELSPECS
 'P1' 'PLAT' 1 1 8350 'OIL' /
 'P2' 'PLAT' 10 5 8350 'OIL' /
 'I1' 'FIELD' 5 3 8350 'GAS' /
/
COMPDAT
 'P1' 1 1 1 1 'OPEN' 1* 1* 0.5 /
 'P2' 10 5 1 1 'OPEN' 1* 1* 0.5 /
 'I1' 5 3 1 1 'OPEN' 1* 1* 0.5 /
/
GCONPROD
 'PLAT' 'ORAT' 4000 3* 1* /
/
WCONPROD
 'P1' 'OPEN' 'GRUP' 5* 500 /
 'P2' 'OPEN' 'GRUP' 5* 500 /
/
WCONINJE
 'I1' 'GAS' 'OPEN' 'RATE' 2000 1* 9000 /
/
TSTEP
 5*10 /
END
"""

# tests/test_wconhist.py (10x5x1, WCONHIST/WCONINJH); its _case() names
# the WCONINJH well
WCONHIST_DECK = """
RUNSPEC
DIMENS
 10 5 1 /
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
 2 1 2 2 /
GRID
DX
 50*500 /
DY
 50*500 /
DZ
 50*50 /
TOPS
 50*8325 /
PORO
 50*0.3 /
PERMX
 50*200 /
PERMY
 50*200 /
PERMZ
 50*200 /
PROPS
PVTW
 4014.7 1.029 3.13D-6 0.31 0 /
ROCK
 14.7 3D-6 /
SWOF
 0.12 0    1    0
 0.5  0.02 0.4  0
 1.0  0.3  0    0 /
SGOF
 0    0    1     0
 0.3  0.1  0.3   0
 0.88 0.8  0.0   0 /
DENSITY
 53.66 64.49 0.0533 /
PVDG
 14.7   166.666 0.008
 2014.7 1.614   0.0189
 9014.7 0.386   0.0470 /
PVTO
 0.20 1014.7 1.20 0.90 /
 0.60 2514.7 1.45 0.65 /
 1.27 4014.7 1.695 0.51
      9014.7 1.579 0.74 /
/
SOLUTION
EQUIL
 8350 4000 8500 0 8200 0 1 0 0 /
RSVD
 8200 0.6
 8500 0.6 /
SUMMARY
FOPR
SCHEDULE
WELSPECS
 'P1' 'G' 1 1 8350 'OIL' /
 'I1' 'G' 10 5 8350 'WATER' /
/
COMPDAT
 'P1' 1 1 1 1 'OPEN' 1* 1* 0.5 /
 'I1' 10 5 1 1 'OPEN' 1* 1* 0.5 /
/
WCONHIST
 'P1' 'OPEN' 'ORAT' 1000 0 600 /
/
WCONINJH
 'WATER' 'OPEN' 1200 /
/
TSTEP
 5*10 /
END
"""


def _vfp_wthp_deck():
    """tests/test_vfp.py::test_wthp_reported_for_bhp_rate_controlled_vfp_
    well: the mini deck's producer with VFPPROD table 1 (ORAT control)."""
    flo_ax = [1000.0, 10000.0, 30000.0]
    thp_ax = [100.0, 500.0, 1000.0]
    wct_ax = [0.0, 0.9]
    gor_ax = [0.0, 10.0]
    recs = []
    for it in range(3):
        for iw in range(2):
            for ig in range(2):
                bhps = [thp_ax[it] + 0.05 * f + 2500.0
                        + 20.0 * wct_ax[iw] + 5.0 * gor_ax[ig]
                        for f in flo_ax]
                recs.append(f" {it+1} {iw+1} {ig+1} 1 "
                            + " ".join(f"{b:.6g}" for b in bhps) + " /")
    vfp = ("VFPPROD\n 1 8400 'LIQ' 'WCT' 'GOR' 'THP' ' ' 'FIELD' 'BHP' /\n"
           + " ".join(f"{f:g}" for f in flo_ax) + " /\n"
           + " ".join(f"{t:g}" for t in thp_ax) + " /\n"
           + " ".join(f"{w:g}" for w in wct_ax) + " /\n"
           + " ".join(f"{g:g}" for g in gor_ax) + " /\n 0.0 /\n"
           + "\n".join(recs) + "\n")
    deck = mini_blackoil_deck(nx=6, ny=6, nz=2, tsteps="3*20")
    return deck.replace("WCONPROD\n 'PROD' 'OPEN' 'ORAT' 20000 4* 1000 /",
                        vfp + "WCONPROD\n"
                        " 'PROD' 'OPEN' 'ORAT' 20000 4* 1000 1* 1 /")


_VFP_DATUM_SCHED = """VFPPROD
 1 {datum} 'LIQ' 'WCT' 'GOR' 'THP' ' ' 'FIELD' 'BHP' /
 10 5000 /
 100 1500 /
 0.0 1.0 /
 0.0 10.0 /
 0.0 /
 1 1 1 1  1300 1300 /
 1 2 1 1  1300 1300 /
 2 1 1 1  2700 2700 /
 2 2 1 1  2700 2700 /
 1 1 2 1  1300 1300 /
 1 2 2 1  1300 1300 /
 2 1 2 1  2700 2700 /
 2 2 2 1  2700 2700 /
/
WCONPROD
 'P1' 'OPEN' 'THP' 5* 100 500 1 /
/
WCONINJE
 'I1' 'WATER' 'OPEN' 'RATE' 1000 1* 9000 /
/"""


def _geo_deck(schedule_mod):
    """tests/test_schedule_geo.py's mini deck with a fault plane at i=2|3
    and a schedule tail after the modifier."""
    deck = mini_blackoil_deck(4, 3, 2, tsteps="3*10")
    deck = deck.replace(
        "PROPS\n",
        "FAULTS\n 'F1' 2 2 1 3 1 2 'X' /\n/\nPROPS\n", 1)
    return deck.replace(
        "END\n", schedule_mod + "TSTEP\n 3*10 /\nEND\n", 1)


def wellctrl_decks():
    """{name: (deck text, report steps run)} of the JAX package's small
    dense-route tests of field-style controls, run to the ends their tests
    use (None: the whole schedule; the defaulted THPRES deck's one step)."""
    sw = SWITCHING_TMPL
    return {
        "thpres_default": (THPRES_DECK, None),
        "thpres_explicit": (THPRES_DECK.replace(
            "THPRES\n 1 2 /", "THPRES\n 1 2 200 /"), None),
        "grat_limit": (sw.format(schedule="""WCONPROD
 'P1' 'OPEN' 'ORAT' 2000 1* 1000 2* 100 /
/
WCONINJE
 'I1' 'WATER' 'OPEN' 'RATE' 2500 1* 9000 /
/""", tsteps="5*10"), 3),
        "watered_out": (sw.format(schedule="""WCONPROD
 'P1' 'OPEN' 'ORAT' 1500 700 3* 100 /
/
WCONINJE
 'I1' 'WATER' 'OPEN' 'RATE' 3000 1* 9000 /
/""", tsteps="30*10").replace("10*500", "10*100").replace("10*50 /",
                                                            "10*20 /"),
                        None),
        "vfp_datum_same": (sw.format(
            schedule=_VFP_DATUM_SCHED.format(datum=8350.0),
            tsteps="3*10"), None),
        "vfp_datum_off": (sw.format(
            schedule=_VFP_DATUM_SCHED.format(datum=8350.0 - 100.0 / 0.3048),
            tsteps="3*10"), None),
        "wthp": (_vfp_wthp_deck(), 2),
        "group_orat": (GROUPS_DECK, 3),
        "wconhist": (WCONHIST_DECK.replace(
            "WCONINJH\n 'WATER' 'OPEN' 1200 /",
            "WCONINJH\n 'I1' 'WATER' 'OPEN' 1200 /"), 3),
        "multflt": (_geo_deck("MULTFLT\n 'F1' 1e-6 /\n/\n"), None),
    }


def norne_field_controls(text):
    """The Norne-class field under field-style controls: text edits of
    norne_like_deck's output (its DIMENS and fault FA read from the text).
    RUNSPEC: EQLDIMS 2, WELLDIMS 12 22 3 12. REGIONS: EQLNUM 1 west of
    fault FA (i <= its column), 2 elsewhere. SOLUTION: EQUIL and RSVD once
    a region, equal, and THPRES 1 2 between them. Wells: P1 on THP
    control with VFPPROD table 1 (an ORAT flo axis over P1's rates, THP
    and WCT axes); P2-P4 and P7 on GRUP under GRUPTREE 'PROD' 'FIELD' and
    GCONPROD 'PROD' 'ORAT'; P5 and P6 on WCONHIST 'RESV' with observed
    rates; P8 on ORAT with a WECON minimum oil rate; I1, I2 on WCONINJE
    rate, I3 on WCONINJH, I4 on WCONINJE 'RESV'. SCHEDULE: the first two
    TSTEPs, MULTFLT 'FA' 0.1, the third. SUMMARY: WBHP and WTHP. The
    values (METRIC) are test data, chosen with the reference's CPU runs:
    P8's ORAT target under its WECON minimum shuts it after the first
    report step at any size of the field."""
    lines = text.split("\n")
    dims = lines[lines.index("DIMENS") + 1].split()
    nx, ny, nz = int(dims[0]), int(dims[1]), int(dims[2])
    fa = next(ln for ln in lines if ln.startswith(" 'FA'")).split()
    f1 = int(fa[1])
    text = text.replace("EQLDIMS\n/", "EQLDIMS\n 2 /", 1)
    text = text.replace("WELLDIMS\n 12 22 1 12 /", "WELLDIMS\n 12 22 3 12 /",
                        1)
    eql = []
    for k in range(nz):
        for j in range(ny):
            eql.append(f"{f1}*1 {nx - f1}*2")
    text = text.replace("SOLUTION\n", "REGIONS\nEQLNUM\n "
                        + "\n ".join(eql) + " /\nSOLUTION\n", 1)
    equil = "\n 2650 270 2850 0 2500 0 1 0 0 /"
    text = text.replace("EQUIL" + equil, "EQUIL" + equil + equil, 1)
    rsvd = "RSVD\n 2400 90\n 2900 90 /"
    text = text.replace(rsvd, rsvd + "\n 2400 90\n 2900 90 /\n"
                        "THPRES\n 1 2 2.0 /\n/", 1)
    text = text.replace("SUMMARY\nFOPR\nFPR\n",
                        "SUMMARY\nFOPR\nFPR\nWBHP\n/\nWTHP\n/\n", 1)
    # P1's table: bhp = thp + a flo + b wct (bar, sm3/day)
    flo = [50.0, 500.0, 2000.0, 8000.0]
    thp = [10.0, 40.0, 80.0, 160.0]
    wct = [0.0, 0.5, 1.0]
    recs = []
    for it, t in enumerate(thp):
        for iw, w in enumerate(wct):
            recs.append(f" {it + 1} {iw + 1} 1 1 " + " ".join(
                f"{t + 150.0 + 0.01 * f + 30.0 * w:.6g}" for f in flo)
                + " /")
    vfp = ("VFPPROD\n 1 2600 'OIL' 'WCT' 'GOR' 'THP' ' ' 'METRIC' 'BHP' /\n "
           + " ".join(f"{v:g}" for v in flo) + " /\n "
           + " ".join(f"{v:g}" for v in thp) + " /\n "
           + " ".join(f"{v:g}" for v in wct) + " /\n 0 /\n 0 /\n"
           + "\n".join(recs) + "\n")
    wcon = ("GRUPTREE\n 'PROD' 'FIELD' /\n/\n" + vfp
            + "WCONPROD\n"
            " 'P1' 'OPEN' 'THP' 5* 120 60 1 /\n"
            " 'P2' 'OPEN' 'GRUP' 5* 120 /\n"
            " 'P3' 'OPEN' 'GRUP' 5* 120 /\n"
            " 'P4' 'OPEN' 'GRUP' 5* 120 /\n"
            " 'P7' 'OPEN' 'GRUP' 5* 120 /\n"
            " 'P8' 'OPEN' 'ORAT' 500 4* 120 /\n/\n"
            "GCONPROD\n 'PROD' 'ORAT' 3000 /\n/\n"
            "WCONHIST\n 'P5' 'OPEN' 'RESV' 900 30 80000 /\n"
            " 'P6' 'OPEN' 'RESV' 900 30 80000 /\n/\n"
            "WECON\n 'P8' 600 /\n/\n")
    head, rest = text.split("WCONPROD\n", 1)
    rest = rest[rest.index("/\nWCONINJE"):][2:]
    text = head + wcon + rest
    text = text.replace(
        " 'I3' 'WATER' 'OPEN' 'RATE' 3000 1* 420 /\n"
        " 'I4' 'WATER' 'OPEN' 'RATE' 3000 1* 420 /\n/\n",
        " 'I4' 'WATER' 'OPEN' 'RESV' 1* 3000 420 /\n/\n"
        "WCONINJH\n 'I3' 'WATER' 'OPEN' 3000 /\n/\n", 1)
    tail = text[text.index("TSTEP\n"):]
    text = text.replace(tail, "TSTEP\n 5 10 /\nMULTFLT\n 'FA' 0.1 /\n/\n"
                        "TSTEP\n 30 /\nEND\n", 1)
    return text
