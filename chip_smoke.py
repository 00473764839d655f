"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases (each prints a line of its own; any failure exits non-zero):

1. device: needs CUDA; prints the card's name and power limit (nvidia-smi)
   and turns TF32 off for matmul and cuDNN;
2. build: compiles the CUDA kernels (K1 tables.cu and its column march
   and EQUIL's cell pass equil.cu, K2 cells.cu, K3
   tpfa.cu, the K3 face blocks blocks.cu, K4/K6 block7.cu, K5 wells.cu,
   K6 cpr.cu, K7 gmg.cu, K8 krylov.cu, K9 newton.cu, K10 amg.cu, the
   face-list kernels faces.cu), one nvcc process each, all started
   together, prints what ptxas says of krylov.cu's, gmg.cu's and amg.cu's
   kernels (registers: the cooperative grids of K8 and of K7's and K10's
   V-cycle legs must be co-resident), of cells.cu's, block7.cu's,
   faces.cu's and wells.cu's (registers and spills of K2's entries and of
   the cell operators that carry K5's well term), of newton.cu's (K9) and
   of tpfa.cu's (K3: the tile march's registers set how many blocks an SM
   holds) and of equil.cu's (the march and the cell pass), K2's resident
   blocks per SM and the float64 instructions of
   K2's, K3's and the face blocks' kernels in the SASS (cuobjdump; the
   operations term of K2's bounds),
   and holds K8 against its twins at an odd length;
3. kernel == plain on the card: (a) K1/K2/K3/K9 at SPE1's shapes (K3's
   divergence and its tangent bit for bit, the tangent at the main path's
   jacfwd batch, B = 3 nc + 4 nw, with seeded tangents and with all-ones
   ones, one launch a call, timed there one call and per launch in a run of
   50 with its bound, and the whole dense Jacobian through the kernels'
   forward-mode rules against the plain CPU path); (b) K1/K2/K3/K9 at SPE10
   model 2's size (60x220x85 = 1.122M cells, the seeded SPE10-like deck),
   each timed against its plain version (CUDA events, warm, median of 20;
   K2's values bit for bit; K9's update entry bit for bit against its
   twins' composition in both call forms, its convergence row against the
   reference's expression with equal flags, also with a NaN cell and with
   no wells, over ten launches in a row, and each one device kernel per
   call under the profiler; K3's divergence and tangent bit for bit and per
   launch in a run of 50); (c) the
   assembly kernels (K2's assembly entry, the K3 face blocks, K5: the
   Schur-reduced operator with the well term fused into the cell
   operator's last launch, ten launches in a row bit for bit against the
   parent's pair, K4 then the stand-alone well term, and against the
   twins' composition; K2 and the fused operator also timed per launch
   over 50 back-to-back calls) and the
   CPR kernels K4, K6, K7 and K8 on real assembled systems (SPE1 and
   SPE10-2 initial state after the well initialisation, first dt; K8's
   steps also run twice for equal bits and checked to allocate nothing), timed
   at SPE10-2 with each one's bound and, where one PyTorch call computes
   the same function, that call's time, and one whole assembly through
   the kernels against one through their twins; D^-1 formed in K5's
   right-hand-side launch against the plain inv4x4 on the card (bit for
   bit, or within TOL_DINV of each block's max) with the right-hand side
   unchanged; K7's value refresh (one launch per coarsen_values into the
   hierarchy's buffers: every level and the float32 dense coarsest matrix
   bit for bit the per-level composition on CPU copies, inv_ex's info 0,
   the kernel making no allocator request and ten refreshes no net
   allocation, a V-cycle after a refresh with other
   values equal to one on freshly composed values; SPE1's hierarchy has
   no level, SPE10-2's twelve) with its time, bound and device kernels
   per coarsen_values; K7's two V-cycle legs
   (one V-cycle: exactly two launches and one float32 product) against
   the per-level twins, every level's right-hand side and correction
   held, with each leg's time, level 0's alone, the V-cycle's time and
   bound and its device kernels (torch.profiler), and the V-cycle from
   the CPR apply's weights and residual (the down leg's right-hand side
   entry, K6's weighted residual folded in) bit for bit the plain
   weighted residual followed by the legs, with its time and bound; then one
   SPE10-2
   Newton system solved with the kernels and again with the plain twins
   on the card;
3d. K1's EQUIL column march and EQUIL's cell pass (equil.cu) on every
   deck this script builds (SPE1, SPE10-2, the toys, the Norne-class
   field in both representations) and on SPE1 with PBVD in place of
   RSVD, SPE1CASE2_2P (dead oil, no DISGAS, no gas) and SPE9: each
   region's three columns bit for bit the twin's on the card (not on the
   toys: the twin takes about 10 s a region on the card), the kernel's
   call under the sync debug mode "error" (no host read), its ms a launch
   and the twin's; the cell pass over those columns into arrays of NaN,
   its call under the sync debug mode "error", bit for bit its twin on
   the region's cells and no other cell written, its ms and the twin's;
   one initial_state per deck (synced host clock) that fails unless it
   makes one march and one cell pass a region and no K1 lookup; SPE1's
   region gives the march's row of the kernels line, SPE10-2's the cell
   pass's (also per launch in a run of 50 and on the device, queued
   behind a spin kernel); at SPE10-2 and on the Norne-class
   field also the time from the parsed deck to the end of the first
   report step (the simulator's construction, initial_state and the
   step, each timed alone);
4. SPE1 end to end on the card through SimulatorFullyImplicitBlackoil
   (dense route), all report steps, held against
   data/spe1_reference_cpu.json (the JAX package's CPU run), with the
   launch counters of K1 (its lookups and column march)/K3/K9 read over
   that run (K9: one update per
   Newton, one convergence check per Newton and per converged substep);
4b. SPE3 (data/SPE3.DATA: wet gas PVTG, VAPOIL, RVVD), the only deck
   through the wet-gas branches: EQUIL's march and cell pass bit for bit
   their twins with RVVD and with PDVD in its place; K2's three entries
   and K9's update with SPE3's tables against their twins at SPE3's 324
   cells and at 1.122M seeded cells (K9's increments switching cells
   GASOIL <-> GASONLY both ways), timed there into the wet-gas rows of
   the kernels line; SPE3's first dense Jacobian on the card against the
   plain CPU path; then the whole 720-day schedule on the card held per
   report step to data/spe3_reference_cpu.json (counts equal, FPR,
   FOPR/FGPR/FGIR within their limits or the reference's own roundoff
   spread the fixture records), the deck's own checks (all GASONLY at
   t = 0 with 0 < rv < rv_sat, condensate dropping out, the gas balance)
   and the launch counters of its kernels over the run;
4c. output and restart: SPE1's whole schedule again with output on
   (output_dir in a temporary directory; .npz checkpoints, UNRST, VTK,
   Matlab), held to the fixture and to phase 4's run (counts, the final
   state's digest bit for bit), its wall beside phase 4's and the ratio;
   the SMSPEC's keys exactly the deck's requests plus TIME, the UNSMRY
   read back with the port's reader equal to the collector's rows at
   float32 rounding and held to the fixture; SPE1 resumed on the card from
   restart_0003.npz, from the UNRST at step 3 and by a crafted deck with
   RESTART 'SPE1CASE2' 3 /, each to the end of report step 5 and held to
   the uninterrupted run at the JAX package's restart-test limits; the
   host syncs (sync debug mode "warn"), K1 interp1 and K2 cells_values
   launches of each report step's summary row and output over SPE1's
   first three report steps, and the devices of their arrays (all cuda);
   SPE1 with its layers as FIPNUM regions and region and block vectors
   asked for, two report steps: the vectors in the SMSPEC and the card's
   summary arrays against the CPU's on the same state (1e-12 relative);
   SPE3's whole schedule with output on: phase 4b's counts and digest,
   the UNRST's RV equal to the state's rv at every step, FOPR and FGPR
   read back held to the fixture as phase 4b holds them;
5. SPE10-2's first report step (20 days) end to end on the card through
   the CPR route, with the launch counters of K4/K6/K7/K8 read over that
   run (K8: two launches per BiCGStab iteration, two per solve; K7: two
   launches and one float32 product per V-cycle, two V-cycles per
   iteration; the down leg from the CPR apply's weighted residual, its
   b entry never; one K7 refresh and one K5 right-hand side forming D^-1
   per Newton system, no plain inv4x4 on the card) and host-clock
   sections (each ended by a synchronize);
5b. the toy SPE10-like deck on the card against
   data/spe10like_toy_reference_cpu.json;
6. the Norne-class corner-point field at full size (norne_like_deck:
   46x112x22, two stair-step faults, ACTNUM holes), parsed once and built
   in both representations: embedded (113,344 cells, 7,166 extra faces,
   structured GMG) and gather (OPM_TPU_EMBED=0: 75,566 cells, aggregation
   AMG). On the first Newton system of each, the assembly kernels (K2, the
   K3 face blocks in stencil form and as the embedded epilogue, or in
   face-list form on the gather grid, the face-list form bit for bit its
   twin run on CPU copies of the inputs (the twin's index_add_ on the
   card adds in no fixed order) and on G per launch in a run of 50, the
   K4-faces copy its row phase writes (into a buffer of NaN) bit for bit
   the pack's twin, and the assembly's face-list part (the face blocks
   and K4-faces' operator over that copy) timed one call, in a run of 50
   and on the device; K5),
   K3's divergence over E's stencil bit for bit, the face-list kernels
   (K3-faces bit for bit its twin on CPU copies, timed per launch in a
   run of 50 on both grids; K4-faces: the system's sliced-ELL copy bit
   for bit the pack's twin, matvec and smoothing step, K6 cells and
   K6-faces, K9's masked convergence check; on G the main path's K6 as the first phases of
   K10's refresh launch, run into buffers filled with NaN, bit for bit
   the twin and the pair with no allocator request, timed one call, in a
   run of 50, on the device (queued behind a spin kernel) and on the host
   beside the pair and the parent's pressure setup), K8 at the
   gather grid's shapes, K10's value refresh (one launch per
   coarsen_values into the hierarchy's buffers: every level's values and
   the float32 dense coarsest matrix bit for bit the per-level twins'
   composition on CPU copies, ten refreshes allocating nothing, a V-cycle
   after a refresh with other values equal to one on a hierarchy put on
   the card afresh) and its two V-cycle legs on G (K7's on E) against
   their plain versions, timed with bounds and yardsticks (on E K7's
   refresh held as at SPE10-2); one gather
   Newton system solved with the
   kernels and with the twins; then the first report step (5 days) in each
   representation through SimulatorFullyImplicitBlackoil with no device
   argument, with its counts, wall time, sections and launch counters
   (the face blocks writing K4-faces' copy once per Newton system, also
   on the toy decks of phase 7; the
   pressure setup one launch a
   Newton on G, K10's refresh with K6 in it, and two on E, K6 and K7's
   refresh; D^-1 by K5's right-hand side and never by the plain inv4x4
   on the card),
   each held to the JAX package's CPU run of the same representation
   (data/nornelike_full_reference_cpu.json) at the limits of phase 4, and
   the two to each other as closely as the reference's two runs agree;
   then that step again in each with output on (UNRST, INIT, EGRID): the
   output-off run's counts and digest, FPR and FOPR read back from the
   UNSMRY held to the fixture, the files covering the real active cells
   only;
7. the toy Norne-like deck in both representations against
   data/nornelike_toy_reference_cpu.json (first K6 in K10's refresh
   against the twin and the pair on the gather deck's first Newton
   system);
3e. (after 3b) K3's five entries with a THPRES threshold (a third of the
   faces at 0, a third above |dphi|, the rest exactly one phase's |dphi|
   as the twin computes it on a CPU copy: the clip's tie): the
   divergence, its tangent (B = 3) and the stencil face blocks at
   SPE10-2's shapes bit for bit their twins on the card; K3-faces'
   divergence and face blocks on the full Norne-class gather grid's face
   list bit for bit their twins on CPU copies (phase 8); each timed per
   launch and in a run of 50 with and without the threshold, with its
   bound;
4d. the small decks of the JAX package's tests of field-style controls
   (data/wellctrl_reference_cpu.json: THPRES given and defaulted,
   secondary-limit switching, the VFP datum correction, WTHP, a group
   ORAT target, WCONHIST/WCONINJH, MULTFLT mid-run) end to end on the card
   through the dense route, each held per report step to whichever of
   the fixture's two runs (compiled, op by op) has its counts: FPR within
   1e-4, FOPR, FWPR, FGOR within 1e-3, WBHP 1e-4, WTHP 1e-3, the same
   control code for every well; no host sync (host-to-device copies
   included) inside any Newton iteration's residual, controls and
   assembly;
8. the Norne-class field under field controls (sim/testcases.py
   norne_field_controls: THP with a VFP table, a group ORAT target,
   WCONHIST RESV, WECON, WCONINJH, a RESV injector, THPRES between two
   EQLNUM regions, MULTFLT before the third of three report steps): the
   toy field in E and G held to data/nornewells_reference_cpu.json and
   the full field (46x112x22) in E and G held to
   data/nornewells_full_reference_cpu.json; each with its wall, counts,
   sections, the threshold entries' launches, P8 shut by WECON, no host
   sync inside any Newton iteration's residual, controls and assembly,
   the CPR hierarchy rebuilt after MULTFLT (K7's refresh on E, K10's on G
   launched after it; the hierarchy's, the model's and the simulator's
   device bytes before and after), device memory at the end within 5% of
   what it was before the rebuild (both after a garbage collection), and a report step's host reads and seconds of
   each new piece (groups, VFP, WTHP, economic limits, RESV).

Phases 4 to 7 read the launch counters over each run (and print the
synced Newton sections) and fail if a kernel of that run's path was not
launched; the CPR runs also fail unless a reduced matvec was one device
launch (structured and gather grids) or two (embedded grids: K4, then
K4-faces with the well term) and the stand-alone well term never ran.

The line before the last is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
JAX_PKG = "opm-simulators-legacy_tpu"

# tolerances (kernel vs plain on the card)
TOL_K1 = 1e-13       # relative, values and slopes
TOL_K9_NORM = 1e-12  # relative
TOL_K4 = 1e-12       # of max (same order of operations as the twin)
TOL_K6_SETUP = 1e-13  # of max, per output
TOL_K7 = 1e-12       # of max, each level's rhs and correction, a V-cycle
TOL_K8_VEC = 1e-13   # of max (same elementwise operations)
TOL_K8_DOT = 1e-12   # relative (block-tree vs library summation order)
TOL_K10 = 1e-12      # of max, the refresh vs the per-level twins on the card
#                      (their index_add_ runs on atomics)
# K2: the same operations in the same order as the plain formula
# (--fmad=false): values relative; tangent columns and the assembly's
# diag of each row's max (torch's jvp orders a few sums differently)
TOL_K2_VAL = 1e-13
TOL_K2_TAN = 1e-12
# the K3 face blocks (the twin sums in the same order; on the card its
# face-list scatter-adds use atomics) and K5 (einsum vs in-order sums), of
# each field's max
TOL_BLOCKS = 1e-12
TOL_K5 = 1e-12
# D^-1 formed in K5's right-hand-side launch against the plain inv4x4 on
# the card, of each block's max, where the bits differ
TOL_DINV = 1e-14
# a whole AMG V-cycle and each level's right-hand side and correction of
# its legs: the coarsest level is solved in float32, and the twin's
# restriction (an index_add with atomics on the card) sums in another
# order, which can round the float32 right-hand side the other way
TOL_K10_VCYCLE = 1e-6
# a whole SPE10-2 linear solve, kernels vs twins: the same iteration
# count; du within TOL_DU of max|du| (BiCGStab amplifies the dot products'
# summation-order difference; tests/test_torch_cpr.py measures the
# reference's own sensitivity)
TOL_DU = 1e-5
# the dense Jacobian on the card against the plain CPU path (the CPU tests
# hold the plain path to the JAX package's jax.jacfwd at the same bound)
TOL_JAC = 1e-10      # of max|J|
# end to end against the JAX package's CPU runs
TOL_FPR = 1e-4
TOL_RATE = 1e-3
TOL_NEWTON_TOTAL = 0.01
TOL_LINEAR = 0.02    # linear iterations per report step (roundoff order)

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the FP64 (non-tensor)
# peak, the bound's two rates for these float64 kernels
HBM_BYTES_S = 3.35e12
F64_FLOP_S = 34e12
# float32 outside the tensor cores (TF32 is off): the float32 coarsest
# inverses' operations term
F32_FLOP_S = 67e12
# float64 instructions per second: the peak counts a DFMA as two
# operations; built with --fmad=false every DADD and DMUL is one
# instruction of one operation, issued at half that rate
F64_INSTR_S = F64_FLOP_S / 2


def log(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def embed_knob(value):
    """OPM_TPU_EMBED set to ``value`` (None: unset) inside the block."""
    old = os.environ.pop("OPM_TPU_EMBED", None)
    if value is not None:
        os.environ["OPM_TPU_EMBED"] = value
    try:
        yield
    finally:
        os.environ.pop("OPM_TPU_EMBED", None)
        if old is not None:
            os.environ["OPM_TPU_EMBED"] = old


def fail(msg):
    raise RuntimeError(msg)


def rel_err(a, b):
    """max |a - b| / |b| elementwise (exact zeros compare exactly)."""
    import torch
    d = (a - b).abs()
    scale = b.abs()
    r = torch.where(d == 0, torch.zeros_like(d), d / scale)
    return float(r.max()) if r.numel() else 0.0


def scaled_err(a, b):
    """max |a - b| / max |b|."""
    s = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / max(s, 1e-300) if b.numel() else 0.0


def row_scaled_err(a, b):
    """max over rows (every axis but the last) of max |a - b| / max |b|."""
    import torch
    a = a.reshape(-1, a.shape[-1])
    b = b.reshape(-1, b.shape[-1])
    d = (a - b).abs().amax(dim=1)
    s = b.abs().amax(dim=1)
    r = torch.where(d == 0, torch.zeros_like(d), d / s.clamp(min=1e-300))
    return float(r.max()) if r.numel() else 0.0


def host_ms(fn, reps=5):
    """Median host-clock time of fn (ended by a synchronize) over reps
    warm runs, in ms: for work that is not one kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def cuda_ms(fn, reps=20):
    """Median device time of fn over reps warm runs (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def run_ms(fn, run=50, reps=5):
    """Median device time per call of fn over ``run`` back-to-back calls
    (CUDA events around the run), of ``reps`` warm runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(run):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / run)
    return statistics.median(times)


def allocations(fn, reps=10):
    """The caching allocator's requests per call of fn over ``reps`` warm
    calls (``allocation.all.allocated``, which counts every request, a
    block served from the cache too), and whether the memory allocated
    after them is what it was before (no net allocation)."""
    import torch
    fn()
    gc.collect()        # earlier cyclic garbage, freed at any moment
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    a0 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    a1 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    return (a1 - a0) / reps, torch.cuda.memory_allocated() == m0


def nbytes(*ts):
    import torch
    n = 0
    for t in ts:
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
        elif isinstance(t, (tuple, list)):
            n += nbytes(*t)
    return n


class RhsInverses:
    """K5's right-hand-side launches that formed D^-1 (the ``inverses``
    count of ``schur_rhs_cuda``), read and reset as a wrapper's
    ``launches``."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.inverses

    @launches.setter
    def launches(self, n):
        self.fn.inverses = n


@contextlib.contextmanager
def plain_inv4x4_on_card():
    """Counts the plain ``inv4x4`` calls on CUDA tensors inside the block
    (the main path forms D^-1 in K5's right-hand-side launch instead):
    yields a one-element list."""
    from opm_tpu_torch.linalg import precond
    plain, calls = precond.inv4x4, [0]

    def counted(m):
        calls[0] += m.device.type == "cuda"
        return plain(m)

    precond.inv4x4 = counted
    try:
        yield calls
    finally:
        precond.inv4x4 = plain


class Kernels:
    """The kernels of the paths: wrappers, sources, replaced functions, and
    what chip_smoke measured for each."""

    def __init__(self):
        from opm_tpu_torch.linalg import amg as k10
        from opm_tpu_torch.linalg import gmg as k7
        from opm_tpu_torch.linalg import kernels_k8 as k8
        from opm_tpu_torch.linalg import precond as k6
        from opm_tpu_torch.models import blackoil as mb
        from opm_tpu_torch.models import linearize as k4
        from opm_tpu_torch.sim import init as equil
        from opm_tpu_torch.solver import kernels_k9 as k9
        from opm_tpu_torch.utils import tables as k1
        P = "opm_tpu_torch"
        self.entries = [
            ("K1 interp1", "cuda", f"{P}/csrc/tables.cu",
             f"{JAX_PKG}/utils/tables.py:97", k1.interp1_cuda),
            ("K1 interp2", "cuda", f"{P}/csrc/tables.cu",
             f"{JAX_PKG}/utils/tables.py:217", k1.interp2_cuda),
            ("K1 equil_march", "cuda", f"{P}/csrc/equil.cu",
             f"{JAX_PKG}/sim/init.py:46-76,108-131",
             equil.equil_columns_cuda),
            ("K1 equil_cells", "cuda", f"{P}/csrc/equil.cu",
             f"{JAX_PKG}/sim/init.py:133-172 and utils/tables.py:97",
             equil.equil_cells_cuda),
            ("K3 tpfa_div", "cuda", f"{P}/csrc/tpfa.cu",
             f"{JAX_PKG}/models/blackoil.py:176", mb.tpfa_div_cuda),
            ("K3 tpfa_div_tangent", "cuda", f"{P}/csrc/tpfa.cu",
             f"{JAX_PKG}/models/blackoil.py:298",
             mb.tpfa_div_tangent_cuda),
            ("K9 update", "cuda", f"{P}/csrc/newton.cu",
             f"{JAX_PKG}/solver/update.py:19", k9.update_cuda),
            ("K9 convergence", "cuda", f"{P}/csrc/newton.cu",
             f"{JAX_PKG}/models/blackoil.py:447", k9.convergence_cuda),
            ("K4 block7_matvec", "cuda", f"{P}/csrc/block7.cu",
             f"{JAX_PKG}/models/linearize.py:559", k4.matvec_cells_cuda),
            ("K6 block7_smooth", "cuda", f"{P}/csrc/block7.cu",
             f"{JAX_PKG}/linalg/precond.py:388", k6.smooth_step_cuda),
            ("K6 cpr_setup", "cuda", f"{P}/csrc/cpr.cu",
             f"{JAX_PKG}/linalg/precond.py:174", k6.cpr_setup_cuda),
            ("K7 gmg_vcycle_down", "cuda", f"{P}/csrc/gmg.cu",
             f"{JAX_PKG}/linalg/gmg.py:171,200,295-307",
             k7.vcycle_down_cuda),
            ("K7 gmg_vcycle_up", "cuda", f"{P}/csrc/gmg.cu",
             f"{JAX_PKG}/linalg/gmg.py:171,200,308-312", k7.vcycle_up_cuda),
            ("K7 gmg_vcycle_down_rhs", "cuda", f"{P}/csrc/gmg.cu",
             f"{JAX_PKG}/linalg/gmg.py:171,200,295-307 and "
             "linalg/precond.py:391", k7.vcycle_down_rhs_cuda),
            ("K7 gmg_refresh", "cuda", f"{P}/csrc/gmg.cu",
             f"{JAX_PKG}/linalg/gmg.py:209-293", k7.refresh_cuda),
            ("K8 init", "cuda", f"{P}/csrc/krylov.cu",
             f"{JAX_PKG}/linalg/krylov.py:59", k8.init_cuda),
            ("K8 p_update", "cuda", f"{P}/csrc/krylov.cu",
             f"{JAX_PKG}/linalg/krylov.py:77", k8.p_update_cuda),
            ("K8 alpha_s", "cuda", f"{P}/csrc/krylov.cu",
             f"{JAX_PKG}/linalg/krylov.py:80-84", k8.alpha_s_cuda),
            ("K8 omega_xr_p", "cuda", f"{P}/csrc/krylov.cu",
             f"{JAX_PKG}/linalg/krylov.py:87-92,70-77", k8.omega_xr_p_cuda),
            ("K3-faces faces_div", "cuda", f"{P}/csrc/faces.cu",
             f"{JAX_PKG}/models/blackoil.py:319", mb.faces_div_cuda),
            ("K4-faces matvec", "cuda", f"{P}/csrc/faces.cu",
             f"{JAX_PKG}/models/linearize.py:474", k4.faces_matvec_cuda),
            ("K4-faces smooth", "cuda", f"{P}/csrc/faces.cu",
             f"{JAX_PKG}/linalg/precond.py:402", k4.faces_smooth_cuda),
            ("K6 cpr_setup_cells", "cuda", f"{P}/csrc/cpr.cu",
             f"{JAX_PKG}/linalg/precond.py:174", k6.cpr_setup_cells_cuda),
            ("K6-faces cpr_faces", "cuda", f"{P}/csrc/cpr.cu",
             f"{JAX_PKG}/linalg/precond.py:254", k6.cpr_faces_cuda),
            ("K6 cpr_setup in amg_refresh", "cuda", f"{P}/csrc/amg.cu",
             f"{JAX_PKG}/linalg/precond.py:113,174,254 and "
             "linalg/amg.py:206-243", k10.refresh_setup_cuda),
            ("K9 convergence_masked", "cuda", f"{P}/csrc/newton.cu",
             f"{JAX_PKG}/models/blackoil.py:452",
             k9.convergence_masked_cuda),
            ("K10 amg_vcycle_down", "cuda", f"{P}/csrc/amg.cu",
             f"{JAX_PKG}/linalg/amg.py:27,37,264-279",
             k10.vcycle_down_cuda),
            ("K10 amg_vcycle_up", "cuda", f"{P}/csrc/amg.cu",
             f"{JAX_PKG}/linalg/amg.py:27,37,280-282", k10.vcycle_up_cuda),
            ("K10 amg_vcycle_down_rhs", "cuda", f"{P}/csrc/amg.cu",
             f"{JAX_PKG}/linalg/amg.py:27,37,264-279 and "
             "linalg/precond.py:391", k10.vcycle_down_rhs_cuda),
            ("K10 amg_refresh", "cuda", f"{P}/csrc/amg.cu",
             f"{JAX_PKG}/linalg/amg.py:206-243", k10.refresh_cuda),
            ("K2 cells_values", "cuda", f"{P}/csrc/cells.cu",
             f"{JAX_PKG}/models/blackoil.py:95", mb.cells_values_cuda),
            ("K2 cells_columns", "cuda", f"{P}/csrc/cells.cu",
             f"{JAX_PKG}/models/linearize.py:175", mb.cells_columns_cuda),
            ("K2 cells_assemble", "cuda", f"{P}/csrc/cells.cu",
             f"{JAX_PKG}/models/linearize.py:141", mb.cells_assemble_cuda),
            ("K3 face_blocks", "cuda", f"{P}/csrc/blocks.cu",
             f"{JAX_PKG}/models/linearize.py:169", k4.face_blocks_cuda),
            ("K3-faces face_blocks", "cuda", f"{P}/csrc/faces.cu",
             f"{JAX_PKG}/models/linearize.py:275", k4.faces_blocks_cuda),
            ("K5 schur_matvec", "cuda", f"{P}/csrc/wells.cu",
             f"{JAX_PKG}/models/linearize.py:653", k4.schur_matvec_cuda),
            ("K5 schur_matvec fused", "cuda", f"{P}/csrc/wells.cuh",
             f"{JAX_PKG}/models/linearize.py:653",
             k4.reduced_matvec_cuda),
            ("K5 schur_rhs", "cuda", f"{P}/csrc/wells.cu",
             f"{JAX_PKG}/models/linearize.py:638", k4.schur_rhs_cuda),
            ("K5 schur_recover", "cuda", f"{P}/csrc/wells.cu",
             f"{JAX_PKG}/models/linearize.py:640", k4.schur_recover_cuda),
            ("K5 inv4x4 in schur_rhs", "cuda", f"{P}/csrc/wells.cuh",
             f"{JAX_PKG}/linalg/precond.py:42",
             RhsInverses(k4.schur_rhs_cuda)),
            # the wet-gas (PVTG, VAPOIL, RVVD/PDVD) branches of K2, K9 and
            # EQUIL's kernels: the same launches as the rows above, timed
            # with SPE3's tables and counted over SPE3's run
            ("K2 cells_values wet gas", "cuda", f"{P}/csrc/cells.cu",
             f"{JAX_PKG}/models/blackoil.py:95-147 and props/pvt.py:245-346",
             mb.cells_values_cuda),
            ("K2 cells_columns wet gas", "cuda", f"{P}/csrc/cells.cu",
             f"{JAX_PKG}/models/linearize.py:175 and props/pvt.py:245-346",
             mb.cells_columns_cuda),
            ("K2 cells_assemble wet gas", "cuda", f"{P}/csrc/cells.cu",
             f"{JAX_PKG}/models/linearize.py:141 and props/pvt.py:245-346",
             mb.cells_assemble_cuda),
            ("K9 update VAPOIL", "cuda", f"{P}/csrc/newton.cu",
             f"{JAX_PKG}/solver/update.py:90-135", k9.update_cuda),
            ("K1 equil_march wet gas", "cuda", f"{P}/csrc/equil.cu",
             f"{JAX_PKG}/sim/init.py:46-76,108-124",
             equil.equil_columns_cuda),
            ("K1 equil_cells RVVD", "cuda", f"{P}/csrc/equil.cu",
             f"{JAX_PKG}/sim/init.py:174-183", equil.equil_cells_cuda),
            ("K1 equil_cells PDVD", "cuda", f"{P}/csrc/equil.cu",
             f"{JAX_PKG}/sim/init.py:184-188", equil.equil_cells_cuda),
            # K3's entries with a THPRES threshold (the clip of
            # face_flux_from_q): the same launches as their rows above,
            # counted where a threshold is given
            ("K3 tpfa_div thr", "cuda", f"{P}/csrc/tpfa.cu",
             f"{JAX_PKG}/models/blackoil.py:194-198,298-331",
             ThrCount(mb.tpfa_div_cuda)),
            ("K3 tpfa_div_tangent thr", "cuda", f"{P}/csrc/tpfa.cu",
             f"{JAX_PKG}/models/blackoil.py:194-198,298-331",
             ThrCount(mb.tpfa_div_tangent_cuda)),
            ("K3 face_blocks thr", "cuda", f"{P}/csrc/blocks.cu",
             f"{JAX_PKG}/models/linearize.py:164-236",
             ThrCount(k4.face_blocks_cuda)),
            ("K3-faces faces_div thr", "cuda", f"{P}/csrc/faces.cu",
             f"{JAX_PKG}/models/blackoil.py:194-198,319-338",
             ThrCount(mb.faces_div_cuda)),
            ("K3-faces face_blocks thr", "cuda", f"{P}/csrc/faces.cu",
             f"{JAX_PKG}/models/linearize.py:237-320",
             ThrCount(k4.faces_blocks_cuda)),
        ]
        self.err = {e[0]: 0.0 for e in self.entries}
        self.ms, self.plain_ms, self.library_ms = {}, {}, {}
        self.bound_ms, self.bound_by, self.launches = {}, {}, {}
        # ms per launch over a run of back-to-back calls (K2, K5 fused)
        self.run_ms = {}
        # float64 instructions per thread in the SASS, by kernel
        self.sass = {}

    # entries of the face-list path whose names share a prefix with the
    # structured kernels
    FACE_GRIDS_ONLY = ("K6 cpr_setup_cells", "K6 cpr_setup in amg_refresh",
                       "K9 convergence_masked")
    # entries held against their plain versions but off the main path:
    # the CPR apply's V-cycle forms its right-hand side in the down leg
    # (the right-hand side entries), so the down legs' b entries never run
    # there; on a gather grid K6 runs as the first phases of K10's refresh
    # (one launch a Newton), so neither the former pair (K6's cell part,
    # then K6-faces) nor the refresh alone runs; EQUIL's cell pass does the
    # initial state's lookups onto the cells, so K1 interp1 runs on no
    # EQUIL deck
    OFF_MAIN = ("K7 gmg_vcycle_down", "K10 amg_vcycle_down",
                "K6 cpr_setup_cells", "K6-faces cpr_faces",
                "K10 amg_refresh", "K1 interp1")
    # the kernels each run must launch: the dense route (SPE1; its initial
    # state is K1's column march and EQUIL's cell pass: K1 interp1 and
    # interp2 run on no path of an EQUIL deck), and the assembly and Schur
    # elimination of every CPR run
    DENSE = ("K1 equil_march", "K1 equil_cells", "K2 cells_values",
             "K2 cells_columns", "K3 tpfa_div", "K3 tpfa_div_tangent",
             "K9 update", "K9 convergence")
    ASSEMBLY = ("K2 cells_values", "K2 cells_columns", "K2 cells_assemble",
                "K5 schur_matvec fused", "K5 schur_rhs", "K5 schur_recover",
                "K5 inv4x4 in schur_rhs")
    # the kernels SPE3's run (dense route, wet gas) must launch, by their
    # wet-gas rows
    SPE3 = ("K1 equil_march wet gas", "K1 equil_cells RVVD",
            "K2 cells_values wet gas", "K2 cells_columns wet gas",
            "K3 tpfa_div", "K3 tpfa_div_tangent", "K9 update VAPOIL",
            "K9 convergence")
    # K2's entries and their kernels
    K2_KERNELS = {"K2 cells_values": "cells_values_kernel",
                  "K2 cells_columns": "cells_columns_kernel",
                  "K2 cells_assemble": "cells_assemble_kernel"}
    K2_KERNELS.update({f"{k} wet gas": v for k, v in K2_KERNELS.items()})

    # the wet-gas rows (phase 4b)
    WET_GAS = ("K2 cells_values wet gas", "K2 cells_columns wet gas",
               "K2 cells_assemble wet gas", "K9 update VAPOIL",
               "K1 equil_march wet gas", "K1 equil_cells RVVD",
               "K1 equil_cells PDVD")

    # the threshold rows (phases 3e, 4d and 8)
    THR = ("K3 tpfa_div thr", "K3 tpfa_div_tangent thr",
           "K3 face_blocks thr", "K3-faces faces_div thr",
           "K3-faces face_blocks thr")
    # the pressure hierarchy's launches a MULTFLT rebuild must be followed
    # by (E: K7's refresh; G: K6 in K10's refresh, K10's up leg)
    REBUILT = ("K7 gmg_refresh", "K6 cpr_setup in amg_refresh",
               "K10 amg_vcycle_up")

    def names(self, prefixes, face_grids=False, main_path=False):
        """The entries whose kernel family is in ``prefixes``: those of the
        structured routes, or with ``face_grids`` those of the grids with
        a face list; with ``main_path`` only those a run launches (the
        wet-gas and the threshold rows are named by WET_GAS and THR
        alone)."""
        return [e[0] for e in self.entries if e[0].split()[0] in prefixes
                and (e[0] in self.FACE_GRIDS_ONLY) == face_grids
                and e[0] not in self.WET_GAS and e[0] not in self.THR
                and not (main_path and e[0] in self.OFF_MAIN)]

    def counts(self, names):
        """The wrappers' current launch counts of ``names``."""
        return {e[0]: e[4].launches for e in self.entries if e[0] in names}

    def reset(self):
        from opm_tpu_torch.linalg import gmg as k7
        for e in self.entries:
            e[4].launches = 0
        k7.coarsest_product.calls = 0

    def read(self, names):
        for e in self.entries:
            if e[0] in names:
                self.launches[e[0]] = e[4].launches

    def note(self, name, err):
        self.err[name] = max(self.err[name], err)

    def bound(self, name, ins, outs, flops):
        """The least time the card could take: each input read once and
        each output written once over HBM, or the float64 operations over
        the FP64 peak, whichever is larger."""
        t_bytes = nbytes(ins, outs) / HBM_BYTES_S * 1e3
        t_ops = flops / F64_FLOP_S * 1e3
        self.bound_ms[name] = max(t_bytes, t_ops)
        self.bound_by[name] = "bytes" if t_bytes >= t_ops else "operations"

    def bound_instr(self, name, nbytes_moved, instructions):
        """bound() from a byte count and a count of float64 instructions
        (from the SASS) at the --fmad=false issue rate."""
        t_bytes = nbytes_moved / HBM_BYTES_S * 1e3
        t_ops = instructions / F64_INSTR_S * 1e3
        self.bound_ms[name] = max(t_bytes, t_ops)
        self.bound_by[name] = "bytes" if t_bytes >= t_ops else "operations"

    def bound_raw(self, name, nbytes_moved, flops):
        """bound() from a byte count (a kernel that reads only some rows
        of its inputs, as K5 reads the perforated cells)."""
        t_bytes = nbytes_moved / HBM_BYTES_S * 1e3
        t_ops = flops / F64_FLOP_S * 1e3
        self.bound_ms[name] = max(t_bytes, t_ops)
        self.bound_by[name] = "bytes" if t_bytes >= t_ops else "operations"

    def report(self):
        return {"kernels": [dict(
            name=n, route=route, source=src, replaces=rep,
            launches=int(self.launches.get(n, 0)),
            max_abs_err=self.err[n], ms=self.ms.get(n),
            plain_ms=self.plain_ms.get(n), bound_ms=self.bound_ms.get(n),
            bound_by=self.bound_by.get(n),
            library_ms=self.library_ms.get(n))
            for n, route, src, rep, _ in self.entries]}


# ---------------------------------------------------------------------------
def seeded_state(model, seed, dev):
    """A state in every hcstate, made from the seed with numpy."""
    import numpy as np

    from opm_tpu_torch.utils.convert import state_from_numpy
    rng = np.random.default_rng(seed)
    nc = model.nc
    hc = rng.integers(0, 3, nc).astype(np.int32)
    sw = rng.uniform(0.15, 0.7, nc)
    x = np.where(hc == 0, rng.uniform(0.0, 0.25, nc),
                 np.where(hc == 1, rng.uniform(20.0, 120.0, nc),
                          rng.uniform(0.0, 1e-4, nc)))
    return state_from_numpy(dict(
        pressure=rng.uniform(1.5e7, 4.0e7, nc), sw=sw, x=x, hcstate=hc,
        bhp=np.zeros(0), qs=np.zeros((0, 3)), control=np.zeros(0),
        target=np.zeros(0)), dev)


def compare_kernels(K, model, state, seed, label, timed, B):
    """K1/K2/K3/K9 against their plain versions on the same card inputs; B
    is the K3 tangent batch."""
    import numpy as np
    import torch

    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.utils import tables as k1

    props = model.props
    rng = np.random.default_rng(seed + 1)
    dev = model.device
    nc = model.nc
    p, sw = state.pressure, state.sw
    q = model.cell_quantities(state)

    def chk(name, tol, pairs):
        for a, b in pairs:
            e = rel_err(a, b)
            K.note(name, float((a - b).abs().max()))
            if not e <= tol:
                fail(f"{label}: {name} differs from its plain version "
                     f"(rel {e:.3e} > {tol:g})")

    def time_pair(name, kfn, pfn, ins, flops):
        if timed:
            K.ms[name] = cuda_ms(kfn)
            K.plain_ms[name] = cuda_ms(pfn)
            K.bound(name, ins, kfn(), flops)

    # K1 1-D: the PVTO saturated curve (linear) and the SWOF columns (clamp)
    lo = props.oil_live
    sf = props.satfunc
    for xs, ys, xq, clamp in ((lo.pbub_tab, lo.rs_col, p, 0),
                              (sf.sw, sf.w_cols, sw, 1)):
        kv = k1.interp1_cuda(xs, ys, xq, None, clamp)
        pv = k1.lookup1_plain(xs, ys, xq, None, clamp)
        chk("K1 interp1", TOL_K1, zip(kv, pv))
    time_pair("K1 interp1",
              lambda: k1.interp1_cuda(sf.sw, sf.w_cols, sw, None, 1),
              lambda: k1.lookup1_plain(sf.sw, sf.w_cols, sw, None, 1),
              (sw, sf.sw, sf.w_cols), 15 * nc * sf.w_cols.shape[0])
    # K1 2-D: the PVTO inv_b/inv_bmu pair at (rs, p - p_bub(rs))
    rs = q.rs
    dpb = torch.clamp(p - lo.p_bub(rs, None), min=0.0)
    kv = k1.interp2_cuda(lo.rs_tab, lo.dp_grid, lo.grids, rs, dpb, None, 0, 0)
    pv = k1.lookup2_plain(lo.rs_tab, lo.dp_grid, lo.grids, rs, dpb, None,
                          0, 0)
    chk("K1 interp2", TOL_K1, zip(kv, pv))
    time_pair("K1 interp2",
              lambda: k1.interp2_cuda(lo.rs_tab, lo.dp_grid, lo.grids, rs,
                                      dpb, None, 0, 0),
              lambda: k1.lookup2_plain(lo.rs_tab, lo.dp_grid, lo.grids, rs,
                                       dpb, None, 0, 0),
              (rs, dpb, lo.rs_tab, lo.dp_grid, lo.grids),
              30 * nc * lo.grids.shape[0])

    # K2: the CellQuantities rows (the residual's entry) and their tangent
    # columns (the forward-mode rule's), at every cell of the state
    pack = props.cell_pack()
    a2 = (p, sw, state.x, state.hcstate, model.pvtnum, model.satnum)
    kq = mb.cells_values_cuda(pack, *a2)
    pq = mb.cells_values_plain(props, *a2)
    chk("K2 cells_values", TOL_K2_VAL, [(kq, pq)])
    if not torch.equal(kq, pq):
        fail(f"{label}: K2 cells_values are not bit for bit the plain "
             "version's")
    kc = mb.cells_columns_cuda(pack, *a2)
    pc = mb.cells_columns_plain(props, *a2)
    K.note("K2 cells_columns", float((kc - pc).abs().max()))
    e2 = row_scaled_err(kc, pc)
    if not e2 <= TOL_K2_TAN:
        fail(f"{label}: K2 cells_columns differ from the plain version "
             f"({e2:.3e} of a row's max > {TOL_K2_TAN:g})")
    # bytes: the primaries, the states, the regions, the tables and the
    # rows written; operations: the kernel's float64 instructions per
    # thread in the SASS, one thread a cell
    k2_ins = (a2[:3], state.hcstate, model.pvtnum, model.satnum, pack.tab)
    for name, kfn, pfn, out in (
            ("K2 cells_values", lambda: mb.cells_values_cuda(pack, *a2),
             lambda: mb.cells_values_plain(props, *a2), kq),
            ("K2 cells_columns", lambda: mb.cells_columns_cuda(pack, *a2),
             lambda: mb.cells_columns_plain(props, *a2), kc)):
        if timed:
            K.ms[name] = cuda_ms(kfn)
            K.plain_ms[name] = cuda_ms(pfn)
            K.run_ms[name] = run_ms(kfn)
            K.bound_instr(name, nbytes(k2_ins, out),
                          K.sass["cells"][K.K2_KERNELS[name]] * nc)
    del kq, pq, kc, pc

    # K3 forward and tangent
    p3 = torch.stack([q.pw, q.po, q.pg]).contiguous()
    bmob = (q.b * q.mob).contiguous()
    rho = q.rho.contiguous()
    rsv, rvv = q.rs.contiguous(), q.rv.contiguous()
    args = (model.dims, p3, rho, bmob, rsv, rvv, model.depth, model.trans,
            model.gravity)
    nf = model.trans.shape[0]
    kd = mb.tpfa_div_cuda(*args)
    pd = mb.tpfa_div_plain(*args)
    K.note("K3 tpfa_div", float((kd - pd).abs().max()))
    if not torch.equal(kd, pd):
        fail(f"{label}: K3 tpfa_div is not bit for bit its plain version's "
             f"({scaled_err(kd, pd):.3e} of max|div|)")
    tan = [torch.as_tensor(rng.standard_normal((B,) + a.shape), device=dev)
           * a.abs().mean() for a in (p3, rho, bmob, rsv, rvv)]
    kt = mb.tpfa_div_tangent_cuda(*args, *tan)
    pt = mb.tpfa_div_tangent_plain(*args, *tan)
    K.note("K3 tpfa_div_tangent", float((kt - pt).abs().max()))
    if not torch.equal(kt, pt):
        fail(f"{label}: K3 tangent (B = {B}) is not bit for bit its plain "
             f"version's ({scaled_err(kt, pt):.3e} of max|ddiv|)")
    time_pair("K3 tpfa_div", lambda: mb.tpfa_div_cuda(*args),
              lambda: mb.tpfa_div_plain(*args), args[1:8], 80 * nf)
    if timed:
        K.run_ms["K3 tpfa_div"] = run_ms(lambda: mb.tpfa_div_cuda(*args))
    time_pair("K3 tpfa_div_tangent",
              lambda: mb.tpfa_div_tangent_cuda(*args, *tan),
              lambda: mb.tpfa_div_tangent_plain(*args, *tan),
              (args[1:8], tan), 120 * nf * B)
    if timed:
        K.run_ms["K3 tpfa_div_tangent"] = run_ms(
            lambda: mb.tpfa_div_tangent_cuda(*args, *tan))

    # K9: the update entry and the convergence check
    return compare_k9(K, model, state, q, seed, label,
                      ("K9 update", "K9 convergence") if timed else ())


def compare_k9(K, model, state, q, seed, label, timed=()):
    """K9 on the card at the run's own shapes: the update entry (seeded
    increments, omega 0.9; the state's own wells, or five seeded wells
    where it has none) bit for bit against its twins' composition (K1's
    rs_sat on the card) in the CPR route's call form ((3, nc) and (nw, 4)
    increments) and the dense route's (views of one flat vector); the
    convergence row (masked where the model has a padding mask) within
    TOL_K9_NORM of the reference's expression with equal flags, on seeded
    residuals, with no wells and with a NaN cell (finite cleared), over
    ten launches in a row (the ticket's reset: the same bits each time).
    For the rows named in ``timed``: times and bounds, and the device
    kernels of one ``update_state`` or one ``BlackoilModel.convergence``
    call under the profiler (one each). Returns those counts."""
    import numpy as np
    import torch

    from opm_tpu_torch.models.blackoil import Residual
    from opm_tpu_torch.solver import kernels_k9 as k9
    from opm_tpu_torch.solver.update import update_state

    rng = np.random.default_rng(seed + 2)
    dev, nc, nw = model.device, model.nc, int(state.bhp.shape[0]) or 5

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def same_bits(x, y):
        if x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        return torch.equal(x, y)

    du_c = t(rng.standard_normal((3, nc)) * np.array([[2e6], [0.1], [0.05]]))
    du_w = t(rng.standard_normal((nw, 4))
             * np.array([1e-3, 1e-3, 1e-3, 1e6]))
    st = state if state.bhp.shape[0] else state._replace(
        bhp=t(rng.uniform(1e7, 3e7, nw)),
        qs=t(rng.standard_normal((nw, 3)) * 1e-3),
        control=t(np.array([0, 2, 0, 3, 2], np.int32)),
        target=t(rng.uniform(1e-3, 1e-2, nw)))
    out = {}
    cpr = k9.update_args(model, st, du_c, du_w[:, 3], du_w[:, :3], 0.9)
    flat = torch.cat([du_c.reshape(-1), du_w[:, 3],
                      du_w[:, :3].reshape(-1)])
    dense = k9.update_args(model, st, flat[:3 * nc].view(3, nc),
                           flat[3 * nc:3 * nc + nw],
                           flat[3 * nc + nw:].view(nw, 3), 0.9)
    for form, a in (("CPR", cpr), ("dense", dense)):
        ku, pu = k9.update_cuda(*a), k9.update_plain(*a)
        for nm, x, y in zip(("p", "sw", "x", "hcstate", "bhp", "qs"),
                            ku, pu):
            K.note("K9 update", float((x.double() - y.double())
                                      .abs().max()))
            if not same_bits(x, y):
                fail(f"{label}: K9 update ({form} form) {nm} is not "
                     "bit for bit its twins' composition")
    out["switched_cells"] = int((ku[3] != st.hcstate).sum())
    if "K9 update" in timed:
        name = "K9 update"
        K.ms[name] = cuda_ms(lambda: k9.update_cuda(*cpr))
        K.plain_ms[name] = cuda_ms(lambda: k9.update_plain(*cpr))
        K.run_ms[name] = run_ms(lambda: k9.update_cuda(*cpr))
        K.library_ms[name] = None
        K.bound(name, (st.pressure, st.sw, st.x, st.hcstate, du_c),
                ku[:4], 60 * nc)
        kern = device_kernels(lambda: update_state(model, st, du_c, 0.9,
                                                   du_w=du_w))
        out["update_device_kernels"] = None if kern is None \
            else len(kern)
        out["update_host_ms"] = host_ms(
            lambda: update_state(model, st, du_c, 0.9, du_w=du_w),
            reps=50)

    masked = model.conv_mask is not None
    name = "K9 convergence_masked" if masked else "K9 convergence"
    fn = k9.convergence_masked_cuda if masked else k9.convergence_cuda
    mask = (model.conv_mask,) if masked else ()
    R = t(rng.standard_normal((3, nc)) + 1.0) * model.pv * 1e-6
    Rnan = R.clone()
    Rnan[1, nc // 2] = float("nan")
    bq = q.b.contiguous()
    wf = t(rng.standard_normal((nw, 3)) * 1e-4)
    wc = t(rng.standard_normal(nw) * 1e3)
    ws, dt = model.k9_workspace(), 86400.0
    tols = k9.conv_tols(model.params)
    s = st
    for case, RR, n in (("seeded", R, nw), ("no wells", R, 0),
                        ("a NaN cell", Rnan, nw)):
        a = (RR, bq, model.pv, dt, *mask, wf[:n], wc[:n],
             s.control[:n].contiguous(), s.target[:n].contiguous(), tols)
        rows = [fn(ws, *a) for _ in range(10)]
        kr = rows[0]
        if not all(torch.equal(r.view(torch.int64), kr.view(torch.int64))
                   for r in rows[1:]):
            fail(f"{label}: {name} ({case}) differs between ten launches")
        pr = k9.convergence_plain(RR, bq, model.pv, dt,
                                  model.conv_mask, wf[:n], wc[:n],
                                  s.control[:n], s.target[:n], tols)
        if not torch.equal(kr[8:], pr[8:]):
            fail(f"{label}: {name} ({case}) flags {kr[8:].tolist()} "
                 f"against the plain version's {pr[8:].tolist()}")
        if not torch.equal(torch.isnan(kr), torch.isnan(pr)):
            fail(f"{label}: {name} ({case}) NaN where the plain version "
                 "has none, or the reverse")
        fin = ~torch.isnan(pr)
        e = rel_err(kr[fin], pr[fin])
        K.note(name, float((kr[fin] - pr[fin]).abs().max()))
        if not e <= TOL_K9_NORM:
            fail(f"{label}: {name} ({case}) off by {e:.3e} relative")
        if case == "a NaN cell" and float(kr[8]) != 0.0:
            fail(f"{label}: a NaN residual left {name}'s finite flag set")
        if case == "no wells" and (float(kr[6]) or float(kr[7])):
            fail(f"{label}: {name} with no wells has well norms")
    if name in timed:
        a = (R, bq, model.pv, dt, *mask, wf, wc, s.control, s.target, tols)
        K.ms[name] = cuda_ms(lambda: fn(ws, *a))
        K.plain_ms[name] = cuda_ms(lambda: k9.convergence_plain(
            R, bq, model.pv, dt, model.conv_mask, wf, wc, s.control,
            s.target, tols))
        K.run_ms[name] = run_ms(lambda: fn(ws, *a))
        K.library_ms[name] = None
        K.bound(name, (R, bq, model.pv, *mask), (), 18 * nc)
        res = Residual(cell=R, well_flux=wf, well_ctrl=wc, b=bq)
        kern = device_kernels(lambda: model.convergence(res, dt, s))
        out["convergence_device_kernels"] = None if kern is None \
            else len(kern)
        out["convergence_host_ms"] = host_ms(
            lambda: model.convergence(res, dt, s), reps=50)
        for k in ("update_device_kernels", "convergence_device_kernels"):
            if out.get(k) not in (None, 1):
                fail(f"{label}: {k} = {out[k]}, not one")
    torch.cuda.synchronize()
    return out


def compare_jacobian(case, dev, label="SPE1"):
    """The dense Jacobian of a deck's first Newton iteration on the card
    (torch.func.jacfwd through K1 and K3, the main path's own tangent
    batch) against the plain path on the CPU, from one initial state.
    Returns (relative error, K3 tangent launches and K2 column launches
    on the card)."""
    import torch

    from opm_tpu_torch.models.blackoil import (cells_columns_cuda,
                                               make_well_device_arrays,
                                               tpfa_div_tangent_cuda)
    from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                            init_well_state,
                                            report_step_wells)
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.solver.newton import connection_offsets
    from opm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

    out = []
    host = None
    n0 = tpfa_div_tangent_cuda.launches
    n2 = cells_columns_cuda.launches
    for d in (dev, torch.device("cpu")):
        sim = SimulatorFullyImplicitBlackoil(case, device=d)
        step = sim.schedule.report_steps[0]
        ws = report_step_wells(step, sim.grid, sim.well_names, sim.max_perf)
        wd = make_well_device_arrays(ws, sim.grid.gravity, d)
        if host is None:
            st = initial_state(sim.grid, sim.props, case, ws.nw)
            host = state_to_numpy(init_well_state(st, ws, True))
        st = state_from_numpy(host, d)
        acc0 = sim.model.accumulation(st)
        cdp = connection_offsets(sim.model, st, wd)
        J, _ = sim.solver.jacobian(st, acc0, 86400.0, wd, cdp)
        out.append(J.cpu())
    Jg, Jc = out
    if not bool(torch.isfinite(Jg).all()):
        fail(f"{label} Jacobian on the card is not finite")
    err = float((Jg - Jc).abs().max()) / float(Jc.abs().max())
    return (err, tpfa_div_tangent_cuda.launches - n0,
            cells_columns_cuda.launches - n2)


# ---------------------------------------------------------------------------
# 3d: K1's EQUIL column march

# float64 operations (add, sub, mul, div) of one K1 lookup's value, of one
# density evaluation of water and of gas, of the live (PVTO) and dead
# (PVDO) oil FVF, and of a midpoint step's own arithmetic (csrc/equil.cu)
OPS_LOOK1 = 9
OPS_WATER = 9
OPS_GAS = 4 + OPS_LOOK1
OPS_OIL_B = {True: OPS_LOOK1 + 1 + 3 + 3 + 16, False: OPS_LOOK1}
# PVTG's gas: rv_sat(p) under VAPOIL, then b over (p, max(rv_sat(p) - rv,
# 0)): two 1-D lookups, the difference and the bilinear value
OPS_WET_GAS = 4 + 2 * OPS_LOOK1 + 1 + 3 + 3 + 16
OPS_STEP = 8


def equil_work(args):
    """(bytes, float64 operations) of one column march on these inputs:
    the staged tables, the depth grid and the RSVD/PBVD column read once
    and the three columns written once; the operations of the density
    evaluations this march makes (2 nz - 1 a column: the anchor and two a
    step) and of its steps and anchors."""
    import ctypes

    from opm_tpu_torch.sim import init as equil
    from opm_tpu_torch.utils import cuda_lib
    props, z, _, _, _, mode, vz = args[:7]
    pack = props.cell_pack()
    lib = cuda_lib.load("equil", equil._EQUIL_SIGS)
    nz, nv = z.shape[0], (vz.shape[0] if mode else 0)
    staged = lib.opm_equil_smem_bytes(
        ctypes.cast(pack.c_meta, ctypes.c_void_p), nz, nv)
    nbytes_moved = staged + 6 * 8 + 3 * nz * 8
    live = props.oil_live is not None
    rs_sat = OPS_LOOK1 if live else 0
    rs = 0 if not props.disgas else \
        (OPS_LOOK1 + rs_sat if mode else rs_sat)
    oil = rs + OPS_OIL_B[live] + 4
    evals = 2 * nz - 1
    gas = OPS_WET_GAS if props.gas_wet is not None else OPS_GAS
    flops = evals * (oil + OPS_WATER + gas) + 3 * (nz - 1) * OPS_STEP \
        + 3 * 3 + 2 * (OPS_LOOK1 + 1)
    return nbytes_moved, flops


@contextlib.contextmanager
def no_host_sync():
    """torch.cuda.set_sync_debug_mode("error") inside the block: any
    synchronising call (a host read) raises."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


@contextlib.contextmanager
def nan_empty():
    """torch.empty filling its float64 tensors with NaN inside the block:
    a kernel's output buffer holds NaN wherever the kernel does not
    write."""
    import torch
    empty = torch.empty

    def filled(*a, **k):
        t = empty(*a, **k)
        return t.fill_(float("nan")) if t.dtype == torch.float64 else t

    torch.empty = filled
    try:
        yield
    finally:
        torch.empty = empty


def equil_cells_work(args, n):
    """(bytes, float64 operations) of one cell pass over a region of n
    cells: the depth grid and the columns (and the RSVD/PBVD and RVVD/PDVD
    columns) read once, a cell's index, depth and two region numbers read
    and its five values written; per cell the operations of the three
    column lookups, the capillary inversions the deck has, sg's clip,
    rs_sat and the RSVD/PBVD interpolation, rv_sat and the RVVD/PDVD
    interpolation (the per-region tables stay in the cache)."""
    props, z, _, _, _, mode, vz, _, vmode, wz, _ = args
    nz, nv = z.shape[0], (vz.shape[0] if mode else 0)
    nw = wz.shape[0] if vmode else 0
    nbytes_moved = 8 * (4 * nz + 2 * nv + 2 * nw) \
        + n * (4 + 8 + 4 + 4 + 5 * 8)
    sf = props.satfunc
    ops = 3 * OPS_LOOK1 + 3
    if sf is not None:
        ops += (OPS_LOOK1 + 2) * (sf.pcow_range > 1e-9) \
            + (OPS_LOOK1 + 1) * (sf.pcgo_range > 1e-9)
    if props.disgas and props.oil_live is not None:
        ops += OPS_LOOK1 + (5 + 1 if mode else 0)
    if props.rv_gas is not None:
        ops += OPS_LOOK1 + (5 + 1 if vmode else 0) \
            + (OPS_LOOK1 if vmode == "pdvd" else 0)
    return nbytes_moved, ops * n


def check_equil(K, label, sim, march_row=None, twin=True, cells_row=None):
    """K1's column march and EQUIL's cell pass on ``sim``'s deck: each
    EQUIL region's columns from the kernel (its call under the sync debug
    mode "error": no host read) bit for bit its twin's on the card (with
    ``twin``: the twin takes about 10 s a region there), the kernel's ms a
    launch (CUDA events, median of 20 warm runs) and the twin's (synced
    host clock, one call); then the cell pass over the kernel's columns,
    into arrays of NaN, under the sync debug mode "error", bit for bit its
    twin's on the region's cells and no other cell written, with its ms
    and its twin's; then one initial_state (synced host clock) with the
    launches it makes: one march and one cell pass a region and no K1
    lookup. ``march_row`` names the march's row of the kernels line that
    takes this deck's times and bound, ``cells_row`` the cell pass's row
    (one call, per launch in a run of 50 and on the device). Returns (the
    initial state, the record)."""
    import torch

    from opm_tpu_torch.sim import init as equil
    from opm_tpu_torch.utils import tables as k1
    regions = equil.equil_regions(sim.grid, sim.case)
    cell_data = equil.equil_cell_data(sim.grid, sim.model.device)
    nc = sim.grid.nc
    rows = []
    for rec, cells, vd in regions:
        args = equil.march_args(sim.grid, sim.props, rec, cells, **vd)
        equil.equil_columns_cuda(*args)         # builds the CellPack, loads
        torch.cuda.synchronize()
        with no_host_sync():
            cols = equil.equil_columns_cuda(*args)
        same = twin_ms = None
        if twin:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = equil.equil_columns_plain(*args)
            torch.cuda.synchronize()
            twin_ms = (time.perf_counter() - t0) * 1e3
            same = torch.equal(cols, plain)
            K.note("K1 equil_march", float((cols - plain).abs().max()))
        ms = cuda_ms(lambda: equil.equil_columns_cuda(*args))
        nbytes_moved, flops = equil_work(args)
        # the cell pass over the kernel's columns
        ti = torch.as_tensor(cells, dtype=torch.int32, device=cols.device)
        kout = torch.full((5, nc), float("nan"), dtype=torch.float64,
                          device=cols.device)
        pout = kout.clone()
        equil.equil_cells_cuda(args, cols, ti, cell_data, kout.clone())
        torch.cuda.synchronize()
        with no_host_sync():
            equil.equil_cells_cuda(args, cols, ti, cell_data, kout)
        equil.equil_cells_plain(args, cols, ti, cell_data, pout)
        idx = ti.long()
        cells_same = bool(torch.equal(kout[:, idx], pout[:, idx]))
        rest = torch.ones(nc, dtype=torch.bool, device=cols.device)
        rest[idx] = False
        untouched = bool(torch.isnan(kout[:, rest]).all())
        K.note("K1 equil_cells",
               float((kout[:, idx] - pout[:, idx]).abs().max()))
        c_ms = cuda_ms(lambda: equil.equil_cells_cuda(args, cols, ti,
                                                      cell_data, kout))
        c_plain = cuda_ms(lambda: equil.equil_cells_plain(args, cols, ti,
                                                          cell_data, pout))
        c_bytes, c_flops = equil_cells_work(args, len(cells))
        rows.append(dict(nz=args[1].shape[0], mode=args[5], vmode=args[8],
                         cells=len(cells),
                         ms=ms, twin_ms=twin_ms, bitwise=same,
                         bytes=nbytes_moved, flops=flops,
                         cell_pass=dict(ms=c_ms, plain_ms=c_plain,
                                        bitwise=cells_same,
                                        bytes=c_bytes, flops=c_flops)))
        if twin and not same:
            fail(f"{label}: the column march differs from its twin on the "
                 "card")
        if not (cells_same and untouched):
            fail(f"{label}: the cell pass differs from its twin on the card "
                 f"(region's cells equal: {cells_same}; other cells left "
                 f"alone: {untouched})")
        if march_row and not rows[1:]:
            K.ms[march_row] = ms
            K.plain_ms[march_row] = twin_ms
            K.bound_raw(march_row, nbytes_moved, flops)
        if cells_row and not rows[1:]:
            def fn():
                equil.equil_cells_cuda(args, cols, ti, cell_data, kout)
            K.ms[cells_row] = c_ms
            K.plain_ms[cells_row] = c_plain
            K.library_ms[cells_row] = None
            K.run_ms[cells_row] = run_ms(fn)
            rows[0]["cell_pass"]["device_ms"] = device_ms(fn)
            K.bound_raw(cells_row, c_bytes, c_flops)
        del kout, pout
    counted = (k1.interp1_cuda, k1.interp2_cuda, equil.equil_columns_cuda,
               equil.equil_cells_cuda)
    before = [f.launches for f in counted]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = equil.initial_state(sim.grid, sim.props, sim.case,
                             len(sim.well_names))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = [f.launches - b for f, b in zip(counted, before)]
    res = dict(regions=rows, initial_state_s=init_s, k1_interp1=n[0],
               k1_interp2=n[1], marches=n[2], cell_passes=n[3])
    log(f"{label}: EQUIL column march"
        + (" == twin bit for bit on the card" if twin else "")
        + f" in {len(rows)} region(s); kernel "
        + ", ".join(f"{r['ms']:.4f}" for r in rows) + " ms"
        + (", twin " + ", ".join(f"{r['twin_ms']:.1f}" for r in rows)
           + " ms" if twin else "")
        + "; cell pass == twin bit for bit, kernel "
        + ", ".join(f"{r['cell_pass']['ms']:.4f}" for r in rows)
        + " ms, twin "
        + ", ".join(f"{r['cell_pass']['plain_ms']:.4f}" for r in rows)
        + f" ms; initial_state {init_s:.3f} s with {n[2]} march(es), "
        f"{n[3]} cell pass(es), {n[0]} + {n[1]} K1 lookups")
    if n[0] or n[1] or n[2] != len(regions) or n[3] != len(regions):
        fail(f"{label}: initial_state made {n[2]} marches, {n[3]} cell "
             f"passes and {n[0] + n[1]} K1 lookups for {len(regions)} EQUIL "
             "region(s)")
    return st, res


# ---------------------------------------------------------------------------
# 3c: the CPR kernels on real assembled systems

def first_newton_system(sim, state0):
    """The block system of the first Newton iteration of report step 0 at
    the deck's first dt, from ``state0`` (an initial state), and what it
    was assembled from (state, acc0, dt, wd, cdp)."""
    from opm_tpu_torch.models import linearize
    from opm_tpu_torch.models.blackoil import make_well_device_arrays
    from opm_tpu_torch.sim.blackoil import init_well_state, report_step_wells
    from opm_tpu_torch.solver.newton import connection_offsets

    ws = report_step_wells(sim.schedule.report_steps[0], sim.grid,
                           sim.well_names, sim.max_perf)
    wd = make_well_device_arrays(ws, sim.grid.gravity, sim.device)
    st = init_well_state(state0, ws, True)
    acc0 = sim.model.accumulation(st)
    cdp = connection_offsets(sim.model, st, wd)
    dt = float(sim.ts.p.initial_dt)
    sys = linearize.assemble(sim.model, st, acc0, dt, wd, cdp)
    return sys, dict(state=st, acc0=acc0, dt=dt, wd=wd, cdp=cdp)


# ---------------------------------------------------------------------------
# the assembly kernels (K2's assembly entry, the K3 face blocks, K5)

def compare_assembly_kernels(K, sim, sys, ctx, seed, label, timed):
    """K2's assembly entry, the K3 face blocks (stencil form, then the face
    list: an embedded grid's epilogue or a gather grid's every face) and
    K5's three entries against their plain versions on one first Newton
    system, and the whole assembly through the kernels against one through
    the twins; timed with bounds when ``timed`` (the face-list form into
    the kernel table on a gather grid, the rest there only on a structured
    grid without extra faces: the main path's SPE10-2). Returns extra
    measurements."""
    import numpy as np
    import torch

    from opm_tpu_torch.linalg.precond import inv4x4
    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.models import linearize as lz

    model = sim.model
    props = model.props
    pack = props.cell_pack()
    nc, dev = model.nc, sys.diag.device
    st, dt = ctx["state"], ctx["dt"]
    fl, dims = model.faces, model.op_dims
    table = timed and fl is None
    rng = np.random.default_rng(seed + 7)
    extra = {}

    def check(name, tol, pairs, how):
        for a, b in pairs:
            K.note(name, float((a - b).abs().max()) if b.numel() else 0.0)
            e = how(a, b)
            if not e <= tol:
                fail(f"{label}: {name} differs from its plain version "
                     f"({e:.3e} > {tol:g})")

    def timing(name, kfn, pfn, nbytes_moved, flops, into_table,
               instr=None):
        """Times into the table (bound from the bytes and the float64
        operations, or the SASS's float64 instructions when ``instr``),
        else into the extra measurements."""
        if not timed:
            return
        ms, pms = cuda_ms(kfn), cuda_ms(pfn)
        if into_table:
            K.ms[name], K.plain_ms[name] = ms, pms
            K.library_ms[name] = None
            if instr is None:
                K.bound_raw(name, nbytes_moved, flops)
            else:
                K.bound_instr(name, nbytes_moved, instr)
        else:
            extra[name] = dict(ms=ms, plain_ms=pms)

    # K2's assembly entry
    a2 = (st.pressure, st.sw, st.x, st.hcstate, model.pvtnum, model.satnum,
          ctx["acc0"], model.pv, dt)
    ka = mb.cells_assemble_cuda(pack, *a2)
    pa = mb.cells_assemble_plain(props, *a2)
    check("K2 cells_assemble", TOL_K2_VAL, [(ka[0], pa[0])], rel_err)
    check("K2 cells_assemble", TOL_K2_TAN, list(zip(ka[1:], pa[1:])),
          row_scaled_err)
    if not (torch.equal(ka[0], pa[0]) and torch.equal(ka[2], pa[2])):
        fail(f"{label}: K2 cells_assemble's face inputs or r_cell are not "
             "bit for bit the plain version's")
    if timed:
        kfn = lambda: mb.cells_assemble_cuda(pack, *a2)  # noqa: E731
        ms, pms = cuda_ms(kfn), cuda_ms(
            lambda: mb.cells_assemble_plain(props, *a2))
        if table:
            K.ms["K2 cells_assemble"], K.plain_ms["K2 cells_assemble"] = \
                ms, pms
            K.run_ms["K2 cells_assemble"] = run_ms(kfn)
            K.bound_instr("K2 cells_assemble", nbytes(a2[:8], pack.tab, ka),
                          K.sass["cells"]["cells_assemble_kernel"] * nc)
        else:
            extra["K2 cells_assemble"] = dict(ms=ms, plain_ms=pms,
                                              run_ms=run_ms(kfn))
    fv, fc, r0, d0 = pa
    del ka

    # the K3 face blocks: each form from the same inputs as its twin
    nf = model.trans.shape[0]

    def run_blocks(fn, lead, r, d):
        fL = torch.zeros((9, nf), dtype=torch.float64, device=dev)
        fR = torch.zeros_like(fL)
        blk = fn(lead, fv, fc, model.depth, model.trans, model.gravity, r,
                 d, fL, fR)
        return r, d, fL, fR, blk

    nf_s = 0
    if dims is not None:
        nf_s = model.nf_canonical
        kb = run_blocks(lz.face_blocks_cuda, dims, r0.clone(), d0.clone())
        pb = run_blocks(lz.face_blocks_plain, dims, r0.clone(), d0.clone())
        check("K3 face_blocks", TOL_BLOCKS,
              [(kb[0], pb[0]), (kb[1], pb[1]),
               (kb[2][:, :nf_s], pb[2][:, :nf_s]),
               (kb[3][:, :nf_s], pb[3][:, :nf_s])], row_scaled_err)
        r_s, d_s = pb[0], pb[1]
        rk, dk = r0.clone(), d0.clone()
        rp, dp_ = r0.clone(), d0.clone()
        fLk, fRk = kb[2], kb[3]
        # repeated in place on persistent buffers (r and d grow, finite)
        timing("K3 face_blocks",
               lambda: lz.face_blocks_cuda(dims, fv, fc, model.depth,
                                           model.trans, model.gravity, rk,
                                           dk, fLk, fRk),
               lambda: lz.face_blocks_plain(dims, fv, fc, model.depth,
                                            model.trans, model.gravity, rp,
                                            dp_, fLk, fRk),
               # fv, fc, depth, the stencil faces' trans; r and d read and
               # written; the stencil faces' blocks written
               nbytes(fv, fc, model.depth) + 8 * nf_s
               + 2 * nbytes(r0, d0) + 8 * 18 * nf_s, 250 * nf_s, table)
        del kb, pb
    else:
        r_s, d_s = r0, d0
    if fl is not None:
        # the packed copy the row phase writes, into a buffer of NaN
        with nan_empty():
            kl = run_blocks(lz.faces_blocks_cuda, fl, r_s.clone(),
                            d_s.clone())
        pl = run_blocks(lz.faces_blocks_plain, fl, r_s.clone(), d_s.clone())
        f0 = fl.first
        check("K3-faces face_blocks", TOL_BLOCKS,
              [(kl[0], pl[0]), (kl[1], pl[1]),
               (kl[2][:, f0:], pl[2][:, f0:]),
               (kl[3][:, f0:], pl[3][:, f0:])], row_scaled_err)
        # bit for bit the twin in its own order: its index_add_ on the
        # card adds in no fixed order, on the CPU in index order, which is
        # the kernel's row order
        cpu = lambda t: t.detach().cpu()  # noqa: E731
        fl_cpu = mb.FaceList(sim.grid.face_cells, nc, f0, "cpu")
        r_c, d_c = cpu(r_s).clone(), cpu(d_s).clone()
        fL_c = torch.zeros((9, nf), dtype=torch.float64)
        fR_c = torch.zeros_like(fL_c)
        blk_c = lz.faces_blocks_packed_plain(
            fl_cpu, cpu(fv), cpu(fc), cpu(model.depth), cpu(model.trans),
            model.gravity, r_c, d_c, fL_c, fR_c)
        if not all(torch.equal(cpu(a), b) for a, b in
                   zip(kl, (r_c, d_c, fL_c, fR_c, blk_c))):
            fail(f"{label}: the K3-faces face blocks (with K4-faces' "
                 "packed copy) are not bit for bit their plain version's "
                 "on CPU copies of the inputs")
        # the copy: bit for bit the pack's twin of the kernel's blocks
        pk = lz.faces_pack_plain(fl.sell, kl[2], kl[3])
        K.note("K3-faces face_blocks", float((kl[4] - pk).abs().max()))
        if not torch.equal(kl[4], pk):
            fail(f"{label}: the face blocks' packed copy differs from the "
                 "pack's twin on the card")
        del r_c, d_c, fL_c, fR_c, blk_c, pk
        rk, dk = r_s.clone(), d_s.clone()
        rp, dp_ = r_s.clone(), d_s.clone()
        fLk, fRk = kl[2], kl[3]
        csr = fl.touched
        rows = csr.n_rows
        # the rows' fv and fc, r and d read and written, the list's trans
        # and blocks, the CSR, K4-faces' copy written and its slices read
        moved = (8 * (44 + 2 * 12) * rows + 8 * (1 + 18) * fl.n
                 + nbytes(csr.ptr, csr.ent, csr.nbr) + 8 * rows
                 + nbytes(kl[4], fl.sell.chunk0))
        timing("K3-faces face_blocks",
               lambda: lz.faces_blocks_cuda(fl, fv, fc, model.depth,
                                            model.trans, model.gravity, rk,
                                            dk, fLk, fRk),
               lambda: lz.faces_blocks_packed_plain(
                   fl, fv, fc, model.depth, model.trans, model.gravity, rp,
                   dp_, fLk, fRk),
               moved, 250 * fl.n, timed and dims is None)
        if timed and dims is None:
            K.run_ms["K3-faces face_blocks"] = run_ms(
                lambda: lz.faces_blocks_cuda(fl, fv, fc, model.depth,
                                             model.trans, model.gravity, rk,
                                             dk, fLk, fRk))

        def main_form():
            # the assembly's face-list part: the face blocks, their row
            # phase writing the copy, and K4-faces' operator over it
            blk = lz.faces_blocks_cuda(fl, fv, fc, model.depth, model.trans,
                                       model.gravity, rk, dk, fLk, fRk)
            return lz.FacesOperator(fl, dk, fLk, fRk, blk)

        if timed:
            # the face blocks on the device (queued behind a spin kernel),
            # and with the operator's constructor: one call, in a run, on
            # the device
            extra.setdefault("K3-faces face_blocks", {}).update(
                device_ms=device_ms(lambda: lz.faces_blocks_cuda(
                    fl, fv, fc, model.depth, model.trans, model.gravity, rk,
                    dk, fLk, fRk)),
                with_operator_ms=cuda_ms(main_form),
                with_operator_run_ms=run_ms(main_form),
                with_operator_device_ms=device_ms(main_form))
        del kl, pl

    # K5 on the system's well blocks, over its prepared arguments
    Dinv = inv4x4(sys.wd_diag).contiguous()
    wt = lz.WellTerm(sys, Dinv)
    v = torch.as_tensor(rng.standard_normal((3, nc)), device=dev)
    out = torch.as_tensor(rng.standard_normal((3, nc)), device=dev)
    check("K5 schur_matvec", TOL_K5,
          [(lz.schur_matvec_cuda(wt, v, out.clone()),
            lz.schur_matvec_plain(sys, Dinv, v, out))], scaled_err)
    check("K5 schur_rhs", TOL_K5, [(lz.schur_rhs_cuda(wt),
                                    lz.schur_rhs_plain(sys, Dinv))],
          scaled_err)
    check("K5 schur_recover", TOL_K5,
          [(lz.schur_recover_cuda(wt, v),
            lz.schur_recover_plain(sys, Dinv, v))], scaled_err)
    # the reduced operator with the well term in the cell operator's last
    # launch: ten launches in a row bit for bit the parent's pair (the
    # ticket resets), and the twins' composition within TOL_K5
    pair = lz.schur_matvec_cuda(wt, v, lz.matvec_cells(sys, v, dims))
    fused = [lz.reduced_matvec_cuda(wt, v, dims) for _ in range(10)]
    if not all(torch.equal(f, pair) for f in fused):
        fail(f"{label}: the fused reduced operator differs from K4 then "
             "the stand-alone well term")
    check("K5 schur_matvec fused", TOL_K5,
          [(fused[0], lz.reduced_matvec_plain(sys, Dinv, v, dims))],
          scaled_err)
    del fused
    nw, mp = sys.perf_cell.shape
    npf = nw * mp
    rows_w = int(torch.unique(sys.perf_cell).numel())   # perforated cells
    wells_b = nbytes(sys.wc, sys.cw, Dinv, sys.perf_cell, sys.perf_order)
    ok = out.clone()
    # the operations terms of K5's rows: the SASS's float64 instructions
    # per thread times the threads launched (256 a block, wells.cu; an
    # upper count: much of the code runs in one block only)
    ws = K.sass["wells"]
    timing("K5 schur_matvec",
           lambda: lz.schur_matvec_cuda(wt, v, ok),
           lambda: lz.schur_matvec_plain(sys, Dinv, v, out),
           wells_b + 8 * 3 * (npf + 2 * rows_w), 0, table,
           instr=ws["schur_matvec_kernel"] * 256)
    if timed:
        # the fused operator against the parent's pair, two ways; its
        # bound is the cell operator's (blocks and both vectors once) plus
        # the well term's
        fn = lambda: lz.reduced_matvec_cuda(wt, v, dims)  # noqa: E731
        pfn = lambda: lz.schur_matvec_cuda(  # noqa: E731
            wt, v, lz.matvec_cells(sys, v, dims))
        two = dict(ms=cuda_ms(fn), run_ms=run_ms(fn), pair_ms=cuda_ms(pfn),
                   pair_run_ms=run_ms(pfn))
        extra["K5 schur_matvec fused"] = two
        if table:
            nf = sys.face_L.shape[1]
            K.ms["K5 schur_matvec fused"] = two["ms"]
            K.run_ms["K5 schur_matvec fused"] = two["run_ms"]
            K.plain_ms["K5 schur_matvec fused"] = cuda_ms(
                lambda: lz.reduced_matvec_plain(sys, Dinv, v, dims))
            K.library_ms["K5 schur_matvec fused"] = None
            K.bound_instr("K5 schur_matvec fused",
                          nbytes(sys.diag, sys.face_L, sys.face_R, v, v)
                          + wells_b + 8 * 3 * npf,
                          K.sass["block7"]["matvec_kernel"] * nc)
    timing("K5 schur_rhs", lambda: lz.schur_rhs_cuda(wt),
           lambda: lz.schur_rhs_plain(sys, Dinv),
           nbytes(sys.cw, Dinv, sys.perf_cell, sys.perf_order, sys.r_well)
           + 2 * nbytes(sys.r_cell), 0, table,
           instr=ws["schur_rhs_kernel"] * 256 * (-(-nc // 2048) + 1))
    timing("K5 schur_recover", lambda: lz.schur_recover_cuda(wt, v),
           lambda: lz.schur_recover_plain(sys, Dinv, v),
           nbytes(sys.wc, Dinv, sys.perf_cell, sys.r_well) * 1
           + 8 * (3 * npf + 4 * nw), 0, table,
           instr=ws["schur_recover_kernel"] * 256)

    # D^-1 formed by the right-hand side's launch (the main path): bit for
    # bit the plain inv4x4 on the card, or within TOL_DINV of each block's
    # max; the right-hand side then bit for bit the one from the given D^-1
    # (or within TOL_K5 of max where D^-1's bits differ)
    name = "K5 inv4x4 in schur_rhs"
    wt_f = lz.WellTerm(sys)
    n0 = lz.schur_rhs_cuda.inverses
    rhs_f = lz.schur_rhs_cuda(wt_f)
    if lz.schur_rhs_cuda.inverses != n0 + 1:
        fail(f"{label}: {name}: the launch did not form D^-1")
    same = torch.equal(wt_f.Dinv, Dinv)
    e = row_scaled_err(wt_f.Dinv.reshape(nw, 16), Dinv.reshape(nw, 16))
    K.note(name, float((wt_f.Dinv - Dinv).abs().max()) if nw else 0.0)
    extra["dinv"] = dict(bits_equal=same, of_block_max=e, wells=nw)
    if not (same or e <= TOL_DINV):
        fail(f"{label}: {name} differs from the plain inv4x4 ({e:.3e} of a "
             f"block's max > {TOL_DINV:g})")
    rhs_g = lz.schur_rhs_cuda(wt)
    if same and not torch.equal(rhs_f, rhs_g):
        fail(f"{label}: the right-hand side from the formed D^-1 is not bit "
             "for bit the one from the given D^-1")
    check(name, TOL_K5, [(rhs_f, lz.schur_rhs_plain(sys, Dinv))], scaled_err)
    if timed:
        def forming():
            wt_f.formed = False         # the launch forms D^-1 again
            return lz.schur_rhs_cuda(wt_f)

        rhs_b = (nbytes(sys.cw, sys.perf_cell, sys.perf_order, sys.r_well)
                 + 2 * nbytes(sys.r_cell))
        inv_t = dict(ms=cuda_ms(forming), run_ms=run_ms(forming),
                     given_ms=cuda_ms(lambda: lz.schur_rhs_cuda(wt)),
                     given_run_ms=run_ms(lambda: lz.schur_rhs_cuda(wt)),
                     plain_inv4x4_ms=cuda_ms(lambda: inv4x4(sys.wd_diag)),
                     plain_ms=cuda_ms(lambda: lz.schur_rhs_plain(
                         sys, inv4x4(sys.wd_diag))))
        extra["dinv"].update(inv_t)
        if table:
            K.ms[name], K.run_ms[name] = inv_t["ms"], inv_t["run_ms"]
            K.plain_ms[name] = inv_t["plain_ms"]
            K.library_ms[name] = None
            # the right-hand side's bytes, the well blocks read and D^-1
            # written
            K.bound_instr(name, rhs_b + 2 * nbytes(sys.wd_diag),
                          ws["schur_rhs_kernel"] * 256
                          * (-(-nc // 2048) + 1))
    del wt_f, rhs_f, rhs_g

    # one whole assembly through the kernels and through their twins
    args = (model, st, ctx["acc0"], dt, ctx["wd"], ctx["cdp"])
    tw = lz.assemble(*args, twin=True)
    for f in ("r_cell", "r_well", "diag", "face_L", "face_R", "cw", "wc",
              "wd_diag"):
        e = scaled_err(getattr(sys, f), getattr(tw, f))
        if not e <= TOL_BLOCKS:
            fail(f"{label}: the assembly through the kernels differs from "
                 f"the twins' in {f} ({e:.3e} of max)")
    del tw
    if timed:
        extra["assemble_ms"] = host_ms(lambda: lz.assemble(*args))
        extra["assemble_twin_ms"] = host_ms(
            lambda: lz.assemble(*args, twin=True))
    torch.cuda.synchronize()
    return extra


def csr_operator(sys, dims):
    """The cells-only block operator as a float64 CSR matrix on the card
    (rows and columns equation-major, as the (3, nc) vectors flatten):
    the library yardstick for K4."""
    import torch

    from opm_tpu_torch.models.blackoil import _dir_segments
    nx, ny, nz = dims
    nc = nx * ny * nz
    dev = sys.diag.device
    cells = torch.arange(nc, device=dev).reshape(nz, ny, nx)
    L, R = [], []
    for slL, slR, _ in _dir_segments(dims):
        L.append(cells[slL].reshape(-1))
        R.append(cells[slR].reshape(-1))
    L, R = torch.cat(L), torch.cat(R)
    rows, cols, vals = [], [], []
    ar = torch.arange(nc, device=dev)
    for e in range(3):
        for v in range(3):
            k = 3 * e + v
            rows += [e * nc + ar, e * nc + L, e * nc + R]
            cols += [v * nc + ar, v * nc + R, v * nc + L]
            vals += [sys.diag[k], sys.face_R[k], -sys.face_L[k]]
    A = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                             torch.cat(cols)]),
                                torch.cat(vals), (3 * nc, 3 * nc))
    return A.coalesce().to_sparse_csr()


def compare_cpr_kernels(K, sim, amg, sys, seed, label, timed):
    """K4, K6, K7 and K8 against their plain versions on one assembled
    system; timed (with bounds and library yardsticks) when ``timed``."""
    import numpy as np
    import torch

    from opm_tpu_torch.linalg import gmg as k7
    from opm_tpu_torch.linalg import precond as k6
    from opm_tpu_torch.models import linearize as k4

    dims = sim.model.dims
    nc = sim.model.nc
    nf = sys.face_L.shape[1]
    dev = sys.diag.device
    rng = np.random.default_rng(seed + 3)

    def rnd(*shape):
        return torch.as_tensor(rng.standard_normal(shape), device=dev)

    def chk(name, tol, pairs, how=scaled_err):
        for a, b in pairs:
            K.note(name, float((a - b).abs().max()) if b.numel() else 0.0)
            e = how(a, b)
            if not e <= tol:
                fail(f"{label}: {name} differs from its plain version "
                     f"({e:.3e} > {tol:g})")

    def timing(name, kfn, pfn, ins, outs, flops, lib=None):
        if timed:
            K.ms[name] = cuda_ms(kfn)
            K.plain_ms[name] = cuda_ms(pfn)
            K.library_ms[name] = cuda_ms(lib) if lib is not None else None
            K.bound(name, ins, outs, flops)

    ops = (sys.diag, sys.face_L, sys.face_R)
    x = rnd(3, nc)
    # K4
    ky = k4.matvec_cells_cuda(*ops, x, dims)
    py = k4.matvec_cells_plain(*ops, x, dims)
    chk("K4 block7_matvec", TOL_K4, [(ky, py)])
    lib = None
    if timed:
        A = csr_operator(sys, dims)
        xv = x.reshape(-1, 1)
        ly = (A @ xv).reshape(3, nc)
        if not scaled_err(ly, py) <= 1e-12:
            fail(f"{label}: the CSR yardstick of K4 disagrees")
        lib = lambda: A @ xv  # noqa: E731
    timing("K4 block7_matvec", lambda: k4.matvec_cells_cuda(*ops, x, dims),
           lambda: k4.matvec_cells_plain(*ops, x, dims), (ops, x), ky,
           18 * nc + 36 * nf, lib)
    if timed:
        del A, xv, lib
    # K6 setup
    ks = k6.cpr_setup_cuda(*ops, dims)
    ps = k6.cpr_setup_plain(*ops, dims)
    chk("K6 cpr_setup", TOL_K6_SETUP, zip(ks, ps))
    # on the main path into the hierarchy's buffers (filled with NaN
    # first, so that a value it fails to write shows), with no allocator
    # request
    for t in amg.setup_out(dev).tensors():
        t.fill_(float("nan"))
    ko = k6.cpr_setup(sys, dims, amg)
    if any(a is not b for a, b in zip(ko, amg.setup_out(dev).tensors())) \
            or not all(torch.equal(a, b) for a, b in zip(ko, ks)) \
            or allocations(lambda: k6.cpr_setup(sys, dims, amg))[0] != 0:
        fail(f"{label}: K6's setup is not one launch into the hierarchy's "
             "buffers, bit for bit the fresh one's, with no allocator "
             "request")
    timing("K6 cpr_setup", lambda: k6.cpr_setup_cuda(*ops, dims),
           lambda: k6.cpr_setup_plain(*ops, dims),
           (sys.diag, sys.face_L[0::3], sys.face_R[0::3]), ks,
           60 * nc + 10 * nf)
    dinv, w = ps[0], ps[1]
    # K6 smoothing step (pressure-only and full iterate: the two steps of
    # an apply)
    r = rnd(3, nc)
    xp = rnd(nc)
    for xx in (xp, x):
        kx = k6.smooth_step_cuda(*ops, dinv, xx, r, dims)
        px = k6.smooth_step_plain(*ops, dinv, xx, r, dims)
        chk("K6 block7_smooth", TOL_K4, [(kx, px)])
    timing("K6 block7_smooth",
           lambda: k6.smooth_step_cuda(*ops, dinv, x, r, dims),
           lambda: k6.smooth_step_plain(*ops, dinv, x, r, dims),
           (ops, dinv, x, r), kx, 18 * nc + 36 * nf + 24 * nc)

    # K7: the value refresh, then the two legs on this system's hierarchy
    # and its V-cycle
    rf = compare_k7_refresh(K, amg, ps[2], ps[3], label, timed, rng)
    vals = amg.coarsen_values(ps[2], ps[3])
    vc = compare_vcycle(K, k7, amg, vals, rnd(nc), label, TOL_K7, timed,
                        (w.contiguous(), r))
    if vc is not None:
        vc["refresh"] = rf

    compare_k8(K, (3, nc), dev, seed, label, timed)
    torch.cuda.synchronize()
    return vc


def device_kernels(fn):
    """The device kernels that one call of fn runs (torch.profiler, after a
    warm call), by name; None where the profiler recorded no device
    event (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    return names or None


def vcycle_work(amg, vals):
    """Per level, level 0 first, (bytes, float64 operations) of each V-cycle
    leg: each input read once and each output written once; the
    operations of the pre-smoothed iterate (once per cell), the residual
    and the post-smoothing sweep. K10 stores the pre-smoothed iterate (the
    down leg writes it, the up leg reads it); K7 does not. A coarsest
    level solved by sweeps adds its 1 + 10 sweeps to the down leg. Returns
    (down, up)."""
    from opm_tpu_torch.linalg import amg as k10

    down, up = [], []
    if not isinstance(amg, k10.DeviceAmg):
        L, nc, n_c = len(amg.levels), amg.nc, amg.coarsest_n
        n = [vals[l][0].numel() for l in range(L)] + [n_c]
        if L == 0:
            return [(12 * nc, 0)], [(12 * nc, 0)]
        for l in range(L):
            coef = nbytes(vals[l])
            rhs = 8 * (nc if l == 0 else n[l])
            nxt = 4 * n_c if l + 1 == L else 8 * n[l + 1]
            # a stencil 13, a sweep 17 operations per cell
            down.append((coef + rhs + nxt, 31.5 * n[l]))
            up.append((coef + rhs + nxt + rhs, 35 * n[l]))
        return down, up
    nL, dense = len(amg.levels), amg.coarsest_n <= k10.DENSE_COARSEST
    for k in range(nL + 1):
        diag, ev = vals[k]
        n, Kw = diag.numel(), ev.shape[0]
        mat = nbytes(diag, ev, amg.ell[k]["cols32"])
        if k == nL:
            if not dense:         # the coarsest sweeps
                down.append((mat + 16 * n, 11 * (2 * Kw + 5) * n))
            elif nL == 0:
                down.append((12 * n, 0))
                up.append((12 * n, 0))
            break
        lv = amg.levels[k]
        nxt = (4 if k + 1 == nL and dense else 8) * lv["n_coarse"]
        # an ELL row 2 K + 1, a sweep 2 K + 5 operations; the down leg
        # writes the pre-smoothed iterate, the up leg reads it
        down.append((mat + 8 * n + nbytes(lv["child_ptr"], lv["child_idx"])
                     + 8 * n + nxt, (4 * Kw + 8) * n))
        up.append((mat + 8 * n + 8 * n + nbytes(lv["agg32"]) + nxt + 8 * n,
                   (2 * Kw + 6) * n))
    return down, up


def compare_vcycle(K, mod, amg, vals, b, label, tol, timed, wr,
                   record=True):
    """K7's or K10's two V-cycle legs (``mod``: linalg.gmg or linalg.amg)
    on one Newton system's hierarchy against their plain versions on the
    card: one V-cycle is exactly two launches plus, where the coarsest is
    inverted, one float32 product; it equals the per-level composition of
    the twins, and each level's right-hand side and correction in the
    workspace the plain legs', within ``tol`` of max. The V-cycle from the
    CPR apply's weights and residual ``wr`` = (w, rc) (the down leg's
    right-hand side entry) is bit for bit the plain weighted residual
    (pressure_rhs_plain on the card) followed by the legs, ten times in a
    row, with the same launches but
    the entry in place of the b one. When ``timed``: returns the V-cycle's
    measurements (each leg, level 0 alone, the product, the V-cycle, their
    bounds, the device kernels of one V-cycle, the legs' grids and
    registers, the right-hand side entry against the pair it replaces),
    and with ``record`` fills the legs' rows."""
    import torch

    from opm_tpu_torch.linalg import gmg as k7
    from opm_tpu_torch.linalg import precond as k6

    prefix = "K7 gmg" if mod is k7 else "K10 amg"
    down, up = f"{prefix}_vcycle_down", f"{prefix}_vcycle_up"
    rhs = f"{prefix}_vcycle_down_rhs"
    w, rc = wr

    def counts():
        return (mod.vcycle_down_cuda.launches, mod.vcycle_up_cuda.launches,
                k7.coarsest_product.calls)

    def chk(name, pairs):
        for a, c in pairs:
            K.note(name, float((a - c).abs().max()) if c.numel() else 0.0)
            e = scaled_err(a, c)
            if not e <= tol:
                fail(f"{label}: {name} differs from its plain version "
                     f"({e:.3e} > {tol:g})")

    n0 = counts()
    x = amg.vcycle(vals, b).clone()
    ws = vals.ws
    dense = ws.bc.numel() > 0
    per = tuple(a - c for a, c in zip(counts(), n0))
    if per != (1, 1, int(dense)):
        fail(f"{label}: one V-cycle ran {per} (down, up, product) launches")
    bs, c = amg.vcycle_down_plain(vals, b)
    ec = vals[-1] @ c if dense else c
    xp, es = amg.vcycle_up_plain(vals, bs, ec)
    chk(down, [(t, bs[l]) for l, t in enumerate(ws.b) if t is not None]
        + ([(ws.bc.double(), c.double())] if dense else []))
    chk(up, [(t, es[l]) for l, t in enumerate(ws.e) if t is not None]
        + [(x, xp), (x, amg.vcycle(vals, b, twin=True))])
    # the right-hand side entry: K6's weighted residual folded into the
    # down leg, bit for bit the plain residual (elementwise, so the same
    # bits on the card) followed by the legs
    pair = amg.vcycle(vals, k6.pressure_rhs_plain(w, rc)).clone()
    n0 = counts() + (mod.vcycle_down_rhs_cuda.launches,)
    fused = amg.vcycle(vals, None, w=w, rc=rc).clone()
    per_f = tuple(a - c for a, c in zip(
        counts() + (mod.vcycle_down_rhs_cuda.launches,), n0))
    if per_f != (0, 1, int(dense), 1):
        fail(f"{label}: one V-cycle from (w, r) ran {per_f} (down, up, "
             "product, down from (w, r)) launches")
    K.note(rhs, float((fused - pair).abs().max()))
    if not torch.equal(fused, pair):
        fail(f"{label}: {rhs}: the V-cycle from (w, r) is not bit for bit "
             "the weighted residual followed by the legs")
    for _ in range(10):
        again = amg.vcycle(vals, None, w=w, rc=rc)
    if not torch.equal(again, fused):
        fail(f"{label}: {rhs}: ten V-cycles from (w, r) changed bits")
    chk(rhs, [(fused, amg.vcycle(vals, None, w=w, rc=rc, twin=True))])
    if not timed:
        return None
    wd, wu = vcycle_work(amg, vals)
    t = dict(down_ms=cuda_ms(lambda: mod.vcycle_down_cuda(ws, b)),
             up_ms=cuda_ms(lambda: mod.vcycle_up_cuda(ws, b)),
             down_plain_ms=cuda_ms(lambda: amg.vcycle_down_plain(vals, b)),
             up_plain_ms=cuda_ms(lambda: amg.vcycle_up_plain(vals, bs, ec)))
    bound = {leg: max(sum(x[0] for x in ws_) / HBM_BYTES_S,
                      sum(x[1] for x in ws_) / F64_FLOP_S) * 1e3
             for leg, ws_ in (("down", wd), ("up", wu))}
    t.update(down_bound_ms=bound["down"], up_bound_ms=bound["up"])
    # the right-hand side entry: the down leg's work plus w and rc read
    # and level 0's b written (56 bytes and 5 operations a cell)
    n_0 = rc.shape[1]
    t.update(
        down_rhs_ms=cuda_ms(lambda: mod.vcycle_down_rhs_cuda(ws, w, rc)),
        down_rhs_run_ms=run_ms(lambda: mod.vcycle_down_rhs_cuda(ws, w, rc)),
        down_run_ms=run_ms(lambda: mod.vcycle_down_cuda(ws, b)),
        pair_run_ms=run_ms(lambda: mod.vcycle_down_cuda(
            ws, k6.pressure_rhs_plain(w, rc))),
        down_rhs_bound_ms=max(
            (sum(x[0] for x in wd) + 56 * n_0) / HBM_BYTES_S,
            (sum(x[1] for x in wd) + 5 * n_0) / F64_FLOP_S) * 1e3)
    if record:
        for name, leg, ws_ in ((down, "down", wd), (up, "up", wu)):
            K.ms[name] = t[f"{leg}_ms"]
            K.plain_ms[name] = t[f"{leg}_plain_ms"]
            K.library_ms[name] = None
            K.bound_raw(name, sum(x[0] for x in ws_),
                        sum(x[1] for x in ws_))
        K.run_ms[down] = t["down_run_ms"]
        K.ms[rhs] = t["down_rhs_ms"]
        K.run_ms[rhs] = t["down_rhs_run_ms"]
        K.plain_ms[rhs] = cuda_ms(lambda: amg.vcycle_down_plain(
            vals, k6.pressure_rhs_plain(w, rc)))
        K.library_ms[rhs] = None
        K.bound_raw(rhs, sum(x[0] for x in wd) + 56 * n_0,
                    sum(x[1] for x in wd) + 5 * n_0)
    nlev = len(amg.levels)
    if nlev:
        t["level0"] = dict(
            down_ms=cuda_ms(lambda: mod.vcycle_down_cuda(ws, b, (0, 1))),
            up_ms=cuda_ms(lambda: mod.vcycle_up_cuda(ws, b, (0, 1))),
            down_bound_ms=wd[0][0] / HBM_BYTES_S * 1e3,
            up_bound_ms=wu[0][0] / HBM_BYTES_S * 1e3)
    prod = 0.0
    if dense:
        t["product_ms"] = cuda_ms(lambda: k7.coarsest_product(
            vals[-1], ws.bc, ws.ec))
        prod = nbytes(vals[-1], ws.bc, ws.ec) / HBM_BYTES_S * 1e3
    kernels = device_kernels(lambda: amg.vcycle(vals, None, w=w, rc=rc))
    t.update(
        vcycle_ms=cuda_ms(lambda: amg.vcycle(vals, b)),
        vcycle_rhs_ms=cuda_ms(lambda: amg.vcycle(vals, None, w=w, rc=rc)),
        vcycle_rhs_host_ms=host_ms(
            lambda: amg.vcycle(vals, None, w=w, rc=rc), reps=20),
        vcycle_bound_ms=bound["down"] + bound["up"] + prod,
        vcycle_plain_legs_ms=cuda_ms(lambda: amg._vcycle_legs_plain(vals,
                                                                     b)),
        vcycle_twin_ms=cuda_ms(lambda: amg.vcycle(vals, b, twin=True)),
        vcycle_host_ms=host_ms(lambda: amg.vcycle(vals, b), reps=20),
        launches_per_vcycle=dict(zip(("down", "up", "product"), per)),
        device_kernels_per_vcycle=None if kernels is None else len(kernels),
        device_kernels=kernels,
        levels=nlev, coarsest_n=amg.coarsest_n, grid=dict(
            down=ws.grid_down, up=ws.grid_up, **ws.info))
    return t


def log_vcycle(label, t):
    """One V-cycle's measurements, as compare_vcycle returned them."""
    l0 = t.get("level0")
    log(f"  V-cycle on {label} ({t['levels']} levels, coarsest "
        f"{t['coarsest_n']}): {t['vcycle_ms']:.4f} ms (bound "
        f"{t['vcycle_bound_ms']:.4f}; host clock {t['vcycle_host_ms']:.4f}); "
        f"plain legs {t['vcycle_plain_legs_ms']:.4f}, per-level twins "
        f"{t['vcycle_twin_ms']:.4f} ms; down {t['down_ms']:.4f} (bound "
        f"{t['down_bound_ms']:.4f}), up {t['up_ms']:.4f} (bound "
        f"{t['up_bound_ms']:.4f}), product "
        f"{t.get('product_ms', 0.0):.4f} ms"
        + (f"; level 0 alone: down {l0['down_ms']:.4f} (bound "
           f"{l0['down_bound_ms']:.4f}), up {l0['up_ms']:.4f} (bound "
           f"{l0['up_bound_ms']:.4f}) ms" if l0 else ""))
    log(f"    from the CPR apply's (w, r): V-cycle {t['vcycle_rhs_ms']:.4f} "
        f"ms (host clock {t['vcycle_rhs_host_ms']:.4f}); per launch in a run "
        f"of 50: down leg from (w, r) {t['down_rhs_run_ms']:.4f} (bound "
        f"{t['down_rhs_bound_ms']:.4f}), pressure_rhs_plain then the down "
        "leg "
        f"{t['pair_run_ms']:.4f}, the down leg alone "
        f"{t['down_run_ms']:.4f} ms; one call of the entry "
        f"{t['down_rhs_ms']:.4f} ms")
    kernels = t["device_kernels"]
    log(f"    launches per V-cycle {t['launches_per_vcycle']}; device "
        "kernels " + ("not measured" if kernels is None else
                      f"{len(kernels)}: {[n[:40] for n in kernels]}")
        + f"; grid {t['grid']}")


def log_k7_refresh(label, t):
    """One K7 refresh's measurements, as compare_k7_refresh returned
    them."""
    kernels = t["device_kernels_per_coarsen_values"]
    log(f"  K7 refresh on {label} ({t['levels']} levels, coarsest "
        f"{t['coarsest_n']}): kernel {t['kernel_ms']:.4f} ms, "
        f"{t['kernel_run_ms']:.4f} per launch in a run of 50 (bound "
        f"{t['bound_ms']:.4f}, {t['bytes'] / 1e6:.1f} MB; plain "
        f"{t['plain_ms']:.4f}); coarsen_values {t['coarsen_values_ms']:.4f} "
        f"ms (host clock {t['coarsen_values_host_ms']:.4f}; per-level "
        f"composition {t['coarsen_values_twin_ms']:.4f}), "
        + ("device kernels not measured" if kernels is None else
           f"{kernels} device kernels")
        + f"; inverse {t['inverse_ms']:.4f} ms (bound "
        f"{t['inverse_bound_ms']:.4f}); grid {t['grid']} ({t['sms']} SMs x "
        f"{t['blocks_per_sm']}, {t['registers']} registers)")


def compare_k8(K, shape, dev, seed, label, timed):
    """K8's steps against their twins on seeded vectors of ``shape`` (a
    solve's (3, nc)), each step from the same vectors and scalars: vectors
    to TOL_K8_VEC of max, scalar slots to TOL_K8_DOT relative; a step run
    twice gives the same bits; no step allocates device memory. Timed with
    bounds and yardsticks when ``timed``."""
    import numpy as np
    import torch

    from opm_tpu_torch.linalg import kernels_k8 as k8

    rng = np.random.default_rng(seed + 9)

    def rnd():
        return torch.as_tensor(rng.standard_normal(shape), device=dev)

    b, r, p, v, t, s, phat, shat, x = (rnd() for _ in range(9))
    rhat = b
    ws = k8.Workspace(b, kernels=True)
    sp = k8.new_scalars(dev)

    def chk(name, pairs, slots):
        for a, c in pairs:
            K.note(name, float((a - c).abs().max()))
            e = scaled_err(a, c)
            if not e <= TOL_K8_VEC:
                fail(f"{label}: {name} differs from its plain version "
                     f"({e:.3e} of max > {TOL_K8_VEC:g})")
        for i in slots:
            K.note(name, abs(float(ws.sc[i]) - float(sp[i])))
            e = rel_err(ws.sc[i:i + 1], sp[i:i + 1])
            if not e <= TOL_K8_DOT:
                fail(f"{label}: {name} scalar slot {i} differs from its "
                     f"plain version ({e:.3e} > {TOL_K8_DOT:g})")

    k8.init_cuda(ws, b)
    k8.init_plain(b, sp)
    chk("K8 init", (), range(k8.EPS))
    sp[k8.ALPHA], sp[k8.OMEGA], sp[k8.BETA] = 0.7, 0.3, 0.5
    ws.sc.copy_(sp)
    pk = k8.p_update_cuda(ws, p.clone(), r, v)
    chk("K8 p_update", [(pk, k8.p_update_plain(p, r, v, sp))], ())
    sk = k8.alpha_s_cuda(ws, rhat, v, r).clone()
    sc_k = ws.sc.clone()
    chk("K8 alpha_s", [(sk, k8.alpha_s_plain(rhat, v, r, sp))],
        [k8.ALPHA])
    ws.sc.copy_(sc_k)
    k8.alpha_s_cuda(ws, rhat, v, r)
    if not (torch.equal(ws.s, sk) and torch.equal(ws.sc, sc_k)):
        fail(f"{label}: K8 alpha_s run twice differs")
    ws.sc.copy_(sp)
    xk, rk, pk = (a.clone() for a in (x, r, p))
    k8.omega_xr_p_cuda(ws, t, s, xk, rk, phat, shat, rhat, pk, v)
    chk("K8 omega_xr_p", list(zip(
        (xk, rk, pk),
        k8.omega_xr_p_plain(t, s, x, r, phat, shat, rhat, p, v, sp))),
        [k8.OMEGA, k8.RHO, k8.RHO1, k8.BETA, k8.RR])
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    for _ in range(3):
        k8.init_cuda(ws, b)
        k8.p_update_cuda(ws, pk, rk, v)
        k8.alpha_s_cuda(ws, rhat, v, rk)
        k8.omega_xr_p_cuda(ws, t, ws.s, xk, rk, phat, shat, rhat, pk, v)
    torch.cuda.synchronize()
    if torch.cuda.memory_stats().get("allocation.all.allocated", 0) != \
            before:
        fail(f"{label}: a K8 step allocated device memory")
    if not timed:
        return
    n = b.numel()
    alpha = 0.7
    scp = sp.clone()
    steps = [
        ("K8 init", lambda: k8.init_cuda(ws, b),
         lambda: k8.init_plain(b, scp), (b,), (), 2 * n,
         lambda: torch.dot(b.reshape(-1), b.reshape(-1))),
        ("K8 p_update", lambda: k8.p_update_cuda(ws, pk, rk, v),
         lambda: k8.p_update_plain(p, r, v, scp), (p, r, v), (p,), 4 * n,
         None),
        ("K8 alpha_s", lambda: k8.alpha_s_cuda(ws, rhat, v, r),
         lambda: k8.alpha_s_plain(rhat, v, r, scp), (rhat, v, r), (s,),
         4 * n, lambda: (torch.dot(rhat.reshape(-1), v.reshape(-1)),
                         torch.add(r, v, alpha=-alpha))),
        ("K8 omega_xr_p",
         lambda: k8.omega_xr_p_cuda(ws, t, s, xk, rk, phat, shat, rhat, pk,
                                    v),
         lambda: k8.omega_xr_p_plain(t, s, x, r, phat, shat, rhat, p, v,
                                     scp),
         (t, s, x, phat, shat, rhat, p, v), (x, r, p), 18 * n, None),
    ]
    for name, kfn, pfn, ins, outs, flops, lib in steps:
        ws.sc.copy_(sp)
        K.ms[name] = cuda_ms(kfn)
        K.plain_ms[name] = cuda_ms(pfn)
        K.library_ms[name] = cuda_ms(lib) if lib is not None else None
        K.bound(name, ins, outs, flops)


def check_k8_launches(launches, rep, label):
    """Two K8 launches per BiCGStab iteration (alpha_s, omega_xr_p) and two
    per solve (init, the first p_update), one solve per Newton."""
    n = {k: launches[f"K8 {k}"] for k in ("init", "p_update", "alpha_s",
                                          "omega_xr_p")}
    log(f"  K8 launches: {n} over {rep.linear_iterations} BiCGStab "
        f"iterations in {rep.newton_iterations} solves")
    if not (n["alpha_s"] == n["omega_xr_p"] == rep.linear_iterations
            and n["init"] == n["p_update"] == rep.newton_iterations):
        fail(f"{label}: K8 launches {n} are not 2 per iteration and 2 per "
             "solve")


def check_reduced_launches(counts, label, model):
    """A reduced matvec (the Krylov operator) is one device launch on a
    structured or a gather grid (K4, or K4-faces, with K5's well term) and
    two on an embedded grid (K4, then K4-faces with the well term); the
    stand-alone well term never runs. On an embedded grid K4 also runs as
    the base of each K4-faces smoothing step, which is left out."""
    kind = ("gather" if model.op_dims is None else
            "embedded" if model.faces is not None else "structured")
    fused = counts["K5 schur_matvec fused"]
    k4, k4f = counts["K4 block7_matvec"], counts["K4-faces matvec"]
    alone = counts["K5 schur_matvec"]
    if kind == "embedded":
        k4 -= counts["K4-faces smooth"]
    per = (k4 + k4f + alone) / max(fused, 1)
    log(f"  {label} ({kind}): {fused} reduced matvecs, {per:g} device "
        f"launches each (K4 {k4}, K4-faces {k4f}, stand-alone well term "
        f"{alone})")
    if fused <= 0 or alone or per != (2 if kind == "embedded" else 1):
        fail(f"{label}: a reduced matvec was not "
             f"{2 if kind == 'embedded' else 1} launch(es) with the well "
             "term fused")
    return per


def check_vcycle_launches(launches, rep, label, amg):
    """Two launches per V-cycle (K7's or K10's down leg from the CPR
    apply's weighted residual, and the up leg) and one float32 coarsest
    product, two V-cycles per BiCGStab iteration; the down leg's b entry
    never runs (a CPR apply is one launch shorter than K6's stand-alone
    weighted residual and the b entry made it)."""
    from opm_tpu_torch.linalg import gmg as k7
    from opm_tpu_torch.linalg.amg import DeviceAmg

    prefix = "K10 amg" if isinstance(amg, DeviceAmg) else "K7 gmg"
    n = (launches[f"{prefix}_vcycle_down_rhs"],
         launches[f"{prefix}_vcycle_up"], k7.coarsest_product.calls)
    off = launches[f"{prefix}_vcycle_down"]
    v = 2 * rep.linear_iterations
    log(f"  {prefix} V-cycle launches (down from (w, r), up, product): {n} "
        f"over {v} V-cycles; the b entry's down leg: {off}")
    if n != (v, v, v) or off != 0:
        fail(f"{label}: {prefix} launches {n} and {off} are not 2 kernels "
             f"and 1 product per V-cycle ({v} V-cycles) with the weighted "
             "residual in the down leg")


SETUP_NAMES = ("K6 cpr_setup in amg_refresh", "K10 amg_refresh",
               "K7 gmg_refresh", "K6 cpr_setup", "K6 cpr_setup_cells",
               "K6-faces cpr_faces")


def check_refresh_launches(launches, rep, label, amg, plain_inv4x4):
    """The pressure setup's launches per Newton system (SETUP_NAMES): on a
    gather grid (the aggregation AMG) one, K10's refresh with K6 as its
    first phases; on the others (the structured GMG) two, K6's setup and
    K7's refresh; no other of them. One K5 right-hand-side launch per
    Newton system that forms D^-1, and no plain ``inv4x4`` on the card
    (``plain_inv4x4`` calls counted over the run). Returns the pressure
    setup's launches per Newton system."""
    from opm_tpu_torch.linalg.amg import DeviceAmg

    n = tuple(launches[k] for k in SETUP_NAMES)
    newtons = rep.newton_iterations
    main = (("K6 cpr_setup in amg_refresh",) if isinstance(amg, DeviceAmg)
            else ("K7 gmg_refresh", "K6 cpr_setup"))
    want = tuple(newtons if k in main else 0 for k in SETUP_NAMES)
    inv = launches["K5 inv4x4 in schur_rhs"]
    per = sum(n) / max(newtons, 1)
    log(f"  pressure setup launches ({', '.join(SETUP_NAMES)}): {n} over "
        f"{newtons} Newton systems ({per:g} a Newton); D^-1 formed by {inv} "
        f"right-hand-side launches, {plain_inv4x4} plain inv4x4 calls on "
        "the card")
    if n != want:
        fail(f"{label}: pressure setup launches {n}, not {want}")
    if inv != newtons or plain_inv4x4:
        fail(f"{label}: D^-1 was formed by {inv} right-hand-side launches "
             f"over {newtons} Newton systems and {plain_inv4x4} plain inv4x4 "
             "calls on the card")
    return per


def check_k9_launches(launches, rep, label):
    """One K9 update per Newton iteration and one convergence check per
    Newton iteration and per converged substep (0 failed)."""
    upd = launches["K9 update"]
    conv = launches["K9 convergence"] + launches["K9 convergence_masked"]
    log(f"  K9 launches: {upd} updates, {conv} convergence checks over "
        f"{rep.newton_iterations} Newtons in {rep.substeps} substeps")
    if upd != rep.newton_iterations or \
            conv != rep.newton_iterations + rep.substeps:
        fail(f"{label}: K9 launches ({upd}, {conv}) are not one per update "
             "and one per convergence check")


def solve_twice(sim, sys, tol, maxiter):
    """One Newton system solved at ``tol`` (at most ``maxiter``
    iterations) with the kernels (twice: the fused reductions are
    deterministic, so the two runs must agree bit for bit) and with the
    plain twins on the card: (converged, iterations, twin iterations,
    max|du - du_twin| / max|du_twin|, seconds, twin seconds)."""
    import torch

    from opm_tpu_torch.linalg.krylov import bicgstab
    from opm_tpu_torch.linalg.precond import make_cpr_cells
    from opm_tpu_torch.models import linearize

    out = []
    for twin in (False, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mv, rhs, rec = linearize.schur_eliminate_wells(
            sys, sim.model.op_dims, twin=twin)
        M = make_cpr_cells(sys, sim.solver.amg, sim.model.op_dims,
                           twin=twin)
        res = bicgstab(mv, rhs, precond=M, tol=tol, maxiter=maxiter,
                       twin=twin)
        du = torch.cat([res.x.reshape(-1), rec(res.x).reshape(-1)])
        torch.cuda.synchronize()
        out.append((res, du, time.perf_counter() - t0))
    (rk, dk, tk), (rk2, dk2, _), (rp, dp, tp) = out
    if rk2.iterations != rk.iterations or not torch.equal(dk, dk2):
        fail("two kernel solves of the same system differ")
    return (rk.converged and rp.converged, rk.iterations, rp.iterations,
            scaled_err(dk, dp), tk, tp)


# ---------------------------------------------------------------------------
# 6: the face-list kernels and K10 on the Norne-class systems

def csr_of_blocks(sys):
    """The cells-only block operator of a gather grid as a float64 CSR
    matrix on the card (equation-major rows and columns): the library
    yardstick for K4-faces."""
    import torch

    fl = sys.faces
    nc = sys.diag.shape[1]
    ar = torch.arange(nc, device=sys.diag.device)
    rows, cols, vals = [], [], []
    for e in range(3):
        for v in range(3):
            k = 3 * e + v
            rows += [e * nc + ar, e * nc + fl.c1, e * nc + fl.c2]
            cols += [v * nc + ar, v * nc + fl.c2, v * nc + fl.c1]
            vals += [sys.diag[k], sys.face_R[k], -sys.face_L[k]]
    A = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                             torch.cat(cols)]),
                                torch.cat(vals), (3 * nc, 3 * nc))
    return A.coalesce().to_sparse_csr()


def csr_of_level(diag, ell_vals, cols):
    """An AMG level's matrix (diag + ELL) as a float64 CSR matrix: the
    yardstick of the SpMV inside K10's sweep."""
    import torch

    K, n = ell_vals.shape
    ar = torch.arange(n, device=diag.device)
    A = torch.sparse_coo_tensor(
        torch.stack([torch.cat([ar, ar.repeat(K)]),
                     torch.cat([ar, cols.reshape(-1)])]),
        torch.cat([diag, ell_vals.reshape(-1)]), (n, n))
    return A.coalesce().to_sparse_csr()


def inverse_bound_ms(n):
    """The least time of a float32 (n, n) inverse: 2 n^3 operations at the
    float32 peak, or the matrix read and the inverse written once."""
    return max(2 * n ** 3 / F32_FLOP_S, 8 * n * n / HBM_BYTES_S) * 1e3


def k7_refresh_adds(gmg):
    """The float64 additions of K7's refresh on ``gmg``: per coarsening
    step three per coarse diagonal entry and one per coupling of a face
    across the coarsened axis (a pair sum; along it a face is copied)."""
    from opm_tpu_torch.linalg.gmg import _face_shape
    import numpy as np

    adds = 0
    for p, lv in enumerate(gmg.levels):
        real = (gmg.levels[p + 1].dims if p + 1 < len(gmg.levels)
                else gmg.coarse_dims)
        adds += 3 * int(np.prod(real)) + 2 * sum(
            int(np.prod(_face_shape(real, b))) for b in range(3)
            if b != lv.axis)
    return adds


def compare_k7_refresh(K, amg, diag_p, off, label, timed, rng):
    """K7's value refresh on one Newton system's pressure values of a
    structured hierarchy: one launch per ``coarsen_values``, which returns
    the hierarchy's own LevelValues; every level and the float32 dense
    coarsest matrix bit for bit the per-level composition on CPU copies of
    the inputs and the refresh's plain version (``refresh_plain``, into a
    second set of buffers on the card); the inverse (inv_ex into the
    hierarchy's buffer) bit for bit torch.linalg.inv of the same matrix,
    in its layout, info 0, and within 1e-5 of max the CPU's; the kernel
    makes no allocator request, ten refreshes (the inverse's pivots are
    requested from the cache) leave the memory allocated as it was and keep
    the workspace's table and the refresh's; a V-cycle after a refresh with other values equals one on
    the per-level composition of those values on the card. Returns the
    hierarchy's grid and one ``coarsen_values``' host ms, device time and
    device kernels; when ``timed`` also the kernel's time (one call; per
    launch in a run of 50), its bound and the plain version's, into the
    table."""
    import torch

    from opm_tpu_torch.linalg import gmg as k7

    name = "K7 gmg_refresh"
    dev = off.device
    diag_p, off = diag_p.contiguous(), off.contiguous()
    n0 = k7.refresh_cuda.launches
    vk = amg.coarsen_values(diag_p, off)
    R = amg.refresh(dev)
    if k7.refresh_cuda.launches != n0 + 1 or vk is not R.vals:
        fail(f"{label}: a K7 refresh was not one launch into the "
             "hierarchy's buffers")
    levels, A = amg.compose(diag_p.cpu(), off.cpu())
    Rp = k7.Refresh(amg, dev)
    k7.refresh_plain(Rp, diag_p, off)
    pairs = [(R.dense, A.to(torch.float32)), (R.dense, Rp.dense)]
    for (dk, ok), (dc, oc), (dp, op) in zip(vk[:-1], levels, Rp.vals[:-1]):
        pairs += [(dk, dc), (dk, dp)]
        for (kL, kR), (cL, cR), (pL, pR) in zip(ok, oc, op):
            pairs += [(kL, cL), (kR, cR), (kL, pL), (kR, pR)]
    for a, c in pairs:
        a, c = a.cpu(), c.cpu()
        K.note(name, float((a - c).abs().max()) if c.numel() else 0.0)
        if not torch.equal(a, c):
            fail(f"{label}: {name} is not bit for bit the per-level "
                 "composition on the CPU and its plain version")
    inv = torch.linalg.inv(R.dense)
    inv_err = scaled_err(vk[-1].cpu(), torch.linalg.inv(A.to(torch.float32)))
    if not (torch.equal(vk[-1], inv) and vk[-1].stride() == inv.stride()
            and inv_err <= 1e-5):
        fail(f"{label}: K7's float32 coarsest inverses differ")
    if int(R.inv_info) != 0:
        fail(f"{label}: the coarsest matrix is singular (inv_ex info "
             f"{int(R.inv_info)})")
    b = torch.as_tensor(rng.standard_normal(amg.nc), device=dev)
    x = amg.vcycle(vk, b).clone()
    tables = (vk.ws.table.clone(), R.table.clone())
    kernel_allocs, _ = allocations(lambda: k7.refresh_cuda(R, diag_p, off))
    refresh_allocs, no_net = allocations(
        lambda: amg.coarsen_values(diag_p, off))
    if (kernel_allocs != 0 or not no_net
            or amg.coarsen_values(diag_p, off) is not vk
            or not torch.equal(vk.ws.table, tables[0])
            or not torch.equal(R.table, tables[1])
            or not torch.equal(amg.vcycle(vk, b), x)):
        fail(f"{label}: the K7 refresh kernel allocated, ten refreshes left "
             "memory allocated, moved the workspace or changed a V-cycle")
    f = torch.as_tensor(rng.uniform(0.9, 1.1, off.shape), device=dev)
    d2, o2 = diag_p * 1.25, off * f
    x2 = amg.vcycle(amg.coarsen_values(d2, o2), b).clone()
    fresh = amg.coarsen_values(d2, o2, twin=True)
    if not torch.equal(x2, amg.vcycle(fresh, b)):
        fail(f"{label}: a V-cycle after a second K7 refresh differs from one "
             "on freshly composed values")
    del fresh, levels, A
    amg.coarsen_values(diag_p, off)
    nbytes_moved = k7.refresh_bytes(amg)
    kernels = device_kernels(lambda: amg.coarsen_values(diag_p, off))
    out = dict(levels=len(amg.levels), coarsest_n=amg.coarsest_n,
               grid=R.grid, **R.grid_info, work=R.work,
               inverse_vs_cpu=inv_err, bytes=nbytes_moved,
               allocations_per_kernel=kernel_allocs,
               allocations_per_coarsen_values=refresh_allocs,
               bound_ms=nbytes_moved / HBM_BYTES_S * 1e3,
               kernel_ms=cuda_ms(lambda: k7.refresh_cuda(R, diag_p, off)),
               kernel_run_ms=run_ms(lambda: k7.refresh_cuda(R, diag_p,
                                                            off)),
               plain_ms=cuda_ms(lambda: k7.refresh_plain(Rp, diag_p, off)),
               coarsen_values_ms=cuda_ms(
                   lambda: amg.coarsen_values(diag_p, off)),
               coarsen_values_host_ms=host_ms(
                   lambda: amg.coarsen_values(diag_p, off), reps=20),
               coarsen_values_twin_ms=cuda_ms(
                   lambda: amg.coarsen_values(diag_p, off, twin=True)),
               inverse_ms=cuda_ms(R.invert),
               inverse_bound_ms=inverse_bound_ms(amg.coarsest_n),
               device_kernels_per_coarsen_values=None if kernels is None
               else len(kernels), device_kernels=kernels)
    if timed:
        K.ms[name], K.run_ms[name] = out["kernel_ms"], out["kernel_run_ms"]
        K.plain_ms[name] = out["plain_ms"]
        K.library_ms[name] = None
        K.bound_raw(name, nbytes_moved, k7_refresh_adds(amg))
    del Rp
    amg.coarsen_values(diag_p, off)
    return out


def compare_refresh(K, amg, diag_p, off, label, timed, rng):
    """K10's value refresh on one Newton system of a gather grid: one
    launch per ``coarsen_values``, which returns the hierarchy's own
    LevelValues; every level's diag and ELL values and the float32 dense
    coarsest matrix bit for bit the per-level composition of the twins on
    CPU copies of the inputs (the CPU's index_add_ adds in index order, the
    kernel's) and the refresh's plain version on the card, within TOL_K10
    of max the per-level twins on the card (index_add_ with atomics); the
    inverse (torch.linalg.inv_ex into the hierarchy's buffer) bit for bit
    torch.linalg.inv of the same matrix, in its layout, and within 1e-5 of
    max the CPU's; a V-cycle on the refreshed values bit for bit one on the
    composition's values (moved to the card, with that inverse); the
    kernel makes no allocator request and ten refreshes leave the memory
    allocated as it was and keep the workspace's table; a
    V-cycle after a refresh with other values equals one on a hierarchy
    put on the card afresh. When ``timed``: the kernel's time (one call;
    per launch in a run of 50), its bound, the plain
    version's, and one ``coarsen_values`` (host clock, device kernels)."""
    import torch

    from opm_tpu_torch.linalg import amg as k10

    name = "K10 amg_refresh"
    R, nl = amg.refresh, amg.n_levels
    n0 = k10.refresh_cuda.launches
    vk = amg.coarsen_values(diag_p, off)
    if k10.refresh_cuda.launches != n0 + 1 or vk is not R.vals:
        fail(f"{label}: a refresh was not one launch into the hierarchy's "
             "buffers")
    hc = k10.DeviceAmg(amg.hierarchy, "cpu")
    vc = hc.coarsen_values(diag_p.cpu(), off.cpu())
    Rp = k10.Refresh(amg, diag_p.device)
    k10.refresh_plain(Rp, diag_p, off)
    vp = amg.coarsen_values(diag_p, off, twin=True)
    pairs = [(a, c) for k in range(nl) for a, c in zip(vk[k], vc[k])]
    plain = [(a, c) for k in range(nl) for a, c in zip(vk[k], Rp.vals[k])]
    if R.dense is not None:
        pairs.append((R.dense, k10.dense_coarsest(
            *vc[nl - 1], hc.ell[-1]["cols"]).to(torch.float32)))
        plain.append((R.dense, Rp.dense))

    for a, c in pairs + plain:
        K.note(name, float((a.cpu() - c.cpu()).abs().max()))
        if not torch.equal(a.cpu(), c.cpu()):
            fail(f"{label}: {name} is not bit for bit the per-level "
                 "composition on the CPU and its plain version")
    for k in range(nl):
        for a, c in zip(vk[k], vp[k]):
            e = scaled_err(a, c)
            if not e <= TOL_K10:
                fail(f"{label}: {name} differs from the per-level twins on "
                     f"the card ({e:.3e} > {TOL_K10:g})")
    inv_err, comp = None, [(d.to(off.device), e.to(off.device))
                           for d, e in vc[:nl]]
    if R.dense is not None:
        inv_err = scaled_err(vk[-1].cpu(), vc[-1])
        inv = torch.linalg.inv(R.dense)
        if not (torch.equal(vk[-1], inv) and vk[-1].stride() == inv.stride()
                and inv_err <= 1e-5 and scaled_err(vk[-1], vp[-1]) <= 1e-5):
            fail(f"{label}: the float32 coarsest inverses differ")
        if int(R.inv_info) != 0:
            fail(f"{label}: the coarsest matrix is singular (inv_ex info "
                 f"{int(R.inv_info)})")
        comp.append(inv)
    # a V-cycle on the refreshed values is the one on the composition's
    # values (with the card's torch.linalg.inv), bit for bit
    b = torch.as_tensor(rng.standard_normal(amg.n0), device=off.device)
    if not torch.equal(amg.vcycle(vk, b), amg.vcycle(k10.LevelValues(comp),
                                                      b)):
        fail(f"{label}: a V-cycle on the refreshed values differs from one "
             "on the per-level composition's")
    table = vk.ws.table.clone()
    kernel_allocs, _ = allocations(lambda: k10.refresh_cuda(R, diag_p, off))
    refresh_allocs, no_net = allocations(
        lambda: amg.coarsen_values(diag_p, off))
    if (kernel_allocs != 0 or not no_net
            or amg.coarsen_values(diag_p, off) is not vk
            or not torch.equal(vk.ws.table, table)):
        fail(f"{label}: the refresh kernel allocated, or ten refreshes left "
             "memory allocated or moved the workspace")
    # other values: the V-cycle on the overwritten buffers equals one on a
    # hierarchy put on the card afresh
    f = torch.as_tensor(rng.uniform(0.9, 1.1, off.shape), device=off.device)
    d2, o2 = diag_p * 1.25, off * f
    x2 = amg.vcycle(amg.coarsen_values(d2, o2), b).clone()
    fresh = k10.DeviceAmg(amg.hierarchy, off.device)
    if not torch.equal(x2, fresh.vcycle(fresh.coarsen_values(d2, o2), b)):
        fail(f"{label}: a V-cycle after a second refresh differs from one "
             "on fresh values")
    del fresh, vp, comp
    amg.coarsen_values(diag_p, off)
    out = dict(levels=nl, grid=R.grid, **R.grid_info,
               work=R.work, inverse_vs_cpu=inv_err,
               allocations_per_kernel=kernel_allocs,
               allocations_per_coarsen_values=refresh_allocs)
    if not timed:
        return out
    nbytes_moved = k10.refresh_bytes(
        [e["cols"].shape[1] for e in amg.ell],
        [e["cols"].shape[0] for e in amg.ell],
        [e["slot"].numel() for e in amg.ell])
    adds = sum(lv["n_fine"] + lv["n_coarse"] for lv in amg.levels) + sum(
        e["slot"].numel() for e in amg.ell[:-1])
    K.ms[name] = cuda_ms(lambda: k10.refresh_cuda(R, diag_p, off))
    K.run_ms[name] = run_ms(lambda: k10.refresh_cuda(R, diag_p, off))
    K.plain_ms[name] = cuda_ms(lambda: k10.refresh_plain(Rp, diag_p, off))
    K.library_ms[name] = None
    K.bound_raw(name, nbytes_moved, adds)
    kernels = device_kernels(lambda: amg.coarsen_values(diag_p, off))
    out.update(
        bytes=nbytes_moved, adds=adds, ms=K.ms[name],
        run_ms=K.run_ms[name], plain_ms=K.plain_ms[name],
        bound_ms=K.bound_ms[name],
        inverse_ms=None if R.dense is None else cuda_ms(R.invert),
        inverse_bound_ms=None if R.dense is None
        else inverse_bound_ms(amg.coarsest_n),
        coarsen_values_host_ms=host_ms(
            lambda: amg.coarsen_values(diag_p, off), reps=20),
        device_kernels_per_coarsen_values=None if kernels is None
        else len(kernels), device_kernels=kernels)
    amg.coarsen_values(diag_p, off)
    return out


def device_ms(fn, run=20, reps=5):
    """Device ms per call of fn: ``run`` calls enqueued behind a spin
    kernel that holds the stream (torch.cuda._sleep) while the host
    enqueues them, CUDA events around the run, so the calls run back to
    back on the card whatever their host time; median of ``reps``."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)       # some 25 ms at 2 GHz
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(run):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / run)
    return statistics.median(times)


def poison_refresh(amg, R):
    """NaN into every value that K10's refresh with K6 as its first phases
    writes into ``R`` (the setup's outputs, every level's diag, the ELL
    slots the refresh fills, the dense coarsest matrix and its inverse),
    so that a value the launch fails to write shows; the padding slots,
    which no refresh writes, keep their zeros."""
    import torch
    nan = float("nan")
    for t in (*R.setup.tensors(), *R.diag):
        t.fill_(nan)
    src = amg.ell[0]["src"]
    R.ell[0].view(-1)[src >= 0] = nan
    for k, lv in enumerate(amg.levels):
        R.ell[k + 1].view(-1)[lv["ent_dst"].long()] = nan
    if R.dense is not None:
        R.dense.fill_(nan)
        R.inv.fill_(nan)
    torch.cuda.synchronize()


def compare_k6_fused(K, amg, sys, label, timed):
    """K6 on a gather grid's face list as the main path runs it: its cell
    part, then a thread per face, as the first phases of K10's refresh
    launch, into the hierarchy's buffers filled with NaN beforehand
    (``poison_refresh``). Its outputs bit for bit (``torch.equal``) the
    twin's (``cpr_setup_plain``) and the former pair's (K6's cell part,
    then K6-faces, into fresh tensors); its levels, dense matrix and
    inverse bit for bit the refresh's plain version from the twin; no
    allocator request. When ``timed``: its ms (one call, per launch in a
    run of 50) and device ms per call (``device_ms``), bound and plain ms;
    beside them the pair, the pair and the refresh launch, the parent's
    pressure setup (the pair, the refresh, the inverse) and the main
    path's (``pressure_setup``): one call, in a run of 50, device ms, host
    ms (synced) and the host's own ms per call (``enqueue_ms``)."""
    import torch

    from opm_tpu_torch.linalg import amg as k10
    from opm_tpu_torch.linalg import precond as k6
    from opm_tpu_torch.tools.newton_ab import enqueue_ms

    fl, dev = sys.faces, sys.diag.device
    ops = (sys.diag, sys.face_L, sys.face_R)
    n_fused = "K6 cpr_setup in amg_refresh"
    twin = k6.cpr_setup_plain(*ops, None, fl)

    def pair():
        cells = k6.cpr_setup_cells_cuda(ops[0])
        return (*cells, k6.cpr_faces_cuda(fl, cells[1], *ops[1:]))

    def same(name, got, want, what):
        for a, b in zip(got, want):
            K.note(name, float((a - b).abs().max()) if b.numel() else 0.0)
            if not torch.equal(a, b):
                fail(f"{label}: {name} is not bit for bit {what}")

    R = amg.card_refresh(dev)
    out = R.setup
    pr = pair()
    same("K6 cpr_setup_cells", pr[:3], twin[:3], "the twin's")
    same("K6-faces cpr_faces", pr[3:], twin[3:], "the twin's")
    Rp = k10.Refresh(amg, dev)
    k6.cpr_setup_refresh_plain(Rp, fl, *ops)
    Rp.invert()
    poison_refresh(amg, R)
    n0 = k10.refresh_setup_cuda.launches
    dinv, w, vals = k6.cpr_setup_refresh_cuda(amg, fl, *ops)
    if k10.refresh_setup_cuda.launches != n0 + 1 or vals is not R.vals \
            or dinv is not out.dinv or w is not out.w:
        fail(f"{label}: {n_fused} was not one launch into the hierarchy's "
             "buffers")
    same(n_fused, out.tensors(), twin, "the twin's")
    same(n_fused, out.tensors(), pr, "the former pair's")
    nl = amg.n_levels
    same(n_fused, [t for k in range(nl) for t in vals[k]]
         + ([R.dense, vals[-1]] if R.dense is not None else []),
         [t for k in range(nl) for t in Rp.vals[k]]
         + ([Rp.dense, Rp.vals[-1]] if R.dense is not None else []),
         "the refresh's plain version's from the twin")
    # cpr_setup on the card: the same launch, its outputs the buffers
    poison_refresh(amg, R)
    po = k6.cpr_setup(sys, None, amg)
    if any(a is not b for a, b in zip(po, out.tensors())):
        fail(f"{label}: cpr_setup did not write the hierarchy's buffers")
    same(n_fused, po, twin, "the twin's")
    R.invert()
    allocs = dict(
        fused=allocations(lambda: k10.refresh_setup_cuda(R, fl, *ops)),
        main=allocations(lambda: k6.pressure_setup(sys, None, amg)))
    if allocs["fused"][0] != 0:
        fail(f"{label}: {n_fused} made allocator requests {allocs}")
    res = dict(allocations_per_call={k: v[0] for k, v in allocs.items()},
               grid_setup=R.grid_setup, **{f"setup_{k}": v for k, v in
                                          R.grid_setup_info.items()})
    if not timed:
        return res
    nc, n = ops[0].shape[1], fl.n
    b_pair = nbytes((ops[0], ops[1][0::3], ops[2][0::3], fl.c1_32,
                     fl.c2_32), twin)
    flops = 60 * nc + 12 * n
    b_ref = k10.refresh_bytes([e["cols"].shape[1] for e in amg.ell],
                              [e["cols"].shape[0] for e in amg.ell],
                              [e["slot"].numel() for e in amg.ell])
    adds = sum(lv["n_fine"] + lv["n_coarse"] for lv in amg.levels) + sum(
        e["slot"].numel() for e in amg.ell[:-1])
    fused = lambda: k10.refresh_setup_cuda(R, fl, *ops)  # noqa: E731
    K.ms[n_fused] = cuda_ms(fused)
    K.run_ms[n_fused] = run_ms(fused)
    K.plain_ms[n_fused] = cuda_ms(
        lambda: k6.cpr_setup_refresh_plain(Rp, fl, *ops))
    K.library_ms[n_fused] = None
    # w, diag_p and off stay in the launch: their reads by the face phase
    # and the refresh are not counted
    b_fused = b_pair + b_ref - 8 * (amg.n0 + amg.nnz0)
    K.bound_raw(n_fused, b_fused, flops + adds)
    res[f"{n_fused} device_ms"] = device_ms(fused)
    # the pair's two kernels alone
    res["K6 cpr_setup_cells device_ms"] = device_ms(
        lambda: k6.cpr_setup_cells_cuda(ops[0]))
    res["K6-faces cpr_faces device_ms"] = device_ms(
        lambda: k6.cpr_faces_cuda(fl, pr[1], *ops[1:]))

    def parent():
        _, _, dp, off = pair()
        k10.refresh_cuda(R, dp, off)
        R.invert()

    calls = dict(pair=pair, fused=fused,
                 pair_refresh=lambda: k10.refresh_cuda(R, *pair()[2:]),
                 parent_pressure_setup=parent,
                 pressure_setup=lambda: k6.pressure_setup(sys, None, amg))
    for k, fn in calls.items():
        res[k] = dict(ms=cuda_ms(fn), run_ms=run_ms(fn),
                      device_ms=device_ms(fn), host_ms=host_ms(fn, reps=20),
                      enqueue_ms=enqueue_ms(fn))
    res.update(bytes_fused=b_fused)
    log(f"  {label}: K6 per call in ms (one call / in a run of 50 / device "
        "/ host synced / host's own): " + "; ".join(
            f"{k} {v['ms']:.4f} / {v['run_ms']:.4f} / {v['device_ms']:.4f} "
            f"/ {v['host_ms']:.4f} / {v['enqueue_ms']:.4f}"
            for k, v in res.items() if isinstance(v, dict) and "ms" in v))
    return res


def compare_face_kernels(K, sim, sys, state, dt, seed, label, timed):
    """The face-list kernels (and K10 on a gather grid) against their plain
    versions on one assembled system of a grid with a face list; timed
    with bounds and yardsticks when ``timed``. Returns extra measurements
    (the embedded grid's epilogue times, the AMG V-cycle, the level-0
    SpMV yardstick)."""
    import numpy as np
    import torch

    from opm_tpu_torch.linalg import amg as k10
    from opm_tpu_torch.linalg import gmg as k7
    from opm_tpu_torch.linalg import precond as k6
    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.models import linearize as k4

    model = sim.model
    fl, dims, amg = model.faces, model.op_dims, sim.solver.amg
    nc, dev = model.nc, sys.diag.device
    nfl = fl.n
    rng = np.random.default_rng(seed + 5)
    extra = {}

    def rnd(*shape):
        return torch.as_tensor(rng.standard_normal(shape), device=dev)

    def chk(name, tol, pairs, how=scaled_err):
        for a, b in pairs:
            K.note(name, float((a - b).abs().max()) if b.numel() else 0.0)
            e = how(a, b)
            if not e <= tol:
                fail(f"{label}: {name} differs from its plain version "
                     f"({e:.3e} > {tol:g})")

    def timing(name, kfn, pfn, ins, outs, flops, lib=None):
        K.ms[name] = cuda_ms(kfn)
        K.plain_ms[name] = cuda_ms(pfn)
        K.library_ms[name] = cuda_ms(lib) if lib is not None else None
        K.bound(name, ins, outs, flops)

    csr = (fl.full.ptr, fl.full.ent, fl.full.nbr)
    # K3-faces on the state's cell quantities
    q = model.cell_quantities(state)
    p3 = torch.stack([q.pw, q.po, q.pg]).contiguous()
    fargs = (p3, q.rho.contiguous(), (q.b * q.mob).contiguous(),
             q.rs.contiguous(), q.rv.contiguous(), model.depth, model.trans,
             model.gravity)
    base = None
    if dims is not None:
        base = mb.tpfa_div_cuda(dims, *fargs[:6], model.trans_stencil,
                                model.gravity)
        pbase = mb.tpfa_div_plain(dims, *fargs[:6], model.trans_stencil,
                                  model.gravity)
        K.note("K3 tpfa_div", float((base - pbase).abs().max()))
        if not torch.equal(base, pbase):
            fail(f"{label}: K3 tpfa_div over the stencil is not bit for "
                 "bit its plain version's")
        del pbase
    kd = mb.faces_div_cuda(fl, *fargs,
                           out=None if base is None else base.clone())
    # bit for bit the twin on CPU copies (on the card its index_add_ adds
    # in no fixed order)
    fl_cpu = mb.FaceList(sim.grid.face_cells, nc, fl.first, "cpu")
    pd = mb.faces_div_plain(
        fl_cpu, *[t.cpu() if torch.is_tensor(t) else t for t in fargs],
        out=None if base is None else base.cpu())
    K.note("K3-faces faces_div", float((kd.cpu() - pd).abs().max()))
    if not torch.equal(kd.cpu(), pd):
        fail(f"{label}: K3-faces faces_div is not bit for bit its plain "
             f"version's on CPU copies ({scaled_err(kd.cpu(), pd):.3e} of "
             "max|div|)")
    del fl_cpu, pd
    ops = (sys.diag, sys.face_L, sys.face_R)
    x = rnd(3, nc)
    xp = rnd(nc)
    r = rnd(3, nc)
    dinv, w, diag_p, off = k6.cpr_setup_plain(*ops, dims, fl)
    # K4-faces: the system's copy (written by the assembly's face blocks),
    # the plain product and the fused smoothing step
    op, sell = sys.packed, fl.sell
    pblk = k4.faces_pack_plain(sell, sys.face_L, sys.face_R)
    K.note("K3-faces face_blocks", float((op.blk - pblk).abs().max()))
    if not torch.equal(op.blk, pblk):
        fail(f"{label}: K4-faces' copy in the system (the face blocks') is "
             "not bit for bit the pack's twin")
    del pblk
    kb = None if dims is None else k4.matvec_cells_cuda(*ops, x, dims)
    ky = k4.faces_matvec_cuda(op, x, None if kb is None else kb.clone())
    py = k4.faces_matvec_plain(fl, *ops, x, kb)
    chk("K4-faces matvec", TOL_K4, [(ky, py)])
    if kb is not None:
        # on the embedded grid also a thread per cell, from the diagonal
        chk("K4-faces matvec", TOL_K4, [(k4.faces_matvec_cuda(op, x),
                                         k4.faces_matvec_plain(fl, *ops,
                                                               x))])
    for xx in (xp, x):
        bb = None if dims is None else k4.matvec_cells_cuda(*ops, xx, dims)
        chk("K4-faces smooth", TOL_K4, [
            (k4.faces_smooth_cuda(op, dinv, xx, r, bb),
             k4.faces_smooth_plain(fl, *ops, dinv, xx, r, bb))])
    n_ent = fl.full.ent.numel()
    extra["sell"] = dict(rows=sell.n_rows, chunks=sell.n_chunks,
                         entries=n_ent,
                         pad_share=1.0 - n_ent / (32 * sell.n_chunks))
    if timed and dims is not None:
        eb = base.clone()
        extra["epilogue_ms"] = dict(
            faces_div=cuda_ms(lambda: mb.faces_div_cuda(
                fl, *fargs, out=base.clone())),
            # in place on one buffer: per launch in a run of 50
            faces_div_run=run_ms(lambda: mb.faces_div_cuda(fl, *fargs,
                                                           out=eb)),
            faces_matvec=cuda_ms(lambda: k4.faces_matvec_cuda(
                op, x, kb.clone())),
            faces_smooth=cuda_ms(lambda: k4.faces_smooth_cuda(
                op, dinv, x, r, kb)),
            clone=cuda_ms(lambda: kb.clone()))
    elif timed:
        nb = (fargs[:6], model.trans, csr, kd)
        timing("K3-faces faces_div",
               lambda: mb.faces_div_cuda(fl, *fargs),
               lambda: mb.faces_div_plain(fl, *fargs), nb, (), 80 * nfl)
        K.run_ms["K3-faces faces_div"] = run_ms(
            lambda: mb.faces_div_cuda(fl, *fargs))
        A = csr_of_blocks(sys)
        xv = x.reshape(-1, 1)
        if not scaled_err((A @ xv).reshape(3, nc), py) <= 1e-12:
            fail(f"{label}: the CSR yardstick of K4-faces disagrees")
        timing("K4-faces matvec",
               lambda: k4.faces_matvec_cuda(op, x),
               lambda: k4.faces_matvec_plain(fl, *ops, x),
               (ops, x, csr), ky, 18 * nc + 36 * nfl, lambda: A @ xv)
        del A, xv
        timing("K4-faces smooth",
               lambda: k4.faces_smooth_cuda(op, dinv, x, r),
               lambda: k4.faces_smooth_plain(fl, *ops, dinv, x, r),
               (ops, dinv, x, r, csr), ky, 18 * nc + 36 * nfl + 24 * nc)
        extra["faces_csr_entries"] = n_ent

    # K6: the cell part and K6-faces (gather), or the stencil setup
    if dims is None:
        kc = k6.cpr_setup_cells_cuda(sys.diag)
        chk("K6 cpr_setup_cells", TOL_K6_SETUP,
            zip(kc, (dinv, w, diag_p)))
        ko = k6.cpr_faces_cuda(fl, w, sys.face_L, sys.face_R)
        chk("K6-faces cpr_faces", TOL_K6_SETUP, [(ko, off)])
        extra["k6_fused"] = compare_k6_fused(K, amg, sys, label, timed)
        if timed:
            timing("K6 cpr_setup_cells",
                   lambda: k6.cpr_setup_cells_cuda(sys.diag),
                   lambda: k6.cpr_setup_cells_plain(sys.diag),
                   sys.diag, kc, 60 * nc)
            timing("K6-faces cpr_faces",
                   lambda: k6.cpr_faces_cuda(fl, w, sys.face_L, sys.face_R),
                   lambda: k6.cpr_faces_plain(fl, w, sys.face_L,
                                              sys.face_R),
                   (w, sys.face_L[0::3], sys.face_R[0::3], fl.c1_32,
                    fl.c2_32), ko, 12 * nfl)
    else:
        ks = k6.cpr_setup_cuda(*ops, dims)
        ps = (dinv, w, diag_p, k6._pressure_off_for(amg, off, dims))
        chk("K6 cpr_setup", TOL_K6_SETUP, zip(ks, ps))
    # K9 at the run's shapes and on its state: the update over the cell
    # axis (the embedded grid's padded one, inert cells with pv = 0
    # included), the convergence check masked on the embedded grid and
    # unmasked on the gather grid (timed: the masked row only; the
    # unmasked row's times are SPE10-2's)
    masked = model.conv_mask is not None
    extra["k9"] = compare_k9(
        K, model, state, q, seed, label,
        ("K9 convergence_masked",) if timed and masked else ())

    if isinstance(amg, k10.DeviceAmg):
        extra["refresh"] = compare_refresh(K, amg, diag_p, off, label,
                                           timed, rng)
        vk = amg.refresh.vals
        d, ev = vk[0]
        extra["level0"] = dict(n=d.shape[0], K=ev.shape[0],
                               nnz=int(off.numel()))
        if timed:
            A0 = csr_of_level(d, ev, amg.levels[0]["cols"])
            xb = rnd(d.shape[0])
            extra["level0_spmv_csr_ms"] = cuda_ms(
                lambda: A0 @ xb.reshape(-1, 1))
            del A0
        extra["vcycle"] = compare_vcycle(K, k10, amg, vk, rnd(nc), label,
                                         TOL_K10_VCYCLE, timed,
                                         (w.contiguous(), rnd(3, nc)))
        extra["widths"] = [int(v[1].shape[0]) for v in vk[:amg.n_levels]]
        extra["sizes"] = [int(v[0].shape[0]) for v in vk[:amg.n_levels]]
        if timed:
            extra.update(
                coarsen_values_ms=cuda_ms(
                    lambda: amg.coarsen_values(diag_p, off)),
                coarsen_values_plain_ms=cuda_ms(
                    lambda: amg.coarsen_values(diag_p, off, twin=True)))
    else:
        # K7 on the embedded grid's hierarchy (its stencil faces)
        off_s = k6._pressure_off_for(amg, off, dims)
        extra["refresh"] = compare_k7_refresh(K, amg, diag_p, off_s, label,
                                              False, rng)
        vals = amg.coarsen_values(diag_p, off_s)
        extra["vcycle"] = compare_vcycle(K, k7, amg, vals, rnd(nc), label,
                                         TOL_K7, timed,
                                         (w.contiguous(), rnd(3, nc)),
                                         record=False)
    torch.cuda.synchronize()
    return extra


def norne_first_step(K, sim, ref, label, names):
    """The first report step of ``sim`` on the card from its initial state,
    held to the JAX package's run of the same representation (``ref``),
    with the launch counters of ``names`` and the sections read over the
    run."""
    import torch

    from opm_tpu_torch.sim.init import initial_state

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st0 = initial_state(sim.grid, sim.props, sim.case, len(sim.well_names))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    sim.solver.timing = {}
    K.reset()
    with plain_inv4x4_on_card() as plain_inv:
        res = run_vs_fixture(sim, ref, f"{label} first report step (5 d)",
                             state=st0, report_step_limit=1)
    K.read(names)
    counts = {e[0]: e[4].launches for e in K.entries}
    rep = sim.report
    row = sim.summary.rows[-1]
    res.update(
        initial_state_s=t_init, residual_s=rep.assemble_time,
        sections_s=dict(sim.solver.timing), launches_all=counts,
        launches_per_newton={n: c / max(rep.newton_iterations, 1)
                             for n, c in counts.items() if c},
        FPR=row["FPR"], FOPR=row["FOPR"], FWPR=row["FWPR"],
        FGOR=row["FGOR"])
    log(f"  initial_state {t_init:.2f} s; FPR {row['FPR'] / 1e5:.4f} bar, "
        f"FOPR {row['FOPR'] * 86400.0:.3f} m3/d")
    log("  sections (s, synced): " + ", ".join(
        f"{k}={v:.2f}" for k, v in res["sections_s"].items())
        + f", residual+convergence={rep.assemble_time:.2f}")
    log("  launches: " + ", ".join(f"{n}={c}" for n, c in counts.items()
                                   if c))
    check_k8_launches(counts, rep, label)
    check_vcycle_launches(counts, rep, label, sim.solver.amg)
    check_k9_launches(counts, rep, label)
    res["pressure_setup_launches_per_newton"] = check_refresh_launches(
        counts, rep, label, sim.solver.amg, plain_inv[0])
    res["launches_per_reduced_matvec"] = check_reduced_launches(
        counts, label, sim.model)
    check_copy_launches(counts, rep, label)
    return res


def check_copy_launches(counts, rep, label):
    """K4-faces' copy of each Newton system written by the face blocks'
    row phase: one face-block launch a Newton, and no other launch writes
    it (the operator takes only that copy)."""
    if counts["K3-faces face_blocks"] != rep.newton_iterations:
        fail(f"{label}: {counts['K3-faces face_blocks']} face blocks' row "
             f"phases writing K4-faces' copy in {rep.newton_iterations} "
             "Newton systems")


def toy_run(K, sim, ref, label, names):
    """run_vs_fixture for a toy deck, with the synced sections and the
    launch counters over the run; fails if a kernel of ``names`` (the
    assembly's) was not launched."""
    sim.solver.timing = {}
    K.reset()
    with plain_inv4x4_on_card() as plain_inv:
        res = run_vs_fixture(sim, ref, label)
    check_k8_launches({e[0]: e[4].launches for e in K.entries},
                      sim.report, label)
    check_vcycle_launches({e[0]: e[4].launches for e in K.entries},
                          sim.report, label, sim.solver.amg)
    check_k9_launches({e[0]: e[4].launches for e in K.entries},
                      sim.report, label)
    check_refresh_launches({e[0]: e[4].launches for e in K.entries},
                           sim.report, label, sim.solver.amg, plain_inv[0])
    per = check_reduced_launches({e[0]: e[4].launches for e in K.entries},
                                 label, sim.model)
    if sim.model.faces is not None:
        check_copy_launches({e[0]: e[4].launches for e in K.entries},
                            sim.report, label)
    counts = {e[0]: e[4].launches for e in K.entries if e[0] in names}
    res.update(sections_s=dict(sim.solver.timing), launches=counts,
               launches_per_reduced_matvec=per)
    log("  sections (s, synced): " + ", ".join(
        f"{k}={v:.2f}" for k, v in res["sections_s"].items()))
    log("  launches: " + ", ".join(f"{n}={c}" for n, c in counts.items()))
    dead = [n for n in names if counts.get(n, 0) <= 0]
    if dead:
        fail(f"{label}: kernels not launched: {dead}")
    return res


# ---------------------------------------------------------------------------
# 4b: SPE3, the gas-condensate deck (wet gas, VAPOIL, RVVD/PDVD)

# the cells of SPE10 model 2 (60 x 220 x 85): the wet-gas kernels' checks
# and times at the main path's widest cell count, with SPE3's tables
N_WIDE = 60 * 220 * 85


def seeded_wet_state(props, n, seed, dev):
    """(p, sw, x, hcstate) of n cells made from the seed with numpy for
    SPE3's tables: every hydrocarbon state, pressures across PVTG's records
    and beyond its ends, rv below rv_sat and, in every tenth GASONLY cell,
    at it (drv = 0)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    hc = rng.integers(0, 3, n).astype(np.int32)
    p = rng.uniform(2.0e6, 2.8e7, n)
    sw = rng.uniform(0.16, 0.3, n)
    rvs = props.rv_sat(torch.as_tensor(p, device=dev), 0).cpu().numpy()
    rv = np.where(np.arange(n) % 10 == 0, rvs, rvs * rng.uniform(0.3, 1.0, n))
    x = np.where(hc == 0, rng.uniform(0.0, 0.8, n),
                 np.where(hc == 1, rng.uniform(0.0, 50.0, n), rv))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return t(p), t(sw), t(x), t(hc)


def compare_wet_k2(K, props, n, seed, dev, label, timed):
    """K2's three entries with SPE3's tables (PVTG's gas, rv = rv_sat under
    VAPOIL) against their plain versions on the card at n seeded cells:
    the values and the assembly's face inputs and r_cell bit for bit, the
    tangent columns and the diag within TOL_K2_TAN of each row's max; with
    ``timed`` their wet-gas rows' times and bounds."""
    import torch

    from opm_tpu_torch.models import blackoil as mb
    pack = props.cell_pack()
    p, sw, x, hc = seeded_wet_state(props, n, seed, dev)
    reg = torch.zeros(n, dtype=torch.int64, device=dev)
    a2 = (p, sw, x, hc, reg, reg)
    kq, pq = mb.cells_values_cuda(pack, *a2), mb.cells_values_plain(props,
                                                                    *a2)
    K.note("K2 cells_values wet gas", float((kq - pq).abs().max()))
    if not torch.equal(kq, pq):
        fail(f"{label}: K2 cells_values with wet gas are not bit for bit "
             f"the plain version's ({rel_err(kq, pq):.3e})")
    kc, pc = mb.cells_columns_cuda(pack, *a2), mb.cells_columns_plain(props,
                                                                      *a2)
    K.note("K2 cells_columns wet gas", float((kc - pc).abs().max()))
    e = row_scaled_err(kc, pc)
    if not e <= TOL_K2_TAN:
        fail(f"{label}: K2 cells_columns with wet gas off by {e:.3e} of a "
             f"row's max (> {TOL_K2_TAN:g})")
    rng = torch.Generator(device="cpu").manual_seed(seed)
    acc0 = torch.rand((3, n), generator=rng, dtype=torch.float64).to(dev)
    pv = torch.rand(n, generator=rng, dtype=torch.float64).to(dev) * 1e3
    a3 = a2 + (acc0, pv, 86400.0)
    ka, pa = mb.cells_assemble_cuda(pack, *a3), mb.cells_assemble_plain(
        props, *a3)
    K.note("K2 cells_assemble wet gas",
           max(float((a - b).abs().max()) for a, b in zip(ka, pa)))
    if not (torch.equal(ka[0], pa[0]) and torch.equal(ka[2], pa[2])):
        fail(f"{label}: K2 cells_assemble's face inputs or r_cell with wet "
             "gas are not bit for bit the plain version's")
    for a, b in (ka[1], pa[1]), (ka[3], pa[3]):
        e = row_scaled_err(a, b)
        if not e <= TOL_K2_TAN:
            fail(f"{label}: K2 cells_assemble with wet gas off by {e:.3e} "
                 f"of a row's max (> {TOL_K2_TAN:g})")
    if timed:
        ins = (a2[:3], hc, reg, reg, pack.tab)
        for name, kfn, pfn, outs, more in (
                ("K2 cells_values wet gas",
                 lambda: mb.cells_values_cuda(pack, *a2),
                 lambda: mb.cells_values_plain(props, *a2), kq, ()),
                ("K2 cells_columns wet gas",
                 lambda: mb.cells_columns_cuda(pack, *a2),
                 lambda: mb.cells_columns_plain(props, *a2), kc, ()),
                ("K2 cells_assemble wet gas",
                 lambda: mb.cells_assemble_cuda(pack, *a3),
                 lambda: mb.cells_assemble_plain(props, *a3), ka,
                 (acc0, pv))):
            K.ms[name] = cuda_ms(kfn)
            K.plain_ms[name] = cuda_ms(pfn)
            K.run_ms[name] = run_ms(kfn)
            K.library_ms[name] = None
            K.bound_instr(name, nbytes(ins, more, outs),
                          K.sass["cells"][K.K2_KERNELS[name]] * n)
    torch.cuda.synchronize()


def compare_wet_k9(K, props, n, seed, dev, label, timed):
    """K9's update under VAPOIL (rv_sat of PVTG at the old and the new
    pressure) bit for bit against its twins' composition at n seeded cells
    in GASOIL and GASONLY: GASOIL cells near so = 0 and GASONLY cells at
    rv_sat, increments that switch cells both ways; with ``timed`` the
    VAPOIL row's times and bound. Returns the switches (GASOIL -> GASONLY,
    GASONLY -> GASOIL)."""
    import numpy as np
    import torch

    from opm_tpu_torch.solver import kernels_k9 as k9
    rng = np.random.default_rng(seed + 3)
    p = rng.uniform(1.2e7, 2.4e7, n)
    hc = np.where(rng.random(n) < 0.5, 0, 2).astype(np.int32)
    sw = np.full(n, 0.16)
    rvs = props.rv_sat(torch.as_tensor(p, device=dev), 0).cpu().numpy()
    x = np.where(hc == 0, 0.84 - rng.uniform(0.0, 1e-3, n),
                 np.where(rng.random(n) < 0.5, rvs, rvs * 0.99))
    du = np.stack([rng.uniform(-1e6, 2e6, n), np.zeros(n),
                   np.where(hc == 0, -rng.uniform(0.0, 2e-3, n),
                            rng.standard_normal(n) * 1e-8)])
    nw = 2

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    consts = k9.UpdateConsts(0.3, 0.2, 1e9, bool(props.disgas),
                             bool(props.vapoil))
    rv = k9.rv_table(props, None)
    if rv is None:
        fail(f"{label}: no rv_sat table for K9 (VAPOIL and PVTG expected)")
    du_w = t(rng.standard_normal((nw, 4)) * np.array([1e-3] * 3 + [1e6]))
    a = (t(p), t(sw), t(x), t(hc), t(rng.uniform(1e7, 2e7, nw)),
         t(rng.standard_normal((nw, 3))), t(du), du_w[:, 3], du_w[:, :3],
         0.9, consts, k9.rs_table(props, None), rv)
    ku, pu = k9.update_cuda(*a), k9.update_plain(*a)
    for nm, x_, y_ in zip(("p", "sw", "x", "hcstate", "bhp", "qs"), ku, pu):
        K.note("K9 update VAPOIL", float((x_.double() - y_.double())
                                         .abs().max()))
        if x_.dtype == torch.float64:
            x_, y_ = x_.view(torch.int64), y_.view(torch.int64)
        if not torch.equal(x_, y_):
            fail(f"{label}: K9 update with VAPOIL: {nm} is not bit for bit "
                 "its twins' composition")
    h0, h1 = a[3], ku[3]
    sw_ = (int(((h0 == 0) & (h1 == 2)).sum()), int(((h0 == 2) & (h1 == 0))
                                                  .sum()))
    if min(sw_) <= 0:
        fail(f"{label}: the seeded update switched {sw_} cells (GASOIL -> "
             "GASONLY, GASONLY -> GASOIL); both directions wanted")
    if timed:
        name = "K9 update VAPOIL"
        K.ms[name] = cuda_ms(lambda: k9.update_cuda(*a))
        K.plain_ms[name] = cuda_ms(lambda: k9.update_plain(*a))
        K.run_ms[name] = run_ms(lambda: k9.update_cuda(*a))
        K.library_ms[name] = None
        K.bound(name, a[:4] + (a[6],), ku[:4], 80 * n)
    torch.cuda.synchronize()
    return sw_


def compare_wet_equil_cells(K, sims, n, seed, dev, timed):
    """EQUIL's cell pass with RVVD and with PDVD over n seeded cells (the
    depths of SPE3's column, one PVT and SAT region) from the kernel's
    columns of each deck's region, into arrays of NaN: bit for bit its twin
    on the card; with ``timed`` the RVVD and PDVD rows' times and
    bounds."""
    import numpy as np
    import torch

    from opm_tpu_torch.sim import init as equil
    rng = np.random.default_rng(seed + 4)
    for vmode, sim in sims.items():
        rec, cells, vd = equil.equil_regions(sim.grid, sim.case)[0]
        args = equil.march_args(sim.grid, sim.props, rec, cells, **vd)
        if args[8] != vmode:
            fail(f"SPE3 {vmode}: the region's column is {args[8]}")
        cols = equil.equil_columns_cuda(*args)
        z = args[1].cpu().numpy()
        depth = torch.as_tensor(rng.uniform(z[1], z[-2], n), device=dev)
        zero = torch.zeros(n, dtype=torch.int32, device=dev)
        cd = (depth, zero, zero)
        ti = torch.arange(n, dtype=torch.int32, device=dev)
        kout = torch.full((5, n), float("nan"), dtype=torch.float64,
                          device=dev)
        pout = kout.clone()
        equil.equil_cells_cuda(args, cols, ti, cd, kout)
        equil.equil_cells_plain(args, cols, ti, cd, pout)
        name = f"K1 equil_cells {vmode.upper()}"
        K.note(name, float((kout - pout).abs().max()))
        if not torch.equal(kout, pout):
            fail(f"SPE3 {vmode} at {n} cells: the cell pass differs from "
                 "its twin on the card")
        if not bool((kout[4] > 0).all()):
            fail(f"SPE3 {vmode}: the cell pass left rv <= 0")
        if timed:
            def fn():
                equil.equil_cells_cuda(args, cols, ti, cd, kout)
            K.ms[name] = cuda_ms(fn)
            K.plain_ms[name] = cuda_ms(lambda: equil.equil_cells_plain(
                args, cols, ti, cd, pout))
            K.run_ms[name] = run_ms(fn)
            K.library_ms[name] = None
            K.bound_raw(name, *equil_cells_work(args, n))
    torch.cuda.synchronize()


def spe3_kernels(K, dev, seed, results):
    """Phase 4b's kernel checks: SPE3's EQUIL (RVVD, and PDVD in its place)
    bit for bit, K2's entries and K9 with wet gas at SPE3's 324 cells and at
    1.122M seeded cells with SPE3's tables (timed there), and SPE3's first
    dense Jacobian through K2's and K3's forward-mode rules against the
    plain CPU path. Returns the two simulators (RVVD, PDVD)."""
    from opm_tpu_torch.io.eclstate import load_case_string
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.sim.testcases import spe3_pdvd_deck
    with open(os.path.join(ROOT, "data", "SPE3.DATA")) as f:
        text = f.read()
    cases = {"rvvd": load_case_string(text),
             "pdvd": load_case_string(spe3_pdvd_deck(text))}
    sims = {k: SimulatorFullyImplicitBlackoil(c) for k, c in cases.items()}
    eq = results.setdefault("equil", {})
    _, eq["SPE3"] = check_equil(K, "SPE3", sims["rvvd"],
                                march_row="K1 equil_march wet gas")
    _, eq["SPE3 PDVD"] = check_equil(K, "SPE3 PDVD", sims["pdvd"])
    props = sims["rvvd"].props
    out = {}
    for n, label, timed in ((sims["rvvd"].model.nc, "SPE3", False),
                            (N_WIDE, "SPE3 tables at 1.122M cells", True)):
        compare_wet_k2(K, props, n, seed, dev, label, timed)
        out[f"k9_switches_{n}"] = compare_wet_k9(K, props, n, seed, dev,
                                                 label, timed)
        compare_wet_equil_cells(K, sims, n, seed, dev, timed)
        log(f"{label}: K2's entries, K9's update (switched GASOIL -> "
            f"GASONLY, GASONLY -> GASOIL: {out[f'k9_switches_{n}']}) and "
            "EQUIL's cell pass with RVVD and PDVD == plain on the card: ok")
    ejac, n_tan, n_col = compare_jacobian(cases["rvvd"], dev, "SPE3")
    out["jacobian_rel"] = ejac
    log(f"SPE3 Jacobian (jacfwd through K2's and K3's forward-mode rules; "
        f"K2 column launches: {n_col}, K3 tangent launches: {n_tan}) vs "
        f"the plain CPU path: {ejac:.3e} of max|J|")
    if not ejac <= TOL_JAC or n_tan < 1 or n_col < 1:
        fail(f"SPE3 Jacobian on the card off by {ejac:.3e} of max|J| "
             f"(> {TOL_JAC:g}) or not through K2 and K3")
    for name in ("K2 cells_values wet gas", "K2 cells_columns wet gas",
                 "K2 cells_assemble wet gas", "K9 update VAPOIL",
                 "K1 equil_cells RVVD", "K1 equil_cells PDVD"):
        log(f"  {name:26s} kernel {K.ms[name]:9.4f} ms   plain "
            f"{K.plain_ms[name]:9.4f} ms   bound {K.bound_ms[name]:8.4f} ms "
            f"({K.bound_by[name]})   per launch in a run of 50 "
            f"{K.run_ms[name]:.4f} ms   max_abs_err {K.err[name]:.3e}")
    results["spe3_kernels"] = out
    return sims


SPE3_LIMITS = dict(FPR=TOL_FPR, FOPR=TOL_RATE, FGPR=TOL_RATE,
                   FGIR=TOL_RATE)


def hold_spe3(series, refs):
    """SPE3's vectors (``series``: key -> one value a report step, SI) held
    to the fixture's report steps: within SPE3_LIMITS relative (a rate the
    reference has at 0: of that vector's maximum), or within the
    reference's own roundoff spread at that step. Returns (worst relative
    error per key, the values outside both, those beyond the limit but
    within the spread)."""
    scale = {k: max(abs(r[k]) for r in refs) for k in series}
    worst = {k: 0.0 for k in series}
    outside, in_spread = [], []
    for k, vals in series.items():
        for i, (v, r) in enumerate(zip(vals, refs)):
            e = (abs(v - r[k]) / abs(r[k]) if r[k] != 0.0
                 else abs(v) / scale[k])
            worst[k] = max(worst[k], e)
            if e > SPE3_LIMITS[k]:
                (in_spread if e <= r["spread"][k] else outside).append(
                    (i, k, e, r["spread"][k]))
    return worst, outside, in_spread


def spe3_run(K, ref):
    """SPE3's whole schedule (720 days: depletion, dry-gas reinjection,
    blowdown) on the card through SimulatorFullyImplicitBlackoil with no
    device argument, the launch counters of its kernels over the run
    (EQUIL's included), held per report step to the JAX package's CPU run
    (data/spe3_reference_cpu.json): substeps, Newtons and failed substeps
    equal, FPR within TOL_FPR, FOPR, FGPR and FGIR within TOL_RATE (a rate
    the reference has at 0 within TOL_RATE of that vector's maximum), or
    within the reference's own roundoff spread at that step where that is
    wider (the fixture's ``spread``: the reference's runs with one-ulp
    changes of sw and x after every Newton update depart from its own run
    by up to 1.7e-2 in FOPR; ROADMAP Queue 3); and
    the deck's own checks (tests/test_spe3.py): every cell GASONLY at t = 0
    with 0 < rv < rv_sat, condensate dropping out (GASOIL cells), and the
    gas balance (the fluid in place's decline against the produced less
    the injected gas) within 1e-3."""
    import numpy as np
    import torch

    from opm_tpu_torch.io.eclstate import load_case
    from opm_tpu_torch.sim.blackoil import (DAY,
                                            SimulatorFullyImplicitBlackoil,
                                            fluid_in_place)
    from opm_tpu_torch.sim.init import initial_state
    case = load_case(os.path.join(ROOT, "data", "SPE3.DATA"))
    sim = SimulatorFullyImplicitBlackoil(case)
    m = sim.model
    # the state at t = 0 and its fluid in place, for the deck's own checks
    st0 = initial_state(sim.grid, sim.props, case, len(sim.well_names))
    rvs0 = sim.props.rv_sat(st0.pressure, m.pvtnum)
    gasonly0 = bool((st0.hcstate == 2).all())
    rv_ok0 = bool(((st0.x > 0) & (st0.x < rvs0)).all())
    fip0 = fluid_in_place(m, st0)
    gasoil, failed = [], []
    sim.events.event("report_step_completed").add(
        lambda s, step: (gasoil.append(int((s.hcstate == 0).sum())),
                         failed.append(sim.report.failed_substeps)))
    K.reset()
    t0 = time.perf_counter()
    state = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {e[0]: e[4].launches for e in K.entries}
    # the wet-gas rows take this run's counts; the rows they share a
    # launch with (K3, K9's check) keep SPE1's
    K.launches.update({n: launches[n] for n in K.SPE3 if n in K.WET_GAS})
    failed = failed[1:] + [sim.report.failed_substeps]
    failed = [b - a for a, b in zip([0] + failed[:-1], failed)]
    rep, rows, steps = sim.report, sim.summary.rows, sim._step_timing
    refs = ref["report_steps"]
    if len(rows) != len(refs):
        fail(f"SPE3 ran {len(rows)} report steps, the reference "
             f"{len(refs)}")
    counts = [((s[3], s[4], f), (r["substeps"], r["newtons"], r["failed"]))
              for s, f, r in zip(steps, failed, refs)]
    off = [(k, c, rc) for k, (c, rc) in enumerate(counts) if c != rc]
    worst, outside, in_spread = hold_spe3(
        {k: [row[k] for row in rows] for k in SPE3_LIMITS}, refs)
    fip1 = fluid_in_place(m, state)
    t = np.array([r["time"] for r in rows]) * DAY
    dt = np.diff(np.concatenate([[0.0], t]))
    net = sum((r["FGPR"] - r["FGIR"]) * d for r, d in zip(rows, dt))
    gas_balance = abs(net - (fip0[2] - fip1[2])) / abs(fip0[2] - fip1[2])
    res = dict(wall_s=wall, newtons=rep.newton_iterations,
               substeps=rep.substeps, failed=rep.failed_substeps,
               worst_rel=worst, count_diffs=off, outside=outside,
               within_reference_spread=in_spread,
               gasoil_cells=gasoil, gas_balance_rel=gas_balance,
               launches={n: launches[n] for n in K.SPE3},
               launches_all=launches, digest=state_digest(state))
    log(f"SPE3 end to end on the card (720 days, {len(rows)} report steps, "
        f"dense route): {wall:.1f} s, {rep.newton_iterations} Newtons, "
        f"{rep.substeps} substeps, {rep.failed_substeps} failed "
        f"(reference {ref['total_newtons']} / {ref['total_substeps']} / "
        f"{ref['failed_substeps']})")
    log("  worst relative summary error: "
        + ", ".join(f"{k}={v:.2e}" for k, v in worst.items())
        + f"; gas balance {gas_balance:.2e}; GASOIL cells per step "
        f"{gasoil}")
    log("  launches: " + ", ".join(f"{n}={launches[n]}" for n in K.SPE3))
    if off:
        log(f"  report steps with other counts (index, port, ref): {off}")
    if in_spread:
        log("  beyond the limits but within the reference's own roundoff "
            f"spread (step, vector, rel, spread): {in_spread}")
    if outside:
        log("  summary values outside their limits and the reference's "
            f"spread (step, vector, rel, spread): {outside}")
    if not (gasonly0 and rv_ok0):
        fail("SPE3: the initial state is not all GASONLY with 0 < rv < "
             "rv_sat")
    if max(gasoil) <= 0:
        fail("SPE3: no condensate dropped out (no GASOIL cell)")
    if not gas_balance <= 1e-3:
        fail(f"SPE3: the gas balance is off by {gas_balance:.2e}")
    if off or outside:
        fail("SPE3: counts or summary vectors differ from the reference")
    dead = [n for n in K.SPE3 if launches[n] <= 0]
    if dead:
        fail(f"kernels not launched by the SPE3 run: {dead}")
    check_k9_launches(launches, rep, "SPE3")
    return res


# ---------------------------------------------------------------------------
# 4c: output and restart (the driver's files, resume on the card)

# the host syncs a report step's output may add on the card: one batched
# pull of the state with its derived arrays (the summary row's own pull is
# made with output off too)
OUTPUT_SYNCS = 1


def state_digest(state):
    """sha256 of a BlackoilState's arrays (their bytes on the host)."""
    import hashlib
    h = hashlib.sha256()
    for name in state._fields:
        t = getattr(state, name)
        if t is not None:
            h.update(name.encode())
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def host_state(state):
    """The state's arrays on the host (numpy), for the resume checks."""
    return {n: getattr(state, n).detach().cpu().numpy()
            for n in ("pressure", "sw", "x", "hcstate", "bhp")}


def file_series(base, unit_system, keys):
    """The UNSMRY's vectors ``keys`` read back with the port's reader,
    converted to SI (divided by the SMSPEC unit factor)."""
    from opm_tpu_torch.io import eclsum
    data = eclsum.read_summary(base)
    return {k: [v / eclsum._unit_for(k.split(":")[0], unit_system)[1]
                for v in data[k]] for k in keys}


def check_unsmry(sim, base, label):
    """The SMSPEC's keys are exactly the deck's requests plus TIME, and the
    UNSMRY's values the collector's rows at float32 rounding."""
    import numpy as np

    from opm_tpu_torch.io import eclsum
    data = eclsum.read_summary(base)
    keys = ["TIME"] + list(sim.summary.requested_keys)
    if list(data) != keys:
        fail(f"{label}: SMSPEC keys {list(data)}, the deck asks for {keys}")
    us = sim.case.runspec.unit_system
    off = []
    for k in keys[1:]:
        fac = eclsum._unit_for(k.split(":")[0], us)[1]
        want = np.float32([r[k] * fac for r in sim.summary.rows])
        if not np.array_equal(np.float32(data[k]), want):
            off.append(k)
    if off:
        fail(f"{label}: UNSMRY vectors other than the rows at float32 "
             f"rounding: {off}")
    return keys


def resume_checks(case, d, states, label):
    """SPE1 resumed on the card from restart_0003.npz and from the UNRST at
    step 3, and a crafted deck with RESTART 'SPE1CASE2' 3 / beside that
    UNRST, each run to the end of report step 5 and held to the
    uninterrupted run there: .npz pressure 4e-4 of the mean and sw 1e-4,
    UNRST and RESTART pressure 2e-3 relative, sw 2e-3, bhp 1e-3 (the JAX
    package's tests/test_restart.py limits), hcstate equal."""
    import numpy as np
    import torch

    from opm_tpu_torch.io.eclstate import load_case
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    a = states[5]
    out = {}
    with open(os.path.join(ROOT, "data", "SPE1CASE2.DATA")) as f:
        text = f.read().replace("SOLUTION",
                                "SOLUTION\nRESTART\n 'SPE1CASE2' 3 /\n", 1)
    deck = os.path.join(d, "SPE1RST.DATA")
    with open(deck, "w") as f:
        f.write(text)
    for kind, rcase, kw in (
            ("npz", case, dict(
                restart_file=os.path.join(d, "restart_0003.npz"))),
            ("UNRST", case, dict(
                restart_file=os.path.join(d, "SPE1CASE2.UNRST"),
                restart_step=3)),
            ("deck RESTART", load_case(deck), {})):
        sim = SimulatorFullyImplicitBlackoil(rcase)
        t0 = time.perf_counter()
        b = host_state(sim.run(report_step_limit=6, **kw))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = [s[0] for s in sim._step_timing]
        p_mean = float(np.abs(a["pressure"] - b["pressure"]).max()
                       / a["pressure"].mean())
        p_rel = float((np.abs(a["pressure"] - b["pressure"])
                       / np.maximum(np.abs(a["pressure"]), 1.0)).max())
        sw = float(np.abs(a["sw"] - b["sw"]).max())
        bhp = float((np.abs(a["bhp"] - b["bhp"]) / np.abs(a["bhp"])).max())
        hc = bool(np.array_equal(a["hcstate"], b["hcstate"]))
        out[kind] = dict(steps_run=ran, wall_s=wall, pressure_of_mean=p_mean,
                         pressure_rel=p_rel, sw=sw, bhp_rel=bhp,
                         hcstate_equal=hc)
        log(f"  {label} resumed from the {kind} at report step 3 on the "
            f"card: ran {ran} in {wall:.2f} s; pressure {p_rel:.2e} "
            f"relative ({p_mean:.2e} of the mean), sw {sw:.2e}, bhp "
            f"{bhp:.2e}, hcstate {'equal' if hc else 'DIFFERENT'}")
        ok = ran == [4, 5] and hc and (
            p_mean < 4e-4 and sw < 1e-4 if kind == "npz"
            else p_rel < 2e-3 and sw < 2e-3 and bhp < 1e-3)
        if not ok:
            fail(f"{label}: the resume from the {kind} is off the "
                 "uninterrupted run")
    return out


def spe1_regions_deck(text):
    """SPE1 with its three layers as FIPNUM regions and the region and
    block vectors asked for in its SUMMARY section."""
    return text.replace(
        "SOLUTION", "REGIONS\nFIPNUM\n 100*1 100*2 100*3 /\n\nSOLUTION",
        1).replace("SUMMARY", "SUMMARY\nRPR\n/\nROIP\n/\nRWIP\n 2 /\n"
                   "RGIP\n/\nBPR\n 1 1 1 /\n 10 10 3 /\n/", 1)


def region_check(text, d):
    """SPE1 with FIPNUM regions (``spe1_regions_deck``), two report steps
    on the card with output on: the region and block vectors in the
    SMSPEC, and the card's summary arrays of the final state (masked row
    sums over the regions, the block gathers) against the CPU's on a copy
    of that state, 1e-12 relative."""
    import numpy as np
    import torch

    from opm_tpu_torch.io import eclsum
    from opm_tpu_torch.io.eclstate import load_case_string
    from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                            summary_arrays)
    from opm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
    case = load_case_string(spe1_regions_deck(text))
    sim = SimulatorFullyImplicitBlackoil(case, output_dir=d)
    state = sim.run(report_step_limit=2)
    keys = check_unsmry(sim, os.path.join(d, sim._out_base()),
                        "SPE1 with regions")
    cpu = SimulatorFullyImplicitBlackoil(case, device="cpu")
    got = []
    for s_, st in ((sim, state),
                   (cpu, state_from_numpy(state_to_numpy(state), "cpu"))):
        masks, cells = s_.summary._spec_on(s_.model.device)
        qs, bhp, fpr, fip, (rpr, rfip), block = summary_arrays(
            s_.model, st, masks, cells)
        got.append([t.cpu().numpy() for t in (fpr, fip, rpr, rfip, block)])
    err = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
              for a, b in zip(*got))
    regional = [k for k in keys if k[0] in "RB"]
    log(f"SPE1 with FIPNUM regions, 2 report steps on the card with output "
        f"on: {len(regional)} region and block vectors in the SMSPEC; the "
        f"card's summary arrays against the CPU's on the same state "
        f"{err:.2e} relative")
    # RPR, ROIP, RGIP of three regions, RWIP of region 2, two BPR
    if len(regional) != 12 or not err <= 1e-12:
        fail("SPE1 with regions: region or block vectors missing, or off "
             "the CPU's")
    return dict(vectors=regional, rel_err_vs_cpu=err)


@contextlib.contextmanager
def output_probe():
    """Inside the block, each call of ``summary_arrays`` and
    ``output_arrays`` (the report step's summary and output arrays) records
    the devices of the tensors it takes and gives, and each
    ``SummaryCollector.record`` and ``_write_step_outputs`` of a simulator
    passed to ``probe.watch`` runs under the sync debug mode "warn",
    counting its host syncs and the K1 ``interp1`` and K2 ``cells_values``
    launches it makes. Yields the probe."""
    import warnings

    import torch

    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.sim import blackoil as bo
    from opm_tpu_torch.utils import tables as k1

    class Probe:
        def __init__(self):
            self.devices = set()
            self.calls = {"record": [], "output": []}

        def watch(self, sim):
            for key, obj, attr in (("record", sim.summary, "record"),
                                   ("output", sim, "_write_step_outputs")):
                setattr(obj, attr, self.counted(key, getattr(obj, attr)))

        def counted(self, key, fn):
            def wrapped(*a, **kw):
                n1, n2 = k1.interp1_cuda.launches, mb.cells_values_cuda.launches
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        out = fn(*a, **kw)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                self.calls[key].append(dict(
                    syncs=sum("synchroniz" in str(x.message) for x in w),
                    interp1=k1.interp1_cuda.launches - n1,
                    cells_values=mb.cells_values_cuda.launches - n2))
                return out
            return wrapped

    probe = Probe()

    def on_device(fn):
        def wrapped(model, state, *a, **kw):
            out = fn(model, state, *a, **kw)
            stack = [state, out]
            while stack:
                t = stack.pop()
                if isinstance(t, torch.Tensor):
                    probe.devices.add(t.device.type)
                elif isinstance(t, (tuple, list)):
                    stack.extend(t)
            return out
        return wrapped

    plain = bo.summary_arrays, bo.output_arrays
    bo.summary_arrays, bo.output_arrays = (on_device(f) for f in plain)
    try:
        yield probe
    finally:
        bo.summary_arrays, bo.output_arrays = plain


def output_phase(K, case1, ref1, off1, case3, ref3, off3):
    """Phase 4c: SPE1's whole schedule with output on (checkpoints, UNRST,
    VTK, Matlab) through SimulatorFullyImplicitBlackoil, held to the
    fixture and to the output-off run of phase 4 (counts, the final
    state's digest bit for bit), its wall beside that run's, the launch
    counters over it (K1 interp1's row of the kernels line takes its count:
    the report steps' rs_sat of the output); the SMSPEC's keys and the
    UNSMRY's values read back; the resumes on the card; the
    host syncs and K1/K2 launches of a report step's output over SPE1's
    first three report steps; SPE1 with FIPNUM regions (``region_check``);
    then SPE3's whole schedule with output on:
    the digest and counts of phase 4b's run, the UNRST's RV against the
    state's rv at every written step, FOPR and FGPR read back from the
    UNSMRY held to the fixture as phase 4b holds them (FGIR is not in
    SPE3's SUMMARY section: the rows hold it there)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from opm_tpu_torch.io import eclsum
    from opm_tpu_torch.models.state import rs_rv
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil

    res = {}
    d = tempfile.mkdtemp(prefix="chip_smoke_output_")
    try:
        # -- SPE1, the whole schedule ------------------------------------
        sim = SimulatorFullyImplicitBlackoil(case1, output_dir=d)
        states = {}
        sim.events.event("report_step_completed").add(
            lambda s, step: states.__setitem__(step.index, host_state(s))
            if step.index == 5 else None)
        K.reset()
        r1 = run_vs_fixture(sim, ref1, "SPE1 end to end, output on",
                            run_kw=dict(write_restart=True, write_vtk=True,
                                        write_matlab=True))
        launches = {e[0]: e[4].launches for e in K.entries}
        K.launches["K1 interp1"] = launches["K1 interp1"]
        counts = {k: (r1[k], off1[k]) for k in
                  ("newtons", "substeps", "failed", "linear")}
        base = os.path.join(d, sim._out_base())
        keys = check_unsmry(sim, base, "SPE1")
        lim = dict(FPR=TOL_FPR, FOPR=TOL_RATE, FGOR=TOL_RATE)
        series = file_series(base, "FIELD", list(lim))
        refs = ref1["report_steps"]
        worst = {k: max(abs(v - r[k]) / max(abs(r[k]), 1e-30)
                        for v, r in zip(series[k], refs)) for k in lim}
        files = sorted(os.listdir(d))
        ratio = r1["wall_s"] / off1["wall_s"]
        res["spe1"] = dict(
            wall_s=r1["wall_s"], wall_off_s=off1["wall_s"],
            wall_ratio=ratio, counts=counts,
            digest_equal=r1["digest"] == off1["digest"], smspec_keys=keys,
            file_worst_rel=worst, files=files, launches_all=launches)
        log(f"SPE1 with output on (checkpoints, UNRST, VTK, Matlab): "
            f"{r1['wall_s']:.2f} s against {off1['wall_s']:.2f} s with "
            f"output off (ratio {ratio:.3f}); counts (on, off) "
            f"{json.dumps(counts)}; final state's digest "
            f"{'equal' if r1['digest'] == off1['digest'] else 'DIFFERENT'}")
        log(f"  files: {files}")
        log("  launches: " + ", ".join(f"{n}={c}" for n, c in
                                       launches.items() if c))
        log("  read back from the UNSMRY against the fixture: "
            + ", ".join(f"{k}={v:.2e}" for k, v in worst.items()))
        if r1["digest"] != off1["digest"] or any(
                a != b for a, b in counts.values()):
            fail("SPE1: output on changed the simulation")
        if any(worst[k] > lim[k] for k in lim):
            fail("SPE1: the UNSMRY's vectors are off the fixture")
        if launches["K1 interp1"] < len(sim.summary.rows):
            fail("SPE1 with output on: K1 interp1 not launched by each "
                 "report step's output")
        res["spe1_resume"] = resume_checks(case1, d, states, "SPE1")
        shutil.rmtree(d)
        os.makedirs(d)
        with open(os.path.join(ROOT, "data", "SPE1CASE2.DATA")) as f:
            res["spe1_regions"] = region_check(f.read(), d)
        shutil.rmtree(d)
        os.makedirs(d)

        # -- the host syncs and launches of a report step's output -------
        with output_probe() as probe:
            sim = SimulatorFullyImplicitBlackoil(case1, output_dir=d)
            probe.watch(sim)
            sim.run(report_step_limit=3, write_restart=True, write_vtk=True,
                    write_matlab=True)
            torch.cuda.synchronize()
        rec, outp = probe.calls["record"], probe.calls["output"]
        res["syncs"] = dict(record=[c["syncs"] for c in rec],
                            output=[c["syncs"] for c in outp],
                            devices=sorted(probe.devices),
                            output_interp1=[c["interp1"] for c in outp],
                            record_cells_values=[c["cells_values"]
                                                 for c in rec])
        log(f"host syncs a report step on the card (SPE1, 3 report "
            f"steps): the summary row {res['syncs']['record']} (made with "
            f"output off too), the output {res['syncs']['output']} (at most "
            f"{OUTPUT_SYNCS}); K2 cells_values launches in the summary row "
            f"{res['syncs']['record_cells_values']}, K1 interp1 launches in "
            f"the output {res['syncs']['output_interp1']}; devices of the "
            f"summary and output arrays {sorted(probe.devices)}")
        if len(outp) != 3 or any(c["syncs"] > OUTPUT_SYNCS for c in outp) \
                or any(c["syncs"] > 1 for c in rec):
            fail("the report step's output made more host syncs than "
                 "counted")
        if any(c["interp1"] < 1 for c in outp) or any(
                c["cells_values"] < 1 for c in rec):
            fail("the report step's output did not launch K1 interp1 and "
                 "K2 cells_values")
        if probe.devices != {"cuda"}:
            fail(f"summary or output arrays on {sorted(probe.devices)}")
        shutil.rmtree(d)
        os.makedirs(d)

        # -- SPE3, the whole schedule -------------------------------------
        sim = SimulatorFullyImplicitBlackoil(case3, output_dir=d)
        # each report step's rv from its state on the card, and its GASONLY
        # cells' x (there rv is the primary variable)
        rv_steps = {}

        def keep_rv(s, step):
            rv = rs_rv(s, sim.props, sim.model.pvtnum)[1].cpu().numpy()
            gasonly = (s.hcstate == 2).cpu().numpy()
            rv_steps[step.index] = (rv, s.x.cpu().numpy()[gasonly], gasonly)

        sim.events.event("report_step_completed").add(keep_rv)
        t0 = time.perf_counter()
        end = sim.run(write_restart=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = sim.report
        c3 = (rep.newton_iterations, rep.substeps, rep.failed_substeps)
        base = os.path.join(d, sim._out_base())
        unrst = eclsum.read_unrst(base + ".UNRST")
        rv_off = []
        for u in unrst:
            rv, x_gasonly, gasonly = rv_steps[u["seqnum"]]
            if not (np.array_equal(u["RV"], rv)
                    and np.array_equal(u["RV"][gasonly], x_gasonly)):
                rv_off.append(u["seqnum"])
        keys = check_unsmry(sim, base, "SPE3")
        series = file_series(base, "FIELD", ["FOPR", "FGPR"])
        series["FPR"] = [r["FPR"] for r in sim.summary.rows]
        series["FGIR"] = [r["FGIR"] for r in sim.summary.rows]
        worst, outside, _ = hold_spe3(series, ref3["report_steps"])
        dig = state_digest(end)
        res["spe3"] = dict(wall_s=wall, wall_off_s=off3["wall_s"],
                           counts=c3, digest_equal=dig == off3["digest"],
                           unrst_steps=len(unrst), rv_steps_off=rv_off,
                           smspec_keys=keys, file_worst_rel=worst,
                           outside=outside)
        log(f"SPE3 with output on (checkpoints, UNRST): {wall:.2f} s "
            f"against {off3['wall_s']:.2f} s off; {c3[0]} / {c3[1]} / "
            f"{c3[2]}; digest "
            f"{'equal' if dig == off3['digest'] else 'DIFFERENT'}; UNRST RV "
            f"equal to the state's rv at {len(unrst) - len(rv_off)} of "
            f"{len(unrst)} steps; read back (FOPR, FGPR; FPR, FGIR from "
            f"the rows): " + ", ".join(f"{k}={v:.2e}"
                                       for k, v in worst.items()))
        if dig != off3["digest"] or c3 != (off3["newtons"],
                                           off3["substeps"],
                                           off3["failed"]):
            fail("SPE3: output on changed the simulation")
        if rv_off or len(unrst) != len(sim.summary.rows):
            fail(f"SPE3: UNRST RV off the state's rv at steps {rv_off}")
        if outside:
            fail(f"SPE3: vectors read back off the fixture: {outside}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return res


def norne_output_step(casen, knob, ref, off, label):
    """The Norne-class first report step in one representation with
    output on (UNRST, INIT, EGRID): the counts and final-state digest of
    the output-off run (phase 6), the fixture held by run_vs_fixture and
    by FPR/FOPR read back from the UNSMRY, and the files covering the real
    active cells only."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from opm_tpu_torch.io import eclsum
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.sim.init import initial_state
    d = tempfile.mkdtemp(prefix="chip_smoke_norne_")
    try:
        with embed_knob(knob):
            sim = SimulatorFullyImplicitBlackoil(casen, output_dir=d)
        st0 = initial_state(sim.grid, sim.props, sim.case,
                            len(sim.well_names))
        torch.cuda.synchronize()
        r = run_vs_fixture(sim, ref, f"{label} first report step, output "
                           "on", state=st0, report_step_limit=1,
                           run_kw=dict(write_restart=True))
        g = sim.grid
        base = os.path.join(d, sim._out_base())
        keys = check_unsmry(sim, base, label)
        series = file_series(base, sim.case.runspec.unit_system,
                                ["FPR", "FOPR"])
        r0 = ref["report_steps"][0]
        worst = {k: abs(series[k][0] - r0[k]) / abs(r0[k])
                 for k in series}
        u = eclsum.read_unrst(base + ".UNRST")
        init = eclsum.read_init(base + ".INIT")
        egrid = {n: v for n, _, v in eclsum.read_ecl_file(base + ".EGRID")}
        cover = dict(
            n_real=g.n_real, nc=g.nc, unrst=int(u[0]["PRESSURE"].size),
            init_cells=int(init["INTEHEAD"][11]),
            init_depth=int(init["DEPTH"].size),
            porv_nonzero=int(np.count_nonzero(init["PORV"])),
            egrid_active=int(np.count_nonzero(egrid["ACTNUM"])))
        counts = {k: (r[k], off[k]) for k in ("substeps", "newtons",
                                              "linear", "failed")}
        out = dict(wall_s=r["wall_s"], wall_off_s=off["wall_s"],
                   counts=counts, digest_equal=r["digest"] == off["digest"],
                   smspec_keys=keys, file_worst_rel=worst, cover=cover)
        log(f"  {label} with output on: {r['wall_s']:.2f} s (off "
            f"{off['wall_s']:.2f} s); counts (on, off) {json.dumps(counts)}"
            f"; digest {'equal' if out['digest_equal'] else 'DIFFERENT'}; "
            f"files cover {json.dumps(cover)}; read back: "
            + ", ".join(f"{k}={v:.2e}" for k, v in worst.items()))
        if not out["digest_equal"] or any(a != b for a, b in
                                          counts.values()):
            fail(f"{label}: output on changed the simulation")
        if {cover[k] for k in ("unrst", "init_cells", "init_depth",
                               "porv_nonzero", "egrid_active")} \
                != {g.n_real}:
            fail(f"{label}: the files do not cover the real active cells "
                 "only")
        if worst["FPR"] > TOL_FPR or worst["FOPR"] > TOL_RATE:
            fail(f"{label}: FPR/FOPR read back off the fixture")
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
def run_vs_fixture(sim, ref, label, state=None, report_step_limit=None,
                   run_kw=None):
    """Run ``sim`` (with ``run``'s output flags ``run_kw``) and hold each
    report step to the fixture: Newton and substep counts, 0 failed, linear
    iterations within TOL_LINEAR (when recorded), FPR / FOPR (/ FWPR, FGOR)
    within their limits. The result carries the final state's digest."""
    import torch

    lin = []
    sim.events.event("report_step_completed").add(
        lambda s, step: lin.append(sim.report.linear_iterations))
    t0 = time.perf_counter()
    end = sim.run(state, report_step_limit=report_step_limit,
                  **(run_kw or {}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lin = lin[1:] + [sim.report.linear_iterations]
    lin = [b - a for a, b in zip([0] + lin[:-1], lin)]
    rep = sim.report
    rows, steps = sim.summary.rows, sim._step_timing
    refs = ref["report_steps"][:len(rows)]
    diffs = [(s[0], (s[3], s[4]), (r["substeps"], r["newtons"]))
             for s, r in zip(steps, refs)
             if (s[3], s[4]) != (r["substeps"], r["newtons"])]
    keys = [k for k in ("FPR", "FOPR", "FWPR", "FGOR") if k in refs[0]]
    worst = {k: 0.0 for k in keys}
    for row, r in zip(rows, refs):
        for k in keys:
            worst[k] = max(worst[k], abs(row[k] - r[k])
                           / max(abs(r[k]), 1e-30))
    lin_off = [(s[0], li, r["linear"]) for s, li, r in zip(steps, lin, refs)
               if "linear" in r
               and abs(li - r["linear"]) > TOL_LINEAR * r["linear"]]
    log(f"{label} on the card: {wall:.1f} s, {rep.newton_iterations} "
        f"Newtons, {rep.substeps} substeps, {rep.failed_substeps} failed, "
        f"{rep.linear_iterations} linear iterations")
    log("  worst relative summary error: "
        + ", ".join(f"{k}={v:.2e}" for k, v in worst.items()))
    if diffs:
        log(f"  report steps with other counts (index, port, ref): {diffs}")
    if len(rows) != len(refs):
        fail(f"{label} ran {len(rows)} report steps, reference "
             f"{len(refs)}")
    if rep.failed_substeps != 0:
        fail(f"{label}: {rep.failed_substeps} failed substeps")
    if sum(s[3] for s in steps) != sum(r["substeps"] for r in refs):
        fail(f"{label}: substeps differ from the reference")
    total = sum(r["newtons"] for r in refs)
    if abs(rep.newton_iterations - total) > TOL_NEWTON_TOTAL * total:
        fail(f"{label}: Newton total more than 1% off the reference")
    if lin_off:
        fail(f"{label}: linear iterations off by more than 2%: {lin_off}")
    lim = dict(FPR=TOL_FPR, FOPR=TOL_RATE, FWPR=TOL_RATE, FGOR=TOL_RATE)
    if any(worst[k] > lim[k] for k in keys):
        fail(f"{label}: summary vectors outside tolerance")
    return dict(wall_s=wall, newtons=rep.newton_iterations,
                substeps=rep.substeps, failed=rep.failed_substeps,
                linear=rep.linear_iterations, linear_per_step=lin,
                newton_diffs=diffs, worst_rel=worst,
                digest=state_digest(end))


# ---------------------------------------------------------------------------
# 3e / 8: THPRES thresholds through K3, the well-control decks, the
# Norne-class field under field-style controls

class ThrCount:
    """A K3 wrapper's launches with a THPRES threshold (its
    ``thr_launches``), read and reset as a wrapper's ``launches``."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.thr_launches

    @launches.setter
    def launches(self, v):
        self.fn.thr_launches = v


def seeded_ties(dphi, seed):
    """(nf,) thresholds for faces with per-phase potentials dphi (3, nf),
    computed on a CPU copy as the twins compute them: a third 0, a third
    above every phase's |dphi|, the rest exactly one phase's |dphi| (the
    clip's tie)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    a = dphi.abs()
    nf = a.shape[1]
    kind = torch.as_tensor(rng.integers(0, 3, nf))
    tie = a[torch.as_tensor(rng.integers(0, 3, nf)), torch.arange(nf)]
    return torch.where(kind == 1, 1.5 * a.amax(dim=0) + 1.0,
                       torch.where(kind == 2, tie, 0.0))


def face_dphi(p3, rho, depth, c1, c2, g):
    """The faces' potentials (3, nf) on a CPU copy, as the twins compute
    them."""
    return (p3[:, c1] - p3[:, c2]) - 0.5 * (rho[:, c1] + rho[:, c2]) * g * (
        depth[c1] - depth[c2])


def stencil_faces(dims):
    """(c1, c2) of a structured grid's stencil faces in the grid's face
    order."""
    import numpy as np
    import torch

    from opm_tpu_torch.models.blackoil import _dir_segments
    nx, ny, nz = dims
    idx = np.arange(nx * ny * nz).reshape(nz, ny, nx)
    c1 = np.concatenate([idx[sl].ravel() for sl, _, _ in
                         _dir_segments(dims)])
    c2 = np.concatenate([idx[sr].ravel() for _, sr, _ in
                         _dir_segments(dims)])
    return torch.as_tensor(c1), torch.as_tensor(c2)


def thr_inputs(model, state, seed, faces=None):
    """K3's face inputs at ``state`` on the card and seeded thresholds over
    the model's faces (``faces``: a face list's (c1, c2), else the
    stencil's), with the count of ties."""
    import torch
    q = model.cell_quantities(state)
    p3 = torch.stack([q.pw, q.po, q.pg]).contiguous()
    rho, bmob = q.rho.contiguous(), (q.b * q.mob).contiguous()
    c1, c2 = faces if faces is not None else stencil_faces(model.dims)
    dphi = face_dphi(p3.cpu(), rho.cpu(), model.depth.cpu(), c1, c2,
                     model.gravity)
    thr = seeded_ties(dphi, seed)
    ties = int((dphi.abs() == thr[None, :]).any(dim=0).sum())
    return (p3, rho, bmob, q.rs.contiguous(), q.rv.contiguous()), \
        thr.to(model.device), ties


def compare_threshold_kernels(K, model, state, seed, label):
    """K3's structured entries with a THPRES threshold at SPE10-2's shapes
    (the divergence, the tangent at B = 3, the stencil face blocks) against
    their twins on the card, bit for bit, ties included; each timed per
    launch with and without the threshold, with its bound."""
    import numpy as np
    import torch

    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.models import linearize as lz
    dev = model.device
    (p3, rho, bmob, rs, rv), thr, ties = thr_inputs(model, state, seed)
    nf = thr.shape[0]
    args = (model.dims, p3, rho, bmob, rs, rv, model.depth, model.trans,
            model.gravity)
    out = dict(faces=nf, ties=ties, zero=int((thr == 0).sum()))
    if ties == 0:
        fail(f"{label}: no face on a threshold's tie")
    rng = np.random.default_rng(seed + 7)
    tan = [torch.as_tensor(rng.standard_normal((3,) + a.shape), device=dev)
           * a.abs().mean() for a in (p3, rho, bmob, rs, rv)]
    fv = torch.cat([p3, rho, bmob, rs[None], rv[None]]).contiguous()
    fc = torch.as_tensor(rng.standard_normal((3, 11, model.nc)), device=dev)
    r0 = torch.as_tensor(rng.standard_normal((3, model.nc)), device=dev)
    d0 = torch.as_tensor(rng.standard_normal((9, model.nc)), device=dev)
    nf_all = model.trans.shape[0]

    def blocks(fn, th):
        r, d = r0.clone(), d0.clone()
        fL = torch.zeros((9, nf_all), dtype=torch.float64, device=dev)
        fR = torch.zeros_like(fL)
        fn(model.dims, fv, fc, model.depth, model.trans, model.gravity, r,
           d, fL, fR, thr=th)
        return r, d, fL, fR

    cases = (
        ("K3 tpfa_div thr", lambda th: mb.tpfa_div_cuda(*args, thr=th),
         lambda th: mb.tpfa_div_plain(*args, thr=th), args[1:8],
         (3, model.nc), 80 * nf),
        ("K3 tpfa_div_tangent thr",
         lambda th: mb.tpfa_div_tangent_cuda(*args, *tan, thr=th),
         lambda th: mb.tpfa_div_tangent_plain(*args, *tan, thr=th),
         (args[1:8], tan), (3, 3, model.nc), 120 * nf * 3),
        ("K3 face_blocks thr",
         lambda th: blocks(lz.face_blocks_cuda, th),
         lambda th: blocks(lz.face_blocks_plain, th),
         (fv, fc, model.depth, model.trans, r0, d0),
         (2 * 9 * nf_all + 12 * model.nc,), 6 * 120 * nf))
    for name, kfn, pfn, ins, out_shape, flops in cases:
        k, p = kfn(thr), pfn(thr)
        k, p = (k,) if isinstance(k, torch.Tensor) else k, \
            (p,) if isinstance(p, torch.Tensor) else p
        for a, b in zip(k, p):
            K.note(name, float((a - b).abs().max()))
            if not torch.equal(a, b):
                fail(f"{label}: {name} is not bit for bit its twin's")
        K.ms[name] = cuda_ms(lambda: kfn(thr))
        K.plain_ms[name] = cuda_ms(lambda: pfn(thr))
        K.run_ms[name] = run_ms(lambda: kfn(thr))
        out[name] = dict(ms=K.ms[name], run_ms=K.run_ms[name],
                         ms_no_thr=cuda_ms(lambda: kfn(None)),
                         run_ms_no_thr=run_ms(lambda: kfn(None)),
                         plain_ms=K.plain_ms[name])
        nb = nbytes(ins, thr) + 8 * int(np.prod(out_shape))
        K.bound_raw(name, nb, flops)
        out[name]["bound_ms"] = K.bound_ms[name]
        log(f"  {name:26s} kernel {K.ms[name]:9.4f} ms (no threshold "
            f"{out[name]['ms_no_thr']:.4f})   per launch in a run of 50 "
            f"{K.run_ms[name]:.4f} (no threshold "
            f"{out[name]['run_ms_no_thr']:.4f})   plain "
            f"{K.plain_ms[name]:.4f}   bound {K.bound_ms[name]:.4f} "
            f"({K.bound_by[name]})")
    return out


def compare_threshold_faces(K, model, state, seed, label):
    """K3-faces' two entries with a THPRES threshold on a gather grid's face
    list against their twins on CPU copies, bit for bit, ties included;
    timed per launch with and without it, with the bound."""
    import numpy as np
    import torch

    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.models import linearize as lz
    dev = model.device
    fl = model.faces
    fl_cpu = mb.FaceList(model.grid.face_cells, model.nc, fl.first, "cpu")
    (p3, rho, bmob, rs, rv), thr, ties = thr_inputs(
        model, state, seed, (fl_cpu.c1, fl_cpu.c2))
    if ties == 0:
        fail(f"{label}: no face on a threshold's tie")
    a = (p3, rho, bmob, rs, rv, model.depth, model.trans)
    cpu = [x.cpu() for x in a]
    kd = mb.faces_div_cuda(fl, *a, model.gravity, thr=thr)
    pd = mb.faces_div_plain(fl_cpu, *cpu, model.gravity, thr=thr.cpu())
    K.note("K3-faces faces_div thr", float((kd.cpu() - pd).abs().max()))
    if not torch.equal(kd.cpu(), pd):
        fail(f"{label}: K3-faces faces_div with a threshold is not bit for "
             "bit its twin's")
    rng = np.random.default_rng(seed + 9)
    nc, nf = model.nc, model.trans.shape[0]
    fv = torch.cat([p3, rho, bmob, rs[None], rv[None]]).contiguous()
    fc = torch.as_tensor(rng.standard_normal((3, 11, nc)), device=dev)
    r0 = torch.as_tensor(rng.standard_normal((3, nc)), device=dev)
    d0 = torch.as_tensor(rng.standard_normal((9, nc)), device=dev)

    def fblocks(fn, lead, on, th):
        r, d = r0.to(on).clone(), d0.to(on).clone()
        fL = torch.zeros((9, nf), dtype=torch.float64, device=on)
        fR = torch.zeros_like(fL)
        blk = fn(lead, fv.to(on), fc.to(on), model.depth.to(on),
                 model.trans.to(on), model.gravity, r, d, fL, fR,
                 thr=None if th is None else th.to(on))
        return r, d, fL, fR, blk

    k = fblocks(lz.faces_blocks_cuda, fl, dev, thr)
    p = fblocks(lz.faces_blocks_packed_plain, fl_cpu, "cpu", thr)
    for x, y in zip(k, p):
        K.note("K3-faces face_blocks thr", float((x.cpu() - y).abs().max()))
        if not torch.equal(x.cpu(), y):
            fail(f"{label}: K3-faces face blocks with a threshold are not "
                 "bit for bit their twin's")
    out = dict(faces=fl.n, ties=ties, zero=int((thr == 0).sum()))
    for name, kfn, pfn, ins, nout, flops in (
            ("K3-faces faces_div thr",
             lambda th: mb.faces_div_cuda(fl, *a, model.gravity, thr=th),
             lambda th: mb.faces_div_plain(fl, *a, model.gravity, thr=th),
             (a, fl.full.ptr, fl.full.ent, fl.full.nbr), 3 * nc, 80 * fl.n),
            ("K3-faces face_blocks thr",
             lambda th: fblocks(lz.faces_blocks_cuda, fl, dev, th),
             lambda th: fblocks(lz.faces_blocks_packed_plain, fl, dev, th),
             (fv, fc, model.depth, model.trans, r0, d0, fl.c1_32, fl.c2_32),
             18 * fl.n + 12 * nc + 288 * fl.sell.n_chunks,
             6 * 120 * fl.n)):
        K.ms[name] = cuda_ms(lambda: kfn(thr))
        K.plain_ms[name] = cuda_ms(lambda: pfn(thr))
        K.run_ms[name] = run_ms(lambda: kfn(thr))
        out[name] = dict(ms=K.ms[name], run_ms=K.run_ms[name],
                         ms_no_thr=cuda_ms(lambda: kfn(None)),
                         run_ms_no_thr=run_ms(lambda: kfn(None)),
                         plain_ms=K.plain_ms[name])
        K.bound_raw(name, nbytes(ins, thr) + 8 * nout, flops)
        out[name]["bound_ms"] = K.bound_ms[name]
        log(f"  {name:26s} kernel {K.ms[name]:9.4f} ms (no threshold "
            f"{out[name]['ms_no_thr']:.4f})   per launch in a run of 50 "
            f"{K.run_ms[name]:.4f} (no threshold "
            f"{out[name]['run_ms_no_thr']:.4f})   plain "
            f"{K.plain_ms[name]:.4f}   bound {K.bound_ms[name]:.4f} "
            f"({K.bound_by[name]})")
    return out


# the limits of the field-control legs against their fixtures (relative)
CTRL_LIMITS = dict(FPR=TOL_FPR, FOPR=TOL_RATE, FWPR=TOL_RATE, FGOR=TOL_RATE,
                   WBHP=1e-4, WTHP=1e-3)


def hold_controls(label, sim, ctrl, runs, spread=None):
    """A field-controls run held per report step to its fixture: the
    reference's runs (its compiled run and, where recorded, its op-by-op
    one, whose summation orders part these decks by more than the limits)
    whose per-step counts equal the port's; against it every report step's
    FPR, FOPR, FWPR (these two of the field's liquid rate), FGOR, each
    well's WBHP and WTHP within CTRL_LIMITS and the same control code for
    every well; with ``spread`` (the reference's own roundoff spread per
    report step, as the nornewells fixture records it) a step's counts may
    also be those of the spread's runs and its values off by as much as
    the spread there, where that is wider than the limit. Returns the
    run's name and the worst relative errors (beyond the spread)."""
    steps = [[int(s[3]), int(s[4])] for s in sim._step_timing]

    def counts_ok(r):
        ref = [[x["substeps"], x["newtons"]] for x in r["report_steps"]]
        if spread is None:
            return steps == ref
        return len(steps) == len(ref) and all(
            st == rs or st in sp["counts"]
            for st, rs, sp in zip(steps, ref, spread))

    match = [m for m, r in runs.items() if counts_ok(r)]
    if not match:
        fail(f"{label}: report-step counts {steps} equal none of the "
             "reference's runs: " + "; ".join(
                 f"{m} {[[x['substeps'], x['newtons']] for x in r['report_steps']]}"
                 for m, r in runs.items()))
    best = None
    for m in match:
        ref = runs[m]["report_steps"]
        worst = {k: 0.0 for k in CTRL_LIMITS}
        raw = dict(worst)
        codes = ctrl == [x["control"] for x in ref]
        for j, (row, x) in enumerate(zip(sim.summary.rows, ref)):
            sp = spread[j] if spread is not None else None
            for k in ("FPR", "FOPR", "FWPR", "FGOR"):
                # the phase rates relative to the field's liquid rate (a
                # trickle of water is no measure of its own)
                scale = max(abs(x[k]), x["FOPR"] + x["FWPR"]) \
                    if k in ("FOPR", "FWPR") else abs(x[k])
                e = abs(row[k] - x[k]) / max(scale, 1e-30)
                raw[k] = max(raw[k], e)
                if sp is not None and e <= sp[k]:
                    e = 0.0
                worst[k] = max(worst[k], e)
            for k in ("WBHP", "WTHP"):
                for i, n in enumerate(sim.well_names):
                    v, w = row.get(f"{k}:{n}", 0.0), x[k][i]
                    e = abs(v - w) / abs(w) if w else abs(v)
                    raw[k] = max(raw[k], e)
                    if sp is not None and e <= sp[k][i]:
                        e = 0.0
                    worst[k] = max(worst[k], e)
        ok = codes and all(worst[k] <= CTRL_LIMITS[k] for k in worst)
        if best is None or ok:
            best = (m, worst, raw, codes, ok)
        if ok:
            break
    m, worst, raw, codes, ok = best
    log(f"  {label}: held to the reference's {m} run; worst relative "
        + ", ".join(f"{k}={v:.2e}" for k, v in raw.items())
        + ("" if spread is None else "; beyond the reference's roundoff "
           "spread: " + ", ".join(f"{k}={v:.2e}" for k, v in worst.items()))
        + f"; control codes {'equal' if codes else 'DIFFER'}")
    if not ok:
        fail(f"{label}: outside the fixture's limits or other control codes")
    return m, raw


def device_bytes(obj):
    """The bytes of the distinct CUDA storages that ``obj`` holds, through
    the attributes of the port's objects and through lists, tuples and
    dicts (the CPR hierarchy with its kernels' buffers, or the model)."""
    import torch

    seen, ptrs, stack = set(), {}, [obj]
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            if o.is_cuda:
                st = o.untyped_storage()
                ptrs[st.data_ptr()] = st.nbytes()
            continue
        if id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif type(o).__module__.startswith("opm_tpu_torch"):
            stack.extend(getattr(o, "__dict__", {}).values())
            stack.extend(getattr(o, k) for k in getattr(o, "__slots__", ())
                         if hasattr(o, k))
    return sum(ptrs.values())


@contextlib.contextmanager
def newton_host_reads():
    """Inside the block, the syncs of every Newton iteration's residual,
    convergence and control update (NonlinearSolver._assemble) and of every
    block assembly (linearize.assemble) are counted under the sync debug
    mode "warn", by the Python line that called the synchronizing operation
    (``sites``; host-to-device copies of constants count too); each
    Newton's one read of K9's row is outside them, in the loop. Yields the
    counters."""
    import warnings

    import torch

    from opm_tpu_torch.models import linearize as lz
    from opm_tpu_torch.solver import newton as nt

    counts = dict(calls=0, syncs=0, sites={})
    plain_asm, plain_lin = nt.NonlinearSolver._assemble, lz.assemble

    def counted(fn):
        def wrapped(*a, **kw):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = fn(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            for x in w:
                if "synchroniz" in str(x.message):
                    counts["syncs"] += 1
                    site = f"{os.path.basename(x.filename)}:{x.lineno}"
                    counts["sites"][site] = counts["sites"].get(site, 0) + 1
            counts["calls"] += fn is plain_asm
            return out
        return wrapped

    nt.NonlinearSolver._assemble = counted(plain_asm)
    lz.assemble = counted(plain_lin)
    try:
        yield counts
    finally:
        nt.NonlinearSolver._assemble = plain_asm
        lz.assemble = plain_lin


def wellctrl_phase(K):
    """Each deck of data/wellctrl_reference_cpu.json end to end on the card
    (dense route), held per report step to the fixture (hold_controls); the
    threshold entries' launches over the THPRES decks."""
    import torch

    from opm_tpu_torch.io.eclstate import load_case_string
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    with open(os.path.join(ROOT, "data", "wellctrl_reference_cpu.json")) as f:
        fx = json.load(f)
    out = {}
    K.reset()
    for name, d in fx["runs"].items():
        sim = SimulatorFullyImplicitBlackoil(load_case_string(d["deck"]))
        ctrl = []
        sim.events.event("report_step_completed").add(
            lambda s, step, c=ctrl: c.append(s.control.tolist()))
        t0 = time.perf_counter()
        with newton_host_reads() as hr:
            sim.run(report_step_limit=d["report_step_limit"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = sim.report
        log(f"wellctrl {name}: {wall:.2f} s, {rep.newton_iterations} "
            f"Newtons, {rep.substeps} substeps, {rep.failed_substeps} "
            f"failed; host syncs inside the Newton iterations' residual, "
            f"controls and assembly: {hr['syncs']} in {hr['calls']} "
            f"iterations at {hr['sites']}; report-step host work "
            f"{sim.host_work}")
        m, worst = hold_controls(f"wellctrl {name}", sim, ctrl, {
            k: v for k, v in d.items() if k in ("jit", "eager")})
        out[name] = dict(wall_s=wall, newtons=rep.newton_iterations,
                         substeps=rep.substeps,
                         failed=rep.failed_substeps, held_to=m,
                         worst_rel=worst, newton_syncs=hr["syncs"],
                         newton_calls=hr["calls"], sync_sites=hr["sites"],
                         host_work=sim.host_work)
        if hr["syncs"]:
            fail(f"wellctrl {name}: host syncs inside the Newton "
                 f"iterations: {hr['sites']}")
    out["launches"] = K.counts(K.THR)
    for n in ("K3 tpfa_div thr", "K3 tpfa_div_tangent thr"):
        if out["launches"][n] <= 0:
            fail(f"the THPRES decks launched no {n}")
    log("  threshold launches over the wellctrl decks: " + ", ".join(
        f"{n}={c}" for n, c in out["launches"].items()))
    return out


def norne_controls_run(K, case, knob, label, ref=None, spread=None):
    """The Norne-class field under field controls (three report steps,
    MULTFLT before the third) on the card in one representation: counts,
    wall, sections, the launch counters (the threshold entries, K10 on G,
    K7 after the rebuild on E), device memory before and after the
    rebuild, host reads a Newton and a report step's host work of each
    piece; held to ``ref`` (the fixture's run) when given; fails unless P8
    is shut by WECON."""
    import torch

    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    # the earlier legs' garbage collected first: the rebuild's own
    # collection must not count it as released
    gc.collect()
    torch.cuda.synchronize()
    mem = dict(start=torch.cuda.memory_allocated())
    with embed_knob(knob):
        sim = SimulatorFullyImplicitBlackoil(case)
    sim.solver.timing = {}
    hier = {}
    plain_geo = sim._apply_geo_modifiers

    def geo(mods):
        gc.collect()
        torch.cuda.synchronize()
        mem["before"] = torch.cuda.memory_allocated()
        hier["bytes_before"] = dict(cpr=device_bytes(sim.solver.amg),
                                    model=device_bytes(sim.model),
                                    sim=device_bytes(sim))
        hier["old"] = id(sim.solver.amg)
        hier["launches_before"] = K.counts(K.REBUILT)
        t0 = time.perf_counter()
        plain_geo(mods)
        torch.cuda.synchronize()
        hier["rebuild_s"] = time.perf_counter() - t0
        mem["after_rebuild"] = torch.cuda.memory_allocated()
        hier["bytes_after"] = dict(cpr=device_bytes(sim.solver.amg),
                                   model=device_bytes(sim.model),
                                   sim=device_bytes(sim))
        hier["new"] = id(sim.solver.amg)

    sim._apply_geo_modifiers = geo
    ctrl, thr_zero = [], []
    sim.events.event("report_step_completed").add(
        lambda s, step: ctrl.append(s.control.tolist()))

    def zero_faces(s, step):
        if thr_zero:
            return
        q = sim.model.cell_quantities(s)
        flux = sim.model.face_fluxes(q, sim.model.threshold_dp)
        free = sim.model.face_fluxes(q)
        on = (sim.model.threshold_dp > 0) & (sim.model.trans > 0)
        held = on & (flux == 0).all(dim=0) & (free != 0).any(dim=0)
        thr_zero.append([int(on.sum()), int(held.sum())])

    sim.events.event("report_step_completed").add(zero_faces)
    K.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with newton_host_reads() as hr:
        sim.run(report_step_limit=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mem["end"] = torch.cuda.memory_allocated()
    hier["bytes_end"] = dict(cpr=device_bytes(sim.solver.amg),
                             model=device_bytes(sim.model),
                             sim=device_bytes(sim))
    launched = K.counts(K.THR + K.REBUILT)
    rep = sim.report
    nsteps = len(sim.summary.rows)
    res = dict(wall_s=wall, newtons=rep.newton_iterations,
               substeps=rep.substeps, failed=rep.failed_substeps,
               linear=rep.linear_iterations,
               steps=[list(s) for s in sim._step_timing],
               sections_s=dict(sim.solver.timing),
               launches=launched,
               memory=mem, rebuild_s=hier.get("rebuild_s"),
               device_bytes=dict(before=hier.get("bytes_before"),
                                 after=hier.get("bytes_after"),
                                 end=hier["bytes_end"]),
               newton_syncs=hr["syncs"], newton_calls=hr["calls"],
               sync_sites=hr["sites"],
               host_work={k: [v[0] / nsteps, v[1] / nsteps]
                          for k, v in sim.host_work.items()},
               econ_shut=sorted(sim._econ_shut), thpres_zero=thr_zero,
               controls=ctrl[-1])
    log(f"{label}: {wall:.2f} s, {rep.newton_iterations} Newtons, "
        f"{rep.substeps} substeps, {rep.failed_substeps} failed, "
        f"{rep.linear_iterations} linear; steps {res['steps']}")
    log("  sections (s, synced): " + ", ".join(
        f"{k}={v:.2f}" for k, v in res["sections_s"].items()))
    log("  launches: " + ", ".join(f"{n}={c}" for n, c in
                                   res["launches"].items()))
    log(f"  rebuild after MULTFLT {hier.get('rebuild_s', 0):.3f} s; device "
        f"memory (MB) at the start {mem['start'] / 1e6:.1f}, before the "
        f"rebuild {mem.get('before', 0) / 1e6:.1f}, after it "
        f"{mem.get('after_rebuild', 0) / 1e6:.1f}, at the end "
        f"{mem['end'] / 1e6:.1f}; device MB held by the CPR hierarchy "
        f"(with K7's / K10's buffers), the model and the whole simulator "
        f"before the rebuild / after it / at the end: " + ", ".join(
            f"{k} " + " / ".join(
                f"{hier.get(w, {}).get(k, 0) / 1e6:.1f}"
                for w in ("bytes_before", "bytes_after", "bytes_end"))
            for k in ("cpr", "model", "sim")))
    log(f"  host syncs inside the Newton iterations' residual, controls "
        f"and assembly: {hr['syncs']} in {hr['calls']} iterations at "
        f"{hr['sites']} (K9's row is the loop's one read); a report step's "
        "host work (reads, s): "
        + ", ".join(
            f"{k} {v[0]:.2f} {v[1]:.4f}" for k, v in
            res["host_work"].items()))
    log(f"  THPRES faces on the interface / held at zero flow after step "
        f"1: {thr_zero}; shut by WECON: {res['econ_shut']}; controls "
        f"{ctrl[-1]}")
    if rep.failed_substeps or nsteps != 3:
        fail(f"{label}: failed substeps or {nsteps} report steps")
    if hr["syncs"]:
        fail(f"{label}: host syncs inside the Newton iterations: "
             f"{hr['sites']}")
    if "P8" not in sim._econ_shut:
        fail(f"{label}: P8 not shut by WECON")
    if "before" not in mem or hier["old"] == hier["new"]:
        fail(f"{label}: the CPR hierarchy was not rebuilt after MULTFLT")
    after = {n: launched[n] - hier["launches_before"][n]
             for n in K.REBUILT}
    rebuilt = "K6 cpr_setup in amg_refresh" if knob else "K7 gmg_refresh"
    if after[rebuilt] <= 0:
        fail(f"{label}: no {rebuilt} launch after the rebuild")
    # the old hierarchy released and the new one made: memory at the end
    # within 5% of what it was before the rebuild (both read after a
    # garbage collection)
    if abs(mem["end"] - mem["before"]) > 0.05 * mem["before"]:
        fail(f"{label}: device memory after the rebuild "
             f"{mem['end'] / 1e6:.1f} MB against {mem['before'] / 1e6:.1f}")
    need = (["K3-faces faces_div thr", "K3-faces face_blocks thr"]
            + ([] if knob else ["K3 tpfa_div thr", "K3 face_blocks thr"]))
    dead = [n for n in need if launched[n] <= 0]
    if dead:
        fail(f"{label}: threshold entries not launched: {dead}")
    if ref is not None:
        res["held_to"], res["worst_rel"] = hold_controls(
            label, sim, ctrl, {"jit": ref}, spread)
    return res


def norne_controls_phase(K, seed):
    """Phase 8: the Norne-class field under field controls
    (sim/testcases.py norne_field_controls) in E and G, at the toy size
    held to data/nornewells_reference_cpu.json and at full size
    (46x112x22) held to data/nornewells_full_reference_cpu.json;
    K3-faces' threshold entries on G's face list against their twins."""
    import hashlib

    import torch

    from opm_tpu_torch.io.eclstate import load_case_string
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.sim.testcases import (norne_field_controls,
                                             norne_like_deck)
    out = {}
    for size, fname in (("toy", "nornewells_reference_cpu.json"),
                        ("full", "nornewells_full_reference_cpu.json")):
        with open(os.path.join(ROOT, "data", fname)) as f:
            fx = json.load(f)
        t0 = time.perf_counter()
        text = norne_field_controls(norne_like_deck(**fx["deck_kwargs"]))
        if hashlib.sha256(text.encode()).hexdigest() != fx["deck_sha256"]:
            fail(f"the {size} Norne field-controls deck is not the fixture's")
        case = load_case_string(text)
        out[f"{size}_parse_s"] = time.perf_counter() - t0
        label = ("toy Norne field controls" if size == "toy"
                 else "Norne-class field controls")
        for rname, knob in (("embedded", None), ("gather", "0")):
            out[f"{size}_{rname}"] = norne_controls_run(
                K, case, knob, f"{label} {rname}", fx["runs"][rname]["jit"],
                fx["runs"][rname].get("spread"))
            if size == "full" and knob:
                with embed_knob(knob):
                    simg = SimulatorFullyImplicitBlackoil(case)
                st = initial_state(simg.grid, simg.props, simg.case,
                                   len(simg.well_names))
                st = seeded_pressure(st, seed)
                out["faces_thr"] = compare_threshold_faces(
                    K, simg.model, st, seed, "Norne-class gather")
                del simg, st
            torch.cuda.empty_cache()
    return out


def seeded_pressure(state, seed):
    """``state`` with a seeded pressure perturbation (faces on both sides
    of their thresholds)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 3)
    dp = torch.as_tensor(rng.standard_normal(state.pressure.shape[0]) * 2e4,
                         device=state.pressure.device)
    return state._replace(pressure=state.pressure + dp)


# ---------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible")
    sys.path.insert(0, ROOT)

    from opm_tpu_torch.io.eclstate import load_case, load_case_string
    from opm_tpu_torch.linalg import kernels_k8 as k8
    from opm_tpu_torch.linalg.gmg import StructuredGmg
    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.sim.testcases import spe1_pbvd_deck, spe10like_case
    from opm_tpu_torch.tools.assembly_ab import parse_ptxas, sass_fp64
    from opm_tpu_torch.utils import cuda_lib

    results = {}
    dev = torch.device("cuda", 0)

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    results["nvidia_smi"] = smi

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_lib.build_all(["tables", "equil", "cells", "tpfa", "blocks",
                        "block7", "wells", "cpr", "gmg", "amg", "faces",
                        "krylov", "newton", "cornerpoint"])
    K = Kernels()
    results["build_s"] = time.perf_counter() - t0
    log(f"build: {results['build_s']:.1f} s (13 nvcc sm_90a and the host "
        "cornerpoint.cpp in parallel)")
    for src in ("krylov.cu", "gmg.cu", "amg.cu", "cells.cu", "block7.cu",
                "faces.cu", "wells.cu", "newton.cu", "tpfa.cu", "equil.cu"):
        ptxas = cuda_lib.build_log.get(src)
        log(f"{src} -Xptxas -v: " + (json.dumps(parse_ptxas(ptxas))
            if ptxas is not None else "(library up to date, not rebuilt)"))
        results.setdefault("ptxas", {})[src] = parse_ptxas(ptxas)
    # the float64 instructions per thread of K2's and K5's kernels (and of
    # the cell operators that carry K5's well term) in the SASS
    for name in ("cells", "block7", "faces", "wells", "tpfa"):
        counts = sass_fp64(os.path.join(cuda_lib.BUILD_DIR,
                                        f"lib{name}.so"))
        K.sass[name] = {k: c["main"] for k, c in counts.items()}
        results.setdefault("sass_fp64", {})[name] = counts
        log(f"lib{name}.so float64 instructions per thread (SASS, main "
            f"body / division slow path): " + ", ".join(
                f"{k} {c['main']}/{c['sub']}" for k, c in counts.items()))
    results["k2_occupancy"] = mb.cells_occupancy(dev)
    log(f"K2 per entry (threads, blocks per SM, registers, local bytes): "
        f"{json.dumps(results['k2_occupancy'])}")
    # K8 at an odd length (the tail element) against its twins
    compare_k8(K, (3, 7), dev, args.seed, "K8 at 21 values", timed=False)
    log("K8 == plain at an odd length (21 values): ok")

    # -- 3a. K1/K3/K9 == plain at SPE1's shapes -------------------------------
    case1 = load_case(os.path.join(ROOT, "data", "SPE1CASE2.DATA"))
    sim_cmp = SimulatorFullyImplicitBlackoil(case1, device=dev)
    m1 = sim_cmp.model
    st1 = seeded_state(m1, args.seed, dev)
    # jacfwd folds every tangent column into one K3 tangent launch
    b_jac = 3 * m1.nc + 4 * len(sim_cmp.well_names)
    results["spe1_k9"] = compare_kernels(K, m1, st1, args.seed, "SPE1",
                                         timed=False, B=b_jac)
    log(f"K1/K2/K3/K9 == plain at SPE1 shapes (300 cells, K3 tangent B = "
        f"{b_jac}): ok")
    q1 = m1.cell_quantities(st1)
    a1 = (m1.dims, torch.stack([q1.pw, q1.po, q1.pg]).contiguous(),
          q1.rho.contiguous(), (q1.b * q1.mob).contiguous(),
          q1.rs.contiguous(), q1.rv.contiguous(), m1.depth, m1.trans,
          m1.gravity)
    t1 = [torch.ones((b_jac,) + a.shape, dtype=torch.float64, device=dev)
          for a in a1[1:6]]
    n0 = mb.tpfa_div_tangent_cuda.launches
    kt1 = mb.tpfa_div_tangent_cuda(*a1, *t1)
    if mb.tpfa_div_tangent_cuda.launches != n0 + 1 or not torch.equal(
            kt1, mb.tpfa_div_tangent_plain(*a1, *t1)):
        fail(f"SPE1: K3 tangent (B = {b_jac}, all-ones tangents) is not one "
             "launch bit for bit its plain version's")
    del kt1
    jac_ms = (cuda_ms(lambda: mb.tpfa_div_tangent_cuda(*a1, *t1)),
              cuda_ms(lambda: mb.tpfa_div_tangent_plain(*a1, *t1)),
              run_ms(lambda: mb.tpfa_div_tangent_cuda(*a1, *t1)))
    # the bound at this shape, as the SPE10-2 row's: inputs and the B
    # tangent divergences once, 120 operations a face and tangent set
    nf1 = m1.trans.shape[0]
    jac_bound = max(nbytes(a1[1:8], t1) / HBM_BYTES_S
                    + 8 * 3 * m1.nc * b_jac / HBM_BYTES_S,
                    120 * nf1 * b_jac / F64_FLOP_S) * 1e3
    log(f"  K3 tangent at SPE1 (the main path's shape), B = {b_jac}: kernel "
        f"{jac_ms[0]:.4f} ms   plain {jac_ms[1]:.4f} ms   bound "
        f"{jac_bound:.4f} ms   per launch in a run of 50 {jac_ms[2]:.4f} ms")
    results["spe1_k3_tangent_ms"] = dict(B=b_jac, ms=jac_ms[0],
                                         plain_ms=jac_ms[1],
                                         bound_ms=jac_bound,
                                         run_ms=jac_ms[2])
    ejac, n_tan, n_col = compare_jacobian(case1, dev)
    log(f"SPE1 Jacobian (jacfwd through the forward-mode rules of K2 and K3; "
        f"K2 column launches: {n_col}, K3 tangent launches: {n_tan}) vs "
        f"the plain CPU path: {ejac:.3e} of max|J|")
    results["spe1_jacobian_rel"] = ejac
    if not ejac <= TOL_JAC or n_tan < 1 or n_col < 1:
        fail(f"SPE1 Jacobian on the card off by {ejac:.3e} of max|J| "
             f"(> {TOL_JAC:g}) or not through K2 and K3 ({n_col} and "
             f"{n_tan} launches)")

    # -- 3b. K1/K3/K9 == plain at SPE10-2 shapes --------------------------------
    t0 = time.perf_counter()
    case10 = spe10like_case(nx=60, ny=220, nz=85)
    t1 = time.perf_counter()
    sim10 = SimulatorFullyImplicitBlackoil(case10)     # the default: cuda
    m10 = sim10.model
    if m10.device.type != "cuda" or sim10.solver.linear_solver != "cpr":
        fail("SPE10-2 did not default to the card's CPR route")
    results["spe10_setup_s"] = time.perf_counter() - t0
    # from the parsed deck: the simulator's construction alone
    results["spe10_construct_s"] = time.perf_counter() - t1
    amg = sim10.solver.amg
    log(f"SPE10-2 setup (deck parse, grid, props, GMG levels on the host): "
        f"{results['spe10_setup_s']:.1f} s, {m10.nc} cells, "
        f"{m10.trans.shape[0]} faces, {len(amg.levels)} GMG levels, "
        f"coarsest {amg.coarsest_n} cells")
    st10 = seeded_state(m10, args.seed, dev)
    k9r = compare_kernels(K, m10, st10, args.seed, "SPE10-2", timed=True,
                          B=3)
    results["spe10_k9"] = k9r
    # -- 3e. K3's entries with a THPRES threshold at SPE10-2's shapes
    results["spe10_thr"] = compare_threshold_kernels(K, m10, st10, args.seed,
                                                     "SPE10-2")
    log("K3 with a THPRES threshold == its twins at SPE10-2 shapes (ties "
        f"{results['spe10_thr']['ties']} of {results['spe10_thr']['faces']} "
        "faces): ok")
    log(f"  K9 at SPE10-2: one device kernel per update_state (profiler: "
        f"{k9r['update_device_kernels']}) and per convergence check "
        f"({k9r['convergence_device_kernels']}); host ms per call "
        f"{k9r['update_host_ms']:.4f} and {k9r['convergence_host_ms']:.4f}; "
        f"{k9r['switched_cells']} cells switched state")
    del st10
    log("K1/K2/K3/K9 == plain at SPE10-2 shapes (1.122M cells): ok")

    # -- 3c. K4/K6/K7/K8 == plain on real assembled systems ---------------------
    eq = results["equil"] = {}
    init1, eq["SPE1"] = check_equil(K, "SPE1", sim_cmp,
                                    march_row="K1 equil_march")
    sys1, ctx1 = first_newton_system(sim_cmp, init1)
    compare_assembly_kernels(K, sim_cmp, sys1, ctx1, args.seed, "SPE1",
                             timed=False)
    log("K2/K3 face blocks/K5 == plain on SPE1's first Newton system: ok")
    compare_cpr_kernels(K, sim_cmp, StructuredGmg(m1.dims,
                                                  sim_cmp.grid.trans),
                        sys1, args.seed, "SPE1", timed=False)
    log("K4/K6/K8 == plain on SPE1's first Newton system: ok")
    init10, eq["SPE10-2"] = check_equil(K, "SPE10-2", sim10,
                                        cells_row="K1 equil_cells")
    results["spe10_initial_state_s"] = eq["SPE10-2"]["initial_state_s"]
    t0 = time.perf_counter()
    sys10, ctx10 = first_newton_system(sim10, init10)
    torch.cuda.synchronize()
    results["spe10_first_assembly_s"] = time.perf_counter() - t0
    asm = compare_assembly_kernels(K, sim10, sys10, ctx10, args.seed,
                                   "SPE10-2", timed=True)
    results["spe10_assembly"] = asm
    log(f"K2/K3 face blocks/K5 == plain on SPE10-2's first Newton system; "
        f"one assembly through the kernels {asm['assemble_ms']:.1f} ms, "
        f"through their twins {asm['assemble_twin_ms']:.1f} ms (host "
        f"clock, synced)")
    del ctx10
    vc = compare_cpr_kernels(K, sim10, amg, sys10, args.seed, "SPE10-2",
                             timed=True)
    results["spe10_vcycle"] = vc
    g8, info8 = k8.grid_info(dev, 3 * m10.nc)
    results["k8_grid"] = dict(grid=g8, **info8)
    log(f"K8 grid at SPE10-2 ({3 * m10.nc} values): {g8} blocks of 256 "
        f"threads; {json.dumps(info8)}")
    for n in K.names(("K1", "K2", "K3", "K5", "K9", "K4", "K6", "K7",
                      "K8")):
        lib = K.library_ms.get(n)
        run = K.run_ms.get(n)
        log(f"  {n:22s} kernel {K.ms[n]:9.4f} ms   plain "
            f"{K.plain_ms[n]:9.4f} ms   bound {K.bound_ms[n]:8.4f} ms "
            f"({K.bound_by[n]})   library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}   "
            f"max_abs_err {K.err[n]:.3e}"
            + ("" if run is None else f"   per launch in a run of 50 "
               f"{run:.4f} ms"))
    results["run_ms"] = dict(K.run_ms)
    log_vcycle("SPE10-2", vc)
    log_k7_refresh("SPE10-2", vc["refresh"])
    # the production solve; then ten iterations of the recurrence at an
    # unreachable tolerance, a longer path for the roundoff to travel
    # (recorded: kernels and twins sum their dot products in other orders)
    results["spe10_solve_twice"] = []
    for tol, maxiter in ((1e-2, 50), (1e-12, 10)):
        ok, its_k, its_p, edu, tk, tp = solve_twice(sim10, sys10, tol,
                                                    maxiter)
        log(f"SPE10-2 Newton system at tol {tol:g}, kernels (twice, bit "
            f"equal) vs twins on the card: {its_k} / {its_p} BiCGStab "
            f"iterations, du off by {edu:.3e} of max|du|, {tk:.3f} s / "
            f"{tp:.3f} s")
        results["spe10_solve_twice"].append(dict(
            tol=tol, maxiter=maxiter, converged=ok, iterations=its_k,
            twin_iterations=its_p, du_rel=edu, s=tk, twin_s=tp))
        if its_k != its_p:
            fail("the kernel and twin solves take other iteration counts")
        if tol >= 1e-2 and not (ok and edu <= TOL_DU):
            fail("the kernel and twin solves of the SPE10-2 system differ")
    del sys10, sys1
    torch.cuda.empty_cache()
    log("K4/K6/K7/K8 == plain at SPE1 and SPE10-2 (1.122M cells): ok")

    # -- 3d. K1's column march on the decks of the other branches --------------
    # SPE1 with PBVD, dead oil with no DISGAS and no gas (SPE1CASE2_2P),
    # SPE9 (9000 cells, RSVD)
    with open(os.path.join(ROOT, "data", "SPE1CASE2.DATA")) as f:
        spe1_text = f.read()
    for name, case in (
            ("SPE1 PBVD", load_case_string(spe1_pbvd_deck(spe1_text))),
            ("SPE1CASE2_2P", load_case(os.path.join(ROOT, "data",
                                                    "SPE1CASE2_2P.DATA"))),
            ("SPE9", load_case(os.path.join(ROOT, "data", "SPE9.DATA")))):
        _, eq[name] = check_equil(K, name, SimulatorFullyImplicitBlackoil(
            case))
    torch.cuda.empty_cache()

    # -- 4. SPE1 end to end -----------------------------------------------------
    with open(os.path.join(ROOT, "data", "spe1_reference_cpu.json")) as f:
        ref1 = json.load(f)
    sim = SimulatorFullyImplicitBlackoil(case1)
    K.reset()
    results["spe1"] = run_vs_fixture(sim, ref1, "SPE1 end to end")
    K.read(K.DENSE)
    results["spe1"]["launches_all"] = {e[0]: e[4].launches
                                       for e in K.entries}
    log("  launches: " + ", ".join(f"{n}={K.launches[n]}"
                                   for n in K.DENSE))
    dead = [n for n in K.DENSE if K.launches[n] <= 0]
    if dead:
        fail(f"kernels not launched by the SPE1 run: {dead}")
    check_k9_launches(results["spe1"]["launches_all"], sim.report, "SPE1")

    # -- 4b. SPE3 (wet gas, VAPOIL, RVVD/PDVD): kernels, then end to end -----
    spe3_kernels(K, dev, args.seed, results)
    torch.cuda.empty_cache()
    with open(os.path.join(ROOT, "data", "spe3_reference_cpu.json")) as f:
        ref3 = json.load(f)
    results["spe3"] = spe3_run(K, ref3)

    # -- 4c. output and restart: SPE1 and SPE3 with output on, resumes -------
    results["output"] = output_phase(
        K, case1, ref1, results["spe1"],
        load_case(os.path.join(ROOT, "data", "SPE3.DATA")), ref3,
        results["spe3"])
    torch.cuda.empty_cache()

    # -- 5. SPE10-2 first report step through the CPR route --------------------
    solver = sim10.solver
    solver.timing = {}
    vtime = [0.0, 0]
    plain_vcycle = amg.vcycle

    def timed_vcycle(vals, b, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain_vcycle(vals, b, **kw)
        torch.cuda.synchronize()
        vtime[0] += time.perf_counter() - t
        vtime[1] += 1
        return out

    amg.vcycle = timed_vcycle
    new_names = K.names(("K4", "K6", "K7", "K8", "K9"), main_path=True) + \
        list(K.ASSEMBLY) + ["K3 face_blocks"]
    K.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with plain_inv4x4_on_card() as plain_inv:
        state = sim10.run(init10, report_step_limit=1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    K.read(new_names)
    amg.vcycle = plain_vcycle
    rep = sim10.report
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (state.pressure, state.sw, state.x, state.bhp, state.qs))
    sec = dict(solver.timing)
    sec["vcycle"] = vtime[0]
    res10 = dict(
        wall_s=wall, initial_state_s=results["spe10_initial_state_s"],
        newtons=rep.newton_iterations, linear=rep.linear_iterations,
        linear_per_newton=rep.linear_iterations
        / max(rep.newton_iterations, 1),
        substeps=rep.substeps, failed=rep.failed_substeps,
        residual_s=rep.assemble_time, sections_s=sec, vcycles=vtime[1],
        # the run_deck user's time: the simulator's construction from the
        # parsed deck, initial_state and the first report step, each
        # timed alone (synced host clock)
        deck_to_first_step_s=results["spe10_construct_s"]
        + results["spe10_initial_state_s"] + wall,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches={n: K.launches[n] for n in new_names},
        # every counter over this run (K1/K3/K9 run here too)
        launches_all={e[0]: e[4].launches for e in K.entries},
        report_steps=[list(s) for s in sim10._step_timing])
    results["spe10_cpr"] = res10
    log(f"SPE10-2 first report step (20 d) through the CPR route: "
        f"{wall:.1f} s wall, {rep.newton_iterations} Newtons, "
        f"{rep.linear_iterations} linear iterations "
        f"({res10['linear_per_newton']:.2f} per Newton), {rep.substeps} "
        f"substeps, {rep.failed_substeps} failed; initial_state "
        f"{results['spe10_initial_state_s']:.2f} s; peak memory "
        f"{res10['peak_mem_gb']:.1f} GB")
    log("  sections (s, synced): " + ", ".join(
        f"{k}={v:.2f}" for k, v in sec.items())
        + f", residual+convergence={rep.assemble_time:.2f} "
        f"({vtime[1]} V-cycles)")
    log("  launches: " + ", ".join(f"{n}={K.launches[n]}"
                                   for n in new_names))
    if rep.failed_substeps != 0 or not finite:
        fail("SPE10-2: failed substeps or a non-finite state")
    check_k8_launches(K.launches, rep, "SPE10-2")
    check_vcycle_launches(res10["launches_all"], rep, "SPE10-2", amg)
    check_k9_launches(res10["launches_all"], rep, "SPE10-2")
    check_refresh_launches(res10["launches_all"], rep, "SPE10-2", amg,
                           plain_inv[0])
    res10["launches_per_reduced_matvec"] = check_reduced_launches(
        res10["launches_all"], "SPE10-2", m10)
    dead = [n for n in new_names if K.launches[n] <= 0]
    if dead:
        fail(f"kernels not launched by the SPE10-2 run: {dead}")
    del sim10, state, init10
    torch.cuda.empty_cache()

    # -- 5b. the toy SPE10-like deck against its fixture -----------------------
    with open(os.path.join(ROOT, "data",
                           "spe10like_toy_reference_cpu.json")) as f:
        reft = json.load(f)
    simt = SimulatorFullyImplicitBlackoil(spe10like_case(
        **reft["deck_kwargs"]))
    _, eq["toy SPE10-like"] = check_equil(K, "toy SPE10-like", simt,
                                          twin=False)
    results["spe10_toy"] = toy_run(
        K, simt, reft, "toy SPE10-like (2640 cells)",
        list(K.ASSEMBLY) + ["K3 face_blocks", "K9 update",
                            "K9 convergence"])

    # -- 6. the Norne-class field at full size, both representations ----------
    from opm_tpu_torch.linalg.amg import DeviceAmg
    from opm_tpu_torch.sim.testcases import norne_like_case
    t0 = time.perf_counter()
    casen = norne_like_case()
    results["norne_parse_s"] = time.perf_counter() - t0
    sims = {}
    for rname, knob in (("embedded", None), ("gather", "0")):
        t0 = time.perf_counter()
        with embed_knob(knob):
            simn = SimulatorFullyImplicitBlackoil(casen)
        sims[rname] = simn
        mn = simn.model
        results[f"norne_{rname}_setup_s"] = time.perf_counter() - t0
        log(f"Norne-class {rname}: setup {time.perf_counter() - t0:.1f} s "
            f"(grid, props, hierarchy; deck parse "
            f"{results['norne_parse_s']:.1f} s once), {mn.nc} cells "
            f"({simn.grid.n_real} real), {mn.trans.shape[0]} faces "
            f"({mn.faces.n} by gather), "
            f"{type(simn.solver.amg).__name__} "
            f"{simn.solver.amg.n_levels if knob else len(simn.solver.amg.levels) + 1}"
            f" levels")
        if mn.device.type != "cuda" or simn.solver.linear_solver != "cpr":
            fail(f"Norne-class {rname} did not default to the card's CPR "
                 "route")
        if (knob is None) != (mn.op_dims is not None) or \
                (knob is not None) != isinstance(simn.solver.amg, DeviceAmg):
            fail(f"Norne-class {rname}: wrong representation or hierarchy")
    face_names = K.names(("K3-faces", "K4-faces", "K6-faces", "K10", "K6",
                          "K9"), face_grids=True) + K.names(
        ("K3-faces", "K4-faces", "K6-faces", "K10"))
    # every kernel of the two runs: the face-list path's and the
    # assembly's (the stencil face blocks and K7 on the embedded grid), K9
    new_names = [n for n in face_names if n not in K.OFF_MAIN] + \
        list(K.ASSEMBLY) + ["K3 face_blocks", "K9 update",
                            "K9 convergence"] + \
        K.names(("K7",), main_path=True)
    for rname, simn in sims.items():
        init_n, eq[f"Norne {rname}"] = check_equil(K, f"Norne-class {rname}",
                                                   simn)
        sysn, ctxn = first_newton_system(simn, init_n)
        stn, dtn = ctxn["state"], ctxn["dt"]
        asm = compare_assembly_kernels(K, simn, sysn, ctxn, args.seed,
                                       f"Norne-class {rname}", timed=True)
        results[f"norne_{rname}_assembly"] = asm
        log(f"assembly kernels == plain on the Norne-class {rname} first "
            f"Newton system: ok {json.dumps(asm)}")
        extra = compare_face_kernels(K, simn, sysn, stn, dtn, args.seed,
                                     f"Norne-class {rname}", timed=True)
        results[f"norne_{rname}_kernels"] = extra
        log(f"face-list kernels == plain on the Norne-class {rname} first "
            f"Newton system: ok {json.dumps(extra)}")
        log_vcycle(f"Norne-class {rname}", extra["vcycle"])
        if rname == "embedded":
            log_k7_refresh(f"Norne-class {rname}", extra["refresh"])
        if rname == "gather":
            compare_k8(K, (3, simn.model.nc), dev, args.seed,
                       "Norne-class gather", timed=False)
            log("K8 == plain at the Norne-class gather grid's shapes: ok")
            ok, its_k, its_p, edu, tk, tp = solve_twice(simn, sysn, 1e-2, 50)
            log(f"Norne-class gather Newton system, kernels (twice, bit "
                f"equal) vs twins on the card: {its_k} / {its_p} BiCGStab "
                f"iterations, du off by {edu:.3e} of max|du|, {tk:.3f} s / "
                f"{tp:.3f} s")
            results["norne_gather_solve_twice"] = dict(
                converged=ok, iterations=its_k, twin_iterations=its_p,
                du_rel=edu, s=tk, twin_s=tp)
            if its_k != its_p or not (ok and edu <= TOL_DU):
                fail("the kernel and twin solves of the Norne-class gather "
                     "system differ")
        del sysn, stn, init_n, ctxn
        torch.cuda.empty_cache()
    for n in face_names:
        lib = K.library_ms.get(n)
        run = K.run_ms.get(n)
        log(f"  {n:22s} kernel {K.ms[n]:9.4f} ms   plain "
            f"{K.plain_ms[n]:9.4f} ms   bound {K.bound_ms[n]:8.4f} ms "
            f"({K.bound_by[n]})   library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}   "
            f"max_abs_err {K.err[n]:.3e}"
            + ("" if run is None else f"   per launch in a run of 50 "
               f"{run:.4f} ms"))
    results["run_ms"] = dict(K.run_ms)
    with open(os.path.join(ROOT, "data",
                           "nornelike_full_reference_cpu.json")) as f:
        reff = json.load(f)
    runs = {}
    # the assembly kernels report SPE10-2's run (phase 5), their main path
    kept = {n: K.launches[n] for n in new_names if n not in face_names}
    for rname, simn in sims.items():
        runs[rname] = norne_first_step(K, simn, reff[rname],
                                       f"Norne-class {rname}", new_names)
        runs[rname]["deck_to_first_step_s"] = (
            results[f"norne_{rname}_setup_s"]
            + runs[rname]["initial_state_s"] + runs[rname]["wall_s"])
        results[f"norne_{rname}_run"] = runs[rname]
    for n in new_names:
        K.launches[n] = sum(r["launches_all"][n] for r in runs.values())
    dead = [n for n in new_names if K.launches[n] <= 0]
    if dead:
        fail(f"kernels not launched by the Norne-class runs: {dead}")
    K.launches.update(kept)
    # the two representations are held to each other as closely as the
    # reference's own two runs agree, up to the parity limits (the JAX
    # package's embedded and gather runs differ by 2.0e-4 in FPR and 3.5e-4
    # in FOPR after this step: 5 against 6 Newtons, inexact solves)
    gap = {}
    for k, tol in (("FPR", TOL_FPR), ("FOPR", TOL_RATE)):
        e, g = runs["embedded"][k], runs["gather"][k]
        re_, rg = (reff[r]["report_steps"][0][k] for r in ("embedded",
                                                            "gather"))
        gap[k] = (abs(e - g) / abs(g), abs(re_ - rg) / abs(rg), tol)
    log("Norne-class embedded vs gather after the first report step "
        "(port, reference): " + ", ".join(
            f"{k} {p:.3e}, {r:.3e}" for k, (p, r, _) in gap.items()))
    results["norne_embedded_vs_gather"] = {
        k: dict(port=p, reference=r) for k, (p, r, _) in gap.items()}
    if any(p > r + tol for p, r, tol in gap.values()):
        fail("the two Norne-class representations disagree by more than "
             "the reference's own two runs")
    del sims, simn
    torch.cuda.empty_cache()
    # the first report step of each with output on (UNRST, INIT, EGRID)
    for rname, knob in (("embedded", None), ("gather", "0")):
        results[f"norne_{rname}_output"] = norne_output_step(
            casen, knob, reff[rname], runs[rname], f"Norne-class {rname}")
        torch.cuda.empty_cache()

    # -- 7. the toy Norne-like deck in both representations ---------------------
    with open(os.path.join(ROOT, "data",
                           "nornelike_toy_reference_cpu.json")) as f:
        refn = json.load(f)
    for rname, knob in (("embedded", None), ("gather", "0")):
        with embed_knob(knob):
            simt = SimulatorFullyImplicitBlackoil(norne_like_case(
                **refn["deck_kwargs"]))
        init_t, eq[f"toy Norne-like {rname}"] = check_equil(
            K, f"toy Norne-like {rname}", simt, twin=False)
        if knob is not None:
            results["norne_toy_gather_k6"] = compare_k6_fused(
                K, simt.solver.amg, first_newton_system(simt, init_t)[0],
                "toy Norne-like gather", timed=False)
            log("K6 in K10's refresh == its twin and the former pair on the "
                "toy Norne-like gather deck's first Newton system: ok")
        del init_t
        results[f"norne_toy_{rname}"] = toy_run(
            K, simt, refn[rname], f"toy Norne-like {rname} "
            f"({simt.model.nc} cells)", list(K.ASSEMBLY)
            + ["K3-faces face_blocks", "K9 update"]
            + (["K3 face_blocks", "K9 convergence_masked"] if knob is None
               else ["K9 convergence"]))

    # -- 4d. the well-control decks, 8. the Norne-class field under field
    # controls; the threshold rows' launches are those runs'
    results["wellctrl"] = wellctrl_phase(K)
    results["norne_controls"] = ctl = norne_controls_phase(K, args.seed)
    for n in K.THR:
        K.launches[n] = results["wellctrl"]["launches"][n] + sum(
            ctl[r]["launches"][n] for r in ("full_embedded", "full_gather"))

    log("EQUIL: initial_state s (K1 march ms a region, twin ms): " + "; ".join(
        f"{n} {r['initial_state_s']:.3f} (" + ", ".join(
            f"{g['ms']:.3f}, {g['twin_ms'] or 0:.0f}" for g in r["regions"])
        + ")" for n, r in eq.items()))
    log("from a parsed deck to the end of the first report step (s): "
        f"SPE10-2 {results['spe10_cpr']['deck_to_first_step_s']:.2f}, "
        + ", ".join(f"Norne-class {r} {runs[r]['deck_to_first_step_s']:.2f}"
                    for r in runs))
    kern = K.report()
    results.update(kern)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    log(smi)
    print(json.dumps(kern))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
