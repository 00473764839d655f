"""The assembly kernels K2, K3 and K5 on one card: an A/B of two trees, and a
sweep of K2's block size and launch bounds.

    python3 -m opm_tpu_torch.tools.assembly_ab --trees BASE,CHANGE
        [--order ABBA] [--part all|faces] [--out assembly_ab.json]
    python3 -m opm_tpu_torch.tools.assembly_ab --sweep [--out sweep.json]

``--trees`` runs one leg per letter of ``--order`` (A: the first tree, B:
the second), each in a process of its own that imports ``opm_tpu_torch``
from its tree and builds that tree's kernels into its own ``build/``, so
two versions of the package are compared in turns on the same card. A leg
reports, for ``cells.cu``, ``wells.cu``, ``block7.cu``, ``faces.cu`` and
``tpfa.cu``, ptxas's registers and spills per kernel and the float64
instructions per kernel in the SASS (``cuobjdump -sass``: DADD, DMUL,
DFMA, DSETP, DMNMX and
the MUFU.RCP64H of the divisions, in the kernel's main body and in the
division's slow-path subroutine); then at SPE10 model 2's size (the
seeded SPE10-like deck, 60x220x85 = 1.122M cells) and on the Norne-class
field (``norne_like_deck()``) in both representations: K2's three entries
on a seeded state in every hydrocarbon state, K3 on that state's face
inputs (``tpfa_div`` over a structured stencil: SPE10-2's and the
embedded grid's; the face-list face blocks on the embedded grid's extra
faces and the gather grid's faces: one call and per launch in a run of
50, wrapper launches and device kernels a call, a digest, bit equality
with the twin), and the Schur-reduced
operator, K5's right-hand side and recovery on the first Newton system,
each timed two ways (CUDA events: one wrapper call, median of 20; and per
launch over a run of 50 back-to-back calls, median of 5), with the device
launches per reduced matvec (the kernel wrappers' counters), the device
time by kernel of the reduced matvec and the right-hand side
(torch.profiler, 20 calls) and a digest of each output (two trees' bits
compared across legs); and SPE10-2's
report step 0 after a warm-up run of the same step: wall, the Newton
loop's synced sections, the counts and a digest of the final state.

Before those, a leg runs SPE1's dense route: K3's tangent at the jacfwd
batch B = 3 nc + 4 nw = 908 (seeded and all-ones tangents: launches a
call, digests, bit equality with the twin; timed two ways with its device
kernels a call) and a digest of the first Newton iteration's dense
Jacobian on the card; at SPE10-2 also the tangent at B = 3, and on both
Norne-class grids K3-faces' divergence (the embedded grid's in-place
epilogue, the gather grid's every cell; bit equality with the twin on CPU
copies).

``--part faces`` runs, per leg, only the face-list face blocks with
K4-faces' packed operator as the assembly makes them on the Norne-class
field's embedded (E) and gather (G) grids, on the first Newton system's
face inputs: in a tree whose face blocks write the packed copy
(``faces_blocks_cuda`` returns it) that call and the operator over its
copy; in an older tree the face blocks, then the operator's pack launch
(``faces_pack_cuda``, which the fused copy replaced). Per grid: one call
and per call in a run of 50 (CUDA events), device time by kernel
(torch.profiler), the host's own time per call (20 calls not
synchronized), the caching allocator's requests per call, the face blocks'
and the pack's wrapper launches per call, whether the copy equals
``faces_pack_plain`` of the blocks bit for bit, digests of the outputs and
of one K4-faces product over the copy; then the first report step after a
warm-up run of the same step: counts, the face blocks' and the pack's
launches per Newton and a digest of the state.

``--sweep`` builds ``csrc/cells.cu`` of this tree with each pair of block
size and ``__launch_bounds__`` minimum blocks per SM (the values entry's,
the Dual3 entries') of ``SWEEP``, and times K2's three entries at SPE10-2's
size with each, with registers, spills and resident blocks per SM.

Prints one JSON line per leg (or sweep point) and the card's name and
power limit; writes everything to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

SPE10 = dict(nx=60, ny=220, nz=85)
# (values threads, values min blocks, Dual3 threads, Dual3 min blocks)
SWEEP = ((128, 1, 128, 1), (256, 1, 256, 1), (256, 2, 128, 2),
         (256, 3, 128, 3), (256, 4, 128, 4), (512, 1, 64, 1),
         (128, 4, 64, 4), (512, 2, 256, 2))
FP64_OPS = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET")


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_name(mangled):
    """The unqualified function name of an Itanium-mangled symbol
    (_ZN<len><name>...<len><name>E..., or _Z<len><name>...); an unmangled
    name as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        end = pos
        while mangled[end].isdigit():
            end += 1
        n = int(mangled[pos:end])
        name = mangled[end:end + n]
        pos = end + n
    return name


def parse_ptxas(text):
    """ptxas -v output -> {kernel: registers, spill stores and loads
    (bytes), stack frame (bytes)}; a template kernel's instances keep
    their mangled suffix apart by a counter."""
    out, cur = {}, None
    for ln in (text or "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = kernel_name(m.group(1))
            k = 2
            while name in out:
                name = f"{kernel_name(m.group(1))}#{k}"
                k += 1
            cur = out.setdefault(name, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def _cuobjdump():
    for d in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = os.path.join(d, "bin", "cuobjdump")
        if d and os.path.exists(p):
            return p
    return "cuobjdump"


def sass_fp64(lib_path):
    """The float64 instructions of each kernel in a library's SASS:
    {kernel: {"main": n, "sub": m, "by_op": {...}}}, main the kernel's own
    body, sub the subroutines it calls (the division's slow path, taken
    only for operands near the range's ends)."""
    text = subprocess.run([_cuobjdump(), "-sass", lib_path],
                          capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        lines = chunk.splitlines()
        name = kernel_name(lines[0].strip())
        insts, labels, targets = [], {}, set()
        for ln in lines[1:]:
            s = ln.strip()
            if s.endswith(":") and not s.startswith("/*"):
                labels[s[:-1].strip()] = len(insts)
                continue
            m = re.match(r"/\*[0-9a-f]+\*/\s+(.*?)\s*;", s)
            if not m:
                continue
            ins = re.sub(r"^@!?U?P\w+\s+", "", m.group(1))
            insts.append(ins)
            if ins.startswith("CALL"):
                t = re.search(r"\(([^)]+)\)", ins)
                if t:
                    targets.add(t.group(1).strip())
        starts = [labels[t] for t in targets if t in labels]
        split = min(starts) if starts else len(insts)
        main, sub, by_op = 0, 0, {}
        for k, ins in enumerate(insts):
            op = ins.split()[0] if ins else ""
            base = op.split(".")[0]
            if not (base in FP64_OPS or (base == "MUFU" and "64H" in op)):
                continue
            if k < split:
                main += 1
                key = base if base != "MUFU" else op
                by_op[key] = by_op.get(key, 0) + 1
            else:
                sub += 1
        while name in out:
            name += "#"
        out[name] = dict(main=main, sub=sub, by_op=by_op)
    return out


def two_ways(fn, reps=20, run=50, run_reps=5):
    """(ms of one call, ms per call over ``run`` back-to-back calls):
    CUDA events, medians of ``reps`` and ``run_reps``."""
    import torch
    fn()
    torch.cuda.synchronize()
    one, many = [], []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        one.append(s.elapsed_time(e))
    for _ in range(run_reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(run):
            fn()
        e.record()
        e.synchronize()
        many.append(s.elapsed_time(e) / run)
    return statistics.median(one), statistics.median(many)


def device_us(fn, reps=20):
    """Device time of fn per call under torch.profiler (after a warm call):
    {"kernels": {name: us}, "busy": us, "span": us} with span the first
    kernel's start to the last one's end over the calls, divided by
    ``reps`` (the gaps included); None where no device event was
    recorded (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    if not evs:
        return None
    by = {}
    for ev in evs:
        name = ev.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].split("::")[-1][:40]
        by[name] = by.get(name, 0.0) + ev.time_range.elapsed_us() / reps
    span = (max(ev.time_range.end for ev in evs)
            - min(ev.time_range.start for ev in evs)) / reps
    return dict(kernels=by, busy=sum(by.values()), span=span)


def seeded_state(model, seed=0):
    """Primaries in every hydrocarbon state, made from the seed with
    numpy, on the model's device: (p, sw, x, hcstate, pvtnum, satnum)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    nc, dev = model.nc, model.device
    hc = rng.integers(0, 3, nc).astype(np.int32)
    sw = rng.uniform(0.15, 0.7, nc)
    x = np.where(hc == 0, rng.uniform(0.0, 0.25, nc),
                 np.where(hc == 1, rng.uniform(20.0, 120.0, nc),
                          rng.uniform(0.0, 1e-4, nc)))
    p = rng.uniform(1.5e7, 4.0e7, nc)
    f = [torch.as_tensor(a, device=dev) for a in (p, sw, x, hc)]
    return (*f, model.pvtnum, model.satnum)


def digest(*ts):
    """A hash of the tensors' bytes: two trees' outputs compared bit for
    bit across legs."""
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def k2_times(pack, a, acc0, pv, dt):
    """K2's three entries two ways: {entry: (one call, per call in a run)},
    and each entry's output digest."""
    from opm_tpu_torch.models import blackoil as mb
    fns = dict(values=lambda: mb.cells_values_cuda(pack, *a),
               columns=lambda: mb.cells_columns_cuda(pack, *a),
               assemble=lambda: mb.cells_assemble_cuda(pack, *a, acc0, pv,
                                                       dt))
    out = {k: two_ways(f) for k, f in fns.items()}
    out["digest"] = {k: digest(*((r,) if not isinstance(r, tuple) else r))
                     for k, f in fns.items() for r in (f(),)}
    return out


def tangent_times(args, B, seed=0):
    """K3's tangent entry at B tangent sets over the structured face inputs
    ``args`` (dims, p3, rho, bmob, rs, rv, depth, trans, gravity): with
    seeded normal tangents and with all-ones ones, the wrapper launches a
    call, a digest and bit equality with the twin (on the card); the
    all-ones call timed two ways and its device kernels a call."""
    import numpy as np
    import torch

    from opm_tpu_torch.models import blackoil as mb

    rng = np.random.default_rng(seed)
    out = dict(B=B)
    for kind in ("seeded", "ones"):
        if kind == "ones":
            tan = [torch.ones((B,) + a.shape, dtype=torch.float64,
                              device=a.device) for a in args[1:6]]
        else:
            tan = [torch.as_tensor(rng.standard_normal((B,) + a.shape),
                                   device=a.device) * a.abs().mean()
                   for a in args[1:6]]
        n0 = mb.tpfa_div_tangent_cuda.launches
        d = mb.tpfa_div_tangent_cuda(*args, *tan)
        out[kind] = dict(
            launches=mb.tpfa_div_tangent_cuda.launches - n0,
            digest=digest(d), bits_equal_twin=bool(torch.equal(
                d, mb.tpfa_div_tangent_plain(*args, *tan))))
        del d
    out["times"] = two_ways(lambda: mb.tpfa_div_tangent_cuda(*args, *tan))
    out["device_us"] = device_us(
        lambda: mb.tpfa_div_tangent_cuda(*args, *tan))
    return out


def faces_div_times(sim, q):
    """K3-faces' divergence over the grid's face list on the face inputs
    ``q`` (p3, rho, bmob, rs, rv): from zeros on a gather grid, in place
    over the touched rows after the stencil's tpfa_div on an embedded grid;
    the wrapper launches a call, a digest and bit equality with the twin
    on CPU copies (its index_add_ on the card adds in no fixed order),
    timed two ways (in place on one buffer on the embedded grid) with its
    device kernels a call."""
    import torch

    from opm_tpu_torch.models import blackoil as mb

    def cpu(t):
        return t.detach().cpu() if torch.is_tensor(t) else t

    m, fl = sim.model, sim.model.faces
    args = (*q, m.depth, m.trans, m.gravity)
    base = None
    if m.structured:
        base = mb.tpfa_div_cuda(m.dims, *q, m.depth, m.trans_stencil,
                                m.gravity)
    n0 = mb.faces_div_cuda.launches
    d = mb.faces_div_cuda(fl, *args, out=None if base is None
                          else base.clone())
    launches = mb.faces_div_cuda.launches - n0
    fl_cpu = mb.FaceList(sim.grid.face_cells, m.nc, fl.first, "cpu")
    twin = mb.faces_div_plain(fl_cpu, *[cpu(a) for a in args],
                              out=None if base is None else cpu(base))
    buf = None if base is None else base.clone()

    def call():
        mb.faces_div_cuda(fl, *args, out=buf)

    return dict(
        faces=fl.n, rows=(fl.full if base is None else fl.touched).n_rows,
        launches=launches, digest=digest(d),
        bits_equal_twin=bool(torch.equal(cpu(d), twin)),
        times=two_ways(call), device_us=device_us(call))


def k3_times(sim, fv, fc, r0, d0):
    """K3 on one seeded state's face inputs (K2's assembly entry): the
    structured divergence (tpfa_div) over a structured grid's stencil and
    its tangent at B = 3 (SPE10-2's row), the face-list divergence and the
    face-list face blocks over a face list, each timed two ways, with its
    wrapper launches and device kernels a call (torch.profiler), a digest
    of its outputs and whether they equal the twin's bit for bit
    (tpfa_div's and the tangent's twins on the card; the face-list ones'
    on CPU copies, since their index_add_ on the card adds in no fixed
    order)."""
    import torch

    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.models import linearize as lz

    m = sim.model
    out = {}
    q = (fv[0:3], fv[3:6], fv[6:9], fv[9], fv[10])
    if m.structured:
        args = (m.dims, *q, m.depth, m.trans_stencil, m.gravity)
        n0 = mb.tpfa_div_cuda.launches
        d = mb.tpfa_div_cuda(*args)
        out["tpfa_div"] = dict(
            launches=mb.tpfa_div_cuda.launches - n0,
            times=two_ways(lambda: mb.tpfa_div_cuda(*args)),
            device_us=device_us(lambda: mb.tpfa_div_cuda(*args)),
            digest=digest(d),
            bits_equal_twin=bool(torch.equal(d, mb.tpfa_div_plain(*args))))
        del d
        if m.faces is None:
            out["tangent"] = tangent_times(args, 3)
    fl = m.faces
    if fl is None:
        return out
    out["faces_div"] = faces_div_times(sim, q)
    nf = m.trans.shape[0]
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    fl_cpu = mb.FaceList(sim.grid.face_cells, m.nc, fl.first, "cpu")

    def run(fn, lead, dev_of, *a):
        r, d = dev_of(r0).clone(), dev_of(d0).clone()
        fL = torch.zeros((9, nf), dtype=torch.float64, device=r.device)
        fR = torch.zeros_like(fL)
        fn(lead, *a, r, d, fL, fR)
        return r, d, fL, fR

    inputs = (fv, fc, m.depth, m.trans, m.gravity)
    twin = run(lz.faces_blocks_plain, fl_cpu, cpu,
               *[cpu(t) if torch.is_tensor(t) else t for t in inputs])
    n0 = lz.faces_blocks_cuda.launches
    k = run(lz.faces_blocks_cuda, fl, lambda t: t, *inputs)
    launches = lz.faces_blocks_cuda.launches - n0
    rk, dk, fLk, fRk = run(lz.faces_blocks_cuda, fl, lambda t: t, *inputs)

    def call():
        # in place on persistent buffers (r and d grow, finite)
        lz.faces_blocks_cuda(fl, *inputs, rk, dk, fLk, fRk)

    out["face_blocks"] = dict(
        launches=launches, times=two_ways(call), device_us=device_us(call),
        digest=digest(*k), bits_equal_twin=all(
            bool(torch.equal(cpu(a), b)) for a, b in zip(k, twin)))
    return out


def spe1_times(tree):
    """SPE1's dense route (10x10x3, two wells): K3's tangent at the
    jacfwd batch B = 3 nc + 4 nw (908) on a seeded state's face inputs,
    and a digest of the first Newton iteration's dense Jacobian and
    residual on the card (torch.func.jacfwd through K2's and K3's
    forward-mode rules) with the tangent launches it took."""
    import numpy as np
    import torch

    from opm_tpu_torch.io.eclstate import load_case
    from opm_tpu_torch.models.blackoil import (make_well_device_arrays,
                                               tpfa_div_tangent_cuda)
    from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                            init_well_state,
                                            report_step_wells)
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.solver.newton import connection_offsets
    from opm_tpu_torch.utils.convert import state_from_numpy

    case = load_case(os.path.join(tree, "data", "SPE1CASE2.DATA"))
    sim = SimulatorFullyImplicitBlackoil(case)
    m = sim.model
    p, sw, x, hc = (t.cpu().numpy() for t in seeded_state(m)[:4])
    q = m.cell_quantities(state_from_numpy(dict(
        pressure=p, sw=sw, x=x, hcstate=hc, bhp=np.zeros(0),
        qs=np.zeros((0, 3)), control=np.zeros(0), target=np.zeros(0)),
        m.device))
    args = (m.dims, torch.stack([q.pw, q.po, q.pg]).contiguous(),
            q.rho.contiguous(), (q.b * q.mob).contiguous(),
            q.rs.contiguous(), q.rv.contiguous(), m.depth, m.trans,
            m.gravity)
    B = 3 * m.nc + 4 * len(sim.well_names)
    out = dict(tangent=tangent_times(args, B))
    ws = report_step_wells(sim.schedule.report_steps[0], sim.grid,
                           sim.well_names, sim.max_perf)
    wd = make_well_device_arrays(ws, sim.grid.gravity, m.device)
    st = init_well_state(initial_state(sim.grid, sim.props, case, ws.nw),
                         ws, True)
    acc0 = m.accumulation(st)
    cdp = connection_offsets(m, st, wd)
    n0 = tpfa_div_tangent_cuda.launches
    J, r = sim.solver.jacobian(st, acc0, 86400.0, wd, cdp)
    out["jacobian"] = dict(
        shape=list(J.shape), digest=digest(J, r),
        tangent_launches=tpfa_div_tangent_cuda.launches - n0,
        finite=bool(torch.isfinite(J).all()))
    return out


def _first_system(sim, st0):
    from opm_tpu_torch.models import linearize
    from opm_tpu_torch.models.blackoil import make_well_device_arrays
    from opm_tpu_torch.sim.blackoil import init_well_state, report_step_wells
    from opm_tpu_torch.solver.newton import connection_offsets

    ws = report_step_wells(sim.schedule.report_steps[0], sim.grid,
                           sim.well_names, sim.max_perf)
    wd = make_well_device_arrays(ws, sim.grid.gravity, sim.device)
    st = init_well_state(st0, ws, True)
    return linearize.assemble(sim.model, st, sim.model.accumulation(st),
                              float(sim.ts.p.initial_dt), wd,
                              connection_offsets(sim.model, st, wd))


def _launches(lz):
    return sum(getattr(lz, n).launches for n in
               ("matvec_cells_cuda", "faces_matvec_cuda", "schur_matvec_cuda")
               if hasattr(lz, n))


def k5_times(sim, sys_):
    """The reduced operator, K5's right-hand side and recovery two ways on
    one Newton system, with the device launches per reduced matvec; in a
    tree with WellTerm also the parent's pair (K4/K4-faces, then the
    stand-alone well term)."""
    import numpy as np
    import torch

    from opm_tpu_torch.linalg.precond import inv4x4
    from opm_tpu_torch.models import linearize as lz

    dims = sim.model.op_dims
    mv, rhs, rec = lz.schur_eliminate_wells(sys_, dims)
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (3, sys_.nc)), device=sys_.r_cell.device)
    n0 = _launches(lz)
    mv(v)
    per_mv = _launches(lz) - n0
    Dinv = inv4x4(sys_.wd_diag).contiguous()
    out = dict(launches_per_matvec=per_mv, reduced_matvec=two_ways(
        lambda: mv(v)), recover=two_ways(lambda: rec(v)),
        device_us=dict(reduced_matvec=device_us(lambda: mv(v))),
        digest=dict(reduced_matvec=digest(mv(v)), rhs=digest(rhs),
                    recover=digest(rec(v))))
    if hasattr(lz, "WellTerm"):
        wt = lz.WellTerm(sys_, Dinv)
        out["rhs"] = two_ways(lambda: lz.schur_rhs_cuda(wt))
        out["device_us"]["rhs"] = device_us(lambda: lz.schur_rhs_cuda(wt))
        out["pair"] = two_ways(lambda: lz.schur_matvec_cuda(
            wt, v, lz.matvec_cells(sys_, v, dims)))
        out["bits_equal_pair"] = bool(torch.equal(
            mv(v), lz.schur_matvec_cuda(wt, v, lz.matvec_cells(sys_, v,
                                                                dims))))
    else:
        out["rhs"] = two_ways(lambda: lz.schur_rhs_cuda(sys_, Dinv))
        out["device_us"]["rhs"] = device_us(
            lambda: lz.schur_rhs_cuda(sys_, Dinv))
    return out


REPORTED = ("cells", "wells", "block7", "faces", "tpfa")


def _build_report(tree):
    """Build every kernel of the tree; ptxas per kernel and SASS float64
    counts for the assembly's and the reduced operator's sources (rebuilt
    even where the tree's libraries are up to date, for ptxas's report)."""
    from opm_tpu_torch.utils import cuda_lib
    csrc = os.path.join(tree, "opm_tpu_torch", "csrc")
    names = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    for n in REPORTED:
        lib = os.path.join(cuda_lib.BUILD_DIR, f"lib{n}.so")
        if os.path.exists(lib):
            os.remove(lib)
    libs = dict(zip(names, cuda_lib.build_all(names)))
    rep = {}
    for n in REPORTED:
        rep[n] = dict(ptxas=parse_ptxas(cuda_lib.build_log.get(n + ".cu")),
                      sass=sass_fp64(libs[n]))
    return rep


def _leg(tree):
    import torch
    sys.path.insert(0, tree)
    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.sim.testcases import norne_like_case, spe10like_case

    out = dict(tree=tree, build=_build_report(tree))
    out["spe1"] = spe1_times(tree)

    def fresh(case, knob):
        os.environ.pop("OPM_TPU_EMBED", None)
        if knob is not None:
            os.environ["OPM_TPU_EMBED"] = knob
        sim = SimulatorFullyImplicitBlackoil(case)
        return sim, initial_state(sim.grid, sim.props, case,
                                  len(sim.well_names))

    norne = norne_like_case()
    for label, case, knob in (("spe10", spe10like_case(**SPE10), None),
                              ("norne_embedded", norne, None),
                              ("norne_gather", norne, "0")):
        sim, init = fresh(case, knob)
        m = sim.model
        a = seeded_state(m)
        acc0 = torch.zeros((3, m.nc), dtype=torch.float64, device=m.device)
        pack = m.props.cell_pack()
        res = dict(nc=m.nc, k2=k2_times(pack, a, acc0, m.pv, 86400.0))
        res["k3"] = k3_times(sim, *mb.cells_assemble_cuda(pack, *a, acc0,
                                                          m.pv, 86400.0))
        del a, acc0
        sys_ = _first_system(sim, init)
        nw, mp = sys_.perf_cell.shape
        res.update(nw=nw, mp=mp, k5=k5_times(sim, sys_))
        del sys_
        if label == "spe10":
            sim.run(init, report_step_limit=1)          # warm-up
            sim, init = fresh(case, knob)
            sim.solver.timing = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = sim.run(init, report_step_limit=1)
            torch.cuda.synchronize()
            rep = sim.report
            res.update(wall_s=time.perf_counter() - t0,
                       state_digest=digest(st.pressure, st.sw, st.x, st.bhp,
                                           st.qs),
                       sections_s=dict(sim.solver.timing),
                       newtons=rep.newton_iterations,
                       linear=rep.linear_iterations, substeps=rep.substeps,
                       failed=rep.failed_substeps)
        out[label] = res
        del sim, init
        torch.cuda.empty_cache()
    os.environ.pop("OPM_TPU_EMBED", None)
    print(json.dumps(out), flush=True)


def enqueue_ms(fn, run=20, reps=5):
    """Host-clock ms per call of ``run`` calls in a row, not synchronized:
    the host's own time per call while the card runs behind; median of
    ``reps``."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(run):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / run)
        torch.cuda.synchronize()
    return statistics.median(times)


def alloc_requests(fn, reps=10):
    """The caching allocator's requests per call of fn (warm)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    a1 = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    return (a1 - a0) / reps


def _faces_leg(tree):
    """--part faces: one leg (module docstring)."""
    import numpy as np
    import torch
    sys.path.insert(0, tree)
    from opm_tpu_torch.models import linearize as lz
    from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                            init_well_state,
                                            report_step_wells)
    from opm_tpu_torch.sim.init import initial_state
    from opm_tpu_torch.sim.testcases import norne_like_case
    from opm_tpu_torch.utils import cuda_lib

    csrc = os.path.join(tree, "opm_tpu_torch", "csrc")
    cuda_lib.build_all(sorted(f[:-3] for f in os.listdir(csrc)
                              if f.endswith(".cu")))
    norne = norne_like_case()
    out = dict(tree=tree)
    for label, knob in (("norne_embedded", None), ("norne_gather", "0")):
        os.environ.pop("OPM_TPU_EMBED", None)
        if knob is not None:
            os.environ["OPM_TPU_EMBED"] = knob
        sim = SimulatorFullyImplicitBlackoil(norne)
        init = initial_state(sim.grid, sim.props, norne,
                             len(sim.well_names))
        m = sim.model
        fl = m.faces
        # the first Newton system's face inputs (K2's assembly entry)
        ws = report_step_wells(sim.schedule.report_steps[0], sim.grid,
                               sim.well_names, sim.max_perf)
        s1 = init_well_state(init, ws, True)
        fv, fc, r0, d0 = lz.cell_assembly(
            m.props, s1.pressure, s1.sw, s1.x, s1.hcstate, m.pvtnum,
            m.satnum, m.accumulation(s1), m.pv,
            float(sim.ts.p.initial_dt))
        nf = m.trans.shape[0]
        inputs = (fv, fc, m.depth, m.trans, m.gravity)
        r, d = r0.clone(), d0.clone()
        fL = torch.zeros((9, nf), dtype=torch.float64, device=m.device)
        fR = torch.zeros_like(fL)

        def main_form():
            # what the assembly runs: the face blocks, then the operator
            # over the copy they wrote (an older tree's packs its own)
            blk = lz.faces_blocks_cuda(fl, *inputs, r, d, fL, fR)
            return lz.FacesOperator(fl, d, fL, fR,
                                    *(() if blk is None else (blk,)))

        pack = getattr(lz, "faces_pack_cuda", None)

        def counts():
            return (lz.faces_blocks_cuda.launches,
                    0 if pack is None else pack.launches)

        r.copy_(r0)
        d.copy_(d0)
        n0 = counts()
        op = main_form()
        launches = [a - b for a, b in zip(counts(), n0)]
        v = torch.as_tensor(np.random.default_rng(5).standard_normal(
            (3, m.nc)), device=m.device)
        y = lz.faces_matvec_cuda(op, v, None if m.op_dims is None
                                 else lz.matvec_cells_cuda(
                                     d, fL, fR, v, m.op_dims))
        res = dict(
            nc=m.nc, n_faces=fl.n, n_chunks=fl.sell.n_chunks,
            launches_per_call=dict(face_blocks=launches[0],
                                   pack=launches[1]),
            bits_equal_pack_plain=bool(torch.equal(
                op.blk, lz.faces_pack_plain(fl.sell, fL, fR))),
            digest=dict(blocks=digest(r, d, fL, fR), blk=digest(op.blk),
                        matvec=digest(y)),
            times=two_ways(main_form), device_us=device_us(main_form),
            host_own_ms=enqueue_ms(main_form),
            alloc_requests=alloc_requests(main_form))
        del op, y
        # the first report step, after a warm-up run of it
        sim.run(init, report_step_limit=1)
        sim = SimulatorFullyImplicitBlackoil(norne)
        init = initial_state(sim.grid, sim.props, norne,
                             len(sim.well_names))
        n0 = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin = sim.run(init, report_step_limit=1)
        torch.cuda.synchronize()
        rep = sim.report
        n = [a - b for a, b in zip(counts(), n0)]
        res.update(
            wall_s=time.perf_counter() - t0,
            counts=[rep.substeps, rep.newton_iterations,
                    rep.linear_iterations, rep.failed_substeps],
            launches_per_newton=dict(
                face_blocks=n[0] / rep.newton_iterations,
                pack=n[1] / rep.newton_iterations),
            state_digest=digest(fin.pressure, fin.sw, fin.x, fin.bhp,
                                fin.qs))
        out[label] = res
        del sim, init, fin
        torch.cuda.empty_cache()
    os.environ.pop("OPM_TPU_EMBED", None)
    print(json.dumps(out), flush=True)


def _sweep():
    import torch

    from opm_tpu_torch.models import blackoil as mb
    from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
    from opm_tpu_torch.sim.testcases import spe10like_case
    from opm_tpu_torch.utils import cuda_lib

    src = os.path.join(cuda_lib.CSRC, "cells.cu")
    bdir = os.path.join(cuda_lib.BUILD_DIR, "k2_sweep")
    os.makedirs(bdir, exist_ok=True)
    jobs = []
    for vt, vb, dt_, db in SWEEP:
        lib = os.path.join(bdir, f"libcells_{vt}_{vb}_{dt_}_{db}.so")
        defs = [f"-DOPM_K2_VAL_THREADS={vt}", f"-DOPM_K2_VAL_MINB={vb}",
                f"-DOPM_K2_DUAL_THREADS={dt_}", f"-DOPM_K2_DUAL_MINB={db}"]
        proc = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *defs, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append(((vt, vb, dt_, db), lib, proc))
    sim = SimulatorFullyImplicitBlackoil(spe10like_case(**SPE10))
    m = sim.model
    pack = m.props.cell_pack()
    a = seeded_state(m)
    acc0 = torch.zeros((3, m.nc), dtype=torch.float64, device=m.device)
    points = []
    for cfg, lib, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {cfg}:\n{err}")
        cl = ctypes.CDLL(lib)
        for fn, sig in mb._CELLS_SIGS.items():
            argtypes, restype = (sig if isinstance(sig, tuple)
                                 else (sig, ctypes.c_int))
            getattr(cl, fn).argtypes = argtypes
            getattr(cl, fn).restype = restype
        cuda_lib._libs["cells"] = cl
        pt = dict(config=dict(zip(("val_threads", "val_minb", "dual_threads",
                                   "dual_minb"), cfg)),
                  ptxas=parse_ptxas(err),
                  occupancy=mb.cells_occupancy(m.device),
                  times=k2_times(pack, a, acc0, m.pv, 86400.0))
        points.append(pt)
        print(json.dumps(pt), flush=True)
    cuda_lib._libs.pop("cells", None)
    return dict(nc=m.nc, points=points)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trees", help="BASE,CHANGE: two repository roots")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--part", default="all", choices=("all", "faces"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--leg", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("assembly_ab: no CUDA device visible")
    if args.leg:
        (_faces_leg if args.part == "faces" else _leg)(
            os.path.abspath(args.leg))
        return 0
    card = smi()
    if args.sweep:
        res = dict(device=card, sweep=_sweep())
    else:
        trees = [os.path.abspath(t) for t in args.trees.split(",")]
        legs = []
        for letter in args.order:
            tree = trees["AB".index(letter)]
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--leg", tree,
                 "--part", args.part],
                capture_output=True, text=True, cwd=tree)
            if proc.returncode != 0:
                raise SystemExit(f"assembly_ab: leg {letter} failed:\n"
                                 f"{proc.stderr[-4000:]}")
            leg = json.loads(proc.stdout.strip().splitlines()[-1])
            leg["leg"] = letter
            legs.append(leg)
            print(json.dumps(leg), flush=True)
        res = dict(device=card, order=args.order, part=args.part,
                   trees=trees, legs=legs)
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
