"""The port's face-list path against the JAX package on the toy Norne-like
deck (norne_like_deck(nx=12, ny=24, nz=22): two stair-step faults, ACTNUM
holes), in both representations, on the CPU in float64:

- embedded (OPM_TPU_EMBED unset): 6336 box cells, the stencil plus 1408
  extra fault faces, structured GMG;
- gather (OPM_TPU_EMBED=0): 4176 cells, 11793 faces, aggregation AMG.

Inputs: the deck's initial state (EQUIL) after the first report step's well
initialisation, its pressure perturbed by seeded noise (so that every face
carries flow and both upwind directions occur), accumulation at the
unperturbed state, dt = 1 day, seeded vectors; the same arrays go to both
packages. The reference runs once per representation, in one jitted
function over every quantity compared.

Tolerances: face fluxes and their divergence 1e-12 of max (the face
kernels' twins sum in the reference's scatter order); the assembled system
(r_cell, diag, face_L, face_R and the well blocks) 1e-11 of each field's
max; the operator, the Schur-reduced operator, its right-hand side and the
well recovery, the CPR weights, pressure system and the GMG's stencil-only
couplings (_pressure_off_for) 1e-12 of max; the masked convergence norms
1e-11 relative. (The CPR apply over these systems is held to the
reference through the aggregation AMG in tests/test_torch_amg.py and end
to end in tests/test_torch_norne.py.)

K4-faces' sliced-ELL layout (the operator the card's kernel reads): the
pack's twin, read back slot by slot in plain torch as the kernel reads
it, gives faces_matvec_plain and faces_smooth_plain bit for bit
(``torch.equal``), with a full and a pressure-only iterate, on both
representations; pads hold NaN in that check, so no sum touches one. The
copy the card's face blocks write in their row phase
(``faces_blocks_packed_plain``, its twin) equals the pack's, slot by slot
as the row phase writes it, and the operator read from it holds to the
reference's gather matvec (1e-12 of max)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from opm_tpu.linalg import precond as rprecond
from opm_tpu.models import linearize as rlin
from opm_tpu.models.blackoil import make_well_device_arrays as ref_wd
from opm_tpu.models.state import BlackoilState as RefState
from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil as RefSim
from opm_tpu.sim.testcases import norne_like_case as ref_norne_like_case
from opm_tpu_torch.linalg import precond
from opm_tpu_torch.models import linearize
from opm_tpu_torch.models.blackoil import (SELL_PAD, cells_assemble_plain,
                                          faces_div_plain, faces_flux_plain,
                                          make_well_device_arrays,
                                          tpfa_div_plain)
from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                        init_well_state, report_step_wells)
from opm_tpu_torch.sim.init import initial_state
from opm_tpu_torch.sim.testcases import norne_like_case
from opm_tpu_torch.solver.newton import connection_offsets
from opm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

TOY = dict(nx=12, ny=24, nz=22, tsteps="1 2 5")
DT = 86400.0
REPS = [("embedded", None), ("gather", "0")]


def _with_knob(knob, fn):
    old = os.environ.pop("OPM_TPU_EMBED", None)
    if knob is not None:
        os.environ["OPM_TPU_EMBED"] = knob
    try:
        return fn()
    finally:
        os.environ.pop("OPM_TPU_EMBED", None)
        if old is not None:
            os.environ["OPM_TPU_EMBED"] = old


@pytest.fixture(scope="module", params=REPS, ids=[r[0] for r in REPS])
def toy(request):
    rep, knob = request.param
    port = _with_knob(knob, lambda: SimulatorFullyImplicitBlackoil(
        norne_like_case(**TOY), device="cpu"))
    ref = _with_knob(knob, lambda: RefSim(ref_norne_like_case(**TOY),
                                          fused=False))
    m = port.model
    step = port.schedule.report_steps[0]
    ws = report_step_wells(step, port.grid, port.well_names, port.max_perf)
    wd_p = make_well_device_arrays(ws, port.grid.gravity, "cpu")
    ws_r = ref._pad_well_set(ref._well_set_for(ref.schedule.report_steps[0]))
    wd_r = ref_wd(ws_r, ref.grid.gravity)
    s0 = initial_state(port.grid, port.props, port.case, ws.nw)
    s0 = init_well_state(s0, ws, True)
    acc0 = m.accumulation(s0)
    rng = np.random.default_rng(11)
    snp = state_to_numpy(s0)
    snp["pressure"] = snp["pressure"] + 2.0e4 * rng.standard_normal(m.nc)
    s_p = state_from_numpy(snp, "cpu")
    cdp = connection_offsets(m, s_p, wd_p)
    s_r = RefState(**{k: (None if snp.get(k) is None else jnp.asarray(snp[k]))
                      for k in RefState._fields})
    dims = m.op_dims
    v = rng.standard_normal((3, m.nc))
    vw = rng.standard_normal((ws.nw, 4))
    amg_r = ref.solver.amg
    rmodel = ref.model

    def ref_all(state, acc0, wd, cdp, v, vw):
        dt = jnp.asarray(DT)
        q = rmodel.cell_quantities(state)
        flux = rmodel.face_fluxes(q)
        res = rmodel.residual(state, acc0, dt, wd, cdp)
        sys = rlin.assemble(rmodel, state, acc0, dt, wd, cdp)
        mv, rhs, rec = rlin.schur_eliminate_wells(sys, dims=dims)
        w = rprecond.quasi_impes_weights(sys.diag)
        diag_p, off = rprecond.cpr_pressure_system(sys, w, dims=dims)
        return dict(flux=flux, div=rmodel.divergence(flux), res=res,
                    conv=rmodel.convergence(res, dt, state), sys=sys,
                    rhs=rhs, mv=mv(v), rec=rec(v),
                    full=rlin.matvec(sys, v, vw, dims=dims), w=w,
                    cells_only=rlin.matvec(sys, v, jnp.zeros_like(vw),
                                           dims=dims)[0],
                    diag_p=diag_p, off=off,
                    off_h=rprecond._pressure_off_for(amg_r, off, dims))

    out = jax.jit(ref_all)(s_r, jnp.asarray(acc0.numpy()), wd_r,
                           jnp.asarray(cdp.numpy()), jnp.asarray(v),
                           jnp.asarray(vw))
    out = jax.tree.map(np.asarray, out)
    sys = linearize.assemble(m, s_p, acc0, DT, wd_p, cdp)
    return dict(rep=rep, port=port, s=s_p, acc0=acc0, wd=wd_p, cdp=cdp,
                dims=dims, sys=sys, v=torch.from_numpy(v),
                vw=torch.from_numpy(vw), ref=out)


def _scaled(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= tol * max(np.abs(b).max(), 1e-300), \
        f"{err / max(np.abs(b).max(), 1e-300):.3e} of max"


def test_representation(toy):
    m = toy["port"].model
    if toy["rep"] == "embedded":
        assert m.op_dims is not None and m.faces.first == m.nf_canonical
        assert m.faces.n == 1408 and m.conv_mask is not None
    else:
        assert m.op_dims is None and m.faces.first == 0
        assert m.faces.n == 11793 and m.conv_mask is None


def test_face_fluxes_and_divergence(toy):
    m = toy["port"].model
    q = m.cell_quantities(toy["s"])
    flux = m.face_fluxes(q)
    _scaled(flux.numpy(), toy["ref"]["flux"], 1e-12)
    _scaled(m.flux_divergence(q).numpy(), toy["ref"]["div"], 1e-12)
    # the divergence through the K3-faces twin is the fluxes' scatter
    assert float(flux.abs().max()) > 0.0


def test_face_blocks_rows_after_faces(toy):
    """The face-list face blocks in the card kernel's order: each face's
    flux and blocks once (the face phase), then each row of the cells the
    faces touch adds its faces in the CSR's order, r += flux and d +=
    face_L as the left cell, r += (-flux) and d += (-face_R) as the right
    cell (the row phase, emulated here in numpy), equal bit for bit to
    faces_blocks_plain's index_add_ (left cells, then right cells)."""
    m, s = toy["port"].model, toy["s"]
    fl = m.faces
    fv, fc, r0, d0 = cells_assemble_plain(
        m.props, s.pressure, s.sw, s.x, s.hcstate, m.pvtnum, m.satnum,
        toy["acc0"], m.pv, DT)
    nf = m.trans.shape[0]
    r, d = r0.clone(), d0.clone()
    fL = torch.zeros((9, nf), dtype=torch.float64)
    fR = torch.zeros_like(fL)
    linearize.faces_blocks_plain(fl, fv, fc, m.depth, m.trans, m.gravity, r,
                                 d, fL, fR)
    flux = faces_flux_plain(fl, fv[0:3], fv[3:6], fv[6:9], fv[9], fv[10],
                            m.depth, m.trans, m.gravity).numpy()
    L, R = fL.numpy(), fR.numpy()
    csr = fl.touched
    ptr, ent = csr.ptr.numpy().astype(np.int64), csr.ent.numpy()
    cell = (np.arange(csr.n_rows) if csr.rows is None
            else csr.rows.numpy().astype(np.int64))
    re, de = r0.numpy()[:, cell], d0.numpy()[:, cell]
    lens = np.diff(ptr)
    assert lens.min() >= 1 and lens.max() > lens.min()
    for j in range(int(lens.max())):
        k = np.nonzero(lens > j)[0]
        e = ent[ptr[k] + j].astype(np.int64)
        left = e >= 0
        f = np.where(left, e, -e - 1)
        i = f - fl.first
        re[:, k] = re[:, k] + np.where(left, flux[:, i], -flux[:, i])
        de[:, k] = de[:, k] + np.where(left, L[:, f], -R[:, f])
    assert np.array_equal(re, r.numpy()[:, cell])
    assert np.array_equal(de, d.numpy()[:, cell])
    rest = np.ones(m.nc, dtype=bool)
    rest[cell] = False
    assert np.array_equal(r.numpy()[:, rest], r0.numpy()[:, rest])
    assert np.array_equal(d.numpy()[:, rest], d0.numpy()[:, rest])


def test_faces_div_rows_after_faces(toy):
    """K3-faces' divergence in the card kernel's order: each row of the
    list's CSR adds its faces' fluxes in the CSR's order, flux as the left
    cell and (-flux) as the right cell (emulated here in numpy from the
    fluxes in face order), from 0.0 on every cell of the gather grid and
    from the structured divergence on the embedded grid's touched rows,
    equal bit for bit to faces_div_plain's index_add_ (left cells, then
    right cells): the order in which the card's sums are held to the
    twin's on CPU copies."""
    m, s = toy["port"].model, toy["s"]
    fl = m.faces
    q = m.cell_quantities(s)
    args = (torch.stack([q.pw, q.po, q.pg]).contiguous(), q.rho.contiguous(),
            (q.b * q.mob).contiguous(), q.rs.contiguous(), q.rv.contiguous(),
            m.depth)
    if m.op_dims is None:
        base, csr = None, fl.full
        start = np.zeros((3, m.nc))
    else:
        base = tpfa_div_plain(m.op_dims, *args, m.trans_stencil, m.gravity)
        csr = fl.touched
        start = base.numpy()
    plain = faces_div_plain(fl, *args, m.trans, m.gravity, out=base).numpy()
    flux = faces_flux_plain(fl, *args, m.trans, m.gravity).numpy()
    ptr, ent = csr.ptr.numpy().astype(np.int64), csr.ent.numpy()
    cell = (np.arange(csr.n_rows) if csr.rows is None
            else csr.rows.numpy().astype(np.int64))
    assert (csr.rows is None) == (m.op_dims is None)
    acc = start[:, cell].copy()
    lens = np.diff(ptr)
    assert lens.max() > lens.min()
    for j in range(int(lens.max())):
        k = np.nonzero(lens > j)[0]
        e = ent[ptr[k] + j].astype(np.int64)
        left = e >= 0
        i = np.where(left, e, -e - 1) - fl.first
        acc[:, k] = acc[:, k] + np.where(left, flux[:, i], -flux[:, i])
    assert np.array_equal(acc, plain[:, cell])
    rest = np.ones(m.nc, dtype=bool)
    rest[cell] = False
    assert np.array_equal(plain[:, rest], start[:, rest])


@pytest.mark.parametrize("field", ["r_cell", "r_well", "diag", "face_L",
                                   "face_R", "cw", "wc", "wd_diag"])
def test_assembly_matches_reference(toy, field):
    r = getattr(toy["ref"]["sys"], field)
    if isinstance(r, tuple):
        r = np.stack(r)
    _scaled(getattr(toy["sys"], field).numpy(), r, 1e-11)


def test_operator_matches_reference(toy):
    oc, ow = linearize.matvec(toy["sys"], toy["v"], toy["vw"], toy["dims"])
    rc, rw = toy["ref"]["full"]
    _scaled(oc.numpy(), rc, 1e-12)
    _scaled(ow.numpy(), rw, 1e-12)


def test_schur_matches_reference(toy):
    mv, rhs, rec = linearize.schur_eliminate_wells(toy["sys"], toy["dims"])
    _scaled(rhs.numpy(), toy["ref"]["rhs"], 1e-12)
    _scaled(mv(toy["v"]).numpy(), toy["ref"]["mv"], 1e-12)
    _scaled(rec(toy["v"]).numpy(), toy["ref"]["rec"], 1e-12)


def test_fused_composition_matches_reference(toy):
    """The plain composition the card's fused reduced operator is held to
    (the cell operator's twins, then the well term, over the prepared well
    arguments on CPU tensors) against the reference's reduced operator and
    right-hand side, in both representations (1e-12 of max)."""
    sys = toy["sys"]
    wt = linearize.WellTerm(sys, precond.inv4x4(sys.wd_diag).contiguous())
    _scaled(linearize.reduced_matvec_plain(wt.sys, wt.Dinv, toy["v"],
                                           toy["dims"]).numpy(),
            toy["ref"]["mv"], 1e-12)
    _scaled(linearize.schur_rhs_plain(wt.sys, wt.Dinv).numpy(),
            toy["ref"]["rhs"], 1e-12)


def test_pressure_system_matches_reference(toy):
    sys = toy["sys"]
    _, w, diag_p, off = precond.cpr_setup_plain(
        sys.diag, sys.face_L, sys.face_R, toy["dims"], sys.faces)
    ref = toy["ref"]
    _scaled(w.numpy(), ref["w"], 1e-12)
    _scaled(diag_p.numpy(), ref["diag_p"], 1e-12)
    _scaled(off.numpy(), ref["off"], 1e-12)
    amg = toy["port"].solver.amg
    off_h = precond._pressure_off_for(amg, off, toy["dims"])
    _scaled(off_h.numpy(), ref["off_h"], 1e-12)
    # what the hierarchy takes: the GMG drops the extra faces, the AMG
    # keeps every face
    nf = toy["port"].model.trans.shape[0]
    nfc = toy["port"].model.nf_canonical
    assert off_h.shape[0] == 2 * (nfc if toy["rep"] == "embedded" else nf)
    _, _, _, off_k = precond.cpr_setup(sys, toy["dims"], amg)
    torch.testing.assert_close(off_k, off_h, rtol=0, atol=0)


def test_convergence_matches_reference(toy):
    m = toy["port"].model
    res = m.residual(toy["s"], toy["acc0"], DT, toy["wd"], toy["cdp"])
    _scaled(res.cell.numpy(), toy["ref"]["res"].cell, 1e-12)
    conv = m.convergence(res, DT, toy["s"])
    rconv = toy["ref"]["conv"]
    for k in ("mb", "cnv", "well_flux", "well_ctrl"):
        np.testing.assert_allclose(conv[k].numpy(), rconv[k], rtol=1e-11,
                                   atol=0, err_msg=k)
    for k in ("converged", "finite"):
        assert bool(conv[k]) == bool(rconv[k]), k



def _sell_apply(fl, blk, diag, x, dinv=None, r=None, base=None,
                in_place=False):
    """K4-faces' arithmetic read from the sliced-ELL layout in plain torch,
    as the kernel reads it: a thread per row of the layout (``in_place``:
    only the touched cells change), else a thread per cell, which finds its
    row through ``row_of``; each from diag x (or base), then its row's slots
    in order (each row stops at its own length), then the smoothing
    epilogue when dinv is given."""
    sell = fl.sell
    x3 = linearize.full3(x)
    y = linearize.bapply_rows(diag, x3) if base is None else base.clone()
    ptr = sell.ptr.long()
    lens = ptr[1:] - ptr[:-1]
    if in_place or sell.row_of is None:
        row = torch.arange(sell.n_rows)
        cell = row if sell.rows is None else sell.rows.long()
    else:
        cell = torch.arange(sell.nc)
        row = sell.row_of.long()
        cell, row = cell[row >= 0], row[row >= 0]
    ch0 = sell.chunk0.long()[row // 32]
    lane = row % 32
    blocks = blk.reshape(-1, 9, 32)
    for j in range(int(lens.max())):
        k = torch.nonzero(lens[row] > j).squeeze(1)
        ch = ch0[k] + j
        o = sell.col.long()[32 * ch + lane[k]]
        y[:, cell[k]] = y[:, cell[k]] + linearize.bapply_rows(
            blocks[ch, :, lane[k]].T, x3[:, o])
    if dinv is None:
        return y
    return x3 + linearize.bapply_rows(dinv, r - y)


def test_sell_layout(toy):
    """The layout's rows are the touched cells' (every cell on the gather
    grid; the cells the extra faces touch on the embedded grid), with
    rows and row_of inverse to each other; every CSR entry sits once in
    its row's slots, in the CSR's order; slices hold rows of uneven length;
    the pack's twin signs the blocks."""
    m = toy["port"].model
    fl, sys = m.faces, toy["sys"]
    sell, csr = fl.sell, fl.touched
    ptr = csr.ptr.long()
    lens = ptr[1:] - ptr[:-1]
    n = sell.n_rows
    assert sell.nc == m.nc and sys.packed is None
    assert torch.equal(sell.ptr, csr.ptr)
    if toy["dims"] is None:
        assert n == m.nc and sell.rows is None and sell.row_of is None
    else:
        assert n == csr.n_rows < m.nc and bool((lens > 0).all())
        assert torch.equal(sell.rows, csr.rows)
        assert torch.equal(sell.row_of.long()[sell.rows.long()],
                           torch.arange(n))
        assert int((sell.row_of >= 0).sum()) == n
    row = torch.repeat_interleave(torch.arange(n), lens)
    slot = torch.arange(int(ptr[-1])) - ptr[row]
    e = 32 * (sell.chunk0.long()[row // 32] + slot) + row % 32
    assert torch.equal(sell.src.long()[e], csr.ent.long())
    assert torch.equal(sell.col.long()[e], csr.nbr.long())
    pads = torch.ones(32 * sell.n_chunks, dtype=torch.bool)
    pads[e] = False
    assert bool((sell.src.long()[pads] == SELL_PAD).all())
    widths = sell.chunk0[1:] - sell.chunk0[:-1]
    lp = torch.zeros(len(widths) * 32, dtype=torch.long)
    lp[:n] = lens
    lp = lp.reshape(-1, 32)
    assert torch.equal(lp.max(dim=1).values, widths.long())
    assert bool((lp.min(dim=1).values < widths).any())
    blk = linearize.faces_pack_plain(sell, sys.face_L, sys.face_R)
    blocks = blk.reshape(-1, 9, 32)
    k = int(torch.nonzero(csr.ent < 0)[0])
    f = -int(csr.ent[k]) - 1
    ek = int(e[k])
    assert torch.equal(blocks[ek // 32, :, ek % 32], -sys.face_L[:, f])
    k = int(torch.nonzero(csr.ent >= 0)[0])
    ek = int(e[k])
    assert torch.equal(blocks[ek // 32, :, ek % 32],
                       sys.face_R[:, int(csr.ent[k])])


@pytest.mark.parametrize("iterate", ["full", "pressure"])
def test_sell_operator_matches_face_list(toy, iterate):
    m = toy["port"].model
    fl, sys, dims = m.faces, toy["sys"], toy["dims"]
    ops = (sys.diag, sys.face_L, sys.face_R)
    blk = linearize.faces_pack_plain(fl.sell, sys.face_L, sys.face_R)
    # pads are never read
    pads = torch.repeat_interleave(fl.sell.src == SELL_PAD, 9)
    blk = blk.reshape(-1, 9, 32).permute(1, 0, 2).reshape(9, -1)
    blk[:, fl.sell.src == SELL_PAD] = float("nan")
    blk = blk.reshape(9, -1, 32).permute(1, 0, 2).reshape(-1)
    assert int(torch.isnan(blk).sum()) == int(pads.sum())
    rng = np.random.default_rng(17)
    x = torch.as_tensor(rng.standard_normal((3, m.nc)))
    if iterate == "pressure":
        x = x[0].contiguous()
    r = torch.as_tensor(rng.standard_normal((3, m.nc)))
    dinv = precond.cpr_setup_plain(*ops, dims, fl)[0]
    base = None if dims is None else linearize.matvec_cells_plain(*ops, x,
                                                                 dims)
    assert torch.equal(_sell_apply(fl, blk, sys.diag, x, base=base,
                                   in_place=base is not None),
                       linearize.faces_matvec_plain(fl, *ops, x, base))
    assert torch.equal(_sell_apply(fl, blk, sys.diag, x),
                       linearize.faces_matvec_plain(fl, *ops, x))
    assert torch.equal(
        _sell_apply(fl, blk, sys.diag, x, dinv, r, base),
        linearize.faces_smooth_plain(fl, *ops, dinv, x, r, base))


def test_packed_blocks_from_row_phase(toy):
    """The face blocks with K4-faces' copy (``faces_blocks_packed_plain``,
    the CPU path and the card kernel's oracle): sums and blocks those of
    faces_blocks_plain, the copy faces_pack_plain's of its blocks, bit for
    bit; the row phase's writes emulated in numpy (the thread of block
    entry b and row t writes the CSR's k-th entry of the row at slot
    k - ptr[t]: +face_R of the face where the row's cell is the left cell,
    -face_L where it is the right one; then 0 up to its slice's width, and
    0 in every slot of the last slice's lanes that hold no row) give the
    same copy; the operator read from it holds to the reference's gather
    matvec (1e-12 of max)."""
    m, s = toy["port"].model, toy["s"]
    fl, dims = m.faces, toy["dims"]
    fv, fc, r0, d0 = cells_assemble_plain(
        m.props, s.pressure, s.sw, s.x, s.hcstate, m.pvtnum, m.satnum,
        toy["acc0"], m.pv, DT)
    nf = m.trans.shape[0]

    def run(fn):
        r, d = r0.clone(), d0.clone()
        fL = torch.zeros((9, nf), dtype=torch.float64)
        fR = torch.zeros_like(fL)
        blk = fn(fl, fv, fc, m.depth, m.trans, m.gravity, r, d, fL, fR)
        return r, d, fL, fR, blk

    *plain, none = run(linearize.faces_blocks_plain)
    *packed, blk = run(linearize.faces_blocks_packed_plain)
    assert none is None
    for a, b in zip(packed, plain):
        assert torch.equal(a, b)
    assert torch.equal(blk, linearize.faces_pack_plain(fl.sell, plain[2],
                                                       plain[3]))
    sell = fl.sell
    ptr = sell.ptr.numpy().astype(np.int64)
    ent = fl.touched.ent.numpy().astype(np.int64)
    chunk0 = sell.chunk0.numpy().astype(np.int64)
    L, R = plain[2].numpy(), plain[3].numpy()
    emu = np.full(288 * sell.n_chunks, np.nan)
    n32 = -(-sell.n_rows // 32) * 32
    for t in range(n32):
        lo, hi = (ptr[t], ptr[t + 1]) if t < sell.n_rows else (0, 0)
        width = chunk0[t // 32 + 1] - chunk0[t // 32]
        base = 288 * chunk0[t // 32] + t % 32 + 32 * np.arange(9)
        for j in range(width):
            k = lo + j
            if k >= hi:
                val = np.zeros(9)
            elif ent[k] >= 0:
                val = R[:, ent[k]]
            else:
                val = -L[:, -ent[k] - 1]
            emu[base + 288 * j] = val
    assert np.array_equal(emu, blk.numpy())
    sys, v = toy["sys"], toy["v"]
    f = fl.first
    assert torch.equal(sys.face_L[:, f:], plain[2][:, f:])
    assert torch.equal(sys.face_R[:, f:], plain[3][:, f:])
    base = None if dims is None else linearize.matvec_cells_plain(
        sys.diag, sys.face_L, sys.face_R, v, dims)
    y = _sell_apply(fl, blk, sys.diag, v, base=base,
                    in_place=base is not None)
    _scaled(y.numpy(), toy["ref"]["cells_only"], 1e-12)
