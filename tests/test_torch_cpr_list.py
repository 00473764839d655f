"""K6 on a face list (the gather route's CPR setup) on the CPU: the plain
version of the main path's launch, K6 as the first phases of K10's value
refresh, against the composition of the plain setup and refresh, and the
JAX package.

Inputs: the toy Norne-like deck's gather grid (norne_like_deck(nx=12,
ny=24, nz=22), OPM_TPU_EMBED=0: 4176 cells, 11793 faces), its first
Newton system at the initial state after the first report step's well
initialisation, dt = 1 day; and seeded face lists with a cell with no
faces, faces out of cell order and a cell with ten faces, each with its
aggregation hierarchy (random positive transmissibilities).

- The refresh with K6 as its first phases (``cpr_setup_refresh_plain``:
  the cell part, then the face list's couplings, as the kernel's phases)
  leaves in its buffers ``cpr_setup_plain``'s outputs and the per-level
  composition of ``coarsen_values`` bit for bit (``torch.equal``).
- Its setup against the JAX package's ``inv3x3_rows``,
  ``quasi_impes_weights`` and ``cpr_pressure_system(dims=None)`` on the
  same arrays: within 1e-13 of each output's max (its jnp.sum over the
  three weights may add in another order); its levels against the JAX
  package's ``DeviceAmg.coarsen_values`` of the reference's pressure
  system at ``tests/test_torch_amg.py``'s tolerances (every level 1e-12
  relative, the float32 inverse 1e-5 of max).
- ``pressure_setup`` and ``cpr_setup`` on CPU tensors: the plain twins,
  bit for bit the refresh form's plain version and its inverse.
- The buffers: two setups into one ``SetupOut`` return the same storage,
  the second call's values overwriting the first's."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from opm_tpu.linalg import amg as ramg
from opm_tpu.linalg import precond as rprecond
from opm_tpu_torch.linalg import amg
from opm_tpu_torch.linalg import precond
from opm_tpu_torch.linalg.gmg import StructuredGmg
from opm_tpu_torch.models import linearize
from opm_tpu_torch.models.blackoil import FaceList, make_well_device_arrays
from opm_tpu_torch.sim.blackoil import (SimulatorFullyImplicitBlackoil,
                                        init_well_state, report_step_wells)
from opm_tpu_torch.sim.init import initial_state
from opm_tpu_torch.sim.testcases import norne_like_case
from opm_tpu_torch.solver.newton import connection_offsets

torch.set_num_threads(2)

TOY = dict(nx=12, ny=24, nz=22, tsteps="1 2 5")
TOL_REF = 1e-13
TOL_F32_INV = 1e-5


@pytest.fixture(scope="module")
def toy():
    old = os.environ.pop("OPM_TPU_EMBED", None)
    os.environ["OPM_TPU_EMBED"] = "0"
    try:
        sim = SimulatorFullyImplicitBlackoil(norne_like_case(**TOY),
                                             device="cpu")
    finally:
        os.environ.pop("OPM_TPU_EMBED", None)
        if old is not None:
            os.environ["OPM_TPU_EMBED"] = old
    m = sim.model
    assert m.op_dims is None and m.faces.first == 0
    ws = report_step_wells(sim.schedule.report_steps[0], sim.grid,
                           sim.well_names, sim.max_perf)
    wd = make_well_device_arrays(ws, sim.grid.gravity, "cpu")
    st = init_well_state(initial_state(sim.grid, sim.props, sim.case, ws.nw),
                         ws, True)
    sys = linearize.assemble(m, st, m.accumulation(st), 86400.0, wd,
                             connection_offsets(m, st, wd))
    return sim, sys


def _seeded_list(seed):
    """(face list, diag, face_L, face_R): 300 cells, 700 random faces in
    no cell order, cell 7 the left or right cell of ten more, cell 0 on
    no face."""
    rng = np.random.default_rng(seed)
    nc = 300
    fc = rng.integers(1, nc, (1400, 2))
    fc = fc[(fc[:, 0] != fc[:, 1]) & (fc != 7).all(axis=1)][:700]
    hub = np.stack([np.full(10, 7), rng.choice(np.arange(8, nc), 10,
                                               replace=False)], axis=1)
    hub[::2] = hub[::2, ::-1]
    fc = np.concatenate([fc, hub])
    fc = fc[rng.permutation(len(fc))]
    fl = FaceList(fc, nc, 0, "cpu")
    counts = np.bincount(fc.reshape(-1), minlength=nc)
    assert counts[0] == 0 and counts[7] == 10
    assert np.any(np.diff(fc[:, 0]) < 0)
    diag = rng.standard_normal((9, nc))
    diag[[0, 4, 8]] += 4.0
    diag[:, 3] = 0.0                      # a singular block: det -> 1
    nf = len(fc)
    return (fl, torch.as_tensor(diag),
            torch.as_tensor(rng.standard_normal((9, nf))),
            torch.as_tensor(rng.standard_normal((9, nf))))


def _scaled(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= tol * max(np.abs(b).max(), 1e-300), \
        f"{err / max(np.abs(b).max(), 1e-300):.3e} of max"


def _reference(fl, diag, face_L, face_R):
    """(dinv (9, nc), w, diag_p, off) of the JAX package."""
    rows = tuple(jnp.asarray(r) for r in diag.numpy())
    w = rprecond.quasi_impes_weights(rows)
    rsys = SimpleNamespace(
        diag=rows, face_L=tuple(jnp.asarray(r) for r in face_L.numpy()),
        face_R=tuple(jnp.asarray(r) for r in face_R.numpy()),
        face_cells=jnp.asarray(np.stack([fl.c1.numpy(), fl.c2.numpy()], 1)))
    diag_p, off = rprecond.cpr_pressure_system(rsys, w, dims=None)
    return (np.stack([np.asarray(r) for r in rprecond.inv3x3_rows(rows)]),
            np.asarray(w), np.asarray(diag_p), np.asarray(off))


def _system(toy):
    sim, sys = toy
    return sys.faces, sys.diag, sys.face_L, sys.face_R


def _seeded_amg(fl, seed):
    """The aggregation hierarchy of a seeded face list on the CPU."""
    fc = np.stack([fl.c1.numpy(), fl.c2.numpy()], axis=1)
    trans = np.abs(np.random.default_rng(seed + 100).standard_normal(fl.n))
    return amg.build_hierarchy(fl.full.n_rows, fc, trans).device("cpu")


def _is_the_composition(damg, fl, diag, fL, fR):
    R = amg.Refresh(damg, "cpu")
    vals = precond.cpr_setup_refresh_plain(R, fl, diag, fL, fR)
    R.invert()
    setup = precond.cpr_setup_plain(diag, fL, fR, None, fl)
    assert setup[3].shape == (2 * fl.n,)
    for a, b in zip(R.setup.tensors(), setup):
        assert torch.equal(a, b)
    comp = damg.coarsen_values(setup[2], setup[3])
    nl = damg.n_levels
    assert vals is R.vals and len(vals) == len(comp) == nl + 1
    for k in range(nl):
        for a, b in zip(vals[k], comp[k]):
            assert torch.equal(a, b), k
    assert torch.equal(vals[-1], comp[-1])


def test_refresh_setup_plain_is_the_composition(toy):
    sim, _ = toy
    _is_the_composition(sim.solver.amg, *_system(toy))


@pytest.mark.parametrize("seed", [0, 1])
def test_refresh_setup_plain_is_the_composition_on_seeded_lists(seed):
    args = _seeded_list(seed)
    _is_the_composition(_seeded_amg(args[0], seed), *args)


@pytest.mark.parametrize("case", ["toy", "seeded"])
def test_refresh_setup_plain_setup_matches_reference(toy, case):
    if case == "toy":
        args, damg = _system(toy), toy[0].solver.amg
    else:
        args = _seeded_list(2)
        damg = _seeded_amg(args[0], 2)
    R = amg.Refresh(damg, "cpu")
    precond.cpr_setup_refresh_plain(R, *args)
    for a, b in zip(R.setup.tensors(), _reference(*args)):
        _scaled(a.numpy(), b, TOL_REF)


def test_refresh_setup_plain_matches_reference(toy):
    sim, sys = toy
    fl, diag, fL, fR = _system(toy)
    R = amg.Refresh(sim.solver.amg, "cpu")
    vals = precond.cpr_setup_refresh_plain(R, fl, diag, fL, fR)
    R.invert()
    _, _, diag_p, off = _reference(fl, diag, fL, fR)
    g = sim.grid
    hr = ramg.build_hierarchy(g.nc, np.asarray(g.face_cells),
                              np.asarray(g.trans))
    ref = hr.device().coarsen_values(jnp.asarray(diag_p), jnp.asarray(off))
    for k in range(sim.solver.amg.n_levels):
        for a, b in zip(vals[k], ref[k]):
            a, b = a.numpy(), np.asarray(b)
            assert a.shape == b.shape
            tol = 1e-12 * np.abs(b) + 1e-14 * np.abs(b).max()
            assert np.all(np.abs(a - b) <= tol), k
    _scaled(vals[-1].numpy(), ref[-1], TOL_F32_INV)


def test_setup_buffers_are_owned(toy):
    """Two setups into one hierarchy's buffers: the same storage, the
    second's values."""
    sim, _ = toy
    fl, diag, fL, fR = _system(toy)
    R = amg.Refresh(sim.solver.amg, "cpu")
    first = precond.cpr_setup_refresh_plain(R, fl, diag, fL, fR)
    ptrs = [t.data_ptr() for t in R.setup.tensors()]
    snap = [t.clone() for t in R.setup.tensors()]
    second = precond.cpr_setup_refresh_plain(R, fl, 2.0 * diag, fL, fR)
    now = R.setup.tensors()
    assert [t.data_ptr() for t in now] == ptrs and second is first
    want = precond.cpr_setup_plain(2.0 * diag, fL, fR, None, fl)
    for t, s, b in zip(now, snap, want):
        assert torch.equal(t, b)
    # diag_p is w^T D e_p = 1 up to rounding whatever D is
    for t, s in ((now[0], snap[0]), (now[1], snap[1]), (now[3], snap[3])):
        assert not torch.equal(t, s)
    # the structured route's buffers: one SetupOut per hierarchy and
    # device, over the stencil faces
    gmg = StructuredGmg((4, 3, 2))
    out = gmg.setup_out("cpu")
    assert out is gmg.setup_out("cpu")
    assert out.off.shape == (2 * (3 * 3 * 2 + 4 * 2 * 2 + 4 * 3 * 1),)
    assert out.dinv.shape == (9, 24) and out.w.shape == (3, 24)


def test_pressure_setup_on_cpu_is_the_refresh_form(toy):
    """On CPU tensors ``pressure_setup`` runs the plain twins (the setup,
    then the per-level composition and the inverse) in fresh tensors: bit
    for bit the refresh form's plain version and its inverse."""
    sim, sys = toy
    fl, diag, fL, fR = _system(toy)
    damg = sim.solver.amg
    R = amg.Refresh(damg, "cpu")
    vals = precond.cpr_setup_refresh_plain(R, fl, diag, fL, fR)
    R.invert()
    dinv, w, got = precond.pressure_setup(sys, None, damg)
    assert torch.equal(dinv, R.setup.dinv) and torch.equal(w, R.setup.w)
    assert dinv.data_ptr() != R.setup.dinv.data_ptr()
    for k in range(damg.n_levels):
        for a, b in zip(got[k], vals[k]):
            assert torch.equal(a, b), k
    assert torch.equal(got[-1], vals[-1])
    setup = precond.cpr_setup(sys, None, damg)
    for a, b in zip(setup, R.setup.tensors()):
        assert torch.equal(a, b)
