"""Restart in the port (CPU): resume SPE1 mid-run from the port's own .npz
checkpoint, from its UNRST and from a deck RESTART keyword, held to the
uninterrupted run at the JAX package's restart-test limits
(tests/test_restart.py: .npz pressure 4e-4 of the mean, sw 1e-4; UNRST
pressure 2e-3 relative, sw 2e-3, bhp 1e-3, hcstate equal: on resume cells
exactly at sg = 0 can move GASOIL <-> OILONLY); the UNRST loader against
the JAX package's on the same file; a missing restart file raises, and a
deck RESTART whose UNRST is missing starts from EQUIL with a warning.

One uninterrupted run of NSTEPS report steps with checkpoints is shared
by the module. The .npz and UNRST resumes take the JAX package's own
test's points (from report step 3 to the end of step 5: the reference's
UNRST resume itself misses bhp's 1e-3 from step 2 to the end of step 3,
1.7e-3, as the port's does); the deck RESTART resumes after step 2 and
runs step 3 only, held as the JAX package's test_deck_restart_keyword
holds it (pressure 2e-3)."""

import os

import numpy as np
import pytest
import torch

from opm_tpu.io.eclstate import load_case as ref_load_case
from opm_tpu.io.restart import load_restart as ref_load_restart
from opm_tpu.io.restart import load_restart_unrst as ref_load_unrst
from opm_tpu.sim.blackoil import SimulatorFullyImplicitBlackoil as RefSim
from opm_tpu_torch.io.eclstate import load_case, load_case_string
from opm_tpu_torch.sim.blackoil import SimulatorFullyImplicitBlackoil
from opm_tpu_torch.utils.convert import state_to_numpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE1 = os.path.join(ROOT, "data", "SPE1CASE2.DATA")
NSTEPS = 6
RESUME = 3          # .npz and UNRST: resume after report step index 3
DECK_RESUME = 2     # deck RESTART: after index 2, run index 3 only


@pytest.fixture(scope="module")
def spe1(tmp_path_factory):
    """The uninterrupted run with checkpoints and its per-step states."""
    out = str(tmp_path_factory.mktemp("spe1_restart"))
    sim = SimulatorFullyImplicitBlackoil(load_case(SPE1), output_dir=out,
                                         device="cpu")
    states = []
    sim.events.event("report_step_completed").add(
        lambda s, step: states.append(state_to_numpy(s)))
    sim.run(report_step_limit=NSTEPS, write_restart=True)
    return out, states


def _resume(limit=NSTEPS, **kw):
    sim = SimulatorFullyImplicitBlackoil(kw.pop("case", None)
                                         or load_case(SPE1), device="cpu")
    state = sim.run(report_step_limit=limit, **kw)
    return sim, state_to_numpy(state)


def _pressure_rel(a, b):
    return (np.abs(a["pressure"] - b["pressure"]) / np.maximum(
        np.abs(a["pressure"]), 1.0)).max()


def test_deck_restart_keyword_resumes(spe1):
    """A deck with RESTART 'SPE1CASE2' 2 / resumes from SPE1CASE2.UNRST
    beside it after report step 2, as the JAX package's driver does
    (tests/test_restart.py::test_deck_restart_keyword): of four report
    steps only the last runs, and it ends at the uninterrupted run's
    state."""
    out, states = spe1
    with open(SPE1) as f:
        text = f.read()
    text = text.replace(
        "SOLUTION", f"SOLUTION\nRESTART\n 'SPE1CASE2' {DECK_RESUME} /\n",
        1)
    deck = os.path.join(out, "SPE1RST.DATA")
    with open(deck, "w") as f:
        f.write(text)
    case = load_case(deck)
    assert case.solution.restart == ("SPE1CASE2", DECK_RESUME)
    sim, end = _resume(limit=DECK_RESUME + 2, case=case)
    assert [s[0] for s in sim._step_timing] == [DECK_RESUME + 1]
    assert len(sim.summary.rows) == 1
    assert _pressure_rel(states[DECK_RESUME + 1], end) < 2e-3


def test_npz_resume(spe1):
    out, states = spe1
    sim, end = _resume(restart_file=os.path.join(
        out, f"restart_{RESUME:04d}.npz"))
    assert [s[0] for s in sim._step_timing] == list(range(RESUME + 1,
                                                          NSTEPS))
    a = states[-1]
    assert np.abs(a["pressure"] - end["pressure"]).max() \
        / a["pressure"].mean() < 4e-4
    assert np.abs(a["sw"] - end["sw"]).max() < 1e-4
    assert np.array_equal(a["hcstate"], end["hcstate"])


def test_unrst_resume(spe1):
    out, states = spe1
    sim, end = _resume(restart_file=os.path.join(out, "SPE1CASE2.UNRST"),
                       restart_step=RESUME)
    assert [s[0] for s in sim._step_timing] == list(range(RESUME + 1,
                                                          NSTEPS))
    a = states[-1]
    assert _pressure_rel(a, end) < 2e-3
    assert np.abs(a["sw"] - end["sw"]).max() < 2e-3
    assert np.array_equal(a["hcstate"], end["hcstate"])
    # the well state round-tripped through OPM_XWEL
    assert np.allclose(a["bhp"], end["bhp"], rtol=1e-3)


def test_checkpoint_matches_state_and_reference_reader(spe1):
    """The .npz checkpoint holds the report step's state bit for bit, and
    the JAX package's reader reads it."""
    out, states = spe1
    path = os.path.join(out, f"restart_{RESUME:04d}.npz")
    ref_state, ref_meta = ref_load_restart(path)
    for name in ("pressure", "sw", "x", "hcstate", "bhp", "qs", "control",
                 "target"):
        assert np.array_equal(np.asarray(getattr(ref_state, name)),
                              states[RESUME][name]), name
    assert ref_meta["report_step"] == RESUME


def test_unrst_loader_matches_reference(spe1):
    """The port's UNRST loader and the JAX package's on the same file: x,
    hcstate and the well state equal, pressure within one ulp."""
    from opm_tpu_torch.io.restart import load_restart_unrst
    out, _ = spe1
    path = os.path.join(out, "SPE1CASE2.UNRST")
    ref = RefSim(ref_load_case(SPE1), fused=False)
    rs, rmeta = ref_load_unrst(path, RESUME, ref.case, ref.props, ref.model)
    port = SimulatorFullyImplicitBlackoil(load_case(SPE1), device="cpu")
    ps, pmeta = load_restart_unrst(path, RESUME, port.case, port.model)
    p = state_to_numpy(ps)
    rp = np.asarray(rs.pressure)
    assert np.all(np.abs(p["pressure"] - rp) <= np.spacing(np.abs(rp)))
    for name in ("sw", "x", "hcstate", "bhp", "qs", "control", "target"):
        assert np.array_equal(p[name], np.asarray(getattr(rs, name))), name
    assert pmeta == rmeta


def test_missing_restart_file_raises(tmp_path):
    sim = SimulatorFullyImplicitBlackoil(load_case(SPE1), device="cpu")
    with pytest.raises(FileNotFoundError):
        sim.run(restart_file=str(tmp_path / "restart_0002.npz"))


def test_deck_restart_without_unrst_warns(tmp_path, capsys):
    """A deck RESTART whose UNRST is missing starts from the initial state,
    as the JAX package does, and says so on stdout and in the PRT, naming
    the paths it tried."""
    from opm_tpu_torch.sim.testcases import mini_blackoil_deck
    text = mini_blackoil_deck(nx=3, ny=3, nz=1, tsteps="2*10").replace(
        "SOLUTION", "SOLUTION\nRESTART\n 'NOSUCH' 1 /\n", 1)
    case = load_case_string(text)
    assert case.solution.restart == ("NOSUCH", 1)
    sim = SimulatorFullyImplicitBlackoil(case, output_dir=str(tmp_path),
                                         device="cpu")
    sim.run()
    said = capsys.readouterr().out
    assert "WARNING" in said and "NOSUCH.UNRST" in said
    prt = (tmp_path / "MINI.PRT").read_text()
    assert "WARNING" in prt and "NOSUCH.UNRST" in prt
    assert [s[0] for s in sim._step_timing] == [0, 1]
