"""K1's EQUIL column march on the CPU against the JAX package's jitted
march (its scans compiled by XLA) on SPE1 with PBVD, SPE1CASE2_2P and the
toy SPE10-like deck: the port's twin columns and ``equilibrate_region``'s
outputs within 1e-13 relative on a 200-point depth grid.
``tests/test_torch_equil.py`` holds them bit for bit to the reference's
eager march and SPE1 to its jitted one; the decks are split over two
files to keep each short.
"""

import pytest
from test_torch_equil import (NZ, _deck, _port, _reference,
                              assert_within_1e13_of_jit)

DECKS = ("spe1_pbvd", "spe1_2p", "spe10_toy")


@pytest.fixture(scope="module")
def runs():
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in DECKS:
            text = _deck(name)
            res[name] = dict(jit=_reference(text, NZ, False, mp),
                             port=_port(text, NZ, mp))
    return res


@pytest.mark.parametrize("what", ["cols", "out"])
@pytest.mark.parametrize("deck", DECKS)
def test_within_1e13_of_reference_jit(runs, deck, what):
    assert_within_1e13_of_jit(runs[deck]["jit"], runs[deck]["port"], what)
