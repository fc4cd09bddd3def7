"""Port vs reference: a whole run on the paper's global quantizer.

fedpaq with ``use_pallas=False`` on both sides (one max-|g| scale per group;
on the CPU only, as the card refuses a plain path), on
``test_torch_slice_wire.py``'s small config.  ``ledger.per_round_uplink``
exact and equal to the closed form (8 bits a value and one 32-bit scale per
group, below the block-local wire's); host syncs one per round plus one
per eval.  Eval loss: with one scale for the whole group a stochastic
rounding draw that an ulp of difference in the delta flips moves one weight
by a step of ``2 max|g| / 255`` (see ``test_torch_slice_quant.py``), so the
run is held to the tolerance the reference gives its own stochastic
quantizer codecs across engines, 5e-4 absolute
(``tests/test_round_engine.py``; measured: 6.6e-5, 1.5e-5 relative)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from test_torch_slice_quant import (RUN, block_local_bits, check_ledger,  # noqa: E402
                                    check_syncs, group_sizes, run_both)

#: the reference's loss tolerance for its stochastic quantizer codecs
LOSS_ATOL = 5e-4


@pytest.fixture(scope="module")
def runs():
    return run_both(("fedpaq",), False)["fedpaq"]


def test_uplink_ledger_exact_and_closed_form(runs):
    ref, (res, _) = runs
    glob = RUN["n_clients"] * sum(8 * n + 32 for n in group_sizes())
    assert glob < block_local_bits()
    check_ledger(ref, res, glob)


def test_eval_loss_within_tolerance(runs):
    ref, (res, _) = runs
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=0, atol=LOSS_ATOL)


def test_host_syncs_within_contract(runs):
    check_syncs(*runs[1], False)
