"""Port vs reference: a whole run of FedQClip on the block-local wire.

fedqclip (clip 100, 8 bits) with ``use_pallas=True`` on both sides, on
``test_torch_slice_wire.py``'s small config, held as
``test_torch_slice_quant.py`` holds fedpaq: ledger exact and equal to the
block-local closed form, eval loss within rtol 1e-5 (measured: 4.0e-6),
host syncs one per round plus one per eval.  The reference runs once, in a
module-scoped fixture."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from test_torch_slice_quant import (LOSS_RTOL, block_local_bits,  # noqa: E402
                                    check_ledger, check_syncs, run_both)


@pytest.fixture(scope="module")
def runs():
    return run_both(("fedqclip",), True)["fedqclip"]


def test_uplink_ledger_exact_and_closed_form(runs):
    ref, (res, _) = runs
    check_ledger(ref, res, block_local_bits())


def test_eval_loss_within_tolerance(runs):
    ref, (res, _) = runs
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=LOSS_RTOL)


def test_host_syncs_within_contract(runs):
    check_syncs(*runs[1], True)
