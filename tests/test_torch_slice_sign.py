"""Port vs reference: a whole run on the sign wire (signSGD).

``run_fl`` with the loop engine, the port on the CPU against the JAX loop
engine, on ``test_torch_slice_wire.py``'s small config.  The sign kernels
and their plain versions are bit-exact, so ``use_pallas`` keeps its default
(False on the CPU) on both sides.  ``ledger.per_round_uplink`` must be equal
exactly and equal the closed form (every group ships a bit a value and one
32-bit scale); eval loss within rtol 1e-5 (measured: 0.0); host syncs one
per round plus one per eval.  The reference runs once, in a module-scoped
fixture."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from test_torch_slice_quant import (RUN, check_ledger, check_syncs,  # noqa: E402
                                    group_sizes, run_both)

LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def runs():
    return run_both(("signsgd",), None)["signsgd"]


def test_uplink_ledger_exact_and_closed_form(runs):
    ref, (res, _) = runs
    check_ledger(ref, res, RUN["n_clients"] * sum(n + 32 for n in group_sizes()))


def test_eval_loss_within_tolerance(runs):
    ref, (res, _) = runs
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(res.eval_acc, ref.eval_acc, atol=1e-6)


def test_host_syncs_within_contract(runs):
    check_syncs(*runs[1], False)
