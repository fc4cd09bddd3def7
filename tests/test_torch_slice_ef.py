"""Port vs reference: a whole run of GradESTC with error feedback.

``run_fl`` (loop engine) for ``gradestc-ef``, the port on the CPU against
the JAX loop engine, on ``test_torch_slice_wire.py``'s small config.  The
ledger (per-round uplink, uplink and downlink bits) and ``extra["sum_d"]``
must be equal exactly, and round 0 must ship every basis and its
coefficients; eval loss within rtol 1e-5 (measured: 0.0); host syncs one per
round plus one per eval.  The reference runs once, in a module-scoped
fixture."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from test_torch_slice_quant import (RUN, check_ledger_exact, check_syncs,  # noqa: E402
                                    gradestc_round_bits, init_bits, run_both)

LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def runs():
    return run_both(("gradestc-ef",), None)["gradestc-ef"]


def test_uplink_ledger_exact(runs):
    ref, (res, _) = runs
    check_ledger_exact(ref, res)
    # error feedback changes what is compressed, not the wire
    assert res.ledger.per_round_uplink_bits[0] == gradestc_round_bits(init_bits)


def test_eval_loss_within_tolerance(runs):
    ref, (res, _) = runs
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=LOSS_RTOL)


def test_host_syncs_within_contract(runs):
    check_syncs(*runs[1], False)
