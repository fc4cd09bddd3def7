"""Port vs reference: a whole run of GradESTC with a compressed downlink.

``run_fl`` (loop engine) for ``gradestc`` with ``downlink_compress=True``:
the server sends its server-lr-scaled average through a GradESTC codec of
its own (``SERVER_CLIENT_ID``, seed + 101).  The port on the CPU against
the JAX loop engine, on ``test_torch_slice_wire.py``'s small config.  The
ledger (per-round uplink, uplink and downlink bits) and ``extra["sum_d"]``
must be equal exactly, and the downlink must be under the raw model's;
eval loss within rtol 1e-5 (measured: 1.1e-7); host syncs one per round
plus one per eval.  The reference runs once, in a module-scoped fixture."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from test_torch_slice_quant import (RUN, check_ledger_exact, check_syncs,  # noqa: E402
                                    group_sizes, run_both)

LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def runs():
    return run_both(("gradestc",), None, downlink_compress=True)["gradestc"]


def test_ledger_exact_and_downlink_below_raw(runs):
    ref, (res, _) = runs
    check_ledger_exact(ref, res)
    raw = 32 * sum(group_sizes()) * RUN["n_clients"] * RUN["rounds"]
    assert 0 < res.ledger.downlink_bits < raw


def test_eval_loss_within_tolerance(runs):
    ref, (res, _) = runs
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=LOSS_RTOL)


def test_host_syncs_within_contract(runs):
    check_syncs(*runs[1], False)
