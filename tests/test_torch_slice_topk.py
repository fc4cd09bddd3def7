"""Port vs reference: a whole run of top-k with error memory.

``run_fl`` with the loop engine, the port on the CPU against the JAX loop
engine, on ``test_torch_slice_wire.py``'s small config at participation
2/3, so that the unselected client of a round keeps its memory.  The ledger
must be equal exactly and equal the closed form (k = max(1, int(0.1 n))
values and int32 indices per group, 2 clients a round); eval loss within
5e-4 absolute, the reference's own tolerance for top-k across its engines
(measured: 2.3e-5): a delta that differs by an ulp (GEMM order) can move
which entry ties at the k-th magnitude.  Host syncs one per round plus one
per eval: the selection makes none.  The reference runs once, in a
module-scoped fixture."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from test_torch_slice_quant import (RUN, check_ledger, check_syncs,  # noqa: E402
                                    group_sizes, run_both)

LOSS_ATOL = 5e-4


@pytest.fixture(scope="module")
def runs():
    return run_both(("topk",), None, participation=2 / 3)["topk"]


def test_uplink_ledger_exact_and_closed_form(runs):
    ref, (res, _) = runs
    n_sel = round(2 / 3 * RUN["n_clients"])
    check_ledger(ref, res, n_sel * sum(64 * max(1, int(0.1 * n)) for n in group_sizes()))


def test_eval_loss_within_tolerance(runs):
    ref, (res, _) = runs
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=0, atol=LOSS_ATOL)


def test_host_syncs_within_contract(runs):
    check_syncs(*runs[1], False)
