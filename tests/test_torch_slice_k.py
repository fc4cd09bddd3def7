"""Port vs reference: a whole run of the GradESTC ablation ``k``.

``run_fl`` (loop engine) for ``gradestc-k``, whose candidate count stays at
d = k.  The port on the CPU against the JAX loop engine, on
``test_torch_slice_wire.py``'s small config.  The ledger and
``extra["sum_d"]`` must be equal exactly; eval loss within rtol 1e-5
(measured: 1.1e-7); host syncs one per round plus one per eval.  The
reference runs once, in a module-scoped fixture."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from test_torch_slice_quant import (RUN, check_ledger_exact, check_syncs,  # noqa: E402
                                    compressed_plans, run_both)

LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def runs():
    return run_both(("gradestc-k",), None)["gradestc-k"]


def test_uplink_ledger_exact(runs):
    ref, (res, _) = runs
    check_ledger_exact(ref, res)
    # every layer pays a rank-k sketch every round: once to init, then d = k
    assert res.extra["sum_d"] == RUN["rounds"] * RUN["n_clients"] * sum(
        p.stack * p.k for p in compressed_plans())


def test_eval_loss_within_tolerance(runs):
    ref, (res, _) = runs
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=LOSS_RTOL)


def test_host_syncs_within_contract(runs):
    check_syncs(*runs[1], False)
