"""Port vs reference: a whole run of the GradESTC ablation ``all``.

``run_fl`` (loop engine) for ``gradestc-all``, which re-initializes every
layer every round.  The port on the CPU against the JAX loop engine, on
``test_torch_slice_wire.py``'s small config.  The ledger and
``extra["sum_d"]`` must be equal exactly and equal the closed form: every
round ships every basis and its coefficients.  Eval loss within rtol 1e-5
(measured: 0.0); host syncs one per round plus one per eval.  The reference
runs once, in a module-scoped fixture."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from test_torch_slice_quant import (RUN, check_ledger_exact, check_syncs,  # noqa: E402
                                    compressed_plans, gradestc_round_bits, init_bits,
                                    run_both)

LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def runs():
    return run_both(("gradestc-all",), None)["gradestc-all"]


def test_uplink_ledger_exact_and_closed_form(runs):
    ref, (res, _) = runs
    check_ledger_exact(ref, res)
    assert res.ledger.per_round_uplink_bits == [gradestc_round_bits(init_bits)] * RUN["rounds"]
    assert res.extra["sum_d"] == RUN["rounds"] * RUN["n_clients"] * sum(
        p.stack * p.k for p in compressed_plans())


def test_eval_loss_within_tolerance(runs):
    ref, (res, _) = runs
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=LOSS_RTOL)


def test_host_syncs_within_contract(runs):
    check_syncs(*runs[1], False)
