"""Port vs reference: a whole run of the GradESTC ablation ``first``.

``run_fl`` (loop engine) for ``gradestc-first``, whose first round's basis
stays: no candidate ever enters.  The port on the CPU against the JAX loop
engine, on ``test_torch_slice_wire.py``'s small config.  The ledger and
``extra["sum_d"]`` must be equal exactly and equal the closed form: round 0
ships every basis and its coefficients, rounds 1-2 the coefficients alone.
Eval loss within rtol 1e-5 (measured: 2.2e-7); host syncs one per round
plus one per eval.  The reference runs once, in a module-scoped fixture."""

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
    return run_both(("gradestc-first",), None)["gradestc-first"]


def test_uplink_ledger_exact_and_closed_form(runs):
    ref, (res, _) = runs
    check_ledger_exact(ref, res)
    init = gradestc_round_bits(init_bits)
    coeffs = gradestc_round_bits(lambda p: p.stack * 32 * p.k * p.m)
    assert res.ledger.per_round_uplink_bits == [init] + [coeffs] * (RUN["rounds"] - 1)
    # every init pays a rank-k sketch; a frozen basis spends no d
    assert res.extra["sum_d"] == RUN["n_clients"] * sum(
        p.stack * p.k for p in compressed_plans())


def test_eval_loss_within_tolerance(runs):
    ref, (res, _) = runs
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=LOSS_RTOL)


def test_host_syncs_within_contract(runs):
    check_syncs(*runs[1], False)
