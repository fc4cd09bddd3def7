"""Port vs reference: a whole run on the block-local quantizer wire.

``run_fl`` with the loop engine, the port on the CPU against the JAX loop
engine, on ``test_torch_slice_wire.py``'s small config, for fedpaq with
``use_pallas=True`` on both sides (the reference runs its Pallas kernels in
interpret mode, the port the plain versions of the card's kernels).
fedqclip's run is in ``test_torch_slice_quant_clip.py``, the global
quantizer's in ``test_torch_slice_quant_global.py`` and signsgd's in
``test_torch_slice_sign.py``: the reference's compile time bounds each
file; the helpers here serve all four.  ``ledger.per_round_uplink`` must
be equal exactly and equal the closed form (8 bits a value and a 32-bit
scale per 512 values, for every group); eval loss within rtol 1e-5
(measured: 4.0e-6); host syncs one per round plus one per eval.  The
reference runs once, in a module-scoped fixture.

Why the losses are not bit-equal: the deltas that local training gives
differ from the reference's by an ulp here and there (GEMM order), and a
stochastic rounding draw that falls between the two values moves one weight
by a whole quantization step.  The codecs alone are exact on equal inputs
(``test_torch_quant_codecs.py``)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import math  # noqa: E402

import numpy as np  # noqa: E402

from repro.fl import simulation as jsim  # noqa: E402
from repro.models.config import ArchConfig as JArch  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.fl import simulation as tsim  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.config import ArchConfig as TArch  # noqa: E402

ARCH = dict(name="slice-small", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=256, vocab=64, dtype="float32")
RUN = dict(rounds=3, n_clients=3, local_steps=1, batch=2, seq=16, eval_every=2)
LOSS_RTOL = 1e-5


def group_sizes():
    return [math.prod(shape) * stack for shape, stack in
            tmodel.param_group_shapes(TArch(**ARCH)).values()]


def plans():
    return tpolicy.make_policy(tmodel.param_group_shapes(TArch(**ARCH)),
                               min_params=4096).plans.values()


def compressed_plans():
    """The plans of the groups GradESTC compresses at this config."""
    return [plan for plan in plans() if plan.compress]


def gradestc_round_bits(per_plan, n_sel=RUN["n_clients"]):
    """A round's uplink when each compressed group ships ``per_plan(plan)``
    bits a client and every other group ships raw f32."""
    return n_sel * sum(per_plan(p) if p.compress else 32 * p.raw_scalars for p in plans())


def init_bits(plan):
    """A compressed group's init: every basis and its coefficients, f32."""
    return plan.stack * 32 * plan.k * (plan.l + plan.m)


def run_both(methods, use_pallas, **cfg_kw):
    """The reference's and the port's runs of each method (``cfg_kw``: more
    ``FLConfig`` fields for both):
    {method: (reference result, (port result, port host syncs))}."""
    run = {**RUN, **cfg_kw}
    out = {}
    for m in methods:
        ref = jsim.run_fl(jsim.FLConfig(method=m, use_pallas=use_pallas, arch=JArch(**ARCH),
                                        engine="loop", **run))
        tmetrics.reset_host_sync_count()
        res = tsim.run_fl(tsim.FLConfig(method=m, use_pallas=use_pallas, arch=TArch(**ARCH),
                                        engine="loop", device="cpu", **run))
        out[m] = (ref, (res, tmetrics.host_sync_count()))
    return out


def block_local_bits():
    """Per-round uplink of the block-local wire: 8 bits a value and a
    32-bit scale per 512 values, every group, every client."""
    return RUN["n_clients"] * sum(8 * n + 32 * -(-n // 512) for n in group_sizes())


@pytest.fixture(scope="module")
def runs():
    return run_both(("fedpaq",), True)["fedpaq"]


def check_ledger_exact(ref, res):
    """The port's ledger and host metrics equal the reference's."""
    assert res.ledger.per_round_uplink == ref.ledger.per_round_uplink
    assert res.ledger.uplink_bits == ref.ledger.uplink_bits
    assert res.ledger.downlink_bits == ref.ledger.downlink_bits
    assert res.uplink_bytes == ref.uplink_bytes
    assert res.extra.get("sum_d") == ref.extra.get("sum_d")


def check_ledger(ref, res, per_round):
    check_ledger_exact(ref, res)
    assert res.ledger.per_round_uplink_bits == [per_round] * RUN["rounds"]


def check_syncs(res, syncs, use_pallas):
    assert syncs == RUN["rounds"] + len(res.eval_rounds)
    assert res.extra["engine"] == "loop" and res.extra["use_pallas"] is use_pallas


def test_uplink_ledger_exact_and_closed_form(runs):
    ref, (res, _) = runs
    check_ledger(ref, res, block_local_bits())


def test_eval_loss_within_tolerance(runs):
    ref, (res, _) = runs
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=LOSS_RTOL)


def test_host_syncs_within_contract(runs):
    check_syncs(*runs[1], True)
