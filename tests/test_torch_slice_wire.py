"""Port vs reference: whole runs on the bf16 and int8 coefficient wires.

``run_fl`` with the loop engine, the port on the CPU against the JAX loop
engine, on ``test_torch_slice.py``'s small config, for gradestc int8,
svdfed int8 and svdfed bf16.  ``ledger.per_round_uplink`` must be equal
exactly; eval losses within rtol 1e-5 (measured: <= 1.1e-7); host syncs one
per round plus one per eval.  At this size SVDFed's default ``gamma = 8``
refits on rounds 0 and 2 and ships int8 coefficients on round 1, so the
svdfed runs hold both kinds of round (asserted below).  The reference runs
once, in a module-scoped fixture."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.fl import simulation as jsim  # noqa: E402
from repro.models.config import ArchConfig as JArch  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.fl import simulation as tsim  # noqa: E402
from repro_torch.models.config import ArchConfig as TArch  # noqa: E402

ARCH = dict(name="slice-small", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=256, vocab=64, dtype="float32")
RUN = dict(rounds=3, n_clients=3, local_steps=1, batch=2, seq=16, eval_every=2)
CASES = {"gradestc-int8": ("gradestc", "int8"), "svdfed-int8": ("svdfed", "int8"),
         "svdfed-bf16": ("svdfed", "bf16")}
LOSS_RTOL = 1e-5


def _cfg(mod, arch, case, **extra):
    method, wire = CASES[case]
    return mod.FLConfig(method=method, method_kw={"wire_dtype": wire}, arch=arch,
                        engine="loop", **RUN, **extra)


@pytest.fixture(scope="module")
def reference():
    return {c: jsim.run_fl(_cfg(jsim, JArch(**ARCH), c)) for c in CASES}


@pytest.fixture(scope="module")
def port():
    out = {}
    for c in CASES:
        tmetrics.reset_host_sync_count()
        res = tsim.run_fl(_cfg(tsim, TArch(**ARCH), c, device="cpu"))
        out[c] = (res, tmetrics.host_sync_count())
    return out


@pytest.mark.parametrize("case", CASES)
def test_uplink_ledger_exact(reference, port, case):
    ref, (res, _) = reference[case], port[case]
    assert res.ledger.per_round_uplink == ref.ledger.per_round_uplink
    assert res.ledger.uplink_bits == ref.ledger.uplink_bits
    assert res.ledger.downlink_bits == ref.ledger.downlink_bits
    assert res.extra.get("sum_d") == ref.extra.get("sum_d")


@pytest.mark.parametrize("case", CASES)
def test_eval_loss_within_tolerance(reference, port, case):
    ref, (res, _) = reference[case], port[case]
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(res.eval_acc, ref.eval_acc, atol=1e-6)
    assert res.uplink_bytes == ref.uplink_bytes


@pytest.mark.parametrize("case", CASES)
def test_host_syncs_within_contract(port, case):
    res, syncs = port[case]
    assert syncs == RUN["rounds"] + len(res.eval_rounds)
    assert res.extra["engine"] == "loop" and res.extra["use_pallas"] is False


def test_wires_order_uplink_and_svdfed_holds_both_rounds(port):
    g8 = port["gradestc-int8"][0].ledger.per_round_uplink_bits
    s8 = port["svdfed-int8"][0].ledger.per_round_uplink_bits
    s16 = port["svdfed-bf16"][0].ledger.per_round_uplink_bits
    # refit rounds ship raw (equal across wires), steady rounds coefficients
    assert s8[0] == s8[2] == s16[0] == s16[2] > s16[1] > s8[1]
    assert max(g8) < s8[0]
