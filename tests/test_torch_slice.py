"""Port vs reference: the whole slice, ``run_fl`` with the loop engine.

The port (on the CPU) and the JAX loop engine run the same config for
gradestc and fedavg.  ``ledger.per_round_uplink`` must be equal exactly;
eval losses within rtol 1e-5 (measured: <= 1.2e-7).  The reference runs
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
METHODS = ("gradestc", "fedavg")
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def reference():
    return {m: jsim.run_fl(jsim.FLConfig(method=m, arch=JArch(**ARCH), engine="loop", **RUN))
            for m in METHODS}


@pytest.fixture(scope="module")
def port():
    out = {}
    for m in METHODS:
        tmetrics.reset_host_sync_count()
        res = tsim.run_fl(tsim.FLConfig(method=m, arch=TArch(**ARCH), device="cpu", **RUN))
        out[m] = (res, tmetrics.host_sync_count())
    return out


@pytest.mark.parametrize("method", METHODS)
def test_uplink_ledger_exact(reference, port, method):
    ref, (res, _) = reference[method], port[method]
    assert res.ledger.per_round_uplink == ref.ledger.per_round_uplink
    assert res.ledger.uplink_bits == ref.ledger.uplink_bits
    assert res.ledger.downlink_bits == ref.ledger.downlink_bits
    assert res.extra.get("sum_d") == ref.extra.get("sum_d")


@pytest.mark.parametrize("method", METHODS)
def test_eval_loss_within_tolerance(reference, port, method):
    ref, (res, _) = reference[method], port[method]
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(res.eval_acc, ref.eval_acc, atol=1e-6)
    assert res.uplink_bytes == ref.uplink_bytes


def test_gradestc_compresses_and_syncs_once_per_round(port):
    g, syncs = port["gradestc"]
    f, _ = port["fedavg"]
    assert g.ledger.uplink_bits < f.ledger.uplink_bits
    # one packed-stats fetch per round plus one per eval round
    assert syncs == RUN["rounds"] + len(g.eval_rounds)
    assert g.extra["engine"] == "loop" and g.extra["use_pallas"] is False


def test_unported_options_raise():
    cfg = dict(arch=TArch(**ARCH), device="cpu", **RUN)
    with pytest.raises(ValueError, match="engine='fused'"):   # the loop runs on one device
        tsim.run_fl(tsim.FLConfig(devices=2, **cfg))
    with pytest.raises(ValueError):
        tsim.run_fl(tsim.FLConfig(engine="scan", **cfg))
    with pytest.raises(ValueError):
        tsim.run_fl(tsim.FLConfig(use_pallas=False, **{**cfg, "device": "cuda"}))
    with pytest.raises(ValueError):        # the global quantizer has no card path
        tsim.run_fl(tsim.FLConfig(method="fedpaq", use_pallas=False,
                                  **{**cfg, "device": "cuda"}))
    assert tsim.FLConfig().device == "cuda" and tsim.FLConfig().engine == "loop"
