"""Port fused engine vs port loop engine, every Table III method (CPU).

The port's ``run_fl(engine="fused")`` (K-round chunks, clients batched
through local training and the codecs) against its per-client loop on the
same config, as the reference's ``TestFusedLoopParity`` holds its own two
engines: eval losses within the reference's tolerances (1e-5; 5e-4 for the
codecs whose output is a discrete function of the input: a delta an ulp
apart can flip a top-k tie or a stochastic rounding), and the ledger
exactly equal.  Measured on the CPU: every method equal bit for bit."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.fl import simulation as tsim  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402

ARCH = dict(name="engine-small", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=256, vocab=64, dtype="float32")
#: the reference's METHODS table (tests/test_round_engine.py)
METHODS = [("fedavg", 1e-5), ("topk", 5e-4), ("fedpaq", 5e-4), ("signsgd", 1e-5),
           ("fedqclip", 5e-4), ("svdfed", 1e-5), ("gradestc", 1e-5)]


def run(**kw):
    base = dict(method="gradestc", rounds=5, n_clients=4, local_steps=1, batch=4, seq=16,
                eval_every=2, seed=1, arch=ArchConfig(**ARCH), device="cpu")
    return tsim.run_fl(tsim.FLConfig(**{**base, **kw}))


def assert_parity(loop, fused, atol=1e-5):
    assert loop.extra["engine"] == "loop" and fused.extra["engine"] == "fused"
    assert fused.eval_rounds == loop.eval_rounds
    np.testing.assert_allclose(fused.eval_loss, loop.eval_loss, rtol=0, atol=atol)
    # the ledger is exact, not approximate
    assert fused.ledger.per_round_uplink == loop.ledger.per_round_uplink
    assert fused.ledger.uplink_total == loop.ledger.uplink_total
    assert fused.ledger.downlink_total == loop.ledger.downlink_total
    assert fused.uplink_bytes == loop.uplink_bytes
    assert fused.extra.get("sum_d") == loop.extra.get("sum_d")


@pytest.mark.parametrize("method,atol", METHODS)
def test_fused_matches_loop(method, atol):
    loop = run(method=method, engine="loop")
    fused = run(method=method, engine="fused")
    assert_parity(loop, fused, atol)
    # evals at 0, 2, 4: chunks (0, 1), (1, 3), (3, 5) of lengths 1 and 2
    assert fused.extra["chunks"] == 3 and fused.extra["chunk_shapes"] == 2
    assert fused.extra["scan_rounds"] == 8 and fused.extra["use_pallas"] is False
