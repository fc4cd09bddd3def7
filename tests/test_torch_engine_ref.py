"""Port fused engine vs the JAX fused engine (CPU).

``plan_chunks`` must equal the reference's over a grid of (rounds,
eval_every, K).  ``run_fl(engine="fused")`` of the port (plain versions of
the kernels) against the reference's fused engine (``engine="fused"``,
``lax.scan`` chunks, ``vmap`` over clients) on ``test_torch_slice.py``'s
small config, for gradestc and fedavg, with ``scan_rounds=2``:
``ledger.per_round_uplink`` equal exactly, eval losses within rtol 1e-5.
The reference runs once, in a module-scoped fixture."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.fl import engine as jengine  # noqa: E402
from repro.fl import simulation as jsim  # noqa: E402
from repro.models.config import ArchConfig as JArch  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.fl import engine as tengine  # noqa: E402
from repro_torch.fl import simulation as tsim  # noqa: E402
from repro_torch.models.config import ArchConfig as TArch  # noqa: E402
from test_torch_slice import ARCH, LOSS_RTOL, RUN  # noqa: E402

METHODS = ("gradestc", "fedavg")
FUSED = dict(engine="fused", scan_rounds=2, **RUN)


@pytest.mark.parametrize("eval_every", [1, 2, 3, 5])
@pytest.mark.parametrize("rounds", [1, 4, 7, 12])
def test_plan_chunks_matches_reference(rounds, eval_every):
    for K in (1, 2, 3, 4, 8, 16):
        assert tengine.plan_chunks(rounds, eval_every, K) == jengine.plan_chunks(
            rounds, eval_every, K)


@pytest.fixture(scope="module")
def reference():
    return {m: jsim.run_fl(jsim.FLConfig(method=m, arch=JArch(**ARCH), **FUSED))
            for m in METHODS}


@pytest.fixture(scope="module")
def port():
    out = {}
    for m in METHODS:
        tmetrics.reset_host_sync_count()
        res = tsim.run_fl(tsim.FLConfig(method=m, arch=TArch(**ARCH), device="cpu", **FUSED))
        out[m] = (res, tmetrics.host_sync_count())
    return out


@pytest.mark.parametrize("method", METHODS)
def test_fused_ledger_exact(reference, port, method):
    ref, (res, _) = reference[method], port[method]
    assert ref.extra["engine"] == res.extra["engine"] == "fused"
    assert res.ledger.per_round_uplink == ref.ledger.per_round_uplink
    assert res.ledger.uplink_bits == ref.ledger.uplink_bits
    assert res.ledger.downlink_bits == ref.ledger.downlink_bits
    assert res.extra.get("sum_d") == ref.extra.get("sum_d")


@pytest.mark.parametrize("method", METHODS)
def test_fused_eval_loss_within_tolerance(reference, port, method):
    ref, (res, syncs) = reference[method], port[method]
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(res.eval_acc, ref.eval_acc, atol=1e-6)
    assert res.uplink_bytes == ref.uplink_bytes
    # chunks (0, 1) and (1, 3), as the reference plans them
    for key in ("chunks", "chunk_shapes", "scan_rounds"):
        assert res.extra[key] == ref.extra[key]
    assert syncs == res.extra["chunks"] + len(res.eval_rounds)
