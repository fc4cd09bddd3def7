"""Port fused engine vs port loop engine: the options (CPU).

Partial participation (mixed init and update rounds, the state gathered
and scattered by index), the GradESTC variants first / ef / all / k, and
the compressed downlink, each against the loop on the same config: eval
losses within the reference's tolerances and the ledger exactly equal."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_engine import assert_parity, run  # noqa: E402

CASES = [
    ("gradestc", dict(participation=0.5, n_clients=6), 1e-5),
    ("topk", dict(participation=0.5, n_clients=6, rounds=4), 5e-4),
    ("gradestc-first", {}, 1e-5),
    ("gradestc-ef", {}, 1e-5),
    ("gradestc-all", {}, 1e-5),
    ("gradestc-k", {}, 1e-5),
    ("gradestc", dict(downlink_compress=True), 1e-5),
    ("topk", dict(downlink_compress=True), 5e-4),
]


@pytest.mark.parametrize("method,kw,atol", CASES,
                         ids=[f"{m}-{'-'.join(kw) or 'full'}" for m, kw, _ in CASES])
def test_fused_matches_loop_with_option(method, kw, atol):
    kw = {"rounds": 4, **kw}
    loop = run(method=method, engine="loop", **kw)
    fused = run(method=method, engine="fused", **kw)
    assert_parity(loop, fused, atol)
