"""The fused engine's chunks, host syncs and batched codec call (CPU).

* K (``scan_rounds``) only sets how many rounds share a stats fetch:
  K in {1, 3, 8} gives identical trajectories and ledgers with fewer
  chunks.
* One ``host_fetch`` per chunk plus one per eval, for gradestc, fedpaq,
  topk and svdfed at K = 4 and K = 1.
* ``Codec.encode_clients`` over C clients equals C ``encode`` calls: the
  integer stats and state exactly, the reconstructions M A within 1e-6
  ||G||_F (the batched GEMMs may sum in another order), the float state
  likewise (a GradESTC basis as its projector M M^T: QR and SVD may flip
  a column's sign)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.fl.engine import plan_chunks  # noqa: E402
from test_torch_engine import run  # noqa: E402

GROUPS = {"layers/w": ((256, 64), 2)}
RTOL = 1e-6


def test_chunk_length_does_not_change_the_run():
    # evals at 0, 5, 6: K = 1 gives 7 chunks, K = 3 four, K = 8 three
    kw = dict(method="gradestc", engine="fused", rounds=7, eval_every=5)
    runs = {K: run(scan_rounds=K, **kw) for K in (1, 3, 8)}
    assert [runs[K].extra["chunks"] for K in (1, 3, 8)] == [7, 4, 3]
    for K in (3, 8):
        assert runs[K].eval_rounds == runs[1].eval_rounds == [0, 5, 6]
        assert runs[K].eval_loss == runs[1].eval_loss
        assert runs[K].ledger.per_round_uplink_bits == runs[1].ledger.per_round_uplink_bits
        assert runs[K].ledger.downlink_bits == runs[1].ledger.downlink_bits
        assert runs[K].extra["sum_d"] == runs[1].extra["sum_d"]
    assert runs[3].extra["chunk_shapes"] == 3 and runs[8].extra["chunk_shapes"] == 2


@pytest.mark.parametrize("K", [4, 1])
@pytest.mark.parametrize("method", ["gradestc", "fedpaq", "topk", "svdfed"])
def test_one_host_fetch_per_chunk_and_eval(method, K):
    tmetrics.reset_host_sync_count()
    res = run(method=method, engine="fused", rounds=3, n_clients=3, scan_rounds=K)
    chunks = plan_chunks(3, 2, K)
    assert res.extra["chunks"] == len(chunks) == {4: 2, 1: 3}[K]
    assert tmetrics.host_sync_count() == len(chunks) + len(res.eval_rounds)
    assert len(res.extra["round_wall_s"]) == 3 and len(res.extra["chunk_spans"]) == len(chunks)


def _codec(name):
    plan = tpolicy.make_policy(GROUPS, min_params=4096).plans["layers/w"]
    if name == "gradestc-int8":
        return tcodecs.GradESTCCodec(plan, seed=2, path_idx=0, wire_dtype="int8")
    if name == "gradestc-ef":
        return tcodecs.EFCodec(tcodecs.GradESTCCodec(plan, seed=2, path_idx=0),
                               (plan.stack, plan.l, plan.m))
    if name == "svdfed-int8":
        return tcodecs.SVDFedCodec(plan, seed=2, path_idx=0, wire_dtype="int8")
    if name == "fedpaq":
        return tcodecs.FedPAQCodec(plan.raw_scalars, bits=6, path_idx=0, use_pallas=True)
    return tcodecs.TopKCodec(plan.raw_scalars, path_idx=0)


@pytest.mark.parametrize("name", ["gradestc-int8", "gradestc-ef", "svdfed-int8", "fedpaq",
                                  "topk"])
def test_encode_clients_equals_one_encode_per_client(name):
    codec = _codec(name)
    plan = tpolicy.make_policy(GROUPS, min_params=4096).plans["layers/w"]
    C = 3
    rng = np.random.default_rng(4)
    cstate = codec.init_client_state(C, "cpu")
    shared = codec.init_shared_state("cpu")
    keys = tcodecs.round_base_key(0, 0, "cpu")
    keys = codec.per_client_key(keys, torch.arange(C)) if codec.draws else None
    for rnd in range(2):                  # an init round, then an update round
        U = rng.normal(size=(plan.stack, 256, 8)) * 0.05
        delta = torch.from_numpy(np.stack([
            (U @ rng.normal(size=(plan.stack, 8, 64)) + 1e-3 * rng.normal(
                size=(plan.stack, 256, 64))).astype(np.float32) for _ in range(C)]))
        wire = codec.to_wire_clients(delta)
        assert torch.equal(wire[1], codec.to_wire(delta[1]))
        st_b, recon_b, stats_b = codec.encode_clients(cstate, shared, keys, wire)
        for c in range(C):
            st_c, recon_c, stats_c = codec.encode(tuple(x[c] for x in cstate), shared,
                                                  None if keys is None else keys[c], wire[c])
            assert torch.equal(stats_b[c], stats_c)
            gn = float(torch.linalg.vector_norm(wire[c]))
            assert float(torch.linalg.vector_norm(recon_b[c] - recon_c)) <= RTOL * gn
            for j, (xb, xc) in enumerate(zip(st_b, st_c)):
                xb = xb[c]
                if not xb.is_floating_point():
                    assert torch.equal(xb, xc)
                    continue
                if j == 0 and name.startswith("gradestc"):     # a basis: signs are free
                    xb, xc = xb @ xb.mT, xc @ xc.mT
                assert float(torch.linalg.vector_norm(xb - xc)) <= RTOL * max(
                    1.0, float(torch.linalg.vector_norm(xc)))
        red = codec.reduce_stats(stats_b)
        shared = codec.update_shared(shared, red, recon_b.sum(0) / C)
        cstate = st_b
