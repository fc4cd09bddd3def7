"""The port's sharded fused engine on a 2-rank gloo world (CPU).

``run_fl(FLConfig(engine="fused", devices=2))`` inside one world of two
ranks (``launch.mesh.run_world``, started once for the file) against the
port's single-device fused run of the same config, as the reference's
``tests/test_sharded_engine.py`` holds its own: every Table III method,
a selection that does not divide over the ranks (n_sel 3 padded to 4),
partial participation with late initialisation, the compressed downlink,
and K = 4 against K = 1.  The ledger is equal bit for bit on both ranks;
eval losses are within the reference's per-method tolerances (its METHODS
table); K does not change the sharded run at all.  Each rank makes one
stats fetch per chunk, rank 0 one more per eval; a round makes two
collectives, one where no codec has per-client stats or state (fedavg,
signsgd, fedpaq, fedqclip: the all-gather of empty rows is skipped).
Also: the int32 views of every codec-state dtype, the padding and lanes,
and the loop engine's refusal of ``devices``."""

import concurrent.futures

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.core import metrics  # noqa: E402
from repro_torch.fl import compression as tcomp  # noqa: E402
from repro_torch.fl import simulation as tsim  # noqa: E402
from repro_torch.fl.engine import plan_chunks  # noqa: E402
from repro_torch.launch.sharding import as_i32, from_i32, i32_words  # noqa: E402
from repro_torch.launch.mesh import FLMesh, run_world  # noqa: E402
from repro_torch.launch.sharding import FLRoundSpecs, make_plan  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.core.policy import make_policy  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402

#: the reference's sharded child (tests/test_sharded_engine.py)
ARCH = dict(name="sharded-tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
            n_kv_heads=2, d_ff=128, vocab=64, dtype="float32")
BASE = dict(rounds=4, n_clients=4, local_steps=1, batch=2, seq=16, eval_every=2, seed=1,
            engine="fused", device="cpu")
#: the reference's METHODS table (tests/test_round_engine.py)
METHODS = [("fedavg", 1e-5), ("topk", 5e-4), ("fedpaq", 5e-4), ("signsgd", 1e-5),
           ("fedqclip", 5e-4), ("svdfed", 1e-5), ("gradestc", 1e-5)]
#: case -> (method, more FLConfig fields, eval-loss tolerance)
CASES = {m: (m, {}, atol) for m, atol in METHODS}
CASES.update({
    "padded": ("gradestc", dict(n_clients=5, participation=0.6), 1e-5),      # n_sel 3 -> 4
    "partial": ("gradestc", dict(n_clients=8, participation=0.5, rounds=5), 1e-5),
    "downlink": ("gradestc", dict(downlink_compress=True), 1e-5),
    "k4": ("gradestc", dict(rounds=6, scan_rounds=4), 1e-5),
    "k1": ("gradestc", dict(rounds=6, scan_rounds=1), 1e-5),
})
#: no codec with per-client stats or state: the round's one collective is
#: the all-reduce
ONE_COLLECTIVE = ("fedavg", "signsgd", "fedpaq", "fedqclip")


def config(name: str, **more) -> "tsim.FLConfig":
    method, kw, _ = CASES[name]
    return tsim.FLConfig(method=method, arch=ArchConfig(**ARCH), **{**BASE, **kw, **more})


def _world(rank: int, names=tuple(CASES)):
    """The cases ``names`` in this rank: name -> (result, host fetches,
    collectives)."""
    out = {}
    for name in names:
        metrics.reset_host_sync_count()
        metrics.reset_collective_count()
        res = tsim.run_fl(config(name, devices=2))
        out[name] = (res, metrics.host_sync_count(), metrics.collective_count())
    return out


@pytest.fixture(scope="module")
def runs():
    """(the world's results by rank, the single-device twins): the world
    runs beside the twins."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_world, _world, 2, "gloo")
        single = {name: tsim.run_fl(config(name)) for name in CASES if name != "k1"}
        return world.result(), single


def assert_ledger_equal(a, b):
    assert a.ledger.per_round_uplink_bits == b.ledger.per_round_uplink_bits
    assert a.ledger.uplink_bits == b.ledger.uplink_bits
    assert a.ledger.downlink_bits == b.ledger.downlink_bits
    assert a.extra.get("sum_d") == b.extra.get("sum_d")


@pytest.mark.parametrize("name", [n for n in CASES if n != "k1"])
def test_sharded_matches_single_device(runs, name):
    world, single = runs
    ref = single[name]
    res = world[0][name][0]
    assert res.extra["devices"] == 2 and ref.extra["devices"] == 1
    assert res.eval_rounds == ref.eval_rounds
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=0, atol=CASES[name][2])
    assert res.uplink_bytes == ref.uplink_bytes
    assert res.ledger.uplink_total == ref.ledger.uplink_total
    for rank in (0, 1):                    # both ranks keep the whole ledger
        assert_ledger_equal(world[rank][name][0], ref)


def test_chunk_length_does_not_change_the_sharded_run(runs):
    world, _ = runs
    k4, k1 = world[0]["k4"][0], world[0]["k1"][0]
    assert (k4.extra["chunks"], k1.extra["chunks"]) == (4, 6)    # evals at 0, 2, 4, 5
    assert k4.eval_rounds == k1.eval_rounds and k4.eval_loss == k1.eval_loss
    assert_ledger_equal(k4, k1)


@pytest.mark.parametrize("name", list(CASES))
def test_one_fetch_per_chunk_on_every_rank(runs, name):
    world, _ = runs
    cfg = config(name)
    chunks = len(plan_chunks(cfg.rounds, cfg.eval_every, cfg.scan_rounds))
    (r0, fetch0, _), (r1, fetch1, _) = world[0][name], world[1][name]
    assert r0.extra["chunks"] == r1.extra["chunks"] == chunks
    # rank 0 alone evaluates
    assert fetch0 == chunks + len(r0.eval_rounds) and r0.eval_rounds
    assert fetch1 == chunks and r1.eval_rounds == [] and r1.eval_loss == []


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_per_round(runs, name):
    world, _ = runs
    per_round = 1 if CASES[name][0] in ONE_COLLECTIVE else 2
    for rank in (0, 1):
        res, _, counted = world[rank][name]
        assert counted == res.extra["collectives"] == per_round * config(name).rounds


def test_lanes_and_padding(runs):
    world, _ = runs
    for name, c_pad in (("gradestc", 4), ("padded", 4), ("partial", 4)):
        for rank in (0, 1):
            res = world[rank][name][0]
            assert res.extra["rank"] == rank and res.extra["backend"] == "gloo"
            assert res.extra["c_pad"] == c_pad
            assert res.extra["lanes"] == (rank * c_pad // 2, (rank + 1) * c_pad // 2)
    arch = ArchConfig(**ARCH)
    for n, want in ((1, [1, 2, 3, 4, 5]), (2, [2, 2, 4, 4, 6]), (4, [4, 4, 4, 4, 8])):
        spec = FLRoundSpecs(make_plan(FLMesh((n, 1), ("data", "model")), arch))
        assert spec.n_shards == n
        assert [spec.pad_clients(s) for s in range(1, 6)] == want
        assert spec.lanes(8) == slice(0, 8 // n)           # rank 0 of a world without a group


def _state_leaves():
    """Every leaf that a port codec's init_client_state returns, over
    three clients, plus values that test the views' bits."""
    arch = ArchConfig(**ARCH)
    policy = make_policy(model.param_group_shapes(arch), min_params=1024)
    paths = list(policy.plans)
    leaves = []
    for name in ("gradestc", "gradestc-ef", "svdfed", "topk", "signsgd", "fedpaq", "fedqclip"):
        method = tcomp.make_method(name, policy=policy, seed=3)
        for codec in tcomp.build_codecs(method, policy, paths, False).values():
            leaves += list(codec.init_client_state(3, "cpu"))
    assert {x.dtype for x in leaves} == {torch.float32, torch.int64, torch.bool}
    gen = torch.Generator().manual_seed(0)
    special = torch.tensor([[-0.0, float("inf"), float("nan"), 1e-45, -3.5, 2.0 ** 100]] * 3)
    leaves += [
        special,
        torch.randint(-2 ** 62, 2 ** 62, (3, 5, 2), generator=gen),
        torch.tensor([0, 0xFFFFFFFF, 2 ** 40 + 7]),                      # (C,) int64
        torch.randint(0, 2, (3, 4), generator=gen).bool(),
    ]
    return leaves


def test_i32_views_round_trip_every_state_dtype():
    for x in _state_leaves():
        rows = as_i32(x)
        assert rows.dtype == torch.int32
        assert rows.shape == (x.shape[0], i32_words(x.dtype, x.shape[1:]))
        back = from_i32(rows, x.dtype, x.shape)
        assert back.dtype == x.dtype and back.shape == x.shape
        if x.dtype == torch.float32:            # bit for bit, NaN and -0.0 too
            assert torch.equal(back.view(torch.int32), x.view(torch.int32))
        else:
            assert torch.equal(back, x)
    for dtype in (torch.int32, torch.float16, torch.bfloat16, torch.float64, torch.uint8):
        with pytest.raises(TypeError):
            as_i32(torch.zeros((2, 3), dtype=dtype))
        with pytest.raises(TypeError):
            from_i32(torch.zeros((2, 3), dtype=torch.int32), dtype, (2, 3))


def test_loop_engine_refuses_devices():
    with pytest.raises(ValueError, match="engine='fused'"):
        tsim.run_fl(config("gradestc", engine="loop", devices=2))
