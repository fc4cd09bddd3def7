"""Port vs reference: the GradESTC codec, stats packing and the accountant.

Two rounds (init, then steady) for two clients through both codecs, on each
coefficient wire: stats vectors, reduced stats, the Formula-13 ``d``,
``charge_bits`` and the ledger must match exactly; reconstructions within
``1e-5 ||G||_F`` on the f32 wire and ``1e-3 ||G||_F`` on bf16/int8."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.fl import compression as jcomp  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.fl import compression as tcomp  # noqa: E402

GROUPS = {"layers/w": ((256, 64), 2), "layers/ln": ((64,), 2), "embed": ((64, 64), 1)}
RTOL = 1e-5
#: bf16 / int8 wires: a coefficient that the two sides' GEMMs put on either
#: side of a rounding boundary ships one quantum apart (measured: <= 2.6e-4)
LOSSY_RTOL = 1e-3


def _deltas(seed, plan, rounds=2, clients=2):
    """Low-rank-plus-noise deltas with spread singular values, group-shaped."""
    rng = np.random.default_rng(seed)
    L, l, m, k = plan.stack, plan.l, plan.m, plan.k
    sv = 0.05 * 0.7 ** np.arange(k)
    U = np.linalg.qr(rng.normal(size=(L, l, k)))[0]
    out = []
    for _ in range(rounds):
        U = np.linalg.qr(U + 0.2 * rng.normal(size=U.shape))[0]
        row = []
        for _ in range(clients):
            V = np.linalg.qr(rng.normal(size=(L, m, k)))[0]
            G = (U * sv) @ V.transpose(0, 2, 1) + 1e-4 * rng.normal(size=(L, l, m))
            row.append(G.transpose(0, 2, 1).reshape((L,) + plan.shape).astype(np.float32))
        out.append(row)
    return out


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_codec_two_rounds_exact_accounting(wire):
    jpol = jpolicy.make_policy(GROUPS, min_params=4096)
    tpol = tpolicy.make_policy(GROUPS, min_params=4096)
    path = "layers/w"
    assert jcomp.path_index(jpol) == tcomp.path_index(tpol)
    pidx = jcomp.path_index(jpol)[path]
    jc = jcodecs.GradESTCCodec(jpol.plans[path], seed=3, path_idx=pidx, wire_dtype=wire)
    tc = tcodecs.GradESTCCodec(tpol.plans[path], seed=3, path_idx=pidx, wire_dtype=wire)
    C = 2
    jst, tst = jc.init_client_state(C), tc.init_client_state(C, "cpu")
    np.testing.assert_array_equal(np.asarray(jst[1]).astype(np.int64), tst[1].numpy())
    jsh, tsh = jc.init_shared_state(), tc.init_shared_state("cpu")
    assert int(jsh) == int(tsh)
    jenc = jax.jit(jc.encode)
    for rnd, row in enumerate(_deltas(0, tpol.plans[path])):
        jstats, tstats, jsum, tsum = [], [], 0, 0
        for c, delta in enumerate(row):
            jw = jc.to_wire(jnp.asarray(delta))
            tw = tc.to_wire(torch.from_numpy(delta))
            np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
            np.testing.assert_array_equal(np.asarray(jc.from_wire(jw, delta.shape)),
                                          tc.from_wire(tw, delta.shape).numpy())
            jcst = jax.tree.map(lambda x: x[c], jst)
            j2, jg, js = jenc(jcst, jsh, None, jw)
            t2, tg, ts = tc.encode(tuple(x[c] for x in tst), tsh, None, tw)
            jst = jax.tree.map(lambda x, u, _c=c: x.at[_c].set(u), jst, j2)
            for x, u in zip(tst, t2):
                x[c] = u
            np.testing.assert_array_equal(np.asarray(js), ts.numpy())
            tol = RTOL if wire == "f32" else LOSSY_RTOL
            assert np.linalg.norm(np.asarray(jg) - tg.numpy()) <= tol * np.linalg.norm(delta)
            jstats.append(js)
            tstats.append(ts)
            jsum, tsum = jsum + jg, tsum + tg
        jred = jc.reduce_stats(jnp.stack(jstats))
        tred = tc.reduce_stats(torch.stack(tstats))
        np.testing.assert_array_equal(np.asarray(jred), tred.numpy())
        jsh = jc.update_shared(jsh, jred, jsum / C)
        tsh = tc.update_shared(tsh, tred, tsum / C)
        assert int(jsh) == int(tsh)
        assert jc.charge_bits(np.asarray(jred), C) == tc.charge_bits(tred.numpy(), C)
        assert jc.host_metrics(np.asarray(jred), C) == tc.host_metrics(tred.numpy(), C)
        if rnd == 0:
            assert int(tred[1]) == 0          # every layer initialized this round


@pytest.mark.parametrize("method", ["gradestc", "fedavg"])
def test_accountant_and_packing_exact(method):
    jpol = jpolicy.make_policy(GROUPS, min_params=4096)
    tpol = tpolicy.make_policy(GROUPS, min_params=4096)
    paths = list(GROUPS)
    jcs = jcomp.build_codecs(jcomp.make_method(method, policy=jpol, seed=1), jpol, paths)
    tcs = tcomp.build_codecs(tcomp.make_method(method, policy=tpol, seed=1), tpol, paths)
    assert sorted(jcs) == sorted(tcs)
    jacct = jcomp.RoundAccountant(jcs, {}, jpol, paths, n_sel=3)
    tacct = tcomp.RoundAccountant(tcs, {}, tpol, paths, n_sel=3)
    jled, tled = jmetrics.CommLedger(), tmetrics.CommLedger()
    rows = ([[2, 6, 5, 16], [0, 0, 0, 4]] if method == "gradestc" else [[0], [0]])
    for rnd, row in enumerate(rows):
        reds = {p: np.asarray(row, np.int32) for p in jcs}
        jpack = np.asarray(jcomp.pack_round_stats(
            {p: jnp.asarray(v) for p, v in reds.items()}, {}))
        tpack = tcomp.pack_round_stats({p: torch.from_numpy(v) for p, v in reds.items()}, {},
                                       "cpu")
        np.testing.assert_array_equal(jpack, tpack.numpy())
        jled.begin_round()
        tled.begin_round()
        jacct.consume(jpack, jled, rnd)
        tacct.consume(tpack.numpy(), tled, rnd)
    assert jled.per_round_uplink_bits == tled.per_round_uplink_bits
    assert jled.downlink_bits == tled.downlink_bits
    assert jacct.metrics == tacct.metrics
    with pytest.raises(ValueError):
        tacct.consume(np.zeros(7, np.int32), tled, 0)


def test_unported_methods_raise():
    """Every method of the reference parses as there; a name or variant
    that neither package has raises ValueError."""
    tpol = tpolicy.make_policy(GROUPS, min_params=4096)
    for name, cls in (("fedavg", tcomp.FedAvgMethod), ("topk", tcomp.TopKMethod),
                      ("fedpaq", tcomp.FedPAQMethod), ("signsgd", tcomp.SignSGDMethod),
                      ("fedqclip", tcomp.FedQClipMethod), ("svdfed", tcomp.SVDFedMethod)):
        assert isinstance(tcomp.make_method(name, policy=tpol), cls)
    jpol = jpolicy.make_policy(GROUPS, min_params=4096)
    paths = list(GROUPS)
    for name in ("gradestc", "gradestc-ef", "gradestc-first", "gradestc-all", "gradestc-k"):
        tm = tcomp.make_method(name, policy=tpol)
        jm = jcomp.make_method(name, policy=jpol)
        assert isinstance(tm, tcomp.GradESTCMethod)
        assert (tm.variant, tm.ef) == (jm.variant, jm.ef)
        tcs = tcomp.build_codecs(tm, tpol, paths)
        jcs = jcomp.build_codecs(jm, jpol, paths)
        assert {p: type(c).__name__ for p, c in tcs.items()} == {
            p: type(c).__name__ for p, c in jcs.items()}
    assert type(tcomp.build_codecs(tcomp.make_method("topk"), tpol, paths)["embed"]) is (
        tcodecs.TopKCodec)
    for name in ("gradestc-foo", "bogus", "topk-ef"):
        with pytest.raises(ValueError):
            tcomp.make_method(name, policy=tpol)
    with pytest.raises(ValueError):
        tcodecs.GradESTCCodec(tpol.plans["layers/w"], variant="half")
    with pytest.raises(ValueError):
        tcodecs.GradESTCCodec(tpol.plans["layers/w"], wire_dtype="int4")
