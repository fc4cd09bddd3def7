"""Port vs reference: the GradESTC ablations, error feedback and the
downlink codec's server instance.

Each variant (``full``, ``first``, ``all``, ``k``) and ``full`` under
``EFCodec`` encodes one group for two clients over four rounds through both
codecs: stats, reduced stats, the shared ``d``, ``charge_bits`` and
``host_metrics`` must match exactly; reconstructions (and EF's memory)
within ``1e-5 ||G||_F``, G what the inner codec compresses (the delta, plus
the memory under EF), on drifting low-rank gradients with spread singular values
(ratio 0.6, as ``test_torch_gradestc.py`` explains).  The downlink's one
server instance (``SERVER_CLIENT_ID`` = 2^32 - 1) must draw the reference's
key stack bit for bit, and the accountant must charge the compressed
downlink as the reference's does."""

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
PATH = "layers/w"
RTOL = 1e-5
C, ROUNDS = 2, 4


def _deltas(plan, seed=0):
    """Drifting low-rank-plus-noise deltas, spread spectrum, group-shaped."""
    rng = np.random.default_rng(seed)
    L, l, m, k = plan.stack, plan.l, plan.m, plan.k
    sv = 0.05 * 0.6 ** np.arange(k)
    U = np.linalg.qr(rng.normal(size=(L, l, k)))[0]
    out = []
    for _ in range(ROUNDS):
        U = np.linalg.qr(U + 0.2 * rng.normal(size=U.shape))[0]
        row = []
        for _ in range(C):
            V = np.linalg.qr(rng.normal(size=(L, m, k)))[0]
            G = (U * sv) @ V.transpose(0, 2, 1) + 1e-6 * rng.normal(size=(L, l, m))
            row.append(G.transpose(0, 2, 1).reshape((L,) + plan.shape).astype(np.float32))
        out.append(row)
    return out


def _codecs(variant, ef):
    jpol = jpolicy.make_policy(GROUPS, min_params=4096)
    tpol = tpolicy.make_policy(GROUPS, min_params=4096)
    plan = tpol.plans[PATH]
    pidx = tcomp.path_index(tpol)[PATH]
    jc = jcodecs.GradESTCCodec(jpol.plans[PATH], seed=5, path_idx=pidx, variant=variant)
    tc = tcodecs.GradESTCCodec(plan, seed=5, path_idx=pidx, variant=variant)
    if ef:
        shape = (plan.stack, plan.l, plan.m)
        jc, tc = jcodecs.EFCodec(jc, shape), tcodecs.EFCodec(tc, shape)
    return jc, tc, plan


@pytest.mark.parametrize("variant,ef", [("full", False), ("first", False), ("all", False),
                                        ("k", False), ("full", True)])
def test_four_rounds_exact_accounting(variant, ef):
    jc, tc, plan = _codecs(variant, ef)
    jst, tst = jc.init_client_state(C), tc.init_client_state(C, "cpu")
    # the port's state is the reference's flattened, the memory last
    assert len(tst) == len(jax.tree.leaves(jst)) == 3 + ef
    jsh, tsh = jc.init_shared_state(), tc.init_shared_state("cpu")
    assert int(jsh) == int(tsh)
    jenc = jax.jit(jc.encode)
    sum_d = 0
    for rnd, row in enumerate(_deltas(plan)):
        jstats, tstats, jsum, tsum = [], [], 0, 0
        for c, delta in enumerate(row):
            jw = jc.to_wire(jnp.asarray(delta))
            tw = tc.to_wire(torch.from_numpy(delta))
            # what the inner codec compresses: the delta, plus the memory under EF
            scale = np.linalg.norm(np.asarray(jw) + (np.asarray(jst[1][c]) if ef else 0))
            j2, jg, js = jenc(jax.tree.map(lambda x: x[c], jst), jsh, None, jw)
            t2, tg, ts = tc.encode(tuple(x[c] for x in tst), tsh, None, tw)
            jst = jax.tree.map(lambda x, u, _c=c: x.at[_c].set(u), jst, j2)
            for x, u in zip(tst, t2):
                x[c] = u
            np.testing.assert_array_equal(np.asarray(js), ts.numpy())
            assert np.linalg.norm(np.asarray(jg) - tg.numpy()) <= RTOL * scale
            if ef:
                mem_diff = tst[-1][c].numpy() - np.asarray(jst[1][c])
                assert np.linalg.norm(mem_diff) <= RTOL * scale
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
        jm, tm = jc.host_metrics(np.asarray(jred), C), tc.host_metrics(tred.numpy(), C)
        assert jm == tm
        sum_d += tm["sum_d"]
        n_init = C * plan.stack - int(tred[1])
        if variant == "all" or rnd == 0:
            assert n_init == C * plan.stack          # every layer initializes
        else:
            assert n_init == 0
        if variant == "first" and rnd > 0:
            assert int(tred[0]) == 0 and int(tred[3]) == 0   # nothing enters
        if variant == "k":
            assert int(tsh) == int(tred[3]) == plan.k
    rounds_of_k = ROUNDS if variant in ("all", "k") else 1
    if variant != "full":
        assert sum_d == rounds_of_k * C * plan.stack * plan.k


def test_server_instance_keys_bit_equal():
    jc, tc, plan = _codecs("full", False)
    ids = [jcodecs.SERVER_CLIENT_ID]
    jst = jc.init_client_state(1, client_ids=ids)
    tst = tc.init_client_state(1, "cpu", client_ids=ids)
    np.testing.assert_array_equal(np.asarray(jst[1]).astype(np.int64), tst[1].numpy())
    assert tcodecs.SERVER_CLIENT_ID == jcodecs.SERVER_CLIENT_ID == 0xFFFFFFFF
    # the id above 2^31 folds in as the uint32 it is, not as -1 sign-extended
    keys = tcodecs.client_layer_keys(5, 0xFFFFFFFF, tc.path_idx, plan.stack, "cpu")
    np.testing.assert_array_equal(keys.numpy(), tst[1][0].numpy())
    np.testing.assert_array_equal(
        keys.numpy(), np.asarray(jcodecs.client_layer_keys(5, -1, tc.path_idx,
                                                           plan.stack)).astype(np.int64))


def test_accountant_charges_the_compressed_downlink():
    jpol = jpolicy.make_policy(GROUPS, min_params=4096)
    tpol = tpolicy.make_policy(GROUPS, min_params=4096)
    paths = list(GROUPS)
    jcs = jcomp.build_codecs(jcomp.make_method("topk", policy=jpol), jpol, paths)
    tcs = tcomp.build_codecs(tcomp.make_method("topk", policy=tpol), tpol, paths)
    jdl = jcomp.build_downlink_codecs(jpol, paths, seed=3)
    tdl = tcomp.build_downlink_codecs(tpol, paths, seed=3)
    assert sorted(jdl) == sorted(tdl) == [PATH]
    assert tdl[PATH].seed == jdl[PATH].seed == 104
    jacct = jcomp.RoundAccountant(jcs, jdl, jpol, paths, n_sel=3, downlink_enabled=True)
    tacct = tcomp.RoundAccountant(tcs, tdl, tpol, paths, n_sel=3, downlink_enabled=True)
    jled, tled = jmetrics.CommLedger(), tmetrics.CommLedger()
    for rnd, row in enumerate([[16, 0, 0, 4], [3, 2, 5, 4]]):
        dl = {PATH: np.asarray(row, np.int32)}
        jpack = np.asarray(jcomp.pack_round_stats({}, {p: jnp.asarray(v) for p, v in dl.items()}))
        tpack = tcomp.pack_round_stats({}, {p: torch.from_numpy(v) for p, v in dl.items()}, "cpu")
        np.testing.assert_array_equal(jpack, tpack.numpy())
        jled.begin_round()
        tled.begin_round()
        jacct.consume(jpack, jled, rnd)
        tacct.consume(tpack.numpy(), tled, rnd)
    assert jled.per_round_uplink_bits == tled.per_round_uplink_bits
    assert jled.downlink_bits == tled.downlink_bits
    raw = 32 * sum(p.raw_scalars for p in tpol.plans.values()) * 3 * 2
    assert 0 < tled.downlink_bits < raw


def test_error_feedback_helpers_bit_equal():
    from repro.core import error_feedback as jef
    from repro_torch.core import error_feedback as tef

    rng = np.random.default_rng(3)
    G, mem, Ghat = (rng.normal(size=(32, 24)).astype(np.float32) for _ in range(3))
    assert tef.EFState.init(32, 24, "cpu").memory.shape == jef.EFState.init(32, 24).memory.shape
    for decay in (1.0, 0.9):
        jinj = jef.ef_inject(jef.EFState(jnp.asarray(mem)), jnp.asarray(G), decay)
        tinj = tef.ef_inject(tef.EFState(torch.from_numpy(mem)), torch.from_numpy(G), decay)
        np.testing.assert_array_equal(tinj.numpy(), np.asarray(jinj))
        jst = jef.ef_update(jef.EFState(jnp.asarray(mem)), jinj, jnp.asarray(Ghat))
        tst = tef.ef_update(tef.EFState(torch.from_numpy(mem)), tinj, torch.from_numpy(Ghat))
        np.testing.assert_array_equal(tst.memory.numpy(), np.asarray(jst.memory))
