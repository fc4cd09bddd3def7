"""Port vs reference: host-side bookkeeping (policy, data, ledger, layout).

All of it must match exactly: LayerPlans, token blocks, segment layout and
ledger totals."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.tinyllama_1_1b import CONFIG as J_TINYLLAMA  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import reshaping as jreshaping  # noqa: E402
from repro.data import client_batch_stream as j_stream, make_task as j_task  # noqa: E402
from repro.fl.simulation import default_tiny_arch as j_tiny  # noqa: E402
from repro.models import param_group_shapes as j_groups  # noqa: E402
from repro_torch.configs.tinyllama_1_1b import CONFIG as T_TINYLLAMA  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.fl import compression as tcomp  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.core import reshaping as treshaping  # noqa: E402
from repro_torch.data import client_batch_stream as t_stream, make_task as t_task  # noqa: E402
from repro_torch.fl.simulation import default_tiny_arch as t_tiny  # noqa: E402
from repro_torch.models.model import param_group_shapes as t_groups  # noqa: E402


def _cut(cfg):
    return dataclasses.replace(cfg, n_layers=2, vocab=4096, dtype="float32", remat=False)


def _plans(pol):
    return {name: dataclasses.astuple(p) for name, p in pol.plans.items()}


@pytest.mark.parametrize("which", ["tiny", "tinyllama_width"])
def test_policy_plans_exact(which):
    if which == "tiny":
        ja, ta = j_tiny(), t_tiny()
    else:
        ja, ta = _cut(J_TINYLLAMA), _cut(T_TINYLLAMA)
    assert dataclasses.asdict(ja) == dataclasses.asdict(ta)
    jg, tg = j_groups(ja), t_groups(ta)
    assert jg == tg
    jp = jpolicy.make_policy(jg, min_params=4096)
    tp = tpolicy.make_policy(tg, min_params=4096)
    assert _plans(jp) == _plans(tp)
    if which == "tinyllama_width":
        got = {n: (p.l, p.m, p.k) for n, p in tp.plans.items() if p.compress}
        assert got == {
            "layers/attn_wq": (2048, 2048, 64), "layers/attn_wo": (2048, 2048, 64),
            "layers/attn_wk": (1024, 512, 64), "layers/attn_wv": (1024, 512, 64),
            "layers/mlp_wgate": (5632, 2048, 64), "layers/mlp_win": (5632, 2048, 64),
            "layers/mlp_wout": (4096, 2816, 64),
        }


@pytest.mark.parametrize("alpha", [None, 0.5])
def test_client_batch_stream_exact(alpha):
    jt = j_task(vocab=64, n_clients=3, alpha=alpha, seed=1)
    tt = t_task(vocab=64, n_clients=3, alpha=alpha, seed=1)
    for client in (-1, 0, 2):
        js, ts = j_stream(jt, client, 2, 16, 1), t_stream(tt, client, 2, 16, 1)
        for _ in range(3):
            jb, tb = next(js), next(ts)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(np.asarray(jb[k]), tb[k])


@pytest.mark.parametrize("shape", [(64, 64), (64, 256), (256, 64), (2048, 256), (5, 7)])
def test_segment_layout_exact(shape):
    l = jreshaping.choose_segment_length(shape)
    assert treshaping.choose_segment_length(shape) == l
    g = np.random.default_rng(0).normal(size=(2, int(np.prod(shape)))).astype(np.float32)
    jG = np.asarray(jreshaping.segment(jnp.asarray(g), l))
    tG = treshaping.segment(torch.from_numpy(g), l)
    np.testing.assert_array_equal(jG, tG.numpy())
    np.testing.assert_array_equal(treshaping.unsegment(tG).numpy(), g)
    jp, jn = jreshaping.pad_to_block(jnp.asarray(jG), 128)
    tp, tn = treshaping.pad_to_block(tG, 128)
    assert jn == tn
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


def test_ledger_exact_integer_bits():
    jl, tl = jmetrics.CommLedger(), tmetrics.CommLedger()
    charges = [(3, 0), (2**40 + 7, 1), (12345678901, 1), (1, None)]
    for led in (jl, tl):
        led.begin_round()
        led.begin_round()
        for bits, rnd in charges:
            led.charge_uplink_bits(bits, group="g", round_idx=rnd)
        led.charge_downlink_bits(99)
    assert jl.uplink_bits == tl.uplink_bits
    assert jl.per_round_uplink == tl.per_round_uplink
    assert jl.downlink_total == tl.downlink_total
    assert isinstance(tl.uplink_bits, int)
    before = tmetrics.host_sync_count()
    out = tmetrics.host_fetch(torch.arange(3, dtype=torch.int32))
    assert isinstance(out, np.ndarray) and tmetrics.host_sync_count() == before + 1


def _codec():
    pol = tpolicy.make_policy({"w": ((256, 64), 2)}, min_params=4096)
    return tcodecs.GradESTCCodec(pol.plans["w"], seed=0)


#: public builders called without a device, as a user would call them
DEFAULT_DEVICE_BUILDERS = {
    "PRNGKey": lambda: prng.PRNGKey(0),
    "init_params": lambda: tmodel.init_params(t_tiny(vocab=64), prng.PRNGKey(0)),
    "client_layer_keys": lambda: tcodecs.client_layer_keys(0, 1, 2, 2),
    "round_base_key": lambda: tcodecs.round_base_key(0, 1),
    "init_client_state": lambda: _codec().init_client_state(2),
    "init_shared_state": lambda: _codec().init_shared_state(),
    "pack_round_stats": lambda: tcomp.pack_round_stats({}, {}),
    "params_from_jax": lambda: params_from_jax({"w": np.zeros(3, np.float32)}),
}


@pytest.mark.parametrize("name", list(DEFAULT_DEVICE_BUILDERS))
def test_builders_default_to_the_card(name):
    """Without a device argument the port builds on CUDA; with no card it
    raises rather than landing on the CPU unnoticed."""
    build = DEFAULT_DEVICE_BUILDERS[name]
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            build()
        return
    out = build()
    leaves = list(out.values()) if isinstance(out, dict) else (
        list(out) if isinstance(out, tuple) else [out])
    assert leaves and all(t.device.type == "cuda" for t in leaves)
