"""Port vs reference: the dense model's KV-cache decode path.

Reduced configs in f32 (``tinyllama-1.1b``, ``gemma3-1b`` with its 16-token
window, ``llama3-8b``, ``yi-34b``), numpy params in the reference's tree
(its ``init_params``' shapes, seeded normals at its scales) carried across
by ``convert.params_from_jax``, the same numpy tokens: the port's
``decode_step`` against the reference's (jitted, as its serve driver runs
it) for 24 steps, logits within rtol 1e-5 of their largest magnitude
(``max |port - ref| <= 1e-5 max |ref|``: an element near zero has no
relative digits to keep) at every step, and the cache's contents after the
last; ``gqa_native`` on and off (Gemma3 reduced
is the one config here with fewer KV heads than heads); a cache that fills
and then takes more writes, clamped to its last slot as the reference's
``dynamic_update_slice``; decode against the port's own forward; and, for
the two configs this slice registers, the reduced forward and loss against
the reference's.  Measured: decode vs reference at most 1.59e-6 of max
|logits|, the cache 1.43e-6, decode vs forward 1.13e-6, the new configs'
forward 1.60e-6 and loss 6.6e-8 relative."""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

RTOL = 1e-5
ARCHS = ["tinyllama-1.1b", "gemma3-1b", "llama3-8b", "yi-34b"]
B, STEPS, MAX_LEN = 2, 24, 32


def _cfgs(name, **kw):
    return (dataclasses.replace(jget(name).reduced(), **kw),
            dataclasses.replace(tget(name).reduced(), **kw))


def _numpy_params(jc, seed):
    """Params of the reference's tree and dtypes: seeded normals, 0.02 for
    the embedding, 1/sqrt(fan-in) for a matrix, 0.1 for a norm's gains."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        scale = (0.02 if path[0].key == "embed" else
                 1 / np.sqrt(x.shape[-2]) if x.ndim >= 2 + (path[0].key == "layers") else 0.1)
        return (rng.standard_normal(x.shape) * scale).astype(x.dtype)

    shapes = jax.eval_shape(lambda k: jmodel.init_params(jc, k), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def ref_params():
    """Reference params by arch (numpy) and the port's copy."""
    out = {}
    for i, name in enumerate(ARCHS):
        p = _numpy_params(_cfgs(name)[0], i)
        out[name] = (p, params_from_jax(p, "cpu"))
    return out


def _tokens(cfg, steps=STEPS, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, steps)).astype(np.int32)


def _close(got, want, err_msg="", tol=RTOL):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, err_msg
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{err_msg}: max |diff| {err:.3e} > {tol} x {scale:.3e}"


@functools.lru_cache(maxsize=None)
def _ref_step(jc):
    return jax.jit(lambda p, c, t: jmodel.decode_step(jc, p, c, t))


def _ref_decode(jc, params, tokens, max_len):
    step = _ref_step(jc)
    cache = jmodel.init_cache(jc, B, max_len)
    outs = []
    for t in range(tokens.shape[1]):
        lg, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]))
        outs.append(np.asarray(lg[:, 0]))
    return np.stack(outs, 1), cache


def _port_decode(tc, params, tokens, max_len):
    cache = tmodel.init_cache(tc, B, max_len, device="cpu")
    outs = []
    for t in range(tokens.shape[1]):
        lg, cache = tmodel.decode_step(tc, params, cache, torch.from_numpy(tokens[:, t:t + 1]))
        assert lg.shape == (B, 1, tc.vocab) and lg.dtype == torch.float32
        outs.append(lg[:, 0])
    return torch.stack(outs, 1).numpy(), cache


def _check_cache(tcache, jcache, tol=RTOL):
    assert int(tcache.length) == int(jcache.length)
    assert tcache.length.dtype == torch.int32 and tcache.length.dim() == 0
    _close(tcache.k.float().numpy(), jcache.k, "cache k", tol)
    _close(tcache.v.float().numpy(), jcache.v, "cache v", tol)


CASES = [(n, {}) for n in ARCHS] + [("gemma3-1b", {"gqa_native": True})]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[n + ("-gqa_native" if kw else "") for n, kw in CASES])
def test_decode_matches_reference(ref_params, name, kw):
    jc, tc = _cfgs(name, **kw)
    jp, tp = ref_params[name]
    toks = _tokens(tc)
    want, jcache = _ref_decode(jc, jp, toks, MAX_LEN)
    got, tcache = _port_decode(tc, tp, toks, MAX_LEN)
    _close(got, want, "decode vs reference")
    _check_cache(tcache, jcache)
    # decode against the port's own forward over the same tokens
    fwd = tmodel.forward(tc, tp, {"tokens": torch.from_numpy(toks)}).numpy()
    _close(got, fwd, "decode vs forward")


def test_window_and_gqa_native_agree(ref_params):
    """Gemma3 reduced: the window masks (24 steps > 16), and the grouped
    attention equals the repeated one's."""
    jc, tc = _cfgs("gemma3-1b")
    assert tc.sliding_window == 16 and tc.n_kv_heads < tc.n_heads
    p = ref_params["gemma3-1b"][1]
    toks = _tokens(tc, seed=3)
    a, _ = _port_decode(tc, p, toks, MAX_LEN)
    b, _ = _port_decode(dataclasses.replace(tc, gqa_native=True), p, toks, MAX_LEN)
    _close(b, a, "gqa_native")
    full, _ = _port_decode(dataclasses.replace(tc, sliding_window=0), p, toks, MAX_LEN)
    assert np.abs(full[:, 16:] - a[:, 16:]).max() > 1e-3        # the window acted
    _close(full[:, :16], a[:, :16], "inside the window")


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "gemma3-1b"])
def test_full_cache_write_clamps(ref_params, name):
    """12 steps into an 8-slot cache: each write past the end lands on the
    last slot, as the reference's clamped ``dynamic_update_slice``; no
    error, and logits and cache equal the reference's."""
    jc, tc = _cfgs(name)
    jp, tp = ref_params[name]
    toks = _tokens(tc, steps=12, seed=5)
    want, jcache = _ref_decode(jc, jp, toks, 8)
    got, tcache = _port_decode(tc, tp, toks, 8)
    _close(got, want, "clamped decode")
    _check_cache(tcache, jcache)
    assert int(tcache.length) == 12


@pytest.mark.parametrize("name", ["llama3-8b", "yi-34b"])
def test_new_configs_forward_and_loss(ref_params, name):
    """The two configs this slice registers: published fields equal to the
    reference's, and the reduced forward and loss against the reference."""
    assert dataclasses.asdict(tget(name)) == dataclasses.asdict(jget(name))
    jc, tc = _cfgs(name)
    jp, tp = ref_params[name]
    x = np.random.default_rng(7).integers(0, tc.vocab, (B, 17)).astype(np.int32)
    batch = {"tokens": x[:, :-1], "labels": x[:, 1:]}
    want = np.asarray(jax.jit(lambda p: jmodel.forward(jc, p, batch))(jp))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tmodel.forward(tc, tp, tb).numpy()
    _close(got, want, "forward")
    jl = float(jax.jit(lambda p: jmodel.loss_fn(jc, p, batch))(jp))
    np.testing.assert_allclose(float(tmodel.loss_fn(tc, tp, tb)), jl, rtol=RTOL)


def test_model_api():
    """init_cache's layout, extra_inputs and count_params, as the
    reference's for a dense model; an MoE cache is the same; an ssm cache
    has the reference's RWKVCache shapes and dtypes."""
    jc, tc = _cfgs("gemma3-1b")
    cache = tmodel.init_cache(tc, 3, 10, length=4, device="cpu")
    assert cache.k.shape == (tc.n_layers, 3, 10, tc.n_kv_heads, tc.hd)
    assert cache.k.dtype == torch.float32 and int(cache.length) == 4
    assert tmodel.extra_inputs(tc, 2, 8) == {} == jmodel.extra_inputs(jc, 2, 8)
    p = _numpy_params(jc, 0)
    assert tmodel.count_params(params_from_jax(p, "cpu")) == jmodel.count_params(p)
    ssm = tmodel.init_cache(dataclasses.replace(tc, family="ssm"), 1, 4, device="cpu")
    want = jmodel.init_cache(dataclasses.replace(jc, family="ssm"), 1, 4)
    assert type(ssm).__name__ == type(want).__name__ == "RWKVCache"
    for got, ref in zip(ssm, want):
        assert tuple(got.shape) == ref.shape and str(got.dtype) == f"torch.{ref.dtype}"
    moe = tmodel.init_cache(dataclasses.replace(tc, family="moe", n_experts=4), 1, 4,
                            device="cpu")
    assert moe.k.shape == (tc.n_layers, 1, 4, tc.n_kv_heads, tc.hd)

