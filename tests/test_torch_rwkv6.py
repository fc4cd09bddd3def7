"""Port vs reference: the ssm family (RWKV-6, ``rwkv6-3b``).

``get_config("rwkv6-3b").reduced()`` from each package (2 layers, d 256, 4
WKV heads of 64, d_ff 512, decay lora 16, vocab 1024, f32).  The port's
``init_params`` equals the reference's eager one bit for bit (the same
threefry key tree and normals), and the reference's tree carried across by
``convert.params_from_jax`` gives: the forward's logits within 1e-5 of max
|logits| of the reference's jitted forward, the loss within rtol 1e-5 and
every gradient of ``loss_fn`` within 1e-5 of its leaf's max |gradient|; 24
decode steps against the reference's jitted ``decode_step``, logits and the
final cache within 1e-5 of their max; decode against the port's own
forward.  The WKV recurrence alone (``time_mix_seq`` from a nonzero state
and token shift) against the reference's, within 1e-5 of max |output|.
Measured: init exact, forward 2.6e-6, loss 1.3e-7, gradients 5.8e-6
(``bonus_u``), decode 2.0e-6, the recurrence 1.4e-6.  The helpers here
serve ``test_torch_rglru.py`` and ``test_torch_encdec.py`` too."""

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
from repro.models import rwkv6 as jrwkv6  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch.serve import start_cache  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import rwkv6 as trwkv6  # noqa: E402

NAME = "rwkv6-3b"
RTOL = 1e-5
B, S, STEPS, MAX_LEN = 2, 24, 24, 32


def cfgs(name, **kw):
    return (dataclasses.replace(jget(name).reduced(), **kw),
            dataclasses.replace(tget(name).reduced(), **kw))


def close(got, want, err_msg="", tol=RTOL):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, err_msg
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{err_msg}: max |diff| {err:.3e} > {tol} x {scale:.3e}"


def ref_params(name, seed=0):
    """The reference's eager ``init_params`` (numpy tree) and the port's
    conversion of it."""
    jc, _ = cfgs(name)
    p = jax.device_get(jmodel.init_params(jc, jax.random.PRNGKey(seed)))
    return p, params_from_jax(p, "cpu")


def batch(cfg, seed=7):
    x = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": x[:, :-1], "labels": x[:, 1:]}


def check_init(name, tp):
    """The port's own init equals the converted reference's, bit for bit,
    in the same dtypes."""
    _, tc = cfgs(name)
    own = tmodel.init_params(tc, prng.PRNGKey(0, "cpu"))
    assert set(own) == set(tp)
    for path, x in own.items():
        assert x.dtype == tp[path].dtype and torch.equal(x, tp[path]), path


def check_forward_loss_grads(name, jp, tp):
    jc, tc = cfgs(name)
    b = batch(tc)
    jl = jax.jit(lambda p, t: jmodel.forward(jc, p, {"tokens": t}))(jp, b["tokens"])
    with torch.no_grad():
        tl = tmodel.forward(tc, tp, {"tokens": torch.from_numpy(b["tokens"])})
    assert tl.shape == (B, S, tc.vocab) and tl.dtype == torch.float32
    close(tl.numpy(), jl, "forward")
    jloss, jg = jax.jit(jax.value_and_grad(lambda p: jmodel.loss_fn(jc, p, b)))(jp)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tloss = tmodel.loss_fn(tc, tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    tg = torch.func.grad(lambda p: tmodel.loss_fn(tc, p, tb))(tp)
    jgf = params_from_jax(jax.device_get(jg), "cpu")
    assert set(jgf) == set(tg)
    for path, g in jgf.items():
        close(tg[path].numpy(), g.numpy(), f"grad {path}")


@functools.lru_cache(maxsize=None)
def _ref_step(jc):
    return jax.jit(lambda p, c, t: jmodel.decode_step(jc, p, c, t))


def ref_cache(jc, jp, max_len):
    if jc.family != "encdec":
        return jmodel.init_cache(jc, B, max_len)
    from repro.models import encdec

    frames = jnp.zeros((B, jc.encoder_seq, jc.d_model), jnp.dtype(jc.dtype))
    return jmodel.init_cache(jc, B, max_len, enc_out=encdec.encode_audio(jc, jp, frames),
                             params=jp)


def check_cache_layout(tcache, jcache):
    """The port's cache has the reference's fields, shapes and dtypes."""
    assert type(tcache)._fields == type(jcache)._fields
    for f, t, j in zip(tcache._fields, tcache, jcache):
        assert tuple(t.shape) == tuple(j.shape), f
        assert str(t.dtype) == f"torch.{j.dtype}", f
    assert tcache.length.dim() == 0 and tcache.length.dtype == torch.int32


def decode(cfg, params, tokens, max_len=MAX_LEN):
    """The port's logits (B, T, V) of stepping ``decode_step`` over tokens,
    from ``serve.start_cache``, and the last cache."""
    cache = start_cache(cfg, params, tokens.shape[0], max_len, "cpu")
    outs = []
    for t in range(tokens.shape[1]):
        lg, cache = tmodel.decode_step(cfg, params, cache, torch.from_numpy(tokens[:, t:t + 1]))
        assert lg.shape == (tokens.shape[0], 1, cfg.vocab) and lg.dtype == torch.float32
        outs.append(lg[:, 0])
    return torch.stack(outs, 1).numpy(), cache


def check_decode(name, jp, tp, steps=STEPS, max_len=MAX_LEN):
    """``steps`` decode steps against the reference's jitted decode_step
    (logits at every step and the final cache), then against the port's
    own forward over the same tokens."""
    jc, tc = cfgs(name)
    tokens = np.random.default_rng(0).integers(0, tc.vocab, (B, steps)).astype(np.int32)
    jcache = ref_cache(jc, jp, max_len)
    check_cache_layout(start_cache(tc, tp, B, max_len, "cpu"), jcache)
    step = _ref_step(jc)
    want = []
    for t in range(steps):
        lg, jcache = step(jp, jcache, jnp.asarray(tokens[:, t:t + 1]))
        want.append(np.asarray(lg[:, 0]))
    got, tcache = decode(tc, tp, tokens, max_len)
    for t in range(steps):
        close(got[:, t], want[t], f"decode step {t}")
    assert int(tcache.length) == int(jcache.length) == steps
    for f, t, j in zip(tcache._fields[:-1], tcache[:-1], jcache[:-1]):
        close(t.float().numpy(), np.asarray(j, np.float32), f"cache {f}")
    with torch.no_grad():
        fwd = tmodel.forward(tc, tp, {"tokens": torch.from_numpy(tokens)}).numpy()
    close(got, fwd, "decode vs forward")


@pytest.fixture(scope="module")
def params():
    return ref_params(NAME)


def test_init_params_equal_reference(params):
    check_init(NAME, params[1])
    jc, tc = cfgs(NAME)
    assert tmodel.param_group_shapes(tc) == jmodel.param_group_shapes(jc)
    assert tmodel.family_module(tc) is trwkv6


def test_forward_loss_and_grads(params):
    check_forward_loss_grads(NAME, *params)


def test_decode_matches_reference_and_forward(params):
    check_decode(NAME, *params)


def test_wkv_recurrence_alone(params):
    """``time_mix_seq`` of layer 0 from a nonzero token shift and WKV
    state, and a nonzero bonus u, against the reference's: the output, the
    tail and the final state."""
    jp, tp = params
    jc, tc = cfgs(NAME)
    rng = np.random.default_rng(3)
    H, hd = tc.d_model // tc.rwkv_head_dim, tc.rwkv_head_dim
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    x_last = rng.standard_normal((B, tc.d_model)).astype(np.float32)
    S0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.5).astype(np.float32)
    jw = jax.tree.map(lambda a: a[0], jp["layers"])
    jw["bonus_u"] = u
    tw = {k[len("layers/"):]: v[0] for k, v in tp.items() if k.startswith("layers/")}
    tw["bonus_u"] = torch.from_numpy(u)
    want = jax.jit(lambda w, *a: jrwkv6.time_mix_seq(jc, w, *a))(jw, x, x_last, S0)
    got = trwkv6.time_mix_seq(tc, tw, *(torch.from_numpy(a) for a in (x, x_last, S0)))
    for name, g, w in zip(("out", "tail", "S"), got, want):
        close(g.numpy(), w, name)


def test_bf16_state_and_lambda_stay_f32():
    """In bf16 the WKV state of the cache is f32, as the reference's, and
    the reference's bf16 tree converts with every dtype kept."""
    jc, tc = cfgs(NAME, dtype="bfloat16")
    cache = tmodel.init_cache(tc, 3, 8, device="cpu")
    check_cache_layout(cache, jmodel.init_cache(jc, 3, 8))
    assert cache.S.dtype == torch.float32 and cache.tm_x.dtype == torch.bfloat16
    shapes = jax.eval_shape(lambda k: jmodel.init_params(jc, k), jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    tp = params_from_jax(tree, "cpu")
    own = tmodel.init_params(tc, prng.PRNGKey(0, "cpu"))
    assert {k: (v.dtype, tuple(v.shape)) for k, v in tp.items()} == {
        k: (v.dtype, tuple(v.shape)) for k, v in own.items()}
