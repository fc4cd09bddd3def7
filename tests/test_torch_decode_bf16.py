"""Port vs reference: the dense decode path in bf16, each config's own dtype.

The decode attention bit for bit against the reference's on the same bf16
inputs (q scaled in bf16, p cast to bf16, the f32 contractions of bf16
operands), repeated and grouped, with and without a window; so are RMS
norm, SwiGLU's SiLU (rounded op by op as ``jax.nn.silu``) and RoPE.  Then
reduced ``tinyllama-1.1b`` and ``gemma3-1b`` (``gqa_native`` on and off) in
bf16, params and tokens as in ``test_torch_decode.py``: 24 steps, past
Gemma3's 16-token window, against the reference's jitted ``decode_step``.
XLA fuses that one and rounds it differently from the reference's own
op-by-op run (max 1.28e-2 of max |logits| between the two), so bits cannot
match there.  Measured: the port at most 1.47e-2 of max |logits| from it
(TinyLlama 7.96e-3), the cache 1.39e-2, within the reference's own
decode-vs-forward tolerance of 2e-2 (``tests/test_models_smoke.py``)."""

import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.convert import params_from_jax  # noqa: E402
from test_torch_decode import (ARCHS, B, MAX_LEN, _cfgs, _check_cache, _close,  # noqa: E402
                               _numpy_params, _port_decode, _ref_decode, _tokens)

#: bf16 decode against the reference's jitted decode_step
BF16_TOL = 2e-2


BF16_CASES = [("tinyllama-1.1b", {}), ("gemma3-1b", {}), ("gemma3-1b", {"gqa_native": True})]


@pytest.mark.parametrize("name,kw", BF16_CASES,
                         ids=[n + ("-gqa_native" if kw else "") for n, kw in BF16_CASES])
def test_decode_bf16_matches_reference(name, kw):
    """bf16: 24 steps (past Gemma3's 16-token window) against the
    reference's jitted decode_step within BF16_TOL of max |logits|, the
    cache likewise."""
    jc, tc = _cfgs(name, dtype="bfloat16", **kw)
    jp = _numpy_params(jc, ARCHS.index(name))
    tp = params_from_jax(jp, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    toks = _tokens(tc)
    want, jcache = _ref_decode(jc, jp, toks, MAX_LEN)
    got, tcache = _port_decode(tc, tp, toks, MAX_LEN)
    assert tcache.k.dtype == tcache.v.dtype == torch.bfloat16
    _close(got, want, "bf16 decode vs reference", BF16_TOL)
    _check_cache(tcache, jcache, BF16_TOL)


@pytest.mark.parametrize("layer", ["rms_norm", "silu", "rope"])
def test_layers_bf16_bits(layer):
    """The decode step's other layers in bf16, bit for bit against the
    reference's (jitted alone) on the same inputs: RMS norm, SwiGLU's SiLU
    (fused into one rounding, it would move a third of the values) and RoPE
    at positions 0 to 31.  (SwiGLU's matmuls, like any bf16 matmul, may
    round a rare element the other way from XLA's: one in 4096 here.)"""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(13)
    normal = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    D, F = 64, 128
    if layer == "rms_norm":
        args, kw = [normal(B, 32, D), normal(D, scale=0.1)], {}
    elif layer == "silu":
        args, kw = [normal(B, 32, F, scale=3.0)], {}
    else:
        args, kw = [normal(B, 32, 4, 32)], {"positions": np.arange(32, dtype=np.int32)}
    jfn = {"rms_norm": lambda x, w: jl.rms_norm(x, w, 1e-6), "silu": jax.nn.silu,
           "rope": lambda x, positions: jl.apply_rope(x, positions, 10000.0)}[layer]
    tfn = {"rms_norm": lambda x, w: tl.rms_norm(x, w, 1e-6), "silu": tl._silu,
           "rope": lambda x, positions: tl.apply_rope(x, positions, 10000.0)}[layer]
    want = jax.jit(jfn)(*(jnp.asarray(a).astype(jnp.bfloat16) for a in args),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tfn(*(torch.from_numpy(a).bfloat16() for a in args),
              **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("gqa", [False, True], ids=["repeated", "gqa_native"])
@pytest.mark.parametrize("window", [0, 16])
def test_decode_attention_bf16_bits(gqa, window):
    """The decode attention in bf16, bit for bit against the reference's
    (jitted) on the same inputs, at lengths 1 to full and hd 32, whose
    scale 1/sqrt(32) is no power of two, so scaling q in f32 instead of
    bf16 would show; so would skipping p's cast to bf16 or contracting in
    bf16 (each moves a sixth to a half of the outputs)."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    Bq, S, H, KV, hd = 2, 32, 4, 2, 32
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((Bq, 1, H, hd), (Bq, S, KV, hd), (Bq, S, KV, hd)))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    if gqa:
        jfn = jax.jit(lambda a, b, c, n: jl.decode_attention_gqa(a, b, c, n, window=window))
        tfn = functools.partial(tl.decode_attention_gqa, window=window)
    else:
        jk, jv = jl.repeat_kv(jk, H // KV), jl.repeat_kv(jv, H // KV)
        tk, tv = tl.repeat_kv(tk, H // KV), tl.repeat_kv(tv, H // KV)
        jfn = jax.jit(lambda a, b, c, n: jl.decode_attention(a, b, c, n, window=window))
        tfn = functools.partial(tl.decode_attention, window=window)
    for n in (1, 5, 24, S):
        want = np.asarray(jfn(jq, jk, jv, jnp.asarray(n, jnp.int32)), np.float32)
        length = torch.tensor(n, dtype=torch.int32)
        for masked in (None, tl.decode_mask(S, length, window)):
            got = tfn(tq, tk, tv, length, masked=masked)
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), want, err_msg=f"length {n}")
