"""Port vs reference: the VLM family (qwen2-vl-72b) and its two layers.

``layers.apply_mrope`` with three distinct position streams (temporal,
height, width) and ``layers.attention_gqa`` (grouped K/V, query chunks, a
window) against the reference's, jitted and op by op: bit for bit in bf16.
In f32 the two are GEMM- or transcendental-bearing: XLA's CPU backend takes
glibc's ``cosf``/``sinf`` (the port: torch's, an ulp apart on ~1% of the
angles), so apply_mrope is held within 1e-6 (measured 2.4e-7) and, bit for
bit, to the port's own ``apply_rope`` section by section; attention_gqa
within 2e-6 of max |output| (measured 4.8e-7).  Then ``qwen2-vl-72b``'s
reduced config (f32, 2 layers, M-RoPE, a 16-token vision prefix) on numpy
params in the reference's tree: the forward and the loss with the prefix and
three position streams, and 24 decode steps, against the reference's jitted
ones within 1e-5 of max |logits| (loss rtol 1e-5); and ``extra_inputs``'s
zero prefix.  (The serve driver: ``test_torch_serve_families.py``.)"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from test_torch_decode import _cfgs, _close, _numpy_params, _port_decode, _ref_decode  # noqa: E402

NAME = "qwen2-vl-72b"
RTOL = 1e-5
B, S = 2, 24


def _streams(B_, S_, seed=0):
    """(3, B, S) int32 position ids, three distinct streams."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, 400, (B_, S_)), axis=1)
    return np.stack([t, t // 3 + rng.integers(0, 7, (B_, S_)), t % 17]).astype(np.int32)


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()


def test_mrope_bf16_bits():
    """bf16 at qwen2-vl's hd 128: the reference's jitted and op-by-op
    apply_mrope, bit for bit."""
    x = np.random.default_rng(1).standard_normal((B, S, 4, 128)).astype(np.float32)
    pos = _streams(B, S, 1)
    jx, tx = _bf16(x)
    got = tl.apply_mrope(tx, torch.from_numpy(pos), 1e6)
    assert got.dtype == torch.bfloat16
    for want in (jax.jit(lambda a, p: jl.apply_mrope(a, p, 1e6))(jx, pos),
                 jl.apply_mrope(jx, pos, 1e6)):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_mrope_f32_sections():
    """f32: within 1e-6 of the reference; each of the three frequency
    sections (16 / 24 / 24 of hd 128's 64 rotary pairs) equal bit for bit to
    the port's apply_rope on that section's stream; equal streams give
    apply_rope."""
    rng = np.random.default_rng(2)
    hd, half = 128, 64
    x = rng.standard_normal((B, S, 4, hd)).astype(np.float32)
    pos = _streams(B, S, 3)
    tx, tp = torch.from_numpy(x), torch.from_numpy(pos)
    got = tl.apply_mrope(tx, tp, 1e6)
    want = np.asarray(jax.jit(lambda a, p: jl.apply_mrope(a, p, 1e6))(x, pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    bounds = (0, int(half * 0.25), int(half * 0.25) + int(half * 0.375), half)
    assert bounds == (0, 16, 40, 64)
    for i in range(3):
        rope = tl.apply_rope(tx, tp[i], 1e6)
        cols = [c for lo in (0, half) for c in range(lo + bounds[i], lo + bounds[i + 1])]
        assert torch.equal(got[..., cols], rope[..., cols]), f"section {i}"
    same = torch.from_numpy(np.broadcast_to(pos[:1], pos.shape).copy())
    assert torch.equal(tl.apply_mrope(tx, same, 1e6), tl.apply_rope(tx, same[0], 1e6))


@pytest.mark.parametrize("q_chunk,window", [(0, 0), (16, 0), (16, 8), (0, 8)])
def test_attention_gqa(q_chunk, window):
    """8 query heads over 2 KV heads, 40 positions (a ragged last chunk of
    16): bf16 bit for bit, f32 within 2e-6 of max |output|."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 40, 8, 32), (B, 40, 2, 32), (B, 40, 2, 32)))
    jfn = jax.jit(functools.partial(jl.attention_gqa, causal=True, window=window,
                                    q_chunk=q_chunk))
    tfn = functools.partial(tl.attention_gqa, causal=True, window=window, q_chunk=q_chunk)
    got = tfn(*(torch.from_numpy(a) for a in (q, k, v)))
    _close(got.numpy(), np.asarray(jfn(q, k, v)), "f32", 2e-6)
    jb, tb = zip(*(_bf16(a) for a in (q, k, v)))
    got = tfn(*tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jfn(*jb), np.float32))


@pytest.fixture(scope="module")
def vlm():
    jc, tc = _cfgs(NAME)
    jp = _numpy_params(jc, 4)
    return jc, tc, jp, params_from_jax(jp, "cpu")


def _vlm_batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    P = cfg.vision_tokens
    x = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": x[:, :-1], "labels": x[:, 1:], "positions": _streams(B, P + S, seed),
            "vision_embeds": rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)}


def test_reduced_forward_and_loss_with_prefix(vlm):
    """The 16-token vision prefix and three position streams: logits (B,
    16 + 24, V) and the loss over the 24 text labels, against the
    reference's jitted forward and loss."""
    jc, tc, jp, tp = vlm
    assert (tc.pos_type, tc.vision_tokens, tc.family) == ("mrope", 16, "vlm")
    batch = _vlm_batch(tc)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = np.asarray(jax.jit(lambda p, b: jmodel.forward(jc, p, b))(jp, batch))
    got = tmodel.forward(tc, tp, tb)
    assert got.shape == (B, tc.vision_tokens + S, tc.vocab)
    _close(got.numpy(), want, "forward with prefix")
    jloss = float(jax.jit(lambda p, b: jmodel.loss_fn(jc, p, b))(jp, batch))
    np.testing.assert_allclose(float(tmodel.loss_fn(tc, tp, tb)), jloss, rtol=RTOL)
    # without the prefix the positions stream is not read: text-only M-RoPE
    text = {k: batch[k] for k in ("tokens", "labels")}
    want = np.asarray(jax.jit(lambda p, b: jmodel.forward(jc, p, b))(jp, text))
    _close(tmodel.forward(tc, tp, {k: torch.from_numpy(v) for k, v in text.items()}).numpy(),
           want, "text-only forward")


def test_reduced_decode(vlm):
    """24 decode steps (M-RoPE positions (3, B, 1) from the cache length)
    against the reference's jitted decode_step; the cache after the last."""
    jc, tc, jp, tp = vlm
    toks = np.random.default_rng(6).integers(0, tc.vocab, (B, 24)).astype(np.int32)
    want, jcache = _ref_decode(jc, jp, toks, 32)
    got, tcache = _port_decode(tc, tp, toks, 32)
    _close(got, want, "decode")
    _close(tcache.k.numpy(), np.asarray(jcache.k), "cache k")


def test_extra_inputs(vlm):
    jc, tc, _, _ = vlm
    want = jmodel.extra_inputs(jc, 3, 8)
    got = tmodel.extra_inputs(tc, 3, 8, device="cpu")
    assert set(got) == set(want) == {"vision_embeds"}
    assert tuple(got["vision_embeds"].shape) == want["vision_embeds"].shape == (3, 16, 256)
    assert got["vision_embeds"].dtype == torch.float32 and not got["vision_embeds"].any()
    bf = tmodel.extra_inputs(dataclasses.replace(tc, dtype="bfloat16"), 1, 8, device="cpu")
    assert bf["vision_embeds"].dtype == torch.bfloat16

