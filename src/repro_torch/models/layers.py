"""Shared layers: RMS and layer norm, RoPE and M-RoPE, GQA head repetition,
attention, SwiGLU, the GELU MLP, and the activations that round op by op
below f32.

Port of ``repro/models/layers.py``, as plain functions on tensors in the reference's layouts: activations
``(B, S, H, hd)`` at function boundaries.  Normalization statistics and
softmax run in f32.  Attention stays plain torch ops, as the reference
computes it outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..core import prng

__all__ = ["rms_norm", "layer_norm", "rope_table", "apply_rope", "apply_mrope", "repeat_kv", "attention",
           "attention_gqa", "decode_attention", "decode_attention_gqa", "KVCache", "swiglu",
           "gelu_mlp", "gelu_tanh", "sigmoid", "scaled_normal"]


def scaled_normal(key: torch.Tensor, shape, dt, mul: float = 1.0,
                  div: float = 1.0) -> torch.Tensor:
    """``normal(key, shape) * mul`` or ``/ div`` in ``dt``, with the scalar
    rounded to that dtype first (the reference's weak-typed scalar).
    Neither scalar is copied to the device: the factor is a 0-dim host
    tensor, the divisor is filled on the device (CUDA turns division by a
    host scalar into a reciprocal multiply, which rounds differently)."""
    x = prng.normal(key, shape).to(dt)
    if mul != 1.0:
        x = x * torch.tensor(mul, dtype=dt)
    if div != 1.0:
        x = x / torch.full((), div, dtype=dt, device=x.device)
    return x


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    rrms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return ((x32 * rrms) * (1.0 + w.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with the statistics in f32: the
    reference's mean, then the mean of the squared centred values."""
    x32 = x.float()
    c = x32 - x32.mean(-1, keepdim=True)
    y = c * torch.rsqrt((c * c).mean(-1, keepdim=True) + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``(..., S, head_dim//2)`` in f32 for int positions."""
    ang = positions.float()[..., None] * _rope_freqs(head_dim // 2, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def _rope_freqs(half: int, theta: float, device) -> torch.Tensor:
    """theta ** (-arange(half) / half) in f32, correctly rounded as the
    reference's ``powf`` gives it: the power of the f32 operands taken in
    f64 (an f32 power is an ulp off on some exponents, which a position in
    the hundreds turns into 1e-5 of angle)."""
    f32 = dict(dtype=torch.float32, device=device)
    # the divisor lives on the device: CUDA turns division by a host scalar
    # into a reciprocal multiply, which rounds differently from the reference
    exps = -torch.arange(0, half, **f32) / torch.full((), half, **f32)
    theta32 = float(torch.tensor(theta, dtype=torch.float32))
    return torch.pow(theta32, exps.double()).float()


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, half) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[..., None, :].float(), sin[..., None, :].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard RoPE.  x: (B, S, H, hd); positions: (B, S) or (S,)."""
    if positions.dim() == 1:
        positions = positions[None, :]
    cos, sin = rope_table(positions, x.shape[-1], theta)
    return _rotate(x, cos, sin)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[float, float, float] = (0.25, 0.375, 0.375)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE (reference ``layers.apply_mrope``): the
    rotary frequencies split into three contiguous sections of
    ``int(half * 0.25)``, ``int(half * 0.375)`` and the rest, fed by the
    (temporal, height, width) position streams ``positions3`` (3, B, S).
    Three equal streams give :func:`apply_rope`."""
    half = x.shape[-1] // 2
    s0 = int(half * sections[0])
    s1 = int(half * sections[1])
    freqs = _rope_freqs(half, theta, positions3.device)
    cos_parts, sin_parts = [], []
    lo = 0
    for i, hi in enumerate((s0, s0 + s1, half)):
        ang = positions3[i].float()[..., None] * freqs[lo:hi]
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        lo = hi
    return _rotate(x, torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1))


def repeat_kv(kv: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd) by head repetition (GQA)."""
    if n_rep == 1:
        return kv
    b, s, h, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _mask_bias(sq: int, skv: int, q_offset: int, *, causal: bool, window: int,
               device) -> torch.Tensor:
    """Additive f32 mask bias (sq, skv); window <= 0 means full attention."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full((), -1e30, device=device))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_chunk: int = 0,
              softmax_scale: float | None = None) -> torch.Tensor:
    """Multi-head attention over full sequences.  q: (B, Sq, H, hd); k, v:
    (B, Skv, H, hd), already GQA-repeated.  ``q_chunk`` > 0 walks query
    blocks so the live scores are (B, H, q_chunk, Skv)."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    scale_t = torch.tensor(scale, dtype=q.dtype)     # 0-dim on the host: no device copy

    def blk(qb: torch.Tensor, off: int) -> torch.Tensor:
        s = torch.einsum("bqhd,bkhd->bhqk", qb * scale_t, k).float()
        s = s + _mask_bias(qb.shape[1], Skv, off, causal=causal, window=window,
                           device=q.device)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)

    if not q_chunk or Sq <= q_chunk:
        return blk(q, 0)
    outs = [blk(q[:, i:i + q_chunk], i) for i in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1)


def attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, q_chunk: int = 0,
                  softmax_scale: float | None = None) -> torch.Tensor:
    """Grouped-query attention without repeating K/V (reference
    ``layers.attention_gqa``, ``ArchConfig.gqa_native``).  q: (B, Sq, H, hd);
    k, v: (B, Skv, KV, hd), H = KV * G.  q is scaled in its dtype, the
    ``bqkgd,bskd->bkgqs`` scores and the contraction with V accumulate in
    f32 from the model-dtype operands (the reference's
    ``preferred_element_type=f32``), p is cast to V's dtype; ``q_chunk`` > 0
    walks query blocks (a ragged last one too)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    scale_t = torch.tensor(scale, dtype=q.dtype)     # 0-dim on the host: no device copy
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    kf, vf = k.float(), v.float()

    def blk(qb: torch.Tensor, off: int) -> torch.Tensor:
        s = torch.einsum("bqkgd,bskd->bkgqs", (qb * scale_t).float(), kf)
        s = s + _mask_bias(qb.shape[1], Skv, off, causal=causal, window=window,
                           device=q.device)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), vf).to(q.dtype)

    if not q_chunk or Sq <= q_chunk:
        return blk(qg, 0).reshape(B, Sq, H, hd)
    outs = [blk(qg[:, i:i + q_chunk], i) for i in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def decode_mask(S: int, length: torch.Tensor, window: int = 0) -> torch.Tensor:
    """(B or 1, S) bool, True for the keys a decode step masks out: at or
    above ``length`` and, for ``window`` > 0, below ``length - window``;
    ``length`` is a 0-dim or (B,) int tensor."""
    kpos = torch.arange(S, device=length.device)
    lb = length.reshape(-1, 1)
    out = kpos >= lb
    if window > 0:
        out = out | (kpos < lb - window)
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length: torch.Tensor, *, window: int = 0,
                     softmax_scale: float | None = None,
                     masked: torch.Tensor | None = None) -> torch.Tensor:
    """Single-token attention against a KV cache.  q: (B, 1, H, hd); caches:
    (B, S, H, hd), already GQA-repeated; ``length``: 0-dim or (B,) int, the
    valid length; ``masked``: :func:`decode_mask` of ``length`` and
    ``window``, when the caller has it.  q is scaled in its dtype; the
    scores and the contraction with V accumulate in f32 from the
    model-dtype operands (the reference's ``preferred_element_type=f32``),
    softmax in f32, p cast to V's dtype."""
    B, S, H, hd = k_cache.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qs = q * torch.tensor(scale, dtype=q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k_cache.float())       # (B, H, 1, S)
    if masked is None:
        masked = decode_mask(S, length, window)
    p = torch.softmax(s.masked_fill(masked[:, None, None, :], -1e30), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v_cache.dtype).float(), v_cache.float())
    return o.to(q.dtype)


def decode_attention_gqa(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         length: torch.Tensor, *, window: int = 0,
                         softmax_scale: float | None = None,
                         masked: torch.Tensor | None = None) -> torch.Tensor:
    """Single-token GQA attention against an un-repeated (B, S, KV, hd)
    cache, with :func:`decode_attention`'s rounding and arguments."""
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qg = (q * torch.tensor(scale, dtype=q.dtype)).reshape(B, 1, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float())
    if masked is None:
        masked = decode_mask(S, length, window)
    p = torch.softmax(s.masked_fill(masked[:, None, None, None, :], -1e30), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor        # (L, B, S, KV, hd) in the model dtype
    v: torch.Tensor        # (L, B, S, KV, hd)
    length: torch.Tensor   # () int32 on the cache's device: tokens already in cache


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
           w_out: torch.Tensor) -> torch.Tensor:
    return (_silu(x @ w_gate) * (x @ w_in)) @ w_out


def _silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU.  Below f32 it takes ``jax.nn.silu``'s ops, x * (1 / (1 +
    exp(-x))), each rounded to x's dtype as the reference rounds them: in
    bf16 one rounding instead of four moves a third of the values by an ulp.
    f32 keeps the single fused op, within an ulp of the reference's."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic function; below f32, 1 / (1 + exp(-x)) rounded op by op
    to x's dtype, as :func:`_silu` rounds."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``, x * 0.5 (1 + tanh(sqrt(2/pi)
    (x + 0.044715 x^3))), on the f32 values the reference hands it."""
    return F.gelu(x.float(), approximate="tanh")


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """The biased two-layer MLP with the tanh GELU taken in f32."""
    h = gelu_tanh(x @ w_in + b_in).to(x.dtype)
    return h @ w_out + b_out
