"""Shared layers: RMS norm, RoPE, GQA head repetition, attention, SwiGLU.

Port of the parts of ``repro/models/layers.py`` the dense path runs, as
plain functions on tensors in the reference's layouts: activations
``(B, S, H, hd)`` at function boundaries.  Normalization statistics and
softmax run in f32.  Attention stays plain torch ops, as the reference
computes it outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope_table", "apply_rope", "repeat_kv", "attention",
           "decode_attention", "decode_attention_gqa", "KVCache", "swiglu"]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    rrms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return ((x32 * rrms) * (1.0 + w.float())).to(x.dtype)


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``(..., S, head_dim//2)`` in f32 for int positions."""
    half = head_dim // 2
    f32 = dict(dtype=torch.float32, device=positions.device)
    # the divisor lives on the device: CUDA turns division by a host scalar
    # into a reciprocal multiply, which rounds differently from the reference
    exps = -torch.arange(0, half, **f32) / torch.full((), half, **f32)
    freqs = torch.pow(float(theta), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


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
