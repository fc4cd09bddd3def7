"""Decoder-only transformer stack: the dense, MoE and VLM families.

Port of ``repro/models/transformer.py`` (llama3-8b, tinyllama-1.1b,
yi-34b, gemma3-1b; granite-moe-1b-a400m and dbrx-132b through the MoE FFN
of :mod:`.moe`; qwen2-vl-72b with M-RoPE and a vision-embedding prefix).
Parameters are a flat ``{path: tensor}`` dict keyed by the reference's
pytree paths (``"embed"``, ``"layers/attn_wq"``, ..., ``"ln_f"``,
``"head"``), with the reference's stacked layouts: per-layer weights carry
a leading ``L`` axis, e.g. ``layers/attn_wq`` is ``(L, D, H*hd)``.  The
layer loop is a Python loop over that axis (the reference's ``lax.scan``).

Initialization draws from the reference's key tree with
:mod:`repro_torch.core.prng`, so initial weights equal the reference's to
within the PRNG's normal bound.

Attention: a forward on the card with grad disabled (the eval forward,
which runs under ``torch.no_grad``) goes through the flash kernel
(``kernels.ops.flash_attention``, GQA without repeating K/V); every other
forward (local training under ``torch.func.grad``, anything on the CPU)
runs the plain attention, as the reference's ``model.forward`` does:
``layers.attention_gqa`` over grouped K/V where ``cfg.gqa_native`` and
KV < H, else ``layers.attention`` over repeated K/V.  :func:`attend` makes
that choice for every family's forward.  The reference defines no
backward for its flash kernel, so training stays plain.

Decode: ``init_cache`` builds the stacked ``(L, B, S, KV, hd)`` KV cache in
the model dtype and ``decode_step`` runs one token against it, as the
reference's decode path.  Its attention is the plain single-query
``layers.decode_attention`` (the reference's too is outside any Pallas
kernel); the flash kernel, which takes any query and key lengths (the
encdec family's cross-attention reads 1500 keys for S queries), runs in
no decode step.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ..core import prng
from ..kernels import ops
from .config import ArchConfig
from .layers import (KVCache, apply_mrope, apply_rope, attention, attention_gqa,
                     decode_attention, decode_attention_gqa, decode_mask, repeat_kv, rms_norm,
                     scaled_normal, swiglu)
from .moe import init_moe_ffn, moe_ffn

Params = Dict[str, torch.Tensor]

__all__ = ["init_params", "forward_hidden", "forward", "init_cache", "decode_step",
           "param_group_shapes", "padded_vocab", "FAMILIES"]

#: the families this stack serves (the reference's ``_TRANSFORMER_FAMILIES``)
FAMILIES = ("dense", "moe", "vlm")
_ATTN_KEYS = ("ln_attn", "ln_mlp", "attn_wq", "attn_wk", "attn_wv", "attn_wo")
_MLP_KEYS = ("mlp_wgate", "mlp_win", "mlp_wout")
_MOE_KEYS = ("router", "moe_wgate", "moe_win", "moe_wout")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not a transformer family (this module "
            f"serves {', '.join(FAMILIES)}; ``model.family_module`` picks the module of "
            f"every family)")


def _layer_keys(cfg: ArchConfig) -> Tuple[str, ...]:
    return _ATTN_KEYS + (_MOE_KEYS if cfg.n_experts else _MLP_KEYS)


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def padded_vocab(cfg: ArchConfig) -> int:
    m = cfg.pad_vocab_multiple
    return cfg.vocab if not m else ((cfg.vocab + m - 1) // m) * m


def init_params(cfg: ArchConfig, key: torch.Tensor) -> Params:
    """Parameters on ``key.device`` from the reference's key tree."""
    _check_family(cfg)
    kE, kL, kH = prng.split(key, 3).unbind(0)
    dt = _dtype(cfg)
    D, F, H, KV, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    V, L = padded_vocab(cfg), cfg.n_layers
    ks = prng.split(kL, 8).unbind(0)
    s, sf = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F)
    dev = key.device
    p: Params = {
        "embed": scaled_normal(kE, (V, D), dt, mul=0.02),
        "layers/ln_attn": torch.zeros((L, D), dtype=dt, device=dev),
        "layers/ln_mlp": torch.zeros((L, D), dtype=dt, device=dev),
        "layers/attn_wq": scaled_normal(ks[0], (L, D, H * hd), dt, mul=s),
        "layers/attn_wk": scaled_normal(ks[1], (L, D, KV * hd), dt, mul=s),
        "layers/attn_wv": scaled_normal(ks[2], (L, D, KV * hd), dt, mul=s),
        "layers/attn_wo": scaled_normal(ks[3], (L, H * hd, D), dt,
                                        mul=1.0 / math.sqrt(H * hd)),
        "ln_f": torch.zeros((D,), dtype=dt, device=dev),
    }
    if cfg.n_experts:
        p.update({f"layers/{k}": x for k, x in init_moe_ffn(cfg, ks[4], L).items()})
    else:
        p.update({
            "layers/mlp_wgate": scaled_normal(ks[5], (L, D, F), dt, mul=s),
            "layers/mlp_win": scaled_normal(ks[6], (L, D, F), dt, mul=s),
            "layers/mlp_wout": scaled_normal(ks[7], (L, F, D), dt, mul=sf),
        })
    if not cfg.tie_embeddings:
        p["head"] = scaled_normal(kH, (D, V), dt, div=math.sqrt(D))
    return p


def _layer_windows(cfg: ArchConfig) -> List[int]:
    """Per-layer sliding window (0 = full attention), from the pattern."""
    return [cfg.sliding_window if k == "local" else 0 for k in cfg.layer_kinds()]


def _embed(cfg: ArchConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    dt = _dtype(cfg)
    x = params["embed"][tokens.long()].to(dt)
    if cfg.scale_embed:       # multiplied in the model dtype
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    return x


def _head(cfg: ArchConfig, params: Params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _positions_for(cfg: ArchConfig, B: int, S: int, device) -> torch.Tensor:
    """Default positions 0..S-1: (B, S), or (3, B, S) equal streams for
    M-RoPE (text only)."""
    pos = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    return pos[None].expand(3, B, S) if cfg.pos_type == "mrope" else pos


def _rotary(cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if cfg.pos_type == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta)
    if cfg.pos_type == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    return x


def _ffn(cfg: ArchConfig, h: torch.Tensor, w: Params) -> torch.Tensor:
    if cfg.n_experts:
        return moe_ffn(cfg, h, w)
    return swiglu(h, w["mlp_wgate"], w["mlp_win"], w["mlp_wout"])


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
           window: int = 0, q_chunk: int = 0, gqa_native: bool = False) -> torch.Tensor:
    """The attention of every family's forward.  q: (B, Sq, H, hd); k, v:
    (B, Skv, KV, hd).  On the card with grad disabled, the flash kernel;
    else the plain attention: ``attention_gqa`` over grouped K/V where
    ``gqa_native`` and KV < H, else ``attention`` over K/V repeated to H
    heads."""
    if q.is_cuda and not torch.is_grad_enabled():
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    H, KV = q.shape[2], k.shape[2]
    if gqa_native and KV != H:
        return attention_gqa(q, k, v, causal=causal, window=window, q_chunk=q_chunk)
    return attention(q, repeat_kv(k, H // KV), repeat_kv(v, H // KV), causal=causal,
                     window=window, q_chunk=q_chunk)


def _layer_fwd(cfg: ArchConfig, x: torch.Tensor, w: Params, positions: torch.Tensor,
               window: int) -> torch.Tensor:
    """One pre-norm block: attention + SwiGLU or MoE FFN."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, w["ln_attn"], cfg.norm_eps)
    q = _rotary(cfg, (h @ w["attn_wq"]).reshape(B, S, H, hd), positions)
    k = _rotary(cfg, (h @ w["attn_wk"]).reshape(B, S, KV, hd), positions)
    v = (h @ w["attn_wv"]).reshape(B, S, KV, hd)
    o = attend(q, k, v, causal=True, window=window, q_chunk=cfg.attn_chunk,
               gqa_native=cfg.gqa_native)
    x = x + o.reshape(B, S, H * hd) @ w["attn_wo"]
    return x + _ffn(cfg, rms_norm(x, w["ln_mlp"], cfg.norm_eps), w)


def forward_hidden(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None,
                   vision_embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward up to the final norm: (hidden (B, S_total, D), head (D, V)).
    ``vision_embeds`` (B, P, D) prefix the text (S_total = P + S);
    ``positions`` default to 0..S_total-1, three equal streams for M-RoPE."""
    _check_family(cfg)
    x = _embed(cfg, params, tokens)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    if positions is None:
        positions = _positions_for(cfg, B, S, x.device)
    keys = _layer_keys(cfg)
    for i, window in enumerate(_layer_windows(cfg)):
        w = {name: params[f"layers/{name}"][i] for name in keys}
        x = _layer_fwd(cfg, x, w, positions, window)
    return rms_norm(x, params["ln_f"], cfg.norm_eps), _head(cfg, params)


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, **kw) -> torch.Tensor:
    """Full logits (B, S_total, V) in f32; ``kw`` as :func:`forward_hidden`."""
    x, head = forward_hidden(cfg, params, tokens, **kw)
    return (x @ head).float()[..., : cfg.vocab]


def init_cache(cfg: ArchConfig, batch: int, max_len: int, length: int = 0,
               device="cuda") -> KVCache:
    """Stacked (L, B, S, KV, hd) KV cache of zeros in the model dtype on
    ``device`` (the card unless the caller asks for the CPU); ``length``
    marks pre-filled tokens."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    z = dict(dtype=_dtype(cfg), device=device)
    return KVCache(k=torch.zeros(shape, **z), v=torch.zeros(shape, **z),
                   length=torch.full((), length, dtype=torch.int32, device=device))


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: KVCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
    """One new token (B, 1) against the KV cache; returns (logits (B, 1,
    vocab) f32, cache).

    The passed cache is consumed: its k and v are written in place at
    ``cache.length`` (clamped to the last slot when the cache is full, as
    the reference's ``dynamic_update_slice`` clamps) and returned in the
    new cache, so serving holds one cache, not two.  The write's index
    stays on the device: no host read."""
    _check_family(cfg)
    B = tokens.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = _embed(cfg, params, tokens)
    length = cache.length
    positions = length.reshape(1, 1).expand(B, 1)
    if cfg.pos_type == "mrope":
        positions = positions[None].expand(3, B, 1)
    slot = length.clamp_max(cache.k.shape[2] - 1).reshape(1).long()
    new_len = length + 1
    windows = _layer_windows(cfg)
    # one mask per window kind (Gemma3's local and global), not per layer
    masks = {w: decode_mask(cache.k.shape[2], new_len, w) for w in set(windows)}
    keys = _layer_keys(cfg)
    for i, window in enumerate(windows):
        w = {name: params[f"layers/{name}"][i] for name in keys}
        h = rms_norm(x, w["ln_attn"], cfg.norm_eps)
        q = _rotary(cfg, (h @ w["attn_wq"]).reshape(B, 1, H, hd), positions)
        k = _rotary(cfg, (h @ w["attn_wk"]).reshape(B, 1, KV, hd), positions)
        v = (h @ w["attn_wv"]).reshape(B, 1, KV, hd)
        kc, vc = cache.k[i], cache.v[i]
        kc.index_copy_(1, slot, k)
        vc.index_copy_(1, slot, v)
        if cfg.gqa_native and KV != H:
            o = decode_attention_gqa(q, kc, vc, new_len, masked=masks[window])
        else:
            o = decode_attention(q, repeat_kv(kc, H // KV), repeat_kv(vc, H // KV), new_len,
                                 masked=masks[window])
        x = x + o.reshape(B, 1, H * hd) @ w["attn_wo"]
        x = x + _ffn(cfg, rms_norm(x, w["ln_mlp"], cfg.norm_eps), w)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x @ _head(cfg, params)).float()[..., : cfg.vocab]
    return logits, KVCache(k=cache.k, v=cache.v, length=new_len)


def param_group_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """{group: (per-layer shape, stack)} for the GradESTC policy."""
    _check_family(cfg)
    D, F, H, KV, hd, L = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                          cfg.hd, cfg.n_layers)
    groups = {
        "layers/attn_wq": ((D, H * hd), L),
        "layers/attn_wk": ((D, KV * hd), L),
        "layers/attn_wv": ((D, KV * hd), L),
        "layers/attn_wo": ((H * hd, D), L),
        "layers/ln_attn": ((D,), L),
        "layers/ln_mlp": ((D,), L),
        "embed": ((padded_vocab(cfg), D), 1),
        "ln_f": ((D,), 1),
    }
    if cfg.n_experts:
        E = cfg.n_experts
        groups.update({
            "layers/moe_wgate": ((E, D, F), L),
            "layers/moe_win": ((E, D, F), L),
            "layers/moe_wout": ((E, F, D), L),
            "layers/router": ((D, E), L),
        })
    else:
        groups.update({
            "layers/mlp_wgate": ((D, F), L),
            "layers/mlp_win": ((D, F), L),
            "layers/mlp_wout": ((F, D), L),
        })
    if not cfg.tie_embeddings:
        groups["head"] = ((D, padded_vocab(cfg)), 1)
    return groups
