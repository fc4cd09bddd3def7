"""Decoder-only dense transformer stack.

Port of the dense path of ``repro/models/transformer.py``.  Parameters are
a flat ``{path: tensor}`` dict keyed by the reference's pytree paths
(``"embed"``, ``"layers/attn_wq"``, ..., ``"ln_f"``, ``"head"``), with the
reference's stacked layouts: per-layer weights carry a leading ``L`` axis,
e.g. ``layers/attn_wq`` is ``(L, D, H*hd)``.  The layer loop is a Python
loop over that axis (the reference's ``lax.scan``).

Initialization draws from the reference's key tree with
:mod:`repro_torch.core.prng`, so initial weights equal the reference's to
within the PRNG's normal bound.

Attention: a forward on the card with grad disabled (the eval forward,
which runs under ``torch.no_grad``) goes through the flash kernel
(``kernels.ops.flash_attention``, GQA without repeating K/V); every other
forward (local training under ``torch.func.grad``, anything on the CPU)
runs the plain ``layers.attention`` over repeated K/V, as the reference's
``model.forward`` does.  The reference defines no backward for its flash
kernel, so training stays plain.

Decode: ``init_cache`` builds the stacked ``(L, B, S, KV, hd)`` KV cache in
the model dtype and ``decode_step`` runs one token against it, as the
reference's decode path.  Its attention is the plain single-query
``layers.decode_attention`` (the reference's too is outside any Pallas
kernel); the flash kernel, which attends over equal query and key axes,
never runs in a decode step.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from ..core import prng
from ..kernels import ops
from .config import ArchConfig
from .layers import (KVCache, apply_rope, attention, decode_attention, decode_attention_gqa,
                     decode_mask, repeat_kv, rms_norm, swiglu)

Params = Dict[str, torch.Tensor]

__all__ = ["init_params", "forward_hidden", "forward", "init_cache", "decode_step",
           "param_group_shapes", "padded_vocab"]

_LAYER_KEYS = ("ln_attn", "ln_mlp", "attn_wq", "attn_wk", "attn_wv", "attn_wo",
               "mlp_wgate", "mlp_win", "mlp_wout")


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts or cfg.pos_type not in ("rope", "none"):
        raise NotImplementedError(
            f"{cfg.name}: only the dense rope transformer is ported "
            "(the other families are ROADMAP A13)")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def padded_vocab(cfg: ArchConfig) -> int:
    m = cfg.pad_vocab_multiple
    return cfg.vocab if not m else ((cfg.vocab + m - 1) // m) * m


def _scaled_normal(key: torch.Tensor, shape, dt, mul: float = 1.0,
                   div: float = 1.0) -> torch.Tensor:
    """``normal(key, shape) * mul`` or ``/ div`` in the model dtype, with the
    scalar rounded to that dtype first (the reference's weak-typed scalar).
    Neither scalar is copied to the device: the factor is a 0-dim host
    tensor, the divisor is filled on the device (CUDA turns division by a
    host scalar into a reciprocal multiply, which rounds differently)."""
    x = prng.normal(key, shape).to(dt)
    if mul != 1.0:
        x = x * torch.tensor(mul, dtype=dt)
    if div != 1.0:
        x = x / torch.full((), div, dtype=dt, device=x.device)
    return x


def init_params(cfg: ArchConfig, key: torch.Tensor) -> Params:
    """Parameters on ``key.device`` from the reference's key tree."""
    _check_dense(cfg)
    kE, kL, kH = prng.split(key, 3).unbind(0)
    dt = _dtype(cfg)
    D, F, H, KV, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    V, L = padded_vocab(cfg), cfg.n_layers
    ks = prng.split(kL, 8).unbind(0)
    s, sf = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F)
    dev = key.device
    p: Params = {
        "embed": _scaled_normal(kE, (V, D), dt, mul=0.02),
        "layers/ln_attn": torch.zeros((L, D), dtype=dt, device=dev),
        "layers/ln_mlp": torch.zeros((L, D), dtype=dt, device=dev),
        "layers/attn_wq": _scaled_normal(ks[0], (L, D, H * hd), dt, mul=s),
        "layers/attn_wk": _scaled_normal(ks[1], (L, D, KV * hd), dt, mul=s),
        "layers/attn_wv": _scaled_normal(ks[2], (L, D, KV * hd), dt, mul=s),
        "layers/attn_wo": _scaled_normal(ks[3], (L, H * hd, D), dt,
                                         mul=1.0 / math.sqrt(H * hd)),
        "layers/mlp_wgate": _scaled_normal(ks[5], (L, D, F), dt, mul=s),
        "layers/mlp_win": _scaled_normal(ks[6], (L, D, F), dt, mul=s),
        "layers/mlp_wout": _scaled_normal(ks[7], (L, F, D), dt, mul=sf),
        "ln_f": torch.zeros((D,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        p["head"] = _scaled_normal(kH, (D, V), dt, div=math.sqrt(D))
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


def _layer_fwd(cfg: ArchConfig, x: torch.Tensor, w: Params, positions: torch.Tensor,
               window: int) -> torch.Tensor:
    """One pre-norm block: attention + SwiGLU FFN."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, w["ln_attn"], cfg.norm_eps)
    q = (h @ w["attn_wq"]).reshape(B, S, H, hd)
    k = (h @ w["attn_wk"]).reshape(B, S, KV, hd)
    v = (h @ w["attn_wv"]).reshape(B, S, KV, hd)
    if cfg.pos_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if q.is_cuda and not torch.is_grad_enabled():
        o = ops.flash_attention(q, k, v, causal=True, window=window)
    else:
        o = attention(q, repeat_kv(k, H // KV), repeat_kv(v, H // KV), causal=True,
                      window=window, q_chunk=cfg.attn_chunk)
    x = x + o.reshape(B, S, H * hd) @ w["attn_wo"]
    h = rms_norm(x, w["ln_mlp"], cfg.norm_eps)
    return x + swiglu(h, w["mlp_wgate"], w["mlp_win"], w["mlp_wout"])


def forward_hidden(cfg: ArchConfig, params: Params,
                   tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward up to the final norm: (hidden (B, S, D), head (D, V))."""
    _check_dense(cfg)
    x = _embed(cfg, params, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    for i, window in enumerate(_layer_windows(cfg)):
        w = {name: params[f"layers/{name}"][i] for name in _LAYER_KEYS}
        x = _layer_fwd(cfg, x, w, positions, window)
    return rms_norm(x, params["ln_f"], cfg.norm_eps), _head(cfg, params)


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Full logits (B, S, V) in f32."""
    x, head = forward_hidden(cfg, params, tokens)
    return (x @ head).float()[..., : cfg.vocab]


def init_cache(cfg: ArchConfig, batch: int, max_len: int, length: int = 0,
               device="cuda") -> KVCache:
    """Stacked (L, B, S, KV, hd) KV cache of zeros in the model dtype on
    ``device`` (the card unless the caller asks for the CPU); ``length``
    marks pre-filled tokens."""
    _check_dense(cfg)
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
    _check_dense(cfg)
    B = tokens.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = _embed(cfg, params, tokens)
    length = cache.length
    positions = length.reshape(1, 1).expand(B, 1)
    slot = length.clamp_max(cache.k.shape[2] - 1).reshape(1).long()
    new_len = length + 1
    windows = _layer_windows(cfg)
    # one mask per window kind (Gemma3's local and global), not per layer
    masks = {w: decode_mask(cache.k.shape[2], new_len, w) for w in set(windows)}
    for i, window in enumerate(windows):
        w = {name: params[f"layers/{name}"][i] for name in _LAYER_KEYS}
        h = rms_norm(x, w["ln_attn"], cfg.norm_eps)
        q = (h @ w["attn_wq"]).reshape(B, 1, H, hd)
        k = (h @ w["attn_wk"]).reshape(B, 1, KV, hd)
        v = (h @ w["attn_wv"]).reshape(B, 1, KV, hd)
        if cfg.pos_type == "rope":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        kc, vc = cache.k[i], cache.v[i]
        kc.index_copy_(1, slot, k)
        vc.index_copy_(1, slot, v)
        if cfg.gqa_native and KV != H:
            o = decode_attention_gqa(q, kc, vc, new_len, masked=masks[window])
        else:
            o = decode_attention(q, repeat_kv(kc, H // KV), repeat_kv(vc, H // KV), new_len,
                                 masked=masks[window])
        x = x + o.reshape(B, 1, H * hd) @ w["attn_wo"]
        h2 = rms_norm(x, w["ln_mlp"], cfg.norm_eps)
        x = x + swiglu(h2, w["mlp_wgate"], w["mlp_win"], w["mlp_wout"])
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x @ _head(cfg, params)).float()[..., : cfg.vocab]
    return logits, KVCache(k=cache.k, v=cache.v, length=new_len)


def param_group_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """{group: (per-layer shape, stack)} for the GradESTC policy."""
    _check_dense(cfg)
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
        "layers/mlp_wgate": ((D, F), L),
        "layers/mlp_win": ((D, F), L),
        "layers/mlp_wout": ((F, D), L),
    }
    if not cfg.tie_embeddings:
        groups["head"] = ((D, padded_vocab(cfg)), 1)
    return groups
