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
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..core import prng
from ..kernels import ops
from .config import ArchConfig
from .layers import apply_rope, attention, repeat_kv, rms_norm, swiglu

Params = Dict[str, torch.Tensor]

__all__ = ["init_params", "forward_hidden", "forward", "param_group_shapes",
           "padded_vocab"]

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
    dt = _dtype(cfg)
    x = params["embed"][tokens.long()].to(dt)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    for i, kind in enumerate(cfg.layer_kinds()):
        w = {name: params[f"layers/{name}"][i] for name in _LAYER_KEYS}
        window = cfg.sliding_window if kind == "local" else 0
        x = _layer_fwd(cfg, x, w, positions, window)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x, head


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Full logits (B, S, V) in f32."""
    x, head = forward_hidden(cfg, params, tokens)
    return (x @ head).float()[..., : cfg.vocab]


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
