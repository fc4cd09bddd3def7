"""RWKV-6 "Finch": an attention-free RNN with data-dependent decay
[arXiv:2404.05892].

Port of ``repro/models/rwkv6.py``.  Per layer a *time-mix* block (the
WKV6 linear recurrence) and a *channel-mix* block (a token-shifted
squared-ReLU FFN).  Per head, with state S (hd, hd) in f32:

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

with the per-channel decay ``w_t = exp(-exp(w0 + lora(x_t)))`` kept as its
log, and the "bonus" u for the current token.  DDLerp token-shift mixing
interpolates each projection's input between x_t and x_{t-1} with a
data-dependent coefficient.

Parameters are a flat ``{path: tensor}`` dict keyed by the reference's
pytree paths (``"embed"``, ``"layers/tm_wr"``, ..., ``"ln_f_w"``,
``"head"``) in its stacked layouts, drawn from the reference's key tree
with :mod:`repro_torch.core.prng`.  The scan over time is a Python loop
over T of plain tensor ops (the reference's ``lax.scan``; it has no
kernel for it either), written without in-place writes so that it runs
under ``torch.func.grad`` and ``torch.func.vmap``.  Decode is one step of
the same recurrence.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..core import prng
from .config import ArchConfig
from .layers import _silu, layer_norm, scaled_normal, sigmoid

Params = Dict[str, torch.Tensor]

__all__ = ["init_params", "forward", "forward_hidden", "init_cache", "decode_step",
           "RWKVCache", "param_group_shapes", "time_mix_seq"]

_MIX_NAMES = ("r", "k", "v", "w", "g")
_LAYER_KEYS = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "mix_base", "mix_mus", "mix_w1", "mix_w2",
               "tm_wr", "tm_wk", "tm_wv", "tm_wg", "tm_wo", "decay_w0", "decay_w1",
               "decay_w2", "bonus_u", "tm_ln_w", "tm_ln_b", "cm_mix_k", "cm_mix_r", "cm_wk",
               "cm_wv", "cm_wr")


class RWKVCache(NamedTuple):
    tm_x: torch.Tensor      # (L, B, D) last input to time-mix, model dtype
    cm_x: torch.Tensor      # (L, B, D) last input to channel-mix
    S: torch.Tensor         # (L, B, H, hd, hd) wkv state, f32
    length: torch.Tensor    # () int32 on the cache's device


def _heads(cfg: ArchConfig) -> Tuple[int, int]:
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(cfg: ArchConfig, key: torch.Tensor) -> Params:
    """Parameters on ``key.device`` from the reference's key tree."""
    D, F, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    H, hd = _heads(cfg)
    lora = cfg.time_decay_extra_dim
    dt = _dtype(cfg)
    ks = prng.split(key, 20).unbind(0)
    s = 1.0 / math.sqrt(D)
    n = len(_MIX_NAMES)
    z = dict(dtype=dt, device=key.device)
    return {
        "embed": scaled_normal(ks[12], (V, D), dt, mul=0.02),
        "layers/ln1_w": torch.ones((L, D), **z), "layers/ln1_b": torch.zeros((L, D), **z),
        "layers/ln2_w": torch.ones((L, D), **z), "layers/ln2_b": torch.zeros((L, D), **z),
        "layers/mix_base": torch.zeros((L, D), **z),
        "layers/mix_mus": torch.zeros((L, n, D), **z),
        "layers/mix_w1": scaled_normal(ks[0], (L, D, 32 * n), dt, mul=s),
        "layers/mix_w2": scaled_normal(ks[1], (L, n, 32, D), dt, mul=0.02),
        "layers/tm_wr": scaled_normal(ks[2], (L, D, D), dt, mul=s),
        "layers/tm_wk": scaled_normal(ks[3], (L, D, D), dt, mul=s),
        "layers/tm_wv": scaled_normal(ks[4], (L, D, D), dt, mul=s),
        "layers/tm_wg": scaled_normal(ks[5], (L, D, D), dt, mul=s),
        "layers/tm_wo": scaled_normal(ks[6], (L, D, D), dt, mul=s),
        "layers/decay_w0": torch.full((L, D), -6.0, **z),
        "layers/decay_w1": scaled_normal(ks[7], (L, D, lora), dt, mul=s),
        "layers/decay_w2": scaled_normal(ks[8], (L, lora, D), dt, mul=0.02),
        "layers/bonus_u": torch.zeros((L, H, hd), **z),
        "layers/tm_ln_w": torch.ones((L, D), **z), "layers/tm_ln_b": torch.zeros((L, D), **z),
        "layers/cm_mix_k": torch.zeros((L, D), **z),
        "layers/cm_mix_r": torch.zeros((L, D), **z),
        "layers/cm_wk": scaled_normal(ks[9], (L, D, F), dt, mul=s),
        "layers/cm_wv": scaled_normal(ks[10], (L, F, D), dt, mul=1.0 / math.sqrt(F)),
        "layers/cm_wr": scaled_normal(ks[11], (L, D, D), dt, mul=s),
        "ln_f_w": torch.ones((D,), **z), "ln_f_b": torch.zeros((D,), **z),
        "head": scaled_normal(ks[13], (D, V), dt, mul=s),
    }


def _shifted(x: torch.Tensor, x_last: torch.Tensor) -> torch.Tensor:
    """x_{t-1} for every t: (B, T, D), the first from ``x_last`` (B, D)."""
    return torch.cat([x_last[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(w: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent token shift: the 5 mixed inputs (r, k, v, w, g)."""
    sx = x_prev - x                                           # (B, T, D)
    base = x + sx * w["mix_base"]
    lora = torch.tanh(base @ w["mix_w1"])                     # (B, T, 32*5)
    B, T = x.shape[0], x.shape[1]
    lora = lora.reshape(B, T, len(_MIX_NAMES), 32)
    dyn = torch.einsum("btsi,sid->btsd", lora, w["mix_w2"])   # (B, T, 5, D)
    mixed = x[:, :, None, :] + sx[:, :, None, :] * (w["mix_mus"][None, None] + dyn)
    return mixed.unbind(2)


def _decay_log(w: Params, xw: torch.Tensor) -> torch.Tensor:
    """log(w_t) = -exp(w0 + lora(xw)) in f32; always < 0."""
    lo = torch.tanh(xw @ w["decay_w1"]) @ w["decay_w2"]
    return -torch.exp((w["decay_w0"] + lo).float())


def time_mix_seq(cfg: ArchConfig, w: Params, x: torch.Tensor, x_last: torch.Tensor,
                 S0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """WKV6 over a sequence.  x: (B, T, D); x_last: (B, D); S0: (B, H, hd,
    hd).  Returns (out (B, T, D), x_tail (B, D), S_T in S0's dtype)."""
    B, T, D = x.shape
    H, hd = _heads(cfg)
    xr, xk, xv, xw, xg = _ddlerp(w, x, _shifted(x, x_last))
    r = (xr @ w["tm_wr"]).reshape(B, T, H, hd).float()
    k = (xk @ w["tm_wk"]).reshape(B, T, H, hd).float()
    v = (xv @ w["tm_wv"]).reshape(B, T, H, hd).float()
    g = _silu(xg @ w["tm_wg"])
    decay = torch.exp(_decay_log(w, xw).reshape(B, T, H, hd))   # f32, in (0, 1)
    u = w["bonus_u"].float()[None, :, :, None]                  # (1, H, hd, 1)
    S = S0.float()
    outs = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B, H, hd, hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + u * kv))
        S = decay[:, t, :, :, None] * S + kv
    o = torch.stack(outs, dim=1).reshape(B, T, D)
    # a LayerNorm over all of D (eps 1e-5), as the reference's code computes
    o = layer_norm(o, w["tm_ln_w"], w["tm_ln_b"])
    o = (o * g).to(x.dtype) @ w["tm_wo"]
    return o, x[:, -1, :], S.to(S0.dtype)


def _channel_mix(w: Params, x: torch.Tensor, x_last: torch.Tensor):
    x_prev = _shifted(x, x_last)
    xk = x + (x_prev - x) * w["cm_mix_k"]
    xr = x + (x_prev - x) * w["cm_mix_r"]
    kk = torch.square(torch.relu(xk @ w["cm_wk"]))
    return sigmoid(xr @ w["cm_wr"]) * (kk @ w["cm_wv"]), x[:, -1, :]


def _layer(cfg: ArchConfig, x, w: Params, tm_x0, cm_x0, S0):
    h = layer_norm(x, w["ln1_w"], w["ln1_b"])
    o, tm_tail, S = time_mix_seq(cfg, w, h, tm_x0, S0)
    x = x + o
    h = layer_norm(x, w["ln2_w"], w["ln2_b"])
    o, cm_tail = _channel_mix(w, h, cm_x0)
    return x + o, tm_tail, cm_tail, S


def _layer_weights(params: Params, i: int) -> Params:
    return {name: params[f"layers/{name}"][i] for name in _LAYER_KEYS}


def forward_hidden(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                   **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward up to the final norm: (hidden (B, T, D), head (D, V)).  Each
    layer starts from zero token-shift state and a zero WKV state."""
    dt = _dtype(cfg)
    B = tokens.shape[0]
    H, hd = _heads(cfg)
    x = params["embed"][tokens.long()].to(dt)
    zeros_x = torch.zeros((B, cfg.d_model), dtype=dt, device=x.device)
    S0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x = _layer(cfg, x, _layer_weights(params, i), zeros_x, zeros_x, S0)[0]
    return layer_norm(x, params["ln_f_w"], params["ln_f_b"]), params["head"]


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, **_) -> torch.Tensor:
    """Full logits (B, T, V) in f32."""
    x, head = forward_hidden(cfg, params, tokens)
    return (x @ head).float()


def init_cache(cfg: ArchConfig, batch: int, max_len: int, length: int = 0,
               device="cuda") -> RWKVCache:
    """Zero token-shift inputs (model dtype) and WKV state (f32) on
    ``device``; the state's size does not grow with ``max_len``."""
    H, hd = _heads(cfg)
    L, D = cfg.n_layers, cfg.d_model
    z = dict(dtype=_dtype(cfg), device=device)
    return RWKVCache(
        tm_x=torch.zeros((L, batch, D), **z), cm_x=torch.zeros((L, batch, D), **z),
        S=torch.zeros((L, batch, H, hd, hd), dtype=torch.float32, device=device),
        length=torch.full((), length, dtype=torch.int32, device=device))


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: RWKVCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, RWKVCache]:
    """One token (B, 1): one step of every layer's recurrence; returns
    (logits (B, 1, V) f32, cache).  The passed cache is consumed: its
    tensors are written in place and returned in the new cache."""
    x = params["embed"][tokens.long()].to(_dtype(cfg))      # (B, 1, D)
    for i in range(cfg.n_layers):
        x, tm, cm, S = _layer(cfg, x, _layer_weights(params, i), cache.tm_x[i],
                              cache.cm_x[i], cache.S[i])
        cache.tm_x[i].copy_(tm)
        cache.cm_x[i].copy_(cm)
        cache.S[i].copy_(S)
    x = layer_norm(x, params["ln_f_w"], params["ln_f_b"])
    logits = (x @ params["head"]).float()
    return logits, RWKVCache(tm_x=cache.tm_x, cm_x=cache.cm_x, S=cache.S,
                             length=cache.length + 1)


def param_group_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """{group: (per-layer shape, stack)} for the GradESTC policy, the
    reference's: the time-mix, channel-mix and decay matrices, the DDLerp
    lora's first matrix, embed, head and ``ln1_w``; the other parameters
    are not in any group and keep their initial values in FL."""
    D, F, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    lora = cfg.time_decay_extra_dim
    return {
        "layers/tm_wr": ((D, D), L), "layers/tm_wk": ((D, D), L),
        "layers/tm_wv": ((D, D), L), "layers/tm_wg": ((D, D), L),
        "layers/tm_wo": ((D, D), L),
        "layers/cm_wk": ((D, F), L), "layers/cm_wv": ((F, D), L),
        "layers/cm_wr": ((D, D), L),
        "layers/decay_w1": ((D, lora), L), "layers/decay_w2": ((lora, D), L),
        "layers/mix_w1": ((D, 32 * 5), L),
        "embed": ((V, D), 1), "head": ((D, V), 1),
        "layers/ln1_w": ((D,), L),
    }
