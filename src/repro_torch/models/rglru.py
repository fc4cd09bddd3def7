"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
attention [arXiv:2402.19427].

Port of ``repro/models/rglru.py``.  The layer pattern ("rec", "rec",
"local") repeats: two recurrent residual blocks, then one local
(sliding-window, MQA with one KV head) attention block.  Every residual
block is a temporal mix and a GeGLU MLP, each after an RMS norm.  The
RG-LRU recurrence, per channel (c = 8):

    r_t = sigmoid(W_rg xb_t),  i_t = sigmoid(W_ig xb_t)
    log a_t = c * r_t * logsigmoid(Lambda)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * xb_t)

The reference evaluates it with ``jax.lax.associative_scan``; the port runs
the same odd/even recursion (:func:`lru_scan`): log2(T) levels of
elementwise tensor ops, vmappable and with no host read.  The closed form
``exp(cumsum(log a))`` would overflow f32 past about 230 steps.

Parameters are a flat ``{path: tensor}`` dict keyed by the reference's
paths: the recurrent layers' stack under ``"rec/..."``, the attention
layers' under ``"attn/..."``.  The reference scans whole blocks of the
pattern and runs the leftover layers after them; walking
``cfg.layer_kinds()`` over the two stacks is the same order.

Attention: a forward on the card with grad disabled (the eval) runs the
flash kernel (``kernels.ops.flash_attention``, causal with the window, 16
query heads over the one KV head); every other forward runs the plain
attention over repeated K/V, as the reference does.  Decode keeps the
local layers' K/V in ring buffers of ``min(max_len, window)`` slots and
never runs flash.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import prng
from .config import ArchConfig
from .layers import (apply_rope, decode_attention, decode_mask, gelu_tanh,
                     repeat_kv, rms_norm, scaled_normal, sigmoid)
from .transformer import _embed, _head, attend

Params = Dict[str, torch.Tensor]

__all__ = ["init_params", "forward", "forward_hidden", "init_cache", "decode_step",
           "HybridCache", "param_group_shapes", "lru_scan"]

_LRU_C = 8.0
_MLP_KEYS = ("ln_mlp", "mlp_wgate", "mlp_win", "mlp_wout")
_REC_KEYS = ("ln", "w_y", "w_x", "conv_k", "w_rg", "w_ig", "lru_lambda", "w_o") + _MLP_KEYS
_ATTN_KEYS = ("ln", "wq", "wk", "wv", "wo") + _MLP_KEYS


class HybridCache(NamedTuple):
    k: torch.Tensor         # (La, B, S, KV, hd) ring buffers of the local layers
    v: torch.Tensor         # (La, B, S, KV, hd)
    h: torch.Tensor         # (Lr, B, R) LRU state, f32
    conv: torch.Tensor      # (Lr, B, cw-1, R) conv tail, model dtype
    length: torch.Tensor    # () int32 on the cache's device


def _dims(cfg: ArchConfig) -> Tuple[int, int]:
    return cfg.d_model, cfg.d_rnn or cfg.d_model


def _counts(cfg: ArchConfig) -> Tuple[int, int]:
    kinds = cfg.layer_kinds()
    n_rec = sum(k == "rec" for k in kinds)
    return n_rec, len(kinds) - n_rec


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _init_mlp(cfg: ArchConfig, key: torch.Tensor, L: int, pre: str) -> Params:
    D, Fd = cfg.d_model, cfg.d_ff
    dt = _dtype(cfg)
    k1, k2, k3 = prng.split(key, 3).unbind(0)
    s = 1.0 / math.sqrt(D)
    return {
        f"{pre}/ln_mlp": torch.zeros((L, D), dtype=dt, device=key.device),
        f"{pre}/mlp_wgate": scaled_normal(k1, (L, D, Fd), dt, mul=s),
        f"{pre}/mlp_win": scaled_normal(k2, (L, D, Fd), dt, mul=s),
        f"{pre}/mlp_wout": scaled_normal(k3, (L, Fd, D), dt, mul=1.0 / math.sqrt(Fd)),
    }


def _init_rec(cfg: ArchConfig, key: torch.Tensor, L: int) -> Params:
    D, R = _dims(cfg)
    dt = _dtype(cfg)
    ks = prng.split(key, 8).unbind(0)
    s, sr = 1.0 / math.sqrt(D), 1.0 / math.sqrt(R)
    p = {
        "rec/ln": torch.zeros((L, D), dtype=dt, device=key.device),
        "rec/w_y": scaled_normal(ks[0], (L, D, R), dt, mul=s),
        "rec/w_x": scaled_normal(ks[1], (L, D, R), dt, mul=s),
        "rec/conv_k": scaled_normal(ks[2], (L, cfg.conv_width, R), dt, mul=0.1),
        "rec/w_rg": scaled_normal(ks[3], (L, R, R), dt, mul=sr),
        "rec/w_ig": scaled_normal(ks[4], (L, R, R), dt, mul=sr),
        # f32 whatever the model dtype: a ~ sigmoid(3)
        "rec/lru_lambda": torch.full((L, R), 3.0, dtype=torch.float32, device=key.device),
        "rec/w_o": scaled_normal(ks[5], (L, R, D), dt, mul=sr),
    }
    p.update(_init_mlp(cfg, ks[6], L, "rec"))
    return p


def _init_attn(cfg: ArchConfig, key: torch.Tensor, L: int) -> Params:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = _dtype(cfg)
    ks = prng.split(key, 6).unbind(0)
    s = 1.0 / math.sqrt(D)
    p = {
        "attn/ln": torch.zeros((L, D), dtype=dt, device=key.device),
        "attn/wq": scaled_normal(ks[0], (L, D, H * hd), dt, mul=s),
        "attn/wk": scaled_normal(ks[1], (L, D, KV * hd), dt, mul=s),
        "attn/wv": scaled_normal(ks[2], (L, D, KV * hd), dt, mul=s),
        "attn/wo": scaled_normal(ks[3], (L, H * hd, D), dt, mul=1.0 / math.sqrt(H * hd)),
    }
    p.update(_init_mlp(cfg, ks[4], L, "attn"))
    return p


def init_params(cfg: ArchConfig, key: torch.Tensor) -> Params:
    """Parameters on ``key.device`` from the reference's key tree."""
    n_rec, n_attn = _counts(cfg)
    kE, kR, kA, kH = prng.split(key, 4).unbind(0)
    dt = _dtype(cfg)
    D, V = cfg.d_model, cfg.vocab
    params = {"embed": scaled_normal(kE, (V, D), dt, mul=0.02)}
    params.update(_init_rec(cfg, kR, n_rec))
    params.update(_init_attn(cfg, kA, n_attn))
    params["ln_f"] = torch.zeros((D,), dtype=dt, device=key.device)
    if not cfg.tie_embeddings:
        params["head"] = scaled_normal(kH, (D, V), dt, div=math.sqrt(D))
    return params


def _geglu(w: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    h = rms_norm(x, w["ln_mlp"], eps)
    y = gelu_tanh(h @ w["mlp_wgate"])
    return x + (y.to(x.dtype) * (h @ w["mlp_win"])) @ w["mlp_wout"]


def _causal_conv(xb: torch.Tensor, kern: torch.Tensor, tail: Optional[torch.Tensor]):
    """Depthwise causal conv1d.  xb: (B, T, R); kern: (cw, R); tail: (B,
    cw-1, R), the previous context, or None (zeros).  The taps are added in
    the reference's order.  Returns (out, the new tail)."""
    cw, T = kern.shape[0], xb.shape[1]
    if tail is None:
        tail = xb.new_zeros((xb.shape[0], cw - 1, xb.shape[2]))
    xp = torch.cat([tail, xb], dim=1)                        # (B, T+cw-1, R)
    out = xp[:, 0:T] * kern[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + T] * kern[i]
    return out, (xp[:, -(cw - 1):] if cw > 1 else tail)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """(e0, o0, e1, o1, ...) along dim 1; ``even`` has as many entries as
    ``odd`` or one more."""
    B, n, rest = odd.shape[0], odd.shape[1], odd.shape[2:]
    pairs = torch.stack([even[:, :n], odd], dim=2).reshape(B, 2 * n, *rest)
    return pairs if even.shape[1] == n else torch.cat([pairs, even[:, n:]], dim=1)


def _assoc_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of (a_l, b_l) . (a_r, b_r) = (a_l a_r,
    b_l a_r + b_r), by ``jax.lax.associative_scan``'s odd/even recursion,
    so each prefix is combined in the reference's order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_r = a[:, 1::2]
    oa, ob = _assoc_scan(a[:, 0:-1:2] * a_r, b[:, 0:-1:2] * a_r + b[:, 1::2])
    if n % 2 == 0:
        oa_, ob_ = oa[:, :-1], ob[:, :-1]
    else:
        oa_, ob_ = oa, ob
    a_e = a[:, 2::2]
    ea = torch.cat([a[:, :1], oa_ * a_e], dim=1)
    eb = torch.cat([b[:, :1], ob_ * a_e + b[:, 2::2]], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def lru_scan(log_a: torch.Tensor, bx: torch.Tensor,
             h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over T.  log_a, bx: (B, T, R) f32; h0: (B, R)
    initial state or None (zeros).  Returns h (B, T, R)."""
    a = torch.exp(log_a)
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], dim=1)
    return _assoc_scan(a, bx)[1]


def _rec_temporal(cfg: ArchConfig, w: Params, x: torch.Tensor, h0, conv_tail, eps: float):
    """RG-LRU temporal block.  Returns (x + out, h_T, conv tail)."""
    hN = rms_norm(x, w["ln"], eps)
    y = gelu_tanh(hN @ w["w_y"])
    xb, new_tail = _causal_conv(hN @ w["w_x"], w["conv_k"], conv_tail)
    xb32 = xb.float()
    r = sigmoid(xb32 @ w["w_rg"].float())
    i = sigmoid(xb32 @ w["w_ig"].float())
    log_a = _LRU_C * r * F.logsigmoid(w["lru_lambda"])
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9)) * (i * xb32)
    h = lru_scan(log_a, b, h0)                                # (B, T, R)
    out = (y * h).to(x.dtype) @ w["w_o"]
    return x + out, h[:, -1, :], new_tail


def _attn_temporal(cfg: ArchConfig, w: Params, x: torch.Tensor, positions: torch.Tensor,
                   eps: float) -> torch.Tensor:
    B, T, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    hN = rms_norm(x, w["ln"], eps)
    q = apply_rope((hN @ w["wq"]).reshape(B, T, H, hd), positions, cfg.rope_theta)
    k = apply_rope((hN @ w["wk"]).reshape(B, T, KV, hd), positions, cfg.rope_theta)
    v = (hN @ w["wv"]).reshape(B, T, KV, hd)
    o = attend(q, k, v, causal=True, window=cfg.sliding_window, q_chunk=cfg.attn_chunk)
    return x + o.reshape(B, T, H * hd) @ w["wo"]


def _weights(params: Params, stack: str, keys, i: int) -> Params:
    return {name: params[f"{stack}/{name}"][i] for name in keys}


def forward_hidden(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                   **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward up to the final norm: (hidden (B, T, D), head (D, V))."""
    eps = cfg.norm_eps
    x = _embed(cfg, params, tokens)
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    ri = ai = 0
    for kind in cfg.layer_kinds():
        if kind == "rec":
            w = _weights(params, "rec", _REC_KEYS, ri)
            x = _rec_temporal(cfg, w, x, None, None, eps)[0]
            ri += 1
        else:
            w = _weights(params, "attn", _ATTN_KEYS, ai)
            x = _attn_temporal(cfg, w, x, positions, eps)
            ai += 1
        x = _geglu(w, x, eps)
    return rms_norm(x, params["ln_f"], eps), _head(cfg, params)


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, **kw) -> torch.Tensor:
    """Full logits (B, T, V) in f32."""
    x, head = forward_hidden(cfg, params, tokens, **kw)
    return (x @ head).float()


def init_cache(cfg: ArchConfig, batch: int, max_len: int, length: int = 0,
               device="cuda") -> HybridCache:
    """Zero caches on ``device``: the local layers' K/V capped at the window
    (they only ever see ``sliding_window`` keys), the LRU state in f32 and
    the conv tails in the model dtype."""
    dt = _dtype(cfg)
    n_rec, n_attn = _counts(cfg)
    _, R = _dims(cfg)
    KV, hd = cfg.n_kv_heads, cfg.hd
    s_attn = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    z = dict(dtype=dt, device=device)
    return HybridCache(
        k=torch.zeros((n_attn, batch, s_attn, KV, hd), **z),
        v=torch.zeros((n_attn, batch, s_attn, KV, hd), **z),
        h=torch.zeros((n_rec, batch, R), dtype=torch.float32, device=device),
        conv=torch.zeros((n_rec, batch, cfg.conv_width - 1, R), **z),
        length=torch.full((), length, dtype=torch.int32, device=device))


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: HybridCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, HybridCache]:
    """One token (B, 1); returns (logits (B, 1, V) f32, cache).  The local
    layers write slot ``length % S_buf`` of their ring buffers, an index
    kept on the device (no host read).  The passed cache is consumed: its
    tensors are written in place and returned in the new cache."""
    eps = cfg.norm_eps
    B = tokens.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = _embed(cfg, params, tokens)
    length = cache.length
    pos = length.reshape(1, 1).expand(B, 1)
    S_buf = cache.k.shape[2]
    slot = torch.remainder(length, S_buf).reshape(1).long()
    valid = (length + 1).clamp_max(S_buf)
    masked = decode_mask(S_buf, valid)
    ri = ai = 0
    for kind in cfg.layer_kinds():
        if kind == "rec":
            w = _weights(params, "rec", _REC_KEYS, ri)
            x, h_new, tail = _rec_temporal(cfg, w, x, cache.h[ri], cache.conv[ri], eps)
            cache.h[ri].copy_(h_new)
            cache.conv[ri].copy_(tail)
            ri += 1
        else:
            w = _weights(params, "attn", _ATTN_KEYS, ai)
            hN = rms_norm(x, w["ln"], eps)
            q = apply_rope((hN @ w["wq"]).reshape(B, 1, H, hd), pos, cfg.rope_theta)
            k = apply_rope((hN @ w["wk"]).reshape(B, 1, KV, hd), pos, cfg.rope_theta)
            v = (hN @ w["wv"]).reshape(B, 1, KV, hd)
            kc, vc = cache.k[ai], cache.v[ai]
            kc.index_copy_(1, slot, k)
            vc.index_copy_(1, slot, v)
            o = decode_attention(q, repeat_kv(kc, H // KV), repeat_kv(vc, H // KV), valid,
                                 masked=masked)
            x = x + o.reshape(B, 1, H * hd) @ w["wo"]
            ai += 1
        x = _geglu(w, x, eps)
    x = rms_norm(x, params["ln_f"], eps)
    logits = (x @ _head(cfg, params)).float()
    return logits, HybridCache(k=cache.k, v=cache.v, h=cache.h, conv=cache.conv,
                               length=length + 1)


def param_group_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """{group: (per-layer shape, stack)} for the GradESTC policy, the
    reference's: the matrices of both stacks, embed and head; the conv
    taps, ``lru_lambda`` and the norms are in no group and keep their
    initial values in FL."""
    n_rec, n_attn = _counts(cfg)
    D, R = _dims(cfg)
    Fd, H, KV, hd, V = cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.vocab
    g = {
        "rec/w_y": ((D, R), n_rec), "rec/w_x": ((D, R), n_rec),
        "rec/w_rg": ((R, R), n_rec), "rec/w_ig": ((R, R), n_rec),
        "rec/w_o": ((R, D), n_rec),
        "rec/mlp_wgate": ((D, Fd), n_rec), "rec/mlp_win": ((D, Fd), n_rec),
        "rec/mlp_wout": ((Fd, D), n_rec),
        "attn/wq": ((D, H * hd), n_attn), "attn/wk": ((D, KV * hd), n_attn),
        "attn/wv": ((D, KV * hd), n_attn), "attn/wo": ((H * hd, D), n_attn),
        "attn/mlp_wgate": ((D, Fd), n_attn), "attn/mlp_win": ((D, Fd), n_attn),
        "attn/mlp_wout": ((Fd, D), n_attn),
        "embed": ((V, D), 1),
    }
    if not cfg.tie_embeddings:
        g["head"] = ((D, V), 1)
    return g
