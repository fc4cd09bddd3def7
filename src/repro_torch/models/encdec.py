"""Whisper-style encoder-decoder backbone [arXiv:2212.04356].

Port of ``repro/models/encdec.py``.  The mel spectrogram and conv feature
extractor are a stub, as in the reference: the caller passes precomputed
frame embeddings (B, frames, D), zeros when absent
(``model.extra_inputs``), and this module is the transformer that reads
them:

* encoder: bidirectional self-attention and a GELU MLP, learned positions;
* decoder: causal self-attention, cross-attention to the encoder output
  and a GELU MLP, learned positions, the head tied to the embedding.

Parameters are a flat ``{path: tensor}`` dict keyed by the reference's
paths (``"enc/self/wq"``, ``"dec/cross/wk"``, ``"dec_pos"``, ...) in its
stacked layouts, drawn from the reference's key tree.

Attention: a forward on the card with grad disabled (the eval) runs every
attention through the flash kernel (``kernels.ops.flash_attention``): the
encoder's non-causal self-attention over the frames, the decoder's causal
self-attention, and the cross-attention (non-causal, S queries against the
encoder's keys).  Every other forward runs the plain attention, as the
reference does.

Decode: the encoder output and its per-layer cross K/V are computed once
at prefill (``init_cache(..., enc_out=, params=)``); each step appends one
token to the decoder's self-attention cache and reads the fixed cross K/V.
Decode never runs flash.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core import prng
from .config import ArchConfig
from .layers import decode_attention, decode_mask, gelu_mlp, layer_norm, scaled_normal
from .transformer import attend, padded_vocab

Params = Dict[str, torch.Tensor]

__all__ = ["init_params", "forward", "forward_hidden", "encode_audio", "init_cache",
           "decode_step", "EncDecCache", "param_group_shapes"]

_STACK_KEYS = ("ln1_w", "ln1_b", "ln_mlp_w", "ln_mlp_b", "mlp_win", "mlp_bin", "mlp_wout",
               "mlp_bout")
_CROSS_KEYS = ("ln2_w", "ln2_b")
_ATTN = ("wq", "wk", "wv", "wo")


class EncDecCache(NamedTuple):
    self_k: torch.Tensor     # (L, B, S, H, hd)
    self_v: torch.Tensor     # (L, B, S, H, hd)
    cross_k: torch.Tensor    # (L, B, F, H, hd): fixed after prefill
    cross_v: torch.Tensor    # (L, B, F, H, hd)
    length: torch.Tensor     # () int32 on the cache's device


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _init_attn_block(key: torch.Tensor, pre: str, L: int, D: int, H: int, hd: int,
                     dt) -> Params:
    ks = prng.split(key, 4).unbind(0)
    s = 1.0 / math.sqrt(D)
    return {
        f"{pre}/wq": scaled_normal(ks[0], (L, D, H * hd), dt, mul=s),
        f"{pre}/wk": scaled_normal(ks[1], (L, D, H * hd), dt, mul=s),
        f"{pre}/wv": scaled_normal(ks[2], (L, D, H * hd), dt, mul=s),
        f"{pre}/wo": scaled_normal(ks[3], (L, H * hd, D), dt, mul=1.0 / math.sqrt(H * hd)),
    }


def _init_stack(cfg: ArchConfig, key: torch.Tensor, pre: str, L: int, cross: bool) -> Params:
    D, Fd, H, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.hd
    dt = _dtype(cfg)
    ks = prng.split(key, 4).unbind(0)
    z = dict(dtype=dt, device=key.device)
    p = {
        f"{pre}/ln1_w": torch.ones((L, D), **z), f"{pre}/ln1_b": torch.zeros((L, D), **z),
        f"{pre}/ln_mlp_w": torch.ones((L, D), **z), f"{pre}/ln_mlp_b": torch.zeros((L, D), **z),
        **_init_attn_block(ks[0], f"{pre}/self", L, D, H, hd, dt),
        f"{pre}/mlp_win": scaled_normal(ks[1], (L, D, Fd), dt, div=math.sqrt(D)),
        f"{pre}/mlp_bin": torch.zeros((L, Fd), **z),
        f"{pre}/mlp_wout": scaled_normal(ks[2], (L, Fd, D), dt, div=math.sqrt(Fd)),
        f"{pre}/mlp_bout": torch.zeros((L, D), **z),
    }
    if cross:
        p[f"{pre}/ln2_w"] = torch.ones((L, D), **z)
        p[f"{pre}/ln2_b"] = torch.zeros((L, D), **z)
        p.update(_init_attn_block(ks[3], f"{pre}/cross", L, D, H, hd, dt))
    return p


def init_params(cfg: ArchConfig, key: torch.Tensor) -> Params:
    """Parameters on ``key.device`` from the reference's key tree."""
    D, V = cfg.d_model, padded_vocab(cfg)
    dt = _dtype(cfg)
    ks = prng.split(key, 6).unbind(0)
    z = dict(dtype=dt, device=key.device)
    p = {
        "enc_pos": scaled_normal(ks[0], (cfg.encoder_seq, D), dt, mul=0.02),
        "dec_pos": scaled_normal(ks[1], (32768, D), dt, mul=0.02),
        "embed": scaled_normal(ks[2], (V, D), dt, mul=0.02),
    }
    p.update(_init_stack(cfg, ks[3], "enc", cfg.encoder_layers, cross=False))
    p.update(_init_stack(cfg, ks[4], "dec", cfg.n_layers, cross=True))
    p.update({"ln_enc_w": torch.ones((D,), **z), "ln_enc_b": torch.zeros((D,), **z),
              "ln_dec_w": torch.ones((D,), **z), "ln_dec_b": torch.zeros((D,), **z)})
    return p


def _layer(params: Params, pre: str, i: int, cross: bool) -> Params:
    w = {k: params[f"{pre}/{k}"][i] for k in _STACK_KEYS + (_CROSS_KEYS if cross else ())}
    for blk in ("self", "cross") if cross else ("self",):
        w[blk] = {k: params[f"{pre}/{blk}/{k}"][i] for k in _ATTN}
    return w


def _self_attn(cfg: ArchConfig, w: Params, h: torch.Tensor, causal: bool) -> torch.Tensor:
    B, S, _ = h.shape
    H, hd = cfg.n_heads, cfg.hd
    q, k, v = ((h @ w[n]).reshape(B, S, H, hd) for n in ("wq", "wk", "wv"))
    o = attend(q, k, v, causal=causal, q_chunk=cfg.attn_chunk)
    return o.reshape(B, S, H * hd) @ w["wo"]


def _cross_attn(cfg: ArchConfig, w: Params, h: torch.Tensor,
                enc_out: torch.Tensor) -> torch.Tensor:
    B, S, _ = h.shape
    H, hd = cfg.n_heads, cfg.hd
    Fr = enc_out.shape[1]
    q = (h @ w["wq"]).reshape(B, S, H, hd)
    k = (enc_out @ w["wk"]).reshape(B, Fr, H, hd)
    v = (enc_out @ w["wv"]).reshape(B, Fr, H, hd)
    o = attend(q, k, v, causal=False)
    return o.reshape(B, S, H * hd) @ w["wo"]


def _mlp(w: Params, h: torch.Tensor) -> torch.Tensor:
    return gelu_mlp(h, w["mlp_win"], w["mlp_bin"], w["mlp_wout"], w["mlp_bout"])


def encode_audio(cfg: ArchConfig, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, D), the stubbed conv front end's output -> the
    encoder's states (B, F, D)."""
    x = frames.to(_dtype(cfg)) + params["enc_pos"][None, :frames.shape[1]]
    eps = cfg.norm_eps
    for i in range(cfg.encoder_layers):
        w = _layer(params, "enc", i, cross=False)
        h = layer_norm(x, w["ln1_w"], w["ln1_b"], eps)
        x = x + _self_attn(cfg, w["self"], h, causal=False)
        h = layer_norm(x, w["ln_mlp_w"], w["ln_mlp_b"], eps)
        x = x + _mlp(w, h)
    return layer_norm(x, params["ln_enc_w"], params["ln_enc_b"], eps)


def forward_hidden(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                   audio_frames: Optional[torch.Tensor] = None,
                   **_) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward up to the final norm: (hidden (B, S, D), head (D, V)), the
    head tied to the embedding.  ``audio_frames`` default to zeros (B,
    encoder_seq, D)."""
    dt = _dtype(cfg)
    B, S = tokens.shape
    if audio_frames is None:
        audio_frames = torch.zeros((B, cfg.encoder_seq, cfg.d_model), dtype=dt,
                                   device=tokens.device)
    enc_out = encode_audio(cfg, params, audio_frames)
    eps = cfg.norm_eps
    x = params["embed"][tokens.long()].to(dt) + params["dec_pos"][None, :S]
    for i in range(cfg.n_layers):
        w = _layer(params, "dec", i, cross=True)
        h = layer_norm(x, w["ln1_w"], w["ln1_b"], eps)
        x = x + _self_attn(cfg, w["self"], h, causal=True)
        h = layer_norm(x, w["ln2_w"], w["ln2_b"], eps)
        x = x + _cross_attn(cfg, w["cross"], h, enc_out)
        h = layer_norm(x, w["ln_mlp_w"], w["ln_mlp_b"], eps)
        x = x + _mlp(w, h)
    return layer_norm(x, params["ln_dec_w"], params["ln_dec_b"], eps), params["embed"].T


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            audio_frames: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
    """Logits (B, S, vocab) in f32, the padded vocabulary cropped."""
    x, head = forward_hidden(cfg, params, tokens, audio_frames=audio_frames)
    return (x @ head).float()[..., :cfg.vocab]


def init_cache(cfg: ArchConfig, batch: int, max_len: int, length: int = 0,
               enc_out: Optional[torch.Tensor] = None, params: Optional[Params] = None,
               device="cuda") -> EncDecCache:
    """Zero self-attention caches on ``device``; with ``enc_out`` (B, F, D)
    and ``params``, the cross K/V of every decoder layer projected from it
    at once (zeros without them)."""
    dt = _dtype(cfg)
    L, H, hd, Fr = cfg.n_layers, cfg.n_heads, cfg.hd, cfg.encoder_seq
    z = dict(dtype=dt, device=device)
    if enc_out is not None and params is not None:
        ck, cv = (torch.einsum("bfd,ldh->lbfh", enc_out, params[f"dec/cross/{n}"])
                  .reshape(L, batch, Fr, H, hd).to(dt) for n in ("wk", "wv"))
    else:
        ck = torch.zeros((L, batch, Fr, H, hd), **z)
        cv = torch.zeros((L, batch, Fr, H, hd), **z)
    return EncDecCache(
        self_k=torch.zeros((L, batch, max_len, H, hd), **z),
        self_v=torch.zeros((L, batch, max_len, H, hd), **z),
        cross_k=ck, cross_v=cv,
        length=torch.full((), length, dtype=torch.int32, device=device))


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: EncDecCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, EncDecCache]:
    """One token (B, 1) at position ``cache.length``; returns (logits (B, 1,
    vocab) f32, cache).  The passed cache is consumed: the self-attention
    K/V are written in place at ``length`` (clamped to the last slot when
    the cache is full, as the reference's ``dynamic_update_slice``), an
    index kept on the device."""
    eps = cfg.norm_eps
    B = tokens.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    length = cache.length
    idx = length.reshape(1).long()
    pos = params["dec_pos"].index_select(0, idx)                 # (1, D): no host read
    x = params["embed"][tokens.long()].to(_dtype(cfg)) + pos[None]
    slot = length.clamp_max(cache.self_k.shape[2] - 1).reshape(1).long()
    new_len = length + 1
    masked = decode_mask(cache.self_k.shape[2], new_len)
    Fr = cache.cross_k.shape[2]
    cross_len = torch.full((), Fr, dtype=torch.int32, device=length.device)
    cross_masked = decode_mask(Fr, cross_len)
    for i in range(cfg.n_layers):
        w = _layer(params, "dec", i, cross=True)
        h = layer_norm(x, w["ln1_w"], w["ln1_b"], eps)
        q, k, v = ((h @ w["self"][n]).reshape(B, 1, H, hd) for n in ("wq", "wk", "wv"))
        sk, sv = cache.self_k[i], cache.self_v[i]
        sk.index_copy_(1, slot, k)
        sv.index_copy_(1, slot, v)
        o = decode_attention(q, sk, sv, new_len, masked=masked)
        x = x + o.reshape(B, 1, H * hd) @ w["self"]["wo"]
        h = layer_norm(x, w["ln2_w"], w["ln2_b"], eps)
        q = (h @ w["cross"]["wq"]).reshape(B, 1, H, hd)
        o = decode_attention(q, cache.cross_k[i], cache.cross_v[i], cross_len,
                             masked=cross_masked)
        x = x + o.reshape(B, 1, H * hd) @ w["cross"]["wo"]
        h = layer_norm(x, w["ln_mlp_w"], w["ln_mlp_b"], eps)
        x = x + _mlp(w, h)
    x = layer_norm(x, params["ln_dec_w"], params["ln_dec_b"], eps)
    logits = (x @ params["embed"].T).float()[..., :cfg.vocab]
    return logits, EncDecCache(self_k=cache.self_k, self_v=cache.self_v,
                               cross_k=cache.cross_k, cross_v=cache.cross_v, length=new_len)


def param_group_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """{group: (per-layer shape, stack)} for the GradESTC policy, the
    reference's: the attention and MLP matrices of both stacks, the
    cross-attention's and the embedding; the positions, the MLP biases and
    the norms are in no group and keep their initial values in FL."""
    D, Fd, H, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.hd
    g = {}
    for pre, L in (("enc", cfg.encoder_layers), ("dec", cfg.n_layers)):
        g.update({
            f"{pre}/self/wq": ((D, H * hd), L), f"{pre}/self/wk": ((D, H * hd), L),
            f"{pre}/self/wv": ((D, H * hd), L), f"{pre}/self/wo": ((H * hd, D), L),
            f"{pre}/mlp_win": ((D, Fd), L), f"{pre}/mlp_wout": ((Fd, D), L),
        })
    Ld = cfg.n_layers
    g.update({
        "dec/cross/wq": ((D, H * hd), Ld), "dec/cross/wk": ((D, H * hd), Ld),
        "dec/cross/wv": ((D, H * hd), Ld), "dec/cross/wo": ((H * hd, D), Ld),
        "embed": ((padded_vocab(cfg), D), 1),
    })
    return g
