"""Family dispatcher: one API over the architectures of the reference.

Port of ``repro/models/model.py``.  ``batch`` is a dict ``{"tokens",
"labels"}`` of ``(B, S)`` integer tensors, plus for the VLM family an
optional ``"vision_embeds"`` (B, P, D) prefix (the qwen2-vl stub) and its
``"positions"`` (3, B, P + S), and for the encdec family optional
``"audio_frames"`` (B, encoder_seq, D) (the whisper stub; zeros when
absent).  The dense, MoE and VLM families run through :mod:`.transformer`,
the ssm family through :mod:`.rwkv6`, the hybrid through :mod:`.rglru` and
the encdec through :mod:`.encdec`.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import encdec, rglru, rwkv6, transformer
from .config import ArchConfig

__all__ = ["init_params", "forward", "forward_hidden", "loss_fn", "init_cache", "decode_step",
           "param_group_shapes", "extra_inputs", "family_module", "count_params"]

_FAMILY_MODULES = {"ssm": rwkv6, "hybrid": rglru, "encdec": encdec}


def family_module(cfg: ArchConfig):
    """The module that implements ``cfg.family``."""
    if cfg.family in transformer.FAMILIES:
        return transformer
    if cfg.family in _FAMILY_MODULES:
        return _FAMILY_MODULES[cfg.family]
    raise ValueError(f"unknown family {cfg.family!r}")


def init_params(cfg: ArchConfig, key: torch.Tensor):
    return family_module(cfg).init_params(cfg, key)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, length: int = 0, **kw):
    return family_module(cfg).init_cache(cfg, batch, max_len, length, **kw)


def decode_step(cfg: ArchConfig, params, cache, tokens: torch.Tensor):
    return family_module(cfg).decode_step(cfg, params, cache, tokens)


def param_group_shapes(cfg: ArchConfig):
    return family_module(cfg).param_group_shapes(cfg)


def extra_inputs(cfg: ArchConfig, batch: int, seq: int, dtype=None,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """Modality-frontend stubs on ``device`` (the card unless the caller
    asks for the CPU): the zero (B, encoder_seq, D) audio frames of an
    encdec model, the zero (B, vision_tokens, D) vision embeddings of a VLM,
    nothing for the other families."""
    family_module(cfg)
    dt = dtype or getattr(torch, cfg.dtype)
    if cfg.family == "encdec":
        return {"audio_frames": torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                            dtype=dt, device=device)}
    if cfg.family == "vlm" and cfg.vision_tokens:
        return {"vision_embeds": torch.zeros((batch, cfg.vision_tokens, cfg.d_model),
                                             dtype=dt, device=device)}
    return {}


def count_params(params) -> int:
    return sum(x.numel() for x in params.values())


def _modality_kw(cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The VLM's prefix and its positions, or the encdec model's audio
    frames, when the batch has them."""
    if cfg.family == "vlm" and "vision_embeds" in batch:
        return {k: batch[k] for k in ("vision_embeds", "positions") if k in batch}
    if cfg.family == "encdec" and "audio_frames" in batch:
        return {"audio_frames": batch["audio_frames"]}
    return {}


def forward(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return family_module(cfg).forward(cfg, params, batch["tokens"], **_modality_kw(cfg, batch))


def forward_hidden(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor]):
    """(hidden (B, S_total, D), head (D, V)) without materializing logits."""
    return family_module(cfg).forward_hidden(cfg, params, batch["tokens"],
                                             **_modality_kw(cfg, batch))


def loss_fn(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross-entropy, mean over tokens, f32.  The vocabulary
    projection runs in sequence chunks of ``cfg.ce_chunk``, as the
    reference does, so the live logits are (B, ce_chunk, V).  A vision
    prefix carries no labels: the hidden states align to the trailing
    label length."""
    hidden, head = forward_hidden(cfg, params, batch)
    labels = batch["labels"].long()
    if hidden.shape[1] != labels.shape[1]:
        hidden = hidden[:, -labels.shape[1]:]
    B, S, D = hidden.shape
    cs = min(cfg.ce_chunk, S)
    while S % cs:
        cs -= 1
    V = head.shape[-1]
    pad_bias = None
    if V != cfg.vocab:     # padded-vocab columns must not leak probability
        pad_bias = torch.where(torch.arange(V, device=head.device) < cfg.vocab,
                               0.0, -1e30).float()

    # the one-hot mask as a comparison: F.one_hot reads the labels' range
    # back to the host on the CPU, which torch.func.vmap cannot batch
    vocab_ids = torch.arange(V, device=head.device)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, cs):
        logits = (hidden[:, c0:c0 + cs] @ head).float()       # (B, cs, V)
        if pad_bias is not None:
            logits = logits + pad_bias
        logz = torch.logsumexp(logits, dim=-1)
        one_hot = labels[:, c0:c0 + cs, None] == vocab_ids
        gold = (logits * one_hot.to(logits.dtype)).sum(-1)
        total = total + (logz - gold).sum()
    # a device divisor: true division, as the reference (see layers.rope_table)
    return total / torch.full((), B * S, dtype=torch.float32, device=total.device)
