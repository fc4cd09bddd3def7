"""Model API over the dense stack: forward, chunked cross-entropy loss,
KV-cache decode.

Port of ``repro/models/model.py`` for the dense family.  ``batch`` is a dict
``{"tokens", "labels"}`` of ``(B, S)`` integer tensors.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import transformer
from .config import ArchConfig

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "decode_step",
           "param_group_shapes", "extra_inputs", "count_params"]

init_params = transformer.init_params
param_group_shapes = transformer.param_group_shapes
init_cache = transformer.init_cache
decode_step = transformer.decode_step


def extra_inputs(cfg: ArchConfig, batch: int, seq: int, dtype=None) -> Dict[str, torch.Tensor]:
    """Modality-frontend inputs: none for the dense family (the reference's
    audio frames and vision embeddings belong to enc-dec and VLM models,
    which are not ported)."""
    transformer._check_dense(cfg)
    return {}


def count_params(params) -> int:
    return sum(x.numel() for x in params.values())


def forward(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return transformer.forward(cfg, params, batch["tokens"])


def loss_fn(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross-entropy, mean over tokens, f32.  The vocabulary
    projection runs in sequence chunks of ``cfg.ce_chunk``, as the
    reference does, so the live logits are (B, ce_chunk, V)."""
    hidden, head = transformer.forward_hidden(cfg, params, batch["tokens"])
    labels = batch["labels"].long()
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
