"""Architecture configuration dataclass.

A copy of ``repro/models/config.py::ArchConfig`` (importing the reference's
would pull in jax through ``repro/models/__init__.py``).  The fields are the
reference's, so a config built for one package reads the same in the
other.  :class:`InputShape` and :data:`SHAPES` are the reference's four
input shapes, which the dry run and the production step read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

__all__ = ["ArchConfig", "InputShape", "SHAPES"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_tok: int = 0
    capacity_factor: float = 1.25

    # --- attention pattern --------------------------------------------------
    sliding_window: int = 0          # 0 = full attention
    layer_pattern: Tuple[str, ...] = ()

    # --- positions ----------------------------------------------------------
    pos_type: str = "rope"           # rope | mrope | none | learned
    rope_theta: float = 10000.0

    # --- encoder-decoder / vlm / ssm / hybrid -------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 1500
    vision_tokens: int = 0
    rwkv_head_dim: int = 64
    time_decay_extra_dim: int = 64
    d_rnn: int = 0
    conv_width: int = 4

    norm_eps: float = 1e-6
    scale_embed: bool = False        # gemma-style sqrt(d) embedding scaling
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True               # activation-checkpoint each layer
    attn_chunk: int = 1024           # query chunk for memory-bounded attention
    scan_chunk: int = 256
    scan_unroll: int = 1
    attn_unroll: bool = False
    ce_chunk: int = 512              # sequence chunk of the vocab cross-entropy
    moe_stop_gradient_dispatch: bool = False
    pad_vocab_multiple: int = 0      # pad embed/head vocab to this multiple
    moe_group: int = 4096
    gqa_native: bool = False
    grad_accum_override: int = 0
    source: str = ""                 # citation for the exact config

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern(self) -> Tuple[str, ...]:
        return self.layer_pattern or ("global",)

    def layer_kinds(self, n: int | None = None) -> Tuple[str, ...]:
        """Expand the repeating pattern over n layers."""
        n = n or self.n_layers
        pat = self.pattern
        return tuple(pat[i % len(pat)] for i in range(n))

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/topology, tiny dimensions (a
        copy of the reference's ``ArchConfig.reduced``)."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        hd = d // heads
        pat = self.pattern
        n_layers = max(2, len(pat)) if len(pat) > 1 else 2
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=hd if self.head_dim else 0,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 1024),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_tok=min(self.experts_per_tok, 2) if self.experts_per_tok else 0,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            encoder_seq=min(self.encoder_seq, 64) if self.encoder_layers else self.encoder_seq,
            vision_tokens=min(self.vision_tokens, 16) if self.vision_tokens else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            d_rnn=min(self.d_rnn, 256) if self.d_rnn else 0,
            time_decay_extra_dim=16,
            attn_chunk=64,
            scan_chunk=16,
            dtype="float32",
            remat=False,
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
