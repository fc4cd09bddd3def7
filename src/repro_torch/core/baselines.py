"""Top-k sparsification and the paper's global-scale stochastic quantizer.

Port of ``repro/core/baselines.py``'s ``TopKState``/``topk_compress``
(magnitude top-k with an error memory) and ``quantize_stochastic``/
``dequantize`` (FedPAQ, FedQClip).

Top-k keeps exactly ``jax.lax.top_k``'s set of indices: among entries tied
at the k-th magnitude, the lower indices.  ``torch.topk`` gives only the
threshold; the set is picked by a mask and a cumulative count, so nothing
syncs the host (no boolean indexing, no ``nonzero``).

The quantizer has one max-|g| scale for the whole vector, codes in
``[0, 2^bits - 1]``.  It is the reference's ``use_pallas=False`` path,
which the port runs on the CPU only (on the card the block-local wire runs
through the kernels).  The roundings follow the compiled reference: jax
0.9's ``bernoulli`` is ``uniform(key, shape) < p``, and XLA's CPU backend
fuses the dequantization's ``codes * (2/levels) - 1`` into one
multiply-add.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import prng

__all__ = ["TopKState", "topk_compress", "quantize_stochastic", "dequantize"]


class TopKState(NamedTuple):
    memory: torch.Tensor       # (..., n) error accumulation

    @staticmethod
    def init(n: int, device="cuda") -> "TopKState":
        return TopKState(memory=torch.zeros((n,), dtype=torch.float32, device=device))


def topk_compress(state: TopKState, g: torch.Tensor, k: int
                  ) -> Tuple[TopKState, torch.Tensor, torch.Tensor]:
    """Keep the k largest-magnitude entries of ``g + memory`` (last axis),
    ties at the k-th magnitude to the lower indices: (state, ghat, scalars
    sent = 2k values and indices)."""
    corrected = g + state.memory
    a = corrected.abs()
    t = torch.topk(a, k, dim=-1, sorted=False).values.amin(-1, keepdim=True)
    above = a > t
    tied = a == t
    keep = above | (tied & (torch.cumsum(tied, -1) <= k - above.sum(-1, keepdim=True)))
    ghat = torch.where(keep, corrected, 0.0)
    scalars = torch.full((), 2 * k, dtype=torch.float32, device=g.device)
    return TopKState(memory=corrected - ghat), ghat, scalars


def quantize_stochastic(g: torch.Tensor, key: torch.Tensor, bits: int = 8
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unbiased stochastic uniform quantizer on ``[-scale, scale]``:
    (codes int64 in ``[0, 2^bits - 1]``, scale ())."""
    levels = (1 << bits) - 1
    scale = g.abs().amax().clamp_min(1e-12)
    x = (g / scale + 1.0) * float(np.float32(levels / 2.0))
    lo = torch.floor(x)
    up = prng.uniform(key, g.shape) < (x - lo)
    codes = (lo + up.to(g.dtype)).clamp(0, levels).to(torch.int64)
    return codes, scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """``(codes * (2/levels) - 1) * scale``, the first two steps one fused
    multiply-add as XLA compiles them."""
    levels = (1 << bits) - 1
    # the integer code times the f32 constant is exact in float64, so one
    # rounding of ``- 1`` to f32 is the fused multiply-add
    fused = (codes.double() * float(np.float32(2.0 / levels)) - 1.0).float()
    return fused * scale
