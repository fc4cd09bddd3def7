"""The paper's global-scale stochastic quantizer (FedPAQ, FedQClip).

Port of ``repro/core/baselines.py::quantize_stochastic`` and
``dequantize``: one max-|g| scale for the whole vector, codes in
``[0, 2^bits - 1]``.  It is the reference's ``use_pallas=False`` path,
which the port runs on the CPU only (on the card the block-local wire runs
through the kernels).  The roundings follow the compiled reference: jax
0.9's ``bernoulli`` is ``uniform(key, shape) < p``, and XLA's CPU backend
fuses the dequantization's ``codes * (2/levels) - 1`` into one
multiply-add.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import prng

__all__ = ["quantize_stochastic", "dequantize"]


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
