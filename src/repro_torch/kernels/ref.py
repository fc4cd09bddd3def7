"""Plain PyTorch versions of the port's kernels.

Port of ``repro/kernels/ref.py`` (the parts this slice runs).  These are the
semantics the CUDA kernels must match; on a CPU tensor ``kernels.ops`` runs
them, and ``chip_smoke.py`` compares the kernels with them on the card.
Accumulation is f32 whatever the input dtype, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["WIRE_BLOCK", "INV127", "encode_ref", "decode_ref"]

#: codes per scale row of every packed wire format.
WIRE_BLOCK = 512

#: Single-rounded f32 reciprocal of the int8 range (the coefficient wire's
#: dequantization is defined as codes * (scale * INV127)).
INV127 = float(np.float32(1.0) / np.float32(127.0))


def encode_ref(M: torch.Tensor, G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A = M^T G, E = G - M A.  M: (..., l, k), G: (..., l, m)."""
    M32, G32 = M.float(), G.float()
    A = M32.mT @ G32
    E = G32 - M32 @ A
    return A.to(G.dtype), E.to(G.dtype)


def decode_ref(M: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Ghat = M A.  M: (..., l, k), A: (..., k, m)."""
    return (M.float() @ A.float()).to(M.dtype)
