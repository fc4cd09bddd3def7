"""Public entry points of the port's kernels, dispatching on device.

Port of ``repro/kernels/ops.py::encode/decode``.  A tensor on the CPU goes
to the plain version in ``ref``; a CUDA tensor goes to the hand-written
kernel, or the call raises.  There is no fall-back on the card: a shape or
dtype the kernel does not take is an error, not a silent plain path.

On the card the operands are stacks ``(L, l, k)``/``(L, l, m)``, one kernel
launch per stack (the CPU path also takes single matrices).  The kernels
tile l in shared memory and mask the ragged m edge, so the reference's VMEM
fit rule (``choose_block_m``) and column padding have no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import gradestc_decode, gradestc_encode, ref

__all__ = ["encode", "decode"]


def _route(*xs: torch.Tensor) -> str:
    kinds = {x.device.type for x in xs}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"operands on mixed or unsupported devices: {[x.device for x in xs]}")


def encode(M: torch.Tensor, G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused A = M^T G, E = G - M A."""
    if _route(M, G) == "cpu":
        return ref.encode_ref(M, G)
    return gradestc_encode.encode(M, G)


def decode(M: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Ghat = M A."""
    if _route(M, A) == "cpu":
        return ref.decode_ref(M, A)
    return gradestc_decode.decode(M, A)
