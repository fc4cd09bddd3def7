"""Public entry points of the port's kernels, dispatching on device.

Port of ``repro/kernels/ops.py``: ``encode``/``decode`` and the coefficient
wire (``coeff_quant``, ``coeff_roundtrip``, ``encode_quant``,
``decode_wire``).  A tensor on the CPU goes to the plain version in
``ref``; a CUDA tensor goes to the hand-written kernel, or the call raises.
There is no fall-back on the card: a shape or dtype the kernel does not
take is an error, not a silent plain path.

On the card the operands are stacks ``(L, l, k)``/``(L, l, m)``/``(L, k,
m)``, one kernel call per stack (the CPU path also takes single
matrices).  The kernels
tile l in shared memory and mask the ragged m edge, so the reference's VMEM
fit rule (``choose_block_m``), its fall-back to the oracle for large l and
its column padding have no counterpart here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _build, gradestc_decode, gradestc_encode, ref, wire

__all__ = ["encode", "decode", "coeff_quant", "coeff_roundtrip", "encode_quant",
           "decode_wire", "WIRE_DTYPES", "KERNELS", "launch_counts",
           "reset_launch_counts"]

#: coefficient wire formats: exact f32, bf16 half-words, scaled int8 codes
WIRE_DTYPES = ("f32", "bf16", "int8")
#: the CUDA kernels, by the names their launches are counted under
KERNELS = ("encode", "decode", "coeff_quant", "encode_quant", "decode_wire")


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset (a plain-version call on
    the CPU launches nothing)."""
    return {name: _build.launches[name] for name in KERNELS}


def reset_launch_counts() -> None:
    _build.launches.clear()


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


def coeff_quant(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int8 wire of ``A (..., k, m)``: (codes, scales, ship)."""
    if _route(A) == "cpu":
        return ref.coeff_quant_ref(A)
    return wire.coeff_quant(A)


def coeff_roundtrip(A: torch.Tensor, wire_dtype: str = "f32") -> torch.Tensor:
    """Ship a coefficient matrix through its wire format and back: "f32" is
    the identity, "bf16" rounds to bf16 half-words and packs them into
    uint32 words (plain torch ops on either device, as the reference uses
    its oracle there), "int8" runs the scaled deterministic quantizer.
    Client and server both use the returned value."""
    if wire_dtype == "f32":
        return A
    if wire_dtype == "bf16":
        return ref.bf16_unpack_ref(ref.bf16_pack_ref(A), A.shape[-1]).to(A.dtype)
    if wire_dtype != "int8":
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}; expected one of {WIRE_DTYPES}")
    return coeff_quant(A)[2].to(A.dtype)


def encode_quant(M: torch.Tensor, G: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A = M^T G on the int8 wire, residual against the shipped values:
    (codes, scales, E = G - M ship)."""
    if _route(M, G) == "cpu":
        return ref.encode_quant_ref(M, G)
    return gradestc_encode.encode_quant(M, G)


def decode_wire(M: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Ghat = M (codes * (scale * INV127)): the int8 wire's reconstruction."""
    if _route(M, codes, scales) == "cpu":
        return ref.decode_ref(M, ref.coeff_dequant_ref(codes, scales))
    return gradestc_decode.decode_wire(M, codes, scales)
