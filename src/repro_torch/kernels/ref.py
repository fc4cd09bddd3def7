"""Plain PyTorch versions of the port's kernels.

Port of ``repro/kernels/ref.py`` (the parts the ported paths run).  These
are the semantics the CUDA kernels must match; on a CPU tensor
``kernels.ops`` runs them, and ``chip_smoke.py`` compares the kernels with
them on the card.  Accumulation is f32 whatever the input dtype, as in the
reference.  Every function takes leading stack axes.

Wire words are uint32 values held in int64 tensors (as the PRNG holds its
keys), packed in the reference's canonical layout: code ``i`` goes to word
``i // cpw`` at shift ``(i % cpw) * bits``, ``cpw = 32 // bits``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["WIRE_BLOCK", "INV127", "encode_ref", "decode_ref", "pack_codes_ref",
           "unpack_codes_ref", "coeff_quant_ref", "coeff_dequant_ref",
           "bf16_pack_ref", "bf16_unpack_ref", "encode_quant_ref"]

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


def pack_codes_ref(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned codes in ``[0, 2**bits)`` ``(..., n)`` -> uint32 words
    ``(..., ceil(n / cpw))`` (int64); the tail word is zero padded."""
    assert 1 <= bits <= 16
    cpw = 32 // bits
    pad = (-codes.shape[-1]) % cpw
    c = torch.nn.functional.pad(codes.to(torch.int64), (0, pad))
    c = c.reshape(*c.shape[:-1], -1, cpw)
    shifts = torch.arange(cpw, dtype=torch.int64, device=c.device) * bits
    return (c << shifts).sum(-1)          # disjoint bit fields: sum == OR


def unpack_codes_ref(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes_ref`: ``(..., nw)`` words -> ``(..., n)``."""
    cpw = 32 // bits
    shifts = torch.arange(cpw, dtype=torch.int64, device=words.device) * bits
    c = (words.to(torch.int64)[..., :, None] >> shifts) & ((1 << bits) - 1)
    return c.reshape(*words.shape[:-1], -1)[..., :n]


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """``(..., k, m)`` -> ``(..., k, ceil(m/512), 512)``, zero padded."""
    x = torch.nn.functional.pad(x, (0, (-x.shape[-1]) % WIRE_BLOCK))
    return x.reshape(*x.shape[:-1], -1, WIRE_BLOCK)


def coeff_quant_ref(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deterministic int8 wire of a ``(..., k, m)`` coefficient matrix: one
    max-|a| scale per (row, 512-column block), clamped at 1e-12; codes
    ``clip(rint(a / scale * 127), -127, 127)`` (round half to even); the
    shipped value ``float(codes) * (scale * INV127)``.

    Returns (codes int8 (..., k, m), scales f32 (..., k, ceil(m/512)),
    ship f32 (..., k, m))."""
    m = A.shape[-1]
    blocks = _blocks(A.float())
    scales = blocks.abs().amax(-1).clamp_min(1e-12)
    codes = torch.round(blocks / scales[..., None] * 127.0).clamp(-127, 127).to(torch.int8)
    # from the integer codes, so a code of -0.0 ships +0.0, as the reference's
    # compiled oracle does
    ship = codes.float() * (scales[..., None] * INV127)
    return (codes.flatten(-2)[..., :m].contiguous(), scales,
            ship.flatten(-2)[..., :m].contiguous())


def coeff_dequant_ref(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 codes ``(..., k, m)`` + scales ``(..., k, nb)`` -> f32 ``(..., k, m)``."""
    m = codes.shape[-1]
    out = _blocks(codes.float()) * (scales[..., None] * INV127)
    return out.flatten(-2)[..., :m].contiguous()


def bf16_pack_ref(x: torch.Tensor) -> torch.Tensor:
    """f32 ``(..., n)`` -> bf16 (round to nearest even), bit patterns
    pair-packed into ``(..., ceil(n/2))`` uint32 words (element 2j in the low
    half-word)."""
    h = x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    return pack_codes_ref(h, 16)


def bf16_unpack_ref(words: torch.Tensor, n: int) -> torch.Tensor:
    h = unpack_codes_ref(words, 16, n)
    h = h - ((h >> 15) << 16)                 # uint16 -> int16 value
    return h.to(torch.int16).view(torch.bfloat16).float()


def encode_quant_ref(M: torch.Tensor, G: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVDFed's int8 uplink: ``A = M^T G`` through :func:`coeff_quant_ref`,
    and the residual against the shipped coefficients, ``E = G - M ship``.

    Returns (codes int8 (..., k, m), scales (..., k, ceil(m/512)), E (..., l, m))."""
    M32, G32 = M.float(), G.float()
    codes, scales, ship = coeff_quant_ref(M32.mT @ G32)
    return codes, scales, (G32 - M32 @ ship).to(G.dtype)
