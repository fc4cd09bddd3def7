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

from ..models.layers import attention, repeat_kv

__all__ = ["WIRE_BLOCK", "INV127", "quant_levels", "recip32", "encode_ref", "decode_ref",
           "block_quant_ref", "block_dequant_ref", "pack_codes_ref", "unpack_codes_ref",
           "pairwise_sum", "mean_abs_ref", "sign_pack_ref", "sign_unpack_ref",
           "quant_pack_ref", "unpack_dequant_ref", "coeff_quant_ref",
           "coeff_dequant_ref", "bf16_pack_ref", "bf16_unpack_ref", "encode_quant_ref",
           "flash_attention_ref"]

#: codes per scale row of every packed wire format.
WIRE_BLOCK = 512

#: Single-rounded f32 reciprocal of the int8 range (the coefficient wire's
#: dequantization is defined as codes * (scale * INV127)).
INV127 = float(np.float32(1.0) / np.float32(127.0))


def quant_levels(bits: int) -> float:
    """Magnitude of the symmetric signed code book of ``bits``-bit codes,
    ``2^(bits-1) - 1`` (codes span ``[-levels, levels]``); a copy of
    ``repro/kernels/quant.py::quant_levels``."""
    return float((1 << (bits - 1)) - 1)


def recip32(x: float) -> float:
    """The f32 reciprocal of f32 ``x``, rounded once (a Python float)."""
    return float(np.float32(1.0) / np.float32(x))


def encode_ref(M: torch.Tensor, G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A = M^T G, E = G - M A.  M: (..., l, k), G: (..., l, m)."""
    M32, G32 = M.float(), G.float()
    A = M32.mT @ G32
    E = G32 - M32 @ A
    return A.to(G.dtype), E.to(G.dtype)


def decode_ref(M: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Ghat = M A.  M: (..., l, k), A: (..., k, m)."""
    return (M.float() @ A.float()).to(M.dtype)


def block_quant_ref(g: torch.Tensor, uniforms: torch.Tensor, block: int,
                    bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise stochastic uniform quantization: each ``block`` values of
    ``g (..., n)`` (``n % block == 0``) get their own max-|g| scale, clamped
    at 1e-12; ``x = g / scale * levels``, ``code = floor(x) + (u < x -
    floor(x))``, clipped to ``[-levels, levels]``.

    Returns (codes int8 ``(..., n)``, scales f32 ``(..., n / block)``)."""
    levels = quant_levels(bits)
    gb = g.float().reshape(*g.shape[:-1], -1, block)
    ub = uniforms.float().reshape(gb.shape)
    scale = gb.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    x = gb / scale * levels
    lo = torch.floor(x)
    codes = (lo + (ub < (x - lo)).float()).clamp(-levels, levels)
    return codes.to(torch.int8).reshape(g.shape), scale[..., 0]


def block_dequant_ref(codes: torch.Tensor, scales: torch.Tensor, block: int,
                      bits: int = 8) -> torch.Tensor:
    """``codes * (scale * f32(1/levels))``, the reciprocal rounded once, as
    the reference defines the dequantization."""
    inv = recip32(quant_levels(bits))
    cb = codes.float().reshape(*codes.shape[:-1], -1, block)
    return (cb * (scales[..., None] * inv)).reshape(codes.shape)


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


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by a fixed pairwise tree (adjacent pairs
    first), zero padded to a power of two: the defined accumulation order of
    the sign wire's scale."""
    c = x.shape[-1]
    p = 1 << max(c - 1, 0).bit_length()
    if p != c:
        x = torch.nn.functional.pad(x, (0, p - c))
    while p > 1:
        x = x[..., ::2] + x[..., 1::2]
        p //= 2
    return x[..., 0]


def mean_abs_ref(g: torch.Tensor) -> torch.Tensor:
    """mean(|g|) over the last axis by the two-stage reduction: pairwise
    sums over rows of ``WIRE_BLOCK`` (zero padded), then across rows, then
    times the single-rounded f32 reciprocal of ``n``.  The reference writes
    ``/ n``; compiled (as its codecs always run), XLA rewrites the division
    by that constant into this multiply, and the port follows the compiled
    reference."""
    n = g.shape[-1]
    a = g.float().abs()
    a = torch.nn.functional.pad(a, (0, (-n) % WIRE_BLOCK))
    rows = pairwise_sum(a.reshape(*a.shape[:-1], -1, WIRE_BLOCK))
    return pairwise_sum(rows) * recip32(n)


def sign_pack_ref(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """signSGD wire: bit i = (g_i < 0) packed 32 to a word, and the mean-|g|
    scale.  An exact zero (and -0.0) ships as +scale."""
    return pack_codes_ref((g < 0).to(torch.int64), 1), mean_abs_ref(g)


def sign_unpack_ref(words: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """+scale where the bit is 0, -scale where it is 1; ``scale`` has the
    words' leading shape."""
    b = unpack_codes_ref(words, 1, n).float()
    return (1.0 - 2.0 * b) * scale[..., None]


def quant_pack_ref(g: torch.Tensor, uniforms: torch.Tensor, block: int = WIRE_BLOCK,
                   bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`block_quant_ref`, then the codes biased by ``+levels`` (into
    ``[0, 2 levels]``) and bit-packed: (words ``(..., ceil(n bits / 32))``,
    scales ``(..., n / block)``)."""
    codes, scales = block_quant_ref(g, uniforms, block, bits)
    return pack_codes_ref(codes.to(torch.int64) + int(quant_levels(bits)), bits), scales


def unpack_dequant_ref(words: torch.Tensor, scales: torch.Tensor, n: int,
                       block: int = WIRE_BLOCK, bits: int = 8) -> torch.Tensor:
    """Inverse of :func:`quant_pack_ref`: unpack ``n`` codes, remove the bias,
    dequantize.  Returns f32 ``(..., n)``."""
    c = unpack_codes_ref(words, bits, n) - int(quant_levels(bits))
    return block_dequant_ref(c.to(torch.int8), scales, block, bits)


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                        window: int = 0, softmax_scale: float | None = None) -> torch.Tensor:
    """GQA attention without the flash kernel: K/V repeated to the query
    heads, then the plain :func:`models.layers.attention` (the JAX tests'
    reference for the TPU kernel).  q (B, Sq, H, hd); k, v (B, Skv, KV, hd)
    with H a multiple of KV; ``window > 0`` masks ``kpos <= qpos - window``;
    ``softmax_scale`` defaults to ``hd ** -0.5``.  The probabilities are cast
    to ``v.dtype`` before P·V (bf16 inputs), as the TPU kernel does."""
    rep = q.shape[2] // k.shape[2]
    return attention(q, repeat_kv(k, rep), repeat_kv(v, rep), causal=causal, window=window,
                     softmax_scale=softmax_scale)
