"""Public entry points of the port's kernels, dispatching on device.

Port of ``repro/kernels/ops.py``: ``encode``/``decode``, the coefficient
wire (``coeff_quant``, ``coeff_dequant``, ``coeff_roundtrip``,
``encode_quant``, ``decode_wire``), the quantizer wire
(``sign_wire``/``sign_unwire``, ``block_quant_wire``/``block_dequant_wire``,
``quantize_update``), the unpacked block quantizer (``block_quantize``,
``block_dequantize``) and ``flash_attention``.  A tensor on the CPU goes to
the plain version in ``ref`` (so does a ``meta`` tensor, the dry run's,
whose plain version only propagates shapes); a CUDA tensor goes to the
hand-written kernel, or the call raises.  There is no fall-back on the card: a shape or
dtype the kernel does not take is an error, not a silent plain path.

On the card the coefficient operands are stacks ``(..., L, l, k)``/``(...,
L, l, m)``/``(..., L, k, m)``, one kernel call per stack: leading axes (the
fused engine's clients) fold into the kernels' stack axis, and encode plans
its split of l for one stack of L, so a folded call gives each matrix the
bits of a call per stack (the CPU path also takes single matrices).  The kernels tile l in shared memory and mask the ragged
m edge, so the reference's VMEM fit rule (``choose_block_m``), its
fall-back to the oracle for large l and its column padding have no
counterpart here.

The quantizer wire works on flat ``(n,)`` vectors.  Its words are uint32
values held as the bit patterns of int32 tensors on both devices.  It has
two routes, as the reference has: ``bits`` in {2, 4, 8} with 512-value
blocks run the fused ``quant_pack``/``unpack_dequant`` kernels; every other
width from 2 to 8 bits, and any block, runs the ``block_quant`` and
``block_dequant`` kernels around an integer pack (see
``block_quant_wire``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core import baselines, prng
from . import _build, gradestc_decode, gradestc_encode, quant, ref, wire
from . import flash_attention as flash

__all__ = ["encode", "decode", "coeff_quant", "coeff_dequant", "coeff_roundtrip",
           "encode_quant", "decode_wire", "sign_wire", "sign_unwire", "block_quant_wire",
           "block_dequant_wire", "quantize_update", "block_quantize", "block_dequantize",
           "flash_attention", "WIRE_DTYPES", "KERNELS", "launch_counts",
           "reset_launch_counts"]

#: coefficient wire formats: exact f32, bf16 half-words, scaled int8 codes
WIRE_DTYPES = ("f32", "bf16", "int8")
#: the CUDA kernels, by the names their launches are counted under
KERNELS = ("encode", "decode", "coeff_quant", "encode_quant", "decode_wire",
           "sign_pack", "sign_unpack", "quant_pack", "unpack_dequant", "coeff_dequant",
           "block_quant", "block_dequant", "flash_attention")


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset (a plain-version call on
    the CPU launches nothing)."""
    return {name: _build.launches[name] for name in KERNELS}


def reset_launch_counts() -> None:
    _build.launches.clear()


def _route(*xs: torch.Tensor) -> str:
    kinds = {x.device.type for x in xs}
    if kinds == {"cpu"} or kinds == {"meta"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"operands on mixed or unsupported devices: {[x.device for x in xs]}")


def _fold(x: torch.Tensor) -> torch.Tensor:
    """``(..., L, r, c)`` -> ``(prod(...) L, r, c)``, a view of a contiguous
    stack; a tensor of rank 3 or less passes as it is (the kernel's checks
    see it)."""
    return x.reshape(-1, *x.shape[-2:]) if x.dim() > 3 else x


def _unfold(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The kernel's ``(prod(...) L, r, c)`` output back under ``like``'s
    leading axes."""
    return x.reshape(*like.shape[:-2], *x.shape[-2:])


def encode(M: torch.Tensor, G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused A = M^T G, E = G - M A."""
    if _route(M, G) == "cpu":
        return ref.encode_ref(M, G)
    plan_stack = M.shape[-3] if M.dim() > 3 else None
    A, E = gradestc_encode.encode(_fold(M), _fold(G), plan_stack)
    return _unfold(A, G), _unfold(E, G)


def decode(M: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Ghat = M A."""
    if _route(M, A) == "cpu":
        return ref.decode_ref(M, A)
    return _unfold(gradestc_decode.decode(_fold(M), _fold(A)), A)


def coeff_quant(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int8 wire of ``A (..., k, m)``: (codes, scales, ship)."""
    if _route(A) == "cpu":
        return ref.coeff_quant_ref(A)
    return tuple(_unfold(x, A) for x in wire.coeff_quant(_fold(A)))


def coeff_dequant(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 codes ``(..., k, m)`` + scales ``(..., k, ceil(m/512))`` -> f32
    ``codes * (scale * INV127)`` (the card takes stacks of rank 3 or more)."""
    if _route(codes, scales) == "cpu":
        return ref.coeff_dequant_ref(codes, scales)
    return _unfold(wire.coeff_dequant(_fold(codes), _fold(scales)), codes)


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
    # A's chain runs over l alone, so the fold needs no plan
    return tuple(_unfold(x, G) for x in gradestc_encode.encode_quant(_fold(M), _fold(G)))


def decode_wire(M: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Ghat = M (codes * (scale * INV127)): the int8 wire's reconstruction."""
    if _route(M, codes, scales) == "cpu":
        return ref.decode_ref(M, ref.coeff_dequant_ref(codes, scales))
    return _unfold(gradestc_decode.decode_wire(_fold(M), _fold(codes), _fold(scales)), codes)


def _words32(words: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 (the plain versions' words) -> the same
    bits as int32, the wire words' type on both devices (wrapped here, not
    left to an out-of-range cast)."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _fused_wire(bits: int, block: int) -> bool:
    """Whether the fused quant_pack/unpack_dequant route takes this width."""
    return bits in wire.QUANT_BITS and block == ref.WIRE_BLOCK


def sign_wire(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """signSGD uplink of a flat ``g (n,)``: (words (ceil(n/32),), scale ()).
    The scale is mean(|g|) by the two-stage tree (``ref.mean_abs_ref``); on
    the card ``wire.sign_pack`` finishes it on the device, so no torch op
    runs between the kernel and the scale."""
    if _route(g) == "cpu":
        words, scale = ref.sign_pack_ref(g)
        return _words32(words), scale
    words, _, scale = wire.sign_pack(g)
    return words, scale


def sign_unwire(words: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`sign_wire`: (n,) f32 of +-scale."""
    if _route(words, scale) == "cpu":
        return ref.sign_unpack_ref(words, scale, n)
    return wire.sign_unpack(words, scale, n)


def block_quant_wire(g: torch.Tensor, key: torch.Tensor, bits: int = 8,
                     block: int = ref.WIRE_BLOCK
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Block-quantize and bit-pack a flat ``g (n,)`` (FedPAQ/FedQClip):
    (words (ceil(n_p / (32 // bits)),), scales (n_p/block,), pad), ``n_p =
    n + pad`` the length padded to a whole block; code ``i`` sits in word
    ``i // (32 // bits)``.  The stochastic rounding draws ``prng.uniform(key,
    (n_p,))`` over the padded length, as the reference does, on ``g``'s
    device.

    bits in {2, 4, 8} with 512-value blocks: the fused ``quant_pack``.  Any
    other width from 2 to 8 bits, or another block: ``block_quantize`` (the
    ``block_quant`` kernel on the card), then the codes biased by ``+levels``
    and packed ``32 // bits`` to a word by a few integer tensor ops.  The
    pack stays outside the kernel because the reference, too, packs these
    widths outside any kernel (its oracle, ``ref.quant_pack_ref``); all
    arithmetic on values is in the kernels, and both routes equal
    ``ref.quant_pack_ref`` bit for bit."""
    if bits < 2:
        raise ValueError("1-bit quantization is the sign wire (ops.sign_wire)")
    if bits > 8:
        raise ValueError(f"the quantizer wire takes 2 <= bits <= 8, got {bits}")
    if not _fused_wire(bits, block):
        codes, scales, pad = block_quantize(g, key, block=block, bits=bits)
        biased = codes.to(torch.int64) + int(ref.quant_levels(bits))
        return _words32(ref.pack_codes_ref(biased, bits)), scales, pad
    n = g.shape[0]
    pad = (-n) % block
    if _route(g, key) == "cpu":
        words, scales = ref.quant_pack_ref(torch.nn.functional.pad(g, (0, pad)),
                                           prng.uniform(key, (n + pad,)), block, bits)
        return _words32(words), scales, pad
    return (*wire.quant_pack(g, prng.uniform(key, (n + pad,)), bits), pad)


def block_dequant_wire(words: torch.Tensor, scales: torch.Tensor, pad: int,
                       bits: int = 8, block: int = ref.WIRE_BLOCK) -> torch.Tensor:
    """Inverse of :func:`block_quant_wire`: unpack, un-bias, dequantize,
    crop the padding (f32).  The other widths unpack and un-bias with
    integer tensor ops and dequantize with ``block_dequantize``."""
    if not 2 <= bits <= 8:
        raise ValueError(f"the quantizer wire takes 2 <= bits <= 8, got {bits}")
    n_p = scales.shape[0] * block
    if not _fused_wire(bits, block):
        codes = ref.unpack_codes_ref(words, bits, n_p) - int(ref.quant_levels(bits))
        codes = codes.to(torch.int8)
        return block_dequantize(codes, scales, pad, block=block, bits=bits)
    if _route(words, scales) == "cpu":
        return ref.unpack_dequant_ref(words, scales, n_p, block, bits)[: n_p - pad]
    return wire.unpack_dequant(words, scales, n_p - pad, bits)


def quantize_update(g: torch.Tensor, key: torch.Tensor, bits: int = 8,
                    block: int = ref.WIRE_BLOCK, use_pallas: bool = False) -> torch.Tensor:
    """Quantize a flat update through its packed wire and reconstruct it
    (FedPAQ, FedQClip).  ``use_pallas=True``: the block-local quantizer
    (one scale per ``block`` values; the kernels on the card).
    ``use_pallas=False``: the paper's global-scale quantizer
    (``core.baselines``), on the CPU only: the card has no plain path."""
    if use_pallas:
        words, scales, pad = block_quant_wire(g, key, bits=bits, block=block)
        return block_dequant_wire(words, scales, pad, bits=bits, block=block).to(g.dtype)
    if _route(g) != "cpu":
        raise ValueError("use_pallas=False is the plain global quantizer, which runs "
                         "only on the CPU")
    codes, scale = baselines.quantize_stochastic(g, key, bits)
    codes = ref.unpack_codes_ref(ref.pack_codes_ref(codes, bits), bits, g.shape[0])
    return baselines.dequantize(codes, scale, bits).to(g.dtype)


def block_quantize(g: torch.Tensor, key: torch.Tensor, block: int = 512, bits: int = 8
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Flat block-stochastic quantization (the reference's
    ``ops.block_quantize``): (codes int8 (n_p,), scales f32 (n_p/block,),
    pad), ``n_p = n + pad`` the length padded to a whole block, with the
    uniforms ``prng.uniform(key, (n_p,))`` drawn over the padded length on
    ``g``'s device.  The card reads g as zero past n (no padded copy)."""
    n = g.shape[0]
    pad = (-n) % block
    u = prng.uniform(key, (n + pad,))
    if _route(g, key) == "cpu":
        codes, scales = ref.block_quant_ref(torch.nn.functional.pad(g, (0, pad)), u, block,
                                            bits)
        return codes, scales, pad
    return (*quant.block_quant(g, u, block, bits), pad)


def block_dequantize(codes: torch.Tensor, scales: torch.Tensor, pad: int, block: int = 512,
                     bits: int = 8, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`block_quantize`: ``code * (scale * f32(1/levels))``
    in ``out_dtype``, the padding cropped."""
    n = codes.shape[0] - pad
    if _route(codes, scales) == "cpu":
        return ref.block_dequant_ref(codes, scales, block, bits)[:n].to(out_dtype)
    return quant.block_dequant(codes, scales, n, block, bits, out_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    window: int = 0, softmax_scale: float | None = None) -> torch.Tensor:
    """Grouped-query attention over full sequences: q (B, Sq, H, hd), k and
    v (B, Skv, KV, hd) -> (B, Sq, H, hd).  The flash kernel on the card, the
    plain attention over repeated K/V on the CPU."""
    if _route(q, k, v) == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softmax_scale=softmax_scale)
    return flash.flash_attention(q, k, v, causal=causal, window=window,
                                 softmax_scale=softmax_scale)
