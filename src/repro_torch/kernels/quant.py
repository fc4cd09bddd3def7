"""CUDA kernel wrappers: the unpacked block quantizer (FedPAQ's other widths).

Port of ``src/repro/kernels/quant.py``.  ``block_quant`` replaces
``quant.py::block_quant_pallas`` and ``block_dequant`` replaces
``quant.py::block_dequant_pallas``; both kernels are in
``csrc/quant_wire.cu``.  Per row of ``block`` values: ``scale =
max(max|g|, 1e-12)``, ``x = g / scale * levels``, ``code = floor(x) + (u <
x - floor(x))`` clipped to ``[-levels, levels]`` against operand uniforms
``u``, and back ``code * (scale * f32(1/levels))``.  They take any
``block`` and any ``bits`` from 2 to 8, and equal their plain versions
``ref.block_quant_ref`` and ``ref.block_dequant_ref`` bit for bit.  The
quantizer wire (``ops.block_quant_wire``) runs them for the widths that
``quant_pack``/``unpack_dequant`` do not take.  Both are single passes
bounded by HBM bandwidth.  ``block_quant`` shares ``quant_pack``'s row walk
(a warp a row, lane L on the float4 chunk ``32q + L`` of g and of u in step
q, one 4-byte store of its 4 codes) by the host's plan, ``wire.quant_plan``;
the uniforms stay an operand.  ``block_dequant`` walks its output in chunks
of 4 codes (one 4-byte load) by the host's plan, ``wire.dequant_plan``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .gradestc_encode import check_operand
from .ref import quant_levels
from .wire import dequant_plan, quant_plan

__all__ = ["block_quant", "block_dequant", "quant_levels", "OUT_DTYPES"]

#: the output types of ``block_dequant``, by the kernel's code for them
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(block: int, bits: int) -> None:
    if not 2 <= bits <= 8:
        raise ValueError(f"the block quantizer takes 2 <= bits <= 8, got {bits}")
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")


def block_quant(g: torch.Tensor, u: torch.Tensor, block: int = 512, bits: int = 8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g (n,) f32 and uniforms u (n_p,) f32, ``n_p = ceil(n/block)*block <
    2**31``, on one CUDA device -> (codes int8 (n_p,), scales f32
    (n_p/block,)).  g reads as zero past n (the reference's padding).  The
    kernel walks ``wire.quant_plan(n, block, g and u aligned to 16 bytes and
    the codes to 4)`` and draws nothing: the uniforms are the caller's."""
    _check(block, bits)
    check_operand("g", g, 1, g.device)
    check_operand("u", u, 1, g.device)
    n = g.shape[0]
    rows = -(-n // block)
    if u.shape[0] != rows * block:
        raise ValueError(f"u has {u.shape[0]} values; g of {n} needs {rows * block}")
    if rows * block >= 2 ** 31:
        raise ValueError(f"the quantizer takes fewer than 2**31 padded values, got "
                         f"{rows * block}")
    codes = torch.empty((rows * block,), dtype=torch.int8, device=g.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=g.device)
    if n:
        gp, up, cp = g.data_ptr(), u.data_ptr(), codes.data_ptr()
        plan = quant_plan(n, block, gp % 16 == 0 and up % 16 == 0 and cp % 4 == 0)
        with _build.device(g):
            _build.launch("block_quant", "quant_block_quant_f32", gp, up, cp,
                          scales.data_ptr(), n, block, bits, plan.vec_rows, plan.grid,
                          _build.stream(g))
    return codes, scales


def block_dequant(codes: torch.Tensor, scales: torch.Tensor, n: int, block: int = 512,
                  bits: int = 8, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """codes int8 (n_p,) and scales f32 (n_p/block,) on one CUDA device ->
    the first n values of ``code * (scale * f32(1/levels))`` in
    ``out_dtype`` (f32, bf16 or f16; rounded once from f32); ``n_p < 2**31``."""
    _check(block, bits)
    dev = codes.device
    check_operand("codes", codes, 1, dev, torch.int8)
    check_operand("scales", scales, 1, dev)
    kind = OUT_DTYPES.get(out_dtype)
    if kind is None:
        raise TypeError(f"block_dequant writes {list(OUT_DTYPES)}, not {out_dtype}")
    n_p = scales.shape[0] * block
    if codes.shape[0] != n_p or not 0 <= n_p - n < block:
        raise ValueError(f"codes {tuple(codes.shape)} and scales {tuple(scales.shape)} "
                         f"do not hold {n} values in blocks of {block}")
    if n_p >= 2 ** 31:
        raise ValueError(f"the dequantizer takes fewer than 2**31 codes, got {n_p}")
    out = torch.empty((n,), dtype=out_dtype, device=dev)
    if n:
        c, o = codes.data_ptr(), out.data_ptr()
        plan = dequant_plan(n, block, c % 4 == 0 and o % 16 == 0)
        with _build.device(codes):
            _build.launch("block_dequant", "quant_block_dequant", c, scales.data_ptr(), o, n,
                          block, bits, kind, plan.vec_chunks, plan.grid, _build.stream(codes))
    return out
