"""CUDA kernel wrappers: GradESTC reconstruction Ghat = M A, and its int8
form Ghat = M (codes * (scale * INV127)) with the dequantization inside the
GEMM (the server side of the int8 coefficient wire).

``decode`` replaces ``src/repro/kernels/gradestc_decode.py::decode_pallas``
and ``decode_wire`` replaces ``decode_wire_pallas`` in the same file.  One
launch covers a group's L stacked layers; the kernels live in
``csrc/gradestc.cu`` beside the encode kernels: both are encode's residual
kernel without its G tile (128 x 64 output tiles, 3xTF32 on the tensor
cores, M and X by cp.async); on an H100 their bound is the write of Ghat.
decode_wire dequantizes its int8 tile as coeff_dequant does, so it equals
``decode(M, coeff_dequant(codes, scales))`` bit for bit.  Their plain
versions are ``ref.decode_ref`` and ``ref.decode_ref(M,
ref.coeff_dequant_ref(codes, scales))``; Ghat differs from cuBLAS's bits
(within 1e-5 ||G||_F), and M = 0 gives exactly 0.
"""

from __future__ import annotations

import torch

from . import _build, ref
from .gradestc_encode import check_operand

__all__ = ["decode", "decode_wire"]


def decode(M: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """M (L, l, k), A (L, k, m), both f32 on one CUDA device -> (L, l, m)."""
    check_operand("M", M, 3, M.device)
    check_operand("A", A, 3, M.device)
    L, l, k = M.shape
    if A.shape[:2] != (L, k):
        raise ValueError(f"M {tuple(M.shape)} and A {tuple(A.shape)} disagree on (L, k)")
    if not 1 <= k <= 64:
        raise ValueError(f"the decode kernel takes 1 <= k <= 64, got k={k}")
    m = A.shape[2]
    out = torch.empty((L, l, m), dtype=M.dtype, device=M.device)
    if L * l * m == 0:
        return out
    with _build.device(M):
        _build.launch("decode", "gradestc_decode_f32", M.data_ptr(), A.data_ptr(),
                      out.data_ptr(), L, l, m, k, _build.stream(M))
    return out


def decode_wire(M: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """M (L, l, k) f32, codes (L, k, m) int8, scales (L, k, ceil(m/512)) f32,
    all on one CUDA device -> (L, l, m) f32."""
    check_operand("M", M, 3, M.device)
    check_operand("codes", codes, 3, M.device, torch.int8)
    check_operand("scales", scales, 3, M.device)
    L, l, k = M.shape
    m = codes.shape[2]
    if codes.shape[:2] != (L, k):
        raise ValueError(f"M {tuple(M.shape)} and codes {tuple(codes.shape)} disagree on (L, k)")
    if scales.shape != (L, k, -(-m // ref.WIRE_BLOCK)):
        raise ValueError(f"scales {tuple(scales.shape)} do not fit codes {tuple(codes.shape)}")
    if not 1 <= k <= 64:
        raise ValueError(f"the decode_wire kernel takes 1 <= k <= 64, got k={k}")
    out = torch.empty((L, l, m), dtype=M.dtype, device=M.device)
    if L * l * m == 0:
        return out
    with _build.device(M):
        _build.launch("decode_wire", "gradestc_decode_wire_f32", M.data_ptr(), codes.data_ptr(),
                      scales.data_ptr(), out.data_ptr(), L, l, m, k, _build.stream(M))
    return out
