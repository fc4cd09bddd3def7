"""CUDA kernel wrappers: GradESTC reconstruction Ghat = M A, and its int8
form Ghat = M (codes * (scale * INV127)) with the dequantization inside the
GEMM (the server side of the int8 coefficient wire).

``decode`` replaces ``src/repro/kernels/gradestc_decode.py::decode_pallas``
and ``decode_wire`` replaces ``decode_wire_pallas`` in the same file.  One
launch covers a group's L stacked layers; the kernels live in
``csrc/gradestc.cu`` beside the encode kernels.  Their plain versions are
``ref.decode_ref`` and ``ref.decode_ref(M, ref.coeff_dequant_ref(codes,
scales))``.  On an H100 at k = 64 FP32 FMA issue bounds both.
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
    lib = _build.load()
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        rc = lib.gradestc_decode_f32(M.data_ptr(), A.data_ptr(), out.data_ptr(),
                                     L, l, m, k, stream)
    if rc != 0:
        raise RuntimeError(f"gradestc_decode_f32 launch failed: CUDA error {rc}")
    _build.launches["decode"] += 1
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
    lib = _build.load()
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        rc = lib.gradestc_decode_wire_f32(M.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                                          out.data_ptr(), L, l, m, k, stream)
    if rc != 0:
        raise RuntimeError(f"gradestc_decode_wire_f32 launch failed: CUDA error {rc}")
    _build.launches["decode_wire"] += 1
    return out
