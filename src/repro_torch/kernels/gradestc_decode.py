"""CUDA kernel wrapper: GradESTC reconstruction Ghat = M A.

Replaces ``src/repro/kernels/gradestc_decode.py::decode_pallas``.  One
launch covers a group's L stacked layers; the kernel lives in
``csrc/gradestc.cu`` beside the encode kernel.  Its plain version is
``ref.decode_ref``.  On an H100 at k = 64 FP32 FMA issue bounds it.
"""

from __future__ import annotations

import torch

from . import _build
from .gradestc_encode import check_operand

__all__ = ["decode", "launch_count", "reset_launch_count"]

_LAUNCHES = 0


def launch_count() -> int:
    return _LAUNCHES


def reset_launch_count() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def decode(M: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """M (L, l, k), A (L, k, m), both f32 on one CUDA device -> (L, l, m)."""
    global _LAUNCHES
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
    _LAUNCHES += 1
    return out
