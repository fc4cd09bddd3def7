"""CUDA kernel wrapper: fused GradESTC projection A = M^T G, E = G - M A.

Replaces ``src/repro/kernels/gradestc_encode.py::encode_pallas``.  The
kernel (``csrc/gradestc.cu``) takes a leading stack axis, so one launch
covers a group's L layers.  Its plain version is ``ref.encode_ref``;
``kernels.ops.encode`` picks between them by the tensors' device.

On an H100 FP32 FMA issue bounds this kernel, not memory (see the note in
the source); the launch count below shows that a run went through it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

__all__ = ["encode", "launch_count", "reset_launch_count", "check_operand"]

_LAUNCHES = 0


def launch_count() -> int:
    return _LAUNCHES


def reset_launch_count() -> None:
    global _LAUNCHES
    _LAUNCHES = 0


def check_operand(name: str, x: torch.Tensor, ndim: int, device) -> None:
    """Raise unless ``x`` is what the CUDA kernels take: a contiguous f32
    tensor of rank ``ndim`` on ``device``."""
    if x.device != device or x.device.type != "cuda":
        raise ValueError(f"{name} must lie on {device} (a CUDA device), got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def encode(M: torch.Tensor, G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """M (L, l, k), G (L, l, m), both f32 on one CUDA device ->
    (A (L, k, m), E (L, l, m))."""
    global _LAUNCHES
    check_operand("M", M, 3, M.device)
    check_operand("G", G, 3, M.device)
    L, l, k = M.shape
    if G.shape[:2] != (L, l):
        raise ValueError(f"M {tuple(M.shape)} and G {tuple(G.shape)} disagree on (L, l)")
    if not 1 <= k <= 64:
        raise ValueError(f"the encode kernel takes 1 <= k <= 64, got k={k}")
    m = G.shape[2]
    A = torch.empty((L, k, m), dtype=G.dtype, device=G.device)
    E = torch.empty_like(G)
    if L * l * m == 0:
        return A.zero_(), E
    lib = _build.load()
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        rc = lib.gradestc_encode_f32(M.data_ptr(), G.data_ptr(), A.data_ptr(),
                                     E.data_ptr(), L, l, m, k, stream)
    if rc != 0:
        raise RuntimeError(f"gradestc_encode_f32 launch failed: CUDA error {rc}")
    _LAUNCHES += 1
    return A, E
