"""CUDA kernel wrappers: fused GradESTC projection A = M^T G, E = G - M A,
and its int8-wire form (SVDFed's uplink).

``encode`` replaces ``src/repro/kernels/gradestc_encode.py::encode_pallas``
and ``encode_quant`` replaces ``encode_quant_pallas`` in the same file.
The kernels (``csrc/gradestc.cu``) take a leading stack axis, so one call
covers a group's L layers.  Their plain versions are ``ref.encode_ref`` and
``ref.encode_quant_ref``; ``kernels.ops`` picks between kernel and plain
version by the tensors' device.

On an H100 FP32 FMA issue bounds both, not memory (see the note in the
source); each call counts its launch in ``_build.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build, ref

__all__ = ["encode", "encode_quant", "check_operand"]


def check_operand(name: str, x: torch.Tensor, ndim: int, device,
                  dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``x`` is what the CUDA kernels take: a contiguous
    ``dtype`` tensor of rank ``ndim`` on ``device``."""
    if x.device != device or x.device.type != "cuda":
        raise ValueError(f"{name} must lie on {device} (a CUDA device), got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def encode(M: torch.Tensor, G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """M (L, l, k), G (L, l, m), both f32 on one CUDA device ->
    (A (L, k, m), E (L, l, m))."""
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
    _build.launches["encode"] += 1
    return A, E


def encode_quant(M: torch.Tensor, G: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """M (L, l, k), G (L, l, m), both f32 on one CUDA device -> (codes int8
    (L, k, m), scales f32 (L, k, ceil(m/512)), E = G - M ship (L, l, m)).

    Three launches on scratch ``A`` and ``ship``: A = M^T G, its int8 wire
    per (row, 512-column block), then E from the shipped values."""
    check_operand("M", M, 3, M.device)
    check_operand("G", G, 3, M.device)
    L, l, k = M.shape
    if G.shape[:2] != (L, l):
        raise ValueError(f"M {tuple(M.shape)} and G {tuple(G.shape)} disagree on (L, l)")
    if not 1 <= k <= 64:
        raise ValueError(f"the encode_quant kernel takes 1 <= k <= 64, got k={k}")
    m = G.shape[2]
    nb = -(-m // ref.WIRE_BLOCK)
    codes = torch.empty((L, k, m), dtype=torch.int8, device=G.device)
    scales = torch.empty((L, k, nb), dtype=torch.float32, device=G.device)
    E = torch.empty_like(G)
    if L * l * m == 0:
        return codes, scales, E
    A = torch.empty((L, k, m), dtype=torch.float32, device=G.device)
    ship = torch.empty_like(A)
    lib = _build.load()
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        rc = lib.gradestc_encode_quant_f32(M.data_ptr(), G.data_ptr(), codes.data_ptr(),
                                           scales.data_ptr(), A.data_ptr(), ship.data_ptr(),
                                           E.data_ptr(), L, l, m, k, stream)
    if rc != 0:
        raise RuntimeError(f"gradestc_encode_quant_f32 launch failed: CUDA error {rc}")
    _build.launches["encode_quant"] += 1
    return codes, scales, E
