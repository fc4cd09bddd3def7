"""CUDA kernel wrapper: the deterministic int8 coefficient wire.

Replaces ``src/repro/kernels/wire.py::coeff_quant_pallas`` (GradESTC's
``wire_dtype="int8"``, reached through ``ops.coeff_roundtrip`` after basis
replacement).  Per (row, 512-column block) of a coefficient matrix:
``scale = max(max|a|, 1e-12)``, ``codes = clip(rint(a / scale * 127),
-127, 127)`` and the shipped value ``codes * (scale * INV127)``.  The
kernel (``csrc/gradestc.cu``) takes a leading stack axis and masks the
ragged last block, and equals its plain version ``ref.coeff_quant_ref`` bit
for bit.  It moves 9 bytes per coefficient, so HBM bounds it; at the
slice's sizes (~4 us of traffic) the call's host-side cost dominates.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build, ref
from .gradestc_encode import check_operand

__all__ = ["coeff_quant"]


def coeff_quant(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A (L, k, m) f32 on a CUDA device -> (codes int8 (L, k, m), scales f32
    (L, k, ceil(m/512)), ship f32 (L, k, m))."""
    check_operand("A", A, 3, A.device)
    L, k, m = A.shape
    codes = torch.empty((L, k, m), dtype=torch.int8, device=A.device)
    scales = torch.empty((L, k, -(-m // ref.WIRE_BLOCK)), dtype=torch.float32,
                         device=A.device)
    ship = torch.empty_like(A)
    if L * k * m == 0:
        return codes, scales, ship
    lib = _build.load()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.gradestc_coeff_quant_f32(A.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                                          ship.data_ptr(), L, k, m, stream)
    if rc != 0:
        raise RuntimeError(f"gradestc_coeff_quant_f32 launch failed: CUDA error {rc}")
    _build.launches["coeff_quant"] += 1
    return codes, scales, ship
