"""CUDA kernel wrappers: fused GradESTC projection A = M^T G, E = G - M A,
and its int8-wire form (SVDFed's uplink).

``encode`` replaces ``src/repro/kernels/gradestc_encode.py::encode_pallas``
and ``encode_quant`` replaces ``encode_quant_pallas`` in the same file.
The kernels (``csrc/gradestc.cu``) take a leading stack axis, so one call
covers a group's L layers.  Their plain versions are ``ref.encode_ref`` and
``ref.encode_quant_ref``; ``kernels.ops`` picks between kernel and plain
version by the tensors' device.

Each call computes A, then the residual, on the tensors' current stream.
``encode`` splits the sum over l into chunks as :func:`split_plan` chooses
from the shapes alone and sums the chunks' partial products (3xTF32 on the
tensor cores) in split order.  ``encode_quant`` takes A as one sequential
FP32 chain over l, the order the installed cuBLAS takes at the path's
shapes, so the int8 scales and codes of A keep the plain version's bits (a
split moves max|A| past the scales' 1e-6 tolerance), then runs the int8
wire and the residual.  The wrapper allocates the scratch (the partials;
``encode_quant``'s A and shipped values) in one tensor and reads nothing
back from the device.  Each call counts one launch in ``_build.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build, ref

__all__ = ["encode", "encode_quant", "check_operand", "split_plan", "COL_TILE", "ROW_TILE",
           "MIN_CHUNK", "TARGET_BLOCKS"]

#: columns of G per block and rows of l per pipeline stage of the partial
#: kernel (``P1_BN``, ``P1_TR`` in ``csrc/gradestc.cu``)
COL_TILE = 128
ROW_TILE = 16
#: the least rows a chunk holds: k <= 64, so a block's k x 128 partial
#: (written once, read once) never outweighs the G rows it reads
MIN_CHUNK = 64
#: the grid the plan aims at: 5 blocks on each of the H100's 132 SMs
TARGET_BLOCKS = 5 * 132


def split_plan(L: int, l: int, m: int) -> Tuple[int, int]:
    """(S, LC): the partial kernel's split of l into S chunks of LC rows
    (the last may be shorter, none empty).  LC is a multiple of
    ``ROW_TILE`` and at least ``MIN_CHUNK``; within that, S is the fewest
    chunks that bring the grid ``(ceil(m / COL_TILE), S, L)`` to
    ``TARGET_BLOCKS``."""
    want = -(-TARGET_BLOCKS // (L * -(-m // COL_TILE)))
    lc = -(-l // want)
    lc = max(MIN_CHUNK, -(-lc // ROW_TILE) * ROW_TILE)
    return -(-l // lc), lc


def check_operand(name: str, x: torch.Tensor, ndim: int, device,
                  dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``x`` is what the CUDA kernels take: a contiguous
    ``dtype`` tensor of rank ``ndim`` on ``device``."""
    # is_cuda, not device.type: a wrapper's host time is on every launch's path
    if x.device != device or not x.is_cuda:
        raise ValueError(f"{name} must lie on {device} (a CUDA device), got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _shapes(kernel: str, M: torch.Tensor, G: torch.Tensor) -> Tuple[int, int, int, int]:
    check_operand("M", M, 3, M.device)
    check_operand("G", G, 3, M.device)
    L, l, k = M.shape
    if G.shape[:2] != (L, l):
        raise ValueError(f"M {tuple(M.shape)} and G {tuple(G.shape)} disagree on (L, l)")
    if not 1 <= k <= 64:
        raise ValueError(f"the {kernel} kernel takes 1 <= k <= 64, got k={k}")
    return L, l, G.shape[2], k


def encode(M: torch.Tensor, G: torch.Tensor, plan_stack: int | None = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M (L, l, k), G (L, l, m), both f32 on one CUDA device ->
    (A (L, k, m), E (L, l, m)).  The split of l is planned for a stack of
    ``plan_stack`` matrices (default L): a stack that folds C clients' L
    layers passes one client's L, so that every matrix gets the split, and
    so the bits, of a call for one client (the split depends on the shapes
    alone, each matrix's partials on nothing but the split)."""
    L, l, m, k = _shapes("encode", M, G)
    A = torch.empty((L, k, m), dtype=torch.float32, device=G.device)
    E = torch.empty_like(G)
    if L * l * m == 0:
        return A.zero_(), E
    S, LC = split_plan(L if plan_stack is None else plan_stack, l, m)
    P = torch.empty((L, S, k, m), dtype=torch.float32, device=G.device)   # the partials
    with _build.device(G):
        _build.launch("encode", "gradestc_encode_f32", M.data_ptr(), G.data_ptr(), A.data_ptr(),
                      E.data_ptr(), P.data_ptr(), L, l, m, k, S, LC, _build.stream(G))
    return A, E


def encode_quant(M: torch.Tensor, G: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """M (L, l, k), G (L, l, m), both f32 on one CUDA device -> (codes int8
    (L, k, m), scales f32 (L, k, ceil(m/512)), E = G - M ship (L, l, m)).

    A = M^T G (one sequential chain over l) goes through its
    int8 wire per (row, 512-column block); A and the shipped values are
    scratch."""
    L, l, m, k = _shapes("encode_quant", M, G)
    codes = torch.empty((L, k, m), dtype=torch.int8, device=G.device)
    scales = torch.empty((L, k, -(-m // ref.WIRE_BLOCK)), dtype=torch.float32,
                         device=G.device)
    E = torch.empty_like(G)
    if L * l * m == 0:
        return codes, scales, E
    if L * k * m >= 2 ** 31:
        raise ValueError(f"the int8 wire takes fewer than 2**31 coefficients, got {L * k * m}")
    A, ship = torch.empty((2, L, k, m), dtype=torch.float32, device=G.device)   # one scratch
    with _build.device(G):
        _build.launch("encode_quant", "gradestc_encode_quant_f32", M.data_ptr(), G.data_ptr(),
                      codes.data_ptr(), scales.data_ptr(), A.data_ptr(), ship.data_ptr(),
                      E.data_ptr(), L, l, m, k, _build.stream(G))
    return codes, scales, E
