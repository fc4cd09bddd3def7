"""CUDA kernel wrapper: flash attention, the forward of a full sequence.

``flash_attention`` replaces
``src/repro/kernels/flash_attention.py::flash_attention_pallas``: causal or
sliding-window grouped-query attention with the online-softmax (m, l, acc)
rescale, K and V never repeated to the query heads.  The kernel
(``csrc/flash_attention.cu``) takes f32 or bf16, works in f32 (3xTF32 on the
tensor cores for QK^T and P·V), rounds p to v's dtype before P·V, writes
q's dtype, and takes any Sq and Skv (the TPU kernel's divisibility
assertion is a constraint of its tiling).  Its plain version is
``ref.flash_attention_ref``; they agree within rtol = atol = 1e-4 in f32
and 5e-2 with bf16 inputs, the JAX tests' tolerances.  The port's eval
forward runs it (``models/transformer._layer_fwd`` on a CUDA tensor with
grad disabled); training keeps the plain attention, since the reference
defines no backward for the kernel.

:func:`flash_plan` balances the grid from the shapes alone (no device
read): each 64-row query tile's range of 32-key tiles splits into chunks,
one block each; the chunks of a split tile leave partial (acc, m, l) in a
scratch tensor the wrapper allocates, and a second kernel merges them in
chunk order, so two calls give the same bits.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention", "flash_plan", "tile_range", "tile_lengths", "plan_items", "DTYPES",
           "MAX_HEAD_DIM", "BLOCK_Q", "BLOCK_KV"]

#: input types, by the kernel's code for them
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest head dim whose tiles fit a block's shared memory
MAX_HEAD_DIM = 256
#: query rows per block and keys per tile (``BQ``, ``BKV`` in the source)
BLOCK_Q = 64
BLOCK_KV = 32
#: the H100's SMs; the work items the plan aims at on each (at hd 256 an
#: SM holds one block); and the fewest key tiles a chunk holds (128 keys: a
#: partial's write and read stay small beside the chunk's K and V)
SMS = 132
ITEMS_PER_SM = 3
MIN_CHUNK = 4


def head_dim_bucket(hd: int) -> int:
    """hd rounded up to the kernel's 32, 64, 128 or 256."""
    return next(b for b in (32, 64, 128, 256) if hd <= b)


def tile_range(qt: int, Sq: int, Skv: int, causal: bool, window: int) -> Tuple[int, int]:
    """The key tiles [t_lo, t_hi) that some row of query tile ``qt`` may see
    (the kernel's ``tile_range``): tiles wholly above the diagonal or before
    every row's window are skipped, except that a tile holding a row with no
    visible key (``qpos >= Skv + window - 1``) walks all of them."""
    q0 = qt * BLOCK_Q
    q_last = min(q0 + BLOCK_Q, Sq) - 1
    k_lo, k_hi = 0, Skv
    if causal:
        k_hi = min(Skv, q_last + 1)
    if window > 0:
        k_lo = max(0, q0 - window + 1)
    if window > 0 and q_last >= Skv + window - 1:
        k_lo, k_hi = 0, Skv
    return k_lo // BLOCK_KV, -(-k_hi // BLOCK_KV)


def tile_lengths(Sq: int, Skv: int, causal: bool, window: int) -> List[int]:
    """The key tiles each query tile walks, by q-tile."""
    return [hi - lo for lo, hi in (tile_range(qt, Sq, Skv, causal, window)
                                   for qt in range(-(-Sq // BLOCK_Q)))]


@functools.lru_cache(maxsize=256)
def flash_plan(B: int, H: int, Sq: int, Skv: int, causal: bool,
               window: int) -> Tuple[int, int]:
    """(chunk, nc): every q-tile's key tiles split into ``ceil(len /
    chunk)`` chunks, the longest's into nc.  The chunk aims at
    ``ITEMS_PER_SM`` work items per SM over the whole grid (at least
    ``MIN_CHUNK`` tiles), rounded so the longest range splits evenly; nc ==
    1 is no split (no scratch, no combine).  A target per SM rather than per
    resident block: where an SM holds several blocks (hd <= 64), the blocks
    that share it already even out its load."""
    lens = tile_lengths(Sq, Skv, causal, window)
    want = max(MIN_CHUNK, -(-sum(lens) * B * H // (ITEMS_PER_SM * SMS)))
    longest = max(lens)
    nc = max(1, round(longest / want))
    return -(-longest // nc), nc


def plan_items(Sq: int, Skv: int, causal: bool, window: int,
               chunk: int) -> List[Tuple[int, int, int, int]]:
    """The work items of one (batch row, head), in launch order: (q-tile,
    first key tile, end key tile, chunks of that q-tile)."""
    nq = -(-Sq // BLOCK_Q)
    out = []
    for qt in reversed(range(nq)):
        lo, hi = tile_range(qt, Sq, Skv, causal, window)
        n = -(-(hi - lo) // chunk)
        out += [(qt, lo + c * chunk, min(hi, lo + (c + 1) * chunk), n) for c in range(n)]
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    window: int = 0, softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, H, hd), k and v (B, Skv, KV, hd), contiguous, one dtype (f32
    or bf16), on one CUDA device, H a multiple of KV, hd <= 256 -> (B, Sq,
    H, hd) in q's dtype.  ``window > 0`` masks ``kpos <= qpos - window``;
    ``softmax_scale`` defaults to ``hd ** -0.5``."""
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name} must lie on {dev} (a CUDA device), got {x.device}")
        if x.dtype not in DTYPES or x.dtype != q.dtype:
            raise TypeError(f"q, k and v must share one dtype of {list(DTYPES)}, "
                            f"got {q.dtype}, {k.dtype}, {v.dtype}")
        if x.dim() != 4 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, S, heads, hd) tensor, "
                             f"got shape {tuple(x.shape)}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "do not fit")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} key/value heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel takes 1 <= hd <= {MAX_HEAD_DIM}, got {hd}")
    out = torch.empty_like(q)
    if B * Sq * H == 0:
        return out
    if Skv == 0:
        raise ValueError("attention over no keys")
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    chunk, nc = flash_plan(B, H, Sq, Skv, bool(causal), int(window))
    part = torch.empty(B * H * -(-Sq // BLOCK_Q) * nc * BLOCK_Q * (head_dim_bucket(hd) + 2),
                       dtype=torch.float32, device=dev) if nc > 1 else None
    with _build.device(q):
        _build.launch("flash_attention", "flash_attention_fwd", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), part.data_ptr() if nc > 1 else None, B, Sq,
                      Skv, H, KV, hd, DTYPES[q.dtype], scale, int(causal), int(window), chunk,
                      nc, _build.stream(q))
    return out
