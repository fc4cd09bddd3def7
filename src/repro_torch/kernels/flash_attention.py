"""CUDA kernel wrapper: flash attention, the forward of a full sequence.

``flash_attention`` replaces
``src/repro/kernels/flash_attention.py::flash_attention_pallas``: causal or
sliding-window grouped-query attention with the online-softmax (m, l, acc)
rescale, K and V never repeated to the query heads.  The kernel
(``csrc/flash_attention.cu``) takes f32 or bf16, works in f32, rounds p to
v's dtype before P·V, writes q's dtype, and takes any Sq and Skv (the TPU
kernel's divisibility assertion is a constraint of its tiling).  Its plain
version is ``ref.flash_attention_ref``; they agree within rtol = atol =
1e-4 in f32 and 5e-2 with bf16 inputs, the JAX tests' tolerances.  The
port's eval forward runs it (``models/transformer._layer_fwd`` on a CUDA
tensor with grad disabled); training keeps the plain attention, since the
reference defines no backward for the kernel.  FP32 operations bound it
(see the note in the source).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "DTYPES", "MAX_HEAD_DIM"]

#: input types, by the kernel's code for them
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest head dim whose tiles fit a block's shared memory
MAX_HEAD_DIM = 256


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
    with torch.cuda.device(dev):
        _build.launch("flash_attention", "flash_attention_fwd", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), B, Sq, Skv, H, KV, hd, DTYPES[q.dtype],
                      scale, int(causal), int(window), _build.stream(q))
    return out
