"""Gradient preprocessing: (l, m) segmentation of flattened gradients.

Port of ``repro/core/reshaping.py``.  Each gradient tensor is flattened
row-major and cut into consecutive length-``l`` segments that form the
columns of ``G in R^{l x m}`` (paper Sec. III-A.a); ``l`` is the factor of
``n`` nearest ``sqrt(n)`` that is a multiple of the row length where one
exists.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

__all__ = ["choose_segment_length", "segment", "unsegment", "pad_to_block"]


def pad_to_block(x: torch.Tensor, multiple: int, axis: int = -1) -> Tuple[torch.Tensor, int]:
    """Zero-pad ``x`` along ``axis`` up to the next multiple of ``multiple``.
    Returns ``(padded, original_size)``; a no-op when already aligned."""
    axis = axis % x.ndim
    size = x.shape[axis]
    pad = (-size) % multiple
    if pad == 0:
        return x, size
    widths = [0, 0] * (x.ndim - axis)   # F.pad lists the last axis first
    widths[-1] = pad
    return torch.nn.functional.pad(x, widths), size


def choose_segment_length(shape: Sequence[int], l_hint: int | None = None) -> int:
    """Column length ``l`` for a gradient of this tensor shape: ``l_hint``
    if given (must divide n), else a multiple of the trailing dimension
    nearest sqrt(n), else the divisor of n nearest sqrt(n)."""
    n = math.prod(int(s) for s in shape)
    if l_hint is not None:
        if n % l_hint != 0:
            raise ValueError(f"l_hint={l_hint} does not divide n={n}")
        return l_hint

    root = math.isqrt(n)
    trailing = int(shape[-1])
    if trailing <= n:
        k = max(1, round(root / trailing))
        for cand in (k * trailing, (k + 1) * trailing, max(1, k - 1) * trailing):
            if cand > 0 and n % cand == 0:
                return cand
    best = 1
    for d in range(1, root + 1):
        if n % d == 0:
            best = d
    other = n // best
    return best if abs(best - root) <= abs(other - root) else other


def segment(g: torch.Tensor, l: int) -> torch.Tensor:
    """``(..., n) -> (..., l, m)`` with ``G[:, j] = g[j*l:(j+1)*l]``."""
    n = g.shape[-1]
    if n % l != 0:
        raise ValueError(f"segment length l={l} must divide n={n}")
    return g.reshape(*g.shape[:-1], n // l, l).transpose(-1, -2)


def unsegment(G: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`segment`: ``(..., l, m) -> (..., n)``."""
    l, m = G.shape[-2], G.shape[-1]
    return G.transpose(-1, -2).reshape(*G.shape[:-2], l * m)
