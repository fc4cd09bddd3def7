"""Randomized SVD (Halko, Martinsson & Tropp 2011), batched, in f32.

Port of ``repro/core/rsvd.py``.  Works over any leading stack axes: ``A``
is ``(..., l, m)`` and ``key`` is ``(..., 2)``, one threefry key per matrix,
so one call sketches all L layers of a group.  The Gaussian test matrix
comes from :func:`repro_torch.core.prng.normal` on the reference's key, so
it is the reference's bit for bit.  QR and SVD of the small
core are ``torch.linalg`` calls (LAPACK on the CPU, cuSOLVER on the card);
their column signs differ from XLA's, which is harmless: callers use
``U``/``Vt`` only through products and squared norms.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import prng

__all__ = ["randomized_svd", "randomized_range_finder"]


def randomized_range_finder(key: torch.Tensor, A: torch.Tensor, size: int,
                            n_iter: int = 1) -> torch.Tensor:
    """Orthonormal ``Q (..., l, size)`` with ``A ~= Q Q^T A``."""
    omega = prng.normal(key, (A.shape[-1], size)).to(A.dtype)
    Q = torch.linalg.qr(A @ omega).Q
    for _ in range(n_iter):                          # power iterations
        Z = torch.linalg.qr(A.mT @ Q).Q
        Q = torch.linalg.qr(A @ Z).Q
    return Q


def randomized_svd(key: torch.Tensor, A: torch.Tensor, rank: int,
                   n_oversample: int = 8, n_iter: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Truncated rSVD: ``(U (..., l, rank), S (..., rank), Vt (..., rank, m))``."""
    l, m = A.shape[-2:]
    size = min(rank + n_oversample, m, l)
    A32 = A.float()
    Q = randomized_range_finder(key, A32, size, n_iter)
    Ub, S, Vt = torch.linalg.svd(Q.mT @ A32, full_matrices=False)
    U = Q @ Ub
    return (U[..., :rank].to(A.dtype), S[..., :rank].to(A.dtype),
            Vt[..., :rank, :].to(A.dtype))
