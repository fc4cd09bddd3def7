"""GradESTC compressor / decompressor (paper Algorithms 1 and 2).

Port of ``repro/core/gradestc.py``: the rank-padded, branch-free
:func:`compress_step` with a traced candidate count ``d``, the
reconstruction ``Ghat = M A`` and Formula 13.  Everything is written over
leading stack axes (the reference vmaps one layer's step over L): ``G`` is
``(..., l, m)``, the state's basis ``(..., l, k)``, its key ``(..., 2)`` and
its init flag ``(...)``.

The projection ``A = M^T G, E = G - M A`` and the reconstruction go through
``kernels.ops`` (the CUDA kernels on the card, the plain versions on the
CPU).  The rSVD, the top-k replacement and the stats are plain torch ops.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..kernels import ops
from . import prng
from .rsvd import randomized_svd

__all__ = ["CompressorState", "Payload", "CompressStats", "compress_step",
           "reconstruct", "next_candidate_count", "payload_scalars"]


class CompressorState(NamedTuple):
    """Client-side state for one compressed group (leading stack axes)."""

    M: torch.Tensor            # (..., l, k) orthonormal basis
    key: torch.Tensor          # (..., 2) threefry key for the rSVD
    initialized: torch.Tensor  # (...) bool


class Payload(NamedTuple):
    """What crosses the uplink for one group in one round."""

    replaced_mask: torch.Tensor  # (..., k) bool -- True where M[:, j] is replaced
    new_vectors: torch.Tensor    # (..., d_max, l) entering vectors, rank order
    coeffs: torch.Tensor         # (..., k, m) updated coefficients A*
    d_r: torch.Tensor            # (...) int32 number of valid replacement vectors
    init: torch.Tensor           # (...) bool -- True on the initialization round


class CompressStats(NamedTuple):
    d_r: torch.Tensor            # (...) int32
    recon_err: torch.Tensor      # (...) relative Frobenius reconstruction error
    energy_kept: torch.Tensor    # (...) ||M M^T G||_F^2 / ||G||_F^2


def _stats(G: torch.Tensor, Ghat: torch.Tensor, d_r: torch.Tensor) -> CompressStats:
    gnorm = (G.float() ** 2).sum(dim=(-2, -1))
    err = ((G - Ghat).float() ** 2).sum(dim=(-2, -1))
    safe = gnorm.clamp_min(1e-30)
    return CompressStats(d_r=d_r.to(torch.int32), recon_err=torch.sqrt(err / safe),
                         energy_kept=1.0 - err / safe)


def compress_step(
    state: CompressorState, G: torch.Tensor, *, k: int, d,
    d_max: int | None = None, wire_dtype: str = "f32",
) -> Tuple[CompressorState, Payload, CompressStats]:
    """Rank-padded compression step with a traced ``d`` (an int or a 0-dim
    integer tensor).

    The rSVD sketch always runs at ``d_max`` (default ``k``); candidates at
    index ``>= d`` score ``-inf`` and can never enter.  An uninitialized
    layer projects against the zero basis (``A = 0``, ``E = G`` exactly),
    scores its old columns ``-inf`` and sketches at full capacity, so the
    init round takes this same path.  Top-k membership keeps index order on
    ties (old vectors first), like ``jax.lax.top_k``.  ``wire_dtype`` ("f32",
    "bf16" or "int8") is the coefficient wire ``A_new`` ships through
    (``ops.coeff_roundtrip``; int8 runs the coeff_quant kernel on the card).
    """
    l, m = G.shape[-2:]
    d_max = k if d_max is None else d_max
    dev = G.device
    keys = prng.split(state.key, 2)
    key, sub = keys[..., 0, :], keys[..., 1, :]
    init = ~state.initialized
    M = torch.where(init[..., None, None], torch.zeros_like(state.M), state.M)

    # --- spatial projection onto the carried-over basis (Formulas 4 + 6)
    A, E = ops.encode(M.contiguous(), G)

    # --- rank-padded candidates: always sketch at d_max, mask the tail
    d_eff = torch.where(init, d_max, d)
    Me, Se, Vte = randomized_svd(sub, E, rank=d_max)       # (..., l, d_max)
    Ae = Se[..., :, None] * Vte                             # (..., d_max, m)

    R_old = torch.where(init[..., None], float("-inf"), (A.float() ** 2).sum(-1))
    valid = torch.arange(d_max, device=dev) < d_eff[..., None]
    R_new = torch.where(valid, (Ae.float() ** 2).sum(-1), float("-inf"))
    R = torch.cat([R_old, R_new], dim=-1)                   # (..., k + d_max)

    top_idx = torch.sort(R, dim=-1, descending=True, stable=True).indices[..., :k]
    in_top = torch.zeros(R.shape, dtype=torch.bool, device=dev)
    in_top.scatter_(-1, top_idx, True)
    replaced = ~in_top[..., :k]                             # old columns leaving
    entering = in_top[..., k:]                              # candidates entering
    d_r = entering.sum(-1).to(torch.int32)

    # pair the i-th replaced slot with the i-th entering candidate
    repl_rank = torch.cumsum(replaced.to(torch.int32), -1) - 1
    enter_order = torch.argsort((~entering).to(torch.int32), dim=-1, stable=True)
    src = torch.gather(enter_order, -1, repl_rank.clamp(0, d_max - 1).long())
    Me_src = torch.gather(Me, -1, src[..., None, :].expand(*src.shape[:-1], l, k))
    Ae_src = torch.gather(Ae, -2, src[..., :, None].expand(*src.shape[:-1], k, m))
    M_new = torch.where(replaced[..., None, :], Me_src, M)
    A_new = torch.where(replaced[..., :, None], Ae_src, A)
    # the coefficient wire (bf16 / int8) applies after replacement; client
    # and server both use the shipped value, so the payload, the stats and
    # the reconstruction see it
    A_new = ops.coeff_roundtrip(A_new, wire_dtype)

    # wire buffer: entering vectors packed in rank order, zero padded; the
    # non-entering rows land in a spare row d_max that is cut off
    enter_rank = torch.cumsum(entering.to(torch.int32), -1) - 1
    rows = torch.where(entering, enter_rank, d_max).long()
    buf = torch.zeros(*M.shape[:-2], d_max + 1, l, dtype=M.dtype, device=dev)
    buf.scatter_(-2, rows[..., None].expand(*rows.shape, l), Me.mT.to(M.dtype))

    payload = Payload(replaced_mask=replaced, new_vectors=buf[..., :d_max, :],
                      coeffs=A_new, d_r=d_r, init=init)
    new_state = CompressorState(M=M_new, key=key,
                                initialized=torch.ones_like(state.initialized))
    # the stats product mirrors the reference (a plain GEMM beside decode)
    return new_state, payload, _stats(G, M_new @ A_new, d_r)


def reconstruct(M: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Ghat = M A (Alg. 2 line 2) through the decode kernel."""
    return ops.decode(M.contiguous(), A.contiguous())


def next_candidate_count(d_r: torch.Tensor, k: int, alpha: float = 1.3,
                         beta: float = 1.0) -> torch.Tensor:
    """Formula 13 on the device: ``d* = clip(ceil(alpha*d_r + beta), 1, k)``
    in f32 arithmetic, as the reference's ``next_candidate_count_jax`` (the
    Python scalars are rounded to f32 by the ops)."""
    d = torch.ceil(alpha * d_r.float() + beta)
    return d.to(torch.int32).clamp(1, k)


def payload_scalars(payload: Payload, *, l: int, m: int, k: int,
                    bytes_per_el: int = 4) -> torch.Tensor:
    """Formula 14: init ``k*l + k*m``; update ``k*m + d_r*l + d_r``."""
    init_cost = k * l + k * m
    upd_cost = k * m + payload.d_r.long() * l + payload.d_r.long()
    return torch.where(payload.init, init_cost, upd_cost) * bytes_per_el
