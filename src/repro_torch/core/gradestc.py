"""GradESTC compressor / decompressor (paper Algorithms 1 and 2).

Port of ``repro/core/gradestc.py``: the rank-padded, branch-free
:func:`compress_step` with a traced candidate count ``d``, the
reconstruction ``Ghat = M A``, Formula 13 (the reference's
``next_candidate_count_jax``; its bucketed host rule for static-``d``
callers is not ported) and the standalone Alg. 1/Alg. 2 API
(:func:`init_compressor`, :func:`compress_init`, :func:`compress_update`,
:func:`compress`, :func:`decompress`, :func:`apply_payload`).  Everything
is written over leading stack axes (the reference vmaps one layer's step
over L): ``G`` is ``(..., l, m)``, the state's basis ``(..., l, k)``, its
key ``(..., 2)`` and its init flag ``(...)``.

``compress_init`` and ``compress_update`` are :func:`compress_step` on a
state forced uninitialized or initialized, with ``d_max`` the static ``d``:
the sketch runs at the same rank as the reference's, and the init path
projects against the zero basis (``E = G`` exactly), so both take the
encode kernel on the card like the codec does.

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

__all__ = ["CompressorState", "DecompressorState", "Payload", "CompressStats",
           "init_compressor", "compress_init", "compress_update", "compress_step",
           "compress", "decompress", "apply_payload", "reconstruct",
           "next_candidate_count", "payload_scalars"]


class CompressorState(NamedTuple):
    """Client-side state for one compressed group (leading stack axes)."""

    M: torch.Tensor            # (..., l, k) orthonormal basis
    key: torch.Tensor          # (..., 2) threefry key for the rSVD
    initialized: torch.Tensor  # (...) bool


class DecompressorState(NamedTuple):
    """Server-side mirror of the basis."""

    M: torch.Tensor            # (..., l, k)


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


def init_compressor(l: int, k: int, key: torch.Tensor,
                    dtype=torch.float32) -> CompressorState:
    """A fresh state: zero basis, the given key ``(..., 2)``, not
    initialized.  Leading axes of ``key`` become the state's stack axes."""
    lead = key.shape[:-1]
    return CompressorState(M=torch.zeros(*lead, l, k, dtype=dtype, device=key.device),
                           key=key,
                           initialized=torch.zeros(lead, dtype=torch.bool, device=key.device))


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


def _with_init(state: CompressorState, flag: bool) -> CompressorState:
    return state._replace(initialized=torch.full_like(state.initialized, flag))


def compress_init(state: CompressorState, G: torch.Tensor, *, k: int
                  ) -> Tuple[CompressorState, Payload, CompressStats]:
    """First-round compression (Alg. 1 lines 2-8): the basis is the rank-k
    rSVD of G, and all k vectors ship."""
    return compress_step(_with_init(state, False), G, k=k, d=k, d_max=k)


def compress_update(state: CompressorState, G: torch.Tensor, *, k: int, d: int
                    ) -> Tuple[CompressorState, Payload, CompressStats]:
    """Steady-state compression (Alg. 1 lines 9-29) with a static ``d``
    candidates from the fitting error.  The state's ``initialized`` flag
    comes back as it came in, as in the reference."""
    st2, payload, stats = compress_step(_with_init(state, True), G, k=k, d=d, d_max=d)
    return st2._replace(initialized=state.initialized), payload, stats


def compress(state: CompressorState, G: torch.Tensor, *, k: int, d: int
             ) -> Tuple[CompressorState, Payload, CompressStats, torch.Tensor]:
    """Init or update by ``state.initialized``, chosen on the device: both
    run and :func:`torch.where` selects (a Python branch on the flag would
    sync the host).  The init payload's ``new_vectors`` is cut or padded to
    the update's ``(d, l)``.  Returns ``(state, payload, stats, basis)``,
    ``basis`` the updated M."""
    l = G.shape[-2]
    si, pi, ti = compress_init(state, G, k=k)
    su, pu, tu = compress_update(state, G, k=k, d=d)
    nv = torch.zeros(*pi.new_vectors.shape[:-2], d, l, dtype=pi.new_vectors.dtype,
                     device=G.device)
    nv[..., :min(d, k), :] = pi.new_vectors[..., :min(d, k), :]
    pi = pi._replace(new_vectors=nv)
    upd = state.initialized

    def pick(a, b):
        return torch.where(upd.reshape(upd.shape + (1,) * (a.dim() - upd.dim())), a, b)

    new_state = CompressorState(*(pick(a, b) for a, b in zip(su, si)))
    payload = Payload(*(pick(a, b) for a, b in zip(pu, pi)))
    stats = CompressStats(*(pick(a, b) for a, b in zip(tu, ti)))
    return new_state, payload, stats, new_state.M


def decompress(state: DecompressorState, payload: Payload,
               init_basis: torch.Tensor | None = None
               ) -> Tuple[DecompressorState, torch.Tensor]:
    """Server side (Alg. 2): mirror the basis from the payload (the i-th
    replaced column takes the i-th entering vector), then reconstruct Ghat
    through the decode kernel.  ``init_basis`` replaces the mirrored basis
    where ``payload.init``."""
    M = state.M
    d, l = payload.new_vectors.shape[-2:]
    repl_rank = torch.cumsum(payload.replaced_mask.to(torch.int32), -1) - 1
    src = repl_rank.clamp(0, d - 1).long()
    cols = torch.gather(payload.new_vectors, -2,
                        src[..., :, None].expand(*src.shape, l)).mT     # (..., l, k)
    M_upd = torch.where(payload.replaced_mask[..., None, :], cols, M)
    if init_basis is not None:
        M_upd = torch.where(payload.init[..., None, None], init_basis, M_upd)
    return DecompressorState(M=M_upd), reconstruct(M_upd, payload.coeffs)


def apply_payload(state: DecompressorState, payload: Payload) -> DecompressorState:
    return decompress(state, payload)[0]


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
