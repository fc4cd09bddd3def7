"""Stateless codec protocol: GradESTC behind the reference's codec contract.

Port of ``repro/core/codecs.py``: the ``Codec`` base, the flat ``(n,)``
layout of the per-tensor baselines with ``TopKCodec``, ``SignSGDCodec``,
``FedPAQCodec`` and ``FedQClipCodec``, the ``(L, l, m)`` matrix wire
layout, the f32/bf16/int8 coefficient wires, ``GradESTCCodec`` (variants
``full``, ``first``, ``all`` and ``k``), ``SVDFedCodec`` and the
error-feedback wrapper ``EFCodec``.  A codec owns its wire layout
(``to_wire``/``from_wire``) and per-client state, and ``encode`` returns
the new state, the server-side reconstruction in wire layout and a small
int32 stats vector -- the only thing the host ever reads.  ``charge_bits``
turns the reduced stats into exact Python-int uplink bits (Formula 14).

Client state is a flat tuple of tensors with a leading client axis (``()``
for a stateless codec): the loop engine indexes and writes back each of
them per client, the fused engine gathers and scatters the round's
selected clients, so a wrapper appends its tensors to the inner codec's
tuple rather than nesting it.  ``encode_clients`` is ``encode`` over a
leading client axis (the reference's ``vmap`` of ``encode``): the matrix
codecs' ``encode`` is written over leading axes, so one call serves all
the clients; the flat codecs' kernels take one flat vector with one scale,
so their ``encode_clients`` loops over the clients.

PRNG streams are ``fold_in`` chains (:mod:`repro_torch.core.prng`), the
reference's exactly: the quantizers draw from :func:`round_base_key`
folded with the client id and the group index (``Codec.per_client_key``),
GradESTC's bases from :func:`client_layer_keys`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..kernels import ops
from . import baselines as bl
from . import gradestc as ge
from . import prng
from .policy import LayerPlan
from .rsvd import randomized_svd

__all__ = ["Codec", "EFCodec", "TopKCodec", "SignSGDCodec", "FedPAQCodec", "FedQClipCodec",
           "GradESTCCodec", "SVDFedCodec", "client_layer_keys", "round_base_key",
           "SERVER_CLIENT_ID"]

#: Client id of server-side (downlink) codec instances.
SERVER_CLIENT_ID = 0xFFFFFFFF


def client_layer_keys(seed: int, client: int, path_idx: int, L: int,
                      device="cuda") -> torch.Tensor:
    """Per-(client, group) rSVD key stack ``(L, 2)``, one key per layer."""
    base = prng.fold_in(prng.fold_in(prng.PRNGKey(seed, device), client & 0xFFFFFFFF),
                        path_idx)
    return prng.split(base, L)


def round_base_key(seed: int, rnd: int, device="cuda") -> torch.Tensor:
    """Per-round base for codec randomness (the FedPAQ/FedQClip draws),
    folded with the client id and group index by ``Codec.per_client_key``."""
    return prng.fold_in(prng.PRNGKey(seed + 0x5EED, device), rnd)


class Codec:
    """Contract for one parameter group's compressor."""

    client_stats_len: int = 0
    stats_len: int = 0
    #: whether ``encode`` draws from its ``key``; the engine derives the
    #: round's per-client keys only when some codec does
    draws: bool = False

    def __init__(self, path_idx: int = 0):
        self.path_idx = path_idx

    def per_client_key(self, base_key: torch.Tensor, client) -> torch.Tensor:
        """The (round, client, group) draw key: ``client`` is an int or an
        integer tensor on the key's device (one key per element)."""
        return prng.fold_in(prng.fold_in(base_key, client), self.path_idx)

    def init_client_state(self, n_clients: int, device="cuda", client_ids=None):
        """Per-client state on a leading client axis; ``client_ids`` (default
        ``range(n_clients)``) names the clients where the state depends on
        them (the downlink's one server instance is ``SERVER_CLIENT_ID``)."""
        return ()

    def init_shared_state(self, device="cuda"):
        return ()

    def to_wire(self, delta: torch.Tensor) -> torch.Tensor:
        return delta

    def to_wire_clients(self, delta: torch.Tensor) -> torch.Tensor:
        """``to_wire`` of each client's delta ``(C, ...)`` -> ``(C, *wire)``."""
        return delta

    def from_wire(self, wire: torch.Tensor, shape) -> torch.Tensor:
        return wire.reshape(shape)

    def encode(self, cstate, shared, key, wire):
        """-> (cstate', recon_wire, stats int32 (client_stats_len,)).  ``key``
        is the client's draw key for the codecs that draw (``draws``);
        GradESTC draws from its state's keys, SVDFed and signSGD draw
        nothing, and the engines pass them ``None``."""
        raise NotImplementedError

    def encode_clients(self, cstate, shared, keys, wire):
        """``encode`` over a leading client axis: every state tensor, ``keys``
        (``(C, 2)`` or ``None``) and ``wire`` carry it -> (cstate', recon
        ``(C, *wire)``, stats ``(C, client_stats_len)``).  Here one
        ``encode`` per client; a codec whose ``encode`` takes leading axes
        makes it one call."""
        outs = [self.encode(tuple(x[i] for x in cstate), shared,
                            None if keys is None else keys[i], wire[i])
                for i in range(wire.shape[0])]
        cstate2 = tuple(torch.stack(xs) for xs in zip(*(o[0] for o in outs)))
        return (cstate2, torch.stack([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]))

    def reduce_stats(self, stats: torch.Tensor) -> torch.Tensor:
        return torch.zeros((0,), dtype=torch.int32, device=stats.device)

    def update_shared(self, shared, reduced_stats, mean_wire):
        return shared

    def charge_bits(self, reduced: np.ndarray, n_sel: int) -> int:
        raise NotImplementedError

    def host_metrics(self, reduced: np.ndarray, n_sel: int) -> Dict[str, int]:
        return {}


def _no_stats(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((0,), dtype=torch.int32, device=x.device)


class _FlatCodec(Codec):
    """Flat ``(n,)`` f32 layout of the per-tensor baselines, which compress
    every parameter group."""

    def __init__(self, n: int, path_idx: int = 0):
        super().__init__(path_idx)
        self.n = int(n)

    def to_wire(self, delta: torch.Tensor) -> torch.Tensor:
        return delta.reshape(-1).float()

    def to_wire_clients(self, delta: torch.Tensor) -> torch.Tensor:
        return delta.reshape(delta.shape[0], -1).float()


class TopKCodec(_FlatCodec):
    """Magnitude top-k with a per-client error memory: k values and k int32
    indices, ``2k * 32`` bits a client.  State: ``(memory (C, n),)``."""

    def __init__(self, n: int, frac: float = 0.1, path_idx: int = 0):
        super().__init__(n, path_idx)
        self.k = max(1, int(frac * self.n))

    def init_client_state(self, n_clients: int, device="cuda", client_ids=None):
        return (torch.zeros((n_clients, self.n), dtype=torch.float32, device=device),)

    def encode(self, cstate, shared, key, wire):
        st, ghat, _ = bl.topk_compress(bl.TopKState(*cstate), wire, self.k)
        return (st.memory,), ghat, _no_stats(wire)

    def charge_bits(self, reduced, n_sel):
        return 32 * 2 * self.k * n_sel


class SignSGDCodec(_FlatCodec):
    """1-bit sign wire with a mean-|g| scale (signSGD): ``n`` bits and one
    32-bit scale per client.  An exact zero ships as +scale.  The kernels
    and the plain versions are bit-exact, so the reference's ``use_pallas``
    switch has nothing to choose here; the device picks the path."""

    def encode(self, cstate, shared, key, wire):
        words, scale = ops.sign_wire(wire)
        return (), ops.sign_unwire(words, scale, self.n), _no_stats(wire)

    def charge_bits(self, reduced, n_sel):
        return (self.n + 32) * n_sel


class FedPAQCodec(_FlatCodec):
    """Stochastic uniform quantization (FedPAQ).  ``use_pallas=True``: the
    block-local wire (one 32-bit scale per ``block`` values; the kernels on
    the card); ``use_pallas=False``: the paper's global-max-abs quantizer
    (one scale; the CPU only).  Both ship ``n * bits`` code bits."""

    draws = True

    def __init__(self, n: int, bits: int = 8, path_idx: int = 0,
                 use_pallas: bool = False, block: int = 512):
        super().__init__(n, path_idx)
        self.bits = int(bits)
        self.use_pallas = bool(use_pallas)
        self.block = int(block)

    def _quantize(self, g, key):
        return ops.quantize_update(g, key, bits=self.bits, block=self.block,
                                   use_pallas=self.use_pallas)

    def encode(self, cstate, shared, key, wire):
        return (), self._quantize(wire, key), _no_stats(wire)

    @property
    def _n_scales(self) -> int:
        return -(-self.n // self.block) if self.use_pallas else 1

    def charge_bits(self, reduced, n_sel):
        return (self.n * self.bits + 32 * self._n_scales) * n_sel


class FedQClipCodec(FedPAQCodec):
    """Clipped and quantized updates (FedQClip): the update is scaled by
    ``min(1, clip / max(||g||, 1e-12))``, then shipped on FedPAQ's wire."""

    def __init__(self, n: int, clip: float = 100.0, bits: int = 8, path_idx: int = 0,
                 use_pallas: bool = False, block: int = 512):
        super().__init__(n, bits, path_idx, use_pallas, block)
        self.clip = float(clip)

    def encode(self, cstate, shared, key, wire):
        norm = torch.linalg.vector_norm(wire).clamp_min(1e-12)
        # a true division (python / tensor would multiply by a reciprocal)
        factor = torch.full_like(norm, self.clip).div(norm).clamp_max(1.0)
        return (), self._quantize(wire * factor, key), _no_stats(wire)


class _MatrixCodec(Codec):
    """Stacked ``(L, l, m)`` segment-matrix layout (columns = segments).
    ``encode`` works over leading axes of the client state and the wire
    (per-client reductions run over the last three axes), so
    ``encode_clients`` is one call of it."""

    def __init__(self, plan: LayerPlan, path_idx: int = 0):
        super().__init__(path_idx)
        self.plan = plan

    def _wire(self, delta: torch.Tensor, lead) -> torch.Tensor:
        plan = self.plan
        m = plan.n // plan.l
        return (delta.reshape(*lead, plan.stack, m, plan.l).transpose(-1, -2)
                .float().contiguous())

    def to_wire(self, delta: torch.Tensor) -> torch.Tensor:
        return self._wire(delta, ())

    def to_wire_clients(self, delta: torch.Tensor) -> torch.Tensor:
        return self._wire(delta, delta.shape[:1])

    def encode_clients(self, cstate, shared, keys, wire):
        return self.encode(cstate, shared, keys, wire)

    def from_wire(self, wire: torch.Tensor, shape) -> torch.Tensor:
        plan = self.plan
        return wire.transpose(-1, -2).reshape(plan.stack, plan.n).reshape(shape)


#: bits per coefficient entry for each coefficient wire format
_WIRE_DTYPE_BITS = {"f32": 32, "bf16": 16, "int8": 8}


def _coeff_wire_bits(wire_dtype: str, k: int, m: int) -> int:
    """Exact uplink bits for one (k, m) coefficient matrix on the wire."""
    bits = _WIRE_DTYPE_BITS[wire_dtype] * k * m
    if wire_dtype == "int8":
        bits += 32 * k * (-(-m // 512))
    return bits


def _check_wire_dtype(wire_dtype: str) -> None:
    if wire_dtype not in ops.WIRE_DTYPES:
        raise ValueError(f"wire_dtype={wire_dtype!r}; expected one of {ops.WIRE_DTYPES}")


class SVDFedCodec(_MatrixCodec):
    """Globally shared per-group basis (SVDFed), round-granular refits.

    The shared state is ``(M (L, l, k), key (2,), refit ())``: the server's
    basis, the key of its refits and whether this round is a refit round.
    Clients upload coefficients ``A = M^T G`` between refits; a refit round
    ships raw G from every client and the server refits M from the mean.
    If any client's relative fitting error exceeds ``gamma`` percent, the
    next round is a refit round; round 0 is one (M starts at zero).

    ``wire_dtype`` "int8" runs the fused encode_quant / decode_wire kernels
    on the card (the residual is against the shipped coefficients); "f32"
    and "bf16" are two GEMMs around ``ops.coeff_roundtrip``.  Stats per
    client: ``[is_refit_round, wants_refit_next]``, max-reduced.  Over a
    client axis the int8 kernels take the shared M broadcast to every
    client's rows (a copy of C x (L, l, k), small beside the (C, L, l, m)
    wire they read), so each launches once per group and round.
    """

    client_stats_len = 2
    stats_len = 2

    def __init__(self, plan: LayerPlan, gamma: float = 8.0, seed: int = 0,
                 path_idx: int = 0, wire_dtype: str = "f32"):
        _check_wire_dtype(wire_dtype)
        super().__init__(plan, path_idx)
        self.gamma = float(gamma)
        self.seed = int(seed)
        self.wire_dtype = wire_dtype

    def init_shared_state(self, device="cuda"):
        plan = self.plan
        key = prng.fold_in(prng.PRNGKey(self.seed + 17, device), self.path_idx)
        return (torch.zeros((plan.stack, plan.l, plan.k), dtype=torch.float32, device=device),
                key, torch.ones((), dtype=torch.bool, device=device))

    def encode(self, cstate, shared, key, wire):
        M, _, refit = shared
        per_client = (-3, -2, -1)
        if self.wire_dtype == "int8":
            Mc = M.expand(*wire.shape[:-1], M.shape[-1]).contiguous()
            codes, scales, E = ops.encode_quant(Mc, wire)
            Ghat = ops.decode_wire(Mc, codes, scales)
            err = (E.float() ** 2).sum(per_client)
        else:
            A = ops.coeff_roundtrip(M.mT @ wire, self.wire_dtype)
            Ghat = M @ A
            err = ((wire - Ghat).float() ** 2).sum(per_client)
        recon = torch.where(refit, wire, Ghat)
        den = (wire.float() ** 2).sum(per_client).clamp_min(1e-30)
        want = ~refit & (err > (self.gamma / 100.0) ** 2 * den)
        return (), recon, torch.stack([refit.expand_as(want), want], -1).to(torch.int32)

    def reduce_stats(self, stats: torch.Tensor) -> torch.Tensor:
        return stats.amax(0).to(torch.int32)

    def update_shared(self, shared, reduced_stats, mean_wire):
        # the reference refits under lax.cond on the device flag; here the fit
        # runs every round and is selected on the device, so the flag never
        # reaches the host.  The key advances every round either way.
        M, key, refit = shared
        key2, sub = prng.split(key, 2).unbind(-2)
        fit = randomized_svd(prng.split(sub, self.plan.stack), mean_wire,
                             rank=self.plan.k)[0]
        return torch.where(refit, fit, M), key2, reduced_stats[1] > 0

    def charge_bits(self, reduced, n_sel):
        plan = self.plan
        if int(reduced[0]):                       # refit round: raw uplink
            return 32 * plan.raw_scalars * n_sel
        return _coeff_wire_bits(self.wire_dtype, plan.k, plan.m) * plan.stack * n_sel


class GradESTCCodec(_MatrixCodec):
    """The paper's spatio-temporal compressor, rank-padded (coefficient
    wire f32, bf16 or int8).  ``variant``: ``full`` (the paper's), or the
    Table IV ablations ``first`` (the first round's basis stays: no
    candidate ever enters), ``all`` (every round re-initializes) and ``k``
    (a fixed ``d = k``).

    Per-client state: basis stack ``(L, l, k)``, rSVD keys ``(L, 2)``, init
    flags ``(L,)``; the engine stacks them on a leading client axis.  The
    Formula-13 candidate count ``d`` is a 0-dim int32 tensor in the shared
    state, advanced on the device by :meth:`update_shared`.

    Stats per client: ``[max d_r over updating layers, #updating layers,
    sum d_r, d used]``, reduced across clients to ``[drmax, n_upd, sum_dr,
    d]``.
    """

    client_stats_len = 4
    stats_len = 4

    def __init__(self, plan: LayerPlan, seed: int = 0, path_idx: int = 0,
                 variant: str = "full", alpha: float = 1.3, beta: float = 1.0,
                 wire_dtype: str = "f32"):
        if variant not in ("full", "first", "all", "k"):
            raise ValueError(f"GradESTC variant={variant!r}; expected full, first, all or k")
        _check_wire_dtype(wire_dtype)
        super().__init__(plan, path_idx)
        self.seed = int(seed)
        self.variant = variant
        self.alpha, self.beta = float(alpha), float(beta)
        self.wire_dtype = wire_dtype

    def init_client_state(self, n_clients: int, device="cuda", client_ids=None):
        plan = self.plan
        L, l, k = plan.stack, plan.l, plan.k
        ids = range(n_clients) if client_ids is None else client_ids
        keys = torch.stack([client_layer_keys(self.seed, int(c), self.path_idx, L, device)
                            for c in ids])
        return (torch.zeros((n_clients, L, l, k), dtype=torch.float32, device=device),
                keys,
                torch.zeros((n_clients, L), dtype=torch.bool, device=device))

    def init_shared_state(self, device="cuda"):
        k = self.plan.k
        d0 = k if self.variant == "k" else max(1, k // 4)
        return torch.full((), d0, dtype=torch.int32, device=device)

    def _round_d(self, shared: torch.Tensor) -> torch.Tensor:
        """The candidate count updating layers use this round (on the
        device).  ``first`` masks every candidate (d = 0), but the rank-d_max
        sketch still runs, as in the reference: only its uplink and sum_d
        are what the ablation compares."""
        if self.variant == "first":
            return torch.zeros_like(shared)
        if self.variant == "k":
            return torch.full_like(shared, self.plan.k)
        return shared

    def encode(self, cstate, shared, key, wire):
        plan = self.plan
        M, keys, inited = cstate
        d = self._round_d(shared)
        if self.variant == "all":          # re-initialize every round
            inited = torch.zeros_like(inited)
        st2, payload, stats = ge.compress_step(
            ge.CompressorState(M=M, key=keys, initialized=inited), wire,
            k=plan.k, d=d, d_max=plan.d_max, wire_dtype=self.wire_dtype)
        Ghat = ge.reconstruct(st2.M, payload.coeffs)
        # d_r on update branches only; inits are counted through n_upd; each
        # reduces over the layer axis alone (a client axis stays)
        upd_dr = torch.where(payload.init, 0, stats.d_r).to(torch.int32)
        out_stats = torch.stack([
            upd_dr.amax(-1), (~payload.init).sum(-1), upd_dr.sum(-1),
            d.expand(upd_dr.shape[:-1]),
        ], -1).to(torch.int32)
        return (st2.M, st2.key, torch.ones_like(inited)), Ghat, out_stats

    def reduce_stats(self, stats: torch.Tensor) -> torch.Tensor:
        return torch.stack([stats[:, 0].max(), stats[:, 1].sum(),
                            stats[:, 2].sum(), stats[:, 3].max()]).to(torch.int32)

    def update_shared(self, shared, reduced_stats, mean_wire):
        if self.variant != "full":         # d fixed for the ablations
            return shared
        drmax, n_upd = reduced_stats[0], reduced_stats[1]
        d2 = ge.next_candidate_count(drmax, self.plan.k, self.alpha, self.beta)
        # init-only rounds (n_upd == 0) carry d forward unchanged
        return torch.where(n_upd > 0, d2, shared).to(torch.int32)

    def charge_bits(self, reduced, n_sel):
        plan = self.plan
        n_upd, sum_dr = int(reduced[1]), int(reduced[2])
        n_init = n_sel * plan.stack - n_upd
        coeff = _coeff_wire_bits(self.wire_dtype, plan.k, plan.m)
        return (n_init * (32 * plan.k * plan.l + coeff)
                + n_upd * coeff
                + 32 * sum_dr * (plan.l + 1))

    def host_metrics(self, reduced, n_sel):
        # every init pays a rank-k sketch, every update a rank-d one (d is
        # spent only by full and k)
        n_upd = int(reduced[1])
        n_init = n_sel * self.plan.stack - n_upd
        inc = self.plan.k * n_init
        if self.variant in ("full", "k"):
            inc += int(reduced[3]) * n_upd
        return {"sum_d": inc}


class EFCodec(Codec):
    """Error-feedback wrapper (``gradestc-ef``): a per-client memory of the
    compression residual in wire layout, re-injected before the inner
    encode.  State: the inner codec's tuple, then the memory ``(C,
    *mem_shape)``."""

    def __init__(self, inner: Codec, mem_shape):
        super().__init__(inner.path_idx)
        self.inner = inner
        self.mem_shape = tuple(int(s) for s in mem_shape)
        self.client_stats_len = inner.client_stats_len
        self.stats_len = inner.stats_len
        self.draws = inner.draws

    def init_client_state(self, n_clients: int, device="cuda", client_ids=None):
        mem = torch.zeros((n_clients,) + self.mem_shape, dtype=torch.float32, device=device)
        return (*self.inner.init_client_state(n_clients, device, client_ids), mem)

    def init_shared_state(self, device="cuda"):
        return self.inner.init_shared_state(device)

    def to_wire(self, delta):
        return self.inner.to_wire(delta)

    def to_wire_clients(self, delta):
        return self.inner.to_wire_clients(delta)

    def from_wire(self, wire, shape):
        return self.inner.from_wire(wire, shape)

    def _feedback(self, inner_encode, cstate, shared, key, wire):
        *inner_st, mem = cstate
        injected = wire + mem
        inner_st2, recon, stats = inner_encode(tuple(inner_st), shared, key, injected)
        return (*inner_st2, injected - recon), recon, stats

    def encode(self, cstate, shared, key, wire):
        return self._feedback(self.inner.encode, cstate, shared, key, wire)

    def encode_clients(self, cstate, shared, keys, wire):
        return self._feedback(self.inner.encode_clients, cstate, shared, keys, wire)

    def reduce_stats(self, stats):
        return self.inner.reduce_stats(stats)

    def update_shared(self, shared, reduced_stats, mean_wire):
        return self.inner.update_shared(shared, reduced_stats, mean_wire)

    def charge_bits(self, reduced, n_sel):
        return self.inner.charge_bits(reduced, n_sel)

    def host_metrics(self, reduced, n_sel):
        return self.inner.host_metrics(reduced, n_sel)
