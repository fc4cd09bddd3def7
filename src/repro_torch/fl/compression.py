"""Uplink compression methods as thin shells over the stateless codecs.

Port of ``repro/fl/compression.py``: ``fedavg``, ``topk``, ``signsgd``,
``fedpaq``, ``fedqclip``, ``svdfed`` and ``gradestc`` with its ablations
(``gradestc-first``, ``-all``, ``-k``) and error feedback
(``gradestc-ef``).  A method is host-side configuration that builds one
codec per compressed group; :func:`build_downlink_codecs` builds the
server's GradESTC codecs of the compressed broadcast;
:class:`RoundAccountant` turns a round's packed int32 stats row into exact
integer-bit ledger charges, uplink and downlink.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.codecs import (Codec, EFCodec, FedPAQCodec, FedQClipCodec, GradESTCCodec,
                           SignSGDCodec, SVDFedCodec, TopKCodec)
from ..core.policy import CompressionPolicy, LayerPlan

__all__ = ["make_method", "path_index", "build_codecs", "build_downlink_codecs",
           "apply_downlink", "pack_round_stats", "RoundAccountant", "FedAvgMethod", "TopKMethod",
           "GradESTCMethod", "SVDFedMethod", "SignSGDMethod", "FedPAQMethod",
           "FedQClipMethod"]


def path_index(policy: CompressionPolicy) -> Dict[str, int]:
    """Stable group-name -> int map (sorted order) for PRNG key derivation."""
    return {name: i for i, name in enumerate(sorted(policy.plans))}


class _MethodShell:
    """Host-side method config; ``build_codec`` returns ``None`` for a
    group that ships raw.  ``use_pallas`` is the run's resolved kernel
    switch (it picks FedPAQ's and FedQClip's wire)."""

    name = "?"

    def __init__(self, seed: int = 0, **_):
        self.seed = seed

    def build_codec(self, path: str, plan: LayerPlan, path_idx: int,
                    use_pallas: bool = False) -> Optional[Codec]:
        raise NotImplementedError


class FedAvgMethod(_MethodShell):
    """Uncompressed reference: every group ships raw."""

    name = "fedavg"

    def build_codec(self, path, plan, path_idx, use_pallas=False):
        return None


class TopKMethod(_MethodShell):
    """Magnitude top-k with an error memory, every group."""

    name = "topk"

    def __init__(self, frac: float = 0.1, **kw):
        super().__init__(**kw)
        self.frac = frac

    def build_codec(self, path, plan, path_idx, use_pallas=False):
        return TopKCodec(plan.raw_scalars, frac=self.frac, path_idx=path_idx)


class SignSGDMethod(_MethodShell):
    """1-bit signs and a mean-|g| scale for every group (signSGD)."""

    name = "signsgd"

    def build_codec(self, path, plan, path_idx, use_pallas=False):
        return SignSGDCodec(plan.raw_scalars, path_idx=path_idx)


class FedPAQMethod(_MethodShell):
    """Stochastic uniform quantization of every group (FedPAQ)."""

    name = "fedpaq"

    def __init__(self, bits: int = 8, **kw):
        super().__init__(**kw)
        self.bits = bits

    def build_codec(self, path, plan, path_idx, use_pallas=False):
        return FedPAQCodec(plan.raw_scalars, bits=self.bits, path_idx=path_idx,
                           use_pallas=use_pallas)


class FedQClipMethod(_MethodShell):
    """Clipped and quantized updates of every group (FedQClip)."""

    name = "fedqclip"

    def __init__(self, clip: float = 100.0, bits: int = 8, **kw):
        super().__init__(**kw)
        self.clip = clip
        self.bits = bits

    def build_codec(self, path, plan, path_idx, use_pallas=False):
        return FedQClipCodec(plan.raw_scalars, clip=self.clip, bits=self.bits,
                             path_idx=path_idx, use_pallas=use_pallas)


class SVDFedMethod(_MethodShell):
    """Shared server-fit basis, coefficient uplink between refits (SVDFed)."""

    name = "svdfed"

    def __init__(self, policy: CompressionPolicy, gamma: float = 8.0,
                 wire_dtype: str = "f32", **kw):
        super().__init__(**kw)
        self.policy = policy
        self.gamma = gamma
        # explicit, not swallowed by **kw: a dropped wire_dtype would charge
        # f32 bits for a wire the caller believed was int8
        self.wire_dtype = wire_dtype

    def build_codec(self, path, plan, path_idx, use_pallas=False):
        if not plan.compress:
            return None
        return SVDFedCodec(plan, gamma=self.gamma, seed=self.seed,
                           path_idx=path_idx, wire_dtype=self.wire_dtype)


class GradESTCMethod(_MethodShell):
    """The paper's method: ``variant`` in {full, first, all, k} (Table IV
    ablations), ``ef`` error feedback (beyond-paper); f32, bf16 or int8
    coefficient wire."""

    name = "gradestc"

    def __init__(self, policy: CompressionPolicy, variant: str = "full",
                 alpha: float = 1.3, beta: float = 1.0, ef: bool = False,
                 wire_dtype: str = "f32", **kw):
        if variant not in ("full", "first", "all", "k"):
            raise ValueError(f"GradESTC variant={variant!r}; expected full, first, all or k")
        super().__init__(**kw)
        self.policy = policy
        self.variant = variant
        self.alpha, self.beta = alpha, beta
        self.ef = ef
        self.wire_dtype = wire_dtype

    def build_codec(self, path, plan, path_idx, use_pallas=False):
        if not plan.compress:
            return None
        codec = GradESTCCodec(plan, seed=self.seed, path_idx=path_idx,
                              variant=self.variant, alpha=self.alpha,
                              beta=self.beta, wire_dtype=self.wire_dtype)
        if self.ef:
            codec = EFCodec(codec, (plan.stack, plan.l, plan.m))
        return codec


def make_method(name: str, policy: Optional[CompressionPolicy] = None, **kw):
    name = name.lower()
    if name == "fedavg":
        return FedAvgMethod(**kw)
    flat = {"topk": TopKMethod, "signsgd": SignSGDMethod, "fedpaq": FedPAQMethod,
            "fedqclip": FedQClipMethod}
    if name in flat:
        return flat[name](**kw)
    if name == "svdfed" or name.startswith("gradestc"):
        if policy is None:
            raise ValueError(f"{name} needs a compression policy")
        if name == "svdfed":
            return SVDFedMethod(policy, **kw)
        # gradestc, gradestc-ef, or gradestc-<variant>
        suffix = name.split("-", 1)[1] if "-" in name else ""
        if suffix == "ef":
            return GradESTCMethod(policy, ef=True, **kw)
        return GradESTCMethod(policy, variant=suffix or "full", **kw)
    raise ValueError(f"unknown method {name!r}")


def build_codecs(method, policy: CompressionPolicy, group_paths,
                 use_pallas: bool = False) -> Dict[str, Codec]:
    """One codec per compressed group; paths absent from the result ship raw."""
    pidx = path_index(policy)
    out: Dict[str, Codec] = {}
    for path in group_paths:
        codec = method.build_codec(path, policy.plans[path], pidx[path], use_pallas)
        if codec is not None:
            out[path] = codec
    return out


def build_downlink_codecs(policy: CompressionPolicy, group_paths, seed: int,
                          use_pallas: bool = False) -> Dict[str, Codec]:
    """The server's GradESTC codecs compressing the broadcast
    (``FLConfig.downlink_compress``): one 'client', ``SERVER_CLIENT_ID``,
    seeded apart from the uplink codecs."""
    method = make_method("gradestc", policy=policy, seed=seed + 101)
    return build_codecs(method, policy, group_paths, use_pallas)


def apply_downlink(dl_codecs: Dict[str, Codec], dl_state, dl_shared,
                   avg: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The compressed downlink, once a round: the server encodes each
    group's server-lr-scaled average through its one instance
    (``SERVER_CLIENT_ID``); every client mirrors the shared decompressor, so
    the server applies the *reconstruction*.  ``avg``, ``dl_state`` and
    ``dl_shared`` are updated in place; returns the reduced stats by group."""
    dl_reds: Dict[str, torch.Tensor] = {}
    for path, dlc in dl_codecs.items():
        dl_state[path], rw, stats = dlc.encode(dl_state[path], dl_shared[path], None,
                                               dlc.to_wire(avg[path]))
        dl_reds[path] = dlc.reduce_stats(stats[None])
        dl_shared[path] = dlc.update_shared(dl_shared[path], dl_reds[path], rw)
        avg[path] = dlc.from_wire(rw, avg[path].shape).to(avg[path].dtype)
    return dl_reds


def pack_round_stats(reds: Dict[str, torch.Tensor], dl_reds: Dict[str, torch.Tensor],
                     device="cuda") -> torch.Tensor:
    """The round's packed int32 stats vector: reduced stats per sorted
    uplink path, then per sorted downlink path; a stats-free round ships one
    placeholder."""
    parts = [reds[p] for p in sorted(reds)] + [dl_reds[p] for p in sorted(dl_reds)]
    if parts and sum(int(p.numel()) for p in parts):
        return torch.cat(parts)
    return torch.zeros((1,), dtype=torch.int32, device=device)


class RoundAccountant:
    """Host half of the codec protocol: charges one round's packed stats row
    to the ledger in exact integer bits.  With ``downlink_enabled`` the
    broadcast to each selected client is the raw groups plus each downlink
    codec's charge for its one server instance; otherwise the raw model."""

    def __init__(self, codecs: Dict[str, Codec], dl_codecs: Dict[str, Codec],
                 policy: CompressionPolicy, group_paths, n_sel: int,
                 downlink_enabled: bool = False):
        self.codecs = {p: codecs[p] for p in sorted(codecs)}
        self.dl_codecs = {p: dl_codecs[p] for p in sorted(dl_codecs)}
        self.n_sel = n_sel
        self.downlink_enabled = downlink_enabled
        self.metrics: Dict[str, int] = {}
        self.raw_scalars_per_client = sum(
            policy.plans[p].raw_scalars for p in group_paths if p not in codecs)
        self.model_scalars = sum(policy.plans[p].raw_scalars for p in group_paths)
        self.dl_raw_scalars = sum(
            policy.plans[p].raw_scalars for p in group_paths if p not in dl_codecs)
        self.packed_len = (sum(c.stats_len for c in self.codecs.values())
                           + sum(c.stats_len for c in self.dl_codecs.values()))

    def consume(self, packed: np.ndarray, ledger, rnd: int) -> None:
        """Charge the ledger for round ``rnd`` from its fetched stats row."""
        packed = np.asarray(packed).reshape(-1)
        expected = max(self.packed_len, 1)
        if packed.size != expected:
            raise ValueError(
                f"packed stats layout drift: got {packed.size} entries, "
                f"expected {expected}")
        off = 0
        bits = 32 * self.raw_scalars_per_client * self.n_sel
        for codec in self.codecs.values():
            red = packed[off: off + codec.stats_len]
            off += codec.stats_len
            bits += codec.charge_bits(red, self.n_sel)
            for k, v in codec.host_metrics(red, self.n_sel).items():
                self.metrics[k] = self.metrics.get(k, 0) + v
        ledger.charge_uplink_bits(bits, group=f"round{rnd}", round_idx=rnd)
        if not self.downlink_enabled:
            ledger.charge_downlink_bits(32 * self.model_scalars * self.n_sel)
            return
        dbits = 32 * self.dl_raw_scalars
        for codec in self.dl_codecs.values():
            red = packed[off: off + codec.stats_len]
            off += codec.stats_len
            dbits += codec.charge_bits(red, 1)
        ledger.charge_downlink_bits(dbits * self.n_sel)
