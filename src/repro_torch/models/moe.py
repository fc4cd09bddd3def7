"""Mixture-of-Experts FFN with top-k routing (granite-moe, dbrx).

Port of ``repro/models/moe.py``: GShard-style capacity dispatch written as
einsums over one-hot tensors.  Tokens go in groups of ``moe_group``; each
group builds an (S_g, E, C) dispatch one-hot with per-expert capacity
C = ceil(S_g * top_k * capacity_factor / E), and the tokens past an
expert's capacity fall back to the residual stream.  The groups are a
leading batch axis (the reference vmaps over them).

Everything is plain torch, as the reference runs MoE outside any Pallas
kernel.  No op reads a value back to the host (no ``.item()``, ``nonzero``,
boolean indexing or ``F.one_hot``, whose range check reads its input): the
fused engine runs local training under ``torch.func.vmap`` over clients,
and on the card a read would sync.

Routing follows the reference's integers exactly:

- the top-k experts come from a stable descending sort of the router
  probabilities, so among equal probabilities the lower expert index comes
  first, as ``jax.lax.top_k`` orders them (``torch.topk`` promises no
  order among ties, and the order sets the capacity priority below);
- each (token, choice)'s slot is its count among earlier claims on the
  same expert in choice-major order (all first choices, then all second
  ones), and a slot at or past C keeps no row of the slot one-hot, as
  ``jax.nn.one_hot`` gives an all-zero row there.

The router runs in f32 in any model dtype; the one-hots are in the model
dtype.  The dispatch and combine products select single values exactly
only while TF32 is off (the card's callers turn it off:
``torch.backends.cuda.matmul.allow_tf32 = False``).  The router is left
out of GradESTC compression by name (``core/policy.DEFAULT_EXCLUDE``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..core import prng
from .config import ArchConfig
from .layers import _silu, scaled_normal

Params = Dict[str, torch.Tensor]

__all__ = ["MOE_GROUP", "init_moe_ffn", "moe_ffn", "router_load_balance_loss"]

#: tokens per dispatch group; keeps the (S_g, E, C) one-hot bounded.
MOE_GROUP = 4096


def init_moe_ffn(cfg: ArchConfig, key: torch.Tensor, L: int) -> Params:
    """The router (L, D, E) in f32 and the expert banks (L, E, D, F),
    (L, E, D, F), (L, E, F, D) in the model dtype, from ``split(key, 4)``
    as the reference draws them."""
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = getattr(torch, cfg.dtype)
    ks = prng.split(key, 4).unbind(0)
    s, sf = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F)
    return {
        "router": scaled_normal(ks[0], (L, D, E), torch.float32, mul=s),
        "moe_wgate": scaled_normal(ks[1], (L, E, D, F), dt, mul=s),
        "moe_win": scaled_normal(ks[2], (L, E, D, F), dt, mul=s),
        "moe_wout": scaled_normal(ks[3], (L, E, F, D), dt, mul=sf),
    }


def _onehot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)``: an all-zero row where idx is outside
    [0, n), by comparison on the device."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def capacity(cfg: ArchConfig, S: int) -> int:
    """Each expert's buffer in a group of S tokens."""
    return max(1, int(math.ceil(S * cfg.experts_per_tok * cfg.capacity_factor / cfg.n_experts)))


def route(cfg: ArchConfig, x: torch.Tensor,
          router: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routing of token groups x (..., S, D): (gate (..., S, K) f32,
    renormalized over the chosen experts; expert ids (..., S, K) int64 in
    descending probability; slot (..., S, K), the (token, choice)'s position
    in its expert's buffer; kept (..., S, K) bool, slot < C)."""
    S = x.shape[-2]
    E, K = cfg.n_experts, cfg.experts_per_tok
    probs = torch.softmax(x.float() @ router, dim=-1)                  # (..., S, E)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :K], order[..., :K]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    sel = _onehot(idx, E, torch.float32)                               # (..., S, K, E)
    # choice-major claim order: every token's first choice, then the second...
    selk = sel.transpose(-3, -2).reshape(*sel.shape[:-3], K * S, E)
    pos = (torch.cumsum(selk, dim=-2) - selk).reshape(*sel.shape[:-3], K, S, E)
    slot = (pos.transpose(-3, -2) * sel).sum(-1).to(torch.int32)        # (..., S, K)
    return gate, idx, slot, slot < capacity(cfg, S)


def _dispatch_one_group(cfg: ArchConfig, x: torch.Tensor, w: Params) -> torch.Tensor:
    """x: (..., S, D), one token group per leading index -> (..., S, D)
    expert-mixed output."""
    dt = x.dtype
    gate, idx, slot, kept = route(cfg, x, w["router"])
    slot_oh = _onehot(slot, capacity(cfg, x.shape[-2]), dt)           # (..., S, K, C)
    sel_kept = (_onehot(idx, cfg.n_experts, torch.float32) * kept[..., None]).to(dt)
    if cfg.moe_stop_gradient_dispatch:
        # routing indices carry no gradient; the gate's flows through ge_
        mask = torch.einsum("...ske,...skc->...sec", sel_kept, slot_oh).detach()
        dispatch = mask
        ge_ = torch.einsum("...ske,...sk->...se", sel_kept, gate.to(dt))
        combine = mask * ge_[..., None]
    else:
        dispatch = torch.einsum("...ske,...skc->...sec", sel_kept, slot_oh)
        combine = torch.einsum("...ske,...skc->...sec", sel_kept * gate[..., None].to(dt),
                               slot_oh)
    xe = torch.einsum("...sec,...sd->...ecd", dispatch, x)             # (..., E, C, D)
    h = _silu(xe @ w["moe_wgate"]) * (xe @ w["moe_win"])               # (..., E, C, F)
    ye = h @ w["moe_wout"]                                             # (..., E, C, D)
    return torch.einsum("...sec,...ecd->...sd", combine, ye)


def moe_ffn(cfg: ArchConfig, x: torch.Tensor, w: Params) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D), the B*S tokens in groups of ``moe_group``
    (or fewer: the largest size at most that which divides B*S)."""
    B, S, D = x.shape
    T = B * S
    g = min(cfg.moe_group or MOE_GROUP, T)
    while T % g:
        g -= 1
    return _dispatch_one_group(cfg, x.reshape(T // g, g, D), w).reshape(B, S, D)


def router_load_balance_loss(cfg: ArchConfig, x: torch.Tensor, w: Params) -> torch.Tensor:
    """Switch-style auxiliary load-balance loss: E * sum(importance * load)
    over the B*S tokens, in f32 (argmax takes the lower expert among ties,
    as jax's)."""
    T = x.shape[0] * x.shape[1]
    probs = torch.softmax(x.reshape(T, -1).float() @ w["router"], dim=-1)
    imp = probs.mean(0)
    load = _onehot(probs.argmax(-1), cfg.n_experts, torch.float32).mean(0)
    return cfg.n_experts * torch.sum(imp * load)
