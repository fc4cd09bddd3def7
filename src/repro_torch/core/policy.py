"""Per-layer compression policy: which groups to compress, with what (k, l).

Port of ``repro/core/policy.py`` (host-side, no tensors).  Only
*parameter-dominant* groups are compressed (the paper's Sec. I / V-A.b
rule): the largest groups until ``coverage_target`` of all parameters is
covered, skipping embeddings, norms, biases, routers and small tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Mapping, Tuple

from .reshaping import choose_segment_length

__all__ = ["LayerPlan", "CompressionPolicy", "make_policy"]


@dataclass(frozen=True)
class LayerPlan:
    """Compression plan for one (stacked) parameter group."""

    name: str
    shape: Tuple[int, ...]       # per-layer tensor shape (without stack axis)
    stack: int                   # number of stacked layers sharing this plan
    l: int                       # segment length (rows of G)
    m: int                       # columns of G
    k: int                       # retained basis vectors
    compress: bool               # False -> transmitted raw

    @property
    def n(self) -> int:
        return math.prod(self.shape)

    @property
    def d_max(self) -> int:
        """Capacity of the rank-padded candidate buffers: Formula 13 clamps
        ``d`` at ``k``."""
        return self.k

    @property
    def raw_scalars(self) -> int:
        return self.n * self.stack


@dataclass
class CompressionPolicy:
    plans: Dict[str, LayerPlan] = field(default_factory=dict)
    min_params_to_compress: int = 65536
    coverage_target: float = 0.90


def _default_k(n: int, l: int) -> int:
    """k << l, capped at 64 and rounded down to a power of two."""
    m = n // l
    k = max(4, min(l // 8, m // 4, 64))
    return 1 << (k.bit_length() - 1) if k & (k - 1) else k


#: Name fragments never compressed.
DEFAULT_EXCLUDE = ("embed", "norm", "bias", "router", "scale", "ln_", "head")


def make_policy(
    param_shapes: Mapping[str, Tuple[Tuple[int, ...], int]],
    overrides: Mapping[str, Tuple[int, int]] | None = None,
    coverage_target: float = 0.90,
    min_params: int = 65536,
    exclude: Tuple[str, ...] = DEFAULT_EXCLUDE,
) -> CompressionPolicy:
    """Policy from ``{group_name: (per_layer_shape, stack)}``; ``overrides``
    maps a group name to ``(k, l)``."""
    overrides = dict(overrides or {})
    totals = {name: math.prod(shape) * stack
              for name, (shape, stack) in param_shapes.items()}
    grand = sum(totals.values()) or 1
    order = sorted(totals, key=totals.get, reverse=True)

    plans: Dict[str, LayerPlan] = {}
    covered = 0
    for name in order:
        shape, stack = param_shapes[name]
        n = math.prod(shape)
        excluded = any(frag in name.lower() for frag in exclude)
        want = (covered / grand < coverage_target and n >= min_params
                and len(shape) >= 2 and not excluded)
        if name in overrides:
            k, l = overrides[name]
            want = True
        elif want:
            l = choose_segment_length(shape)
            k = _default_k(n, l)
        else:
            trailing = max(1, int(shape[-1]))
            l, k = (trailing if n % trailing == 0 else 1), 0
        if want:
            covered += totals[name]
        plans[name] = LayerPlan(
            name=name, shape=tuple(int(s) for s in shape), stack=stack,
            l=l, m=n // l, k=k, compress=bool(want),
        )
    return CompressionPolicy(plans=plans, coverage_target=coverage_target,
                             min_params_to_compress=min_params)
