"""Plain SGD as an (init, update) pair over ``{path: tensor}`` dicts.

Port of ``repro/optim/optimizers.py::sgd`` without momentum (the FL
clients' optimizer).  The update runs in f32 and casts back to each
parameter's dtype, as in the reference.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

__all__ = ["OptState", "sgd"]

Params = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: int
    slots: None


def sgd(lr: float):
    """Plain SGD: ``p <- p - lr * g``."""

    def init(params: Params) -> OptState:
        return OptState(step=0, slots=None)

    def update(grads: Params, state: OptState, params: Params) -> Tuple[Params, OptState]:
        new = {}
        for name, p in params.items():
            # a Python scalar: the op rounds it to f32, with no device copy
            new[name] = (p.float() - lr * grads[name].float()).to(p.dtype)
        return new, OptState(step=state.step + 1, slots=None)

    return init, update
