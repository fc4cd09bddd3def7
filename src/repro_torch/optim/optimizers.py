"""SGD (+momentum) and AdamW as (init, update) pairs over ``{path: tensor}``
dicts.

Port of ``repro/optim/optimizers.py``.  ``update(grads, state, params) ->
(new_params, new_state)``; the learning rate is a float or a callable
step -> lr (a schedule of :mod:`.schedules`).  Updates run in f32 and cast
back to each parameter's dtype, as in the reference.

``sgd(lr)`` with a float lr and no momentum is the FL clients' optimizer,
which the fused engine runs under ``torch.func.vmap``: its state keeps a
Python-int step and its update is one closure over the dict, with no branch
on the state.  Momentum, Adam's moments and a callable lr keep the step as a
0-dim int32 tensor on the parameters' device, as the reference does.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

__all__ = ["OptState", "sgd", "adam"]

Params = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: Any                       # int (plain SGD) or a 0-dim int32 tensor
    slots: Any                      # optimizer-specific dict(s) or None


def _lr_at(lr, step: torch.Tensor):
    """The step's learning rate: a callable's f32 tensor, or a float kept as
    a Python scalar (the op rounds it to f32, with no device copy)."""
    return lr(step) if callable(lr) else float(lr)


def _step0(params: Params) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` in ``like``'s dtype as a 0-dim host tensor: the reference's
    weak-typed scalar, rounded to the operand's dtype, with no device copy."""
    return torch.tensor(x, dtype=like.dtype)


def sgd(lr, momentum: float = 0.0, nesterov: bool = False):
    """Plain / momentum SGD: ``p <- p - lr * g`` (``v <- momentum v + g``)."""
    if not momentum and not callable(lr):
        return _plain_sgd(float(lr))

    def init(params: Params) -> OptState:
        slots = {n: torch.zeros_like(p) for n, p in params.items()} if momentum else None
        return OptState(step=_step0(params), slots=slots)

    def update(grads: Params, state: OptState, params: Params) -> Tuple[Params, OptState]:
        step_lr = _lr_at(lr, state.step)
        vel = None
        if momentum:
            vel = {n: _scalar(momentum, v) * v + grads[n] for n, v in state.slots.items()}
            eff = ({n: _scalar(momentum, v) * v + grads[n] for n, v in vel.items()}
                   if nesterov else vel)
        else:
            eff = grads
        new = {n: (p.float() - step_lr * eff[n].float()).to(p.dtype) for n, p in params.items()}
        return new, OptState(step=state.step + 1, slots=vel)

    return init, update


def _plain_sgd(lr: float):
    """The FL clients' SGD: a Python-int step, no slots, one f32 update."""

    def init(params: Params) -> OptState:
        return OptState(step=0, slots=None)

    def update(grads: Params, state: OptState, params: Params) -> Tuple[Params, OptState]:
        new = {}
        for name, p in params.items():
            # a Python scalar: the op rounds it to f32, with no device copy
            new[name] = (p.float() - lr * grads[name].float()).to(p.dtype)
        return new, OptState(step=state.step + 1, slots=None)

    return init, update


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0):
    """AdamW (decoupled weight decay when weight_decay > 0).

    Moments are stored in f32 regardless of parameter dtype.  The bias
    corrections are f32 tensors on the device, so their divisions are true
    divisions on the card too."""

    def init(params: Params) -> OptState:
        zeros = lambda: {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for n, p in params.items()}
        return OptState(step=_step0(params), slots=(zeros(), zeros()))

    def update(grads: Params, state: OptState, params: Params) -> Tuple[Params, OptState]:
        m, v = state.slots
        t = state.step + 1
        step_lr = _lr_at(lr, state.step)
        m = {n: b1 * a + (1 - b1) * grads[n].float() for n, a in m.items()}
        v = {n: b2 * a + (1 - b2) * torch.square(grads[n].float()) for n, a in v.items()}
        tf = t.float()
        bc1 = 1 - torch.pow(b1, tf)
        bc2 = 1 - torch.pow(b2, tf)

        def upd(p, mi, vi):
            u = (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p.float() - step_lr * u).to(p.dtype)

        new = {n: upd(p, m[n], v[n]) for n, p in params.items()}
        return new, OptState(step=t, slots=(m, v))

    return init, update
