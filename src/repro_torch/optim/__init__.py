"""Optimizers and LR schedules over ``{path: tensor}`` dicts.

FedAvg's client optimizer is plain SGD (paper Sec. IV); Adam and the
schedules serve centralized training and ablations, as in the reference.
"""

from .optimizers import OptState, adam, sgd
from .schedules import constant, cosine_decay, linear_warmup

__all__ = ["OptState", "sgd", "adam", "constant", "cosine_decay", "linear_warmup"]
