"""Federated data partitioning: IID and Dirichlet(alpha) client priors.

Numpy copy of ``repro/data/partition.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import numpy as np

__all__ = ["iid_client_priors", "dirichlet_client_priors"]


def iid_client_priors(n_clients: int, n_classes: int) -> np.ndarray:
    return np.full((n_clients, n_classes), 1.0 / n_classes)


def dirichlet_client_priors(
    n_clients: int, n_classes: int, alpha: float,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    p = rng.dirichlet([alpha] * n_classes, size=n_clients)
    # guard against degenerate all-zero classes for tiny alpha
    return (p + 1e-6) / (p + 1e-6).sum(axis=1, keepdims=True)
