"""Synthetic language-modeling task with controllable client heterogeneity.

Numpy copy of ``repro/data/synthetic.py``: a hidden first-order Markov chain
over the vocabulary generates token streams, each client reweighted by its
class prior (IID or Dirichlet(alpha)).  Token blocks are bit-identical to
the reference's for the same ``(seed, client)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np

from .partition import dirichlet_client_priors, iid_client_priors

__all__ = ["SyntheticLMTask", "make_task", "client_batch_stream"]


@dataclass
class SyntheticLMTask:
    vocab: int
    n_classes: int
    n_clients: int
    trans: np.ndarray           # (V, V) row-stochastic transition matrix
    client_priors: np.ndarray   # (C, n_classes)
    class_of: np.ndarray        # (V,) class id of each token

    def chain_cdf(self, prior: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-prior sampling tables: (row-wise transition CDF, start dist)."""
        w = prior[self.class_of]                       # (V,)
        trans_w = self.trans * w[None, :]
        trans_w /= trans_w.sum(axis=1, keepdims=True)
        return np.cumsum(trans_w, axis=1), w / w.sum()

    def sample_tokens(
        self, rng: np.random.Generator, batch: int, seq: int, prior: np.ndarray,
        tables: Tuple[np.ndarray, np.ndarray] | None = None,
    ) -> np.ndarray:
        """Sample (batch, seq+1) token ids biased by a class prior."""
        cdf, p0 = self.chain_cdf(prior) if tables is None else tables
        x = np.empty((batch, seq + 1), np.int64)
        x[:, 0] = rng.choice(self.vocab, size=batch, p=p0)
        u = rng.random((batch, seq))
        for t in range(seq):
            rows = cdf[x[:, t]]
            x[:, t + 1] = (u[:, t : t + 1] < rows).argmax(axis=1)
        return x


def make_task(
    vocab: int = 256,
    n_classes: int = 8,
    n_clients: int = 10,
    alpha: float | None = None,     # None -> IID
    seed: int = 0,
    concentration: float = 6.0,
) -> SyntheticLMTask:
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(vocab, vocab))
    top = np.argpartition(-logits, 8, axis=1)[:, :8]
    boost = np.zeros_like(logits)
    np.put_along_axis(boost, top, concentration, axis=1)
    trans = np.exp(logits * 0.3 + boost)
    trans /= trans.sum(axis=1, keepdims=True)

    class_of = rng.integers(0, n_classes, size=vocab)
    if alpha is None:
        priors = iid_client_priors(n_clients, n_classes)
    else:
        priors = dirichlet_client_priors(n_clients, n_classes, alpha, rng)
    return SyntheticLMTask(
        vocab=vocab, n_classes=n_classes, n_clients=n_clients,
        trans=trans, client_priors=priors, class_of=class_of,
    )


def client_batch_stream(
    task: SyntheticLMTask, client: int, batch: int, seq: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite stream of host-numpy {tokens, labels} for one client
    (-1 = eval/uniform).  ``hash`` of an int tuple does not depend on
    PYTHONHASHSEED, so the stream is the reference's."""
    rng = np.random.default_rng(hash((seed, client)) % (2**31))
    prior = (
        np.ones(task.n_classes) / task.n_classes
        if client < 0 else task.client_priors[client]
    )
    tables = task.chain_cdf(prior)
    while True:
        x = task.sample_tokens(rng, batch, seq, prior, tables)
        yield {
            "tokens": np.asarray(x[:, :-1], np.int32),
            "labels": np.asarray(x[:, 1:], np.int32),
        }
