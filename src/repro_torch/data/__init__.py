"""Data pipeline: synthetic LM streams + federated (IID / Dirichlet) priors."""

from .partition import dirichlet_client_priors, iid_client_priors
from .synthetic import SyntheticLMTask, client_batch_stream, make_task

__all__ = [
    "SyntheticLMTask", "make_task", "client_batch_stream",
    "dirichlet_client_priors", "iid_client_priors",
]
