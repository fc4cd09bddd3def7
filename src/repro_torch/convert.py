"""Convert the JAX reference's parameter pytree into the port's parameters.

``params_from_jax`` takes the reference's nested dict of arrays (after
``jax.device_get``, so plain numpy) and returns the port's flat
``{path: tensor}`` dict, keyed by the same ``/``-joined paths the
compression policy uses (``"layers/attn_wq"``, ``"embed"``, ...).  The
layouts already agree, so no array is transposed.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["params_from_jax"]


def params_from_jax(tree: Any, device="cuda", prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a nested dict of numpy arrays into ``{path: tensor}`` on
    ``device`` (the card unless the caller asks for the CPU)."""
    out: Dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        path = f"{prefix}{name}"
        if isinstance(node, dict):
            out.update(params_from_jax(node, device, prefix=f"{path}/"))
        else:
            out[path] = torch.from_numpy(np.array(node)).to(device)
    return out
