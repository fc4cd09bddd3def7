"""Convert the JAX reference's parameter pytree into the port's parameters.

``params_from_jax`` takes the reference's nested dict of arrays (after
``jax.device_get``, so plain numpy) and returns the port's flat
``{path: tensor}`` dict, keyed by the same ``/``-joined paths the
compression policy uses (``"layers/attn_wq"``, ``"embed"``, and nested
ones such as ``"dec/cross/wq"``).  The layouts already agree, so no array
is transposed, and each keeps its dtype: an f32 leaf of a bf16 model (an
MoE router, RG-LRU's ``lru_lambda``) stays f32.  A bf16 array (numpy's
``ml_dtypes.bfloat16``) comes across bit for bit, through its 16-bit
pattern.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["params_from_jax"]


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":      # torch cannot read ml_dtypes' bf16
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(tree: Any, device="cuda", prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a nested dict of numpy arrays into ``{path: tensor}`` on
    ``device`` (the card unless the caller asks for the CPU)."""
    out: Dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        path = f"{prefix}{name}"
        if isinstance(node, dict):
            out.update(params_from_jax(node, device, prefix=f"{path}/"))
        else:
            out[path] = _tensor(np.array(node)).to(device)
    return out
