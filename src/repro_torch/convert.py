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

``ge_state_from_jax`` turns the reference's ``GEState`` of the production
round step (its bases ``M`` and threefry ``keys``, as numpy) into the
port's: keys become int64 tensors holding the two uint32 words.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["params_from_jax", "ge_state_from_jax"]


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


def ge_state_from_jax(state: Any, device="cuda"):
    """The reference's ``launch.steps.GEState`` (``M`` {group: (C, L, l,
    k)}, ``keys`` {group: (C, L, 2)} uint32; numpy after
    ``jax.device_get``) as the port's ``GEState`` on ``device``."""
    from .launch.steps import GEState

    return GEState(
        M={k: _tensor(np.array(v)).to(device) for k, v in state.M.items()},
        keys={k: torch.from_numpy(np.array(v).astype(np.int64)).to(device)
              for k, v in state.keys.items()})
