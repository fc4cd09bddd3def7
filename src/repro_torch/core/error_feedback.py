"""Error-feedback memory (paper Sec. VI, listed as future work).

Port of ``repro/core/error_feedback.py``.  The client accumulates the
compression residual and adds it back before the next compression::

    c_t    = Compress(g_t + m_t)
    m_t+1  = g_t + m_t - Decompress(c_t)

For GradESTC the residual is the fitting error in the segmented ``(l, m)``
layout.  A beyond-paper extension, off by default (``gradestc-ef``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["EFState", "ef_inject", "ef_update"]


class EFState(NamedTuple):
    memory: torch.Tensor    # same shape as the segmented gradient matrix G

    @staticmethod
    def init(l: int, m: int, device="cuda") -> "EFState":
        return EFState(memory=torch.zeros((l, m), dtype=torch.float32, device=device))


def ef_inject(state: EFState, G: torch.Tensor, decay: float = 1.0) -> torch.Tensor:
    """Gradient handed to the compressor: G + decayed residual memory."""
    return G + decay * state.memory.to(G.dtype)


def ef_update(state: EFState, G_injected: torch.Tensor, Ghat: torch.Tensor) -> EFState:
    """Store the new residual (the compressor's fitting error)."""
    return EFState(memory=(G_injected - Ghat).to(state.memory.dtype))
