"""Communication accounting and the counted device-to-host fetch.

Port of ``repro/core/metrics.py``.  Totals accumulate as exact Python-int
bits (``charge_uplink_bits``); the byte views divide by 8 on read.  Every
blocking device-to-host transfer of the round loop goes through
:func:`host_fetch`, which counts it: the loop engine makes one per round
plus one per eval, the fused engine one per chunk plus one per eval.  A
fetch may be started early (:func:`start_fetch`) and waited on later.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

__all__ = ["CommLedger", "bytes_h", "PendingFetch", "host_fetch", "start_fetch", "host_sync_count",
           "reset_host_sync_count", "count_collective", "collective_count",
           "reset_collective_count"]

_HOST_SYNCS = 0
_COLLECTIVES = 0


class PendingFetch(NamedTuple):
    """A device-to-host copy in flight: ``host`` is filled once ``done``
    (an event after the copy on the card; ``None`` for a CPU tensor, which
    is already on the host) has completed."""

    host: torch.Tensor
    done: Optional[torch.cuda.Event]


def start_fetch(x: torch.Tensor) -> PendingFetch:
    """Start copying ``x`` to the host without waiting for the device: on
    the card into pinned memory, behind an event on the current stream.
    :func:`host_fetch` of the result waits for the copy alone (not for work
    issued after it) and counts the sync."""
    if not x.is_cuda:
        return PendingFetch(x.detach(), None)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return PendingFetch(host, done)


def host_fetch(x: Union[torch.Tensor, PendingFetch]) -> np.ndarray:
    """Copy a tensor to host numpy (one ``.cpu()``), or wait for a started
    fetch, counting the sync."""
    global _HOST_SYNCS
    _HOST_SYNCS += 1
    if isinstance(x, PendingFetch):
        if x.done is not None:
            x.done.synchronize()
        return x.host.numpy()
    return x.detach().cpu().numpy()


def host_sync_count() -> int:
    return _HOST_SYNCS


def reset_host_sync_count() -> None:
    global _HOST_SYNCS
    _HOST_SYNCS = 0


def count_collective() -> None:
    """Count one cross-rank collective (``launch/sharding.FLRoundSpecs``)."""
    global _COLLECTIVES
    _COLLECTIVES += 1


def collective_count() -> int:
    return _COLLECTIVES


def reset_collective_count() -> None:
    global _COLLECTIVES
    _COLLECTIVES = 0


def bytes_h(b: float) -> str:
    """Human-readable bytes."""
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024.0 or unit == "TB":
            return f"{b:.3f} {unit}"
        b /= 1024.0
    return f"{b:.3f} TB"


@dataclass
class CommLedger:
    uplink_bits: int = 0
    downlink_bits: int = 0
    per_round_uplink_bits: List[int] = field(default_factory=list)
    per_group_bits: Dict[str, int] = field(default_factory=dict)

    def begin_round(self) -> None:
        self.per_round_uplink_bits.append(0)

    def charge_uplink_bits(self, bits: int, group: str = "_",
                           round_idx: int | None = None) -> None:
        """Charge exact integer ``bits`` of uplink, to round ``round_idx``
        (default: the round begun last)."""
        bits = int(bits)
        self.uplink_bits += bits
        if round_idx is not None:
            if not 0 <= round_idx < len(self.per_round_uplink_bits):
                raise IndexError(
                    f"charge_uplink round_idx={round_idx} but only "
                    f"{len(self.per_round_uplink_bits)} rounds begun")
            self.per_round_uplink_bits[round_idx] += bits
        elif self.per_round_uplink_bits:
            self.per_round_uplink_bits[-1] += bits
        self.per_group_bits[group] = self.per_group_bits.get(group, 0) + bits

    def charge_downlink_bits(self, bits: int) -> None:
        self.downlink_bits += int(bits)

    @property
    def uplink_total(self) -> float:
        return self.uplink_bits / 8

    @property
    def downlink_total(self) -> float:
        return self.downlink_bits / 8

    @property
    def per_round_uplink(self) -> List[float]:
        return [b / 8 for b in self.per_round_uplink_bits]

    @property
    def per_group(self) -> Dict[str, float]:
        return {g: b / 8 for g, b in self.per_group_bits.items()}

    @property
    def rounds(self) -> int:
        return len(self.per_round_uplink_bits)

    def summary(self) -> str:
        """The reference's summary: totals, rounds, per-group uplink."""
        lines = [
            f"uplink total   : {bytes_h(self.uplink_total)}",
            f"downlink total : {bytes_h(self.downlink_total)}",
            f"rounds         : {self.rounds}",
        ]
        if self.per_group:
            lines.append("per-group uplink:")
            for g, b in sorted(self.per_group.items(), key=lambda kv: -kv[1]):
                lines.append(f"  {g:40s} {bytes_h(b)}")
        return "\n".join(lines)
