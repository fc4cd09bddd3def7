"""Sharding rules of the FL round over a mesh of ranks.

Port of ``repro/launch/sharding.py`` as far as the sharded fused engine
needs it: :class:`MeshPlan` (which mesh axes enumerate clients and which
carry tensor parallelism, and the ``huge`` regime), :func:`axis_size`,
:func:`make_plan`, and :class:`FLRoundSpecs`, the engine's view of the
mesh -- how many shards the selected clients split over, how the client
axis is padded, this rank's lanes of a ``(K, C_pad, ...)`` block, and the
two collectives of a round on the ``"data"`` group, each counted
(``metrics.collective_count``).  The parameter, batch and cache specs
serve ``launch/steps.py`` and wait for it (ROADMAP A13).

The collectives take the tensors where they lie: NCCL on the cards; gloo
on the CPU, and gloo over tensors on a card too (two ranks sharing one
card), which copies them through host memory on its own threads and
waits for the device there.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..core import metrics
from ..models import model
from ..models.config import ArchConfig
from .mesh import FLMesh

__all__ = ["MeshPlan", "make_plan", "axis_size", "FLRoundSpecs"]

#: per-replica bf16 bytes above which clients can no longer hold replicas on
#: a 16-chip group (4 copies live during an FL round: global, client, delta,
#: grads; budget ~12 GB of 16 GB HBM).
_HUGE_BYTES = 12 * 1024**3 / 4

# torch 2.13 names the tensor all-gather all_gather_single and keeps
# all_gather_into_tensor as a deprecated alias; older versions have only it
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def axis_size(mesh: FLMesh, name: str) -> int:
    return mesh.size(name) if name in mesh.mesh_dim_names else 1


class MeshPlan:
    """Resolved axis assignment for one (arch, mesh) pair."""

    def __init__(self, mesh: FLMesh, cfg: ArchConfig):
        self.mesh = mesh
        self.cfg = cfg
        self.axes = tuple(mesh.mesh_dim_names)
        n_params = sum(
            int(torch.Size(shape).numel()) * stack
            for shape, stack in model.param_group_shapes(cfg).values()
        )
        self.param_bytes = 2 * n_params
        self.huge = self.param_bytes > _HUGE_BYTES * axis_size(mesh, "model")
        if self.huge:
            # 2-D weight sharding: one dim of every layer matrix over
            # "model", a second over "data"; clients are whole pods
            self.tp_axes: Tuple[str, ...] = ("model",)
            self.second_axes: Tuple[str, ...] = ("data",)
            self.flat_tp_axes: Tuple[str, ...] = ("data", "model")
            self.client_axes: Tuple[str, ...] = ("pod",) if "pod" in self.axes else ()
            self.inner_batch_axes: Tuple[str, ...] = ("data",)
        else:
            self.tp_axes = ("model",)
            self.second_axes = ()
            self.flat_tp_axes = ("model",)
            self.client_axes = tuple(a for a in ("pod", "data") if a in self.axes)
            #: batch axes of per-client batches: neither client nor tp axes
            self.inner_batch_axes = tuple(
                a for a in self.axes
                if a not in self.client_axes and a not in self.tp_axes
            )
        #: batch axes for serving (no client axis)
        self.serve_batch_axes = tuple(a for a in self.axes if a != "model")

    @property
    def n_clients(self) -> int:
        n = 1
        for a in self.client_axes:
            n *= axis_size(self.mesh, a)
        return max(n, 1)

    def tp_size(self) -> int:
        n = 1
        for a in self.tp_axes:
            n *= axis_size(self.mesh, a)
        return n

    def shard_dim(self, size: int, axes: Tuple[str, ...]):
        """``axes`` if ``size`` divides evenly over them, else None."""
        total = 1
        for a in axes:
            total *= axis_size(self.mesh, a)
        return axes if size % total == 0 and total > 1 else None


def make_plan(mesh: FLMesh, cfg: ArchConfig) -> MeshPlan:
    return MeshPlan(mesh, cfg)


class FLRoundSpecs:
    """The sharded fused round's view of the mesh (DESIGN.md Sec. 10).

    The selected clients of a round, padded to :meth:`pad_clients`, split
    into ``n_shards`` contiguous blocks of lanes, one a rank in rank order;
    params, codec shared state and the per-client state store stay whole
    on every rank.  A round's cross-rank traffic is :meth:`all_reduce_sum`
    of the masked reconstruction sums and :meth:`all_gather_rows` of the
    per-lane int32 rows."""

    def __init__(self, plan: MeshPlan):
        self.plan = plan
        self.mesh = plan.mesh
        cl = plan.client_axes
        if not cl:
            raise ValueError(f"mesh {self.mesh.mesh_dim_names} has no client axes for FL "
                             "(need 'data' and/or 'pod')")
        if plan.inner_batch_axes:
            raise ValueError(f"mesh {self.mesh.mesh_dim_names}: non-client batch axes "
                             f"{plan.inner_batch_axes} are not supported for the sharded FL "
                             "round (use make_fl_mesh)")
        if len(cl) > 1:
            raise ValueError(f"mesh {self.mesh.mesh_dim_names}: the port's FL round shards "
                             "clients over 'data' alone")
        self.client_axis_name = cl[0]
        #: the collectives' process group (None on one rank)
        self.group = self.mesh.get_group(self.client_axis_name)
        self.rank = self.mesh.get_local_rank(self.client_axis_name)
        self.backend = dist.get_backend(self.group) if self.group is not None else None

    @property
    def n_shards(self) -> int:
        return self.plan.n_clients     # product of client-axis sizes

    def pad_clients(self, n_sel: int) -> int:
        """Selected-client axis padded up to a multiple of the shard count."""
        s = self.n_shards
        return -(-n_sel // s) * s

    def lanes(self, c_pad: int) -> slice:
        """This rank's contiguous lanes of a padded client axis."""
        c_loc = c_pad // self.n_shards
        return slice(self.rank * c_loc, (self.rank + 1) * c_loc)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; returns ``x``."""
        metrics.count_collective()
        if self.group is None:
            return x
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(c_loc, W)`` rows stacked in rank order ->
        ``(n_shards * c_loc, W)``."""
        metrics.count_collective()
        if self.group is None:
            return rows
        shape = (self.n_shards * rows.shape[0],) + tuple(rows.shape[1:])
        out = torch.empty(shape, dtype=rows.dtype, device=rows.device)
        _all_gather(out, rows.contiguous(), group=self.group)
        return out

