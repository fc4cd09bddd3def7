"""Sharding rules of the FL round and the serve steps over a mesh of ranks.

Port of ``repro/launch/sharding.py``: :class:`MeshPlan` (which mesh axes
enumerate clients and which carry tensor parallelism, and the ``huge``
regime), :func:`axis_size`, :func:`make_plan`; the spec rules
:func:`param_specs` (roles ``train`` and ``serve``),
:func:`client_stacked_specs`, :func:`batch_specs` and :func:`cache_specs`;
and :class:`FLRoundSpecs`, the fused engine's view of the mesh -- how many
shards the selected clients split over, how the client axis is padded,
this rank's lanes of a ``(K, C_pad, ...)`` block, and the two collectives
of a round on the ``"data"`` group, each counted
(``metrics.collective_count``).

A spec is a tuple with one entry per dim, each entry ``None``, an axis
name or a tuple of names: the entries of the reference's
``PartitionSpec``.  The rules are host arithmetic on shapes and equal the
reference's exactly.  :func:`named` pairs a spec with its mesh; the dry
run divides a tensor's bytes by its :attr:`Named.shards`.  Executing a
spec that names ``"model"`` is not ported (ROADMAP A13): the production
step raises where ``"model"`` has more than one rank.

The collectives take the tensors where they lie: NCCL on the cards; gloo
on the CPU, and gloo over tensors on a card too (two ranks sharing one
card), which copies them through host memory on its own threads and
waits for the device there.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..core import metrics
from ..models import model
from ..models.config import ArchConfig
from .mesh import FLMesh

__all__ = ["MeshPlan", "make_plan", "param_specs", "client_stacked_specs", "batch_specs",
           "cache_specs", "named", "Named", "axis_size", "FLRoundSpecs", "I32_WORDS",
           "i32_words", "as_i32", "from_i32"]

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


class Named(NamedTuple):
    """A spec on its mesh (the reference's ``NamedSharding``)."""

    mesh: FLMesh
    spec: Tuple

    @property
    def shards(self) -> int:
        """How many pieces the spec cuts a tensor into: the product of the
        sizes of the axes it names."""
        n = 1
        for entry in self.spec:
            for a in entry if isinstance(entry, tuple) else (entry,):
                if a is not None:
                    n *= axis_size(self.mesh, a)
        return n


def named(mesh: FLMesh, spec: Tuple) -> Named:
    return Named(mesh, tuple(spec))


def _one(axes: Tuple[str, ...]):
    """A spec entry for ``axes``: the name alone, the tuple, or None."""
    return axes if len(axes) > 1 else (axes[0] if axes else None)


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------

def _matrix_spec(plan: MeshPlan, shape: Tuple[int, ...], prefer: int,
                 tp: Optional[Tuple[str, ...]] = None) -> Tuple:
    """Spec for a per-layer matrix: shard dim ``prefer`` over ``tp`` axes
    when divisible, else try the other matrix dims, else replicate."""
    nd = len(shape)
    tp = plan.tp_axes if tp is None else tp
    order = [prefer] + [i for i in range(nd) if i != prefer]
    for dim in order:
        if plan.shard_dim(shape[dim], tp):
            spec = [None] * nd
            spec[dim] = tp if len(tp) > 1 else tp[0]
            return tuple(spec)
    # fall back to model-only when the combined axes don't divide
    if len(tp) > 1:
        for dim in order:
            if plan.shard_dim(shape[dim], ("model",)):
                spec = [None] * nd
                spec[dim] = "model"
                return tuple(spec)
    return (None,) * nd


#: group-name fragment -> preferred shard dim index (within per-layer shape):
#: column-parallel for input projections, row-parallel for output
#: projections (megatron pattern); expert axis for MoE banks; vocab for
#: embeddings.
_PREFER_RULES = (
    ("moe_wgate", 0), ("moe_win", 0), ("moe_wout", 0),       # (E, D, F): E
    ("router", 1),
    ("attn_wq", 1), ("attn_wk", 1), ("attn_wv", 1), ("attn_wo", 0),
    ("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0),
    ("mlp_wgate", 1), ("mlp_win", 1), ("mlp_wout", 0),
    ("cm_wk", 1), ("cm_wv", 0), ("cm_wr", 1),
    ("tm_wr", 1), ("tm_wk", 1), ("tm_wv", 1), ("tm_wg", 1), ("tm_wo", 0),
    ("w_y", 1), ("w_x", 1), ("w_rg", 1), ("w_ig", 1), ("w_o", 0),
    ("embed", 0), ("head", 1), ("pos", 0),
)


def _prefer_for(name: str, shape: Tuple[int, ...]) -> int:
    for frag, dim in _PREFER_RULES:
        if frag in name:
            return min(dim, len(shape) - 1)
    return len(shape) - 1


_STACK_CONTAINERS = ("/layers/", "/rec/", "/attn/", "/enc/", "/dec/")


def _leaf_spec(plan: MeshPlan, path: str, shape: Tuple[int, ...], role: str) -> Tuple:
    """The spec of one parameter at ``path`` (``/``-led, as the
    reference's tree paths)."""
    under_stack = any(seg in path for seg in _STACK_CONTAINERS)
    if len(shape) <= 1 or (under_stack and len(shape) == 2):
        # 1-D, or stacked per-layer vectors (L, D): replicate (tiny)
        return (None,) * len(shape)
    if under_stack and len(shape) >= 3:
        per_layer = shape[1:]
        prefer = _prefer_for(path, per_layer)
        if role == "serve" and plan.huge and "moe_w" in path:
            # expert-parallel serving: experts over "data", ffn over "model"
            inner = [None] * len(per_layer)
            if plan.shard_dim(per_layer[0], ("data",)):
                inner[0] = "data"
            for i in sorted(range(1, len(per_layer)), key=lambda i: -per_layer[i]):
                if plan.shard_dim(per_layer[i], ("model",)):
                    inner[i] = "model"
                    break
            return (None, *inner)
        # within-layer "model" on the preferred dim, plus (huge regime,
        # train only) "data" on the largest other divisible dim: 2-D
        # sharding of weights, grads and codec state; serving keeps weights
        # model-only so activations stay batch-sharded over "data"
        inner = list(_matrix_spec(plan, per_layer, prefer, tp=plan.tp_axes))
        if plan.second_axes and role == "train":
            cands = sorted((i for i in range(len(per_layer)) if inner[i] is None),
                           key=lambda i: -per_layer[i])
            for i in cands:
                if plan.shard_dim(per_layer[i], plan.second_axes):
                    inner[i] = _one(plan.second_axes)
                    break
        return (None, *inner)
    # unstacked tensors (embeddings, heads, positional tables)
    return _matrix_spec(plan, shape, _prefer_for(path, shape), tp=plan.flat_tp_axes)


def param_specs(plan: MeshPlan, params: Dict[str, Any], role: str = "train") -> Dict[str, Tuple]:
    """``{path: spec}`` for a flat parameter dict (no client axis); the
    values need only a ``shape``."""
    return {k: _leaf_spec(plan, "/" + k, tuple(v.shape), role) for k, v in params.items()}


def client_stacked_specs(plan: MeshPlan, params: Dict[str, Any]) -> Dict[str, Tuple]:
    """Specs for per-client replicated params: a leading client axis
    sharded over ``client_axes``."""
    cspec = _one(plan.client_axes)
    return {k: (cspec, *s) for k, s in param_specs(plan, params).items()}


# --------------------------------------------------------------------------
# batch and cache specs
# --------------------------------------------------------------------------

def batch_specs(plan: MeshPlan, batch: Dict[str, Any], *, client_axis: bool) -> Dict[str, Tuple]:
    """tokens/labels (B, S) or (C, B, S); modality stubs get matching specs."""
    out = {}
    for k, v in batch.items():
        nd = len(v.shape)
        if client_axis:
            out[k] = (_one(plan.client_axes), _one(plan.inner_batch_axes), *([None] * (nd - 2)))
        else:
            sb = plan.serve_batch_axes
            total = math.prod(axis_size(plan.mesh, a) for a in sb)
            if v.shape[0] % max(total, 1) == 0 and total > 1:
                out[k] = (_one(sb), *([None] * (nd - 1)))
            else:
                out[k] = (None,) * nd
    return out


def cache_specs(plan: MeshPlan, cache: Any, batch: int) -> Any:
    """KV/recurrent cache specs for serving: a named tuple of the cache's
    type (every family's cache is one of tensors), a spec a field.

    Batch shards over the serve batch axes when divisible; otherwise
    (long_500k, batch=1) the *sequence* axis shards there (flash-decoding
    over sequence shards).  Head/feature trailing dims shard over "model"
    when divisible.
    """
    sb = plan.serve_batch_axes
    sb_total = math.prod(axis_size(plan.mesh, a) for a in sb)
    sb_spec = _one(sb)

    def leaf_spec(x) -> Tuple:
        shape = tuple(x.shape)
        nd = len(shape)
        spec = [None] * nd
        # axes: (L, B, S, KV, hd) / (L, B, S, H, hd) / (L, B, D) /
        # (L, B, cw-1, R) / (L, B, H, hd, hd)
        if nd >= 2 and shape[1] == batch:
            if batch % sb_total == 0 and sb_total > 1:
                spec[1] = sb_spec
            elif nd >= 3 and shape[2] % sb_total == 0 and sb_total > 1:
                spec[2] = sb_spec          # shard sequence instead
        for dim in range(nd - 1, 1, -1):  # trailing feature dims over model
            if spec[dim] is None and plan.shard_dim(shape[dim], ("model",)):
                spec[dim] = "model"
                break
        return tuple(spec)

    return type(cache)(*(leaf_spec(x) for x in cache))


#: the dtypes of the codecs' client state (``init_client_state``), with the
#: int32 words a value takes in a gathered row (bool rides as 0/1)
I32_WORDS = {torch.float32: 1, torch.int64: 2, torch.bool: 1}


def i32_words(dtype: torch.dtype, shape) -> int:
    """int32 columns that one client's leaf of ``dtype`` and per-client
    ``shape`` takes in a gathered row."""
    if dtype not in I32_WORDS:
        raise TypeError(f"codec state dtype {dtype} has no int32 view")
    return I32_WORDS[dtype] * math.prod(shape)


def as_i32(leaf: torch.Tensor) -> torch.Tensor:
    """Lossless ``(C_loc, -1)`` int32 view of a codec-state leaf, so every
    per-client state update rides *one* all-gather whatever the dtypes:
    f32 bases and memories by their bits, int64 key words as int32 pairs,
    bool init flags as 0/1."""
    i32_words(leaf.dtype, ())
    flat = leaf.reshape(leaf.shape[0], -1)
    if leaf.dtype == torch.bool:
        return flat.to(torch.int32)
    return flat.contiguous().view(torch.int32)


def from_i32(col: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """The inverse of :func:`as_i32`: ``(C, w)`` int32 columns -> a leaf of
    ``dtype`` and ``shape`` (``C`` first)."""
    i32_words(dtype, ())
    if dtype == torch.bool:
        return (col != 0).reshape(shape)
    return col.contiguous().view(dtype).reshape(shape)


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

