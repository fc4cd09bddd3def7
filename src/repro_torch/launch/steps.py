"""The production FL round step and the serve steps.

Port of ``repro/launch/steps.py``.  Three kinds, per input shape:

  * train_4k             -> ``fl_round_step``: one FedAvg round -- every
    client trains ``local_steps`` SGD steps from the global params on its
    batch (over ``grad_accum`` microbatches), GradESTC compresses each
    compressed group's delta (``compress_update`` at a static ``d``), the
    server averages ``M_c A_c`` over the clients and applies it with
    ``server_lr``.  Every other method (``fedpaq`` too) takes the dense mean
    of the deltas, the FedAvg reference the paper compares against.

  * prefill_32k          -> ``prefill_step``: the forward, the last
    position's logits.

  * decode_32k/long_500k -> ``decode_step``: one token against the cache.

The clients are the mesh's client axis (``plan.n_clients``).  One client
trains unbatched; more train under ``torch.func.vmap``.  On a logical mesh
(no process group) this process runs every client; in a world over
``"data"`` the ranks split the clients as ``FLRoundSpecs.lanes`` does,
every rank holding the whole model and the whole :class:`GEState`.  The
aggregation's schedule is the reference's: per compressed group, an
all-gather of each lane's basis ``M`` and one of its coefficients ``A``
(with its ``d_r`` and next key, as int32 words), then the einsum on every
rank -- never an all-reduce of the full gradient; the dense groups' sums
cross in one all-reduce.  Each collective is counted
(``metrics.count_collective``).  The step fetches nothing to the host.

Tensor parallelism over ``"model"`` is not executed (ROADMAP A13): the
spec rules compute the TP specs for the dry run, which runs the step on
the ``meta`` device, and a step called on real tensors over a ``"model"``
axis above 1 raises ``ValueError``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..core import gradestc as ge
from ..core import prng
from ..core.policy import CompressionPolicy, LayerPlan, make_policy
from ..models import model
from ..models.config import ArchConfig, InputShape
from .sharding import (FLRoundSpecs, MeshPlan, _matrix_spec, _one, _prefer_for, as_i32,
                       axis_size, from_i32, named, param_specs)

__all__ = [
    "GEState", "ShapeDtype", "make_ge_state", "ge_state_specs",
    "make_aggregate", "make_fl_round_step", "make_serve_steps", "train_input_specs",
    "serve_input_specs", "compression_policy_for",
]


# --------------------------------------------------------------------------
# GradESTC distributed state
# --------------------------------------------------------------------------

class GEState(NamedTuple):
    """Per-(client, group) compressor state for the round step.

    M:    {group: (C, L, l, k)}   the client axis over client_axes, l over
                                  the tp axes when divisible (specs).
    keys: {group: (C, L, 2)}      per-compressor threefry keys.
    """

    M: Dict[str, torch.Tensor]
    keys: Dict[str, torch.Tensor]


class ShapeDtype(NamedTuple):
    """An abstract input: a shape and a dtype (``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def compression_policy_for(cfg: ArchConfig, plan: MeshPlan) -> CompressionPolicy:
    """Paper policy with the alignment rule: the segment length l is the
    parameter's tp-sharded dimension (DESIGN.md Sec. 5) -- falling back to
    the sqrt rule when a group is unsharded."""
    groups = model.param_group_shapes(cfg)
    overrides = {}
    for name, (shape, stack) in groups.items():
        if len(shape) < 2:
            continue
        n = math.prod(shape)
        if n < 65536:
            continue
        # orient l along the dim the spec rules shard for that group
        spec = _matrix_spec(plan, shape, _prefer_for(name, shape))
        sharded_dim = next((i for i, s in enumerate(spec) if s is not None), None)
        if sharded_dim is None:
            continue  # unsharded group: keep the default sqrt rule
        l = int(shape[sharded_dim])
        if len(shape) > 2 and l < 256:
            # fold extra dims into m (MoE (E, D, F) with E sharded: l = E is
            # degenerate -- use the largest remaining dim instead)
            l = int(max(s for i, s in enumerate(shape) if i != sharded_dim))
        m = n // l
        k = max(4, min(l // 8, m // 4, 64))
        k = 1 << (k.bit_length() - 1) if k & (k - 1) else k
        overrides[name] = (k, l)
    return make_policy(groups, overrides=overrides)


def make_ge_state(cfg: ArchConfig, policy: CompressionPolicy, n_clients: int,
                  seed: int = 0, dtype=torch.float32, device="cuda") -> GEState:
    """Zero bases and per-compressor keys on ``device`` (the card unless
    the caller asks for the CPU).  Each group's keys fold ``hash(name) %
    2**31`` into the seed's key, as the reference's do: Python salts
    ``hash`` of a string per process (``PYTHONHASHSEED``), so keys equal
    the reference's in one process, and a world's ranks take the state
    built once in the process that starts them."""
    M, keys = {}, {}
    base = prng.PRNGKey(seed, device)
    for name, lp in policy.plans.items():
        if not lp.compress:
            continue
        M[name] = torch.zeros((n_clients, lp.stack, lp.l, lp.k), dtype=dtype, device=device)
        keys[name] = prng.split(prng.fold_in(base, hash(name) % (2**31)),
                                n_clients * lp.stack).reshape(n_clients, lp.stack, 2)
    return GEState(M=M, keys=keys)


def ge_state_specs(plan: MeshPlan, policy: CompressionPolicy) -> GEState:
    cspec = _one(plan.client_axes)
    tp = plan.tp_axes
    M_specs, key_specs = {}, {}
    for name, lp in policy.plans.items():
        if not lp.compress:
            continue
        lspec = tp if len(tp) > 1 else tp[0]
        if lp.l % max(plan.tp_size(), 1) != 0:
            lspec = None
        M_specs[name] = (cspec, None, lspec, None)
        key_specs[name] = (cspec, None, None)
    return GEState(M=M_specs, keys=key_specs)


# --------------------------------------------------------------------------
# group <-> matrices plumbing (stacked, on the device); the params are a
# flat {path: tensor} dict, so the reference's _group_leaf and _set_leaf
# are a lookup and an update
# --------------------------------------------------------------------------

def _delta_to_G(delta: torch.Tensor, lp: LayerPlan) -> torch.Tensor:
    """(C?, L, *shape) -> (C?, L, l, m) oriented so rows are the l axis.

    With l one tensor dimension (the first whose size is l) this is a
    transpose-reshape; where none is, the flat delta reshapes to (m, l)
    and swaps."""
    shape = lp.shape
    lead = tuple(delta.shape[: delta.dim() - len(shape)])
    ax = next((i for i, s in enumerate(shape) if s == lp.l), None)
    if ax is None:
        return delta.reshape(*lead, lp.m, lp.l).transpose(-1, -2)
    perm_tail = (ax,) + tuple(i for i in range(len(shape)) if i != ax)
    perm = tuple(range(len(lead))) + tuple(len(lead) + i for i in perm_tail)
    return delta.permute(perm).reshape(*lead, lp.l, lp.m)


def _G_to_delta(G: torch.Tensor, lp: LayerPlan, like_shape) -> torch.Tensor:
    """The inverse of :func:`_delta_to_G`, reshaped to ``like_shape``."""
    lead = tuple(G.shape[:-2])
    shape = lp.shape
    ax = next((i for i, s in enumerate(shape) if s == lp.l), None)
    if ax is None:
        return G.transpose(-1, -2).reshape(*lead, lp.n).reshape(like_shape)
    rest = tuple(s for i, s in enumerate(shape) if i != ax)
    moved = G.reshape(*lead, lp.l, *rest)
    tail_perm = [0] * len(shape)
    tail_src = (ax,) + tuple(i for i in range(len(shape)) if i != ax)
    for pos, src in enumerate(tail_src):
        tail_perm[src] = len(lead) + pos
    return moved.permute(tuple(range(len(lead))) + tuple(tail_perm)).reshape(like_shape)


# --------------------------------------------------------------------------
# FL round step
# --------------------------------------------------------------------------

def _world(mesh, plan: MeshPlan) -> Tuple[Optional[FLRoundSpecs], slice]:
    """(the round's view of an executing world over ``"data"``, this
    rank's lanes of the C clients); on a logical mesh (None, every lane):
    this process runs every client."""
    C = plan.n_clients
    if "data" not in mesh.mesh_dim_names or mesh.get_group("data") is None:
        return None, slice(0, C)
    if plan.huge:
        raise ValueError("the huge regime's 2-D weights over ranks are not ported "
                         "(ROADMAP A13); run it on one rank")
    world = FLRoundSpecs(plan)
    return world, world.lanes(C)


def make_aggregate(mesh, plan: MeshPlan, policy: CompressionPolicy, *, method: str = "gradestc",
                   server_lr: float = 1.0, d_static: int = 16,
                   trace: Optional[List[Tuple[str, int, int]]] = None,
                   delta_specs: Optional[Dict[str, Tuple]] = None) -> Callable:
    """The server's half of a round, from this process's lanes' deltas.

    signature: (global_params, ge_state, deltas) ->
               (new_params, new_ge_state, metrics)
    deltas: {group path: (n_loc, *param shape) f32}, the groups to update.

    ``trace``, where given, receives one ``(op, bytes, shards)`` entry for
    each client-axis collective the aggregation makes or, on a logical
    mesh, stands for (none where C is 1): the bytes of the tensor it
    returns, whose ``shards`` pieces the specs spread over the mesh (the
    dry run's per-device collective bytes).  ``delta_specs`` ({path: spec
    of one client's delta}) lays out the deltas the dense mean reduces;
    by default the parameters' specs, as the round's local training leaves
    them.
    """
    C = plan.n_clients
    world, lanes = _world(mesh, plan)
    n_loc = lanes.stop - lanes.start
    tp = axis_size(mesh, "model")

    def record(op: str, nbytes: int, shards: int) -> None:
        if trace is not None and C > 1:
            trace.append((op, nbytes, shards))

    def gather(rows: torch.Tensor, shards: int) -> torch.Tensor:
        """Every lane's ``(n_loc, W)`` rows -> ``(C, W)``."""
        record("all-gather", C * rows[0].numel() * rows.element_size(), shards)
        return rows if world is None else world.all_gather_rows(rows)

    def aggregate(global_params, ge_state: GEState, deltas: Dict[str, torch.Tensor]):
        dev = next(iter(deltas.values())).device
        metrics: Dict[str, torch.Tensor] = {}
        new_M, new_keys = dict(ge_state.M), dict(ge_state.keys)
        recon: Dict[str, torch.Tensor] = {}
        dense: List[str] = []
        for path in list(deltas):
            lp = policy.plans[path]
            delta = deltas.pop(path)
            if not (method == "gradestc" and lp.compress):
                recon[path] = delta.sum(0)
                dense.append(path)
                continue
            G = _delta_to_G(delta.reshape((n_loc, lp.stack) + lp.shape), lp).contiguous()
            del delta
            st = ge.CompressorState(
                M=ge_state.M[path][lanes], key=ge_state.keys[path][lanes],
                initialized=torch.ones((n_loc, lp.stack), dtype=torch.bool, device=dev))
            st2, payload, stats = ge.compress_update(st, G, k=lp.k, d=d_static)
            # the payload crosses as two all-gathers: M, then the next key,
            # d_r and A as int32 words (the key's and A's bits exactly)
            l_shards = tp if lp.l % tp == 0 else 1
            M2 = gather(st2.M.reshape(n_loc, -1), l_shards).reshape(C, lp.stack, lp.l, lp.k)
            row = gather(torch.cat([as_i32(st2.key), stats.d_r.reshape(n_loc, -1),
                                    as_i32(payload.coeffs)], 1), 1)
            nk = 4 * lp.stack
            # a copy: an int64 view wants even strides, which a row cut of
            # one lane need not have
            new_keys[path] = from_i32(row[:, :nk].clone(memory_format=torch.contiguous_format),
                                      torch.int64, (C, lp.stack, 2))
            d_r = row[:, nk:nk + lp.stack]
            A = from_i32(row[:, nk + lp.stack:], torch.float32, (C, lp.stack, lp.k, lp.m))
            new_M[path] = M2
            # Ghat_c = M_c A_c, averaged: the reference's einsum / C
            Ghat_avg = torch.einsum("cxlk,cxkm->xlm", M2, A) / C
            recon[path] = _G_to_delta(Ghat_avg, lp, (lp.stack,) + lp.shape).reshape(
                global_params[path].shape)
            metrics[f"d_r/{path}"] = d_r.float().mean()
        if dense:
            # one all-reduce of the dense groups' sums
            flat = torch.cat([recon[p].reshape(-1) for p in dense])
            specs = delta_specs or param_specs(plan, {p: recon[p] for p in dense})
            for p in dense:
                record("all-reduce", recon[p].numel() * 4, named(mesh, specs[p]).shards)
            if world is not None:
                world.all_reduce_sum(flat)
            off = 0
            for p in dense:
                n = recon[p].numel()
                recon[p] = flat[off:off + n].view(recon[p].shape) / C
                off += n
        # server update; a parameter outside the groups keeps its value
        new_params = {}
        for path, old in global_params.items():
            if path in recon:
                new_params[path] = (old.float() + server_lr * recon.pop(path)).to(old.dtype)
            else:
                new_params[path] = old
        metrics["loss_proxy"] = torch.zeros((), dtype=torch.float32, device=dev)
        return new_params, GEState(M=new_M, keys=new_keys), metrics

    return aggregate


def make_fl_round_step(
    cfg: ArchConfig,
    mesh,
    plan: MeshPlan,
    policy: CompressionPolicy,
    *,
    method: str = "gradestc",        # "gradestc" | "fedavg" | "fedpaq"
    local_steps: int = 1,
    grad_accum: int = 1,
    lr: float = 0.01,
    server_lr: float = 1.0,
    d_static: int = 16,
    trace: Optional[List[Tuple[str, int, int]]] = None,
) -> Callable:
    """Build the FL round function.

    signature: (global_params, ge_state, batches) ->
               (new_params, new_ge_state, metrics)
    batches: {tokens/labels: (C, B_c, S), ...}, all C clients on every rank.

    ``grad_accum`` splits each client batch into microbatches whose
    gradients accumulate in f32; ``trace`` is :func:`make_aggregate`'s.
    """
    C = plan.n_clients
    group_paths = list(policy.plans)
    _, lanes = _world(mesh, plan)
    tp = axis_size(mesh, "model")
    aggregate = make_aggregate(mesh, plan, policy, method=method, server_lr=server_lr,
                               d_static=d_static, trace=trace)

    def client_grad(p, batch_c):
        if grad_accum == 1:
            return torch.func.grad(lambda pp: model.loss_fn(cfg, pp, batch_c))(p)
        mbs = {k: x.reshape((grad_accum, x.shape[0] // grad_accum) + tuple(x.shape[1:]))
               for k, x in batch_c.items()}
        g_acc = {k: torch.zeros(a.shape, dtype=torch.float32, device=a.device)
                 for k, a in p.items()}
        for i in range(grad_accum):
            mb = {k: x[i] for k, x in mbs.items()}
            g = torch.func.grad(lambda pp: model.loss_fn(cfg, pp, mb))(p)
            g_acc = {k: g_acc[k] + g[k].float() / grad_accum for k in p}
        return g_acc

    def local_train(params_c, batch_c):
        p = params_c
        for _ in range(local_steps):
            g = client_grad(p, batch_c)
            p = {k: (a.float() - lr * g[k].float()).to(a.dtype) for k, a in p.items()}
        return p

    def fl_round(global_params, ge_state: GEState, batches):
        if tp > 1 and next(iter(global_params.values())).device.type != "meta":
            raise ValueError(f"mesh {mesh.shape}: tensor parallelism over 'model' is not "
                             "ported (ROADMAP A13); only the meta-device dry run takes it")
        local = {k: x[lanes] for k, x in batches.items()}
        if C == 1:
            # one client, unbatched, as the reference's FSDP regime
            one = local_train(global_params, {k: x[0] for k, x in local.items()})
            client_params = {k: x[None] for k, x in one.items()}
        else:
            client_params = torch.func.vmap(local_train, in_dims=(None, 0))(global_params,
                                                                            local)
        # per-group deltas (n_loc, ...), f32 for the codec
        deltas = {path: client_params.pop(path).float() - global_params[path].float()[None]
                  for path in group_paths}
        del client_params
        return aggregate(global_params, ge_state, deltas)

    return fl_round


# --------------------------------------------------------------------------
# serve steps
# --------------------------------------------------------------------------

def make_serve_steps(cfg: ArchConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        # hidden-then-head: only the last position's logits are formed
        hidden, head = model.forward_hidden(cfg, params, batch)
        return (hidden[:, -1, :] @ head).float()

    def decode(params, cache, batch):
        return model.decode_step(cfg, params, cache, batch["tokens"])

    return prefill_step, decode


# --------------------------------------------------------------------------
# abstract inputs per shape
# --------------------------------------------------------------------------

def train_input_specs(cfg: ArchConfig, shape: InputShape, plan: MeshPlan) -> Dict[str, ShapeDtype]:
    """{name: ShapeDtype} for one FL-round step's batches."""
    C = plan.n_clients
    B = shape.global_batch // C
    S = shape.seq_len
    specs = {"tokens": ShapeDtype((C, B, S), torch.int32),
             "labels": ShapeDtype((C, B, S), torch.int32)}
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "encdec":
        specs["audio_frames"] = ShapeDtype((C, B, cfg.encoder_seq, cfg.d_model), dt)
    if cfg.family == "vlm" and cfg.vision_tokens:
        specs["vision_embeds"] = ShapeDtype((C, B, cfg.vision_tokens, cfg.d_model), dt)
    return specs


def serve_input_specs(cfg: ArchConfig, shape: InputShape, *, decode: bool
                      ) -> Dict[str, ShapeDtype]:
    B, S = shape.global_batch, shape.seq_len
    if decode:
        return {"tokens": ShapeDtype((B, 1), torch.int32)}
    specs = {"tokens": ShapeDtype((B, S), torch.int32),
             "labels": ShapeDtype((B, S), torch.int32)}
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "encdec":
        specs["audio_frames"] = ShapeDtype((B, cfg.encoder_seq, cfg.d_model), dt)
    if cfg.family == "vlm" and cfg.vision_tokens:
        specs["vision_embeds"] = ShapeDtype((B, cfg.vision_tokens, cfg.d_model), dt)
    return specs
