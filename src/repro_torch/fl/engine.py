"""K-round fused client-parallel FL round engine, on one device or sharded.

Port of ``repro/fl/engine.py``.  A run is cut into **chunks of K rounds**
(``FLConfig.scan_rounds``, :func:`plan_chunks`); the reference's
``lax.scan`` over a chunk's rounds is a Python loop here, and its ``vmap``
over clients a client axis written out:

  * local training is ``make_local_train``'s function under
    ``torch.func.vmap`` over the round's selected clients (the parameters
    broadcast); it keeps the plain attention under grad, so it reaches no
    kernel;
  * each compressed group's codec runs once per round over all the
    clients (``Codec.encode_clients``): GradESTC's and SVDFed's kernels
    take the clients folded into their stack axis, one launch per group
    and round; the flat codecs' wire kernels still launch per client;
  * the selected clients' codec state is gathered and scattered through
    index tensors (``index_select`` / ``index_copy_``), with no host read;
  * the server averages the reconstructions, runs the optional downlink
    codec (``compression.apply_downlink``, once a round, as the loop does)
    and steps the model.

Each round's packed int32 stats land in one ``(Kc, stats_len)`` device
block, and exactly **one** ``host_fetch`` per chunk reads it: its copy to
pinned host memory starts when the chunk has been issued and is waited on
one chunk later (or at an eval), so the host's accounting of a chunk
overlaps the next chunk's device work.  Chunks never span an eval round, so
parameters are whole at every eval and trajectories and ledgers do not
depend on K.  The batches of a chunk are drawn on the host in the
reference's order and copied to the device once per chunk.

**Sharded** (``FLConfig.devices`` = N > 1, DESIGN.md Sec. 10): one process
per rank of a ``torch.distributed`` world of N (``launch/mesh``).  Every
rank holds the whole model, the codecs' shared state and the per-client
state store.  A round's selection, padded to ``c_pad`` (a multiple of N)
with copies of its first client, splits into N contiguous blocks of lanes,
one a rank, which it trains and encodes.  Two collectives a round cross
the ranks (``launch/sharding.FLRoundSpecs``): one all-reduce of the
concatenated reconstruction sums over the real lanes (the compressed
groups' wire and the raw groups' deltas, f32), divided by ``n_sel`` on
the device; and one all-gather of every lane's int32 row ``[per-group
stats | codec state]`` (``launch/sharding.as_i32``), skipped where the
rows are empty (fedavg and the stateless flat codecs).  The gathered rows, cut to
the real clients, give ``reduce_stats`` the rows the single-device round
reduces, so the packed stats and the ledger are equal bit for bit; their
state columns are scattered into every rank's store.  What follows the
collectives runs alike on every rank; rank 0 alone evaluates and reports
``progress``.  :func:`run_fl_spawned` starts the world where the caller
has none.

The per-client loop (``simulation._run_fl_loop``) stays the parity oracle.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import metrics, prng
from ..core.codecs import SERVER_CLIENT_ID, round_base_key
from ..core.metrics import host_fetch, start_fetch
from ..launch.mesh import make_fl_mesh, run_world
from ..launch.sharding import FLRoundSpecs, as_i32, from_i32, i32_words, make_plan
from .compression import (RoundAccountant, apply_downlink, build_codecs, build_downlink_codecs,
                          pack_round_stats)
from .simulation import (FLConfig, FLResult, _setup_run, default_tiny_arch, make_local_train,
                         select_round_clients)

__all__ = ["run_fl_fused", "run_fl_spawned", "plan_chunks"]

def plan_chunks(rounds: int, eval_every: int, scan_rounds: int) -> List[Tuple[int, int]]:
    """Partition ``range(rounds)`` into chunks ``[start, end)``.

    A chunk grows until it holds ``scan_rounds`` rounds or its last round
    is an eval round (``r % eval_every == 0 or r == rounds - 1``), whichever
    comes first -- so parameters always materialize exactly at eval points
    and the eval cadence is invariant in K.
    """
    scan_rounds = max(1, int(scan_rounds))
    chunks: List[Tuple[int, int]] = []
    start = 0
    while start < rounds:
        end = start
        for r in range(start, min(start + scan_rounds, rounds)):
            end = r + 1
            if r % eval_every == 0 or r == rounds - 1:
                break
        chunks.append((start, end))
        start = end
    return chunks


def _to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host block on ``dev``: through pinned memory without a wait on the
    card, as it is on the CPU."""
    t = torch.from_numpy(x)
    if dev.type == "cuda":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def _run_rank(rank: int, cfg: FLConfig, record: bool):
    """One rank of :func:`run_fl_spawned`'s world: ``run_fl`` inside the
    process group; rank 0 returns its result and the progress calls it
    recorded."""
    from .simulation import run_fl

    events: List[Tuple[int, dict]] = []
    res = run_fl(cfg, (lambda rnd, info: events.append((rnd, info))) if record else None)
    return (res, events) if rank == 0 else None


def run_fl_spawned(cfg: FLConfig,
                   progress: Optional[Callable[[int, dict], None]] = None) -> FLResult:
    """``run_fl`` of a sharded config from a process with no process group:
    start ``cfg.devices`` ranks (gloo on the CPU; NCCL on the cards, rank r
    on card r) and return rank 0's result.  ``progress`` is called here
    once the run has ended, with rank 0's calls in order.  Raises
    ``ValueError`` where the backend cannot place the ranks, and with a
    failing rank's traceback where one fails."""
    dev = torch.device(cfg.device)
    n = int(cfg.devices)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if dev.index is not None:
            raise ValueError(f"device={cfg.device!r} with devices={n}: the ranks take cards "
                             "0..devices-1; pass device='cuda'")
        from ..kernels import _build

        _build.load()              # once, before the ranks look for it
    res, events = run_world(_run_rank, n, backend, args=(cfg, progress is not None))[0]
    for rnd, info in events:
        progress(rnd, info)
    return res


def run_fl_fused(cfg: FLConfig,
                 progress: Optional[Callable[[int, dict], None]] = None) -> FLResult:
    t0 = time.time()
    collectives0 = metrics.collective_count()
    ndev = int(cfg.devices or 1)
    # the mesh first: a world that does not fit fails before any setup
    spec = (FLRoundSpecs(make_plan(make_fl_mesh(ndev), cfg.arch or default_tiny_arch()))
            if ndev > 1 else None)
    su = _setup_run(cfg)
    dev = torch.device(cfg.device)
    params = su.params
    ledger, group_paths, n_sel = su.ledger, su.group_paths, su.n_sel
    C = cfg.n_clients
    K = max(1, int(cfg.scan_rounds))
    full = n_sel == C
    rank = spec.rank if spec is not None else 0
    c_pad = spec.pad_clients(n_sel) if spec is not None else n_sel
    lanes = spec.lanes(c_pad) if spec is not None else slice(0, n_sel)
    n_real = max(0, min(lanes.stop, n_sel) - lanes.start)     # this rank's real lanes

    use_pallas = dev.type == "cuda" if cfg.use_pallas is None else bool(cfg.use_pallas)
    codecs = build_codecs(su.method, su.policy, group_paths, use_pallas)
    drawing = [p for p in codecs if codecs[p].draws]
    key_col = {p: j for j, p in enumerate(drawing)}
    path_idx_t = _to_device(np.array([codecs[p].path_idx for p in drawing], np.int64), dev)
    dl_codecs = (build_downlink_codecs(su.policy, group_paths, cfg.seed, use_pallas)
                 if cfg.downlink_compress else {})
    acct = RoundAccountant(codecs, dl_codecs, su.policy, group_paths, n_sel,
                           downlink_enabled=cfg.downlink_compress)
    cstate = {p: c.init_client_state(C, dev) for p, c in codecs.items()}
    shared = {p: c.init_shared_state(dev) for p, c in codecs.items()}
    dl_state = {p: tuple(x[0] for x in c.init_client_state(1, dev, [SERVER_CLIENT_ID]))
                for p, c in dl_codecs.items()}
    dl_shared = {p: c.init_shared_state(dev) for p, c in dl_codecs.items()}
    local_train = torch.func.vmap(make_local_train(su.arch, cfg.lr), in_dims=(None, 0))

    # the whole run's selections (the reference's chain, drawn on the host)
    # and round keys, each put on the device once
    sel_table = np.array([select_round_clients(cfg.seed, r, C, n_sel)
                          for r in range(cfg.rounds)], np.int64).reshape(cfg.rounds, n_sel)
    sel_dev = _to_device(sel_table, dev)
    base_keys = round_base_key(cfg.seed, _to_device(np.arange(cfg.rounds, dtype=np.int64), dev),
                               dev)
    # the mean's divisor lives on the device (a host scalar would become a
    # reciprocal multiply on CUDA)
    n_sel_t = torch.full((), n_sel, dtype=torch.float32, device=dev)

    def draw_keys(rnd: int, sel: torch.Tensor) -> Optional[torch.Tensor]:
        """The drawing codecs' keys of the clients ``sel``: (C, P, 2)."""
        if not drawing:
            return None
        per_client = prng.fold_in(base_keys[rnd], sel)
        return prng.fold_in(per_client[:, None, :], path_idx_t)

    def encode(path: str, cst, keys, delta):
        codec = codecs[path]
        ckeys = keys[:, key_col[path]] if codec.draws else None
        return codec.encode_clients(cst, shared[path], ckeys, codec.to_wire_clients(delta))

    def finish(params, means: Dict[str, torch.Tensor], stats_of: Dict[str, torch.Tensor]):
        """The server's half of a round from the clients' mean (wire layout
        for a compressed group) and their stats rows: shared state (Formula
        13), downlink, server step.  -> (params', packed stats)."""
        reds: Dict[str, torch.Tensor] = {}
        avg: Dict[str, torch.Tensor] = {}
        for path in group_paths:
            p = params[path]
            codec = codecs.get(path)
            if codec is None:
                avg[path] = means.pop(path) * cfg.server_lr
                continue
            reds[path] = codec.reduce_stats(stats_of[path])
            shared[path] = codec.update_shared(shared[path], reds[path], means[path])
            avg[path] = codec.from_wire(means.pop(path), p.shape).to(p.dtype) * cfg.server_lr
        dl_reds = apply_downlink(dl_codecs, dl_state, dl_shared, avg)
        # each average is dropped once applied, so the old and new models and
        # the averages are never all alive at once; a parameter outside the
        # groups keeps the server's value, as the reference's ``_set_groups``
        new_params = {path: x + avg.pop(path).to(x.dtype) if path in avg else x
                      for path, x in params.items()}
        return new_params, pack_round_stats(reds, dl_reds, dev)

    def one_round(params, batches, rnd: int):
        """One round over the selected clients, batches {k: (C_sel, steps,
        B, S)}; codec state is updated in place.  -> (params', packed
        stats)."""
        sel = sel_dev[rnd]
        keys = draw_keys(rnd, sel)
        locals_ = local_train(params, batches)
        means: Dict[str, torch.Tensor] = {}
        stats_of: Dict[str, torch.Tensor] = {}
        for path in group_paths:
            delta = locals_[path] - params[path][None]
            if path not in codecs:
                means[path] = delta.sum(0) / n_sel_t
                continue
            cst = cstate[path] if full else tuple(x.index_select(0, sel) for x in cstate[path])
            cst2, recon, stats_of[path] = encode(path, cst, keys, delta)
            if full:
                cstate[path] = cst2
            else:
                for x, u in zip(cstate[path], cst2):
                    x.index_copy_(0, sel, u)
            means[path] = recon.sum(0) / n_sel_t
        del locals_
        return finish(params, means, stats_of)

    if spec is not None:
        # lanes past n_sel mirror the round's first client: they train and
        # encode like it, and are cut before every sum, stat and scatter
        sel_pad = torch.cat([sel_dev, sel_dev[:, :1].expand(-1, c_pad - n_sel)], 1)
        # collective 1's buffer: each group's sum in its wire layout
        layout, off = [], 0
        for path in group_paths:
            shape = params[path].shape
            if path in codecs:
                shape = codecs[path].to_wire(torch.empty(shape, device="meta")).shape
            layout.append((path, off, shape))
            off += math.prod(shape)
        sum_len = off
        # collective 2's row: every codec's stats, then every state leaf
        row_width = (sum(c.client_stats_len for c in codecs.values())
                     + sum(i32_words(x.dtype, x.shape[1:]) for st in cstate.values() for x in st))

    def sharded_round(params, batches, rnd: int):
        """This rank's lanes of one round, batches {k: (c_loc, steps, B,
        S)}, then the two collectives and the replicated server step."""
        sel = sel_pad[rnd, lanes]
        keys = draw_keys(rnd, sel)
        locals_ = local_train(params, batches)
        sums = torch.empty(sum_len, dtype=torch.float32, device=dev)
        stats, states = [], []
        for path, off, shape in layout:
            delta = locals_[path] - params[path][None]
            out = sums[off:off + math.prod(shape)].view(shape)
            if path not in codecs:
                torch.sum(delta[:n_real], 0, dtype=torch.float32, out=out)
                continue
            cst2, recon, st = encode(path, tuple(x.index_select(0, sel) for x in cstate[path]),
                                     keys, delta)
            torch.sum(recon[:n_real], 0, dtype=torch.float32, out=out)
            stats.append(st)
            states += [as_i32(x) for x in cst2]
        del locals_
        spec.all_reduce_sum(sums)                                       # collective 1
        means = {path: sums[off:off + math.prod(shape)].view(shape) / n_sel_t
                 for path, off, shape in layout}
        if not row_width:
            return finish(params, means, {p: sums.new_zeros((n_sel, 0), dtype=torch.int32)
                                          for p in codecs})
        rows = spec.all_gather_rows(torch.cat(stats + states, 1))[:n_sel]  # collective 2
        stats_of, col = {}, 0
        for path, codec in codecs.items():
            stats_of[path] = rows[:, col:col + codec.client_stats_len]
            col += codec.client_stats_len
        real = sel_dev[rnd]
        for path in codecs:
            for x in cstate[path]:
                w = i32_words(x.dtype, x.shape[1:])
                x.index_copy_(0, real, from_i32(rows[:, col:col + w], x.dtype,
                                                 (n_sel,) + tuple(x.shape[1:])))
                col += w
        return finish(params, means, stats_of)

    def assemble(start: int, end: int) -> Dict[str, torch.Tensor]:
        """The chunk's (Kc, c_pad, steps, B, S) batch block, drawn per round,
        per selected client and per step in the loop engine's order (the
        padding lanes copy lane 0), then this rank's lanes copied to the
        device in one transfer per key.  Every rank draws every lane, so
        each client's stream advances as on one device."""
        kc = end - start
        block: Dict[str, np.ndarray] = {}
        for i, r in enumerate(range(start, end)):
            for j, c in enumerate(sel_table[r]):
                stream = su.streams[int(c)]
                for s in range(cfg.local_steps):
                    b = next(stream)
                    if not block:
                        block = {k: np.empty((kc, c_pad, cfg.local_steps) + v.shape, v.dtype)
                                 for k, v in b.items()}
                    for k, v in b.items():
                        block[k][i, j, s] = v
        for v in block.values():
            v[:, n_sel:] = v[:, :1]
        return {k: _to_device(np.ascontiguousarray(v[:, lanes]), dev) for k, v in block.items()}

    round_fn = one_round if spec is None else sharded_round
    stats_len = max(acct.packed_len, 1)
    chunks = plan_chunks(cfg.rounds, cfg.eval_every, K)
    res = FLResult([], [], [], [], ledger, 0.0)
    round_wall: List[float] = []
    chunk_spans: List[Tuple[float, float]] = []
    pending = None          # (the started fetch of a chunk's stats block, start, end)

    def drain():
        nonlocal pending
        if pending is not None:
            rows = host_fetch(pending[0])          # the chunk's one fetch
            for i, r in enumerate(range(pending[1], pending[2])):
                acct.consume(rows[i], ledger, r)
            pending = None

    for start, end in chunks:
        t_chunk = time.perf_counter()
        for _ in range(start, end):
            ledger.begin_round()
        block = assemble(start, end)
        packed = torch.empty((end - start, stats_len), dtype=torch.int32, device=dev)
        for i, rnd in enumerate(range(start, end)):
            params, packed[i] = round_fn(params, {k: v[i] for k, v in block.items()}, rnd)
        # the previous chunk's stats are read only now, behind this chunk's
        # work on the device
        drain()
        pending = (start_fetch(packed), start, end)
        dt = time.perf_counter() - t_chunk
        chunk_spans.append((t_chunk, t_chunk + dt))
        round_wall += [dt / (end - start)] * (end - start)

        rnd = end - 1
        if rank == 0 and (rnd % cfg.eval_every == 0 or rnd == cfg.rounds - 1):
            drain()                       # the ledger is exact before reporting
            la = host_fetch(su.eval_fn(params, su.eval_block))
            res.eval_rounds.append(rnd)
            res.eval_loss.append(float(la[0]))
            res.eval_acc.append(float(la[1]))
            res.uplink_bytes.append(ledger.uplink_total)
            if progress:
                progress(rnd, {"loss": res.eval_loss[-1], "acc": res.eval_acc[-1],
                               "uplink": ledger.uplink_total})
    drain()

    res.wall_s = time.time() - t0
    res.extra["engine"] = "fused"
    res.extra["use_pallas"] = use_pallas
    res.extra["round_wall_s"] = round_wall
    res.extra["devices"] = ndev
    res.extra["scan_rounds"] = K
    res.extra["chunks"] = len(chunks)
    res.extra["chunk_spans"] = chunk_spans
    res.extra["chunk_shapes"] = len({e - s for s, e in chunks})
    if spec is not None:
        res.extra.update(rank=rank, backend=spec.backend, c_pad=c_pad,
                         lanes=(lanes.start, lanes.stop),
                         collectives=metrics.collective_count() - collectives0)
    res.extra.update(acct.metrics)
    return res
