"""K-round fused client-parallel FL round engine (single device).

Port of ``repro/fl/engine.py``'s single-device engine.  A run is cut into
**chunks of K rounds** (``FLConfig.scan_rounds``, :func:`plan_chunks`); the
reference's ``lax.scan`` over a chunk's rounds is a Python loop here, and
its ``vmap`` over clients a client axis written out:

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

The per-client loop (``simulation._run_fl_loop``) stays the parity oracle.
The sharded engine (``FLConfig.devices > 1``) is ROADMAP A11.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import prng
from ..core.codecs import SERVER_CLIENT_ID, round_base_key
from ..core.metrics import host_fetch, start_fetch
from .compression import (RoundAccountant, apply_downlink, build_codecs, build_downlink_codecs,
                          pack_round_stats)
from .simulation import FLConfig, FLResult, _setup_run, make_local_train, select_round_clients

__all__ = ["run_fl_fused", "plan_chunks"]


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


def run_fl_fused(cfg: FLConfig,
                 progress: Optional[Callable[[int, dict], None]] = None) -> FLResult:
    t0 = time.time()
    su = _setup_run(cfg)
    dev = torch.device(cfg.device)
    params = su.params
    ledger, group_paths, n_sel = su.ledger, su.group_paths, su.n_sel
    C = cfg.n_clients
    K = max(1, int(cfg.scan_rounds))
    full = n_sel == C

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

    def one_round(params, batches, rnd: int):
        """One round over the selected clients, batches {k: (C_sel, steps,
        B, S)}; codec state is updated in place.  -> (params', packed
        stats)."""
        sel = sel_dev[rnd]
        if drawing:
            per_client = prng.fold_in(base_keys[rnd], sel)
            keys = prng.fold_in(per_client[:, None, :], path_idx_t)      # (n_sel, P, 2)
        locals_ = local_train(params, batches)
        reds: Dict[str, torch.Tensor] = {}
        avg: Dict[str, torch.Tensor] = {}
        for path in group_paths:
            p = params[path]
            delta = locals_[path] - p[None]
            codec = codecs.get(path)
            if codec is None:
                avg[path] = delta.sum(0) / n_sel_t * cfg.server_lr
                continue
            cst = cstate[path] if full else tuple(x.index_select(0, sel) for x in cstate[path])
            ckeys = keys[:, key_col[path]] if codec.draws else None
            cst2, recon, stats = codec.encode_clients(cst, shared[path], ckeys,
                                                      codec.to_wire_clients(delta))
            if full:
                cstate[path] = cst2
            else:
                for x, u in zip(cstate[path], cst2):
                    x.index_copy_(0, sel, u)
            reds[path] = codec.reduce_stats(stats)
            mean_wire = recon.sum(0) / n_sel_t
            shared[path] = codec.update_shared(shared[path], reds[path], mean_wire)
            avg[path] = codec.from_wire(mean_wire, p.shape).to(p.dtype) * cfg.server_lr
        del locals_
        dl_reds = apply_downlink(dl_codecs, dl_state, dl_shared, avg)
        # each average is dropped once applied, so the old and new models and
        # the averages are never all alive at once
        new_params = {path: params[path] + avg.pop(path).to(params[path].dtype)
                      for path in group_paths}
        return new_params, pack_round_stats(reds, dl_reds, dev)

    def assemble(start: int, end: int) -> Dict[str, torch.Tensor]:
        """The chunk's (Kc, C_sel, steps, B, S) batch block, drawn per round,
        per selected client and per step in the loop engine's order, then
        copied to the device in one transfer per key."""
        kc = end - start
        block: Dict[str, np.ndarray] = {}
        for i, r in enumerate(range(start, end)):
            for j, c in enumerate(sel_table[r]):
                stream = su.streams[int(c)]
                for s in range(cfg.local_steps):
                    b = next(stream)
                    if not block:
                        block = {k: np.empty((kc, n_sel, cfg.local_steps) + v.shape, v.dtype)
                                 for k, v in b.items()}
                    for k, v in b.items():
                        block[k][i, j, s] = v
        return {k: _to_device(v, dev) for k, v in block.items()}

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
            params, packed[i] = one_round(params, {k: v[i] for k, v in block.items()}, rnd)
        # the previous chunk's stats are read only now, behind this chunk's
        # work on the device
        drain()
        pending = (start_fetch(packed), start, end)
        dt = time.perf_counter() - t_chunk
        chunk_spans.append((t_chunk, t_chunk + dt))
        round_wall += [dt / (end - start)] * (end - start)

        rnd = end - 1
        if rnd % cfg.eval_every == 0 or rnd == cfg.rounds - 1:
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
    res.extra["devices"] = 1
    res.extra["scan_rounds"] = K
    res.extra["chunks"] = len(chunks)
    res.extra["chunk_spans"] = chunk_spans
    res.extra["chunk_shapes"] = len({e - s for s, e in chunks})
    res.extra.update(acct.metrics)
    return res
