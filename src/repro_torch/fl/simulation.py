"""Federated-learning round loop (the per-client loop engine).

Port of ``repro/fl/simulation.py``'s loop engine, the reference's parity
oracle: N clients, all (or a sampled fraction) per round, each running
``local_steps`` SGD steps and uploading its model delta through the
configured uplink method; the server averages the reconstructions and
applies them with ``server_lr``.  Client selection, codec keys and initial
weights come from the reference's threefry chains, and the ledger charges
exact integer bits, so ``ledger.per_round_uplink`` equals the reference's.

The port runs on ``FLConfig.device`` ("cuda" by default).  Methods:
``fedavg``; ``gradestc`` and ``svdfed``, each with
``method_kw={"wire_dtype": "f32" | "bf16" | "int8"}``; the GradESTC
ablations ``gradestc-first``, ``gradestc-all`` and ``gradestc-k`` and its
error feedback ``gradestc-ef``; and the flat baselines ``topk``,
``signsgd``, ``fedpaq`` and ``fedqclip``.  ``downlink_compress`` also
sends the server's broadcast through a GradESTC codec of its own (one
server instance, ``SERVER_CLIENT_ID``).  On the card GradESTC's
projection, reconstruction and int8 wire, SVDFed's int8 uplink and the
sign and quantizer wires (at every width from 2 to 8 bits) run the
hand-written CUDA kernels, and so does the eval forward's attention (the
flash kernel; local training keeps the plain attention); there is no plain
path there.  ``use_pallas`` resolves as in the reference: ``None``
means the kernels on the card and the plain versions on the CPU, where
FedPAQ/FedQClip then run the paper's global quantizer and
``use_pallas=True`` gives the card's block-local wire.
``engine="fused"`` runs the K-round client-batched engine
(:mod:`repro_torch.fl.engine`), on one device or, with ``devices`` > 1,
sharded over a ``torch.distributed`` world of that many ranks: the
caller's, where one is initialized, else ranks that ``run_fl`` starts
(gloo on the CPU, NCCL on the cards).  The default stays the loop.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import prng
from ..core.codecs import SERVER_CLIENT_ID, round_base_key
from ..core.metrics import CommLedger, host_fetch
from ..core.policy import make_policy
from ..data import client_batch_stream, make_task
from ..models import model
from ..models.config import ArchConfig
from ..optim.optimizers import sgd
from .compression import (RoundAccountant, apply_downlink, build_codecs, build_downlink_codecs,
                          make_method, pack_round_stats)

__all__ = ["FLConfig", "FLResult", "run_fl", "default_tiny_arch",
           "make_local_train", "make_batched_eval", "select_round_clients"]


def select_round_clients(seed: int, rnd: int, n_clients: int, n_sel: int) -> List[int]:
    """The round's selected client ids, sorted: a pure function of
    ``(seed, round)`` through the reference's ``fold_in`` chain, drawn on
    the host."""
    key = prng.fold_in(prng.PRNGKey(seed + 0xC11E47, "cpu"), rnd)
    perm = prng.permutation(key, n_clients)
    return sorted(int(c) for c in perm[:n_sel])


def default_tiny_arch(vocab: int = 256) -> ArchConfig:
    """Small-but-real transformer for CPU-scale FL experiments."""
    return ArchConfig(
        name="fl-tiny", family="dense", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=512, vocab=vocab, dtype="float32", remat=False,
        attn_chunk=0,
    )


@dataclass
class FLConfig:
    method: str = "gradestc"
    rounds: int = 30
    n_clients: int = 10
    participation: float = 1.0       # fraction of clients per round
    local_steps: int = 4
    batch: int = 16
    seq: int = 64
    lr: float = 0.05
    server_lr: float = 1.0
    alpha: Optional[float] = None    # None = IID; 0.5 / 0.1 = paper's non-IID
    #: compress the server->client broadcast through a server-side GradESTC
    #: codec (the paper's Sec. VI future work; beyond-paper).
    downlink_compress: bool = False
    seed: int = 0
    eval_every: int = 5
    eval_batches: int = 4
    arch: Optional[ArchConfig] = None
    method_kw: Dict[str, Any] = field(default_factory=dict)
    policy_overrides: Dict[str, tuple] = field(default_factory=dict)
    coverage_target: float = 0.90
    min_params: int = 4096
    #: "loop" = the per-client loop (the parity oracle); "fused" = the
    #: K-round engine (``fl/engine.py``): clients batched through local
    #: training and the matrix codecs, one stats fetch per chunk.  Every
    #: method and option runs on either.
    engine: str = "loop"
    #: chunk length K of the fused engine: one packed-stats host fetch per K
    #: rounds.  Chunks never span an eval round, so trajectories and the
    #: ledger do not depend on K.
    scan_rounds: int = 8
    #: None: True on CUDA (the kernels), False on the CPU (the plain
    #: versions, and the paper's global quantizer for FedPAQ/FedQClip).
    #: ``False`` with a CUDA device is refused (no plain path on the card);
    #: ``True`` on the CPU gives the block-local quantizer wire.
    use_pallas: Optional[bool] = None
    #: where the run lives: "cuda" (default) or "cpu".
    device: str = "cuda"
    #: data-parallel device count of the fused engine; None/1 = one device.
    #: More runs the sharded engine (``engine="fused"`` only): the selected
    #: clients split over that many ranks, in the caller's process group if
    #: one is initialized (it must have that many ranks), else in ranks that
    #: ``run_fl`` starts (gloo on the CPU; NCCL on the cards, one a card).
    devices: Optional[int] = None


@dataclass
class FLResult:
    eval_rounds: List[int]
    eval_loss: List[float]
    eval_acc: List[float]
    uplink_bytes: List[float]        # cumulative at each eval point
    ledger: CommLedger
    wall_s: float
    extra: Dict[str, Any] = field(default_factory=dict)

    def uplink_at_loss(self, target: float) -> Optional[float]:
        """Cumulative uplink bytes when eval loss first reaches target."""
        for loss, b in zip(self.eval_loss, self.uplink_bytes):
            if loss <= target:
                return b
        return None

    def uplink_at_acc(self, target: float) -> Optional[float]:
        """Cumulative uplink bytes when eval accuracy first reaches target."""
        for acc, b in zip(self.eval_acc, self.uplink_bytes):
            if acc >= target:
                return b
        return None


def make_local_train(arch: ArchConfig, lr: float):
    """``local_steps`` SGD steps; batches: {k: (steps, B, S)} on the device.
    Gradients come from ``torch.func.grad`` over the flat parameter dict."""
    opt_init, opt_update = sgd(lr)

    def local_train(params, batches):
        p, st = params, opt_init(params)
        for s in range(batches["tokens"].shape[0]):
            b = {k: v[s] for k, v in batches.items()}
            g = torch.func.grad(lambda pp: model.loss_fn(arch, pp, b))(p)
            p, st = opt_update(g, st, p)
        return p

    return local_train


def make_batched_eval(arch: ArchConfig):
    """Eval over the stacked block {k: (E, B, S)} -> f32 [mean loss, mean
    acc], so an eval round costs one device-to-host fetch."""

    @torch.no_grad()
    def eval_all(params, block):
        ls, accs = [], []
        for e in range(block["tokens"].shape[0]):
            logits = model.forward(arch, params, {"tokens": block["tokens"][e]})
            labels = block["labels"][e].long()
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[..., None])[..., 0]
            ls.append((logz - gold).mean())
            accs.append((logits.argmax(-1) == labels).float().mean())
        return torch.stack([torch.stack(ls).mean(), torch.stack(accs).mean()]).float()

    return eval_all


@dataclass
class _RunSetup:
    arch: ArchConfig
    params: Dict[str, torch.Tensor]
    group_paths: List[str]
    policy: Any
    method: Any
    streams: Dict[int, Any]
    eval_block: Dict[str, torch.Tensor]
    eval_fn: Callable
    ledger: CommLedger
    n_sel: int


def _stack_batches(bs, device) -> Dict[str, torch.Tensor]:
    # non_blocking: the copy is staged at once and the host does not wait
    # for the stream (a blocking copy would sync the device)
    return {k: torch.from_numpy(np.stack([b[k] for b in bs])).to(device, non_blocking=True)
            for k in bs[0]}


def _setup_run(cfg: FLConfig) -> _RunSetup:
    arch = cfg.arch or default_tiny_arch()
    dev = torch.device(cfg.device)
    task = make_task(vocab=arch.vocab, n_clients=cfg.n_clients, alpha=cfg.alpha,
                     seed=cfg.seed)
    params = model.init_params(arch, prng.PRNGKey(cfg.seed, dev))
    groups = model.param_group_shapes(arch)
    policy = make_policy(groups, overrides=cfg.policy_overrides,
                         coverage_target=cfg.coverage_target,
                         min_params=cfg.min_params)
    method = make_method(cfg.method, policy=policy, seed=cfg.seed, **cfg.method_kw)
    streams = {c: client_batch_stream(task, c, cfg.batch, cfg.seq, cfg.seed)
               for c in range(cfg.n_clients)}
    eval_stream = client_batch_stream(task, -1, cfg.batch, cfg.seq, cfg.seed + 999)
    eval_block = _stack_batches([next(eval_stream) for _ in range(cfg.eval_batches)], dev)
    return _RunSetup(
        arch=arch, params=params, group_paths=list(groups),
        policy=policy, method=method, streams=streams, eval_block=eval_block,
        eval_fn=make_batched_eval(arch), ledger=CommLedger(),
        n_sel=max(1, int(round(cfg.participation * cfg.n_clients))),
    )


def _check_config(cfg: FLConfig) -> None:
    if cfg.engine not in ("fused", "loop"):
        raise ValueError(f"unknown engine {cfg.engine!r} (want 'fused' or 'loop')")
    ndev = int(cfg.devices or 1)
    if ndev < 1:
        raise ValueError(f"devices={cfg.devices}: want a positive rank count")
    if ndev > 1 and cfg.engine != "fused":
        raise ValueError(f"devices={ndev} runs the sharded engine, which is engine='fused'; "
                         f"engine={cfg.engine!r} runs on one device")
    dev = torch.device(cfg.device)
    if dev.type == "cuda" and cfg.use_pallas is False:
        raise ValueError("use_pallas=False on a CUDA device: the port has no "
                         "plain path on the card")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("FLConfig.device is CUDA but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")


def run_fl(cfg: FLConfig, progress: Optional[Callable[[int, dict], None]] = None) -> FLResult:
    _check_config(cfg)
    if cfg.engine == "loop":
        return _run_fl_loop(cfg, progress)
    from .engine import run_fl_fused, run_fl_spawned

    if int(cfg.devices or 1) > 1 and not (dist.is_available() and dist.is_initialized()):
        return run_fl_spawned(cfg, progress)
    return run_fl_fused(cfg, progress)


def _run_fl_loop(cfg: FLConfig, progress=None) -> FLResult:
    t0 = time.time()
    su = _setup_run(cfg)
    dev = torch.device(cfg.device)
    params = su.params
    ledger, group_paths, n_sel = su.ledger, su.group_paths, su.n_sel
    C = cfg.n_clients

    use_pallas = dev.type == "cuda" if cfg.use_pallas is None else bool(cfg.use_pallas)
    codecs = build_codecs(su.method, su.policy, group_paths, use_pallas)
    # the quantizers' keys: fold_in(fold_in(round base, client), path index),
    # one batched chain per round over the selected clients and drawing groups
    drawing = [p for p in codecs if codecs[p].draws]
    key_col = {p: j for j, p in enumerate(drawing)}
    path_idx_t = torch.tensor([codecs[p].path_idx for p in drawing],
                              dtype=torch.int64).to(dev, non_blocking=True)
    dl_codecs = (build_downlink_codecs(su.policy, group_paths, cfg.seed, use_pallas)
                 if cfg.downlink_compress else {})
    acct = RoundAccountant(codecs, dl_codecs, su.policy, group_paths, n_sel,
                           downlink_enabled=cfg.downlink_compress)
    cstate = {p: c.init_client_state(C, dev) for p, c in codecs.items()}
    shared = {p: c.init_shared_state(dev) for p, c in codecs.items()}
    # the server's codec state, without a client axis
    dl_state = {p: tuple(x[0] for x in c.init_client_state(1, dev, [SERVER_CLIENT_ID]))
                for p, c in dl_codecs.items()}
    dl_shared = {p: c.init_shared_state(dev) for p, c in dl_codecs.items()}
    local_train = make_local_train(su.arch, cfg.lr)

    # the mean's divisor lives on the device: CUDA turns division by a host
    # scalar into a reciprocal multiply, which rounds differently
    n_sel_t = torch.full((), n_sel, dtype=torch.float32, device=dev)
    res = FLResult([], [], [], [], ledger, 0.0)
    round_wall = []
    for rnd in range(cfg.rounds):
        t_round = time.perf_counter()
        ledger.begin_round()
        sel = select_round_clients(cfg.seed, rnd, C, n_sel)
        if drawing:
            sel_t = torch.tensor(sel, dtype=torch.int64).to(dev, non_blocking=True)
            per_client = prng.fold_in(round_base_key(cfg.seed, rnd, dev), sel_t)
            keys = prng.fold_in(per_client[:, None, :], path_idx_t)    # (n_sel, P, 2)

        raw_acc: Dict[str, torch.Tensor] = {}
        wire_acc: Dict[str, torch.Tensor] = {}
        stats_rows: Dict[str, list] = {p: [] for p in codecs}
        for i, c in enumerate(sel):
            batches = _stack_batches(
                [next(su.streams[c]) for _ in range(cfg.local_steps)], dev)
            local = local_train(params, batches)
            for path in group_paths:
                delta = local[path] - params[path]
                codec = codecs.get(path)
                if codec is None:
                    raw_acc[path] = delta if path not in raw_acc else raw_acc[path] + delta
                    continue
                cst = tuple(x[c] for x in cstate[path])
                # GradESTC draws from its own state's keys, SVDFed and signSGD
                # draw nothing
                key = keys[i, key_col[path]] if codec.draws else None
                cst2, rw, stats = codec.encode(cst, shared[path], key,
                                               codec.to_wire(delta))
                for x, u in zip(cstate[path], cst2):   # in place: one slot per client
                    x[c] = u
                stats_rows[path].append(stats)
                wire_acc[path] = rw if path not in wire_acc else wire_acc[path] + rw
            del local

        reds: Dict[str, torch.Tensor] = {}
        avg: Dict[str, torch.Tensor] = {}
        for path in group_paths:
            codec = codecs.get(path)
            p = params[path]
            if codec is None:
                recon_mean = raw_acc[path] / n_sel_t
            else:
                reds[path] = codec.reduce_stats(torch.stack(stats_rows[path]))
                mean_wire = wire_acc[path] / n_sel_t
                shared[path] = codec.update_shared(shared[path], reds[path], mean_wire)
                recon_mean = codec.from_wire(mean_wire, p.shape).to(p.dtype)
            avg[path] = recon_mean * cfg.server_lr
        # the broadcast is the server-lr-scaled average, compressed
        dl_reds = apply_downlink(dl_codecs, dl_state, dl_shared, avg)
        # each average is dropped once applied, so the old and new models and
        # the averages are never all alive at once; a parameter outside the
        # groups keeps the server's value, as the reference's ``_set_groups``
        params = {path: x + avg.pop(path).to(x.dtype) if path in avg else x
                  for path, x in params.items()}

        # the single host sync of the round
        acct.consume(host_fetch(pack_round_stats(reds, dl_reds, dev)), ledger, rnd)
        round_wall.append(time.perf_counter() - t_round)

        if rnd % cfg.eval_every == 0 or rnd == cfg.rounds - 1:
            la = host_fetch(su.eval_fn(params, su.eval_block))
            res.eval_rounds.append(rnd)
            res.eval_loss.append(float(la[0]))
            res.eval_acc.append(float(la[1]))
            res.uplink_bytes.append(ledger.uplink_total)
            if progress:
                progress(rnd, {"loss": res.eval_loss[-1], "acc": res.eval_acc[-1],
                               "uplink": ledger.uplink_total})

    res.wall_s = time.time() - t0
    res.extra["engine"] = "loop"
    res.extra["use_pallas"] = use_pallas
    res.extra["round_wall_s"] = round_wall
    res.extra.update(acct.metrics)
    return res
