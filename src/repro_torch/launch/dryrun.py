"""Dry run: every (architecture x input shape x mesh) on the ``meta``
device, with its per-device cost and roofline on the H100.

Port of ``repro/launch/dryrun.py``.  Where the reference lowers and
compiles each step for 256 or 512 placeholder devices and reads XLA's
``cost_analysis``, the port runs the step itself on ``meta`` tensors
(shapes, no values) under a dispatch mode that counts (``CostMode``):

  * PROOF    -- the step built and run at true depth: train shapes run
                ``fl_round_step`` with ``_auto_grad_accum`` microbatches,
                prefill and decode shapes ``make_serve_steps``; memory is
                the per-device argument bytes from the specs plus the peak
                of live temporary bytes, spread over the chips.
  * COST     -- FLOPs (``torch.utils.flop_counter``'s formulas), bytes (each
                op's input and output bytes; views move none) and the
                client-axis collectives the step makes (the bytes of the
                tensor each returns on one device), each at reduced depths
                p and 2p and extrapolated to the true depth:
                    per_layer = (cost(2p) - cost(p)) / p
                    total     = cost(p) + per_layer * (L - p)
                then divided by the chips the specs shard over.  The
                tensor-parallel collectives over ``"model"`` are not
                modelled: the port does not execute them (ROADMAP A13).
  * ROOFLINE -- compute / memory / collective seconds on :class:`HW`, one
                H100 SXM's data-sheet figures.

The record is the reference's, with ``hlo_flops_per_device`` and
``hlo_bytes_per_device`` named ``flops_per_device`` and
``bytes_per_device`` (no HLO stands behind them), ``peak_bytes_tpu``
named ``peak_bytes``, and ``compile_s`` named ``proof_s``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--method gradestc]
  python -m repro_torch.launch.dryrun --all --proof-only      # fast shardability pass
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from collections import Counter
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import SHAPES, arch_names, get_config, get_shape, is_skipped
from ..core import prng
from ..models import model
from ..models.config import ArchConfig, InputShape
from .mesh import HW, make_production_mesh
from .sharding import MeshPlan, axis_size, batch_specs, cache_specs, make_plan, named, param_specs
from .steps import (compression_policy_for, ge_state_specs, make_fl_round_step, make_ge_state,
                    make_serve_steps, serve_input_specs, train_input_specs)

__all__ = ["CostMode", "dryrun_pair", "main"]

NOT_MODELLED = "tensor-parallel collectives over 'model' (the port does not execute them)"


class CostMode(TorchDispatchMode):
    """Counts, for every op dispatched inside it: FLOPs by torch's formulas,
    the bytes of its input and output tensors (a view op moves none), and
    the peak of live bytes of the storages the ops create (an op that
    writes into an input's storage creates none)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if func.is_view:
            return out
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors((out,))
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        known = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if st._cdata in known:
                continue
            known.add(st._cdata)
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def _tensors(xs) -> list:
    """The tensors among an op's arguments or results (an aten op takes
    them alone or in one list)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _meta(spec) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def _spec_bytes(mesh, tree: Dict[str, Any], specs: Dict[str, Any]) -> float:
    """Per-device bytes of a dict of tensors under its specs."""
    return sum(t.numel() * t.element_size() / named(mesh, specs[k]).shards
               for k, t in tree.items())


# --------------------------------------------------------------------------
# per-pair runs
# --------------------------------------------------------------------------

def _reduced_depth(cfg: ArchConfig) -> int:
    """Smallest faithful depth: one full layer pattern (>= 1)."""
    return max(len(cfg.pattern), 1)


def _with_depth(cfg: ArchConfig, L: int) -> ArchConfig:
    kw: Dict[str, Any] = dict(n_layers=L)
    if cfg.family == "encdec":
        kw["encoder_layers"] = L
    return dataclasses.replace(cfg, **kw)


def _auto_grad_accum(cfg: ArchConfig, shape: InputShape, plan: MeshPlan,
                     budget: float = 2e9) -> int:
    """Microbatch count bounding per-device activation-checkpoint memory
    (~ n_layers x tokens_per_device x d_model x 2B per microbatch)."""
    C = plan.n_clients
    B_c = max(shape.global_batch // C, 1)
    inner = 1
    for a in plan.inner_batch_axes:
        inner *= axis_size(plan.mesh, a)
    tokens_dev = B_c * shape.seq_len / max(inner, 1)
    save_bytes = cfg.n_layers * tokens_dev * cfg.d_model * 2
    ga = 1
    while save_bytes / ga > budget and ga < B_c:
        ga *= 2
    while B_c % ga:
        ga //= 2
    return max(ga, 1)


def _run(cfg: ArchConfig, shape: InputShape, mesh, plan: MeshPlan, method: str,
         grad_accum: Optional[int] = None, d_static: int = 16) -> Dict[str, Any]:
    """One run of the pair's step on ``meta`` under :class:`CostMode`:
    {flops, bytes, peak temp bytes, per-device argument and output bytes,
    collectives {op: per-device bytes}}."""
    params = model.init_params(cfg, prng.PRNGKey(0, "meta"))
    trace: list = []
    if shape.kind == "train":
        policy = compression_policy_for(cfg, plan)
        step = make_fl_round_step(cfg, mesh, plan, policy, method=method, d_static=d_static,
                                  grad_accum=grad_accum or 1, trace=trace)
        ge_state = make_ge_state(cfg, policy, plan.n_clients, device="meta")
        batch = {k: _meta(v) for k, v in train_input_specs(cfg, shape, plan).items()}
        g_specs = ge_state_specs(plan, policy)
        p_specs = param_specs(plan, params)
        args = (_spec_bytes(mesh, params, p_specs)
                + _spec_bytes(mesh, ge_state.M, g_specs.M)
                + _spec_bytes(mesh, ge_state.keys, g_specs.keys)
                + _spec_bytes(mesh, batch, batch_specs(plan, batch, client_axis=True)))
        with CostMode() as cm:
            out = step(params, ge_state, batch)
        out_bytes = (_spec_bytes(mesh, out[0], p_specs) + _spec_bytes(mesh, out[1].M, g_specs.M)
                     + _spec_bytes(mesh, out[1].keys, g_specs.keys))
    else:
        if plan.huge and cfg.attn_chunk > 256:
            # bound the per-chunk score buffer when attention heads cannot
            # shard 16-way (e.g. yi-34b's 56 heads)
            cfg = dataclasses.replace(cfg, attn_chunk=256)
        prefill, decode = make_serve_steps(cfg)
        p_bytes = _spec_bytes(mesh, params, param_specs(plan, params, role="serve"))
        batch = {k: _meta(v) for k, v in
                 serve_input_specs(cfg, shape, decode=shape.kind == "decode").items()}
        b_bytes = _spec_bytes(mesh, batch, batch_specs(plan, batch, client_axis=False))
        if shape.kind == "prefill":
            args = p_bytes + b_bytes
            with CostMode() as cm:
                logits = prefill(params, batch)
        else:
            cache = model.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
            c_specs = cache_specs(plan, cache, shape.global_batch)
            c_bytes = sum(t.numel() * t.element_size() / named(mesh, s).shards
                          for t, s in zip(cache, c_specs))    # the caches are named tuples
            args = p_bytes + c_bytes + b_bytes
            with CostMode() as cm:
                logits, _ = decode(params, cache, batch)
        # the logits shard as the batch; a decode step's new cache is the
        # old one's bytes again
        out_bytes = _spec_bytes(mesh, {"x": logits},
                                batch_specs(plan, {"x": logits}, client_axis=False))
        out_bytes += c_bytes if shape.kind == "decode" else 0
    coll: Dict[str, float] = Counter()
    for op, nbytes, shards in trace:
        coll[op] += nbytes / shards
    return {"flops": cm.flops, "bytes": cm.bytes, "temp": cm.peak, "args": args,
            "out": out_bytes, "collectives": dict(coll)}


def dryrun_pair(
    arch: str, shape_name: str, *, multi_pod: bool = False,
    method: str = "gradestc", proof_only: bool = False,
    verbose: bool = True, cfg_overrides: Optional[Dict[str, Any]] = None,
    tag: str = "",
) -> Dict[str, Any]:
    """Run the dry run for one (arch, shape, mesh); returns the record.

    ``cfg_overrides``: dataclasses.replace kwargs applied to the arch config
    (the hillclimb's switches)."""
    t_start = time.time()
    shape = get_shape(shape_name)
    cfg0 = get_config(arch)
    if cfg_overrides:
        cfg0 = dataclasses.replace(cfg0, **cfg_overrides)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "method": method if shape.kind == "train" else "-",
        "kind": shape.kind, "tag": tag,
        "cfg_overrides": dict(cfg_overrides or {}),
    }
    skip = is_skipped(arch, shape_name)
    if skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = skip
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.chips
    plan = make_plan(mesh, cfg0)
    rec["chips"] = chips
    rec["tp_axes"] = list(plan.tp_axes)
    rec["client_axes"] = list(plan.client_axes)
    rec["n_clients"] = plan.n_clients
    # grad-accum from the TRUE depth: the reduced-depth cost runs would
    # otherwise take ga=1 and miss the per-microbatch weight re-streaming
    ga_true = None
    if shape.kind == "train":
        ga_true = cfg0.grad_accum_override or _auto_grad_accum(cfg0, shape, plan)
        rec["grad_accum"] = ga_true

    # ---- 1. PROOF: true depth ---------------------------------------------
    t0 = time.time()
    proof = _run(cfg0, shape, mesh, plan, method, grad_accum=ga_true)
    rec["proof_s"] = round(time.time() - t0, 1)
    temp = proof["temp"] / chips
    rec["memory"] = {
        "argument_bytes": int(proof["args"]),
        "output_bytes": int(proof["out"]),
        # the peak of live temporaries of the whole step, spread evenly
        "temp_bytes": int(temp),
        "peak_bytes": int(proof["args"] + temp),
    }
    rec["fits_hbm"] = rec["memory"]["peak_bytes"] <= HW.HBM_BYTES
    rec["proof_collectives"] = proof["collectives"]
    rec["collectives_not_modelled"] = NOT_MODELLED
    rec["status"] = "ok"
    if proof_only:
        rec["wall_s"] = round(time.time() - t_start, 1)
        return rec

    # ---- 2. COST: reduced depths p and 2p ---------------------------------
    p = _reduced_depth(cfg0)
    # the cost runs cap the microbatches at 4; the residual (ga_true -
    # ga_cost) microbatches re-stream the layer weights ~3x each (fwd + bwd
    # + remat-fwd reads) -- added analytically below, as the reference does
    ga_cost = min(ga_true, 4) if ga_true else None
    costs = {}
    for mult in (1, 2):
        cfg_c = _with_depth(cfg0, p * mult)
        costs[mult] = _run(cfg_c, shape, mesh, make_plan(mesh, cfg_c), method,
                           grad_accum=ga_cost)

    L_true = cfg0.n_layers

    def extrap(c1: float, c2: float) -> float:
        return c1 + max(c2 - c1, 0.0) / p * (L_true - p)

    flops = extrap(costs[1]["flops"], costs[2]["flops"]) / chips
    bytes_acc = extrap(costs[1]["bytes"], costs[2]["bytes"]) / chips
    if ga_true and ga_cost and ga_true > ga_cost:
        rec["ga_cost"] = ga_cost
        extra_stream = (ga_true - ga_cost) * 3.0 * plan.param_bytes / chips
        rec["ga_stream_correction_bytes"] = extra_stream
        bytes_acc += extra_stream
    c1s, c2s = costs[1]["collectives"], costs[2]["collectives"]
    coll_total = {op: extrap(c1s.get(op, 0.0), c2s.get(op, 0.0)) for op in set(c1s) | set(c2s)}
    coll_bytes = sum(coll_total.values())

    rec["flops_per_device"] = flops
    rec["bytes_per_device"] = bytes_acc
    rec["collective_bytes_per_device"] = coll_bytes
    rec["collectives"] = coll_total

    # ---- 3. ROOFLINE ------------------------------------------------------
    compute_s = flops / HW.PEAK_FLOPS_BF16
    memory_s = bytes_acc / HW.HBM_BW
    collective_s = coll_bytes / HW.NVLINK_BW
    rec["roofline"] = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": max(("compute", compute_s), ("memory", memory_s),
                          ("collective", collective_s), key=lambda kv: kv[1])[0],
    }

    # MODEL_FLOPS = 6 * N_active * tokens (train: fwd + bwd); 2 * N_active
    # per token for prefill and decode
    n_active = _active_params(cfg0)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2.0 * n_active * tokens
    else:
        tokens = shape.global_batch
        model_flops = 2.0 * n_active * tokens
    rec["model_flops"] = model_flops
    rec["useful_ratio"] = model_flops / (flops * chips) if flops else 0.0
    rec["wall_s"] = round(time.time() - t_start, 1)
    return rec


def _active_params(cfg: ArchConfig) -> float:
    """Parameters touched per token (MoE counts top-k experts only)."""
    total = 0.0
    for name, (shape, stack) in model.param_group_shapes(cfg).items():
        n = float(math.prod(shape)) * stack
        if "moe_w" in name and cfg.n_experts:
            n *= cfg.experts_per_tok / cfg.n_experts
        if "embed" in name:       # lookup, not matmul
            continue
        total += n
    return total


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _append_report(path: str, rec: Dict[str, Any]):
    data = []
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data = [r for r in data if not (
        r["arch"] == rec["arch"] and r["shape"] == rec["shape"]
        and r["multi_pod"] == rec["multi_pod"] and r.get("method") == rec.get("method")
    )]
    data.append(rec)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--method", default="gradestc", choices=["gradestc", "fedavg"])
    ap.add_argument("--proof-only", action="store_true")
    ap.add_argument("--report", default="reports/torch/dryrun.json")
    args = ap.parse_args(argv)

    if args.all:
        pairs = [(a, s) for a in arch_names() for s in SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
    failures = 0
    for arch, shape in pairs:
        tag = f"{arch} x {shape} ({'2pod' if args.multi_pod else '1pod'})"
        try:
            rec = dryrun_pair(arch, shape, multi_pod=args.multi_pod,
                              method=args.method, proof_only=args.proof_only)
        except Exception as e:  # noqa: BLE001 -- a failing pair is recorded, the rest run
            rec = {
                "arch": arch, "shape": shape, "multi_pod": args.multi_pod,
                "method": args.method, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:],
            }
            failures += 1
        _append_report(args.report, rec)
        status = rec["status"]
        extra = ""
        if status == "ok":
            mem = rec["memory"]["peak_bytes"] / 2**30
            extra = f"peak={mem:.2f}GiB fits={rec['fits_hbm']} proof={rec['proof_s']}s"
            if "roofline" in rec:
                r = rec["roofline"]
                extra += (f" compute={r['compute_s']*1e3:.1f}ms "
                          f"mem={r['memory_s']*1e3:.1f}ms "
                          f"coll={r['collective_s']*1e3:.1f}ms "
                          f"-> {r['bottleneck']}")
        elif status == "skipped":
            extra = rec["skip_reason"]
        else:
            extra = rec["error"][:200]
        print(f"[{status:7s}] {tag:48s} {extra}", flush=True)
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
