"""Hillclimb runner: apply one named optimization configuration to an
(arch, shape) pair, re-run the dry run, and append the record (with the
hypothesis text) to reports/torch/perf_iterations.json.

Port of ``repro/launch/hillclimb.py`` over the port's dry run
(``launch.dryrun.dryrun_pair``, the ``meta`` device).  ``STEPS`` is the
reference's, word for word; every override is a field of the port's
``ArchConfig``.  ``--step flash_whatif`` measures the plain attention
component alone on ``meta`` at the pair's shape and puts the flash
kernel's q + k + v + o traffic in its place.

Usage:
  python -m repro_torch.launch.hillclimb --arch granite-moe-1b-a400m \
      --shape train_4k --step moe_sg
  python -m repro_torch.launch.hillclimb --list
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict

__all__ = ["STEPS", "flash_whatif", "main"]

#: name -> (cfg overrides, hypothesis text); the texts are the reference's, written
#: against its XLA lowerings for the TPU mesh
STEPS: Dict[str, Dict[str, Any]] = {
    "baseline": dict(
        overrides={},
        hypothesis="paper-faithful baseline (re-measurement)",
    ),
    "moe_sg": dict(
        overrides={"moe_stop_gradient_dispatch": True},
        hypothesis=(
            "the MoE dispatch/combine one-hots are integer-valued, so their "
            "cotangents are mathematically zero; stop_gradient removes the "
            "f32 (S,E,C) backward all-gathers (HLO showed 60 GiB of them) "
            "-> collective term should drop several-fold; FLOPs slightly "
            "down; forward numerics identical (verified bit-exact)"
        ),
    ),
    "pad_vocab": dict(
        overrides={"pad_vocab_multiple": 16},
        hypothesis=(
            "vocab not divisible by tp=16 leaves the LM head unsharded; "
            "every CE chunk all-reduces (B,cs,V) f32 partials (12.3 GiB on "
            "granite). Megatron-style padding shards the head -> those "
            "all-reduces become (B,cs) scalars"
        ),
    ),
    "moe_sg+pad": dict(
        overrides={"moe_stop_gradient_dispatch": True, "pad_vocab_multiple": 16},
        hypothesis="compose moe_sg and pad_vocab",
    ),
    "moe_sg+pad+group": dict(
        overrides={"moe_stop_gradient_dispatch": True, "pad_vocab_multiple": 16,
                   "moe_group": 1024},
        hypothesis=(
            "dispatch bytes scale with group size (S_g x E x C, C ~ S_g); "
            "1024-token groups cut the one-hot traffic ~4x -> memory term "
            "down on MoE train"
        ),
    ),
    "gqa": dict(
        overrides={"gqa_native": True},
        hypothesis=(
            "repeat_kv materializes H/KV-times larger K/V per layer "
            "(8x for qwen2/llama3); contracting the grouped layout reads "
            "K/V once -> memory term down on attention-heavy prefill"
        ),
    ),
    "gqa+chunk2k": dict(
        overrides={"gqa_native": True, "attn_chunk": 2048},
        hypothesis=(
            "larger q-chunks amortize K/V re-reads across chunks: HBM "
            "traffic for K/V scales with n_chunks; 2048-chunks halve it if "
            "score memory still fits"
        ),
    ),
    "gqa+ce1k": dict(
        overrides={"gqa_native": True, "ce_chunk": 1024},
        hypothesis="halve CE-chunk count: fewer head re-reads in fwd+bwd",
    ),
    "moe_group_512": dict(
        overrides={"moe_stop_gradient_dispatch": True, "pad_vocab_multiple": 16,
                   "moe_group": 512},
        hypothesis="push dispatch-group scaling further (512-token groups)",
    ),
}


def _load(path: str) -> list:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return []


def _append(path: str, rec: Dict[str, Any]) -> None:
    data = _load(path)
    data.append(rec)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def flash_whatif(arch: str, shape_name: str, report: str,
                 baseline: str = "reports/torch/dryrun.json") -> Dict[str, Any]:
    """What-if analysis: replace the plain attention path's HBM traffic with
    the flash kernel's (``kernels/flash_attention.py``, the eval forward's
    kernel on the card).  The plain attention component is measured alone
    on ``meta`` at the pair's shape (its bytes per device, one layer) and
    the kernel's q + k + v + o traffic substituted in the baseline
    record's memory term."""
    import torch

    from ..configs import get_config, get_shape
    from ..models.layers import attention, repeat_kv
    from .dryrun import CostMode
    from .mesh import HW, make_production_mesh
    from .sharding import make_plan

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=False)
    plan = make_plan(mesh, cfg)
    chips = mesh.chips
    qc = 256 if plan.huge and cfg.attn_chunk > 256 else cfg.attn_chunk

    B = shape.global_batch
    S = shape.seq_len + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.empty((B, S, H, hd), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((B, S, KV, hd), dtype=torch.bfloat16, device="meta")
    with torch.no_grad(), CostMode() as cm:
        attention(q, repeat_kv(kv, H // KV), repeat_kv(kv, H // KV), causal=True, q_chunk=qc)
    plain_bytes = cm.bytes / chips                      # per device, 1 layer
    flash_bytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * 2 / chips

    base = None
    for path in (baseline, report):
        for r in _load(path):
            if ((r["arch"], r["shape"], r.get("multi_pod")) == (arch, shape_name, False)
                    and r["status"] == "ok" and not r.get("tag") and "roofline" in r):
                base = r
    if base is None:
        raise ValueError(f"no baseline record of {arch} x {shape_name} in {baseline} or "
                         f"{report}: run the dry run of the pair first")
    L = cfg.n_layers
    saved = max(plain_bytes - flash_bytes, 0.0) * L
    mem_new = base["roofline"]["memory_s"] - saved / HW.HBM_BW
    rec = dict(base)
    rec["tag"] = "flash_whatif"
    rec["hypothesis"] = (
        "the f32 score/prob matrices written to HBM per (q-chunk x layer) "
        "dominate prefill memory; the fused flash kernel keeps them on chip "
        "so per-layer attention traffic collapses to q+k+v+o"
    )
    rec["attention_component_bytes_per_layer"] = plain_bytes
    rec["flash_bytes_per_layer"] = flash_bytes
    rec["roofline"] = dict(base["roofline"])
    rec["roofline"]["memory_s"] = mem_new
    rec["roofline"]["bottleneck"] = max(
        ("compute", rec["roofline"]["compute_s"]),
        ("memory", mem_new),
        ("collective", rec["roofline"]["collective_s"]),
        key=lambda kv: kv[1])[0]
    print(f"[flash_whatif] {arch} x {shape_name}: attention component "
          f"{plain_bytes/2**30:.2f} GiB/layer -> flash {flash_bytes/2**30:.3f} "
          f"GiB/layer; memory term {base['roofline']['memory_s']*1e3:.0f}ms "
          f"-> {mem_new*1e3:.0f}ms (bottleneck {rec['roofline']['bottleneck']})")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--step", default=None)
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of ArchConfig overrides (ad-hoc step)")
    ap.add_argument("--hypothesis", default="")
    ap.add_argument("--method", default="gradestc")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--report", default="reports/torch/perf_iterations.json")
    args = ap.parse_args(argv)

    if args.list:
        for name, s in STEPS.items():
            print(f"{name:20s} {s['overrides']}")
        return 0

    if args.step == "flash_whatif":
        _append(args.report, flash_whatif(args.arch, args.shape, args.report))
        return 0

    from .dryrun import dryrun_pair

    if args.overrides:
        step = dict(overrides=json.loads(args.overrides),
                    hypothesis=args.hypothesis or "(ad-hoc)")
        args.step = args.step or "adhoc"
    else:
        step = STEPS[args.step]
    rec = dryrun_pair(args.arch, args.shape, method=args.method,
                      cfg_overrides=step["overrides"], tag=args.step)
    rec["hypothesis"] = step["hypothesis"]
    _append(args.report, rec)

    if rec["status"] == "ok" and "roofline" in rec:
        r = rec["roofline"]
        print(f"[{args.step}] {args.arch} x {args.shape}: "
              f"compute={r['compute_s']*1e3:.1f}ms mem={r['memory_s']*1e3:.1f}ms "
              f"coll={r['collective_s']*1e3:.1f}ms -> {r['bottleneck']} "
              f"(peak {rec['memory']['peak_bytes']/2**30:.2f}GiB)")
    else:
        print(f"[{args.step}] status={rec['status']}: {rec.get('error', '')[:200]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
