"""Aggregation-collective comparison: FedAvg vs GradESTC (the paper's
uplink, isolated).

Port of ``repro/launch/agg_compare.py``.  The FL uplink on the mesh is the
cross-client aggregation collective:
  FedAvg   : all-reduce of the full f32 deltas over the client axis (each
             client's delta whole on its devices, as the reference's)
  GradESTC : all-gather of each client's basis M (l x k) and coefficients
             A (k x m; with d_r and the next key as int32 words), then the
             local einsum
Both aggregation steps (``launch.steps.make_aggregate``) run alone on the
``meta`` device at the production policy's shapes on the single-pod mesh,
and each records the collectives it makes: bytes per device (the tensor
each returns on one device), the seconds on :class:`HW`'s NVLink figure,
and their ratio.

Usage: python -m repro_torch.launch.agg_compare [--arch gemma3-1b]
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter

import torch

from ..configs import arch_names, get_config
from ..core import prng
from ..models import model
from .dryrun import CostMode
from .mesh import HW, make_production_mesh
from .sharding import make_plan
from .steps import compression_policy_for, make_aggregate, make_ge_state

__all__ = ["compare", "main"]


def compare(arch: str, d_static: int = 16):
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=False)
    plan = make_plan(mesh, cfg)
    C = plan.n_clients
    policy = compression_policy_for(cfg, plan)
    comp = {p: lp for p, lp in policy.plans.items() if lp.compress}
    params = model.init_params(cfg, prng.PRNGKey(0, "meta"))
    ge_state = make_ge_state(cfg, policy, C, device="meta")

    rec = {"arch": arch, "n_clients": C}
    for name in ("fedavg", "gradestc"):
        trace: list = []
        # the deltas as the reference lays them out here: the client axis
        # sharded, every other dim whole
        agg = make_aggregate(mesh, plan, policy, method=name, d_static=d_static, trace=trace,
                             delta_specs={p: (None,) * (1 + len(lp.shape))
                                          for p, lp in comp.items()})
        deltas = {p: torch.empty((C, lp.stack) + lp.shape, dtype=torch.float32, device="meta")
                  for p, lp in comp.items()}
        with CostMode() as cm:
            agg(params, ge_state, deltas)
        coll: Counter = Counter()
        for op, nbytes, shards in trace:
            coll[op] += nbytes / shards
        total = sum(coll.values())
        rec[name] = {
            "collective_bytes_per_device": total,
            "collective_s": total / HW.NVLINK_BW,
            "breakdown": dict(coll),
            "flops": cm.flops / mesh.chips,
        }
    rec["ratio"] = (rec["gradestc"]["collective_bytes_per_device"]
                    / max(rec["fedavg"]["collective_bytes_per_device"], 1.0))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--report", default="reports/torch/agg_compare.json")
    args = ap.parse_args(argv)
    # an arch with one client on the single-pod mesh aggregates nothing
    mesh = make_production_mesh(multi_pod=False)
    archs = [args.arch] if args.arch else [
        a for a in arch_names() if make_plan(mesh, get_config(a)).n_clients > 1]
    out = []
    for a in archs:
        try:
            rec = compare(a)
        except Exception as e:  # noqa: BLE001 -- a failing arch is recorded, the rest run
            rec = {"arch": a, "error": f"{type(e).__name__}: {e}"}
        out.append(rec)
        if "error" in rec:
            print(f"{a:24s} ERROR {rec['error'][:120]}", flush=True)
        else:
            f, g = rec["fedavg"], rec["gradestc"]
            print(f"{a:24s} fedavg={f['collective_bytes_per_device']/2**20:9.1f}MiB "
                  f"({f['collective_s']*1e3:7.3f}ms)  "
                  f"gradestc={g['collective_bytes_per_device']/2**20:9.1f}MiB "
                  f"({g['collective_s']*1e3:7.3f}ms)  ratio={rec['ratio']:.4f}",
                  flush=True)
    os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
    with open(args.report, "w") as fjson:
        json.dump(out, fjson, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
