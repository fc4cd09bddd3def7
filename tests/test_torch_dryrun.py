"""The port's dry run (``launch/dryrun.py``) on the ``meta`` device, and
its two users, ``agg_compare`` and ``hillclimb`` (CPU, no card).

tinyllama-1.1b on the single-pod mesh: prefill_32k and decode_32k give
status ``ok``; their FLOPs (per device times the chips) equal the
forward's matmuls -- 2 N tokens for the layers' weights, the head over
the positions the step forms logits for, and the plain attention's 4 B H
S_q S_kv hd a layer -- within ``FLOP_RTOL`` (torch's formulas count
matmuls alone); ``model_flops`` is the reference's formula over the
reference's own parameter groups (``_active_params``, copied here: the
reference's ``dryrun`` module sets ``XLA_FLAGS`` to 512 devices when
imported, so no test process imports it); the roofline reads the H100
figures of ``HW``.  long_500k is skipped with the reference's reason.
train_4k's dry run is in ``test_torch_dryrun_train.py``.

``agg_compare``: GradESTC's bytes per device equal its payload's shapes
(per compressed group, C clients' M over l's model shards, and A with the
next key and d_r as int32 words), FedAvg's the full f32 deltas, ratio
below 1.  ``hillclimb --list`` prints ``STEPS``, which equals the
reference's (its assignment read from the reference's source, since
importing that module sets ``XLA_FLAGS`` too)."""

import ast
import contextlib
import io
import math
from pathlib import Path
from typing import Any, Dict

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as jget  # noqa: E402
from repro.models import param_group_shapes as jgroups  # noqa: E402
from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.launch import agg_compare, dryrun, hillclimb  # noqa: E402
from repro_torch.launch.mesh import HW, make_production_mesh  # noqa: E402
from repro_torch.launch.sharding import make_plan  # noqa: E402
from repro_torch.launch.steps import compression_policy_for  # noqa: E402

FLOP_RTOL = 1e-3
ARCH = "tinyllama-1.1b"


def reference_active_params(cfg) -> float:
    """The reference's ``dryrun._active_params``, line for line."""
    total = 0.0
    for name, (shape, stack) in jgroups(cfg).items():
        n = float(math.prod(shape)) * stack
        if "moe_w" in name and cfg.n_experts:
            n *= cfg.experts_per_tok / cfg.n_experts
        if "embed" in name:
            continue
        total += n
    return total


@pytest.fixture(scope="module")
def serve_recs():
    return {s: dryrun.dryrun_pair(ARCH, s) for s in ("prefill_32k", "decode_32k")}


def _forward_flops(shape_name: str) -> float:
    """The forward's matmul FLOPs at a serve shape, from the config."""
    cfg = get_config(ARCH)
    shape = get_shape(shape_name)
    B, S, L = shape.global_batch, shape.seq_len, cfg.n_layers
    head = cfg.d_model * cfg.vocab
    layers = reference_active_params(jget(ARCH)) - head
    H, hd = cfg.n_heads, cfg.hd
    if shape.kind == "prefill":       # logits of the last position only
        return 2 * layers * B * S + 2 * B * head + 4 * B * H * S * S * hd * L
    return 2 * (layers + head) * B + 4 * B * H * 1 * S * hd * L


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_serve_shapes_run_and_count_the_forward(serve_recs, shape_name):
    rec = serve_recs[shape_name]
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["fits_hbm"]
    total = rec["flops_per_device"] * rec["chips"]
    want = _forward_flops(shape_name)
    assert abs(total - want) <= FLOP_RTOL * want, (total, want)
    tokens = get_shape(shape_name).global_batch * (
        get_shape(shape_name).seq_len if shape_name == "prefill_32k" else 1)
    assert rec["model_flops"] == 2.0 * reference_active_params(jget(ARCH)) * tokens
    r = rec["roofline"]
    assert r["compute_s"] == rec["flops_per_device"] / HW.PEAK_FLOPS_BF16
    assert r["memory_s"] == rec["bytes_per_device"] / HW.HBM_BW
    assert rec["collectives"] == {} and r["collective_s"] == 0.0
    assert rec["memory"]["peak_bytes"] == (rec["memory"]["argument_bytes"]
                                           + rec["memory"]["temp_bytes"])


def test_hw_is_the_h100_data_sheet():
    assert (HW.PEAK_FLOPS_BF16, HW.HBM_BW, HW.HBM_BYTES, HW.NVLINK_BW) == (
        989e12, 3.35e12, 80e9, 450e9)


def test_skipped_pair_carries_the_reference_reason():
    from repro.configs import SKIPS
    rec = dryrun.dryrun_pair(ARCH, "long_500k")
    assert rec["status"] == "skipped" and rec["skip_reason"] == SKIPS[(ARCH, "long_500k")]


def test_agg_compare_bytes_are_the_payload():
    rec = agg_compare.compare(ARCH)
    cfg = get_config(ARCH)
    mesh = make_production_mesh()
    plan = make_plan(mesh, cfg)
    C, tp = plan.n_clients, 16
    comp = [lp for lp in compression_policy_for(cfg, plan).plans.values() if lp.compress]
    gather = sum(C * lp.stack * (lp.l * lp.k * 4 / (tp if lp.l % tp == 0 else 1)
                                 + (4 + 1 + lp.k * lp.m) * 4) for lp in comp)
    assert rec["gradestc"]["breakdown"] == {"all-gather": gather}
    assert rec["fedavg"]["breakdown"] == {"all-reduce": sum(4 * lp.stack * lp.n for lp in comp)}
    assert rec["gradestc"]["collective_s"] == gather / HW.NVLINK_BW
    assert 0 < rec["ratio"] < 1 and rec["n_clients"] == C == 16


def test_hillclimb_lists_the_reference_steps():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert hillclimb.main(["--list"]) == 0
    lines = out.getvalue().splitlines()
    assert [ln.split()[0] for ln in lines] == list(hillclimb.STEPS)
    src = Path(__file__).resolve().parents[1] / "src/repro/launch/hillclimb.py"
    node = next(n for n in ast.parse(src.read_text()).body
                if isinstance(n, ast.AnnAssign) and n.target.id == "STEPS")
    ns = {"Dict": Dict, "Any": Any}
    exec(compile(ast.Module([node], []), str(src), "exec"), ns)
    assert hillclimb.STEPS == ns["STEPS"] and len(ns["STEPS"]) == 9
