#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit.  Phases, each printing its own lines; any failure raises and the
script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: compile ``src/repro_torch/kernels/csrc/gradestc.cu`` with nvcc;
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the main path's shapes (and a ragged one), ``||diff||_F <= 1e-5
   ||G||_F`` and the exact M = 0 case; CUDA-event times (median of 20
   after warm-up) of the kernel, the plain version and the library call,
   beside the data-sheet bound;
4. slice: ``run_fl`` (loop engine) at TinyLlama-1.1B width, cut to 2
   layers and a 4096 vocab, for gradestc then fedavg; launch counts,
   uplink bits, eval loss, ms/round and peak memory; every host sync of
   each run (torch's sync debug mode), by the port's source line that made
   it: only ``host_fetch`` (one per round and per eval) and cuSOLVER's
   error checks in ``core/rsvd.py`` may sync;
5. card vs CPU: a small config through the port on both; per-round uplink
   equal, eval loss within the CPU parity tests' tolerance.

``python3 chip_smoke.py --profile`` adds, after phase 4, a gradestc run
whose round 1 is traced by ``torch.profiler``: the device idle share of that
round and the top ops and kernels by device time.

The line before the last is the ``{"kernels": [...]}`` JSON summary and
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository beside it, the script fails and prints no
result.  It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (NVIDIA): HBM3 bandwidth and FP32 on the CUDA cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
KERNEL_RTOL = 1e-5        # ||kernel - plain||_F <= KERNEL_RTOL * ||G||_F
LOSS_RTOL = 1e-5          # eval-loss tolerance of the CPU parity tests


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class SyncCounter:
    """Counts the card's host syncs inside the ``with`` block, keyed by the
    innermost line of the port (``src/repro_torch``) on the stack: torch's
    sync debug mode in "warn" raises one warning per synchronizing call."""

    def __enter__(self):
        self.sites = collections.Counter()
        self._cw = warnings.catch_warnings()
        self._cw.__enter__()
        warnings.simplefilter("always")
        self._show = warnings.showwarning
        warnings.showwarning = self._on_warning
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._cw.__exit__(*exc)
        return False

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return self._show(message, category, filename, lineno, file, line)
        src = ROOT / "src"
        site = f"{filename}:{lineno}"
        for fr in reversed(traceback.extract_stack()):
            if "repro_torch" in fr.filename:
                site = f"{Path(fr.filename).resolve().relative_to(src)}:{fr.lineno}"
                break
        self.sites[site] += 1


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def slice_arch():
    """TinyLlama-1.1B at full width, cut to 2 layers, a 4096 vocab, f32."""
    from repro_torch.configs.tinyllama_1_1b import CONFIG

    return dataclasses.replace(CONFIG, n_layers=2, vocab=4096, dtype="float32",
                               remat=False)


def small_arch():
    from repro_torch.models.config import ArchConfig

    return ArchConfig(name="parity-small", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=256, vocab=64, dtype="float32")


def phase_kernels(shapes, group_counts):
    """Check and time both kernels at each (L, l, m, k); returns the JSON rows'
    measured numbers, summed over one client's round (group_counts[shape]
    launches of each shape)."""
    from repro_torch.kernels import gradestc_decode, gradestc_encode, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    tot = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
           for name in ("encode", "decode")}
    bound_by = {}
    for shape in shapes:
        L, l, m, k = shape
        M = torch.linalg.qr(torch.randn(L, l, k, device="cuda", generator=gen)).Q.contiguous()
        G = torch.randn(L, l, m, device="cuda", generator=gen) * 1e-3
        A, E = gradestc_encode.encode(M, G)
        A_ref, E_ref = ref.encode_ref(M, G)
        Ghat = gradestc_decode.decode(M, A_ref.contiguous())
        Ghat_ref = ref.decode_ref(M, A_ref)
        Z = torch.zeros_like(M)
        A0, E0 = gradestc_encode.encode(Z, G)
        torch.cuda.synchronize()
        gn = float(G.norm())
        rel = {"A": float((A - A_ref).norm()) / gn, "E": float((E - E_ref).norm()) / gn,
               "Ghat": float((Ghat - Ghat_ref).norm()) / gn}
        exact0 = bool((A0 == 0).all()) and torch.equal(E0, G)
        enc_err = max(float((A - A_ref).abs().max()), float((E - E_ref).abs().max()))
        dec_err = float((Ghat - Ghat_ref).abs().max())
        if max(rel.values()) > KERNEL_RTOL or not exact0:
            raise AssertionError(f"kernel mismatch at {shape}: rel={rel} M=0 exact={exact0}")

        At = A_ref.contiguous()
        t = {
            "encode": (time_ms(lambda: gradestc_encode.encode(M, G)),
                       time_ms(lambda: ref.encode_ref(M, G)),
                       time_ms(lambda: torch.baddbmm(G, M, torch.matmul(M.mT, G), alpha=-1.0))),
            "decode": (time_ms(lambda: gradestc_decode.decode(M, At)),
                       time_ms(lambda: ref.decode_ref(M, At)),
                       time_ms(lambda: torch.matmul(M, At))),
        }
        b = {"encode": bound_ms(4 * L * (l * k + 2 * l * m + k * m), L * l * m * (4 * k + 1)),
             "decode": bound_ms(4 * L * (l * k + k * m + l * m), 2 * L * l * m * k)}
        log("kernels", f"L={L} l={l} m={m} k={k} rel_err A={rel['A']:.3e} E={rel['E']:.3e} "
                       f"Ghat={rel['Ghat']:.3e} M=0 exact={exact0}")
        for name in ("encode", "decode"):
            ms, plain, lib = t[name]
            bms, by = b[name]
            bound_by[name] = by
            log("kernels", f"  {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                           f"library {lib:.4f} ms, bound {bms:.4f} ms ({by}), "
                           f"launches/client-round {group_counts.get(shape, 0)}")
            w = group_counts.get(shape, 0)
            row = tot[name]
            row["err"] = max(row["err"], enc_err if name == "encode" else dec_err)
            row["ms"] += w * ms
            row["plain_ms"] += w * plain
            row["library_ms"] += w * lib
            row["bound_ms"] += w * bms
    return tot, bound_by


def check_syncs(method: str, sites, fetches: int, expect_fetches: int) -> None:
    """Print a run's host syncs by site; fail unless ``host_fetch`` made
    exactly its counted fetches and every other sync is cuSOLVER's error
    check in ``core/rsvd.py`` (gradestc only)."""
    fetch_syncs = sum(n for s, n in sites.items() if s.startswith("repro_torch/core/metrics.py"))
    other = {s: n for s, n in sites.items() if not s.startswith("repro_torch/core/metrics.py")}
    log("syncs", f"{method}: {sum(sites.values())} host syncs: host_fetch {fetch_syncs} "
                 f"(counted {fetches}, expected {expect_fetches}); others {dict(sorted(other.items()))}")
    allowed = ("repro_torch/core/rsvd.py",) if method == "gradestc" else ()
    bad = {s: n for s, n in other.items() if not s.startswith(allowed)}
    if fetch_syncs != fetches or fetches != expect_fetches or bad:
        raise AssertionError(f"{method}: unexpected host syncs {bad}, host_fetch "
                             f"{fetch_syncs}/{fetches}/{expect_fetches}")


def run_slice(method: str, arch, device: str, progress=None, **kw):
    from repro_torch.fl.simulation import FLConfig, run_fl

    cfg = FLConfig(method=method, arch=arch, device=device, engine="loop", **kw)
    return run_fl(cfg, progress)


def phase_profile(arch, kw) -> None:
    """``--profile``: trace round 1 (a steady round, with its eval) of a
    gradestc run at slice width; print the device-busy share of that window,
    the top ops and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    marks = []

    def on_round_end(rnd, _):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        prof.step()          # rounds 0 | 1 | after: the trace holds round 1

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run_slice("gradestc", arch, "cuda", **{**kw, "rounds": 2, "eval_every": 1},
                  progress=on_round_end)

    def dev(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    events = prof.key_averages()
    # the step range is recorded on the device track too; it is no kernel
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and not e.key.startswith("ProfilerStep")), key=dev, reverse=True)
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU and dev(e) > 0),
                 key=dev, reverse=True)
    busy_ms = sum(dev(e) for e in kernels) / 1e3
    window_ms = 1e3 * (marks[1] - marks[0])
    log("profile", f"round 1 + eval, profiler on: wall {window_ms:.1f} ms, kernels busy "
                   f"{busy_ms:.1f} ms, device idle share {1 - busy_ms / window_ms:.3f}")
    for kind, rows in (("op", ops[:12]), ("kernel", kernels[:12])):
        for e in rows:
            log("profile", f"{kind:6s} {dev(e) / 1e3:9.2f} ms {e.count:6d} calls  {e.key[:80]}")


def main() -> int:
    profile_run = "--profile" in sys.argv[1:]
    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs only on the card",
              file=sys.stderr)
        return 2
    smi = nvidia_smi("name,power.limit")
    log("device", smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
                  f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
                  f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, gradestc_decode, gradestc_encode

    # ---- 2. build
    t0 = time.perf_counter()
    _build.load()
    log("build", f"built in {time.perf_counter() - t0:.2f} s into {_build.last_build['dir']}")
    for line in _build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())

    # ---- 3. kernels, at the shapes the slice gives them
    from repro_torch.core import metrics
    from repro_torch.core.policy import make_policy
    from repro_torch.models import model

    arch = slice_arch()
    policy = make_policy(model.param_group_shapes(arch), min_params=4096)
    group_counts = {}
    for plan in policy.plans.values():
        if plan.compress:
            shape = (plan.stack, plan.l, plan.m, plan.k)
            group_counts[shape] = group_counts.get(shape, 0) + 1
            log("kernels", f"group {plan.name}: L={plan.stack} l={plan.l} m={plan.m} k={plan.k}")
    shapes = sorted(group_counts) + [(2, 1024, 500, 64)]
    tot, bound_by = phase_kernels(shapes, group_counts)
    log("kernels", f"kernels: gradestc_encode, gradestc_decode "
                   f"({sum(group_counts.values())} launches each per client-round)")
    log("kernels", "clocks/power after timing: "
        + nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))

    # ---- 4. the slice at TinyLlama width
    n_clients, rounds = 4, 3
    kw = dict(n_clients=n_clients, participation=1.0, rounds=rounds, local_steps=2,
              batch=4, seq=256, eval_every=1)
    launches = {}
    runs = {}
    for method in ("gradestc", "fedavg"):
        torch.cuda.reset_peak_memory_stats()
        gradestc_encode.reset_launch_count()
        gradestc_decode.reset_launch_count()
        metrics.reset_host_sync_count()
        with SyncCounter() as syncs:
            res = run_slice(method, arch, "cuda", **kw)
            torch.cuda.synchronize()
        launches[method] = (gradestc_encode.launch_count(), gradestc_decode.launch_count())
        runs[method] = res
        check_syncs(method, syncs.sites, metrics.host_sync_count(),
                    rounds + len(res.eval_rounds))
        ms_round = 1e3 * statistics.mean(res.extra["round_wall_s"][1:])
        log("slice", f"{method}: ms/round(rounds 1-2) {ms_round:.1f} "
                     f"uplink bytes {res.ledger.uplink_total:.0f} per-round "
                     f"{res.ledger.per_round_uplink} eval loss {res.eval_loss} "
                     f"launches encode/decode {launches[method]} "
                     f"max_memory_allocated {torch.cuda.max_memory_allocated()} B "
                     f"wall {res.wall_s:.1f} s")
        if not all(math.isfinite(x) for x in res.eval_loss):
            raise AssertionError(f"{method}: non-finite eval loss {res.eval_loss}")
    expect = sum(group_counts.values()) * n_clients * rounds
    if launches["gradestc"] != (expect, expect) or launches["fedavg"] != (0, 0):
        raise AssertionError(f"launch counts {launches}, expected ({expect}, {expect}) / (0, 0)")
    n_params = sum(math.prod(shape) * stack
                   for shape, stack in model.param_group_shapes(arch).values())
    raw_bits = 32 * n_params * n_clients * rounds
    if n_params != 104_867_840 or runs["fedavg"].ledger.uplink_bits != raw_bits:
        raise AssertionError(f"fedavg uplink {runs['fedavg'].ledger.uplink_bits} bits, "
                             f"params {n_params}, expected {raw_bits}")
    if not runs["gradestc"].ledger.uplink_bits < raw_bits:
        raise AssertionError("gradestc uplink is not below fedavg's")
    log("slice", f"gradestc/fedavg uplink = "
                 f"{runs['gradestc'].ledger.uplink_bits / raw_bits:.4f}")
    if profile_run:
        phase_profile(arch, kw)

    # ---- 5. card vs CPU at a small config, both through the port
    small = dict(rounds=3, n_clients=3, local_steps=1, batch=2, seq=16, eval_every=2)
    for method in ("gradestc", "fedavg"):
        gpu = run_slice(method, small_arch(), "cuda", **small)
        cpu = run_slice(method, small_arch(), "cpu", **small)
        rel = max(abs(a - b) / abs(b) for a, b in zip(gpu.eval_loss, cpu.eval_loss))
        log("parity", f"{method}: uplink/round card {gpu.ledger.per_round_uplink} "
                      f"cpu {cpu.ledger.per_round_uplink}; eval loss card {gpu.eval_loss} "
                      f"cpu {cpu.eval_loss} max rel diff {rel:.3e}")
        if gpu.ledger.per_round_uplink_bits != cpu.ledger.per_round_uplink_bits:
            raise AssertionError(f"{method}: per-round uplink differs between card and CPU")
        if rel > LOSS_RTOL:
            raise AssertionError(f"{method}: eval loss differs by {rel:.3e} > {LOSS_RTOL}")

    # ---- 6. summary lines
    src = "src/repro_torch/kernels/csrc/gradestc.cu"
    rows = []
    for name, replaces in (("encode", "src/repro/kernels/gradestc_encode.py:55"),
                           ("decode", "src/repro/kernels/gradestc_decode.py:33")):
        t = tot[name]
        rows.append({
            "name": f"gradestc_{name}", "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": launches["gradestc"][0 if name == "encode" else 1],
            "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": bound_by[name],
            "library_ms": t["library_ms"],
        })
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
