"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``csrc/*.cu`` compiles into one shared library with a plain C
interface: one nvcc per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         -Xptxas -v -c -o <name>.o csrc/<name>.cu          (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libgradestc.so *.o

The library lands in ``build/repro_torch_kernels/<hash>/`` under the
repository root (``launch.compile_cache.enable_compilation_cache`` moves
that root), keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.  Every load records one
event in ``events``: when it ended, its seconds and whether it ran nvcc
(``launch.compile_cache.CompileWatcher`` reads them).  Nothing here runs at
import time: the CPU tests import every module without a CUDA toolkit.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["load", "launch", "stream", "device", "BUILD_ROOT", "DEFAULT_BUILD_ROOT",
           "NVCC_FLAGS", "last_build", "launches", "events", "loaded"]

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
BUILD_ROOT = DEFAULT_BUILD_ROOT
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: C signatures of the library's entry points
_SIGNATURES = {
    "gradestc_encode_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gradestc_decode_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "gradestc_coeff_quant_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gradestc_encode_quant_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "gradestc_decode_wire_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "wire_sign_pack_f32": [_P, _P, _P, _P, _L, _F, _P],
    "wire_sign_unpack_f32": [_P, _P, _P, _L, _L, _I, _P],
    "wire_quant_pack_f32": [_P, _P, _P, _P, _L, _I, _L, _I, _P],
    "wire_unpack_dequant_f32": [_P, _P, _P, _L, _I, _L, _I, _P],
    "quant_block_quant_f32": [_P, _P, _P, _P, _L, _I, _I, _L, _I, _P],
    "quant_block_dequant": [_P, _P, _P, _L, _I, _I, _I, _L, _I, _P],
    "wire_coeff_dequant_f32": [_P, _P, _P, _L, _I, _L, _I, _P],
    "flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                            _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None
#: what the last build did: {"seconds": float, "dir": str, "log": str}
last_build: Dict[str, object] = {}
#: kernel launches by name, one per wrapper call that launched (read and
#: reset through ``ops.launch_counts``/``ops.reset_launch_counts``)
launches: "collections.Counter[str]" = collections.Counter()
#: one (perf_counter at its end, seconds, built) per load of the library:
#: ``built`` when it ran nvcc, else it loaded an existing build
events: List[Tuple[float, float, bool]] = []


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix == ".cu")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _compile(out: Path) -> Path:
    """nvcc each source to an object, all at once, then link the library;
    the compilers' output (ptxas registers and spills) goes to
    ``<out>/nvcc.log``, which :func:`load` reads into ``last_build``."""
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = out / f"{src.stem}.{os.getpid()}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, proc in procs:
        text = proc.communicate()[0]
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = out / f"libgradestc.{os.getpid()}.so"
    if not failed:
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *(str(obj) for _, obj, _ in procs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    text = "\n".join(log)
    (out / "nvcc.log").write_text(text)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{text}")
    return tmp


def load() -> ctypes.CDLL:
    """The kernels' library, compiled from ``csrc/*.cu`` unless this build
    of the sources exists, then loaded once per process."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out = _build_dir()
    so = out / "libgradestc.so"
    t0 = time.perf_counter()
    built = not so.exists()
    if built:
        out.mkdir(parents=True, exist_ok=True)
        os.replace(_compile(out), so)       # atomic: concurrent builds agree
    # a build made earlier (by another process) left its compilers' output
    log = out / "nvcc.log"
    last_build.update(seconds=time.perf_counter() - t0, dir=str(out),
                      log=log.read_text() if log.exists() else "")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _LIB = lib
    t1 = time.perf_counter()
    events.append((t1, t1 - t0, built))
    return lib


def loaded() -> bool:
    """Whether this process has loaded the library."""
    return _LIB is not None


def launch(name: str, fn: str, *args) -> None:
    """Call the library's entry point ``fn`` and count one launch of kernel
    ``name``; raise if the launch failed (the entry points return
    ``cudaGetLastError()``)."""
    rc = getattr(_LIB or load(), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")
    launches[name] += 1


def stream(x: torch.Tensor) -> int:
    """The current CUDA stream of ``x``'s device, as the entry points take it:
    the raw handle, without building the Stream object that
    ``torch.cuda.current_stream(dev).cuda_stream`` builds (a wrapper's host
    time is on the critical path of every small launch)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def device(x: torch.Tensor):
    """A context that makes ``x``'s device current for a launch; a no-op
    when it is current already, skipping ``torch.cuda.device``'s exchange."""
    if x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)
