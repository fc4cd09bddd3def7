"""Build the port's CUDA source at first use and load it with ctypes.

``csrc/gradestc.cu`` compiles into a shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o libgradestc.so csrc/gradestc.cu

The library lands in ``build/repro_torch_kernels/<hash>/`` under the
repository root, keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once.  Nothing here runs at
import time: the CPU tests import every module without a CUDA toolkit.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["load", "BUILD_ROOT", "NVCC_FLAGS", "last_build", "launches"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "gradestc.cu"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures of the library's entry points
_SIGNATURES = {
    "gradestc_encode_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "gradestc_decode_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "gradestc_coeff_quant_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "gradestc_encode_quant_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "gradestc_decode_wire_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None
#: what the last build did: {"seconds": float, "dir": str, "log": str}
last_build: Dict[str, object] = {}
#: kernel launches by name, one per wrapper call that launched (read and
#: reset through ``ops.launch_counts``/``ops.reset_launch_counts``)
launches: "collections.Counter[str]" = collections.Counter()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def load() -> ctypes.CDLL:
    """The kernels' library, compiled from ``csrc/gradestc.cu`` unless this
    build of the sources exists, then loaded once per process."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out = _build_dir()
    so = out / "libgradestc.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"libgradestc.{os.getpid()}.so"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log = proc.stdout
        (out / "gradestc.nvcc.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{log}")
        os.replace(tmp, so)       # atomic: concurrent builds agree
    last_build.update(seconds=time.perf_counter() - t0, dir=str(out), log=log)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _LIB = lib
    return lib
