"""Host environment defaults for the training and benchmark entry points.

Port of ``repro/launch/env.py``.  It imports no torch, so that it can run
before the first ``import torch`` in the process, as the reference's runs
before ``import jax``.

Knobs (defaults only -- anything the user already exported wins):

  TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD=60000000000
      with tcmalloc preloaded, suppress per-allocation warnings for the
      multi-GB host buffers of large models and checkpoints.

The reference's XLA knobs have no counterpart here: ``TF_CPP_MIN_LOG_LEVEL``
silences XLA's C++ logging, and ``XLA_FLAGS``' host device count is read
once at jax's import.  The port's multi-rank CPU runs are ``torch.distributed``
gloo worlds of ``FLConfig.devices`` ranks that ``run_fl`` starts itself, so
no flag has to be set before an import.  No torch allocator setting is
changed.

tcmalloc itself cannot be enabled here: LD_PRELOAD is read by the dynamic
loader at process start.  ``configure_host`` detects whether it is active
(via /proc/self/maps) and reports the preload line to use when it is not.
"""

from __future__ import annotations

import os
import sys

__all__ = ["tcmalloc_active", "tcmalloc_hint", "configure_host"]

_TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
)

_DEFAULTS = {
    "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000",
}


def tcmalloc_active() -> bool:
    """True when a tcmalloc variant is linked into this process."""
    try:
        with open("/proc/self/maps") as f:
            return "tcmalloc" in f.read()
    except OSError:  # non-Linux: undetectable, assume not
        return False


def tcmalloc_hint() -> str | None:
    """The LD_PRELOAD line to get tcmalloc, or None if unavailable/active."""
    if tcmalloc_active():
        return None
    for path in _TCMALLOC_PATHS:
        if os.path.exists(path):
            return f"LD_PRELOAD={path}"
    return None


def configure_host(*, env: dict | None = None, verbose: bool = False) -> dict:
    """Apply the default host knobs; returns {knob: value} for what was set.

    Pass ``env`` to tune a child-process environment dict instead of
    ``os.environ``."""
    target = os.environ if env is None else env
    applied = {}
    for k, v in _DEFAULTS.items():
        if k not in target:
            target[k] = v
            applied[k] = v
    if verbose:
        for k, v in applied.items():
            print(f"[env] {k}={v}", file=sys.stderr)
        hint = tcmalloc_hint()
        if hint:
            print(f"[env] tcmalloc not preloaded; for faster host malloc: {hint}",
                  file=sys.stderr)
    return applied
