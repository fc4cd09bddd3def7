"""The kernels' build cache and build-time observability.

Port of ``repro/launch/compile_cache.py``.  The reference caches XLA
executables; the port's compiled artifact is the kernels' library, which
``kernels/_build.py`` builds once per source hash with nvcc and keeps on
disk, so a later process loads it at once.

``enable_compilation_cache`` points that build root at a directory.
``CompileWatcher`` counts library builds (nvcc runs) and sums the seconds
of every load (build and ``dlopen``), from the events ``_build.load``
records; a benchmark splits a first round into build and execute with it,
and a run shows from measured events that it built nothing after its
start.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import List, Optional, Tuple

from ..kernels import _build

__all__ = ["enable_compilation_cache", "CompileWatcher"]


def enable_compilation_cache(cache_dir: Optional[str] = None) -> str:
    """Point the kernels' build root at ``cache_dir`` (default:
    ``build/repro_torch_kernels`` under the repository root).

    Idempotent; returns the directory in use.  Once the library is loaded
    in this process, a call naming another directory warns and changes
    nothing."""
    root = Path(cache_dir) if cache_dir else _build.DEFAULT_BUILD_ROOT
    if root.resolve() != Path(_build.BUILD_ROOT).resolve():
        if _build.loaded():
            warnings.warn(f"enable_compilation_cache({str(root)!r}): the kernels' library "
                          f"is already loaded from {_build.BUILD_ROOT}; no effect",
                          stacklevel=2)
            return str(_build.BUILD_ROOT)
        _build.BUILD_ROOT = root
    root.mkdir(parents=True, exist_ok=True)
    return str(root)


class CompileWatcher:
    """Counts library builds and sums the seconds of library loads.

    One watcher per process (:meth:`install`); windows are taken with
    :meth:`snapshot` / :meth:`since`, as with the reference's watcher.  The
    events are ``_build``'s record of every load in the process, so a
    watcher installed late still sees a build made before it."""

    _installed: Optional["CompileWatcher"] = None

    def __init__(self):
        #: (perf_counter at the load's end, seconds, built)
        self.events: List[Tuple[float, float, bool]] = _build.events

    @classmethod
    def install(cls) -> "CompileWatcher":
        if cls._installed is None:
            cls._installed = cls()
        return cls._installed

    def snapshot(self) -> int:
        """Marker for a window start: the current event count."""
        return len(self.events)

    def since(self, mark: int, t_start: float | None = None,
              t_end: float | None = None) -> Tuple[int, float]:
        """(builds, seconds of every load) after ``mark``, optionally
        restricted to events that ended in [t_start, t_end] perf-counter
        time.  A load of an existing build counts its seconds and no
        build."""
        window = self.events[mark:]
        if t_start is not None:
            window = [e for e in window if e[0] >= t_start]
        if t_end is not None:
            window = [e for e in window if e[0] <= t_end]
        return sum(1 for e in window if e[2]), sum(e[1] for e in window)
