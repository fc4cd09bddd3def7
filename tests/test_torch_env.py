"""The port's host env (``launch/env.py``) and kernel build cache
(``launch/compile_cache.py`` over ``kernels/_build.py``).

``configure_host`` sets its default on an env dict and keeps a value the
user exported, ``launch.env`` imports without torch (checked in a child
process), ``enable_compilation_cache`` moves the build root (and warns
once the library is loaded), and ``CompileWatcher`` counts the builds and
sums the load seconds that ``_build.load`` records.  The CPU tests run
without nvcc, so the build and the ``dlopen`` are stood in for; the load
path around them is the real one."""

import subprocess
import sys
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import compile_cache, env  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def test_configure_host_sets_defaults_and_keeps_the_users():
    target = {}
    applied = env.configure_host(env=target)
    assert applied == target == {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000"}
    mine = {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "1", "OTHER": "x"}
    assert env.configure_host(env=mine) == {}
    assert mine == {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "1", "OTHER": "x"}
    # the reference's XLA knobs are not the port's
    assert "XLA_FLAGS" not in target and "TF_CPP_MIN_LOG_LEVEL" not in target


def test_tcmalloc_hint_is_a_preload_line_or_none():
    hint = env.tcmalloc_hint()
    assert hint is None or (hint.startswith("LD_PRELOAD=") and not env.tcmalloc_active())


def test_env_imports_without_torch():
    """``repro_torch.launch.env`` and the package's lazy exports import no
    torch, so a driver can set the host knobs before torch loads."""
    code = ("import sys; import repro_torch.launch.env as e; import repro_torch.launch as l; "
            "e.configure_host(env={}); assert 'torch' not in sys.modules, 'torch imported'; "
            "assert l.__all__ == ['make_local_mesh', 'MeshPlan', 'make_plan']; "
            "l.make_plan; assert 'torch' in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, env={"PYTHONPATH": str(SRC)},
                   timeout=120)


def test_enable_compilation_cache_moves_the_root(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.DEFAULT_BUILD_ROOT)
    monkeypatch.setattr(_build, "_LIB", None)
    d = tmp_path / "kernels"
    assert compile_cache.enable_compilation_cache(str(d)) == str(d)
    assert compile_cache.enable_compilation_cache(str(d)) == str(d)      # idempotent
    assert d.is_dir() and _build.BUILD_ROOT == d
    assert _build._build_dir().parent == d
    monkeypatch.setattr(_build, "_LIB", object())                       # loaded
    with pytest.warns(UserWarning, match="no effect"):
        assert compile_cache.enable_compilation_cache(str(tmp_path / "other")) == str(d)
    assert _build.BUILD_ROOT == d
    with warnings.catch_warnings():
        warnings.simplefilter("error")                                   # same dir: silent
        assert compile_cache.enable_compilation_cache(str(d)) == str(d)


class _FakeLib:
    """Stands in for the ctypes library: any entry point, any signature."""

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        self.__dict__[name] = fn
        return fn


def test_compile_watcher_counts_builds_and_loads(tmp_path, monkeypatch):
    """Two loads through ``_build.load``: the first builds (a stand-in for
    nvcc writes the library), the second, in a fresh state, finds the
    build and only loads it.  The watcher sees one build and both loads'
    seconds."""
    calls = []

    def fake_compile(out):
        calls.append(out)
        tmp = out / "libgradestc.tmp.so"
        tmp.write_bytes(b"")
        return tmp

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _FakeLib())
    monkeypatch.setattr(_build, "events", list(_build.events))
    monkeypatch.setattr(compile_cache.CompileWatcher, "_installed", None)
    watcher = compile_cache.CompileWatcher.install()
    assert compile_cache.CompileWatcher.install() is watcher
    mark = watcher.snapshot()
    assert watcher.since(mark) == (0, 0)
    _build.load()
    assert _build.loaded() and len(calls) == 1
    t_mid = _build.events[-1][0]
    monkeypatch.setattr(_build, "_LIB", None)          # a fresh process's state
    _build.load()
    assert len(calls) == 1                              # the build was found
    n, secs = watcher.since(mark)
    assert n == 1 and secs == pytest.approx(sum(e[1] for e in _build.events[mark:]))
    assert [e[2] for e in _build.events[mark:]] == [True, False]
    assert watcher.since(mark, t_start=t_mid + 1e-9)[0] == 0           # the load alone
    assert watcher.since(mark, t_end=t_mid)[0] == 1                    # the build alone
    assert watcher.since(watcher.snapshot()) == (0, 0)
