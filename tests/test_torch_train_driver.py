"""Port vs reference: the training driver (``launch/train.py``).

``--mode sim`` with 2 rounds, 2 clients and 1 local step: the port's
``main`` (``--device cpu``) prints the reference's ledger summary and round
lines exactly, and its final loss (the ``run_fl`` result each driver
made) is within 1e-5 relative of the reference's.  Sim mode accepts
spmd mode's flags (``--arch``, ``--batch``, ``--seq``) and ignores them,
as the reference's does; ``--mode spmd`` is held against the reference's
in ``test_torch_train_spmd.py``.  The reference's ``main`` runs with its
persistent XLA cache switched off, so the test writes nothing outside its
temp dir."""

import contextlib
import io
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.fl as jfl  # noqa: E402
import repro.launch.compile_cache as jcache  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.fl import simulation as tsim  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

ARGV = ["--mode", "sim", "--method", "gradestc", "--rounds", "2", "--clients", "2",
        "--local-steps", "1"]
KNOBS = ("TF_CPP_MIN_LOG_LEVEL", "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD")


def _main(main, argv, monkeypatch):
    for k in KNOBS:                     # restored after the test
        monkeypatch.setenv(k, "0")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def outputs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcache, "enable_compilation_cache", lambda cache_dir=None: cache_dir)
        seen = {}
        for name, mod in (("ref", jfl), ("port", tsim)):
            def recording(cfg, progress=None, name=name, direct=mod.run_fl):
                seen[name] = (cfg, direct(cfg, progress))
                return seen[name][1]
            mp.setattr(mod, "run_fl", recording)
        ref = _main(jtrain.main, ARGV, mp)
        port = _main(ttrain.main, ARGV + ["--device", "cpu"], mp)
    return ref, port, seen


def _summary(text):
    return text.split("---\n", 1)[1].rsplit("final loss", 1)[0]


def _final_loss(text):
    return float(re.search(r"final loss ([0-9.]+)", text).group(1))


def test_sim_prints_the_reference_ledger(outputs):
    ref, port, _ = outputs
    assert _summary(port) == _summary(ref)
    assert "uplink total" in _summary(port) and "rounds         : 2" in _summary(port)


def test_sim_final_loss_and_round_lines(outputs):
    ref, port, seen = outputs
    want, got = seen["ref"][1].eval_loss, seen["port"][1].eval_loss
    assert len(got) == len(want) == 2
    assert got[-1] == pytest.approx(want[-1], rel=1e-5)
    assert _final_loss(port) == _final_loss(ref)
    rounds = lambda t: [ln for ln in t.splitlines() if ln.startswith("round ")]
    assert rounds(port) == rounds(ref) and len(rounds(port)) == 2


def test_sim_builds_the_reference_flconfig(outputs):
    """The reference's FLConfig: eval every max(1, rounds // 10), the fused
    engine (the reference's default), the CLI's method and sizes."""
    cfg = outputs[2]["port"][0]
    assert (cfg.method, cfg.rounds, cfg.n_clients, cfg.local_steps) == ("gradestc", 2, 2, 1)
    assert cfg.eval_every == 1 and cfg.engine == "fused" and cfg.device == "cpu"
    assert (cfg.lr, cfg.seed, cfg.alpha) == (0.05, 0, None)


class _Stop(Exception):
    """Raised by a stub ``run_fl``: the driver's config is all the test
    wants."""


def _sim_config(main, mod, argv, monkeypatch):
    seen = []

    def stop(cfg, progress=None):
        seen.append(cfg)
        raise _Stop

    monkeypatch.setattr(mod, "run_fl", stop)
    for k in KNOBS:
        monkeypatch.setenv(k, "0")
    with contextlib.redirect_stdout(io.StringIO()), pytest.raises(_Stop):
        main(argv)
    return seen[0]


@pytest.mark.parametrize("flag,value", [("--arch", "yi-34b"), ("--batch", "3"), ("--seq", "7")])
def test_sim_accepts_and_ignores_spmd_flags(flag, value, monkeypatch):
    """Sim mode takes ``--arch``, ``--batch`` and ``--seq`` and reads none of
    them, as the reference's does: the FLConfig equals the one built
    without the flag, and the reference's driver accepts the flag too."""
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda cache_dir=None: cache_dir)
    port = ARGV + ["--device", "cpu"]
    plain = _sim_config(ttrain.main, tsim, port, monkeypatch)
    assert _sim_config(ttrain.main, tsim, port + [flag, value], monkeypatch) == plain
    ref_plain = _sim_config(jtrain.main, jfl, ARGV, monkeypatch)
    assert _sim_config(jtrain.main, jfl, ARGV + [flag, value], monkeypatch) == ref_plain
