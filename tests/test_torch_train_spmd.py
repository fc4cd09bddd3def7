"""Port vs reference: the training driver's ``--mode spmd`` (CPU).

``python -m repro_torch.launch.train --mode spmd --device cpu`` against
``python -m repro.launch.train --mode spmd`` (the reference's XLA cache in
a temp dir), for gradestc and fedavg: tinyllama-1.1b's reduced config
(vocab 256) on a (1, 1) mesh, 2 rounds, batch 2, seq 32.  Each run is a
child process, all four at once, with one ``PYTHONHASHSEED``: both
packages fold ``hash(name)`` into a group's keys, which Python salts per
process (and one thread each, as this process has).  The round lines,
``round N: eval_loss=X.XXXX``, equal the reference's (their seconds
aside): the step's params after each round give the reference's eval
loss to four places."""

import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

METHODS = ("gradestc", "fedavg")
ARGV = ["--mode", "spmd", "--arch", "tinyllama-1.1b", "--rounds", "2", "--batch", "2",
        "--seq", "32"]


def _rounds(text):
    """The round lines without their seconds."""
    return [re.sub(r"\s+\(.*s\)$", "", ln) for ln in text.splitlines()
            if ln.startswith("round ")]


@pytest.fixture(scope="module")
def outputs():
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""),
               PYTHONHASHSEED="0", OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        argv = {(pkg, m): [sys.executable, "-m", f"{pkg}.launch.train", *ARGV, "--method", m]
                for pkg in ("repro", "repro_torch") for m in METHODS}
        for m in METHODS:
            argv["repro", m] += ["--compilation-cache", os.path.join(tmp, m)]
            argv["repro_torch", m] += ["--device", "cpu"]
        children = {k: subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
                    for k, cmd in argv.items()}
        try:
            out = {}
            for k, child in children.items():
                text, err = child.communicate(timeout=300)
                assert child.returncode == 0, (k, err[-3000:])
                out[k] = text
        finally:
            for child in children.values():
                child.kill()
                child.wait()
    return ({m: out["repro", m] for m in METHODS}, {m: out["repro_torch", m] for m in METHODS})


@pytest.mark.parametrize("method", METHODS)
def test_spmd_prints_the_reference_round_lines(outputs, method):
    ref, port = outputs
    want, got = _rounds(ref[method]), _rounds(port[method])
    assert len(want) == 2 and got == want
    assert all(re.fullmatch(r"round \d: eval_loss=\d+\.\d{4}", ln) for ln in got)


def test_spmd_methods_differ(outputs):
    """gradestc's compressed aggregate is not fedavg's dense mean."""
    _, port = outputs
    assert _rounds(port["gradestc"]) != _rounds(port["fedavg"])
