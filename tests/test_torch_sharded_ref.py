"""The port's sharded fused engine against the JAX reference (CPU).

The port's ``run_fl(engine="fused", devices=2)`` on a 2-rank gloo world
(``test_torch_sharded``'s tiny config) against

* the JAX fused engine on one device, in this process, for gradestc and
  fedpaq (the paper's global quantizer on the CPU in both): the ledger
  equal, eval losses within the reference's tolerances (1e-5; fedpaq 5e-4);
* the reference's own sharded engine (``devices=2``, ``shard_map`` over
  two host devices) in a child process with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=2``, on the padded
  config (5 clients at participation 0.6: n_sel 3 padded to 4): every
  ledger figure equal and eval losses within 1e-5.

The child, the port's world and the in-process reference run at once."""

import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.fl import simulation as jsim  # noqa: E402
from repro.models.config import ArchConfig as JArch  # noqa: E402
from repro_torch.launch.mesh import run_world  # noqa: E402
from test_torch_sharded import ARCH, BASE, CASES, _world  # noqa: E402

NAMES = ("gradestc", "fedpaq", "padded")
JAX_RUN = {k: v for k, v in BASE.items() if k != "device"}

#: the reference's sharded engine at devices=2; prints its ledger and losses
CHILD = r"""
import json, sys
from repro.fl import FLConfig, run_fl
from repro.models.config import ArchConfig
arch, kw = json.loads(sys.argv[1])
res = run_fl(FLConfig(arch=ArchConfig(**arch), devices=2, **kw))
assert res.extra["devices"] == 2, res.extra
print("RESULT " + json.dumps({
    "per_round_uplink_bits": res.ledger.per_round_uplink_bits,
    "uplink_bits": res.ledger.uplink_bits, "downlink_bits": res.ledger.downlink_bits,
    "uplink_bytes": res.uplink_bytes, "sum_d": res.extra.get("sum_d"),
    "eval_rounds": res.eval_rounds, "eval_loss": res.eval_loss}))
"""


def _jax_kw(name):
    method, kw, _ = CASES[name]
    return {**JAX_RUN, **kw, "method": method}


@pytest.fixture(scope="module")
def runs():
    """(the port's world, rank 0; the reference in process; the
    reference's sharded child)."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=2").strip())
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, json.dumps([ARCH, _jax_kw("padded")])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            world = pool.submit(run_world, _world, 2, "gloo", (NAMES,))
            ref = {name: jsim.run_fl(jsim.FLConfig(arch=JArch(**ARCH), **_jax_kw(name)))
                   for name in ("gradestc", "fedpaq")}
            port = world.result()[0]
        out, err = child.communicate(timeout=120)
    finally:
        child.kill()
        child.wait()
    assert child.returncode == 0, err[-3000:]
    line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
    return port, ref, json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("name", ["gradestc", "fedpaq"])
def test_sharded_port_matches_jax_fused(runs, name):
    port, refs, _ = runs
    res, ref = port[name][0], refs[name]
    assert ref.extra["engine"] == res.extra["engine"] == "fused"
    assert res.extra["devices"] == 2 and ref.extra["devices"] == 1
    assert res.ledger.per_round_uplink_bits == ref.ledger.per_round_uplink_bits
    assert res.ledger.uplink_bits == ref.ledger.uplink_bits
    assert res.ledger.downlink_bits == ref.ledger.downlink_bits
    assert res.extra.get("sum_d") == ref.extra.get("sum_d")
    assert res.uplink_bytes == ref.uplink_bytes
    assert res.eval_rounds == ref.eval_rounds
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=0, atol=CASES[name][2])


def test_sharded_port_matches_jax_sharded_padded(runs):
    port, _, child = runs
    res = port["padded"][0]
    assert res.extra["c_pad"] == 4 and res.extra["lanes"] == (0, 2)
    assert res.ledger.per_round_uplink_bits == child["per_round_uplink_bits"]
    assert res.ledger.uplink_bits == child["uplink_bits"]
    assert res.ledger.downlink_bits == child["downlink_bits"]
    assert res.uplink_bytes == child["uplink_bytes"]
    assert res.extra.get("sum_d") == child["sum_d"]
    assert res.eval_rounds == child["eval_rounds"]
    np.testing.assert_allclose(res.eval_loss, child["eval_loss"], rtol=0, atol=1e-5)
