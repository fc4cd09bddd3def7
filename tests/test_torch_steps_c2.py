"""Port vs reference: the production FL round step at C = 2 (CPU).

The reference's ``make_fl_round_step`` on a (2, 1) mesh of two host
devices (a child process with
``XLA_FLAGS=--xla_force_host_platform_device_count=2``, as the
reference's sharded tests run it) against the port's

  * on a logical (2, 1) mesh in this process: both lanes trained under
    ``torch.func.vmap``, no collective;
  * on a gloo world of 2 ranks (``launch.mesh.run_world``, the function in
    ``test_torch_steps_world.py``): one lane a rank, per compressed group
    an all-gather of M and one of the key, d_r and A words, and one
    all-reduce of the dense groups' sums, each counted.

gradestc and fedavg at tinyllama-1.1b's reduced config (vocab 256), 2
rounds, ``local_steps`` 2, batch (2, 2, 32) from one numpy seed, from the
same params and ``GEState`` (made here by the port, handed to the child
as numpy: a process salts ``hash(name)``, so the keys go with the
state).  Every parameter within ``PARAM_RTOL`` of max |reference
parameter|, ``d_r`` equal, keys bit for bit, bases as projections within
``PROJ_ATOL`` (``test_torch_steps.py``'s check).  Both ranks end with the
same state and params.  The child, the world and the in-process runs go at
once."""

import concurrent.futures
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.launch import steps as tst  # noqa: E402
from repro_torch.launch.mesh import FLMesh, run_world  # noqa: E402
from repro_torch.launch.sharding import make_plan  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import model  # noqa: E402
from test_torch_steps import batches, check_round  # noqa: E402
from test_torch_steps_world import _rank, arch, run_rounds  # noqa: E402

METHODS = ("gradestc", "fedavg")

#: the reference's step on two host devices: reads the params, state and
#: batches from an npz, writes each method's rounds to another
CHILD = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch import steps as jst
from repro.launch.mesh import make_local_mesh
from repro.launch.sharding import make_plan
assert len(jax.devices()) == 2, jax.devices()
z = dict(np.load(sys.argv[1]))
cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(), vocab=256)
mesh = make_local_mesh((2, 1))
plan = make_plan(mesh, cfg)
pol = jst.compression_policy_for(cfg, plan)
def nest(prefix):
    out = {}
    for k, v in z.items():
        if k.startswith(prefix):
            node = out
            *head, last = k[len(prefix):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = jnp.asarray(v)
    return out
params0 = nest("p/")
state0 = jst.GEState(M={k: jnp.asarray(z["M/" + k]) for k in pol.plans if "M/" + k in z},
                     keys={k: jnp.asarray(z["K/" + k].astype(np.uint32))
                           for k in pol.plans if "K/" + k in z})
out = {}
for method in sys.argv[3].split(","):
    step = jax.jit(jst.make_fl_round_step(cfg, mesh, plan, pol, method=method, lr=0.05,
                                          local_steps=2))
    params, state = params0, state0
    for r in range(int(z["rounds"])):
        b = {k: jnp.asarray(z[f"b{r}/{k}"]) for k in ("tokens", "labels")}
        params, state, met = step(params, state, b)
        params, state, met = jax.device_get((params, state, met))
        def flat(t, pre):
            for k, v in t.items():
                if isinstance(v, dict):
                    flat(v, pre + k + "/")
                else:
                    out[pre + k] = np.asarray(v)
        flat(params, f"{method}/{r}/p/")
        for k in state.M:
            out[f"{method}/{r}/M/{k}"] = np.asarray(state.M[k])
            out[f"{method}/{r}/K/{k}"] = np.asarray(state.keys[k])
        for k, v in met.items():
            out[f"{method}/{r}/m/{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
print("DONE")
"""


def _unflat(d):
    """{"a/b": x} -> {"a": {"b": x}} (the reference's param tree)."""
    out = {}
    for k, v in d.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _reference(z, method, r):
    """The child's round ``r`` of ``method`` as (params tree, GEState,
    metrics), numpy."""
    pre = f"{method}/{r}/"
    params = _unflat({k[len(pre) + 2:]: v for k, v in z.items() if k.startswith(pre + "p/")})
    state = tst.GEState(
        M={k[len(pre) + 2:]: v for k, v in z.items() if k.startswith(pre + "M/")},
        keys={k[len(pre) + 2:]: v for k, v in z.items() if k.startswith(pre + "K/")})
    met = {k[len(pre) + 2:]: v for k, v in z.items() if k.startswith(pre + "m/")}
    return params, state, met


@pytest.fixture(scope="module")
def runs():
    cfg = arch()
    mesh = FLMesh((2, 1), ("data", "model"))
    pol = tst.compression_policy_for(cfg, make_plan(mesh, cfg))
    params = model.init_params(cfg, prng.PRNGKey(0, "cpu"))
    state = tst.make_ge_state(cfg, pol, 2, device="cpu")
    rounds = batches(C=2)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=2").strip())
    with tempfile.TemporaryDirectory() as tmp:
        z_in, z_out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        feed = {f"p/{k}": v.numpy() for k, v in params.items()}
        feed.update({f"M/{k}": v.numpy() for k, v in state.M.items()})
        feed.update({f"K/{k}": v.numpy() for k, v in state.keys.items()})
        for r, b in enumerate(rounds):
            feed.update({f"b{r}/{k}": v for k, v in b.items()})
        np.savez(z_in, rounds=len(rounds), **feed)
        child = subprocess.Popen([sys.executable, "-c", CHILD, z_in, z_out, ",".join(METHODS)],
                                 env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True)
        try:
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                world = pool.submit(run_world, _rank, 2, "gloo",
                                    (METHODS, params, state, rounds))
                logical = {m: run_rounds(mesh, m, dict(params), state, rounds) for m in METHODS}
                ranks = world.result()
            out, err = child.communicate(timeout=300)
        finally:
            child.kill()
            child.wait()
        assert child.returncode == 0 and "DONE" in out, err[-3000:]
        z = dict(np.load(z_out))
    return z, logical, ranks, pol


def _check(z, method, got):
    for r, (params, state, met, _) in enumerate(got):
        check_round(_reference(z, method, r), (params, state, met), f"{method} round {r}")


@pytest.mark.parametrize("method", METHODS)
def test_logical_mesh_matches_reference(runs, method):
    z, logical, _, _ = runs
    _check(z, method, logical[method])
    assert all(coll == 0 for *_, coll in logical[method])


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("method", METHODS)
def test_gloo_world_matches_reference(runs, method, rank):
    z, _, ranks, pol = runs
    got = ranks[rank][method]
    _check(z, method, got)
    n_comp = sum(lp.compress for lp in pol.plans.values())
    want = 2 * n_comp + 1 if method == "gradestc" else 1
    assert [coll for *_, coll in got] == [want] * len(got)


@pytest.mark.parametrize("method", METHODS)
def test_ranks_agree(runs, method):
    """Both ranks end with the same params and state: every rank applies
    the gathered payloads alike."""
    _, _, ranks, _ = runs
    (p0, s0, m0, _), (p1, s1, m1, _) = ranks[0][method][-1], ranks[1][method][-1]
    assert m0 == m1
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(s0.M[k], s1.M[k]) and torch.equal(s0.keys[k], s1.keys[k])
               for k in s0.M)
