"""Port vs reference: whole gradestc runs on rwkv6-3b's reduced config.

``run_fl`` on ``get_config("rwkv6-3b").reduced()`` from each package (2
layers, d 256, 4 WKV heads, vocab 1024, f32; 2 clients, 3 rounds, 1 local
step, batch 2, seq 32, an eval at rounds 0 and 2): the port on the CPU
with the loop engine and with the fused one (``scan_rounds`` 2: local
training under ``torch.func.vmap`` over the clients, so the WKV
recurrence runs batched), each against the JAX loop engine.
``ledger.per_round_uplink`` and the per-group bits equal exactly, eval
losses within rtol 1e-5 (measured 0), one host fetch a round (loop) or a
chunk (fused) and an eval.  RWKV-6's parameter groups leave out the
DDLerp mixes, the decay base, the bonus, every LayerNorm but ``ln1_w``
and the final norm: as the reference's ``_set_groups`` does, a round
writes back only the group paths, so those keep their initial values
(before the port did the same, the first round dropped them and the next
forward failed with a ``KeyError``).  The parameters each eval sees are
recorded: outside the groups equal to ``init_params``' bit for bit,
inside them moved.  The runs are made once, in a module-scoped fixture:
the reference's (~22-33 s alone: 161 XLA compiles, most of this file's
time) in a thread beside the port's, since XLA's compiles release the
GIL, and the port's two from one ``init_params`` draw (held to the
reference's in ``test_torch_rwkv6.py``, ``_rglru.py`` and ``_encdec.py``;
whisper's 32768-row ``dec_pos`` takes ~4 s on one thread).  The helpers
serve ``test_torch_slice_hybrid.py`` and ``test_torch_slice_encdec.py``."""

from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.fl import simulation as jsim  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.fl import simulation as tsim  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

NAME = "rwkv6-3b"
RUN = dict(rounds=3, n_clients=2, local_steps=1, batch=2, seq=32, eval_every=2)
ENGINES = {"loop": {}, "fused": {"engine": "fused", "scan_rounds": 2}}
LOSS_RTOL = 1e-5
RUN_SEED = 0                                     # FLConfig's default seed


def reference_run(name):
    return jsim.run_fl(jsim.FLConfig(method="gradestc", arch=jget(name).reduced(),
                                     engine="loop", **RUN))


def port_run(name, engine, init):
    """(FLResult, host syncs, the params each eval saw) of the port on the
    CPU, with the eval function wrapped to record its params, from a copy
    of ``init``, the draw of ``init_params`` that ``run_fl`` makes."""
    real = tsim.make_batched_eval
    seen = []
    cfg, key = tget(name).reduced(), prng.PRNGKey(RUN_SEED, "cpu")

    def drawn(arch, k):
        assert arch == cfg and torch.equal(k, key)
        return {path: x.clone() for path, x in init.items()}

    def recording(arch):
        eval_all = real(arch)

        def wrapped(params, block):
            seen.append(dict(params))
            return eval_all(params, block)

        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsim, "make_batched_eval", recording)
        mp.setattr(tsim.model, "init_params", drawn)
        tmetrics.reset_host_sync_count()
        res = tsim.run_fl(tsim.FLConfig(method="gradestc", arch=tget(name).reduced(),
                                        device="cpu", **RUN, **ENGINES[engine]))
    return res, tmetrics.host_sync_count(), seen


def runs_of(name):
    """The reference's run, the port's on each engine of ENGINES and the
    port's ``init_params``."""
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(reference_run, name)
        init = tmodel.init_params(tget(name).reduced(), prng.PRNGKey(RUN_SEED, "cpu"))
        port = {engine: port_run(name, engine, init) for engine in ENGINES}
        return ref.result(), port, init


def check_run(ref, res, syncs, engine):
    """The ledger equal, the eval losses within LOSS_RTOL, and the host
    fetches: one a round (loop) or a chunk (fused), plus one an eval."""
    assert res.extra["engine"] == engine
    assert res.ledger.per_round_uplink == ref.ledger.per_round_uplink
    assert res.ledger.per_group_bits == ref.ledger.per_group_bits
    assert res.ledger.uplink_bits == ref.ledger.uplink_bits
    assert res.extra.get("sum_d") == ref.extra.get("sum_d")
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=LOSS_RTOL)
    rounds_or_chunks = RUN["rounds"] if engine == "loop" else res.extra["chunks"]
    assert syncs == rounds_or_chunks + len(res.eval_rounds)


def check_write_back(name, init, seen):
    """Every eval's params hold the model's keys; those outside the groups
    equal ``init`` (``init_params``') bit for bit, the group paths have
    moved."""
    groups = set(tmodel.param_group_shapes(tget(name).reduced()))
    outside = set(init) - groups
    assert outside and len(seen) == 2                       # the evals of rounds 0 and 2
    for params in seen:
        assert set(params) == set(init)
        for path in outside:
            assert torch.equal(params[path], init[path]), path
        assert all(not torch.equal(params[p], init[p]) for p in groups)


@pytest.fixture(scope="module")
def runs():
    return runs_of(NAME)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_gradestc_ledger_exact_and_loss_within_tolerance(runs, engine):
    ref, port, _ = runs
    check_run(ref, *port[engine][:2], engine)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_parameters_outside_groups_keep_server_value(runs, engine):
    _, port, init = runs
    check_write_back(NAME, init, port[engine][2])
