"""Port vs reference: a whole gradestc run on granite-moe-1b-a400m's reduced
config, on the loop engine.

``run_fl`` on ``get_config("granite-moe-1b-a400m").reduced()`` from each
package (2 layers, d 256, 4 experts top 2, capacity 1.25, vocab 1024; 2
clients, 2 rounds, seq 32): the port on the CPU with the loop engine
against the JAX loop engine.  GradESTC compresses the expert banks (L, E, D, F), cut into (l, m)
matrices by the reference's policy, and sends the router raw.
``ledger.per_round_uplink`` must be equal exactly, eval losses within rtol
1e-5 (measured 1.3e-7).  At seq 16 a client's 32 tokens a step leave its
deltas rank-deficient, and where the spectrum is degenerate LAPACK and XLA
rotate the rSVD's candidates apart (a condition of the reference, ROADMAP
C): the loss then moves 2.6e-5, with or without capacity drops.  The
reference runs once, in a module-scoped fixture.  The fused engine's run
(local training under ``torch.func.vmap`` over the clients, so the MoE
dispatch runs batched) is ``test_torch_slice_moe_fused.py``, fedavg's runs
``test_torch_slice_moe_fedavg.py``; both reuse this file's helpers."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.fl import simulation as jsim  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.fl import simulation as tsim  # noqa: E402

NAME = "granite-moe-1b-a400m"
RUN = dict(rounds=2, n_clients=2, local_steps=1, batch=2, seq=32, eval_every=1)
ENGINES = {"loop": {}, "fused": {"engine": "fused", "scan_rounds": 2}}
LOSS_RTOL = 1e-5


def reference_run(method):
    return jsim.run_fl(jsim.FLConfig(method=method, arch=jget(NAME).reduced(), engine="loop",
                                     **RUN))


def port_runs(method, engines=tuple(ENGINES)):
    """{engine: (FLResult, host syncs)} of the port on the CPU."""
    out = {}
    for engine in engines:
        kw = ENGINES[engine]
        tmetrics.reset_host_sync_count()
        res = tsim.run_fl(tsim.FLConfig(method=method, arch=tget(NAME).reduced(), device="cpu",
                                        **RUN, **kw))
        out[engine] = (res, tmetrics.host_sync_count())
    return out


def check_run(ref, res, syncs, engine):
    """The ledger equal, the eval loss within LOSS_RTOL, and the host
    fetches: one a round (loop) or a chunk (fused), plus one an eval."""
    assert res.extra["engine"] == engine
    assert res.ledger.per_round_uplink == ref.ledger.per_round_uplink
    assert res.ledger.per_group_bits == ref.ledger.per_group_bits
    assert res.ledger.uplink_bits == ref.ledger.uplink_bits
    assert res.ledger.downlink_bits == ref.ledger.downlink_bits
    assert res.extra.get("sum_d") == ref.extra.get("sum_d")
    assert res.eval_rounds == ref.eval_rounds == [0, 1]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=LOSS_RTOL)
    rounds_or_chunks = RUN["rounds"] if engine == "loop" else res.extra["chunks"]
    assert syncs == rounds_or_chunks + len(res.eval_rounds)


@pytest.fixture(scope="module")
def runs():
    return reference_run("gradestc"), port_runs("gradestc", ("loop",))


def test_gradestc_loop_ledger_exact_and_loss_within_tolerance(runs):
    ref, port = runs
    check_run(ref, *port["loop"], "loop")


def test_expert_banks_compressed_router_raw(runs):
    """The plan: the three banks compressed, the router raw; the uplink
    under fedavg's 32 bits a parameter."""
    from repro_torch.core.policy import make_policy
    from repro_torch.models import model

    groups = model.param_group_shapes(tget(NAME).reduced())
    plans = make_policy(groups).plans
    assert not plans["layers/router"].compress
    assert all(plans[f"layers/moe_{w}"].compress for w in ("wgate", "win", "wout"))
    raw = 32 * sum(s * int(np.prod(shape)) for shape, s in groups.values())
    res = runs[1]["loop"][0]
    assert res.ledger.uplink_bits < raw * RUN["n_clients"] * RUN["rounds"]
