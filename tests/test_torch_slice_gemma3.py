"""Port vs reference: a whole gradestc run on Gemma3-1B's reduced config.

``run_fl`` with the loop engine, the port on the CPU against the JAX loop
engine, on ``get_config("gemma3-1b").reduced()`` from each package (6
layers: five local with a 16-token sliding window, one global; 4 query
heads over 1 KV head; tied and sqrt(d)-scaled embeddings; rope theta 1e6)
at seq 32, so the window masks.  ``ledger.per_round_uplink`` must be equal
exactly; eval loss within rtol 1e-5.  The reference's tied parameters
(no ``head``) convert to the port's, equal to its own initialization bit
for bit, and give the same logits within rtol 1e-5.  On the CPU both sides run the plain
attention; on the card the port's eval forward runs the flash kernel
(``chip_smoke.py`` phase 5 holds that run card vs CPU).  The reference
runs once, in a module-scoped fixture."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.fl import simulation as jsim  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.fl import simulation as tsim  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

RUN = dict(rounds=3, n_clients=2, local_steps=1, batch=2, seq=32, eval_every=2)
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def runs():
    ref = jsim.run_fl(jsim.FLConfig(method="gradestc", arch=jget_config("gemma3-1b").reduced(),
                                    engine="loop", **RUN))
    tmetrics.reset_host_sync_count()
    res = tsim.run_fl(tsim.FLConfig(method="gradestc", arch=get_config("gemma3-1b").reduced(),
                                    device="cpu", **RUN))
    return ref, res, tmetrics.host_sync_count()


def test_reduced_config_windows_and_ties():
    arch = get_config("gemma3-1b").reduced()
    assert arch.sliding_window == 16 and RUN["seq"] > arch.sliding_window
    assert arch.layer_kinds() == ("local",) * 5 + ("global",)
    assert arch.tie_embeddings and arch.scale_embed and (arch.n_heads, arch.n_kv_heads) == (4, 1)


def test_tied_params_convert_and_logits_match():
    ja, ta = jget_config("gemma3-1b").reduced(), get_config("gemma3-1b").reduced()
    params = jax.device_get(jmodel.init_params(ja, jax.random.PRNGKey(0)))
    tp = params_from_jax(params, "cpu")
    own = tmodel.init_params(ta, prng.PRNGKey(0, "cpu"))
    assert "head" not in tp and set(tp) == set(own)
    for path, x in own.items():
        assert torch.equal(tp[path], x), path
    tokens = np.random.default_rng(0).integers(0, ta.vocab, size=(2, 32)).astype(np.int32)
    jl = jax.jit(lambda p, t: jmodel.forward(ja, p, {"tokens": t}))(params, tokens)
    with torch.no_grad():
        tl = tmodel.forward(ta, tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_uplink_ledger_exact(runs):
    ref, res, _ = runs
    assert res.ledger.per_round_uplink == ref.ledger.per_round_uplink
    assert res.ledger.uplink_bits == ref.ledger.uplink_bits
    assert res.ledger.downlink_bits == ref.ledger.downlink_bits
    assert res.extra.get("sum_d") == ref.extra.get("sum_d")


def test_eval_loss_within_tolerance(runs):
    ref, res, syncs = runs
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=LOSS_RTOL)
    assert syncs == RUN["rounds"] + len(res.eval_rounds)
