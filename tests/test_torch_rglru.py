"""Port vs reference: the hybrid family (RecurrentGemma, ``recurrentgemma-9b``).

``get_config("recurrentgemma-9b").reduced()`` from each package (3 layers:
rec, rec, local; d 256, d_rnn 256, 4 query heads over 1 KV head, hd 64,
window 16, conv width 4, sqrt(d)-scaled embeddings, vocab 1024, f32), with
``test_torch_rwkv6.py``'s checks: ``init_params`` bit for bit (the f32
``lru_lambda`` too), forward, loss and gradients, and 24 decode steps at
seq 24 and a 32-token cache, so the local layer's 16-slot ring buffer
wraps and the window masks.  The RG-LRU scan alone (``rglru.lru_scan``,
the reference's odd/even recursion of ``jax.lax.associative_scan``) against
the reference's jitted ``_lru_scan`` at T = 1, 17, 33 and 300, with and
without h0, within ``SCAN_TOL`` of max |h|: measured at most 1.8e-7 (XLA's
and torch's f32 ``exp`` differ by an ulp; the combine order is the
reference's), where the closed form exp(cumsum(log a)) would overflow f32
past T of about 230.  Measured: forward 1.4e-6, loss 6.3e-8, gradients
2.3e-6, decode 1.8e-6."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import model as jmodel  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from test_torch_rwkv6 import (check_cache_layout, check_decode,  # noqa: E402
                              check_forward_loss_grads, check_init, cfgs, close, ref_params)

NAME = "recurrentgemma-9b"
#: the scan alone against the reference's, max |diff| / max |h|
SCAN_TOL = 1e-6


@pytest.fixture(scope="module")
def params():
    return ref_params(NAME)


def test_reduced_config_pattern_and_window():
    jc, tc = cfgs(NAME)
    assert tc.layer_kinds() == ("rec", "rec", "local") == jc.layer_kinds()
    assert tc.sliding_window == 16 and (tc.n_heads, tc.n_kv_heads) == (4, 1)


def test_init_params_equal_reference(params):
    check_init(NAME, params[1])
    jc, tc = cfgs(NAME)
    assert params[1]["rec/lru_lambda"].dtype == torch.float32
    assert tmodel.param_group_shapes(tc) == jmodel.param_group_shapes(jc)
    assert tmodel.family_module(tc) is trglru


def test_forward_loss_and_grads(params):
    check_forward_loss_grads(NAME, *params)


def test_decode_wraps_ring_buffer(params):
    check_decode(NAME, *params)


@pytest.mark.parametrize("T", [1, 17, 33, 300])
@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
def test_lru_scan_alone(T, with_h0):
    rng = np.random.default_rng(T)
    # log a at the initial Lambda = 3: 8 r logsigmoid(3), r in (0, 1)
    log_a = (8 * rng.uniform(0, 1, (2, T, 8)) * -np.log1p(np.exp(-3.0))).astype(np.float32)
    bx = rng.standard_normal((2, T, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32) if with_h0 else None
    want = jax.jit(jrglru._lru_scan)(jnp.asarray(log_a), jnp.asarray(bx),
                                     None if h0 is None else jnp.asarray(h0))
    got = trglru.lru_scan(torch.from_numpy(log_a), torch.from_numpy(bx),
                          None if h0 is None else torch.from_numpy(h0))
    close(got.numpy(), want, f"lru_scan T={T}", SCAN_TOL)


def test_lru_scan_long_sequence_stays_finite():
    """At T = 4096 and the steepest decay the recurrence stays finite and
    equals a step-by-step loop within SCAN_TOL."""
    T = 4096
    log_a = torch.full((1, T, 4), 8 * -float(np.log1p(np.exp(-3.0))))
    bx = torch.ones((1, T, 4))
    h = trglru.lru_scan(log_a, bx, None)
    a = torch.exp(log_a[0, 0])
    ref, acc = [], torch.zeros(4)
    for t in range(T):
        acc = a * acc + bx[0, t]
        ref.append(acc)
    assert torch.isfinite(h).all()
    close(h[0].numpy(), torch.stack(ref).numpy(), "lru_scan T=4096", SCAN_TOL)


def test_bf16_cache_and_lambda():
    """In bf16: the LRU state f32, the conv tails and ring buffers bf16 at
    the window's size, as the reference's; ``lru_lambda`` stays f32 in the
    port's init and through ``params_from_jax``."""
    from repro_torch.convert import params_from_jax
    from repro_torch.core import prng

    jc, tc = cfgs(NAME, dtype="bfloat16")
    cache = tmodel.init_cache(tc, 2, 64, device="cpu")
    check_cache_layout(cache, jmodel.init_cache(jc, 2, 64))
    assert cache.k.shape[2] == tc.sliding_window and cache.h.dtype == torch.float32
    shapes = jax.eval_shape(lambda k: jmodel.init_params(jc, k), jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), "cpu")
    own = tmodel.init_params(tc, prng.PRNGKey(0, "cpu"))
    assert tp["rec/lru_lambda"].dtype == own["rec/lru_lambda"].dtype == torch.float32
    assert {k: v.dtype for k, v in tp.items()} == {k: v.dtype for k, v in own.items()}
