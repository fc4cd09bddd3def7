"""Port vs reference: the MoE FFN (``repro_torch.models.moe``).

``moe_ffn`` of ``granite-moe-1b-a400m``'s reduced config (4 experts, top
2, d 256, d_ff 512) on seeded numpy weights and tokens, against the
reference's jitted ``moe_ffn``, in f32 and bf16: capacity drops on (1.25)
and off (8.0), a token count that ``moe_group`` does not divide (48 tokens,
group 20 -> 16), and ``moe_stop_gradient_dispatch``.  The routing integers
(expert ids in descending probability, each (token, choice)'s slot in its
expert's buffer, the kept mask) are equal to the reference's, also for an
all-zero router where every probability ties (``lax.top_k`` keeps the lower
expert first, and so does the port's stable sort).  Outputs within 1e-5 of
max |output| in f32 (measured 5.7e-7) and 1e-2 in bf16, the router's and the
banks' gradients within 1e-5 of their max |gradient| in f32 (measured
1.3e-6).  ``router_load_balance_loss`` within rtol 1e-6, and
``init_moe_ffn``'s tree: the reference's keys, shapes and dtypes (the router
f32 in a bf16 model), its f32 draws bit for bit."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

NAME = "granite-moe-1b-a400m"
B, S = 2, 24
#: max |port - reference| over max |reference|, by dtype
OUT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_TOL = 1e-5
CASES = {"drops": {}, "no-drops": {"capacity_factor": 8.0}, "ragged-group": {"moe_group": 20},
         "stop-gradient": {"moe_stop_gradient_dispatch": True}}


def _cfgs(**kw):
    return (dataclasses.replace(jget(NAME).reduced(), **kw),
            dataclasses.replace(tget(NAME).reduced(), **kw))


def _weights(cfg, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    n = lambda *s, fan: (rng.standard_normal(s) / np.sqrt(fan)).astype(np.float32)
    w = {"router": n(D, E, fan=D), "moe_wgate": n(E, D, F, fan=D), "moe_win": n(E, D, F, fan=D),
         "moe_wout": n(E, F, D, fan=F)}
    return {k: v if k == "router" else v.astype(dtype) for k, v in w.items()}


def _tokens(cfg, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(dtype)


def _jdt(name):
    return jnp.bfloat16 if name == "bfloat16" else jnp.float32


def _close(got, want, tol, msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, msg
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{msg}: max |diff| {err:.3e} > {tol} * {scale:.3e}"


def _ref_routing(cfg, x, router):
    """The reference's routing integers, by the lines of its
    ``_dispatch_one_group`` (``moe.py:51-68``): (expert ids, slots,
    kept)."""
    S_, K, E = x.shape[0], cfg.experts_per_tok, cfg.n_experts
    C = max(1, int(np.ceil(S_ * K * cfg.capacity_factor / E)))
    probs = jax.nn.softmax(x.astype(jnp.float32) @ router, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, K)
    sel = jax.nn.one_hot(expert_idx, E, dtype=jnp.float32)
    selk = sel.transpose(1, 0, 2).reshape(K * S_, E)
    pos = (jnp.cumsum(selk, axis=0) - selk).reshape(K, S_, E).transpose(1, 0, 2)
    within_cap = (pos < C) & (sel > 0)
    slot = jnp.sum(pos * sel, axis=-1).astype(jnp.int32)
    return expert_idx, slot, jnp.any(within_cap, axis=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("router", ["seeded", "all-zero"])
def test_routing_integers_equal(dtype, router):
    """Expert ids, slots and the kept mask of one 48-token group equal the
    reference's; some tokens overflow (capacity 1.25), and with an
    all-zero router every token picks experts 0 and 1 and the later ones
    overflow in choice-major order."""
    jc, tc = _cfgs()
    w = _weights(jc)
    if router == "all-zero":
        w["router"] = np.zeros_like(w["router"])
    x = _tokens(jc).reshape(B * S, -1)
    jx = jnp.asarray(x).astype(_jdt(dtype))
    want = [np.asarray(a) for a in jax.jit(lambda a, r: _ref_routing(jc, a, r))(jx, w["router"])]
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    _, idx, slot, kept = tmoe.route(tc, tx, torch.from_numpy(w["router"]))
    np.testing.assert_array_equal(idx.numpy(), want[0])
    np.testing.assert_array_equal(slot.numpy(), want[1])
    np.testing.assert_array_equal(kept.numpy(), want[2])
    assert not kept.all()
    if router == "all-zero":
        assert (idx == torch.arange(tc.experts_per_tok)).all()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(case, dtype):
    """The FFN's output against the reference's jitted ``moe_ffn``; in f32
    also every weight's gradient of sum(y^2)."""
    jc, tc = _cfgs(**CASES[case], dtype=dtype)
    np_dt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    w = {k: np.asarray(jnp.asarray(v).astype(np_dt)) if k != "router" else v
         for k, v in _weights(jc).items()}
    x = np.asarray(jnp.asarray(_tokens(jc)).astype(np_dt))
    want = np.asarray(jax.jit(lambda a, ww: jmoe.moe_ffn(jc, a, ww))(x, w), np.float32)
    tw = params_from_jax(w, "cpu")
    tx = params_from_jax({"x": x}, "cpu")["x"]
    got = tmoe.moe_ffn(tc, tx, tw)
    assert got.dtype == tx.dtype
    _close(got.float(), want, OUT_TOL[dtype], f"{case} {dtype} output")
    kept = tmoe.route(tc, tx.reshape(-1, tc.d_model), tw["router"])[3]
    assert bool(kept.all()) == (case == "no-drops")
    if dtype == "float32":
        jg = jax.jit(jax.grad(lambda ww: jnp.sum(jmoe.moe_ffn(jc, x, ww) ** 2)))(w)
        tg = torch.func.grad(lambda ww: (tmoe.moe_ffn(tc, tx, ww) ** 2).sum())(tw)
        for k in w:
            _close(tg[k], np.asarray(jg[k]), GRAD_TOL, f"{case} grad {k}")


def test_router_load_balance_loss():
    jc, tc = _cfgs()
    w, x = _weights(jc), _tokens(jc)
    want = float(jax.jit(lambda a, ww: jmoe.router_load_balance_loss(jc, a, ww))(x, w))
    got = tmoe.router_load_balance_loss(tc, torch.from_numpy(x), params_from_jax(w, "cpu"))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.fixture(scope="module")
def ref_init():
    """The reference's ``init_moe_ffn`` in f32 at narrow widths (its eager
    draws are slow), as the reference's init runs it: op by op."""
    jc, _ = _cfgs(d_model=32, d_ff=16)
    return jax.device_get(jmoe.init_moe_ffn(jc, jax.random.PRNGKey(3), 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_ffn_tree(ref_init, dtype):
    """The reference's keys, shapes and dtypes from the same key (the router
    f32 in either model dtype); in f32 the draws are its bits, in bf16 the
    router's (drawn in f32 in either)."""
    jc, tc = _cfgs(dtype=dtype, d_model=32, d_ff=16)
    want = jax.eval_shape(lambda k: jmoe.init_moe_ffn(jc, k, 2), jax.random.PRNGKey(3))
    got = tmoe.init_moe_ffn(tc, prng.PRNGKey(3, "cpu"), 2)
    assert sorted(got) == sorted(want)
    for k, x in want.items():
        assert tuple(got[k].shape) == x.shape and str(got[k].dtype) == f"torch.{x.dtype}", k
    assert got["router"].dtype == torch.float32
    ref = params_from_jax(ref_init, "cpu")
    for k in (ref if dtype == "float32" else ["router"]):
        assert torch.equal(got[k], ref[k]), k
    assert tmoe.MOE_GROUP == jmoe.MOE_GROUP
