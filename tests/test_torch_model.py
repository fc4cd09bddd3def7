"""Port vs reference: the dense model, its loss, gradients and SGD step.

Parameters come from the reference's ``model.init_params`` through
``convert.params_from_jax``.  Loss and gradients within rtol 1e-5, atol
1e-6 (measured: loss rel diff <= 1.1e-7, the worst gradient entry at 0.88 of
that budget); the port's own initialization equals the converted one bit
for bit (its normals are jax's)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import model as jmodel  # noqa: E402
from repro.models.config import ArchConfig as JArch  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.config import ArchConfig as TArch  # noqa: E402
from repro_torch.optim.optimizers import sgd as t_sgd  # noqa: E402

ARCH = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=256, vocab=64, dtype="float32")
#: "chunked" walks the port's query-chunk attention and chunked-CE loops;
#: chunking changes no math, so both variants are held to the same reference.
VARIANTS = {"plain": {}, "chunked": dict(attn_chunk=8, ce_chunk=8)}


def _batch(seed=0, B=2, S=16, V=64):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, size=(B, S + 1)).astype(np.int32)
    return {"tokens": x[:, :-1], "labels": x[:, 1:]}


@pytest.fixture(scope="module")
def jref():
    """The reference's params, and its loss and grads on one batch."""
    ja = JArch(**ARCH)
    params = jax.device_get(jmodel.init_params(ja, jax.random.PRNGKey(0)))
    b = _batch()
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodel.loss_fn(ja, p, b)))(params)
    return params, b, float(loss), jax.device_get(grads)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match(jref, variant):
    params, b, jl, jg = jref
    ta = TArch(**{**ARCH, **VARIANTS[variant]})
    tp = params_from_jax(params, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tl = tmodel.loss_fn(ta, tp, tb)
    tg = torch.func.grad(lambda p: tmodel.loss_fn(ta, p, tb))(tp)
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5, atol=1e-6)
    jgf = params_from_jax(jg, "cpu")
    assert set(jgf) == set(tg)
    for name in jgf:
        np.testing.assert_allclose(tg[name].numpy(), jgf[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_sgd_step_matches(jref):
    params, _, _, jg = jref
    j_init, j_upd = j_sgd(0.05)
    jnew, _ = j_upd(jg, j_init(params), params)
    tp = params_from_jax(params, "cpu")
    t_init, t_upd = t_sgd(0.05)
    tnew, _ = t_upd(params_from_jax(jg, "cpu"), t_init(tp), tp)
    for name, x in params_from_jax(jax.device_get(jnew), "cpu").items():
        np.testing.assert_array_equal(tnew[name].numpy(), x.numpy(), err_msg=name)


def test_port_init_matches_converted_reference(jref):
    tp = tmodel.init_params(TArch(**ARCH), prng.PRNGKey(0, "cpu"))
    ref = params_from_jax(jref[0], "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    for name, x in ref.items():
        np.testing.assert_array_equal(tp[name].numpy().view(np.int32),
                                      x.numpy().view(np.int32), err_msg=name)


def test_param_group_shapes_cover_params(jref):
    ta = TArch(**ARCH)
    tp = params_from_jax(jref[0], "cpu")
    groups = tmodel.param_group_shapes(ta)
    assert set(groups) == set(tp)
    for name, (shape, stack) in groups.items():
        want = (stack,) + tuple(shape) if name.startswith("layers/") else tuple(shape)
        assert tuple(tp[name].shape) == want
    ssm = dataclasses.replace(ta, family="ssm")
    assert tmodel.param_group_shapes(ssm) == jmodel.param_group_shapes(
        dataclasses.replace(JArch(**ARCH), family="ssm"))
    moe = tmodel.param_group_shapes(dataclasses.replace(ta, family="moe", n_experts=4,
                                                        experts_per_tok=2))
    assert moe["layers/moe_wgate"] == ((4, 64, 256), 2) and moe["layers/router"] == ((64, 4), 2)
    assert not any(name.startswith("layers/mlp_") for name in moe)
