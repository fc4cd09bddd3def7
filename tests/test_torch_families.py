"""Port vs reference: the MoE transformer family (granite-moe-1b-a400m,
dbrx-132b) and what the three new families share.

Reduced configs in f32 (4 experts, top 2, d 256, 2 layers), numpy params in
the reference's tree carried across by ``convert.params_from_jax``: the
forward and the loss against the reference's jitted ones (logits within 1e-5
of max |logits|, loss rtol 1e-5), every gradient of ``loss_fn`` against
``jax.grad`` (within 1e-5 of each leaf's max |gradient|; measured <= 1.2e-6),
24 decode steps against the reference's jitted ``decode_step`` (1e-5), and
decode against the port's own forward with ``capacity_factor=8.0``, where
no token is dropped (the reference's ``test_decode_matches_forward``).
``gqa_native`` (granite reduced over 2 KV heads) leaves the forward's bits
as they are and stays within 1e-5 of the reference's.  For the three full
configs, the published fields, ``param_group_shapes`` and ``make_policy``'s
plans equal the reference's (host only, no weights).  ``family_module``
serves every family of the reference (the transformer's module refuses the
ssm, hybrid and encdec ones) and no unknown one; an MoE tree in bf16 keeps
its f32 router through ``params_from_jax`` and a checkpoint round trip (the
port's and the reference's files), bit for bit.  (The serve driver on these
families: ``test_torch_serve_families.py``.)"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.policy import make_policy as jpolicy  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policy import make_policy as tpolicy  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import encdec, rglru, rwkv6, transformer  # noqa: E402
from test_torch_decode import (B, _cfgs, _close, _numpy_params, _port_decode,  # noqa: E402
                               _ref_decode, _tokens)

MOE = ["granite-moe-1b-a400m", "dbrx-132b"]
NEW = MOE + ["qwen2-vl-72b"]
GRAD_TOL = 1e-5


@pytest.fixture(scope="module")
def moe_params():
    out = {}
    for i, name in enumerate(MOE):
        p = _numpy_params(_cfgs(name)[0], 10 + i)
        out[name] = (p, params_from_jax(p, "cpu"))
    return out


def _batch(cfg, seed=7, S=24):
    x = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": x[:, :-1], "labels": x[:, 1:]}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", MOE)
def test_forward_loss_and_grads(moe_params, name):
    """Capacity drops on (1.25, 48 tokens a group): the forward, the loss
    and every leaf's gradient against the reference's."""
    jc, tc = _cfgs(name)
    assert (tc.family, tc.n_experts, tc.experts_per_tok) == ("moe", 4, 2)
    jp, tp = moe_params[name]
    batch = _batch(tc)
    want = np.asarray(jax.jit(lambda p: jmodel.forward(jc, p, batch))(jp))
    _close(tmodel.forward(tc, tp, _torch(batch)).numpy(), want, "forward")
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jmodel.loss_fn(jc, p, batch)))(jp)
    tl, tg = torch.func.grad_and_value(lambda p: tmodel.loss_fn(tc, p, _torch(batch)))(tp)[::-1]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jg = params_from_jax(jax.device_get(jg), "cpu")
    assert set(tg) == set(jg) and "layers/router" in tg and "layers/mlp_win" not in tg
    for path, g in jg.items():
        _close(tg[path].numpy(), g.numpy(), path, GRAD_TOL)


@pytest.mark.parametrize("name", MOE)
def test_decode(moe_params, name):
    """24 steps against the reference's decode_step; with capacity 8.0,
    against the port's own forward over the same tokens."""
    jc, tc = _cfgs(name)
    jp, tp = moe_params[name]
    toks = _tokens(tc, seed=8)
    want, _ = _ref_decode(jc, jp, toks, 32)
    got, _ = _port_decode(tc, tp, toks, 32)
    _close(got, want, "decode vs reference")
    roomy = dataclasses.replace(tc, capacity_factor=8.0)
    fwd = tmodel.forward(roomy, tp, {"tokens": torch.from_numpy(toks)}).numpy()
    _close(_port_decode(roomy, tp, toks, 32)[0], fwd, "decode vs forward")


def test_gqa_native_leaves_forward_bits(moe_params):
    """granite reduced over 2 KV heads: ``attention_gqa`` (flag on) gives the
    forward the bits of the repeated K/V (flag off), as the reference's
    ``test_gqa_native_bit_exact``, and the reference's logits within 1e-5."""
    jp = _numpy_params(_cfgs(MOE[0], n_kv_heads=2)[0], 12)
    tp = params_from_jax(jp, "cpu")
    batch = _batch(_cfgs(MOE[0])[1], seed=9, S=80)      # past attn_chunk 64: two chunks
    out = {}
    for flag in (False, True):
        jc, tc = _cfgs(MOE[0], n_kv_heads=2, gqa_native=flag)
        out[flag] = tmodel.forward(tc, tp, _torch(batch))
    assert torch.equal(out[True], out[False])
    want = np.asarray(jax.jit(lambda p: jmodel.forward(jc, p, batch))(jp))
    _close(out[True].numpy(), want, "gqa_native forward")


@pytest.mark.parametrize("name", NEW)
def test_full_config_groups_and_plans(name):
    """Published fields, group shapes and the compression plans (k, l, m,
    compress) at full width, equal to the reference's."""
    jc, tc = jget(name), tget(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    groups = tmodel.param_group_shapes(tc)
    assert groups == jmodel.param_group_shapes(jc)
    want, got = jpolicy(groups, min_params=4096), tpolicy(groups, min_params=4096)
    assert list(got.plans) == list(want.plans)
    for path, plan in want.plans.items():
        assert dataclasses.asdict(got.plans[path]) == dataclasses.asdict(plan), path
    if tc.n_experts:
        assert not got.plans["layers/router"].compress
        assert got.plans["layers/moe_wgate"].compress


def test_family_module():
    for name in ("tinyllama-1.1b", *NEW):
        assert tmodel.family_module(tget(name)) is transformer
    base = tget("granite-moe-1b-a400m")
    for family, module in (("ssm", rwkv6), ("hybrid", rglru), ("encdec", encdec)):
        assert tmodel.family_module(dataclasses.replace(base, family=family)) is module
        with pytest.raises(NotImplementedError):
            transformer.init_cache(dataclasses.replace(base, family=family), 1, 2, device="cpu")
    with pytest.raises(ValueError):
        tmodel.family_module(dataclasses.replace(base, family="mamba"))


def test_moe_checkpoint_roundtrip(tmp_path):
    """granite reduced in bf16: the f32 router comes across from the
    reference's tree beside bf16 banks; the port's checkpoint and the
    reference's file both restore the tree bit for bit."""
    jc, _ = _cfgs(MOE[0], dtype="bfloat16")
    jp = _numpy_params(jc, 13)
    tp = params_from_jax(jp, "cpu")
    assert tp["layers/router"].dtype == torch.float32
    assert tp["layers/moe_wgate"].dtype == tp["embed"].dtype == torch.bfloat16
    template = {k: torch.empty_like(x) for k, x in tp.items()}
    tckpt.save(str(tmp_path / "port"), 3, tp)
    jckpt.save(str(tmp_path / "ref"), 3, jp)
    for d in ("port", "ref"):
        back = tckpt.restore(str(tmp_path / d), 3, template)
        for k, x in tp.items():
            assert back[k].dtype == x.dtype and torch.equal(back[k], x), (d, k)

