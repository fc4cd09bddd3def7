"""Port vs reference: the production step's host rules (``launch/sharding``
and ``launch/steps``), exactly.

For all 10 archs on the single-pod (16, 16) and multi-pod (2, 16, 16)
production meshes: ``param_specs`` (train and serve),
``client_stacked_specs``, ``batch_specs`` of every input shape's batch,
``cache_specs`` of both decode shapes' caches, ``compression_policy_for``'s
(k, l) and ``ge_state_specs`` equal the reference's entry for entry.  The
reference's rules run on a stand-in mesh (``axis_names`` and a numpy
``devices`` array of the mesh's shape): they read nothing else, and 256
or 512 devices would need the dry run's ``XLA_FLAGS``.

``_delta_to_G`` / ``_G_to_delta`` bit for bit against the reference's, on
every compressed group of the reduced archs' policies (the (1, 1) mesh,
the sqrt rule) and of the production policy.  A production group's
tensor is too large to draw, so it runs at a copy of its shape with each
distinct size mapped to a distinct small one (equal sizes stay equal, so
the axis each rule picks is the same); every production l is one of its
group's dims.  ``make_ge_state``'s keys equal the reference's in one
process (both fold ``hash(name)``)."""

import functools
import math
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import SHAPES, arch_names  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.policy import LayerPlan as JPlan  # noqa: E402
from repro.launch import sharding as js  # noqa: E402
from repro.launch import steps as jst  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.policy import LayerPlan as TPlan  # noqa: E402
from repro_torch.launch import sharding as ts  # noqa: E402
from repro_torch.launch import steps as tst  # noqa: E402
from repro_torch.launch.mesh import FLMesh, make_production_mesh  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

ARCHS = arch_names()
MESHES = (False, True)          # single pod, multi-pod


def _jmesh(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=object))


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def _spec(p):
    return tuple(p)


@functools.lru_cache(maxsize=None)
def _pair(arch: str, multi_pod: bool):
    jcfg, tcfg = jget(arch), tconfigs.get_config(arch)
    jplan = js.make_plan(_jmesh(multi_pod), jcfg)
    tplan = ts.make_plan(make_production_mesh(multi_pod=multi_pod), tcfg)
    return jcfg, tcfg, jplan, tplan


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    pshape = jax.eval_shape(functools.partial(jm.init_params, jget(arch)),
                            jax.random.PRNGKey(0))
    return pshape, tm.init_params(tconfigs.get_config(arch), prng.PRNGKey(0, "meta"))


def test_shapes_and_skips_are_the_reference_s():
    assert {k: tuple(v.__dict__.values()) for k, v in tconfigs.SHAPES.items()} == {
        k: tuple(v.__dict__.values()) for k, v in SHAPES.items()}
    from repro.configs import SKIPS
    assert tconfigs.SKIPS == SKIPS
    assert tconfigs.is_skipped("yi-34b", "long_500k") == SKIPS[("yi-34b", "long_500k")]
    assert tconfigs.is_skipped("rwkv6-3b", "long_500k") is None
    assert tconfigs.get_shape("train_4k").global_batch == 256


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal(arch):
    pshape, tparams = _params(arch)
    assert set(_flat(pshape)) == set(tparams)
    for multi in MESHES:
        jcfg, tcfg, jplan, tplan = _pair(arch, multi)
        assert (jplan.huge, jplan.n_clients, jplan.client_axes, jplan.inner_batch_axes) == (
            tplan.huge, tplan.n_clients, tplan.client_axes, tplan.inner_batch_axes)
        for role in ("train", "serve"):
            want = {k: _spec(v) for k, v in _flat(js.param_specs(jplan, pshape, role)).items()}
            assert ts.param_specs(tplan, tparams, role) == want, (multi, role)
        want = {k: _spec(v) for k, v in _flat(js.client_stacked_specs(jplan, pshape)).items()}
        assert ts.client_stacked_specs(tplan, tparams) == want, multi


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal(arch):
    for multi in MESHES:
        jcfg, tcfg, jplan, tplan = _pair(arch, multi)
        for shape in SHAPES.values():
            tshape = tconfigs.get_shape(shape.name)
            jb = jst.train_input_specs(jcfg, shape, jplan)
            tb = tst.train_input_specs(tcfg, tshape, tplan)
            assert {k: v.shape for k, v in jb.items()} == {k: v.shape for k, v in tb.items()}
            want = {k: _spec(v) for k, v in js.batch_specs(jplan, jb, client_axis=True).items()}
            assert ts.batch_specs(tplan, tb, client_axis=True) == want
            for decode in (False, True):
                jb = jst.serve_input_specs(jcfg, shape, decode=decode)
                tb = tst.serve_input_specs(tcfg, tshape, decode=decode)
                want = {k: _spec(v)
                        for k, v in js.batch_specs(jplan, jb, client_axis=False).items()}
                assert ts.batch_specs(tplan, tb, client_axis=False) == want
            if shape.kind != "decode":
                continue
            B, S = shape.global_batch, shape.seq_len
            jc = jax.eval_shape(functools.partial(jm.init_cache, jcfg, B, S))
            tc = tm.init_cache(tcfg, B, S, device="meta")
            want = [_spec(p) for p in jax.tree_util.tree_leaves(
                js.cache_specs(jplan, jc, B), is_leaf=lambda x: isinstance(x, js.P))]
            got = ts.cache_specs(tplan, tc, B)
            assert type(got) is type(tc) and list(got) == want, (multi, shape.name)


@pytest.mark.parametrize("arch", ARCHS)
def test_policy_and_ge_state_specs_equal(arch):
    for multi in MESHES:
        jcfg, tcfg, jplan, tplan = _pair(arch, multi)
        jpol = jst.compression_policy_for(jcfg, jplan)
        tpol = tst.compression_policy_for(tcfg, tplan)
        plan_of = lambda pol: {k: (lp.shape, lp.stack, lp.l, lp.m, lp.k, lp.compress)
                               for k, lp in pol.plans.items()}
        assert plan_of(tpol) == plan_of(jpol), multi
        jg, tg = jst.ge_state_specs(jplan, jpol), tst.ge_state_specs(tplan, tpol)
        assert tg.M == {k: _spec(v) for k, v in jg.M.items()}
        assert tg.keys == {k: _spec(v) for k, v in jg.keys.items()}


def _small_twin(lp):
    """The plan at a shape with every distinct size mapped to a distinct
    small one (so equal dims stay equal and l picks the same axis)."""
    sizes = sorted(set(lp.shape))
    small = {s: 2 + i for i, s in enumerate(sizes)}
    shape = tuple(small[s] for s in lp.shape)
    l = small[lp.l]
    n = math.prod(shape)
    return shape, l, n // l


def _reshape_cases(arch):
    """(shape, stack, l, m) of every compressed group of the reduced arch's
    (1, 1) policy and (shrunk) of the single-pod production policy."""
    cases = set()
    jcfg = jget(arch).reduced()
    jmesh1 = types.SimpleNamespace(axis_names=("data", "model"),
                                   devices=np.empty((1, 1), dtype=object))
    for lp in jst.compression_policy_for(jcfg, js.make_plan(jmesh1, jcfg)).plans.values():
        if lp.compress:
            cases.add((lp.shape, lp.stack, lp.l, lp.m))
    jcfg, _, jplan, _ = _pair(arch, False)
    for lp in jst.compression_policy_for(jcfg, jplan).plans.values():
        if lp.compress:
            assert lp.l in lp.shape
            shape, l, m = _small_twin(lp)
            cases.add((shape, min(lp.stack, 2), l, m))
    return sorted(cases)


@pytest.mark.parametrize("arch", ARCHS)
def test_delta_to_G_bit_equal(arch):
    rng = np.random.default_rng(3)
    for shape, stack, l, m in _reshape_cases(arch):
        jlp = JPlan(name="g", shape=shape, stack=stack, l=l, m=m, k=4, compress=True)
        tlp = TPlan(name="g", shape=shape, stack=stack, l=l, m=m, k=4, compress=True)
        delta = rng.standard_normal((2, stack) + shape).astype(np.float32)
        jG = np.asarray(jst._delta_to_G(jnp.asarray(delta), jlp))
        tG = tst._delta_to_G(torch.from_numpy(delta), tlp)
        assert tG.shape == (2, stack, l, m) and np.array_equal(tG.numpy(), jG), shape
        like = (stack,) + shape
        jd = np.asarray(jst._G_to_delta(jnp.asarray(jG[0]), jlp, like))
        td = tst._G_to_delta(tG[0], tlp, like)
        assert np.array_equal(td.numpy(), jd) and np.array_equal(td.numpy(), delta[0]), shape


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "dbrx-132b", "whisper-medium"])
def test_ge_state_keys_bit_equal(arch):
    """One process, one hash salt: the keys of every compressed group equal
    the reference's (C = 3 clients, seed 5), the bases are zeros."""
    jcfg, tcfg, jplan, tplan = _pair(arch, False)
    jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jpol = jst.compression_policy_for(jcfg, jplan)
    tpol = tst.compression_policy_for(tcfg, tplan)
    jstate = jst.make_ge_state(jcfg, jpol, 3, seed=5)
    tstate = tst.make_ge_state(tcfg, tpol, 3, seed=5, device="cpu")
    assert set(tstate.keys) == set(jstate.keys) and tstate.keys
    for name, k in jstate.keys.items():
        assert tstate.keys[name].dtype == torch.int64
        assert np.array_equal(tstate.keys[name].numpy(), np.asarray(k).astype(np.int64)), name
        assert tstate.M[name].shape == jstate.M[name].shape
        assert not tstate.M[name].any()


def test_named_shards_and_production_mesh():
    mesh = make_production_mesh(multi_pod=True)
    assert (mesh.shape, mesh.mesh_dim_names, mesh.chips) == ((2, 16, 16),
                                                             ("pod", "data", "model"), 512)
    assert mesh.get_group("data") is None
    assert ts.named(mesh, (("pod", "data"), None, "model")).shards == 512
    assert ts.named(mesh, (None, "model")).shards == 16
    assert ts.named(mesh, ()).shards == 1


def test_executing_model_axis_raises():
    """A step on real tensors over a "model" axis above 1 raises, naming
    ROADMAP; the dry run's meta tensors pass."""
    cfg = tconfigs.get_config("tinyllama-1.1b").reduced()
    mesh = FLMesh((1, 2), ("data", "model"))
    plan = ts.make_plan(mesh, cfg)
    pol = tst.compression_policy_for(cfg, plan)
    step = tst.make_fl_round_step(cfg, mesh, plan, pol)
    params = tm.init_params(cfg, prng.PRNGKey(0, "cpu"))
    batch = {k: torch.zeros((1, 2, 8), dtype=torch.int32) for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="ROADMAP"):
        step(params, tst.make_ge_state(cfg, pol, 1, device="cpu"), batch)
