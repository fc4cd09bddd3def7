"""Port vs reference: the optimizers and LR schedules of ``repro_torch.optim``.

The same numpy params and per-step grads go through the reference's
``repro.optim`` (eager, as its own tests run it) and the port for 50 steps.
Plain, momentum and Nesterov SGD with a float lr match bit for bit, in f32
and bf16.  Adam and the cosine schedule go through a power or a cosine,
whose last bit XLA's and torch's libm may round differently.  Measured in
f32: the cosine schedule within 1.2e-7 absolute of the reference (linear
warm-up and constant bit-equal), the 50-step trajectories within 2.4e-7
absolute, at most 0.14 of the tests' budget of ``1e-7 + 1e-6 |ref|`` (rtol
1e-6, atol 1e-7); in bf16 every case came out bit-equal, and the test
allows one bf16 ulp (2^-7 relative), what one f32 ulp can move.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.optim.optimizers import OptState  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7
STEPS = 50
SHAPES = {"w": (8, 16), "layers/b": (32,), "h": (4, 4, 4)}


def _schedule(pkg, name):
    return {"cosine": pkg.cosine_decay(0.1, STEPS, warmup_steps=5, floor=0.1),
            "warmup": pkg.linear_warmup(0.05, 10),
            "constant": pkg.constant(0.03)}[name]


#: (label, optimizer name, lr: float or schedule name, kwargs, bit-exact)
CASES = [
    ("sgd", "sgd", 0.05, {}, True),
    ("momentum", "sgd", 0.05, {"momentum": 0.9}, True),
    ("nesterov", "sgd", 0.05, {"momentum": 0.9, "nesterov": True}, True),
    ("sgd-cosine", "sgd", "cosine", {}, False),
    ("momentum-warmup", "sgd", "warmup", {"momentum": 0.9}, False),
    ("adam", "adam", 1e-2, {}, False),
    ("adamw", "adam", 1e-2, {"weight_decay": 0.01}, False),
    ("adam-cosine", "adam", "cosine", {"b1": 0.8, "b2": 0.99}, False),
    ("adam-constant", "adam", "constant", {"eps": 1e-6}, False),
]


def _build(pkg, name, lr, kw):
    lr = _schedule(pkg, lr) if isinstance(lr, str) else lr
    return getattr(pkg, name)(lr, **kw)


def _params(rng, dtype):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _run(label, name, lr, kw, dtype):
    rng = np.random.default_rng(len(label))
    p0 = _params(rng, dtype)
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    ji, ju = _build(jopt, name, lr, kw)
    ti, tu = _build(topt, name, lr, kw)
    js, ts = ji(jp), ti(tp)
    traj = []
    for g in grads:
        jp, js = ju({k: jnp.asarray(v, jdt) for k, v in g.items()}, js, jp)
        tp, ts = tu({k: torch.from_numpy(v).to(tdt) for k, v in g.items()}, ts, tp)
        traj.append(({k: np.asarray(v.astype(jnp.float32)) for k, v in jp.items()},
                     {k: v.float().numpy() for k, v in tp.items()}))
    return traj, js, ts


#: bf16 params: the exact cases and Adam (its moments stay f32)
BF16 = ("sgd", "momentum", "nesterov", "adam", "adam-cosine")


@pytest.mark.parametrize("label,name,lr,kw,exact,dtype",
                         [(*c, "f32") for c in CASES]
                         + [(*c, "bf16") for c in CASES if c[0] in BF16],
                         ids=[f"{c[0]}-f32" for c in CASES]
                         + [f"{c[0]}-bf16" for c in CASES if c[0] in BF16])
def test_trajectory_matches_reference(label, name, lr, kw, exact, dtype):
    traj, js, ts = _run(label, name, lr, kw, dtype)
    for i, (jp, tp) in enumerate(traj):
        for k in SHAPES:
            if exact:
                np.testing.assert_array_equal(tp[k], jp[k], err_msg=f"step {i} {k}")
            elif dtype == "f32":
                np.testing.assert_allclose(tp[k], jp[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"step {i} {k}")
            else:   # an ulp of f32 can move a bf16 rounding by one bf16 ulp
                np.testing.assert_allclose(tp[k], jp[k], rtol=2 ** -7, atol=1e-6,
                                           err_msg=f"step {i} {k}")
    assert int(ts.step) == int(js.step) == STEPS


@pytest.mark.parametrize("name", ["constant", "warmup", "cosine", "cosine-nowarm"])
def test_schedules_match_reference(name):
    def pick(pkg):
        if name == "cosine-nowarm":
            return pkg.cosine_decay(2.0, 100)
        return _schedule(pkg, name)

    js, ts = pick(jopt), pick(topt)
    for s in range(0, 130):
        want = np.asarray(js(jnp.asarray(s, jnp.int32)))
        got = ts(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=f"step {s}")


def test_adam_state_layout_matches_reference():
    """Adam's state: a 0-dim int32 step and (m, v) in f32, whatever the
    params' dtype, as the reference's."""
    init, update = topt.adam(1e-3)
    p = {"w": torch.ones(3, 2, dtype=torch.bfloat16)}
    st = init(p)
    assert st.step.dtype == torch.int32 and st.step.dim() == 0
    assert all(x.dtype == torch.float32 for s in st.slots for x in s.values())
    p2, st2 = update({"w": torch.ones(3, 2, dtype=torch.bfloat16)}, st, p)
    assert p2["w"].dtype == torch.bfloat16 and int(st2.step) == 1


def _quad(init, update, steps=200):
    """The reference's convergence check: minimise sum(x^2) from (3, -2)."""
    params = {"x": torch.tensor([3.0, -2.0])}
    st = init(params)
    for _ in range(steps):
        g = torch.func.grad(lambda p: (p["x"] ** 2).sum())(params)
        params, st = update(g, st, params)
    return float(params["x"].abs().max())


@pytest.mark.parametrize("opt,bound", [
    (lambda: topt.sgd(0.1), 1e-3),
    (lambda: topt.sgd(0.05, momentum=0.9), 1e-3),
    (lambda: topt.adam(0.1), 1e-2),
], ids=["sgd", "momentum", "adam"])
def test_converges(opt, bound):
    assert _quad(*opt()) < bound


def test_schedule_values():
    """The reference's ``test_schedules`` on the port."""
    s = topt.cosine_decay(1.0, 100, warmup_steps=10)
    t = lambda i: torch.tensor(i, dtype=torch.int32)
    assert float(s(t(0))) == 0.0
    assert float(s(t(10))) == pytest.approx(1.0, abs=1e-3)
    assert float(s(t(100))) < 0.01
    assert float(topt.linear_warmup(2.0, 4)(t(2))) == pytest.approx(1.0)
    assert float(topt.constant(0.3)(t(7))) == pytest.approx(0.3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_sgd_is_the_clients_formula(dtype):
    """``sgd(float)``: a Python-int step, no slots, and each parameter
    ``(p.float() - lr * g.float()).to(p.dtype)``, bit for bit, also under
    ``torch.func.vmap`` over clients as the fused engine runs it."""
    gen = torch.Generator().manual_seed(0)
    p = {"a": torch.randn(3, 5, 7, generator=gen).to(dtype),
         "b": torch.randn(3, 11, generator=gen).to(dtype)}
    g = {k: torch.randn(v.shape, generator=gen).to(dtype) for k, v in p.items()}
    init, update = topt.sgd(0.05)
    st = init(p)
    assert st == OptState(step=0, slots=None)
    new, st2 = update(g, st, p)
    assert st2 == OptState(step=1, slots=None)
    for k in p:
        want = (p[k].float() - 0.05 * g[k].float()).to(dtype)
        assert torch.equal(new[k], want), k
    batched = torch.func.vmap(lambda gg, pp: update(gg, st, pp)[0])(g, p)
    for k in p:
        assert torch.equal(batched[k], new[k]), k
