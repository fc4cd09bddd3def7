"""Port vs reference: the production FL round step at C = 1.

``make_fl_round_step`` of each package on a (1, 1) mesh (one client,
trained unbatched) at tinyllama-1.1b's reduced config with vocab 256: 2
rounds of gradestc with ``grad_accum`` 1 (``grad_accum`` 2:
``test_torch_steps_ga2.py``; fedavg: ``test_torch_steps_fedavg.py``; both
share these helpers, a file a compile of the reference's step),
``local_steps`` 2, lr 0.05, batch (1, 2, 32) drawn from one numpy seed.  The reference's
step is jitted (its params from its ``init_params``, handed to the port
by ``convert.params_from_jax``; its ``GEState`` by
``convert.ge_state_from_jax``).  After each round:

  * every parameter within ``PARAM_RTOL`` of max |reference parameter|
    (measured 2.7e-6: the local SGD steps' GEMMs round apart);
  * every group's ``d_r`` metric equal, and ``loss_proxy`` 0;
  * the keys equal bit for bit, and the bases as projections ``M Mᵀ``
    within ``PROJ_ATOL`` (QR and SVD column signs differ between XLA and
    LAPACK; raw columns are never compared).

Each case runs in a thread of its own (where a file has several), and
in it the reference's rounds in a thread beside the port's (XLA's
compiles release the GIL)."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import steps as jst  # noqa: E402
from repro.launch.mesh import make_local_mesh as jlocal  # noqa: E402
from repro.launch.sharding import make_plan as jplan  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import steps as tst  # noqa: E402
from repro_torch.launch.mesh import FLMesh  # noqa: E402
from repro_torch.launch.sharding import make_plan as tplan  # noqa: E402

PARAM_RTOL = 2e-5
PROJ_ATOL = 1e-4
ROUNDS = 2
CASES = [("gradestc", 1)]
KW = dict(lr=0.05, local_steps=2)


def arch(get):
    return dataclasses.replace(get("tinyllama-1.1b").reduced(), vocab=256)


def batches(C: int = 1, B: int = 2, S: int = 32, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ROUNDS):
        tok = rng.integers(0, 256, (C, B, S + 1)).astype(np.int32)
        out.append({"tokens": tok[..., :-1], "labels": tok[..., 1:]})
    return out


def reference_setup(method, ga, C=1):
    """The reference's jitted step and its initial params and state (as
    arrays, and as numpy)."""
    cfg = arch(jget)
    mesh = jlocal((C, 1))
    plan = jplan(mesh, cfg)
    pol = jst.compression_policy_for(cfg, plan)
    step = jax.jit(jst.make_fl_round_step(cfg, mesh, plan, pol, method=method, grad_accum=ga,
                                          **KW))
    # placed as the step returns them, so that round 2 reuses round 1's
    # compile
    params, state = jax.device_put(
        (jm.init_params(cfg, jax.random.PRNGKey(0)), jst.make_ge_state(cfg, pol, C, seed=0)),
        NamedSharding(mesh, PartitionSpec()))
    return step, params, state, jax.device_get((params, state))


def reference_rounds(step, params, state, C=1):
    """The reference's rounds: per round (params, state, metrics) as numpy."""
    rounds = []
    for b in batches(C):
        params, state, met = step(params, state, {k: jnp.asarray(v) for k, v in b.items()})
        rounds.append(jax.device_get((params, state, met)))
    return rounds


def port_run(method, ga, init, mesh=None, rank_rounds=None):
    """The port's rounds from the reference's initial params and state."""
    cfg = arch(tget)
    mesh = mesh or FLMesh((1, 1), ("data", "model"))
    plan = tplan(mesh, cfg)
    pol = tst.compression_policy_for(cfg, plan)
    step = tst.make_fl_round_step(cfg, mesh, plan, pol, method=method, grad_accum=ga, **KW)
    params = convert.params_from_jax(init[0], "cpu")
    state = convert.ge_state_from_jax(init[1], "cpu")
    out = []
    for b in rank_rounds or batches(plan.n_clients):
        params, state, met = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append((params, state, {k: float(v) for k, v in met.items()}))
    return out


def check_round(ref, got, label=""):
    """One round's port result ``got`` against the reference's ``ref``."""
    jparams, jstate, jmet = ref
    params, state, met = got
    want = convert.params_from_jax(jparams, "cpu")
    assert set(params) == set(want)
    for k, w in want.items():
        err = float((params[k] - w).abs().max())
        assert err <= PARAM_RTOL * float(w.abs().max()), (label, k, err)
    assert met == {k: float(v) for k, v in jmet.items()}, label
    assert set(state.M) == set(jstate.M)
    for name, M in jstate.M.items():
        assert np.array_equal(state.keys[name].numpy(),
                              np.asarray(jstate.keys[name]).astype(np.int64)), (label, name)
        M = torch.from_numpy(np.array(M))
        proj = lambda x: x @ x.mT
        err = float((proj(state.M[name]) - proj(M)).abs().max())
        assert err <= PROJ_ATOL, (label, name, err)


def run_case(case):
    """((reference init, reference rounds), port rounds) of one case: the
    reference's rounds in a thread beside the port's (XLA's compile
    releases the GIL)."""
    step, params, state, init = reference_setup(*case)
    with ThreadPoolExecutor(1) as pool:
        ref_rounds = pool.submit(reference_rounds, step, params, state)
        got = port_run(*case, init)
        return (init, ref_rounds.result()), got


def run_cases(cases):
    """{case: run_case(case)}, each case in a thread of its own."""
    with ThreadPoolExecutor(len(cases)) as pool:
        return dict(zip(cases, pool.map(run_case, cases)))


def check_case(runs, case):
    (_, ref_rounds), got = runs[case]
    assert len(got) == len(ref_rounds) == ROUNDS
    for r, (ref, port) in enumerate(zip(ref_rounds, got)):
        check_round(ref, port, f"{case} round {r}")
    d_r = {k: v for k, v in got[-1][2].items() if k.startswith("d_r/")}
    assert bool(d_r) == (case[0] == "gradestc")
    assert got[-1][2]["loss_proxy"] == 0.0


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES)


@pytest.mark.parametrize("case", CASES, ids=[f"{m}-ga{g}" for m, g in CASES])
def test_round_step_matches_reference(runs, case):
    check_case(runs, case)


def test_gradestc_moves_every_basis(runs):
    """Round 1 starts from zero bases: every compressed group's basis moves
    off zero, and the sqrt rule's d_r is the static d on every group."""
    (_, _), got = runs[("gradestc", 1)]
    assert all(M.abs().max() > 0 for M in got[0][1].M.values())
    assert {v for k, v in got[0][2].items() if k.startswith("d_r/")} == {16.0}
