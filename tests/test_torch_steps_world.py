"""The production FL round step over ranks: a gloo world of 2 (CPU).

``_rank`` is the world's function, which ``test_torch_steps_c2.py`` runs
against the JAX reference; it lives here, in a file that imports no JAX,
so that the spawned ranks import none.  This file's own checks need no
world: where the clients split (``FLRoundSpecs.lanes``, one lane a rank
when the world is the client axis), and that a logical mesh -- one
process, no process group -- runs every lane and counts no collective,
while its ``trace`` names the collectives a world would make: per
compressed group an all-gather of M and one of the key, d_r and A words,
and one all-reduce entry per dense group."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import metrics, prng  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import FLMesh, make_local_mesh  # noqa: E402
from repro_torch.launch.sharding import FLRoundSpecs, make_plan  # noqa: E402
from repro_torch.models import model  # noqa: E402

KW = dict(lr=0.05, local_steps=2)


def arch():
    return dataclasses.replace(get_config("tinyllama-1.1b").reduced(), vocab=256)


def run_rounds(mesh, method, params, state, rounds, trace=None):
    """The port's step on ``mesh`` over ``rounds`` (numpy batches, all
    clients): per round (params, state, metrics as floats, collectives)."""
    cfg = arch()
    plan = make_plan(mesh, cfg)
    pol = steps.compression_policy_for(cfg, plan)
    step = steps.make_fl_round_step(cfg, mesh, plan, pol, method=method, trace=trace, **KW)
    out = []
    for b in rounds:
        metrics.reset_collective_count()
        params, state, met = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append((params, state, {k: float(v) for k, v in met.items()},
                    metrics.collective_count()))
    return out


def _rank(rank: int, methods, params, state, rounds):
    """One rank of a 2-rank world: ``run_rounds`` per method on
    ``make_local_mesh((2, 1))`` from the same params and GEState."""
    mesh = make_local_mesh((2, 1), ("data", "model"))
    return {m: run_rounds(mesh, m, dict(params), state, rounds) for m in methods}


def test_lanes_split_one_a_rank():
    cfg = arch()
    plan = make_plan(FLMesh((2, 1), ("data", "model")), cfg)
    spec = FLRoundSpecs(plan)
    assert plan.n_clients == spec.n_shards == 2
    assert spec.group is None and spec.lanes(2) == slice(0, 1)     # rank 0's lane


def test_logical_mesh_runs_every_lane_and_traces_the_collectives():
    cfg = arch()
    mesh = FLMesh((2, 1), ("data", "model"))
    plan = make_plan(mesh, cfg)
    pol = steps.compression_policy_for(cfg, plan)
    params = model.init_params(cfg, prng.PRNGKey(0, "cpu"))
    state = steps.make_ge_state(cfg, pol, 2, device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 256, (2, 2, 17)).astype(np.int32)
    trace = []
    (new, st, met, coll), = run_rounds(mesh, "gradestc", params, state,
                                       [{"tokens": tok[..., :-1], "labels": tok[..., 1:]}],
                                       trace=trace)
    comp = [p for p, lp in pol.plans.items() if lp.compress]
    raw = [p for p, lp in pol.plans.items() if not lp.compress]
    assert coll == 0                                # no world: no collective made
    assert [op for op, _, _ in trace] == ["all-gather"] * 2 * len(comp) + ["all-reduce"] * len(raw)
    for name in comp:
        assert st.M[name].shape[0] == 2 and all(st.M[name][c].abs().max() > 0 for c in (0, 1))
        assert met[f"d_r/{name}"] == 16.0
    # the M gathers' bytes: C lanes of L l k f32 words each
    m_bytes = [b for (op, b, _), i in zip(trace, range(2 * len(comp))) if i % 2 == 0]
    assert m_bytes == [2 * pol.plans[n].stack * pol.plans[n].l * pol.plans[n].k * 4 for n in comp]
    assert set(new) == set(params) and all(torch.isfinite(x).all() for x in new.values())
