"""The port's dry run of a train shape: tinyllama-1.1b x train_4k on the
single-pod (16, 16) mesh, ``meta`` device (CPU, no card).

The pair runs at a 2-layer cut of the config (``DEPTH``, through
``cfg_overrides``, with the true depth's 4 microbatches), so that the
proof and both cost depths are short; the microbatch rule is checked at
the true depth: the port's ``_auto_grad_accum`` equals the reference's
(copied here: the reference's ``dryrun`` module sets ``XLA_FLAGS`` to 512
devices when imported), 4 for 16 clients.  Status ``ok``; the FLOPs (per
device times the chips) equal a training step's matmuls -- 6 N tokens for
every weight but the embedding, and three times the plain attention's 4 B
H S^2 hd a layer (forward, and its two backward products) -- within
``FLOP_RTOL`` (the rest is the compression's own: encode's GEMMs and the
rSVD); ``model_flops`` is the reference's 6 N tokens; the proof's
collectives are the round's client-axis payload: per compressed group the
all-gather of C clients' M (l sharded over "model") and of A with the key
and d_r words, and the all-reduce of the raw groups' f32 sums (each over
its parameter shards)."""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as jget  # noqa: E402
from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.sharding import make_plan, named, param_specs  # noqa: E402
from repro_torch.launch.steps import compression_policy_for  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import model  # noqa: E402
from test_torch_dryrun import reference_active_params  # noqa: E402

FLOP_RTOL = 5e-3
ARCH = "tinyllama-1.1b"
DEPTH = 2
GRAD_ACCUM = 4       # the true depth's microbatches (checked below)


def reference_grad_accum(cfg, shape, plan, budget=2e9):
    """The reference's ``dryrun._auto_grad_accum``, line for line."""
    C = plan.n_clients
    B_c = max(shape.global_batch // C, 1)
    inner = 1
    for a in plan.inner_batch_axes:
        inner *= plan.mesh.size(a)
    tokens_dev = B_c * shape.seq_len / max(inner, 1)
    save_bytes = cfg.n_layers * tokens_dev * cfg.d_model * 2
    ga = 1
    while save_bytes / ga > budget and ga < B_c:
        ga *= 2
    while B_c % ga:
        ga //= 2
    return max(ga, 1)


def cut(get):
    return dataclasses.replace(get(ARCH), n_layers=DEPTH)


@pytest.fixture(scope="module")
def rec():
    return dryrun.dryrun_pair(ARCH, "train_4k", cfg_overrides={
        "n_layers": DEPTH, "grad_accum_override": GRAD_ACCUM})


def test_grad_accum_is_the_reference_s():
    cfg, shape = get_config(ARCH), get_shape("train_4k")
    plan = make_plan(make_production_mesh(), cfg)
    assert dryrun._auto_grad_accum(cfg, shape, plan) == reference_grad_accum(cfg, shape, plan)
    assert reference_grad_accum(cfg, shape, plan) == GRAD_ACCUM


def test_train_shape_runs(rec):
    assert rec["status"] == "ok" and rec["method"] == "gradestc" and rec["kind"] == "train"
    assert rec["n_clients"] == 16 and rec["client_axes"] == ["data"]
    assert rec["grad_accum"] == GRAD_ACCUM
    assert rec["fits_hbm"] and rec["memory"]["argument_bytes"] > 0


def test_train_flops_are_the_step_s_matmuls(rec):
    cfg, shape = cut(get_config), get_shape("train_4k")
    B, S, L = shape.global_batch, shape.seq_len, cfg.n_layers
    n = reference_active_params(cut(jget))
    want = 6 * n * B * S + 3 * 4 * B * cfg.n_heads * S * S * cfg.hd * L
    total = rec["flops_per_device"] * rec["chips"]
    assert abs(total - want) <= FLOP_RTOL * want, (total, want)
    assert rec["model_flops"] == 6.0 * n * B * S
    assert 0 < rec["useful_ratio"] < 1


def test_train_collectives_are_the_payload(rec):
    cfg = cut(get_config)
    mesh = make_production_mesh()
    plan = make_plan(mesh, cfg)
    pol = compression_policy_for(cfg, plan)
    C = plan.n_clients
    specs = param_specs(plan, model.init_params(cfg, prng.PRNGKey(0, "meta")))
    gather = sum(C * lp.stack * (lp.l * lp.k * 4 / (16 if lp.l % 16 == 0 else 1)
                                 + (4 + 1 + lp.k * lp.m) * 4)
                 for lp in pol.plans.values() if lp.compress)
    reduce = sum(4 * lp.stack * math.prod(lp.shape) / named(mesh, specs[p]).shards
                 for p, lp in pol.plans.items() if not lp.compress)
    assert rec["proof_collectives"] == pytest.approx({"all-gather": gather, "all-reduce": reduce},
                                                     rel=1e-12)
    assert rec["collective_bytes_per_device"] == pytest.approx(gather + reduce, rel=1e-9)
    assert "model" in rec["collectives_not_modelled"]
