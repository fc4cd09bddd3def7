"""Port vs reference: a whole gradestc run on granite-moe-1b-a400m's reduced
config on the port's fused engine (local training under ``torch.func.vmap``
over the clients, so the MoE dispatch, its sort and its one-hots run
batched), against the JAX loop engine, with ``test_torch_slice_moe.py``'s
settings: the ledger equal exactly, eval losses within rtol 1e-5, one host
fetch a chunk and an eval."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_slice_moe import check_run, port_runs, reference_run  # noqa: E402


@pytest.fixture(scope="module")
def runs():
    return reference_run("gradestc"), port_runs("gradestc", ("fused",))


def test_gradestc_fused_ledger_exact_and_loss_within_tolerance(runs):
    ref, port = runs
    check_run(ref, *port["fused"], "fused")
    assert port["fused"][0].extra["chunks"] == 2        # an eval every round
