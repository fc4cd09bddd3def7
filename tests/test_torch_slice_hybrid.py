"""Port vs reference: whole gradestc runs on recurrentgemma-9b's reduced
config.

``run_fl`` on ``get_config("recurrentgemma-9b").reduced()`` from each
package (3 layers: rec, rec, local; d 256, 4 query heads over 1 KV head,
window 16, vocab 1024, f32) with ``test_torch_slice_ssm.py``'s settings
and checks, at seq 32, so the local layer's window masks, on the loop and
the fused engine (the RG-LRU scan and the local attention vmapped over
the clients): the ledger equal exactly, eval losses within rtol 1e-5
(measured 1.3e-7), the host fetches, and the parameters outside the
groups (the conv taps, ``lru_lambda``, every RMS norm) at their initial
values in every eval."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_slice_ssm import ENGINES, check_run, check_write_back, runs_of  # noqa: E402

NAME = "recurrentgemma-9b"


@pytest.fixture(scope="module")
def runs():
    return runs_of(NAME)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_gradestc_ledger_exact_and_loss_within_tolerance(runs, engine):
    ref, port, _ = runs
    check_run(ref, *port[engine][:2], engine)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_parameters_outside_groups_keep_server_value(runs, engine):
    _, port, init = runs
    check_write_back(NAME, init, port[engine][2])
