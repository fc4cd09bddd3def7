"""Port vs reference: whole gradestc runs on whisper-medium's reduced
config.

``run_fl`` on ``get_config("whisper-medium").reduced()`` from each package
(2 encoder and 2 decoder layers over 64 zero audio frames, d 256, 4
heads, vocab 1024, f32) with ``test_torch_slice_ssm.py``'s settings and
checks, on the loop and the fused engine (encoder, decoder and
cross-attention vmapped over the clients): the ledger equal exactly, eval
losses within rtol 1e-5 (measured 1.4e-7), the host fetches, and the
parameters outside the groups (the learned positions, the MLP biases,
every LayerNorm) at their initial values in every eval."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_slice_ssm import ENGINES, check_run, check_write_back, runs_of  # noqa: E402

NAME = "whisper-medium"


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
