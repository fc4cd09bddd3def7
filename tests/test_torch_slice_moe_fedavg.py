"""Port vs reference: whole fedavg runs on granite-moe-1b-a400m's reduced
config, loop and fused, against the JAX loop engine, as
``test_torch_slice_moe.py`` holds gradestc: the ledger equal exactly (32
bits a parameter, the f32 router included), eval losses within rtol 1e-5."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import model  # noqa: E402
from test_torch_slice_moe import (ENGINES, NAME, RUN, check_run, port_runs,  # noqa: E402
                                  reference_run)


@pytest.fixture(scope="module")
def runs():
    return reference_run("fedavg"), port_runs("fedavg")


@pytest.mark.parametrize("engine", list(ENGINES))
def test_fedavg_ledger_exact_and_loss_within_tolerance(runs, engine):
    ref, port = runs
    check_run(ref, *port[engine], engine)
    n = sum(s * int(np.prod(shape)) for shape, s in model.param_group_shapes(
        tget(NAME).reduced()).values())
    assert port[engine][0].ledger.uplink_bits == 32 * n * RUN["n_clients"] * RUN["rounds"]
