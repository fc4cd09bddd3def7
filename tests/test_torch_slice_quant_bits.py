"""Port vs reference: a whole fedpaq run at 6 bits on the block-local wire.

``run_fl`` with the loop engine, the port on the CPU against the JAX loop
engine, on ``test_torch_slice_quant.py``'s small config, for fedpaq with
``method_kw={"bits": 6}`` and ``use_pallas=True`` on both sides.  6 bits is
a width the fused quant_pack kernel does not take: the reference sends it
to its oracle, and the port to the block quantizer (the ``block_quant`` /
``block_dequant`` kernels on the card, their plain versions here) around an
integer pack.  ``ledger.per_round_uplink`` must be equal exactly and equal
the closed form (6 bits a value and a 32-bit scale per 512 values, every
group); eval loss within 5e-4, the reference's tolerance for the stochastic
quantizer codecs (an ulp of difference in a delta can flip a rounding draw
and move a weight by a whole step).  The reference runs once, in a
module-scoped fixture."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.fl import simulation as jsim  # noqa: E402
from repro.models.config import ArchConfig as JArch  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.fl import simulation as tsim  # noqa: E402
from repro_torch.models.config import ArchConfig as TArch  # noqa: E402
from test_torch_slice_quant import ARCH, RUN, check_ledger, check_syncs, group_sizes  # noqa: E402

BITS = 6
QUANT_LOSS_ATOL = 5e-4


@pytest.fixture(scope="module")
def runs():
    kw = dict(method="fedpaq", use_pallas=True, method_kw={"bits": BITS}, engine="loop", **RUN)
    ref = jsim.run_fl(jsim.FLConfig(arch=JArch(**ARCH), **kw))
    tmetrics.reset_host_sync_count()
    res = tsim.run_fl(tsim.FLConfig(arch=TArch(**ARCH), device="cpu", **kw))
    return ref, res, tmetrics.host_sync_count()


def test_uplink_ledger_exact_and_closed_form(runs):
    ref, res, _ = runs
    per_round = RUN["n_clients"] * sum(BITS * n + 32 * -(-n // 512) for n in group_sizes())
    check_ledger(ref, res, per_round)


def test_eval_loss_within_tolerance(runs):
    ref, res, syncs = runs
    assert res.eval_rounds == ref.eval_rounds == [0, 2]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=0, atol=QUANT_LOSS_ATOL)
    check_syncs(res, syncs, True)
