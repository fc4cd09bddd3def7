"""The worlds that the sharded engine runs in (CPU, gloo).

* ``run_fl(devices=2)`` from a process with no process group starts its
  own two ranks and returns rank 0's result, equal in its ledger to the
  single-device fused run; ``progress`` is called with rank 0's evals.
* A rank that raises fails ``run_world`` with that rank's traceback while
  the other rank waits in a collective: it is killed, not waited for.
* Asking for more ranks than the backend can place raises ``ValueError``
  (NCCL without cards; gloo past the host's cores); so does a mesh whose
  world is missing or of another size.  Every group this package creates
  has a timeout of a minute at most."""

import datetime

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.fl import simulation as tsim  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from test_torch_sharded import config  # noqa: E402


def _fail_on_rank_1(rank: int):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    # rank 0 waits for rank 1 in a collective that never comes
    dist.all_reduce(torch.ones(3))
    return rank


def test_run_fl_starts_its_own_world():
    assert not dist.is_initialized()
    seen = []
    res = tsim.run_fl(config("gradestc", devices=2), lambda rnd, info: seen.append((rnd, info)))
    ref = tsim.run_fl(config("gradestc"))
    assert res.extra["devices"] == 2 and res.extra["rank"] == 0
    assert res.ledger.per_round_uplink_bits == ref.ledger.per_round_uplink_bits
    assert res.extra["sum_d"] == ref.extra["sum_d"]
    np.testing.assert_allclose(res.eval_loss, ref.eval_loss, rtol=0, atol=1e-5)
    assert [r for r, _ in seen] == res.eval_rounds == [0, 2, 3]
    assert [info["loss"] for _, info in seen] == res.eval_loss
    assert not dist.is_initialized()


def test_a_failing_rank_fails_the_world():
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 fails on purpose"):
        mesh.run_world(_fail_on_rank_1, 2, "gloo")


def test_ranks_the_backend_cannot_place_raise():
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="nccl"):
            mesh.run_world(_fail_on_rank_1, 2, "nccl")
    with pytest.raises(ValueError, match="gloo"):
        mesh.run_world(_fail_on_rank_1, mesh.ranks_available("gloo") + 1, "gloo")
    with pytest.raises(ValueError, match="no process group"):
        mesh.make_fl_mesh(2)
    assert mesh.make_fl_mesh(1).shape == (1, 1)
    assert mesh.PG_TIMEOUT <= datetime.timedelta(minutes=1)
