"""Port vs reference: the production FL round step at C = 1, gradestc
over two microbatches.

``test_torch_steps.py``'s check (its helpers and tolerances) for
gradestc with ``grad_accum`` 2: the microbatch gradients summed as the
reference's ``g_acc + g / grad_accum``; every parameter within
``PARAM_RTOL`` of max |reference parameter|, ``d_r`` and the keys equal,
the bases as projections within ``PROJ_ATOL``."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_steps import check_case, run_cases  # noqa: E402

CASES = [("gradestc", 2)]


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES)


@pytest.mark.parametrize("case", CASES, ids=[f"{m}-ga{g}" for m, g in CASES])
def test_round_step_matches_reference(runs, case):
    check_case(runs, case)
