"""Port vs reference: the production FL round step at C = 1, fedavg.

``test_torch_steps.py``'s check (its helpers and tolerances) for fedavg,
``grad_accum`` 1 and 2: every parameter within ``PARAM_RTOL`` of max
|reference parameter|, no ``d_r`` metric, and the ``GEState`` passed
through untouched (zero bases, the keys as they came)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from test_torch_steps import check_case, run_cases  # noqa: E402

CASES = [("fedavg", 1), ("fedavg", 2)]


@pytest.fixture(scope="module")
def runs():
    return run_cases(CASES)


@pytest.mark.parametrize("case", CASES, ids=[f"{m}-ga{g}" for m, g in CASES])
def test_round_step_matches_reference(runs, case):
    check_case(runs, case)


def test_fedavg_leaves_the_state(runs):
    (init, _), got = runs[("fedavg", 1)]
    state = got[-1][1]
    assert set(state.M) == set(init[1].M) and state.M
    for name in init[1].M:
        assert not state.M[name].any()
        assert np.array_equal(state.keys[name].numpy(),
                              np.asarray(init[1].keys[name]).astype(np.int64))
