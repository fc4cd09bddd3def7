"""The encode kernels' split plan (``gradestc_encode.split_plan``), and why
encode_quant does not split.

The CUDA encode kernel sums A = M^T G over S chunks of LC rows of l in
separate blocks, then adds the (L, S, k, m) partials in split order.  The
plan is chosen in Python from the shapes alone, so it is held here on the
CPU: at every compressed group shape of the TinyLlama-1.1B slice (2 layers)
and of Gemma3-1B (6 layers), and at ragged shapes, the chunks cover l with
none empty, LC is a multiple of the kernel's row tile, the grid holds two
waves of the H100's 132 SMs wherever the smallest chunk allows that many
blocks, and the partials' bytes stay within G's.

encode_quant sums l in one sequential chain instead, because its int8
scales are held to the plain version's within 1e-6 relative: the last test
shows, with f32 FMA chains emulated exactly in numpy, that a split order
(or the exact sum) of A at TinyLlama's MLP shape moves the scales past
that.  The kernels themselves run only on the card (``test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import make_policy  # noqa: E402
from repro_torch.kernels import gradestc_encode as ge  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import model  # noqa: E402

#: two waves of the H100's 132 SMs
TWO_WAVES = 2 * 132


def _group_shapes(name, n_layers):
    arch = dataclasses.replace(get_config(name), n_layers=n_layers, vocab=4096,
                               dtype="float32", remat=False)
    policy = make_policy(model.param_group_shapes(arch), min_params=4096)
    return sorted({(p.stack, p.l, p.m, p.k) for p in policy.plans.values() if p.compress})


SLICE_SHAPES = _group_shapes("tinyllama-1.1b", 2)
GEMMA_SHAPES = _group_shapes("gemma3-1b", 6)
#: (L, l, m, k): one row, fewer rows than a chunk, a chunk plus one, a prime
#: l, ragged and narrow m, small k
RAGGED_SHAPES = [(1, 1, 1, 1), (2, 40, 300, 64), (1, 65, 512, 64), (2, 1025, 260, 64),
                 (3, 7919, 77, 8), (1, 4099, 1000, 17), (2, 1000, 515, 33), (6, 100003, 64, 64)]


def test_the_group_shapes_are_the_slices():
    assert SLICE_SHAPES == [(2, 1024, 512, 64), (2, 2048, 2048, 64), (2, 4096, 2816, 64),
                            (2, 5632, 2048, 64)]
    assert GEMMA_SHAPES == [(6, 1024, 1152, 64), (6, 2304, 3456, 64), (6, 6912, 1152, 64)]


@pytest.mark.parametrize("L,l,m,k", SLICE_SHAPES + GEMMA_SHAPES + RAGGED_SHAPES)
def test_split_plan_covers_l_and_fills_the_card(L, l, m, k):
    S, LC = ge.split_plan(L, l, m)
    assert S >= 1 and S * LC >= l and (S - 1) * LC < l      # covers l, no chunk empty
    assert LC % ge.ROW_TILE == 0 and LC >= ge.MIN_CHUNK
    blocks = L * -(-m // ge.COL_TILE) * S
    most = L * -(-m // ge.COL_TILE) * -(-l // ge.MIN_CHUNK)  # at the smallest chunk
    if most >= TWO_WAVES:
        assert blocks >= TWO_WAVES
    else:
        assert blocks == most
    assert blocks <= 2 * ge.TARGET_BLOCKS or LC == ge.MIN_CHUNK
    # the partials (L, S, k, m): a chunk of at least MIN_CHUNK >= k rows, so
    # they never outweigh G and M
    assert S * k <= l + k


@pytest.mark.parametrize("L,l,m,S,LC", [
    (2, 5632, 2048, 21, 272),     # about 700 blocks at TinyLlama's MLP groups
    (2, 4096, 2816, 15, 288),
    (2, 2048, 2048, 19, 112),
    (2, 1024, 512, 16, 64),       # the smallest chunk: 128 blocks
    (6, 6912, 1152, 13, 544),     # Gemma3-1B's MLP groups
    (1, 65, 512, 2, 64),          # a chunk and one row (test_torch_cuda.py's split edges)
    (2, 1025, 260, 17, 64),
    (2, 40, 300, 1, 64),          # fewer rows than a chunk
])
def test_split_plan_at_known_shapes(L, l, m, S, LC):
    assert ge.split_plan(L, l, m) == (S, LC)


@pytest.mark.parametrize("L,l,m,k", SLICE_SHAPES + GEMMA_SHAPES)
def test_partials_weigh_at_most_g(L, l, m, k):
    """The partials' bytes against G's: at most equal (the smallest chunk,
    l = 1024), and under a quarter at the MLP groups (l >= 4096)."""
    S, _ = ge.split_plan(L, l, m)
    frac = (L * S * k * m) / (L * l * m)
    assert frac <= 1.0 and (l < 4096 or frac <= 0.25), frac


def _fma_chain(M, G):
    """sum_r M[r]^T G[r] as f32 FMAs in row order from +0: each step rounds
    f64(m * g) + acc, in which the product is exact, once to f32."""
    acc = np.zeros((M.shape[1], G.shape[1]), np.float32)
    for r in range(M.shape[0]):
        acc = (np.outer(M[r].astype(np.float64), G[r].astype(np.float64))
               + acc.astype(np.float64)).astype(np.float32)
    return acc


@pytest.fixture(scope="module")
def mlp_sums():
    """A = M^T G at TinyLlama's MLP shape (one layer, l = 5632, the first
    512 columns, k = 64) in one chain, and the inputs; M orthonormal and
    G ~ N(0, 1e-6), as the card's checks make them."""
    rng = np.random.default_rng(1)
    M = np.linalg.qr(rng.normal(size=(5632, 64)))[0].astype(np.float32)
    G = (rng.normal(size=(5632, 512)) * 1e-3).astype(np.float32)
    return M, G, _fma_chain(M, G)


@pytest.mark.parametrize("order", ["split", "exact"])
def test_a_split_sum_moves_the_int8_scales_past_their_tolerance(mlp_sums, order):
    """encode_quant's A keeps one chain over l: summed in encode's split
    order (split_plan's chunks, added in turn) or exactly, its int8 scales
    (max |a| per row and 512-column block) move by more than the 1e-6
    relative that the card's checks allow."""
    M, G, chain = mlp_sums
    if order == "split":
        _, lc = ge.split_plan(2, 5632, 2048)
        A = None
        for r0 in range(0, M.shape[0], lc):
            part = _fma_chain(M[r0:r0 + lc], G[r0:r0 + lc])
            A = part if A is None else (A + part).astype(np.float32)
    else:
        A = (M.astype(np.float64).T @ G.astype(np.float64)).astype(np.float32)
    scales = ref.coeff_quant_ref(torch.from_numpy(A))[1]
    chain_scales = ref.coeff_quant_ref(torch.from_numpy(chain))[1]
    moved = float(((scales - chain_scales).abs() / chain_scales).max())
    print(f"{order} sum vs one chain: int8 scales move by {moved:.3e} relative")
    assert moved > 1e-6
