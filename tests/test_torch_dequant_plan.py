"""The dequantizers' launch plan (``wire.dequant_plan``, of
``unpack_dequant`` and ``block_dequant``), on the CPU.

The CUDA ``unpack_dequant`` and ``block_dequant`` kernels walk their n
outputs in chunks of 4 values: a thread loads a chunk's 4 codes (bits/2
bytes of the packed wire, 4 int8 codes of the block quantizer) and writes
them in one 16-byte store, and a block takes ``DEQUANT_UNROLL`` chunks a
thread, ``DEQUANT_THREADS`` apart, so that a warp's loads and stores are
contiguous.  A chunk below ``vec_chunks`` is whole and takes one scale, of
row ``c // (block // 4)``; the rest (the ragged tail, a block that is not
a multiple of 4, unaligned operands) go value by value, stepping the row
where a chunk crosses into the next.  The plan is made in Python from n,
block and the operands' alignment, so it is held here: at n from 1 to 17,
511, 513, 70,001 and the 12 flat group sizes of the TinyLlama-1.1B slice,
the blocks 512, 256, 96, 100 and 6 and both alignments, the walk below (the
kernel's loop, in numpy) covers each output exactly once, and each value's
scale row is ``i // block``.  Then the kernel's arithmetic on the plan's
paths, emulated in plain torch, equals ``ref.unpack_dequant_ref`` and
``ref.block_dequant_ref`` bit for bit at every width.  The kernels
themselves run only on the card (``test_torch_cuda.py``).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs.tinyllama_1_1b import CONFIG  # noqa: E402
from repro_torch.kernels import ref, wire  # noqa: E402
from repro_torch.models import model  # noqa: E402


def _group_sizes():
    arch = dataclasses.replace(CONFIG, n_layers=2, vocab=4096, dtype="float32", remat=False)
    return [math.prod(s) * st for s, st in model.param_group_shapes(arch).values()]


GROUP_SIZES = _group_sizes()
SIZES = list(range(1, 18)) + [511, 513, 70_001] + sorted(set(GROUP_SIZES))
#: 6 is no multiple of 4: its chunks straddle rows, so all go value by value
BLOCKS = (512, 256, 96, 100, 6)
#: above this many chunks, the rows of the scalar path are checked on a sample
WALK_ALL = 20_000


def test_the_group_sizes_are_the_slices():
    assert sorted(GROUP_SIZES) == [2048, 4096, 4096, 1048576, 1048576] + [8388608] * 4 + [
        23068672] * 3


def _walk(plan):
    """The chunks each thread of the grid takes, in the kernel's loop:
    ``c = block * tile + thread + THREADS * u`` for ``u < UNROLL``, kept
    where ``c < chunks``."""
    tile = wire.DEQUANT_THREADS * wire.DEQUANT_UNROLL
    block, thread, u = np.ix_(np.arange(plan.grid), np.arange(wire.DEQUANT_THREADS),
                              np.arange(wire.DEQUANT_UNROLL))
    c = (tile * block + thread + wire.DEQUANT_THREADS * u).ravel()
    return c[c < plan.chunks]


def _scalar_rows(i0, end, block):
    """The scalar path's rows for values [i0, end): found once, stepped."""
    row, off, rows = i0 // block, i0 % block, []
    for _ in range(i0, end):
        if off == block:
            row, off = row + 1, 0
        rows.append(row)
        off += 1
    return rows


def _check(plan, n, block):
    w = wire.DEQUANT_WIDTH
    # the grid: whole tiles of chunks, none of them empty
    tile = wire.DEQUANT_THREADS * wire.DEQUANT_UNROLL
    assert plan.grid == -(-plan.chunks // tile) >= 1
    # each chunk once; the chunks tile [0, n), only the last one ragged
    c = _walk(plan)
    assert np.array_equal(np.bincount(c, minlength=plan.chunks), np.ones(plan.chunks, np.int64))
    assert (plan.chunks - 1) * w < n <= plan.chunks * w
    # the vector path: whole chunks only, each inside one row, row c // (block // 4)
    assert 0 <= plan.vec_chunks * w <= n
    if plan.vec_chunks:
        v = np.arange(plan.vec_chunks)
        assert np.array_equal(v // (block // w), (v * w) // block)
        assert np.array_equal(v // (block // w), (v * w + w - 1) // block)
    # the scalar path: every value up to n once, row i // block
    scalar = np.arange(plan.vec_chunks, plan.chunks)
    if len(scalar) > WALK_ALL:
        scalar = np.unique(np.concatenate([scalar[:100], scalar[-100:], np.random.default_rng(
            n).choice(scalar, 1000)]))
    for ci in scalar:
        i0, end = int(ci) * w, min(int(ci) * w + w, n)
        assert _scalar_rows(i0, end, block) == [i // block for i in range(i0, end)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n", SIZES)
def test_dequant_plan_covers_each_output_once(n, block, aligned):
    """unpack_dequant's plan is the case block = 512."""
    plan = wire.dequant_plan(n, block, aligned)
    assert plan.vec_chunks == (n // 4 if aligned and block % 4 == 0 else 0)
    _check(plan, n, block)


def test_the_path_sizes_are_all_vector_chunks():
    """At the slice's group sizes, aligned, every chunk takes the vector
    path."""
    for n in GROUP_SIZES:
        plan = wire.dequant_plan(n, 512, True)
        assert plan.vec_chunks == plan.chunks == n // 4


def _emulate(plan, n, block, codes, scales, inv):
    """The kernel's two paths in plain torch f32: a vector chunk's scale
    from row c // (block // 4), a scalar value's from its stepped row."""
    out = torch.empty(n, dtype=torch.float32)
    w = wire.DEQUANT_WIDTH
    for c in range(plan.chunks):
        i0, end = c * w, min(c * w + w, n)
        if c < plan.vec_chunks:
            s = scales[c // (block // w)] * inv
            out[i0:end] = codes[i0:end].float() * s
        else:
            rows = torch.tensor(_scalar_rows(i0, end, block))
            out[i0:end] = codes[i0:end].float() * (scales[rows] * inv)
    return out


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n,bits", [(1, 8), (17, 2), (513, 4), (4096, 8), (5_001, 2)])
def test_unpack_dequant_paths_equal_the_plain_version(n, bits, aligned):
    rng = np.random.default_rng(n + bits)
    n_p = n + (-n) % 512
    levels = int(ref.quant_levels(bits))
    biased = torch.from_numpy(rng.integers(0, 2 * levels + 1, n_p))
    scales = torch.from_numpy(rng.uniform(1e-6, 1e-2, n_p // 512).astype(np.float32))
    words = ref.pack_codes_ref(biased, bits)
    plan = wire.dequant_plan(n, 512, aligned)
    got = _emulate(plan, n, 512, (biased - levels)[:n], scales, ref.recip32(levels))
    assert torch.equal(_bits(got), _bits(ref.unpack_dequant_ref(words, scales, n_p, 512,
                                                                bits)[:n]))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n,block,bits", [(1, 512, 6), (17, 96, 3), (513, 100, 7),
                                          (4096, 256, 5), (5_001, 100, 2), (5_001, 512, 8),
                                          (999, 6, 4)])
def test_block_dequant_paths_equal_the_plain_version(n, block, bits, aligned):
    rng = np.random.default_rng(n + block + bits)
    n_p = n + (-n) % block
    levels = int(ref.quant_levels(bits))
    codes = torch.from_numpy(rng.integers(-levels, levels + 1, n_p).astype(np.int8))
    scales = torch.from_numpy(rng.uniform(1e-6, 1e-2, n_p // block).astype(np.float32))
    plan = wire.dequant_plan(n, block, aligned)
    got = _emulate(plan, n, block, codes[:n], scales, ref.recip32(levels))
    assert torch.equal(_bits(got), _bits(ref.block_dequant_ref(codes, scales, block,
                                                               bits)[:n]))
