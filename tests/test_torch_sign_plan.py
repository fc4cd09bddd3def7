"""The sign wire's kernel layouts (``sign_pack``, its mean-|g| finish, and
``sign_unpack``'s launch plan), on the CPU.

The CUDA ``sign_pack`` kernel gives a 512-value row to a warp: in step q (0
to 3) lane L loads the 4 values ``128q + 4L .. 128q + 4L + 3``.  Its row
sum is ``(v0 + v1) + (v2 + v3)`` in the thread, then lane L adds lane ``L ^
o``'s sum for o = 1, 2, 4, 8, 16, then ``(q0 + q1) + (q2 + q3)``: that must
be ``ref.pairwise_sum``'s tree.  Its words are the OR of each lane's sign
nibble, shifted by ``4 (L % 8)``, over xor 1, 2 and 4, and lane ``4q + j``
takes word ``4q + j`` from lane ``8j``.  The finish kernel sums the row
sums in tiles of 4096 (4 a thread, 128 a warp, 32 warps a tile), then the
tiles pairwise, zero padded to a power of two, times ``ref.recip32(n)``.
Each is emulated here in plain torch f32 (every add a single IEEE add, as
``__fadd_rn``) and held bit for bit against the plain versions, on values
with -0.0, +0.0, +-inf, subnormals and whole zero rows.  Then
``sign_unpack``'s walk of ``wire.dequant_plan(n, 512, aligned)`` covers
every output once, and its vector chunks read their nibble of the right
word.  The kernels themselves run only on the card
(``test_torch_cuda.py``).
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
LANES = torch.arange(32)
#: the finish kernel's tile: 1024 threads of 4 row sums
MA_TILE = 4096


def _bits(x):
    return x.contiguous().view(torch.int32)


def _xor_tree(a, levels=(1, 2, 4, 8, 16)):
    """The butterfly over the last axis (32 lanes): lane L adds lane L ^ o."""
    for o in levels:
        a = a + a[..., LANES ^ o]
    return a


def _specials(n, seed):
    """Heavy-tailed g with exact zeros of both signs, +-inf, subnormals and
    (past 1024 values) a whole zero row."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_t(3, size=n) * 1e-3).astype(np.float32)
    g[::7] = 0.0
    g[3::11] = -0.0
    g[5::13] = np.float32(1e-40) * rng.choice([-1, 1], size=len(g[5::13]))
    if n >= 1024:
        g[512:1024] = 0.0
    if n >= 100:
        g[97], g[n - 2] = np.inf, -np.inf
    return torch.from_numpy(g)


def _pack_rows(g):
    """sign_pack_kernel's arithmetic: (row sums, words) of g (n,)."""
    n = g.shape[0]
    rows = -(-n // 512)
    v = torch.nn.functional.pad(g, (0, rows * 512 - n)).reshape(rows, 4, 32, 4)
    a = v.abs()
    part = _xor_tree((a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3]))[..., 0]
    rowsums = (part[:, 0] + part[:, 1]) + (part[:, 2] + part[:, 3])
    shifts = torch.arange(4, dtype=torch.int64)
    nib = ((v < 0).long() << shifts).sum(-1) << (4 * (LANES % 8))
    for o in (1, 2, 4):
        nib = nib | nib[..., LANES ^ o]
    # lane 4q + j keeps word 4q + j from lane 8j; lanes 0..15 store the row
    lane = torch.arange(16)
    words = nib[:, lane // 4, 8 * (lane % 4)]
    return rowsums, words.reshape(-1)[:-(-n // 32)]


@pytest.mark.parametrize("n", [1, 31, 33, 511, 512, 513, 4096, 70_001, 1_048_576 + 100])
def test_sign_pack_layout_equals_the_plain_version(n):
    g = _specials(n, n)
    rowsums, words = _pack_rows(g)
    rows = -(-n // 512)
    want = ref.pairwise_sum(torch.nn.functional.pad(g.abs(), (0, rows * 512 - n))
                            .reshape(rows, 512))
    assert torch.equal(_bits(rowsums), _bits(want))
    assert torch.equal(words, ref.pack_codes_ref((g < 0).long(), 1))


def _finish(rowsums, n):
    """mean_abs_kernel's arithmetic: tiles of 4096 row sums, 4 tiles a pass
    (the order inside a tile does not depend on the pass), then the tiles'
    tree, then times f32(1/n)."""
    rows = rowsums.shape[0]
    padded = MA_TILE
    while padded < rows:
        padded *= 2
    v = torch.nn.functional.pad(rowsums, (0, padded - rows)).reshape(-1, 32, 32, 4)
    warp = _xor_tree((v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3]))[..., 0]
    tiles = _xor_tree(warp)[..., 0]
    s = 1
    while s < tiles.shape[0]:
        j = torch.arange(0, tiles.shape[0], 2 * s)
        tiles[j] = tiles[j] + tiles[j + s]
        s *= 2
    return tiles[0] * ref.recip32(n)


ROW_COUNTS = list(range(1, 18)) + [31, 33, 1023, 1024, 1025, 2048, 16384, 45_056,
                                   -(-70_001 // 512)]


@pytest.mark.parametrize("rows", ROW_COUNTS)
def test_the_finish_equals_the_plain_scale(rows):
    rng = np.random.default_rng(rows)
    r = rng.uniform(0.0, 1.0, rows) * 10.0 ** rng.integers(-6, 3, rows)
    r[rng.random(rows) < 0.2] = 0.0
    rowsums = torch.from_numpy(r.astype(np.float32))
    n = rows * 512 - rows % 7
    got = _finish(rowsums.clone(), n)
    assert torch.equal(_bits(got), _bits(ref.pairwise_sum(rowsums) * ref.recip32(n)))


@pytest.mark.parametrize("n", [1, 513, 70_001, 1_048_576])
def test_pack_and_finish_equal_mean_abs(n):
    """The whole device path of the scale: the row sums of sign_pack's layout,
    then the finish, against ``ref.mean_abs_ref``."""
    g = _specials(n, n + 1)
    g[g.isinf()] = 2.5         # a finite scale too
    rowsums, _ = _pack_rows(g)
    assert torch.equal(_bits(_finish(rowsums, n)), _bits(ref.mean_abs_ref(g)))


SIZES = list(range(1, 18)) + [511, 513, 70_001] + sorted(set(GROUP_SIZES))


def _walk(plan):
    """The chunks each thread of the grid takes, in the kernel's loop."""
    tile = wire.DEQUANT_THREADS * wire.DEQUANT_UNROLL
    block, thread, u = np.ix_(np.arange(plan.grid), np.arange(wire.DEQUANT_THREADS),
                              np.arange(wire.DEQUANT_UNROLL))
    c = (tile * block + thread + wire.DEQUANT_THREADS * u).ravel()
    return c[c < plan.chunks]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", SIZES)
def test_sign_unpack_plan_covers_each_output_once(n, aligned):
    plan = wire.dequant_plan(n, ref.WIRE_BLOCK, aligned)
    w = wire.DEQUANT_WIDTH
    assert plan.vec_chunks == (n // w if aligned else 0)
    assert plan.grid == -(-plan.chunks // (wire.DEQUANT_THREADS * wire.DEQUANT_UNROLL)) >= 1
    c = _walk(plan)
    assert np.array_equal(np.bincount(c, minlength=plan.chunks), np.ones(plan.chunks, np.int64))
    assert (plan.chunks - 1) * w < n <= plan.chunks * w
    # a vector chunk is whole, and its nibble (word c // 8, bit 4 (c % 8))
    # holds the signs of values 4c .. 4c + 3 (the first and last 4096)
    v = np.arange(plan.vec_chunks, dtype=np.int64)
    v = np.unique(np.concatenate([v[:4096], v[-4096:]]))
    assert np.all(4 * v + 3 < n)
    for j in range(w):
        i = 4 * v + j
        assert np.array_equal(v // 8, i // 32) and np.array_equal(4 * (v % 8) + j, i % 32)


def _unpack(plan, words, scale, n):
    """sign_unpack_kernel's two paths in plain torch f32."""
    out = torch.empty(n, dtype=torch.float32)
    w = words.long() & 0xFFFFFFFF
    for c in range(plan.chunks):
        i = torch.arange(4 * c, min(4 * c + 4, n))
        if c < plan.vec_chunks:
            bits = (w[c // 8] >> (4 * (c % 8) + torch.arange(4))) & 1
        else:
            bits = (w[i // 32] >> (i % 32)) & 1
        out[i] = (1.0 - 2.0 * bits[:len(i)].float()) * scale
    return out


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("scale", [3.25e-4, float("inf"), 0.0])
@pytest.mark.parametrize("n", [1, 17, 513, 2_049])
def test_sign_unpack_paths_equal_the_plain_version(n, scale, aligned):
    g = _specials(n, n + 2)
    words = ref.pack_codes_ref((g < 0).long(), 1)
    s = torch.tensor(scale, dtype=torch.float32)
    got = _unpack(wire.dequant_plan(n, ref.WIRE_BLOCK, aligned), words, s, n)
    assert torch.equal(_bits(got), _bits(ref.sign_unpack_ref(words, s, n)))
