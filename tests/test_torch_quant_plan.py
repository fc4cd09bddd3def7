"""The two quantizers' row walk (``quant_pack`` and ``block_quant``) and
their launch plan (``wire.quant_plan``), on the CPU.

Both CUDA kernels give a row to a warp: in step q lane L takes chunk ``32q +
L`` of its row, the 4 values ``4 (32q + L) .. 4 (32q + L) + 3`` of g and of
u (chunks past the row's ``block / 4`` read nothing).  The row's scale is
``fmaxf`` over the lane's values, then over lanes ``L ^ o`` for o = 16, 8,
4, 2, 1, floored at 1e-12; a g of +-0.0 takes code 0 without the division
(whose slow path a zero dividend takes on the card).  ``quant_pack``'s 4 biased codes of a step make
word ``32q + L`` at 8 bits; at 4 bits half ``L % 2`` of word ``16q + L / 2``,
whole after xor 1, and lane L stores word ``32p + L`` from step ``2p + L /
16``, lane ``2 (L % 16)``; at 2 bits byte ``L % 4`` of word ``8q + L / 4``,
whole after xor 1 and 2, and lane L stores word L from step ``L / 8``, lane
``4 (L % 8)``.  ``block_quant`` stores a chunk's 4 int8 codes at code ``4
(32q + L)`` of the row; a block that is not a multiple of 4 or is longer
than 512 goes value by value, lane L on values L, L + 32, ....  Each walk
is emulated here in plain torch f32 and held bit for bit against
``ref.quant_pack_ref`` and
``ref.block_quant_ref``, on values with -0.0, subnormals, whole zero rows,
values whose x is an exact integer, and uniforms of exactly 0.0 and just
below 1.0 (no +-inf: inf / inf makes NaN codes, whose int8 cast differs
between devices in the plain version itself).  Then ``wire.quant_plan``
covers every value once.  The kernels themselves run only on the card
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
BLOCKS = (512, 256, 96, 100, 30, 1024)


def _inputs(n, block, seed, bits=8):
    """g (n,) and u over the padded length: heavy-tailed g with exact zeros
    of both signs, subnormals, a whole zero row, a row of max 1.0 whose
    values are f32(k / levels), so that most x = g / 1.0 * levels land on the
    integer k; u with exact 0.0 and 1 - 2^-24."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_t(3, size=n) * 1e-3).astype(np.float32)
    g[::7] = 0.0
    g[3::11] = -0.0
    g[5::13] = np.float32(1e-40) * rng.choice([-1, 1], size=len(g[5::13]))
    if n >= 2 * block:
        g[block:2 * block] = 0.0
    if n >= 4 * block:
        row = slice(2 * block, 3 * block)
        levels = ref.quant_levels(bits)
        g[row] = (rng.integers(-levels, levels + 1, block) / np.float32(levels)).astype(np.float32)
        g[2 * block], g[2 * block + 1] = 1.0, -1.0
    n_p = n + (-n) % block
    u = rng.random(n_p, dtype=np.float32)
    u[::5] = 0.0
    u[1::5] = np.nextafter(np.float32(1.0), np.float32(0.0))
    return torch.from_numpy(g), torch.from_numpy(u)


def _xor_max(a):
    """The butterfly over the last axis (32 lanes): lane L takes
    ``fmaxf(a, a[L ^ o])``; every lane ends with the warp's max."""
    for o in (16, 8, 4, 2, 1):
        a = torch.maximum(a, a[..., LANES ^ o])
    return a


def _scale(lane_max):
    m = _xor_max(lane_max)
    assert torch.equal(m, m[:, :1].expand_as(m))
    return m[:, 0].clamp_min(1e-12)


def _codes(g, u, scale, bits):
    """quant_code: x = g / scale * levels, floor(x) + (u < x - floor(x)),
    clipped, each step one f32 rounding; a g of +-0.0 selects code 0 without
    the division."""
    levels = ref.quant_levels(bits)
    x = torch.where(g == 0, scale, g) / scale * levels
    lo = torch.floor(x)
    code = (lo + (u < (x - lo)).float()).clamp(-levels, levels)
    return torch.where(g == 0, 0.0, code)


def _chunk_walk(g, u, n, block, bits):
    """A block of whole chunks, at most 512 values: in step q (0..3) lane L
    takes chunk 32q + L (0.0 past n, no chunk past the row).  Returns
    (scales, codes (rows, 4, 32, 4), indices (rows, 4, 32, 4) of each code
    in the padded vector, -1 where no chunk is)."""
    n_p = u.shape[0]
    rows, cpr, steps = n_p // block, block // 4, 4
    gp = torch.nn.functional.pad(g, (0, n_p - n))
    c = (32 * torch.arange(steps)[:, None] + LANES).reshape(-1)             # chunk per (q, L)
    has = c < cpr
    idx = (torch.arange(rows)[:, None, None] * block + 4 * c[None, :, None]
           + torch.arange(4)).reshape(rows, steps, 32, 4)
    idx = torch.where(has.reshape(1, steps, 32, 1), idx, -1)
    gv = torch.where(idx >= 0, gp[idx.clamp_min(0)], 0.0)
    uv = torch.where(idx >= 0, u[idx.clamp_min(0)], 0.0)
    scale = _scale(gv.abs().amax(dim=(1, 3)))
    return scale, _codes(gv, uv, scale[:, None, None, None], bits), idx


def _value_walk(g, u, n, block, bits):
    """A block that is not a multiple of 4 or is longer than 512: lane L
    takes values L, L + 32, ... of its row (0.0 past n).  Returns (scales,
    codes (n_p,))."""
    n_p = u.shape[0]
    rows = n_p // block
    gp = torch.nn.functional.pad(g, (0, n_p - n)).reshape(rows, block)
    lanes = torch.nn.functional.pad(gp.abs(), (0, (-block) % 32)).reshape(rows, -1, 32)
    scale = _scale(lanes.amax(dim=1))
    return scale, _codes(gp, u.reshape(rows, block), scale[:, None], bits).reshape(-1)


def _block_quant(g, u, n, block, bits):
    """block_quant_kernel's walk: (int8 codes (n_p,), scales)."""
    if block % 4 or block > 512:
        scale, codes = _value_walk(g, u, n, block, bits)
        return codes.to(torch.int8), scale
    scale, codes, idx = _chunk_walk(g, u, n, block, bits)
    out = torch.full((u.shape[0],), 99, dtype=torch.int8)
    out[idx[idx >= 0]] = codes[idx >= 0].to(torch.int8)      # each code stored once
    assert int(torch.bincount(idx[idx >= 0], minlength=u.shape[0]).max()) == 1
    return out, scale


def _quant_pack(g, u, n, bits):
    """quant_pack_kernel's walk and word stores: (words (n_p*bits/32,)
    int64, scales)."""
    scale, codes, _ = _chunk_walk(g, u, n, ref.WIRE_BLOCK, bits)
    rows = scale.shape[0]
    biased = (codes + ref.quant_levels(bits)).long()                       # (rows, 4, 32, 4)
    w = (biased << (bits * torch.arange(4))).sum(-1)                      # (rows, q, L)
    if bits == 8:
        words = w                                                          # word 32q + L
    elif bits == 4:
        w = w << (16 * (LANES % 2))
        w = w | w[..., LANES ^ 1]
        src = 2 * (LANES % 16)
        words = torch.stack([torch.where(LANES < 16, w[:, 2 * p, src], w[:, 2 * p + 1, src])
                             for p in range(2)], 1)                        # word 32p + L
    else:
        w = w << (8 * (LANES % 4))
        w = w | w[..., LANES ^ 1]
        w = w | w[..., LANES ^ 2]
        words = w[:, LANES // 8, 4 * (LANES % 8)]                         # word L
    return words.reshape(rows * ref.WIRE_BLOCK * bits // 32), scale


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("n", [1, 31, 513, 2_049, 70_001])
def test_quant_pack_walk_equals_the_plain_version(n, bits):
    g, u = _inputs(n, 512, n + bits, bits)
    words, scales = _quant_pack(g, u, n, bits)
    rw, rs = ref.quant_pack_ref(torch.nn.functional.pad(g, (0, u.shape[0] - n)), u, 512, bits)
    assert torch.equal(words, rw) and torch.equal(_bits(scales), _bits(rs))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n", [1, 70_001])
def test_block_quant_walk_equals_the_plain_version(n, block):
    for bits in range(2, 9):
        g, u = _inputs(n, block, n + block + bits, bits)
        codes, scales = _block_quant(g, u, n, block, bits)
        rc, rs = ref.block_quant_ref(torch.nn.functional.pad(g, (0, u.shape[0] - n)), u,
                                     block, bits)
        assert torch.equal(codes, rc), (block, bits)
        assert torch.equal(_bits(scales), _bits(rs)), (block, bits)


def test_the_inputs_reach_the_edge_cases():
    """x lands on exact integers (so u = 0.0 cannot round up), a row is all
    zero (the 1e-12 floor), and u takes 0.0 and its largest value."""
    g, u = _inputs(70_001, 512, 1)
    rows = torch.nn.functional.pad(g, (0, u.shape[0] - g.shape[0])).reshape(-1, 512)
    scale = rows.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    x = rows / scale * ref.quant_levels(8)
    assert float(scale[1]) == float(np.float32(1e-12)) and float(scale[2]) == 1.0
    assert int((x[2] == torch.floor(x[2])).sum()) > 100
    assert float(u.min()) == 0.0 and float(u.max()) == float(np.nextafter(np.float32(1), 0))


SIZES = list(range(1, 18)) + [511, 513, 70_001] + sorted(set(GROUP_SIZES))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", SIZES)
def test_quant_plan_covers_each_value_once(n, aligned):
    for block in BLOCKS:
        plan = wire.quant_plan(n, block, aligned)
        rows = -(-n // block)
        assert plan.rows == rows
        vec = aligned and block % 4 == 0 and block <= 512
        assert plan.vec_rows == (n // block if vec else 0)
        assert plan.vec_rows * block <= n                                   # whole below n
        # the grid: warp w of block b takes row 8b + w, each row once
        assert plan.grid == -(-rows // wire.QUANT_ROWS_PER_BLOCK) >= 1
        r = np.arange(plan.grid * wire.QUANT_ROWS_PER_BLOCK)
        assert np.array_equal(np.bincount(r[r < rows], minlength=rows), np.ones(rows, np.int64))
        # inside a row: chunks 32q + L below block / 4, or values L + 32k
        if block % 4 == 0 and block <= 512:
            c = (32 * np.arange(4)[:, None] + np.arange(32)).ravel()
            v = (4 * c[c < block // 4][:, None] + np.arange(4)).ravel()
        else:
            v = (np.arange(32)[:, None] + 32 * np.arange(-(-block // 32))).ravel()
            v = v[v < block]
        assert np.array_equal(np.bincount(v, minlength=block), np.ones(block, np.int64))


@pytest.mark.parametrize("n", sorted(set(GROUP_SIZES)))
def test_every_path_size_takes_the_vector_path_whole(n):
    """The flat groups of the TinyLlama-width slice are whole 512-value
    rows, so the fused wire and the 6-bit route quantize them without a
    scalar row."""
    plan = wire.quant_plan(n, 512, True)
    assert n % 512 == 0 and plan.vec_rows == plan.rows == n // 512
