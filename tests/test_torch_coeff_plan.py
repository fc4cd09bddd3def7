"""The int8 coefficient wire's walks (``coeff_quant`` and ``coeff_dequant``)
and their launch plans (``wire.coeff_plan``, ``wire.coeff_dequant_plan``),
on the CPU.

``coeff_quant`` gives 128 threads to each (row, 512-column block) item of
the ``L k`` rows of m coefficients (``COEFF_ROWS_PER_BLOCK`` rows a block).
On the vector path (m % 4 == 0, operands aligned) thread t takes chunk t of
the item, the 4 values ``4t .. 4t + 3`` (chunks past the row's m read 0.0
and store nothing). The item's scale is ``fmaxf`` over the thread's 4
values, then over lanes ``L ^ o`` for o = 16, 8, 4, 2, 1, then over the 4
warps, floored at 1e-12; each value's code is ``clip(rint(a / scale * 127),
+-127)``, each step one f32 rounding, the quotient made without the IEEE
division's branch to its slow path (which a zero dividend takes on the
card): ``y = RN(1/scale)``, ``q0 = RN(a y)`` and two FMA corrections, the
last one Markstein's, which is held here against the IEEE quotient
exhaustively in an 8-bit format and, in exact rational arithmetic, at
binary32 over 42 decades of scale, at and beside the midpoints between two
floats; a chunk's 4 codes are one 32-bit word, code ``4t + j`` in byte j,
stored at byte ``4t`` of the item, and its 4 shipped values ``code * (scale
* INV127)`` one float4. Otherwise thread t takes values t, t + 128, t + 256,
t + 384 of the item, one by one. ``coeff_dequant`` walks the ``L k m``
values as one vector in chunks of 4, a chunk a thread: a vector chunk's row
is ``c // (m // 4)`` and its scale that of block ``(c % (m // 4)) // 128``;
a scalar chunk finds its row once and steps it where it crosses into the
next. Each walk is emulated here in plain torch f32 and held bit for bit
against ``ref.coeff_quant_ref`` and ``ref.coeff_dequant_ref``, on
coefficients with +-0.0, subnormals, a whole zero block, a row whose values
sit at exactly +-scale and whose a / scale * 127 are exact .5 ties (no +-inf
or NaN: inf / inf makes NaN codes, whose int8 cast differs between devices
in the plain version itself). Then both plans cover every value of every row
once. The kernels themselves run only on the card (``test_torch_cuda.py``).
"""

import math
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ref, wire  # noqa: E402

LANES = torch.arange(32)
#: m across the 512-column block's edges and the
#: slice's m (512, 2048 and 2816; 1152 is Gemma3-1B's), up to 2 x 64 rows
MS = (1, 3, 4, 100, 511, 512, 513, 700, 1152, 2816)
ROWS = 2 * 64


def _coeffs(rows, m, seed):
    """rows x m heavy-tailed coefficients over five decades, with +0.0 every
    7th value, -0.0, subnormals of both signs, row 1's first block all zero,
    and row 2 of scale 127 (127.0 and -127.0 open each block) whose other
    values are ties h + 0.5, a / 127 * 127 being h + 0.5 exactly."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_t(3, size=(rows, m)) * 10.0 ** rng.uniform(-4, 1, (rows, 1))
         ).astype(np.float32)
    flat = A.reshape(-1)
    flat[::7] = 0.0
    flat[3::11] = -0.0
    flat[5::13] = np.float32(1e-40) * np.where(np.arange(len(flat[5::13])) % 2, -1, 1)
    if rows > 1:
        A[1, :512] = 0.0
    if rows > 2:
        ties = (rng.integers(-127, 127, m) + 0.5).astype(np.float32)
        A[2] = ties
        A[2, ::512] = 127.0
        A[2, 1::512] = -127.0
    return torch.from_numpy(A)


def _xor_max(a):
    """The butterfly over the last axis (32 lanes): lane L takes
    ``fmaxf(a, a[L ^ o])``; every lane ends with the warp's max."""
    for o in (16, 8, 4, 2, 1):
        a = torch.maximum(a, a[..., LANES ^ o])
    assert torch.equal(a, a[..., :1].expand_as(a))
    return a[..., 0]


def _block_max(thread_max):
    """(..., 128) thread maxima -> the block's: each warp's xor butterfly,
    then the 4 warps' maxima."""
    return _xor_max(thread_max.reshape(*thread_max.shape[:-1], 4, 32)).amax(-1)


def _codes(a, scale):
    """code_of(a / scale), as the integer the kernel keeps (a code of -0.0
    is the integer 0, so it ships +0.0); the kernel's quotient (``div_by``)
    is the IEEE one (``test_div_by_is_the_ieee_quotient``)."""
    return torch.round(a / scale * 127.0).clamp(-127.0, 127.0).to(torch.int8)


def _rn32(x):
    """The exact rational x rounded to the nearest binary32, ties to even
    (subnormals too), as a Python float."""
    if x == 0:
        return 0.0
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1                                                    # 2^e <= x < 2^(e+1)
    unit = Fraction(2) ** (max(e, -126) - 23)                     # the ulp at x
    n, frac = divmod(x, unit)
    n = int(n) + (frac > unit / 2 or (frac == unit / 2 and int(n) % 2))
    return sign * float(n * unit)


def _fma32(a, b, c):
    return _rn32(Fraction(a) * Fraction(b) + Fraction(c))


def _div_by(a, scale, y):
    """coeff_quant_kernel's div_by, each step one binary32 rounding: q0 =
    RN(a y), q1 = RN(q0 + RN(a - scale q0) y), q = RN(q1 + RN(a - scale q1)
    y)."""
    q0 = _rn32(Fraction(a) * Fraction(y))
    q1 = _fma32(_fma32(-scale, q0, a), y, q0)
    return _fma32(_fma32(-scale, q1, a), y, q1)


def _u32_bytes(words):
    """uint32 words (int64) -> their 4 bytes in memory order (little
    endian), as int8: byte j is code 4c + j."""
    w32 = ((words + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
    return w32.contiguous().view(torch.int8).reshape(*words.shape, 4)


def _quant_walk(A, vec):
    """coeff_quant_kernel's walk over A (rows, m): (codes int8, scales (rows,
    nb), ship) and how often each value was stored."""
    rows, m = A.shape
    nb = -(-m // 512)
    blocks = torch.nn.functional.pad(A, (0, nb * 512 - m)).reshape(rows, nb, 512)
    width = (m - 512 * torch.arange(nb)).clamp(max=512)                      # (nb,)
    codes = torch.zeros(rows, nb * 512, dtype=torch.int8)
    ship = torch.zeros(rows, nb * 512)
    stores = torch.zeros(rows, nb * 512, dtype=torch.int64)
    t = torch.arange(128)
    if vec:
        idx = 4 * t[:, None] + torch.arange(4)                                # thread t: chunk t
    else:
        idx = t[:, None] + 128 * torch.arange(4)                              # values t + 128 j
    has = idx[None] < width[:, None, None]                                    # (nb, 128, 4)
    if vec:
        assert torch.equal(has, has[..., :1].expand_as(has))                 # whole chunks
    v = torch.where(has[None], blocks[:, :, idx], 0.0)                        # (rows, nb, 128, 4)
    scale = _block_max(v.abs().amax(-1)).clamp_min(1e-12)                     # (rows, nb)
    q = _codes(v, scale[..., None, None])
    if vec:
        words = ((q.long() & 0xFF) << (8 * torch.arange(4))).sum(-1)         # (rows, nb, 128)
        q = _u32_bytes(words)                                                 # byte j: code 4t + j
    pos = (512 * torch.arange(nb)[:, None, None] + idx).expand(rows, nb, 128, 4)
    keep = has[None].expand_as(pos)
    r = torch.arange(rows)[:, None, None, None].expand_as(pos)
    codes[r[keep], pos[keep]] = q[keep]
    ship[r[keep], pos[keep]] = (q.float() * (scale * ref.INV127)[..., None, None])[keep]
    stores.index_put_((r[keep], pos[keep]), torch.ones(int(keep.sum()), dtype=torch.int64),
                      accumulate=True)
    return codes[:, :m], scale, ship[:, :m], stores[:, :m]


def _dequant_walk(codes, scales, plan):
    """coeff_dequant_kernel's chunks of ``plan`` over codes (rows, m) and
    scales (rows, nb), the L k m values as one vector."""
    rows, m = codes.shape
    nb, n = scales.shape[1], rows * m
    flat, sflat = codes.reshape(-1), scales.reshape(-1)
    out = torch.full((n,), float("nan"))
    stores = torch.zeros(n, dtype=torch.int64)
    c = torch.arange(plan.vec_chunks)
    if len(c):
        cpr = m // 4
        row = c // cpr
        s = sflat[row * nb + (c - row * cpr) // 128] * ref.INV127
        i = 4 * c[:, None] + torch.arange(4)
        out[i] = flat[i].float() * s[:, None]
        stores.index_put_((i.reshape(-1),), torch.ones(i.numel(), dtype=torch.int64),
                          accumulate=True)
    # the scalar chunks: the row found once, stepped where the chunk crosses
    c = torch.arange(plan.vec_chunks, plan.chunks)
    i0 = 4 * c
    row, col = i0 // m, i0 - (i0 // m) * m
    for j in range(4):
        i = i0 + j
        live = i < n
        wrap = col == m
        col = torch.where(wrap, 0, col)
        row = row + wrap.long()
        ii, rr, cc = i[live], row[live], col[live]
        out[ii] = flat[ii].float() * (sflat[rr * nb + cc // 512] * ref.INV127)
        stores.index_put_((ii,), torch.ones(len(ii), dtype=torch.int64), accumulate=True)
        col = col + 1
    return out.reshape(rows, m), stores


def _bits(x):
    return x.contiguous().view(torch.int32)


def _div_cases(seed, n):
    """(a, scale) pairs, |a| <= scale, 1e-12 <= scale <= 1e30: a uniform
    over [-scale, scale]; a = +-scale; quotients at the midpoint between two
    floats and an ulp of a beside it; quotients below 2^-9; subnormal a."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    scale = (10.0 ** rng.uniform(-12, 30, n)).astype(f32)
    u = rng.uniform(-1, 1, n).astype(f32)
    cases = [(f32(s * x), s) for s, x in zip(scale[: n // 4], u)]
    cases += [(s, s) for s in scale[n // 4: n // 4 + 20]]
    cases += [(-s, s) for s in scale[n // 4 + 20: n // 4 + 40]]
    q = np.abs(u[: n // 2]) * f32(0.998) + f32(2.0 ** -8)                   # in [2^-8, 1)
    for s, qq in zip(scale[n // 2:], q):
        mid = (Fraction(float(qq)) + Fraction(float(np.nextafter(qq, f32(2))))) / 2
        a = f32(_rn32(mid * Fraction(float(s))))
        for aa in (a, np.nextafter(a, f32(0)), np.nextafter(a, f32(np.inf))):
            if abs(aa) <= s:
                cases.append((f32(aa), s))
    cases += [(f32(s * x * f32(2.0 ** -12)), s) for s, x in zip(scale[:40], u[40:80])]
    cases += [(f32(x * f32(1e-40)), f32(1e-12)) for x in u[80:100]]
    return [(float(a), float(s)) for a, s in cases]


def test_div_by_is_the_ieee_quotient():
    """The kernel's quotient equals the IEEE one (numpy's f32 division) where
    |a / scale| >= 2^-9, and gives the same code below; many cases lie
    within a tenth of an ulp of the midpoint between two floats, where an
    error flips the rounding."""
    near = 0
    for a, s in _div_cases(21, 600):
        y = float(np.float32(1) / np.float32(s))
        q, want = _div_by(a, s, y), float(np.float32(a) / np.float32(s))
        if abs(want) >= 2.0 ** -9:
            assert q == want, (a, s, q, want)
            ulp = Fraction(float(np.spacing(np.float32(abs(want)))))
            near += abs(Fraction(a) / Fraction(s) - Fraction(want)) > ulp * 2 / 5
        code = lambda v: int(np.clip(np.round(np.float32(v) * np.float32(127)), -127, 127))
        assert code(q) == code(want), (a, s)
    assert near > 100


def _rn(x, p):
    """x (a float that holds it exactly) rounded to p significant bits, ties
    to even, no exponent limit."""
    if x == 0:
        return 0.0
    f, e = math.frexp(x)
    return math.ldexp(round(math.ldexp(f, p)), e - p)


def test_div_by_is_correctly_rounded_at_8_bits_exhaustively():
    """The same three steps in an 8-bit format, where every product and FMA
    is exact in a double before its one rounding: for every divisor b in [1,
    2) and every dividend a in [1/4, b], q = RN(a / b).  Markstein's
    argument does not depend on the precision, so this covers the shape of
    every case, hard ones included; q0 = RN(a y) alone misses often."""
    p = 8
    grid = [1 + i / 2 ** (p - 1) for i in range(2 ** (p - 1))]
    wrong = {"div_by": 0, "q0": 0}
    for b in grid:
        y = _rn(1 / b, p)
        for a in (x * 2.0 ** e for e in (0, -1, -2) for x in grid):
            if a > b:
                continue
            want = _rn(a / b, p)
            q0 = _rn(a * y, p)
            q1 = _rn(q0 + _rn(a - b * q0, p) * y, p)
            wrong["div_by"] += _rn(q1 + _rn(a - b * q1, p) * y, p) != want
            wrong["q0"] += q0 != want
    assert wrong["div_by"] == 0 and wrong["q0"] > 1000, wrong


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m", MS)
def test_coeff_quant_walk_equals_the_plain_version(m, aligned):
    L, k = 2, ROWS // 2
    A = _coeffs(L * k, m, seed=m)
    plan = wire.coeff_plan(L * k, m, aligned)
    codes, scales, ship, stores = _quant_walk(A, plan.vec)
    rc, rs, rp = ref.coeff_quant_ref(A.reshape(L, k, m))
    assert torch.equal(stores, torch.ones_like(stores))                      # each value once
    assert torch.equal(codes, rc.reshape(L * k, m))
    assert torch.equal(_bits(scales), _bits(rs.reshape(L * k, -1)))
    assert torch.equal(_bits(ship), _bits(rp.reshape(L * k, m)))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m", MS)
def test_coeff_dequant_walk_equals_the_plain_version(m, aligned):
    L, k = 2, ROWS // 2
    codes, scales, ship = ref.coeff_quant_ref(_coeffs(L * k, m, seed=m + 1).reshape(L, k, m))
    plan = wire.coeff_dequant_plan(L * k * m, m, aligned)
    assert plan.vec_chunks == (L * k * m // 4 if aligned and m % 4 == 0 else 0)
    out, stores = _dequant_walk(codes.reshape(L * k, m), scales.reshape(L * k, -1), plan)
    assert torch.equal(stores, torch.ones_like(stores))                      # each value once
    want = ref.coeff_dequant_ref(codes, scales)
    assert torch.equal(_bits(out), _bits(want.reshape(L * k, m)))
    assert torch.equal(_bits(out), _bits(ship.reshape(L * k, m)))            # = the shipped value


def test_the_inputs_reach_the_edge_cases():
    """Zeros of both signs and subnormals, a block whose scale is the 1e-12
    floor, a row of scale 127 with values at +-scale and exact .5 ties."""
    A = _coeffs(ROWS, 2816, seed=2816)
    _, scales, _ = ref.coeff_quant_ref(A[None])
    assert bool(((A == 0) & torch.signbit(A)).any()) and bool(((A == 0) & ~torch.signbit(A)).any())
    assert bool(((A != 0) & (A.abs() < 1.17549435e-38)).any())
    assert float(scales[0, 1, 0]) == float(np.float32(1e-12)) and float(scales[0, 2, 0]) == 127.0
    x = A[2] / scales[0, 2].repeat_interleave(512)[:2816] * 127.0
    assert int((x - torch.floor(x) == 0.5).sum()) > 1000
    assert float(A[2, 512]) == 127.0 and float(A[2, 513]) == -127.0


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rows", [1, 7, 128, 131])
@pytest.mark.parametrize("m", MS)
def test_coeff_plan_covers_each_value_once(m, rows, aligned):
    plan = wire.coeff_plan(rows, m, aligned)
    nb = -(-m // 512)
    per = wire.COEFF_ROWS_PER_BLOCK
    assert plan.blocks == nb
    assert plan.vec == (aligned and m % 4 == 0)                  # scalar for m % 4 or unaligned
    # the grid (grid, nb): block (x, b) takes rows per x + i below rows, at block b
    assert plan.grid == -(-rows // per) >= 1
    x, b, i = np.meshgrid(np.arange(plan.grid), np.arange(nb), np.arange(per), indexing="ij")
    r = (per * x + i).ravel()
    b = b.ravel()
    r, b = r[r < rows], b[r < rows]
    assert np.array_equal(np.bincount(r * nb + b, minlength=rows * nb),
                          np.ones(rows * nb, np.int64))                   # each item once
    t = np.arange(128)[:, None]
    cols = []
    for bb in range(nb):
        width = min(m - 512 * bb, 512)
        v = (4 * t + np.arange(4)) if plan.vec else (t + 128 * np.arange(4))
        if plan.vec:                                             # a chunk is whole or absent
            assert np.array_equal((v < width).all(1), (v < width).any(1))
        cols.append(512 * bb + v[v < width])
    flat = np.concatenate([rr * m + cols[bb] for rr, bb in zip(r, b)])
    assert np.array_equal(np.bincount(flat, minlength=rows * m), np.ones(rows * m, np.int64))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m", MS)
def test_coeff_dequant_plan_covers_each_value_once(m, aligned):
    """A chunk a thread: thread t of block j takes chunk 128 j + t; the
    chunks tile the L k m values, only the last one ragged."""
    n = 9 * m
    plan = wire.coeff_dequant_plan(n, m, aligned)
    assert plan.chunks == -(-n // 4) and plan.vec_chunks == (n // 4 if aligned and m % 4 == 0
                                                              else 0)
    assert plan.grid == -(-plan.chunks // wire.COEFF_DEQUANT_THREADS) >= 1
    c = (wire.COEFF_DEQUANT_THREADS * np.arange(plan.grid)[:, None]
         + np.arange(wire.COEFF_DEQUANT_THREADS)).ravel()
    c = c[4 * c < n]
    v = (4 * c[:, None] + np.arange(4)).ravel()
    assert np.array_equal(np.bincount(v[v < n], minlength=n), np.ones(n, np.int64))


@pytest.mark.parametrize("m", MS)
def test_coeff_dequant_vector_chunks_lie_in_one_row_and_block(m):
    """A vector chunk never straddles two rows or two 512-column blocks,
    and the kernel's row and block are the value's."""
    rows = 9
    plan = wire.coeff_dequant_plan(rows * m, m, True)
    c = np.arange(plan.vec_chunks)
    if not len(c):
        assert m % 4
        return
    i = 4 * c[:, None] + np.arange(4)
    row, blk = c // (m // 4), (c % (m // 4)) // 128
    assert np.array_equal(np.broadcast_to(row[:, None], i.shape), i // m)
    assert np.array_equal(np.broadcast_to(blk[:, None], i.shape), (i % m) // 512)


def test_the_slice_shapes_take_the_vector_paths():
    """At the TinyLlama slice's coefficient shapes (L 2, k 64, m 512, 2048,
    2816), aligned, both kernels take the vector path whole."""
    for m in (512, 2048, 2816):
        assert wire.coeff_plan(128, m, True).vec
        plan = wire.coeff_dequant_plan(128 * m, m, True)
        assert plan.vec_chunks == plan.chunks == 128 * m // 4
