"""The port on the card: the CUDA kernels against their plain versions, and
the PRNG on CUDA against the same draws on the CPU.

Tolerances: encode/decode, and encode_quant's E and decode_wire's Ghat,
``||kernel - plain||_F <= 1e-5 ||G||_F`` (encode and encode_quant also at a
split edge, l = LC + 1, below one chunk, Gemma3-1B's MLP shape and k = 1,
17, 33; two calls on the same inputs give the same bits; with flash, they
also run on a second card, where the host has one); coeff_quant bit for
bit (also on A with +-0 every seventh value, A = 0, exact .5 ties at scales
over 20 decades, scales above 2^100, and from an A, or into codes or ship,
off alignment), at
the slice's group shapes with decode_wire;
encode_quant's codes equal except by one where A/scale*127 sits within
1e-4 of a half-integer; M = 0 exact; PRNG draws bit for bit; the sign and
quantizer wire kernels (sign_pack, sign_unpack, quant_pack, unpack_dequant)
and the block quantizer (block_quant, block_dequant, also through the wire
route of the other bit widths) bit for bit, at every flat group size of the
TinyLlama-width slice and at ragged sizes (quant_pack at bits 2, 4 and 8 and
block_quant at bits 2 to 8 and blocks 512, 256, 96, 100, 30 and 1024, also
with -0.0, subnormals, x on integers, uniforms of 0.0 and 1 - 2^-24, and a
g or a u one float off 16-byte alignment; the sign wire also with -0.0,
+-inf and subnormals in g, its scale against ``ref.mean_abs_ref``, from a g
and into an output off 16-byte alignment, and ``ops.sign_wire`` running
no torch op but its outputs' allocation); the two dequantizers also at n
from 1 to 17, 511, 513, 70,001 and 1,048,576, every width (block_dequant
at blocks 512, 256, 96, 100 and 30 and in f32, bf16 and f16), with operands
on and off 16-byte alignment; coeff_dequant bit for bit;
flash_attention within rtol = atol = 1e-4 in f32 and 5e-2 with bf16 inputs
(the JAX tests' tolerances), also where its plan splits a query tile's
keys (at a one-tile chunk, Sq != Skv, rows that see no key), and an eval
forward on the card launches it once per layer while a ``torch.func.grad``
step launches it never; decode and
decode_wire at k = 1, 17, 33 and ragged l and m, decode_wire bit-equal to
decode(M, coeff_dequant(codes, scales)); flash, decode and decode_wire give
the same bits twice; encode, decode, encode_quant and coeff_quant over a
stack that folds several clients' L matrices (the fused engine's call)
give each client the bits of its own call; and, where the host has two
cards, ``run_fl(devices=2)`` starts two NCCL ranks, a card each, whose
ledger equals the single-device fused run's and whose eval losses are
within 1e-5 (fedpaq 5e-4); the KV-cache decode of Gemma3-1B reduced past
its window against the CPU's within 1e-5 of max |logits|, written in place
and without flash; the serve driver's ``randint`` and ``categorical``
draws bit for bit against the CPU's; a checkpoint of CUDA tensors
restored onto the card bit for bit; and granite-moe-1b-a400m reduced's MoE
FFN and its gradient under ``torch.func.vmap`` over clients, with no host
sync, against the CPU's.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode).  The file imports neither jax nor the JAX package, so it runs
on a machine without them; there, skip the JAX-importing conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dataclasses  # noqa: E402
import math  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.configs.tinyllama_1_1b import CONFIG  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, flash_attention, ops, quant, wire  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import model  # noqa: E402

pytestmark = pytest.mark.cuda

RTOL = 1e-5
#: card vs CPU normals: no libm on the path (XLA's log and log1p are
#: mirrored in tensor arithmetic, sqrt is correctly rounded), so bit-equal
NORMAL_ULP_BOUND = 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(l, k, m, L, seed=0):
    rng = np.random.default_rng(seed)
    M = np.linalg.qr(rng.normal(size=(L, l, k)))[0].astype(np.float32)
    G = rng.normal(size=(L, l, m)).astype(np.float32)
    return M, G


#: encode and encode_quant beyond the first shapes: (L, l, m, k) at a split
#: edge (l = LC + 1 of ``split_plan``), below one chunk, at Gemma3-1B's MLP
#: shape, and at k = 1, 17 and 33 (the scalar copies of M); the splits are
#: held on the CPU in ``test_torch_encode_plan.py``
ENCODE_SPLIT_CASES = [(1, 65, 512, 64), (2, 1025, 260, 64), (2, 40, 300, 64),
                      (6, 6912, 1152, 64), (2, 300, 260, 1), (1, 517, 1000, 17),
                      (2, 1000, 515, 33)]


@pytest.mark.parametrize("L,l,m,k", [(2, 1024, 512, 64), (2, 1024, 500, 64), (3, 384, 77, 8)]
                         + ENCODE_SPLIT_CASES)
def test_cuda_kernels_match_plain(cuda, L, l, m, k):
    M, G = (torch.from_numpy(x).to(cuda) for x in _inputs(l, k, m, L))
    n = ops.launch_counts()
    A, E = ops.encode(M, G)
    rA, rE = tref.encode_ref(M, G)
    O = ops.decode(M, rA.contiguous())
    gn = float(G.norm())
    assert float((A - rA).norm()) <= RTOL * gn and float((E - rE).norm()) <= RTOL * gn
    assert float((O - tref.decode_ref(M, rA)).norm()) <= RTOL * gn
    A0, E0 = ops.encode(torch.zeros_like(M), G)
    assert bool((A0 == 0).all()) and torch.equal(E0, G)
    assert ops.launch_counts()["encode"] == n["encode"] + 2
    assert ops.launch_counts()["decode"] == n["decode"] + 1


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    M, G = (torch.from_numpy(x).to(cuda) for x in _inputs(128, 8, 64, 1))
    with pytest.raises(TypeError):
        ops.encode(M.double(), G.double())
    with pytest.raises(ValueError):
        ops.encode(M, G.mT.contiguous().mT)          # non-contiguous G
    with pytest.raises(ValueError):
        ops.encode(torch.zeros(1, 128, 65, device=cuda), G)   # k > 64
    with pytest.raises(ValueError):
        ops.encode(M[0], G[0])                       # no stack axis


def test_cuda_prng_matches_cpu(cuda):
    """Keys, bits and uniforms are integer work and agree exactly; normals
    agree within the ulp bound."""
    kc, kg = prng.PRNGKey(3, "cpu"), prng.PRNGKey(3, cuda)
    assert torch.equal(prng.split(kg, 5).cpu(), prng.split(kc, 5))
    assert torch.equal(prng.fold_in(kg, 123456789).cpu(), prng.fold_in(kc, 123456789))
    assert torch.equal(prng.uniform(kg, (4096,)).cpu(), prng.uniform(kc, (4096,)))
    a = prng.normal(kc, (200000,)).numpy()
    b = prng.normal(kg, (200000,)).cpu().numpy()
    ulp = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    print(f"normals card vs CPU: {int((ulp > 0).sum())} of {ulp.size} differ, "
          f"max {int(ulp.max())} ulp")
    assert ulp.max() <= NORMAL_ULP_BOUND


def _coeffs(L, k, m, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_t(3, size=(L, k, m)) * 10.0 ** rng.uniform(-4, 1, (L, k, 1))
            ).astype(np.float32)


#: the coefficient wire's shapes (L, k, m): the slice's m (2048, 2816, 512),
#: ragged ones, and m of 1, 3 (no vector path), 513 and 1152
COEFF_SHAPES = [(2, 64, 2048), (2, 64, 2816), (3, 5, 700), (1, 4, 100), (2, 64, 512),
                (1, 3, 1), (2, 5, 3), (2, 64, 513), (2, 64, 1152)]


def _zero_laden(A):
    """A with every seventh value +-0, and A = 0 (SVDFed's round-0 operand)."""
    z = A.clone()
    z.view(-1)[::14] = 0.0
    z.view(-1)[7::14] = -0.0
    return {"zeros 1/7": z, "A = 0": torch.zeros_like(A)}


def _ties(L, k, m, seed):
    """Coefficients whose a / scale * 127, each step rounded to f32, is an
    exact .5 tie (those that are not are zeroed), at a scale per 512-column
    block over 20 decades, each block opened by +-scale: a quotient off by
    an ulp moves a tie's code."""
    rng = np.random.default_rng(seed)
    nb = -(-m // 512)
    s = np.repeat((10.0 ** rng.uniform(-11, 9, (L, k, nb))).astype(np.float32), 512, -1)
    h = rng.integers(-127, 127, s.shape) + 0.5
    a = (s.astype(np.float64) * h / 127).astype(np.float32)
    a = np.where(a / s * np.float32(127) == h, a, np.float32(0))
    a[..., ::512] = s[..., ::512] * np.where(rng.random((L, k, nb)) < 0.5, 1, -1)
    return a[..., :m]


def _coeff_quant_into(A, codes, scales, ship, vec):
    """coeff_quant's entry point on buffers of the caller's, by the plan of
    ``wire.coeff_plan(L k, m, vec)``: codes or ship off alignment take the
    scalar path (vec False), which the wrapper's fresh outputs never do."""
    L, k, m = A.shape
    plan = wire.coeff_plan(L * k, m, vec)
    _build.launch("coeff_quant", "gradestc_coeff_quant_f32", A.data_ptr(), codes.data_ptr(),
                  scales.data_ptr(), ship.data_ptr(), L, k, m, plan.vec, plan.grid,
                  _build.stream(A))


def _same_wire(got, want):
    return (torch.equal(got[0], want[0]) and _same_bits(got[1], want[1])
            and _same_bits(got[2], want[2]))


@pytest.mark.parametrize("L,k,m", COEFF_SHAPES)
def test_cuda_coeff_quant_bit_exact(cuda, L, k, m):
    A = _coeffs(L, k, m, seed=m)
    A[0, 0, :512] = 0.0                               # an all-zero block
    A[0, 1, :3] = [127.0, 2.5, -0.5][:m]              # the max and two ties
    At = torch.from_numpy(A).to(cuda)
    n = ops.launch_counts()["coeff_quant"]
    codes, scales, ship = ops.coeff_quant(At)
    rc, rs, rp = tref.coeff_quant_ref(At)
    torch.cuda.synchronize()
    assert ops.launch_counts()["coeff_quant"] == n + 1
    assert torch.equal(codes, rc)
    assert torch.equal(scales.view(torch.int32), rs.view(torch.int32))
    assert torch.equal(ship.view(torch.int32), rp.view(torch.int32))
    assert float(scales[0, 0, 0]) == np.float32(1e-12)
    assert torch.equal(ops.coeff_roundtrip(At, "int8"), ship)
    # zero-laden inputs, exact ties at scales over 20 decades, and scales
    # above 2^100, which take the IEEE division
    T = torch.from_numpy(_ties(L, k, m, seed=m + 2)).to(cuda)
    assert m < 512 or float((T != 0).float().mean()) > 0.5          # most values are ties
    H = At * 1e32
    assert float(H.abs().max()) > 2.0 ** 100
    for label, Z in {**_zero_laden(At), "ties": T, "huge": H}.items():
        assert _same_wire(ops.coeff_quant(Z), tref.coeff_quant_ref(Z)), label
    z = ops.coeff_quant(torch.zeros_like(At))
    assert not bool(z[0].any()) and bool((z[1] == np.float32(1e-12)).all())
    assert not bool(z[2].any()) and not bool(torch.signbit(z[2]).any())
    # the scalar path: A, codes or ship one element off 16-byte alignment
    assert _same_wire(ops.coeff_quant(_offset(At.reshape(-1), True).view(L, k, m)),
                      (rc, rs, rp))
    for off_codes, off_ship in ((True, False), (False, True)):
        c = _offset(torch.zeros(L * k * m, dtype=torch.int8, device=cuda), off_codes)
        p = _offset(torch.zeros(L * k * m, device=cuda), off_ship)
        sc = torch.empty_like(rs)
        _coeff_quant_into(At, c, sc, p, False)
        assert _same_wire((c.view(L, k, m), sc, p.view(L, k, m)), (rc, rs, rp))
        if m % 4 == 0:                                # the vector path refuses them
            with pytest.raises(RuntimeError):
                _coeff_quant_into(At, c, sc, p, True)


def _code_flips_ok(A, scales, codes, ref_codes):
    """Codes equal, or one apart where A/scale*127 is within 1e-4 of x.5."""
    m = A.shape[-1]
    x = A / scales.repeat_interleave(512, dim=-1)[..., :m] * 127.0
    near = ((x - x.floor()).abs() - 0.5).abs() < 1e-4
    d = (codes.long() - ref_codes.long()).abs()
    return int(d.max()) <= 1 and not bool(((d > 0) & ~near).any())


@pytest.mark.parametrize("L,l,m,k", [(2, 1024, 512, 64), (2, 4096, 2816, 64), (3, 384, 77, 8),
                                     (1, 200, 1030, 20)] + ENCODE_SPLIT_CASES)
def test_cuda_encode_quant_and_decode_wire_match_plain(cuda, L, l, m, k):
    M, G = (torch.from_numpy(x).to(cuda) for x in _inputs(l, k, m, L, seed=m))
    n = ops.launch_counts()
    codes, scales, E = ops.encode_quant(M, G)
    rc, rs, rE = tref.encode_quant_ref(M, G)
    A = torch.matmul(M.mT, G)
    gn = float(G.norm())
    assert _code_flips_ok(A, rs, codes, rc)
    torch.testing.assert_close(scales, rs, rtol=1e-6, atol=0)
    # E against the plain residual on the kernel's own shipped values
    ship = tref.coeff_dequant_ref(codes, scales)
    assert float((E - (G - M @ ship)).norm()) <= RTOL * gn
    Ghat = ops.decode_wire(M, codes, scales)
    assert float((Ghat - tref.decode_ref(M, ship)).norm()) <= RTOL * gn
    # M = 0: A == 0, scale == 1e-12, codes == 0, E == G exactly
    c0, s0, E0 = ops.encode_quant(torch.zeros_like(M), G)
    assert not bool(c0.any()) and bool((s0 == np.float32(1e-12)).all()) and torch.equal(E0, G)
    torch.cuda.synchronize()
    assert ops.launch_counts()["encode_quant"] == n["encode_quant"] + 2
    assert ops.launch_counts()["decode_wire"] == n["decode_wire"] + 1


@pytest.mark.parametrize("L,l,m,k", [(2, 4096, 2816, 64), (1, 517, 1000, 17)])
def test_cuda_encode_kernels_give_the_same_bits_twice(cuda, L, l, m, k):
    """The split sums are added in a fixed order (no float atomics)."""
    M, G = (torch.from_numpy(x).to(cuda) for x in _inputs(l, k, m, L, seed=l))
    A1, E1 = ops.encode(M, G)
    A2, E2 = ops.encode(M, G)
    q1, q2 = ops.encode_quant(M, G), ops.encode_quant(M, G)
    torch.cuda.synchronize()
    assert _same_bits(A1, A2) and _same_bits(E1, E2)
    assert torch.equal(q1[0], q2[0]) and _same_bits(q1[1], q2[1]) and _same_bits(q1[2], q2[2])


@pytest.mark.parametrize("L,l,m,k", [(2, 4096, 2816, 64), (2, 1025, 260, 64), (1, 517, 1000, 17)])
def test_cuda_client_fold_gives_per_client_bits(cuda, L, l, m, k):
    """The fused engine's call: (C, L, ...) stacks fold the clients into the
    kernels' stack axis, one launch each, encode's split planned for one
    client's L (a plan for C L would take another split, and other bits)."""
    C = 3
    pairs = [_inputs(l, k, m, L, seed=c) for c in range(C)]
    M = torch.from_numpy(np.stack([p[0] for p in pairs])).to(cuda)
    G = torch.from_numpy(np.stack([p[1] for p in pairs])).to(cuda)
    n = ops.launch_counts()
    A, E = ops.encode(M, G)
    Ghat = ops.decode(M, A)
    codes, scales, Eq = ops.encode_quant(M, G)
    qc, qs, ship = ops.coeff_quant(A)
    after = ops.launch_counts()
    assert all(after[k_] == n[k_] + 1 for k_ in ("encode", "decode", "encode_quant",
                                                 "coeff_quant"))
    for c in range(C):
        Ac, Ec = ops.encode(M[c], G[c])
        assert _same_bits(A[c], Ac) and _same_bits(E[c], Ec)
        assert _same_bits(Ghat[c], ops.decode(M[c], Ac))
        cc, sc, ec = ops.encode_quant(M[c], G[c])
        assert torch.equal(codes[c], cc) and _same_bits(scales[c], sc) and _same_bits(Eq[c], ec)
        assert all(torch.equal(x[c], y) for x, y in zip((qc, qs, ship), ops.coeff_quant(Ac)))


@pytest.mark.parametrize("L,l,m,k", [(2, 1024, 512, 64), (3, 384, 77, 8)] + ENCODE_SPLIT_CASES)
def test_cuda_decode_kernels_match_plain(cuda, L, l, m, k):
    """decode and decode_wire on the residual kernel's tiling: within RTOL
    of the plain version, decode_wire bit-equal to decode(M,
    coeff_dequant(codes, scales)), M = 0 exactly 0, the same bits twice."""
    M, G = (torch.from_numpy(x).to(cuda) for x in _inputs(l, k, m, L, seed=k + m))
    A = torch.matmul(M.mT, G)
    gn = float(G.norm())
    n = ops.launch_counts()
    Ghat = ops.decode(M, A)
    assert float((Ghat - tref.decode_ref(M, A)).norm()) <= RTOL * gn
    codes, scales, _ = ops.coeff_quant(A)
    ship = ops.coeff_dequant(codes, scales)
    wire_hat = ops.decode_wire(M, codes, scales)
    assert _same_bits(wire_hat, ops.decode(M, ship))
    assert float((wire_hat - tref.decode_ref(M, ship)).norm()) <= RTOL * gn
    assert not bool(ops.decode(torch.zeros_like(M), A).any())
    assert not bool(ops.decode_wire(torch.zeros_like(M), codes, scales).any())
    assert _same_bits(ops.decode(M, A), Ghat)
    assert _same_bits(ops.decode_wire(M, codes, scales), wire_hat)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode"] == n["decode"] + 4
    assert ops.launch_counts()["decode_wire"] == n["decode_wire"] + 3


def test_cuda_wire_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    M, G = (torch.from_numpy(x).to(cuda) for x in _inputs(128, 8, 600, 1))
    codes, scales, _ = ops.encode_quant(M, G)
    with pytest.raises(TypeError):
        ops.decode_wire(M, codes.int(), scales)       # codes must be int8
    with pytest.raises(ValueError):
        ops.decode_wire(M, codes, scales[..., :1])    # scales do not fit
    with pytest.raises(ValueError):
        ops.coeff_quant(G[0])                         # no stack axis
    with pytest.raises(ValueError):
        ops.encode_quant(torch.zeros(1, 128, 65, device=cuda), G)   # k > 64


def _offset(x, misaligned):
    """``x``, or a contiguous copy one element off 16-byte alignment."""
    if not misaligned:
        return x
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:].copy_(x)
    return buf[1:]


def _flat_sizes():
    """The flat group sizes of the TinyLlama-width slice (2 layers, vocab
    4096), plus ragged ones."""
    arch = dataclasses.replace(CONFIG, n_layers=2, vocab=4096, dtype="float32", remat=False)
    sizes = {math.prod(s) * st for s, st in model.param_group_shapes(arch).values()}
    return sorted(sizes) + [1, 31, 513, 70_001]


def _flat(n, seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_t(3, size=n) * 1e-3).astype(np.float32)
    g[::7] = 0.0
    g[3::11] = -0.0
    if n >= 1024:
        g[512:1024] = 0.0
    return g


def _u32(words):
    return words.long() & 0xFFFFFFFF


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _signs(n, seed):
    """``_flat`` with +-inf and subnormals of both signs among the zeros."""
    g = _flat(n, seed)
    g[5::13] = np.float32(1e-40) * np.where(np.arange(len(g[5::13])) % 2, -1, 1)
    if n >= 100:
        g[97], g[n - 2] = np.inf, -np.inf
    return g


#: the sign wire's sizes: a word and a row on both sides, a ragged size and
#: every flat group size
SIGN_SIZES = sorted(set(_flat_sizes()) | {1, 31, 33, 511, 513, 70_001})


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("n", SIGN_SIZES)
def test_cuda_sign_wire_bit_exact(cuda, n, special):
    """words, row sums and the scale of sign_pack (also from a g one float
    off 16-byte alignment, its scalar path) and sign_unpack (also into an
    output one float off alignment) bit for bit; ``special`` puts -0.0,
    +-inf and subnormals in g (the scale is then inf)."""
    g = torch.from_numpy((_signs if special else _flat)(n, seed=n)).to(cuda)
    before = ops.launch_counts()
    words, rowsums, scale = wire.sign_pack(g)
    rw, rs = tref.sign_pack_ref(g)
    pad = (-n) % 512
    rows = tref.pairwise_sum(torch.nn.functional.pad(g.abs(), (0, pad)).reshape(-1, 512))
    assert torch.equal(_u32(words), rw) and _same_bits(rowsums, rows)
    assert _same_bits(scale, rs) and _same_bits(scale.cpu(), tref.mean_abs_ref(g.cpu()))
    gm = _offset(g, True)
    mw, mrows, mscale = wire.sign_pack(gm)
    assert torch.equal(mw, words) and _same_bits(mrows, rowsums) and _same_bits(mscale, scale)
    tw, ts = ops.sign_wire(g)
    assert torch.equal(tw, words) and _same_bits(ts, rs)
    out = wire.sign_unpack(words, ts, n)
    want = tref.sign_unpack_ref(rw, rs, n)
    assert _same_bits(out, want)
    assert bool((out[g == 0] == ts).all())
    mis = _offset(torch.zeros(n, device=cuda), True)
    assert wire.sign_unpack(words, ts, n, out=mis) is mis and _same_bits(mis, want)
    after = ops.launch_counts()
    assert after["sign_pack"] == before["sign_pack"] + 3
    assert after["sign_unpack"] == before["sign_unpack"] + 2


def test_cuda_sign_wire_runs_no_torch_op(cuda):
    """On the card ``ops.sign_wire`` launches its two kernels (sign_pack's
    and the scale's finish) and nothing else: no aten op but the outputs'
    allocation, no other device kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.from_numpy(_flat(70_001, seed=1)).to(cuda)
    ops.sign_wire(g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ops.sign_wire(g)
        torch.cuda.synchronize()
    events = prof.key_averages()
    aten = {e.key for e in events if e.device_type == DeviceType.CPU
            and e.key.startswith("aten::")}
    kernels = sorted(e.key for e in events if e.device_type == DeviceType.CUDA)
    assert aten <= {"aten::empty"}, aten
    assert len(kernels) == 2 and any("sign_pack_kernel" in k for k in kernels) and any(
        "mean_abs_kernel" in k for k in kernels), kernels


def _quant_flat(n, seed, bits):
    """``_flat`` with subnormals of both signs and, past 2048 values, a
    512-value row of max 1.0 whose values are f32(k / levels), so that most
    x = g / scale * levels land on an integer."""
    g = _flat(n, seed)
    g[5::13] = np.float32(1e-40) * np.where(np.arange(len(g[5::13])) % 2, -1, 1)
    if n >= 2048:
        levels = tref.quant_levels(bits)
        k = np.random.default_rng(seed).integers(-levels, levels + 1, 512)
        g[1024:1536] = (k / np.float32(levels)).astype(np.float32)
        g[1024] = 1.0
    return g


def _uniform_specials(u):
    """A copy of the uniforms with exact 0.0 and 1 - 2^-24, the largest."""
    u = u.clone()
    u[::5] = 0.0
    u[1::5] = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
    return u


QUANT_SIZES = sorted(set(_flat_sizes()) | {1, 31, 33, 511, 513, 70_001})


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("n", QUANT_SIZES)
def test_cuda_quant_wire_bit_exact(cuda, n, bits):
    """quant_pack's words and scales bit for bit, on the vector path and,
    with g or u one float off 16-byte alignment, the scalar one; g with
    -0.0, subnormals, a zero row and x on integers, u with 0.0 and 1 -
    2^-24; then unpack_dequant and the dispatchers."""
    g = torch.from_numpy(_quant_flat(n, n + bits, bits)).to(cuda)
    n_p = n + (-n) % 512
    u = prng.uniform(prng.PRNGKey(n, cuda), (n_p,))
    us = _uniform_specials(u)
    gp = torch.nn.functional.pad(g, (0, n_p - n))
    before = ops.launch_counts()
    words, scales = wire.quant_pack(g, u, bits)
    rw, rs = tref.quant_pack_ref(gp, u, 512, bits)
    assert torch.equal(_u32(words), rw) and _same_bits(scales, rs)
    sw, ss = tref.quant_pack_ref(gp, us, 512, bits)
    for gm, um in ((g, us), (_offset(g, True), us), (g, _offset(us, True))):
        mw, ms = wire.quant_pack(gm, um, bits)
        assert torch.equal(_u32(mw), sw) and _same_bits(ms, ss)
    out = wire.unpack_dequant(words, scales, n, bits)
    assert _same_bits(out, tref.unpack_dequant_ref(rw, rs, n_p, 512, bits)[:n])
    after = ops.launch_counts()
    assert after["quant_pack"] == before["quant_pack"] + 4
    assert after["unpack_dequant"] == before["unpack_dequant"] + 1
    # the dispatchers draw the same uniforms from the same key, on the card
    key = prng.PRNGKey(n, cuda)
    q = ops.quantize_update(g, key, bits=bits, use_pallas=True)
    assert _same_bits(q, out)
    assert _same_bits(q.cpu(), ops.quantize_update(g.cpu(), prng.PRNGKey(n, "cpu"), bits=bits,
                                                   use_pallas=True))


def test_cuda_quant_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    g = torch.randn(1000, device=cuda)
    u = torch.rand(1024, device=cuda)
    key = prng.PRNGKey(0, cuda)
    with pytest.raises(ValueError):
        wire.quant_pack(g, u, 3)                            # bits not in {2, 4, 8}
    with pytest.raises(ValueError):
        ops.block_quant_wire(g, key, bits=9)                # the wire takes 2..8 bits
    with pytest.raises(ValueError):
        ops.block_quant_wire(g, key, bits=1)                # 1 bit is the sign wire
    with pytest.raises(ValueError):
        quant.block_quant(g, u, 512, 9)
    with pytest.raises(ValueError):
        quant.block_quant(g, u[:1000], 256, 6)              # u not over the padded length
    with pytest.raises(TypeError):
        quant.block_dequant(torch.zeros(1024, dtype=torch.int8, device=cuda),
                            torch.ones(2, device=cuda), 1000, 512, 6, torch.float64)
    with pytest.raises(ValueError):
        wire.quant_pack(g, u[:1000])                        # u not over the padded length
    with pytest.raises(ValueError):
        wire.quant_pack(g, u.cpu())                         # CPU/CUDA mix
    with pytest.raises(ValueError):
        ops.sign_unwire(*wire.sign_pack(g)[:1], torch.ones((), device="cpu"), 1000)
    with pytest.raises(ValueError):
        wire.sign_unpack(wire.sign_pack(g)[0], torch.ones((), device=cuda), 1000,
                         out=torch.empty(999, device=cuda))          # out of the wrong size
    with pytest.raises(ValueError):
        wire.sign_pack(g[::2])                              # non-contiguous
    with pytest.raises(TypeError):
        wire.sign_pack(g.double())
    with pytest.raises(ValueError):
        ops.quantize_update(g, key, use_pallas=False)       # no plain path on the card


@pytest.mark.parametrize("block", [512, 256, 96, 100, 30, 1024])
@pytest.mark.parametrize("n", [1, 513, 70_001, 2_883_584])
def test_cuda_block_quant_bit_exact(cuda, n, block):
    """bits 2 to 8: codes and scales bit for bit on the vector path and,
    with g or u one float off 16-byte alignment, the scalar one (blocks of
    whole chunks in registers, 1024 and 30 value by value); g and
    u as in ``test_cuda_quant_wire_bit_exact``; then block_dequant and, at 6
    bits, the dispatchers on the card and the CPU."""
    pad = (-n) % block
    u = prng.uniform(prng.PRNGKey(n, cuda), (n + pad,))
    us = _uniform_specials(u)
    for bits in range(2, 9):
        g = torch.from_numpy(_quant_flat(n, n + bits, bits)).to(cuda)
        gp = torch.nn.functional.pad(g, (0, pad))
        before = ops.launch_counts()
        codes, scales = quant.block_quant(g, u, block, bits)
        rc, rs = tref.block_quant_ref(gp, u, block, bits)
        assert torch.equal(codes, rc) and _same_bits(scales, rs), bits
        sc, ss = tref.block_quant_ref(gp, us, block, bits)
        for gm, um in ((g, us), (_offset(g, True), us), (g, _offset(us, True))):
            mc, ms = quant.block_quant(gm, um, block, bits)
            assert torch.equal(mc, sc) and _same_bits(ms, ss), bits
        out = quant.block_dequant(codes, scales, n, block, bits)
        assert _same_bits(out, tref.block_dequant_ref(rc, rs, block, bits)[:n])
        half = quant.block_dequant(codes, scales, n, block, bits, torch.bfloat16)
        assert torch.equal(half, out.to(torch.bfloat16))
        after = ops.launch_counts()
        assert after["block_quant"] == before["block_quant"] + 4
        assert after["block_dequant"] == before["block_dequant"] + 2
        if bits != 6:
            continue
        # the dispatchers: the same uniforms from the same key, and the CPU's result
        key = prng.PRNGKey(n, cuda)
        c2, s2, pad2 = ops.block_quantize(g, key, block=block, bits=bits)
        assert pad2 == pad and torch.equal(c2, codes) and _same_bits(s2, scales)
        cc, cs, _ = ops.block_quantize(g.cpu(), prng.PRNGKey(n, "cpu"), block=block, bits=bits)
        assert torch.equal(cc, codes.cpu()) and _same_bits(cs, scales.cpu())
        assert _same_bits(ops.block_dequantize(codes, scales, pad, block=block, bits=bits), out)


#: the dequantizers' sizes: every chunk remainder, both sides of a row, a
#: ragged size and one group size of the path
DEQUANT_SIZES = list(range(1, 18)) + [511, 513, 70_001, 1_048_576]


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("n", DEQUANT_SIZES)
def test_cuda_unpack_dequant_bit_exact(cuda, n, bits, misaligned):
    """Every code of every width, on the vector path and (misaligned, the
    ragged tail) the scalar one."""
    rng = np.random.default_rng(n + bits)
    n_p = n + (-n) % 512
    levels = int(tref.quant_levels(bits))
    biased = torch.from_numpy(rng.integers(0, 2 * levels + 1, n_p))
    scales = torch.from_numpy(rng.uniform(1e-6, 1e-2, n_p // 512).astype(np.float32))
    words = tref.pack_codes_ref(biased, bits)
    want = tref.unpack_dequant_ref(words, scales, n_p, 512, bits)[:n]
    w32 = _offset(words.to(torch.int32).to(cuda), misaligned)
    s = _offset(scales.to(cuda), misaligned)
    before = ops.launch_counts()["unpack_dequant"]
    out = wire.unpack_dequant(w32, s, n, bits)
    assert ops.launch_counts()["unpack_dequant"] == before + 1
    assert _same_bits(out.cpu(), want)


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("block", [512, 256, 96, 100, 30])
@pytest.mark.parametrize("n", DEQUANT_SIZES)
def test_cuda_block_dequant_bit_exact(cuda, n, block, misaligned):
    """bits 2 to 8 in f32, bf16 and f16 (each rounded once from the f32
    value), blocks of whole chunks or not (30), aligned or not."""
    n_p = n + (-n) % block
    for bits in range(2, 9):
        rng = np.random.default_rng(n + block + bits)
        levels = int(tref.quant_levels(bits))
        codes = torch.from_numpy(rng.integers(-levels, levels + 1, n_p).astype(np.int8))
        scales = torch.from_numpy(rng.uniform(1e-6, 1e-2, n_p // block).astype(np.float32))
        want = tref.block_dequant_ref(codes, scales, block, bits)[:n]
        c, s = _offset(codes.to(cuda), misaligned), _offset(scales.to(cuda), misaligned)
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            before = ops.launch_counts()["block_dequant"]
            out = quant.block_dequant(c, s, n, block, bits, dt)
            assert ops.launch_counts()["block_dequant"] == before + 1
            assert out.dtype == dt
            assert torch.equal(out.cpu().view(torch.int8), want.to(dt).view(torch.int8))


@pytest.mark.parametrize("n,bits,block", [(70_001, 6, 512), (70_001, 3, 256), (513, 7, 512),
                                          (2_883_584, 5, 512)])
def test_cuda_quant_wire_other_widths(cuda, n, bits, block):
    """bits outside {2, 4, 8} or a block other than 512: block_quant, the
    integer pack, and back, equal to the oracle and to the CPU's route."""
    g = torch.from_numpy(_flat(n, seed=3 * n + bits)).to(cuda)
    key = prng.PRNGKey(n + bits, cuda)
    before = ops.launch_counts()
    words, scales, pad = ops.block_quant_wire(g, key, bits=bits, block=block)
    out = ops.block_dequant_wire(words, scales, pad, bits=bits, block=block)
    after = ops.launch_counts()
    n_p = n + pad
    rw, rs = tref.quant_pack_ref(torch.nn.functional.pad(g, (0, pad)),
                                 prng.uniform(key, (n_p,)), block, bits)
    assert words.dtype == torch.int32 and torch.equal(_u32(words), rw) and _same_bits(scales, rs)
    assert _same_bits(out, tref.unpack_dequant_ref(rw, rs, n_p, block, bits)[:n])
    assert after["block_quant"] == before["block_quant"] + 1
    assert after["block_dequant"] == before["block_dequant"] + 1
    assert after["quant_pack"] == before["quant_pack"]
    assert after["unpack_dequant"] == before["unpack_dequant"]
    cw, cs, _ = ops.block_quant_wire(g.cpu(), prng.PRNGKey(n + bits, "cpu"), bits=bits,
                                     block=block)
    assert torch.equal(cw, words.cpu()) and _same_bits(cs, scales.cpu())


@pytest.mark.parametrize("L,k,m", COEFF_SHAPES)
def test_cuda_coeff_dequant_bit_exact(cuda, L, k, m):
    A = torch.from_numpy(_coeffs(L, k, m, seed=m + 1)).to(cuda)
    codes, scales, ship = ops.coeff_quant(A)
    n = ops.launch_counts()["coeff_dequant"]
    out = ops.coeff_dequant(codes, scales)
    torch.cuda.synchronize()
    assert ops.launch_counts()["coeff_dequant"] == n + 1
    assert _same_bits(out, tref.coeff_dequant_ref(codes, scales))
    assert _same_bits(out, ship)
    with pytest.raises(ValueError):
        ops.coeff_dequant(codes, scales[..., :0])
    with pytest.raises(TypeError):
        ops.coeff_dequant(codes.int(), scales)
    # zero-laden inputs
    for label, Z in _zero_laden(A).items():
        zc, zs, zp = ops.coeff_quant(Z)
        assert _same_bits(ops.coeff_dequant(zc, zs), zp), label
    # the scalar path: codes one byte off alignment, or an output one float off
    assert _same_bits(ops.coeff_dequant(_offset(codes.reshape(-1), True).view(L, k, m),
                                         scales), ship)
    o = _offset(torch.zeros(L * k * m, device=cuda), True)
    plan = wire.coeff_dequant_plan(L * k * m, m, False)
    _build.launch("coeff_dequant", "wire_coeff_dequant_f32", codes.data_ptr(), scales.data_ptr(),
                  o.data_ptr(), L * k, m, plan.vec_chunks, plan.grid, _build.stream(codes))
    assert _same_bits(o.view(L, k, m), ship)


def _slice_coeff_shapes():
    """The compressed groups' (L, l, m, k) of the TinyLlama-width slice."""
    from repro_torch.core.policy import make_policy

    arch = dataclasses.replace(CONFIG, n_layers=2, vocab=4096, dtype="float32", remat=False)
    policy = make_policy(model.param_group_shapes(arch), min_params=4096)
    return sorted({(p.stack, p.l, p.m, p.k) for p in policy.plans.values() if p.compress})


@pytest.mark.parametrize("L,l,m,k", _slice_coeff_shapes())
def test_cuda_coeff_wire_at_the_slice_shapes(cuda, L, l, m, k):
    """At each compressed group shape of the slice, on A = M^T G, A with
    every seventh value +-0 and A = 0: coeff_quant equals its plain version
    bit for bit, coeff_dequant its shipped values, decode_wire decode(M,
    coeff_dequant); encode_quant with M = 0 gives codes 0, scales 1e-12 and
    E == G."""
    M, G = (torch.from_numpy(x).to(cuda) for x in _inputs(l, k, m, L, seed=l + m))
    A = torch.matmul(M.mT, G)
    for label, X in {"A": A, **_zero_laden(A)}.items():
        codes, scales, ship = ops.coeff_quant(X)
        assert _same_wire((codes, scales, ship), tref.coeff_quant_ref(X)), label
        back = ops.coeff_dequant(codes, scales)
        assert _same_bits(back, ship), label
        assert _same_bits(ops.decode_wire(M, codes, scales), ops.decode(M, back)), label
    c0, s0, E0 = ops.encode_quant(torch.zeros_like(M), G)
    assert not bool(c0.any()) and bool((s0 == np.float32(1e-12)).all()) and torch.equal(E0, G)


def _qkv(B, Sq, Skv, H, KV, hd, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
                             ).to(device, dtype),
            torch.from_numpy(rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
                             ).to(device, dtype),
            torch.from_numpy(rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
                             ).to(device, dtype))


def test_cuda_kernels_run_on_a_second_card(cuda):
    """A kernel with more than 48 KB of shared memory (encode's and the
    decodes' residual kernel, flash) opts in on the current device only:
    after calls on the first card, the same calls on the second (the first
    still current) must launch and agree there too."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    # test_cuda_encode_quant_and_decode_wire_match_plain's inputs at a split edge
    M0, G0 = (torch.from_numpy(x) for x in _inputs(1025, 64, 260, 2, seed=260))
    qkv0 = _qkv(1, 128, 128, 4, 1, 256, torch.float32, "cpu", seed=5)
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        M, G = M0.to(dev), G0.to(dev)
        A, E = ops.encode(M, G)
        rA, rE = tref.encode_ref(M, G)
        codes, scales, Eq = ops.encode_quant(M, G)
        rc, rs, _ = tref.encode_quant_ref(M, G)
        Ghat, wire_hat = ops.decode(M, rA.contiguous()), ops.decode_wire(M, codes, scales)
        q, k, v = (x.to(dev) for x in qkv0)
        out = ops.flash_attention(q, k, v, causal=True, window=64)
        plain = tref.flash_attention_ref(q, k, v, causal=True, window=64)
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0
        assert A.device == E.device == codes.device == Eq.device == out.device == dev
        assert Ghat.device == wire_hat.device == dev
        gn = float(G.norm())
        assert float((A - rA).norm()) <= RTOL * gn and float((E - rE).norm()) <= RTOL * gn
        assert _code_flips_ok(torch.matmul(M.mT, G), rs, codes, rc)
        torch.testing.assert_close(scales, rs, rtol=1e-6, atol=0)
        ship = tref.coeff_dequant_ref(codes, scales)
        assert float((Eq - (G - M @ ship)).norm()) <= RTOL * gn
        assert float((Ghat - tref.decode_ref(M, rA)).norm()) <= RTOL * gn
        assert float((wire_hat - tref.decode_ref(M, ship)).norm()) <= RTOL * gn
        torch.testing.assert_close(out, plain, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal,window,dtype", [
    (4, 256, 256, 32, 4, 64, True, 0, torch.float32),       # TinyLlama's eval shape
    (2, 1024, 1024, 4, 1, 256, True, 512, torch.float32),   # Gemma3-1B's, local layers
    (2, 1024, 1024, 4, 1, 256, True, 0, torch.float32),     # and global
    (2, 128, 128, 4, 1, 64, False, 0, torch.float32),
    (1, 192, 192, 6, 3, 32, True, 0, torch.float32),
    (1, 256, 256, 8, 8, 16, True, 64, torch.float32),
    (1, 70, 90, 4, 2, 40, True, 20, torch.float32),          # ragged lengths, odd hd
    (1, 100, 30, 4, 2, 32, True, 8, torch.float32),          # rows past Skv + window: no key
    (1, 128, 128, 4, 2, 32, True, 0, torch.bfloat16),
    (2, 256, 256, 4, 1, 256, True, 64, torch.bfloat16),
    (1, 192, 192, 8, 2, 64, True, 0, torch.float32),         # split edge: a one-tile chunk
    (1, 320, 200, 4, 2, 64, True, 0, torch.float32),         # Sq > Skv, split
    (1, 100, 300, 4, 1, 128, False, 0, torch.float32),       # Sq < Skv, split
    (1, 600, 300, 4, 2, 32, True, 16, torch.float32),        # split rows that see no key
])
def test_cuda_flash_matches_plain(cuda, B, Sq, Skv, H, KV, hd, causal, window, dtype):
    q, k, v = _qkv(B, Sq, Skv, H, KV, hd, dtype, cuda, seed=Sq + hd)
    n = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    plain = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == n + 1
    assert out.dtype == dtype and out.shape == q.shape
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(out.float(), plain.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal,window", [
    (2, 1024, 1024, 4, 1, 256, True, 0), (1, 600, 300, 4, 2, 32, True, 16)])
def test_cuda_flash_gives_the_same_bits_twice(cuda, B, Sq, Skv, H, KV, hd, causal, window):
    """The partials merge in chunk order (no atomics)."""
    q, k, v = _qkv(B, Sq, Skv, H, KV, hd, torch.float32, cuda, seed=Sq)
    a = ops.flash_attention(q, k, v, causal=causal, window=window)
    b = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _same_bits(a, b)


def test_cuda_flash_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(1, 64, 64, 4, 2, 32, torch.float32, cuda)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, k[:, :, :1].expand(1, 64, 3, 32).contiguous(),
                                        v[:, :, :1].expand(1, 64, 3, 32).contiguous())
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q.transpose(1, 2), k, v)     # non-contiguous
    with pytest.raises(ValueError):
        flash_attention.flash_attention(*(torch.zeros(1, 8, 1, 320, device=cuda)
                                          for _ in range(3)))         # hd > 256
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, k.cpu(), v)


def test_cuda_eval_forward_runs_flash_and_training_does_not(cuda):
    arch = get_config("gemma3-1b").reduced()
    params = model.init_params(arch, prng.PRNGKey(0, cuda))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, arch.vocab, (2, 32))).to(cuda)
             for k in ("tokens", "labels")}
    ops.reset_launch_counts()
    with torch.no_grad():
        logits = model.forward(arch, params, batch)
    assert ops.launch_counts()["flash_attention"] == arch.n_layers
    with torch.no_grad():
        cpu = model.forward(arch, {p: x.cpu() for p, x in params.items()},
                            {k: x.cpu() for k, x in batch.items()})
    torch.testing.assert_close(logits.cpu(), cpu, rtol=1e-4, atol=1e-4)
    ops.reset_launch_counts()
    grads = torch.func.grad(lambda p: model.loss_fn(arch, p, batch))(params)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 0
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


@pytest.mark.parametrize("method,kw,atol", [
    ("gradestc", dict(n_clients=5, participation=0.6), 1e-5),    # n_sel 3 padded to 4
    ("svdfed", dict(method_kw={"wire_dtype": "int8"}), 1e-5),
    ("fedpaq", {}, 5e-4),
])
def test_cuda_sharded_engine_on_two_cards_over_nccl(cuda, method, kw, atol):
    """The sharded fused engine started by ``run_fl`` itself: NCCL, rank r
    on card r, against the single-device fused run on card 0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from repro_torch.fl import simulation as tsim
    from repro_torch.models.config import ArchConfig

    arch = ArchConfig(name="sharded-card", family="dense", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=256, vocab=64, dtype="float32")
    cfg = {**dict(method=method, rounds=4, n_clients=4, local_steps=1, batch=2, seq=16,
                  eval_every=2, seed=1, arch=arch, engine="fused", scan_rounds=4), **kw}
    single = tsim.run_fl(tsim.FLConfig(**cfg))
    shard = tsim.run_fl(tsim.FLConfig(devices=2, **cfg))
    assert shard.extra["devices"] == 2 and shard.extra["backend"] == "nccl"
    assert shard.extra["collectives"] == cfg["rounds"] * (1 if method == "fedpaq" else 2)
    assert shard.ledger.per_round_uplink_bits == single.ledger.per_round_uplink_bits
    assert shard.ledger.downlink_bits == single.ledger.downlink_bits
    assert shard.extra.get("sum_d") == single.extra.get("sum_d")
    assert shard.eval_rounds == single.eval_rounds == [0, 2, 3]
    np.testing.assert_allclose(shard.eval_loss, single.eval_loss, rtol=0, atol=atol)


def test_cuda_decode_matches_cpu(cuda):
    """Gemma3-1B reduced (window 16) decoded for 24 steps on the card and
    on the CPU: logits within 1e-5 of their largest magnitude (TF32 off),
    the cache written in place on the card, no flash launch."""
    cfg = get_config("gemma3-1b").reduced()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", cuda):
            key = prng.PRNGKey(0, dev)
            params = model.init_params(cfg, key)
            tokens = prng.randint(key, (2, 24), 0, cfg.vocab)
            cache = model.init_cache(cfg, 2, 32, device=dev)
            k_ptr = cache.k.data_ptr()
            ops.reset_launch_counts()
            steps = []
            for t in range(24):
                lg, cache = model.decode_step(cfg, params, cache, tokens[:, t:t + 1])
                steps.append(lg[:, 0])
            assert cache.k.data_ptr() == k_ptr and int(cache.length) == 24
            assert ops.launch_counts()["flash_attention"] == 0
            out[str(dev)] = torch.stack(steps, 1).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    err = float((out["cuda"] - out["cpu"]).abs().max())
    assert err <= 1e-5 * float(out["cpu"].abs().max())


def test_cuda_randint_and_categorical_match_cpu(cuda):
    """The serve driver's draws on the card: the same bits as the CPU's,
    which equal jax's (``tests/test_torch_draws.py``)."""
    for seed in (0, 7):
        kc, kg = prng.PRNGKey(seed, "cpu"), prng.PRNGKey(seed, cuda)
        for shape, hi in (((4, 16), 32000), ((3, 5), 262144), ((7,), 128256)):
            assert torch.equal(prng.randint(kg, shape, 0, hi).cpu(),
                               prng.randint(kc, shape, 0, hi))
        logits = torch.randn(4, 262144, generator=torch.Generator().manual_seed(seed)) * 3
        assert torch.equal(prng.gumbel(kg, (4, 262144)).cpu(), prng.gumbel(kc, (4, 262144)))
        assert torch.equal(prng.categorical(kg, logits.to(cuda)).cpu(),
                           prng.categorical(kc, logits))


def test_cuda_checkpoint_roundtrip(cuda, tmp_path):
    """CUDA tensors (bf16, f32, an int32 step) saved and restored onto the
    card, bit for bit."""
    from repro_torch import checkpoint
    from repro_torch.optim import adam

    gen = torch.Generator().manual_seed(0)
    params = {"layers/w": torch.randn(3, 64, 32, generator=gen).to(cuda, torch.bfloat16),
              "ln_f": torch.randn(32, generator=gen).to(cuda)}
    init, update = adam(1e-3)
    params, state = update({k: v * 0.5 for k, v in params.items()}, init(params), params)
    tree = {"params": params, "opt": state}
    checkpoint.save(str(tmp_path), 1, tree)
    back = checkpoint.restore(str(tmp_path), 1, tree)
    for k, v in params.items():
        assert back["params"][k].is_cuda and back["params"][k].dtype == v.dtype
        assert torch.equal(back["params"][k], v), k
    for i in (0, 1):
        for k, v in state.slots[i].items():
            assert torch.equal(back["opt"].slots[i][k], v), (i, k)
    assert back["opt"].step.is_cuda and int(back["opt"].step) == 1


def test_cuda_moe_ffn_under_vmap_has_no_host_sync(cuda):
    """granite-moe-1b-a400m reduced's MoE FFN and its weights' gradient
    under ``torch.func.vmap`` over 3 clients on the card (the fused engine's
    local training), with torch's sync debug mode set to raise: no host
    sync (the stable sort, the comparison one-hots and the capacity cumsum
    stay on the device); each client's output and router gradient within
    1e-5 of their max |value| of the CPU's (TF32 off), the routing integers
    equal."""
    from repro_torch.models import moe

    cfg = get_config("granite-moe-1b-a400m").reduced()
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    gen = torch.Generator().manual_seed(0)
    shapes = {"router": (D, E), "moe_wgate": (E, D, F), "moe_win": (E, D, F),
              "moe_wout": (E, F, D)}
    w = {k: torch.randn(s, generator=gen) / math.sqrt(s[-2]) for k, s in shapes.items()}
    x = torch.randn(3, 2, 24, D, generator=gen)
    wc, xc = {k: v.to(cuda) for k, v in w.items()}, x.to(cuda)

    def loss(ww, a):
        return (moe.moe_ffn(cfg, a, ww) ** 2).sum()

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = torch.func.vmap(lambda a: moe.moe_ffn(cfg, a, wc))(xc)
            grads = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(wc, xc)
            routes = torch.func.vmap(lambda a: moe.route(cfg, a.reshape(-1, D), wc["router"]))(xc)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for c in range(3):
        want = moe.moe_ffn(cfg, x[c], w)
        assert float((out[c].cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
        g = torch.func.grad(loss)(w, x[c])["router"]
        assert float((grads["router"][c].cpu() - g).abs().max()) <= 1e-5 * float(g.abs().max())
        for got, ref in zip(routes[1:], moe.route(cfg, x[c].reshape(-1, D), w["router"])[1:]):
            assert torch.equal(got[c].cpu(), ref)
