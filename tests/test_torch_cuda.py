"""The port on the card: the CUDA kernels against their plain versions, and
the PRNG on CUDA against the same draws on the CPU.

Tolerances: encode/decode, and encode_quant's E and decode_wire's Ghat,
``||kernel - plain||_F <= 1e-5 ||G||_F``; coeff_quant bit for bit;
encode_quant's codes equal except by one where A/scale*127 sits within
1e-4 of a half-integer; M = 0 exact; PRNG draws bit for bit; the sign and
quantizer wire kernels (sign_pack, sign_unpack, quant_pack, unpack_dequant)
bit for bit, at every flat group size of the TinyLlama-width slice and at
ragged sizes.

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
from repro_torch.kernels import ops, wire  # noqa: E402
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


@pytest.mark.parametrize("L,l,m,k", [(2, 1024, 512, 64), (2, 1024, 500, 64), (3, 384, 77, 8)])
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


@pytest.mark.parametrize("L,k,m", [(2, 64, 2048), (2, 64, 2816), (3, 5, 700), (1, 4, 100)])
def test_cuda_coeff_quant_bit_exact(cuda, L, k, m):
    A = _coeffs(L, k, m, seed=m)
    A[0, 0, :512] = 0.0                               # an all-zero block
    A[0, 1, :3] = [127.0, 2.5, -0.5]                  # the max and two ties
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


def _code_flips_ok(A, scales, codes, ref_codes):
    """Codes equal, or one apart where A/scale*127 is within 1e-4 of x.5."""
    m = A.shape[-1]
    x = A / scales.repeat_interleave(512, dim=-1)[..., :m] * 127.0
    near = ((x - x.floor()).abs() - 0.5).abs() < 1e-4
    d = (codes.long() - ref_codes.long()).abs()
    return int(d.max()) <= 1 and not bool(((d > 0) & ~near).any())


@pytest.mark.parametrize("L,l,m,k", [(2, 1024, 512, 64), (2, 4096, 2816, 64), (3, 384, 77, 8),
                                     (1, 200, 1030, 20)])
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


@pytest.mark.parametrize("n", _flat_sizes())
def test_cuda_sign_wire_bit_exact(cuda, n):
    g = torch.from_numpy(_flat(n, seed=n)).to(cuda)
    before = ops.launch_counts()
    words, rowsums = wire.sign_pack(g)
    rw, rs = tref.sign_pack_ref(g)
    pad = (-n) % 512
    rows = tref.pairwise_sum(torch.nn.functional.pad(g.abs(), (0, pad)).reshape(-1, 512))
    assert torch.equal(_u32(words), rw) and _same_bits(rowsums, rows)
    tw, ts = ops.sign_wire(g)
    assert _same_bits(ts, rs) and _same_bits(ts.cpu(), tref.mean_abs_ref(g.cpu()))
    out = wire.sign_unpack(words, ts, n)
    assert _same_bits(out, tref.sign_unpack_ref(rw, rs, n))
    assert bool((out[g == 0] == ts).all())
    after = ops.launch_counts()
    assert after["sign_pack"] == before["sign_pack"] + 2
    assert after["sign_unpack"] == before["sign_unpack"] + 1


@pytest.mark.parametrize("n,bits", [(n, 8) for n in _flat_sizes()] + [(70_001, 2), (70_001, 4),
                                                                     (513, 2), (513, 4)])
def test_cuda_quant_wire_bit_exact(cuda, n, bits):
    g = torch.from_numpy(_flat(n, seed=n + bits)).to(cuda)
    n_p = n + (-n) % 512
    u = prng.uniform(prng.PRNGKey(n, cuda), (n_p,))
    before = ops.launch_counts()
    words, scales = wire.quant_pack(g, u, bits)
    rw, rs = tref.quant_pack_ref(torch.nn.functional.pad(g, (0, n_p - n)), u, 512, bits)
    assert torch.equal(_u32(words), rw) and _same_bits(scales, rs)
    out = wire.unpack_dequant(words, scales, n, bits)
    assert _same_bits(out, tref.unpack_dequant_ref(rw, rs, n_p, 512, bits)[:n])
    after = ops.launch_counts()
    assert after["quant_pack"] == before["quant_pack"] + 1
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
        ops.block_quant_wire(g, key, bits=3)
    with pytest.raises(ValueError):
        ops.block_quant_wire(g, key, block=256)
    with pytest.raises(ValueError):
        wire.quant_pack(g, u[:1000])                        # u not over the padded length
    with pytest.raises(ValueError):
        wire.quant_pack(g, u.cpu())                         # CPU/CUDA mix
    with pytest.raises(ValueError):
        ops.sign_unwire(*wire.sign_pack(g)[:1], torch.ones((), device="cpu"), 1000)
    with pytest.raises(ValueError):
        wire.sign_pack(g[::2])                              # non-contiguous
    with pytest.raises(TypeError):
        wire.sign_pack(g.double())
    with pytest.raises(ValueError):
        ops.quantize_update(g, key, use_pallas=False)       # no plain path on the card
