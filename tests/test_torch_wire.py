"""Port vs reference: the coefficient wire's plain versions.

The port's ``kernels/ref.py`` wire functions (what ``kernels.ops`` runs on a
CPU tensor) against the reference's oracles (``repro.kernels.ref`` and
``repro.kernels.ops`` with ``use_kernel=False``) on the same seeded numpy
inputs.  Integer results and the deterministic quantizer are exact:
coeff_quant codes, scales and shipped values, coeff_dequant, 16-bit code
packing and the bf16 wire words.  Through a GEMM (encode_quant,
decode_wire) codes are equal except where the reference's ``A/scale*127``
lies within 1e-4 of a half-integer (there they differ by at most 1; one
such flip in these cases); E and Ghat are held to ``1e-5 ||G||_F`` against
the reference evaluated on the same shipped coefficients (measured: 0.0),
E to ``1e-3 ||G||_F`` against the reference's own E across such flips
(measured: 4.8e-5), and M = 0 is exact.
The CUDA kernels run only on the card: their tests are in
``test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RTOL = 1e-5
HALF_MARGIN = 1e-4


def _coeffs(k, m, seed=0, L=None):
    rng = np.random.default_rng(seed)
    lead = () if L is None else (L,)
    # heavy-tailed rows, so scales vary across blocks
    return (rng.standard_t(3, size=lead + (k, m)) * 10.0 ** rng.uniform(-4, 1, lead + (k, 1))
            ).astype(np.float32)


def _j(x):
    return np.asarray(x)


@pytest.mark.parametrize("k", [4, 64])
@pytest.mark.parametrize("m", [512, 700, 1280])
def test_coeff_quant_exact(k, m):
    A = _coeffs(k, m, seed=k + m)
    jc, js, jp = jax.jit(jref.coeff_quant_ref)(jnp.asarray(A))
    tc, ts, tp = ops.coeff_quant(torch.from_numpy(A))
    assert tc.dtype == torch.int8 and tc.shape == (k, m) and ts.shape == (k, -(-m // 512))
    np.testing.assert_array_equal(_j(jc), tc.numpy())
    np.testing.assert_array_equal(_j(js).view(np.int32), ts.numpy().view(np.int32))
    np.testing.assert_array_equal(_j(jp).view(np.int32), tp.numpy().view(np.int32))
    # the reference's dispatcher with kernels off is the same oracle
    np.testing.assert_array_equal(_j(jops.coeff_quant(jnp.asarray(A), use_kernel=False)[2]),
                                  tp.numpy())
    deq = ref.coeff_dequant_ref(tc, ts)
    np.testing.assert_array_equal(_j(jref.coeff_dequant_ref(jc, js)).view(np.int32),
                                  deq.numpy().view(np.int32))
    torch.testing.assert_close(deq, tp, rtol=0, atol=0)


def test_coeff_quant_edge_cases_exact():
    """An all-zero row block (scale 1e-12, codes 0), exact .5 ties (round
    half to even) and the row maxima (codes +-127, the clip bound)."""
    A = np.zeros((3, 1100), np.float32)
    # row 0: scale 127 in every block, with every half-integer whose
    # f32 a / 127 * 127 is exactly the tie
    cand = np.arange(-126.5, 127.0, 1.0, dtype=np.float32)
    ties = cand[(cand / np.float32(127.0)) * np.float32(127.0) == cand]
    assert len(ties) >= 20
    A[0, :len(ties)] = ties
    A[0, 600:600 + len(ties)] = ties
    A[0, [500, 1099]] = 127.0
    A[0, 1000] = -127.0
    # row 1: block 0 all zero, block 1 random, block 2 (ragged) all zero
    A[1, 512:1024] = np.random.default_rng(1).normal(size=512)
    # row 2: tiny and huge values
    A[2, :512] = np.float32(1e-30) * np.arange(512)
    A[2, 512:] = np.float32(3e30) * np.cos(np.arange(588))
    jc, js, jp = jax.jit(jref.coeff_quant_ref)(jnp.asarray(A))
    tc, ts, tp = ops.coeff_quant(torch.from_numpy(A))
    np.testing.assert_array_equal(_j(jc), tc.numpy())
    np.testing.assert_array_equal(_j(js).view(np.int32), ts.numpy().view(np.int32))
    np.testing.assert_array_equal(_j(jp).view(np.int32), tp.numpy().view(np.int32))
    codes = tc.numpy().astype(np.int64)
    want = np.round(ties).astype(np.int64)              # numpy rounds half to even
    np.testing.assert_array_equal(codes[0, :len(ties)], want)
    assert (np.abs(want - ties) == 0.5).all() and (want % 2 == 0).all()
    assert codes[0, 500] == 127 and codes[0, 1099] == 127 and codes[0, 1000] == -127
    assert ts[1, 0] == np.float32(1e-12) and ts[1, 2] == np.float32(1e-12)
    assert not codes[1, :512].any() and not codes[1, 1024:].any()


def test_coeff_quant_stack_axis():
    A = _coeffs(8, 700, seed=3, L=3)
    tc, ts, tp = ops.coeff_quant(torch.from_numpy(A))
    jc, js, jp = jax.vmap(jref.coeff_quant_ref)(jnp.asarray(A))
    np.testing.assert_array_equal(_j(jc), tc.numpy())
    np.testing.assert_array_equal(_j(js), ts.numpy())
    np.testing.assert_array_equal(_j(jp), tp.numpy())


@pytest.mark.parametrize("bits,n", [(16, 7), (16, 1024), (8, 13), (4, 9), (1, 70)])
def test_pack_unpack_codes_exact(bits, n):
    rng = np.random.default_rng(bits * 100 + n)
    codes = rng.integers(0, 1 << bits, size=(3, n)).astype(np.uint32)
    jw = _j(jref.pack_codes_ref(jnp.asarray(codes), bits))
    tw = ref.pack_codes_ref(torch.from_numpy(codes.astype(np.int64)), bits)
    np.testing.assert_array_equal(jw.astype(np.int64), tw.numpy())
    np.testing.assert_array_equal(ref.unpack_codes_ref(tw, bits, n).numpy(), codes)


@pytest.mark.parametrize("n", [700, 1280, 9])
def test_bf16_wire_words_exact(n):
    x = _coeffs(5, n, seed=n)
    x[0, :4] = [0.0, -0.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8]   # ties to even
    jw = _j(jref.bf16_pack_ref(jnp.asarray(x)))
    tw = ref.bf16_pack_ref(torch.from_numpy(x))
    assert tw.shape == (5, -(-n // 2))
    np.testing.assert_array_equal(jw.astype(np.int64), tw.numpy())
    back = ref.bf16_unpack_ref(tw, n)
    np.testing.assert_array_equal(_j(jref.bf16_unpack_ref(jnp.asarray(jw), n)).view(np.int32),
                                  back.numpy().view(np.int32))
    rt = ops.coeff_roundtrip(torch.from_numpy(x), "bf16")
    jrt = jops.coeff_roundtrip(jnp.asarray(x), "bf16")
    np.testing.assert_array_equal(_j(jrt).view(np.int32), rt.numpy().view(np.int32))
    xt = torch.from_numpy(x)
    assert ops.coeff_roundtrip(xt, "f32") is xt                # the f32 wire is exact
    with pytest.raises(ValueError):
        ops.coeff_roundtrip(xt, "int4")


def _basis(l, k, m, seed, L=None):
    rng = np.random.default_rng(seed)
    lead = () if L is None else (L,)
    M = np.linalg.qr(rng.normal(size=lead + (l, k)))[0].astype(np.float32)
    G = rng.normal(size=lead + (l, m)).astype(np.float32)
    return M, G


@pytest.mark.parametrize("l,k,m", [(256, 16, 512), (384, 64, 700), (128, 4, 1280)])
def test_encode_quant_and_decode_wire_vs_reference(l, k, m):
    M, G = _basis(l, k, m, seed=l + k + m)
    jc, js, jE = jax.jit(jref.encode_quant_ref)(jnp.asarray(M), jnp.asarray(G))
    tc, ts, tE = ops.encode_quant(torch.from_numpy(M), torch.from_numpy(G))
    gn = float(np.linalg.norm(G))
    # codes: equal except where the reference sits on a rounding boundary
    A = np.asarray(jnp.asarray(M).T @ jnp.asarray(G))
    x = A / np.repeat(_j(js), 512, axis=1)[:, :m] * np.float32(127.0)
    near_half = np.abs(np.abs(x - np.floor(x)) - 0.5) < HALF_MARGIN
    diff = np.abs(_j(jc).astype(np.int64) - tc.numpy().astype(np.int64))
    assert diff.max() <= 1 and not (diff.astype(bool) & ~near_half).any()
    np.testing.assert_allclose(ts.numpy(), _j(js), rtol=1e-6)
    # E against the reference on the port's shipped coefficients
    ship = jref.coeff_dequant_ref(jnp.asarray(tc.numpy()), jnp.asarray(ts.numpy()))
    E_ref = np.asarray(jnp.asarray(G) - jnp.asarray(M) @ ship)
    assert np.linalg.norm(E_ref - tE.numpy()) <= RTOL * gn
    assert np.linalg.norm(_j(jE) - tE.numpy()) <= 1e-3 * gn    # even across code flips
    # decode_wire on the same codes and scales
    tO = ops.decode_wire(torch.from_numpy(M), tc, ts)
    jO = jops.decode_wire(jnp.asarray(M), jnp.asarray(tc.numpy()), jnp.asarray(ts.numpy()),
                          use_kernel=False)
    assert np.linalg.norm(_j(jO) - tO.numpy()) <= RTOL * gn
    assert tO.shape == (l, m) and tO.dtype == torch.float32


def test_encode_quant_zero_basis_exact_and_stacked():
    M, G = _basis(128, 8, 700, seed=5, L=2)
    Mt, Gt = torch.from_numpy(M), torch.from_numpy(G)
    c0, s0, E0 = ops.encode_quant(torch.zeros_like(Mt), Gt)
    assert not c0.any() and bool((s0 == np.float32(1e-12)).all()) and torch.equal(E0, Gt)
    assert not ops.decode_wire(torch.zeros_like(Mt), c0, s0).any()
    c, s, E = ops.encode_quant(Mt, Gt)
    for i in range(2):
        ci, si, Ei = ops.encode_quant(Mt[i], Gt[i])
        assert (c[i].long() - ci.long()).abs().max() <= 1
        torch.testing.assert_close(E[i], Ei, rtol=0, atol=1e-4)
        torch.testing.assert_close(s[i], si, rtol=1e-6, atol=0)
