"""Port vs reference: the quantizer wire's plain versions and dispatchers.

The port's ``kernels/ref.py`` sign and block-quantizer wire functions and
the ``kernels.ops`` dispatchers on CPU tensors, against the reference's
oracles (``repro.kernels.ref``, ``repro.kernels.ops`` with
``use_kernel=False``, compiled as its codecs run them) on the same seeded
numpy inputs and the same keys.  All exact: sign words, row sums, the
mean-|g| scale (the compiled reference multiplies by the single-rounded
reciprocal of n, which the port mirrors), reconstructions, quantizer words,
scales, uniforms and both ``quantize_update`` paths.  One case also runs
the reference's Pallas kernels in interpret mode.  The CUDA kernels run
only on the card: their tests are in ``test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _grad(n, seed=0, lead=()):
    """Heavy-tailed values with exact zeros, -0.0 and an all-zero 512 row."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_t(3, size=lead + (n,)) * 1e-3).astype(np.float32)
    g[..., ::7] = 0.0
    g[..., 3::11] = -0.0
    if n >= 1024:
        g[..., 512:1024] = 0.0
    return g


def _bits(x):
    """int32 bit patterns of a jax or torch array, for exact comparison."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x.astype(np.int32)


jit_sign_pack = jax.jit(jref.sign_pack_ref)
jit_mean_abs = jax.jit(jref.mean_abs_ref)
jit_pairwise = jax.jit(jref.pairwise_sum)


@pytest.mark.parametrize("n", [1, 31, 512, 1000, 4097, 70_000])
def test_sign_wire_exact(n):
    g = _grad(n, seed=n)
    jw, js = jops.sign_wire(jnp.asarray(g), use_kernel=False)
    tg = torch.from_numpy(g)
    tw, ts = ops.sign_wire(tg)
    assert tw.dtype == torch.int32 and tw.shape == (-(-n // 32),) and ts.shape == ()
    np.testing.assert_array_equal(_bits(jw), _bits(tw))
    np.testing.assert_array_equal(_bits(js), _bits(ts))
    # the plain version's words and scale (the dispatcher's CPU path)
    pw, ps = ref.sign_pack_ref(tg)
    np.testing.assert_array_equal(_bits(jw), _bits(pw.to(torch.int32)))
    np.testing.assert_array_equal(_bits(js), _bits(ps))
    # the per-row partials the kernel emits (first stage of the tree)
    pad = (-n) % 512
    a = np.pad(np.abs(g), (0, pad)).reshape(-1, 512)
    np.testing.assert_array_equal(_bits(jit_pairwise(jnp.asarray(a))),
                                  _bits(ref.pairwise_sum(torch.from_numpy(a))))
    ju = jops.sign_unwire(jw, js, n, use_kernel=False)
    tu = ops.sign_unwire(tw, ts, n)
    np.testing.assert_array_equal(_bits(ju), _bits(tu))
    # a zero (and -0.0) ships as +scale
    zeros = g == 0
    assert bool((tu.numpy()[zeros] == ts.numpy()).all())


def test_mean_abs_follows_the_compiled_reference():
    """At n = 2^24 + 3 (no power of two, and not an f32 integer) the scale
    equals the compiled reference's ``pairwise_sum(rows) * f32(1 / f32(n))``
    bit for bit; stacked inputs give one scale per row."""
    n = (1 << 24) + 3
    g = (np.random.default_rng(7).normal(size=n) * 1e-2).astype(np.float32)
    np.testing.assert_array_equal(_bits(jit_mean_abs(jnp.asarray(g))),
                                  _bits(ref.mean_abs_ref(torch.from_numpy(g))))
    g2 = _grad(3000, seed=3, lead=(3,))
    np.testing.assert_array_equal(_bits(jit_mean_abs(jnp.asarray(g2))),
                                  _bits(ref.mean_abs_ref(torch.from_numpy(g2))))
    jw, js = jit_sign_pack(jnp.asarray(g2))
    tw, ts = ref.sign_pack_ref(torch.from_numpy(g2))
    np.testing.assert_array_equal(_bits(jw), _bits(tw.to(torch.int32)))
    np.testing.assert_array_equal(_bits(jref.sign_unpack_ref(jw[0], js[0], 3000)),
                                  _bits(ref.sign_unpack_ref(tw[0], ts[0], 3000)))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quant_wire_exact(bits):
    """Words, scales and reconstruction of the block quantizer, on the same
    uniforms and through the dispatchers on the same key, at a ragged n with
    an all-zero row; the padded tail ships the code ``levels`` (value 0)."""
    n = 4097
    g = _grad(n, seed=bits * n)
    n_p = n + (-n) % 512
    gp = np.pad(g, (0, n_p - n))
    u = np.random.default_rng(n).uniform(size=n_p).astype(np.float32)
    jw, js = jax.jit(jref.quant_pack_ref, static_argnums=(2, 3))(jnp.asarray(gp), jnp.asarray(u),
                                                                512, bits)
    tw, ts = ref.quant_pack_ref(torch.from_numpy(gp), torch.from_numpy(u), 512, bits)
    np.testing.assert_array_equal(_bits(jw), _bits(tw.to(torch.int32)))
    np.testing.assert_array_equal(_bits(js), _bits(ts))
    assert float(ts[1]) == np.float32(1e-12)                 # the all-zero row
    levels = int(ref.quant_levels(bits))
    codes = ref.unpack_codes_ref(tw, bits, n_p)
    assert bool((codes[n:] == levels).all())
    jr = jax.jit(jref.unpack_dequant_ref, static_argnums=(2, 3, 4))(jw, js, n_p, 512, bits)
    tr = ref.unpack_dequant_ref(tw, ts, n_p, 512, bits)
    np.testing.assert_array_equal(_bits(jr), _bits(tr))

    key, tkey = jax.random.PRNGKey(n + bits), prng.PRNGKey(n + bits, "cpu")
    jw2, js2, jpad = jops.block_quant_wire(jnp.asarray(g), key, bits=bits, use_kernel=False)
    tw2, ts2, tpad = ops.block_quant_wire(torch.from_numpy(g), tkey, bits=bits)
    assert jpad == tpad == n_p - n and tw2.dtype == torch.int32
    np.testing.assert_array_equal(_bits(jw2), _bits(tw2))
    np.testing.assert_array_equal(_bits(js2), _bits(ts2))
    jr2 = jops.block_dequant_wire(jw2, js2, jpad, bits=bits, use_kernel=False)
    tr2 = ops.block_dequant_wire(tw2, ts2, tpad, bits=bits)
    assert tr2.shape == (n,)
    np.testing.assert_array_equal(_bits(jr2), _bits(tr2))
    np.testing.assert_array_equal(
        _bits(tr2), _bits(ops.quantize_update(torch.from_numpy(g), tkey, bits=bits,
                                              use_pallas=True)))
    # the paper's global quantizer, compiled as the reference's codecs run it
    jq = jax.jit(lambda x, k: jops.quantize_update(x, k, bits=bits))(jnp.asarray(g), key)
    tq = ops.quantize_update(torch.from_numpy(g), tkey, bits=bits, use_pallas=False)
    np.testing.assert_array_equal(_bits(jq), _bits(tq))


def test_uniform_over_the_padded_length_matches_jax():
    for seed, n_p in ((0, 70_144), (5, 512)):
        np.testing.assert_array_equal(
            _bits(jax.random.uniform(jax.random.PRNGKey(seed), (n_p,), jnp.float32)),
            _bits(prng.uniform(prng.PRNGKey(seed, "cpu"), (n_p,))))


def test_reference_kernels_in_interpret_mode_agree():
    """The reference's Pallas kernels (interpret mode) on the same inputs
    give the port's dispatchers' results bit for bit."""
    n, bits = 5000, 8
    g = _grad(n, seed=11)
    jw, js = jops.sign_wire(jnp.asarray(g), use_kernel=True, interpret=True)
    tw, ts = ops.sign_wire(torch.from_numpy(g))
    np.testing.assert_array_equal(_bits(jw), _bits(tw))
    np.testing.assert_array_equal(_bits(js), _bits(ts))
    np.testing.assert_array_equal(
        _bits(jops.sign_unwire(jw, js, n, use_kernel=True, interpret=True)),
        _bits(ops.sign_unwire(tw, ts, n)))
    key, tkey = jax.random.PRNGKey(3), prng.PRNGKey(3, "cpu")
    qw, qs, pad = jops.block_quant_wire(jnp.asarray(g), key, bits=bits, use_kernel=True,
                                        interpret=True)
    tqw, tqs, tpad = ops.block_quant_wire(torch.from_numpy(g), tkey, bits=bits)
    np.testing.assert_array_equal(_bits(qw), _bits(tqw))
    np.testing.assert_array_equal(_bits(qs), _bits(tqs))
    np.testing.assert_array_equal(
        _bits(jops.block_dequant_wire(qw, qs, pad, bits=bits, use_kernel=True, interpret=True)),
        _bits(ops.block_dequant_wire(tqw, tqs, tpad, bits=bits)))


def test_one_bit_quantizer_is_refused():
    with pytest.raises(ValueError):
        ops.block_quant_wire(torch.zeros(10), prng.PRNGKey(0, "cpu"), bits=1)
