"""Port vs reference: the unpacked block quantizer, coeff_dequant, and the
quantizer wire at the widths the fused kernels do not take.

On CPU tensors the port's ``ops.block_quantize``/``block_dequantize`` run
the plain versions of the ``block_quant``/``block_dequant`` kernels; they
are held bit for bit against the reference's ``ops.block_quantize``/
``block_dequantize`` with ``use_kernel=False`` (same key, so the same
uniforms) and against ``block_quant_pallas``/``block_dequant_pallas`` in
interpret mode on the same uniforms as operands.  ``coeff_dequant`` against
the reference's compiled ``coeff_dequant_ref`` and ``coeff_dequant_pallas``
in interpret mode.  The split route of ``ops.block_quant_wire`` (bits 3, 5,
6, 7 at 512-value blocks, and bits 6 and 4 at 256: block quantizer, bias,
integer pack) against ``quant_pack_ref``/``unpack_dequant_ref`` of both
packages and the reference's dispatcher.  All exact.  The CUDA kernels run
only on the card: their tests are in ``test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.quant import block_dequant_pallas, block_quant_pallas  # noqa: E402
from repro.kernels.wire import coeff_dequant_pallas  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from test_torch_quant_wire import _bits, _grad  # noqa: E402


@pytest.mark.parametrize("n,block,bits", [(4097, 512, 8), (3000, 256, 6), (1000, 128, 3)])
def test_block_quantize_exact(n, block, bits):
    g = _grad(n, seed=n + bits)
    key, tkey = jax.random.PRNGKey(n), prng.PRNGKey(n, "cpu")
    jc, js, jpad = jops.block_quantize(jnp.asarray(g), key, block=block, bits=bits,
                                       use_kernel=False)
    tc, ts, tpad = ops.block_quantize(torch.from_numpy(g), tkey, block=block, bits=bits)
    assert jpad == tpad == (-n) % block and tc.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(_bits(js), _bits(ts))
    # the TPU kernels in interpret mode, on the same uniforms as operands
    n_p = n + tpad
    u = prng.uniform(tkey, (n_p,))
    rows = n_p // block
    pc, ps = block_quant_pallas(jnp.asarray(np.pad(g, (0, tpad))), jnp.asarray(u.numpy()),
                               block=block, bits=bits, block_rows=rows, interpret=True)
    np.testing.assert_array_equal(np.asarray(pc), tc.numpy())
    np.testing.assert_array_equal(_bits(ps), _bits(ts))
    # and back
    jd = jops.block_dequantize(jc, js, jpad, block=block, bits=bits, use_kernel=False)
    td = ops.block_dequantize(tc, ts, tpad, block=block, bits=bits)
    assert td.shape == (n,) and td.dtype == torch.float32
    np.testing.assert_array_equal(_bits(jd), _bits(td))
    pd = block_dequant_pallas(jc, js, block=block, bits=bits, block_rows=rows, interpret=True)
    np.testing.assert_array_equal(_bits(np.asarray(pd)[:n]), _bits(td))
    if bits != 6:
        return
    # a bf16 output, rounded once from f32
    pb = block_dequant_pallas(jc, js, block=block, bits=bits, block_rows=rows, interpret=True,
                              out_dtype=jnp.bfloat16)
    tb = ops.block_dequantize(tc, ts, tpad, block=block, bits=bits, out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(pb).view(np.int16)[:n],
                                  tb.view(torch.int16).numpy())


@pytest.mark.parametrize("k,m", [(8, 1024), (5, 700), (64, 2048)])
def test_coeff_dequant_exact(k, m):
    rng = np.random.default_rng(m)
    codes = rng.integers(-127, 128, size=(k, m)).astype(np.int8)
    scales = (rng.standard_t(3, size=(k, -(-m // 512))) ** 2 * 1e-3).astype(np.float32)
    scales[0, 0] = 1e-12
    out = ops.coeff_dequant(torch.from_numpy(codes), torch.from_numpy(scales))
    jr = jax.jit(jref.coeff_dequant_ref)(jnp.asarray(codes), jnp.asarray(scales))
    np.testing.assert_array_equal(_bits(jr), _bits(out))
    if m % 512 == 0:
        jp = coeff_dequant_pallas(jnp.asarray(codes), jnp.asarray(scales), interpret=True)
        np.testing.assert_array_equal(_bits(jp), _bits(out))
    # a leading stack axis, as the card takes it
    stacked = ops.coeff_dequant(torch.from_numpy(np.stack([codes, -codes])),
                                torch.from_numpy(np.stack([scales, scales])))
    np.testing.assert_array_equal(_bits(stacked[0]), _bits(out))


@pytest.mark.parametrize("bits,block", [(3, 512), (5, 512), (6, 512), (7, 512), (6, 256),
                                        (4, 256)])
def test_split_wire_route_exact(bits, block):
    """The route the card takes for these widths, composed on the CPU: words,
    scales and reconstruction equal both packages' oracles and the
    reference's dispatcher, at a ragged n with an all-zero row."""
    n = 4097
    g = _grad(n, seed=bits * block)
    key, tkey = jax.random.PRNGKey(bits), prng.PRNGKey(bits, "cpu")
    tw, ts, tpad = ops.block_quant_wire(torch.from_numpy(g), tkey, bits=bits, block=block)
    n_p = n + tpad
    assert tw.dtype == torch.int32 and tw.shape == (-(-n_p // (32 // bits)),)
    gp = torch.nn.functional.pad(torch.from_numpy(g), (0, tpad))
    rw, rs = ref.quant_pack_ref(gp, prng.uniform(tkey, (n_p,)), block, bits)
    np.testing.assert_array_equal(_bits(tw), _bits(rw.to(torch.int32)))
    np.testing.assert_array_equal(_bits(ts), _bits(rs))
    jw, js, jpad = jops.block_quant_wire(jnp.asarray(g), key, bits=bits, block=block)
    assert jpad == tpad
    np.testing.assert_array_equal(_bits(jw), _bits(tw))
    np.testing.assert_array_equal(_bits(js), _bits(ts))
    tr = ops.block_dequant_wire(tw, ts, tpad, bits=bits, block=block)
    assert tr.shape == (n,)
    np.testing.assert_array_equal(_bits(tr), _bits(ref.unpack_dequant_ref(rw, rs, n_p, block,
                                                                          bits)[:n]))
    jr = jops.block_dequant_wire(jw, js, jpad, bits=bits, block=block)
    np.testing.assert_array_equal(_bits(jr), _bits(tr))
    np.testing.assert_array_equal(
        _bits(tr), _bits(ops.quantize_update(torch.from_numpy(g), tkey, bits=bits, block=block,
                                             use_pallas=True)))


def test_wire_refuses_widths_outside_2_to_8():
    g = torch.zeros(100)
    key = prng.PRNGKey(0, "cpu")
    for bits in (1, 9):
        with pytest.raises(ValueError):
            ops.block_quant_wire(g, key, bits=bits)
