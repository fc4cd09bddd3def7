"""Port vs reference: flash attention.

The port's ``ops.flash_attention`` on CPU tensors (the plain version, GQA
attention over repeated K/V, ``ref.flash_attention_ref``) against the TPU
kernel ``flash_attention_pallas`` in interpret mode and against the
reference's plain ``layers.attention`` over repeated K/V, on the same
seeded numpy inputs: the JAX tests' four cases and their bf16 case
(``tests/test_kernels.py::TestFlashAttention``), plus Gemma3's head dim 256
with a sliding window.  Tolerances are the JAX tests': rtol = atol = 1e-4
in f32, 5e-2 with bf16 inputs.  The CUDA kernel runs only on the card: its
test is in ``test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import layers  # noqa: E402
from repro.models.layers import repeat_kv  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 5e-2

#: the reference's plain attention, compiled (eager dispatch costs seconds)
attention = jax.jit(layers.attention, static_argnames=("causal", "window", "q_chunk",
                                                       "softmax_scale", "unroll"))


def _qkv(B, Sq, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sq, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Sq, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("B,Sq,H,KV,hd,causal,window", [
    (2, 128, 4, 2, 32, True, 0),
    (1, 256, 8, 8, 16, True, 64),
    (2, 128, 4, 1, 64, False, 0),
    (1, 192, 6, 3, 32, True, 0),
    (1, 128, 4, 1, 256, True, 48),
])
def test_flash_matches_reference(B, Sq, H, KV, hd, causal, window):
    q, k, v = _qkv(B, Sq, H, KV, hd, seed=Sq + hd)
    out = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                              window=window)
    assert out.shape == (B, Sq, H, hd) and out.dtype == torch.float32
    kern = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=window, block_q=64, block_kv=64,
                                  interpret=True)
    plain = attention(jnp.asarray(q), repeat_kv(jnp.asarray(k), H // KV),
                      repeat_kv(jnp.asarray(v), H // KV), causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(plain), rtol=F32_TOL, atol=F32_TOL)


def test_flash_bf16():
    q, k, v = _qkv(1, 128, 4, 2, 32, seed=7)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    out = ops.flash_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert out.dtype == torch.bfloat16
    kern = flash_attention_pallas(jq, jk, jv, block_q=64, block_kv=64, interpret=True)
    plain = attention(jq, repeat_kv(jk, 2), repeat_kv(jv, 2))
    got = out.float().numpy()
    np.testing.assert_allclose(got, np.asarray(kern, np.float32), rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(got, np.asarray(plain, np.float32), rtol=BF16_TOL, atol=BF16_TOL)


def test_flash_scale_and_ragged_lengths():
    """An explicit softmax scale, and Sq != Skv off the TPU kernel's tiling
    (its plain reference takes any lengths)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 70, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((1, 90, 2, 32)).astype(np.float32) for _ in range(2))
    out = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                              window=20, softmax_scale=0.1)
    plain = attention(jnp.asarray(q), repeat_kv(jnp.asarray(k), 2), repeat_kv(jnp.asarray(v), 2),
                      causal=True, window=20, softmax_scale=0.1)
    np.testing.assert_allclose(out.numpy(), np.asarray(plain), rtol=F32_TOL, atol=F32_TOL)
