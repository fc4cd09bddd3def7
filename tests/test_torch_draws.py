"""Port vs reference: the draws of the serve driver.

``prng.randint`` (the prompts) and ``prng.categorical`` (sampling, through
``gumbel``) equal jax 0.9's bit for bit at several shapes, keys and
vocabularies, including spans above 2^16 where jax's uint32 products wrap."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.core import prng  # noqa: E402

SEEDS = [0, 7, 0xC11E47]
#: (shape, minval, maxval): the serve driver's (B, P) prompts at the port's
#: vocabularies, a shifted range, spans above 2^16 (128256: the product
#: 2^16 * 2^16 wraps to 0; 100000 and 262144), an empty range
RANDINT = [((4, 16), 0, 32000), ((2, 8), 0, 1024), ((3, 5), 0, 262144), ((7,), 5, 128256),
           ((64,), 0, 100000), ((5, 3), -3, 3), ((9,), 4, 4)]
#: categorical over (rows, vocab) f32 logits, with a seed each; Gemma3's
#: 262144-token vocabulary at one seed, the others at every seed
CATEGORICAL = [(s, shape) for shape in ((2, 1024), (4, 32000), (1, 5)) for s in SEEDS]
CATEGORICAL.append((0, (3, 262144)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", RANDINT, ids=[f"{s}-{lo}-{hi}" for s, lo, hi in RANDINT])
def test_randint_bits_equal_jax(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))
    got = prng.randint(prng.PRNGKey(seed, "cpu"), shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,shape", CATEGORICAL,
                         ids=[f"{r}x{v}-{s}" for s, (r, v) in CATEGORICAL])
def test_gumbel_and_categorical_bits_equal_jax(seed, shape):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
    logits = (np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)
    g = prng.gumbel(kt, shape).numpy()
    np.testing.assert_array_equal(g.view(np.int32),
                                  np.asarray(jax.random.gumbel(kj, shape)).view(np.int32))
    got = prng.categorical(kt, torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.random.categorical(kj, logits)))
