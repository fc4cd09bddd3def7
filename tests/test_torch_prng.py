"""Port vs reference: the threefry key chains of ``repro_torch.core.prng``.

Keys, fold_in, split, bits, uniforms, permutations, client selection,
codec keys and normals must equal jax's bit for bit (the port mirrors
XLA's f32 ``log``, ``log1p``, ``sqrt`` and ``erf_inv`` on the CPU)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import codecs as jcodecs  # noqa: E402
from repro.fl import simulation as jsim  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.fl import simulation as tsim  # noqa: E402

SEEDS = [7, 0xC11E47]


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_bits_exact(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
    np.testing.assert_array_equal(_np(kj), kt.numpy())
    for d in (0, 5, 123456789, 0xFFFFFFFF):
        np.testing.assert_array_equal(_np(jax.random.fold_in(kj, d)),
                                      prng.fold_in(kt, d).numpy())
    np.testing.assert_array_equal(_np(jax.random.split(kj, 7)), prng.split(kt, 7).numpy())
    np.testing.assert_array_equal(_np(jax.random.bits(kj, (3, 5))),
                                  prng.bits(kt, (3, 5)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_permutation_exact(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(kj, (1024,))),
                                  prng.uniform(kt, (1024,)).numpy())
    for n in (1, 3, 10, 257):
        np.testing.assert_array_equal(np.asarray(jax.random.permutation(kj, n)),
                                      prng.permutation(kt, n).numpy())


def test_batched_keys_match_vmap():
    ks = jax.random.split(jax.random.PRNGKey(3), 4)
    kt = torch.from_numpy(_np(ks))
    np.testing.assert_array_equal(
        _np(jax.vmap(lambda k: jax.random.fold_in(k, 9))(ks)), prng.fold_in(kt, 9).numpy())
    np.testing.assert_array_equal(
        _np(jax.vmap(lambda k: jax.random.split(k, 3))(ks)), prng.split(kt, 3).numpy())
    np.testing.assert_array_equal(
        _np(jax.vmap(lambda k: jax.random.bits(k, (5, 6)))(ks)), prng.bits(kt, (5, 6)).numpy())
    a = prng.normal(kt, (5, 6)).numpy()
    b = np.stack([prng.normal(kt[i], (5, 6)).numpy() for i in range(4)])
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_ulp_bound(seed):
    """Normals bit-equal to jax's (0 ulp) over 200,000 draws per seed; the
    tails (|u| near 1, where erf_inv takes its sqrt branch) included."""
    a = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (200000,), jnp.float32))
    b = prng.normal(prng.PRNGKey(seed, "cpu"), (200000,)).numpy()
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert np.abs(a).max() > 4.0            # the sqrt branch was reached


def test_normal_in_pieces_equals_one_draw(monkeypatch):
    """A draw larger than ``NORMAL_PIECE`` (pieces of 1000 here, the last
    ragged) equals jax's one draw bit for bit, for one key and a batch."""
    monkeypatch.setattr(prng, "NORMAL_PIECE", 1000)
    kj = jax.random.PRNGKey(11)
    a = np.asarray(jax.random.normal(kj, (7, 613), jnp.float32))
    b = prng.normal(prng.PRNGKey(11, "cpu"), (7, 613)).numpy()
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    ks = jax.random.split(kj, 3)
    a = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (2, 1500), jnp.float32))(ks))
    b = prng.normal(torch.from_numpy(_np(ks)), (2, 1500)).numpy()
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_log_and_log1p_match_xla():
    """The port's f32 log/log1p equal XLA's CPU ones bit for bit, over the
    exponent range and the special values."""
    rng = np.random.default_rng(0)
    x = np.concatenate([10.0 ** rng.uniform(-37, 38, 100000),
                        [0.0, 1e-45, np.inf, -1.0, np.nan, 1.0]]).astype(np.float32)
    y = np.concatenate([rng.uniform(-1, 1, 100000), [0.5, -0.5]]).astype(np.float32)
    for fn, tfn, v in ((jnp.log, prng._log_f32, x), (jnp.log1p, prng._log1p_f32, y)):
        want = np.asarray(jax.jit(fn)(v))
        got = tfn(torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
        ok = ~np.isnan(want)
        np.testing.assert_array_equal(want[ok].view(np.int32), got[ok].view(np.int32))


def test_round_client_selection_and_codec_keys_exact():
    for rnd in range(6):
        for n_clients, n_sel in ((10, 3), (4, 4), (7, 5)):
            want = [int(c) for c in np.asarray(
                jsim.select_round_clients(0, rnd, n_clients, n_sel))]
            assert tsim.select_round_clients(0, rnd, n_clients, n_sel) == want
        np.testing.assert_array_equal(_np(jcodecs.round_base_key(5, rnd)),
                                      tcodecs.round_base_key(5, rnd, "cpu").numpy())
    for client, path_idx, L in ((0, 0, 2), (3, 4, 4), (jcodecs.SERVER_CLIENT_ID, 1, 1)):
        np.testing.assert_array_equal(
            _np(jcodecs.client_layer_keys(0, client, path_idx, L)),
            tcodecs.client_layer_keys(0, client, path_idx, L, "cpu").numpy())
