"""Port vs reference: top-k sparsification with error memory.

``core/baselines.topk_compress`` and ``core/codecs.TopKCodec`` against the
JAX functions on the same numpy inputs, bit for bit: the kept set is
``jax.lax.top_k``'s, which breaks ties at the k-th magnitude toward the
lower index (``torch.topk`` promises no order among ties, so the port takes
only the threshold from it).  Random vectors, ties of both signs, an
all-zero vector, k = n, a batch of rows, and the codec's memory over three
calls."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import baselines as jbl  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro_torch.core import baselines as tbl  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402

TIES = np.array([1, -3, 3, 0, -3, 2, 3, 0, 0], np.float32)


def _vector(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=n).astype(np.float32)
    if kind == "ties":       # few distinct magnitudes, both signs
        return (rng.integers(-3, 4, size=n) * 0.25).astype(np.float32)
    return np.zeros(n, np.float32)


def _both(g, mem, k):
    jst, jg, js = jbl.topk_compress(jbl.TopKState(jnp.asarray(mem)), jnp.asarray(g), k)
    tst, tg, ts = tbl.topk_compress(tbl.TopKState(torch.from_numpy(mem)),
                                    torch.from_numpy(g), k)
    return (np.asarray(jst.memory), np.asarray(jg), float(js)), (tst.memory.numpy(),
                                                                 tg.numpy(), float(ts))


def test_ties_keep_the_lower_indices():
    mem = tbl.TopKState.init(TIES.size, "cpu").memory.numpy()
    np.testing.assert_array_equal(mem, np.asarray(jbl.TopKState.init(TIES.size).memory))
    _, (_, ghat, scalars) = _both(TIES, mem, 3)
    assert set(np.flatnonzero(ghat)) == {1, 2, 4}
    assert scalars == 6.0


@pytest.mark.parametrize("kind,n,k", [("normal", 1000, 100), ("normal", 37, 1),
                                      ("ties", 1000, 100), ("ties", 513, 200),
                                      ("ties", 9, 9), ("zeros", 64, 6), ("normal", 50, 50)])
def test_topk_compress_bit_equal(kind, n, k):
    g = _vector(kind, n, n + k)
    mem = _vector("ties" if kind == "ties" else "normal", n, k) * 0.5
    (jm, jg, js), (tm, tg, ts) = _both(g, mem, k)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tm, jm)
    assert ts == js == 2 * k


def test_batched_rows_equal_single_rows():
    g = np.stack([_vector("ties", 300, s) for s in range(3)])
    mem = np.zeros_like(g)
    st, ghat, _ = tbl.topk_compress(tbl.TopKState(torch.from_numpy(mem)),
                                    torch.from_numpy(g), 40)
    for i in range(3):
        _, (tm, tg, _) = _both(g[i], mem[i], 40)
        np.testing.assert_array_equal(ghat[i].numpy(), tg)
        np.testing.assert_array_equal(st.memory[i].numpy(), tm)


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_codec_memory_over_three_calls(kind):
    n, frac = 777, 0.1
    jc = jcodecs.TopKCodec(n, frac=frac, path_idx=2)
    tc = tcodecs.TopKCodec(n, frac=frac, path_idx=2)
    assert tc.k == jc.k == 77
    jst = jc.init_client_state(2)
    tst = tc.init_client_state(2, "cpu")
    assert isinstance(tst, tuple) and len(tst) == 1
    for rnd in range(3):
        for c in range(2):
            g = _vector(kind, n, 10 * rnd + c)
            j2, jg, _ = jc.encode(jst[c], (), None, jnp.asarray(g))
            t2, tg, tstats = tc.encode(tuple(x[c] for x in tst), (), None,
                                       tc.to_wire(torch.from_numpy(g)))
            jst = jst.at[c].set(j2)
            tst[0][c] = t2[0]
            np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
            np.testing.assert_array_equal(tst[0][c].numpy(), np.asarray(jst[c]))
            assert tstats.numel() == 0
    assert tc.charge_bits(np.zeros(0, np.int32), 3) == jc.charge_bits(None, 3) == 64 * 77 * 3
