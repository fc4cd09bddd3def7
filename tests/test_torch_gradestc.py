"""Port vs reference: rSVD and the rank-padded GradESTC step.

Same keys, same inputs.  Integer outcomes (d_r, the replaced mask, the init
flag, Formula 13) must match exactly; reconstructions M_new A_new within
``1e-5 ||G||_F`` (measured <= 1e-6).  Raw basis columns are never compared:
QR/SVD column signs differ between LAPACK and XLA."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import gradestc as jge  # noqa: E402
from repro.core.rsvd import randomized_svd as j_rsvd  # noqa: E402
from repro_torch.core import gradestc as tge  # noqa: E402
from repro_torch.core.rsvd import randomized_svd as t_rsvd  # noqa: E402

RTOL = 1e-5
L, l, m, k = 2, 64, 48, 8


def _stream(seed, drift=0.2):
    """Two rounds of drifting low-rank-plus-noise gradients, (L, l, m) each.

    The singular values are spread (ratio 0.6) so that the rSVD candidates
    are well defined: near-degenerate singular pairs would rotate within
    their subspace under LAPACK-vs-XLA rounding, which is sensitivity of
    the input, not a port fault (random-normal spectra gave up to 2.5e-5)."""
    rng = np.random.default_rng(seed)
    sv = 4.0 * 0.6 ** np.arange(k)
    U = np.linalg.qr(rng.normal(size=(L, l, k)))[0]
    V = np.linalg.qr(rng.normal(size=(L, m, k)))[0]
    G0 = (U * sv) @ V.transpose(0, 2, 1) + 1e-3 * rng.normal(size=(L, l, m))
    U2 = np.linalg.qr(U + drift * rng.normal(size=(L, l, k)))[0]
    V2 = np.linalg.qr(V + drift * rng.normal(size=(L, m, k)))[0]
    G1 = (U2 * sv) @ V2.transpose(0, 2, 1) + 1e-3 * rng.normal(size=(L, l, m))
    return G0.astype(np.float32), G1.astype(np.float32)


_j_step = jax.jit(jax.vmap(
    lambda st, G, d: jge.compress_step(st, G, k=k, d=d, d_max=k),
    in_axes=(0, 0, None)))


def _j_state(M, keys, init):
    return jge.CompressorState(M=jnp.asarray(M), key=jnp.asarray(keys, jnp.uint32),
                               initialized=jnp.asarray(init))


def _t_state(M, keys, init):
    return tge.CompressorState(M=torch.tensor(np.asarray(M)),
                               key=torch.tensor(np.asarray(keys).astype(np.int64)),
                               initialized=torch.tensor(np.asarray(init)))


def _ma_rel(jst, jp, tst, tp, G):
    jMA = np.asarray(jst.M) @ np.asarray(jp.coeffs)
    tMA = (tst.M @ tp.coeffs).numpy()
    return float(np.linalg.norm(jMA - tMA) / np.linalg.norm(G))


def test_rsvd_reconstruction_matches():
    rng = np.random.default_rng(1)
    A = (rng.normal(size=(L, l, 12)) @ rng.normal(size=(L, 12, m))
         + 0.01 * rng.normal(size=(L, l, m))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), L)
    tU, tS, tVt = t_rsvd(torch.as_tensor(np.asarray(keys).astype(np.int64)),
                         torch.from_numpy(A), rank=k)
    for i in range(L):
        jU, jS, jVt = j_rsvd(keys[i], jnp.asarray(A[i]), rank=k)
        np.testing.assert_allclose(tS[i].numpy(), np.asarray(jS), rtol=1e-5)
        jR = np.asarray(jU) * np.asarray(jS) @ np.asarray(jVt)
        tR = (tU[i] * tS[i] @ tVt[i]).numpy()
        assert np.linalg.norm(jR - tR) <= RTOL * np.linalg.norm(A[i])


@pytest.mark.parametrize("seed,d", [(0, 1), (1, 2), (2, 5), (3, 8)])
def test_init_then_steady_step_matches(seed, d):
    G0, G1 = _stream(seed)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), L))
    zeros = np.zeros((L, l, k), np.float32)
    init = np.zeros((L,), bool)

    jst1, jp1, js1 = _j_step(_j_state(zeros, keys, init), jnp.asarray(G0), jnp.int32(d))
    tst1, tp1, ts1 = tge.compress_step(_t_state(zeros, keys, init), torch.from_numpy(G0),
                                       k=k, d=d, d_max=k)
    np.testing.assert_array_equal(np.asarray(jst1.key).astype(np.int64), tst1.key.numpy())
    np.testing.assert_array_equal(np.asarray(jp1.init), tp1.init.numpy())
    np.testing.assert_array_equal(np.asarray(js1.d_r), ts1.d_r.numpy())
    np.testing.assert_array_equal(np.asarray(jp1.replaced_mask), tp1.replaced_mask.numpy())
    assert _ma_rel(jst1, jp1, tst1, tp1, G0) <= RTOL

    jst2, jp2, js2 = _j_step(jst1, jnp.asarray(G1), jnp.int32(d))
    tst2, tp2, ts2 = tge.compress_step(tst1, torch.from_numpy(G1), k=k, d=d, d_max=k)
    assert not tp2.init.any()
    np.testing.assert_array_equal(np.asarray(js2.d_r), ts2.d_r.numpy())
    np.testing.assert_array_equal(np.asarray(jp2.replaced_mask), tp2.replaced_mask.numpy())
    assert _ma_rel(jst2, jp2, tst2, tp2, G1) <= RTOL
    nv = tp2.new_vectors.numpy()
    for i in range(L):
        assert np.abs(nv[i, int(ts2.d_r[i]):]).max(initial=0.0) == 0.0
    # Ghat through the decode path equals M_new A_new
    Ghat = tge.reconstruct(tst2.M, tp2.coeffs)
    torch.testing.assert_close(Ghat, tst2.M @ tp2.coeffs)


@pytest.mark.parametrize("d", [3, 8])
def test_padded_step_equals_static_slice_within_tolerance(d):
    """The port's traced-d step against the reference's exact static-d
    slice (``tests/test_properties.py::TestRankPaddedDynamicD``), in
    tolerance form: d_r and the replaced mask exact, M A within 1e-5."""
    from test_gradestc_core import ref_static_slice_update

    G0, G1 = _stream(10 + d, drift=0.3)
    st0 = jge.init_compressor(l, k, jax.random.PRNGKey(d))
    st1, _, _ = jge.compress_init(st0, jnp.asarray(G0[0]), k=k)
    st_ref, p_ref, s_ref = ref_static_slice_update(st1, jnp.asarray(G1[0]), k=k, d=d, d_max=k)
    tst, tp, ts = tge.compress_step(
        _t_state(np.asarray(st1.M)[None], np.asarray(st1.key)[None], [True]),
        torch.from_numpy(G1[:1]), k=k, d=d, d_max=k)
    assert int(ts.d_r[0]) == int(s_ref.d_r)
    np.testing.assert_array_equal(tp.replaced_mask[0].numpy(), np.asarray(p_ref.replaced_mask))
    jMA = np.asarray(st_ref.M) @ np.asarray(p_ref.coeffs)
    tMA = (tst.M[0] @ tp.coeffs[0]).numpy()
    assert np.linalg.norm(jMA - tMA) <= RTOL * np.linalg.norm(G1[0])


def test_formula13_and_payload_scalars_exact():
    d_r = np.arange(0, 70, dtype=np.int32)
    want = np.asarray(jge.next_candidate_count_jax(jnp.asarray(d_r), 64))
    got = tge.next_candidate_count(torch.from_numpy(d_r), 64).numpy()
    np.testing.assert_array_equal(want, got)
    init = np.array([True, False, False])
    dr = np.array([8, 3, 0], np.int32)
    jp = jge.Payload(None, None, None, jnp.asarray(dr), jnp.asarray(init))
    tp = tge.Payload(None, None, None, torch.from_numpy(dr), torch.from_numpy(init))
    np.testing.assert_array_equal(
        np.asarray(jge.payload_scalars(jp, l=64, m=48, k=8)),
        tge.payload_scalars(tp, l=64, m=48, k=8).numpy())
