"""Port vs reference: the standalone Alg. 1 / Alg. 2 compressor API.

The quickstart loop (``examples/quickstart.py``): ``init_compressor``, a
``compress_init`` round decoded with ``decompress(init_basis=...)``, then
``compress_update`` rounds decoded with ``decompress``, through both
packages on the same keys and drifting low-rank gradients with spread
singular values (ratio 0.6; ``test_torch_gradestc.py`` says why).  The port
runs the layers as one stack, the reference layer by layer.  Integer
outcomes (d_r, the replaced mask, the init flag, Formula 14) must match
exactly; Ghat and M A within ``1e-5 ||G||_F``; raw basis columns are never
compared across packages.  Within the port, the server's mirrored basis
must equal the client's bit for bit, and Ghat must equal ``reconstruct(M,
A)`` bit for bit.  ``compress`` (init or update chosen on the device) is
held against the reference's ``lax.cond`` version."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import gradestc as jge  # noqa: E402
from repro_torch.core import gradestc as tge  # noqa: E402

RTOL = 1e-5
L, l, m, k, d = 2, 64, 48, 8, 4
ROUNDS = 4


def _stream(seed=0, drift=0.2):
    """ROUNDS drifting low-rank-plus-noise gradients, (L, l, m) each."""
    rng = np.random.default_rng(seed)
    sv = 4.0 * 0.6 ** np.arange(k)
    U = np.linalg.qr(rng.normal(size=(L, l, k)))[0]
    V = np.linalg.qr(rng.normal(size=(L, m, k)))[0]
    out = []
    for _ in range(ROUNDS):
        G = (U * sv) @ V.transpose(0, 2, 1) + 1e-3 * rng.normal(size=(L, l, m))
        out.append(G.astype(np.float32))
        U = np.linalg.qr(U + drift * rng.normal(size=(L, l, k)))[0]
        V = np.linalg.qr(V + drift * rng.normal(size=(L, m, k)))[0]
    return out


def _keys():
    return jax.random.split(jax.random.PRNGKey(0), L)


def _close(a, b, G):
    assert np.linalg.norm(np.asarray(a) - np.asarray(b)) <= RTOL * np.linalg.norm(G)


def test_quickstart_loop_matches_reference():
    keys = _keys()
    jst = [jge.init_compressor(l, k, keys[i]) for i in range(L)]
    jsv = [jge.DecompressorState(M=jnp.zeros((l, k))) for _ in range(L)]
    tst = tge.init_compressor(l, k, torch.from_numpy(np.asarray(keys).astype(np.int64)))
    tsv = tge.DecompressorState(M=torch.zeros(L, l, k))
    assert tst.M.shape == (L, l, k) and not tst.initialized.any()
    for rnd, G in enumerate(_stream()):
        tG = torch.from_numpy(G)
        if rnd == 0:
            tst, tp, ts = tge.compress_init(tst, tG, k=k)
            tsv, tGhat = tge.decompress(tsv, tp, init_basis=tst.M)
        else:
            tst, tp, ts = tge.compress_update(tst, tG, k=k, d=d)
            tsv, tGhat = tge.decompress(tsv, tp)
        assert tst.initialized.all()
        # the server mirrors the client's basis exactly, and decodes M A
        assert torch.equal(tsv.M, tst.M)
        assert torch.equal(tGhat, tge.reconstruct(tst.M, tp.coeffs))
        assert tp.new_vectors.shape == (L, k if rnd == 0 else d, l)
        for i in range(L):
            if rnd == 0:
                jst[i], jp, js = jge.compress_init(jst[i], jnp.asarray(G[i]), k=k)
                jsv[i], jGhat = jge.decompress(jsv[i], jp, init_basis=jst[i].M)
            else:
                jst[i], jp, js = jge.compress_update(jst[i], jnp.asarray(G[i]), k=k, d=d)
                jsv[i], jGhat = jge.decompress(jsv[i], jp)
            assert int(jp.d_r) == int(tp.d_r[i]) == int(ts.d_r[i])
            assert bool(jp.init) == bool(tp.init[i]) == (rnd == 0)
            np.testing.assert_array_equal(np.asarray(jp.replaced_mask), tp.replaced_mask[i])
            np.testing.assert_array_equal(np.asarray(jst[i].key).astype(np.int64), tst.key[i])
            assert (int(jge.payload_scalars(jp, l=l, m=m, k=k))
                    == int(tge.payload_scalars(tp, l=l, m=m, k=k)[i]))
            _close(jGhat, tGhat[i], G[i])
            _close(np.asarray(jst[i].M) @ np.asarray(jp.coeffs), tst.M[i] @ tp.coeffs[i], G[i])
            np.testing.assert_allclose(float(ts.recon_err[i]), float(js.recon_err), atol=1e-5)
    # the drift makes later rounds replace basis vectors
    assert int(tp.d_r.sum()) > 0


def test_compress_selects_init_or_update_on_the_device():
    keys = _keys()
    G0, G1 = _stream()[:2]
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    # layer 0 starts initialized from round 0's basis, layer 1 fresh
    warm = tge.compress_init(tge.init_compressor(l, k, tkeys), torch.from_numpy(G0), k=k)[0]
    mixed = tge.CompressorState(M=warm.M, key=warm.key, initialized=torch.tensor([True, False]))
    st, p, s, basis = tge.compress(mixed, torch.from_numpy(G1), k=k, d=d)
    assert torch.equal(basis, st.M) and st.initialized.all()
    assert p.new_vectors.shape == (L, d, l)
    assert p.init.tolist() == [False, True]
    for i in range(L):
        jmixed = jge.CompressorState(M=jnp.asarray(warm.M[i].numpy()),
                                     key=jnp.asarray(warm.key[i].numpy(), jnp.uint32),
                                     initialized=jnp.asarray(bool(mixed.initialized[i])))
        jst, jp, js, jbasis = jge.compress(jmixed, jnp.asarray(G1[i]), k=k, d=d)
        assert int(jp.d_r) == int(p.d_r[i]) and bool(jp.init) == bool(p.init[i])
        np.testing.assert_array_equal(np.asarray(jp.replaced_mask), p.replaced_mask[i])
        _close(np.asarray(jbasis) @ np.asarray(jp.coeffs), basis[i] @ p.coeffs[i], G1[i])
    # the init layer's padded wire holds its first d basis vectors
    assert torch.equal(p.new_vectors[1], st.M[1, :, :d].mT)


def test_apply_payload_is_decompress_state():
    G = torch.from_numpy(_stream()[0])
    st, p, _ = tge.compress_init(
        tge.init_compressor(l, k, torch.from_numpy(np.asarray(_keys()).astype(np.int64))), G, k=k)
    server = tge.DecompressorState(M=torch.zeros(L, l, k))
    assert torch.equal(tge.apply_payload(server, p).M, tge.decompress(server, p)[0].M)
    # an init payload carries the whole basis: no init_basis needed
    assert torch.equal(tge.apply_payload(server, p).M, st.M)
