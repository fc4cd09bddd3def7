"""Port vs reference: the signSGD, FedPAQ and FedQClip codecs.

The per-client draw key (``round_base_key`` folded with the client id and
the group index, ``Codec.per_client_key``) must equal jax's bit for bit, and
so must the engine's batched derivation of a round's keys.  Given the same
wire and key, each codec's reconstruction equals the reference's compiled
``encode`` exactly, on both FedPAQ/FedQClip wires (``use_pallas`` True: the
block-local wire; False: the paper's global quantizer, whose dequantization
XLA fuses into one multiply-add, mirrored by the port); ``charge_bits`` is
exact.  With the clip active the norm is a float reduction whose order
differs between XLA and torch (here the norms are 1 ulp apart): the clipped
input is held to 1e-6 relative (measured: 6.9e-8) and the reconstruction to
one quantization step per value (measured: at most 1.5e-11 against a step
of 1.7e-6; the scale moves by an ulp and no code changes)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.fl import compression as jcomp  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.fl import compression as tcomp  # noqa: E402

GROUPS = {"layers/w": ((256, 64), 2), "layers/ln": ((64,), 2), "embed": ((100, 70), 1)}
CLIP_RTOL = 1e-6


def _wire(n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_t(3, size=n) * 1e-3).astype(np.float32)
    w[::13] = 0.0
    return w


def _key(seed, rnd, client, path_idx):
    jk = jcodecs.Codec(path_idx).per_client_key(jcodecs.round_base_key(seed, rnd), client)
    tk = tcodecs.Codec(path_idx).per_client_key(
        tcodecs.round_base_key(seed, rnd, "cpu"), client)
    return jk, tk


@pytest.mark.parametrize("seed,rnd,client,path_idx",
                         [(0, 0, 0, 0), (0, 3, 7, 2), (5, 11, 2, 9), (2**31 - 1, 1, 99, 1)])
def test_per_client_key_matches_jax(seed, rnd, client, path_idx):
    jk, tk = _key(seed, rnd, client, path_idx)
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
    # the engine's batched derivation: one fold over the selected clients,
    # then one over the groups' path indices
    sel = torch.tensor([client, client + 1], dtype=torch.int64)
    paths = torch.tensor([path_idx, path_idx + 3], dtype=torch.int64)
    base = tcodecs.round_base_key(seed, rnd, "cpu")
    keys = prng.fold_in(prng.fold_in(base, sel)[:, None, :], paths)
    for i, c in enumerate(sel.tolist()):
        for j, p in enumerate(paths.tolist()):
            assert torch.equal(keys[i, j], tcodecs.Codec(p).per_client_key(base, c))


def _codecs(method, n, path_idx, use_pallas, **kw):
    jcls = {"signsgd": jcodecs.SignSGDCodec, "fedpaq": jcodecs.FedPAQCodec,
            "fedqclip": jcodecs.FedQClipCodec}[method]
    tcls = {"signsgd": tcodecs.SignSGDCodec, "fedpaq": tcodecs.FedPAQCodec,
            "fedqclip": tcodecs.FedQClipCodec}[method]
    jkw = dict(kw, pallas_interpret=True) if use_pallas else kw
    tkw = kw if method == "signsgd" else dict(kw, use_pallas=use_pallas)
    return (jcls(n, path_idx=path_idx, use_pallas=use_pallas, **jkw),
            tcls(n, path_idx=path_idx, **tkw))


@pytest.mark.parametrize("method,use_pallas", [("signsgd", False), ("fedpaq", False),
                                               ("fedpaq", True), ("fedqclip", False),
                                               ("fedqclip", True)])
def test_flat_codec_reconstruction_and_bits_exact(method, use_pallas):
    n, path_idx = 7000, 3
    jc, tc = _codecs(method, n, path_idx, use_pallas)
    assert tc.draws == (method != "signsgd")
    w = _wire(n, seed=n + path_idx)
    jw, tw = jc.to_wire(jnp.asarray(w.reshape(70, 100))), tc.to_wire(
        torch.from_numpy(w.reshape(70, 100)))
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    jk, tk = _key(1, 2, 4, path_idx)
    _, jr, jst = jax.jit(jc.encode)((), (), jk, jw)
    _, tr, tst = tc.encode((), (), tk if tc.draws else None, tw)
    np.testing.assert_array_equal(np.asarray(jr).view(np.int32), tr.numpy().view(np.int32))
    assert tst.shape == (0,) and tst.dtype == torch.int32
    for n_sel in (1, 3):
        assert tc.charge_bits(np.zeros(0, np.int32), n_sel) == jc.charge_bits(
            np.zeros(0, np.int32), n_sel)
    scales = 1 if method == "signsgd" or not use_pallas else -(-n // 512)
    bits = 1 if method == "signsgd" else 8
    assert tc.charge_bits(np.zeros(0, np.int32), 2) == 2 * (n * bits + 32 * scales)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fedqclip_with_the_clip_active(use_pallas):
    n, path_idx, clip = 7000, 1, 1e-3
    jc, tc = _codecs("fedqclip", n, path_idx, use_pallas, clip=clip)
    w = _wire(n, seed=5)
    assert np.linalg.norm(w) > 10 * clip
    jk, tk = _key(3, 0, 2, path_idx)
    jr = np.asarray(jax.jit(jc.encode)((), (), jk, jnp.asarray(w))[1])
    tr = tc.encode((), (), tk, torch.from_numpy(w))[1].numpy()
    # the clipped inputs
    jn = jnp.linalg.norm(jnp.asarray(w))
    jclipped = np.asarray(jnp.asarray(w) * jnp.minimum(1.0, clip / jnp.maximum(jn, 1e-12)))
    tw = torch.from_numpy(w)
    tn = torch.linalg.vector_norm(tw).clamp_min(1e-12)
    tclipped = (tw * torch.full_like(tn, clip).div(tn).clamp_max(1.0)).numpy()
    rel = np.abs(tclipped - jclipped).max() / np.abs(jclipped).max()
    assert rel <= CLIP_RTOL
    # one quantization step per value: the row's (or the vector's) scale
    # over the code book
    if use_pallas:
        pad = (-n) % 512
        step = np.repeat(np.abs(np.pad(jclipped, (0, pad))).reshape(-1, 512).max(1), 512)[:n] / 127
    else:
        step = np.full(n, np.abs(jclipped).max() * 2 / 255)
    assert bool((np.abs(tr - jr) <= step * (1 + 1e-5)).all())


def test_methods_build_a_codec_for_every_group():
    """signsgd/fedpaq/fedqclip compress every group, norms included, and the
    resolved ``use_pallas`` reaches the codecs."""
    jpol = jpolicy.make_policy(GROUPS, min_params=4096)
    tpol = tpolicy.make_policy(GROUPS, min_params=4096)
    paths = sorted(GROUPS)
    for name in ("signsgd", "fedpaq", "fedqclip"):
        for use_pallas in (False, True):
            jcs = jcomp.build_codecs(jcomp.make_method(name, policy=jpol, seed=0), jpol,
                                     paths, use_pallas)
            tcs = tcomp.build_codecs(tcomp.make_method(name, policy=tpol, seed=0), tpol,
                                     paths, use_pallas)
            assert sorted(tcs) == sorted(jcs) == paths
            for p in paths:
                assert tcs[p].path_idx == jcs[p].path_idx and tcs[p].n == jcs[p].n
                assert getattr(tcs[p], "use_pallas", use_pallas) == use_pallas
                assert (tcs[p].charge_bits(np.zeros(0), 3)
                        == jcs[p].charge_bits(np.zeros(0), 3))
