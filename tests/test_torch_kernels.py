"""Port vs reference: the GradESTC encode/decode kernels and their dispatch.

On the CPU the port runs the plain versions (``kernels.ref``), held here
against the reference's oracles (``repro.kernels.ref``): ``||diff||_F <=
1e-5 ||G||_F`` (measured: <= 6.4e-8), and M = 0 gives A == 0, E == G exactly.
The CUDA kernels run only on the card: their tests are in
``test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import gradestc_decode, gradestc_encode, ops  # noqa: E402

RTOL = 1e-5

CASES = [(l, k, 77) for l in (128, 384) for k in (8, 32)]     # m = 77: ragged


def _inputs(l, k, m, L=None, seed=0):
    rng = np.random.default_rng(seed)
    lead = () if L is None else (L,)
    M = np.linalg.qr(rng.normal(size=lead + (l, k)))[0].astype(np.float32)
    G = rng.normal(size=lead + (l, m)).astype(np.float32)
    return M, G


def _rel(a, b, ref_norm):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))) / ref_norm


@pytest.mark.parametrize("l,k,m", CASES)
def test_plain_versions_match_reference(l, k, m):
    M, G = _inputs(l, k, m)
    jA, jE = jref.encode_ref(jnp.asarray(M), jnp.asarray(G))
    tA, tE = ops.encode(torch.from_numpy(M), torch.from_numpy(G))
    gn = float(np.linalg.norm(G))
    assert _rel(jA, tA, gn) <= RTOL and _rel(jE, tE, gn) <= RTOL
    jO = jref.decode_ref(jnp.asarray(M), jA)
    tO = ops.decode(torch.from_numpy(M), tA)
    assert _rel(jO, tO, gn) <= RTOL
    assert tA.dtype == torch.float32 and tO.shape == (l, m)


def test_stacked_equals_per_layer_and_zero_basis_exact():
    M, G = _inputs(128, 8, 77, L=3)
    Mt, Gt = torch.from_numpy(M), torch.from_numpy(G)
    A, E = ops.encode(Mt, Gt)
    for i in range(3):
        Ai, Ei = ops.encode(Mt[i], Gt[i])
        torch.testing.assert_close(A[i], Ai, rtol=0, atol=1e-6)
        torch.testing.assert_close(E[i], Ei, rtol=0, atol=1e-6)
    A0, E0 = ops.encode(torch.zeros_like(Mt), Gt)
    assert bool((A0 == 0).all()) and torch.equal(E0, Gt)


def test_dispatch_refuses_mixed_devices():
    M, G = _inputs(128, 8, 64)
    with pytest.raises(ValueError):
        ops.encode(torch.from_numpy(M), torch.from_numpy(G).to("meta"))


def test_wrapper_refuses_cpu_tensors():
    """The kernel wrappers take CUDA tensors only; they never fall back."""
    M, G = (torch.from_numpy(x) for x in _inputs(128, 8, 64, L=1))
    with pytest.raises(ValueError):
        gradestc_encode.encode(M, G)
    with pytest.raises(ValueError):
        gradestc_decode.decode(M, G[:, :8])
