"""The port on the card: the CUDA kernels against their plain versions, and
the PRNG on CUDA against the same draws on the CPU.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode).  The file imports neither jax nor the JAX package, so it runs
on a machine without them; there, skip the JAX-importing conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import gradestc_decode, gradestc_encode, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

pytestmark = pytest.mark.cuda

RTOL = 1e-5
#: card vs CPU normals: torch's f32 log differs between CUDA and the CPU
#: library in the last bits, so the port's log1p does too
NORMAL_ULP_BOUND = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(l, k, m, L, seed=0):
    rng = np.random.default_rng(seed)
    M = np.linalg.qr(rng.normal(size=(L, l, k)))[0].astype(np.float32)
    G = rng.normal(size=(L, l, m)).astype(np.float32)
    return M, G


@pytest.mark.parametrize("L,l,m,k", [(2, 1024, 512, 64), (2, 1024, 500, 64), (3, 384, 77, 8)])
def test_cuda_kernels_match_plain(cuda, L, l, m, k):
    M, G = (torch.from_numpy(x).to(cuda) for x in _inputs(l, k, m, L))
    n_enc, n_dec = gradestc_encode.launch_count(), gradestc_decode.launch_count()
    A, E = ops.encode(M, G)
    rA, rE = tref.encode_ref(M, G)
    O = ops.decode(M, rA.contiguous())
    gn = float(G.norm())
    assert float((A - rA).norm()) <= RTOL * gn and float((E - rE).norm()) <= RTOL * gn
    assert float((O - tref.decode_ref(M, rA)).norm()) <= RTOL * gn
    A0, E0 = ops.encode(torch.zeros_like(M), G)
    assert bool((A0 == 0).all()) and torch.equal(E0, G)
    assert gradestc_encode.launch_count() == n_enc + 2
    assert gradestc_decode.launch_count() == n_dec + 1


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    M, G = (torch.from_numpy(x).to(cuda) for x in _inputs(128, 8, 64, 1))
    with pytest.raises(TypeError):
        ops.encode(M.double(), G.double())
    with pytest.raises(ValueError):
        ops.encode(M, G.mT.contiguous().mT)          # non-contiguous G
    with pytest.raises(ValueError):
        ops.encode(torch.zeros(1, 128, 65, device=cuda), G)   # k > 64
    with pytest.raises(ValueError):
        ops.encode(M[0], G[0])                       # no stack axis


def test_cuda_prng_matches_cpu(cuda):
    """Keys, bits and uniforms are integer work and agree exactly; normals
    agree within the ulp bound."""
    kc, kg = prng.PRNGKey(3, "cpu"), prng.PRNGKey(3, cuda)
    assert torch.equal(prng.split(kg, 5).cpu(), prng.split(kc, 5))
    assert torch.equal(prng.fold_in(kg, 123456789).cpu(), prng.fold_in(kc, 123456789))
    assert torch.equal(prng.uniform(kg, (4096,)).cpu(), prng.uniform(kc, (4096,)))
    a = prng.normal(kc, (200000,)).numpy()
    b = prng.normal(kg, (200000,)).cpu().numpy()
    ulp = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    print(f"normals card vs CPU: {int((ulp > 0).sum())} of {ulp.size} differ, "
          f"max {int(ulp.max())} ulp")
    assert ulp.max() <= NORMAL_ULP_BOUND and (ulp > 0).mean() < 0.02
