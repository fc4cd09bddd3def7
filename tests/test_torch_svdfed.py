"""Port vs reference: the SVDFed codec on the f32, bf16 and int8 wires.

Two rounds for two clients through both codecs: round 0 is a refit round
(M = 0, raw uplink), round 1 ships coefficients on the fitted basis.  Stats
vectors, reduced stats, the refit flag, the key chain and ``charge_bits``
must match exactly.  Reconstructions are held to ``1e-5 ||G||_F`` (given the
same basis; on the int8 wire against the reference evaluated on the port's
shipped codes, since a code may flip where A/scale*127 sits on a rounding
boundary; the reference's own result within 1e-3, across such flips).
Server fits are compared as the projector M M^T (every entry within 1e-5),
never as raw columns (their signs differ between LAPACK and XLA)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import codecs as jcodecs  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.fl import compression as tcomp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

GROUPS = {"layers/w": ((256, 64), 2), "layers/ln": ((64,), 2), "embed": ((64, 64), 1)}
PATH = "layers/w"
RTOL = 1e-5
FIT_TOL = 1e-5


def _deltas(seed, plan, rounds=2, clients=2):
    """Low-rank-plus-noise deltas with spread singular values, group-shaped."""
    rng = np.random.default_rng(seed)
    L, l, m, k = plan.stack, plan.l, plan.m, plan.k
    sv = 0.05 * 0.7 ** np.arange(k)
    U = np.linalg.qr(rng.normal(size=(L, l, k)))[0]
    out = []
    for _ in range(rounds):
        U = np.linalg.qr(U + 0.2 * rng.normal(size=U.shape))[0]
        row = []
        for _ in range(clients):
            V = np.linalg.qr(rng.normal(size=(L, m, k)))[0]
            G = (U * sv) @ V.transpose(0, 2, 1) + 1e-3 * rng.normal(size=(L, l, m))
            row.append(G.transpose(0, 2, 1).reshape((L,) + plan.shape).astype(np.float32))
        out.append(row)
    return out


def _codecs(wire, gamma):
    jpol = jpolicy.make_policy(GROUPS, min_params=4096)
    tpol = tpolicy.make_policy(GROUPS, min_params=4096)
    pidx = 1
    jc = jcodecs.SVDFedCodec(jpol.plans[PATH], gamma=gamma, seed=4, path_idx=pidx,
                             wire_dtype=wire)
    tc = tcodecs.SVDFedCodec(tpol.plans[PATH], gamma=gamma, seed=4, path_idx=pidx,
                             wire_dtype=wire)
    return jc, tc


def _proj(M):
    M = np.asarray(M, np.float64)
    return M @ np.swapaxes(M, -1, -2)


@pytest.mark.parametrize("gamma", [8.0, 95.0])
@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_svdfed_two_rounds(wire, gamma):
    jc, tc = _codecs(wire, gamma)
    plan = tc.plan
    jsh, tsh = jc.init_shared_state(), tc.init_shared_state("cpu")
    np.testing.assert_array_equal(np.asarray(jsh[1]).astype(np.int64), tsh[1].numpy())
    assert bool(jsh[2]) and bool(tsh[2]) and not tsh[0].any()
    jenc, jupd = jax.jit(jc.encode), jax.jit(jc.update_shared)
    wants = []
    for rnd, row in enumerate(_deltas(7, plan)):
        # encode on the same basis (the reference's), to hold encode alone
        tsh_same = (torch.from_numpy(np.array(jsh[0])), tsh[1], tsh[2])
        jstats, tstats, jsum, tsum = [], [], 0, 0
        for delta in row:
            jw = jc.to_wire(jnp.asarray(delta))
            tw = tc.to_wire(torch.from_numpy(delta))
            _, jg, js = jenc((), jsh, None, jw)
            _, tg, ts = tc.encode((), tsh_same, None, tw)
            np.testing.assert_array_equal(np.asarray(js), ts.numpy())
            gn = float(np.linalg.norm(delta))
            if rnd == 0:
                torch.testing.assert_close(tg, tw, rtol=0, atol=0)   # raw on a refit round
            elif wire == "int8":
                codes, scales, _ = ops.encode_quant(tsh_same[0], tw)
                want = np.stack([np.asarray(jsh[0][i]) @ np.asarray(jref.coeff_dequant_ref(
                    jnp.asarray(codes.numpy()[i]), jnp.asarray(scales.numpy()[i])))
                    for i in range(plan.stack)])
                assert np.linalg.norm(want - tg.numpy()) <= RTOL * gn
                assert np.linalg.norm(np.asarray(jg) - tg.numpy()) <= 1e-3 * gn
            else:
                assert np.linalg.norm(np.asarray(jg) - tg.numpy()) <= RTOL * gn
            jstats.append(js)
            tstats.append(ts)
            jsum, tsum = jsum + jg, tsum + tg
        jred = jc.reduce_stats(jnp.stack(jstats))
        tred = tc.reduce_stats(torch.stack(tstats))
        np.testing.assert_array_equal(np.asarray(jred), tred.numpy())
        assert jc.charge_bits(np.asarray(jred), 2) == tc.charge_bits(tred.numpy(), 2)
        wants.append(int(tred[1]))
        jsh = jupd(jsh, jred, jsum / 2)
        tsh = tc.update_shared(tsh, tred, tsum / 2)
        np.testing.assert_array_equal(np.asarray(jsh[1]).astype(np.int64), tsh[1].numpy())
        assert bool(jsh[2]) == bool(tsh[2])
        assert np.abs(_proj(jsh[0]) - _proj(tsh[0].numpy())).max() <= FIT_TOL
    # the steady round's fit leaves ~85% of the energy unexplained: gamma = 8
    # asks for a refit, gamma = 95 does not
    assert wants == [0, int(gamma < 10)]


def test_svdfed_method_and_bits():
    tpol = tpolicy.make_policy(GROUPS, min_params=4096)
    meth = tcomp.make_method("svdfed", policy=tpol, seed=2, wire_dtype="int8", gamma=9.0)
    cs = tcomp.build_codecs(meth, tpol, list(GROUPS))
    assert list(cs) == [PATH] and cs[PATH].wire_dtype == "int8" and cs[PATH].gamma == 9.0
    plan = tpol.plans[PATH]
    assert cs[PATH].charge_bits(np.array([1, 0]), 3) == 32 * plan.raw_scalars * 3
    assert cs[PATH].charge_bits(np.array([0, 1]), 3) == (
        (8 * plan.k * plan.m + 32 * plan.k * -(-plan.m // 512)) * plan.stack * 3)
    with pytest.raises(ValueError):
        tcodecs.SVDFedCodec(plan, wire_dtype="int4")
