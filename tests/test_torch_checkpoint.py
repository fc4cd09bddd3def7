"""Port vs reference: checkpoints (``repro_torch.checkpoint``).

A round trip keeps every leaf's bits and dtype (bf16 widened to f32 in the
file and narrowed back), an overwrite is atomic, and the file keys are the
reference's letter for letter: a checkpoint of a param tree plus an Adam
state written by either package restores in the other, bit for bit."""

import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402

SHAPES = {"embed": (16, 8), "layers": {"attn_wq": (2, 8, 8), "ln_attn": (2, 8)},
          "ln_f": (8,)}


def _nested(rng, shapes):
    return {k: _nested(rng, v) if isinstance(v, dict)
            else rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()}


def _jax_state(rng):
    """The reference's params (bf16 layers, f32 rest) after one Adam step,
    and its state."""
    p = jax.tree.map(jnp.asarray, _nested(rng, SHAPES))
    p["layers"] = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p["layers"])
    g = jax.tree.map(lambda x: (x * 0.5).astype(x.dtype), p)
    init, update = jopt.adam(1e-2)
    return update(g, init(p), p)


def _port_template():
    """The port's tree of the same structure: flat params, Adam's state."""
    z = {k: torch.zeros(SHAPES[k], dtype=torch.float32) for k in ("embed", "ln_f")}
    z.update({f"layers/{k}": torch.zeros(v, dtype=torch.bfloat16)
              for k, v in SHAPES["layers"].items()})
    init, _ = topt.adam(1e-2)
    return {"params": z, "opt": init(z)}


def test_roundtrip(tmp_path):
    """The reference's round trip on the port: bf16 and an int leaf."""
    tree = {"layers/w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "opt": (torch.tensor([1.5, -0.0, 3e-3], dtype=torch.bfloat16),
                    torch.tensor(7, dtype=torch.int32), 5)}
    path = str(tmp_path / "ck")
    tckpt.save(path, 42, tree)
    assert tckpt.latest_step(path) == 42
    out = tckpt.restore(path, 42, tree)
    assert torch.equal(out["layers/w"], tree["layers/w"])
    assert out["opt"][0].dtype == torch.bfloat16
    assert torch.equal(out["opt"][0].view(torch.int16), tree["opt"][0].view(torch.int16))
    assert out["opt"][1].dtype == torch.int32 and int(out["opt"][1]) == 7
    assert out["opt"][2] == 5 and isinstance(out["opt"][2], int)
    with np.load(os.path.join(path, "ckpt_00000042.npz")) as f:
        assert sorted(f.files) == ["layers|w", "opt|0", "opt|1", "opt|2"]
        assert f["opt|0"].dtype == np.float32


def test_atomic_overwrite(tmp_path):
    path = str(tmp_path / "ck")
    tckpt.save(path, 1, {"a": torch.ones(4)})
    tckpt.save(path, 2, {"a": torch.ones(4) * 2})
    tckpt.save(path, 2, {"a": torch.ones(4) * 3})     # the same step again
    assert tckpt.latest_step(path) == 2
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    out = tckpt.restore(path, 2, {"a": torch.zeros(4)})
    assert torch.equal(out["a"], 3 * torch.ones(4))
    assert sorted(os.listdir(path)) == ["ckpt_00000001.npz", "ckpt_00000002.npz"]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference saves params + an Adam state; the port restores it
    into its own tree: params equal to ``convert.params_from_jax``, the
    moments too, the step an int32 tensor."""
    params, state = _jax_state(np.random.default_rng(0))
    path = str(tmp_path / "ck")
    jckpt.save(path, 3, {"params": params, "opt": state})
    with np.load(os.path.join(path, "ckpt_00000003.npz")) as f:
        assert "opt|.step" in f.files and "opt|.slots|0|layers|attn_wq" in f.files
    out = tckpt.restore(path, 3, _port_template())
    want = params_from_jax(jax.device_get(params), "cpu")
    assert set(out["params"]) == set(want)
    for k, v in want.items():
        assert out["params"][k].dtype == v.dtype and torch.equal(out["params"][k], v), k
    for i in (0, 1):
        slot = params_from_jax(jax.device_get(state.slots[i]), "cpu")
        for k, v in slot.items():
            assert torch.equal(out["opt"].slots[i][k], v), (i, k)
    assert out["opt"].step.dtype == torch.int32 and int(out["opt"].step) == int(state.step)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port saves params + an Adam state; the reference restores it
    into its nested tree, bit for bit."""
    params, state = _jax_state(np.random.default_rng(1))
    tparams = params_from_jax(jax.device_get(params), "cpu")
    init, update = topt.adam(1e-2)
    tnew, tstate = update({k: (v * 0.5).to(v.dtype) for k, v in tparams.items()},
                          init(tparams), tparams)
    path = str(tmp_path / "ck")
    tckpt.save(path, 5, {"params": tnew, "opt": tstate})
    init_j, _ = jopt.adam(1e-2)
    template = {"params": params, "opt": init_j(params)}
    out = jckpt.restore(path, 5, template)
    got = params_from_jax(jax.device_get(out["params"]), "cpu")
    for k, v in tnew.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    for i in (0, 1):
        slot = params_from_jax(jax.device_get(out["opt"].slots[i]), "cpu")
        for k, v in tstate.slots[i].items():
            assert torch.equal(slot[k], v), (i, k)
    assert int(out["opt"].step) == 1
