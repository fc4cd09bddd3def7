"""Port vs reference: the serve driver.

``repro_torch.launch.serve.main`` prints the same generated token ids as
``repro.launch.serve.main`` on the CPU (gemma3-1b reduced, batch 2, 8
prompt tokens, 8 steps), greedy and at ``--temperature 0.7``: its prompts
come from ``prng.randint`` and its samples from ``prng.categorical``, each
bit-equal to jax's (``tests/test_torch_draws.py``)."""

import contextlib
import io
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402


def _ids(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == "arch=gemma3-1b-smoke  batch=2"
    assert lines[1].startswith("prefill: 8 tokens in ") and lines[2].startswith("decode : 8 steps")
    prefix = "generated token ids (first sequence): "
    assert lines[3].startswith(prefix)
    return lines[3][len(prefix):]


@pytest.mark.parametrize("temperature", ["0", "0.7"])
def test_serve_main_matches_reference(temperature):
    argv = ["--arch", "gemma3-1b", "--batch", "2", "--prompt-len", "8", "--steps", "8",
            "--temperature", temperature]
    want = _ids(jserve.main, argv)
    got = _ids(tserve.main, argv + ["--device", "cpu"])
    assert got == want
    assert len(json.loads(got)) == 8


def test_generate_returns_host_ids_and_times():
    """``generate``: (B, steps) ids on the host, greedy by default."""
    from repro_torch.models import model
    from repro_torch.models.config import ArchConfig

    cfg = ArchConfig(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
                     n_kv_heads=2, d_ff=64, vocab=64, dtype="float32")
    key = prng.PRNGKey(3, "cpu")
    params = model.init_params(cfg, key)
    prompts = prng.randint(key, (2, 4), 0, cfg.vocab)
    gen, prefill_s, decode_s = tserve.generate(cfg, params, prompts, 5, 16)
    assert isinstance(gen, np.ndarray) and gen.shape == (2, 5)
    assert prefill_s >= 0 and decode_s >= 0
    # greedy: the first id is the argmax after the prompt
    cache = model.init_cache(cfg, 2, 16, device="cpu")
    for t in range(4):
        lg, cache = model.decode_step(cfg, params, cache, prompts[:, t:t + 1])
    np.testing.assert_array_equal(gen[:, 0], lg[:, -1].argmax(-1).numpy())
