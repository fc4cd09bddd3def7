"""Port vs reference: the serve driver on the MoE and VLM families.

``repro_torch.launch.serve.main`` prints the same lines' arch and the same
generated token ids as ``repro.launch.serve.main`` on the CPU, greedy, for
``granite-moe-1b-a400m`` and ``qwen2-vl-72b`` reduced (batch 2, 6 prompt
tokens, 6 steps): MoE routing in every decode step, M-RoPE positions from
the cache length."""

import contextlib
import io

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402


def _lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-vl-72b"])
def test_serve_main_matches_reference(arch):
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "6", "--steps", "6"]
    want = _lines(jserve.main, argv)
    got = _lines(tserve.main, argv + ["--device", "cpu"])
    assert got[0] == want[0] == f"arch={arch}-smoke  batch=2"
    prefix = "generated token ids (first sequence): "
    assert got[3].startswith(prefix) and got[3] == want[3]
