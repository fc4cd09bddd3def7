"""Port vs reference: the serve driver on the ssm, hybrid and encdec
families.

``repro_torch.launch.serve.main`` prints the same arch line and the same
generated token ids as ``repro.launch.serve.main`` on the CPU, greedy, for
``rwkv6-3b``, ``recurrentgemma-9b`` and ``whisper-medium`` reduced (batch 2,
6 prompt tokens, 6 steps): one WKV and RG-LRU recurrence step a token, the
local layer's ring buffer, and whisper's prefill through the encoder over
zero audio frames (``serve.start_cache``) with its cross K/V fixed."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from test_torch_serve_families import _lines  # noqa: E402


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b", "whisper-medium"])
def test_serve_main_matches_reference(arch):
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "6", "--steps", "6"]
    want = _lines(jserve.main, argv)
    got = _lines(tserve.main, argv + ["--device", "cpu"])
    assert got[0] == want[0] == f"arch={arch}-smoke  batch=2"
    prefix = "generated token ids (first sequence): "
    assert got[3].startswith(prefix) and got[3] == want[3]
