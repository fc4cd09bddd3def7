"""Port vs reference: the encdec family (Whisper, ``whisper-medium``).

``get_config("whisper-medium").reduced()`` from each package (2 encoder and
2 decoder layers, d 256, 4 heads of 64, d_ff 512, 64 encoder frames,
vocab 1024, LayerNorm eps 1e-5, f32), with ``test_torch_rwkv6.py``'s
checks: ``init_params`` bit for bit (the 32768-row decoder positions
too), forward, loss and gradients over zero audio frames, and 24 decode
steps from ``serve.start_cache`` (the encoder's states over zero frames,
cross K/V projected once) against the reference's prefill and
``decode_step``.  The encoder alone and a forward with explicit random
frames (``model.forward``'s ``audio_frames``) against the reference's;
``extra_inputs`` gives the reference's zero frames.  Measured: forward
9.3e-7, loss exact, gradients 2.2e-6, decode 1.1e-6."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import encdec as jencdec  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from test_torch_rwkv6 import (B, check_decode, check_forward_loss_grads,  # noqa: E402
                              check_init, cfgs, close, ref_params)

NAME = "whisper-medium"


@pytest.fixture(scope="module")
def params():
    return ref_params(NAME)


def test_init_params_equal_reference(params):
    check_init(NAME, params[1])
    jc, tc = cfgs(NAME)
    assert params[1]["dec_pos"].shape == (32768, tc.d_model)
    assert tmodel.param_group_shapes(tc) == jmodel.param_group_shapes(jc)
    assert tmodel.family_module(tc) is tencdec


def test_forward_loss_and_grads(params):
    check_forward_loss_grads(NAME, *params)


def test_decode_matches_reference_and_forward(params):
    check_decode(NAME, *params)


def test_encoder_and_explicit_frames(params):
    """``encode_audio`` over random frames, and the forward's logits with
    those frames passed through ``model.forward``'s batch."""
    jp, tp = params
    jc, tc = cfgs(NAME)
    frames = np.random.default_rng(5).standard_normal(
        (B, tc.encoder_seq, tc.d_model)).astype(np.float32)
    want = jax.jit(lambda p, f: jencdec.encode_audio(jc, p, f))(jp, frames)
    got = tencdec.encode_audio(tc, tp, torch.from_numpy(frames))
    close(got.numpy(), want, "encode_audio")
    tokens = np.random.default_rng(6).integers(0, tc.vocab, (B, 12)).astype(np.int32)
    jb = {"tokens": tokens, "audio_frames": frames}
    want = jax.jit(lambda p, b: jmodel.forward(jc, p, b))(jp, jb)
    with torch.no_grad():
        got = tmodel.forward(tc, tp, {k: torch.from_numpy(v) for k, v in jb.items()})
    close(got.numpy(), want, "forward with frames")


def test_extra_inputs_are_zero_frames():
    jc, tc = cfgs(NAME)
    got = tmodel.extra_inputs(tc, 3, 8, device="cpu")
    want = jmodel.extra_inputs(jc, 3, 8)
    assert set(got) == set(want) == {"audio_frames"}
    a = got["audio_frames"]
    assert a.shape == want["audio_frames"].shape == (3, tc.encoder_seq, tc.d_model)
    assert a.dtype == torch.float32 and not a.any()
