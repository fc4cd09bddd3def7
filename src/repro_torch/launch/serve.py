"""Batched serving driver: prefill a batch of prompts, then decode tokens.

Port of ``repro/launch/serve.py``: the same flags, plus ``--device``
(``cuda`` unless the caller asks for ``cpu``), the same order of work and
the same printed lines.  It runs the reduced architecture of ``--arch``;
:func:`generate` serves any config, at full width too.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --batch 4 --steps 16
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import prng
from ..core.metrics import host_fetch
from ..models import model
from ..models.config import ArchConfig

__all__ = ["generate", "start_cache", "main"]


class _Clock:
    """Wall time of a span of queued work without a host sync inside it:
    CUDA events on the card (read after the caller's one fetch), the
    perf counter on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a


def start_cache(cfg: ArchConfig, params, batch: int, max_len: int, device):
    """The empty decode cache that prefill starts from, on ``device``.  An
    encdec model's holds the cross K/V of its encoder's states over zero
    audio frames (the stubbed front end), as the reference's ``main``
    builds it; the encoder's forward runs with grad disabled, so on the
    card its attention is the flash kernel."""
    if cfg.family != "encdec":
        return model.init_cache(cfg, batch, max_len, device=device)
    from ..models import encdec

    frames = model.extra_inputs(cfg, batch, max_len, device=device)["audio_frames"]
    with torch.no_grad():
        enc_out = encdec.encode_audio(cfg, params, frames)
    return model.init_cache(cfg, batch, max_len, enc_out=enc_out, params=params, device=device)


def generate(cfg: ArchConfig, params, prompts: torch.Tensor, steps: int, max_len: int,
             temperature: float = 0.0,
             key: Optional[torch.Tensor] = None) -> Tuple[np.ndarray, float, float]:
    """Prefill ``prompts`` (B, P) by stepping ``decode_step`` over them, then
    generate ``steps`` tokens: greedy, or at ``temperature`` > 0 sampled with
    ``split(key)`` and ``categorical``, as the reference.  Returns the
    generated ids (B, steps) on the host and the prefill and decode seconds.

    The tokens stay on the device and come to the host in one fetch at the
    end; nothing in the loops syncs.  The prefill time starts once the
    cache is allocated; an encdec model's includes its encoder
    (:func:`start_cache`)."""
    B, P = prompts.shape
    dev = prompts.device
    clock = _Clock(dev)
    temp = torch.full((), temperature, dtype=torch.float32, device=dev)   # true division
    t0 = clock.mark() if cfg.family == "encdec" else None
    cache = start_cache(cfg, params, B, max_len, dev)
    if t0 is None:
        t0 = clock.mark()

    logits = None
    for t in range(P):
        logits, cache = model.decode_step(cfg, params, cache, prompts[:, t:t + 1])
    t1 = clock.mark()

    out_tokens = []
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    for _ in range(steps):
        out_tokens.append(tok)
        logits, cache = model.decode_step(cfg, params, cache, tok)
        if temperature > 0:
            key, sub = prng.split(key, 2).unbind(-2)
            tok = prng.categorical(sub, logits[:, -1, :] / temp)[:, None]
        else:
            tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    t2 = clock.mark()
    gen = host_fetch(torch.cat(out_tokens, dim=1))
    return gen, clock.seconds(t0, t1), clock.seconds(t1, t2)


def main(argv=None) -> int:
    from ..configs import get_config

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    key = prng.PRNGKey(args.seed, args.device)
    params = model.init_params(cfg, key)
    B, P = args.batch, args.prompt_len
    prompts = prng.randint(key, (B, P), 0, cfg.vocab)
    gen, prefill_s, decode_s = generate(cfg, params, prompts, args.steps, args.max_len,
                                        args.temperature, key)
    print(f"arch={cfg.name}  batch={B}")
    print(f"prefill: {P} tokens in {prefill_s:.2f}s "
          f"({B*P/max(prefill_s,1e-9):.1f} tok/s)")
    print(f"decode : {args.steps} steps in {decode_s:.2f}s "
          f"({B*args.steps/max(decode_s,1e-9):.1f} tok/s)")
    print("generated token ids (first sequence):", gen[0][:16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
