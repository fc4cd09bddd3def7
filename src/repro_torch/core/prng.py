"""Threefry-2x32 key chains, reimplemented in PyTorch.

The JAX reference derives every random draw from ``jax.random`` keys
(threefry2x32 with ``jax_threefry_partitionable=True``, the jax 0.9 default).
This module computes the same chains so the port draws the same client
selections, rSVD test matrices and initial weights:

* a key is an integer tensor ``(..., 2)`` holding two uint32 words;
* all arithmetic runs on int64 tensors masked to 32 bits, so one code path
  serves the CPU and CUDA;
* constants enter as Python scalars (rounded to float32 where the
  reference holds them in float32), never as fresh device tensors, so a
  draw on the card makes no host-to-device copy and no stream sync;
* ``randint`` and ``categorical`` (its Gumbel draws through the same
  XLA-exact ``log``) equal jax's too, as the serve driver draws prompts
  and samples tokens with them;
* ``normal`` follows the reference's transform (uniform on
  ``[nextafter(-1, 0), 1)`` through XLA's polynomial ``erf_inv``, times
  sqrt(2)), with XLA's own f32 ``log`` and ``log1p`` mirrored in tensor
  arithmetic (no libm on the path), so normals, like keys, bits, uniforms
  and permutations, equal jax's bit for bit, on the CPU and on the card.

Batched keys broadcast: ``fold_in``/``split``/``bits`` accept ``(..., 2)``
keys and return one result per key.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

__all__ = ["PRNGKey", "fold_in", "split", "bits", "uniform", "normal",
           "permutation", "randint", "gumbel", "categorical", "erfinv_f32"]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range, on
    ``device`` (the card unless the caller asks for the CPU)."""
    key = torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)
    return key.to(device, non_blocking=True)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` is an int or an integer tensor on the
    key's device that broadcasts against the key's batch shape."""
    k0, k1 = key[..., 0], key[..., 1]
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & _MASK
    else:
        d = torch.full_like(k0, int(data) & _MASK)
    d, k0, k1 = torch.broadcast_tensors(d, k0, k1)
    o0, o1 = _threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``(..., num, 2)``."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    k0, k1 = key[..., 0, None], key[..., 1, None]
    o0, o1 = _threefry2x32(k0, k1, torch.zeros_like(idx), idx)
    return torch.stack([o0, o1], dim=-1)


#: elements per piece of a large normal draw: threefry's int64 temporaries
#: take some 40 bytes an element, so a tensor of 1e9 values is drawn piece
#: by piece over its flat index (threefry is counter-based, so the bits of
#: a piece are those of its indices in one whole draw)
NORMAL_PIECE = 1 << 26
#: the piece on the CPU, where one that fits the caches draws ~7x faster
#: than one pass of each op over a large draw (a 32768 x 256 table: 2.2
#: against 16.0 s on one thread)
CPU_NORMAL_PIECE = 1 << 14


def _bits_flat(key: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """The bits of flat indices ``[start, stop)``: ``(*key.shape[:-1],
    stop - start)``."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(*lead, 1)
    k1 = key[..., 1].reshape(*lead, 1)
    b0, b1 = _threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return b0 ^ b1


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (values in [0, 2^32), int64) of
    ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    return _bits_flat(key, 0, math.prod(shape)).reshape(*key.shape[:-1], *shape)


def _r32(x: float) -> float:
    """``x`` rounded to the nearest float32, as a Python float: in an op on
    a float32 tensor it acts as the reference's float32 constant."""
    return float(np.float32(x))


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under a
    fixed exponent, then scaled to ``[minval, maxval)``."""
    shape = tuple(int(s) for s in shape)
    flat = _uniform_flat(key, 0, math.prod(shape), minval, maxval)
    return flat.reshape(*key.shape[:-1], *shape)


def _uniform_flat(key: torch.Tensor, start: int, stop: int, minval: float,
                  maxval: float) -> torch.Tensor:
    """``uniform`` at flat indices ``[start, stop)``."""
    fb = (_bits_flat(key, start, stop) >> 9) | 0x3F800000
    floats = fb.to(torch.int32).view(torch.float32) - 1.0
    lo = _r32(minval)
    span = float(np.float32(maxval) - np.float32(minval))   # float32 subtraction
    return (floats * span + lo).clamp_min(lo)


# XLA's single-precision erf_inv (Giles' approximation), as the reference's
# CPU and TPU backends lower ``lax.erf_inv``.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _f64(v):
    return v.double() if isinstance(v, torch.Tensor) else v


def _fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add of float32 tensors or float32-exact Python
    floats (at least one a tensor): the f32 product is exact in float64, so
    one rounding of the float64 sum to f32 gives the fused result."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


# XLA's CPU float32 log: Cephes' logf as Eigen writes it (frexp into
# [sqrt(1/2), sqrt(2)), a degree-8 polynomial in three Horner chains joined
# over x^3, the exponent split into 0.693359375 - 2.12194440e-4), with the
# multiply-adds LLVM contracts into fused ones.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_MIN_NORMAL_F32 = float(np.finfo(np.float32).tiny)


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log, in f32 tensor arithmetic (no libm), so the CPU
    and the card give the same bits as the reference."""
    p = [_r32(c) for c in _LOG_P]
    xb = torch.where(x > _MIN_NORMAL_F32, x, _MIN_NORMAL_F32)
    bits = xb.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    mant = ((bits & -0x7F800001) | 0x3F000000).view(torch.float32)   # [1/2, 1)
    low = mant < _r32(math.sqrt(0.5))
    e = e - low.float()
    t = (mant - 1.0) + torch.where(low, mant, 0.0)                  # [sqrt(1/2)-1, sqrt(2)-1)
    t2 = t * t
    t3 = t2 * t
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, t3, y1), t3, y2)
    y = _fma(y, t3, e * _r32(_LOG_Q1))
    out = _fma(e, _r32(_LOG_Q2), _fma(t2, -0.5, t) + y)
    out = torch.where((x <= 0) | torch.isnan(x), float("nan"), out)
    out = torch.where(x.abs() < _MIN_NORMAL_F32, float("-inf"), out)   # denormals flush to 0
    return torch.where(x == float("inf"), float("inf"), out)


# XLA's log1p below sqrt(2) - 1 in magnitude: Cephes' rational function.
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p: Cephes' rational form for small |x|, XLA's
    ``log(1 + x)`` above it."""

    def poly(cs):
        p = torch.full_like(x, cs[0])
        for c in cs[1:]:
            p = _fma(p, x, _r32(c))
        return p

    x2 = x * x
    small = (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN))
    small = x + _fma(-0.5, x2, small)
    return torch.where(x.abs() < 0.41421356237309504880, small, _log_f32(x + 1.0))


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """erf^-1 on float32 with XLA's polynomial, so draws follow the
    reference's rounding rather than the local libm's.  XLA contracts each
    Horner step into one fused multiply-add, and so does this."""
    w = -_log1p_f32(x * -x)
    lt = w < 5.0
    # sqrt through float64: correctly rounded on every device (torch's f32
    # sqrt on the CPU is not), as XLA's is
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _r32(_ERFINV_LT5[0]), _r32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, _r32(a), _r32(b)))
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` in float32; above ``NORMAL_PIECE`` elements
    (on the CPU, ``CPU_NORMAL_PIECE``), drawn piece by piece into the
    result.  A ``meta`` key gives the shape alone, at once (the dry run
    counts a full config's parameters so)."""
    shape = tuple(int(s) for s in shape)
    n, lead = math.prod(shape), key.shape[:-1]
    if key.device.type == "meta":
        return torch.empty(*lead, *shape, dtype=torch.float32, device="meta")
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    piece = CPU_NORMAL_PIECE if key.device.type == "cpu" else NORMAL_PIECE
    if n <= piece:
        return _normal_flat(key, 0, n, lo).reshape(*lead, *shape)
    out = torch.empty(*lead, n, dtype=torch.float32, device=key.device)
    for start in range(0, n, piece):
        stop = min(n, start + piece)
        out[..., start:stop] = _normal_flat(key, start, stop, lo)
    return out.reshape(*lead, *shape)


def _normal_flat(key: torch.Tensor, start: int, stop: int, lo: float) -> torch.Tensor:
    return _r32(math.sqrt(2.0)) * erfinv_f32(_uniform_flat(key, start, stop, lo, 1.0))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: repeated stable sorts on fresh
    32-bit keys (one round below ~1600 elements)."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))
    for _ in range(rounds):
        key, sub = split(key, 2).unbind(-2)
        order = torch.sort(bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two 32-bit
    words from a split key, reduced modulo the span as jax does, with its
    uint32 wrap-around emulated in int64."""
    span = max(int(maxval) - int(minval), 1) & _MASK
    # jax's 2**32 mod span, ((2**16 % N) * (2**16 % N)) % N, whose product
    # wraps in uint32 (to 0 for a span above 2**16)
    mult = ((((1 << 16) % span) ** 2) & _MASK) % span
    k1, k2 = split(key, 2).unbind(-2)
    hi, lo = bits(k1, shape), bits(k2, shape)
    off = (((hi % span) * mult) & _MASK) + (lo % span)
    off = (off & _MASK) % span
    return (int(minval) + off).to(torch.int32)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, "low" mode: ``-log(-log(u))`` on
    ``uniform(minval=tiny)``, with XLA's float32 ``log``."""
    u = uniform(key, shape, _MIN_NORMAL_F32, 1.0)
    return -_log_f32(-_log_f32(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis of f32
    logits: the argmax of Gumbel noise plus the logits (ties to the lower
    index, as ``jnp.argmax``)."""
    g = gumbel(key, tuple(logits.shape))
    return torch.argmax(g + logits, dim=-1)
