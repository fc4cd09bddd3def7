"""CUDA kernel wrappers: the packed wire formats.

``coeff_quant``: the deterministic int8 coefficient wire.  Replaces
``src/repro/kernels/wire.py::coeff_quant_pallas`` (GradESTC's
``wire_dtype="int8"``, reached through ``ops.coeff_roundtrip`` after basis
replacement; its body is also step 2 of ``gradestc_encode.encode_quant``,
SVDFed's int8 wire).  Per (row, 512-column block) of a coefficient matrix:
``scale = max(max|a|, 1e-12)``, ``codes = clip(rint(a / scale * 127),
-127, 127)`` and the shipped value ``codes * (scale * INV127)``.  The
kernel (``csrc/gradestc.cu``) takes a leading stack axis and equals its
plain version ``ref.coeff_quant_ref`` bit for bit.  It gives 128 threads to
each (row, block), thread t on the float4 chunk t, two rows a block, by a
launch plan made here (:func:`coeff_plan`), and makes the correctly rounded
quotient a / scale without the IEEE division's branch to its slow path
(which a zero dividend takes).  It moves 9 bytes per coefficient, so HBM
bounds it, but at the slice's sizes a call is under a microsecond of
traffic, below the card's launch floor: what counts there is how many SMs
share the work and how long each thread's chain of dependent steps is.

The quantizer wire (``csrc/quant_wire.cu``), on flat f32 vectors:
``sign_pack``/``sign_unpack`` replace ``wire.py::sign_pack_pallas`` and
``sign_unpack_pallas`` (signSGD), ``quant_pack``/``unpack_dequant`` replace
``quant_pack_pallas`` and ``unpack_dequant_pallas`` (FedPAQ and FedQClip
with ``use_pallas``).  Their plain versions are ``ref.sign_pack_ref``,
``ref.sign_unpack_ref``, ``ref.quant_pack_ref`` and
``ref.unpack_dequant_ref``; each kernel equals its plain version bit for bit.
All four are single passes bounded by HBM bandwidth.  ``sign_pack`` also
finishes the mean-|g| scale on the device (``ref.mean_abs_ref``), so the
sign wire runs no torch op on the card.  ``sign_unpack`` and the
dequantizers (``unpack_dequant`` here, ``quant.block_dequant``) walk their
output in chunks of 4 values, by a launch plan made here on the host
(:func:`dequant_plan`) and passed to the kernel, so that the CPU tests can
hold it.  The quantizers (``quant_pack`` here, ``quant.block_quant``) walk
their input a warp a row, lane L on chunk ``32q + L`` of the row in step q
(a float4 of g and of u), by :func:`quant_plan`; ``quant_pack`` stores
whole words from contiguous lanes.  They take the uniforms as an operand,
as the TPU kernels do: nothing is drawn inside a kernel.

``coeff_dequant`` (also in ``csrc/quant_wire.cu``) replaces
``wire.py::coeff_dequant_pallas``: ``codes * (scale * INV127)`` back to a
``(L, k, m)`` f32 matrix, the int8 coefficient wire's dequantization
(``decode_wire`` fuses the same step into its GEMM).  No path of the JAX
package calls it; ``ops.coeff_dequant`` exposes it.  It walks the ``L k m``
values as one vector in chunks of 4, a chunk a thread
(:func:`coeff_dequant_plan`), a chunk's row found by one 32-bit division.
Its plain version is ``ref.coeff_dequant_ref``, and it too is exact.  Wire
words are uint32 values, held here as the bit patterns of an int32 tensor.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build, ref
from .gradestc_encode import check_operand

__all__ = ["coeff_quant", "coeff_dequant", "sign_pack", "sign_unpack", "quant_pack",
           "unpack_dequant", "QUANT_BITS", "DequantPlan", "dequant_plan", "QuantPlan",
           "quant_plan", "CoeffPlan", "coeff_plan", "coeff_dequant_plan"]

#: bit widths whose codes tile a 512-value row in whole words
QUANT_BITS = (2, 4, 8)
#: the dequantizers' chunk of values, threads per block and chunks per thread
DEQUANT_WIDTH = 4
DEQUANT_THREADS = 256
DEQUANT_UNROLL = 4
#: the quantizers' rows per block of 256 threads (a warp a row)
QUANT_ROWS_PER_BLOCK = 8
#: coeff_quant's rows (items of 128 threads) per block
COEFF_ROWS_PER_BLOCK = 2
#: coeff_dequant's threads per block, a chunk a thread
COEFF_DEQUANT_THREADS = 256


class DequantPlan(NamedTuple):
    """How a dequantizer kernel walks its n outputs.  Chunk ``c`` holds
    values ``[4c, min(4c + 4, n))``; chunks below ``vec_chunks`` take the
    vector path (one load of their 4 codes, one scale, of row ``c // (block
    // 4)``, one 16-byte store), the rest the scalar path, value by value
    with the row ``i // block``.  Block ``b`` of the ``grid`` takes chunks
    ``b * tile + t + DEQUANT_THREADS * u`` for thread ``t`` and ``u <
    DEQUANT_UNROLL``, ``tile = DEQUANT_THREADS * DEQUANT_UNROLL``, so a
    warp's loads and stores are contiguous."""
    chunks: int
    vec_chunks: int
    grid: int


@functools.lru_cache(maxsize=256)
def dequant_plan(n: int, block: int, aligned: bool) -> DequantPlan:
    """The plan of ``unpack_dequant`` and ``sign_unpack`` (``block`` 512)
    and ``quant.block_dequant`` for n outputs (and the chunks of
    :func:`coeff_dequant_plan`, ``block`` m): the vector path takes every whole
    chunk when the operands are ``aligned`` for its loads and store (the
    codes to 4 bytes, the output to 16) and no chunk straddles two rows
    (``block % 4 == 0``); the ragged tail and any other case take the scalar
    path."""
    chunks = -(-n // DEQUANT_WIDTH)
    vec = aligned and block % DEQUANT_WIDTH == 0
    return DequantPlan(chunks, n // DEQUANT_WIDTH if vec else 0,
                       -(-chunks // (DEQUANT_THREADS * DEQUANT_UNROLL)))


class QuantPlan(NamedTuple):
    """How a quantizer kernel (``quant_pack``, ``quant.block_quant``) walks
    its ``rows`` rows of ``block`` values, a warp a row, ``QUANT_ROWS_PER_BLOCK``
    rows to each block of the ``grid``.  In step q lane L takes chunk ``32q +
    L`` of its row, values ``4 (32q + L) .. 4 (32q + L) + 3``.  Rows below
    ``vec_rows`` take the vector path (a float4 load of g and of u per chunk;
    block_quant's 4 codes in one 4-byte store); the others load value by
    value, g reading 0.0 past n (block_quant storing a byte a code), and a
    block that is not a multiple of 4 or is longer than 512 goes value by
    value, lane L on values L, L + 32, ..."""
    rows: int
    vec_rows: int
    grid: int


@functools.lru_cache(maxsize=256)
def quant_plan(n: int, block: int, aligned: bool) -> QuantPlan:
    """The plan of ``quant_pack`` (``block`` 512) and ``quant.block_quant``
    for n values: every row whole below n takes the vector path when the
    operands are ``aligned`` (g and u to 16 bytes, block_quant's codes to 4)
    and the row is whole chunks of 4 values in registers (``block % 4 ==
    0``, ``block <= 512``); the ragged last row and any other case take the
    scalar path."""
    rows = -(-n // block)
    vec = aligned and block % 4 == 0 and block <= ref.WIRE_BLOCK
    return QuantPlan(rows, n // block if vec else 0, -(-rows // QUANT_ROWS_PER_BLOCK))


class CoeffPlan(NamedTuple):
    """How ``coeff_quant`` walks ``rows`` rows of m coefficients: block (x,
    b) of the grid (``grid`` x ``blocks``) takes the items (row
    ``COEFF_ROWS_PER_BLOCK x + i``, 512-column block b), 128 threads each.
    On the vector path (``vec``) thread t of an item takes chunk t, values
    ``4t .. 4t + 3`` (a float4 of A, a 4-byte word of codes, a float4 of
    ship), chunks past the row's m reading and storing nothing; otherwise
    thread t takes values t, t + 128, t + 256, t + 384 of the item, one by
    one."""
    blocks: int
    vec: bool
    grid: int


@functools.lru_cache(maxsize=256)
def coeff_plan(rows: int, m: int, aligned: bool) -> CoeffPlan:
    """The plan of ``coeff_quant`` for ``rows`` rows of m: the vector path
    where m % 4 == 0 and the operands are ``aligned`` (A and ship to 16
    bytes, codes to 4), so that every chunk of a row starts on an aligned
    address; the scalar path otherwise."""
    return CoeffPlan(-(-m // ref.WIRE_BLOCK), aligned and m % 4 == 0,
                     -(-rows // COEFF_ROWS_PER_BLOCK))


@functools.lru_cache(maxsize=256)
def coeff_dequant_plan(n: int, m: int, aligned: bool) -> DequantPlan:
    """The plan of ``coeff_dequant`` for the n = L k m values of rows of m:
    ``dequant_plan(n, m, aligned)``'s chunks and vector chunks (the codes
    aligned to 4 bytes, the output to 16, m % 4 == 0), a chunk a thread,
    ``COEFF_DEQUANT_THREADS`` chunks a block of the grid."""
    plan = dequant_plan(n, m, aligned)
    return plan._replace(grid=-(-plan.chunks // COEFF_DEQUANT_THREADS))


def _check_coeffs(rows: int, m: int) -> None:
    if rows * m >= 2 ** 31:
        raise ValueError(f"the coefficient wire takes fewer than 2**31 values, got {rows * m}")


def _rows(n: int) -> int:
    return -(-n // ref.WIRE_BLOCK)


def _check_bits(bits: int) -> None:
    if bits not in QUANT_BITS:
        raise ValueError(f"the quantizer kernels take bits in {QUANT_BITS}, got {bits}")


def coeff_quant(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A (L, k, m) f32 on a CUDA device, ``L k m < 2**31`` -> (codes int8
    (L, k, m), scales f32 (L, k, ceil(m/512)), ship f32 (L, k, m)).  The
    kernel walks ``coeff_plan(L k, m, A aligned to 16 bytes)`` (the outputs
    are fresh, so aligned)."""
    check_operand("A", A, 3, A.device)
    L, k, m = A.shape
    codes = torch.empty((L, k, m), dtype=torch.int8, device=A.device)
    scales = torch.empty((L, k, -(-m // ref.WIRE_BLOCK)), dtype=torch.float32,
                         device=A.device)
    ship = torch.empty_like(A)
    if L * k * m:
        _check_coeffs(L * k, m)
        if m > 65535 * ref.WIRE_BLOCK:             # the grid's second axis
            raise ValueError(f"coeff_quant takes rows of at most {65535 * ref.WIRE_BLOCK}, "
                             f"got {m}")
        a = A.data_ptr()
        plan = coeff_plan(L * k, m, a % 16 == 0)
        with _build.device(A):
            _build.launch("coeff_quant", "gradestc_coeff_quant_f32", a, codes.data_ptr(),
                          scales.data_ptr(), ship.data_ptr(), L, k, m, plan.vec, plan.grid,
                          _build.stream(A))
    return codes, scales, ship


def coeff_dequant(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """codes int8 (L, k, m) and scales f32 (L, k, ceil(m/512)) on one CUDA
    device, ``L k m < 2**31`` -> (L, k, m) f32, ``codes * (scale * INV127)``.
    The kernel walks ``coeff_dequant_plan(L k m, m, codes aligned to 4
    bytes)`` (the output is fresh, so aligned)."""
    check_operand("codes", codes, 3, codes.device, torch.int8)
    check_operand("scales", scales, 3, codes.device)
    L, k, m = codes.shape
    if scales.shape != (L, k, -(-m // ref.WIRE_BLOCK)):
        raise ValueError(f"scales {tuple(scales.shape)} do not fit codes {tuple(codes.shape)}")
    out = torch.empty((L, k, m), dtype=torch.float32, device=codes.device)
    if L * k * m:
        _check_coeffs(L * k, m)
        c = codes.data_ptr()
        plan = coeff_dequant_plan(L * k * m, m, c % 4 == 0)
        with _build.device(codes):
            _build.launch("coeff_dequant", "wire_coeff_dequant_f32", c, scales.data_ptr(),
                          out.data_ptr(), L * k, m, plan.vec_chunks, plan.grid,
                          _build.stream(codes))
    return out


def _check_flat(n: int) -> None:
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"the sign wire takes 1 <= n < 2**31 values, got {n}")


#: f32(1/n), rounded once, by n (the host's cost is on every call's path)
_recip32 = functools.lru_cache(maxsize=256)(ref.recip32)


def sign_pack(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g (n,) f32 on a CUDA device, ``1 <= n < 2**31`` -> (words int32
    (ceil(n/32),), rowsums f32 (ceil(n/512),), scale f32 ()): bit i = (g_i <
    0), each 512-value row's |g| summed by ``ref.pairwise_sum``'s tree, and
    the mean-|g| scale, the rows summed by the same tree times
    ``ref.recip32(n)`` (``ref.mean_abs_ref``), finished on the device by a
    second kernel of the same call."""
    check_operand("g", g, 1, g.device)
    n = g.shape[0]
    _check_flat(n)
    words = torch.empty((-(-n // 32),), dtype=torch.int32, device=g.device)
    rowsums = torch.empty((_rows(n),), dtype=torch.float32, device=g.device)
    scale = torch.empty((), dtype=torch.float32, device=g.device)
    with _build.device(g):
        _build.launch("sign_pack", "wire_sign_pack_f32", g.data_ptr(), words.data_ptr(),
                      rowsums.data_ptr(), scale.data_ptr(), n, _recip32(n), _build.stream(g))
    return words, rowsums, scale


def sign_unpack(words: torch.Tensor, scale: torch.Tensor, n: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """words int32 (ceil(n/32),) and a 0-dim f32 ``scale`` on the same CUDA
    device -> (n,) f32, +scale where the bit is 0 and -scale where it is 1,
    written into ``out`` (a contiguous (n,) f32 tensor of any alignment)
    where given.  The kernel reads ``scale`` on the device: no host fetch.
    It walks ``dequant_plan(n, 512, out aligned to 16 bytes)``."""
    dev = words.device
    check_operand("words", words, 1, dev, torch.int32)
    check_operand("scale", scale, 0, dev)
    if words.shape[0] != -(-n // 32):
        raise ValueError(f"{words.shape[0]} words do not hold {n} signs")
    if out is None:
        out = torch.empty((n,), dtype=torch.float32, device=dev)
    else:
        check_operand("out", out, 1, dev)
        if out.shape[0] != n:
            raise ValueError(f"out holds {out.shape[0]} values, not {n}")
    if n:
        _check_flat(n)
        o = out.data_ptr()
        plan = dequant_plan(n, ref.WIRE_BLOCK, o % 16 == 0)
        with _build.device(words):
            _build.launch("sign_unpack", "wire_sign_unpack_f32", words.data_ptr(),
                          scale.data_ptr(), o, n, plan.vec_chunks, plan.grid,
                          _build.stream(words))
    return out


def quant_pack(g: torch.Tensor, u: torch.Tensor, bits: int = 8
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g (n,) f32 and uniforms u (n_p,) f32, ``n_p = ceil(n/512)*512 <
    2**31``, on one CUDA device -> (words int32 (n_p*bits/32,), scales f32
    (n_p/512,)).  g reads as zero past n (the reference's padding); ``bits``
    in {2, 4, 8}.  The kernel walks ``quant_plan(n, 512, g and u aligned to
    16 bytes)`` and draws nothing: the uniforms are the caller's."""
    _check_bits(bits)
    check_operand("g", g, 1, g.device)
    check_operand("u", u, 1, g.device)
    n = g.shape[0]
    rows = _rows(n)
    if u.shape[0] != rows * ref.WIRE_BLOCK:
        raise ValueError(f"u has {u.shape[0]} values; g of {n} needs {rows * ref.WIRE_BLOCK}")
    if rows * ref.WIRE_BLOCK >= 2 ** 31:
        raise ValueError(f"the quantizer takes fewer than 2**31 padded values, got "
                         f"{rows * ref.WIRE_BLOCK}")
    words = torch.empty((rows * ref.WIRE_BLOCK * bits // 32,), dtype=torch.int32,
                        device=g.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=g.device)
    if n:
        gp, up = g.data_ptr(), u.data_ptr()
        plan = quant_plan(n, ref.WIRE_BLOCK, gp % 16 == 0 and up % 16 == 0)
        with _build.device(g):
            _build.launch("quant_pack", "wire_quant_pack_f32", gp, up, words.data_ptr(),
                          scales.data_ptr(), n, bits, plan.vec_rows, plan.grid,
                          _build.stream(g))
    return words, scales


def unpack_dequant(words: torch.Tensor, scales: torch.Tensor, n: int, bits: int = 8
                   ) -> torch.Tensor:
    """words int32 (n_p*bits/32,) and scales f32 (n_p/512,) on one CUDA
    device -> the first n values, ``(code - levels) * (scale * f32(1/levels))``;
    ``n_p < 2**31``."""
    _check_bits(bits)
    dev = words.device
    check_operand("words", words, 1, dev, torch.int32)
    check_operand("scales", scales, 1, dev)
    n_p = scales.shape[0] * ref.WIRE_BLOCK
    if words.shape[0] != n_p * bits // 32 or not 0 <= n_p - n < ref.WIRE_BLOCK:
        raise ValueError(f"words {tuple(words.shape)} and scales {tuple(scales.shape)} "
                         f"do not hold {n} {bits}-bit codes")
    if n_p >= 2 ** 31:
        raise ValueError(f"the dequantizer takes fewer than 2**31 codes, got {n_p}")
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        o = out.data_ptr()
        plan = dequant_plan(n, ref.WIRE_BLOCK, o % 16 == 0)
        with _build.device(words):
            _build.launch("unpack_dequant", "wire_unpack_dequant_f32", words.data_ptr(),
                          scales.data_ptr(), o, n, bits, plan.vec_chunks, plan.grid,
                          _build.stream(words))
    return out
