// Quantizer wire kernels for Hopper (sm_90a): the signSGD sign wire, the
// FedPAQ / FedQClip block-quantizer wire, the unpacked block quantizer and
// the int8 coefficient wire's dequantization, with a plain C interface loaded
// through ctypes (see kernels/_build.py, which compiles every .cu here into
// one library).
//
// sign_pack:      g (n,) f32 -> words (ceil(n/32),) u32, bit i = (g_i < 0),
//                 rowsums (ceil(n/512),) f32, the pairwise-tree sum of |g|
//                 over each 512-value row (zero padded), and the mean-|g|
//                 scale () f32, the rows' pairwise sum times f32(1/n) (a
//                 second kernel, mean_abs_kernel, from the same entry point)
// sign_unpack:    words, scale (a device pointer) -> (1 - 2 bit) * scale, (n,)
// quant_pack:     g (n,) f32 zero padded to n_p = ceil(n/512)*512, u (n_p,)
//                 uniforms -> per row scale = max(max|g|, 1e-12), codes
//                 floor(x) + (u < x - floor(x)) with x = g / scale * levels,
//                 clipped to +-levels, biased by +levels and packed
//                 32/bits to a word: words (n_p*bits/32,), scales (n_p/512,)
// unpack_dequant: words, scales -> (code - levels) * (scale * f32(1/levels)),
//                 the first n values
// block_quant:    quant_pack's arithmetic on rows of any `block` values and
//                 any bits from 2 to 8, without the bias and the pack:
//                 g (n,) zero padded to n_p = ceil(n/block)*block, u (n_p,)
//                 -> codes (n_p,) int8, scales (n_p/block,) f32
// block_dequant:  codes (n_p,) int8, scales -> code * (scale * f32(1/levels)),
//                 the first n values, in f32, bf16 or f16 (rounded once)
// coeff_dequant:  codes (L, k, m) int8, scales (L, k, ceil(m/512)) ->
//                 code * (scale * INV127), (L, k, m) f32, the scale of
//                 each value's (row, 512-column block)
//
// Words are uint32 in the canonical layout (code i -> word i / cpw, shift
// (i % cpw) * bits, cpw = 32 / bits); bits is 2, 4 or 8 for quant_pack and
// unpack_dequant.  Every kernel launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().
//
// Replaces (JAX/Pallas TPU reference):
//   sign_pack      -> src/repro/kernels/wire.py::sign_pack_pallas
//   sign_unpack    -> src/repro/kernels/wire.py::sign_unpack_pallas
//   quant_pack     -> src/repro/kernels/wire.py::quant_pack_pallas
//   unpack_dequant -> src/repro/kernels/wire.py::unpack_dequant_pallas
//   block_quant    -> src/repro/kernels/quant.py::block_quant_pallas
//   block_dequant  -> src/repro/kernels/quant.py::block_dequant_pallas
//   coeff_dequant  -> src/repro/kernels/wire.py::coeff_dequant_pallas
//
// What bounds them on an H100 SXM (3.35 TB/s): all seven are single passes
// that do a few operations per value, so HBM bandwidth.  quant_pack reads 8
// bytes per value (g and u) and writes bits/8; sign_pack reads 4 and writes
// 1/8 (its finish reads 4 bytes per 512 values, from L2); the unpackers read
// 1/8 or bits/8 and write 4.  block_quant reads 8 and
// writes 1 (plus a scale per block); block_dequant and coeff_dequant read 1
// and write 4 (2 for a bf16 or f16 output).
//
// Results must equal the plain versions (kernels/ref.py) bit for bit:
//   * sign_pack's row sum follows ref.pairwise_sum's tree: a warp owns a row
//     of 512 values, lane L holds values 128q + 4L .. 128q + 4L + 3 of step
//     q (0..3); (v0 + v1) + (v2 + v3) in the thread is the tree's first two
//     levels, the butterfly __shfl_xor_sync at offsets 1, 2, 4, 8, 16 the
//     next five (adjacent blocks first; f32 addition is commutative, so both
//     lanes of a pair hold the same sum), and (q0 + q1) + (q2 + q3) the last
//     two.  The scale's finish (mean_abs_kernel) continues the same tree over
//     the row sums, zero padded to a power of two: a row sum is >= +0.0, so
//     each added zero is exact.
//   * quant_pack and block_quant divide with __fdiv_rn and multiply with
//     __fmul_rn, so nvcc cannot contract x * levels - floor(x) into an FMA
//     (the reference rounds the product first); max|g| is exact in any order.
//   * the dequantizers multiply the integer code by scale * f32(1/levels)
//     (or scale * INV127), that product rounded once; f32(1/levels) is the
//     IEEE quotient __fdiv_rn(1, levels), as the reference's
//     np.float32(1) / np.float32(levels).
// No --use_fast_math.
//
// Design:
//   sign_pack (redesigned for the H100): 256 threads, one warp per 512-value
//     row.  A step of a warp loads 512 contiguous bytes (a float4 a lane),
//     and a row's four are in flight at once; the sum takes 20 shuffles a
//     row.  Word 4q + L / 8 is the OR of lanes 8j .. 8j + 7's sign nibbles,
//     each at bit 4 (L % 8), over xor 1, 2 and 4; one more shuffle hands it
//     to lane 4q + j, so lanes 0..15 store the row's 16 words as 64
//     contiguous bytes.  The ragged last row and a g that is not 16-byte
//     aligned load value by value (0.0 past n) in the same kernel; n < 2^31,
//     so indices are 32-bit.
//   mean_abs_kernel, the scale's finish: one block of 1024 threads, launched
//     by sign_pack's entry point on the same stream, so no torch op runs
//     between the kernel and the scale.  It walks the row sums in tiles of
//     4096, 4 tiles loaded at once: a thread sums 4 (levels 1-2), its warp
//     128 (3-7), the 32 warps' sums a tile (8-12, in one warp); the tiles'
//     sums then meet in shared memory, adjacent pairs first, and thread 0
//     writes sum * f32(1/n), the host's ref.recip32(n).
//   sign_unpack (redesigned for the H100), the dequantizers' store pattern:
//     a thread step is a chunk of 4 values, the nibble of word c / 8 at bit
//     4 (c % 8), written by one 16-byte streaming store; lane L of a warp
//     takes chunk base + L, a block of 256 threads 4 chunks a thread, 256
//     apart, every load in flight before its stores; the scale is loaded
//     once a thread.  It walks wire.dequant_plan(n, 512, out aligned); the
//     ragged tail and an unaligned out take the scalar path.
//   coeff_dequant (redesigned for the H100): the dequantizers' chunk of 4
//     values (one 4-byte load of codes, one scale, one 16-byte streaming
//     store; lane L on chunk base + L, 512 contiguous bytes a warp store)
//     over the L k m values as one vector, but a chunk a thread, 256
//     threads a block (wire.coeff_dequant_plan): its calls are 65,536 to
//     360,448 values, where the SMs a call reaches and the longest chain of
//     one thread set the time, not the bytes.  4 chunks a thread left most
//     SMs idle; of blocks of 128, 256, 512 and 1,024 threads, 256 measured
//     fastest on the H100.  A chunk's row is c / (m / 4), one 32-bit
//     division per 4 values, and its scale that of 512-column block (c % (m
//     / 4)) / 128, read through the L1 by the chunks that share it; a chunk
//     never straddles two blocks, since m % 4 == 0 on the vector path.  A
//     row whose m is not a multiple of 4, and unaligned operands, take the
//     scalar path, which steps the row where a chunk crosses into the next.
//   unpack_dequant, block_dequant (redesigned for the H100): they write 4
//     bytes per value (2 in bf16 or f16) and read 1/4 to 1, so the stores
//     bound them.  One thread per value, each reloading its row's scale and
//     (block_dequant) dividing by levels and by the runtime block, held them
//     at 42-46% of the HBM bound; so did a thread per 16-byte code load,
//     because its 16 values made 64 contiguous bytes a thread, so each warp
//     store covered 2 KB at a 64-byte stride and half of every sector.  What
//     the card rewards is a warp store of 512 contiguous bytes.  So a thread
//     step is a chunk of 4 values: one load of its 4 codes (bits/2 bytes of
//     the words; 4 int8 codes), one scale, one 16-byte streaming store
//     (__stcs: nothing here reads the output again; 8 bytes in bf16 or f16),
//     and lane L of a warp takes chunk base + L, so loads and stores are
//     contiguous across the warp.  A block of 256 threads takes 4 chunks a
//     thread, 256 apart, every load in flight before its stores.  The chunk's
//     row is c / 128 (a shift) or c / (block / 4), one 32-bit division per 4
//     values; f32(1/levels) is a constant (unpack) or one IEEE division per
//     thread (block_dequant), and each value is code * (scale * inv), in that
//     order, so the bits stay the reference's.  The ragged tail, a block that
//     is not a multiple of 4, and operands not aligned for the vector loads
//     and stores take a scalar path inside the same kernel (block_dequant
//     steps the row where a chunk crosses into the next).  The host makes the
//     plan -- how many chunks take the vector path, and the grid
//     (wire.dequant_plan) -- and the entry points check it; n < 2^31, so
//     indices are 32-bit.
//   quant_pack, block_quant (redesigned for the H100): one row walk for
//     both, in the sign wire's layout.  256 threads, a warp per row; in step
//     q (0..3) lane L takes chunk 32q + L of its row, the float4 of g and the
//     float4 of u at values 128q + 4L .. 128q + 4L + 3, so a warp access
//     reads 512 contiguous bytes of each (16 contiguous values a lane
//     would span 2 KB at a 64-byte lane stride per load).  Every load of a
//     row (8 float4 a lane) is in flight before the max, by streaming loads
//     (__ldcs: nothing reads g or u again), and the max is fmaxf over the
//     lane's values, then 5 xor shuffles.  Each value keeps the plain version's sequence (quant_code),
//     with levels a compile-time constant: the entry points dispatch bits to
//     their instantiations; a zero g skips the IEEE division's slow path.  The stores are whole words from contiguous
//     lanes: quant_pack's 4 codes of a step are 4 * bits bits at code 128q +
//     4L -- at 8 bits word 32q + L; at 4 bits half of word 16q + L / 2, and
//     at 2 bits byte L % 4 of word 8q + L / 4, whole after one or two xor
//     shuffles and handed by one more to the lane that stores it, so a
//     warp's word store covers 128 contiguous bytes; block_quant's 4 int8
//     codes are one 4-byte store at code 4 (32q + L) of the row.  Lane 0
//     writes the scale.  The host makes the plan (wire.quant_plan: the rows,
//     how many take the vector path, the grid) and the entry points check
//     it.  The vector path needs the row whole below n, block % 4 == 0 and
//     block <= 512, g and u 16-byte aligned and (block_quant) the codes
//     4-byte aligned; the
//     ragged last row and unaligned operands load value by value in the same
//     walk (g reads as 0.0 past n, the reference's zero padding, so g is
//     never copied to a padded buffer; u covers the padded length, as the
//     reference draws it) and block_quant stores them byte by byte; a block
//     that is not a multiple of 4 or is longer than 512 values (no path
//     runs either) goes value by value, strided over the lanes, twice (the
//     max, then the codes).  The uniforms are an operand, as in the TPU
//     kernels: no draw happens here.  n_p < 2^31, so indices are 32-bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW = 512;           // values per wire row (ref.WIRE_BLOCK)
constexpr int ROW_THREADS = 256;   // 8 warps, one row each (wire.QUANT_ROWS_PER_BLOCK rows)
constexpr int ROWS_PER_BLOCK = ROW_THREADS / 32;
// the dequantizers: a chunk of 4 values a thread-step, DQ_UNROLL chunks a
// thread, 256 apart, so a warp's loads and 16-byte stores are contiguous
// (wire.DEQUANT_THREADS and DEQUANT_UNROLL on the host)
constexpr int DQ_UNROLL = 4;
constexpr int DQ_THREADS = 256;
constexpr int DQ_WIDTH = 4;
constexpr int DQ_TILE = DQ_THREADS * DQ_UNROLL;   // chunks a block
// coeff_dequant: a chunk a thread (wire.COEFF_DEQUANT_THREADS on the host)
constexpr int CDQ_THREADS = 256;
// the mean-|g| scale's finish: one block, tiles of 4 row sums a thread,
// MA_UNROLL tiles loaded at once, at most 2^22 rows (n < 2^31) in 1024 tiles
constexpr int MA_THREADS = 1024;
constexpr int MA_TILE = 4 * MA_THREADS;
constexpr int MA_UNROLL = 4;
constexpr int MA_MAX_TILES = (1 << 22) / MA_TILE;
constexpr float SCALE_FLOOR = 1e-12f;
constexpr unsigned FULL = 0xffffffffu;
// f32(1/127), rounded once: the int8 coefficient wire's step (ref.INV127)
constexpr float INV127 = 0x1.020408p-7f;

// four consecutive values from i (a multiple of 4); 0.0 past n
__device__ __forceinline__ float4 load4(const float* __restrict__ p, unsigned i, unsigned n,
                                        bool vec) {
  if (vec && i + 3 < n) return *reinterpret_cast<const float4*>(p + i);
  float4 r;
  r.x = i < n ? p[i] : 0.0f;
  r.y = i + 1 < n ? p[i + 1] : 0.0f;
  r.z = i + 2 < n ? p[i + 2] : 0.0f;
  r.w = i + 3 < n ? p[i + 3] : 0.0f;
  return r;
}

// (a0 + a1) + (a2 + a3): the pairwise tree's first two levels
__device__ __forceinline__ float sum4(float a0, float a1, float a2, float a3) {
  return __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
}

// the tree's next five levels across a warp: lane L adds lane L ^ o's sum
// (o = 1, 2, 4, 8, 16: adjacent blocks first; f32 addition commutes, so
// both lanes of a pair hold the same bits); every lane gets the total
__device__ __forceinline__ float warp_tree(float a) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) a = __fadd_rn(a, __shfl_xor_sync(FULL, a, o));
  return a;
}

__global__ void __launch_bounds__(ROW_THREADS)
sign_pack_kernel(const float* __restrict__ g, uint32_t* __restrict__ words,
                 float* __restrict__ rowsums, unsigned n, unsigned rows, bool vec) {
  const unsigned lane = threadIdx.x % 32;
  const unsigned row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= rows) return;
  // step q takes values 128q + 4L .. 128q + 4L + 3 in lane L
  const unsigned base = row * ROW + 4 * lane;
  float4 v[4];
  if (vec && row * ROW + ROW <= n) {        // a whole row, g aligned: 4 loads in flight
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = *reinterpret_cast<const float4*>(g + base + 128 * q);
  } else {                                  // the ragged last row, or g unaligned
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = load4(g, base + 128 * q, n, false);
  }
  float part[4];
  uint32_t mine = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    part[q] = warp_tree(sum4(fabsf(v[q].x), fabsf(v[q].y), fabsf(v[q].z), fabsf(v[q].w)));
    // word 4q + L / 8: lane L's 4 signs at bit 4 (L % 8), OR-ed over its 8 lanes
    uint32_t w = ((uint32_t)(v[q].x < 0.0f) | (uint32_t)(v[q].y < 0.0f) << 1 |
                  (uint32_t)(v[q].z < 0.0f) << 2 | (uint32_t)(v[q].w < 0.0f) << 3)
                 << (4 * (lane % 8));
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) w |= __shfl_xor_sync(FULL, w, o);
    // lane 4q + j keeps word 4q + j, which lanes 8j .. 8j + 7 hold
    const uint32_t t = __shfl_sync(FULL, w, 8 * (lane % 4));
    if (lane / 4 == q) mine = t;
  }
  // the row's 16 words as 64 contiguous bytes from lanes 0 .. 15
  const unsigned wi = row * 16 + lane;
  if (lane < 16 && wi < (n + 31) / 32) words[wi] = mine;
  if (lane == 0) rowsums[row] = sum4(part[0], part[1], part[2], part[3]);
}

// the mean-|g| scale: the row sums' pairwise tree, zero padded to a power of
// two (a row sum is >= +0.0, so a zero adds exactly), times f32(1/n)
__global__ void __launch_bounds__(MA_THREADS)
mean_abs_kernel(const float* __restrict__ rowsums, float* __restrict__ scale, unsigned rows,
                unsigned tiles, float inv_n, bool vec) {
  __shared__ float warp_sums[MA_UNROLL][32];
  __shared__ float tile_sums[MA_MAX_TILES];
  const unsigned lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (unsigned k0 = 0; k0 < tiles; k0 += MA_UNROLL) {
    float4 v[MA_UNROLL];
#pragma unroll
    for (int u = 0; u < MA_UNROLL; ++u)
      v[u] = load4(rowsums, (k0 + u) * MA_TILE + 4 * threadIdx.x, rows, vec);
    // levels 1-7: thread t sums 4 row sums, a warp its 128 consecutive ones
#pragma unroll
    for (int u = 0; u < MA_UNROLL; ++u) {
      const float a = warp_tree(sum4(v[u].x, v[u].y, v[u].z, v[u].w));
      if (lane == 0) warp_sums[u][warp] = a;
    }
    __syncthreads();
    // levels 8-12: warp u sums the 32 warps' sums of tile k0 + u
    if (warp < MA_UNROLL) {
      const float a = warp_tree(warp_sums[warp][lane]);
      if (lane == 0 && k0 + warp < tiles) tile_sums[k0 + warp] = a;
    }
    __syncthreads();
  }
  // the tiles' tree, adjacent pairs first; tiles is a power of two
  for (unsigned s = 1; s < tiles; s <<= 1) {
    const unsigned j = 2 * s * threadIdx.x;
    if (j + s < tiles) tile_sums[j] = __fadd_rn(tile_sums[j], tile_sums[j + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) *scale = __fmul_rn(tile_sums[0], inv_n);
}

// (1 - 2 bit) * scale, rounded as the plain version rounds it, so the bits
// hold for every scale (inf and NaN too)
__device__ __forceinline__ float sign_value(uint32_t bit, float s) {
  return __fmul_rn(__fsub_rn(1.0f, __fmul_rn(2.0f, (float)(bit & 1u))), s);
}

__global__ void __launch_bounds__(DQ_THREADS)
sign_unpack_kernel(const uint32_t* __restrict__ words, const float* __restrict__ scale,
                   float* __restrict__ out, unsigned n, unsigned vec_chunks) {
  const float s = *scale;
  const unsigned c0 = blockIdx.x * DQ_TILE + threadIdx.x;
  uint32_t q[DQ_UNROLL];
#pragma unroll
  for (int u = 0; u < DQ_UNROLL; ++u) {     // every load in flight before a store
    const unsigned c = c0 + u * DQ_THREADS;
    if (c < vec_chunks) q[u] = words[c / 8] >> (4 * (c % 8));   // chunk c's nibble
  }
#pragma unroll
  for (int u = 0; u < DQ_UNROLL; ++u) {
    const unsigned c = c0 + u * DQ_THREADS;
    if (c < vec_chunks) {
      __stcs(reinterpret_cast<float4*>(out) + c,
             make_float4(sign_value(q[u], s), sign_value(q[u] >> 1, s),
                         sign_value(q[u] >> 2, s), sign_value(q[u] >> 3, s)));
    } else if (c * DQ_WIDTH < n) {          // the ragged tail, or an unaligned out
      const unsigned end = min(c * DQ_WIDTH + DQ_WIDTH, n);
      for (unsigned i = c * DQ_WIDTH; i < end; ++i)
        out[i] = sign_value(words[i / 32] >> (i % 32), s);
    }
  }
}

// the quantizers' row walk: in step q lane L takes chunk 32q + L (if below
// cpr, the row's chunks) of g and u, the 4 values at base + 4 (32q + L), every
// load in flight before the max; returns the row's scale, max(max|g|, 1e-12)
// (fmaxf is exact in any order).  vec: the row is whole below n and g and u
// are 16-byte aligned (streaming float4 loads); else value by value, g 0.0
// past n
__device__ __forceinline__ float load_row(const float* __restrict__ g,
                                          const float* __restrict__ u, unsigned base,
                                          unsigned cpr, unsigned n, unsigned n_p, bool vec,
                                          float4 (&gv)[4], float4 (&uv)[4]) {
  const unsigned lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned c = 32 * q + lane, i = base + 4 * c;
    gv[q] = uv[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c < cpr && vec) {
      gv[q] = __ldcs(reinterpret_cast<const float4*>(g + i));
      uv[q] = __ldcs(reinterpret_cast<const float4*>(u + i));
    } else if (c < cpr) {
      gv[q] = load4(g, i, n, false);
      uv[q] = load4(u, i, n_p, false);
    }
  }
  float mx = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    mx = fmaxf(fmaxf(fmaxf(fmaxf(mx, fabsf(gv[q].x)), fabsf(gv[q].y)), fabsf(gv[q].z)),
               fabsf(gv[q].w));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  return fmaxf(mx, SCALE_FLOOR);
}

// one value's code in [-levels, levels], as a float: x = g / scale * levels,
// floor(x) + (u < x - floor(x)), clipped; each step rounded once, as the
// plain version rounds it (no FMA).  A g of +-0.0 gives code +0.0 (x = +-0,
// x - floor(x) = +0, and no u is below it), so it is selected without the
// division: IEEE division sends a zero dividend to its slow path, which
// cost the warp a call wherever one of its lanes held a zero (a 2,048-value
// call took 3.8 us instead of 2.0 at one zero in seven)
template <int BITS>
__device__ __forceinline__ float quant_code(float g, float u, float scale) {
  constexpr float LEVELS = (float)((1 << (BITS - 1)) - 1);
  const float x = __fmul_rn(__fdiv_rn(g == 0.0f ? scale : g, scale), LEVELS);
  const float lo = floorf(x);
  const float code = __fadd_rn(lo, u < __fsub_rn(x, lo) ? 1.0f : 0.0f);
  return g == 0.0f ? 0.0f : fminf(fmaxf(code, -LEVELS), LEVELS);
}

// a chunk's 4 codes biased by +levels, code j at bit j * BITS
template <int BITS>
__device__ __forceinline__ uint32_t biased4(float4 g, float4 u, float scale) {
  constexpr float LEVELS = (float)((1 << (BITS - 1)) - 1);
  const float c[4] = {quant_code<BITS>(g.x, u.x, scale), quant_code<BITS>(g.y, u.y, scale),
                      quant_code<BITS>(g.z, u.z, scale), quant_code<BITS>(g.w, u.w, scale)};
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) w |= (uint32_t)(int)__fadd_rn(c[j], LEVELS) << (j * BITS);
  return w;
}

template <int BITS>
__global__ void __launch_bounds__(ROW_THREADS)
quant_pack_kernel(const float* __restrict__ g, const float* __restrict__ u,
                  uint32_t* __restrict__ words, float* __restrict__ scales, unsigned n,
                  unsigned rows, unsigned vec_rows) {
  const unsigned lane = threadIdx.x % 32;
  const unsigned row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= rows) return;
  float4 gv[4], uv[4];
  const float scale = load_row(g, u, row * ROW, ROW / 4, n, rows * ROW, row < vec_rows, gv, uv);
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = biased4<BITS>(gv[q], uv[q], scale);
  uint32_t* out = words + row * (ROW * BITS / 32);
  if (BITS == 8) {
    // lane L's 4 codes of step q are word 32q + L
#pragma unroll
    for (int q = 0; q < 4; ++q) __stcs(out + 32 * q + lane, w[q]);
  } else if (BITS == 4) {
    // lane L's 16 bits are half L % 2 of word 16q + L / 2: whole after xor 1;
    // word 32p + L is word 16q + L % 16 of step q = 2p + L / 16, in lane 2 (L % 16)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] <<= 16 * (lane % 2);
      w[q] |= __shfl_xor_sync(FULL, w[q], 1);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t lo = __shfl_sync(FULL, w[2 * p], 2 * (lane % 16));
      const uint32_t hi = __shfl_sync(FULL, w[2 * p + 1], 2 * (lane % 16));
      __stcs(out + 32 * p + lane, lane < 16 ? lo : hi);
    }
  } else {
    // 2 bits: lane L's byte is byte L % 4 of word 8q + L / 4: whole after xor
    // 1 and 2; word L is word 8q + L % 8 of step q = L / 8, in lane 4 (L % 8)
    uint32_t mine = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] <<= 8 * (lane % 4);
      w[q] |= __shfl_xor_sync(FULL, w[q], 1);
      w[q] |= __shfl_xor_sync(FULL, w[q], 2);
      const uint32_t t = __shfl_sync(FULL, w[q], 4 * (lane % 8));
      if (lane / 8 == q) mine = t;
    }
    __stcs(out + lane, mine);
  }
  if (lane == 0) scales[row] = scale;
}

// the 4 codes of chunk c (values 4c..4c+3), BITS/2 bytes at byte c*BITS/2
template <int BITS>
__device__ __forceinline__ uint32_t chunk_codes(const uint32_t* __restrict__ words,
                                                unsigned c) {
  if (BITS == 8) return words[c];
  if (BITS == 4) return reinterpret_cast<const uint16_t*>(words)[c];
  return reinterpret_cast<const uint8_t*>(words)[c];
}

template <int BITS>
__global__ void __launch_bounds__(DQ_THREADS)
unpack_dequant_kernel(const uint32_t* __restrict__ words, const float* __restrict__ scales,
                      float* __restrict__ out, unsigned n, unsigned vec_chunks) {
  constexpr int CPW = 32 / BITS;
  constexpr unsigned CPR = ROW / DQ_WIDTH;   // chunks per row
  constexpr int LEVELS = (1 << (BITS - 1)) - 1;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  // float(np.float32(1) / np.float32(levels)), rounded once
  constexpr float INV = 1.0f / (float)LEVELS;
  const unsigned c0 = blockIdx.x * DQ_TILE + threadIdx.x;
  uint32_t q[DQ_UNROLL];
  float sc[DQ_UNROLL];
#pragma unroll
  for (int u = 0; u < DQ_UNROLL; ++u) {     // every load in flight before a store
    const unsigned c = c0 + u * DQ_THREADS;
    if (c < vec_chunks) {
      q[u] = chunk_codes<BITS>(words, c);
      sc[u] = scales[c / CPR];
    }
  }
#pragma unroll
  for (int u = 0; u < DQ_UNROLL; ++u) {
    const unsigned c = c0 + u * DQ_THREADS;
    if (c < vec_chunks) {
      const float s = __fmul_rn(sc[u], INV);
      float v[DQ_WIDTH];
#pragma unroll
      for (int j = 0; j < DQ_WIDTH; ++j)
        v[j] = __fmul_rn((float)((int)((q[u] >> (j * BITS)) & MASK) - LEVELS), s);
      __stcs(reinterpret_cast<float4*>(out) + c, make_float4(v[0], v[1], v[2], v[3]));
    } else if (c * DQ_WIDTH < n) {          // the ragged tail, or an unaligned out
      const float s = __fmul_rn(scales[c / CPR], INV);
      const unsigned end = min(c * DQ_WIDTH + DQ_WIDTH, n);
      for (unsigned i = c * DQ_WIDTH; i < end; ++i) {
        const int code = (int)((words[i / CPW] >> ((i % CPW) * BITS)) & MASK) - LEVELS;
        out[i] = __fmul_rn((float)code, s);
      }
    }
  }
}

// a chunk's 4 int8 codes from codes + i: one 4-byte store (vec), or byte by byte
template <int BITS>
__device__ __forceinline__ void store_codes(int8_t* __restrict__ codes, unsigned i, float4 g,
                                            float4 u, float scale, bool vec) {
  const int8_t c[4] = {(int8_t)(int)quant_code<BITS>(g.x, u.x, scale),
                       (int8_t)(int)quant_code<BITS>(g.y, u.y, scale),
                       (int8_t)(int)quant_code<BITS>(g.z, u.z, scale),
                       (int8_t)(int)quant_code<BITS>(g.w, u.w, scale)};
  if (vec) {
    __stcs(reinterpret_cast<unsigned*>(codes + i),
           (uint32_t)(uint8_t)c[0] | (uint32_t)(uint8_t)c[1] << 8 |
               (uint32_t)(uint8_t)c[2] << 16 | (uint32_t)(uint8_t)c[3] << 24);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) codes[i + j] = c[j];
  }
}

template <int BITS>
__global__ void __launch_bounds__(ROW_THREADS)
block_quant_kernel(const float* __restrict__ g, const float* __restrict__ u,
                   int8_t* __restrict__ codes, float* __restrict__ scales, unsigned n,
                   unsigned rows, unsigned block, unsigned vec_rows) {
  const unsigned lane = threadIdx.x % 32;
  const unsigned row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= rows) return;
  const unsigned base = row * block, n_p = rows * block, cpr = block / 4;
  const bool vec = row < vec_rows;
  float scale;
  if (block % 4 == 0 && block <= ROW) {
    // whole chunks, the row in registers: one pass
    float4 gv[4], uv[4];
    scale = load_row(g, u, base, cpr, n, n_p, vec, gv, uv);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned c = 32 * q + lane;
      if (c < cpr) store_codes<BITS>(codes, base + 4 * c, gv[q], uv[q], scale, vec);
    }
  } else {
    // a block that is not a multiple of 4, or longer than 512 values (no
    // path runs either): value by value, strided over the lanes, twice
    float mx = 0.0f;
    for (unsigned j = lane; j < block; j += 32) {
      const unsigned i = base + j;
      if (i < n) mx = fmaxf(mx, fabsf(g[i]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    scale = fmaxf(mx, SCALE_FLOOR);
    for (unsigned j = lane; j < block; j += 32) {
      const unsigned i = base + j;
      codes[i] = (int8_t)(int)quant_code<BITS>(i < n ? g[i] : 0.0f, u[i], scale);
    }
  }
  if (lane == 0) scales[row] = scale;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

// two 16-bit values in one word, a at the lower address
__device__ __forceinline__ uint32_t pair(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}
__device__ __forceinline__ uint32_t pair(__half a, __half b) {
  return (uint32_t)__half_as_ushort(a) | ((uint32_t)__half_as_ushort(b) << 16);
}

// 4 consecutive values to p, aligned to their size, in one streaming store,
// each value rounded once from f32 as store() rounds it
__device__ __forceinline__ void store4(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const float* v) {
  T h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) store(h + j, v[j]);
  __stcs(reinterpret_cast<uint2*>(p), make_uint2(pair(h[0], h[1]), pair(h[2], h[3])));
}

template <typename T>
__global__ void __launch_bounds__(DQ_THREADS)
block_dequant_kernel(const int8_t* __restrict__ codes, const float* __restrict__ scales,
                     T* __restrict__ out, unsigned n, unsigned block, int bits,
                     unsigned vec_chunks) {
  // float(np.float32(1) / np.float32(levels)), rounded once, once per thread
  const float inv = __fdiv_rn(1.0f, (float)((1 << (bits - 1)) - 1));
  const unsigned cpr = block / DQ_WIDTH;     // chunks per row on the vector path
  const unsigned c0 = blockIdx.x * DQ_TILE + threadIdx.x;
  int q[DQ_UNROLL];
  float sc[DQ_UNROLL];
#pragma unroll
  for (int u = 0; u < DQ_UNROLL; ++u) {     // every load in flight before a store
    const unsigned c = c0 + u * DQ_THREADS;
    if (c < vec_chunks) {
      q[u] = reinterpret_cast<const int*>(codes)[c];
      sc[u] = scales[c / cpr];                // block % 4 == 0: one row a chunk
    }
  }
#pragma unroll
  for (int u = 0; u < DQ_UNROLL; ++u) {
    const unsigned c = c0 + u * DQ_THREADS;
    if (c < vec_chunks) {
      const float s = __fmul_rn(sc[u], inv);
      float v[DQ_WIDTH];
#pragma unroll
      for (int j = 0; j < DQ_WIDTH; ++j) v[j] = __fmul_rn((float)(int8_t)(q[u] >> (8 * j)), s);
      store4(out + c * DQ_WIDTH, v);
    } else if (c * DQ_WIDTH < n) {
      // any block, the ragged tail, unaligned operands: value by value, the
      // row found once and stepped where the chunk crosses into the next
      const unsigned i0 = c * DQ_WIDTH, end = min(i0 + DQ_WIDTH, n);
      unsigned row = i0 / block, off = i0 - row * block;
      float s = __fmul_rn(scales[row], inv);
      for (unsigned i = i0; i < end; ++i, ++off) {
        if (off == block) {
          off = 0;
          s = __fmul_rn(scales[++row], inv);
        }
        store(out + i, __fmul_rn((float)codes[i], s));
      }
    }
  }
}

// a chunk of 4 values a thread over the n = rows m values of a (rows, m)
// matrix; on the vector path (m % 4 == 0) a chunk lies in one row and one
// 512-column block: row c / (m / 4), block (c % (m / 4)) / 128
__global__ void __launch_bounds__(CDQ_THREADS)
coeff_dequant_kernel(const int8_t* __restrict__ codes, const float* __restrict__ scales,
                     float* __restrict__ out, unsigned n, unsigned m, unsigned nb,
                     unsigned vec_chunks) {
  constexpr unsigned CPB = ROW / DQ_WIDTH;   // chunks a 512-column block
  const unsigned c = blockIdx.x * CDQ_THREADS + threadIdx.x;
  if (c < vec_chunks) {
    const unsigned cpr = m / DQ_WIDTH, row = c / cpr;
    const int q = reinterpret_cast<const int*>(codes)[c];
    const float s = __fmul_rn(scales[row * nb + (c - row * cpr) / CPB], INV127);
    float v[DQ_WIDTH];
#pragma unroll
    for (int j = 0; j < DQ_WIDTH; ++j) v[j] = __fmul_rn((float)(int8_t)(q >> (8 * j)), s);
    store4(out + c * DQ_WIDTH, v);
  } else if (c * DQ_WIDTH < n) {
    // a row whose m is not a multiple of 4, or unaligned operands: value by
    // value, the row found once and stepped where the chunk crosses into
    // the next
    const unsigned i0 = c * DQ_WIDTH, end = min(i0 + DQ_WIDTH, n);
    unsigned row = i0 / m, col = i0 - row * m;
    for (unsigned i = i0; i < end; ++i, ++col) {
      if (col == m) {
        col = 0;
        ++row;
      }
      out[i] = __fmul_rn((float)codes[i], __fmul_rn(scales[row * nb + col / ROW], INV127));
    }
  }
}

inline unsigned grid_for(long long items, int per_block) {
  return (unsigned)((items + per_block - 1) / per_block);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// the dequantizers' and sign_unpack's plan (wire.dequant_plan): n < 2^31 outputs in chunks of 4
// values, the first vec_chunks on the vector path, grid blocks of DQ_TILE chunks
inline bool dequant_plan_ok(long long n, long long vec_chunks, int grid) {
  return n >= 1 && n <= 0x7fffffffLL && vec_chunks >= 0 && vec_chunks <= n / DQ_WIDTH &&
         grid >= 1 && (unsigned)grid == grid_for((n + DQ_WIDTH - 1) / DQ_WIDTH, DQ_TILE);
}

// coeff_dequant's plan (wire.coeff_dequant_plan): as the dequantizers', but
// grid blocks of CDQ_THREADS chunks, a chunk a thread
inline bool coeff_dequant_plan_ok(long long n, long long vec_chunks, int grid) {
  return n >= 1 && n <= 0x7fffffffLL && vec_chunks >= 0 && vec_chunks <= n / DQ_WIDTH &&
         grid >= 1 && (unsigned)grid == grid_for((n + DQ_WIDTH - 1) / DQ_WIDTH, CDQ_THREADS);
}

// the quantizers' plan (wire.quant_plan): n values in rows of `block`, n_p =
// rows * block < 2^31, the first vec_rows rows (whole below n; block % 4 == 0
// and block <= 512) on the vector path, grid blocks of ROWS_PER_BLOCK rows
inline bool quant_plan_ok(long long n, int block, long long vec_rows, int grid) {
  if (n < 1 || block < 1) return false;
  const long long rows = (n + block - 1) / block;
  return rows * block <= 0x7fffffffLL && vec_rows >= 0 && vec_rows <= n / block &&
         (vec_rows == 0 || (block % 4 == 0 && block <= ROW)) && grid >= 1 &&
         (unsigned)grid == grid_for(rows, ROWS_PER_BLOCK);
}

// g (n,) f32, n < 2^31 -> words (ceil(n/32),) u32, rowsums (ceil(n/512),) f32 and
// scale () f32, the rows' pairwise sum times inv_n = f32(1/n) (ref.recip32(n)):
// sign_pack_kernel, then mean_abs_kernel on the same stream
extern "C" int wire_sign_pack_f32(const float* g, uint32_t* words, float* rowsums,
                                   float* scale, long long n, float inv_n, void* stream) {
  if (n < 1 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned nn = (unsigned)n, rows = (nn + ROW - 1) / ROW;
  unsigned padded = MA_TILE;                // the tree's width, a power of two
  while (padded < rows) padded <<= 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sign_pack_kernel<<<grid_for(rows, ROWS_PER_BLOCK), ROW_THREADS, 0, s>>>(
      g, words, rowsums, nn, rows, aligned16(g));
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  mean_abs_kernel<<<1, MA_THREADS, 0, s>>>(rowsums, scale, rows, padded / MA_TILE, inv_n,
                                           aligned16(rowsums));
  return (int)cudaGetLastError();
}

// words (ceil(n/32),) u32, scale () f32 on the device -> out (n,) f32, by the
// plan of wire.dequant_plan(n, 512, out 16-byte aligned)
extern "C" int wire_sign_unpack_f32(const uint32_t* words, const float* scale, float* out,
                                     long long n, long long vec_chunks, int grid,
                                     void* stream) {
  if (!dequant_plan_ok(n, vec_chunks, grid) || (vec_chunks > 0 && !aligned16(out)))
    return (int)cudaErrorInvalidValue;
  sign_unpack_kernel<<<grid, DQ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      words, scale, out, (unsigned)n, (unsigned)vec_chunks);
  return (int)cudaGetLastError();
}

// g (n,) f32, u (n_p,) f32 with n_p = ceil(n/512)*512 < 2^31 -> words
// (n_p*bits/32,) u32, scales (n_p/512,) f32, by the plan of wire.quant_plan(n,
// 512, g and u 16-byte aligned)
extern "C" int wire_quant_pack_f32(const float* g, const float* u, uint32_t* words,
                                    float* scales, long long n, int bits, long long vec_rows,
                                    int grid, void* stream) {
  if (!quant_plan_ok(n, ROW, vec_rows, grid) || (bits != 2 && bits != 4 && bits != 8) ||
      (vec_rows > 0 && !(aligned16(g) && aligned16(u))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nn = (unsigned)n, rows = (nn + ROW - 1) / ROW, vr = (unsigned)vec_rows;
  switch (bits) {
    case 2: quant_pack_kernel<2><<<grid, ROW_THREADS, 0, s>>>(g, u, words, scales, nn, rows, vr); break;
    case 4: quant_pack_kernel<4><<<grid, ROW_THREADS, 0, s>>>(g, u, words, scales, nn, rows, vr); break;
    default: quant_pack_kernel<8><<<grid, ROW_THREADS, 0, s>>>(g, u, words, scales, nn, rows, vr); break;
  }
  return (int)cudaGetLastError();
}

// words (n_p*bits/32,) u32, scales (n_p/512,) f32 -> out (n,) f32, n <= n_p
extern "C" int wire_unpack_dequant_f32(const uint32_t* words, const float* scales,
                                        float* out, long long n, int bits,
                                        long long vec_chunks, int grid, void* stream) {
  if (!dequant_plan_ok(n, vec_chunks, grid) || (bits != 2 && bits != 4 && bits != 8) ||
      (vec_chunks > 0 && !aligned16(out)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nn = (unsigned)n, vc = (unsigned)vec_chunks;
  switch (bits) {
    case 2: unpack_dequant_kernel<2><<<grid, DQ_THREADS, 0, s>>>(words, scales, out, nn, vc); break;
    case 4: unpack_dequant_kernel<4><<<grid, DQ_THREADS, 0, s>>>(words, scales, out, nn, vc); break;
    default: unpack_dequant_kernel<8><<<grid, DQ_THREADS, 0, s>>>(words, scales, out, nn, vc); break;
  }
  return (int)cudaGetLastError();
}

// g (n,) f32, u (n_p,) f32 with n_p = ceil(n/block)*block < 2^31 -> codes
// (n_p,) int8, scales (n_p/block,) f32; 2 <= bits <= 8; by the plan of
// wire.quant_plan(n, block, g and u 16-byte and codes 4-byte aligned)
extern "C" int quant_block_quant_f32(const float* g, const float* u, int8_t* codes,
                                      float* scales, long long n, int block, int bits,
                                      long long vec_rows, int grid, void* stream) {
  if (!quant_plan_ok(n, block, vec_rows, grid) || bits < 2 || bits > 8 ||
      (vec_rows > 0 && !(aligned16(g) && aligned16(u) && ((uintptr_t)codes & 3u) == 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nn = (unsigned)n, bl = (unsigned)block, rows = (nn + bl - 1) / bl,
                 vr = (unsigned)vec_rows;
#define BLOCK_QUANT(B)                                                                  \
  case B:                                                                               \
    block_quant_kernel<B><<<grid, ROW_THREADS, 0, s>>>(g, u, codes, scales, nn, rows, bl, vr); \
    break;
  switch (bits) {
    BLOCK_QUANT(2) BLOCK_QUANT(3) BLOCK_QUANT(4) BLOCK_QUANT(5) BLOCK_QUANT(6) BLOCK_QUANT(7)
    BLOCK_QUANT(8)
  }
#undef BLOCK_QUANT
  return (int)cudaGetLastError();
}

// codes (n_p,) int8, scales (n_p/block,) f32 -> out (n,), n <= n_p, of type
// out_kind: 0 f32, 1 bf16, 2 f16; the vector path needs block % 4 == 0, codes
// 4-byte and out 16-byte aligned
extern "C" int quant_block_dequant(const int8_t* codes, const float* scales, void* out,
                                   long long n, int block, int bits, int out_kind,
                                   long long vec_chunks, int grid, void* stream) {
  if (!dequant_plan_ok(n, vec_chunks, grid) || block < 1 || bits < 2 || bits > 8 ||
      (vec_chunks > 0 && !(block % DQ_WIDTH == 0 && ((uintptr_t)codes & 3u) == 0 &&
                           aligned16(out))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nn = (unsigned)n, vc = (unsigned)vec_chunks, bl = (unsigned)block;
  switch (out_kind) {
    case 0: block_dequant_kernel<<<grid, DQ_THREADS, 0, s>>>(
        codes, scales, static_cast<float*>(out), nn, bl, bits, vc); break;
    case 1: block_dequant_kernel<<<grid, DQ_THREADS, 0, s>>>(
        codes, scales, static_cast<__nv_bfloat16*>(out), nn, bl, bits, vc); break;
    case 2: block_dequant_kernel<<<grid, DQ_THREADS, 0, s>>>(
        codes, scales, static_cast<__half*>(out), nn, bl, bits, vc); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// codes (L, k, m) int8, scales (L, k, ceil(m/512)) f32 -> out (L, k, m) f32:
// rows = L k rows of m values, n = rows m < 2^31, by the plan of
// wire.coeff_dequant_plan(n, m, codes 4-byte and out 16-byte aligned)
extern "C" int wire_coeff_dequant_f32(const int8_t* codes, const float* scales, float* out,
                                       long long rows, int m, long long vec_chunks, int grid,
                                       void* stream) {
  if (rows < 1 || m < 1 || rows > 0x7fffffffLL / m ||
      !coeff_dequant_plan_ok(rows * m, vec_chunks, grid) ||
      (vec_chunks > 0 && !(m % DQ_WIDTH == 0 && ((uintptr_t)codes & 3u) == 0 && aligned16(out))))
    return (int)cudaErrorInvalidValue;
  coeff_dequant_kernel<<<grid, CDQ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      codes, scales, out, (unsigned)(rows * m), (unsigned)m, (unsigned)((m + ROW - 1) / ROW),
      (unsigned)vec_chunks);
  return (int)cudaGetLastError();
}
