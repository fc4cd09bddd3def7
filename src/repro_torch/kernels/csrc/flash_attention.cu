// Flash attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see kernels/_build.py).
//
// flash_attention_fwd: q (B, Sq, H, hd), k and v (B, Skv, KV, hd), all f32 or
// all bf16, contiguous, H a multiple of KV, hd <= 256 -> o (B, Sq, H, hd) in
// q's dtype.  Query head h reads key/value head h / (H / KV): grouped-query
// attention with K and V never repeated.  Scores are (q * scale) . k in f32;
// a score is masked to -1e30 where causal and kpos > qpos, or where
// window > 0 and kpos <= qpos - window (positions count from 0 in q and in
// k), and a key past Skv scores -inf; the online softmax keeps a running
// max m, sum l and accumulator acc per query row, rescaled by exp(m_old -
// m_new) at each key tile; p is rounded to v's dtype before P.V (a no-op in
// f32), and o = acc / max(l, 1e-30).  A row that sees no key (a window, and
// qpos >= Skv + window - 1) averages V over all Skv keys, as the reference.
//
// Replaces (JAX/Pallas TPU reference):
//   src/repro/kernels/flash_attention.py::flash_attention_pallas
// The TPU kernel asserts Sq % block_q == 0 and Skv % block_kv == 0, a
// constraint of its tiling; this kernel takes any Sq and Skv and masks the
// ragged tiles.
//
// What bounds it on an H100 SXM: operations.  QK^T and PV are 4 * B * H *
// hd FLOP per visible (query, key) pair, against q + k + v + o bytes read or
// written once.  Single-pass TF32 breaks the f32 tolerance (a score at hd
// 256 carries ~1e-3 relative error), so both products run in 3xTF32 on the
// tensor cores (mma.sync m16n8k8, three TF32 products for each f32 one, at
// a third of the 495 TFLOP/s TF32 rate); the exponentials and the rescale
// stay in FP32 on the CUDA cores.  wgmma and bf16 MMAs are later work.
//
// Design:
//   * flash_fwd_kernel: a block of 8 warps owns 64 query rows of one (head,
//     batch row) and a range of key tiles (a work item, below).  The scaled
//     Q tile sits in shared memory; K and V tiles of 32 keys stream through
//     a two-stage cp.async ring (pitch HD + 4 floats: the fragment reads hit
//     32 distinct banks), so the next tile's copy overlaps this tile's MMAs
//     (199,680 B at hd 256: one block an SM; two at hd <= 64).  Warp w owns
//     rows 16 (w % 4)..+15 and keys 16 (w / 4)..+15 of every tile, with its
//     own (m, l, acc): at hd 256 one block is all an SM holds, and the key
//     halves give each scheduler two warps to hide the MMA and shared-memory
//     latencies.  At the item's end the two halves of a row merge through
//     shared memory (exp(m_half - m) weights, first half first).  bf16
//     inputs convert to f32 as they load.
//   * The scores stay in registers: S = Q K^T is a 16 x 16 accumulator per
//     warp; the row max and row sum reduce over the 4 lanes that share a row
//     (the sum once, at the end).  P feeds P.V from the same registers: the
//     A fragment wants (row g, k t) and (row g, k t + 4) where the C
//     fragment holds keys 2t and 2t + 1, so k-index t stands for key 2t and
//     t + 4 for key 2t + 1, and V's fragment is read from rows 2t and 2t + 1
//     to match -- no shuffle and no shared P tile.
//   * Key tiles that lie wholly above the diagonal (causal) or before every
//     row's window are skipped (a masked score adds exp(-1e30 - m) = 0 once
//     the row has seen a real score); a q-tile holding a row that sees no
//     key walks every tile, as the TPU kernel does.
//   * A balanced grid (kernels/flash_attention.flash_plan, from the shapes
//     alone): a q-tile's range of key tiles splits into chunks of at most
//     `chunk` tiles, one work item each, in the manner of flash-decoding; a
//     q-tile of one chunk writes o itself, the others write their partial
//     (acc, m, l) to the wrapper's scratch, and flash_combine_kernel merges
//     them chunk by chunk in order (no atomics: two calls give the same
//     bits), a float4 a thread.  Grid (nq * nc, H, B), the longest q-tiles
//     first; an item past its q-tile's chunk count exits at once.
//   * HD is hd rounded up to 32, 64, 128 or 256: the padded columns load as
//     0.0 and add nothing; only the hd real ones are written.
//   * expf; o = acc / max(l, 1e-30) by __fdividef (within 2 ulp: the IEEE
//     division's slow-path call would spill registers at hd 256); no
//     --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block (flash_plan's BLOCK_Q)
constexpr int BKV = 32;           // keys per tile (flash_plan's BLOCK_KV)
constexpr int ROW_GROUPS = BQ / 16;
constexpr int KEYS_PER_WARP = BKV / 2;
constexpr int THREADS = 32 * 2 * ROW_GROUPS;   // 8 warps: 4 row groups x 2 key halves
constexpr int STAGES = 2;
constexpr int CB_THREADS = 128;   // the combine kernel's block: a float4 a thread
constexpr int CB_FLOATS = 4 * CB_THREADS;
constexpr float NEG = -1e30f;     // a masked score, as the TPU kernel's _NEG
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// p.astype(v.dtype): identity in f32, one rounding to bf16 otherwise
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// reduce over the 4 lanes (t) that share a fragment row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// the key tiles [t_lo, t_hi) that some row of q-tile qt may see
// (flash_attention.tile_range): never empty
__device__ __forceinline__ void tile_range(int qt, int Sq, int Skv, int causal, int window,
                                           int& t_lo, int& t_hi) {
  const int q0 = qt * BQ, q_last = min(q0 + BQ, Sq) - 1;
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(Skv, q_last + 1);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  if (window > 0 && q_last >= Skv + window - 1) {   // a row that sees no key
    k_lo = 0;
    k_hi = Skv;
  }
  t_lo = k_lo / BKV;
  t_hi = (k_hi + BKV - 1) / BKV;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(HD + 4) * (BQ + 2 * STAGES * BKV);
}
// floats of one partial: acc (BQ x HD), then (m, l) per row
template <int HD>
__host__ __device__ constexpr int slot_floats() { return BQ * (HD + 2); }

// rows [row0, row0 + ROWS) of x (positions `stride` elements apart), columns
// [0, HD), into dst (pitch HD + 4) as f32, zero past nrows or hd.  f32: by
// cp.async (vec: hd % 4 == 0 and 16-byte aligned rows); bf16: converted
// through registers.
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride,
                                          int row0, int nrows, int hd, bool vec) {
  constexpr int P = HD + 4;
  if (vec) {
    constexpr int Q = HD / 4;
    for (int idx = threadIdx.x; idx < ROWS * Q; idx += THREADS) {
      const int r = idx / Q, c = 4 * (idx % Q), gr = row0 + r;
      const bool ok = gr < nrows && c < hd;
      cp_async16(dst + r * P + c, ok ? src + gr * stride + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * HD; idx += THREADS) {
      const int r = idx / HD, c = idx % HD, gr = row0 + r;
      const bool ok = gr < nrows && c < hd;
      cp_async4(dst + r * P + c, ok ? src + gr * stride + c : src, ok);
    }
  }
}
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const __nv_bfloat16* src,
                                          long long stride, int row0, int nrows, int hd, bool) {
  constexpr int P = HD + 4;
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD, gr = row0 + r;
    dst[r * P + c] = (gr < nrows && c < hd) ? __bfloat162float(src[gr * stride + c]) : 0.0f;
  }
}

// Q's tile, copied by load_rows, times scale in place (q * scale rounded
// once, as the reference): each thread scales the elements it copied, once
// its copies have landed (f32); bf16 loads and scales through registers.
template <int HD>
__device__ __forceinline__ void load_q(float* Qs, const float* src, long long stride, int row0,
                                       int nrows, int hd, float, bool vec) {
  load_rows<HD, BQ>(Qs, src, stride, row0, nrows, hd, vec);
}
template <int HD>
__device__ __forceinline__ void load_q(float* Qs, const __nv_bfloat16* src, long long stride,
                                       int row0, int nrows, int hd, float scale, bool) {
  constexpr int P = HD + 4;
  for (int idx = threadIdx.x; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD, gr = row0 + r;
    Qs[r * P + c] =
        (gr < nrows && c < hd) ? __fmul_rn(__bfloat162float(src[gr * stride + c]), scale) : 0.0f;
  }
}
template <int HD>
__device__ __forceinline__ void scale_q(float* Qs, const float*, float scale, bool vec) {
  constexpr int P = HD + 4;
  const int per = vec ? 4 : 1;            // load_rows's mapping of threads to elements
  for (int idx = threadIdx.x; idx < BQ * HD / per; idx += THREADS) {
    const int r = idx / (HD / per), c = per * (idx % (HD / per));
    for (int e = 0; e < per; ++e) Qs[r * P + c + e] = __fmul_rn(Qs[r * P + c + e], scale);
  }
}
template <int HD>
__device__ __forceinline__ void scale_q(float*, const __nv_bfloat16*, float, bool) {}

// blocks an SM holds: by shared memory at hd 256 and 128, registers below
template <int HD>
constexpr int min_blocks() { return HD <= 64 ? 2 : 1; }

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, min_blocks<HD>())
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ part, int Sq, int Skv, int H, int KV,
                 int hd, float scale, int causal, int window, int chunk, int nc, int vec) {
  constexpr int P = HD + 4;
  constexpr int NT = HD / 8;      // output n-tiles; k-steps of Q K^T
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // BQ x P, q * scale
  float* Ks = Qs + BQ * P;        // STAGES x BKV x P
  float* Vs = Ks + STAGES * BKV * P;

  const int nq = (Sq + BQ - 1) / BQ;
  const int qt = nq - 1 - (int)(blockIdx.x / nc), c = (int)(blockIdx.x % nc);
  int t_lo, t_hi;
  tile_range(qt, Sq, Skv, causal, window, t_lo, t_hi);
  const int n_chunks = (t_hi - t_lo + chunk - 1) / chunk;
  if (c >= n_chunks) return;
  const int t_begin = t_lo + c * chunk, ntile = min(t_hi - t_begin, chunk);

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long qstride = (long long)H * hd;    // between positions of q and o
  const long long kstride = (long long)KV * hd;   // between positions of k and v
  const T* qb = q + ((long long)b * Sq * H + h) * hd;
  const T* kb = k + ((long long)b * Skv * KV + kvh) * hd;
  const T* vb = v + ((long long)b * Skv * KV + kvh) * hd;
  const int q0 = qt * BQ;

  load_q<HD>(Qs, qb, qstride, q0, Sq, hd, scale, vec);
  load_rows<HD, BKV>(Ks, kb, kstride, t_begin * BKV, Skv, hd, vec);
  load_rows<HD, BKV>(Vs, vb, kstride, t_begin * BKV, Skv, hd, vec);
  cp_async_commit();

  // warp w: rows 16 (w % 4) .. + 15 of the tile, keys 16 (w / 4) .. + 15 of
  // each key tile, with its own (m, l, acc); the two halves merge at the end
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * (warp % ROW_GROUPS), kh = KEYS_PER_WARP * (warp / ROW_GROUPS);
  const int g = lane / 4, tg = lane % 4;
  const int qp[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.0f, 0.0f};   // l_r: this lane's share

  for (int it = 0; it < ntile; ++it) {
    cp_async_wait<0>();
    if (it == 0) scale_q<HD>(Qs, qb, scale, vec);
    __syncthreads();              // tile it landed everywhere; tile it-1 is consumed
    if (it + 1 < ntile) {
      const int st = (it + 1) % STAGES;
      load_rows<HD, BKV>(Ks + st * BKV * P, kb, kstride, (t_begin + it + 1) * BKV, Skv, hd, vec);
      load_rows<HD, BKV>(Vs + st * BKV * P, vb, kstride, (t_begin + it + 1) * BKV, Skv, hd, vec);
    }
    cp_async_commit();
    const float* Kt = Ks + (it % STAGES) * BKV * P + kh * P;
    const float* Vt = Vs + (it % STAGES) * BKV * P + kh * P;
    const int kv0 = (t_begin + it) * BKV + kh;

    // S = (q * scale) K^T: 16 rows x 16 keys a warp, 2 n-tiles of 8 keys
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < HD; kk += 8) {   // 8 k-steps at a time: no spill at hd 256
      const float* qa = Qs + (r0 + g) * P + kk + tg;
      uint32_t ah[4], al[4];
      split_tf32(qa[0], ah[0], al[0]);
      split_tf32(qa[8 * P], ah[1], al[1]);
      split_tf32(qa[4], ah[2], al[2]);
      split_tf32(qa[8 * P + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* kr = Kt + (8 * j + g) * P + kk + tg;
        uint32_t bh[2], bl[2];
        split_tf32(kr[0], bh[0], bl[0]);
        split_tf32(kr[4], bh[1], bl[1]);
        mma_3xtf32(s[j], ah, al, bh, bl);
      }
    }

    // mask; the online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qp[e / 2], kp = kv0 + 8 * j + 2 * tg + (e & 1);
        const bool ok = (!causal || kp <= qpos) && (window <= 0 || kp > qpos - window);
        s[j][e] = kp >= Skv ? -INFINITY : (ok ? s[j][e] : NEG);
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_r[e / 2]);
        l_r[e / 2] += p;
        s[j][e] = round_as(p, vb);
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V: k-step j covers the warp's keys 8j..8j+7, k-index t
    // standing for key 8j + 2t and t + 4 for key 8j + 2t + 1 (P's C fragment
    // as it is)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
      const float* v0 = Vt + (8 * j + 2 * tg) * P + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bh[2], bl[2];
        split_tf32(v0[8 * n], bh[0], bl[0]);
        split_tf32(v0[P + 8 * n], bh[1], bl[1]);
        mma_3xtf32(acc[n], ph, pl, bh, bl);
      }
    }
  }
  cp_async_wait<0>();

  // merge the two key halves in shared memory (K's and V's stages are free):
  // the second half's warps write (acc, m, l), the first half's add them
  float l_row[2] = {quad_sum(l_r[0]), quad_sum(l_r[1])};
  constexpr int XP = HD + 8;      // pitch: a half-warp's float2 hits 16 bank pairs
  float* xacc = Ks;               // BQ x XP
  float* xml = Ks + BQ * XP;      // BQ x (m, l)
  __syncthreads();
  if (kh != 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(xacc + row * XP + 8 * n + 2 * tg) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      if (tg == 0) *reinterpret_cast<float2*>(xml + 2 * row) = make_float2(m_r[r], l_row[r]);
    }
  }
  __syncthreads();
  if (kh != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const float2 ml = *reinterpret_cast<const float2*>(xml + 2 * row);
    const float m = fmaxf(m_r[r], ml.x);
    const float a0 = expf(m_r[r] - m), a1 = expf(ml.x - m);
    m_r[r] = m;
    l_row[r] = a0 * l_row[r] + a1 * ml.y;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 x = *reinterpret_cast<const float2*>(xacc + row * XP + 8 * n + 2 * tg);
      acc[n][2 * r] = a0 * acc[n][2 * r] + a1 * x.x;
      acc[n][2 * r + 1] = a0 * acc[n][2 * r + 1] + a1 * x.y;
    }
  }

  if (n_chunks == 1) {
    T* ob = o + ((long long)b * Sq * H + h) * hd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qp[r] >= Sq) continue;
      const float denom = fmaxf(l_row[r], 1e-30f);
      T* orow = ob + qp[r] * qstride;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int d = 8 * n + 2 * tg;
        if (d < hd) store(orow + d, __fdividef(acc[n][2 * r], denom));
        if (d + 1 < hd) store(orow + d + 1, __fdividef(acc[n][2 * r + 1], denom));
      }
    }
  } else {
    float* slot = part + ((((long long)b * H + h) * nq + qt) * nc + c) * slot_floats<HD>();
    float* ml = slot + BQ * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(slot + row * HD + 8 * n + 2 * tg) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      if (tg == 0) *reinterpret_cast<float2*>(ml + 2 * row) = make_float2(m_r[r], l_row[r]);
    }
  }
}

// o for the q-tiles of more than one chunk.  Block (x, h, b) covers CB_FLOATS
// consecutive floats of q-tile x / (BQ * HD / CB_FLOATS)'s rows, a thread one
// float4: m = max_c m_c, w_c = exp(m_c - m), o = (sum_c w_c acc_c) /
// max(sum_c w_c l_c, 1e-30), both sums in chunk order
template <typename T, int HD>
__global__ void __launch_bounds__(CB_THREADS)
flash_combine_kernel(const float* __restrict__ part, T* __restrict__ o, int Sq, int Skv,
                     int H, int hd, int causal, int window, int chunk, int nc) {
  constexpr int PER_QT = BQ * HD / CB_FLOATS;     // blocks a q-tile
  const int qt = blockIdx.x / PER_QT, h = blockIdx.y, b = blockIdx.z;
  const int nq = (Sq + BQ - 1) / BQ;
  int t_lo, t_hi;
  tile_range(qt, Sq, Skv, causal, window, t_lo, t_hi);
  const int n_chunks = (t_hi - t_lo + chunk - 1) / chunk;
  const int e = (blockIdx.x % PER_QT) * CB_FLOATS + 4 * threadIdx.x;
  const int row = e / HD, d = e % HD, qpos = qt * BQ + row;
  if (n_chunks <= 1 || qpos >= Sq || d >= hd) return;
  T* orow = o + (((long long)b * Sq + qpos) * H + h) * hd;
  const float* base = part + (((long long)b * H + h) * nq + qt) * nc * slot_floats<HD>();
  float m = -INFINITY;
  for (int ch = 0; ch < n_chunks; ++ch)
    m = fmaxf(m, base[ch * slot_floats<HD>() + BQ * HD + 2 * row]);
  float l = 0.0f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const float* sl = base + ch * slot_floats<HD>();
    const float2 ml = *reinterpret_cast<const float2*>(sl + BQ * HD + 2 * row);
    const float4 x = *reinterpret_cast<const float4*>(sl + row * HD + d);
    const float w = expf(ml.x - m);
    l += w * ml.y;
    a = make_float4(a.x + w * x.x, a.y + w * x.y, a.z + w * x.z, a.w + w * x.w);
  }
  const float denom = fmaxf(l, 1e-30f);
  store(orow + d, __fdividef(a.x, denom));
  if (d + 1 < hd) store(orow + d + 1, __fdividef(a.y, denom));
  if (d + 2 < hd) store(orow + d + 2, __fdividef(a.z, denom));
  if (d + 3 < hd) store(orow + d + 3, __fdividef(a.w, denom));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int HD>
int launch(const T* q, const T* k, const T* v, T* o, float* part, int B, int Sq, int Skv,
           int H, int KV, int hd, float scale, int causal, int window, int chunk, int nc,
           cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<HD>();
  static_assert(bytes <= 232448, "the tiles exceed a block's shared memory");
  // The opt-in holds for the current device only: set it before every launch
  // (it is cheap and idempotent), so a call on any card finds it set.
  const cudaError_t rc = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  const int vec = hd % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const int nq = (Sq + BQ - 1) / BQ;
  flash_fwd_kernel<T, HD><<<dim3(nq * nc, H, B), THREADS, bytes, s>>>(
      q, k, v, o, part, Sq, Skv, H, KV, hd, scale, causal, window, chunk, nc, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nc == 1) return (int)err;
  flash_combine_kernel<T, HD><<<dim3(nq * (BQ * HD / CB_FLOATS), H, B), CB_THREADS, 0, s>>>(
      part, o, Sq, Skv, H, hd, causal, window, chunk, nc);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* part, int B, int Sq,
             int Skv, int H, int KV, int hd, float scale, int causal, int window, int chunk,
             int nc, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (hd <= 32)
    return launch<T, 32>(qt, kt, vt, ot, part, B, Sq, Skv, H, KV, hd, scale, causal, window,
                         chunk, nc, s);
  if (hd <= 64)
    return launch<T, 64>(qt, kt, vt, ot, part, B, Sq, Skv, H, KV, hd, scale, causal, window,
                         chunk, nc, s);
  if (hd <= 128)
    return launch<T, 128>(qt, kt, vt, ot, part, B, Sq, Skv, H, KV, hd, scale, causal, window,
                          chunk, nc, s);
  return launch<T, 256>(qt, kt, vt, ot, part, B, Sq, Skv, H, KV, hd, scale, causal, window,
                        chunk, nc, s);
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Skv, KV, hd), o (B, Sq, H, hd), contiguous;
// dtype: 0 f32, 1 bf16 (all four tensors); causal 0 or 1; window <= 0 is
// none; (chunk, nc) the split plan (flash_attention.flash_plan): chunks of
// at most `chunk` key tiles, at most nc a q-tile; part the scratch for the
// partials, B * H * ceil(Sq/64) * nc slots of 64 * (HD + 2) floats (HD: hd
// rounded up to 32, 64, 128 or 256), unused (may be null) when nc == 1.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* part, int B, int Sq, int Skv, int H, int KV, int hd,
                                   int dtype, float scale, int causal, int window, int chunk,
                                   int nc, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || hd < 1 || hd > 256 ||
      B > 65535 || H > 65535 || chunk < 1 || nc < 1 ||
      (long long)((Sq + BQ - 1) / BQ) * nc > 0x7fffffff || (nc > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, part, B, Sq, Skv, H, KV, hd, scale, causal, window,
                           chunk, nc, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, part, B, Sq, Skv, H, KV, hd, scale, causal,
                                   window, chunk, nc, s);
  return (int)cudaErrorInvalidValue;
}
