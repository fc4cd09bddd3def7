// Flash attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see kernels/_build.py).
//
// flash_attention_fwd: q (B, Sq, H, hd), k and v (B, Skv, KV, hd), all f32 or
// all bf16, contiguous, H a multiple of KV, hd <= 256 -> o (B, Sq, H, hd) in
// q's dtype.  Query head h reads key/value head h / (H / KV): grouped-query
// attention with K and V never repeated.  Scores are (q * scale) . k in f32;
// a score is masked to -1e30 where causal and kpos > qpos, or where
// window > 0 and kpos <= qpos - window (positions count from 0 in q and in
// k); the online softmax keeps a running max m, sum l and accumulator acc
// per query row, rescaled by exp(m_old - m_new) at each key tile; p is
// rounded to v's dtype before P.V (a no-op in f32), and o = acc / max(l,
// 1e-30).
//
// Replaces (JAX/Pallas TPU reference):
//   src/repro/kernels/flash_attention.py::flash_attention_pallas
// The TPU kernel asserts Sq % block_q == 0 and Skv % block_kv == 0, a
// constraint of its tiling; this kernel takes any Sq and Skv and masks the
// ragged tiles (a key past Skv scores -inf, so it adds nothing).
//
// What bounds it on an H100 SXM: FP32 operations.  QK^T and PV are
// 4 * B * H * Sq * Skv_eff * hd FLOP, Skv_eff the keys a query row may see
// (about Skv / 2 causal, the window with a window), against q + k + v + o
// bytes read or written once: at the eval shapes (hd 64 and 256, seq 256 to
// 1024) the operations take 3 to 10 times as long as the bytes at 67 TFLOP/s
// and 3.35 TB/s.  This first design runs on the CUDA cores in f32; tensor
// cores (wgmma, or 3xTF32 to keep the f32 tolerance) and TMA are later work.
//
// Design (simple and right first):
//   * one block of 256 threads per (64 query rows, query head, batch row);
//     the Q tile (scaled), one 64-key K tile and its V tile sit in shared
//     memory as f32 (213,760 bytes at hd 256, hence the opt-in above 48 KB);
//   * thread (tr, tc) = (tid / 16, tid % 16) owns query rows 4tr..4tr+3:
//     the scores of keys tc + 16j (j < 4), and the accumulator columns
//     tc + 16jj (jj < HD / 16), so each row's m, l and rescale stay in the
//     registers of the 16 lanes that share the row (shuffle reductions over
//     those lanes), and P goes through shared memory to the P.V product;
//   * key tiles that lie wholly above the diagonal (causal) or wholly before
//     every row's window are skipped: their scores would all be masked, and
//     a masked score adds exp(-1e30 - m) = 0 once the row has seen a real
//     score.  Only a row with no visible key at all (a window, and qpos >=
//     Skv + window - 1) would see the difference, so a block with such a row
//     walks every tile, as the TPU kernel does;
//   * HD is hd rounded up to 32, 64, 128 or 256: the padded columns load as
//     0.0 and add nothing to a score; only the hd real ones are written;
//   * expf, IEEE division, no --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BKV = 64;           // keys per tile
constexpr int THREADS = 256;
constexpr int PSTRIDE = BKV + 1;  // P tile row stride (floats)
constexpr float NEG = -1e30f;     // a masked score, as the TPU kernel's _NEG
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// p.astype(v.dtype): identity in f32, one rounding to bf16 otherwise
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// reduce over the 16 lanes (tc) that share a row group
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)2 * BQ * (HD + 1) + (size_t)BKV * HD + (size_t)BQ * PSTRIDE);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Sq, int Skv, int H, int KV, int hd, float scale,
                 int causal, int window) {
  constexpr int HDP = HD + 1;     // Q and K row stride: conflict-free column reads
  constexpr int NJ = HD / 16;     // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // BQ x HDP, q * scale
  float* Ks = Qs + BQ * HDP;      // BKV x HDP
  float* Vs = Ks + BKV * HDP;     // BKV x HD
  float* Ps = Vs + BKV * HD;      // BQ x PSTRIDE

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long qstride = (long long)H * hd;    // between positions of q and o
  const long long kstride = (long long)KV * hd;   // between positions of k and v
  const T* qb = q + ((long long)b * Sq * H + h) * hd;
  const T* kb = k + ((long long)b * Skv * KV + kvh) * hd;
  const T* vb = v + ((long long)b * Skv * KV + kvh) * hd;
  T* ob = o + ((long long)b * Sq * H + h) * hd;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int qp = q0 + r;
    Qs[r * HDP + d] = (qp < Sq && d < hd) ? __fmul_rn(to_f32(qb[qp * qstride + d]), scale) : 0.0f;
  }

  // the key tiles some row of this block may see
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(Skv, q_last + 1);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  if (window > 0 && q_last >= Skv + window - 1) {   // a row that sees no key
    k_lo = 0;
    k_hi = Skv;
  }
  const int t_lo = k_lo / BKV, t_hi = (k_hi + BKV - 1) / BKV;

  float m_i[4], l_i[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG;
    l_i[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.0f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int kv0 = t * BKV;
    __syncthreads();              // the last tile's readers are done; Qs is written
    for (int idx = tid; idx < BKV * HD; idx += THREADS) {
      const int r = idx / HD, d = idx % HD;
      const int kp = kv0 + r;
      const bool in = kp < Skv && d < hd;
      Ks[r * HDP + d] = in ? to_f32(kb[kp * kstride + d]) : 0.0f;
      Vs[r * HD + d] = in ? to_f32(vb[kp * kstride + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * tr + i) * HDP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * HDP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * tr + i;
      float rowmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kv0 + tc + 16 * j;
        const bool ok = (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        s[i][j] = kp >= Skv ? -INFINITY : (ok ? s[i][j] : NEG);
        rowmax = fmaxf(rowmax, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], max16(rowmax));
      float rowsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rowsum += s[i][j];
        Ps[(4 * tr + i) * PSTRIDE + tc + 16 * j] = round_as(s[i][j], vb);
      }
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = alpha * l_i[i] + sum16(rowsum);
      m_i[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();              // P is complete

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * tr + i) * PSTRIDE + j];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float vv = Vs[j * HD + tc + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(p[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * tr + i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tc + 16 * jj;
      if (d < hd) store(ob + qp * qstride + d, __fdiv_rn(acc[i][jj], denom));
    }
  }
}

template <typename T, int HD>
int launch(const T* q, const T* k, const T* v, T* o, int B, int Sq, int Skv, int H, int KV,
           int hd, float scale, int causal, int window, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<HD>();
  static_assert(bytes <= 232448, "the tiles exceed a block's shared memory");
  // The opt-in holds for the current device only: set it before every launch
  // (it is cheap and idempotent), so a call on any card finds it set.
  const cudaError_t rc = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, bytes, s>>>(q, k, v, o, Sq, Skv, H, KV, hd, scale,
                                                       causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
             int H, int KV, int hd, float scale, int causal, int window, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (hd <= 32) return launch<T, 32>(qt, kt, vt, ot, B, Sq, Skv, H, KV, hd, scale, causal, window, s);
  if (hd <= 64) return launch<T, 64>(qt, kt, vt, ot, B, Sq, Skv, H, KV, hd, scale, causal, window, s);
  if (hd <= 128) return launch<T, 128>(qt, kt, vt, ot, B, Sq, Skv, H, KV, hd, scale, causal, window, s);
  return launch<T, 256>(qt, kt, vt, ot, B, Sq, Skv, H, KV, hd, scale, causal, window, s);
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Skv, KV, hd), o (B, Sq, H, hd), contiguous;
// dtype: 0 f32, 1 bf16 (all four tensors); causal 0 or 1; window <= 0 is none
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Sq, int Skv, int H, int KV, int hd, int dtype,
                                   float scale, int causal, int window, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || hd < 1 || hd > 256 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, Sq, Skv, H, KV, hd, scale, causal, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, hd, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
