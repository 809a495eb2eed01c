// Flash-attention forward (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` reached through
// `flash_attention_fwd` in src/repro/kernels/flash_attention/flash_attention.py.
// Same function: causal or non-causal GQA attention with an online softmax,
// fp32 accumulation, q-head h reading kv-head h*K/H, scale D^-0.5, the
// top-left causal mask k_pos <= q_pos (both from 0), kv tiles wholly above
// the diagonal skipped, l clamped at 1e-37, outputs out (in q's dtype) and
// lse = m + log(l) in fp32.
//
// What bounds it on an H100 (published SXM peaks at its 700 W limit:
// 3.35 TB/s, 989 TFLOP/s bf16 tensor cores, 67 TFLOP/s fp32 CUDA cores):
// at the serve shapes (B=4, H=16, Sq=Skv=512, K=8, D=128, bf16) one call
// needs ~4.3 GFLOP (the causal half of QK^T and PV) and moves ~25 MB of
// inputs and outputs: ~170 FLOP/byte, below the ~295 FLOP/byte ridge of
// the bf16 tensor cores, so the roofline floor is the bytes (~7.5 us).
// This first version does its products in fp32 on the CUDA cores, where
// the same work needs at least ~64 us: it is bounded by operations, and
// exact to the reference's fp32 numerics.  Moving the products to the
// tensor cores (wgmma, TMA, a producer/consumer pipeline) is later work.
//
// Design: one block of 256 threads (a 16 x 16 grid) per (64-row query tile,
// q-head, batch).  The query tile is staged once in shared memory as fp32;
// the block then walks 32-key tiles of K and V through shared memory.  Each
// thread owns 4 query rows (ty + 16 i) and, for the score tile, 2 key
// columns (tx + 16 j); for the output, D/16 columns (tx + 16 c).  The row
// max and row sum of the online softmax reduce over the 16 threads of a
// half-warp with shuffles, so m, l and the output accumulator live in
// registers for the whole walk.  Ragged tails (rows >= Sq, keys >= Skv) are
// masked in the kernel instead of shrinking the tile.

#include <cmath>
#include <cstddef>

#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TR = BQ / 16;   // rows per thread
constexpr int TC = BK / 16;   // score columns per thread

template <int D>
constexpr size_t smem_bytes() {
  // Qs [BQ][D+4], Ks [BK][D+4], Vs [BK][D], Ps [BQ][BK+1]  (fp32)
  return sizeof(float) * (BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int H, int K,
                 float scale, int causal) {
  constexpr int DC = D / 16;  // output columns per thread
  constexpr int QS = D + 4;   // padded row strides (16-byte aligned rows)
  constexpr int KS = D + 4;
  constexpr int PS = BK + 1;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h * K / H;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, qp = q0 + r;
    Qs[r * QS + d] =
        qp < Sq ? repro::to_f(q[((static_cast<size_t>(b) * Sq + qp) * H + h) * D + d]) : 0.f;
  }

  float m[TR], l[TR], acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last row are masked for every row
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // previous tile's Ps/Vs fully read (and Qs written)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D, kp = k0 + c;
      float kf = 0.f, vf = 0.f;
      if (kp < Skv) {
        const size_t off = ((static_cast<size_t>(b) * Skv + kp) * K + kh) * D + d;
        kf = repro::to_f(k[off]);
        vf = repro::to_f(v[off]);
      }
      Ks[c * KS + d] = kf;
      Vs[c * D + d] = vf;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[TR], kv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < TC; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * KS + d]);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int kp = k0 + tx + 16 * j;
        float sv = s[i][j] * scale;
        if (kp >= Skv || (causal && kp > qp)) sv = NEG_INF;
        s[i][j] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = repro::half_warp_max(mx);
      // key k0 = 0 is visible to every row, so m is finite from the first
      // tile on and masked scores give exp(NEG_INF - m) = 0
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        ps += p;
      }
      ps = repro::half_warp_sum(ps);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DC];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) vv[cc] = Vs[c * D + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float p = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) acc[i][cc] = fmaf(p, vv[cc], acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float ll = fmaxf(l[i], 1e-37f);
    T* orow = out + ((static_cast<size_t>(b) * Sq + qp) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) orow[tx + 16 * cc] = repro::from_f<T>(acc[i][cc] / ll);
    if (tx == 0) lse[(static_cast<size_t>(b) * H + h) * Sq + qp] = m[i] + logf(ll);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   int B, int Sq, int Skv, int H, int K, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // once per instantiation (a repeat is harmless)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), Sq, Skv, H, K,
      1.0f / sqrtf(static_cast<float>(D)), causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, void* lse,
                       int B, int Sq, int Skv, int H, int K, int D, int causal,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, lse, B, Sq, Skv, H, K, causal, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, B, Sq, Skv, H, K, causal, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, Sq, Skv, H, K, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Skv,K,D) contiguous; out (B,Sq,H,D) in q's dtype,
// lse (B,H,Sq) fp32.  dtype: 0 = float32, 1 = bfloat16.  Returns the
// cudaError_t of the launch.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         void* out, void* lse, int B, int Sq, int Skv,
                                         int H, int K, int D, int causal, int dtype,
                                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, lse, B, Sq, Skv, H, K, D, causal, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Skv, H, K, D, causal, st);
  return cudaErrorInvalidValue;
}
