// Flash-attention backward, dq pass, for Hopper, sm_90a: the fp32 kernel.
// bf16 inputs go to flash_bwd_dq_sm90.cu (tensor cores, TMA).
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel`, launched from
// `flash_attention_bwd` in src/repro/kernels/flash_attention/flash_attention.py,
// for fp32 inputs.  Same function: for each query row, recompute p =
// exp(s - lse) from the forward's lse (s = q.k * D^-0.5, top-left causal
// mask k_pos <= q_pos), dp = dO.V^T, ds = p * (dp - Dvec) * D^-0.5 and dq =
// ds.K, all in fp32, with q-head h reading kv-head h*K/H.  Dvec =
// rowsum(dO * O), a `jnp` expression before the reference's launch, is this
// kernel's prologue: each block computes it for its own rows and writes it
// out for the dk/dv pass (csrc/flash_bwd_dkv.cu), which runs after this one
// on the same stream.
//
// What bounds it on an H100 (published SXM peak at its 700 W limit: 67
// TFLOP/s fp32 on the CUDA cores): at the training shape in fp32 (B=4,
// H=16, K=8, S=512, D=128, causal) one call does 6 D flop for each of the
// 8.4 M visible (q, k) pairs, 6.45 GFLOP, at least ~96 us, against ~84 MB
// of inputs and outputs (~25 us at 3.35 TB/s): it is bounded by
// operations, and exact to the reference's fp32 numerics.
//
// Design: one block of 256 threads (a 16 x 16 grid) per (64-row query tile,
// q-head, batch), like the forward.  The query and dO tiles are staged once
// in shared memory; the block then walks 32-key tiles of K and V up
// to the causal edge, and keeps dq (64 x D fp32) in registers: each thread
// owns 4 query rows (ty + 16 i) and D/16 columns (tx + 16 c).  For a key
// tile each thread computes s and dp for its 4 rows and 2 key columns
// (tx + 16 j), writes ds to shared memory, and after a barrier accumulates
// ds.K.  Rows past Sq are computed on zeros and never written; keys past
// Skv get p = 0.

#include <cmath>
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TR = BQ / 16;   // rows per thread
constexpr int TC = BK / 16;   // key columns per thread

template <int D>
constexpr size_t smem_bytes() {
  // Qs, Gs [BQ][D+4]; Ks, Vs [BK][D+4]; Ss [BQ][BK+1]  (fp32)
  return sizeof(float) * (2 * BQ * (D + 4) + 2 * BK * (D + 4) + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ out,
                    const float* __restrict__ g, const float* __restrict__ lse,
                    float* __restrict__ dvec, float* __restrict__ dq, int Sq, int Skv,
                    int H, int K, float scale, int causal) {
  constexpr int DC = D / 16;  // dq columns per thread
  constexpr int RS = D + 4;   // padded row stride (16-byte aligned rows)
  constexpr int SS = BK + 1;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + BQ * RS;
  float* Ks = Gs + BQ * RS;
  float* Vs = Ks + BK * RS;
  float* Ss = Vs + BK * RS;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h * K / H;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, qp = q0 + r;
    float qf = 0.f, gf = 0.f;
    if (qp < Sq) {
      const size_t off = ((static_cast<size_t>(b) * Sq + qp) * H + h) * D + d;
      qf = q[off];
      gf = g[off];
    }
    Qs[r * RS + d] = qf;
    Gs[r * RS + d] = gf;
  }
  __syncthreads();

  // prologue: Dvec = rowsum(dO * O) over the 16 threads of a half-warp,
  // which share the row; lse of the same rows
  float lse_r[TR], dvec_r[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
    float part = 0.f;
    if (qp < Sq) {
      const float* orow = out + ((static_cast<size_t>(b) * Sq + qp) * H + h) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        part = fmaf(Gs[r * RS + tx + 16 * c], orow[tx + 16 * c], part);
    }
    part = repro::half_warp_sum(part);
    dvec_r[i] = part;
    const size_t row = (static_cast<size_t>(b) * H + h) * Sq + qp;
    lse_r[i] = qp < Sq ? lse[row] : 0.f;
    if (tx == 0 && qp < Sq) dvec[row] = part;
  }

  float acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  // causal: keys past the tile's last row are masked for every row
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // previous tile's Ss and Ks fully read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D, kp = k0 + c;
      float kf = 0.f, vf = 0.f;
      if (kp < Skv) {
        const size_t off = ((static_cast<size_t>(b) * Skv + kp) * K + kh) * D + d;
        kf = k[off];
        vf = v[off];
      }
      Ks[c * RS + d] = kf;
      Vs[c * RS + d] = vf;
    }
    __syncthreads();

    float s[TR][TC], dp[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[TR], gv[TR], kv[TC], vv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * RS + d]);
        gv[i] = *reinterpret_cast<const float4*>(&Gs[(ty + 16 * i) * RS + d]);
      }
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * RS + d]);
        vv[j] = *reinterpret_cast<const float4*>(&Vs[(tx + 16 * j) * RS + d]);
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          float a = s[i][j], e = dp[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          e = fmaf(gv[i].x, vv[j].x, e);
          e = fmaf(gv[i].y, vv[j].y, e);
          e = fmaf(gv[i].z, vv[j].z, e);
          e = fmaf(gv[i].w, vv[j].w, e);
          s[i][j] = a;
          dp[i][j] = e;
        }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool masked = kp >= Skv || (causal && kp > qp);
        const float p = masked ? 0.f : expf(s[i][j] * scale - lse_r[i]);
        Ss[(ty + 16 * i) * SS + tx + 16 * j] = p * (dp[i][j] - dvec_r[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float kk[DC];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) kk[cc] = Ks[c * RS + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float ds = Ss[(ty + 16 * i) * SS + c];
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) acc[i][cc] = fmaf(ds, kk[cc], acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    float* row = dq + ((static_cast<size_t>(b) * Sq + qp) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) row[tx + 16 * cc] = acc[i][cc];
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* g, const void* lse, void* dvec, void* dq, int B, int Sq,
                   int Skv, int H, int K, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // once per instantiation (a repeat is harmless)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(out),
      static_cast<const float*>(g), static_cast<const float*>(lse), static_cast<float*>(dvec),
      static_cast<float*>(dq), Sq, Skv, H, K, 1.0f / sqrtf(static_cast<float>(D)), causal);
  return cudaGetLastError();
}

}  // namespace

// q, out, g (B,Sq,H,D), k/v (B,Skv,K,D) contiguous fp32, lse (B,H,Sq) fp32
// from the forward; writes dq (B,Sq,H,D) and dvec (B,H,Sq), fp32.  Returns
// the cudaError_t of the launch (cudaErrorInvalidValue when D is not 32, 64
// or 128).
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* out, const void* g, const void* lse,
                                  void* dvec, void* dq, int B, int Sq, int Skv, int H,
                                  int K, int D, int causal, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, out, g, lse, dvec, dq, B, Sq, Skv, H, K, causal, st);
    case 64: return launch<64>(q, k, v, out, g, lse, dvec, dq, B, Sq, Skv, H, K, causal, st);
    case 128: return launch<128>(q, k, v, out, g, lse, dvec, dq, B, Sq, Skv, H, K, causal, st);
    default: return cudaErrorInvalidValue;
  }
}
