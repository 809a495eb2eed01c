// Flash-attention backward, dk/dv pass, for Hopper, sm_90a: the fp32
// kernel.  bf16 inputs go to flash_bwd_dkv_sm90.cu (tensor cores, TMA).
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel`, launched from
// `flash_attention_bwd` in src/repro/kernels/flash_attention/flash_attention.py,
// for fp32 inputs.  Same function: for each key row of kv-head kh, loop
// over the query rows and over the G = H/K q-heads that read kh, recompute
// p = exp(s - lse) (s = q.k * D^-0.5, top-left causal mask k_pos <= q_pos)
// and ds = p * (dO.V^T - Dvec) * D^-0.5, and accumulate dv += p^T.dO and
// dk += ds^T.Q in fp32.  Dvec = rowsum(dO * O) comes from the dq pass
// (csrc/flash_bwd_dq.cu), launched before this one on the same stream.
// Like the reference it uses no atomics: every dk/dv element is summed by
// one thread in a fixed order, so two runs give bit-identical results.
//
// What bounds it on an H100 (published SXM peak at its 700 W limit: 67
// TFLOP/s fp32 on the CUDA cores): at the training shape in fp32 (B=4,
// H=16, K=8, S=512, D=128, causal) one call does 8 D flop for each of the
// 8.4 M visible (q, k) pairs, 8.6 GFLOP, at least ~128 us, against ~67 MB
// of inputs and outputs (~20 us at 3.35 TB/s): it is bounded by
// operations.
//
// Design: one block of 256 threads (a 16 x 16 grid) per (64-key tile,
// kv-head, batch).  The K and V tiles are staged once in shared memory as
// fp32 and stay there; dk and dv (2 x 64 x D fp32) stay in registers: each
// thread owns 4 key rows (ty + 16 i) and D/16 columns (tx + 16 c) of both.
// The block walks 32-row query tiles from the first one the causal mask
// lets see its keys, and for each the G q-heads of its kv-head: it stages
// that head's Q and dO rows, lse and Dvec, computes s and dp for its 4 key
// rows and 2 query columns (tx + 16 j), writes p and ds to shared memory,
// and after a barrier accumulates p^T.dO and ds^T.Q.  Queries past Sq and
// keys past Skv get p = 0; key rows past Skv are never written.

#include <cmath>
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int BKV = 64;       // key rows per block
constexpr int BQ = 32;        // query rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TR = BKV / 16;  // key rows per thread
constexpr int TC = BQ / 16;   // query columns per thread

template <int D>
constexpr size_t smem_bytes() {
  // Ks, Vs [BKV][D+4]; Qs, Gs [BQ][D+4]; Ps, DSs [BKV][BQ+1]; lse, Dvec [BQ]
  return sizeof(float) *
         (2 * BKV * (D + 4) + 2 * BQ * (D + 4) + 2 * BKV * (BQ + 1) + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ dvec,
                     float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H,
                     int K, float scale, int causal) {
  constexpr int DC = D / 16;  // dk/dv columns per thread
  constexpr int RS = D + 4;   // padded row stride (16-byte aligned rows)
  constexpr int PS = BQ + 1;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKV * RS;
  float* Qs = Vs + BKV * RS;
  float* Gs = Qs + BQ * RS;
  float* Ps = Gs + BQ * RS;
  float* DSs = Ps + BKV * PS;
  float* Ls = DSs + BKV * PS;
  float* Dl = Ls + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.x * BKV;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;

  for (int i = tid; i < BKV * D; i += THREADS) {
    const int r = i / D, d = i % D, kp = k0 + r;
    float kf = 0.f, vf = 0.f;
    if (kp < Skv) {
      const size_t off = ((static_cast<size_t>(b) * Skv + kp) * K + kh) * D + d;
      kf = k[off];
      vf = v[off];
    }
    Ks[r * RS + d] = kf;
    Vs[r * RS + d] = vf;
  }

  float acc_k[TR][DC], acc_v[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      acc_k[i][c] = 0.f;
      acc_v[i][c] = 0.f;
    }

  // causal: query tiles wholly before the first key see none of the keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < Sq; q0 += BQ) {
    for (int gi = 0; gi < G; ++gi) {
      const int h = kh * G + gi;
      __syncthreads();  // previous Qs, Gs, Ps, DSs fully read (Ks, Vs written)
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
      if (tid < BQ) {
        const int qp = q0 + tid;
        const size_t row = (static_cast<size_t>(b) * H + h) * Sq + qp;
        Ls[tid] = qp < Sq ? lse[row] : 0.f;
        Dl[tid] = qp < Sq ? dvec[row] : 0.f;
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
        float4 kv[TR], vv[TR], qv[TC], gv[TC];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          kv[i] = *reinterpret_cast<const float4*>(&Ks[(ty + 16 * i) * RS + d]);
          vv[i] = *reinterpret_cast<const float4*>(&Vs[(ty + 16 * i) * RS + d]);
        }
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          qv[j] = *reinterpret_cast<const float4*>(&Qs[(tx + 16 * j) * RS + d]);
          gv[j] = *reinterpret_cast<const float4*>(&Gs[(tx + 16 * j) * RS + d]);
        }
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            float a = s[i][j], e = dp[i][j];
            a = fmaf(qv[j].x, kv[i].x, a);
            a = fmaf(qv[j].y, kv[i].y, a);
            a = fmaf(qv[j].z, kv[i].z, a);
            a = fmaf(qv[j].w, kv[i].w, a);
            e = fmaf(gv[j].x, vv[i].x, e);
            e = fmaf(gv[j].y, vv[i].y, e);
            e = fmaf(gv[j].z, vv[i].z, e);
            e = fmaf(gv[j].w, vv[i].w, e);
            s[i][j] = a;
            dp[i][j] = e;
          }
      }

#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int kp = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int c = tx + 16 * j, qp = q0 + c;
          const bool masked = qp >= Sq || kp >= Skv || (causal && kp > qp);
          const float p = masked ? 0.f : expf(s[i][j] * scale - Ls[c]);
          Ps[(ty + 16 * i) * PS + c] = p;
          DSs[(ty + 16 * i) * PS + c] = p * (dp[i][j] - Dl[c]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int c = 0; c < BQ; ++c) {
        float gg[DC], qq[DC];
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          gg[cc] = Gs[c * RS + tx + 16 * cc];
          qq[cc] = Qs[c * RS + tx + 16 * cc];
        }
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float p = Ps[(ty + 16 * i) * PS + c];
          const float ds = DSs[(ty + 16 * i) * PS + c];
#pragma unroll
          for (int cc = 0; cc < DC; ++cc) {
            acc_v[i][cc] = fmaf(p, gg[cc], acc_v[i][cc]);
            acc_k[i][cc] = fmaf(ds, qq[cc], acc_k[i][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= Skv) continue;
    const size_t off = ((static_cast<size_t>(b) * Skv + kp) * K + kh) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      dk[off + tx + 16 * cc] = acc_k[i][cc];
      dv[off + tx + 16 * cc] = acc_v[i][cc];
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const void* lse, const void* dvec, void* dk, void* dv, int B, int Sq,
                   int Skv, int H, int K, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // once per instantiation (a repeat is harmless)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Skv + BKV - 1) / BKV, K, B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(dvec), static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Skv, H, K, 1.0f / sqrtf(static_cast<float>(D)), causal);
  return cudaGetLastError();
}

}  // namespace

// q, g (B,Sq,H,D), k/v (B,Skv,K,D) contiguous fp32, lse and dvec (B,H,Sq)
// fp32; writes dk, dv (B,Skv,K,D) fp32.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue when D is not 32, 64 or 128).
extern "C" int repro_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* g, const void* lse, const void* dvec,
                                   void* dk, void* dv, int B, int Sq, int Skv, int H,
                                   int K, int D, int causal, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, g, lse, dvec, dk, dv, B, Sq, Skv, H, K, causal, st);
    case 64: return launch<64>(q, k, v, g, lse, dvec, dk, dv, B, Sq, Skv, H, K, causal, st);
    case 128: return launch<128>(q, k, v, g, lse, dvec, dk, dv, B, Sq, Skv, H, K, causal, st);
    default: return cudaErrorInvalidValue;
  }
}
