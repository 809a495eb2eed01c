// Flash-decode for Hopper, sm_90a: one query token per (batch, q-head)
// against the KV cache.
//
// Replaces the Pallas TPU kernel `_decode_kernel` reached through
// `decode_attention_fwd` in src/repro/kernels/decode_attention/decode_attention.py.
// Same function: positions past `cache_index` (inclusive, one runtime scalar
// for the batch) are masked and never read, q-head h reads kv-head h*K/H,
// scale D^-0.5, fp32 softmax and accumulation, l clamped at 1e-37, output in
// the cache dtype.  `cache_index` is an ordinary int argument, so decode
// steps share one compiled kernel.
//
// What bounds it on an H100 (published SXM peaks at its 700 W limit):
// bytes.  Each call reads (cache_index+1) keys and values of every kv head
// once (~9.4 MB per layer at B=4, K=8, D=128, 576 positions, bf16) and does
// ~2 FLOP per byte, far below the ridge, so the floor is the K/V bytes over
// 3.35 TB/s.  The kernel reads only the valid prefix, a warp reading whole
// K/V rows (coalesced), with 8 keys in flight per warp to hide latency.
//
// Design: one block of 8 warps per (q-head, batch).  Warps take interleaved
// groups of 8 keys; a lane holds D/32 elements of q, of each key and value
// row, and of its warp's output accumulator.  Each warp keeps its own online
// softmax (m, l, acc) in registers; the 8 partial states merge through
// shared memory at the end.  Known limit: at the serve shapes the grid is
// only B*H = 64 blocks on 132 SMs; splitting the KV axis across blocks is
// later work.

#include <cmath>
#include <cstddef>

#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int U = 8;  // keys per warp per step

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int S, int H, int K,
              int n_keys, float scale) {
  constexpr int EPL = D / 32;  // elements per lane
  __shared__ float sm[WARPS], sl[WARPS];
  __shared__ float sacc[WARPS][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kh = h * K / H;
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;

  float qv[EPL];
  const T* qrow = q + (static_cast<size_t>(b) * H + h) * D + lane * EPL;
#pragma unroll
  for (int e = 0; e < EPL; ++e) qv[e] = repro::to_f(qrow[e]);

  float m = NEG_INF, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  for (int base = w * U; base < n_keys; base += WARPS * U) {
    float kx[U][EPL], vx[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u;
      if (p < n_keys) {
        const size_t off = ((static_cast<size_t>(b) * S + p) * K + kh) * D + lane * EPL;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kx[u][e] = repro::to_f(k[off + e]);
          vx[u][e] = repro::to_f(v[off + e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kx[u][e] = vx[u][e] = 0.f;
      }
    }
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot = fmaf(qv[e], kx[u][e], dot);
      s[u] = dot;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = repro::warp_sum(s[u]);
    // key `base` is valid, so m_new is finite and masked keys give 0
    float mx = NEG_INF;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = base + u < n_keys ? s[u] * scale : NEG_INF;
      mx = fmaxf(mx, s[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = expf(s[u] - m_new);
      l += p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(p, vx[u][e], acc[e]);
    }
    m = m_new;
  }

  if (lane == 0) {
    sm[w] = m;
    sl[w] = l;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) sacc[w][lane * EPL + e] = acc[e];
  __syncthreads();

  // merge: a warp that saw no key has m = NEG_INF, l = 0 and weighs 0
  float M = NEG_INF;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) M = fmaxf(M, sm[i]);
  float L = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) L += sl[i] * expf(sm[i] - M);
  L = fmaxf(L, 1e-37f);
  T* orow = out + (static_cast<size_t>(b) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) o = fmaf(sacc[i][d], expf(sm[i] - M), o);
    orow[d] = repro::from_f<T>(o / L);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int S, int H, int K, int cache_index, cudaStream_t stream) {
  const dim3 grid(H, B);
  decode_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, K, cache_index + 1,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
                       int S, int H, int K, int D, int cache_index, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, K, cache_index, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, K, cache_index, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, K, cache_index, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,1,H,D), k/v caches (B,S,K,D) contiguous; out (B,1,H,D) in the cache
// dtype.  0 <= cache_index < S.  dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
extern "C" int repro_decode_attention_fwd(const void* q, const void* k, const void* v,
                                          void* out, int B, int S, int H, int K, int D,
                                          int cache_index, int dtype, void* stream) {
  if (cache_index < 0 || cache_index >= S) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, B, S, H, K, D, cache_index, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, B, S, H, K, D, cache_index, st);
  return cudaErrorInvalidValue;
}
