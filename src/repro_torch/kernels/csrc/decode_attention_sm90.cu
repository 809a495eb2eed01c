// Flash-decode for Hopper, sm_90a: one query token per (batch, q-head)
// against the KV cache, the KV axis split over a thread-block cluster.
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
// bytes.  A call reads the (cache_index+1) valid keys and values of every kv
// head once (8.9 MB at B=4, K=8, D=128, cache_index 543, bf16) and does ~2
// FLOP a byte, far below the ridge: the floor is those bytes over 3.35 TB/s,
// 2.7 us (phi-3's decode, B=4, K=32, D=96, cache_index 543: 26.7 MB, 8.0
// us).  At that size the card has to keep a few MB in flight on all its
// SMs at once, so the design is about parallelism and bytes in flight.
//
// Design.  One block of 4 warps per (b, kv-head, KV split): it serves every
// q-head of its kv-head (up to GP = 8 of them a block), so K and V are read
// from memory once, not once per q-head.  The splits of one (b, kv-head) are
// one thread-block cluster (grid (splits, K * head groups, B), cluster
// (splits, 1, 1)); `splits` is a launch parameter (the tuning cache's
// `decode` entries, repro_torch/tune/space.py), and when the caller passes
// 0 it is chosen per call (`choose_splits`) so that the grid covers the
// device's SMs (132 on an H100 SXM) about twice: at most 8 (the portable
// cluster size) and no split shorter than one 32-key tile, the bounds an
// explicit count must keep too.  Each block takes a contiguous
// range of the valid keys and streams it through shared memory in 32-key
// tiles of K and V with 16-byte cp.async copies, in a ring of 2-4 stages
// (64 KB), so that all of a short split's tiles are in flight at once.  Each
// warp takes 8 keys of a tile: a lane holds D/32 elements of each q row
// (pre-scaled by D^-0.5 log2 e), of the key and value rows and of the
// output accumulators (D/32 neighbours, one vector load, at D = 32, 64 and
// 128; at D = 96 three elements strided by 32, since no load moves 6 or 12
// bytes, and neighbouring lanes still read neighbouring elements), and
// keeps an online softmax (m, l, acc) for each
// q-head in registers, p = exp2(s - m).  The block merges its warps' states
// in shared memory; then, after `cluster.sync()`, the blocks of the cluster
// merge the splits' states by reading each other's shared memory
// (distributed shared memory, `map_shared_rank`), rank by rank in a fixed
// order, with the combine of the reference's sharded decode
// (src/repro/kernels/decode_attention/sharded.py): M = max m,
// L = sum l e^(m-M) clamped at 1e-37, out = sum acc e^(m-M) / L.  A second
// `cluster.sync()` keeps every block resident until its shared memory has
// been read.  One launch, no workspace in global memory and no counter, so
// calls on several streams at once share nothing, and the result is the
// same bit for bit from launch to launch.  A split or warp that saw no key
// keeps m = NEG_INF (finite), l = 0 and weighs exactly 0.
//
// Where the caller passes an `lse` buffer (B, H) fp32, the merge also
// writes each q-head's log-sum-exp of its scores, ln 2 (M + log2 L): what a
// sequence-parallel decode needs to merge the outputs of the cache chunks
// that several devices hold (repro_torch/kernels/decode_attention/sharded.py).
// The output is the same with and without it.

#include <cooperative_groups.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::NEG_INF;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int U = 8;                   // keys a warp takes from a tile
constexpr int TK = WARPS * U;          // keys a tile
constexpr int MAX_SPLITS = 8;          // the portable cluster size
constexpr int RING_BYTES = 64 * 1024;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The K/V ring of a block: STAGES stages of one K tile and one V tile.
template <typename T, int D>
struct Ring {
  static constexpr int ROW = D * static_cast<int>(sizeof(T));  // bytes a key row
  static constexpr int CPR = ROW / 16;                          // 16-byte chunks a row
  static constexpr int TILE = TK * ROW;                         // bytes of K (or V) a tile
  static constexpr int FIT = RING_BYTES / (2 * TILE);
  static constexpr int STAGES = FIT < 2 ? 2 : (FIT > 4 ? 4 : FIT);
  static constexpr int BYTES = STAGES * 2 * TILE;
};

template <int BYTES> struct Bits;
template <> struct Bits<2> { using type = unsigned short; };
template <> struct Bits<4> { using type = unsigned int; };
template <> struct Bits<8> { using type = uint2; };
template <> struct Bits<16> { using type = uint4; };

// N consecutive elements from shared memory in one load, as floats.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float (&out)[N]) {
  using V = typename Bits<N * sizeof(T)>::type;
  const V raw = *reinterpret_cast<const V*>(p);
  const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = repro::to_f(t[e]);
}

// Element e of the D/32 a lane holds of a row: neighbours when D/32 is a
// power of two, else (D = 96) elements strided by 32.
template <int D>
__device__ __forceinline__ int lane_col(int lane, int e) {
  constexpr int EPL = D / 32;
  return (EPL & (EPL - 1)) == 0 ? lane * EPL + e : lane + 32 * e;
}

// A lane's D/32 elements of a row in shared memory, as floats.
template <typename T, int D>
__device__ __forceinline__ void load_lane(const T* row, int lane, float (&out)[D / 32]) {
  constexpr int EPL = D / 32;
  if constexpr ((EPL & (EPL - 1)) == 0) {
    load_f<T, EPL>(row + lane * EPL, out);
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e) out[e] = repro::to_f(row[lane + 32 * e]);
  }
}

template <typename T, int D, int GP>
__global__ void __launch_bounds__(THREADS)
decode_sm90_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                   int S, int H, int K, int n_keys, float scale_log2) {
  using R = Ring<T, D>;
  constexpr int EPL = D / 32;  // elements a lane
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte chunk
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float wm[WARPS][GP], wl[WARPS][GP];
  __shared__ float wacc[WARPS][GP][D];
  // the block's state, read by the cluster's merge
  __shared__ float pm[GP], pl[GP];
  __shared__ float pacc[GP][D];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.x;  // the cluster spans x: (splits, 1, 1)
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = H / K;
  const int n_groups = (G + GP - 1) / GP;
  const int kh = blockIdx.y / n_groups;
  const int g0 = (blockIdx.y % n_groups) * GP;  // first q-head of the block in its group
  const int n_heads = min(GP, G - g0);
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;

  // this split's keys: [k_begin, k_end)
  const int k_begin = static_cast<int>(static_cast<long long>(rank) * n_keys / splits);
  const int k_end = static_cast<int>(static_cast<long long>(rank + 1) * n_keys / splits);
  const int n_mine = k_end - k_begin;
  const int n_tiles = (n_mine + TK - 1) / TK;

  const size_t key_stride = static_cast<size_t>(K) * D;
  const T* kb = k + (static_cast<size_t>(b) * S * K + kh) * D;
  const T* vb = v + (static_cast<size_t>(b) * S * K + kh) * D;

  // tile `t` of the split into its ring stage; keys past the split are
  // zero-filled without being read
  auto issue = [&](int t) {
    T* ks = reinterpret_cast<T*>(ring + (t % R::STAGES) * 2 * R::TILE);
    T* vs = ks + TK * D;
    const int t0 = k_begin + t * TK;
    for (int i = threadIdx.x; i < 2 * TK * R::CPR; i += THREADS) {
      const bool is_v = i >= TK * R::CPR;
      const int j = is_v ? i - TK * R::CPR : i;
      const int r = j / R::CPR;
      const int c = (j % R::CPR) * EPC;
      const int p = t0 + r;
      const bool ok = p < k_end;
      const T* src = (is_v ? vb : kb) + static_cast<size_t>(ok ? p : k_begin) * key_stride + c;
      repro::cp_async16((is_v ? vs : ks) + r * D + c, src, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < R::STAGES - 1; ++t) {
    if (t < n_tiles) issue(t);
    repro::cp_async_commit();
  }

  float qv[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    const T* qrow = q + (static_cast<size_t>(b) * H + kh * G + g0 + g) * D;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qv[g][e] = g < n_heads ? repro::to_f(qrow[lane_col<D>(lane, e)]) * scale_log2 : 0.f;
  }
  float m[GP], l[GP], acc[GP][EPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    repro::cp_async_wait<R::STAGES - 2>();
    __syncthreads();  // tile t has landed for every thread; tile t-1's stage is free
    if (t + R::STAGES - 1 < n_tiles) issue(t + R::STAGES - 1);
    repro::cp_async_commit();
    const int valid = min(U, n_mine - (t * TK + w * U));  // this warp's keys in the tile
    if (valid <= 0) continue;  // warp-uniform
    const T* ks = reinterpret_cast<const T*>(ring + (t % R::STAGES) * 2 * R::TILE) + w * U * D;
    const T* vs = ks + TK * D;

    float s[GP][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[EPL];
      load_lane<T, D>(ks + u * D, lane, kx);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qv[g][e], kx[e], dot);
        s[g][u] = dot;
      }
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
#pragma unroll
      for (int u = 0; u < U; ++u) s[g][u] = repro::warp_sum(s[g][u]);
      // key 0 of the warp's keys is valid, so m_new is finite and masked
      // keys weigh exp2(NEG_INF - m_new) = 0
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[g][u] = u < valid ? s[g][u] : NEG_INF;
        mx = fmaxf(mx, s[g][u]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float corr = exp2f(m[g] - m_new);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[g][u] = exp2f(s[g][u] - m_new);
        l[g] += s[g][u];
      }
      m[g] = m_new;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[EPL];
      load_lane<T, D>(vs + u * D, lane, vx);
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(s[g][u], vx[e], acc[g][e]);
    }
  }
  repro::cp_async_wait<0>();

  // the block's state: its warps merged
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (lane == 0) {
      wm[w][g] = m[g];
      wl[w][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) wacc[w][g][lane_col<D>(lane, e)] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GP * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = NEG_INF;
#pragma unroll
    for (int x = 0; x < WARPS; ++x) M = fmaxf(M, wm[x][g]);
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int x = 0; x < WARPS; ++x) {
      const float c = exp2f(wm[x][g] - M);
      L = fmaf(wl[x][g], c, L);
      o = fmaf(wacc[x][g][d], c, o);
    }
    pacc[g][d] = o;
    if (d == 0) {
      pm[g] = M;
      pl[g] = L;
    }
  }
  cluster.sync();  // every split's state is in its block's shared memory

  // the splits merged, rank by rank; the cluster's blocks share the outputs
  T* orow = out + (static_cast<size_t>(b) * H + kh * G + g0) * D;
  for (int i = rank * THREADS + threadIdx.x; i < n_heads * D; i += splits * THREADS) {
    const int g = i / D, d = i % D;
    float M = NEG_INF;
    for (int r = 0; r < splits; ++r) M = fmaxf(M, *cluster.map_shared_rank(&pm[g], r));
    float L = 0.f, o = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float c = exp2f(*cluster.map_shared_rank(&pm[g], r) - M);
      L = fmaf(*cluster.map_shared_rank(&pl[g], r), c, L);
      o = fmaf(*cluster.map_shared_rank(&pacc[g][d], r), c, o);
    }
    orow[i] = repro::from_f<T>(o / fmaxf(L, 1e-37f));
    if (lse != nullptr && d == 0)
      lse[static_cast<size_t>(b) * H + kh * G + g0 + g] = LN2 * (M + log2f(fmaxf(L, 1e-37f)));
  }
  cluster.sync();  // no block leaves while another may still read its shared memory
}

// q-heads a block serves: the kv-head's G, rounded up to a power of two, at
// most 8 (a larger G takes several blocks a kv-head)
int heads_a_block(int G) { return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8; }

int choose_splits(int B, int H, int K, int n_keys, int sms) {
  const int G = H / K;
  const int pairs = B * K * ((G + heads_a_block(G) - 1) / heads_a_block(G));
  int splits = (2 * sms + pairs - 1) / pairs;  // about two blocks on each SM
  splits = splits < MAX_SPLITS ? splits : MAX_SPLITS;
  const int tiles = n_keys / TK;  // no split shorter than a tile
  splits = splits < tiles ? splits : tiles;
  return splits > 1 ? splits : 1;
}

// The current device's SM count.
cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err
                            : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// The KV splits of a call: `splits`, or choose_splits's when it is 0; -1
// when an explicit count is outside 1..8 or leaves a split shorter than a
// tile.
int resolve_splits(int splits, int B, int H, int K, int n_keys, int sms) {
  if (splits == 0) return choose_splits(B, H, K, n_keys, sms);
  const int tiles = n_keys / TK;
  return splits < 1 || splits > MAX_SPLITS || splits > (tiles > 1 ? tiles : 1) ? -1 : splits;
}

template <typename T, int D, int GP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int S, int H, int K, int cache_index, int splits_asked, cudaStream_t stream) {
  using R = Ring<T, D>;
  static bool configured = false;  // once per instantiation (a repeat is harmless)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_sm90_kernel<T, D, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize, R::BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  int sms = 0;
  const cudaError_t qerr = sm_count(&sms);
  if (qerr != cudaSuccess) return qerr;
  const int n_keys = cache_index + 1;
  const int splits = resolve_splits(splits_asked, B, H, K, n_keys, sms);
  if (splits < 0) return cudaErrorInvalidValue;
  const int G = H / K;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, K * ((G + GP - 1) / GP), B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = R::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_sm90_kernel<T, D, GP>, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, K, n_keys,
      LOG2E / sqrtf(static_cast<float>(D)));
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(const void* q, const void* k, const void* v, void* out, float* lse,
                       int B, int S, int H, int K, int cache_index, int splits,
                       cudaStream_t stream) {
  switch (heads_a_block(H / K)) {
    case 1: return launch<T, D, 1>(q, k, v, out, lse, B, S, H, K, cache_index, splits, stream);
    case 2: return launch<T, D, 2>(q, k, v, out, lse, B, S, H, K, cache_index, splits, stream);
    case 4: return launch<T, D, 4>(q, k, v, out, lse, B, S, H, K, cache_index, splits, stream);
    default: return launch<T, D, 8>(q, k, v, out, lse, B, S, H, K, cache_index, splits, stream);
  }
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, float* lse,
                       int B, int S, int H, int K, int D, int cache_index, int splits,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return dispatch_g<T, 32>(q, k, v, out, lse, B, S, H, K, cache_index, splits, stream);
    case 64: return dispatch_g<T, 64>(q, k, v, out, lse, B, S, H, K, cache_index, splits, stream);
    case 96: return dispatch_g<T, 96>(q, k, v, out, lse, B, S, H, K, cache_index, splits, stream);
    case 128:
      return dispatch_g<T, 128>(q, k, v, out, lse, B, S, H, K, cache_index, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,1,H,D), k/v caches (B,S,K,D) contiguous, the caches 16-byte aligned;
// out (B,1,H,D) in the cache dtype; lse (B,H) fp32, or null for none.
// 0 <= cache_index < S, H a multiple of K, B <= 65535.  dtype: 0 = float32, 1 = bfloat16.  splits: the KV
// splits a cluster, 1..8 and at most the 32-key tiles of the cache_index + 1
// keys (one always), or 0 for choose_splits's.  Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for a split count outside those bounds).
extern "C" int repro_decode_attention_fwd(const void* q, const void* k, const void* v,
                                          void* out, void* lse, int B, int S, int H, int K,
                                          int D, int cache_index, int dtype, int splits,
                                          void* stream) {
  if (cache_index < 0 || cache_index >= S || B < 1 || B > 65535 || K < 1 || H % K)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, l, B, S, H, K, D, cache_index, splits, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, l, B, S, H, K, D, cache_index, splits, st);
  return cudaErrorInvalidValue;
}

// The KV splits (the cluster size) a call at these sizes launches on the
// current device when it passes splits 0; -1 when its SM count cannot be
// read.
extern "C" int repro_decode_attention_fwd_splits(int B, int H, int K, int cache_index) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  return choose_splits(B, H, K, cache_index + 1, sms);
}

// A block's dynamic shared memory (the K/V ring) at head dim D; dtype as above.
extern "C" int repro_decode_attention_fwd_smem(int D, int dtype) {
  const bool bf16 = dtype == 1;
  switch (D) {
    case 32: return bf16 ? Ring<__nv_bfloat16, 32>::BYTES : Ring<float, 32>::BYTES;
    case 64: return bf16 ? Ring<__nv_bfloat16, 64>::BYTES : Ring<float, 64>::BYTES;
    case 96: return bf16 ? Ring<__nv_bfloat16, 96>::BYTES : Ring<float, 96>::BYTES;
    case 128: return bf16 ? Ring<__nv_bfloat16, 128>::BYTES : Ring<float, 128>::BYTES;
    default: return -1;
  }
}
