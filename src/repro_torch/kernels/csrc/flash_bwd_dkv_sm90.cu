// Flash-attention backward, dk/dv pass, for Hopper (sm_90a), bfloat16:
// every product on the tensor cores (wgmma), every tile brought in by TMA.
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel` (the `pl.pallas_call` at
// l.307 of src/repro/kernels/flash_attention/flash_attention.py, reached
// through `flash_attention_bwd`) for bf16 inputs; fp32 inputs go to
// flash_bwd_dkv_sm90_fp32.cu.  Same function: for each key of kv-head kh,
// over the queries the causal mask lets see it and the G = H/K q-heads that
// read kh, p = exp(s - lse) (s = q.k D^-0.5, top-left causal mask k_pos <=
// q_pos), ds = p (dO.v - Dvec) D^-0.5, dv = sum p dO and dk = sum ds q, all
// summed in fp32, written in bf16.  Dvec = rowsum(dO * O) comes from the dq
// pass (flash_bwd_dq_sm90.cu), launched before this one on the same stream.
// Inputs: q (B,Sq,H,D), dO (B,Sq,H,DV), k (B,Skv,K,D), v (B,Skv,K,DV),
// contiguous bf16 on 16-byte boundaries; lse, Dvec (B,H,Sq) fp32; D == DV in
// {32, 64, 96, 128} or (D, DV) = (96, 64) (MLA), any Sq and Skv.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 dense): at the
// training shape (B=4, H=16, K=8, D=128, S=512, causal) the function's
// 4 D + 4 DV flops for each of the 8.4 M visible (q, k) pairs are 8.6
// GFLOP (8.7 us), and it moves 33.8 MB (q, k, v, dO, lse, Dvec read once;
// dk, dv written once): 10.1 us.  Bytes bound it, and MLA's and phi-3's
// shapes too; whisper's encoder (B=4, 1500 x 1500 non-causal, H=K=6,
// D=DV=64) does 27.6 GFLOP: compute-bound.
//
// Why P and dS are split.  The reference computes p and ds in fp32 and
// keeps them so for both products.  A CPU model of this arithmetic
// (tests/test_torch_flash_bwd_sm90.py; B=1, S=512, H=4, K=2, D=128,
// causal, bf16 inputs), held to the plain version's element check
// |err| <= 1e-4 + 2^-7 |ref|: P rounded once to bf16 puts 7,269 of 131,072
// dv elements beyond it (the worst at 21.6x the limit), dS rounded once
// 7,031 dk elements (24.5x); each split into hi = bf16(x) and lo =
// bf16(x - hi), two products into one fp32 accumulator, puts none beyond
// it (worst 0.91).  The split raises the tensor-core work from 4 D + 4 DV
// to 6 D + 6 DV flops a visible pair: 12.9 GFLOP, 13.1 us at the peak rate.
//
// Design, constraint by constraint:
// - Tensor cores, transposed.  A block owns 64 keys of one kv-head; each of
//   its two consumer warpgroups (128 threads) computes S^T = K Q^T (D/16
//   k16 slices) and dP^T = V dO^T (DV/16) as m64n32k16 wgmmas with A (the K
//   or V tile) and B (a 32-query Q or dO tile) from shared memory,
//   K-major: keys on M, queries on N.  Their accumulators, taken pairwise
//   as bf16, are the A fragments of the RS wgmmas dV += P^T dO (m64nDVk16)
//   and dK += dS^T Q (m64nDk16: n96 at D=96, its B operand spanning Q's
//   three 64-byte-swizzle column atoms), each issued twice (hi, then lo)
//   into its own fp32 accumulator; dO and Q are read again from the same
//   tiles, MN-major through the transpose-B immediate.  P^T and dS^T never
//   leave registers.
// - The causal work is triangular: key tile 0 sees every query, the last
//   tile 64.  The block's steps (32-query tile, q-head) are dealt to its
//   two warpgroups in turn, even and odd, which halves the longest block's
//   chain of dependent steps; the K and V tiles are shared.  A causal key
//   tile past the last query (Sq < Skv) has no step and writes zeros.
// - Registers: dK and dV are D/2 + DV/2 fp32 a thread (128 at D=128), S^T
//   and dP^T 16 each at 32-query steps, the hi/lo fragments 32; 32-query
//   steps keep that under the 255 a thread that one block of two
//   warpgroups an SM allows (phase 1 of chip_smoke.py prints ptxas -v,
//   spills included).
// - Memory: q, k, v and dO are 4-D tensor maps (D or DV, heads, S, B) made
//   on the host for every call (sm90.cuh's make_map).  Thread 0 brings the
//   K and V tiles in once; the first thread of each warpgroup brings its
//   steps' (Q, dO) tile pairs into its own ring of 3 stages, each signalled
//   by an mbarrier carrying the transaction bytes, two steps ahead.  Q and
//   K take D's geometry, dO and V take DV's (sm90.cuh's Geo), every tile on
//   a 1024-byte boundary.  lse and Dvec of a thread's 8 query columns come
//   by plain loads into registers, issued before the step's tiles are
//   waited for.  The same swizzled layout serves TMA and both descriptor
//   forms.
// - Masking: TMA zero-fills rows past Sq and Skv, but a zero row scores 0,
//   not -inf, against a finite lse, so queries >= Sq, keys >= Skv and (when
//   causal) keys past the query get p = 0 and ds = 0 explicitly, on the
//   tiles that reach an edge.
// - Determinism: no atomics.  Each warpgroup sums its steps in ascending
//   order; at the end warpgroup 1's dK and dV pass through shared memory
//   and are added to warpgroup 0's, always in that order, so two runs give
//   bit-identical results.
// - Grid: (K, B, key tiles of block_k keys), the key tile on z in
//   ascending order: key tile 0 sees the most queries, and blocks are
//   dispatched x fastest, so the longest run first.  Causal key tiles start
//   at their own first query.
// - Tiles as launch parameters (the tuning cache's bf16 `flash_bwd`
//   entries' dkv_block_k and dkv_block_q, repro_torch/tune/space.py):
//   block_q, the queries of a step, is 16, 32 or 64 (S^T and dP^T m64n16k16,
//   m64n32k16 or m64n64k16); block_k, the keys of a block, is 64 (the design
//   above: two warpgroups deal the steps over one 64-key tile and add their
//   sums at the end) or 128: each warpgroup owns 64 of the keys and both
//   read every (Q, dO) step from one shared ring of STAGES stages, which
//   halves the Q/dO traffic a key and needs no cross-warpgroup sum; each
//   key's dK and dV are one warpgroup's sums over the steps in ascending
//   order, so two runs give bit-identical results there too.  At 64 keys
//   and 16 queries warpgroup 1's dK and dV outgrow the rings, and the block
//   takes their size instead.  The untuned 64 x 32 is always built; any
//   other instantiation only where a thread's registers fit (`admits`, the
//   space's rule, from ptxas's report: 64-query steps spill at D=128).


#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int STAGES = 3;  // (Q, dO) ring
constexpr int NWG = 2;     // warpgroups of a block
// the untuned tiles: 64 keys a block, 32-query steps
constexpr int DEFAULT_BLOCK_K = 64, DEFAULT_BLOCK_Q = 32;
// a thread's registers beyond the dK and dV accumulators, a step's S^T and
// dP^T and their two bf16 terms (repro_torch/tune/space.py's DKV_REG_BASE)
constexpr int REG_BASE = 30;

// Bytes of the <D, DV, BKV, BQ> instantiation's (Q, dO) rings: one a
// warpgroup at 64 keys a block (each takes every other step), one for both
// at 128 (each owns 64 of the keys and takes every step).
template <int D, int DV, int BKV, int BQ>
constexpr int ring_bytes() {
  return (BKV == 64 ? NWG : 1) * STAGES * pair_bytes<D, DV>(BQ);
}

// Dynamic shared memory of the <D, DV, BKV, BQ> instantiation: K and V, the
// rings (at 64 keys also room for warpgroup 1's dK and dV, which pass
// through the rings' memory at the end), and room to align them to 1024
// bytes.
template <int D, int DV, int BKV, int BQ>
constexpr int smem_bytes() {
  constexpr int rings = ring_bytes<D, DV, BKV, BQ>();
  constexpr int red = BKV == 64 ? (D / 2 + DV / 2) * WG * 4 : 0;
  return pair_bytes<D, DV>(BKV) + (rings > red ? rings : red) + 1024;
}

// Whether the <D, DV, BKV, BQ> instantiation is built: the default tiles
// always; the others where a thread's registers (REG_BASE + D/2 + DV/2 +
// 2 BQ: dK, dV, S^T, dP^T and their two terms) fit the 255 that one block
// of two warpgroups an SM leaves, and the block's shared memory 227 KB.
template <int D, int DV, int BKV, int BQ>
constexpr bool admits() {
  if (BKV == DEFAULT_BLOCK_K && BQ == DEFAULT_BLOCK_Q) return true;
  return smem_bytes<D, DV, BKV, BQ>() <= 232448 && REG_BASE + D / 2 + DV / 2 + 2 * BQ <= 255;
}

// Step j's Q and dO tiles (query tile j / group, q-head kh group + j % group),
// the ring's i-th, into its stage i % STAGES, completing on that stage's
// barrier.
template <int D, int DV, int BQ>
__device__ __forceinline__ void load_step(const CUtensorMap* tq, const CUtensorMap* tg,
                                          uint32_t ring, uint32_t fbar, int i, int j,
                                          int q_begin, int group, int kh, int b) {
  const int s = i % STAGES;
  const uint32_t dst = ring + s * pair_bytes<D, DV>(BQ);
  tma_load_pair<D, DV>(tq, tg, dst, dst + Geo<D>::tile_bytes(BQ), kh * group + j % group,
                       q_begin + j / group * BQ, b, BQ, fbar + 8 * s);
}

// Barrier of the 128 threads of warpgroup wg alone (id 0 is __syncthreads').
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
}

// BKV = 64: both warpgroups on the block's 64 keys, steps j = wg, wg + 2,
// ... from a ring each, their sums added at the end.  BKV = 128: warpgroup
// wg on keys wg 64 .. wg 64 + 63, every step from one shared ring.
template <int D, int DV, int BKV, int BQ>
__global__ void __launch_bounds__(NWG * WG, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg,
                          const float* __restrict__ lse, const float* __restrict__ dvec,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          int Sq, int Skv, int H, int K, float scale_log2, float scale,
                          int causal) {
  constexpr bool SPLIT = BKV == 64;   // the warpgroups split the steps
  constexpr int NRING = SPLIT ? NWG : 1;
  constexpr int KSTEPS = D / 16;   // k16 slices of K Q^T
  constexpr int VSTEPS = DV / 16;  // k16 slices of V dO^T
  constexpr int QSTEPS = BQ / 16;  // k16 slices of P^T dO and dS^T Q
  constexpr int SREG = BQ / 2;     // S^T, dP^T accumulator registers a thread
  constexpr int KREG = D / 2;      // dK accumulator registers a thread
  constexpr int VREG = DV / 2;     // dV accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + NRING * STAGES];

  const uint32_t sk = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sv = sk + Geo<D>::tile_bytes(BKV);
  const uint32_t sring = sk + pair_bytes<D, DV>(BKV);  // ring r after r rings
  const uint32_t kvbar = smem_u32(&bars[0]);

  const int tid = threadIdx.x;
  const int wg = tid / WG, warp = tid / 32 % 4, lane = tid % 32;
  const int kh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BKV;
  const int group = H / K;
  // the warpgroup's ring (stage s: Q, then dO) and its barriers (fbar + 8 s)
  const int rid = SPLIT ? wg : 0;
  const uint32_t ring = sring + rid * STAGES * pair_bytes<D, DV>(BQ);
  const uint32_t fbar = smem_u32(&bars[1 + rid * STAGES]);
  // the ring's loader, and the A tiles' first key row of this warpgroup
  const bool loader = SPLIT ? tid % WG == 0 : tid == 0;
  const int kw = SPLIT ? 0 : wg * 64;
  // causal: queries before the block's first key see none of its keys
  const int q_begin = causal ? k0 : 0;
  const int n_steps = q_begin < Sq ? (Sq - q_begin + BQ - 1) / BQ * group : 0;
  // this warpgroup's steps: j = first + stride i
  const int first = SPLIT ? wg : 0, stride = SPLIT ? NWG : 1;
  const int n_mine = n_steps > first ? (n_steps - first + stride - 1) / stride : 0;

  if (tid == 0) {
    mbar_init(kvbar, 1);
#pragma unroll
    for (int s = 0; s < NRING * STAGES; ++s) mbar_init(smem_u32(&bars[1 + s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) tma_load_pair<D, DV>(&tk, &tv, sk, sv, kh, k0, b, BKV, kvbar);
  if (loader)
    for (int i = 0; i < STAGES - 1 && i < n_mine; ++i)
      load_step<D, DV, BQ>(&tq, &tg, ring, fbar, i, first + stride * i, q_begin, group, kh, b);

  // this thread's key rows kr0 and kr0 + 8, and its first query column in
  // every 8-column chunk
  const int kr0 = k0 + kw + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  float dk_acc[KREG], dv_acc[VREG];
#pragma unroll
  for (int i = 0; i < KREG; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < VREG; ++i) dv_acc[i] = 0.f;

  // the warpgroup's 64 key rows of the K and V tiles (BKV rows an atom)
  const uint32_t ak = sk + kw * Geo<D>::SW, av = sv + kw * Geo<DV>::SW;
  mbar_wait(kvbar, 0);
  for (int i = 0; i < n_mine; ++i) {
    const int j = first + stride * i, s = i % STAGES;
    const int q0 = q_begin + j / group * BQ, h = kh * group + j % group;
    // the ring's consumers are past its previous step's products: that
    // stage may be refilled
    if (SPLIT)
      wg_sync(wg);
    else
      __syncthreads();
    if (loader && i + STAGES - 1 < n_mine)
      load_step<D, DV, BQ>(&tq, &tg, ring, fbar, i + STAGES - 1, j + stride * (STAGES - 1),
                           q_begin, group, kh, b);

    // lse (as a base-2 exponent) and Dvec of query columns q0 + 8 t + c0 + e
    float lq[BQ / 8][2], dd[BQ / 8][2];
#pragma unroll
    for (int t = 0; t < BQ / 8; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qp = q0 + 8 * t + c0 + e;
        const size_t row = (static_cast<size_t>(b) * H + h) * Sq + qp;
        lq[t][e] = qp < Sq ? lse[row] * LOG2E : 0.f;
        dd[t][e] = qp < Sq ? dvec[row] : 0.f;
      }
    mbar_wait(fbar + 8 * s, (i / STAGES) & 1);
    const uint32_t q_tile = ring + s * pair_bytes<D, DV>(BQ);
    const uint32_t g_tile = q_tile + Geo<D>::tile_bytes(BQ);

    // S^T = K Q^T over D, dP^T = V dO^T over DV: K-major A and B
    float st[SREG], dpt[SREG];
#pragma unroll
    for (int i = 0; i < SREG; ++i) {  // overwritten: the first slice has scale_d 0
      st[i] = 0.f;
      dpt[i] = 0.f;
    }
    pin(dk_acc);
    pin(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss(st, desc_k<D>(ak, BKV, kk), desc_k<D>(q_tile, BQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < VSTEPS; ++kk)
      wgmma_ss(dpt, desc_k<DV>(av, BKV, kk), desc_k<DV>(g_tile, BQ, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin(st);
    pin(dpt);

    // P^T and dS^T in the accumulator's layout: st[4t + e] is key row
    // kr0 + 8 (e >> 1), query column q0 + 8t + c0 + (e & 1)
    const bool edge =
        k0 + kw + 64 > Skv || q0 + BQ > Sq || (causal && k0 + kw + 63 > q0);
#pragma unroll
    for (int i = 0; i < SREG; ++i) {
      const int t = i / 4, e = i & 1;
      float p = exp2f(st[i] * scale_log2 - lq[t][e]);
      if (edge) {
        const int kp = kr0 + 8 * ((i >> 1) & 1), qp = q0 + 8 * t + c0 + e;
        if (kp >= Skv || qp >= Sq || (causal && kp > qp)) p = 0.f;
      }
      st[i] = p;
      dpt[i] = p * (dpt[i] - dd[t][e]) * scale;
    }
    // P^T and dS^T as two bf16 terms each, in the A-fragment layout: slice
    // kk's four registers are the accumulator's [8kk .. 8kk+7] pairwise
    uint32_t p_hi[QSTEPS][4], p_lo[QSTEPS][4], ds_hi[QSTEPS][4], ds_lo[QSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < QSTEPS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1], p_hi[kk][e], p_lo[kk][e]);
        split_bf16(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1], ds_hi[kk][e], ds_lo[kk][e]);
      }

    // dV += P^T dO, dK += dS^T Q: dO and Q MN-major, hi then lo
    pin(dk_acc);
    pin(dv_acc);
    pin(p_hi);
    pin(p_lo);
    pin(ds_hi);
    pin(ds_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QSTEPS; ++kk)
      wgmma_rs(dv_acc, p_hi[kk], desc_mn<DV>(g_tile, BQ, kk));
#pragma unroll
    for (int kk = 0; kk < QSTEPS; ++kk)
      wgmma_rs(dv_acc, p_lo[kk], desc_mn<DV>(g_tile, BQ, kk));
#pragma unroll
    for (int kk = 0; kk < QSTEPS; ++kk) wgmma_rs(dk_acc, ds_hi[kk], desc_mn<D>(q_tile, BQ, kk));
#pragma unroll
    for (int kk = 0; kk < QSTEPS; ++kk) wgmma_rs(dk_acc, ds_lo[kk], desc_mn<D>(q_tile, BQ, kk));
    wgmma_commit();
    wgmma_wait_all();
    pin(dk_acc);
    pin(dv_acc);
    pin(p_hi);
    pin(p_lo);
    pin(ds_hi);
    pin(ds_lo);
  }

  if constexpr (!SPLIT) {
    // each warpgroup's own 64 keys, summed over every step in order
    store_rows<D>(dk, dk_acc, k0 + kw, Skv, K, kh, b);
    store_rows<DV>(dv, dv_acc, k0 + kw, Skv, K, kh, b);
  } else {
    // warpgroup 1's partial dK and dV into warpgroup 0's, in that order,
    // through the rings' memory (every step's tiles are consumed by now)
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem_raw + (sring - smem_u32(smem_raw)));
    const int t = tid % WG;
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < KREG; ++i) red[i * WG + t] = dk_acc[i];
#pragma unroll
      for (int i = 0; i < VREG; ++i) red[(KREG + i) * WG + t] = dv_acc[i];
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < KREG; ++i) dk_acc[i] += red[i * WG + t];
#pragma unroll
      for (int i = 0; i < VREG; ++i) dv_acc[i] += red[(KREG + i) * WG + t];
      store_rows<D>(dk, dk_acc, k0, Skv, K, kh, b);
      store_rows<DV>(dv, dv_acc, k0, Skv, K, kh, b);
    }
  }
}

struct Call {
  const void *q, *k, *v, *g, *lse, *dvec;
  void *dk, *dv;
  int B, Sq, Skv, H, K, causal;
  cudaStream_t stream;
};

template <int D, int DV, int BKV, int BQ>
cudaError_t launch_tiles(const Call& c) {
  if constexpr (!admits<D, DV, BKV, BQ>()) {
    return cudaErrorInvalidValue;  // not built: its registers or shared memory would not fit
  } else {
    CUtensorMap maps[4];
    if (!(make_map<D>(&maps[0], c.q, c.B, c.Sq, c.H, BQ) &&
          make_map<D>(&maps[1], c.k, c.B, c.Skv, c.K, BKV) &&
          make_map<DV>(&maps[2], c.v, c.B, c.Skv, c.K, BKV) &&
          make_map<DV>(&maps[3], c.g, c.B, c.Sq, c.H, BQ)))
      return cudaErrorInvalidValue;
    constexpr int smem = smem_bytes<D, DV, BKV, BQ>();
    static bool configured = false;  // once per instantiation (a repeat is harmless)
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_bwd_dkv_sm90_kernel<D, DV, BKV, BQ>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      configured = true;
    }
    const float root = sqrtf(static_cast<float>(D));
    const dim3 grid(c.K, c.B, (c.Skv + BKV - 1) / BKV);
    flash_bwd_dkv_sm90_kernel<D, DV, BKV, BQ><<<grid, NWG * WG, smem, c.stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(c.lse),
        static_cast<const float*>(c.dvec), static_cast<__nv_bfloat16*>(c.dk),
        static_cast<__nv_bfloat16*>(c.dv), c.Sq, c.Skv, c.H, c.K, LOG2E / root, 1.0f / root,
        c.causal);
    return cudaGetLastError();
  }
}

// The instantiation of block_k x block_q.
template <int D, int DV>
cudaError_t launch(const Call& c, int block_k, int block_q) {
  if (block_k == 64 && block_q == 16) return launch_tiles<D, DV, 64, 16>(c);
  if (block_k == 64 && block_q == 32) return launch_tiles<D, DV, 64, 32>(c);
  if (block_k == 64 && block_q == 64) return launch_tiles<D, DV, 64, 64>(c);
  if (block_k == 128 && block_q == 16) return launch_tiles<D, DV, 128, 16>(c);
  if (block_k == 128 && block_q == 32) return launch_tiles<D, DV, 128, 32>(c);
  if (block_k == 128 && block_q == 64) return launch_tiles<D, DV, 128, 64>(c);
  return cudaErrorInvalidValue;
}

template <int D, int DV, int BKV, int BQ>
int smem_tiles() {
  return admits<D, DV, BKV, BQ>() ? smem_bytes<D, DV, BKV, BQ>() : -1;
}

template <int D, int DV>
int smem_dv(int block_k, int block_q) {
  if (block_k == 64 && block_q == 16) return smem_tiles<D, DV, 64, 16>();
  if (block_k == 64 && block_q == 32) return smem_tiles<D, DV, 64, 32>();
  if (block_k == 64 && block_q == 64) return smem_tiles<D, DV, 64, 64>();
  if (block_k == 128 && block_q == 16) return smem_tiles<D, DV, 128, 16>();
  if (block_k == 128 && block_q == 32) return smem_tiles<D, DV, 128, 32>();
  if (block_k == 128 && block_q == 64) return smem_tiles<D, DV, 128, 64>();
  return -1;
}

}  // namespace

// q (B,Sq,H,D), g (B,Sq,H,Dv), k (B,Skv,K,D), v (B,Skv,K,Dv) contiguous bf16
// with 16-byte aligned pointers, lse and dvec (B,H,Sq) fp32; block_k (64 or
// 128: keys a block) and block_q (16, 32 or 64: queries a step); writes dk
// (B,Skv,K,D) and dv (B,Skv,K,Dv) bf16.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue when a tensor map cannot be made, (D, Dv)
// is not one of (32, 32), (64, 64), (96, 96), (128, 128), (96, 64), or the
// tiles' instantiation is not built).
extern "C" int repro_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                        const void* g, const void* lse, const void* dvec,
                                        void* dk, void* dv, int B, int Sq, int Skv, int H,
                                        int K, int D, int Dv, int causal, int block_k,
                                        int block_q, void* stream) {
  const Call c{q, k, v, g, lse, dvec, dk, dv, B, Sq, Skv, H, K, causal,
               static_cast<cudaStream_t>(stream)};
  if (D == 96 && Dv == 64) return launch<96, 64>(c, block_k, block_q);
  if (D != Dv) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<32, 32>(c, block_k, block_q);
    case 64: return launch<64, 64>(c, block_k, block_q);
    case 96: return launch<96, 96>(c, block_k, block_q);
    case 128: return launch<128, 128>(c, block_k, block_q);
    default: return cudaErrorInvalidValue;
  }
}

// A block's dynamic shared memory at (D, Dv) and block_k x block_q; -1
// where that instantiation is not built.
extern "C" int repro_flash_bwd_dkv_sm90_smem(int D, int Dv, int block_k, int block_q) {
  if (D == 96 && Dv == 64) return smem_dv<96, 64>(block_k, block_q);
  if (D != Dv) return -1;
  switch (D) {
    case 32: return smem_dv<32, 32>(block_k, block_q);
    case 64: return smem_dv<64, 64>(block_k, block_q);
    case 96: return smem_dv<96, 96>(block_k, block_q);
    case 128: return smem_dv<128, 128>(block_k, block_q);
    default: return -1;
  }
}
