// Flash-attention backward, dk/dv pass, for Hopper (sm_90a), fp32: every
// product on the tensor cores as three tf32 products (split-TF32), every
// tile brought in by TMA.  bf16 inputs go to flash_bwd_dkv_sm90.cu.
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel` (the `pl.pallas_call` at
// l.307 of src/repro/kernels/flash_attention/flash_attention.py, reached
// through `flash_attention_bwd`) for fp32 inputs.  Same function: for each
// key of kv-head kh, over the queries the causal mask lets see it and the
// G = H/K q-heads that read kh, p = exp(s - lse) (s = q.k D^-0.5, top-left
// causal mask k_pos <= q_pos), ds = p (dO.v - Dvec) D^-0.5, dv = sum p dO
// and dk = sum ds q, all summed in fp32.  Dvec = rowsum(dO * O) comes from
// the dq pass (flash_bwd_dq_sm90_fp32.cu), launched before this one on the
// same stream.  Inputs: q (B,Sq,H,D), dO (B,Sq,H,Dv), k (B,Skv,K,D), v
// (B,Skv,K,Dv), contiguous fp32 on 16-byte boundaries; lse, Dvec (B,H,Sq)
// fp32; D == Dv in {32, 64, 96, 128} or (D, Dv) = (96, 64) (MLA), any Sq
// and Skv.
//
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s tf32 dense): at the training
// shape (B=4, H=16, K=8, D=128, S=512, causal) the function is 8 D flops for
// each of the 8.4 M visible (q, k) pairs, 8.6 GFLOP, issued as three tf32
// products each: 25.8 GFLOP, 52.2 us; it moves 67 MB (q, k, v, dO, lse,
// Dvec read once; dk, dv written once): 20 us.  Operations bound it; at
// minicpm3's (96, 64) (B=4, S=512, H=K=40; 4 D + 4 Dv a pair) 13.4 GFLOP,
// 40.3 issued, 81.5 us; at phi-3's (96, 96), S=768, H=K=32, 29.0 GFLOP,
// 87.1 issued, 176 us.
//
// Why three terms, and why each sum goes through a fresh accumulator: as in
// flash_bwd_dq_sm90_fp32.cu (the CPU model in
// tests/test_torch_flash_bwd_fp32_sm90.py, and the fp32 forward's drift).
// Each step's P^T dO and dS^T Q are summed in fresh accumulators, which
// hold only that step's part, and added to dV and dK in fp32 registers.
//
// Design, constraint by constraint:
// - Tensor cores, transposed.  A block owns 64 keys of one kv-head and
//   walks 16-query steps.  S^T = K Q^T and dP^T = V dO^T are m64n16k8 tf32
//   wgmmas with A (K or V) and B (the step's Q or dO) from shared memory,
//   K-major as they lie: keys on M, queries on N.  Their accumulators,
//   split into hi and lo, are the A fragments of the RS wgmmas dV += P^T dO
//   and dK += dS^T Q.  P^T and dS^T never leave registers.
// - Registers: dK and dV at D=128 are 128 fp32 a thread for one warpgroup,
//   and with a fresh accumulator, S^T, dP^T and the fragments beside them
//   one warpgroup spills.  So a block has two warpgroups, each owning half
//   of D's columns of dK and dV (D/4 registers each).  Each sums S^T and
//   dP^T over its half of D; the halves are swapped through shared memory
//   and added, own half first (x + y = y + x in fp32, so both warpgroups
//   hold the same P^T and dS^T); each then multiplies them into its
//   columns: RS wgmmas m64nNk8 with N = D/2 for dK and Dv/2 for dV (n48 at
//   96).  S^T's halves are halves of D, dP^T's halves of Dv.  Phase 1 of
//   chip_smoke.py prints ptxas -v, spills included.
// - No transpose-B in tf32: the RS products reduce over queries, so their B
//   operands are dO^T (Dv rows) and Q^T (D rows) of 16 queries (64-byte
//   rows, 64-byte swizzle: sm90.cuh's Geo<16, 4>).  A warpgroup's rows
//   start D/2 or Dv/2 rows in, a multiple of 512 bytes (the 64-byte
//   swizzle's period: 8 rows) at every width, 3,072 at 96.  Each step's raw Q and dO tiles land in
//   a TMA stage of their own; the eight warps write each as it lies (hi,
//   lo) and transposed (hi, lo) in one pass (transpose_split_tf32), the
//   queries of each 8-query group permuted (k slot t holds query 2t, slot
//   t + 4 query 2t + 1) so that the S^T accumulator's register pairs are
//   the A fragment's slots.  K's and V's hi are written in place, with K_lo
//   and V_lo beside them, once per block.
// - Shared memory at D=128 (227 KB is the most a block may take): K, K_lo,
//   V, V_lo 128 KB; the raw (Q, dO) stage 16 KB; a step's Q, dO hi and lo
//   32 KB and Q^T, dO^T hi and lo 32 KB; the swap of S^T and dP^T halves
//   16 KB: 224 KB, one block an SM (at (96, 96) 172 KB, at (96, 64)
//   146 KB: D=96 is three 128-byte atoms a row, every tile a multiple of
//   1024 bytes; the library's _smem entry gives each).  The bf16 kernel's
//   32-query steps would
//   take 256 KB before the swap.  The TMA of step i+1 starts once step i's
//   tiles are split, and runs under step i's products.
// - Memory: q, k, v and dO are 4-D tensor maps (D, heads, S, B) of fp32,
//   made on the host for every call (sm90.cuh's make_map), each TMA load
//   signalled by an mbarrier carrying the transaction bytes.  lse and Dvec
//   of a thread's 4 query columns come by plain loads into registers,
//   issued before the step's tiles are waited for.
// - Masking: TMA zero-fills rows past Sq and Skv, but a zero row scores 0,
//   not -inf, against a finite lse, so queries >= Sq, keys >= Skv and (when
//   causal) keys past the query get p = 0 and ds = 0 explicitly, on the
//   steps that reach an edge.  Causal key tiles start at their own first
//   query.
// - Determinism: no atomics.  The block sums its steps in ascending order
//   (query tile, then q-head), so two runs give bit-identical results.
// - Grid: (K, B, 64-key tiles), the key tile on z in ascending order: key
//   tile 0 sees the most queries, and blocks are dispatched x fastest, so
//   the longest run first.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BKV = 64;       // keys of a block
constexpr int BQ = 16;        // queries of a step
constexpr int NWG = 2;        // warpgroups, each owning half of D's columns
constexpr int SREG = BQ / 2;  // S^T, dP^T accumulator registers a thread

// Byte offsets of the block's buffers from a 1024-byte boundary.  A
// transposed tile is D (Q^T) or DV (dO^T) rows of BQ queries: as many bytes
// as a step's tile of Q or dO.
template <int D, int DV>
struct Smem {
  using G = Geo<D, 4>;
  using GV = Geo<DV, 4>;
  static constexpr int K = 0;  // hi in place
  static constexpr int K_LO = K + G::tile_bytes(BKV);
  static constexpr int V = K_LO + G::tile_bytes(BKV);  // hi in place
  static constexpr int V_LO = V + GV::tile_bytes(BKV);
  static constexpr int RAW = V_LO + GV::tile_bytes(BKV);  // the TMA stage: Q, then dO
  static constexpr int Q_HI = RAW + G::tile_bytes(BQ) + GV::tile_bytes(BQ);
  static constexpr int Q_LO = Q_HI + G::tile_bytes(BQ);
  static constexpr int G_HI = Q_LO + G::tile_bytes(BQ);
  static constexpr int G_LO = G_HI + GV::tile_bytes(BQ);
  static constexpr int QT_HI = G_LO + GV::tile_bytes(BQ);
  static constexpr int QT_LO = QT_HI + G::tile_bytes(BQ);
  static constexpr int GT_HI = QT_LO + G::tile_bytes(BQ);
  static constexpr int GT_LO = GT_HI + GV::tile_bytes(BQ);
  // warpgroup w's S^T and dP^T halves: fp32 [w][2 SREG][WG]
  static constexpr int SWAP = GT_LO + GV::tile_bytes(BQ);
  static constexpr int BYTES = SWAP + NWG * 2 * SREG * WG * 4;
};

// Step i's Q and dO tiles (query tile i / group, q-head kh group + i % group)
// into the raw stage, completing on `bar`.
template <int D, int DV>
__device__ __forceinline__ void load_step(const CUtensorMap* tq, const CUtensorMap* tg,
                                          uint32_t base, uint32_t bar, int i, int q_begin,
                                          int group, int kh, int b) {
  const uint32_t dst = base + Smem<D, DV>::RAW;
  tma_load_pair<D, DV, 4>(tq, tg, dst, dst + Geo<D, 4>::tile_bytes(BQ),
                          kh * group + i % group, q_begin + i / group * BQ, b, BQ, bar);
}

// acc += A_hi B_lo + A_lo B_hi + A_hi B_hi over the step's queries: A from
// registers, B the warpgroup's rows of a transposed tile (N rows of BQ
// queries, hi and lo); the sum made in a fresh accumulator and added to acc
// in fp32.
template <int N>
__device__ __forceinline__ void add_product(float (&acc)[N / 2], uint32_t (&a_hi)[BQ / 8][4],
                                            uint32_t (&a_lo)[BQ / 8][4], uint32_t b_hi,
                                            uint32_t b_lo) {
  float t[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) t[i] = 0.f;
  pin(t);
  pin(a_hi);
  pin(a_lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BQ / 8; ++kk) wgmma_rs_tf32(t, a_hi[kk], desc_k_tf32<BQ>(b_lo, N, kk));
#pragma unroll
  for (int kk = 0; kk < BQ / 8; ++kk) wgmma_rs_tf32(t, a_lo[kk], desc_k_tf32<BQ>(b_hi, N, kk));
#pragma unroll
  for (int kk = 0; kk < BQ / 8; ++kk) wgmma_rs_tf32(t, a_hi[kk], desc_k_tf32<BQ>(b_hi, N, kk));
  wgmma_commit();
  wgmma_wait_all();
  pin(t);
  pin(a_hi);
  pin(a_lo);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] += t[i];
}

template <int D, int DV>
__global__ void __launch_bounds__(NWG * WG, 1)
flash_bwd_dkv_sm90_fp32_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tg,
                               const float* __restrict__ lse, const float* __restrict__ dvec,
                               float* __restrict__ dk, float* __restrict__ dv, int Sq,
                               int Skv, int H, int K, float scale_log2, float scale,
                               int causal) {
  using G = Geo<D, 4>;
  using GV = Geo<DV, 4>;
  using L = Smem<D, DV>;
  constexpr int DH = D / NWG;      // columns of dK a warpgroup owns
  constexpr int DHV = DV / NWG;    // columns of dV a warpgroup owns
  constexpr int KSTEPS = DH / 8;   // k8 slices of a warpgroup's half of D (S^T)
  constexpr int VSTEPS = DHV / 8;  // k8 slices of its half of DV (dP^T)
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kvbar = smem_u32(&bars[0]), rbar = smem_u32(&bars[1]);

  const int tid = threadIdx.x;
  const int wg = tid / WG, warp = tid / 32 % 4, lane = tid % 32;
  const int kh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BKV;
  const int group = H / K;
  // causal: queries before the block's first key see none of its keys
  const int q_begin = causal ? k0 : 0;
  const int n_steps = q_begin < Sq ? (Sq - q_begin + BQ - 1) / BQ * group : 0;

  if (tid == 0) {
    mbar_init(kvbar, 1);
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    tma_load_pair<D, DV, 4>(&tk, &tv, base + L::K, base + L::V, kh, k0, b, BKV, kvbar);
    if (n_steps > 0) load_step<D, DV>(&tq, &tg, base, rbar, 0, q_begin, group, kh, b);
  }

  // this thread's key rows kr0 and kr0 + 8, its first query column in every
  // 8-column chunk, and its slots in the swap of S^T and dP^T halves
  const int kr0 = k0 + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t swap_mine = base + L::SWAP + (wg * 2 * SREG * WG + tid % WG) * 4;
  const uint32_t swap_other = base + L::SWAP + ((1 - wg) * 2 * SREG * WG + tid % WG) * 4;
  float dk_acc[DH / 2], dv_acc[DHV / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DHV / 2; ++i) dv_acc[i] = 0.f;

  mbar_wait(kvbar, 0);
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));  // base, generic
  split_tile_tf32(gbase + L::K, gbase + L::K_LO, G::tile_bytes(BKV));
  split_tile_tf32(gbase + L::V, gbase + L::V_LO, GV::tile_bytes(BKV));
  for (int i = 0; i < n_steps; ++i) {
    const int q0 = q_begin + i / group * BQ, h = kh * group + i % group;
    // every thread is past step i-1's products and reads of the swap: the
    // step's buffers may be rewritten
    __syncthreads();

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
    mbar_wait(rbar, i & 1);
    transpose_split_tf32<D, BQ>(base + L::RAW, base + L::Q_HI, base + L::Q_LO,
                                base + L::QT_HI, base + L::QT_LO);
    transpose_split_tf32<DV, BQ>(base + L::RAW + G::tile_bytes(BQ), base + L::G_HI,
                                 base + L::G_LO, base + L::GT_HI, base + L::GT_LO);
    fence_proxy_async();
    __syncthreads();
    // the raw stage is split: step i+1's tiles may come in
    if (tid == 0 && i + 1 < n_steps)
      load_step<D, DV>(&tq, &tg, base, rbar, i + 1, q_begin, group, kh, b);

    // the warpgroup's half of S^T = K_hi Q_lo^T + K_lo Q_hi^T + K_hi Q_hi^T
    // and of dP^T, the same of V and dO: the k8 slices of D from wg KSTEPS,
    // of DV from wg VSTEPS
    float st[SREG], dpt[SREG];
#pragma unroll
    for (int j = 0; j < SREG; ++j) {  // overwritten: the first slice has scale_d 0
      st[j] = 0.f;
      dpt[j] = 0.f;
    }
    pin(dk_acc);
    pin(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss_tf32(st, desc_k_tf32<D>(base + L::K, BKV, wg * KSTEPS + kk),
                    desc_k_tf32<D>(base + L::Q_LO, BQ, wg * KSTEPS + kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss_tf32(st, desc_k_tf32<D>(base + L::K_LO, BKV, wg * KSTEPS + kk),
                    desc_k_tf32<D>(base + L::Q_HI, BQ, wg * KSTEPS + kk), 1);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss_tf32(st, desc_k_tf32<D>(base + L::K, BKV, wg * KSTEPS + kk),
                    desc_k_tf32<D>(base + L::Q_HI, BQ, wg * KSTEPS + kk), 1);
#pragma unroll
    for (int kk = 0; kk < VSTEPS; ++kk)
      wgmma_ss_tf32(dpt, desc_k_tf32<DV>(base + L::V, BKV, wg * VSTEPS + kk),
                    desc_k_tf32<DV>(base + L::G_LO, BQ, wg * VSTEPS + kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < VSTEPS; ++kk)
      wgmma_ss_tf32(dpt, desc_k_tf32<DV>(base + L::V_LO, BKV, wg * VSTEPS + kk),
                    desc_k_tf32<DV>(base + L::G_HI, BQ, wg * VSTEPS + kk), 1);
#pragma unroll
    for (int kk = 0; kk < VSTEPS; ++kk)
      wgmma_ss_tf32(dpt, desc_k_tf32<DV>(base + L::V, BKV, wg * VSTEPS + kk),
                    desc_k_tf32<DV>(base + L::G_HI, BQ, wg * VSTEPS + kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    pin(st);
    pin(dpt);

    // swap the halves: each thread's registers at [j][tid], conflict-free;
    // own half plus the other's, the same sum in both warpgroups
#pragma unroll
    for (int j = 0; j < SREG; ++j) {
      sts_u32(swap_mine + j * WG * 4, __float_as_uint(st[j]));
      sts_u32(swap_mine + (SREG + j) * WG * 4, __float_as_uint(dpt[j]));
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SREG; ++j) {
      st[j] += lds_f32(swap_other + j * WG * 4);
      dpt[j] += lds_f32(swap_other + (SREG + j) * WG * 4);
    }

    // P^T and dS^T in the accumulator's layout: st[4t + e] is key row
    // kr0 + 8 (e >> 1), query column q0 + 8t + c0 + (e & 1)
    const bool edge = k0 + BKV > Skv || q0 + BQ > Sq || (causal && k0 + BKV - 1 > q0);
#pragma unroll
    for (int j = 0; j < SREG; ++j) {
      const int t = j / 4, e = j & 1;
      float p = exp2f(st[j] * scale_log2 - lq[t][e]);
      if (edge) {
        const int kp = kr0 + 8 * ((j >> 1) & 1), qp = q0 + 8 * t + c0 + e;
        if (kp >= Skv || qp >= Sq || (causal && kp > qp)) p = 0.f;
      }
      st[j] = p;
      dpt[j] = p * (dpt[j] - dd[t][e]) * scale;
    }

    // dV += P^T dO, then dK += dS^T Q over the warpgroup's columns: B the
    // transposed dO and Q, rows wg DHV .. (wg + 1) DHV - 1 and wg DH .. (wg +
    // 1) DH - 1 (64 bytes each)
    const uint32_t g_rows = wg * DHV * BQ * 4, q_rows = wg * DH * BQ * 4;
    uint32_t a_hi[BQ / 8][4], a_lo[BQ / 8][4];
    tf32_fragments(st, a_hi, a_lo);
    add_product<DHV>(dv_acc, a_hi, a_lo, base + L::GT_HI + g_rows, base + L::GT_LO + g_rows);
    tf32_fragments(dpt, a_hi, a_lo);
    add_product<DH>(dk_acc, a_hi, a_lo, base + L::QT_HI + q_rows, base + L::QT_LO + q_rows);
  }

  store_rows_f32<D, DH>(dk + wg * DH, dk_acc, k0, Skv, K, kh, b);
  store_rows_f32<DV, DHV>(dv + wg * DHV, dv_acc, k0, Skv, K, kh, b);
}

// Dynamic shared memory a block of the <D, DV> instantiation takes: the
// buffers, and room to align them to 1024 bytes.
template <int D, int DV>
constexpr int smem_bytes() {
  return Smem<D, DV>::BYTES + 1024;
}

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const void* lse, const void* dvec, void* dk, void* dv, int B, int Sq,
                   int Skv, int H, int K, int causal, cudaStream_t stream) {
  CUtensorMap maps[4];
  if (!(make_map<D, 4>(&maps[0], q, B, Sq, H, BQ) &&
        make_map<D, 4>(&maps[1], k, B, Skv, K, BKV) &&
        make_map<DV, 4>(&maps[2], v, B, Skv, K, BKV) &&
        make_map<DV, 4>(&maps[3], g, B, Sq, H, BQ)))
    return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<D, DV>();
  static bool configured = false;  // once per instantiation (a repeat is harmless)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_sm90_fp32_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const float root = sqrtf(static_cast<float>(D));
  const dim3 grid(K, B, (Skv + BKV - 1) / BKV);
  flash_bwd_dkv_sm90_fp32_kernel<D, DV><<<grid, NWG * WG, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<float*>(dk), static_cast<float*>(dv), Sq,
      Skv, H, K, LOG2E / root, 1.0f / root, causal);
  return cudaGetLastError();
}

}  // namespace

// q (B,Sq,H,D), g (B,Sq,H,Dv), k (B,Skv,K,D), v (B,Skv,K,Dv) contiguous fp32
// with 16-byte aligned pointers, lse and dvec (B,H,Sq) fp32; writes dk
// (B,Skv,K,D) and dv (B,Skv,K,Dv) fp32.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue when a tensor map cannot be made, or (D, Dv)
// is neither D == Dv in {32, 64, 96, 128} nor (96, 64)).
extern "C" int repro_flash_bwd_dkv_sm90_fp32(const void* q, const void* k, const void* v,
                                             const void* g, const void* lse, const void* dvec,
                                             void* dk, void* dv, int B, int Sq, int Skv,
                                             int H, int K, int D, int Dv, int causal,
                                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 96 && Dv == 64)
    return launch<96, 64>(q, k, v, g, lse, dvec, dk, dv, B, Sq, Skv, H, K, causal, st);
  if (Dv != D) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<32, 32>(q, k, v, g, lse, dvec, dk, dv, B, Sq, Skv, H, K, causal, st);
    case 64: return launch<64, 64>(q, k, v, g, lse, dvec, dk, dv, B, Sq, Skv, H, K, causal, st);
    case 96: return launch<96, 96>(q, k, v, g, lse, dvec, dk, dv, B, Sq, Skv, H, K, causal, st);
    case 128:
      return launch<128, 128>(q, k, v, g, lse, dvec, dk, dv, B, Sq, Skv, H, K, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block of the (D, Dv) instantiation takes, in
// bytes (0 for a pair the entry refuses): what phase 1 of chip_smoke.py
// prints.
extern "C" int repro_flash_bwd_dkv_sm90_fp32_smem(int D, int Dv) {
  if (D == 96 && Dv == 64) return smem_bytes<96, 64>();
  if (Dv != D) return 0;
  switch (D) {
    case 32: return smem_bytes<32, 32>();
    case 64: return smem_bytes<64, 64>();
    case 96: return smem_bytes<96, 96>();
    case 128: return smem_bytes<128, 128>();
    default: return 0;
  }
}
