// Flash-attention backward, dq pass, for Hopper (sm_90a), fp32: every
// product on the tensor cores as three tf32 products (split-TF32), every
// tile brought in by TMA.  bf16 inputs go to flash_bwd_dq_sm90.cu.
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` (the `pl.pallas_call` at
// l.280 of src/repro/kernels/flash_attention/flash_attention.py, reached
// through `flash_attention_bwd`) for fp32 inputs.  Same function: for each
// query row, p = exp(s - lse) from the forward's lse (s = q.k D^-0.5,
// top-left causal mask k_pos <= q_pos), dp = dO.V^T, ds = p (dp - Dvec)
// D^-0.5 and dq = ds.K, summed in fp32, with q-head h reading kv-head
// h*K/H.  Dvec = rowsum(dO * O), a `jnp` expression before the reference's
// launch (l.274), is this kernel's prologue: each block computes it for its
// own rows and writes it out for the dk/dv pass (flash_bwd_dkv_sm90_fp32.cu),
// which runs after this one on the same stream.  Inputs: q (B,Sq,H,D),
// out, dO (B,Sq,H,Dv), k (B,Skv,K,D), v (B,Skv,K,Dv), contiguous fp32 on
// 16-byte boundaries; lse (B,H,Sq) fp32; D == Dv in {32, 64, 96, 128} or
// (D, Dv) = (96, 64) (MLA), any Sq and Skv.
//
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s tf32 dense): at the training
// shape (B=4, H=16, K=8, D=128, S=512, causal) the function is 6 D flops for
// each of the 8.4 M visible (q, k) pairs, 6.45 GFLOP, issued as three tf32
// products each: 19.4 GFLOP, 39.1 us; it moves 84 MB (q, k, v, O, dO, lse
// read once; dq, Dvec written once): 25 us.  Operations bound it; at
// minicpm3's (96, 64) (B=4, S=512, H=K=40; 4 D + 2 Dv a pair) 10.8 GFLOP,
// 32.3 issued, 65.2 us (158 MB: 47 us); at phi-3's (96, 96), S=768, H=K=32,
// 21.8 GFLOP, 65.3 issued, 132 us.
//
// Why three terms.  Each product is a_hi b_lo + a_lo b_hi + a_hi b_hi, with
// x_hi = x with its low 13 mantissa bits cleared and x_lo = the same of
// x - x_hi (sm90.cuh's split_tf32), the cross terms first.  A CPU model of
// the pair's arithmetic (tests/test_torch_flash_bwd_fp32_sm90.py, at B=1,
// S=512, H=4, K=2, D=128, causal, numpy seed 0; `python
// tests/test_torch_flash_bwd_fp32_sm90.py` prints it) holds dq, dk and dv
// to the plain backward: elements beyond the element check |err| <= 1e-4
// (of 262,144 dq, 131,072 dk and dv) and ||err|| / ||ref||, against phase
// 7's 1e-5 limit on a training step's relative gradient differences:
//   terms in        dq beyond, rel       dk beyond, rel       dv beyond, rel
//   S   1           115,982  1.4e-3      56,575  1.4e-3       59,520  1.4e-3
//   S   2            48,498  7.1e-4      31,050  7.1e-4       33,411  7.1e-4
//   dP  1            65,221  9.4e-4      34,082  9.3e-4            0  9.9e-7
//   dP  2            20,612  5.0e-4      15,504  5.2e-4            0  9.9e-7
//   dQ  1            59,024  7.7e-4           0  1.2e-6            0  9.9e-7
//   dQ  2            16,316  4.2e-4           0  1.2e-6            0  9.9e-7
//   dV  1, 2              0  1.2e-6           0  1.2e-6  34,200; 15,401  7.6e-4; 4.2e-4
//   dK  1, 2              0  1.2e-6  33,070; 14,384  7.7e-4; 4.1e-4     0  9.9e-7
//   all 3                 0  1.2e-6           0  1.2e-6            0  9.9e-7
// (2 terms: a_lo b_hi + a_hi b_hi; the other products at 3.)  So all five
// products take three: 19.4 GFLOP here.

// Why dQ is summed afresh each tile.  The tensor cores add a wgmma's
// products to its accumulator with less care than an fp32 add: a sum over
// many tiles drifts (the fp32 forward's lesson, flash_attention_sm90_fp32.cu).
// Each tile's dS K is summed in a fresh accumulator, which holds only that
// tile's part, and added to dQ in fp32 registers; at D=128 in two halves of
// 64 columns, to keep within 255 registers, and at D=96 in two of 48
// (m64n48k8, as the forward's O at Dv=96).
//
// Design, constraint by constraint:
// - Tensor cores: one warpgroup (128 threads) a block owns 64 query rows of
//   one q-head and walks key tiles of BK keys (32 untuned; below).  S = Q K^T and dP = dO V^T are
//   m64n32k8 tf32 wgmmas with A (Q or dO) and B (K or V) from shared
//   memory, K-major as they lie.  The dP accumulator, turned into dS in
//   place and split into hi and lo, is the A fragment of the RS wgmma
//   dQ += dS K (m64nNk8, N = D / NH: NH = 2 parts at D > 64, else 1).  S
//   reduces over D, dP over Dv; Q, K, K^T and dQ are D wide, dO and V Dv
//   wide.
// - No transpose-B in tf32: its B operand is K^T (keys contiguous).  After
//   each K tile lands the warps write K's hi in place, K_lo beside it, and
//   K^T hi and lo (D rows of 32 keys, 128-byte swizzle) in one pass
//   (sm90.cuh's transpose_split_tf32); V's hi in place and V_lo beside it;
//   Q's and dO's once per block.
// - dS from registers, through a key permutation.  The dP accumulator holds
//   keys 8i + 2t and 8i + 2t + 1 (t = lane % 4) of 8-key group i in a
//   thread; a tf32 A fragment wants k = t and t + 4.  K^T's 8-key groups are
//   written permuted the same way (k slot t holds key 2t, slot t + 4 key
//   2t + 1), so each ds meets its own k.
// - Shared memory at D=128 and 32-key tiles (227 KB is the most a block may
//   take): Q (hi in
//   place) and Q_lo 64 KB; dO and dO_lo 64 KB; K and K_lo 32 KB; V and V_lo
//   32 KB; K^T hi and lo 32 KB: 224 KB, one K/V stage (at (96, 96) 168 KB,
//   at (96, 64) 144 KB: D=96 is three 128-byte atoms a row, and every tile
//   a multiple of 1024 bytes; the library's _smem entry gives each).  So
//   the TMA of tile
//   j+1 starts once tile j's S and dP products have read K and V, and runs
//   under tile j's dS and its dS K product (K^T has its own buffers).
// - Memory: q, k, v and dO are 4-D tensor maps (D, heads, S, B) of fp32
//   made on the host for every call (sm90.cuh's make_map), each TMA load
//   signalled by an mbarrier carrying the transaction bytes.  Dvec's
//   prologue reads O and dO rows with 16-byte loads, two threads a row; each
//   thread then holds lse (as a base-2 exponent) and Dvec of its two rows
//   in registers.  The warps' writes are made visible to the tensor cores,
//   and to the next TMA write, by fence.proxy.async and a barrier.
// - Masking: TMA zero-fills rows past Sq and Skv, but a zero key scores 0,
//   not -inf, against a finite lse, so keys >= Skv, rows >= Sq and (when
//   causal) keys past the row get p = 0 and ds = 0 explicitly, on the tiles
//   that reach an edge; tiles wholly above the diagonal are skipped.
// - Registers: dQ D/2 fp32 a thread, the fresh part D/2 / NH, S and dP 16 each,
//   dS hi and lo 32 (phase 1 of chip_smoke.py prints ptxas -v, spills
//   included).  The split transpose addresses shared memory by 32-bit
//   addresses (sm90.cuh's lds_f32, sts_u32): through generic pointers and
//   unrolled it took the <128> instance to 217 registers, against 184.
// - Grid: (H, B, 64-row query tiles), the query tile on z and reversed:
//   blocks are dispatched x fastest, so the longest causal tiles go first.
//   No atomics: each dq element is one thread's sum over the key tiles in
//   order, so two runs give bit-identical results.
// - Tiles as launch parameters (the tuning cache's fp32 `flash_bwd`
//   entries' dq_block_k, repro_torch/tune/space.py): BK is 16, 32 or 64
//   keys (K^T in Geo<BK, 4>: 64-byte rows at 16, 128 at 32, two 128-byte
//   atoms at 64, sm90.cuh's transpose_split_tf32 and tposed_off), with the
//   same 8-key permutation; dq_block_q stays the warpgroup's 64 rows.  The
//   untuned 32 is always built; 16 and 64 where the shared memory and a
//   thread's registers fit (`admits`, the space's rule): 64-key tiles take
//   328,704 bytes at D=128 and are built at D = 64 and below and at
//   (96, 64).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 64;  // query rows of the warpgroup
// the untuned key tile
constexpr int DEFAULT_BLOCK_K = 32;
// a thread's registers beyond the dQ accumulator, its fresh part and a
// tile's S, dP and dS terms (repro_torch/tune/space.py's FP32_DQ_REG_BASE)
constexpr int REG_BASE = 50;

// Byte offsets of the <D, DV, BK> instantiation's buffers from a 1024-byte
// boundary.  K^T is D rows of BK keys (Geo<BK, 4>): as many bytes as a K
// tile.  dO and V are DV wide.
template <int D, int DV, int BK>
struct Smem {
  using G = Geo<D, 4>;
  using GV = Geo<DV, 4>;
  static constexpr int Q = 0;  // hi in place
  static constexpr int Q_LO = Q + G::tile_bytes(BQ);
  static constexpr int DO = Q_LO + G::tile_bytes(BQ);  // hi in place
  static constexpr int DO_LO = DO + GV::tile_bytes(BQ);
  static constexpr int K = DO_LO + GV::tile_bytes(BQ);  // hi in place
  static constexpr int V = K + G::tile_bytes(BK);       // hi in place
  static constexpr int K_LO = V + GV::tile_bytes(BK);
  static constexpr int V_LO = K_LO + G::tile_bytes(BK);
  static constexpr int KT_HI = V_LO + GV::tile_bytes(BK);
  static constexpr int KT_LO = KT_HI + G::tile_bytes(BK);
  static constexpr int BYTES = KT_LO + G::tile_bytes(BK);
};

// Dynamic shared memory a block of the <D, DV, BK> instantiation takes:
// the buffers, and room to align them to 1024 bytes.
template <int D, int DV, int BK>
constexpr int smem_bytes() {
  return Smem<D, DV, BK>::BYTES + 1024;
}

// Whether the <D, DV, BK> instantiation is built: the default tile always;
// the others where the block's shared memory fits 227 KB and a thread's
// registers (REG_BASE + D/2 + D/2 / NH + 2 BK: dQ, its fresh part, S, dP
// and dS's two terms) fit the 255 that one block an SM leaves.
template <int D, int DV, int BK>
constexpr bool admits() {
  if (BK == DEFAULT_BLOCK_K) return true;
  const int nh = D > 64 ? 2 : 1;
  return smem_bytes<D, DV, BK>() <= 232448 && REG_BASE + D / 2 + D / 2 / nh + 2 * BK <= 255;
}

template <int D, int DV, int BK>
__global__ void __launch_bounds__(WG, 1)
flash_bwd_dq_sm90_fp32_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tg,
                              const float* __restrict__ out, const float* __restrict__ g,
                              const float* __restrict__ lse, float* __restrict__ dvec,
                              float* __restrict__ dq, int Sq, int Skv, int H, int K,
                              float scale_log2, float scale, int causal) {
  using G = Geo<D, 4>;
  using GV = Geo<DV, 4>;
  using GT = Geo<BK, 4>;  // K^T's geometry
  using L = Smem<D, DV, BK>;
  constexpr int KSTEPS = D / 8;        // k8 slices of Q K^T
  constexpr int VSTEPS = DV / 8;       // k8 slices of dO V^T
  constexpr int PSTEPS = BK / 8;       // k8 slices of dS K
  constexpr int OREG = D / 2;          // dQ accumulator registers a thread
  constexpr int NH = D > 64 ? 2 : 1;   // parts of dQ a tile's dS K is summed in: n64, n48
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ float dvec_s[BQ];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));  // the same, generic
  const uint32_t qbar = smem_u32(&bars[0]), kvbar = smem_u32(&bars[1]);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // blocks are dispatched x fastest, z slowest: the longest causal q tiles
  // (the last) go first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h * K / H;
  // causal: keys past the tile's last row are masked for every row
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(qbar, 1);
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    tma_load_pair<D, DV, 4>(&tq, &tg, base + L::Q, base + L::DO, h, q0, b, BQ, qbar);
    tma_load_pair<D, DV, 4>(&tk, &tv, base + L::K, base + L::V, kh, 0, b, BK, kvbar);
  }

  // prologue: Dvec = rowsum(dO * O) for the block's 64 rows, two threads a
  // row, each over half the columns in 16-byte loads
  {
    const int row = tid / 2, half = tid % 2, qp = q0 + row;
    float part = 0.f;
    if (qp < Sq) {
      const size_t off = ((static_cast<size_t>(b) * Sq + qp) * H + h) * DV + half * (DV / 2);
#pragma unroll
      for (int c = 0; c < DV / 2; c += 4) {
        const float4 ov = *reinterpret_cast<const float4*>(out + off + c);
        const float4 gv = *reinterpret_cast<const float4*>(g + off + c);
        part = fmaf(gv.x, ov.x, part);
        part = fmaf(gv.y, ov.y, part);
        part = fmaf(gv.z, ov.z, part);
        part = fmaf(gv.w, ov.w, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      dvec_s[row] = part;
      if (qp < Sq) dvec[(static_cast<size_t>(b) * H + h) * Sq + qp] = part;
    }
  }
  __syncthreads();

  // this thread's two rows, their lse (as a base-2 exponent) and Dvec, and
  // its first key column in every 8-column chunk
  const int r0 = q0 + 16 * warp + lane / 4, r1 = r0 + 8;
  const int c0 = 2 * (lane % 4);
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r ? r1 : r0;
    l2[r] = qp < Sq ? lse[(static_cast<size_t>(b) * H + h) * Sq + qp] * LOG2E : 0.f;
    dd[r] = dvec_s[qp - q0];
  }
  float dq_acc[OREG];
#pragma unroll
  for (int i = 0; i < OREG; ++i) dq_acc[i] = 0.f;

  mbar_wait(qbar, 0);
  split_tile_tf32(gbase + L::Q, gbase + L::Q_LO, G::tile_bytes(BQ));
  split_tile_tf32(gbase + L::DO, gbase + L::DO_LO, GV::tile_bytes(BQ));
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    // every thread is past tile j-1's dS K product: K^T may be rewritten
    __syncthreads();
    mbar_wait(kvbar, j & 1);
    transpose_split_tf32<D, BK>(base + L::K, base + L::K, base + L::K_LO, base + L::KT_HI,
                                base + L::KT_LO);
    split_tile_tf32(gbase + L::V, gbase + L::V_LO, GV::tile_bytes(BK));
    fence_proxy_async();
    __syncthreads();

    // S = Q_hi K_lo^T + Q_lo K_hi^T + Q_hi K_hi^T, dP the same of dO and V:
    // K-major A and B, k8 slices walk the row inside an atom, then the next
    float sc[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {  // overwritten: the first slice has scale_d 0
      sc[i] = 0.f;
      dp[i] = 0.f;
    }
    pin(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss_tf32(sc, desc_k_tf32<D>(base + L::Q, BQ, kk),
                    desc_k_tf32<D>(base + L::K_LO, BK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss_tf32(sc, desc_k_tf32<D>(base + L::Q_LO, BQ, kk),
                    desc_k_tf32<D>(base + L::K, BK, kk), 1);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss_tf32(sc, desc_k_tf32<D>(base + L::Q, BQ, kk),
                    desc_k_tf32<D>(base + L::K, BK, kk), 1);
#pragma unroll
    for (int kk = 0; kk < VSTEPS; ++kk)
      wgmma_ss_tf32(dp, desc_k_tf32<DV>(base + L::DO, BQ, kk),
                    desc_k_tf32<DV>(base + L::V_LO, BK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < VSTEPS; ++kk)
      wgmma_ss_tf32(dp, desc_k_tf32<DV>(base + L::DO_LO, BQ, kk),
                    desc_k_tf32<DV>(base + L::V, BK, kk), 1);
#pragma unroll
    for (int kk = 0; kk < VSTEPS; ++kk)
      wgmma_ss_tf32(dp, desc_k_tf32<DV>(base + L::DO, BQ, kk),
                    desc_k_tf32<DV>(base + L::V, BK, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);
    pin(dp);

    // every warp's products have read K and V: tile j+1 may come in
    __syncthreads();
    if (tid == 0 && j + 1 < n_tiles)
      tma_load_pair<D, DV, 4>(&tk, &tv, base + L::K, base + L::V, kh, k0 + BK, b, BK, kvbar);

    // dS in dP's registers, in the accumulator's layout: dp[4i + e] is row
    // (e < 2 ? r0 : r1), key column k0 + 8i + c0 + (e & 1)
    const bool edge = k0 + BK > Skv || q0 + BQ > Sq || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2f(sc[i] * scale_log2 - l2[r]);
      if (edge) {
        const int kp = k0 + 8 * (i / 4) + c0 + (i & 1), qp = r ? r1 : r0;
        if (kp >= Skv || qp >= Sq || (causal && kp > qp)) p = 0.f;
      }
      dp[i] = p * (dp[i] - dd[r]) * scale;
    }
    // dS as two tf32 terms in the A-fragment layout of the RS wgmma
    uint32_t ds_hi[PSTEPS][4], ds_lo[PSTEPS][4];
    tf32_fragments(dp, ds_hi, ds_lo);

    // dQ += dS_hi K^T_lo + dS_lo K^T_hi + dS_hi K^T_hi, the tile's product
    // in a fresh accumulator added to dQ in fp32, for NH parts of D columns
    // (K^T rows of GT::SW bytes in an atom, 8 of them a swizzle period, so
    // a part of 48 starts on a period too); the k8 slice kk is 32 bytes into
    // its atom
#pragma unroll
    for (int part = 0; part < NH; ++part) {
      float t[OREG / NH];
#pragma unroll
      for (int i = 0; i < OREG / NH; ++i) t[i] = 0.f;
      const uint32_t kt_lo = base + L::KT_LO + part * (D / NH) * GT::SW;
      const uint32_t kt_hi = base + L::KT_HI + part * (D / NH) * GT::SW;
      pin(t);
      pin(ds_hi);
      pin(ds_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PSTEPS; ++kk)
        wgmma_rs_tf32(t, ds_hi[kk], desc_k_tf32<BK>(kt_lo, D, kk));
#pragma unroll
      for (int kk = 0; kk < PSTEPS; ++kk)
        wgmma_rs_tf32(t, ds_lo[kk], desc_k_tf32<BK>(kt_hi, D, kk));
#pragma unroll
      for (int kk = 0; kk < PSTEPS; ++kk)
        wgmma_rs_tf32(t, ds_hi[kk], desc_k_tf32<BK>(kt_hi, D, kk));
      wgmma_commit();
      wgmma_wait_all();
      pin(t);
      pin(ds_hi);
      pin(ds_lo);
#pragma unroll
      for (int i = 0; i < OREG / NH; ++i) dq_acc[part * (OREG / NH) + i] += t[i];
    }
  }

  store_rows_f32<D>(dq, dq_acc, q0, Sq, H, h, b);
}

template <int D, int DV, int BK>
cudaError_t launch_tiles(const void* q, const void* k, const void* v, const void* out,
                         const void* g, const void* lse, void* dvec, void* dq, int B, int Sq,
                         int Skv, int H, int K, int causal, cudaStream_t stream) {
  if constexpr (!admits<D, DV, BK>()) {
    return cudaErrorInvalidValue;  // not built: its shared memory or registers would not fit
  } else {
    CUtensorMap maps[4];
    if (!(make_map<D, 4>(&maps[0], q, B, Sq, H, BQ) &&
          make_map<D, 4>(&maps[1], k, B, Skv, K, BK) &&
          make_map<DV, 4>(&maps[2], v, B, Skv, K, BK) &&
          make_map<DV, 4>(&maps[3], g, B, Sq, H, BQ)))
      return cudaErrorInvalidValue;
    constexpr int smem = smem_bytes<D, DV, BK>();
    static bool configured = false;  // once per instantiation (a repeat is harmless)
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_bwd_dq_sm90_fp32_kernel<D, DV, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return err;
      configured = true;
    }
    const float root = sqrtf(static_cast<float>(D));
    const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
    flash_bwd_dq_sm90_fp32_kernel<D, DV, BK><<<grid, WG, smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(out),
        static_cast<const float*>(g), static_cast<const float*>(lse), static_cast<float*>(dvec),
        static_cast<float*>(dq), Sq, Skv, H, K, LOG2E / root, 1.0f / root, causal);
    return cudaGetLastError();
  }
}

// The instantiation of block_k (block_q is the warpgroup's 64 rows).
template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* g, const void* lse, void* dvec, void* dq, int B, int Sq,
                   int Skv, int H, int K, int causal, int block_q, int block_k,
                   cudaStream_t stream) {
  if (block_q != BQ) return cudaErrorInvalidValue;
  switch (block_k) {
    case 16:
      return launch_tiles<D, DV, 16>(q, k, v, out, g, lse, dvec, dq, B, Sq, Skv, H, K, causal,
                                     stream);
    case 32:
      return launch_tiles<D, DV, 32>(q, k, v, out, g, lse, dvec, dq, B, Sq, Skv, H, K, causal,
                                     stream);
    case 64:
      return launch_tiles<D, DV, 64>(q, k, v, out, g, lse, dvec, dq, B, Sq, Skv, H, K, causal,
                                     stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int D, int DV>
int smem_dv(int block_q, int block_k) {
  if (block_q != BQ) return -1;
  switch (block_k) {
    case 16: return admits<D, DV, 16>() ? smem_bytes<D, DV, 16>() : -1;
    case 32: return admits<D, DV, 32>() ? smem_bytes<D, DV, 32>() : -1;
    case 64: return admits<D, DV, 64>() ? smem_bytes<D, DV, 64>() : -1;
    default: return -1;
  }
}

}  // namespace

// q (B,Sq,H,D), out, g (B,Sq,H,Dv), k (B,Skv,K,D), v (B,Skv,K,Dv)
// contiguous fp32 with 16-byte aligned pointers, lse (B,H,Sq) fp32 from the
// forward; block_q (64: the warpgroup's query rows) and block_k (16, 32 or
// 64: keys a tile); writes dq (B,Sq,H,D) and dvec (B,H,Sq), fp32.  Returns
// the cudaError_t of the launch (cudaErrorInvalidValue when a tensor map
// cannot be made, (D, Dv) is neither D == Dv in {32, 64, 96, 128} nor
// (96, 64), or the tiles' instantiation is not built).
extern "C" int repro_flash_bwd_dq_sm90_fp32(const void* q, const void* k, const void* v,
                                            const void* out, const void* g, const void* lse,
                                            void* dvec, void* dq, int B, int Sq, int Skv,
                                            int H, int K, int D, int Dv, int causal,
                                            int block_q, int block_k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DQ_ARGS q, k, v, out, g, lse, dvec, dq, B, Sq, Skv, H, K, causal, block_q, block_k, st
  if (D == 96 && Dv == 64) return launch<96, 64>(REPRO_DQ_ARGS);
  if (Dv != D) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<32, 32>(REPRO_DQ_ARGS);
    case 64: return launch<64, 64>(REPRO_DQ_ARGS);
    case 96: return launch<96, 96>(REPRO_DQ_ARGS);
    case 128: return launch<128, 128>(REPRO_DQ_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_DQ_ARGS
}

// Dynamic shared memory a block of the (D, Dv) instantiation of block_q x
// block_k takes, in bytes; -1 where that instantiation is not built.
extern "C" int repro_flash_bwd_dq_sm90_fp32_smem(int D, int Dv, int block_q, int block_k) {
  if (D == 96 && Dv == 64) return smem_dv<96, 64>(block_q, block_k);
  if (Dv != D) return -1;
  switch (D) {
    case 32: return smem_dv<32, 32>(block_q, block_k);
    case 64: return smem_dv<64, 64>(block_q, block_k);
    case 96: return smem_dv<96, 96>(block_q, block_k);
    case 128: return smem_dv<128, 128>(block_q, block_k);
    default: return -1;
  }
}
