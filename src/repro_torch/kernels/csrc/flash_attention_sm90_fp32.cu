// Flash-attention forward for Hopper (sm_90a), fp32: both products on the
// tensor cores as three tf32 products each (split-TF32), Q, K and V tiles
// brought in by TMA.  bf16 inputs go to flash_attention_sm90.cu.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` reached through
// `flash_attention_fwd` (the `pl.pallas_call` at l.127) in
// src/repro/kernels/flash_attention/flash_attention.py, for fp32 inputs.
// Same function: causal or non-causal GQA attention with an online softmax
// in fp32, q-head h reading kv-head h*K/H (no head expansion), scale
// D^-0.5, the top-left causal mask k_pos <= q_pos (both from 0, so Sq !=
// Skv keeps the reference's meaning), kv tiles wholly above the diagonal
// skipped, l clamped at 1e-37, outputs out (B,Sq,H,D) and lse = m + log(l)
// (B,H,Sq), both fp32, natural log.  Inputs: q (B,Sq,H,D), k (B,Skv,K,D)
// and v (B,Skv,K,Dv), contiguous fp32 on 16-byte boundaries, D == Dv in
// {32, 64, 96, 128} or (D, Dv) = (96, 64) (MLA's prefill and training), any
// Sq and Skv; out is (B,Sq,H,Dv).
//
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s tf32 dense): at the serve
// shape (B=4, H=16, K=8, D=128, Sq=Skv=512, causal) the function is 4*D
// flops for each of 8,404,992 visible pairs, 4.30 GFLOP, and moves 50.5 MB
// (q, k, v read once, out and lse written once: 15.1 us).  On the CUDA
// cores (67 TFLOP/s) the flops take 64 us; the cheapest tensor-core form
// that passes the fp32 check below is three tf32 products for each, 12.9
// GFLOP: 26.1 us.  Operations bound it, at D = 96 too: minicpm3's (96, 64)
// (B=4, S=512, H=K=40) is 6.72 GFLOP, 20.2 issued, 40.7 us (105 MB: 31.4
// us); phi-3's (96, 96) after 256 patches (S=768, H=K=32) 14.5 GFLOP, 43.5
// issued, 87.9 us.
//
// Why three terms.  The tensor cores read fp32 operands as tf32 (10 of the
// 23 mantissa bits).  Each product is issued as a_hi b_hi + a_hi b_lo +
// a_lo b_hi, with x_hi = x with its low 13 mantissa bits cleared and x_lo =
// the same of x - x_hi, summed in fp32.  Against the plain version's fp32
// element check (|err| <= 2e-5, chip_smoke.py and the reference suite's
// fp32 tolerance), a CPU model of this kernel's arithmetic
// (tests/test_torch_flash_fp32_sm90.py, at B=1, S=512, H=4, K=2, D=128,
// causal, numpy seed 0; 262,144 outputs, 2,048 lse; `python
// tests/test_torch_flash_fp32_sm90.py` prints it) counts the elements
// beyond it:
//   S = QK^T    O = PV     out beyond (worst / limit)   lse beyond
//   1 term      1 term     232,042 (126)                2,047
//   3 terms     1 term     204,582                      0
//   1 term      3 terms    214,042                      2,047
//   2 terms     3 terms    175,173                      2,045
//   3 terms     2 terms    168,320                      0
//   3 terms     3 terms    0 (0.072)                    0 (0.083)
// (2 terms: a_hi b_hi + a_lo b_hi.)  So both products take all three.
// hi is written explicitly (in place, over what TMA brought), so the
// result does not rest on how the tensor cores read the low bits of a raw
// fp32 value.  l is summed from the fp32 p.
//
// Why O is summed afresh each tile.  The tensor cores add a wgmma's
// products to its accumulator with less care than an fp32 add: O summed
// in place over every tile's 12 PV wgmmas (3 terms x 4 k8 slices) drifts
// low as the sum grows, and phase 7 of chip_smoke.py (a full-width fp32
// training step through the kernels against the plain versions) then read
// a largest relative gradient difference of 2.2e-5 against its 1e-5
// limit.  Each tile's PV is summed in a fresh accumulator, which holds only
// that tile's part, and added to O in fp32 registers; at Dv=128 in two
// halves of 64 columns, to keep within 255 registers, and at Dv=96 in two
// of 48 (m64n48k8, the form the dk/dv pass's halves take at 96: one tf32
// RS form more, not two, and fewer registers than Dv=128 takes).
//
// Design, constraint by constraint:
// - Tensor cores: a warpgroup (128 threads) owns 64 query rows of one
//   q-head, one or two such warpgroups a block (block_q, below).  S = Q K^T is m64n32k8 tf32 wgmmas, A (Q) and B (K) read
//   from shared memory, K-major: the cross terms Q_hi K_lo and Q_lo K_hi
//   first, then Q_hi K_hi, into one fp32 accumulator.  O += P V is m64nNk8
//   tf32 wgmmas in the RS form (N = Dv / NH: NH = 2 parts at Dv > 64,
//   else 1): A is P from
//   registers, B is V^T from shared memory; P_hi V^T_lo, P_lo V^T_hi, then
//   P_hi V^T_hi into a fresh accumulator, added to O.  QK^T reduces over
//   D, PV over the keys; V, V^T and O are Dv wide.
// - No transpose-B in tf32: the transpose immediate that the bf16 kernel
//   uses to read V is for 16-bit types only, and V's reduction axis (keys)
//   is not contiguous.  After each V tile lands, the warps write V^T hi and
//   lo (keys contiguous, 128-byte swizzle) into buffers that K-major
//   descriptors read; K's hi is written in place and K_lo beside it in the
//   same pass, and Q's once per block.
// - P from registers, through a key permutation.  The S accumulator holds
//   keys 8i + 2t and 8i + 2t + 1 (t = lane % 4) of 8-key group i in a
//   thread; a tf32 A fragment wants k = t and t + 4.  Rather than shuffling
//   registers, V^T's 8-key groups are written permuted the same way: k
//   slot t holds key 2t and slot t + 4 key 2t + 1, so the reduction pairs
//   each p with its own v (a product's reduction order is free).
// - Memory: q, k and v are 4-D tensor maps (D, heads, S, B) of fp32, made
//   on the host for every call and passed as __grid_constant__ parameters.
//   Thread 0 brings the Q tiles in once and K/V tiles of BK keys into a ring
//   of 2 stages, each signalled by an mbarrier carrying the transaction
//   bytes; tile j+1 is in flight while tile j is split and multiplied.  TMA
//   zero-fills rows past Sq or Skv; a key >= Skv still gets score -inf in
//   registers.  The warps' writes are made visible to the tensor cores and
//   to the next TMA write by fence.proxy.async and a barrier.
// - Shared memory at D=128 and the untuned tiles: Q (hi in place) and Q_lo
//   64 KB; two stages of
//   K (hi in place) and V 64 KB; K_lo, V^T_hi and V^T_lo 48 KB; 176 KB, so
//   one block an SM.  Two warpgroups on two q-heads of a kv-head, as the
//   bf16 kernel has, would need another 64 KB of Q and do not fit.  fp32
//   rows of 32 columns are one 128-byte swizzle atom (sm90.cuh's Geo<D, 4>);
//   D=128 is four atoms, D=96 three, each on a 1024-byte boundary (every
//   tile at D=96 is a multiple of 1024 bytes: 24,576 at 64 rows, 12,288 at
//   32); V^T is Dv rows of one atom.  At (96, 96) 132 KB, at (96, 64)
//   116 KB (the library's _smem entry gives each).  The split writes hi and lo at the offsets it read x from, so it
//   never decodes the swizzle; only the V^T writes do.
// - Softmax in the accumulator's layout, as in the bf16 kernel: row max and
//   sum over the 4 threads of a quad; scores pre-scaled by D^-0.5 log2(e),
//   p = exp2(s - m); lse = m ln2 + log(l).
// - Registers: S (16), O (Dv/2), the tile's part of O (Dv/2 / NH), P_hi
//   and P_lo (32) a thread (phase 1 of chip_smoke.py prints
//   ptxas -v, spills included).
// - Grid: (H, B, query tiles of block_q rows), the query tile on z and
//   reversed: blocks are dispatched x fastest, so the longest causal tiles
//   go first.
// - Tiles as launch parameters (the tuning cache's fp32 `flash_fwd`
//   entries, repro_torch/tune/space.py): block_q, the query rows of a
//   block, is 64 or 128 (RW = 1 or 2 warpgroups, each its own 64 rows and
//   its own Q hi and lo, sharing every K/V stage, K lo and V^T; the first
//   skips the tiles wholly above its rows, which would add exactly 0);
//   block_k, the keys of a tile, is 16, 32 or 64 (V^T in Geo<BK, 4>: rows
//   of 64 bytes with the 64-byte swizzle at 16, of 128 at 32, two 128-byte
//   atoms at 64; sm90.cuh's tposed_off), with the same 8-key permutation.
//   A 128-row block of 16-key tiles takes 189,440 bytes at D=128: eight
//   warps an SM where the untuned tiles have four.  The untuned 64 x 32 is
//   the kernel's first design and always built; any other instantiation
//   only where its shared memory fits a block and a thread's registers fit
//   (`admits`, the space's rule, set from ptxas's report so that none
//   spills).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;
using repro::NEG_INF;

constexpr int BQ = 64;     // query rows of a warpgroup
constexpr int STAGES = 2;  // K/V ring
// the untuned tiles: one 64-row warpgroup a block, 32-key tiles
constexpr int DEFAULT_BLOCK_Q = 64, DEFAULT_BLOCK_K = 32;
// a thread's registers beyond the O accumulator and a tile's S and P
// (repro_torch/tune/space.py's FP32_FWD_REG_BASE)
constexpr int REG_BASE = 80;

// Byte offsets of the <D, DV, RW, BK> instantiation's buffers from a
// 1024-byte boundary: RW row warpgroups' Q (hi in place) and Q_lo, the K/V
// ring, K_lo, V^T hi and lo.  V^T is DV rows of BK keys (Geo<BK, 4>): as
// many bytes as a V tile.
template <int D, int DV, int RW, int BK>
struct Smem {
  using G = Geo<D, 4>;
  using GV = Geo<DV, 4>;
  static constexpr int STAGE = G::tile_bytes(BK) + GV::tile_bytes(BK);  // K, then V
  static constexpr int Q = 0;                        // warpgroup w's at Q + w Q_STRIDE
  static constexpr int Q_STRIDE = 2 * G::tile_bytes(BQ);  // hi in place, then lo
  static constexpr int KV = RW * Q_STRIDE;                // the ring's stages
  static constexpr int K_LO = KV + STAGES * STAGE;
  static constexpr int VT_HI = K_LO + G::tile_bytes(BK);
  static constexpr int VT_LO = VT_HI + GV::tile_bytes(BK);
  static constexpr int BYTES = VT_LO + GV::tile_bytes(BK);
  __host__ __device__ static constexpr int k_tile(int s) { return KV + s * STAGE; }
  __host__ __device__ static constexpr int q_hi(int w) { return Q + w * Q_STRIDE; }
  __host__ __device__ static constexpr int q_lo(int w) { return q_hi(w) + G::tile_bytes(BQ); }
};

// Dynamic shared memory a block of the <D, DV, RW, BK> instantiation takes:
// the buffers, and room to align them to 1024 bytes.
template <int D, int DV, int RW, int BK>
constexpr int smem_bytes() {
  return Smem<D, DV, RW, BK>::BYTES + 1024;
}

// Whether the <D, DV, RW, BK> instantiation is built: the default tiles
// always; the others where the block's shared memory fits 227 KB and a
// thread's registers (REG_BASE + DV/2 + DV/2 / NH + 3 BK/2: O, the tile's
// part of O, S and P's two terms) fit the 255 that one block an SM leaves.
template <int D, int DV, int RW, int BK>
constexpr bool admits() {
  if (RW * BQ == DEFAULT_BLOCK_Q && BK == DEFAULT_BLOCK_K) return true;
  const int nh = DV > 64 ? 2 : 1;
  return smem_bytes<D, DV, RW, BK>() <= 232448 &&
         REG_BASE + DV / 2 + DV / 2 / nh + 3 * BK / 2 <= 255;
}

// Tile j of K and V into ring stage j % STAGES, completing on that stage's
// barrier (fbar + 8 s).
template <int D, int DV, int RW, int BK>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t base, uint32_t fbar, int kh, int b, int j) {
  const int s = j % STAGES;
  const uint32_t k_dst = base + Smem<D, DV, RW, BK>::k_tile(s);
  tma_load_pair<D, DV, 4>(tk, tv, k_dst, k_dst + Geo<D, 4>::tile_bytes(BK), kh, j * BK, b, BK,
                          fbar + 8 * s);
}

// V's tile (BK keys x DV, column atoms of BK rows x 128 bytes, as TMA wrote
// it) as V^T hi and lo: DV rows of BK keys in Geo<BK, 4>'s layout
// (sm90.cuh's tposed_off), key 8g + 2i + e at k slot 8g + 4e + i.  A warp
// takes 32 columns d (a lane each) of 4 keys of one parity a step, the NW
// warps of the block in turn: its reads cover a row of V, its 16-byte
// writes 32 rows of V^T, conflict-free both.
template <int DV, int BK, int NW>
__device__ __forceinline__ void transpose_v(const uint8_t* v, uint8_t* vt_hi, uint8_t* vt_lo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int u = warp; u < DV * BK / 128; u += NW) {
    const int atom = u / (BK / 4), g = u % (BK / 4) / 2, e = u % 2;
    const uint8_t* src = v + atom * Geo<DV, 4>::atom_bytes(BK) + (lane % 4) * 4;
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 8 * g + 2 * i + e;
      x[i] = *reinterpret_cast<const float*>(src + key * 128 + ((lane / 4) ^ (key % 8)) * 16);
    }
    const int d = 32 * atom + lane;
    const int off = tposed_off<BK>(d, 2 * g + e, DV);
    float4 hi, lo;
    split_tf32(make_float4(x[0], x[1], x[2], x[3]), hi, lo);
    *reinterpret_cast<float4*>(vt_hi + off) = hi;
    *reinterpret_cast<float4*>(vt_lo + off) = lo;
  }
}

// RW row warpgroups a block over one q-head, warpgroup w its rows w 64.. of
// the block's RW x 64; they share every K/V tile of BK keys.  Grid (H, B,
// query tiles of RW x 64 rows).
template <int D, int DV, int RW, int BK>
__global__ void __launch_bounds__(RW * WG, 1)
flash_fwd_sm90_fp32_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, float* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Skv, int H, int K,
                           float scale_log2, int causal) {
  using G = Geo<D, 4>;
  using GT = Geo<BK, 4>;  // V^T's geometry
  using L = Smem<D, DV, RW, BK>;
  constexpr int KSTEPS = D / 8;   // k8 slices of QK^T
  constexpr int PSTEPS = BK / 8;  // k8 slices of PV
  constexpr int OREG = DV / 2;    // O accumulator registers per thread
  constexpr int NH = DV > 64 ? 2 : 1;  // parts of O a tile's PV is summed in: n64, n48
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));  // the same, generic
  const uint32_t qbar = smem_u32(&bars[0]);
  const uint32_t fbar = smem_u32(&bars[1]);  // stage s: fbar + 8 s

  const int tid = threadIdx.x;
  // one row warpgroup: warpgroup 0 as a constant, so that the untuned
  // instantiation keeps the registers of the kernel's first design
  const int wg = RW > 1 ? tid / WG : 0, warp = tid / 32 % 4, lane = tid % 32;
  // blocks are dispatched x fastest, z slowest: the longest causal q tiles
  // (the last) go first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * (RW * BQ);
  const int qw = q0 + wg * BQ;  // this warpgroup's first row
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h * K / H;
  // causal: keys past the block's last row are masked for every row
  const int kv_end = causal ? min(Skv, q0 + RW * BQ) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(fbar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, RW * G::tile_bytes(BQ));
#pragma unroll
    for (int w = 0; w < RW; ++w)
#pragma unroll
      for (int c = 0; c < G::NATOM; ++c)
        tma_load(base + L::q_hi(w) + c * G::atom_bytes(BQ), &tq, c * G::ATOM, h, q0 + w * BQ,
                 b, qbar);
    load_kv<D, DV, RW, BK>(&tk, &tv, base, fbar, kh, b, 0);
  }

  // this thread's two rows and its first column in every 8-column chunk
  const int r0 = qw + 16 * warp + lane / 4, r1 = r0 + 8;
  const int c0 = 2 * (lane % 4);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[OREG];
#pragma unroll
  for (int i = 0; i < OREG; ++i) o[i] = 0.f;

  mbar_wait(qbar, 0);
#pragma unroll
  for (int w = 0; w < RW; ++w)
    split_tile_tf32(gbase + L::q_hi(w), gbase + L::q_lo(w), G::tile_bytes(BQ));
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int k0 = j * BK;
    // every thread is past tile j-1's products and has fenced its writes:
    // stage (j+1) % STAGES and the split buffers may be refilled
    __syncthreads();
    if (tid == 0 && j + 1 < n_tiles) load_kv<D, DV, RW, BK>(&tk, &tv, base, fbar, kh, b, j + 1);
    mbar_wait(fbar + 8 * s, (j / STAGES) & 1);
    const int k_tile = L::k_tile(s), v_tile = k_tile + G::tile_bytes(BK);
    split_tile_tf32(gbase + k_tile, gbase + L::K_LO, G::tile_bytes(BK));
    transpose_v<DV, BK, 4 * RW>(gbase + v_tile, gbase + L::VT_HI, gbase + L::VT_LO);
    fence_proxy_async();
    __syncthreads();
    // a tile wholly above this warpgroup's rows (only below the block's last
    // warpgroup, which needs every tile) would add exactly 0
    if (RW > 1 && causal && k0 > qw + BQ - 1) continue;

    // S = Q_hi K_lo^T + Q_lo K_hi^T + Q_hi K_hi^T: K-major A and B, k8
    // slices walk the row inside an atom, then the next atom
    const uint32_t q_hi = base + L::q_hi(wg), q_lo = base + L::q_lo(wg);
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;  // overwritten: the first slice has scale_d 0
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss_tf32(sc, desc_k_tf32<D>(q_hi, BQ, kk), desc_k_tf32<D>(base + L::K_LO, BK, kk),
                    kk > 0);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss_tf32(sc, desc_k_tf32<D>(q_lo, BQ, kk), desc_k_tf32<D>(base + k_tile, BK, kk), 1);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss_tf32(sc, desc_k_tf32<D>(q_hi, BQ, kk), desc_k_tf32<D>(base + k_tile, BK, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

    // online softmax in the accumulator's layout: sc[4i + e] is row (e < 2 ?
    // r0 : r1), column 8i + c0 + (e & 1)
    const bool mask = k0 + BK > Skv || (causal && k0 + BK - 1 > qw);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (mask) {
        const int kp = k0 + 8 * (i / 4) + c0 + (i & 1);
        const int qp = (i & 2) ? r1 : r0;
        if (kp >= Skv || (causal && kp > qp)) x = NEG_INF;
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key 0 is visible to every row, so m is finite from the first tile
      // on and a masked score gives exp2(NEG_INF - m) = 0
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = exp2f(sc[i] - m[(i >> 1) & 1]);
      sc[i] = p;
      ps[(i >> 1) & 1] += p;
    }
    l[0] = l[0] * corr[0] + ps[0];
    l[1] = l[1] * corr[1] + ps[1];
#pragma unroll
    for (int i = 0; i < OREG; ++i) o[i] *= corr[(i >> 1) & 1];

    // P as two tf32 terms in the A-fragment layout of the RS wgmma: slice
    // kk's registers (row r0 slot t, r1 slot t, r0 slot t+4, r1 slot t+4)
    // are keys 2t, 2t, 2t+1, 2t+1 of group kk: sc[4kk + 0, 2, 1, 3]
    uint32_t p_hi[PSTEPS][4], p_lo[PSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk) {
      split_tf32(sc[4 * kk + 0], p_hi[kk][0], p_lo[kk][0]);
      split_tf32(sc[4 * kk + 2], p_hi[kk][1], p_lo[kk][1]);
      split_tf32(sc[4 * kk + 1], p_hi[kk][2], p_lo[kk][2]);
      split_tf32(sc[4 * kk + 3], p_hi[kk][3], p_lo[kk][3]);
    }

    // O += P_hi V^T_lo + P_lo V^T_hi + P_hi V^T_hi, the tile's product in a
    // fresh accumulator added to O in fp32, for NH parts of DV columns (V^T
    // rows of GT::SW bytes in an atom, 8 of them a swizzle period, so a part
    // of 48 starts on a period too); the k8 slice kk is 32 bytes into its
    // atom
#pragma unroll
    for (int part = 0; part < NH; ++part) {
      float ot[OREG / NH];
#pragma unroll
      for (int i = 0; i < OREG / NH; ++i) ot[i] = 0.f;
      const uint32_t vt_lo = base + L::VT_LO + part * (DV / NH) * GT::SW;
      const uint32_t vt_hi = base + L::VT_HI + part * (DV / NH) * GT::SW;
      pin(ot);
      pin(p_hi);
      pin(p_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PSTEPS; ++kk)
        wgmma_rs_tf32(ot, p_hi[kk], desc_k_tf32<BK>(vt_lo, DV, kk));
#pragma unroll
      for (int kk = 0; kk < PSTEPS; ++kk)
        wgmma_rs_tf32(ot, p_lo[kk], desc_k_tf32<BK>(vt_hi, DV, kk));
#pragma unroll
      for (int kk = 0; kk < PSTEPS; ++kk)
        wgmma_rs_tf32(ot, p_hi[kk], desc_k_tf32<BK>(vt_hi, DV, kk));
      wgmma_commit();
      wgmma_wait_all();
      pin(ot);
      pin(p_hi);
      pin(p_lo);
#pragma unroll
      for (int i = 0; i < OREG / NH; ++i) o[part * (OREG / NH) + i] += ot[i];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-37f);
  }
#pragma unroll
  for (int i = 0; i < OREG; ++i) o[i] /= l[(i >> 1) & 1];
  store_rows_f32<DV>(out, o, qw, Sq, H, h, b);
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = r ? r1 : r0;
      if (qp < Sq) lse[(static_cast<size_t>(b) * H + h) * Sq + qp] = m[r] * LN2 + logf(l[r]);
    }
  }
}

struct Call {
  const void *q, *k, *v;
  void *out, *lse;
  int B, Sq, Skv, H, K, causal;
  cudaStream_t stream;
};

template <int D, int DV, int RW, int BK>
cudaError_t launch_tiles(const Call& c) {
  if constexpr (!admits<D, DV, RW, BK>()) {
    return cudaErrorInvalidValue;  // not built: its shared memory or registers would not fit
  } else {
    CUtensorMap maps[3];
    if (!(make_map<D, 4>(&maps[0], c.q, c.B, c.Sq, c.H, BQ) &&
          make_map<D, 4>(&maps[1], c.k, c.B, c.Skv, c.K, BK) &&
          make_map<DV, 4>(&maps[2], c.v, c.B, c.Skv, c.K, BK)))
      return cudaErrorInvalidValue;
    constexpr int smem = smem_bytes<D, DV, RW, BK>();
    static bool configured = false;  // once per instantiation (a repeat is harmless)
    if (!configured) {
      const cudaError_t err =
          cudaFuncSetAttribute(flash_fwd_sm90_fp32_kernel<D, DV, RW, BK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      configured = true;
    }
    const dim3 grid(c.H, c.B, (c.Sq + RW * BQ - 1) / (RW * BQ));
    flash_fwd_sm90_fp32_kernel<D, DV, RW, BK><<<grid, RW * WG, smem, c.stream>>>(
        maps[0], maps[1], maps[2], static_cast<float*>(c.out), static_cast<float*>(c.lse),
        c.Sq, c.Skv, c.H, c.K, LOG2E / sqrtf(static_cast<float>(D)), c.causal);
    return cudaGetLastError();
  }
}

// The instantiation of block_q x block_k.
template <int D, int DV>
cudaError_t launch(const Call& c, int block_q, int block_k) {
  if (block_q == 64 && block_k == 16) return launch_tiles<D, DV, 1, 16>(c);
  if (block_q == 64 && block_k == 32) return launch_tiles<D, DV, 1, 32>(c);
  if (block_q == 64 && block_k == 64) return launch_tiles<D, DV, 1, 64>(c);
  if (block_q == 128 && block_k == 16) return launch_tiles<D, DV, 2, 16>(c);
  if (block_q == 128 && block_k == 32) return launch_tiles<D, DV, 2, 32>(c);
  if (block_q == 128 && block_k == 64) return launch_tiles<D, DV, 2, 64>(c);
  return cudaErrorInvalidValue;
}

template <int D, int DV, int RW, int BK>
int smem_tiles() {
  return admits<D, DV, RW, BK>() ? smem_bytes<D, DV, RW, BK>() : -1;
}

template <int D, int DV>
int smem_dv(int block_q, int block_k) {
  if (block_q == 64 && block_k == 16) return smem_tiles<D, DV, 1, 16>();
  if (block_q == 64 && block_k == 32) return smem_tiles<D, DV, 1, 32>();
  if (block_q == 64 && block_k == 64) return smem_tiles<D, DV, 1, 64>();
  if (block_q == 128 && block_k == 16) return smem_tiles<D, DV, 2, 16>();
  if (block_q == 128 && block_k == 32) return smem_tiles<D, DV, 2, 32>();
  if (block_q == 128 && block_k == 64) return smem_tiles<D, DV, 2, 64>();
  return -1;
}

}  // namespace

// q (B,Sq,H,D), k (B,Skv,K,D), v (B,Skv,K,Dv) contiguous fp32 with 16-byte
// aligned pointers; out (B,Sq,H,Dv) fp32, lse (B,H,Sq) fp32; block_q (64 or
// 128: query rows in a block) and block_k (16, 32 or 64: keys a tile).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue when a
// tensor map cannot be made, (D, Dv) is neither D == Dv in {32, 64, 96,
// 128} nor (96, 64), or the tiles' instantiation is not built).
extern "C" int repro_flash_attention_fwd_sm90_fp32(const void* q, const void* k,
                                                   const void* v, void* out, void* lse, int B,
                                                   int Sq, int Skv, int H, int K, int D,
                                                   int Dv, int causal, int block_q, int block_k,
                                                   void* stream) {
  const Call c{q, k, v, out, lse, B, Sq, Skv, H, K, causal, static_cast<cudaStream_t>(stream)};
  if (D == 96 && Dv == 64) return launch<96, 64>(c, block_q, block_k);
  if (Dv != D) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<32, 32>(c, block_q, block_k);
    case 64: return launch<64, 64>(c, block_q, block_k);
    case 96: return launch<96, 96>(c, block_q, block_k);
    case 128: return launch<128, 128>(c, block_q, block_k);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block of the (D, Dv) instantiation of block_q x
// block_k takes, in bytes; -1 where that instantiation is not built.
extern "C" int repro_flash_attention_fwd_sm90_fp32_smem(int D, int Dv, int block_q,
                                                        int block_k) {
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
