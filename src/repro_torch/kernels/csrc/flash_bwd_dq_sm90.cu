// Flash-attention backward, dq pass, for Hopper (sm_90a), bfloat16: every
// product on the tensor cores (wgmma), every tile brought in by TMA.
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` (the `pl.pallas_call` at
// l.280 of src/repro/kernels/flash_attention/flash_attention.py, reached
// through `flash_attention_bwd`) for bf16 inputs; fp32 inputs go to
// flash_bwd_dq_sm90_fp32.cu.  Same function: for each query row, p =
// exp(s - lse) from the forward's lse (s = q.k D^-0.5, top-left causal mask
// k_pos <= q_pos), dp = dO.V^T, ds = p (dp - Dvec) D^-0.5 and dq = ds.K,
// summed in fp32, written in bf16, with q-head h reading kv-head h*K/H.
// Dvec = rowsum(dO * O), a `jnp` expression before the reference's launch
// (l.274), is this kernel's prologue: each block computes it for its own
// rows and writes it out for the dk/dv pass (flash_bwd_dkv_sm90.cu), which
// runs after this one on the same stream.  Inputs: q (B,Sq,H,D), out, dO
// (B,Sq,H,DV), k (B,Skv,K,D), v (B,Skv,K,DV), contiguous bf16 on 16-byte
// boundaries; lse (B,H,Sq) fp32; D == DV in {32, 64, 96, 128} or (D, DV) =
// (96, 64) (MLA: 64 nope + 32 rope dims of q and k, 64 of v), any Sq and
// Skv.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 dense): at the
// training shape (B=4, H=16, K=8, D=128, S=512, causal) the function's
// 4 D + 2 DV flops for each of the 8.4 M visible (q, k) pairs are 6.45
// GFLOP (6.5 us), and it moves 42.2 MB (q, k, v, O, dO, lse read once; dq,
// Dvec written once): 12.6 us.  Bytes bound it, and so they do MLA's (B=4,
// S=512, H=K=40, D=96, DV=64) and phi-3's (H=K=32, D=DV=96) shapes;
// whisper's encoder (B=4, 1500 x 1500 non-causal, H=K=6, D=DV=64) does
// 20.7 GFLOP on 27.9 MB: compute-bound.
//
// Why dS is split.  The reference computes ds in fp32 and keeps it so for
// dq = ds K.  A CPU model of this arithmetic (tests/
// test_torch_flash_bwd_sm90.py; B=1, S=512, H=4, K=2, D=128, causal, bf16
// inputs), held to the plain version's element check |err| <= 1e-4 +
// 2^-7 |ref|: dS rounded once to bf16 puts 14,435 of 262,144 dq elements
// beyond it (the worst at 11.4x the limit); dS split into hi = bf16(ds) and
// lo = bf16(ds - hi), two products into one fp32 accumulator, none (worst
// 0.85).  The split raises the tensor-core work from 4 D + 2 DV to 6 D +
// 2 DV flops a visible pair: 8.6 GFLOP, 8.7 us at the peak rate.
//
// Design, constraint by constraint (the forward's, flash_attention_sm90.cu):
// - Tensor cores: a consumer warpgroup (128 threads) owns 64 query rows of
//   one q-head.  S = Q K^T (D/16 k16 slices) and dP = dO V^T (DV/16) are
//   m64n64k16 wgmmas with A (the Q or dO tile) and B (the K or V tile) from
//   shared memory, K-major.  The dP accumulator, turned into dS in place
//   and taken pairwise as bf16, is the A fragment of the RS wgmma dQ += dS K
//   (m64nDk16: n96 at D=96, its B operand spanning K's three column atoms),
//   issued twice (hi, then lo) into one fp32 accumulator; K is read again
//   from the same tile, MN-major through the transpose-B immediate.
// - Memory: q, k, v and dO are 4-D tensor maps (D or DV, heads, S, B) made
//   on the host for every call (sm90.cuh's make_map).  Thread 0 brings the
//   Q and dO tiles in once and the K/V tiles into a ring of 2 stages, each
//   signalled by an mbarrier carrying the transaction bytes; tile j+1 is in
//   flight while tile j's products run.  Q and K take D's geometry, dO and
//   V take DV's (sm90.cuh's Geo: D=96 is three 64-byte-swizzle atoms), and
//   every tile starts on a 1024-byte boundary.  When H/K is even a block
//   holds two warpgroups for two q-heads of one kv-head, same rows: every
//   K/V tile is brought in once for both.  Dvec's prologue reads O and dO
//   rows (DV wide) with 16-byte loads, two threads a row; each thread then
//   holds lse (as a base-2 exponent) and Dvec of its two rows in registers.
// - Masking: TMA zero-fills rows past Sq and Skv, but a zero key scores 0,
//   not -inf, against a finite lse, so keys >= Skv, rows >= Sq and (when
//   causal) keys past the row get p = 0 and ds = 0 explicitly, on the tiles
//   that reach an edge.
// - Registers: dQ D/2 fp32 a thread, S and dP 32 each, the hi/lo fragments
//   32; blocks of two warpgroups take 128 KB of shared memory at D=128, so
//   one fits an SM and may use 255 registers a thread (phase 1 of
//   chip_smoke.py prints ptxas -v, spills included).
// - Grid: (q-head groups, batch, 64-row query tiles), the query tile on z
//   and reversed: blocks are dispatched x fastest, so the longest causal
//   tiles go first.  No atomics: each dq element is one thread's sum over
//   the key tiles in order, so two runs give bit-identical results.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 64;     // query rows of a warpgroup
constexpr int BK = 64;     // keys per tile
constexpr int STAGES = 2;  // K/V ring

// Tile j of K and V into ring stage j % STAGES (K at skv + s pair_bytes(BK),
// V after it), completing on that stage's barrier (fbar + 8 s).
template <int D, int DV>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t skv, uint32_t fbar, int kh, int b, int j) {
  const int s = j % STAGES;
  const uint32_t k_dst = skv + s * pair_bytes<D, DV>(BK);
  tma_load_pair<D, DV>(tk, tv, k_dst, k_dst + Geo<D>::tile_bytes(BK), kh, j * BK, b, BK,
                       fbar + 8 * s);
}

// NWG warpgroups a block, each with its own q-head of the same kv-head and
// the same 64 rows: they share every K/V tile.  Grid (H/NWG, B, q tiles).
template <int D, int DV, int NWG>
__global__ void __launch_bounds__(NWG * WG, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tg,
                         const __nv_bfloat16* __restrict__ out,
                         const __nv_bfloat16* __restrict__ g, const float* __restrict__ lse,
                         float* __restrict__ dvec, __nv_bfloat16* __restrict__ dq, int Sq,
                         int Skv, int H, int K, float scale_log2, float scale, int causal) {
  using G = Geo<D>;
  constexpr int KSTEPS = D / 16;   // k16 slices of Q K^T
  constexpr int VSTEPS = DV / 16;  // k16 slices of dO V^T
  constexpr int PSTEPS = BK / 16;  // k16 slices of dS K
  constexpr int OREG = D / 2;      // dQ accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];
  __shared__ float dvec_s[NWG][BQ];

  // warpgroup w: Q at sq0 + w pair_bytes(BQ), dO after it
  const uint32_t sq0 = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // stage s: K at skv + s pair_bytes(BK), V after it
  const uint32_t skv = sq0 + NWG * pair_bytes<D, DV>(BQ);
  const uint32_t qbar = smem_u32(&bars[0]);
  const uint32_t fbar = smem_u32(&bars[1]);  // stage s: fbar + 8 s

  const int tid = threadIdx.x;
  const int wg = tid / WG, warp = tid / 32 % 4, lane = tid % 32;
  // blocks are dispatched x fastest, z slowest: the longest causal q tiles
  // (the last) go first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h0 = blockIdx.x * NWG, h = h0 + wg, b = blockIdx.y;
  const int kh = h0 * K / H;  // the same for the block's NWG heads
  const uint32_t sq = sq0 + wg * pair_bytes<D, DV>(BQ), sg = sq + G::tile_bytes(BQ);
  // causal: keys past the tile's last row are masked for every row
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(qbar, NWG);  // one arrival for each warpgroup's (Q, dO) pair
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(fbar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < NWG; ++w) {
      const uint32_t dst = sq0 + w * pair_bytes<D, DV>(BQ);
      tma_load_pair<D, DV>(&tq, &tg, dst, dst + G::tile_bytes(BQ), h0 + w, q0, b, BQ, qbar);
    }
    load_kv<D, DV>(&tk, &tv, skv, fbar, kh, b, 0);
  }

  // prologue: Dvec = rowsum(dO * O) for the warpgroup's 64 rows, two
  // threads a row, each over half the DV columns in 16-byte loads
  {
    const int t = tid % WG, row = t / 2, half = t % 2, qp = q0 + row;
    float part = 0.f;
    if (qp < Sq) {
      const size_t off = ((static_cast<size_t>(b) * Sq + qp) * H + h) * DV + half * (DV / 2);
#pragma unroll
      for (int c = 0; c < DV / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(out + off + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(g + off + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), gf = __bfloat1622float2(g2[e]);
          part = fmaf(gf.x, of.x, part);
          part = fmaf(gf.y, of.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      dvec_s[wg][row] = part;
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
    dd[r] = dvec_s[wg][qp - q0];
  }
  float dq_acc[OREG];
#pragma unroll
  for (int i = 0; i < OREG; ++i) dq_acc[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int k0 = j * BK;
    // every warp of the block is past tile j-1's products: its stage may be
    // refilled
    __syncthreads();
    if (tid == 0 && j + 1 < n_tiles) load_kv<D, DV>(&tk, &tv, skv, fbar, kh, b, j + 1);
    mbar_wait(fbar + 8 * s, (j / STAGES) & 1);
    const uint32_t k_tile = skv + s * pair_bytes<D, DV>(BK), v_tile = k_tile + G::tile_bytes(BK);

    // S = Q K^T over D, dP = dO V^T over DV: K-major A and B
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
      wgmma_ss(sc, desc_k<D>(sq, BQ, kk), desc_k<D>(k_tile, BK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < VSTEPS; ++kk)
      wgmma_ss(dp, desc_k<DV>(sg, BQ, kk), desc_k<DV>(v_tile, BK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);
    pin(dp);

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
    // dS as two bf16 terms, in the A-fragment layout of the RS wgmma: slice
    // kk's four registers are dp[8kk .. 8kk+7] pairwise
    uint32_t ds_hi[PSTEPS][4], ds_lo[PSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1], ds_hi[kk][e], ds_lo[kk][e]);

    // dQ += dS K: K MN-major, hi then lo
    pin(dq_acc);
    pin(ds_hi);
    pin(ds_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk) wgmma_rs(dq_acc, ds_hi[kk], desc_mn<D>(k_tile, BK, kk));
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk) wgmma_rs(dq_acc, ds_lo[kk], desc_mn<D>(k_tile, BK, kk));
    wgmma_commit();
    wgmma_wait_all();
    pin(dq_acc);
    pin(ds_hi);
    pin(ds_lo);
  }

  store_rows<D>(dq, dq_acc, q0, Sq, H, h, b);
}

template <int D, int DV, int NWG>
cudaError_t launch_nwg(const CUtensorMap* maps, const void* out, const void* g,
                       const void* lse, void* dvec, void* dq, int B, int Sq, int Skv, int H,
                       int K, int causal, cudaStream_t stream) {
  // NWG (Q, dO) pairs, the K/V ring, and room to align them to 1024 bytes
  constexpr int smem = NWG * pair_bytes<D, DV>(BQ) + STAGES * pair_bytes<D, DV>(BK) + 1024;
  static bool configured = false;  // once per instantiation (a repeat is harmless)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_sm90_kernel<D, DV, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const float root = sqrtf(static_cast<float>(D));
  const dim3 grid(H / NWG, B, (Sq + BQ - 1) / BQ);
  flash_bwd_dq_sm90_kernel<D, DV, NWG><<<grid, NWG * WG, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(g), static_cast<const float*>(lse),
      static_cast<float*>(dvec), static_cast<__nv_bfloat16*>(dq), Sq, Skv, H, K,
      LOG2E / root, 1.0f / root, causal);
  return cudaGetLastError();
}

// Two q-heads a block when they share a kv-head (H/K even), else one.
template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* g, const void* lse, void* dvec, void* dq, int B, int Sq,
                   int Skv, int H, int K, int causal, cudaStream_t stream) {
  CUtensorMap maps[4];
  if (!(make_map<D>(&maps[0], q, B, Sq, H, BQ) && make_map<D>(&maps[1], k, B, Skv, K, BK) &&
        make_map<DV>(&maps[2], v, B, Skv, K, BK) && make_map<DV>(&maps[3], g, B, Sq, H, BQ)))
    return cudaErrorInvalidValue;
  if ((H / K) % 2 == 0)
    return launch_nwg<D, DV, 2>(maps, out, g, lse, dvec, dq, B, Sq, Skv, H, K, causal, stream);
  return launch_nwg<D, DV, 1>(maps, out, g, lse, dvec, dq, B, Sq, Skv, H, K, causal, stream);
}

}  // namespace

// q (B,Sq,H,D), out, g (B,Sq,H,Dv), k (B,Skv,K,D), v (B,Skv,K,Dv) contiguous
// bf16 with 16-byte aligned pointers, lse (B,H,Sq) fp32 from the forward;
// writes dq (B,Sq,H,D) bf16 and dvec (B,H,Sq) fp32.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue when a tensor map cannot
// be made or (D, Dv) is not one of (32, 32), (64, 64), (96, 96), (128, 128),
// (96, 64)).
extern "C" int repro_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                       const void* out, const void* g, const void* lse,
                                       void* dvec, void* dq, int B, int Sq, int Skv, int H,
                                       int K, int D, int Dv, int causal, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 96 && Dv == 64)
    return launch<96, 64>(q, k, v, out, g, lse, dvec, dq, B, Sq, Skv, H, K, causal, st);
  if (D != Dv) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<32, 32>(q, k, v, out, g, lse, dvec, dq, B, Sq, Skv, H, K, causal, st);
    case 64: return launch<64, 64>(q, k, v, out, g, lse, dvec, dq, B, Sq, Skv, H, K, causal, st);
    case 96: return launch<96, 96>(q, k, v, out, g, lse, dvec, dq, B, Sq, Skv, H, K, causal, st);
    case 128:
      return launch<128, 128>(q, k, v, out, g, lse, dvec, dq, B, Sq, Skv, H, K, causal, st);
    default: return cudaErrorInvalidValue;
  }
}
