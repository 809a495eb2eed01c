// Flash-attention forward for Hopper (sm_90a), bfloat16: both products on
// the tensor cores (wgmma), K and V tiles brought in by TMA.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` reached through
// `flash_attention_fwd` (the `pl.pallas_call` at l.127) in
// src/repro/kernels/flash_attention/flash_attention.py, for bf16 inputs; the
// fp32 inputs go to flash_attention_sm90_fp32.cu.  Same function: causal or
// non-causal GQA attention with an online softmax in fp32, q-head h reading
// kv-head h*K/H (no head expansion), scale D^-0.5, the top-left causal mask
// k_pos <= q_pos (both from 0, so Sq != Skv keeps the reference's meaning),
// kv tiles wholly above the diagonal skipped, l clamped at 1e-37, outputs
// out (B,Sq,H,DV) in bf16 and lse = m + log(l) (B,H,Sq) in fp32, natural log.
// Inputs: q (B,Sq,H,D), k (B,Skv,K,D), v (B,Skv,K,DV), contiguous bf16,
// D == DV in {32, 64, 96, 128} or (D, DV) = (96, 64) (MLA's prefill: 64 nope
// + 32 rope dims of q and k, 64 of v), any Sq and Skv.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 dense): at the serve
// shape (B=4, H=16, K=8, D=128, Sq=Skv=512, causal) the function moves
// 25.3 MB (q, k, v read once, out and lse written once): 7.55 us; its 4.30
// GFLOP of products (4*D a visible pair) take 4.3 us.  Bytes bound it.
// So do MLA's prefill (B=4, S=512, H=K=40, D=96, DV=64: 52.8 MB, 15.7 us)
// and phi-3's (H=K=32, D=DV=96); whisper's encoder (B=4, 1500 x 1500
// non-causal, H=K=6, D=64) does 20.7 GFLOP on 18.6 MB: 21 us of tensor-core
// time against 5.5 us of bytes, compute-bound.
//
// Why P is split.  The reference keeps p in fp32 for the PV product (q, k, v
// are cast to fp32 and p.astype(v.dtype) stays fp32).  Against the plain
// version's element check |err| <= 2e-5 + 2^-7 |ref|, a CPU model of this
// kernel's arithmetic (tests/test_torch_flash_sm90.py, at B=1, S=512, H=4,
// K=2, D=128, causal, bf16 inputs) shows: QK^T from bf16 operands with fp32
// sums loses nothing (products of bf16 values are exact in fp32); p rounded
// once to bf16 puts 24,639 of 262,144 outputs beyond the check, the worst at
// 51x the limit; p split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), two
// PV products into one fp32 accumulator, puts none beyond it (worst 0.975
// of the limit: the one-ulp flip of a bf16 output that an fp32 kernel shows
// too).  The split costs 6*D flops a visible pair instead of 4*D: 6.45
// GFLOP at the serve shape, 6.5 us on the tensor cores, still under the
// byte bound.
// l is summed from the fp32 p, not from p_hi + p_lo.
//
// Design, constraint by constraint:
// - Tensor cores: a consumer warpgroup (128 threads) owns 64 query rows of
//   one q-head.
//   S = Q K^T is m64n64k16 wgmmas with A (the Q tile) and B (the K tile)
//   both read from shared memory, fp32 accumulators in registers.  O += P V
//   is m64nDVk16 wgmmas in the RS form: A is P from registers, issued twice
//   (p_hi, then p_lo) into the same fp32 O; B is the V tile, whose
//   reduction axis (keys) is not contiguous in memory, so it is read
//   MN-major through the transpose-B immediate.  The S accumulator's
//   layout, converted pairwise to bf16, is the A-fragment layout of the RS
//   wgmma, so P never leaves registers.
// - Memory: q, k and v are 4-D tensor maps (D, heads, S, B), made on the
//   host for every call (the pointers change; phase 2 of chip_smoke.py
//   times that cost) and passed as __grid_constant__ parameters.  Thread 0
//   brings the Q tiles in once and K/V tiles into a ring of 2 stages, each
//   signalled by an mbarrier carrying the transaction bytes; tile j+1 is in
//   flight while tile j's products run.  When H/K is even, a block holds
//   two warpgroups for two q-heads of one kv-head, same rows: every K/V
//   tile is brought in once for both, halving the block's traffic from L2
//   to shared memory.  TMA zero-fills rows past Sq or
//   Skv; a key >= Skv still gets score -inf in registers, since a zero key
//   would score 0, not be masked.
// - Shared-memory layout (sm90.cuh's Geo, desc_k, desc_mn, shared with the
//   backward's kernels): what TMA writes is what the wgmma descriptors
//   read.  A bf16 row of D=128 is 256 bytes, split into two 64-column atoms
//   with the 128-byte swizzle; D=64 is one such atom; D=32 (64-byte rows)
//   uses the 64-byte swizzle, and so does D=96: a 192-byte row is three
//   32-column atoms, QK^T six k16 slices two to an atom, and PV at DV=96 an
//   n96 wgmma whose B operand spans the three atoms.  Q and K take D's
//   geometry, V and O take DV's.  Every atom starts on a 1024-byte boundary.
// - Softmax in the accumulator's layout: each thread holds two rows of its
//   warp's 16 (lane/4 and lane/4 + 8); row max and row sum reduce over the
//   4 threads of a quad with shuffles; O is rescaled by corr every tile.
//   Scores are pre-scaled by D^-0.5 log2(e) so p = exp2(s - m); lse is
//   returned as m ln2 + log(l).
// - Registers: S (BK/2), O (DV/2) and the bf16 halves of P (BK/2) per
//   thread.  Two-warpgroup blocks of the default tiles are held to 128
//   registers so that two blocks share an SM (phase 1 of chip_smoke.py
//   prints ptxas -v, spills included).
// - Grid: (q-head groups, batch, query tiles), the query tile on z and
//   reversed: blocks are dispatched x fastest, so the longest causal tiles
//   go first.  The causal work is triangular, and the serve shape has 256
//   blocks of 2 warpgroups for 132 SMs.
// - Tiles as launch parameters (the tuning cache's `flash_fwd` entries,
//   repro_torch/tune/space.py): block_q, the query rows of a q-head in a
//   block, is 64 or 128 (RW = 1 or 2 warpgroups, each its own 64 rows);
//   block_k, the keys of a K/V tile, is 64 or 128.  A block of RW row
//   warpgroups walks the key tiles up to the furthest its last warpgroup
//   needs under the causal mask; a warpgroup skips the tiles wholly above
//   its own rows (a skipped tile would add exactly 0).  The defaults,
//   64 x 64, are the kernel's first tiles and keep their launch bounds
//   (NWG * 128 threads, 2 blocks an SM); every other instantiation takes
//   (threads, 1) and is built only where a thread's registers fit
//   (`admits`, the same rule as the space's flash_instantiated), so that
//   none spills.

#include <cuda.h>
#include <cuda_bf16.h>
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
// the untuned tiles: one 64-row warpgroup a q-head, 64-key tiles
constexpr int DEFAULT_BLOCK_Q = 64, DEFAULT_BLOCK_K = 64;
// a thread's registers beyond the O accumulator and a 64-key tile's S and P
// (repro_torch/tune/space.py's FLASH_REG_BASE)
constexpr int REG_BASE = 100;

// Minimum blocks an SM of the <NWG, RW, BK> instantiation's launch bounds:
// today's tiles keep 2; the others 1.
template <int RW, int BK>
constexpr int min_blocks() {
  return RW == 1 && BK == DEFAULT_BLOCK_K ? 2 : 1;
}

// Whether the <DV, NWG, RW, BK> instantiation is built: the default tiles
// always; the others where a thread's registers (REG_BASE + DV/2 +
// (BK - 64)/2) fit in what the launch bounds leave it.
template <int DV, int NWG, int RW, int BK>
constexpr bool admits() {
  if (RW == 1 && BK == DEFAULT_BLOCK_K) return true;
  const int threads = NWG * RW * WG;
  const int cap = 65536 / (threads * min_blocks<RW, BK>());
  return REG_BASE + DV / 2 + (BK - 64) / 2 <= (cap < 255 ? cap : 255);
}

// Dynamic shared memory of the <D, DV, NWG, RW, BK> instantiation: a Q tile
// a warpgroup, the K/V ring, and room to align them to 1024 bytes.
template <int D, int DV, int NWG, int RW, int BK>
constexpr int smem_bytes() {
  return NWG * RW * Geo<D>::tile_bytes(BQ) + STAGES * pair_bytes<D, DV>(BK) + 1024;
}

// Tile j of K (D columns) and V (DV) into ring stage j % STAGES (K at
// skv + s pair_bytes(BK), V after it), completing on that stage's barrier
// (fbar + 8 s).
template <int D, int DV, int BK>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t skv, uint32_t fbar, int kh, int b, int j) {
  const int s = j % STAGES;
  const uint32_t k_dst = skv + s * pair_bytes<D, DV>(BK);
  tma_load_pair<D, DV>(tk, tv, k_dst, k_dst + Geo<D>::tile_bytes(BK), kh, j * BK, b, BK,
                       fbar + 8 * s);
}

// NWG x RW warpgroups a block: NWG q-heads of the same kv-head, each over RW
// x 64 rows, warpgroup w taking head w / RW and rows (w % RW) 64.. of the
// block's; they share every K/V tile of BK keys.  Grid (H/NWG, B, query
// tiles of RW x 64 rows).
template <int D, int DV, int NWG, int RW, int BK>
__global__ void __launch_bounds__(NWG * RW * WG, min_blocks<RW, BK>())
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq,
                      int Skv, int H, int K, float scale_log2, int causal) {
  using G = Geo<D>;
  constexpr int NQ = NWG * RW;     // Q tiles (warpgroups) of the block
  constexpr int KSTEPS = D / 16;   // k16 slices of QK^T
  constexpr int PSTEPS = BK / 16;  // k16 slices of PV
  constexpr int OREG = DV / 2;     // O accumulator registers per thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];

  const uint32_t sq0 = (smem_u32(smem_raw) + 1023u) & ~1023u;  // warpgroup w's Q tile
  // stage s: K at skv + s pair_bytes(BK), V after it
  const uint32_t skv = sq0 + NQ * G::tile_bytes(BQ);
  const uint32_t qbar = smem_u32(&bars[0]);
  const uint32_t fbar = smem_u32(&bars[1]);  // stage s: fbar + 8 s

  const int tid = threadIdx.x;
  const int wg = tid / WG, warp = tid / 32 % 4, lane = tid % 32;
  // blocks are dispatched x fastest, z slowest: the longest causal q tiles
  // (the last) go first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * (RW * BQ);
  const int qw = q0 + (wg % RW) * BQ;  // this warpgroup's first row
  const int h0 = blockIdx.x * NWG, h = h0 + wg / RW, b = blockIdx.y;
  const int kh = h0 * K / H;  // the same for the block's NWG heads
  const uint32_t sq = sq0 + wg * G::tile_bytes(BQ);
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
    mbar_expect_tx(qbar, NQ * G::tile_bytes(BQ));
#pragma unroll
    for (int w = 0; w < NQ; ++w)
#pragma unroll
      for (int c = 0; c < G::NATOM; ++c)
        tma_load(sq0 + w * G::tile_bytes(BQ) + c * G::atom_bytes(BQ), &tq, c * G::ATOM,
                 h0 + w / RW, q0 + (w % RW) * BQ, b, qbar);
    load_kv<D, DV, BK>(&tk, &tv, skv, fbar, kh, b, 0);
  }

  // this thread's two rows and its first column in every 8-column chunk
  const int r0 = qw + 16 * warp + lane / 4, r1 = r0 + 8;
  const int c0 = 2 * (lane % 4);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[OREG];
#pragma unroll
  for (int i = 0; i < OREG; ++i) o[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int k0 = j * BK;
    // every warp of the block is past tile j-1's products: its stage may be
    // refilled
    __syncthreads();
    if (tid == 0 && j + 1 < n_tiles) load_kv<D, DV, BK>(&tk, &tv, skv, fbar, kh, b, j + 1);
    // a tile wholly above this warpgroup's rows (only below the block's last
    // warpgroup, which waits on every tile) would add exactly 0
    if (RW > 1 && causal && k0 > qw + BQ - 1) continue;
    mbar_wait(fbar + 8 * s, (j / STAGES) & 1);
    const uint32_t k_tile = skv + s * pair_bytes<D, DV>(BK), v_tile = k_tile + G::tile_bytes(BK);

    // S = Q K^T: K-major A and B, k16 slices walk the row inside an atom
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;  // overwritten: the first slice has scale_d 0
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss(sc, desc_k<D>(sq, BQ, kk), desc_k<D>(k_tile, BK, kk), kk > 0);
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

    // P as two bf16 terms, in the A-fragment layout of the RS wgmma: slice
    // kk's four registers are sc[8kk .. 8kk+7] taken pairwise
    uint32_t p_hi[PSTEPS][4], p_lo[PSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], p_hi[kk][e], p_lo[kk][e]);

    // O += P V: V MN-major; a k16 slice is 16 key rows, 2 swizzle groups of
    // 8; the column atoms of DV=128 (two) and DV=96 (three) lie
    // atom_bytes(BK) bytes apart
    pin(o);
    pin(p_hi);
    pin(p_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk)
      wgmma_rs(o, p_hi[kk], desc_mn<DV>(v_tile, BK, kk));
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk)
      wgmma_rs(o, p_lo[kk], desc_mn<DV>(v_tile, BK, kk));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    pin(p_hi);
    pin(p_lo);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-37f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r ? r1 : r0;
    if (qp >= Sq) continue;
    __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * Sq + qp) * H + h) * DV + c0;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i) =
          pack_bf16(o[4 * i + 2 * r] / l[r], o[4 * i + 2 * r + 1] / l[r]);
    if (lane % 4 == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + qp] = m[r] * LN2 + logf(l[r]);
  }
}

template <int D, int DV, int BK>
bool make_maps(CUtensorMap* maps, const void* q, const void* k, const void* v, int B,
               int Sq, int Skv, int H, int K) {
  return make_map<D>(&maps[0], q, B, Sq, H, BQ) && make_map<D>(&maps[1], k, B, Skv, K, BK) &&
         make_map<DV>(&maps[2], v, B, Skv, K, BK);
}

struct Call {
  const void *q, *k, *v;
  void *out, *lse;
  int B, Sq, Skv, H, K, causal;
  cudaStream_t stream;
};

template <int D, int DV, int NWG, int RW, int BK>
cudaError_t launch_tiles(const Call& c) {
  if constexpr (!admits<DV, NWG, RW, BK>()) {
    return cudaErrorInvalidValue;  // not built: its registers would not fit
  } else {
    CUtensorMap maps[3];
    if (!make_maps<D, DV, BK>(maps, c.q, c.k, c.v, c.B, c.Sq, c.Skv, c.H, c.K))
      return cudaErrorInvalidValue;
    constexpr int smem = smem_bytes<D, DV, NWG, RW, BK>();
    static bool configured = false;  // once per instantiation (a repeat is harmless)
    if (!configured) {
      const cudaError_t err =
          cudaFuncSetAttribute(flash_fwd_sm90_kernel<D, DV, NWG, RW, BK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      configured = true;
    }
    const dim3 grid(c.H / NWG, c.B, (c.Sq + RW * BQ - 1) / (RW * BQ));
    flash_fwd_sm90_kernel<D, DV, NWG, RW, BK><<<grid, NWG * RW * WG, smem, c.stream>>>(
        maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(c.out),
        static_cast<float*>(c.lse), c.Sq, c.Skv, c.H, c.K,
        LOG2E / sqrtf(static_cast<float>(D)), c.causal);
    return cudaGetLastError();
  }
}

// The instantiation of block_q x block_k; NWG q-heads a block.
template <int D, int DV, int NWG>
cudaError_t launch_nwg(const Call& c, int block_q, int block_k) {
  if (block_q == 64 && block_k == 64) return launch_tiles<D, DV, NWG, 1, 64>(c);
  if (block_q == 64 && block_k == 128) return launch_tiles<D, DV, NWG, 1, 128>(c);
  if (block_q == 128 && block_k == 64) return launch_tiles<D, DV, NWG, 2, 64>(c);
  if (block_q == 128 && block_k == 128) return launch_tiles<D, DV, NWG, 2, 128>(c);
  return cudaErrorInvalidValue;
}

// Two q-heads a block when they share a kv-head (H/K even), else one.
template <int D, int DV>
cudaError_t launch(const Call& c, int block_q, int block_k) {
  if ((c.H / c.K) % 2 == 0) return launch_nwg<D, DV, 2>(c, block_q, block_k);
  return launch_nwg<D, DV, 1>(c, block_q, block_k);
}

template <int D, int DV, int NWG>
int smem_nwg(int block_q, int block_k) {
  if (block_q == 64 && block_k == 64) return smem_bytes<D, DV, NWG, 1, 64>();
  if (block_q == 64 && block_k == 128)
    return admits<DV, NWG, 1, 128>() ? smem_bytes<D, DV, NWG, 1, 128>() : -1;
  if (block_q == 128 && block_k == 64)
    return admits<DV, NWG, 2, 64>() ? smem_bytes<D, DV, NWG, 2, 64>() : -1;
  if (block_q == 128 && block_k == 128)
    return admits<DV, NWG, 2, 128>() ? smem_bytes<D, DV, NWG, 2, 128>() : -1;
  return -1;
}

template <int D, int DV>
int smem_dv(int heads, int block_q, int block_k) {
  if (heads == 2) return smem_nwg<D, DV, 2>(block_q, block_k);
  if (heads == 1) return smem_nwg<D, DV, 1>(block_q, block_k);
  return -1;
}

}  // namespace

// q (B,Sq,H,D), k (B,Skv,K,D), v (B,Skv,K,Dv) contiguous bf16 with 16-byte
// aligned pointers; out (B,Sq,H,Dv) bf16, lse (B,H,Sq) fp32; block_q (64 or
// 128: query rows of a q-head in a block) and block_k (64 or 128: keys a
// tile).  Returns the cudaError_t of the launch (cudaErrorInvalidValue when
// a tensor map cannot be made, (D, Dv) is not one of (32, 32), (64, 64),
// (96, 96), (128, 128), (96, 64), or the tiles' instantiation is not built).
extern "C" int repro_flash_attention_fwd_sm90(const void* q, const void* k, const void* v,
                                              void* out, void* lse, int B, int Sq, int Skv,
                                              int H, int K, int D, int Dv, int causal,
                                              int block_q, int block_k, void* stream) {
  const Call c{q, k, v, out, lse, B, Sq, Skv, H, K, causal, static_cast<cudaStream_t>(stream)};
  if (D == 96 && Dv == 64) return launch<96, 64>(c, block_q, block_k);
  if (D != Dv) return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<32, 32>(c, block_q, block_k);
    case 64: return launch<64, 64>(c, block_q, block_k);
    case 96: return launch<96, 96>(c, block_q, block_k);
    case 128: return launch<128, 128>(c, block_q, block_k);
    default: return cudaErrorInvalidValue;
  }
}

// A block's dynamic shared memory at (D, Dv), `heads` q-heads a block (1 or
// 2) and block_q x block_k; -1 where that instantiation is not built.
extern "C" int repro_flash_attention_fwd_sm90_smem(int D, int Dv, int heads, int block_q,
                                                   int block_k) {
  if (D == 96 && Dv == 64) return smem_dv<96, 64>(heads, block_q, block_k);
  if (D != Dv) return -1;
  switch (D) {
    case 32: return smem_dv<32, 32>(heads, block_q, block_k);
    case 64: return smem_dv<64, 64>(heads, block_q, block_k);
    case 96: return smem_dv<96, 96>(heads, block_q, block_k);
    case 128: return smem_dv<128, 128>(heads, block_q, block_k);
    default: return -1;
  }
}

// Makes the three tensor maps of one call at the default tiles `reps` times
// and launches nothing: what a call spends on its descriptors, timed by the
// caller.  Returns 0, or cudaErrorInvalidValue when a map cannot be made.
extern "C" int repro_flash_sm90_describe(const void* q, const void* k, const void* v, int B,
                                         int Sq, int Skv, int H, int K, int D, int Dv,
                                         int reps) {
  constexpr int BK = DEFAULT_BLOCK_K;
  CUtensorMap maps[3];
  for (int i = 0; i < reps; ++i) {
    const bool ok =
        D == 96 && Dv == 64 ? make_maps<96, 64, BK>(maps, q, k, v, B, Sq, Skv, H, K)
        : D != Dv           ? false
        : D == 32           ? make_maps<32, 32, BK>(maps, q, k, v, B, Sq, Skv, H, K)
        : D == 64           ? make_maps<64, 64, BK>(maps, q, k, v, B, Sq, Skv, H, K)
        : D == 96           ? make_maps<96, 96, BK>(maps, q, k, v, B, Sq, Skv, H, K)
        : D == 128          ? make_maps<128, 128, BK>(maps, q, k, v, B, Sq, Skv, H, K)
                            : false;
    if (!ok) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}
