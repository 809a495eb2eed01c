// Hopper (sm_90a) machinery shared by the attention kernels
// (flash_attention_sm90.cu, flash_bwd_dq_sm90.cu, flash_bwd_dkv_sm90.cu in
// bf16; flash_attention_sm90_fp32.cu, flash_bwd_dq_sm90_fp32.cu,
// flash_bwd_dkv_sm90_fp32.cu in fp32): on the device, shared-memory
// addresses, mbarriers, TMA tile loads, wgmma descriptors and the wgmma
// forms the kernels issue, bf16 and tf32, the split of fp32 values into two
// bf16 or two tf32 terms, and the split transpose of an fp32 tile; on the
// host, the tensor-map encoder fetched at run time and the maps of a (B, S,
// heads, D) bf16 or fp32 tensor.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

constexpr int WG = 128;  // threads of a warpgroup
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory geometry of a tile with D columns of E-byte elements (E = 2:
// bf16, E = 4: fp32): a tile of `rows` rows is NATOM column atoms of rows x
// SW bytes, each starting on a 1024-byte boundary.  SW, the swizzle span,
// is the larger of 128 and 64 bytes that divides a row: 64 bf16 columns
// (D = 64, 128), 32 for bf16 D = 32 and D = 96 (a 192-byte row is three
// 64-byte atoms, not one 128-byte atom and a stray half), 32 fp32 columns.
template <int D, int E = 2>
struct Geo {
  static constexpr int SW = D * E % 128 == 0 ? 128 : 64;
  static_assert(D * E % SW == 0, "the swizzle atoms must cover a row exactly");
  static constexpr int ATOM = SW / E;
  static constexpr int NATOM = D / ATOM;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;  // wgmma: 128B or 64B swizzle
  static constexpr CUtensorMapSwizzle TMA_SWIZZLE =
      SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  __host__ __device__ static constexpr int atom_bytes(int rows) { return rows * SW; }
  __host__ __device__ static constexpr int tile_bytes(int rows) { return rows * D * E; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the barrier's phase of the given parity to complete.  A wait
// that lasts over ~2^31 clocks (about a second) traps: a lost transfer
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 31)) __trap();
  }
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Bytes of two tiles of `rows` rows of E-byte elements, DA and DB columns
// wide (K and V, or Q and dO): what tma_load_pair brings in.
template <int DA, int DB, int E = 2>
__host__ __device__ constexpr int pair_bytes(int rows) {
  return Geo<DA, E>::tile_bytes(rows) + Geo<DB, E>::tile_bytes(rows);
}

// Tiles of `rows` rows of one head from two maps (K and V, or Q and dO) of
// E-byte elements, DA and DB columns wide, into dst_a and dst_b, each in
// its own width's geometry, completing on `bar`.
template <int DA, int DB, int E = 2>
__device__ __forceinline__ void tma_load_pair(const CUtensorMap* ma, const CUtensorMap* mb,
                                              uint32_t dst_a, uint32_t dst_b, int head,
                                              int row, int b, int rows, uint32_t bar) {
  using GA = Geo<DA, E>;
  using GB = Geo<DB, E>;
  mbar_expect_tx(bar, pair_bytes<DA, DB, E>(rows));
#pragma unroll
  for (int c = 0; c < GA::NATOM; ++c)
    tma_load(dst_a + c * GA::atom_bytes(rows), ma, c * GA::ATOM, head, row, b, bar);
#pragma unroll
  for (int c = 0; c < GB::NATOM; ++c)
    tma_load(dst_b + c * GB::atom_bytes(rows), mb, c * GB::ATOM, head, row, b, bar);
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

// The descriptors of a tile that TMA wrote with Geo<D>'s swizzle, `rows`
// rows at `tile`.  K-major (the operand's reduction axis is D, contiguous):
// the k16 slice kk of D.  MN-major (the reduction axis is the rows, read
// through the transpose immediate): the k16 slice kk of the rows, its
// column atoms atom_bytes(rows) apart.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  using G = Geo<D>;
  const int atom = kk * 16 / G::ATOM;
  const uint32_t off = (kk * 16 % G::ATOM) * 2;
  return desc(tile + atom * G::atom_bytes(rows) + off, 16, 8 * G::SW, G::LAYOUT);
}
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  using G = Geo<D>;
  return desc(tile + kk * 16 * G::SW, G::atom_bytes(rows), 8 * G::SW, G::LAYOUT);
}

// The same for an fp32 tile of D columns read as tf32, K-major only (tf32
// wgmma has no transpose): the k8 slice kk of D, 32 bytes inside a 128-byte
// atom as a bf16 k16 slice is.  A tile of 16 columns (64-byte rows, as
// transpose_split_tf32 writes them for 16 rows) takes Geo<16, 4>'s 64-byte
// swizzle: one atom, its two k8 slices 32 bytes apart.
template <int D>
__device__ __forceinline__ uint64_t desc_k_tf32(uint32_t tile, int rows, int kk) {
  using G = Geo<D, 4>;
  const int atom = kk * 8 / G::ATOM;
  const uint32_t off = (kk * 8 % G::ATOM) * 4;
  return desc(tile + atom * G::atom_bytes(rows) + off, 16, 8 * G::SW, G::LAYOUT);
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy accesses (wgmma operand reads, TMA writes) that a barrier
// orders after them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers that an asynchronous wgmma reads or writes, so the
// compiler neither moves their other uses across the wait nor reuses them
// while the wgmma is in flight.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D = A B (+ D when scale_d), m64nNk16, fp32 += bf16 x bf16, N = 2 x the
// accumulator registers a thread holds.  wgmma_ss: A and B from shared
// memory, both K-major.  wgmma_rs: A from registers (four bf16x2 per
// thread), B from shared memory MN-major (transpose-B), D accumulated.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D = A B (+ D when scale_d), m64nNk8, fp32 += tf32 x tf32 (the operands'
// low 13 mantissa bits are cleared by the caller: split_tf32), N = 2 x the
// accumulator registers a thread holds; the forms of
// SM90_64xNx8_F32TF32TF32_{SS,RS}_TN in CUTLASS's cute/arch/mma_sm90_gmma.hpp.
// Both operands K-major (tf32 takes no transpose immediate).  wgmma_ss_tf32:
// A and B from shared memory.  wgmma_rs_tf32: A from registers, D
// accumulated; a thread's four registers hold A's rows lane/4 (a[0], a[2])
// and lane/4 + 8 (a[1], a[3]) of its warp's 16, at k = lane % 4 (a[0],
// a[1]) and lane % 4 + 4 (a[2], a[3]).
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[8], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[16], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// n48: a 96-column output summed in two parts (the fp32 forward's O and the
// dq pass's dQ at 96 columns), or half of one (the dk/dv pass's dK and dV,
// one warpgroup a half, at 96 columns).
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[24], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x and y (two neighbouring columns of an accumulator) as two bf16 terms:
// hi = bf16(x), lo = bf16(x - hi), each a bf16x2 register of an RS wgmma's
// A fragment.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// Writes a warpgroup's m64nD fp32 accumulator `acc` as bf16 rows of a
// (B, S, heads, D) tensor: row `row0` + the accumulator row, rows >= S
// skipped.  Each thread holds rows lane/4 and lane/4 + 8 of its warp's 16,
// columns 8 i + 2 (lane % 4) and the next.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst,
                                           const float (&acc)[D / 2], int row0, int S,
                                           int heads, int head, int b) {
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + lane / 4 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* p = dst + ((static_cast<size_t>(b) * S + row) * heads + head) * D + c0;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(p + 8 * i) =
          pack_bf16(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

// x as two tf32 terms, as bit patterns: hi = x with its low 13 mantissa bits
// cleared, lo = the same of x - hi (exact).  hi + lo holds x's top 22 or so
// significant bits; hi_a hi_b + hi_a lo_b + lo_a hi_b, each product exact in
// fp32, is a product of fp32 values to about 2^-21 relative.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float4 x, float4& hi, float4& lo) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                   __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
}

// Splits an fp32 tile of `bytes` bytes at `tile`, as TMA wrote it, into its
// tf32 terms: hi in place, lo at the same offset from `lo`.  The two share
// the tile's layout, so the swizzle never needs decoding.  Every thread of
// the block takes part; the caller fences and synchronises before a wgmma
// reads either.
__device__ __forceinline__ void split_tile_tf32(uint8_t* tile, uint8_t* lo, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16) {
    float4 h, l;
    split_tf32(*reinterpret_cast<const float4*>(tile + i), h, l);
    *reinterpret_cast<float4*>(tile + i) = h;
    *reinterpret_cast<float4*>(lo + i) = l;
  }
}

// An accumulator of K 8-column groups (x[4i + e]: row r, column 8i + 2t +
// (e & 1) for e < 2, row r + 8 for e >= 2, t = lane % 4) as two tf32 terms
// in the A-fragment layout of an RS wgmma: slice i's registers (row r slot
// t, r + 8 slot t, r slot t + 4, r + 8 slot t + 4) are columns 2t, 2t,
// 2t + 1, 2t + 1 of group i: x[4i + 0, 2, 1, 3].  The B operand's k slots
// are permuted to match (transpose_split_tf32).
template <int K>
__device__ __forceinline__ void tf32_fragments(const float (&x)[4 * K], uint32_t (&hi)[K][4],
                                               uint32_t (&lo)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    split_tf32(x[4 * i + 0], hi[i][0], lo[i][0]);
    split_tf32(x[4 * i + 2], hi[i][1], lo[i][1]);
    split_tf32(x[4 * i + 1], hi[i][2], lo[i][2]);
    split_tf32(x[4 * i + 3], hi[i][3], lo[i][3]);
  }
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}
__device__ __forceinline__ void sts_u32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}
__device__ __forceinline__ void sts_v4(uint32_t addr, const uint32_t (&x)[4]) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(x[0]),
               "r"(x[1]), "r"(x[2]), "r"(x[3])
               : "memory");
}

// An fp32 tile of ROWS rows (16 or 32) by D columns at shared address
// `src`, as TMA wrote it (Geo<D, 4>), split into its tf32 terms twice over:
// as it lies, hi at `hi` (which may be `src`: in place) and lo at `lo`, in
// src's layout; and transposed, D rows of ROWS values in Geo<ROWS, 4>'s
// layout (one atom row: 128 bytes with the 128-byte swizzle at ROWS = 32,
// 64 bytes with the 64-byte swizzle at ROWS = 16), hi at `t_hi` and lo at
// `t_lo`.  D is any multiple of 32 (D = 96: three column atoms).  Each
// 8-row group is permuted on the way: row 8g + 2i + e goes to
// k slot 8g + 4e + i, so that an RS wgmma's A fragment taken pairwise from
// an accumulator's registers meets its own rows (flash_attention_sm90_fp32.cu's
// V^T).  A warp takes 32 columns (a lane each) of 4 rows of one parity a
// step: its reads and in-layout writes cover a row of an atom, its 16-byte
// transposed writes 32 rows, conflict-free all.  Each element is read and
// written by one thread, so hi may overwrite src.  Every warp of the block
// takes part; the caller fences and synchronises before a wgmma reads any
// of the four.  The lane passes through an empty asm, so the compiler makes
// the offsets at each call rather than holding them in registers between
// calls.
template <int D, int ROWS>
__device__ __forceinline__ void transpose_split_tf32(uint32_t src, uint32_t hi, uint32_t lo,
                                                     uint32_t t_hi, uint32_t t_lo) {
  constexpr int RB = ROWS * 4;  // bytes of a transposed row
  int lane = threadIdx.x % 32;
  asm volatile("" : "+r"(lane));
  const int warps = blockDim.x / 32;
#pragma unroll 1
  for (int u = threadIdx.x / 32; u < D * ROWS / 128; u += warps) {
    const int atom = u / (ROWS / 4), g = u % (ROWS / 4) / 2, e = u % 2;
    const int col = atom * Geo<D, 4>::atom_bytes(ROWS) + (lane % 4) * 4;
    uint32_t off[4], h[4], l[4];
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the four loads first: one wait, not four
      const int row = 8 * g + 2 * i + e;
      off[i] = col + row * 128 + ((lane / 4) ^ (row % 8)) * 16;
      x[i] = lds_f32(src + off[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split_tf32(x[i], h[i], l[i]);
      sts_u32(hi + off[i], h[i]);
      sts_u32(lo + off[i], l[i]);
    }
    const int d = 32 * atom + lane;
    const uint32_t toff = d * RB + ((2 * g + e) ^ ((d * RB >> 7) & (RB / 16 - 1))) * 16;
    sts_v4(t_hi + toff, h);
    sts_v4(t_lo + toff, l);
  }
}

// Writes a warpgroup's m64nN fp32 accumulator `acc` as fp32 rows of a
// (B, S, heads, D) tensor, as store_rows does in bf16: N columns from
// `dst` (N = D: the whole row; a caller that owns columns c.. of the row
// passes dst + c).
template <int D, int N = D>
__device__ __forceinline__ void store_rows_f32(float* __restrict__ dst,
                                               const float (&acc)[N / 2], int row0, int S,
                                               int heads, int head, int b) {
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + lane / 4 + 8 * r;
    if (row >= S) continue;
    float* p = dst + ((static_cast<size_t>(b) * S + row) * heads + head) * D + c0;
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      *reinterpret_cast<float2*>(p + 8 * i) =
          make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: no link to
// libcuda at build time.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, S, heads, D) of E-byte elements (E = 2: bf16, 4: fp32) as a 4-D map
// (D, heads, S, B), box (ATOM, 1, rows, 1).  Rows past S are zero-filled.
template <int D, int E = 2>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int rows) {
  using G = Geo<D, E>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  // The driver's encoder fails without a current context, and a thread
  // whose first CUDA call this is (a fresh autograd worker, whose tensors
  // came from the caching allocator) has none until a runtime call binds
  // the device's primary context: cudaFree(nullptr) does, once a thread.
  static thread_local bool bound = false;
  if (!bound) {
    if (cudaFree(nullptr) != cudaSuccess) return false;
    bound = true;
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * E,
                                 static_cast<cuuint64_t>(heads) * D * E,
                                 static_cast<cuuint64_t>(S) * heads * D * E};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::ATOM), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      E == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, G::TMA_SWIZZLE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
