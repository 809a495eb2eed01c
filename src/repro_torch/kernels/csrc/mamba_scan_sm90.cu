// Mamba-1 selective scan for Hopper, sm_90a: one thread a channel, tiles
// of the inputs copied asynchronously (or 2 or 4 lanes a channel).
//
// Replaces the Pallas TPU kernel `_scan_kernel` reached through
// `mamba_scan_pallas` in src/repro/kernels/mamba_scan/mamba_scan.py.
// Same function, per batch b, channel d and state n:
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t,   y_t = sum_n C_t[n] * h_t[n],
// from h0 (zeros when no h0 is passed), all in fp32; outputs y (b,s,d) and
// h_final (b,d,n).  Any sequence length and any channel count work: the
// ragged tail of the last time tile and of the last channel block are
// masked, so there is no divisor rule.
//
// What bounds it on an H100 (published SXM peaks at its 700 W limit): the
// exponentials.  One per (b, s, d, n), 268 M at b=4, s=512, d=8192, n=16,
// on the multi-function unit at 16 a clock per SM: 64 us at 1,980 MHz.
// Just below lie the bytes, x, dt and y being b*s*d fp32 values each (~204
// MB at those shapes, 61 us at 3.35 TB/s).  The rest of the fp32 work (5
// operations an element) is below both.
//
// Design.  The Pallas kernel tiles (batch, d-block) over the parallel grid
// and walks sequence chunks on the sequential grid axis with the state in
// VMEM scratch.  Blocks run in no order on Hopper, so here each block walks
// the whole sequence itself, with the state in registers.  A block of 128
// threads owns one batch row and 128 channels: each thread one channel and
// all its n <= 16 states (n <= 32: two lanes a channel, 16 states each, and
// one shuffle for y).  So every (b, t, d) element costs one thread one read
// of dt and x and one product dt*x, and each step has 16 independent
// exponentials to keep the multi-function unit busy; the grid, 256 blocks
// at the serve shape and 128 in training, is one wave on the 132 SMs.  (Two
// lanes a channel at n = 16, 8 states each, were timed once against this
// and were slower at the serve shape: PERF.md section 6.)  The lanes a
// channel are a launch parameter (the tuning cache's `mamba` entries,
// repro_torch/tune/space.py): 1, 2 or 4 at n <= 16, 2 at n <= 32; 0 is the
// rule above (`geometry`).  With G lanes a block holds 128/G channels, each
// lane NS states, and y is summed across the G lanes by shuffles.
// Tiles of T = 16 time steps of x and dt (T x 128 channels) and of B and C
// (T x n) are copied into shared memory with cp.async (16 bytes a copy
// where the rows are 16-byte aligned, else 4) in a ring of 3 stages, so
// that tiles t+1 and t+2 arrive while tile t is stepped; one barrier a
// tile.  A whole tile's steps are unrolled and y is summed in four partial
// sums, so that the exponentials and loads of several steps overlap.  x,
// dt, B and C may be strided views: their batch and time strides are
// arguments.  y is stored at each step straight from the registers: a
// warp's 32 channels make one coalesced 128-byte row.
//
// Exponentials: exp(dt A) = 2^(dt * (A log2 e)), with A log2 e held in
// registers, as one `ex2.approx.ftz.f32` (one MUFU.EX2 instruction).  Its
// relative error is about 2^-22, and flushing results below 2^-126 to 0
// moves h by less than 2^-126 |h|.  tests/test_torch_scan_sm90.py holds the
// stepwise recurrence with every exponential off by 2^-21 (either sign)
// within the reference tolerance 1e-4 at s = 512.

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int T = 16;  // time steps a tile
constexpr int STAGES = 3;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A block's tile ring in bytes: STAGES stages of x, dt, B and C.
constexpr int ring_bytes(int G, int NS) {
  return STAGES * (2 * T * (THREADS / G) + 2 * T * G * NS) * 4;
}

// G lanes a channel, NS states a lane.
template <int G, int NS>
struct Geo {
  static constexpr int DC = THREADS / G;  // channels a block
  static constexpr int NW = G * NS;       // state slots a channel
  static constexpr int XS = T * DC;       // floats of x (and of dt) a stage
  static constexpr int BS = T * NW;       // floats of B (and of C) a stage
  static constexpr int STAGE = 2 * XS + 2 * BS;
  static constexpr int BYTES = ring_bytes(G, NS);
  static_assert(BYTES == STAGES * STAGE * 4, "the ring's layout");
};

template <int G, int NS>
__global__ void __launch_bounds__(THREADS)
scan_sm90_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ h0,
                 float* __restrict__ y, float* __restrict__ hf, int s, int d, int n,
                 long long sxb, long long sxt, long long sdb, long long sdt, long long sbb,
                 long long sbt, long long scb, long long sct, int x16, int bc16) {
  using Q = Geo<G, NS>;
  constexpr int DC = Q::DC, NW = Q::NW;
  extern __shared__ __align__(16) float smem[];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * DC;
  const int c = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const int ch = d0 + c;
  const bool live = ch < d;

  // B and C slots past n are never copied and must read 0 (a masked state
  // keeps h = 0: 2^0 = 1 and its B and C are 0)
  for (int i = threadIdx.x; i < STAGES * Q::STAGE; i += THREADS) smem[i] = 0.f;
  __syncthreads();

  const float* xb = x + b * sxb + d0;
  const float* dtb = dt + b * sdb + d0;
  const float* Bb = Bm + b * sbb;
  const float* Cb = Cm + b * scb;
  const int n_tiles = (s + T - 1) / T;
  // this thread's 16-byte copies of a tile's x and dt: channels cc..cc+3 of
  // rows cr, cr + RPP, ... (a ragged last chunk zero-filled)
  constexpr int CPR = DC / 4;         // chunks a row
  constexpr int RPP = THREADS / CPR;  // rows a pass
  static_assert(T % RPP == 0, "whole passes a tile");
  const int cr = threadIdx.x / CPR, cc = (threadIdx.x % CPR) * 4;
  const int cvalid = max(0, min(4, d - d0 - cc));

  auto issue = [&](int tile) {
    float* st = smem + (tile % STAGES) * Q::STAGE;
    const int t0 = tile * T;
    const int tn = min(T, s - t0);
    if (x16) {
#pragma unroll
      for (int p = 0; p < T / RPP; ++p) {
        const int r = cr + p * RPP;
        const int v = r < tn ? cvalid : 0;
        repro::cp_async16(st + r * DC + cc, v ? xb + (t0 + r) * sxt + cc : xb, 4 * v);
        repro::cp_async16(st + Q::XS + r * DC + cc, v ? dtb + (t0 + r) * sdt + cc : dtb, 4 * v);
      }
    } else {  // rows that are not 16-byte aligned: 4-byte copies
      for (int i = threadIdx.x; i < T * DC; i += THREADS) {
        const int r = i / DC, k = i % DC;
        const bool ok = r < tn && d0 + k < d;
        repro::cp_async4(st + i, ok ? xb + (t0 + r) * sxt + k : xb, ok ? 4 : 0);
        repro::cp_async4(st + Q::XS + i, ok ? dtb + (t0 + r) * sdt + k : dtb, ok ? 4 : 0);
      }
    }
    float* bs = st + 2 * Q::XS;
    const int w = bc16 ? 4 : 1;  // floats a copy
    const int per_row = n / w;
    for (int i = threadIdx.x; i < 2 * tn * per_row; i += THREADS) {
      const bool is_c = i >= tn * per_row;
      const int j = is_c ? i - tn * per_row : i;
      const int r = j / per_row, k = (j % per_row) * w;
      const float* src = (is_c ? Cb + (t0 + r) * sct : Bb + (t0 + r) * sbt) + k;
      float* dst = bs + (is_c ? Q::BS : 0) + r * NW + k;
      if (bc16)
        repro::cp_async16(dst, src, 16);
      else
        repro::cp_async4(dst, src, 4);
    }
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) issue(t);
    repro::cp_async_commit();
  }

  float a2[NS], h[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int st = g * NS + k;
    const bool on = live && st < n;
    a2[k] = on ? A[static_cast<size_t>(ch) * n + st] * kLog2e : 0.f;
    h[k] = (on && h0 != nullptr) ? h0[(static_cast<size_t>(b) * d + ch) * n + st] : 0.f;
  }
  float* yb = y + static_cast<size_t>(b) * s * d + ch;

  for (int tile = 0; tile < n_tiles; ++tile) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile `tile` has landed for every thread; tile-1's stage is free
    if (tile + STAGES - 1 < n_tiles) issue(tile + STAGES - 1);
    repro::cp_async_commit();
    const float* xs = smem + (tile % STAGES) * Q::STAGE;
    const float* dts = xs + Q::XS;
    const float* bs = xs + 2 * Q::XS + g * NS;
    const float* cs = bs + Q::BS;
    const int t0 = tile * T;
    const int tn = min(T, s - t0);
    auto step = [&](int tt) {
      const float dv = dts[tt * DC + c];
      const float dx = dv * xs[tt * DC + c];
      float part[4] = {0.f, 0.f, 0.f, 0.f};  // y in four partial sums: shorter chains
#pragma unroll
      for (int k4 = 0; k4 < NS; k4 += 4) {
        const float4 bv = *reinterpret_cast<const float4*>(bs + tt * NW + k4);
        const float4 cv = *reinterpret_cast<const float4*>(cs + tt * NW + k4);
        const float bk[4] = {bv.x, bv.y, bv.z, bv.w};
        const float ck[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          h[k4 + j] = fmaf(h[k4 + j], ex2(dv * a2[k4 + j]), dx * bk[j]);
          part[j] = fmaf(ck[j], h[k4 + j], part[j]);
        }
      }
      float acc = (part[0] + part[1]) + (part[2] + part[3]);
#pragma unroll
      for (int o = 1; o < G; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (live && g == 0) yb[static_cast<size_t>(t0 + tt) * d] = acc;
    };
    // a whole tile fully unrolled, so that the exponentials and shared-memory
    // reads of its steps overlap: only the state update chains step to step
    if (tn == T) {
#pragma unroll
      for (int tt = 0; tt < T; ++tt) step(tt);
    } else {
      for (int tt = 0; tt < tn; ++tt) step(tt);
    }
  }
  repro::cp_async_wait<0>();
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int st = g * NS + k;
    if (live && st < n) hf[(static_cast<size_t>(b) * d + ch) * n + st] = h[k];
  }
}

struct Args {
  const float *x, *dt, *A, *B, *C, *h0;
  float *y, *hf;
  int b, s, d, n;
  long long sxb, sxt, sdb, sdt, sbb, sbt, scb, sct;
};

template <int G, int NS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Q = Geo<G, NS>;
  static bool configured = false;  // once per instantiation (a repeat is harmless)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_sm90_kernel<G, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // 16-byte copies need 16-byte aligned rows
  auto aligned = [](const float* p, long long sb, long long st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 && st % 4 == 0;
  };
  const bool x16 = aligned(a.x, a.sxb, a.sxt) && aligned(a.dt, a.sdb, a.sdt);
  const bool bc16 = a.n % 4 == 0 && aligned(a.B, a.sbb, a.sbt) && aligned(a.C, a.scb, a.sct);
  const dim3 grid((a.d + Q::DC - 1) / Q::DC, a.b);
  scan_sm90_kernel<G, NS><<<grid, THREADS, Q::BYTES, stream>>>(
      a.x, a.dt, a.A, a.B, a.C, a.h0, a.y, a.hf, a.s, a.d, a.n, a.sxb, a.sxt, a.sdb, a.sdt,
      a.sbb, a.sbt, a.scb, a.sct, x16, bc16);
  return cudaGetLastError();
}

// `lanes` lanes a channel (0: one lane with n <= 16 states, two lanes for
// n <= 32), each with the channel's states split evenly, rounded up to 4, 8
// or 16 a lane; false for lanes other than 1, 2 or 4 at n <= 16 and 2 at
// n <= 32.
bool geometry(int n, int lanes, int* G, int* NS) {
  *G = lanes != 0 ? lanes : n > 16 ? 2 : 1;
  if (n > 16 ? *G != 2 : (*G != 1 && *G != 2 && *G != 4)) return false;
  const int per_lane = (n + *G - 1) / *G;
  *NS = per_lane <= 4 ? 4 : per_lane <= 8 ? 8 : 16;
  return true;
}

int run(const void* x, const void* dt, const void* A, const void* B, const void* C,
        const void* h0, void* y, void* hf, int b, int s, int d, int n, long long sxb,
        long long sxt, long long sdb, long long sdt, long long sbb, long long sbt,
        long long scb, long long sct, int lanes, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || d < 1 || n < 1 || n > 32) return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const float*>(B),
               static_cast<const float*>(C), static_cast<const float*>(h0),
               static_cast<float*>(y), static_cast<float*>(hf), b, s, d, n,
               sxb, sxt, sdb, sdt, sbb, sbt, scb, sct};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int G, NS;
  if (!geometry(n, lanes, &G, &NS)) return cudaErrorInvalidValue;
  if (G == 1) return NS == 4 ? launch<1, 4>(a, st) : NS == 8 ? launch<1, 8>(a, st)
                                                             : launch<1, 16>(a, st);
  if (G == 4) return launch<4, 4>(a, st);  // n <= 16: four states a lane
  return NS == 4 ? launch<2, 4>(a, st) : NS == 8 ? launch<2, 8>(a, st) : launch<2, 16>(a, st);
}

}  // namespace

// x, dt (b,s,d) and B, C (b,s,n): fp32 with unit stride along the last axis,
// batch and time strides given (in elements).  A (d,n), h0 (b,d,n) or null:
// contiguous fp32.  Outputs y (b,s,d) and hf (b,d,n): contiguous fp32.
// 1 <= n <= 32, b <= 65535; lanes a channel 1, 2 or 4 at n <= 16, 2 at
// n <= 32, or 0 for `geometry`'s.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for other lanes).
extern "C" int repro_mamba_scan_fwd(const void* x, const void* dt, const void* A,
                                    const void* B, const void* C, const void* h0,
                                    void* y, void* hf, int b, int s, int d, int n,
                                    long long sxb, long long sxt, long long sdb,
                                    long long sdt, long long sbb, long long sbt,
                                    long long scb, long long sct, int lanes, void* stream) {
  return run(x, dt, A, B, C, h0, y, hf, b, s, d, n, sxb, sxt, sdb, sdt, sbb, sbt, scb, sct,
             lanes, stream);
}

// A block's dynamic shared memory (its tile ring) at state size n and
// `lanes` lanes a channel (0: `geometry`'s); -1 where the kernel refuses.
extern "C" int repro_mamba_scan_fwd_smem(int n, int lanes) {
  if (n < 1 || n > 32) return -1;
  int G, NS;
  if (!geometry(n, lanes, &G, &NS)) return -1;
  return ring_bytes(G, NS);
}
