// Mamba-1 selective scan for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_scan_kernel` reached through
// `mamba_scan_pallas` in src/repro/kernels/mamba_scan/mamba_scan.py.
// Same function, per batch b, channel d and state n:
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t,   y_t = sum_n C_t[n] * h_t[n],
// from h0 (zeros when no h0 is passed), all in fp32; outputs y (b,s,d) and
// h_final (b,d,n).  Any sequence length works: the ragged tail of the last
// time tile is masked, so there is no divisor rule.
//
// What bounds it on an H100 (published SXM peaks at its 700 W limit): two
// floors lie close together.  Bytes: x, dt and y are b*s*d fp32 values each
// (~201 MB at b=4, s=512, d=8192), over 3.35 TB/s.  Exponentials: one per
// (b, s, d, n), 268 M at those shapes, on the multi-function unit at 16 a
// clock per SM.  The fp32 arithmetic (6 flop an element) is well below both.
//
// Design.  The Pallas kernel tiles (batch, d-block) over the parallel grid
// and walks sequence chunks on the sequential grid axis with the state in
// VMEM scratch.  Blocks run in no order on Hopper, so here each block walks
// the whole sequence itself, with the state in registers: a block of 128
// threads owns one batch row and 128/G channels, and G lanes of a warp share
// a channel, 4 states each (G = 4 for n = 16), so there are enough threads
// to fill the card (4 x 8192 channels x 4 lanes = 131,072 at the serve
// shapes).  Each pass stages a tile of T time steps of x, dt, B and C in
// shared memory with coalesced loads (x and dt may be strided views: the
// batch and time strides are arguments), then every thread steps through
// the tile: 4 exponentials, the state update, its part of y, and a butterfly
// over the G lanes of the channel (__shfl_xor_sync).  y goes back through
// shared memory as coalesced rows.  The time loop is unrolled, so that the
// exponentials and shared-memory reads of several steps overlap.
//
// Exponentials: exp(dt A) is computed as exp2f(dt * (A log2 e)), not with
// the __expf intrinsic.  exp2f is the full-range function, within 2 ulp of
// exp2 (CUDA programming guide; expf's bound is the same); rounding A log2 e
// and the product adds at most 2^-23 |dt A| of relative error, which is
// large only where exp(dt A) is already negligible.  On the H100 the
// outputs stay well inside the reference tolerance 1e-4 + 1e-4 |ref| of the
// plain scan, and exp2f is faster than expf's longer range reduction
// (PERF.md has both readings).

#include <cstddef>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NS = 4;  // states per thread
constexpr float kLog2e = 1.4426950408889634f;

template <int G>  // lanes per channel
__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const float* __restrict__ Bm,
            const float* __restrict__ Cm, const float* __restrict__ h0,
            float* __restrict__ y, float* __restrict__ hf, int s, int d, int n,
            long long sxb, long long sxt, long long sdb, long long sdt,
            long long sbb, long long sbt, long long scb, long long sct) {
  constexpr int DC = THREADS / G;  // channels per block
  constexpr int T = 8 * G;         // time steps per tile: T * DC = 1024
  constexpr int NW = NS * G;       // state slots per channel, >= n
  __shared__ float xs[T][DC], dts[T][DC], ys[T][DC];
  __shared__ __align__(16) float bs[T][NW];
  __shared__ __align__(16) float cs[T][NW];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * DC;
  const int c = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const int ch = d0 + c;
  const bool live = ch < d;

  float a[NS], h[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int st = g * NS + k;
    const bool on = live && st < n;
    // exp(dt A) = exp2(dt A log2(e)); a masked state keeps h = 0: exp2(0)
    // = 1 and its B and C slots are 0
    a[k] = on ? A[static_cast<size_t>(ch) * n + st] * kLog2e : 0.f;
    h[k] = (on && h0 != nullptr) ? h0[(static_cast<size_t>(b) * d + ch) * n + st] : 0.f;
  }
  const float* xb = x + b * sxb + d0;
  const float* dtb = dt + b * sdb + d0;
  const float* Bb = Bm + b * sbb;
  const float* Cb = Cm + b * scb;
  float* yb = y + static_cast<size_t>(b) * s * d + d0;

  for (int t0 = 0; t0 < s; t0 += T) {
    const int tn = min(T, s - t0);
    for (int i = threadIdx.x; i < T * DC; i += THREADS) {
      const int tt = i / DC, cc = i % DC;
      const bool ok = tt < tn && d0 + cc < d;
      xs[tt][cc] = ok ? xb[(t0 + tt) * sxt + cc] : 0.f;
      dts[tt][cc] = ok ? dtb[(t0 + tt) * sdt + cc] : 0.f;
    }
    for (int i = threadIdx.x; i < T * NW; i += THREADS) {
      const int tt = i / NW, k = i % NW;
      const bool ok = tt < tn && k < n;
      bs[tt][k] = ok ? Bb[(t0 + tt) * sbt + k] : 0.f;
      cs[tt][k] = ok ? Cb[(t0 + tt) * sct + k] : 0.f;
    }
    __syncthreads();
    // unrolled, so that the exponentials and shared-memory reads of several
    // steps overlap: only the state update is a chain from step to step
#pragma unroll 8
    for (int tt = 0; tt < tn; ++tt) {
      const float dv = dts[tt][c];
      const float dx = dv * xs[tt][c];
      const float4 bv = *reinterpret_cast<const float4*>(&bs[tt][g * NS]);
      const float4 cv = *reinterpret_cast<const float4*>(&cs[tt][g * NS]);
      const float bk[NS] = {bv.x, bv.y, bv.z, bv.w};
      const float ck[NS] = {cv.x, cv.y, cv.z, cv.w};
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        h[k] = h[k] * exp2f(dv * a[k]) + dx * bk[k];
        acc += ck[k] * h[k];
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (g == 0) ys[tt][c] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < T * DC; i += THREADS) {
      const int tt = i / DC, cc = i % DC;
      if (tt < tn && d0 + cc < d) yb[static_cast<size_t>(t0 + tt) * d + cc] = ys[tt][cc];
    }
  }
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int st = g * NS + k;
    if (live && st < n) hf[(static_cast<size_t>(b) * d + ch) * n + st] = h[k];
  }
}

template <int G>
cudaError_t launch(const float* x, const float* dt, const float* A, const float* B,
                   const float* C, const float* h0, float* y, float* hf, int b, int s,
                   int d, int n, long long sxb, long long sxt, long long sdb,
                   long long sdt, long long sbb, long long sbt, long long scb,
                   long long sct, cudaStream_t stream) {
  constexpr int DC = THREADS / G;
  const dim3 grid((d + DC - 1) / DC, b);
  scan_kernel<G><<<grid, THREADS, 0, stream>>>(x, dt, A, B, C, h0, y, hf, s, d, n, sxb,
                                               sxt, sdb, sdt, sbb, sbt, scb, sct);
  return cudaGetLastError();
}

}  // namespace

// x, dt (b,s,d) and B, C (b,s,n): fp32 with unit stride along the last axis,
// batch and time strides given (in elements).  A (d,n), h0 (b,d,n) or null:
// contiguous fp32.  Outputs y (b,s,d) and hf (b,d,n): contiguous fp32.
// 1 <= n <= 32.  Returns the cudaError_t of the launch.
extern "C" int repro_mamba_scan_fwd(const void* x, const void* dt, const void* A,
                                    const void* B, const void* C, const void* h0,
                                    void* y, void* hf, int b, int s, int d, int n,
                                    long long sxb, long long sxt, long long sdb,
                                    long long sdt, long long sbb, long long sbt,
                                    long long scb, long long sct, void* stream) {
  if (b < 1 || s < 1 || d < 1 || n < 1 || n > 8 * NS) return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Bf = static_cast<const float*>(B);
  const auto* Cf = static_cast<const float*>(C);
  const auto* h0f = static_cast<const float*>(h0);
  auto* yf = static_cast<float*>(y);
  auto* hff = static_cast<float*>(hf);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SCAN_LAUNCH(G)                                                          \
  return launch<G>(xf, dtf, Af, Bf, Cf, h0f, yf, hff, b, s, d, n, sxb, sxt, sdb, sdt, \
                   sbb, sbt, scb, sct, st)
  if (n <= NS) REPRO_SCAN_LAUNCH(1);
  if (n <= 2 * NS) REPRO_SCAN_LAUNCH(2);
  if (n <= 4 * NS) REPRO_SCAN_LAUNCH(4);
  REPRO_SCAN_LAUNCH(8);
#undef REPRO_SCAN_LAUNCH
}
