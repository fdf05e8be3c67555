// mamba_scan: the Mamba1 selective scan, state carried over the whole
// sequence. Replaces repro/kernels/mamba_scan.py: mamba_scan (_mamba_kernel).
//
//   h_t = exp(dt_t · A) ⊙ h_{t-1} + (dt_t · x_t) ⊗ B_t      (Dm, N) per sequence
//   y_t = Σ_n h_t[:, n] · C_t[n] + D ⊙ x_t
//
// x (Bt, L, Dm) fp32 or bf16; dt (Bt, L, Dm), A (Dm, N), B and C (Bt, L, N),
// D (Dm,) and the state fp32. y takes x's dtype; h_final is fp32.
//
// Bound on the H100: bytes at the serve shape (x, dt and y stream once, B
// and C are shared by a sequence's channels, the state is read and written
// once), with one exp per state element and step on the SFUs close behind
// (16 a clock per SM); on a long sequence with few channels the exps are
// the floor.
//
// Design. The TPU kernel walks L over a sequential grid with the state in
// VMEM scratch. Hopper blocks run in no order, so here one block of 128
// threads owns CH channels of one sequence for the whole of L, and nothing
// of size (Bt, L, Dm, N) is ever materialized:
// - A lane holds 4 state elements h[d, n0:n0+4] of one channel (N/4 lanes
//   a channel: CH = 32 for N = 16, 64 for N = 8) and A[d, n0:n0+4]·log2(e)
//   in registers, and reads h0 and writes h_out as float4 (the wrapper
//   requires A, B, C and the state 16-byte aligned). Each lane reads its own state elements once before
//   the walk and writes them once after it, so h_out may alias h0.
// - A step costs a lane one dt·x, four ex2(dt·A') on the SFUs, four
//   h = fma(e, h, dt·x·B[n]) and a 4-term partial of h·C, which it stores
//   to shared memory: no shuffle and no predicate in the walk, so the
//   unrolled steps overlap everywhere but in the FMA that carries h, and
//   each burst of 4 steps issues its 16 exps before its h updates.
// - The sequence is walked in chunks of 32 steps: x and dt (32 × CH,
//   coalesced rows) and B and C (32 × N, read as broadcast float4s) are
//   staged in shared memory, and the next chunk's loads are in flight (in
//   registers, x as stored) during the walk. The ragged last chunk is
//   padded with dt = x = 0, which leaves h exactly as it is (ex2(0) = 1),
//   and its y rows are not written. After the walk each thread sums a
//   channel's N/4 partials per step and writes y as coalesced rows.
// - A decode step (L = 1) skips the staging: a second kernel reads x, dt,
//   B and C straight from global memory and sums y by xor shuffles.
// Numerics: fp32 throughout; ex2.approx of the pre-scaled A (≤ 2 ulp, as
// expf) instead of expf; y sums each lane's 4 terms in order, D·x joins
// the first lane's, then the lanes in order (shuffles for decode) -
// another order than the plain version's.
#include "attention_common.cuh"

namespace repro_torch {
namespace mamba {

using attn::store;
using attn::to_f32;

constexpr int kThreads = 128;
constexpr int kChunk = 32;                   // steps per staged chunk
constexpr int kBurst = 4;                    // steps whose exps issue ahead of their h updates
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Four consecutive floats at a 16-byte aligned p.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// exp(dt·A) of a lane's 4 state elements (a = A·log2 e).
__device__ __forceinline__ float4 decay(const float4& a, float dtv) {
  return make_float4(ex2(dtv * a.x), ex2(dtv * a.y), ex2(dtv * a.z), ex2(dtv * a.w));
}

// One step of a lane's 4 state elements given their decays e; returns its
// share of y_t.
__device__ __forceinline__ float advance(float4& h, const float4& e, float dtx,
                                        const float4& b, const float4& c) {
  h.x = fmaf(e.x, h.x, dtx * b.x);
  h.y = fmaf(e.y, h.y, dtx * b.y);
  h.z = fmaf(e.z, h.z, dtx * b.z);
  h.w = fmaf(e.w, h.w, dtx * b.w);
  float part = h.x * c.x;
  part = fmaf(h.y, c.y, part);
  part = fmaf(h.z, c.z, part);
  return fmaf(h.w, c.w, part);
}

// Sum over the NL lanes of a channel (consecutive lanes).
template <int NL>
__device__ __forceinline__ float channel_sum(float p) {
#pragma unroll
  for (int off = NL / 2; off > 0; off >>= 1) p += __shfl_xor_sync(attn::kAll, p, off);
  return p;
}

// The NL partials of a channel, read from shared memory, summed in order.
template <int NL>
__device__ __forceinline__ float lane_sum(const float* p) {
  if constexpr (NL == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    return ((v.x + v.y) + v.z) + v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    return v.x + v.y;
  }
}

// This lane's A (times log2 e), its initial state, and where the state lives.
struct Lane {
  float4 a, h;
  long long hidx;
};

template <int N>
__device__ __forceinline__ Lane lane_state(const float* A, const float* h0, int b, int d,
                                           int g, int Dm) {
  const bool live = d < Dm;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  Lane st;
  st.hidx = (static_cast<long long>(b) * Dm + d) * N + 4 * g;
  const float4 a = live ? load4(A + static_cast<long long>(d) * N + 4 * g) : z;
  st.a = make_float4(a.x * kLog2e, a.y * kLog2e, a.z * kLog2e, a.w * kLog2e);
  st.h = live && h0 != nullptr ? load4(h0 + st.hidx) : z;
  return st;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ D, const float* h0, T* __restrict__ y, float* h_out,
    int L, int Dm) {
  constexpr int TL = kChunk, kU = kBurst;
  constexpr int NL = N / 4;                  // lanes per channel
  constexpr int CH = kThreads / NL;          // channels per block
  constexpr int KX = TL * CH / kThreads;     // x (and dt) values a thread stages
  constexpr int KB = TL * N / kThreads;      // B (and C) values a thread stages
  __shared__ float s_x[TL][CH], s_dt[TL][CH], s_p[TL][kThreads];
  __shared__ float4 s_B[TL][NL], s_C[TL][NL];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int c = threadIdx.x / NL;            // this lane's channel in the block
  const int g = threadIdx.x % NL;            // its state elements 4g..4g+3
  const int d = d0 + c;
  Lane st = lane_state<N>(A, h0, b, d, g, Dm);
  // D·x joins the first lane's partial of each channel
  const float dd = d < Dm && g == 0 ? D[d] : 0.f;

  T rx[KX];                                  // x as stored: converted when staged
  float rdt[KX], rb[KB], rc[KB];
  auto fetch = [&](int t0) {                 // chunk t0's loads into registers
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const int i = threadIdx.x + k * kThreads, tt = i / CH, cc = i % CH;
      const bool ok = t0 + tt < L && d0 + cc < Dm;
      const long long off = (static_cast<long long>(b) * L + t0 + tt) * Dm + d0 + cc;
      rx[k] = ok ? x[off] : T{};
      rdt[k] = ok ? dt[off] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const bool ok = t0 + i / N < L;
      const long long off = (static_cast<long long>(b) * L + t0) * N + i;
      rb[k] = ok ? Bm[off] : 0.f;
      rc[k] = ok ? Cm[off] : 0.f;
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < L; t0 += TL) {
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const int i = threadIdx.x + k * kThreads;
      (&s_x[0][0])[i] = to_f32(rx[k]);
      (&s_dt[0][0])[i] = rdt[k];
    }
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const int i = threadIdx.x + k * kThreads;
      reinterpret_cast<float*>(s_B)[i] = rb[k];
      reinterpret_cast<float*>(s_C)[i] = rc[k];
    }
    __syncthreads();
    if (t0 + TL < L) fetch(t0 + TL);
    // The walk: no shuffle and no predicate, so the unrolled steps overlap
    // everywhere but in the FMA that carries h.
#pragma unroll
    for (int t1 = 0; t1 < TL; t1 += kU) {
      float4 e[kU];
      float xs[kU], dtx[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float dtv = s_dt[t1 + u][c];
        xs[u] = s_x[t1 + u][c];
        dtx[u] = dtv * xs[u];
        e[u] = decay(st.a, dtv);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
        s_p[t1 + u][threadIdx.x] =
            fmaf(dd, xs[u], advance(st.h, e[u], dtx[u], s_B[t1 + u][g], s_C[t1 + u][g]));
    }
    __syncthreads();
    // y: a channel's NL partials, in lane order, as coalesced rows.
    const int tl = min(TL, L - t0);
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const int i = threadIdx.x + k * kThreads, tt = i / CH, cc = i % CH;
      if (tt < tl && d0 + cc < Dm)
        store(y + (static_cast<long long>(b) * L + t0 + tt) * Dm + d0 + cc,
              lane_sum<NL>(&s_p[tt][cc * NL]));
    }
  }
  if (d < Dm) store4(h_out + st.hidx, st.h);
}

// L = 1: one step, nothing staged.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) mamba_step_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ D, const float* h0, T* __restrict__ y, float* h_out,
    int Dm) {
  constexpr int NL = N / 4;
  constexpr int CH = kThreads / NL;
  const int b = blockIdx.y;
  const int c = threadIdx.x / NL;
  const int g = threadIdx.x % NL;
  const int d = blockIdx.x * CH + c;
  const bool live = d < Dm;
  Lane st = lane_state<N>(A, h0, b, d, g, Dm);
  const long long xo = static_cast<long long>(b) * Dm + d;
  const float xv = live ? to_f32(x[xo]) : 0.f;
  const float dtv = live ? dt[xo] : 0.f;
  const long long bo = static_cast<long long>(b) * N + 4 * g;
  const float part = channel_sum<NL>(advance(st.h, decay(st.a, dtv), dtv * xv,
                                             load4(Bm + bo), load4(Cm + bo)));
  if (!live) return;
  if (g == 0) store(y + xo, part + D[d] * xv);
  store4(h_out + st.hidx, st.h);
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, const void* D, const void* h0, void* y, void* h_out,
                   int Bt, int L, int Dm, cudaStream_t s) {
  constexpr int CH = kThreads / (N / 4);
  const dim3 grid((Dm + CH - 1) / CH, Bt);
  const T* xp = static_cast<const T*>(x);
  const float* f[] = {static_cast<const float*>(dt), static_cast<const float*>(A),
                      static_cast<const float*>(B), static_cast<const float*>(C),
                      static_cast<const float*>(D), static_cast<const float*>(h0)};
  if (L == 1)
    mamba_step_kernel<T, N><<<grid, kThreads, 0, s>>>(
        xp, f[0], f[1], f[2], f[3], f[4], f[5], static_cast<T*>(y),
        static_cast<float*>(h_out), Dm);
  else
    mamba_scan_kernel<T, N><<<grid, kThreads, 0, s>>>(
        xp, f[0], f[1], f[2], f[3], f[4], f[5], static_cast<T*>(y),
        static_cast<float*>(h_out), L, Dm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* D, const void* h0, void* y, void* h_out,
                       int Bt, int L, int Dm, int N, cudaStream_t s) {
  switch (N) {
    case 8: return launch<T, 8>(x, dt, A, B, C, D, h0, y, h_out, Bt, L, Dm, s);
    case 16: return launch<T, 16>(x, dt, A, B, C, D, h0, y, h_out, Bt, L, Dm, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mamba
}  // namespace repro_torch

// All tensors contiguous, A, B, C, h0 and h_out 16-byte aligned; h0 may
// be null (zeros) and may equal h_out.
// dtype 0 = fp32 x and y, 1 = bf16. N in {8, 16}.
extern "C" int mamba_scan_launch(const void* x, const void* dt, const void* A, const void* B,
                                 const void* C, const void* D, const void* h0, void* y,
                                 void* h_out, int Bt, int L, int Dm, int N, int dtype,
                                 void* stream) {
  using namespace repro_torch::mamba;
  if (Bt == 0 || L == 0 || Dm == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? dispatch_n<__nv_bfloat16>(x, dt, A, B, C, D, h0, y, h_out, Bt, L, Dm, N, s)
                 : dispatch_n<float>(x, dt, A, B, C, D, h0, y, h_out, Bt, L, Dm, N, s);
  return static_cast<int>(err);
}

