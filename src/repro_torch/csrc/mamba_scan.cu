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
// once), with exp() on the SFUs close behind; the walk over L is
// sequential, so a long sequence with few channels in flight is bound by
// the latency of one step instead.
//
// Design. The TPU kernel walks L over a sequential grid with the state in
// VMEM scratch. Hopper blocks run in no order, so here one block owns CH
// channels of one sequence for the whole of L: a group of N lanes per
// channel, each lane holding one state element h[d, n] in a register, so
// nothing of size (Bt, L, Dm, N) is ever materialized. y_t is the group's
// sum of h·C by __shfl_xor_sync. The sequence is walked in chunks of TL
// steps: the block stages the chunk's x and dt (TL × CH, coalesced rows)
// and B and C (TL × N) in shared memory, walks the chunk, and writes the
// chunk's y from shared memory as coalesced rows. An optional initial
// state h0 (none: zeros, as the TPU kernel) lets a decode step (L = 1)
// continue a sequence; h_out may alias h0, since each lane reads its own
// state element once before the walk and writes it once after it.
#include "attention_common.cuh"

namespace repro_torch {
namespace mamba {

using attn::store;
using attn::to_f32;

constexpr int CH = 16;    // channels per block
constexpr int TL = 64;    // steps staged in shared memory at a time

template <typename T, int N>
__global__ void __launch_bounds__(CH * N) mamba_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ D, const float* h0, T* __restrict__ y, float* h_out,
    int L, int Dm) {
  __shared__ float s_x[TL][CH], s_dt[TL][CH], s_y[TL][CH];
  __shared__ float s_B[TL][N], s_C[TL][N];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int c = threadIdx.x / N;                 // this lane's channel in the block
  const int n = threadIdx.x % N;                 // its state element
  const int d = d0 + c;
  const bool live = d < Dm;
  const float a = live ? A[static_cast<long long>(d) * N + n] : 0.f;
  const float dd = live ? D[d] : 0.f;
  const long long hidx = (static_cast<long long>(b) * Dm + d) * N + n;
  float h = (h0 != nullptr && live) ? h0[hidx] : 0.f;

  for (int t0 = 0; t0 < L; t0 += TL) {
    const int tl = min(TL, L - t0);
    const long long row0 = static_cast<long long>(b) * L + t0;
    for (int i = threadIdx.x; i < tl * CH; i += blockDim.x) {
      const int tt = i / CH, cc = i - tt * CH;
      const long long off = (row0 + tt) * Dm + d0 + cc;
      const bool ok = d0 + cc < Dm;
      s_x[tt][cc] = ok ? to_f32(x[off]) : 0.f;
      s_dt[tt][cc] = ok ? dt[off] : 0.f;
    }
    for (int i = threadIdx.x; i < tl * N; i += blockDim.x) {
      const int tt = i / N, nn = i - tt * N;
      const long long off = (row0 + tt) * N + nn;
      s_B[tt][nn] = Bm[off];
      s_C[tt][nn] = Cm[off];
    }
    __syncthreads();
    for (int tt = 0; tt < tl; ++tt) {
      const float dtv = s_dt[tt][c], xv = s_x[tt][c];
      h = expf(dtv * a) * h + (dtv * xv) * s_B[tt][n];
      float part = h * s_C[tt][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) part += __shfl_xor_sync(attn::kAll, part, off);
      if (n == 0) s_y[tt][c] = part + dd * xv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tl * CH; i += blockDim.x) {
      const int tt = i / CH, cc = i - tt * CH;
      if (d0 + cc < Dm) store(y + (row0 + tt) * Dm + d0 + cc, s_y[tt][cc]);
    }
    __syncthreads();                             // the next chunk overwrites the stage
  }
  if (live) h_out[hidx] = h;
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, const void* D, const void* h0, void* y, void* h_out,
                   int Bt, int L, int Dm, cudaStream_t s) {
  const dim3 grid((Dm + CH - 1) / CH, Bt);
  mamba_scan_kernel<T, N><<<grid, CH * N, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(h_out), L, Dm);
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

// All tensors contiguous; h0 may be null (zeros) and may equal h_out.
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
