// gather_scores: scores[b,k] = <table[idx[b,k]], q[b]> (x scale[idx] on
// int8 rows), -inf where idx < 0. One warp per (b, k); a dead lane loads
// nothing. Replaces repro/kernels/gather_scores.py:gather_scores.
#include "dot.cuh"

namespace repro_torch {

constexpr int kGatherWarps = 8;

__global__ void gather_scores_kernel(const void* __restrict__ table,
                                     const float* __restrict__ scales,
                                     const int* __restrict__ idx,
                                     const float* __restrict__ q,
                                     float* __restrict__ out,
                                     long long n_rows, int d, int B, int K) {
  const int lane = threadIdx.x & 31;
  const long long pair =
      static_cast<long long>(blockIdx.x) * kGatherWarps + (threadIdx.x >> 5);
  if (pair >= static_cast<long long>(B) * K) return;
  const int b = static_cast<int>(pair / K);
  const int row = idx[pair];
  float s = -INFINITY;
  if (row >= 0 && row < n_rows)
    s = warp_row_score(table, scales, row, q + static_cast<long long>(b) * d, d, lane);
  if (lane == 0) out[pair] = s;
}

}  // namespace repro_torch

extern "C" int gather_scores_launch(const void* table, const void* scales,
                                    const void* idx, const void* q, void* out,
                                    long long n_rows, int d, int B, int K,
                                    int quant, void* stream) {
  const long long pairs = static_cast<long long>(B) * K;
  if (pairs > 0) {
    const unsigned blocks = static_cast<unsigned>(
        (pairs + repro_torch::kGatherWarps - 1) / repro_torch::kGatherWarps);
    repro_torch::gather_scores_kernel<<<blocks, 32 * repro_torch::kGatherWarps, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
        table, quant ? static_cast<const float*>(scales) : nullptr,
        static_cast<const int*>(idx), static_cast<const float*>(q),
        static_cast<float*>(out), n_rows, d, B, K);
  }
  return static_cast<int>(cudaGetLastError());
}
