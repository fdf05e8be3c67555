// The one row-query dot product of the cache data plane.
//
// gather_scores and frontier_hop both call these, so one (row, query)
// pair scores the same bits in both kernels: a node that is in the
// frontier and among a hop's candidates ties exactly in the beam merge.
// The order is fixed: lane l accumulates 4-wide chunks l, l+32, ... with
// fmaf in fp32 (no TF32, no tensor cores), then a fixed xor-shuffle tree
// sums the 32 lanes. Every lane ends with the same value. On int8 rows
// the per-row scale multiplies after the dot. d must be a multiple of 4
// and rows 16-byte (fp32) or 4-byte (int8) aligned; the wrappers check.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kInvalid = -1;
constexpr int kTombstone = -2;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFullMask, acc, off);
  return acc;
}

__device__ __forceinline__ float lane_dot_f32(const float* __restrict__ row,
                                              const float* __restrict__ q,
                                              int d, int lane) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float acc = 0.f;
  for (int i = lane; i < (d >> 2); i += 32) {
    float4 a = r4[i];
    float4 b = q4[i];
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
  return acc;
}

__device__ __forceinline__ float lane_dot_i8(const int8_t* __restrict__ row,
                                             const float* __restrict__ q,
                                             int d, int lane) {
  const char4* r4 = reinterpret_cast<const char4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float acc = 0.f;
  for (int i = lane; i < (d >> 2); i += 32) {
    char4 a = r4[i];
    float4 b = q4[i];
    acc = fmaf(static_cast<float>(a.x), b.x, acc);
    acc = fmaf(static_cast<float>(a.y), b.y, acc);
    acc = fmaf(static_cast<float>(a.z), b.z, acc);
    acc = fmaf(static_cast<float>(a.w), b.w, acc);
  }
  return acc;
}

// Score of table row `row_id` against query `q`, called by all 32 lanes of
// a warp. `table` is fp32 (scales == nullptr) or int8 with per-row scales.
__device__ __forceinline__ float warp_row_score(const void* __restrict__ table,
                                                const float* __restrict__ scales,
                                                long long row_id,
                                                const float* __restrict__ q,
                                                int d, int lane) {
  if (scales == nullptr) {
    const float* row = static_cast<const float*>(table) + row_id * d;
    return warp_sum(lane_dot_f32(row, q, d, lane));
  }
  const int8_t* row = static_cast<const int8_t*>(table) + row_id * d;
  return warp_sum(lane_dot_i8(row, q, d, lane)) * scales[row_id];
}

}  // namespace repro_torch
