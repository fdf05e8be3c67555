// flat_topk: category-masked cosine top-1 over the whole table. Replaces
// repro/kernels/flat_topk.py:flat_topk.
//
// The TPU kernel carried the running best across a sequential grid in
// VMEM scratch; Hopper's blocks run in no order, so this is two passes.
// Pass 1: block (chunk, query tile) stages kQueryTile queries in shared
// memory; each warp walks rows chunk_start + warp, + kTopkWarps, ... and
// scores every row against the whole query tile from one row load (fp32
// FMA, fixed lane order, xor-shuffle tree; int8 rows are scaled after
// the dot). A row qualifies when valid and its category equals the
// query's (query category < 0 = wildcard); a row that no query of the
// tile can take is not loaded at all. Each warp keeps the first
// best row in its own increasing row order (strict >), then the block
// combines warps and writes one (score, idx) partial per (chunk, query).
// Pass 2 reduces the partials per query. Order: score descending, then
// idx ascending - the lowest index wins, as on the TPU. When nothing
// qualifies the result is (-inf, -1).
#include "dot.cuh"

namespace repro_torch {

constexpr int kTopkWarps = 8;
constexpr int kQueryTile = 8;

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

template <bool kQuant>
__global__ void flat_topk_partial_kernel(const void* __restrict__ table,
                                         const unsigned char* __restrict__ valid,
                                         const int* __restrict__ cat,
                                         const float* __restrict__ scales,
                                         const float* __restrict__ q,
                                         const int* __restrict__ qcat,
                                         float* __restrict__ part_s,
                                         int* __restrict__ part_i,
                                         long long n_rows, int d, int B,
                                         int chunk_rows) {
  extern __shared__ float4 q_smem4[];
  float* q_s = reinterpret_cast<float*>(q_smem4);   // kQueryTile x d
  __shared__ float warp_s[kTopkWarps][kQueryTile];
  __shared__ int warp_i[kTopkWarps][kQueryTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * kQueryTile;
  const int nq = min(kQueryTile, B - q0);
  for (int i = threadIdx.x; i < kQueryTile * d; i += blockDim.x) {
    const int j = i / d;
    q_s[i] = j < nq ? q[static_cast<long long>(q0 + j) * d + (i - j * d)] : 0.f;
  }
  int qc[kQueryTile];
#pragma unroll
  for (int j = 0; j < kQueryTile; ++j) qc[j] = j < nq ? qcat[q0 + j] : -1;
  __syncthreads();

  float best_s[kQueryTile];
  int best_i[kQueryTile];
#pragma unroll
  for (int j = 0; j < kQueryTile; ++j) {
    best_s[j] = -INFINITY;
    best_i[j] = kInvalid;
  }
  const long long start = static_cast<long long>(blockIdx.x) * chunk_rows;
  const long long end = min(start + chunk_rows, n_rows);
  const int d4 = d >> 2;
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  for (long long r = start + warp; r < end; r += kTopkWarps) {
    // Warp-uniform skip: a row that no query of the tile can take
    // (invalid, or of a category none of them asks for) is not loaded.
    if (!valid[r]) continue;
    const int rc = cat == nullptr ? -1 : cat[r];
    bool wanted = false;
#pragma unroll
    for (int j = 0; j < kQueryTile; ++j)
      wanted |= j < nq && (qc[j] < 0 || rc == qc[j]);
    if (!wanted) continue;
    float acc[kQueryTile];
#pragma unroll
    for (int j = 0; j < kQueryTile; ++j) acc[j] = 0.f;
    for (int i = lane; i < d4; i += 32) {
      float4 a;
      if (kQuant) {
        const char4 c = reinterpret_cast<const char4*>(
            static_cast<const int8_t*>(table) + r * d)[i];
        a = make_float4(c.x, c.y, c.z, c.w);
      } else {
        a = reinterpret_cast<const float4*>(
            static_cast<const float*>(table) + r * d)[i];
      }
#pragma unroll
      for (int j = 0; j < kQueryTile; ++j) {
        const float4 b = q4[j * d4 + i];
        acc[j] = fmaf(a.x, b.x, acc[j]);
        acc[j] = fmaf(a.y, b.y, acc[j]);
        acc[j] = fmaf(a.z, b.z, acc[j]);
        acc[j] = fmaf(a.w, b.w, acc[j]);
      }
    }
    const float sc = kQuant ? scales[r] : 1.f;
#pragma unroll
    for (int j = 0; j < kQueryTile; ++j) {
      float s = warp_sum(acc[j]);
      if (kQuant) s *= sc;
      if (j < nq && (qc[j] < 0 || rc == qc[j]) && s > best_s[j]) {
        best_s[j] = s;
        best_i[j] = static_cast<int>(r);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kQueryTile; ++j) {
      warp_s[warp][j] = best_s[j];
      warp_i[warp][j] = best_i[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < nq) {
    const int j = threadIdx.x;
    float bs = warp_s[0][j];
    int bi = warp_i[0][j];
    for (int w = 1; w < kTopkWarps; ++w)
      if (better(warp_s[w][j], warp_i[w][j], bs, bi)) {
        bs = warp_s[w][j];
        bi = warp_i[w][j];
      }
    const long long o = static_cast<long long>(q0 + j) * gridDim.x + blockIdx.x;
    part_s[o] = bs;
    part_i[o] = bi;
  }
}

// One warp per query: lanes stride over the chunks' partials, then a
// shuffle tree combines them under the same (score desc, idx asc) order.
__global__ void flat_topk_reduce_kernel(const float* __restrict__ part_s,
                                        const int* __restrict__ part_i,
                                        float* __restrict__ out_s,
                                        int* __restrict__ out_i,
                                        int B, int n_chunks) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;
  float bs = -INFINITY;
  int bi = kInvalid;
  const long long base = static_cast<long long>(b) * n_chunks;
  for (int c = lane; c < n_chunks; c += 32)
    if (better(part_s[base + c], part_i[base + c], bs, bi)) {
      bs = part_s[base + c];
      bi = part_i[base + c];
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(kFullMask, bs, off);
    const int oi = __shfl_xor_sync(kFullMask, bi, off);
    if (better(os, oi, bs, bi)) {
      bs = os;
      bi = oi;
    }
  }
  if (lane == 0) {
    out_s[b] = bs;
    out_i[b] = bi;
  }
}

}  // namespace repro_torch

extern "C" int flat_topk_launch(const void* table, const void* valid,
                                const void* cat, const void* scales,
                                const void* q, const void* qcat,
                                void* part_s, void* part_i,
                                void* out_s, void* out_i,
                                long long n_rows, int d, int B, int quant,
                                int chunk_rows, int n_chunks, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(n_chunks, (B + kQueryTile - 1) / kQueryTile);
  const size_t smem = static_cast<size_t>(kQueryTile) * d * sizeof(float);
  if (quant) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(flat_topk_partial_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    flat_topk_partial_kernel<true><<<grid, 32 * kTopkWarps, smem, s>>>(
        table, static_cast<const unsigned char*>(valid), static_cast<const int*>(cat),
        static_cast<const float*>(scales), static_cast<const float*>(q),
        static_cast<const int*>(qcat), static_cast<float*>(part_s),
        static_cast<int*>(part_i), n_rows, d, B, chunk_rows);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(flat_topk_partial_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    flat_topk_partial_kernel<false><<<grid, 32 * kTopkWarps, smem, s>>>(
        table, static_cast<const unsigned char*>(valid), static_cast<const int*>(cat),
        nullptr, static_cast<const float*>(q), static_cast<const int*>(qcat),
        static_cast<float*>(part_s), static_cast<int*>(part_i), n_rows, d, B,
        chunk_rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_per_block = 8;
  flat_topk_reduce_kernel<<<(B + warps_per_block - 1) / warps_per_block,
                            32 * warps_per_block, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), B, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
