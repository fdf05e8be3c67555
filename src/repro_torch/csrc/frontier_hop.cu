// frontier_hop: one fused HNSW beam expansion. Replaces
// repro/kernels/frontier_hop.py:frontier_hop.
//
// One block per (b, f) frontier lane. The block stages query b in shared
// memory and reads its own neighbor row neighbors[frontier[b,f]] (the TPU
// kernel had the ids scalar-prefetched; here the block loads them). Each
// warp scores candidates m, m + warps, ... with the shared dot of dot.cuh,
// so its scores are bit-identical to gather_scores'. A dead lane (INVALID
// frontier or neighbor id, or a done query) loads no row and emits
// INVALID / -inf. Routing scores mask only dead lanes; result scores also
// mask meta == TOMBSTONE and other categories (query category < 0 is a
// wildcard). Outputs are (B, F*M), position f*M + m.
#include "dot.cuh"

namespace repro_torch {

constexpr int kHopWarps = 8;

__global__ void frontier_hop_kernel(const void* __restrict__ emb,
                                    const float* __restrict__ scales,
                                    const int* __restrict__ neighbors,
                                    const int* __restrict__ meta,
                                    const int* __restrict__ frontier,
                                    const float* __restrict__ q,
                                    const int* __restrict__ qcat,
                                    const int* __restrict__ done,
                                    int* __restrict__ ids_out,
                                    float* __restrict__ route_out,
                                    float* __restrict__ res_out,
                                    long long n_rows, int d, int M, int F) {
  extern __shared__ float4 q_smem4[];
  float* q_s = reinterpret_cast<float*>(q_smem4);
  const int b = blockIdx.x / F;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int fid = frontier[blockIdx.x];
  const bool live = fid >= 0 && fid < n_rows && done[b] == 0;
  if (live) {
    const float* qb = q + static_cast<long long>(b) * d;
    for (int i = threadIdx.x; i < d; i += blockDim.x) q_s[i] = qb[i];
  }
  __syncthreads();
  const int qc = qcat[b];
  const long long out_base = static_cast<long long>(blockIdx.x) * M;
  for (int m = warp; m < M; m += kHopWarps) {
    const int cid = live ? neighbors[static_cast<long long>(fid) * M + m] : kInvalid;
    int id = kInvalid;
    float route = -INFINITY, res = -INFINITY;
    if (cid >= 0 && cid < n_rows) {
      route = warp_row_score(emb, scales, cid, q_s, d, lane);
      const int mw = meta[cid];
      id = cid;
      if (mw != kTombstone && (qc < 0 || mw == qc)) res = route;
    }
    if (lane == 0) {
      ids_out[out_base + m] = id;
      route_out[out_base + m] = route;
      res_out[out_base + m] = res;
    }
  }
}

}  // namespace repro_torch

extern "C" int frontier_hop_launch(const void* emb, const void* scales,
                                   const void* neighbors, const void* meta,
                                   const void* frontier, const void* q,
                                   const void* qcat, const void* done,
                                   void* ids, void* route, void* res,
                                   long long n_rows, int d, int M, int B, int F,
                                   int quant, void* stream) {
  if (B > 0 && F > 0) {
    const size_t smem = static_cast<size_t>(d) * sizeof(float);
    repro_torch::frontier_hop_kernel<<<B * F, 32 * repro_torch::kHopWarps, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
        emb, quant ? static_cast<const float*>(scales) : nullptr,
        static_cast<const int*>(neighbors), static_cast<const int*>(meta),
        static_cast<const int*>(frontier), static_cast<const float*>(q),
        static_cast<const int*>(qcat), static_cast<const int*>(done),
        static_cast<int*>(ids), static_cast<float*>(route),
        static_cast<float*>(res), n_rows, d, M, F);
  }
  return static_cast<int>(cudaGetLastError());
}
