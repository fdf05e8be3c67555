// gather_scores: scores[b,k] = <table[idx[b,k]], q[b]> (x scale[idx] on
// int8 rows), -inf where idx < 0 or idx >= N. Replaces
// repro/kernels/gather_scores.py:gather_scores (line 96).
//
// gather_scores_masked (replaces gather_scores.py:gather_scores_masked,
// line 173) is the same kernel with the category test: -inf also where
// slot_cat[idx] != qcat[b] and qcat[b] >= 0 (a negative query category is
// a wildcard). A candidate that passes scores through the same dot, so its
// score is bit-equal to gather_scores'.
//
// Bound on the H100. The main path scores the HNSW entry set: 8 ids, the
// same for all B = 8 queries, padded to K = 32 with INVALID
// (core/hnsw.py:beam_search). Its bytes (8 rows, 8 queries, 256 ids and
// 256 scores: 26,624 B in fp32) take 0.0000079 ms at 3.35 TB/s, far below
// one launch. What bounds it is the launch and two dependent loads behind
// it: the id, then the row (and, masked, its category), then a warp
// reduction and the store.
//
// Design. One block per (column k, group of up to 16 queries), one warp
// per query of the group.
// - Every warp loads the column's ids (lane l: query g0 + l's) and its own
//   query's category. A column with no live id leaves at once: warp w
//   stores -inf for its query and nothing else is loaded.
// - The queries on one row form its group (a ballot over the lanes' ids);
//   the lowest of them leads. Only the leader loads the row, so each
//   distinct row is read once per block, whatever number of queries ask
//   for it. In the same step every live warp loads its own query's chunks
//   (and the row's int8 scale and category): the queries wait for no row.
// - A row with more than one query is staged by its leader in its slot of
//   shared memory; after one block barrier (taken only when some row is
//   shared, which every warp decides alike from the same ids, with
//   __match_any_sync) the other queries read it from there.
// - Each warp scores its (row, query) pair in dot.cuh's order: lane l
//   walks chunks l, l + 32, ... with fma_chunk, then warp_sum, then the
//   int8 scale. That is warp_row_score's order, so the scores equal
//   frontier_hop's bit for bit (both feed one beam merge).
// - The masked entry loads the row's category beside the row, both off the
//   id, and applies the test after: one dependent round trip saved against
//   the earlier design (category, then row), at the price of a row read
//   for a group whose queries all fail. A query that fails reads nothing
//   from the staged row.
// - The first 4 chunks a lane needs (d <= 512 in fp32 and int8) are loaded
//   in straight-line code, all in flight at once; wider rows loop over
//   batches of 4.
//
// The grid is K x ceil(B / group) blocks, group = min(16, B, 128 KB / row
// slot) warps (32 blocks of 256 threads at the main path's shape, one
// wave); a block's shared memory is a row slot per warp.
//
// gather_scores_serial_kernel, below, is the earlier design (one warp per
// (b, k) pair; the id, then the category, then the row, one after the
// other, each pair loading its own row). No path runs it: chip_smoke.py
// times it beside this kernel on the same inputs.
#include <algorithm>
#include <type_traits>

#include "dot.cuh"

namespace repro_torch {

constexpr int kGatherWarps = 8;              // the earlier design's warps a block
constexpr int kGatherThreads = 32 * kGatherWarps;
constexpr int kGroupWarps = 16;              // queries of a group, at most: one warp each
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kGatherSlotBytes = 128 * 1024; // a block's row slots, at most (fewer
                                             // queries a group above d 2,048 fp32)
constexpr int kGatherBatch = 4;              // chunks a lane loads at once

struct GatherArgs {
  const void* table;      // (N, d) fp32, or int8 with scales
  const float* scales;    // (N,) on int8 rows, else nullptr
  const int* idx;         // (B, K)
  const float* q;         // (B, d), 16-byte aligned rows
  float* out;             // (B, K)
  const int* slot_cat;    // (N,), masked entry only
  const int* qcat;        // (B,), masked entry only
  long long n_rows;
  int d, B, K;
  int group;              // queries (warps) of a block
  int slot;               // bytes of one row slot in shared memory
};

// Chunks base + lane, base + lane + 32, ... (kGatherBatch of them, those
// below n4) of a row, and of a query.
template <typename Raw>
__device__ __forceinline__ void load_batch(Raw (&c)[kGatherBatch], const Raw* src, int base,
                                           int n4, int lane) {
#pragma unroll
  for (int u = 0; u < kGatherBatch; ++u) {
    const int i = base + u * 32 + lane;
    if (i < n4) c[u] = src[i];
  }
}

// acc gains the batch's row chunks times its query chunks, in chunk order.
template <typename Raw>
__device__ __forceinline__ float fma_batch(const Raw (&c)[kGatherBatch],
                                           const float4 (&qv)[kGatherBatch], int base, int n4,
                                           int lane, float acc) {
#pragma unroll
  for (int u = 0; u < kGatherBatch; ++u)
    if (base + u * 32 + lane < n4) acc = fma_chunk(chunk_f32(c[u]), qv[u], acc);
  return acc;
}

template <bool kInt8, bool kMasked>
__global__ void __launch_bounds__(kGroupThreads)
    gather_scores_kernel(const __grid_constant__ GatherArgs a) {
  using Raw = typename std::conditional<kInt8, char4, float4>::type;  // one 4-value chunk
  extern __shared__ float4 slots[];  // a row slot per warp: the shared row it leads
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int k = blockIdx.x;
  const int g0 = blockIdx.y * a.group;
  const int nq = min(a.group, a.B - g0);
  const int n4 = a.d >> 2;
  const long long b = g0 + w;  // this warp's query, if w < nq

  // The column's ids (lane l holds query g0 + l's) and this warp's query
  // category. A column with no live id loads nothing more: every warp sees
  // the same ids, so the whole block leaves.
  int key = kInvalid;
  if (lane < nq) {
    const int id = a.idx[static_cast<long long>(g0 + lane) * a.K + k];
    if (id >= 0 && id < a.n_rows) key = id;
  }
  const int qc = kMasked && w < nq ? a.qcat[b] : -1;
  const int my = __shfl_sync(kFullMask, key, w);
  if (!__any_sync(kFullMask, key != kInvalid)) {
    if (w < nq && lane == 0) a.out[b * a.K + k] = -INFINITY;
    return;
  }
  // In flight together: this warp's query chunks, and, if it leads its row
  // (the lowest query on it), the row's chunks.
  const bool live = my != kInvalid;
  const unsigned group = __ballot_sync(kFullMask, key == my);
  const bool lead = live && (group & ((1u << w) - 1u)) == 0u;
  const bool stage = lead && __popc(group) > 1;
  const float4* qb = reinterpret_cast<const float4*>(a.q) + b * n4;
  const Raw* row = reinterpret_cast<const Raw*>(
      static_cast<const char*>(a.table) + my * static_cast<long long>(kInt8 ? a.d : 4 * a.d));
  Raw* slot = reinterpret_cast<Raw*>(reinterpret_cast<char*>(slots) + w * a.slot);
  float4 qv[kGatherBatch];
  Raw c[kGatherBatch];
  if (live) load_batch(qv, qb, 0, n4, lane);
  if (lead) load_batch(c, row, 0, n4, lane);
  float scale = 1.f;
  int cat = 0;
  if (live) {
    if (kInt8) scale = a.scales[my];
    if (kMasked) cat = a.slot_cat[my];
  }
  float acc = 0.f;
  if (lead) {
    for (int base = 0;;) {  // the leader stages every chunk before the barrier
      if (stage) {
#pragma unroll
        for (int u = 0; u < kGatherBatch; ++u)
          if (base + u * 32 + lane < n4) slot[base + u * 32 + lane] = c[u];
      }
      acc = fma_batch(c, qv, base, n4, lane, acc);
      base += 32 * kGatherBatch;
      if (base >= n4) break;
      load_batch(c, row, base, n4, lane);
      load_batch(qv, qb, base, n4, lane);
    }
  }
  // Whether any row has more than one query: the same answer in every warp.
  const unsigned same = __match_any_sync(kFullMask, key);
  if (__any_sync(kFullMask, key != kInvalid && __popc(same) > 1)) __syncthreads();
  const bool pass = !kMasked || qc < 0 || cat == qc;
  if (live && !lead && pass) {  // the row from its leader's slot
    const Raw* src = reinterpret_cast<const Raw*>(reinterpret_cast<const char*>(slots) +
                                                  (__ffs(group) - 1) * a.slot);
    for (int base = 0;;) {
      load_batch(c, src, base, n4, lane);
      acc = fma_batch(c, qv, base, n4, lane, acc);
      base += 32 * kGatherBatch;
      if (base >= n4) break;
      load_batch(qv, qb, base, n4, lane);
    }
  }
  if (w >= nq) return;
  float s = -INFINITY;
  if (live && pass) {
    s = warp_sum(acc);
    if (kInt8) s *= scale;
  }
  if (lane == 0) a.out[b * a.K + k] = s;
}

template <bool kInt8, bool kMasked>
cudaError_t launch_kernel(const GatherArgs& a, dim3 grid, cudaStream_t s) {
  const int smem = a.group * a.slot;
  // Raise this instance's dynamic shared-memory ceiling once per size seen.
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_scores_kernel<kInt8, kMasked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  gather_scores_kernel<kInt8, kMasked><<<grid, 32 * a.group, smem, s>>>(a);
  return cudaGetLastError();
}

// The earlier design, timed by chip_smoke.py only: one warp per (b, k)
// pair, 8 warps a block; the warp loads its id, then (masked) the query's
// and the row's categories, then the row and the query through
// warp_row_score. A row shared by several queries is loaded once by each.
__global__ void gather_scores_serial_kernel(const void* __restrict__ table,
                                            const float* __restrict__ scales,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ q,
                                            float* __restrict__ out,
                                            long long n_rows, int d, int B, int K,
                                            const int* __restrict__ slot_cat,
                                            const int* __restrict__ qcat) {
  const int lane = threadIdx.x & 31;
  const long long pair =
      static_cast<long long>(blockIdx.x) * kGatherWarps + (threadIdx.x >> 5);
  if (pair >= static_cast<long long>(B) * K) return;
  const int b = static_cast<int>(pair / K);
  const int row = idx[pair];
  bool ok = row >= 0 && row < n_rows;
  if (ok && slot_cat != nullptr) {
    const int qc = qcat[b];
    ok = qc < 0 || slot_cat[row] == qc;
  }
  float s = -INFINITY;
  if (ok)
    s = warp_row_score(table, scales, row, q + static_cast<long long>(b) * d, d, lane);
  if (lane == 0) out[pair] = s;
}

}  // namespace repro_torch

namespace {

int launch_gather(const void* table, const void* scales, const void* idx, const void* q,
                  void* out, long long n_rows, int d, int B, int K, int quant,
                  const void* slot_cat, const void* qcat, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  if (d <= 0 || d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int slot = ((quant ? d : 4 * d) + 15) / 16 * 16;
  const int group = std::min(std::min(kGroupWarps, B), std::max(1, kGatherSlotBytes / slot));
  const int groups = (B + group - 1) / group;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(K), static_cast<unsigned>(groups));
  const GatherArgs a{table,
                     quant ? static_cast<const float*>(scales) : nullptr,
                     static_cast<const int*>(idx),
                     static_cast<const float*>(q),
                     static_cast<float*>(out),
                     static_cast<const int*>(slot_cat),
                     static_cast<const int*>(qcat),
                     n_rows,
                     d,
                     B,
                     K,
                     group,
                     slot};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (slot_cat == nullptr)
    err = quant ? launch_kernel<true, false>(a, grid, s) : launch_kernel<false, false>(a, grid, s);
  else
    err = quant ? launch_kernel<true, true>(a, grid, s) : launch_kernel<false, true>(a, grid, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int gather_scores_launch(const void* table, const void* scales,
                                    const void* idx, const void* q, void* out,
                                    long long n_rows, int d, int B, int K,
                                    int quant, void* stream) {
  return launch_gather(table, scales, idx, q, out, n_rows, d, B, K, quant, nullptr, nullptr,
                       stream);
}

extern "C" int gather_scores_masked_launch(const void* table, const void* scales,
                                           const void* idx, const void* q,
                                           const void* slot_cat, const void* qcat, void* out,
                                           long long n_rows, int d, int B, int K, int quant,
                                           void* stream) {
  return launch_gather(table, scales, idx, q, out, n_rows, d, B, K, quant, slot_cat, qcat,
                       stream);
}

// The earlier design (no path calls it); slot_cat and qcat null = unmasked.
extern "C" int gather_scores_serial_launch(const void* table, const void* scales,
                                           const void* idx, const void* q,
                                           const void* slot_cat, const void* qcat, void* out,
                                           long long n_rows, int d, int B, int K, int quant,
                                           void* stream) {
  using namespace repro_torch;
  const long long pairs = static_cast<long long>(B) * K;
  if (pairs > 0) {
    const unsigned blocks = static_cast<unsigned>((pairs + kGatherWarps - 1) / kGatherWarps);
    gather_scores_serial_kernel<<<blocks, kGatherThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        table, quant ? static_cast<const float*>(scales) : nullptr,
        static_cast<const int*>(idx), static_cast<const float*>(q),
        static_cast<float*>(out), n_rows, d, B, K, static_cast<const int*>(slot_cat),
        static_cast<const int*>(qcat));
  }
  return static_cast<int>(cudaGetLastError());
}
