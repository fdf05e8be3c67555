// The MoE FFN's glue around its three grouped products, one kernel per
// step: routing (moe_route), the stable sort of the (token, choice) pairs
// by expert with the gather of their rows (moe_dispatch), silu(g) * u
// (swiglu_cast) and the weighted combine back to tokens (moe_combine).
// Replaces no TPU kernel: the reference leaves routing, its argsort, the
// gathers and the combine to XLA around lax.ragged_dot. On the card the same
// steps as PyTorch ops were ~40 launches a layer, each a few microseconds of
// work at a decode step's 8 tokens; inside a captured decode graph they were
// two thirds of the MoE layer's time (models/moe.py).
//
// Bound on the H100: launches and latency. At a decode step (T 8, granite's
// d 1,536, E 40, k 8) the four move ~0.9 MB together (the fp32 router
// 245 KB, 64 gathered rows, g, u and the hidden, the down rows), under a
// third of a microsecond at 3.35 TB/s; at a prefill of 8 x 64 (T 512)
// ~42 MB, ~13 us. So each kernel is one launch with no host sync and static
// shapes (a CUDA graph captures it), enough blocks to spread its bytes over
// the SMs, and no atomics on device memory: every sum runs in a fixed order.
//
// moe_route: logits x . router in fp32 FMAs. A cluster of 8 blocks takes a
//   few tokens, each block an eighth of d (an eighth of the router, 30 KB at
//   granite's width, so no SM streams the whole router), each thread a
//   strided slice of its rows for one expert; the slices are summed in
//   order in the block, and block 0 sums the blocks' partials in rank order
//   from their shared memory (distributed shared memory, no trip through
//   device memory). Each (token, expert) so sums in one fixed order and a
//   token's logits do not depend on its batch. Then, in block 0, softmax,
//   each expert's place among its token's (probability descending, expert
//   ascending: ties go to the lower expert, as a stable descending sort
//   has them) with a thread per (token, expert), the first k taken and
//   their weights renormalised (renorm 1), or left as the k probabilities
//   (renorm 0: Jamba's router). Every step is a few hundred cycles deep:
//   at a decode step the kernel is latency, not bytes or operations.
// moe_dispatch: a stable counting sort. Each block counts every pair's
//   expert (shared-memory counters, one add per expert per warp), scans the
//   counts into the cumulative ends (offs), ranks its own 32 pairs among
//   equal experts with __match_any_sync, writes their sorted positions
//   (order) and copies their rows of x. The counting is repeated in every
//   block (T·k ids, 16 KB at a prefill) so that one launch does it all.
//   Where the caller passes a counter, block (0, 0)'s first warp adds the
//   number of experts with pairs to it: one add by one thread a launch, so
//   the launches of a stream add in their order and no atomic is needed.
// swiglu_cast: bf16 g and u, silu(g) * u in fp32 (torch's silu formula),
//   rounded to bf16; 8 elements a thread.
// moe_combine: each block takes a few tokens, finds their k rows in the
//   sorted down product by scanning order (the inverse permutation of its
//   tokens, in shared memory), and sums the k weighted rows in fp32 in the
//   order torch's sum over them takes (each product rounded before the add,
//   as the op chain does), so an output that cancels to near 0 rounds alike.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {
namespace moe {

using attn::kAll;
using attn::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxExperts = 512;
constexpr int kMaxTopK = 16;
constexpr int kRouteTokens = 8;    // tokens a routing cluster at most: one warp each
constexpr int kRouteChunk = 256;   // router rows (x columns) staged a pass at most
constexpr int kRouteStage = 8192;  // fp32 router elements staged a pass
constexpr int kCluster = 8;        // blocks of a routing cluster: each an eighth of d
constexpr int kSegment = 32;       // pairs a dispatch block ranks: one warp
constexpr int kCombineTokens = 8;  // tokens a combine block at most

// ------------------------------------------------------------- moe_route

// A barrier of the cluster's threads that orders their shared-memory
// writes before the reads after it (release / acquire at cluster scope;
// cooperative groups' sync adds a GPU-wide fence and an L1 invalidate).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename X, typename W>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    moe_route_kernel(const X* __restrict__ x, const W* __restrict__ w, int* __restrict__ ids,
                     float* __restrict__ weights, int T, int d, int E, int k, int tb,
                     int renorm) {
  __shared__ float xs[kRouteTokens * kRouteChunk];
  __shared__ float ws[kRouteStage];   // a chunk of router rows; then the partials
  float* part = ws;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int t0 = (blockIdx.x / kCluster) * tb;
  const int ntok = min(tb, T - t0);
  // This block's rows of the router: one kCluster-th of d, staged in
  // chunks of rows that fill ws (one chunk at granite's and jamba's E).
  const int dc = (d + kCluster - 1) / kCluster;
  const int r0 = min(d, rank * dc), r1 = min(d, r0 + dc);
  const int rows = min(kRouteChunk, kRouteStage / E);
  // A thread sums expert e0 (and e0 + 256 where E > 256) over the rows
  // s, s + S, ... of each chunk; E <= 256 spreads S = 256 / E slices of the
  // rows over the block.
  int S, s, e0;
  if (E <= kThreads) {
    S = kThreads / E;
    s = tid / E;
    e0 = tid % E;
  } else {
    S = 1;
    s = 0;
    e0 = tid;
  }
  const bool active = s < S;
  // Two interleaved sums of a thread's rows (u = its row's index / S mod
  // 2), so two rows' products are in flight at once.
  float acc[2][2][kRouteTokens];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int t = 0; t < kRouteTokens; ++t) acc[u][m][t] = 0.f;

  for (int c0 = r0; c0 < r1; c0 += rows) {
    const int len = min(rows, r1 - c0);
    __syncthreads();
    // Every load of the chunk (router rows and x columns) in flight at
    // once, then stored to shared memory as fp32.
    constexpr int kW = kRouteStage / kThreads, kX = kRouteTokens * kRouteChunk / kThreads;
    const W* src = w + static_cast<size_t>(c0) * E;
    const int nw = len * E, nx = ntok * len;
    float wv[kW], xv[kX];
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const int idx = tid + j * kThreads;
      wv[j] = idx < nw ? to_f32(src[idx]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kX; ++j) {
      const int idx = tid + j * kThreads;
      const int t = idx / len;
      xv[j] = idx < nx ? to_f32(x[static_cast<size_t>(t0 + t) * d + c0 + idx - t * len]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kW; ++j)
      if (tid + j * kThreads < nw) ws[tid + j * kThreads] = wv[j];
#pragma unroll
    for (int j = 0; j < kX; ++j) {
      const int idx = tid + j * kThreads;
      const int t = idx / len;
      if (idx < nx) xs[t * kRouteChunk + idx - t * len] = xv[j];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = s; i < len; i += 2 * S) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int iu = i + u * S;
        if (iu < len) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int e = e0 + m * kThreads;
            if (e < E) {
              const float w_ie = ws[iu * E + e];
#pragma unroll
              for (int t = 0; t < kRouteTokens; ++t)
                if (t < ntok) acc[u][m][t] = fmaf(xs[t * kRouteChunk + iu], w_ie, acc[u][m][t]);
            }
          }
        }
      }
    }
  }
  __syncthreads();   // part overwrites the staged rows
  if (active) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int e = e0 + m * kThreads;
      if (e < E)
#pragma unroll
        for (int t = 0; t < kRouteTokens; ++t)
          if (t < ntok)
            part[(s * kRouteTokens + t) * E + e] = acc[0][m][t] + acc[1][m][t];
    }
  }
  __syncthreads();
  // This block's partial logits, the slices summed in order, into slice 0.
  for (int idx = tid; idx < ntok * E; idx += kThreads) {
    const int t = idx / E, e = idx - t * E;
    float l = part[t * E + e];
    for (int q = 1; q < S; ++q) l += part[(q * kRouteTokens + t) * E + e];
    part[t * E + e] = l;
  }
  cluster_sync();

  // Block 0 of the cluster: the blocks' partials summed in rank order (read
  // from their shared memory), then softmax and top-k with a thread for
  // each (token, expert), so no step is a chain of k rounds.
  float* prob = ws + kRouteStage / 2;   // (ntok, E): beyond the partials
  __shared__ float mx_s[kRouteTokens], sum_s[kRouteTokens];
  __shared__ int sel[kRouteTokens * kMaxTopK];
  if (rank == 0) {
    for (int idx = tid; idx < ntok * E; idx += kThreads) {
      float l = 0.f;
      for (int r = 0; r < kCluster; ++r) l += cluster.map_shared_rank(part, r)[idx];
      prob[idx] = l;
    }
  }
  cluster_sync();   // every block's partials stay until block 0 has read them
  if (rank != 0) return;
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < ntok) {   // a warp per token: max, then the sum of exps
    const float* lg = prob + warp * E;
    float mx = -INFINITY;
    for (int e = lane; e < E; e += 32) mx = fmaxf(mx, lg[e]);
    mx = attn::warp_max(mx);
    float sum = 0.f;
    for (int e = lane; e < E; e += 32) sum += expf(lg[e] - mx);
    sum = attn::warp_sum(sum);
    if (lane == 0) {
      mx_s[warp] = mx;
      sum_s[warp] = sum;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < ntok * E; idx += kThreads) {
    const int t = idx / E;
    prob[idx] = expf(prob[idx] - mx_s[t]) / sum_s[t];
  }
  __syncthreads();
  // An expert's place: the experts of higher probability, or of equal
  // probability and a lower index, before it (a stable descending sort).
  for (int idx = tid; idx < ntok * E; idx += kThreads) {
    const int t = idx / E, e = idx - t * E;
    const float* pt = prob + t * E;
    const float p = pt[e];
    int place = 0;
    for (int q = 0; q < E; ++q) {
      const float o = pt[q];
      place += (o > p) || (o == p && q < e);
    }
    if (place < k) sel[t * k + place] = e;
  }
  __syncthreads();
  for (int idx = tid; idx < ntok * k; idx += kThreads) {
    const int t = idx / k;
    const float* pt = prob + t * E;
    const size_t o = static_cast<size_t>(t0) * k + idx;
    ids[o] = sel[idx];
    if (renorm) {
      float total = 0.f;
      for (int q = 0; q < k; ++q) total += pt[sel[t * k + q]];
      weights[o] = pt[sel[idx]] / fmaxf(total, 1e-9f);
    } else {
      weights[o] = pt[sel[idx]];
    }
  }
}

// ---------------------------------------------------------- moe_dispatch

// Rows travel as 16-byte words (``vec`` a row), whatever their dtype.
__global__ void __launch_bounds__(kThreads)
    moe_dispatch_kernel(const int* __restrict__ ids, const uint4* __restrict__ x,
                        int* __restrict__ order, int* __restrict__ offs,
                        uint4* __restrict__ rows, int N, int k, int E, int vec,
                        int cols_per_block, int* __restrict__ count) {
  __shared__ int total[kMaxExperts];
  __shared__ int first[kMaxExperts];   // pairs of the expert before this segment, then its start
  __shared__ int pos_s[kSegment];
  __shared__ int src_s[kSegment];
  const int tid = threadIdx.x, lane = tid & 31;
  const int seg0 = blockIdx.x * kSegment;
  for (int e = tid; e < E; e += kThreads) total[e] = first[e] = 0;
  __syncthreads();
  // A warp's 32 pairs lie all before this segment or none (both are
  // 32-aligned), so one add per expert per warp counts both.
  for (int base = 0; base < N; base += kThreads) {
    const int j = base + tid;
    const int e = j < N ? ids[j] : -1;
    const bool valid = j < N && e >= 0 && e < E;
    const unsigned peers = __match_any_sync(kAll, valid ? e : -1);
    if (valid && lane == __ffs(peers) - 1) {
      const int n = __popc(peers);
      atomicAdd(&total[e], n);
      if (j - lane < seg0) atomicAdd(&first[e], n);
    }
  }
  __syncthreads();
  if (tid < 32) {   // exclusive scan of the counts; the cumulative ends are offs
    int carry = 0, reached = 0;
    for (int base = 0; base < E; base += 32) {
      const int e = base + lane;
      const int c = e < E ? total[e] : 0;
      reached += c > 0;
      int inc = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kAll, inc, off);
        if (lane >= off) inc += v;
      }
      if (e < E) {
        first[e] += carry + inc - c;
        if (blockIdx.x == 0 && blockIdx.y == 0) offs[e] = carry + inc;
      }
      carry += __shfl_sync(kAll, inc, 31);
    }
    reached = __reduce_add_sync(kAll, reached);
    if (count != nullptr && lane == 0 && blockIdx.x == 0 && blockIdx.y == 0) *count += reached;
    const int j = seg0 + lane;
    const int e = j < N ? ids[j] : -1;
    const bool valid = j < N && e >= 0 && e < E;
    const unsigned peers = __match_any_sync(kAll, valid ? e : -1 - lane);
    const int pos = valid ? first[e] + __popc(peers & ((1u << lane) - 1u)) : -1;
    pos_s[lane] = pos;
    src_s[lane] = valid ? j / k : 0;
    if (valid && blockIdx.y == 0) order[pos] = j;
  }
  __syncthreads();
  const int c0 = blockIdx.y * cols_per_block;
  const int width = min(vec, c0 + cols_per_block) - c0;
  const int nrows = min(kSegment, N - seg0);
  for (int idx = tid; idx < nrows * width; idx += kThreads) {
    const int r = idx / width, c = c0 + idx - r * width;
    const int p = pos_s[r];
    if (p >= 0) rows[static_cast<size_t>(p) * vec + c] = x[static_cast<size_t>(src_s[r]) * vec + c];
  }
}

// ----------------------------------------------------------- swiglu_cast

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__global__ void __launch_bounds__(kThreads)
    swiglu_cast_kernel(const uint4* __restrict__ g, const uint4* __restrict__ u,
                       uint4* __restrict__ h, long long n_vec) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  float gf[8], uf[8], hf[8];
  attn::unpack16(g[i], gf, __nv_bfloat16());
  attn::unpack16(u[i], uf, __nv_bfloat16());
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float silu = gf[q] / (1.0f + expf(-gf[q]));   // torch's silu
    hf[q] = __fmul_rn(silu, uf[q]);
  }
  h[i] = make_uint4(pack_bf16(hf[0], hf[1]), pack_bf16(hf[2], hf[3]),
                    pack_bf16(hf[4], hf[5]), pack_bf16(hf[6], hf[7]));
}

// ----------------------------------------------------------- moe_combine

__global__ void __launch_bounds__(kThreads)
    moe_combine_kernel(const uint4* __restrict__ part, const int* __restrict__ order,
                       const float* __restrict__ weights, uint4* __restrict__ y, int T,
                       int N, int k, int vec, int tb, int cols_per_block) {
  __shared__ int src[kCombineTokens * kMaxTopK];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * tb;
  const int ntok = min(tb, T - t0);
  for (int i = tid; i < N; i += kThreads) {   // the inverse of order, for these tokens
    const int j = order[i];
    const int t = j / k - t0;
    if (t >= 0 && t < ntok) src[t * k + (j - (j / k) * k)] = i;
  }
  __syncthreads();
  const int c0 = blockIdx.y * cols_per_block;
  const int width = min(vec, c0 + cols_per_block) - c0;
  for (int idx = tid; idx < ntok * width; idx += kThreads) {
    const int t = idx / width, c = c0 + idx - t * width;
    // torch's sum over the k choices: choice q into accumulator q % 4,
    // then ((a0 + a1) + a2) + a3 (Reduce.cuh's vt0 = 4 accumulators).
    float acc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[a][r] = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxTopK; ++q) {
      if (q < k) {
        const float wv = weights[static_cast<size_t>(t0 + t) * k + q];
        float v[8];
        attn::unpack16(part[static_cast<size_t>(src[t * k + q]) * vec + c], v, __nv_bfloat16());
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[q & 3][r] = __fadd_rn(acc[q & 3][r], __fmul_rn(v[r], wv));
      }
    }
    float o[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      o[r] = __fadd_rn(__fadd_rn(__fadd_rn(acc[0][r], acc[1][r]), acc[2][r]), acc[3][r]);
    y[static_cast<size_t>(t0 + t) * vec + c] =
        make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]),
                   pack_bf16(o[6], o[7]));
  }
}

template <typename X, typename W>
cudaError_t launch_route(const void* x, const void* w, void* ids, void* weights, int T, int d,
                         int E, int k, int tb, int renorm, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((T + tb - 1) / tb * kCluster);
  moe_route_kernel<X, W><<<blocks, kThreads, 0, s>>>(
      static_cast<const X*>(x), static_cast<const W*>(w), static_cast<int*>(ids),
      static_cast<float*>(weights), T, d, E, k, tb, renorm);
  return cudaGetLastError();
}

}  // namespace moe
}  // namespace repro_torch

// x (T, d) and the router (d, E): dtype 0 fp32, 1 bf16 each. ids (T, k)
// int32, weights (T, k) fp32. tb tokens a block (1..8). renorm 1: the k
// weights divided by their sum; 0: the k probabilities.
extern "C" int moe_route_launch(const void* x, const void* w, void* ids, void* weights, int T,
                                int d, int E, int k, int x_dtype, int w_dtype, int tb,
                                int renorm, void* stream) {
  using namespace repro_torch::moe;
  if (E < 1 || E > kMaxExperts || k < 1 || k > kMaxTopK || k > E || tb < 1 ||
      tb > kRouteTokens)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 1)
    err = w_dtype == 1 ? launch_route<__nv_bfloat16, __nv_bfloat16>(x, w, ids, weights, T, d, E, k, tb, renorm, s)
                       : launch_route<__nv_bfloat16, float>(x, w, ids, weights, T, d, E, k, tb, renorm, s);
  else
    err = w_dtype == 1 ? launch_route<float, __nv_bfloat16>(x, w, ids, weights, T, d, E, k, tb, renorm, s)
                       : launch_route<float, float>(x, w, ids, weights, T, d, E, k, tb, renorm, s);
  return static_cast<int>(err);
}

// ids (N = T·k,) int32 in [0, E); x (T, vec) 16-byte words. order (N,),
// offs (E,) int32; rows (N, vec). n_col column blocks a segment. count:
// null, or one int32 that gains the number of experts with pairs.
extern "C" int moe_dispatch_launch(const void* ids, const void* x, void* order, void* offs,
                                   void* rows, int N, int k, int E, int vec, int n_col,
                                   void* count, void* stream) {
  using namespace repro_torch::moe;
  if (E < 1 || E > kMaxExperts || k < 1 || vec < 1 || n_col < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const int cols = (vec + n_col - 1) / n_col;
  const dim3 grid(static_cast<unsigned>((N + kSegment - 1) / kSegment),
                  static_cast<unsigned>((vec + cols - 1) / cols));
  moe_dispatch_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const uint4*>(x), static_cast<int*>(order),
      static_cast<int*>(offs), static_cast<uint4*>(rows), N, k, E, vec, cols,
      static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

// g, u, h: n_vec 16-byte words of bf16 (8 elements each).
extern "C" int swiglu_cast_launch(const void* g, const void* u, void* h, long long n_vec,
                                  void* stream) {
  using namespace repro_torch::moe;
  if (n_vec == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((n_vec + kThreads - 1) / kThreads);
  swiglu_cast_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(g), static_cast<const uint4*>(u), static_cast<uint4*>(h), n_vec);
  return static_cast<int>(cudaGetLastError());
}

// part (N, vec) bf16 in sorted order, order (N,) int32, weights (T, k) fp32
// -> y (T, vec) bf16. tb tokens a block (1..8), n_col column blocks.
extern "C" int moe_combine_launch(const void* part, const void* order, const void* weights,
                                  void* y, int T, int N, int k, int vec, int tb, int n_col,
                                  void* stream) {
  using namespace repro_torch::moe;
  if (k < 1 || k > kMaxTopK || tb < 1 || tb > kCombineTokens || vec < 1 || n_col < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  const int cols = (vec + n_col - 1) / n_col;
  const dim3 grid(static_cast<unsigned>((T + tb - 1) / tb),
                  static_cast<unsigned>((vec + cols - 1) / cols));
  moe_combine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(part), static_cast<const int*>(order),
      static_cast<const float*>(weights), static_cast<uint4*>(y), T, N, k, vec, tb, cols);
  return static_cast<int>(cudaGetLastError());
}
