// flat_topk: category-masked cosine top-1 over the whole table. Replaces
// repro/kernels/flat_topk.py:flat_topk (_flat_topk_kernel).
//
// Bound on the H100: bytes. Each query of a tile of 8 shares one pass over
// the rows that some query of the tile wants (fp32 d·4 bytes, int8 d bytes
// plus the scale), every row's valid flag, and the category of each valid
// row. At the main path's occupancy (a few thousand valid rows, a prefix
// of the table as FlatIndex fills it) the flags are nearly all of it.
//
// The TPU kernel carried the running best across a sequential grid in VMEM
// scratch; Hopper's blocks run in no order, so this is two passes. Pass 1:
// - Flags 32 rows at a time. Rows go to warps in groups of 32, group g to
//   warp g mod (all warps of the grid), so a table filled from row 0 is
//   spread over the whole grid. A lane loads one row's valid flag (and,
//   only for a valid row, its category) for 8 groups at once and builds
//   the 8-bit mask of the tile's queries that want the row; a ballot picks
//   the wanted rows.
// - Four rows at a time, 8 lanes a row. The warp takes its next 4 wanted
//   rows (in increasing order) and each group of 8 lanes scores one of
//   them: lane l of a group owns the row's float4 chunks l, l+8, ...
//   (int8: 4-byte words). The next 4 rows' loads are in flight while these
//   are scored. The tile's 8 queries sit in shared memory (d ≤ 384;
//   longer rows walk d in slices of 384 and read the queries from global
//   memory), and a query chunk is one broadcast read for the 4 rows. Only the queries that one of the 4 rows
//   wants are multiplied (a warp-uniform branch per query), in fp32 FMA.
//   int8 rows become fp32 exactly with a byte permute and a subtraction,
//   off the slow conversion pipe, and the per-row scale multiplies after
//   the dot.
// - A transposed butterfly sums the 8 queries' partials over the 8 lanes
//   of a group: xor 4, 2 and 1 each halve the queries a lane keeps (4 + 2
//   + 1 shuffles for 4 rows), so lane l ends with query l's score of its
//   group's row and keeps its first best row (strict >, rows in increasing
//   order).
// Why not 32 lanes a row with the 8 queries in registers: at d = 384 they
// take 96 registers a lane, which left 8 warps an SM, and that layout ran
// the int8 scan slower on the H100; 8 lanes a row needs a quarter of the
// shuffles per row and about half the registers (12 to 16 warps an SM).
// The summation order: each lane sums its chunks in order, then the xor
// tree 4, 2, 1 - another order than dot.cuh's 32-lane tree, so the
// scores are no longer the same bits as gather_scores's (the cache never
// compares the two). The block combines its warps' lanes, writes one
// (score, idx) partial per (block, query), and pass 2 reduces the partials
// per query. Order: score descending, then idx ascending - the lowest
// index wins, as on the TPU. When nothing qualifies the result is
// (-inf, -1).
#include <type_traits>

#include "dot.cuh"

namespace repro_torch {
namespace topk {

constexpr int kWarps = 4;          // warps per block
constexpr int kQueryTile = 8;      // queries per block (grid.y tiles B)
constexpr int kLanes = 8;          // lanes per row: a warp scores 4 rows at once
constexpr int kRows = 32 / kLanes;
constexpr int kGroups = 8;         // 32-row groups whose flags a warp loads at once
constexpr int kChunks = 12;        // float4 chunks a lane holds of a row (a slice)
constexpr int kSlice = kLanes * kChunks;  // chunks of a slice: d = 384, the cache's width

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// Four int8 values (one 4-byte word) to fp32, exactly: (b ^ 0x80) = b + 128
// placed in the low byte of 2^23's mantissa reads as 2^23 + b + 128.
__device__ __forceinline__ float4 i8x4_to_f32(unsigned w) {
  const unsigned u = w ^ 0x80808080u;
  constexpr float kBias = 8388736.f;   // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7441)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7442)) - kBias,
                     __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7443)) - kBias);
}

// The wanted rows of one warp's kGroups groups, in increasing order. Group
// u's 8-bit query masks (one per lane's row) sit in byte u % 4 of packed.
struct Stream {
  static_assert(kGroups == 8, "two packed words of 4 groups");
  long long g0, all_warps;
  unsigned packed[2];
  unsigned mine, bits;                           // this group's masks, rows left
  int u;

  __device__ __forceinline__ unsigned masks(int g) const {
    return ((g < 4 ? packed[0] : packed[1]) >> (8 * (g % 4))) & 0xffu;
  }

  __device__ __forceinline__ void start() {
    u = 0;
    mine = masks(0);
    bits = __ballot_sync(kFullMask, mine != 0);
  }

  // The next wanted row and its query mask (mask 0: none left).
  __device__ __forceinline__ void next(int& r, unsigned& mk) {
    while (!bits && u + 1 < kGroups) {
      mine = masks(++u);
      bits = __ballot_sync(kFullMask, mine != 0);
    }
    const int i = bits ? __ffs(bits) - 1 : 0;
    const unsigned m = __shfl_sync(kFullMask, mine, i);
    mk = bits ? m : 0u;
    r = static_cast<int>((g0 + u * all_warps) * 32 + i);
    bits &= bits - 1;
  }
};

// One row per group of 8 lanes (4 rows a warp): this lane's kChunks
// chunks of a slice of its group's row (fp32 float4s, or int8 4-byte
// words), chunk c0 + li + 8k for the lane's index li in its group.
template <bool kQuant>
struct Slot {
  using Word = typename std::conditional<kQuant, unsigned, float4>::type;
  Word w[kChunks];
  int r;                                         // the group's row
  unsigned mk;                                   // its query mask (0: no row)
  float sc;                                      // its int8 scale
  unsigned any;                                  // the warp's rows' masks together

  // The warp's next 4 wanted rows, the g-th to lane group g.
  __device__ __forceinline__ void take(Stream& st, int grp) {
    any = 0;
    mk = 0;
    r = 0;
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      int rt;
      unsigned mt;
      st.next(rt, mt);
      any |= mt;
      if (grp == t) {
        r = rt;
        mk = mt;
      }
    }
  }

  __device__ __forceinline__ void load(const void* table, const float* scales, int d,
                                       int c0, int li) {
    const int d4 = d >> 2;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = c0 + li + kLanes * k;
      const bool on = mk && c < d4;
      if constexpr (kQuant) {
        const unsigned* p = reinterpret_cast<const unsigned*>(
            static_cast<const int8_t*>(table) + static_cast<long long>(r) * d);
        w[k] = on ? p[c] : 0u;
      } else {
        const float4* p = reinterpret_cast<const float4*>(
            static_cast<const float*>(table) + static_cast<long long>(r) * d);
        w[k] = on ? p[c] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    sc = kQuant && mk ? scales[r] : 1.f;
  }

  __device__ __forceinline__ float4 chunk(int k) const {
    if constexpr (kQuant) return i8x4_to_f32(w[k]);
    else return w[k];
  }
};

// Query j's float4 chunk c: from the shared-memory tile, or (d > 384) from
// global memory.
template <bool kSmem>
__device__ __forceinline__ float4 query_chunk(const float4 (*q_s)[kSlice],
                                              const float* q, int q0, int d, int j,
                                              int c) {
  if constexpr (kSmem) {
    return q_s[j][c];
  } else {
    if (c >= (d >> 2)) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* p = q + static_cast<long long>(q0 + j) * d + 4 * c;
    return make_float4(p[0], p[1], p[2], p[3]);
  }
}

// acc[j] += this lane's chunks c0 + li + 8k of its row · query j, for the
// queries some row of the slot wants: one warp-uniform branch per query.
template <bool kQuant, bool kSmem>
__device__ __forceinline__ void accumulate(float (&acc)[kQueryTile],
                                           const Slot<kQuant>& sl,
                                           const float4 (*q_s)[kSlice],
                                           const float* q, int q0, int d, int c0, int li) {
  float4 a[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) a[k] = sl.chunk(k);
#pragma unroll
  for (int j = 0; j < kQueryTile; ++j) {
    if (!(sl.any >> j & 1u)) continue;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const float4 b = query_chunk<kSmem>(q_s, q, q0, d, j, c0 + li + kLanes * k);
      acc[j] = fmaf(a[k].x, b.x, acc[j]);
      acc[j] = fmaf(a[k].y, b.y, acc[j]);
      acc[j] = fmaf(a[k].z, b.z, acc[j]);
      acc[j] = fmaf(a[k].w, b.w, acc[j]);
    }
  }
}

// The 8 queries' sums over a group of 8 lanes: xor 4, 2 and 1 each keep
// half of the queries a lane holds, so lane li ends with query li's sum.
__device__ __forceinline__ float transposed_group_sum(const float (&acc)[kQueryTile],
                                                      int lane) {
  static_assert(kLanes == kQueryTile, "one query per lane of a group");
  float v4[4], v2[2];
  const bool b2 = lane & 4, b1 = lane & 2, b0 = lane & 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float keep = b2 ? acc[j + 4] : acc[j];
    const float send = b2 ? acc[j] : acc[j + 4];
    v4[j] = keep + __shfl_xor_sync(kFullMask, send, 4);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float keep = b1 ? v4[j + 2] : v4[j];
    const float send = b1 ? v4[j] : v4[j + 2];
    v2[j] = keep + __shfl_xor_sync(kFullMask, send, 2);
  }
  return (b0 ? v2[1] : v2[0]) + __shfl_xor_sync(kFullMask, b0 ? v2[0] : v2[1], 1);
}

// kSmem: d ≤ 384, so the queries fit the shared-memory tile and a row is
// one slice.
template <bool kQuant, bool kSmem>
__global__ void __launch_bounds__(32 * kWarps)
flat_topk_partial_kernel(const void* __restrict__ table,
                         const unsigned char* __restrict__ valid,
                         const int* __restrict__ cat, const float* __restrict__ scales,
                         const float* __restrict__ q, const int* __restrict__ qcat,
                         float* __restrict__ part_s, int* __restrict__ part_i,
                         long long n_rows, int d, int B) {
  __shared__ float4 q_s[kSmem ? kQueryTile : 1][kSlice];
  __shared__ float warp_s[kWarps][32];
  __shared__ int warp_i[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int li = lane % kLanes;                  // its index in its group, and the
                                                 // query whose sum it ends with
  const int grp = lane / kLanes;                 // its group: its row of the 4
  const int q0 = blockIdx.y * kQueryTile;
  const int nq = min(kQueryTile, B - q0);
  const int n_slices = ((d >> 2) + kSlice - 1) / kSlice;

  if constexpr (kSmem) {
    for (int i = threadIdx.x; i < kQueryTile * kSlice; i += blockDim.x) {
      const int j = i / kSlice, c = i % kSlice;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < nq && c < (d >> 2)) {
        const float* p = q + static_cast<long long>(q0 + j) * d + 4 * c;
        v = make_float4(p[0], p[1], p[2], p[3]);
      }
      q_s[j][c] = v;
    }
    __syncthreads();
  }
  const unsigned live = (1u << nq) - 1u;
  unsigned wild = 0;
  int qc[kQueryTile];
#pragma unroll
  for (int j = 0; j < kQueryTile; ++j) {
    qc[j] = j < nq ? qcat[q0 + j] : -1;
    if (j < nq && qc[j] < 0) wild |= 1u << j;
  }

  using S = Slot<kQuant>;
  float best_s = -INFINITY;
  int best_i = kInvalid;
  auto track = [&](float v, const S& sl) {
    const float s = kQuant ? v * sl.sc : v;
    if ((sl.mk >> li & 1u) && s > best_s) {
      best_s = s;
      best_i = sl.r;
    }
  };

  const long long n_groups = (n_rows + 31) >> 5;
  Stream st;
  st.all_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (st.g0 = static_cast<long long>(blockIdx.x) * kWarps + warp; st.g0 < n_groups;
       st.g0 += st.all_warps * kGroups) {
    // This lane's row of each of kGroups groups: its valid flag (all loads
    // in flight together), then the category of the valid ones, then the
    // mask of the tile's queries that want it.
    unsigned char v[kGroups];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long r = (st.g0 + u * st.all_warps) * 32 + lane;
      v[u] = r < n_rows ? valid[r] : 0;
    }
    st.packed[0] = st.packed[1] = 0;
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      if (!v[u]) continue;
      const long long r = (st.g0 + u * st.all_warps) * 32 + lane;
      const int rc = cat == nullptr ? -1 : cat[r];
      unsigned m = wild;
#pragma unroll
      for (int j = 0; j < kQueryTile; ++j) m |= static_cast<unsigned>(qc[j] == rc) << j;
      st.packed[u / 4] |= (m & live) << (8 * (u % 4));
    }
    st.start();
    if constexpr (kSmem) {
      // Two slots in turn: one's loads are in flight while the other's rows
      // are scored.
      auto fill = [&](S& sl) {
        sl.take(st, grp);
        sl.load(table, scales, d, 0, li);
      };
      auto score = [&](const S& sl) {
        float acc[kQueryTile] = {};
        accumulate<kQuant, true>(acc, sl, q_s, q, q0, d, 0, li);
        track(transposed_group_sum(acc, lane), sl);
      };
      S sa, sb;
      fill(sa);
      while (sa.any) {
        fill(sb);
        score(sa);
        if (!sb.any) break;
        fill(sa);
        score(sb);
      }
    } else {
      // d > 384: 4 rows at a time, each in slices of kSlice chunks.
      for (;;) {
        S sl;
        sl.take(st, grp);
        if (!sl.any) break;
        float acc[kQueryTile] = {};
        for (int s = 0; s < n_slices; ++s) {
          sl.load(table, scales, d, s * kSlice, li);
          accumulate<kQuant, false>(acc, sl, q_s, q, q0, d, s * kSlice, li);
        }
        track(transposed_group_sum(acc, lane), sl);
      }
    }
  }
  warp_s[warp][lane] = best_s;
  warp_i[warp][lane] = best_i;
  __syncthreads();
  if (threadIdx.x < nq) {
    // query j's bests: lane j of each group of every warp
    const int j = threadIdx.x;
    float bs = -INFINITY;
    int bi = kInvalid;
    for (int w = 0; w < kWarps; ++w)
      for (int g = 0; g < kRows; ++g) {
        const int l = g * kLanes + j;
        if (better(warp_s[w][l], warp_i[w][l], bs, bi)) {
          bs = warp_s[w][l];
          bi = warp_i[w][l];
        }
      }
    const long long o = static_cast<long long>(q0 + j) * gridDim.x + blockIdx.x;
    part_s[o] = bs;
    part_i[o] = bi;
  }
}

// One warp per query: lanes stride over the blocks' partials, then a
// shuffle tree combines them under the same (score desc, idx asc) order.
__global__ void flat_topk_reduce_kernel(const float* __restrict__ part_s,
                                        const int* __restrict__ part_i,
                                        float* __restrict__ out_s,
                                        int* __restrict__ out_i,
                                        int B, int n_parts) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;
  float bs = -INFINITY;
  int bi = kInvalid;
  const long long base = static_cast<long long>(b) * n_parts;
  for (int c = lane; c < n_parts; c += 32)
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

template <bool kQuant, bool kSmem>
void launch_partial(dim3 grid, cudaStream_t s, const void* table, const void* valid,
                    const void* cat, const void* scales, const void* q, const void* qcat,
                    void* part_s, void* part_i, long long n_rows, int d, int B) {
  flat_topk_partial_kernel<kQuant, kSmem><<<grid, 32 * kWarps, 0, s>>>(
      table, static_cast<const unsigned char*>(valid), static_cast<const int*>(cat),
      static_cast<const float*>(scales), static_cast<const float*>(q),
      static_cast<const int*>(qcat), static_cast<float*>(part_s),
      static_cast<int*>(part_i), n_rows, d, B);
}

}  // namespace topk
}  // namespace repro_torch

// n_chunks blocks, one partial each per query; the blocks' rows are
// interleaved in groups of 32, so n_chunks sets the grid, not which rows
// a block reads.
extern "C" int flat_topk_launch(const void* table, const void* valid,
                                const void* cat, const void* scales,
                                const void* q, const void* qcat,
                                void* part_s, void* part_i,
                                void* out_s, void* out_i,
                                long long n_rows, int d, int B, int quant,
                                int n_chunks, void* stream) {
  using namespace repro_torch;
  using namespace repro_torch::topk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(n_chunks, (B + kQueryTile - 1) / kQueryTile);
  // the shared-memory kernel when a row is one slice, else the slice walk
  const bool one_slice = (d >> 2) <= kSlice;
  const auto partial = quant ? (one_slice ? launch_partial<true, true>
                                          : launch_partial<true, false>)
                             : (one_slice ? launch_partial<false, true>
                                          : launch_partial<false, false>);
  partial(grid, s, table, valid, cat, quant ? scales : nullptr, q, qcat, part_s, part_i,
          n_rows, d, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_per_block = 8;
  flat_topk_reduce_kernel<<<(B + warps_per_block - 1) / warps_per_block,
                            32 * warps_per_block, 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), B, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

