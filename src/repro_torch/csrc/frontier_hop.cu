// frontier_hop: one fused HNSW beam expansion. Replaces
// repro/kernels/frontier_hop.py:frontier_hop.
//
// One block of 8 warps per (b, f) frontier lane. The TPU kernel started
// every live candidate's row DMA back to back and then waited for all of
// them; this kernel does the same with Hopper's bulk copy engine:
//
// - Front end. Each thread reads its entry of the neighbor row
//   neighbors[frontier[b,f], 0:M] (warp w takes w, w + 8, ..., the
//   candidates it will score), starts one
//   cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes copy
//   of its live candidate's row into a shared-memory slot of its own, and
//   only then gathers the candidate's meta word (and int8 scale) and its
//   slice of the query row. Every thread then arrives on the barrier with
//   expect_tx = the bytes it started (0 for none): the tx-count may run below
//   zero until then, so no copy waits for the count, and the arrival
//   (release) publishes the thread's shared-memory writes to the waiters
//   (acquire), so no block barrier stands between the copies and the scores.
//   No thread waits before every copy of the first stage is started.
// - Scoring. Each warp scores candidates m, m + 8, ... from shared memory
//   with the lane_dot_* + warp_sum of dot.cuh, so its scores are
//   bit-identical to gather_scores'. Outputs are staged in shared memory
//   and written as one coalesced store per output.
// - Stages. When M rows exceed the wrapper's 48 KB row budget (fp32 d
//   1,024 with M 64 is 256 KB), the block walks its candidates in chunks
//   through a ring of two buffers on two mbarriers: chunk c uses buffer
//   c % 2 and waits on phase parity (c / 2) % 2 of its barrier, and chunk
//   c + 2 is started once every warp is done with chunk c. The wrapper
//   computes the plan (kernels/frontier_hop.py:_stage_plan).
// - Rows that are not 16-byte multiples (int8 with d % 16 != 0) take 4-byte
//   cp.async copies by every thread instead, each thread arriving on the
//   same mbarrier with cp.async.mbarrier.arrive.noinc.
//
// A dead lane (INVALID frontier or neighbor id, or a done query) starts no
// copy and emits INVALID / -inf; a done query's block loads no row at all.
// Routing scores mask only dead lanes; result scores also mask
// meta == TOMBSTONE and other categories (query category < 0 is a
// wildcard). Outputs are (B, F*M), position f*M + m.
//
// Bound on the H100: bytes (each live row once). A warp that walks its
// candidates one after another pays a chain of dependent loads for each
// (neighbor id, then the row, then meta, then the store); here a lane pays
// about three dependent latencies in all: frontier id, neighbor id, then
// the copies and the meta gather in parallel. At the main path's shape
// (fp32, d 384, M 32) a block holds 48 KB of rows and 1.5 KB of query, so
// four blocks share an SM and B=8, F=32 runs in one wave. Every row is
// one bulk copy, so an SM's copies of a hop (about 50 rows) go through
// its one copy engine in turn (PERF.md §6 has what that costs).
#include "dot.cuh"

namespace repro_torch {

constexpr int kHopWarps = 8;
constexpr int kHopThreads = 32 * kHopWarps;
constexpr int kHopSmemLimit = 232448;  // a block's dynamic shared memory on sm_90

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Byte offsets into the block's dynamic shared memory;
// kernels/frontier_hop.py:_stage_plan computes the same total.
struct HopLayout {
  int q, rows, cand, meta, scale, route, res, total;
  __host__ __device__ HopLayout(int d, int M, int slot, int chunk, int n_chunks) {
    q = 16;                                  // two mbarriers at offset 0
    rows = q + round16(d * 4);
    cand = rows + (n_chunks > 1 ? 2 : 1) * chunk * slot;
    meta = cand + 4 * M;
    scale = meta + 4 * M;
    route = scale + 4 * M;
    res = route + 4 * M;
    total = res + 4 * M;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Arrive on `bar`, adding `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that outlasts
// 2^32 cycles (seconds) traps, so a wrong byte count reports a launch
// error instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void word_copy(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void word_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

struct HopArgs {
  const void* emb;
  const float* scales;  // nullptr: fp32 rows
  const int* neighbors;
  const int* meta;
  const int* frontier;
  const float* q;
  const int* qcat;
  const int* done;
  int* ids_out;
  float* route_out;
  float* res_out;
  long long n_rows;
  int d, M, F, row_bytes, slot, chunk, n_chunks, bulk;
};

__global__ void __launch_bounds__(kHopThreads)
    frontier_hop_kernel(const __grid_constant__ HopArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const HopLayout L(a.d, a.M, a.slot, a.chunk, a.n_chunks);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  unsigned char* rows_s = smem + L.rows;
  int* cand_s = reinterpret_cast<int*>(smem + L.cand);
  int* meta_s = reinterpret_cast<int*>(smem + L.meta);
  float* scale_s = reinterpret_cast<float*>(smem + L.scale);
  float* route_s = reinterpret_cast<float*>(smem + L.route);
  float* res_s = reinterpret_cast<float*>(smem + L.res);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = a.M, chunk = a.chunk;
  const int b = blockIdx.x / a.F;
  const long long out_base = static_cast<long long>(blockIdx.x) * M;
  const int fid = a.frontier[blockIdx.x];
  const int done = a.done[b];
  if (tid == 0) {  // every thread arrives once a stage, in either copy mode
    bar_init(&bars[0], kHopThreads);
    bar_init(&bars[1], kHopThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (fid < 0 || fid >= a.n_rows || done != 0) {  // dead lane: no row loads
    for (int m = tid; m < M; m += kHopThreads) {
      a.ids_out[out_base + m] = kInvalid;
      a.route_out[out_base + m] = -INFINITY;
      a.res_out[out_base + m] = -INFINITY;
    }
    return;
  }
  const unsigned char* emb = static_cast<const unsigned char*>(a.emb);
  auto slot_ptr = [&](int c, int j) {
    return rows_s + static_cast<long long>((c & 1) * chunk + j) * a.slot;
  };
  auto row_src = [&](int cid) { return emb + static_cast<long long>(cid) * a.row_bytes; };

  // Front end: the bulk copies of each thread's live candidates in the
  // first two chunks, then their meta words and scales and the query row
  // while the copies are in flight, then one arrival a thread on each
  // first-stage barrier with the bytes it started there. Candidates are
  // dealt to warps as they are scored (warp w: w, w + 8, ...), so every
  // warp starts a few copies instead of one warp starting them all.
  const int* nrow = a.neighbors + static_cast<long long>(fid) * M;
  unsigned sent0 = 0, sent1 = 0;  // bytes this thread started per stage
  for (int base = 0; base < M; base += kHopThreads) {
    const int m = base + warp + kHopWarps * lane;  // warp w owns w, w + 8, ...
    if (m >= M) continue;
    int cid = nrow[m];
    route_s[m] = -INFINITY;
    res_s[m] = -INFINITY;
    if (cid < 0 || cid >= a.n_rows) cid = kInvalid;
    cand_s[m] = cid;
    if (cid < 0) continue;
    const int c = m / chunk;
    if (a.bulk && c < 2) {
      bulk_copy(slot_ptr(c, m - c * chunk), row_src(cid), a.row_bytes, &bars[c]);
      (c == 0 ? sent0 : sent1) += a.row_bytes;
    }
    meta_s[m] = a.meta[cid];
    if (a.scales != nullptr) scale_s[m] = a.scales[cid];
  }
  const float* qb = a.q + static_cast<long long>(b) * a.d;
  for (int i = tid; i < a.d; i += kHopThreads) q_s[i] = qb[i];

  // Word mode (rows that are not 16-byte multiples): every thread copies
  // 4-byte words of the chunk's live rows and arrives on the chunk's
  // barrier once its own copies have landed.
  auto stage_words = [&](int c) {
    const int lo = c * chunk, len = min(M - lo, chunk), words = a.row_bytes >> 2;
    for (int i = tid; i < len * words; i += kHopThreads) {
      const int j = i / words, w = i - j * words;
      const int cid = cand_s[lo + j];
      if (cid >= 0) word_copy(slot_ptr(c, j) + 4 * w, row_src(cid) + 4 * w);
    }
    word_arrive(&bars[c & 1]);
  };
  if (a.bulk) {
    bar_arrive_tx(&bars[0], sent0);
    if (a.n_chunks > 1) bar_arrive_tx(&bars[1], sent1);
  } else {
    __syncthreads();  // every candidate id is in shared memory
    for (int c = 0; c < min(a.n_chunks, 2); ++c) stage_words(c);
  }

  const int qc = a.qcat[b];
  for (int c = 0; c < a.n_chunks; ++c) {
    bar_wait(&bars[c & 1], (c >> 1) & 1);
    const int lo = c * chunk, hi = min(M, lo + chunk);
    for (int m = lo + warp; m < hi; m += kHopWarps) {
      if (cand_s[m] < 0) continue;
      const unsigned char* row = slot_ptr(c, m - lo);
      const float s =
          a.scales == nullptr
              ? warp_sum(lane_dot_f32(reinterpret_cast<const float*>(row), q_s, a.d, lane))
              : warp_sum(lane_dot_i8(reinterpret_cast<const int8_t*>(row), q_s, a.d, lane)) *
                    scale_s[m];
      if (lane == 0) {
        const int mw = meta_s[m];
        route_s[m] = s;
        res_s[m] = (mw != kTombstone && (qc < 0 || mw == qc)) ? s : -INFINITY;
      }
    }
    const int next = c + 2;
    if (next < a.n_chunks) {
      __syncthreads();  // every warp is done with buffer c % 2
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (!a.bulk) {
        stage_words(next);
      } else {
        const int nlo = next * chunk, len = min(M - nlo, chunk);
        unsigned bytes = 0;
        for (int j = tid; j < len; j += kHopThreads) {
          const int cid = cand_s[nlo + j];
          if (cid < 0) continue;
          bulk_copy(slot_ptr(next, j), row_src(cid), a.row_bytes, &bars[c & 1]);
          bytes += a.row_bytes;
        }
        bar_arrive_tx(&bars[c & 1], bytes);
      }
    }
  }
  __syncthreads();
  for (int m = tid; m < M; m += kHopThreads) {
    a.ids_out[out_base + m] = cand_s[m];
    a.route_out[out_base + m] = route_s[m];
    a.res_out[out_base + m] = res_s[m];
  }
}

}  // namespace repro_torch

extern "C" int frontier_hop_launch(const void* emb, const void* scales,
                                   const void* neighbors, const void* meta,
                                   const void* frontier, const void* q,
                                   const void* qcat, const void* done,
                                   void* ids, void* route, void* res,
                                   long long n_rows, int d, int M, int B, int F,
                                   int quant, int chunk, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || F <= 0 || M <= 0) return static_cast<int>(cudaGetLastError());
  const int row_bytes = quant ? d : 4 * d;
  if (chunk <= 0 || row_bytes % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (M + chunk - 1) / chunk;
  const int slot = round16(row_bytes);
  const HopLayout L(d, M, slot, chunk, n_chunks);
  if (L.total > kHopSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // Raise the kernel's dynamic shared-memory ceiling once per size seen.
  static int allowed = 48 * 1024;
  if (L.total > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        frontier_hop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = L.total;
  }
  HopArgs a{emb,
            quant ? static_cast<const float*>(scales) : nullptr,
            static_cast<const int*>(neighbors),
            static_cast<const int*>(meta),
            static_cast<const int*>(frontier),
            static_cast<const float*>(q),
            static_cast<const int*>(qcat),
            static_cast<const int*>(done),
            static_cast<int*>(ids),
            static_cast<float*>(route),
            static_cast<float*>(res),
            n_rows,
            d,
            M,
            F,
            row_bytes,
            slot,
            chunk,
            n_chunks,
            row_bytes % 16 == 0 ? 1 : 0};
  frontier_hop_kernel<<<B * F, kHopThreads, L.total, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
