// scatter_rows: in-place table[rows[r]] = src[r] for up to 8 tables in one
// launch, the delta flush. Replaces repro/kernels/scatter_update.py:scatter_rows.
//
// Rows are raw bytes: the wrapper views any table as (N, row_bytes), so
// one kernel serves every resident table (fp32 or int8 embeddings, scales,
// neighbor lists, flags, categories, timestamps). A delta flush stages the
// row ids and every table's rows in one packed device buffer (one upload)
// and passes one descriptor per table by value: blockIdx.y picks the
// table, and one thread copies one `word`-sized piece of one row, the
// widest word (16, 8, 4, 2 or 1 bytes) that divides the row and both base
// addresses. There is no device-side pointer array, so the launch can be
// captured in a CUDA graph. Rows out of [0, N) are skipped. Duplicate rows
// carry identical payloads (the bucketing contract), so their racing
// writes store the same bytes.
//
// Bound on the H100: bytes, but a flush moves a few to a few hundred KB,
// so what it costs is launches: one per flush instead of one per table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kMaxTables = 8;
constexpr int kScatterThreads = 256;

struct ScatterTable {
  void* table;
  const void* src;       // R staged rows of row_bytes each
  long long n_rows;
  long long words;       // words per row
  int word;              // bytes per word
};

struct ScatterParams {
  const int* rows;       // (R,) row ids, shared by every table
  long long R;
  ScatterTable t[kMaxTables];
};

template <typename Word>
__device__ __forceinline__ void copy_word(const ScatterTable& s, long long dst, long long src) {
  static_cast<Word*>(s.table)[dst] = static_cast<const Word*>(s.src)[src];
}

__global__ void __launch_bounds__(kScatterThreads)
    scatter_rows_kernel(const __grid_constant__ ScatterParams p) {
  const ScatterTable& s = p.t[blockIdx.y];
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= p.R * s.words) return;
  const long long r = t / s.words;
  const long long row = p.rows[r];
  if (row < 0 || row >= s.n_rows) return;
  const long long dst = row * s.words + (t - r * s.words);
  switch (s.word) {
    case 16: copy_word<uint4>(s, dst, t); break;
    case 8: copy_word<uint2>(s, dst, t); break;
    case 4: copy_word<uint32_t>(s, dst, t); break;
    case 2: copy_word<uint16_t>(s, dst, t); break;
    default: copy_word<uint8_t>(s, dst, t); break;
  }
}

}  // namespace repro_torch

// tables[i], srcs[i], n_rows[i], row_bytes[i] and words[i] (bytes per word)
// describe table i; these are host arrays, copied into the kernel's
// by-value parameters.
extern "C" int scatter_rows_launch(const void* rows, long long R, int n_tables,
                                   void* const* tables, const void* const* srcs,
                                   const long long* n_rows, const long long* row_bytes,
                                   const int* words, void* stream) {
  using namespace repro_torch;
  if (n_tables < 1 || n_tables > kMaxTables) return static_cast<int>(cudaErrorInvalidValue);
  ScatterParams p{};
  p.rows = static_cast<const int*>(rows);
  p.R = R;
  long long most = 0;
  for (int i = 0; i < n_tables; ++i) {
    const int w = words[i];
    if ((w != 1 && w != 2 && w != 4 && w != 8 && w != 16) || row_bytes[i] % w != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    p.t[i] = ScatterTable{tables[i], srcs[i], n_rows[i], row_bytes[i] / w, w};
    if (R * p.t[i].words > most) most = R * p.t[i].words;
  }
  if (most > 0) {
    const dim3 grid(static_cast<unsigned>((most + kScatterThreads - 1) / kScatterThreads),
                    static_cast<unsigned>(n_tables));
    scatter_rows_kernel<<<grid, kScatterThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
