// scatter_rows: in-place table[rows[r]] = vals[r], the delta flush.
// Replaces repro/kernels/scatter_update.py:scatter_rows.
//
// Rows are raw bytes: the wrapper views any table as (N, row_bytes), so
// one kernel serves every resident table (fp32 or int8 embeddings, scales,
// neighbor lists, flags, categories, timestamps). One thread copies one
// `Word`-sized piece of one row; the wrapper picks the widest word (16, 8,
// 4, 2 or 1 bytes) that divides the row and both base addresses. Rows out
// of [0, N) are skipped. Duplicate rows carry identical payloads (the
// bucketing contract), so their racing writes store the same bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

template <typename Word>
__global__ void scatter_rows_kernel(Word* __restrict__ table,
                                    const int* __restrict__ rows,
                                    const Word* __restrict__ vals,
                                    long long n_rows, long long R,
                                    long long words_per_row) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= R * words_per_row) return;
  const long long r = t / words_per_row;
  const long long w = t - r * words_per_row;
  const long long row = rows[r];
  if (row < 0 || row >= n_rows) return;
  table[row * words_per_row + w] = vals[t];
}

template <typename Word>
void launch(void* table, const void* rows, const void* vals, long long n_rows,
            long long R, long long row_bytes, cudaStream_t s) {
  const long long words = row_bytes / static_cast<long long>(sizeof(Word));
  const long long total = R * words;
  if (total <= 0) return;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  scatter_rows_kernel<Word><<<blocks, threads, 0, s>>>(
      static_cast<Word*>(table), static_cast<const int*>(rows),
      static_cast<const Word*>(vals), n_rows, R, words);
}

}  // namespace repro_torch

extern "C" int scatter_rows_launch(void* table, const void* rows, const void* vals,
                                   long long n_rows, long long R, long long row_bytes,
                                   int word_bytes, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 16: launch<uint4>(table, rows, vals, n_rows, R, row_bytes, s); break;
    case 8: launch<uint2>(table, rows, vals, n_rows, R, row_bytes, s); break;
    case 4: launch<uint32_t>(table, rows, vals, n_rows, R, row_bytes, s); break;
    case 2: launch<uint16_t>(table, rows, vals, n_rows, R, row_bytes, s); break;
    case 1: launch<uint8_t>(table, rows, vals, n_rows, R, row_bytes, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
