// flash_attention: tiled GQA prefill attention with causal / sliding-window
// masks, logit softcap and an fp32 online softmax.
// Replaces repro/kernels/flash_attention.py:flash_attention (_flash_kernel).
//
// One block owns kBQ = 32 query rows of one (batch, query head); its 8 warps
// own 4 rows each. The block walks the KV tiles of 32 keys that its rows can
// see (causal: up to the last row's position; window: from the first row's
// window start), staging each tile in shared memory as fp32: K transposed
// (d-major, padded to 33 columns, so lane j reads key j without bank
// conflicts) and V row-major. Per tile, lane j scores key j against the
// warp's 4 rows (q broadcast from shared memory), the warp updates its
// running (m, l) per row, and P·V accumulates into fp32 registers with lane
// l owning output columns l, l + 32, ... . Everything is fp32 FMA: scores,
// probabilities (never rounded) and P·V. A masked key takes no probability
// mass; the output is acc / max(l, 1e-30) in q's dtype. The ragged edges of
// Sq and Skv are masked here, so nothing is padded. Strides are in
// elements, the head dimension contiguous.
#include "attention_common.cuh"

namespace repro_torch {
namespace attn {

constexpr int kFlashWarps = 8;
constexpr int kRows = 4;                       // query rows per warp
constexpr int kBQ = kFlashWarps * kRows;       // query rows per block
constexpr int kBK = 32;                        // keys per tile, one per lane
constexpr int kKStride = kBK + 1;              // padded K^T row

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int Hq, Hkv, Sq, Skv, dh, causal, window, kv_offset;
  float scale, softcap;
};

template <typename T, int NI>
__global__ void __launch_bounds__(kFlashWarps * 32) flash_kernel(FlashParams p) {
  extern __shared__ float smem[];
  const int dh = p.dh;
  float* q_s = smem;                            // [kBQ][dh]
  float* kt_s = q_s + kBQ * dh;                 // [dh][kKStride]
  float* v_s = kt_s + dh * kKStride;            // [kBK][dh]

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int e = tid; e < kBQ * dh; e += blockDim.x) {
    const int r = e / dh, d = e - r * dh;
    q_s[e] = (q0 + r < p.Sq) ? to_f32(Q[(q0 + r) * p.q_ss + d]) : 0.f;
  }

  // The keys any row of this block can see: whole tiles outside are skipped.
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  int kv_end = p.Skv, kv_begin = 0;
  if (p.causal) kv_end = min(kv_end, q_last + p.kv_offset + 1);
  if (p.window > 0) kv_begin = max(0, q0 + p.kv_offset - p.window + 1);

  float m[kRows], l[kRows], acc[kRows][NI];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  }
  const float* q_w = q_s + warp * kRows * dh;

  for (int t0 = kv_begin; t0 < kv_end; t0 += kBK) {
    __syncthreads();                            // the last tile is consumed
    for (int e = tid; e < kBK * dh; e += blockDim.x) {
      const int j = e / dh, d = e - j * dh;
      const bool in = t0 + j < kv_end;
      kt_s[d * kKStride + j] = in ? to_f32(K[(t0 + j) * p.k_ss + d]) : 0.f;
      v_s[e] = in ? to_f32(V[(t0 + j) * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float kd = kt_s[d * kKStride + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = fmaf(q_w[r * dh + d], kd, s[r]);
    }
    const int kpos = t0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r + p.kv_offset;
      float x = s[r] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      bool ok = kpos < kv_end;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && kpos > qpos - p.window;
      const float m_new = fmaxf(m[r], warp_max(ok ? x : kNegInf));
      const float pr = ok ? expf(x - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pr);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] *= alpha;
      s[r] = pr;
    }
    for (int j = 0; j < kBK; ++j) {
      float vv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < dh ? v_s[j * dh + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kAll, s[r], j);
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) store(O + row * p.o_ss + d, acc[r][i] / den);
    }
  }
}

template <typename T, int NI>
cudaError_t launch_flash(const FlashParams& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(p.dh) * (kBQ + kKStride + kBK);
  cudaError_t err = allow_smem(flash_kernel<T, NI>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, B);
  flash_kernel<T, NI><<<grid, kFlashWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(const FlashParams& p, int B, cudaStream_t stream) {
  switch ((p.dh + 31) / 32) {
    case 1: return launch_flash<T, 1>(p, B, stream);
    case 2: return launch_flash<T, 2>(p, B, stream);
    case 3: return launch_flash<T, 3>(p, B, stream);
    case 4: return launch_flash<T, 4>(p, B, stream);
    case 5: return launch_flash<T, 5>(p, B, stream);
    case 6: return launch_flash<T, 6>(p, B, stream);
    case 7: return launch_flash<T, 7>(p, B, stream);
    case 8: return launch_flash<T, 8>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace repro_torch

// strides: 12 element strides, (batch, head, seq) for q, k, v, o in order.
// dtype 0 = fp32, 1 = bf16. window <= 0 and softcap <= 0 mean none.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const long long* strides, int B, int Hq, int Hkv,
                                      int Sq, int Skv, int dh, int causal, int window,
                                      int kv_offset, float scale, float softcap, int dtype,
                                      void* stream) {
  using namespace repro_torch::attn;
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  FlashParams p{q, k, v, o,
                strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
                Hq, Hkv, Sq, Skv, dh, causal, window, kv_offset, scale, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? dispatch_flash<__nv_bfloat16>(p, B, s)
                                     : dispatch_flash<float>(p, B, s);
  return static_cast<int>(err);
}
