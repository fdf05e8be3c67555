// decode_attention: one new token per sequence against a ragged KV cache,
// GQA, optional logit softcap and sliding window, fp32 online softmax.
// Replaces repro/kernels/decode_attention.py: decode_attention
// (_decode_kernel), which has no window; the window is the one the model's
// attend_decode masks (gemma2's local layers).
//
// Bound on the H100: bytes (each live K/V row is read once, ~4 flops a
// byte). At decode_32k (8 sequences of up to 32,768 rows) one block per
// (sequence, KV head) would be 64 blocks on 132 SMs, the longest walking
// 32,768 rows alone; so the rows are split across blocks (split-KV):
//
// Grid (Hkv, B, NS). NS = ceil(min(S, window or S) / chunk) is computed on
// the host from static shapes, so kv_len stays on the device and the call
// can be captured in a CUDA graph. Split c of sequence b owns rows
// [first + c*chunk, min(first + (c+1)*chunk, kv_len[b])), first =
// max(0, kv_len[b] - window) with a window and 0 without; a split with no
// rows writes m = -1e30, l = 0 and returns. Each block takes all G query
// heads of its group, so each K/V row is read from memory once per group.
// A row of DH elements is LPR lanes' 16-byte loads (LPR = DH*sizeof(T)/16,
// at most 32; a lane takes CPL such words), so a warp reads RPW = 32/LPR
// rows at once, and every warp keeps U row loads in flight before it
// computes. Nothing past kv_len (the ragged skip) or before the window is
// read. Each lane group keeps a running (m, l, acc) per query head in fp32
// registers; the groups of a warp merge by shuffles and the warps of the
// block through shared memory. With NS = 1 the block writes acc / max(l,
// 1e-30) in q's dtype (0 when kv_len is 0): one pass, no scratch. With NS >
// 1 it writes its partial (m, l, acc) to fp32 scratch, and a combine kernel
// gives out = sum_c acc_c e^(m_c - m*) / max(sum_c l_c e^(m_c - m*), 1e-30),
// m* = max_c m_c, over the splits that hold rows. Strides are in elements,
// the head dimension contiguous, and every row 16-byte aligned (the wrapper
// checks), so the model's (B, S, Hkv, dh) cache is read through a
// transposed view with no copy.
//
// Sequence shards: with ``row0`` (B,) the cache holds rows [row0[b],
// row0[b] + S) of sequence b in absolute positions (one rank's block of a
// KV sequence split over a mesh). kv_len and the window stay absolute:
// the block sees local rows [max(kv_len - window - row0, 0), min(kv_len -
// row0, S)), none where that is empty. With ``lse`` (B, Hq) fp32 the call
// also writes the log-sum-exp m + log(l) of the scaled logits over the
// rows it saw, -inf where it saw none (its output row is then 0), and
// writes its output in fp32 (a partial, not yet rounded), so the blocks
// of one sequence merge as the splits do: out = sum_r o_r e^(lse_r -
// LSE), LSE = log sum_r e^(lse_r), rounded once after.
#include "attention_common.cuh"

namespace repro_torch {
namespace attn {

constexpr int kDecWarps = 8;

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  void* o;
  float* part_acc;                               // (B, Hq, NS, DH), NS > 1 only
  float* part_ml;                                // (B, Hq, NS, 2): m, l
  float* lse;                                    // (B, Hq) or null
  const int* row0;                               // (B,) first absolute row, or null
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh;
  int S;
  float scale, softcap;
  int window;                                    // 0 = none
  int chunk, splits;                             // rows per split, NS
};

// The output element at ``off`` (elements): fp32 where the call returns
// lse (a partial to be merged), q's type otherwise.
template <typename T>
__device__ __forceinline__ void put_out(const DecodeParams& p, long long off, float v) {
  if (p.lse != nullptr) {
    store(static_cast<float*>(p.o) + off, v);
  } else {
    store(static_cast<T*>(p.o) + off, v);
  }
}

// log(l) + m: the log-sum-exp of a running (m, l); -inf where l is 0 (no rows).
__device__ __forceinline__ float log_sum_exp(float m, float l) {
  return l > 0.f ? m + logf(l) : -__int_as_float(0x7f800000);
}

template <typename T, int DH, int G>
__global__ void __launch_bounds__(kDecWarps * 32) decode_kernel(DecodeParams p) {
  constexpr int VEC = 16 / sizeof(T);            // elements per 16-byte word
  constexpr int CHUNKS = DH / VEC;               // words per row
  constexpr int LPR = CHUNKS < 32 ? CHUNKS : 32; // lanes per row
  constexpr int CPL = CHUNKS / LPR;              // words per lane
  constexpr int RPW = 32 / LPR;                  // rows per warp step
  constexpr int E = CPL * VEC;                   // elements per lane
  constexpr int U = G <= 4 ? 4 : 2;              // warp steps in flight
  constexpr int STEP = kDecWarps * RPW;          // rows per block step

  extern __shared__ float smem[];                // [warps][G] m, l; [warps][G][DH] acc
  float* sm_m = smem;
  float* sm_l = sm_m + kDecWarps * G;
  float* sm_acc = sm_l + kDecWarps * G;

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / LPR;
  const int w0 = (lane % LPR) * CPL;             // this lane's first word
  // absolute rows: [kv_len - window, kv_len) visible, [lo, lo + S) held; without
  // row0 a kv_len past S counts as S
  const int lo = p.row0 != nullptr ? p.row0[b] : 0;
  const int kv_abs = p.row0 != nullptr ? p.kv_len[b] : min(p.kv_len[b], p.S);
  const int kv = min(max(kv_abs - lo, 0), p.S);
  const int first = (p.window > 0 ? max(kv_abs - p.window - lo, 0) : 0) + split * p.chunk;
  const int len = p.splits > 1 ? min(first + p.chunk, kv) : kv;   // this split's rows end
  const int hq0 = hk * G;
  if (p.splits > 1 && first >= len) {            // a split with no rows
    if (threadIdx.x < G) {
      float* ml = p.part_ml + ((static_cast<long long>(b) * gridDim.x * G + hq0 + threadIdx.x)
                               * p.splits + split) * 2;
      ml[0] = kNegInf;
      ml[1] = 0.f;
    }
    return;
  }

  const T* Qb = static_cast<const T*>(p.q) + b * p.q_sb + hq0 * p.q_sh;
  const T* Kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* Vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  float qf[G][E], acc[G][E], m[G], l[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const uint4 w = *reinterpret_cast<const uint4*>(Qb + h * p.q_sh + (w0 + c) * VEC);
      unpack16(w, &qf[h][c * VEC], T());
    }
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.f;
  }

  for (int base = first + warp * RPW; base < len; base += STEP * U) {
    uint4 kw[U][CPL], vw[U][CPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * STEP + sub;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        if (j < len) {
          kw[u][c] = *reinterpret_cast<const uint4*>(Kb + j * p.k_ss + (w0 + c) * VEC);
          vw[u][c] = *reinterpret_cast<const uint4*>(Vb + j * p.v_ss + (w0 + c) * VEC);
        } else {
          kw[u][c] = make_uint4(0, 0, 0, 0);
          vw[u][c] = make_uint4(0, 0, 0, 0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * STEP + sub;
      float kf[E];
#pragma unroll
      for (int c = 0; c < CPL; ++c) unpack16(kw[u][c], &kf[c * VEC], T());
      float s[G];
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(kf[e], qf[h][e], part);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) part += __shfl_xor_sync(kAll, part, off);
        s[h] = part;
      }
      if (j < len) {                             // uniform over the row's lanes
        float vf[E];
#pragma unroll
        for (int c = 0; c < CPL; ++c) unpack16(vw[u][c], &vf[c * VEC], T());
#pragma unroll
        for (int h = 0; h < G; ++h) {
          float x = s[h] * p.scale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          const float m_new = fmaxf(m[h], x);
          const float alpha = expf(m[h] - m_new);
          const float pr = expf(x - m_new);
          l[h] = l[h] * alpha + pr;
          m[h] = m_new;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[h][e] = fmaf(pr, vf[e], acc[h][e] * alpha);
        }
      }
    }
  }

  // Merge the RPW row groups of the warp, then the warps of the block.
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float mo = __shfl_xor_sync(kAll, m[h], off);
      const float lo = __shfl_xor_sync(kAll, l[h], off);
      const float mn = fmaxf(m[h], mo);
      const float a = expf(m[h] - mn), c = expf(mo - mn);
      l[h] = l[h] * a + lo * c;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(kAll, acc[h][e], off);
        acc[h][e] = acc[h][e] * a + ao * c;
      }
      m[h] = mn;
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (lane == 0) {
        sm_m[warp * G + h] = m[h];
        sm_l[warp * G + h] = l[h];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[(warp * G + h) * DH + w0 * VEC + e] = acc[h][e];
    }
  }
  __syncthreads();
  const long long ob = b * p.o_sb + hq0 * p.o_sh;
  for (int idx = threadIdx.x; idx < G * DH; idx += blockDim.x) {
    const int h = idx / DH, d = idx - h * DH;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, sm_m[w * G + h]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float f = expf(sm_m[w * G + h] - mx);
      den += sm_l[w * G + h] * f;
      num += sm_acc[(w * G + h) * DH + d] * f;
    }
    if (p.splits == 1) {
      put_out<T>(p, ob + h * p.o_sh + d, num / fmaxf(den, 1e-30f));
      if (p.lse != nullptr && d == 0)
        p.lse[static_cast<long long>(b) * gridDim.x * G + hq0 + h] = log_sum_exp(mx, den);
    } else {
      const long long row = (static_cast<long long>(b) * gridDim.x * G + hq0 + h) * p.splits
                            + split;
      p.part_acc[row * DH + d] = num;
      if (d == 0) {
        p.part_ml[row * 2] = mx;
        p.part_ml[row * 2 + 1] = den;
      }
    }
  }
}

// Merge the NS partials of each (sequence, query head): one block of DH
// threads per (query head, sequence), thread d owning output column d.
template <typename T, int DH>
__global__ void __launch_bounds__(DH) combine_kernel(DecodeParams p, int Hq) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const long long base = (static_cast<long long>(b) * Hq + hq) * p.splits;
  const float* ml = p.part_ml + base * 2;
  float mx = kNegInf;
  for (int c = 0; c < p.splits; ++c) mx = fmaxf(mx, ml[2 * c]);
  float num = 0.f, den = 0.f;
  for (int c = 0; c < p.splits; ++c) {
    if (ml[2 * c + 1] > 0.f) {                   // a split that held rows
      const float f = expf(ml[2 * c] - mx);
      den += ml[2 * c + 1] * f;
      num += p.part_acc[(base + c) * DH + d] * f;
    }
  }
  put_out<T>(p, b * p.o_sb + hq * p.o_sh + d, num / fmaxf(den, 1e-30f));
  if (p.lse != nullptr && d == 0)
    p.lse[static_cast<long long>(b) * Hq + hq] = log_sum_exp(mx, den);
}

template <typename T, int DH, int G>
cudaError_t launch_decode(const DecodeParams& p, int B, int Hkv, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kDecWarps * G * (DH + 2);
  cudaError_t err = allow_smem(decode_kernel<T, DH, G>, smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T, DH, G><<<dim3(Hkv, B, p.splits), kDecWarps * 32, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  combine_kernel<T, DH><<<dim3(Hkv * G, B), DH, 0, stream>>>(p, Hkv * G);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t dispatch_g(const DecodeParams& p, int B, int Hkv, int g, cudaStream_t s) {
  switch (g) {
    case 1: return launch_decode<T, DH, 1>(p, B, Hkv, s);
    case 2: return launch_decode<T, DH, 2>(p, B, Hkv, s);
    case 3: return launch_decode<T, DH, 3>(p, B, Hkv, s);
    case 4: return launch_decode<T, DH, 4>(p, B, Hkv, s);
    case 8: return launch_decode<T, DH, 8>(p, B, Hkv, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dh(const DecodeParams& p, int B, int Hkv, int g, int dh, cudaStream_t s) {
  switch (dh) {
    case 64: return dispatch_g<T, 64>(p, B, Hkv, g, s);
    case 128: return dispatch_g<T, 128>(p, B, Hkv, g, s);
    case 256: return dispatch_g<T, 256>(p, B, Hkv, g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace repro_torch

// strides: 10 element strides: q (batch, head), k (batch, head, seq),
// v (batch, head, seq), o (batch, head). dtype 0 = fp32, 1 = bf16.
// softcap <= 0 and window <= 0 mean none. dh in {64, 128, 256}, g in
// {1, 2, 3, 4, 8}. splits = NS >= 1 blocks of chunk rows per (sequence, KV
// head); with NS > 1, part_acc (B, Hq, NS, dh) and part_ml (B, Hq, NS, 2)
// are fp32 scratch. lse (B, Hq) fp32 contiguous and row0 (B,) int32 may
// be null (no log-sum-exp; the rows start at 0); with lse, o is fp32.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* kv_len, void* o, void* part_acc,
                                       void* part_ml, void* lse, const void* row0,
                                       const long long* strides, int B,
                                       int Hq, int Hkv, int S, int dh, float scale,
                                       float softcap, int window, int chunk, int splits,
                                       int dtype, void* stream) {
  using namespace repro_torch::attn;
  if (B == 0 || Hkv == 0) return static_cast<int>(cudaGetLastError());
  if (splits < 1 || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  DecodeParams p{q, k, v, static_cast<const int*>(kv_len), o,
                 static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                 static_cast<float*>(lse), static_cast<const int*>(row0),
                 strides[0], strides[1], strides[2], strides[3], strides[4],
                 strides[5], strides[6], strides[7], strides[8], strides[9],
                 S, scale, softcap, window, chunk, splits};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = Hq / Hkv;
  const cudaError_t err = dtype == 1 ? dispatch_dh<__nv_bfloat16>(p, B, Hkv, g, dh, s)
                                     : dispatch_dh<float>(p, B, Hkv, g, dh, s);
  return static_cast<int>(err);
}
