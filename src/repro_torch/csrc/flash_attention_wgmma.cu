// flash_attention_wgmma: the bf16 prefill attention on Hopper's tensor cores.
// Replaces repro/kernels/flash_attention.py:flash_attention (_flash_kernel)
// for bf16 inputs; fp32 inputs keep the exact FMA kernel (flash_attention.cu).
//
// Bound on the H100: operations at long prefills (4,096 causal tokens, 24
// heads of 128: ~103 GFLOP against 989 TFLOP/s bf16, 0.104 ms), bytes at the
// serve shape (8 x 64 tokens: ~8.4 MB of q, k, v and output at 3.35 TB/s).
// Only wgmma reaches the tensor-core rate, so both products are wgmma:
//
// - Tiles. A block is one warpgroup (128 threads) that owns kBQ = 64 query
//   rows of one (batch, head); K and V tiles are kBK = 64 keys x dh, two K
//   stages and one V stage. At dh <= 128 three blocks share an SM (65 KB of
//   shared memory and at most 168 registers a thread each at dh 128) and
//   run out of step, so one block's softmax overlaps another's wgmma. On
//   the card this beat two warpgroups sharing each K/V tile in lockstep,
//   two blocks an SM with two K/V stages each, and a producer warp feeding
//   two warpgroups through mbarriers (ptxas held that block to 168
//   registers a thread, and it spilled). At dh 256 the O accumulator alone
//   is 128 registers a thread: one block an SM.
// - Loads. Every thread issues 16-byte cp.async copies straight into the
//   128-byte-swizzled layout that the wgmma descriptors read (dh split into
//   64-column blocks of [rows][64], 16-byte chunk c of row r stored at chunk
//   c ^ (r % 8)). K_{t+1} is in flight while tile t is scored, V_{t+1} from
//   the end of tile t until its P V. cp.async takes any row stride and needs
//   no tensor map, so the model's (B, S, H, dh) projections go in through
//   transposed views with no host set-up per call (TMA would need a
//   cuTensorMapEncodeTiled per call on a launch-bound path); rows past Sq or
//   Skv are zero-filled (src-size 0), never read.
// - S = Q K^T: wgmma m64n64k16, Q and K from shared memory, both K-major.
// - Softmax on the fp32 accumulator fragments in registers: a row lives in one
//   quad of threads, so its max takes 2 shuffles; the running sum l stays a
//   per-thread partial until the epilogue. Scale, softcap, and the causal,
//   window and kv_offset masks come from absolute positions, evaluated only on
//   the tiles that the block's rows do not all see; tiles that none of them
//   see are never loaded. The softmax runs in the log2 domain (ex2.approx).
// - O += P V: wgmma m64n{dh}k16 with A = P in registers (the S accumulator's
//   layout is the A-fragment layout), rounded to bf16, and V from shared
//   memory with the transpose bit (V is MN-major). O accumulates in fp32.
//   l sums the bf16-rounded probabilities, the same ones that enter P V, so
//   each output row is an exact convex combination of V rows.
// - Epilogue: acc / max(l, 1e-30) in bf16 through the output strides; a row
//   that sees no key gives 0.
//
// Numerics: scores and sums are fp32; the probabilities are rounded to bf16
// before P V, as the reference model's attend_prefill does
// (repro/models/attention.py). Against the fp32 oracle the error is within
// 2^-7 max(|got|, |want|) + 2^-7 (P |V|) + 1e-5.
#include <stdint.h>

#include "attention_common.cuh"

namespace repro_torch {
namespace attn {
namespace wg {

constexpr float kLog2e = 1.4426950408889634f;

constexpr int kBQ = 64;                          // query rows per block (one warpgroup)
constexpr int kBK = 64;                          // keys per tile

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int Hq, Hkv, Sq, Skv, causal, window, kv_offset;
  float scale, softcap;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (all >> 4), layout type 1 (B128).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, fp32) = [D +] A (64 x 16) * B (16 x 64): A and B in shared
// memory, both K-major; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 in registers) * B (16 x 64): B in
// shared memory, MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 in registers) * B (16 x 128): B in
// shared memory, MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, fp32) += A (64 x 16, bf16 in registers) * B (16 x 256): B in
// shared memory, MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Copy rows [r0, r0 + ROWS) x DH of a bf16 matrix (row stride ss elements)
// into shared memory at dst (1024-byte aligned) in the 128-byte-swizzled
// layout: DH / 64 column blocks of [ROWS][64], 16-byte chunk c of row r at
// chunk c ^ (r % 8). Rows at or past r_end are zero-filled.
template <int ROWS, int DH, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          long long ss, int r0, int r_end, int tid) {
  constexpr int CPR = DH / 8;                    // 16-byte chunks per row
  static_assert((ROWS * CPR) % NT == 0, "tile chunks must divide among threads");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / CPR, ch = c % CPR;
    const bool in = r0 + r < r_end;
    const __nv_bfloat16* g = in ? src + static_cast<long long>(r0 + r) * ss + ch * 8 : src;
    const uint32_t s = dst + (ch >> 3) * (ROWS * 128) + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
    cp_async16(s, g, in ? 16 : 0);
  }
}

// 2^x on the SFU (MUFU.EX2); results below 2^-126 flush to 0, far below
// the bf16 rounding P takes next.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DH == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (DH == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

// Shared memory of a block: Q as [DH / 64][kBQ rows][128 B], two K stages
// and one V stage (each [DH / 64][kBK][128 B]); the base is aligned to the
// 1 KB swizzle atom.
template <int DH>
struct Smem {
  static constexpr int Q_BYTES = kBQ * DH * 2, KV_BYTES = kBK * DH * 2;
  static constexpr int BYTES = Q_BYTES + 3 * KV_BYTES + 1024;
  __device__ static uint32_t base(uint8_t* raw) { return (smem_u32(raw) + 1023) & ~1023u; }
  __device__ static uint32_t k_tile(uint32_t b, int t) {
    return b + Q_BYTES + (t & 1) * KV_BYTES;
  }
  __device__ static uint32_t v_tile(uint32_t b) { return b + Q_BYTES + 2 * KV_BYTES; }
};

// The block's rows and the keys any of them can see: tiles outside
// [kv_begin, kv_end) are never loaded.
struct Span {
  int q0, q_last, kv_begin, n_tiles;
  __device__ explicit Span(const Params& p) {
    q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;     // longest rows first
    q_last = min(q0 + kBQ, p.Sq) - 1;
    int kv_end = p.Skv;
    kv_begin = 0;
    if (p.causal) kv_end = min(kv_end, q_last + p.kv_offset + 1);
    if (p.window > 0) kv_begin = max(0, q0 + p.kv_offset - p.window + 1);
    n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kBK - 1) / kBK : 0;
  }
  // Tile t0 is visible to every row of the block: no mask to evaluate.
  __device__ bool full(const Params& p, int t0) const {
    return t0 + kBK <= p.Skv && (!p.causal || t0 + kBK - 1 <= q0 + p.kv_offset) &&
           (p.window <= 0 || t0 > q_last + p.kv_offset - p.window);
  }
};

// The warpgroup's running state over its kBQ rows: O in fp32 (the
// accumulator layout: this thread holds rows row0 and row0 + 8) and each
// row's max m and partial sum l in the log2 domain.
template <int DH>
struct Rows {
  float o[DH / 2];
  float m[2], l[2];
  int row0, qpos0, col0;
  __device__ void init(int first_row, int kv_offset) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
    row0 = first_row + warp * 16 + (lane >> 2);
    qpos0 = row0 + kv_offset;
    col0 = 2 * (lane & 3);
  }

  // One K tile: S = Q K^T (wgmma, Q and K from shared memory), then the
  // softmax on S's fragments; P leaves in pa, O is rescaled.
  __device__ void score(const Params& p, uint32_t q_s, uint32_t k_s, int t0, bool full,
                        uint32_t (&pa)[16]) {
    float s[32];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wgmma_ss_n64(s, smem_desc(q_s + (kk >> 2) * (kBQ * 128) + (kk & 3) * 32, 16, 1024),
                   smem_desc(k_s + (kk >> 2) * (kBK * 128) + (kk & 3) * 32, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Scores in the log2 domain; masked keys -inf (no mass).
    const float sl2 = p.scale * kLog2e;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i];
      if (p.softcap > 0.f) x = p.softcap * tanhf(x * p.scale / p.softcap) * kLog2e;
      else x *= sl2;
      if (!full) {
        const int kpos = t0 + 8 * (i >> 2) + col0 + (i & 1);
        const int qpos = qpos0 + 8 * ((i >> 1) & 1);
        bool ok = kpos < p.Skv;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        x = ok ? x : -INFINITY;
      }
      s[i] = x;
    }
    float mx[2] = {m[0], m[1]}, alpha[2];
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kAll, mx[r], 2));
      alpha[r] = fast_exp2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const uint32_t w = pack_bf16(fast_exp2(s[i] - m[r]), fast_exp2(s[i + 1] - m[r]));
      pa[i >> 1] = w;
      l[r] += __uint_as_float(w << 16) + __uint_as_float(w & 0xffff0000u);
    }
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  }

  // O += P V (wgmma, P from registers, V from shared memory).
  __device__ void accumulate(uint32_t v_s, const uint32_t (&pa)[16]) {
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
      wgmma_pv<DH>(o, a, smem_desc(v_s + kk * 16 * 128, kBK * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  // acc / max(l, 1e-30) in bf16; a row that sees no key gives 0.
  __device__ void store(const Params& p, __nv_bfloat16* O) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kAll, l[r], 1);
      l[r] += __shfl_xor_sync(kAll, l[r], 2);
      l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const __nv_bfloat162 w = __floats2bfloat162_rn(o[4 * j + 2 * r] * l[r],
                                                       o[4 * j + 2 * r + 1] * l[r]);
        *reinterpret_cast<__nv_bfloat162*>(O + row * p.o_ss + 8 * j + col0) = w;
      }
    }
  }
};

// cp.async writes through the generic proxy; wgmma reads through the async
// proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One warpgroup owns kBQ query rows of one (batch, head). Every thread
// copies. K_{t+1} is in flight while tile t is scored, V_{t+1} from the end
// of tile t until P V needs it; one V stage keeps the block at 65 KB of
// shared memory (dh 128), so three blocks share an SM.
template <int DH>
__global__ void __launch_bounds__(128, DH <= 128 ? 3 : 1) flash_wgmma_kernel(Params p) {
  using S = Smem<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = S::base(smem_raw);
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const Span span(p);
  const __nv_bfloat16* K = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* V = p.v + b * p.v_sb + hk * p.v_sh;
  // One cp.async group per load, committed even when empty so that the
  // waits below count the same groups on every tile.
  auto load = [&](const __nv_bfloat16* src, long long ss, uint32_t dst, int t) {
    if (t < span.n_tiles)
      load_tile<kBK, DH, 128>(dst, src, ss, span.kv_begin + t * kBK, p.Skv, tid);
    cp_async_commit();
  };
  if (span.n_tiles > 0)
    load_tile<kBQ, DH, 128>(base, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, span.q0, p.Sq, tid);
  load(K, p.k_ss, S::k_tile(base, 0), 0);
  load(V, p.v_ss, S::v_tile(base), 0);

  Rows<DH> rows;
  rows.init(span.q0, p.kv_offset);
  for (int t = 0; t < span.n_tiles; ++t) {
    load(K, p.k_ss, S::k_tile(base, t + 1), t + 1);   // its stage was freed by tile t - 1
    cp_async_wait<2>();                          // K_t (V_t and K_{t+1} may be in flight)
    fence_proxy_async();
    __syncthreads();
    const int t0 = span.kv_begin + t * kBK;
    uint32_t pa[16];                             // P in bf16, A-fragment order
    rows.score(p, base, S::k_tile(base, t), t0, span.full(p, t0), pa);
    cp_async_wait<1>();                          // V_t
    fence_proxy_async();
    __syncthreads();
    rows.accumulate(S::v_tile(base), pa);
    __syncthreads();                             // V and K_t are free
    load(V, p.v_ss, S::v_tile(base), t + 1);
  }
  cp_async_wait<0>();
  rows.store(p, p.o + b * p.o_sb + h * p.o_sh);
}

template <int DH>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_wgmma_kernel<DH>, Smem<DH>::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hq, B, (p.Sq + kBQ - 1) / kBQ);
  flash_wgmma_kernel<DH><<<grid, 128, Smem<DH>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace attn
}  // namespace repro_torch

// strides: 12 element strides, (batch, head, seq) for q, k, v, o in order;
// every row 16-byte aligned. dh in {64, 128, 256}. window <= 0 and
// softcap <= 0 mean none.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* o, const long long* strides, int B,
                                            int Hq, int Hkv, int Sq, int Skv, int dh,
                                            int causal, int window, int kv_offset,
                                            float scale, float softcap, void* stream) {
  using namespace repro_torch::attn::wg;
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
           strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
           strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
           Hq, Hkv, Sq, Skv, causal, window, kv_offset, scale, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dh == 64) err = launch<64>(p, B, s);
  else if (dh == 128) err = launch<128>(p, B, s);
  else if (dh == 256) err = launch<256>(p, B, s);
  return static_cast<int>(err);
}
