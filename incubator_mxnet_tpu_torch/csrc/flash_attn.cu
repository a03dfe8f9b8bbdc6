// Flash-attention forward for Hopper (sm_90a): the partial attention of
// one KV shard, in the ring-step contract of the JAX package,
//     s = (q / sqrt(D)) k^T  (causal: key position > query position masked)
//     m = rowmax(s),  l = rowsum(exp(s - m)),  o = exp(s - m) v   (unnormalised)
// q (B, Tq, H, D), k and v (B, Tk, H, D), float32, bfloat16 or float16,
// read through their strides (the head dimension contiguous); o (B, Tq,
// H, D) in q's dtype, m and l (B, H, Tq) in float32.  q_off and k_off are
// the global positions of q's and k's first rows, for the causal mask.
// The scale is the caller's (1/sqrt of the head size before any padding).
// A row that sees no key ends with m = -1e30, l = 0, o = 0.  D is a
// multiple of 8 (the wrappers pad other head sizes).
//
// Two entries, two TPU kernels replaced:
//   mx_flash_fwd         K2, `_fwd_kernel` via `_partial_tpu` in
//                        incubator_mxnet_tpu/ops/flash_attention.py: whole KV
//                        walked by one block's loop;
//   mx_flash_fwd_stream  K3, `_fwd_kernel_stream` via `_stream_tpu` there:
//                        the accumulator rode sequential grid steps in VMEM.
//                        Blocks here run in no order and carry nothing, so
//                        the KV range is split across blocks (grid z), each
//                        writes an fp32 partial (o, m, l) to a workspace, and
//                        a second kernel merges the splits of every row with
//                        the online-softmax merge (the ring's merge).
// Both entries share one mainloop per dtype over a KV tile range
// [begin, end); K2 is the case of one range.
//
// What bounds them on an H100: 4*Tq*Tk*D operations (halved when causal)
// against bytes that grow only as (Tq + Tk)*D, so at the long-context
// shapes (T = 8192..32768, D = 64) both are far above the ridge point:
// operation-bound, at the rate of the unit that multiplies.
//
// Both routes run on the tensor cores with `wgmma`, in one block shape:
// one producer warp that loads Q once and K/V tiles through a 2-stage
// ring in shared memory by TMA (a 4-D tensor map over (D, H, T, B) with
// the tensors' own strides, so q, k, v sliced out of a packed tensor read
// without a copy; 128-byte boxes, 128-byte swizzle; TMA zero-fills rows
// past T and columns past D), handed over with mbarriers (full: the bytes
// landed; empty: every consumer warp is done), and one or two consumer
// warpgroups of 64 query rows each.  Accumulator fragments: a thread
// holds rows r and r + 8 and, per 8-column chunk j, columns 8j + 2t and
// 8j + 2t + 1 (t = lane % 4).  Softmax runs on the S fragments: a row
// lives in 4 lanes (a 2-step shuffle for its max); exp is ex2 of s*log2(e)
// - m*log2(e) with m kept in natural units, so a row that never saw a key
// keeps m = -1e30 exactly (alpha = ex2(0) = 1, p = ex2(-inf) = 0); l is
// kept per lane and summed over its 4 lanes at the end.  Only tiles that
// touch the causal diagonal or the ragged end of KV evaluate the mask
// (TMA's zero fill gives s = 0, not -inf); tiles above the diagonal are
// never loaded; the heaviest causal q tiles are launched first (reversed
// grid x).  Registers and shared memory set the tiles: a 288-thread block
// puts 3 warps on one of the SM's 4 sub-partitions, so a thread gets at
// most 168 registers; a block holds at most 227 KB of shared memory.
//
// Head sizes above 128 split O's columns across blocks: a column group
// of DV columns (grid x = q tiles x groups) accumulates its DV columns of
// O from its DV columns of V, and computes S over the whole of D and the
// same softmax as the other groups; group 0 writes m and l.  At D = 256
// that is 1.5x the operations of one pass (S twice), so such a call reads
// at most 0.67 of the bound, which counts 4*D per pair.
//
// 16-bit route (flash_fwd_tc, bfloat16 and float16): 989 TFLOP/s.  Both
// products are 16-bit x 16-bit -> fp32, as the TPU kernel's dots
// (preferred_element_type=float32), so the rounding points are the
// contract's: q scaled and rounded to the dtype once (in shared memory,
// by its warpgroup, behind fence.proxy.async), fp32 scores and row sums,
// p rounded to the dtype before P.V while l sums the fp32 p.  128 query
// rows (two consumer warpgroups), 288 threads.  S = Q K^T: m64nBKk16, Q
// and the K tile K-major from shared memory.  O += P V: m64n64k16 per 64
// columns of the group, A = P from registers (the S fragment paired into
// 16-bit x2 is the A fragment) and B = the V tile, keys x D, MN-major:
// the transpose bit.  Tiles: 128 keys at D <= 64 (S 64 registers, O 32);
// 64 keys at D <= 128 (O takes 64; 128-key tiles spilled) and at D <= 256
// (128-column groups).  Shared memory: 80, 96 and 160 KB.  In float16 the
// unnormalised o of a long row can pass 65504 and overflow to inf; the
// TPU kernel's cast (acc.astype(o_ref.dtype)) overflows the same way.
//
// float32 route (flash_fwd_f32): TF32 tensor cores at 495 TFLOP/s,
// three passes for fp32 accuracy ("3xTF32", CUTLASS's
// OpMultiplyAddFastF32): x = hi + lo with hi = tf32(x), lo = tf32(x - hi),
// and a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b summed in the fp32
// accumulator, about 2^-21 relative per product, an effective 165 TFLOP/s.
// Parity needs full fp32: one TF32 pass is off by ~1e-3.  `wgmma` reads
// only the top 19 bits of a .tf32 operand (it truncates; measured on an
// H100), so hi and lo are rounded explicitly with cvt.rna.  `wgmma` takes
// .tf32 operands K-major only (no transpose bit), so:
//   * S = Q K^T: Q (scaled by the caller's scale in fp32, then split) and
//     K tiles, D-contiguous, are K-major as loaded.  The consumers split
//     each K tile in place (hi) and into a K_lo buffer of the same layout;
//   * O += P V needs V as a K-major B, keys contiguous: the consumers
//     transpose each V tile into V^T_hi and V^T_lo (swizzled like a TMA
//     tile), then fence.proxy.async and a barrier of the consumers hand
//     them to `wgmma`.  A second barrier before the next tile's transform
//     keeps it off buffers still being read;
//   * P comes from registers.  The tf32 A fragment of a k8 step gives a
//     thread columns t and t + 4 (registers a0 (r, t), a1 (r + 8, t), a2
//     (r, t + 4), a3 (r + 8, t + 4); measured), while S's fragment holds
//     2t and 2t + 1.  So P is fed as it lies, and the transpose writes V's
//     8 keys of each k-step in the order pi = (0, 2, 4, 6, 1, 3, 5, 7):
//     position q of the k-step holds key pi(q).  hi and lo of p are split
//     in registers;
//   * tiles from shared memory: Q in hi and lo takes 2x what one fp32 copy
//     does, so D <= 64 runs 128 query rows by 64 keys (Q 64 KB, ring
//     64 KB, K_lo 16 KB, V^T 32 KB = 176 KB), D <= 128 runs 64 rows (one
//     consumer warpgroup, 160 threads) by 32 keys (176 KB), and D <= 256
//     64 rows by 16 keys with 128-column groups (224 KB).
//
// Head sizes above 256 (flash_fwd_wide, all three dtypes): Q of one block
// and a K tile no longer fit shared memory beside the ring, so a simple
// CUDA-core kernel takes them.  A block is 64 query rows and one column
// group of 128 columns of O (grid x = q tiles x groups, as above); per KV
// tile of 64 keys it accumulates S over D in chunks of 64 columns of Q
// and K staged in shared memory, runs the online softmax on S in
// registers, and adds P.V from P and a V tile in shared memory.  fp32
// throughout (67 TFLOP/s of FMAs), the 16-bit rounding points kept; S is
// computed once per column group, D / 128 times in all.
// The split-KV plan (mx_flash_fwd_stream_plan) counts in the route's own
// tiles and column groups, and cuts the KV range so that about
// kBlocksPerSm blocks of work per SM exist and no block's share exceeds
// the balanced share of the causal triangle.

#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kBlocksPerSm = 8;   // split-KV target: blocks of work per SM
constexpr int kStages = 2;        // K/V ring depth
constexpr int kMaxTcD = 256;      // the widest head of the tensor-core routes
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* m;
  float* l;
  float* ws;          // split-KV workspace (nullptr for the whole-KV kernel)
  int B, H, Tq, Tk, D;
  long long qs[3], ks[3], vs[3], os[3];   // strides of b, t, h (elements)
  long long q_off, k_off;
  int causal;
  float scale;
  int chunk;          // KV tiles per split
};

// The 16-bit element types: two values packed in 32 bits (x0 low)
template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float x0, float x1) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
};
template <> struct Pair<__half> {
  static __device__ __forceinline__ uint32_t pack(float x0, float x1) {
    const __half2 v = __floats2half2_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  }
};

// KV tiles of bk keys that q tile qt (bq rows) must visit: all of them, or
// under the causal mask those up to the one holding the tile's last row's
// position.
__host__ __device__ inline int tiles_run(int qt, int Tq, int Tk,
                                         long long q_off, long long k_off,
                                         int causal, int bq, int bk) {
  const int nk = (Tk + bk - 1) / bk;
  if (!causal) return nk;
  const int q0 = qt * bq;
  const int rows = Tq - q0 < bq ? Tq - q0 : bq;
  const long long e = q_off + q0 + rows - 1 - k_off;
  if (e < 0) return 0;
  const long long n = e / bk + 1;
  return n < nk ? static_cast<int>(n) : nk;
}

// ---- TMA and wgmma of the two tensor-core routes ---------------------------

// one box of a 4-D tensor map at coordinates (d, h, t, b) into dst,
// completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d),
      "r"(h), "r"(t), "r"(b) : "memory");
}

// zero `bytes` (a multiple of 16) of shared memory at p, by threads
// `first`, `first + step`, ...
__device__ __forceinline__ void zero_smem(uint8_t* p, int bytes, int first,
                                          int step) {
  for (int e = first; e < bytes / 16; e += step)
    reinterpret_cast<uint4*>(p)[e] = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

// 16-bit d = A B (scale_d 0) or d += A B, A (64 x 16) and B (16 x N) both
// K-major in shared memory (descriptors a, b): m64n128k16 (d[64]) and
// m64n64k16 (d[32])
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (kIsHalf<T>)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
                 MX_R64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : MX_A64(d) : "l"(a), "l"(b), "r"(scale_d));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
                 MX_R64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : MX_A64(d) : "l"(a), "l"(b), "r"(scale_d));
}
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (kIsHalf<T>)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
                 MX_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : MX_A32(d) : "l"(a), "l"(b), "r"(scale_d));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
                 MX_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : MX_A32(d) : "l"(a), "l"(b), "r"(scale_d));
}

// 16-bit d += A B: A (64 x 16) from registers in the accumulator layout, B
// (16 x 64) MN-major in shared memory (the transpose bit set)
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsHalf<T>)
    asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
                 MX_R32 "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
                 : MX_A32(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                   "l"(b));
  else
    asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
                 MX_R32 "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
                 : MX_A32(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                   "l"(b));
}

// tf32 d = A B (scale_d 0) or d += A B, A (64 x 8) and B (8 x N) K-major in
// shared memory: N = 64 (d[32]), 32 (d[16]), 16 (d[8])
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
               MX_R32 "}, %32, %33, p, 1, 1;\n}\n"
               : MX_A32(d) : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
               MX_R16 "}, %16, %17, p, 1, 1;\n}\n"
               : MX_A16(d) : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[8], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
               MX_R8 "}, %8, %9, p, 1, 1;\n}\n"
               : MX_A8(d) : "l"(a), "l"(b), "r"(scale_d));
}

// tf32 d += A B: A (64 x 8) from registers {a0 (r, t), a1 (r + 8, t),
// a2 (r, t + 4), a3 (r + 8, t + 4)}, B (8 x 64) K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
               MX_R32 "}, {%32, %33, %34, %35}, %36, 1, 1, 1;\n"
               : MX_A32(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                 "l"(b));
}

// ---- what the two routes share around their products ----------------------

// -inf where key column `col` (of 2 per chunk j) is past Tk or, causal,
// after the row's position; sc is the S fragment of NJ 8-column chunks
template <int NJ>
__device__ __forceinline__ void mask_tile(float* sc, const Args& a, int k0,
                                          int cq, long long qpos_a,
                                          long long qpos_b) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = k0 + 8 * j + cq + c;
      const long long kp = a.k_off + col;
      const bool out = col >= a.Tk;
      if (out || (a.causal && kp > qpos_a)) sc[4 * j + c] = -INFINITY;
      if (out || (a.causal && kp > qpos_b)) sc[4 * j + 2 + c] = -INFINITY;
    }
  }
}

// the online softmax step of rows a and b: new maxima from the tile's S,
// the rescale factors of the old sums, and m in log2 units for ex2
template <int NJ>
__device__ __forceinline__ void softmax_max(const float* sc, float& m_a,
                                            float& m_b, float& al_a,
                                            float& al_b, float& ms_a,
                                            float& ms_b) {
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a);
  const float mn_b = fmaxf(m_b, mx_b);
  al_a = ex2((m_a - mn_a) * kLog2e);
  al_b = ex2((m_b - mn_b) * kLog2e);
  m_a = mn_a;
  m_b = mn_b;
  ms_a = mn_a * kLog2e;
  ms_b = mn_b * kLog2e;
}

// The epilogue of both routes: rows r_a and r_a + 8 of the block's q tile,
// the columns c0 + 64x + 8j + cq (+1) that are < D.  SPLIT: the fp32
// partial into the workspace (o [splits][rows][D], then m [splits][rows],
// then l), else o in T and m, l.  Column group 0 writes m and l.
template <typename T, int NX, bool SPLIT>
__device__ __forceinline__ void store_rows(const Args& a, float (&o)[NX][32],
                                           float m_a, float m_b, float l_a,
                                           float l_b, int bh, int b, int h,
                                           int q0, int r_a, int c0, int cg,
                                           int lane) {
  const int cq = 2 * (lane % 4);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const long long rows_all = static_cast<long long>(a.B) * a.H * a.Tq;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r_a + 8 * hr;
    if (row >= a.Tq) continue;
    const long long r = static_cast<long long>(bh) * a.Tq + row;
    const float mr = hr ? m_b : m_a;
    const float lr = hr ? l_b : l_a;
    const bool ml = cg == 0 && lane % 4 == 0;
    if (SPLIT) {
      const long long splits = gridDim.z;
      const long long slot = blockIdx.z * rows_all + r;
      float* wo = a.ws + slot * a.D;
#pragma unroll
      for (int x = 0; x < NX; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + x * 64 + 8 * j + cq;
          if (col < a.D)
            *reinterpret_cast<float2*>(wo + col) =
                make_float2(o[x][4 * j + 2 * hr], o[x][4 * j + 2 * hr + 1]);
        }
      if (ml) {
        float* wm = a.ws + splits * rows_all * a.D;
        wm[slot] = mr;
        wm[splits * rows_all + slot] = lr;
      }
    } else {
      T* out = static_cast<T*>(a.o) + b * a.os[0] + row * a.os[1] +
               h * a.os[2];
#pragma unroll
      for (int x = 0; x < NX; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + x * 64 + 8 * j + cq;
          if (col >= a.D) continue;
          const float x0 = o[x][4 * j + 2 * hr];
          const float x1 = o[x][4 * j + 2 * hr + 1];
          if constexpr (std::is_same<T, float>::value)
            *reinterpret_cast<float2*>(out + col) = make_float2(x0, x1);
          else
            *reinterpret_cast<uint32_t*>(out + col) = Pair<T>::pack(x0, x1);
        }
      if (ml) {
        a.m[r] = mr;
        a.l[r] = lr;
      }
    }
  }
}

// Where a block starts: its q tile (the heaviest causal tiles first) and
// column group, from the reversed grid x of n_tiles x groups
struct BlockPos {
  int qt, cg, bh, b, h;
};
__device__ __forceinline__ BlockPos block_pos(const Args& a, int groups) {
  BlockPos p;
  const int idx = gridDim.x - 1 - blockIdx.x;
  p.qt = idx / groups;
  p.cg = idx - p.qt * groups;
  p.bh = blockIdx.y;
  p.b = p.bh / a.H;
  p.h = p.bh - p.b * a.H;
  return p;
}

// ---- 16-bit route: bfloat16 and float16 ------------------------------------

constexpr int kTcBQ = 128;        // query rows per block: 2 consumer warpgroups
constexpr int kTcThreads = 288;   // 2 consumer warpgroups + 1 producer warp
constexpr int kBox16 = 64;        // 16-bit columns per TMA box: 128 bytes

// Shared memory of the 16-bit kernel, in bytes from a 1024-aligned base
// (the 128-byte swizzle repeats every 8 rows of 128 bytes).  A tile of R
// rows is boxes of R x 128 bytes, one after the other: DQK / 64 of them
// for Q and K, DV / 64 for V.
template <int DQK, int DV, int BK>
struct TcSmem {
  static constexpr int kQBoxes = DQK / kBox16;
  static constexpr int kVBoxes = DV / kBox16;
  static constexpr int kQBytes = kQBoxes * kTcBQ * 128;
  static constexpr int kKBytes = kQBoxes * BK * 128;      // one K tile
  static constexpr int kVBytes = kVBoxes * BK * 128;      // one V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;                 // + stage * kKBytes
  static constexpr int kV = kK + kStages * kKBytes;       // + stage * kVBytes
  static constexpr int kBar = kV + kStages * kVBytes;     // full[], empty[], q
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + 1024;
};

// The 16-bit route of K2 (SPLIT = false) and of K3's first pass (SPLIT =
// true), see the note at the top of the file.  One block: q tile of 128
// rows and column group (block_pos), head blockIdx.y, KV tiles [split *
// chunk, min(nk_run, (split + 1) * chunk)) with split = blockIdx.z.
// Warps 0-7 are the consumer warpgroups (rows 0-63, 64-127 of the tile),
// warp 8 the producer.
template <typename T, int DQK, int DV, int BK, bool SPLIT>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const Args a) {
  using L = TcSmem<DQK, DV, BK>;
  constexpr int NX = L::kVBoxes;
  constexpr int NJ = BK / 8;       // 8-column chunks of S
  constexpr int NKS = BK / 16;     // k-steps of P.V
  // Q and K boxes that hold columns < D: all of them below DQK = 256
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t full = base + L::kBar;             // full[s] at + 8 s
  const uint32_t empty = full + 8 * kStages;        // empty[s] at + 8 s
  const uint32_t qbar = empty + 8 * kStages;

  const int groups = (a.D + DV - 1) / DV;
  const BlockPos bp = block_pos(a, groups);
  const int q0 = bp.qt * kTcBQ;
  const int c0 = bp.cg * DV;                        // first column of O, V
  const int nq = DQK <= 128 ? L::kQBoxes : (a.D + kBox16 - 1) / kBox16;
  const int nv = min(NX, (a.D - c0 + kBox16 - 1) / kBox16);
  const int nk_run = tiles_run(bp.qt, a.Tq, a.Tk, a.q_off, a.k_off,
                               a.causal, kTcBQ, BK);
  const int kt_begin = blockIdx.z * a.chunk;
  const int n = min(nk_run, kt_begin + a.chunk) - kt_begin;   // may be <= 0

  // Q and K boxes past D are never loaded: zero, so that every wgmma runs
  // over all DQK columns (a wgmma behind a runtime branch makes ptxas
  // serialise); V boxes past D only feed columns of O past D
  if (nq < L::kQBoxes) {
    zero_smem(smem + L::kQ + nq * kTcBQ * 128,
              (L::kQBoxes - nq) * kTcBQ * 128, threadIdx.x, kTcThreads);
    for (int s = 0; s < kStages; ++s)
      zero_smem(smem + L::kK + s * L::kKBytes + nq * BK * 128,
                (L::kQBoxes - nq) * BK * 128, threadIdx.x, kTcThreads);
    fence_async_smem();
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 8) {
    // producer: Q once, then K/V tiles into the ring
    if (lane == 0 && n > 0) {
      mbar_expect_tx(qbar, nq * kTcBQ * 128);
      for (int x = 0; x < nq; ++x)
        tma_load(base + L::kQ + x * kTcBQ * 128, &qmap, qbar, x * kBox16,
                 bp.h, q0, bp.b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const int use = i / kStages;
        if (use > 0) mbar_wait(empty + 8 * s, (use - 1) & 1);
        mbar_expect_tx(full + 8 * s, (nq + nv) * BK * 128);
        const int k0 = (kt_begin + i) * BK;
        const uint32_t kdst = base + L::kK + s * L::kKBytes;
        const uint32_t vdst = base + L::kV + s * L::kVBytes;
        for (int x = 0; x < nq; ++x)
          tma_load(kdst + x * BK * 128, &kmap, full + 8 * s, x * kBox16,
                   bp.h, k0, bp.b);
        for (int x = 0; x < nv; ++x)
          tma_load(vdst + x * BK * 128, &vmap, full + 8 * s,
                   c0 + x * kBox16, bp.h, k0, bp.b);
      }
    }
    return;
  }

  // consumers
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int r_a = wg * 64 + (warp % 4) * 16 + lane / 4;   // rows r_a, r_a + 8
  const int cq = 2 * (lane % 4);
  const long long wg_first = a.q_off + q0 + wg * 64;   // first row's position
  const long long qpos_a = a.q_off + q0 + r_a;
  const long long qpos_b = qpos_a + 8;

  float o[NX][32];
#pragma unroll
  for (int x = 0; x < NX; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[x][i] = 0.f;
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;

  if (n > 0) {
    // this warpgroup's 64 rows of q: scaled, rounded to T, in place
    mbar_wait(qbar, 0);
#pragma unroll
    for (int x = 0; x < L::kQBoxes; ++x) {
      uint4* rows = reinterpret_cast<uint4*>(smem + L::kQ + x * kTcBQ * 128 +
                                             wg * 64 * 128);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint4 u = rows[tid + 128 * e];
        uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = Pair<T>::unpack(w[t]);
          w[t] = Pair<T>::pack(f.x * a.scale, f.y * a.scale);
        }
        rows[tid + 128 * e] = u;
      }
    }
    fence_async_smem();
    bar_sync(1 + wg, 128);
  }

  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const int k0 = (kt_begin + i) * BK;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    // a tile wholly after this warpgroup's rows adds nothing
    if (!(a.causal && a.k_off + k0 > wg_first + 63)) {
      const uint32_t kt = base + L::kK + s * L::kKBytes;
      const uint32_t vt = base + L::kV + s * L::kVBytes;
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;       // bytes into the box row
        const uint32_t qa = base + L::kQ + (kk / 4) * kTcBQ * 128 +
                            wg * 64 * 128 + col;
        const uint32_t kb = kt + (kk / 4) * BK * 128 + col;
        wgmma_ss<T>(sc, kmajor(qa), kmajor(kb), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) reg_fence(sc[j]);

      // only tiles touching the diagonal or the end of KV evaluate the mask
      if ((a.causal && a.k_off + k0 + BK - 1 > wg_first) || k0 + BK > a.Tk)
        mask_tile<NJ>(sc, a, k0, cq, qpos_a, qpos_b);
      float al_a, al_b, ms_a, ms_b;
      softmax_max<NJ>(sc, m_a, m_b, al_a, al_b, ms_a, ms_b);

      // p = exp(s - m) in fp32 for l; rounded to T pairs for P.V: the
      // A fragment of k-step kk is registers 8kk .. 8kk + 7 of S
      uint32_t p[NKS][4];
      float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const bool row_b = t & 1;
          const float ms = row_b ? ms_b : ms_a;
          const float x0 = ex2(fmaf(sc[8 * kk + 2 * t], kLog2e, -ms));
          const float x1 = ex2(fmaf(sc[8 * kk + 2 * t + 1], kLog2e, -ms));
          if (row_b) rs_b += x0 + x1; else rs_a += x0 + x1;
          p[kk][t] = Pair<T>::pack(x0, x1);
        }
      }
      l_a = l_a * al_a + rs_a;
      l_b = l_b * al_b + rs_b;
#pragma unroll
      for (int x = 0; x < NX; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[x][4 * j] *= al_a;
          o[x][4 * j + 1] *= al_a;
          o[x][4 * j + 2] *= al_b;
          o[x][4 * j + 3] *= al_b;
        }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk)
#pragma unroll
        for (int x = 0; x < NX; ++x) {
          // V: keys x 64 columns, 16 keys (2048 bytes) per k-step
          const uint32_t vb = vt + x * BK * 128 + kk * 16 * 128;
          wgmma_rs<T>(o[x], p[kk], smem_desc(vb, 1024, 1024));
        }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int x = 0; x < NX; ++x)
#pragma unroll
        for (int j = 0; j < 32; ++j) reg_fence(o[x][j]);
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t) reg_fence(p[kk][t]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  store_rows<T, NX, SPLIT>(a, o, m_a, m_b, l_a, l_b, bp.bh, bp.b, bp.h, q0,
                           r_a, c0, bp.cg, lane);
}

// ---- float32 route: 3xTF32 ------------------------------------------------

constexpr int kBox32 = 32;        // fp32 columns per TMA box: 128 bytes

// Shared memory of the fp32 kernel (bytes from a 1024-aligned base): Q in
// hi and lo (DQK / 32 boxes of BQ rows each), the K/V ring (K tiles of
// DQK / 32 boxes, V tiles of DV / 32 boxes, BK rows), K_lo of one tile,
// and V^T in hi and lo: BK / 32 (at least one) key boxes of DV rows, a
// row holding 32 keys, of which the first BK are used.
template <int DQK, int DV, int NWG, int BK>
struct F32Smem {
  static constexpr int kBQ = 64 * NWG;
  static constexpr int kQBoxes = DQK / kBox32;
  static constexpr int kVBoxes = DV / kBox32;
  static constexpr int kKeyBoxes = (BK + 31) / 32;
  static constexpr int kQBytes = kQBoxes * kBQ * 128;     // Q hi or lo
  static constexpr int kKBytes = kQBoxes * BK * 128;      // one K tile
  static constexpr int kVBytes = kVBoxes * BK * 128;      // one V tile
  static constexpr int kVtBytes = kKeyBoxes * DV * 128;   // V^T hi or lo
  static constexpr int kQhi = 0;
  static constexpr int kQlo = kQhi + kQBytes;
  static constexpr int kK = kQlo + kQBytes;               // + stage * kKBytes
  static constexpr int kV = kK + kStages * kKBytes;       // + stage * kVBytes
  static constexpr int kKlo = kV + kStages * kVBytes;
  static constexpr int kVthi = kKlo + kKBytes;
  static constexpr int kVtlo = kVthi + kVtBytes;
  static constexpr int kBar = kVtlo + kVtBytes;           // full[], empty[], q
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + 1024;
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// x (in place) and lo (same offset) = the hi and lo of each fp32 of `n`
// 16-byte chunks at x, the `first`-th chunk onwards in steps of `step`;
// scaled by `scale` first
__device__ __forceinline__ void split_chunks(float4* x, float4* lo, int n,
                                             int first, int step,
                                             float scale) {
  for (int e = first; e < n; e += step) {
    float4 v = x[e];
    float* f = reinterpret_cast<float*>(&v);
    float4 w;
    float* g = reinterpret_cast<float*>(&w);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float y = f[c] * scale;
      f[c] = tf32(y);
      g[c] = tf32(y - f[c]);
    }
    x[e] = v;
    lo[e] = w;
  }
}

// The fp32 route of K2 (SPLIT = false) and of K3's first pass (SPLIT =
// true), see the note at the top of the file.  One block: q tile of 64 x
// NWG rows and column group (block_pos), head blockIdx.y, KV tiles
// [split * chunk, min(nk_run, (split + 1) * chunk)) with split =
// blockIdx.z.  Warps 0 .. 4 NWG - 1 are the consumer warpgroups, the
// last warp the producer.
template <int DQK, int DV, int NWG, int BK, bool SPLIT>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_fwd_f32(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, const Args a) {
  using L = F32Smem<DQK, DV, NWG, BK>;
  constexpr int BQ = L::kBQ;
  constexpr int NT = NWG * 128;    // consumer threads
  constexpr int NX = DV / 64;      // 64-column fragments of O
  constexpr int NJ = BK / 8;       // 8-column chunks of S = k8 steps of P.V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t full = base + L::kBar;             // full[s] at + 8 s
  const uint32_t empty = full + 8 * kStages;        // empty[s] at + 8 s
  const uint32_t qbar = empty + 8 * kStages;

  const int groups = (a.D + DV - 1) / DV;
  const BlockPos bp = block_pos(a, groups);
  const int q0 = bp.qt * BQ;
  const int c0 = bp.cg * DV;                        // first column of O, V
  const int nq = (a.D + kBox32 - 1) / kBox32;       // boxes of Q, K
  const int nv = min(L::kVBoxes, (a.D - c0 + kBox32 - 1) / kBox32);
  const int nk_run = tiles_run(bp.qt, a.Tq, a.Tk, a.q_off, a.k_off,
                               a.causal, BQ, BK);
  const int kt_begin = blockIdx.z * a.chunk;
  const int n = min(nk_run, kt_begin + a.chunk) - kt_begin;   // may be <= 0

  // boxes past D are never loaded: Q and K ones (hi and lo) zero, so that
  // every wgmma runs over all DQK columns (a wgmma behind a runtime branch
  // makes ptxas serialise); V^T rows past D zero too, though they only
  // feed columns of O past D
  if (nq < L::kQBoxes) {
    const int skip = nq * 128;        // bytes of a row of boxes below D
    for (int h = 0; h < 2; ++h)
      zero_smem(smem + (h ? L::kQlo : L::kQhi) + skip * BQ,
                (L::kQBoxes * 128 - skip) * BQ, threadIdx.x, NT + 32);
    for (int s = 0; s <= kStages; ++s)   // both K stages and K_lo
      zero_smem(smem + (s < kStages ? L::kK + s * L::kKBytes : L::kKlo) +
                    skip * BK,
                (L::kQBoxes * 128 - skip) * BK, threadIdx.x, NT + 32);
  }
  if (nv < L::kVBoxes) {
    for (int h = 0; h < 2; ++h)
      for (int kb = 0; kb < L::kKeyBoxes; ++kb)
        zero_smem(smem + (h ? L::kVtlo : L::kVthi) + kb * DV * 128 +
                      nv * 32 * 128,
                  (DV - nv * 32) * 128, threadIdx.x, NT + 32);
  }
  fence_async_smem();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NWG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 4 * NWG) {
    // producer: Q once, then K/V tiles into the ring
    if (lane == 0 && n > 0) {
      mbar_expect_tx(qbar, nq * BQ * 128);
      for (int x = 0; x < nq; ++x)
        tma_load(base + L::kQhi + x * BQ * 128, &qmap, qbar, x * kBox32,
                 bp.h, q0, bp.b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const int use = i / kStages;
        if (use > 0) mbar_wait(empty + 8 * s, (use - 1) & 1);
        mbar_expect_tx(full + 8 * s, (nq + nv) * BK * 128);
        const int k0 = (kt_begin + i) * BK;
        const uint32_t kdst = base + L::kK + s * L::kKBytes;
        const uint32_t vdst = base + L::kV + s * L::kVBytes;
        for (int x = 0; x < nq; ++x)
          tma_load(kdst + x * BK * 128, &kmap, full + 8 * s, x * kBox32,
                   bp.h, k0, bp.b);
        for (int x = 0; x < nv; ++x)
          tma_load(vdst + x * BK * 128, &vmap, full + 8 * s,
                   c0 + x * kBox32, bp.h, k0, bp.b);
      }
    }
    return;
  }

  // consumers
  const int wg = warp / 4;
  const int r_a = wg * 64 + (warp % 4) * 16 + lane / 4;   // rows r_a, r_a + 8
  const int cq = 2 * (lane % 4);
  const long long wg_first = a.q_off + q0 + wg * 64;   // first row's position
  const long long qpos_a = a.q_off + q0 + r_a;
  const long long qpos_b = qpos_a + 8;

  float o[NX][32];
#pragma unroll
  for (int x = 0; x < NX; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[x][i] = 0.f;
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;

  if (n > 0) {
    // q * scale split into hi (in place) and lo, by all consumers; the
    // first barrier of the loop below publishes it
    mbar_wait(qbar, 0);
    split_chunks(reinterpret_cast<float4*>(smem + L::kQhi),
                 reinterpret_cast<float4*>(smem + L::kQlo), nq * BQ * 8,
                 threadIdx.x, NT, a.scale);
    fence_async_smem();
  }

  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const int k0 = (kt_begin + i) * BK;
    const uint32_t sb = opaque(base);   // descriptors are made per tile
    const uint32_t kt = sb + L::kK + s * L::kKBytes;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    bar_sync(1, NT);    // every consumer is done with K_lo and V^T
    // K: hi in place, lo beside it
    split_chunks(reinterpret_cast<float4*>(smem + L::kK + s * L::kKBytes),
                 reinterpret_cast<float4*>(smem + L::kKlo), nq * BK * 8,
                 threadIdx.x, NT, 1.f);
    // V (keys x DV, swizzled) -> V^T hi and lo (DV x keys, swizzled): a
    // task is 8 keys (one k8 step, written in the order pi) x 4 columns
    const uint8_t* vs = smem + L::kV + s * L::kVBytes;
    for (int e = threadIdx.x; e < NJ * nv * 8; e += NT) {
      const int g = e % NJ;             // 8-key group
      const int dq = e / NJ;            // 4-column group
      const int box = dq / 8;
      float4 in[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        in[k] = *reinterpret_cast<const float4*>(
            vs + box * BK * 128 + swz((8 * g + k) * 128 + (dq % 8) * 16));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * dq + c;
        float hv[8], lv[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          // position q holds key pi(q) = 2q (q < 4), 2(q - 4) + 1
          const float4& f = in[q < 4 ? 2 * q : 2 * (q - 4) + 1];
          const float y = c == 0 ? f.x : c == 1 ? f.y : c == 2 ? f.z : f.w;
          hv[q] = tf32(y);
          lv[q] = tf32(y - hv[q]);
        }
        const uint32_t off = (g / 4) * DV * 128 +
                             swz(d * 128 + (g % 4) * 32);
        const uint32_t off2 = (g / 4) * DV * 128 +
                              swz(d * 128 + (g % 4) * 32 + 16);
        *reinterpret_cast<float4*>(smem + L::kVthi + off) =
            make_float4(hv[0], hv[1], hv[2], hv[3]);
        *reinterpret_cast<float4*>(smem + L::kVthi + off2) =
            make_float4(hv[4], hv[5], hv[6], hv[7]);
        *reinterpret_cast<float4*>(smem + L::kVtlo + off) =
            make_float4(lv[0], lv[1], lv[2], lv[3]);
        *reinterpret_cast<float4*>(smem + L::kVtlo + off2) =
            make_float4(lv[4], lv[5], lv[6], lv[7]);
      }
    }
    fence_async_smem();
    bar_sync(1, NT);    // the split K and V^T are in place

    // a tile wholly after this warpgroup's rows adds nothing
    if (!(a.causal && a.k_off + k0 > wg_first + 63)) {
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      const uint32_t qhi = sb + L::kQhi + wg * 64 * 128;
      const uint32_t qlo = sb + L::kQlo + wg * 64 * 128;
      const uint32_t klo = sb + L::kKlo;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) reg_fence(sc[j]);
      wgmma_fence();
      // the small terms first, then hi x hi
#pragma unroll
      for (int kk = 0; kk < DQK / 8; ++kk) {
        const uint32_t qo = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * BK * 128 + (kk % 4) * 32;
        wgmma_tf32(sc, kmajor(qlo + qo), kmajor(kt + ko), kk > 0);
        wgmma_tf32(sc, kmajor(qhi + qo), kmajor(klo + ko), 1);
      }
#pragma unroll
      for (int kk = 0; kk < DQK / 8; ++kk) {
        const uint32_t qo = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * BK * 128 + (kk % 4) * 32;
        wgmma_tf32(sc, kmajor(qhi + qo), kmajor(kt + ko), 1);
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) reg_fence(sc[j]);

      // only tiles touching the diagonal or the end of KV evaluate the mask
      if ((a.causal && a.k_off + k0 + BK - 1 > wg_first) || k0 + BK > a.Tk)
        mask_tile<NJ>(sc, a, k0, cq, qpos_a, qpos_b);
      float al_a, al_b, ms_a, ms_b;
      softmax_max<NJ>(sc, m_a, m_b, al_a, al_b, ms_a, ms_b);

      // p = exp(s - m) in fp32 for l, split into hi and lo for P.V.  The
      // A fragment of k8 step j is chunk j of S as it lies: a0 = (r, 2t),
      // a1 = (r + 8, 2t), a2 = (r, 2t + 1), a3 = (r + 8, 2t + 1), i.e.
      // positions t and t + 4 hold keys 2t and 2t + 1 (V^T's order pi)
      uint32_t ph[NJ][4], pl[NJ][4];
      float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool row_b = c >= 2;
          const float x = ex2(fmaf(sc[4 * j + c], kLog2e,
                                   -(row_b ? ms_b : ms_a)));
          if (row_b) rs_b += x; else rs_a += x;
          const float hi = tf32(x);
          // the fragment's order: (r, 2t) (r + 8, 2t) (r, 2t + 1) (r + 8, 2t + 1)
          const int slot = (c & 1) * 2 + (c >> 1);
          ph[j][slot] = __float_as_uint(hi);
          pl[j][slot] = __float_as_uint(tf32(x - hi));
        }
      }
      l_a = l_a * al_a + rs_a;
      l_b = l_b * al_b + rs_b;

      // this tile's P.V in an accumulator of its own, added to o below
      float t[NX][32];
#pragma unroll
      for (int x = 0; x < NX; ++x)
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          t[x][j] = 0.f;
          reg_fence(t[x][j]);
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          reg_fence(ph[j][c]);
          reg_fence(pl[j][c]);
        }
      wgmma_fence();
      const uint32_t vhi = sb + L::kVthi;
      const uint32_t vlo = sb + L::kVtlo;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int x = 0; x < NX; ++x) {
          const uint32_t vo = (j / 4) * DV * 128 + x * 64 * 128 +
                              (j % 4) * 32;
          wgmma_tf32_rs(t[x], pl[j], kmajor(vhi + vo));
          wgmma_tf32_rs(t[x], ph[j], kmajor(vlo + vo));
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int x = 0; x < NX; ++x) {
          const uint32_t vo = (j / 4) * DV * 128 + x * 64 * 128 +
                              (j % 4) * 32;
          wgmma_tf32_rs(t[x], ph[j], kmajor(vhi + vo));
        }
      wgmma_commit();
      wgmma_wait();
      // o = alpha o + t, rounded to nearest: the tensor cores' fp32 sums
      // round toward zero, which over a long row's thousands of chained
      // adds biased |o| low by ~3e-5 of its largest value (H100, T = 8192)
#pragma unroll
      for (int x = 0; x < NX; ++x)
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          reg_fence(t[x][j]);
          o[x][j] = fmaf(o[x][j], (j & 2) ? al_b : al_a, t[x][j]);
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          reg_fence(ph[j][c]);
          reg_fence(pl[j][c]);
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  store_rows<float, NX, SPLIT>(a, o, m_a, m_b, l_a, l_b, bp.bh, bp.b, bp.h,
                               q0, r_a, c0, bp.cg, lane);
}

// ---- head sizes above 256: CUDA cores, all three dtypes ------------------

constexpr int kWideBQ = 64;        // query rows per block
constexpr int kWideBK = 64;        // keys per KV tile
constexpr int kWideDV = 128;       // columns of O per column group
constexpr int kWideDC = 64;        // columns of Q and K per staged chunk
constexpr int kWideThreads = 256;
constexpr int kWidePitch = 65;     // floats per row of Q, K, P in shared
                                   // memory (65: no bank conflicts)
// Q chunk, K chunk, P (64 x 64 each, padded), V tile (64 keys x DV)
constexpr int kWideSmem =
    (3 * kWideBQ * kWidePitch + kWideBK * kWideDV) * 4;

// The route of K2 (SPLIT = false) and K3's first pass (SPLIT = true) at
// D > 256, see the note at the top of the file.  One block: q tile of 64
// rows and column group of 128 (block_pos), head blockIdx.y, KV tiles
// [split * chunk, min(nk_run, (split + 1) * chunk)).  Thread t owns rows
// 4 (t / 16) .. + 3, and of each tile keys t % 16 + 16 j (S, P) and
// columns c0 + t % 16 + 16 x of O; a row's 16 threads are one half-warp.
// Rounding points as in the tensor-core routes and `_partial_ref`: q
// scaled in fp32 and rounded to T, fp32 scores and sums, p rounded to T
// for P.V while l sums the fp32 p.
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(kWideThreads)
flash_fwd_wide(const Args a) {
  extern __shared__ float wsm[];
  float* qs = wsm;
  float* ks = qs + kWideBQ * kWidePitch;
  float* ps = ks + kWideBK * kWidePitch;
  float* vs = ps + kWideBQ * kWidePitch;
  const int groups = (a.D + kWideDV - 1) / kWideDV;
  const BlockPos bp = block_pos(a, groups);
  const int q0 = bp.qt * kWideBQ;
  const int c0 = bp.cg * kWideDV;
  const int nk_run = tiles_run(bp.qt, a.Tq, a.Tk, a.q_off, a.k_off,
                               a.causal, kWideBQ, kWideBK);
  const int kt_begin = blockIdx.z * a.chunk;
  const int n = min(nk_run, kt_begin + a.chunk) - kt_begin;   // may be <= 0
  const T* qg = static_cast<const T*>(a.q) + bp.b * a.qs[0] + bp.h * a.qs[2];
  const T* kg = static_cast<const T*>(a.k) + bp.b * a.ks[0] + bp.h * a.ks[2];
  const T* vg = static_cast<const T*>(a.v) + bp.b * a.vs[0] + bp.h * a.vs[2];
  const int tid = threadIdx.x;
  const int r0 = 4 * (tid / 16);
  const int lc = tid % 16;

  float o[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int x = 0; x < 8; ++x) o[i][x] = 0.f;
  }

  for (int it = 0; it < n; ++it) {
    const int k0 = (kt_begin + it) * kWideBK;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    // S = (q scale) k^T over D, 64 columns at a time
    for (int d0 = 0; d0 < a.D; d0 += kWideDC) {
      __syncthreads();    // every thread is done with the last chunk
      for (int e = tid; e < kWideBQ * kWideDC; e += kWideThreads) {
        const int r = e / kWideDC;
        const int d = d0 + e % kWideDC;
        const int qr = q0 + r, kr = k0 + r;
        const bool in_d = d < a.D;
        qs[r * kWidePitch + e % kWideDC] =
            qr < a.Tq && in_d
                ? to_float(from_float<T>(to_float(qg[qr * a.qs[1] + d]) *
                                         a.scale))
                : 0.f;
        ks[r * kWidePitch + e % kWideDC] =
            kr < a.Tk && in_d ? to_float(kg[kr * a.ks[1] + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kWideDC; ++c) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(r0 + i) * kWidePitch + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(lc + 16 * j) * kWidePitch + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
    // mask, online softmax, p into shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = a.q_off + q0 + r0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + lc + 16 * j;
        if (key >= a.Tk || (a.causal && a.k_off + key > qpos))
          s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float al = ex2((m[i] - mn) * kLog2e);
      const float ms = mn * kLog2e;
      m[i] = mn;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ex2(fmaf(s[i][j], kLog2e, -ms));
        rs += p;
        ps[(r0 + i) * kWidePitch + lc + 16 * j] = to_float(from_float<T>(p));
      }
      l[i] = l[i] * al + rs;
#pragma unroll
      for (int x = 0; x < 8; ++x) o[i][x] *= al;
    }
    // V: the tile's keys x this group's columns
    for (int e = tid; e < kWideBK * kWideDV; e += kWideThreads) {
      const int r = e / kWideDV;
      const int d = c0 + e % kWideDV;
      const int kr = k0 + r;
      vs[e] = kr < a.Tk && d < a.D ? to_float(vg[kr * a.vs[1] + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kWideBK; ++kk) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(r0 + i) * kWidePitch + kk];
#pragma unroll
      for (int x = 0; x < 8; ++x) vv[x] = vs[kk * kWideDV + lc + 16 * x];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int x = 0; x < 8; ++x) o[i][x] = fmaf(pv[i], vv[x], o[i][x]);
    }
    // the next tile's first barrier keeps p and V until every thread is done
  }

  const long long rows_all = static_cast<long long>(a.B) * a.H * a.Tq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int row = q0 + r0 + i;
    if (row >= a.Tq) continue;
    const long long r = static_cast<long long>(bp.bh) * a.Tq + row;
    const bool ml = bp.cg == 0 && lc == 0;
    if (SPLIT) {
      const long long slot = blockIdx.z * rows_all + r;
      float* wo = a.ws + slot * a.D;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int col = c0 + lc + 16 * x;
        if (col < a.D) wo[col] = o[i][x];
      }
      if (ml) {
        float* wm = a.ws + gridDim.z * rows_all * a.D;
        wm[slot] = m[i];
        wm[gridDim.z * rows_all + slot] = l[i];
      }
    } else {
      T* out = static_cast<T*>(a.o) + bp.b * a.os[0] + row * a.os[1] +
               bp.h * a.os[2];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int col = c0 + lc + 16 * x;
        if (col < a.D) out[col] = from_float<T>(o[i][x]);
      }
      if (ml) {
        a.m[r] = m[i];
        a.l[r] = l[i];
      }
    }
  }
}

// K3's second pass.  Merge the split partials of every (row, d): m = max_s m_s,
// l = sum_s l_s exp(m_s - m), o = sum_s o_s exp(m_s - m), in split order.
template <typename T>
__global__ void merge_splits(const Args a, int splits) {
  const long long rows_all = static_cast<long long>(a.B) * a.H * a.Tq;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows_all * a.D) return;
  const long long r = idx / a.D;
  const int d = static_cast<int>(idx - r * a.D);
  const float* wo = a.ws;
  const float* wm = a.ws + splits * rows_all * a.D;
  const float* wl = wm + splits * rows_all;
  float mx = kNeg;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, wm[s * rows_all + r]);
  float o = 0.f, l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(wm[s * rows_all + r] - mx);
    o += w * wo[(s * rows_all + r) * a.D + d];
    l += w * wl[s * rows_all + r];
  }
  const int bh = static_cast<int>(r / a.Tq);
  const int t = static_cast<int>(r - static_cast<long long>(bh) * a.Tq);
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  static_cast<T*>(a.o)[b * a.os[0] + t * a.os[1] + h * a.os[2] + d] =
      from_float<T>(o);
  if (d == 0) {
    a.m[r] = mx;
    a.l[r] = l;
  }
}

// ---- host side -------------------------------------------------------------

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// The tiles of a dtype's route at head size D: query rows per block, keys
// per KV tile, columns of O per column group (see the note at the top)
struct Tiles {
  int bq, bk, dv;
};
Tiles route_tiles(int dtype, int D) {
  if (D > kMaxTcD) return Tiles{kWideBQ, kWideBK, kWideDV};
  if (dtype == kF32) {
    if (D <= 64) return Tiles{128, 64, 64};
    if (D <= 128) return Tiles{64, 32, 128};
    return Tiles{64, 16, 128};
  }
  if (D <= 64) return Tiles{kTcBQ, 128, 64};
  return Tiles{kTcBQ, 64, 128};
}

// dims = B, H, Tq, Tk, D, q_off, k_off, causal.  False when the shape is
// outside the kernels' range (D a multiple of 8 up to 65536: the wrappers
// pad other head sizes) or dtype is not one of the three.
bool read_dims(const long long* dims, int dtype, Args* a) {
  const long long B = dims[0], H = dims[1], Tq = dims[2], Tk = dims[3],
                  D = dims[4];
  if (dtype != kF32 && dtype != kBF16 && dtype != kF16) return false;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return false;
  if (D < 8 || D > (1 << 16) || D % 8) return false;
  if (B * H > 65535 || Tq > (1LL << 30) || Tk > (1LL << 30)) return false;
  a->B = static_cast<int>(B);
  a->H = static_cast<int>(H);
  a->Tq = static_cast<int>(Tq);
  a->Tk = static_cast<int>(Tk);
  a->D = static_cast<int>(D);
  a->q_off = dims[5];
  a->k_off = dims[6];
  a->causal = dims[7] != 0;
  return true;
}

struct StreamPlan {
  int splits;        // KV ranges (grid z)
  int chunk;         // KV tiles per range
  long long ws;      // fp32 workspace elements
};

// Split the KV range so that the work of all q tiles and column groups,
// in the route's tile steps, makes about kBlocksPerSm blocks per SM, and
// no block's range exceeds that balanced share; at least two ranges when
// KV has two tiles.  The workspace holds D + 2 floats per row and range
// (the column groups write disjoint columns).
StreamPlan make_stream_plan(const Args& a, Tiles tl, int sm_count) {
  const int nqt = cdiv(a.Tq, tl.bq);
  const int nk = cdiv(a.Tk, tl.bk);
  long long work = 0;
  for (int qt = 0; qt < nqt; ++qt)
    work += tiles_run(qt, a.Tq, a.Tk, a.q_off, a.k_off, a.causal, tl.bq,
                      tl.bk);
  work *= static_cast<long long>(a.B) * a.H * cdiv(a.D, tl.dv);
  const long long target =
      static_cast<long long>(kBlocksPerSm) * (sm_count > 0 ? sm_count : 1);
  long long chunk = work > 0 ? (work + target - 1) / target : nk;
  const long long half = (nk + 1) / 2;
  if (chunk > half) chunk = half;
  if (chunk < 1) chunk = 1;
  StreamPlan p;
  p.chunk = static_cast<int>(chunk);
  p.splits = cdiv(nk, chunk);
  p.ws = static_cast<long long>(p.splits) * a.B * a.H * a.Tq * (a.D + 2);
  return p;
}

void read_strides(const long long* st, Args* a) {
  for (int i = 0; i < 3; ++i) {
    a->qs[i] = st[i];
    a->ks[i] = st[3 + i];
    a->vs[i] = st[6 + i];
    a->os[i] = st[9 + i];
  }
}

// The 4-D map (D, H, T, B) of a tensor of `dtype` with b, t, h strides st
// (elements), read in boxes of 128 bytes of columns x `rows` rows,
// 128-byte swizzled; boxes past T or D are zero-filled.
bool tensor_map(CUtensorMap* map, const void* ptr, const long long* st,
                const Args& a, int T, int rows, int dtype) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int item = dtype == kF32 ? 4 : 2;
  const cuuint64_t dim[4] = {static_cast<cuuint64_t>(a.D),
                             static_cast<cuuint64_t>(a.H),
                             static_cast<cuuint64_t>(T),
                             static_cast<cuuint64_t>(a.B)};
  const cuuint64_t stride[3] = {static_cast<cuuint64_t>(st[2]) * item,
                                static_cast<cuuint64_t>(st[1]) * item,
                                static_cast<cuuint64_t>(st[0]) * item};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / item), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, map_type(dtype), 4, const_cast<void*>(ptr), dim, stride,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the maps of q (boxes of bq rows), k and v (bk rows) and the grid of a
// route's first pass
template <typename Kernel>
cudaError_t launch_maps(Kernel kernel, const Args& a, int dtype, Tiles tl,
                        int threads, int smem, int splits,
                        cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, a.q, a.qs, a, a.Tq, tl.bq, dtype) ||
      !tensor_map(&km, a.k, a.ks, a, a.Tk, tl.bk, dtype) ||
      !tensor_map(&vm, a.v, a.vs, a, a.Tk, tl.bk, dtype))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(a.Tq, tl.bq) * cdiv(a.D, tl.dv), a.B * a.H, splits);
  kernel<<<grid, threads, smem, stream>>>(qm, km, vm, a);
  return cudaGetLastError();
}

template <typename T, int DQK, int DV, int BK, bool SPLIT>
cudaError_t launch_tc(const Args& a, int dtype, int splits,
                      cudaStream_t stream) {
  return launch_maps(flash_fwd_tc<T, DQK, DV, BK, SPLIT>, a, dtype,
                     Tiles{kTcBQ, BK, DV}, kTcThreads,
                     TcSmem<DQK, DV, BK>::kBytes, splits, stream);
}

template <int DQK, int DV, int NWG, int BK, bool SPLIT>
cudaError_t launch_f32(const Args& a, int splits, cudaStream_t stream) {
  return launch_maps(flash_fwd_f32<DQK, DV, NWG, BK, SPLIT>, a, kF32,
                     Tiles{64 * NWG, BK, DV}, NWG * 128 + 32,
                     F32Smem<DQK, DV, NWG, BK>::kBytes, splits, stream);
}

template <typename T, bool SPLIT>
cudaError_t launch_16(const Args& a, int dtype, int splits,
                      cudaStream_t stream) {
  if (a.D <= 64) return launch_tc<T, 64, 64, 128, SPLIT>(a, dtype, splits,
                                                         stream);
  if (a.D <= 128) return launch_tc<T, 128, 128, 64, SPLIT>(a, dtype, splits,
                                                           stream);
  return launch_tc<T, 256, 128, 64, SPLIT>(a, dtype, splits, stream);
}

template <typename T, bool SPLIT>
cudaError_t launch_wide(const Args& a, int splits, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide<T, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWideSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(a.Tq, kWideBQ) * cdiv(a.D, kWideDV), a.B * a.H,
                  splits);
  flash_fwd_wide<T, SPLIT><<<grid, kWideThreads, kWideSmem, stream>>>(a);
  return cudaGetLastError();
}

// the first pass of the dtype's route (the tiles of route_tiles)
template <bool SPLIT>
cudaError_t launch_attend(const Args& a, int dtype, int splits,
                          cudaStream_t stream) {
  if (a.D > kMaxTcD) {
    if (dtype == kBF16)
      return launch_wide<__nv_bfloat16, SPLIT>(a, splits, stream);
    if (dtype == kF16) return launch_wide<__half, SPLIT>(a, splits, stream);
    return launch_wide<float, SPLIT>(a, splits, stream);
  }
  if (dtype == kBF16)
    return launch_16<__nv_bfloat16, SPLIT>(a, dtype, splits, stream);
  if (dtype == kF16) return launch_16<__half, SPLIT>(a, dtype, splits, stream);
  if (a.D <= 64) return launch_f32<64, 64, 2, 64, SPLIT>(a, splits, stream);
  if (a.D <= 128) return launch_f32<128, 128, 1, 32, SPLIT>(a, splits, stream);
  return launch_f32<256, 128, 1, 16, SPLIT>(a, splits, stream);
}

cudaError_t launch_stream(const Args& a, int dtype, const StreamPlan& p,
                          cudaStream_t stream) {
  cudaError_t err = launch_attend<true>(a, dtype, p.splits, stream);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(a.B) * a.H * a.Tq * a.D;
  const int threads = 256;
  const int blocks = cdiv(total, threads);
  if (dtype == kBF16)
    merge_splits<__nv_bfloat16><<<blocks, threads, 0, stream>>>(a, p.splits);
  else if (dtype == kF16)
    merge_splits<__half><<<blocks, threads, 0, stream>>>(a, p.splits);
  else
    merge_splits<float><<<blocks, threads, 0, stream>>>(a, p.splits);
  return cudaGetLastError();
}

}  // namespace

// K2: o, m, l of q against the whole of k, v.  dims: B, H, Tq, Tk, D,
// q_off, k_off, causal.  strides: b, t, h strides (elements) of q, k, v,
// o.  dtype 0 float32, 1 bfloat16, 2 float16.  Returns the CUDA error of
// the launch (0 = none), or cudaErrorInvalidValue when the shape or
// layout is outside the kernel's range.
extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, float* m, float* l,
                            const long long* dims, const long long* strides,
                            float scale, int dtype, void* stream) {
  Args a = {};
  if (!read_dims(dims, dtype, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  read_strides(strides, &a);
  a.q = q; a.k = k; a.v = v; a.o = o; a.m = m; a.l = l; a.ws = nullptr;
  a.scale = scale;
  a.chunk = cdiv(a.Tk, route_tiles(dtype, a.D).bk);
  return static_cast<int>(
      launch_attend<false>(a, dtype, 1, static_cast<cudaStream_t>(stream)));
}

// The split-KV plan of mx_flash_fwd_stream for these dims and dtype on
// sm_count SMs: plan[0..5] = KV ranges, KV tiles per range, fp32 workspace
// elements, keys per KV tile, query rows per block, column groups.
// Returns 0, or cudaErrorInvalidValue for a shape outside the kernels'
// range.
extern "C" int mx_flash_fwd_stream_plan(const long long* dims, int dtype,
                                        int sm_count, long long* plan) {
  Args a = {};
  if (!read_dims(dims, dtype, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tiles tl = route_tiles(dtype, a.D);
  const StreamPlan p = make_stream_plan(a, tl, sm_count);
  if (p.splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.splits;
  plan[1] = p.chunk;
  plan[2] = p.ws;
  plan[3] = tl.bk;
  plan[4] = tl.bq;
  plan[5] = cdiv(a.D, tl.dv);
  return 0;
}

// K3: as mx_flash_fwd, with the KV range split across blocks and merged
// by a second kernel.  ws: fp32 buffer of ws_elems elements, at least
// what mx_flash_fwd_stream_plan asks for.
extern "C" int mx_flash_fwd_stream(const void* q, const void* k,
                                   const void* v, void* o, float* m, float* l,
                                   float* ws, long long ws_elems,
                                   const long long* dims,
                                   const long long* strides, float scale,
                                   int dtype, int sm_count, void* stream) {
  Args a = {};
  if (!read_dims(dims, dtype, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  read_strides(strides, &a);
  const StreamPlan p =
      make_stream_plan(a, route_tiles(dtype, a.D), sm_count);
  if (p.splits > 65535 || ws == nullptr || ws_elems < p.ws)
    return static_cast<int>(cudaErrorInvalidValue);
  a.q = q; a.k = k; a.v = v; a.o = o; a.m = m; a.l = l; a.ws = ws;
  a.scale = scale;
  a.chunk = p.chunk;
  return static_cast<int>(
      launch_stream(a, dtype, p, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
