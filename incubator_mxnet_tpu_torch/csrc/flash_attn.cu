// Flash-attention forward for Hopper (sm_90a): the partial attention of
// one KV shard, in the ring-step contract of the JAX package,
//     s = (q / sqrt(D)) k^T  (causal: key position > query position masked)
//     m = rowmax(s),  l = rowsum(exp(s - m)),  o = exp(s - m) v   (unnormalised)
// q (B, Tq, H, D), k and v (B, Tk, H, D), float32 or bfloat16, read through
// their strides (the head dimension contiguous); o (B, Tq, H, D) in q's
// dtype, m and l (B, H, Tq) in float32.  q_off and k_off are the global
// positions of q's and k's first rows, for the causal mask.  The scale is
// the caller's (1/sqrt of the head size before any padding).  A row that
// sees no key ends with m = -1e30, l = 0, o = 0.
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
// bfloat16 route (flash_fwd_tc): the tensor cores, 989 TFLOP/s.  Both
// products are bf16 x bf16 -> fp32, as the TPU kernel's dots
// (preferred_element_type=float32), so the rounding points are the
// contract's: q scaled and rounded to bf16 once, fp32 scores and row sums,
// p rounded to bf16 before P.V while l sums the fp32 p.
//   * a block of 128 query rows is two consumer warpgroups (64 rows each)
//     and one producer warp: 288 threads;
//   * K/V tiles go through a 2-stage ring in shared memory, loaded by TMA
//     (one thread of the producer warp; a 4-D tensor map over (D, H, T, B)
//     with the tensors' own strides, so q, k, v sliced out of a packed
//     tensor read without a copy) and handed over with mbarriers (full:
//     the bytes landed; empty: all 8 consumer warps are done), so tile
//     j+1 is in flight while the consumers compute on tile j;
//   * each TMA box is 64 columns (128 bytes, the 128-byte swizzle's span)
//     by the tile's rows: one box at D <= 64, two at D <= 128; TMA
//     zero-fills rows past T and columns past D, so any D that is a
//     multiple of 8 runs as 64 or 128;
//   * tile sizes come from the registers: 288 threads put 3 warps on one
//     of the SM's 4 sub-partitions, so a thread gets at most 168 (16384 /
//     96, rounded down to 8).  At D <= 64, 128-key tiles keep S at 64 fp32
//     registers, O at 32 and P at 32; at D <= 128, O takes 64 and 128-key
//     tiles spilled, so the tile is 64 keys (S 32, P 16).  Shared memory:
//     Q 16 KB + 2 stages x (K + V) 64 KB = 80 KB at D <= 64, 32 + 64 =
//     96 KB at D <= 128, of 227 KB: one block per SM either way, held
//     there by the registers;
//   * S = Q K^T: wgmma m64nBKk16, A = Q and B = the K tile from shared
//     memory, both K-major.  Q is scaled by 1/sqrt(D) and rounded to bf16
//     in shared memory by its warpgroup once, behind fence.proxy.async;
//   * softmax in registers on the accumulator fragments: a row lives in 4
//     lanes, so its max is a 2-step shuffle; exp as ex2 of s*log2(e) -
//     m*log2(e), with m kept in natural units so that a row that never saw
//     a key keeps m = -1e30 exactly (alpha = ex2(0) = 1, p = ex2(-inf) = 0);
//     l is kept per lane and summed over the 4 lanes once, at the end;
//   * O += P V: wgmma m64n64k16 per 64 columns of D with A = P from
//     registers (the fp32 accumulator layout of S, paired into bf16x2, is
//     the A-operand layout) and B = the V tile, keys x D, which is MN-major
//     for this B: the transpose bit.  P never goes through shared memory.
// fp32 route (flash_fwd_kernel): the CUDA cores, 67 TFLOP/s; parity needs
// full fp32, not TF32.  One block of 128 threads per (b*h, 64-row q tile),
// 64-key tiles widened into shared memory; each thread owns a 4 x 8
// micro-tile of S (a 3-step shuffle among 8 lanes per row) and the same 4
// rows of O; p is staged in shared memory for P.V.  A tensor-core design
// for it (3xTF32) is later work.
// Both routes: tiles above the causal diagonal are never loaded; only
// tiles that touch the diagonal or the ragged end of KV evaluate the mask
// (TMA's zero fill gives a score of 0, not -inf); the heaviest causal q
// tiles are launched first (reversed grid x); the split-KV plan
// (mx_flash_fwd_stream_plan) counts in the route's own tiles and cuts the
// KV range so that about kBlocksPerSm blocks of work per SM exist and no
// block's share exceeds the balanced share of the causal triangle.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // fp32 route: query rows per block
constexpr int kBK = 64;          // fp32 route: keys per KV tile
constexpr int kThreads = 128;    // fp32 route: 16 row groups x 8 column groups
constexpr int kRows = 4;         // query rows per thread
constexpr int kCols = kBK / 8;   // S columns per thread
constexpr int kPP = kBK + 2;     // pitch of P in shared memory
constexpr int kBlocksPerSm = 8;  // split-KV target: blocks of work per SM
constexpr float kNeg = -1e30f;

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

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 8 consecutive fp32 elements at p (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float* d) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

// rows [t0, t0 + 64) of head (b, h) into dst (pitch ld, fp32); rows past
// T are zero.  scale > 0: each value is multiplied by scale.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* base,
                                          const long long* st, int b, int h,
                                          int t0, int T_len, int D,
                                          float scale) {
  const int per_row = D / 8;
  for (int e = threadIdx.x; e < 64 * per_row; e += kThreads) {
    const int row = e / per_row;
    const int c = (e - row * per_row) * 8;
    const int t = t0 + row;
    float x[8];
    if (t < T_len) {
      load8(base + b * st[0] + t * st[1] + h * st[2] + c, x);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
    }
    if (scale > 0.f) {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] *= scale;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[row * ld + c + i] = x[i];
  }
}

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

size_t smem_bytes(int dmax) {
  return static_cast<size_t>(3 * 64 * (dmax + 1) + kBQ * kPP) * sizeof(float);
}

// The fp32 route of K2 (SPLIT = false, one split covering the KV range) and
// of K3's first pass (SPLIT = true); see the note at the top of the file.
// One block: q tile (reversed blockIdx.x), head blockIdx.y, KV tiles
// [split * chunk, min(nk_run, (split + 1) * chunk)) with split = blockIdx.z.
// SPLIT: write the fp32 partial to the workspace, else o, m, l.
template <int DMAX, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Args a) {
  extern __shared__ float smem[];
  const int D = a.D;
  const int ld = D + 1;
  float* Qs = smem;
  float* Ks = Qs + kBQ * ld;
  float* Vs = Ks + kBK * ld;
  float* Ps = Vs + kBK * ld;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int split = blockIdx.z;
  const int cg = threadIdx.x & 7;     // column group: keys cg, cg + 8, ...
  const int rg = threadIdx.x >> 3;    // row group: rows 4*rg .. 4*rg + 3
  const int q0 = qt * kBQ;
  const long long qg0 = a.q_off + q0;
  const int nk_run = tiles_run(qt, a.Tq, a.Tk, a.q_off, a.k_off, a.causal,
                               kBQ, kBK);
  const int kt_begin = split * a.chunk;
  const int kt_end = min(nk_run, kt_begin + a.chunk);
  constexpr int DT = DMAX / 8;
  const int dt = D / 8;

  float acc[kRows][DT];
  float mrow[kRows];
  float lrow[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    mrow[i] = kNeg;
    lrow[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[i][t] = 0.f;
  }

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  if (kt_begin < kt_end)
    load_tile(Qs, ld, q, a.qs, b, h, q0, a.Tq, D, a.scale);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    load_tile(Ks, ld, k, a.ks, b, h, k0, a.Tk, D, 0.f);
    load_tile(Vs, ld, v, a.vs, b, h, k0, a.Tk, D, 0.f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(rg * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(cg + 8 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // only tiles touching the diagonal or the end of KV evaluate the mask
    const bool masked = (a.causal && a.k_off + k0 + kBK - 1 > qg0) ||
                        k0 + kBK > a.Tk;
    if (masked) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const long long qpos = qg0 + rg * kRows + i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int col = k0 + cg + 8 * j;
          if (col >= a.Tk || (a.causal && a.k_off + col > qpos))
            s[i][j] = -INFINITY;    // exp(-inf - m) = 0: p = 0 when masked
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(mrow[i], mx);
      const float alpha = expf(mrow[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(rg * kRows + i) * kPP + cg + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      lrow[i] = lrow[i] * alpha + rs;
      mrow[i] = m_new;
#pragma unroll
      for (int t = 0; t < DT; ++t) acc[i][t] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(rg * kRows + i) * kPP + c];
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        if (t < dt) {
          const float vv = Vs[c * ld + cg + 8 * t];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][t] = fmaf(pv[i], vv, acc[i][t]);
        }
      }
    }
    __syncthreads();
  }

  const long long rows_all = static_cast<long long>(a.B) * a.H * a.Tq;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg * kRows + i;
    if (row >= a.Tq) continue;
    const long long r = static_cast<long long>(bh) * a.Tq + row;
    if (SPLIT) {
      // workspace: o [splits][rows][D], then m [splits][rows], l likewise
      const long long splits = gridDim.z;
      const long long slot = split * rows_all + r;
      float* wo = a.ws + slot * D;
#pragma unroll
      for (int t = 0; t < DT; ++t)
        if (t < dt) wo[cg + 8 * t] = acc[i][t];
      if (cg == 0) {
        float* wm = a.ws + splits * rows_all * D;
        wm[slot] = mrow[i];
        wm[splits * rows_all + slot] = lrow[i];
      }
    } else {
      float* o = static_cast<float*>(a.o) + b * a.os[0] + row * a.os[1] +
                 h * a.os[2];
#pragma unroll
      for (int t = 0; t < DT; ++t)
        if (t < dt) o[cg + 8 * t] = acc[i][t];
      if (cg == 0) {
        a.m[r] = mrow[i];
        a.l[r] = lrow[i];
      }
    }
  }
}

// ---- bfloat16 route: wgmma on the tensor cores, K/V through a TMA ring --

constexpr int kTcBQ = 128;        // query rows per block: 2 consumer warpgroups
constexpr int kTcBK64 = 128;      // keys per K/V tile at D <= 64
constexpr int kTcBK128 = 64;      // keys per K/V tile at D <= 128
constexpr int kTcStages = 2;      // K/V ring depth
constexpr int kTcThreads = 288;   // 2 consumer warpgroups + 1 producer warp
constexpr int kBox = 64;          // bf16 columns per TMA box: 128 bytes
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the bf16 kernel, in bytes from a 1024-aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes).  A tile of R rows
// is DMAX / 64 boxes of R x 128 bytes, one after the other.
template <int DMAX, int BK>
struct TcSmem {
  static constexpr int kBoxes = DMAX / kBox;
  static constexpr int kQBytes = kBoxes * kTcBQ * 128;
  static constexpr int kKVBytes = kBoxes * BK * 128;   // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;                 // + stage * kKVBytes
  static constexpr int kV = kK + kTcStages * kKVBytes;
  static constexpr int kBar = kV + kTcStages * kKVBytes;  // full[], empty[], q
  static constexpr int kBytes = kBar + 8 * (2 * kTcStages + 1) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase differs from `parity` (its completion
// number `parity` mod 2 has happened)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

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

// a wgmma descriptor of a 128-byte-swizzled tile at shared address addr:
// 8-row groups `sbo` bytes apart; lbo as the layout wants it
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep reads of a wgmma's registers after its wait
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 rounded to bf16, x0 in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d = A B (scale_d 0) or d += A B: A (64 x 16) and B (16 x 128), both
// K-major in shared memory (the descriptors a, b)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

// d = A B (scale_d 0) or d += A B: A (64 x 16) and B (16 x 64), both
// K-major in shared memory (the descriptors a, b)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A B: A (64 x 16) from registers in the accumulator layout, B
// (16 x 64) MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The bf16 route of K2 (SPLIT = false) and of K3's first pass (SPLIT =
// true), see the note at the top of the file.  One block: q tile of 128
// rows (reversed blockIdx.x), head blockIdx.y, KV tiles [split * chunk,
// min(nk_run, (split + 1) * chunk)) with split = blockIdx.z.  Warps 0-7
// are the consumer warpgroups (rows 0-63, 64-127 of the tile), warp 8
// the producer.  Accumulator fragment of wgmma m64nN: a thread holds rows
// r and r + 8 (r = 16 * warp + lane / 4 within its warpgroup) and, for
// each 8-column chunk j, columns 8j + 2 * (lane % 4) + {0, 1}: registers
// 4j, 4j + 1 (row r) and 4j + 2, 4j + 3 (row r + 8).
template <int DMAX, int BK, bool SPLIT>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const Args a) {
  using L = TcSmem<DMAX, BK>;
  constexpr int NB = L::kBoxes;
  constexpr int NJ = BK / 8;       // 8-column chunks of S
  constexpr int NKS = BK / 16;     // k-steps of P.V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t full = base + L::kBar;             // full[s] at + 8 s
  const uint32_t empty = full + 8 * kTcStages;      // empty[s] at + 8 s
  const uint32_t qbar = empty + 8 * kTcStages;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * kTcBQ;
  const int nk_run = tiles_run(qt, a.Tq, a.Tk, a.q_off, a.k_off, a.causal,
                               kTcBQ, BK);
  const int kt_begin = blockIdx.z * a.chunk;
  const int n = min(nk_run, kt_begin + a.chunk) - kt_begin;   // may be <= 0

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
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
      mbar_expect_tx(qbar, L::kQBytes);
      for (int x = 0; x < NB; ++x)
        tma_load(base + L::kQ + x * kTcBQ * 128, &qmap, qbar, x * kBox, h,
                 q0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kTcStages;
        const int use = i / kTcStages;
        if (use > 0) mbar_wait(empty + 8 * s, (use - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * L::kKVBytes);
        const int k0 = (kt_begin + i) * BK;
        const uint32_t kdst = base + L::kK + s * L::kKVBytes;
        const uint32_t vdst = base + L::kV + s * L::kKVBytes;
        for (int x = 0; x < NB; ++x) {
          tma_load(kdst + x * BK * 128, &kmap, full + 8 * s, x * kBox, h,
                   k0, b);
          tma_load(vdst + x * BK * 128, &vmap, full + 8 * s, x * kBox, h,
                   k0, b);
        }
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

  float o[NB][32];
#pragma unroll
  for (int x = 0; x < NB; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[x][i] = 0.f;
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;

  if (n > 0) {
    // this warpgroup's 64 rows of q: scaled, rounded to bf16, in place
    mbar_wait(qbar, 0);
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      uint4* rows = reinterpret_cast<uint4*>(smem + L::kQ + x * kTcBQ * 128 +
                                             wg * 64 * 128);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint4 u = rows[tid + 128 * e];
        uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[t]));
          w[t] = pack_bf16(f.x * a.scale, f.y * a.scale);
        }
        rows[tid + 128 * e] = u;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }

  for (int i = 0; i < n; ++i) {
    const int s = i % kTcStages;
    const int k0 = (kt_begin + i) * BK;
    mbar_wait(full + 8 * s, (i / kTcStages) & 1);
    // a tile wholly after this warpgroup's rows adds nothing
    if (!(a.causal && a.k_off + k0 > wg_first + 63)) {
      const uint32_t kt = base + L::kK + s * L::kKVBytes;
      const uint32_t vt = base + L::kV + s * L::kKVBytes;
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;       // bytes into the box row
        const uint32_t qa = base + L::kQ + (kk / 4) * kTcBQ * 128 +
                            wg * 64 * 128 + col;
        const uint32_t kb = kt + (kk / 4) * BK * 128 + col;
        wgmma_ss(sc, smem_desc(qa, 16, 1024), smem_desc(kb, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) reg_fence(sc[j]);

      // only tiles touching the diagonal or the end of KV evaluate the mask
      if ((a.causal && a.k_off + k0 + BK - 1 > wg_first) ||
          k0 + BK > a.Tk) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = k0 + 8 * j + cq + c;
            const long long kp = a.k_off + col;
            const bool out = col >= a.Tk;
            if (out || (a.causal && kp > qpos_a)) sc[4 * j + c] = -INFINITY;
            if (out || (a.causal && kp > qpos_b))
              sc[4 * j + 2 + c] = -INFINITY;
          }
        }
      }

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
      const float al_a = ex2((m_a - mn_a) * kLog2e);
      const float al_b = ex2((m_b - mn_b) * kLog2e);
      m_a = mn_a;
      m_b = mn_b;
      const float ms_a = mn_a * kLog2e;
      const float ms_b = mn_b * kLog2e;

      // p = exp(s - m) in fp32 for l; rounded to bf16 pairs for P.V: the
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
          p[kk][t] = pack_bf16(x0, x1);
        }
      }
      l_a = l_a * al_a + rs_a;
      l_b = l_b * al_b + rs_b;
#pragma unroll
      for (int x = 0; x < NB; ++x)
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
        for (int x = 0; x < NB; ++x) {
          // V: keys x 64 columns, 16 keys (2048 bytes) per k-step
          const uint32_t vb = vt + x * BK * 128 + kk * 16 * 128;
          wgmma_rs(o[x], p[kk], smem_desc(vb, 1024, 1024));
        }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int x = 0; x < NB; ++x)
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

  // l: the sum of the 4 lanes that share each row
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
    if (SPLIT) {
      // workspace: o [splits][rows][D], then m [splits][rows], l likewise
      const long long splits = gridDim.z;
      const long long slot = blockIdx.z * rows_all + r;
      float* wo = a.ws + slot * a.D;
#pragma unroll
      for (int x = 0; x < NB; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = x * kBox + 8 * j + cq;
          if (col < a.D)
            *reinterpret_cast<float2*>(wo + col) =
                make_float2(o[x][4 * j + 2 * hr], o[x][4 * j + 2 * hr + 1]);
        }
      if (lane % 4 == 0) {
        float* wm = a.ws + splits * rows_all * a.D;
        wm[slot] = mr;
        wm[splits * rows_all + slot] = lr;
      }
    } else {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + b * a.os[0] +
                           row * a.os[1] + h * a.os[2];
#pragma unroll
      for (int x = 0; x < NB; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = x * kBox + 8 * j + cq;
          if (col < a.D)
            *reinterpret_cast<uint32_t*>(out + col) =
                pack_bf16(o[x][4 * j + 2 * hr], o[x][4 * j + 2 * hr + 1]);
        }
      if (lane % 4 == 0) {
        a.m[r] = mr;
        a.l[r] = lr;
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

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// (query rows per block, keys per KV tile) of a dtype's route at head
// size D
struct Tiles {
  int bq, bk;
};
Tiles route_tiles(int dtype, int D) {
  if (dtype != 1) return Tiles{kBQ, kBK};
  return Tiles{kTcBQ, D <= 64 ? kTcBK64 : kTcBK128};
}

// dims = B, H, Tq, Tk, D, q_off, k_off, causal.  False when the shape is
// outside the kernels' range (D a multiple of 8 up to 128: the wrappers pad
// other head sizes).
bool read_dims(const long long* dims, Args* a) {
  const long long B = dims[0], H = dims[1], Tq = dims[2], Tk = dims[3],
                  D = dims[4];
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return false;
  if (D < 8 || D > 128 || D % 8) return false;
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

// Split the KV range so that the work of all q tiles, in the route's tile
// steps, makes about kBlocksPerSm blocks per SM, and no block's range
// exceeds that balanced share; at least two ranges when KV has two tiles.
StreamPlan make_stream_plan(const Args& a, Tiles tl, int sm_count) {
  const int nqt = cdiv(a.Tq, tl.bq);
  const int nk = cdiv(a.Tk, tl.bk);
  long long work = 0;
  for (int qt = 0; qt < nqt; ++qt)
    work += tiles_run(qt, a.Tq, a.Tk, a.q_off, a.k_off, a.causal, tl.bq,
                      tl.bk);
  work *= static_cast<long long>(a.B) * a.H;
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

template <int DMAX, bool SPLIT>
cudaError_t launch_fp32(const Args& a, int splits, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<DMAX, SPLIT>;
  const size_t smem = smem_bytes(DMAX);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(a.Tq, kBQ), a.B * a.H, splits);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime already
// loaded (the build links only the runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// The 4-D map (D, H, T, B) of a bf16 tensor with b, t, h strides st
// (elements), read in boxes of 64 columns x `rows` rows, 128-byte
// swizzled; boxes past T or D are zero-filled.
bool tensor_map(CUtensorMap* map, const void* ptr, const long long* st,
                const Args& a, int T, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dim[4] = {static_cast<cuuint64_t>(a.D),
                             static_cast<cuuint64_t>(a.H),
                             static_cast<cuuint64_t>(T),
                             static_cast<cuuint64_t>(a.B)};
  const cuuint64_t stride[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                static_cast<cuuint64_t>(st[1]) * 2,
                                static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dim, stride, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DMAX, int BK, bool SPLIT>
cudaError_t launch_tc(const Args& a, int splits, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, a.q, a.qs, a, a.Tq, kTcBQ) ||
      !tensor_map(&km, a.k, a.ks, a, a.Tk, BK) ||
      !tensor_map(&vm, a.v, a.vs, a, a.Tk, BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_tc<DMAX, BK, SPLIT>;
  const int smem = TcSmem<DMAX, BK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(a.Tq, kTcBQ), a.B * a.H, splits);
  kernel<<<grid, kTcThreads, smem, stream>>>(qm, km, vm, a);
  return cudaGetLastError();
}

// the first pass of the dtype's route (dtype 0 float32, 1 bfloat16)
template <bool SPLIT>
cudaError_t launch_attend(const Args& a, int dtype, int splits,
                          cudaStream_t stream) {
  if (dtype == 1)
    return a.D <= 64 ? launch_tc<64, kTcBK64, SPLIT>(a, splits, stream)
                     : launch_tc<128, kTcBK128, SPLIT>(a, splits, stream);
  if (a.D <= 32) return launch_fp32<32, SPLIT>(a, splits, stream);
  if (a.D <= 64) return launch_fp32<64, SPLIT>(a, splits, stream);
  return launch_fp32<128, SPLIT>(a, splits, stream);
}

cudaError_t launch_stream(const Args& a, int dtype, const StreamPlan& p,
                          cudaStream_t stream) {
  cudaError_t err = launch_attend<true>(a, dtype, p.splits, stream);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(a.B) * a.H * a.Tq * a.D;
  const int threads = 256;
  if (dtype == 1)
    merge_splits<__nv_bfloat16>
        <<<cdiv(total, threads), threads, 0, stream>>>(a, p.splits);
  else
    merge_splits<float><<<cdiv(total, threads), threads, 0, stream>>>(
        a, p.splits);
  return cudaGetLastError();
}

}  // namespace

// K2: o, m, l of q against the whole of k, v.  dims: B, H, Tq, Tk, D,
// q_off, k_off, causal.  strides: b, t, h strides (elements) of q, k, v,
// o.  dtype 0 float32, 1 bfloat16.  Returns the CUDA error of the launch
// (0 = none), or cudaErrorInvalidValue when the shape or layout is outside
// the kernel's range.
extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, float* m, float* l,
                            const long long* dims, const long long* strides,
                            float scale, int dtype, void* stream) {
  Args a = {};
  if (!read_dims(dims, &a) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  read_strides(strides, &a);
  a.q = q; a.k = k; a.v = v; a.o = o; a.m = m; a.l = l; a.ws = nullptr;
  a.scale = scale;
  a.chunk = cdiv(a.Tk, route_tiles(dtype, a.D).bk);
  return static_cast<int>(
      launch_attend<false>(a, dtype, 1, static_cast<cudaStream_t>(stream)));
}

// The split-KV plan of mx_flash_fwd_stream for these dims and dtype on
// sm_count SMs: plan[0..3] = KV ranges, KV tiles per range, fp32 workspace
// elements, keys per KV tile.  Returns 0, or
// cudaErrorInvalidValue for a shape outside the kernels' range.
extern "C" int mx_flash_fwd_stream_plan(const long long* dims, int dtype,
                                        int sm_count, long long* plan) {
  Args a = {};
  if (!read_dims(dims, &a) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tiles tl = route_tiles(dtype, a.D);
  const StreamPlan p = make_stream_plan(a, tl, sm_count);
  if (p.splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.splits;
  plan[1] = p.chunk;
  plan[2] = p.ws;
  plan[3] = tl.bk;
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
  if (!read_dims(dims, &a) || (dtype != 0 && dtype != 1))
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
