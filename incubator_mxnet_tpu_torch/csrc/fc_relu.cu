// Fused FullyConnected + bias + ReLU for Hopper (sm_90a):
//     out = relu(x @ w^T + b),  x (M, K), w (N, K), b (N,), out (M, N)
// fp32 accumulation, bias add and ReLU in the epilogue, output in x's
// dtype (float32, bfloat16 or float16).
//
// Replaces the Pallas kernel `_fc_relu_pallas` in
// incubator_mxnet_tpu/subgraph/fused_ops.py (op `_sg_pallas_fc_relu`).
// The Pallas original is gridless: whole operands sit in VMEM and one
// MXU dot produces the tile.  Here x and w are both K-contiguous, so the
// kernel is a tiled product with the epilogue fused in.
//
// What bounds it on an H100: serving buckets are small (M = 1..32), so
// the work is a weight-streaming product.  At VGG-16's first classifier
// layer, w is 4096 x 25088 fp32 = 411 MB, about 123 us at 3.35 TB/s; x (at
// most 3.2 MB) and out stay in L2.  Every design choice is about reading
// w once, at the HBM rate, with the arithmetic kept under that time.
// Two routes, chosen by make_plan (`route` of mx_fc_relu_plan):
//
// tensor_core (fc_relu_tc): out^T (N x M) = w (N x K) . x^T on `wgmma`.
// w's 128-row slabs are the A operand (two consumer warpgroups of 64
// rows) and x the B operand, M rounded up to a tile of 8, 16, 32 or 64
// rows; both are K-major as they lie in memory, so nothing is transposed.
// A producer warp keeps a 4-stage ring of 128-byte-wide K slices in
// flight by TMA (w: 128 rows x 128 bytes = 16 KB a stage; x's matching
// slice, re-read from L2), handed over with mbarriers; TMA's zero fill
// covers ragged M, N and K.  Two blocks fit an SM (96 KB of shared memory
// each), and K is split across grid z into as many ranges as fill those
// slots in one wave (a second, partial wave would leave the card mostly
// idle for its length); partial sums go to an fp32 workspace and
// splitk_epilogue adds them in split order (deterministic), then the bias
// and ReLU.  M tiles of one w slab are adjacent in the grid (x), so a
// second M tile reads w from L2.  TMA needs w's rows 16-byte aligned
// (K % 4 in fp32, K % 8 in 16-bit) and w's base (and x's, in 16-bit)
// 16-byte aligned.
//   * bfloat16 / float16: one m64nMTk16 `wgmma` per 16 of K, both
//     operands from shared memory.
//   * float32: full fp32 accuracy from TF32 tensor cores in three passes
//     (3xTF32): a = hi + lo with hi = tf32(a), lo = tf32(a - hi), and
//     w x ~ w_hi x_hi + w_hi x_lo + w_lo x_hi.  x is split once per call
//     by split_tf32 into the workspace (and TMA reads the halves from
//     there); each consumer takes its w fragment from the swizzled stage
//     into registers as the A operand (a0 (r, t), a1 (r + 8, t),
//     a2 (r, t + 4), a3 (r + 8, t + 4); tests/cuda/wgmma_tf32_probe.cu)
//     and splits it with cvt.rna (wgmma truncates an operand's low 13
//     bits).  The tensor cores' fp32 sums round toward zero, which over
//     thousands of chained k8 steps biases the sum low by ~n 2^-24 of it:
//     each stage (32 of K) sums into an accumulator of its own, added to
//     a running total on the CUDA cores, rounded to nearest.
//   Arithmetic at fc6, M = 32: 6.6 GFLOP, 13 us at 495 TFLOP/s of TF32 (x3
//   for fp32: 40 us), under the 123 us of bytes.
//
// cuda_core (fc_relu_kernel): split-K tiles of CUDA-core FMAs, for shapes
// the tensor-core route does not take (a row stride TMA cannot read), the
// smallest buckets (kTcMinRows) and small weights (kTcMinWeights):
//   * each warp owns kCols output columns and walks K with 16-byte
//     vector loads of w (neighbouring lanes on neighbouring addresses),
//     one w load feeding ROWS (at most 8) rows of x from L1/L2;
//   * blocks along M for the same columns are adjacent in the grid, so a
//     w tile read by one M tile is an L2 hit for the others when M > 8;
//   * K is split across blockIdx.z until about kBlocksPerSm blocks per SM
//     are in flight, reduced by splitk_epilogue as above;
//   * rows and columns past the ragged edge read a clamped valid row and
//     are never stored; K is handled in whole vectors when K is a multiple
//     of the vector width and the pointers are 16-byte aligned, else one
//     element per lane.

#include <type_traits>

#include "hopper.cuh"

namespace {

// ---- cuda_core route -------------------------------------------------------

constexpr int kWarps = 8;                   // warps per block
constexpr int kCols = 4;                    // output columns per warp
constexpr int kBlockCols = kWarps * kCols;  // output columns per block

// VEC consecutive elements at p, widened to float.  VEC > 1 is one
// 16-byte load (p must be 16-byte aligned).
template <typename T, int VEC> struct Load;

template <> struct Load<float, 1> {
  static __device__ __forceinline__ void run(const float* p, float* d) {
    d[0] = __ldg(p);
  }
};
template <> struct Load<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float* d) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
};
template <> struct Load<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float* d) {
    d[0] = __bfloat162float(p[0]);
  }
};
template <> struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float* d) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      d[2 * t] = f.x;
      d[2 * t + 1] = f.y;
    }
  }
};
template <> struct Load<__half, 1> {
  static __device__ __forceinline__ void run(const __half* p, float* d) {
    d[0] = __half2float(p[0]);
  }
};
template <> struct Load<__half, 8> {
  static __device__ __forceinline__ void run(const __half* p, float* d) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __half22float2(h[t]);
      d[2 * t] = f.x;
      d[2 * t + 1] = f.y;
    }
  }
};

// One block: ROWS rows of x (from blockIdx.x), kBlockCols columns of w
// (blockIdx.y), one K range (blockIdx.z).  ws == nullptr: the block holds
// whole sums and writes relu(sum + b) to out; else it writes its partial
// sums to ws[split][m][n].
template <typename T, int VEC, int ROWS>
__global__ void __launch_bounds__(kWarps * 32)
fc_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ b, T* __restrict__ out,
               float* __restrict__ ws, int M, int N, int K, int k_chunk) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * ROWS;
  const int n0 = blockIdx.y * kBlockCols + warp * kCols;
  const int split = blockIdx.z;
  const int k_begin = split * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  const T* wrow[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    wrow[j] = w + static_cast<size_t>(min(n0 + j, N - 1)) * K;
  const T* xrow[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    xrow[i] = x + static_cast<size_t>(min(m0 + i, M - 1)) * K;

  float acc[ROWS][kCols];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // k_chunk is a multiple of 32 * VEC and K of VEC, so every vector lies
  // wholly inside [k_begin, k_end)
#pragma unroll 2
  for (int k = k_begin + lane * VEC; k < k_end; k += 32 * VEC) {
    float wv[kCols][VEC];
#pragma unroll
    for (int j = 0; j < kCols; ++j) Load<T, VEC>::run(wrow[j] + k, wv[j]);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float xv[VEC];
      Load<T, VEC>::run(xrow[i] + k, xv);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[i][j] = fmaf(xv[v], wv[j][v], acc[i][j]);
    }
  }

  // butterfly: every lane ends with every (row, column) sum
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);

  // lane l stores sum l (ROWS * kCols <= 32)
  float val = 0.f;
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (lane == i * kCols + j) val = acc[i][j];
  const int m = m0 + lane / kCols;
  const int n = n0 + lane % kCols;
  if (lane < ROWS * kCols && m < M && n < N) {
    if (ws != nullptr) {
      ws[(static_cast<size_t>(split) * M + m) * N + n] = val;
    } else {
      out[static_cast<size_t>(m) * N + n] =
          from_float<T>(fmaxf(val + to_float(b[n]), 0.f));
    }
  }
}

// out[m][n] = relu(sum_s ws[s][m][n] + b[n]), summed in split order.
template <typename T>
__global__ void splitk_epilogue(const float* __restrict__ ws,
                                const T* __restrict__ b, T* __restrict__ out,
                                int M, int N, int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * N) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p)
    s += ws[static_cast<size_t>(p) * M * N + idx];
  out[idx] = from_float<T>(fmaxf(s + to_float(b[idx % N]), 0.f));
}

// ---- tensor_core route -----------------------------------------------------

constexpr int kTcRows = 128;      // rows of w (output columns) per block
constexpr int kTcStages = 4;      // ring depth
constexpr int kTcThreads = 288;   // 2 consumer warpgroups + 1 producer warp
constexpr int kTcWBytes = kTcRows * 128;   // one stage of w: 16 KB

// Shared memory of a block (bytes from a 1024-aligned base): the w ring,
// the x ring (fp32: x_hi then x_lo per stage), full[] and empty[].
template <int MT, bool F32>
struct TcSmem {
  static constexpr int kXBytes = MT * 128 * (F32 ? 2 : 1);   // one x stage
  static constexpr int kW = 0;
  static constexpr int kX = kTcStages * kTcWBytes;
  static constexpr int kBar = kX + kTcStages * kXBytes;
  static constexpr int kBytes = kBar + 16 * kTcStages + 1024;
};

// one box of a 2-D tensor map at coordinates (k, row) into dst, completing
// `bar`'s transaction bytes
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k),
      "r"(row) : "memory");
}

// d += A B, A (64 x 16) and B (16 x N) 16-bit, K-major in shared memory
template <typename T, int N> struct Wgmma16;
#define MX_WGMMA16(T, TS, N, RN, AN, IA, IB)                                  \
  template <> struct Wgmma16<T, N> {                                         \
    static __device__ __forceinline__ void run(float* d, uint64_t a,          \
                                               uint64_t b) {                 \
      asm volatile("wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TS "."  \
                   TS " {" RN "}, " IA ", " IB ", 1, 1, 1, 0, 0;\n"         \
                   : AN(d) : "l"(a), "l"(b));                                \
    }                                                                        \
  };
MX_WGMMA16(__nv_bfloat16, "bf16", 8, MX_R4, MX_A4, "%4", "%5")
MX_WGMMA16(__nv_bfloat16, "bf16", 16, MX_R8, MX_A8, "%8", "%9")
MX_WGMMA16(__nv_bfloat16, "bf16", 32, MX_R16, MX_A16, "%16", "%17")
MX_WGMMA16(__nv_bfloat16, "bf16", 64, MX_R32, MX_A32, "%32", "%33")
MX_WGMMA16(__half, "f16", 8, MX_R4, MX_A4, "%4", "%5")
MX_WGMMA16(__half, "f16", 16, MX_R8, MX_A8, "%8", "%9")
MX_WGMMA16(__half, "f16", 32, MX_R16, MX_A16, "%16", "%17")
MX_WGMMA16(__half, "f16", 64, MX_R32, MX_A32, "%32", "%33")
#undef MX_WGMMA16

// tf32 d += A B: A (64 x 8) from registers, B (8 x N) K-major in shared
// memory
template <int N> struct WgmmaTf32;
#define MX_WGMMA_TF32(N, RN, AN, IA, IB)                                      \
  template <> struct WgmmaTf32<N> {                                          \
    static __device__ __forceinline__ void run(float* d, const uint32_t* a,   \
                                               uint64_t b) {                 \
      asm volatile("wgmma.mma_async.sync.aligned.m64n" #N                   \
                   "k8.f32.tf32.tf32 {" RN "}, {" IA "}, " IB ", 1, 1, 1;\n" \
                   : AN(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),     \
                     "l"(b));                                                \
    }                                                                        \
  };
MX_WGMMA_TF32(8, MX_R4, MX_A4, "%4, %5, %6, %7", "%8")
MX_WGMMA_TF32(16, MX_R8, MX_A8, "%8, %9, %10, %11", "%12")
MX_WGMMA_TF32(32, MX_R16, MX_A16, "%16, %17, %18, %19", "%20")
#undef MX_WGMMA_TF32

// x split once into its TF32 hi and lo halves (the fp32 route's B operands)
__global__ void split_tf32(const float* __restrict__ x, float* __restrict__ hi,
                           float* __restrict__ lo, long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float v = x[i];
    const float h = tf32(v);
    hi[i] = h;
    lo[i] = tf32(v - h);
  }
}

// The tensor_core route, see the note at the top.  One block: rows
// [m0, m0 + MT) of x (blockIdx.x), rows [n0, n0 + 128) of w (blockIdx.y),
// K range [split k_chunk, min(K, (split + 1) k_chunk)) (split = blockIdx.z).
// Warps 0-7 are the consumer warpgroups (w rows n0 .. + 63, n0 + 64 ..
// + 127), warp 8 the producer.  ws == nullptr: the block holds whole sums
// and writes relu(sum + b); else its partial sums go to ws[split][m][n].
// The accumulator (64 x MT) holds w rows x x rows: a thread has w rows r,
// r + 8 and, per 8-column chunk j, x rows 8j + 2t, 8j + 2t + 1.
template <typename T, int MT>
__global__ void __launch_bounds__(kTcThreads, 2)
fc_relu_tc(const __grid_constant__ CUtensorMap wmap,
           const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap xlomap,
           const T* __restrict__ b, T* __restrict__ out,
           float* __restrict__ ws, int M, int N, int K, int k_chunk) {
  constexpr bool F32 = std::is_same<T, float>::value;
  using L = TcSmem<MT, F32>;
  constexpr int BK = 128 / sizeof(T);      // K elements per stage
  constexpr int NA = MT / 2;               // accumulator registers
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t full = base + L::kBar;             // full[s] at + 8 s
  const uint32_t empty = full + 8 * kTcStages;      // empty[s] at + 8 s

  const int m0 = blockIdx.x * MT;
  const int n0 = blockIdx.y * kTcRows;
  const int k_begin = blockIdx.z * k_chunk;
  const int steps = (min(K, k_begin + k_chunk) - k_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 8) {
    // producer: w and x slices into the ring
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kTcStages;
        const int use = i / kTcStages;
        if (use > 0) mbar_wait(empty + 8 * s, (use - 1) & 1);
        mbar_expect_tx(full + 8 * s, kTcWBytes + L::kXBytes);
        const int k0 = k_begin + i * BK;
        const uint32_t xdst = base + L::kX + s * L::kXBytes;
        tma_load_2d(base + L::kW + s * kTcWBytes, &wmap, full + 8 * s, k0,
                    n0);
        tma_load_2d(xdst, &xmap, full + 8 * s, k0, m0);
        if (F32)
          tma_load_2d(xdst + MT * 128, &xlomap, full + 8 * s, k0, m0);
      }
    }
    return;
  }

  // consumers
  const int wg = warp / 4;
  const int r = 16 * (warp % 4) + lane / 4;   // w rows r, r + 8 of the slab
  const int t = lane % 4;
  float acc[NA], tot[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    acc[j] = 0.f;
    tot[j] = 0.f;
  }

  for (int i = 0; i < steps; ++i) {
    const int s = i % kTcStages;
    const uint32_t sb = opaque(base);   // descriptors are made per stage
    const uint32_t xt = sb + L::kX + s * L::kXBytes;
    mbar_wait(full + 8 * s, (i / kTcStages) & 1);
    if constexpr (F32) {
      // this warpgroup's w fragments of the stage's 4 k8 steps, split
      const uint8_t* wf = smem + L::kW + s * kTcWBytes + wg * 64 * 128;
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = r + 8 * (q & 1);
          const int col = 8 * kk + t + 4 * (q >> 1);
          const float v =
              *reinterpret_cast<const float*>(wf + swz(row * 128 + col * 4));
          const float h = tf32(v);
          hi[kk][q] = __float_as_uint(h);
          lo[kk][q] = __float_as_uint(tf32(v - h));
        }
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        acc[j] = 0.f;
        reg_fence(acc[j]);
      }
      wgmma_fence();
      // the small terms first, then hi x hi
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        WgmmaTf32<MT>::run(acc, lo[kk], kmajor(xt + kk * 32));
        WgmmaTf32<MT>::run(acc, hi[kk], kmajor(xt + MT * 128 + kk * 32));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32<MT>::run(acc, hi[kk], kmajor(xt + kk * 32));
      wgmma_commit();
      wgmma_wait();
      // the stage's sum into the total, rounded to nearest
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        reg_fence(acc[j]);
        tot[j] += acc[j];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          reg_fence(hi[kk][q]);
          reg_fence(lo[kk][q]);
        }
    } else {
      const uint32_t wt = sb + L::kW + s * kTcWBytes + wg * 64 * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma16<T, MT>::run(acc, kmajor(wt + kk * 32), kmajor(xt + kk * 32));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int j = 0; j < NA; ++j) reg_fence(acc[j]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int n = n0 + wg * 64 + r + 8 * hr;
    if (n >= N) continue;
    const float bias = to_float(b[n]);
#pragma unroll
    for (int j = 0; j < MT / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int m = m0 + 8 * j + 2 * t + c;
        if (m >= M) continue;
        const int idx = 4 * j + 2 * hr + c;
        const float v = F32 ? tot[idx] : acc[idx];
        if (ws != nullptr)
          ws[(static_cast<size_t>(blockIdx.z) * M + m) * N + n] = v;
        else
          out[static_cast<size_t>(m) * N + n] =
              from_float<T>(fmaxf(v + bias, 0.f));
      }
  }
}

// ---- host side -------------------------------------------------------------

constexpr int kBlocksPerSm = 4;     // cuda_core: split K until this many
constexpr int kTcBlocksPerSm = 2;   // tensor_core: the blocks that fit an SM
constexpr int kTcMinSteps = 4;      // tensor_core: stages per K range, at least
// tensor_core takes M from this many rows up, by dtype (float32, bfloat16,
// float16), where it measured faster than cuda_core by device time at
// every VGG-16 classifier shape (H100, chip_smoke.py phase 3).  Below:
// fp32 at M <= 4 cuda_core was faster at fc7 (4096 x 4096) and within 3 %
// at fc6; 16-bit at M = 1 the two were within 3 %.
constexpr int kTcMinRows[3] = {8, 2, 2};

// ... and from this many weights (N * K) up.  Below, the tensor-core
// route's fixed costs (the TMA maps' fetch, the ring's fill, and in fp32
// the split of x) outweigh its arithmetic: on an H100 (700 W,
// chip_smoke.py phase 3) cuda_core took 0.0020-0.0031 ms of device time
// at the mlp's fc2 (128 x 64) and wide_deep's deep1 (32 x 32) where
// tensor_core took 0.0048-0.0070 ms.  At the mlp's fc1 (784 x 128)
// tensor_core stays: in 16-bit it is the faster (0.0045 against 0.0063
// ms at M = 5), in fp32 within 1.1x of cuda_core (0.0094 against 0.0086
// at M = 64).
constexpr long long kTcMinWeights = 1LL << 16;

enum Route { kCudaCore = 0, kTensorCore = 1 };

struct Plan {
  int route;       // kCudaCore or kTensorCore
  int rows;        // rows of x per block: 1, 2, 4 or 8 (cuda_core); the M
                   // tile 8, 16, 32 or 64 (tensor_core)
  int splits;      // K ranges (blockIdx.z)
  int k_chunk;     // K elements per range, a multiple of `step`
  int step;        // K elements of one warp step (cuda_core: 32 * vec) or
                   // one ring stage (tensor_core: 128 bytes of K)
  int vec;         // cuda_core: elements per lane load (1 = scalar loads)
  long long ws;    // fp32 workspace elements (split partials; fp32
                   // tensor_core: x_hi and x_lo first)
};

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// Whether the tensor_core route can read these operands: TMA wants w's
// rows (and x's, read directly in 16-bit) 16-byte aligned.
bool tc_readable(const void* x, const void* w, int N, int K, int dtype) {
  const int wide = dtype == kF32 ? 4 : 8;   // 16 bytes of elements
  const bool x_ok =
      dtype == kF32 || reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return K % wide == 0 && x_ok && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
         cdiv(N, kTcRows) <= 65535;
}

// The launch of one call.  route: -1 lets the library choose (tensor_core
// where it can read the operands, M reaches kTcMinRows and N * K reaches
// kTcMinWeights, else cuda_core); 0 or 1 asks for that route.  cuda_core
// splits K until about kBlocksPerSm blocks per SM are in flight;
// tensor_core into the most ranges whose blocks fit the card's
// kTcBlocksPerSm slots per SM at once.  Returns false when the shape,
// dtype or requested route is outside the kernels' range.
bool make_plan(const void* x, const void* w, int M, int N, int K, int dtype,
               int sm_count, int route, Plan* p) {
  if (M <= 0 || N <= 0 || K <= 0 || dtype < kF32 || dtype > kF16 ||
      route < -1 || route > kTensorCore)
    return false;
  if (static_cast<long long>(M) * N >= (1LL << 31)) return false;
  const bool tc_ok = tc_readable(x, w, N, K, dtype);
  if (route == -1)
    route = tc_ok && M >= kTcMinRows[dtype] &&
                    static_cast<long long>(N) * K >= kTcMinWeights
                ? kTensorCore
                : kCudaCore;
  if (route == kTensorCore && !tc_ok) return false;
  const int sms = sm_count > 0 ? sm_count : 1;
  p->route = route;
  long long blocks, want, most;
  if (route == kCudaCore) {
    if (cdiv(N, kBlockCols) > 65535) return false;
    const int wide = dtype == kF32 ? 4 : 8;   // 16 bytes of elements
    const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(w) % 16 == 0;
    p->vec = K % wide == 0 && aligned ? wide : 1;
    p->rows = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8;
    p->step = 32 * p->vec;
    blocks = static_cast<long long>(cdiv(M, p->rows)) * cdiv(N, kBlockCols);
    want = (static_cast<long long>(kBlocksPerSm) * sms + blocks - 1) / blocks;
    most = cdiv(K, 4 * p->step);            // at least four warp steps each
  } else {
    p->vec = 0;
    p->rows = M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 || dtype == kF32 ? 32 : 64;
    p->step = dtype == kF32 ? 32 : 64;
    blocks = static_cast<long long>(cdiv(M, p->rows)) * cdiv(N, kTcRows);
    want = static_cast<long long>(kTcBlocksPerSm) * sms / blocks;
    most = cdiv(K, kTcMinSteps * p->step);
  }
  int splits = static_cast<int>(want < most ? want : most);
  if (splits < 1) splits = 1;
  if (splits > 65535) splits = 65535;
  p->k_chunk = cdiv(cdiv(K, splits), p->step) * p->step;
  p->splits = cdiv(K, p->k_chunk);
  p->ws = p->splits > 1 ? static_cast<long long>(p->splits) * M * N : 0;
  if (route == kTensorCore && dtype == kF32)
    p->ws += 2LL * M * K;
  return true;
}

template <typename T, int VEC, int ROWS>
cudaError_t launch_rows(const T* x, const T* w, const T* b, T* out,
                        float* ws, int M, int N, int K, int splits,
                        int k_chunk, cudaStream_t stream) {
  const dim3 grid((M + ROWS - 1) / ROWS, (N + kBlockCols - 1) / kBlockCols,
                  splits);
  fc_relu_kernel<T, VEC, ROWS><<<grid, kWarps * 32, 0, stream>>>(
      x, w, b, out, splits > 1 ? ws : nullptr, M, N, K, k_chunk);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_vec(const T* x, const T* w, const T* b, T* out, float* ws,
                       int M, int N, int K, const Plan& p,
                       cudaStream_t stream) {
  switch (p.rows) {
    case 1: return launch_rows<T, VEC, 1>(x, w, b, out, ws, M, N, K, p.splits,
                                          p.k_chunk, stream);
    case 2: return launch_rows<T, VEC, 2>(x, w, b, out, ws, M, N, K, p.splits,
                                          p.k_chunk, stream);
    case 4: return launch_rows<T, VEC, 4>(x, w, b, out, ws, M, N, K, p.splits,
                                          p.k_chunk, stream);
    case 8: return launch_rows<T, VEC, 8>(x, w, b, out, ws, M, N, K, p.splits,
                                          p.k_chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The 2-D map (K, rows) of a row-major tensor of `dtype`, read in boxes
// of 128 bytes of K x `box_rows` rows, 128-byte swizzled; boxes past K or
// the rows are zero-filled.
bool tensor_map_2d(CUtensorMap* map, const void* ptr, int K, int rows,
                   int box_rows, int dtype) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int item = dtype == kF32 ? 4 : 2;
  const cuuint64_t dim[2] = {static_cast<cuuint64_t>(K),
                             static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(K) * item};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / item),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, map_type(dtype), 2, const_cast<void*>(ptr), dim, stride,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int MT>
cudaError_t launch_tc_tile(const T* x, const T* w, const T* b, T* out,
                           float* ws, int M, int N, int K, const Plan& p,
                           cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const int dtype = F32 ? kF32 : std::is_same<T, __half>::value ? kF16 : kBF16;
  const void* xb = x;       // what TMA reads as B: x, or x_hi and x_lo
  const void* xlo = x;
  float* part = ws;
  if (F32) {
    const long long n = static_cast<long long>(M) * K;
    float* hi = ws;
    float* lo = ws + n;
    const int blocks = static_cast<int>(n / 256 + 1 < 4096 ? n / 256 + 1
                                                           : 4096);
    split_tf32<<<blocks, 256, 0, stream>>>(
        reinterpret_cast<const float*>(x), hi, lo, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    xb = hi;
    xlo = lo;
    part = ws + 2 * n;
  }
  CUtensorMap wm, xm, xlm;
  if (!tensor_map_2d(&wm, w, K, N, kTcRows, dtype) ||
      !tensor_map_2d(&xm, xb, K, M, MT, dtype) ||
      !tensor_map_2d(&xlm, xlo, K, M, MT, dtype))
    return cudaErrorInvalidValue;
  const int smem = TcSmem<MT, F32>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fc_relu_tc<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(M, MT), cdiv(N, kTcRows), p.splits);
  fc_relu_tc<T, MT><<<grid, kTcThreads, smem, stream>>>(
      wm, xm, xlm, b, out, p.splits > 1 ? part : nullptr, M, N, K,
      p.k_chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc(const T* x, const T* w, const T* b, T* out, float* ws,
                      int M, int N, int K, const Plan& p,
                      cudaStream_t stream) {
  switch (p.rows) {
    case 8: return launch_tc_tile<T, 8>(x, w, b, out, ws, M, N, K, p, stream);
    case 16: return launch_tc_tile<T, 16>(x, w, b, out, ws, M, N, K, p,
                                          stream);
    case 32: return launch_tc_tile<T, 32>(x, w, b, out, ws, M, N, K, p,
                                          stream);
    default:
      if constexpr (std::is_same<T, float>::value)
        return cudaErrorInvalidValue;
      else
        return launch_tc_tile<T, 64>(x, w, b, out, ws, M, N, K, p, stream);
  }
}

// the plan's launches, then splitk_epilogue when K is split
template <typename T, int WIDE>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   void* ws, int M, int N, int K, const Plan& p,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  float* wsf = static_cast<float*>(ws);
  cudaError_t err;
  if (p.route == kTensorCore)
    err = launch_tc<T>(xt, wt, bt, ot, wsf, M, N, K, p, stream);
  else if (p.vec == WIDE)
    err = launch_vec<T, WIDE>(xt, wt, bt, ot, wsf, M, N, K, p, stream);
  else
    err = launch_vec<T, 1>(xt, wt, bt, ot, wsf, M, N, K, p, stream);
  if (err != cudaSuccess || p.splits == 1) return err;
  // the split partials follow x_hi and x_lo in fp32 tensor_core's workspace
  const float* part = p.route == kTensorCore && std::is_same<T, float>::value
                          ? wsf + 2LL * M * K
                          : wsf;
  const int threads = 256;
  splitk_epilogue<T><<<(M * N + threads - 1) / threads, threads, 0,
                       stream>>>(part, bt, ot, M, N, p.splits);
  return cudaGetLastError();
}

}  // namespace

// The plan of mx_fc_relu for these operands and `route` (-1: the
// library's choice; 0 cuda_core; 1 tensor_core): plan[0..6] = route, rows
// of x per block, K splits, K elements per split, K elements per step,
// elements per lane load (cuda_core; 0 for tensor_core), and the fp32
// workspace elements mx_fc_relu needs (0 when there is none).  Reads no
// memory through x or w.  Returns 0, or cudaErrorInvalidValue when the
// shape, dtype or route is outside the kernels' range.
extern "C" int mx_fc_relu_plan(const void* x, const void* w, int M, int N,
                               int K, int dtype, int sm_count, int route,
                               long long* plan) {
  Plan p;
  if (!make_plan(x, w, M, N, K, dtype, sm_count, route, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.route;
  plan[1] = p.rows;
  plan[2] = p.splits;
  plan[3] = p.k_chunk;
  plan[4] = p.step;
  plan[5] = p.vec;
  plan[6] = p.ws;
  return 0;
}

// out = relu(x @ w^T + b).  dtype: 0 float32, 1 bfloat16, 2 float16.
// route as for mx_fc_relu_plan.  ws: an fp32 buffer of ws_elems elements,
// at least what mx_fc_relu_plan asks for (may be null when that is 0).
// Returns the CUDA error of the launches (0 = none).
extern "C" int mx_fc_relu(const void* x, const void* w, const void* b,
                          void* out, void* ws, long long ws_elems, int M,
                          int N, int K, int dtype, int sm_count, int route,
                          void* stream) {
  Plan p;
  if (!make_plan(x, w, M, N, K, dtype, sm_count, route, &p) ||
      (p.ws > 0 && (ws == nullptr || ws_elems < p.ws)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32)
    err = launch<float, 4>(x, w, b, out, ws, M, N, K, p, s);
  else if (dtype == kBF16)
    err = launch<__nv_bfloat16, 8>(x, w, b, out, ws, M, N, K, p, s);
  else
    err = launch<__half, 8>(x, w, b, out, ws, M, N, K, p, s);
  return static_cast<int>(err);
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
