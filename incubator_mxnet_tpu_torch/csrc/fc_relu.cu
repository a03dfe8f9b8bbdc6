// Fused FullyConnected + bias + ReLU for Hopper (sm_90a):
//     out = relu(x @ w^T + b),  x (M, K), w (N, K), b (N,), out (M, N)
// fp32 accumulation, bias add and ReLU in the epilogue, output in x's
// dtype (float32 or bfloat16).
//
// Replaces the Pallas kernel `_fc_relu_pallas` in
// incubator_mxnet_tpu/subgraph/fused_ops.py (op `_sg_pallas_fc_relu`).
// The Pallas original is gridless: whole operands sit in VMEM and one
// MXU dot produces the tile.  Here x and w are both K-contiguous, so the
// kernel is a tiled product with the epilogue fused in.
//
// What bounds it on an H100: serving buckets are small (M = 1..32), so
// the work is a weight-streaming GEMV.  At VGG-16's first classifier
// layer, w is 4096 x 25088 fp32 = 411 MB, about 123 us at 3.35 TB/s;
// x (at most 3.2 MB) and out stay in L2.  The arithmetic (2*M*N*K) is
// below the fp32 FMA rate's line up to M of about 32.  The design is about
// streaming w once at full rate:
//   * each warp owns kCols output columns and walks K with 16-byte
//     vector loads of w (neighbouring lanes on neighbouring addresses),
//     one w load feeding ROWS rows of x from L1/L2;
//   * blocks along M for the same columns are adjacent in the grid
//     (blockIdx.x), so a w tile read by one M tile is an L2 hit for the
//     others when M > 8;
//   * N / 32 column tiles alone give only 128 blocks for N = 4096 on 132
//     SMs, so K is split across blockIdx.z until about four blocks per SM
//     are in flight; split partial sums go to an fp32 workspace and a
//     second small kernel reduces them in a fixed order (deterministic),
//     then adds the bias and applies the ReLU;
//   * rows and columns past the ragged edge read a clamped valid row and
//     are never stored; K is handled in whole vectors when K is a multiple
//     of the vector width and the pointers are 16-byte aligned, else one
//     element per lane.
// The fp32 path uses CUDA-core FMAs, not tensor cores; wgmma/TMA tiles
// are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                   // warps per block
constexpr int kCols = 4;                    // output columns per warp
constexpr int kBlockCols = kWarps * kCols;  // output columns per block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

template <typename T, int VEC, int ROWS>
cudaError_t launch_rows(const T* x, const T* w, const T* b, T* out,
                        float* ws, int M, int N, int K, int splits,
                        int k_chunk, cudaStream_t stream) {
  const dim3 grid((M + ROWS - 1) / ROWS, (N + kBlockCols - 1) / kBlockCols,
                  splits);
  fc_relu_kernel<T, VEC, ROWS><<<grid, kWarps * 32, 0, stream>>>(
      x, w, b, out, splits > 1 ? ws : nullptr, M, N, K, k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int threads = 256;
  splitk_epilogue<T><<<(M * N + threads - 1) / threads, threads, 0,
                       stream>>>(ws, b, out, M, N, splits);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_vec(const T* x, const T* w, const T* b, T* out, float* ws,
                       int M, int N, int K, int rows, int splits,
                       int k_chunk, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch_rows<T, VEC, 1>(x, w, b, out, ws, M, N, K, splits,
                                          k_chunk, stream);
    case 2: return launch_rows<T, VEC, 2>(x, w, b, out, ws, M, N, K, splits,
                                          k_chunk, stream);
    case 4: return launch_rows<T, VEC, 4>(x, w, b, out, ws, M, N, K, splits,
                                          k_chunk, stream);
    case 8: return launch_rows<T, VEC, 8>(x, w, b, out, ws, M, N, K, splits,
                                          k_chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kBlocksPerSm = 4;   // split K until about this many blocks

struct Plan {
  int rows;        // rows of x per block: 1, 2, 4 or 8
  int splits;      // K ranges (blockIdx.z)
  int k_chunk;     // K elements per range, a multiple of 32 * vec
  int vec;         // elements per lane load (1 = scalar loads)
  long long ws;    // fp32 workspace elements (0 without a split)
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The launch of one call: 16-byte loads when K is a multiple of the
// vector width and x, w are 16-byte aligned; the fewest rows per block
// that cover M (at most 8); K split until about kBlocksPerSm blocks per SM
// are in flight, each split at least four warp steps long.  Returns
// false when the output exceeds the grid.
bool make_plan(const void* x, const void* w, int M, int N, int K, int dtype,
               int sm_count, Plan* p) {
  if (M <= 0 || N <= 0 || K <= 0 || (dtype != 0 && dtype != 1)) return false;
  if (static_cast<long long>(M) * N >= (1LL << 31)) return false;
  if (cdiv(N, kBlockCols) > 65535) return false;
  const int wide = dtype == 0 ? 4 : 8;   // 16 bytes of float / bfloat16
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  p->vec = K % wide == 0 && aligned ? wide : 1;
  p->rows = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8;
  const int step = 32 * p->vec;          // K elements one warp step covers
  const long long blocks =
      static_cast<long long>(cdiv(M, p->rows)) * cdiv(N, kBlockCols);
  const long long want =
      (static_cast<long long>(kBlocksPerSm) * sm_count + blocks - 1) / blocks;
  int splits = static_cast<int>(want < cdiv(K, 4 * step) ? want
                                                         : cdiv(K, 4 * step));
  if (splits < 1) splits = 1;
  p->k_chunk = cdiv(cdiv(K, splits), step) * step;
  p->splits = cdiv(K, p->k_chunk);
  p->ws = p->splits > 1 ? static_cast<long long>(p->splits) * M * N : 0;
  return true;
}

template <typename T, int WIDE>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   void* ws, int M, int N, int K, const Plan& p,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  float* wsf = static_cast<float*>(ws);
  if (p.vec == WIDE)
    return launch_vec<T, WIDE>(xt, wt, bt, ot, wsf, M, N, K, p.rows,
                               p.splits, p.k_chunk, stream);
  return launch_vec<T, 1>(xt, wt, bt, ot, wsf, M, N, K, p.rows, p.splits,
                          p.k_chunk, stream);
}

}  // namespace

// The plan of mx_fc_relu for these operands: plan[0..4] = rows per block,
// K splits, K elements per split, elements per lane load, and the fp32
// workspace elements mx_fc_relu needs (0 without a split).  Reads no
// memory through x or w.  Returns 0, or cudaErrorInvalidValue when the
// shape or dtype is outside the kernel's range.
extern "C" int mx_fc_relu_plan(const void* x, const void* w, int M, int N,
                               int K, int dtype, int sm_count,
                               long long* plan) {
  Plan p;
  if (!make_plan(x, w, M, N, K, dtype, sm_count, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.rows;
  plan[1] = p.splits;
  plan[2] = p.k_chunk;
  plan[3] = p.vec;
  plan[4] = p.ws;
  return 0;
}

// out = relu(x @ w^T + b).  dtype: 0 float32, 1 bfloat16.  ws: an fp32
// buffer of ws_elems elements, at least what mx_fc_relu_plan asks for
// (may be null when that is 0).  Returns the CUDA error of the launches
// (0 = none).
extern "C" int mx_fc_relu(const void* x, const void* w, const void* b,
                          void* out, void* ws, long long ws_elems, int M,
                          int N, int K, int dtype, int sm_count,
                          void* stream) {
  Plan p;
  if (!make_plan(x, w, M, N, K, dtype, sm_count, &p) ||
      (p.ws > 0 && (ws == nullptr || ws_elems < p.ws)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float, 4>(x, w, b, out, ws, M, N, K, p, s)
                 : launch<__nv_bfloat16, 8>(x, w, b, out, ws, M, N, K, p, s);
  return static_cast<int>(err);
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
