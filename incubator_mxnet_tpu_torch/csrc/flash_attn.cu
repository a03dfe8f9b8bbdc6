// Flash-attention forward for Hopper (sm_90a): the partial attention of
// one KV shard, in the ring-step contract of the JAX package,
//     s = (q / sqrt(D)) k^T  (causal: key position > query position masked)
//     m = rowmax(s),  l = rowsum(exp(s - m)),  o = exp(s - m) v   (unnormalised)
// q (B, Tq, H, D), k and v (B, Tk, H, D), float32 or bfloat16, read through
// their strides (the head dimension contiguous); o (B, Tq, H, D) in q's
// dtype, m and l (B, H, Tq) in float32.  q_off and k_off are the global
// positions of q's and k's first rows, for the causal mask.  A row that
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
//
// What bounds them on an H100: 4*Tq*Tk*D operations (halved when causal)
// against bytes that grow only as (Tq + Tk)*D, so at the long-context
// shapes (T = 8192..32768, D = 64) both are far above the ridge point:
// operation-bound.  This first version computes on the CUDA cores in
// fp32 for both dtypes (the fp32 parity needs full fp32, not TF32; bf16
// inputs are widened on load), which caps it at the 67 TFLOP/s fp32 rate,
// far below the bf16 tensor-core rate; mma/wgmma tiles are later work.
// The design keeps the operation count at the causal minimum and the
// shared-memory traffic per FMA low:
//   * one block of 128 threads per (b*h, 64-row q tile); q is scaled by
//     1/sqrt(D) and rounded to the input dtype once, on load, as the TPU
//     kernels do;
//   * KV tiles of 64 rows pass through shared memory (widened to fp32,
//     16-byte global loads, rows past Tk zeroed); tiles above the causal
//     diagonal are never loaded, and only tiles that touch the diagonal
//     or the ragged end of KV evaluate the mask;
//   * each thread owns a 4 x 8 micro-tile of S (4 q rows, 8 keys strided
//     by 8) and the same 4 rows of O, so the row max and sum need only a
//     3-step shuffle among the 8 lanes that share the rows, and the
//     rescale by alpha stays in registers;
//   * p is rounded to v's dtype (as the TPU kernels cast p before P.V),
//     staged in shared memory, and P.V runs from there;
//   * shared-memory row pitches (D + 1, 64 + 2) keep the micro-tile reads
//     free of bank conflicts;
//   * the heaviest causal q tiles are launched first (reversed grid x); the
//     split-KV plan (mx_flash_fwd_stream_plan) cuts the KV range so that
//     about kBlocksPerSm blocks of work per SM exist and no block's
//     share exceeds the balanced share of the causal triangle.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per KV tile
constexpr int kThreads = 128;    // 16 row groups x 8 column groups
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

// v rounded to T and widened back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// 8 consecutive elements at p (16-byte aligned for bf16, 32 for fp32)
__device__ __forceinline__ void load8(const float* p, float* d) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* d) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 f = __bfloat1622float2(h[t]);
    d[2 * t] = f.x;
    d[2 * t + 1] = f.y;
  }
}

// rows [t0, t0 + 64) of head (b, h) into dst (pitch ld, fp32); rows past
// T are zero.  scale > 0: each value becomes round_to<T>(value * scale).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
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
      for (int i = 0; i < 8; ++i) x[i] = round_to<T>(x[i] * scale);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[row * ld + c + i] = x[i];
  }
}

// KV tiles that q tile qt must visit: all of them, or under the causal
// mask those up to the one holding the tile's last row's position.
__host__ __device__ inline int tiles_run(int qt, int Tq, int Tk,
                                         long long q_off, long long k_off,
                                         int causal) {
  const int nk = (Tk + kBK - 1) / kBK;
  if (!causal) return nk;
  const int q0 = qt * kBQ;
  const int rows = Tq - q0 < kBQ ? Tq - q0 : kBQ;
  const long long e = q_off + q0 + rows - 1 - k_off;
  if (e < 0) return 0;
  const long long n = e / kBK + 1;
  return n < nk ? static_cast<int>(n) : nk;
}

size_t smem_bytes(int dmax) {
  return static_cast<size_t>(3 * 64 * (dmax + 1) + kBQ * kPP) * sizeof(float);
}

// K2 (SPLIT = false, one split covering the KV range) and K3's first pass
// (SPLIT = true); see the note at the top of the file.  One block: q tile
// (reversed blockIdx.x), head blockIdx.y, KV tiles
// [split * chunk, min(nk_run, (split + 1) * chunk)) with split = blockIdx.z.
// SPLIT: write the fp32 partial to the workspace, else o, m, l.
template <typename T, int DMAX, bool SPLIT>
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
  const int nk_run = tiles_run(qt, a.Tq, a.Tk, a.q_off, a.k_off, a.causal);
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

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  if (kt_begin < kt_end)
    load_tile<T>(Qs, ld, q, a.qs, b, h, q0, a.Tq, D, a.scale);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    load_tile<T>(Ks, ld, k, a.ks, b, h, k0, a.Tk, D, 0.f);
    load_tile<T>(Vs, ld, v, a.vs, b, h, k0, a.Tk, D, 0.f);
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
        Ps[(rg * kRows + i) * kPP + cg + 8 * j] = round_to<T>(p);
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
      T* o = static_cast<T*>(a.o) + b * a.os[0] + row * a.os[1] +
             h * a.os[2];
#pragma unroll
      for (int t = 0; t < DT; ++t)
        if (t < dt) o[cg + 8 * t] = from_float<T>(acc[i][t]);
      if (cg == 0) {
        a.m[r] = mrow[i];
        a.l[r] = lrow[i];
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

// dims = B, H, Tq, Tk, D, q_off, k_off, causal.  False when the shape is
// outside the kernels' range.
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

// Split the KV range so that the work of all q tiles, in tile steps,
// makes about kBlocksPerSm blocks per SM, and no block's range exceeds
// that balanced share; at least two ranges when KV has two tiles.
StreamPlan make_stream_plan(const Args& a, int sm_count) {
  const int nqt = cdiv(a.Tq, kBQ);
  const int nk = cdiv(a.Tk, kBK);
  long long work = 0;
  for (int qt = 0; qt < nqt; ++qt)
    work += tiles_run(qt, a.Tq, a.Tk, a.q_off, a.k_off, a.causal);
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

template <typename T, int DMAX, bool SPLIT>
cudaError_t launch_attend(const Args& a, int splits, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DMAX, SPLIT>;
  const size_t smem = smem_bytes(DMAX);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(a.Tq, kBQ), a.B * a.H, splits);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool SPLIT>
cudaError_t launch_d(const Args& a, int splits, cudaStream_t stream) {
  if (a.D <= 32) return launch_attend<T, 32, SPLIT>(a, splits, stream);
  if (a.D <= 64) return launch_attend<T, 64, SPLIT>(a, splits, stream);
  return launch_attend<T, 128, SPLIT>(a, splits, stream);
}

template <typename T>
cudaError_t launch_stream(const Args& a, const StreamPlan& p,
                          cudaStream_t stream) {
  cudaError_t err = launch_d<T, true>(a, p.splits, stream);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(a.B) * a.H * a.Tq * a.D;
  const int threads = 256;
  merge_splits<T><<<cdiv(total, threads), threads, 0, stream>>>(a, p.splits);
  return cudaGetLastError();
}

}  // namespace

// K2: o, m, l of q against the whole of k, v.  dims: B, H, Tq, Tk, D,
// q_off, k_off, causal.  strides: b, t, h strides (elements) of q, k, v,
// o.  dtype 0 float32, 1 bfloat16.  Returns the CUDA error of the launch
// (0 = none), or cudaErrorInvalidValue when the shape is outside the
// kernel's range.
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
  a.chunk = cdiv(a.Tk, kBK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_d<float, false>(a, 1, s)
                                     : launch_d<__nv_bfloat16, false>(a, 1, s);
  return static_cast<int>(err);
}

// The split-KV plan of mx_flash_fwd_stream for these dims on sm_count
// SMs: plan[0..2] = KV ranges, KV tiles per range, fp32 workspace
// elements.  Returns 0, or cudaErrorInvalidValue for a shape outside the
// kernels' range.
extern "C" int mx_flash_fwd_stream_plan(const long long* dims, int sm_count,
                                        long long* plan) {
  Args a = {};
  if (!read_dims(dims, &a)) return static_cast<int>(cudaErrorInvalidValue);
  const StreamPlan p = make_stream_plan(a, sm_count);
  if (p.splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.splits;
  plan[1] = p.chunk;
  plan[2] = p.ws;
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
  const StreamPlan p = make_stream_plan(a, sm_count);
  if (p.splits > 65535 || ws == nullptr || ws_elems < p.ws)
    return static_cast<int>(cudaErrorInvalidValue);
  a.q = q; a.k = k; a.v = v; a.o = o; a.m = m; a.l = l; a.ws = ws;
  a.scale = scale;
  a.chunk = p.chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_stream<float>(a, p, s)
                                     : launch_stream<__nv_bfloat16>(a, p, s);
  return static_cast<int>(err);
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
