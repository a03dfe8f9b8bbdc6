// Probe of `wgmma ... .tf32` on sm_90a, the facts the fp32 route of
// incubator_mxnet_tpu_torch/csrc/flash_attn.cu relies on.  Prints one
// "name value" line each:
//   a_fragment        rows_plus_8 when a thread's A registers (m64k8) are
//                     a0 (r, t), a1 (r + 8, t), a2 (r, t + 4), a3 (r + 8, t + 4)
//                     (t = lane % 4); cols_plus_4 for a0 (r, t), a1 (r, t + 4),
//                     a2 (r + 8, t), a3 (r + 8, t + 4); else other
//   kmajor_swizzled   exact when A and B from 128-byte-swizzled K-major
//                     shared memory, k-steps 32 bytes apart, give the fp32
//                     product of small integers exactly
//   low_bits          truncate, round or keep: what the product 1 * x shows
//                     of x = 1 + 2^-11 + 2^-20 (TF32 keeps 10 mantissa bits)
// Build and run: nvcc -gencode arch=compute_90a,code=sm_90a -o probe
// wgmma_tf32_probe.cu && ./probe  (tests/test_torch_kernels_cuda.py does).
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <math.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
}

// d = A B, m64n8k8 tf32: A from registers, B from shared memory
__device__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4],
                            uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, 0, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}
// d = A B (sd 0) or d += A B, m64n8k8 tf32: A and B from shared memory
__device__ void wgmma_ss_n8(float (&d)[4], uint64_t a, uint64_t b, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(sd));
}

__global__ void probe_rs(float* out, float bval) {
  __shared__ __align__(1024) uint8_t sm[1024];
  const int tid = threadIdx.x;
  // B: n8 x k8, K-major: row n at n*128, k at +4k; B[n][k] = (n==k)*bval
  for (int e = tid; e < 64; e += 128) {
    const int n = e / 8, k = e % 8;
    *reinterpret_cast<float*>(sm + swz(n * 128 + k * 4)) =
        n == k ? bval : 0.f;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) {
    float v = static_cast<float>(tid * 4 + i + 1);
    a[i] = __float_as_uint(v);
  }
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_rs_n8(d, a, smem_desc(smem_addr(sm), 16, 1024));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  const int warp = tid / 32, lane = tid % 32;
  const int r = warp * 16 + lane / 4, c = 2 * (lane % 4);
  out[r * 8 + c] = d[0];
  out[r * 8 + c + 1] = d[1];
  out[(r + 8) * 8 + c] = d[2];
  out[(r + 8) * 8 + c + 1] = d[3];
}

// A 64 x 32 (smem, K-major swizzled), B 8 x 32 (smem, K-major swizzled),
// 4 k-steps; D 64 x 8
__global__ void probe_ss(const float* A, const float* B, float* out) {
  __shared__ __align__(1024) uint8_t sa[64 * 128];
  __shared__ __align__(1024) uint8_t sb[1024];
  const int tid = threadIdx.x;
  for (int e = tid; e < 64 * 32; e += 128) {
    int r = e / 32, k = e % 32;
    *reinterpret_cast<float*>(sa + swz(r * 128 + k * 4)) = A[e];
  }
  for (int e = tid; e < 8 * 32; e += 128) {
    int n = e / 32, k = e % 32;
    *reinterpret_cast<float*>(sb + swz(n * 128 + k * 4)) = B[e];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n8(d, smem_desc(smem_addr(sa) + kk * 32, 16, 1024),
                smem_desc(smem_addr(sb) + kk * 32, 16, 1024), kk > 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  const int warp = tid / 32, lane = tid % 32;
  const int r = warp * 16 + lane / 4, c = 2 * (lane % 4);
  out[r * 8 + c] = d[0];
  out[r * 8 + c + 1] = d[1];
  out[(r + 8) * 8 + c] = d[2];
  out[(r + 8) * 8 + c + 1] = d[3];
}

int main() {
  float* dout;
  cudaMalloc(&dout, 64 * 8 * 4);
  float h[64 * 8];
  // A fragment: A = 1 + 4 * thread + register, B = the identity, so D = A
  probe_rs<<<1, 128>>>(dout, 1.f);
  if (cudaDeviceSynchronize() != cudaSuccess) return 1;
  cudaMemcpy(h, dout, sizeof h, cudaMemcpyDeviceToHost);
  int rows8 = 1, cols4 = 1;
  for (int tid = 0; tid < 128; ++tid) {
    const int warp = tid / 32, lane = tid % 32;
    const int r = warp * 16 + lane / 4, t = lane % 4;
    const int r1[4] = {r, r + 8, r, r + 8}, c1[4] = {t, t, t + 4, t + 4};
    const int r2[4] = {r, r, r + 8, r + 8}, c2[4] = {t, t + 4, t, t + 4};
    for (int i = 0; i < 4; ++i) {
      const float v = tid * 4 + i + 1;
      if (h[r1[i] * 8 + c1[i]] != v) rows8 = 0;
      if (h[r2[i] * 8 + c2[i]] != v) cols4 = 0;
    }
  }
  printf("a_fragment %s\n", rows8 ? "rows_plus_8" : cols4 ? "cols_plus_4"
                                                         : "other");
  // K-major swizzled operands from shared memory, 4 k-steps
  float hA[64 * 32], hB[8 * 32], ref[64 * 8];
  for (int i = 0; i < 64 * 32; ++i) hA[i] = (float)((i * 7) % 13 - 6);
  for (int i = 0; i < 8 * 32; ++i) hB[i] = (float)((i * 5) % 11 - 5);
  for (int m = 0; m < 64; ++m)
    for (int n = 0; n < 8; ++n) {
      float s = 0;
      for (int k = 0; k < 32; ++k) s += hA[m * 32 + k] * hB[n * 32 + k];
      ref[m * 8 + n] = s;
    }
  float *dA, *dB;
  cudaMalloc(&dA, sizeof hA);
  cudaMalloc(&dB, sizeof hB);
  cudaMemcpy(dA, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, hB, sizeof hB, cudaMemcpyHostToDevice);
  probe_ss<<<1, 128>>>(dA, dB, dout);
  if (cudaDeviceSynchronize() != cudaSuccess) return 1;
  cudaMemcpy(h, dout, sizeof h, cudaMemcpyDeviceToHost);
  int exact = 1;
  for (int i = 0; i < 64 * 8; ++i) exact &= h[i] == ref[i];
  printf("kmajor_swizzled %s\n", exact ? "exact" : "wrong");
  // the low 13 bits of an operand: B = x on the diagonal, A(0, 0) = 1
  const float x = 1.0f + ldexpf(1.f, -11) + ldexpf(1.f, -20);
  probe_rs<<<1, 128>>>(dout, x);
  if (cudaDeviceSynchronize() != cudaSuccess) return 1;
  cudaMemcpy(h, dout, sizeof h, cudaMemcpyDeviceToHost);
  printf("low_bits %s\n", h[0] == 1.0f ? "truncate"
                           : h[0] == 1.0f + ldexpf(1.f, -10) ? "round"
                           : h[0] == x ? "keep" : "other");
  return 0;
}
