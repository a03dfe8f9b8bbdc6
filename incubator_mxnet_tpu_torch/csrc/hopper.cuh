// Hopper (sm_90a) building blocks shared by the port's kernel sources:
// element conversions, mbarriers, the 128-byte swizzle, wgmma shared-memory
// descriptors and fences, TF32 rounding, and the host's lookup of
// cuTensorMapEncodeTiled.  Each source that includes it is its own library
// (kernels/_build.py), so everything here has internal linkage.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

// ---- element types ---------------------------------------------------------

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// ---- barriers, fences ------------------------------------------------------

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

// named barrier `id` over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma operands --------------------------------------------------------

// a wgmma descriptor of a 128-byte-swizzled tile at shared address addr:
// 8-row groups `sbo` bytes apart; lbo as the layout wants it
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// a K-major swizzled operand at `addr`: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}

// the 128-byte swizzle of byte offset `off` in a 1024-aligned tile: the
// 16-byte chunk of a 128-byte row moves by the row's index mod 8
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
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

// x, opaque to the compiler: what is computed from it inside a loop stays
// there (wgmma descriptors hoisted out of a loop would hold registers)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as fp32.
// wgmma reads only the top 19 bits of a .tf32 operand (it truncates), so
// 3xTF32 rounds hi and lo itself.
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// accumulator operand lists of wgmma asm: MX_R<n> names n registers, MX_A<n>(d)
// binds d[0 .. n-1]
#define MX_R4 "%0, %1, %2, %3"
#define MX_R8 MX_R4 ", %4, %5, %6, %7"
#define MX_R16 MX_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define MX_R32 MX_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31"
#define MX_R64 MX_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, " \
    "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
    "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define MX_A4(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define MX_A8(d) MX_A4(d), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define MX_A16(d) MX_A8(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
    "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define MX_A32(d) MX_A16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
    "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), \
    "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define MX_A64(d) MX_A32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
    "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
    "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
    "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
    "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// ---- host ------------------------------------------------------------------

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

// dtype codes of the C interfaces
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

CUtensorMapDataType map_type(int dtype) {
  return dtype == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

}  // namespace
