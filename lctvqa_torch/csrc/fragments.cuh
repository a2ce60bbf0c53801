// Fragment helpers shared by the tensor-core and tiled kernels (the LSTM
// cell in lstm.cu, the sequence kernels in lstm_seq.cuh, the mixed-op node
// in mixedop.cu): values of the compute dtype, mma.sync, ldmatrix, cp.async
// and vector loads with a ragged edge.
#pragma once

#include <cstdint>
#include <mutex>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lctvqa {

// Host side. cudaFuncSetAttribute(MaxDynamicSharedMemorySize) for `fn` on
// the current device, called only when a launch needs more than the
// kernel was last allowed there: a call through the runtime costs
// microseconds, and the entry points run once per kernel call.
inline cudaError_t allow_dynamic_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  struct Entry {
    const void* fn;
    int dev, bytes;
  };
  static std::mutex lock;
  static Entry table[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  int at = -1;
  for (int i = 0; i < used; ++i)
    if (table[i].fn == fn && table[i].dev == dev) at = i;
  if (at >= 0 && table[at].bytes >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  if (at < 0 && used < 64) at = used++;
  if (at >= 0) table[at] = {fn, dev, bytes};
  return cudaSuccess;
}

// The device's shared memory a block may opt in to, asked once per device.
inline cudaError_t smem_optin(int* bytes) {
  static std::mutex lock;
  static int known[16] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  if (dev < 16 && known[dev] > 0) {
    *bytes = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess && dev < 16) known[dev] = *bytes;
  return err;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two fp32 values rounded to bf16 (round to nearest even), packed low first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four values (fp32 or bf16) at p as floats; p aligned for one load.
__device__ __forceinline__ float4 ld4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4f(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// Two values (fp32 or bf16) at p as floats; p aligned for one load.
__device__ __forceinline__ float2 ld2f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2f(const __nv_bfloat16* p) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// Four floats rounded to T at p (aligned for one store).
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y),
                                            pack_bf16(v.z, v.w));
}

// D[16x8] += A[16x16] * B[16x8], bf16 operands, fp32 sums. With g = lane / 4
// and q = lane % 4: a0..a3 hold A[g][2q..], A[g+8][2q..], A[g][2q+8..],
// A[g+8][2q+8..]; b0, b1 hold B[2q..][g], B[2q+8..][g]; c holds D[g][2q],
// D[g][2q+1], D[g+8][2q], D[g+8][2q+1].
__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Asynchronous copies to shared memory: 16 bytes past L1, 8 bytes through
// it. Both addresses aligned to the size.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Four consecutive elements at p, of which `left` exist (<= 0: none); the
// rest read as 0. vec: p is aligned for one load and left is 0 or >= 4.
__device__ __forceinline__ uint2 load4(const __nv_bfloat16* p, int left,
                                       bool vec) {
  if (left <= 0) return make_uint2(0u, 0u);
  if (vec) return *reinterpret_cast<const uint2*>(p);
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < left ? u[i] : 0u;
  return make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
}

__device__ __forceinline__ float4 load4(const float* p, int left, bool vec) {
  if (left <= 0) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) return *reinterpret_cast<const float4*>(p);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < left ? p[i] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Four 8 x 8 bf16 matrices from shared memory, each transposed: from rows
// of 8 contiguous n at consecutive k to the "col" operand of mma. Lane l
// gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* smem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same without the transpose: rows of 8 contiguous k, as the "row"
// operand A lies ([m][k]) and as a [n][k] array holds the "col" operand B.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

}  // namespace lctvqa
