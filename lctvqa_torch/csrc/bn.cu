// Batch-statistics BatchNorm forward for Hopper (sm_90a), bound to Python
// with ctypes (lctvqa_torch/ops/cuda_bn.py). Replaces the forward of the
// Pallas TPU kernel of lctvqa/ops/pallas_bn.py (_fwd_kernel, the
// pallas_call at pallas_bn.py:81):
//
//   lctvqa_bn_fwd   y = (x - mean_c) * rsqrt(var_c + eps) over a contiguous
//                   [M, C] view of an NHWC tensor, no scale or bias,
//                   var = E[x^2] - mean^2, statistics and normalize in fp32,
//                   x fp32 or bf16, y fp32 or bf16
//
// What bounds it on an H100: bytes. It does 5 operations per element it
// moves, so the least time is one read of x and one write of y at the
// memory rate. The TPU kernel gets its "one read, one write" by holding
// the whole tensor in VMEM; no block here holds a 16 MiB tensor and blocks
// run in no order, so the statistics need a grid-wide dependency. Design:
// three launches on one stream.
//   1. bn_stats: each block sums x and x^2 per channel over its share of
//      the rows and writes one partial per block. No atomics: the partials
//      are added in a fixed order, so a result does not change from run to
//      run, which a served answer should not.
//   2. bn_finalize: one thread per channel adds the partials in block
//      order and writes mean and 1/sqrt(var + eps).
//   3. bn_normalize: reads x a second time (from the 50 MB L2 when the
//      tensor fits there) and writes y.
// The lane-packing of the TPU kernel (_select_matrix) is a TPU layout
// device and has no counterpart. Threads form `rows` x `lanes`: a lane owns
// VEC neighbouring channels (VEC = 4 when C is a multiple of 4, so an fp32
// thread moves 16 bytes at a time), and neighbouring threads read
// neighbouring addresses.
#include "lstm_common.cuh"

namespace lctvqa {
namespace {

constexpr int kBnThreads = 256;
constexpr int kBnMaxBlocks = 264;  // two per SM of an H100

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float v[VEC]);
template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p,
                                                   float v[1]) {
  v[0] = p[0];
}
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p,
                                                   float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float v[1]) {
  v[0] = __bfloat162float(p[0]);
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(
    const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float v[VEC]);
template <>
__device__ __forceinline__ void store_vec<float, 1>(float* p,
                                                    const float v[1]) {
  p[0] = v[0];
}
template <>
__device__ __forceinline__ void store_vec<float, 4>(float* p,
                                                    const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 1>(
    __nv_bfloat16* p, const float v[1]) {
  p[0] = __float2bfloat16_rn(v[0]);
}
template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 4>(
    __nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned*>(&a);
  q.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// partial: [gridDim.x, 2, C] (sum, sum of squares). Thread (r, lane) with
// tid = r * lanes + lane walks rows r, r + rows, ... of this block's share.
template <typename T, int VEC>
__global__ void bn_stats_kernel(const T* __restrict__ x,
                                float* __restrict__ partial, long long M,
                                int C, int lanes, int rows) {
  extern __shared__ float red[];  // [rows * lanes][2 * VEC]
  const int lane = threadIdx.x % lanes;
  const int r = threadIdx.x / lanes;
  const int groups = C / VEC;
  for (int g0 = 0; g0 < groups; g0 += lanes) {
    const int g = g0 + lane;
    const bool active = g < groups;
    float s[VEC], q[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.f;
    if (active) {
      const long long step = (long long)gridDim.x * rows;
#pragma unroll 4
      for (long long row = (long long)blockIdx.x * rows + r; row < M;
           row += step) {
        float v[VEC];
        load_vec<T, VEC>(x + row * C + (long long)g * VEC, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          s[k] += v[k];
          q[k] = fmaf(v[k], v[k], q[k]);
        }
      }
    }
    float* mine = red + (size_t)threadIdx.x * 2 * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      mine[k] = s[k];
      mine[VEC + k] = q[k];
    }
    __syncthreads();
    if (active && r == 0) {
      for (int r2 = 1; r2 < rows; ++r2) {
        const float* other = red + (size_t)(r2 * lanes + lane) * 2 * VEC;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          s[k] += other[k];
          q[k] += other[VEC + k];
        }
      }
      float* out = partial + (size_t)blockIdx.x * 2 * C + (size_t)g * VEC;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        out[k] = s[k];
        out[C + k] = q[k];
      }
    }
    __syncthreads();
  }
}

// stat: [2, C] (mean, 1/sqrt(var + eps)).
__global__ void bn_finalize_kernel(const float* __restrict__ partial,
                                   float* __restrict__ stat, int blocks,
                                   int C, float inv_count, float eps) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f, q = 0.f;
  for (int b = 0; b < blocks; ++b) {
    s += partial[(size_t)b * 2 * C + c];
    q += partial[(size_t)b * 2 * C + C + c];
  }
  const float mean = s * inv_count;
  const float var = q * inv_count - mean * mean;
  stat[c] = mean;
  stat[C + c] = 1.f / sqrtf(var + eps);
}

template <typename T, typename TO, int VEC>
__global__ void bn_normalize_kernel(const T* __restrict__ x,
                                    const float* __restrict__ stat,
                                    TO* __restrict__ y, long long M, int C,
                                    int lanes, int rows) {
  const int lane = threadIdx.x % lanes;
  const int r = threadIdx.x / lanes;
  const int groups = C / VEC;
  const long long step = (long long)gridDim.x * rows;
  for (int g = lane; g < groups; g += lanes) {
    float mean[VEC], rstd[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      mean[k] = stat[g * VEC + k];
      rstd[k] = stat[C + g * VEC + k];
    }
#pragma unroll 4
    for (long long row = (long long)blockIdx.x * rows + r; row < M;
         row += step) {
      const long long at = row * C + (long long)g * VEC;
      float v[VEC];
      load_vec<T, VEC>(x + at, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = (v[k] - mean[k]) * rstd[k];
      store_vec<TO, VEC>(y + at, v);
    }
  }
}

template <typename T, typename TO, int VEC>
cudaError_t bn_fwd(const void* x, void* y, void* partial, void* stat,
                   long long M, int C, float eps, cudaStream_t s) {
  const int groups = C / VEC;
  const int lanes = groups < kBnThreads ? groups : kBnThreads;
  const int rows = kBnThreads / lanes;
  const int threads = rows * lanes;
  long long want = (M + rows - 1) / rows;
  const int blocks = (int)(want < kBnMaxBlocks ? want : kBnMaxBlocks);
  const size_t shmem = (size_t)threads * 2 * VEC * sizeof(float);
  bn_stats_kernel<T, VEC><<<blocks, threads, shmem, s>>>(
      (const T*)x, (float*)partial, M, C, lanes, rows);
  bn_finalize_kernel<<<(C + 255) / 256, 256, 0, s>>>(
      (const float*)partial, (float*)stat, blocks, C, 1.f / (float)M, eps);
  // the normalize pass has no reduction, so it takes more blocks
  want = (M + rows - 1) / rows;
  const int nblocks = (int)(want < 8 * kBnMaxBlocks ? want : 8 * kBnMaxBlocks);
  bn_normalize_kernel<T, TO, VEC><<<nblocks, threads, 0, s>>>(
      (const T*)x, (const float*)stat, (TO*)y, M, C, lanes, rows);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t bn_fwd_vec(const void* x, void* y, void* partial, void* stat,
                       long long M, int C, float eps, cudaStream_t s) {
  if (C % 4 == 0) return bn_fwd<T, TO, 4>(x, y, partial, stat, M, C, eps, s);
  return bn_fwd<T, TO, 1>(x, y, partial, stat, M, C, eps, s);
}

}  // namespace
}  // namespace lctvqa

extern "C" {

// The number of per-block partials lctvqa_bn_fwd writes at most: `partial`
// must hold this many times 2 * C floats.
int lctvqa_bn_max_blocks() { return lctvqa::kBnMaxBlocks; }

// x: [M, C] contiguous in `in_dtype`; y: [M, C] in `out_dtype`; partial:
// fp32 scratch [lctvqa_bn_max_blocks(), 2, C]; stat: fp32 [2, C], left
// holding mean and 1/sqrt(var + eps). M >= 1, C >= 1.
int lctvqa_bn_fwd(const void* x, void* y, void* partial, void* stat,
                  long long M, int C, float eps, int in_dtype, int out_dtype,
                  void* stream) {
  using namespace lctvqa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  if (in_dtype == kFloat32 && out_dtype == kFloat32)
    rc = bn_fwd_vec<float, float>(x, y, partial, stat, M, C, eps, s);
  else if (in_dtype == kFloat32 && out_dtype == kBFloat16)
    rc = bn_fwd_vec<float, __nv_bfloat16>(x, y, partial, stat, M, C, eps, s);
  else if (in_dtype == kBFloat16 && out_dtype == kFloat32)
    rc = bn_fwd_vec<__nv_bfloat16, float>(x, y, partial, stat, M, C, eps, s);
  else if (in_dtype == kBFloat16 && out_dtype == kBFloat16)
    rc = bn_fwd_vec<__nv_bfloat16, __nv_bfloat16>(x, y, partial, stat, M, C,
                                                  eps, s);
  return (int)rc;
}

}  // extern "C"
