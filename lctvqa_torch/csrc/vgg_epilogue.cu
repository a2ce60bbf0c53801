// The VGG epilogue for Hopper (sm_90a), bound to Python with ctypes
// (lctvqa_torch/ops/cuda_vgg.py). It replaces no TPU kernel: the JAX
// package leaves VGG19's convolutions and the elementwise work around them
// to XLA, which fuses that work into its convolutions. The port leaves the
// convolutions to cuDNN, and there the work after each of them (a cast of
// the bf16 result to fp32, the bias added through a broadcast, ReLU in
// fp32, an fp32 2x2 max pool, and the next convolution's cast back to
// bf16) was four or five passes over the tensor that held more device time
// than the convolutions.
//
//   lctvqa_vgg_epilogue   out = relu(f32(y) + b), then, where `pool` is
//                         set, the 2x2 stride-2 max in floor mode
//                         (F.max_pool2d(x, 2, 2)'s), written once in
//                         out's dtype (round to nearest even for bf16)
//
// y is the raw convolution, [N, H, W, C] contiguous, fp32 or bf16; b fp32
// [C]; out [N, H, W, C], or [N, H/2, W/2, C] pooled, in y's dtype or fp32
// (bf16 to bf16 between convolutions, bf16 to fp32 into the adaptive pool,
// fp32 to fp32; the route makes no other pair). The
// arithmetic is the plain version's (ops/cuda_vgg.py::vgg_epilogue_plain),
// operation for operation: one fp32 add (no product to contract into an
// FMA), ReLU, max, one rounding at the end, so the two agree bit for bit.
//
// What bounds it on an H100: bytes. It does one add, one max and, pooled,
// three more maxes per element read, so the least time is one read of y
// and one write of out at 3.35 TB/s: 4 bytes an element in bf16, 2.5 where
// the pool follows (2 read, a quarter of 2 written). Its design:
//   - a thread owns 8 neighbouring channels of one output pixel: one
//     16-byte load a pixel read (two in fp32) and one 16-byte store (two);
//     its 8 bias values are loaded once into registers;
//   - a block is `rows` x `lanes` threads, lanes = C / 8 (C % 8 == 0), rows
//     = 256 / lanes, so neighbouring threads touch neighbouring 16-byte
//     words of one pixel, and a block's pixels follow each other in memory;
//   - the grid is as many blocks as are resident on the card at once (the
//     occupancy calculator's count times the SMs), or fewer where the
//     tensor has fewer pixels; each thread walks its pixels with a stride
//     of the whole grid's rows, keeping its channels (and its bias). At the
//     smallest of VGG19's 16 shapes at 224 px and B 64, [64,14,14,512]
//     pooled, that is 784 blocks of 4 pixels: every SM has work;
//   - the input is read once with an evict-first hint (__ldcs): nothing
//     reads it again. The output is stored plainly, for the next
//     convolution to find what of it stays in the L2.
// A pooled thread issues its four pixels' loads before it computes, so 64
// bytes (bf16) or 128 (fp32) are in flight a thread.
#include <cstdint>

#include "lstm_common.cuh"

namespace lctvqa {
namespace {
namespace vgg {

constexpr int kThreads = 256;   // threads a block at most
constexpr int kMaxDevices = 64;

// 8 values of one pixel's channel group, widened to fp32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]));
    const uint32_t hi =
        __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// torch.relu's: a NaN stays NaN
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// max_pool2d's step: the larger, or a NaN
__device__ __forceinline__ float pool_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

template <typename TI, typename TO, bool POOL>
__global__ void __launch_bounds__(kThreads)
    vgg_epilogue_kernel(const TI* __restrict__ y,
                        const float* __restrict__ bias, TO* __restrict__ out,
                        long long pixels, int H, int W, int Ho, int Wo,
                        int C, int lanes, int rows) {
  const int lane = threadIdx.x % lanes;
  const int c0 = 8 * lane;
  float b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) b[k] = bias[c0 + k];
  const long long stride = (long long)gridDim.x * rows;
  for (long long p = (long long)blockIdx.x * rows + threadIdx.x / lanes;
       p < pixels; p += stride) {
    float v[8];
    if constexpr (POOL) {
      // 32-bit division: the host refuses 2^32 pixels or more
      const unsigned q = (unsigned)p / (unsigned)Wo;
      const unsigned ow = (unsigned)p - q * (unsigned)Wo;
      const unsigned n = q / (unsigned)Ho;
      const unsigned oh = q - n * (unsigned)Ho;
      const TI* src =
          y + (((long long)n * H + 2 * oh) * W + 2 * ow) * C + c0;
      const long long row = (long long)W * C;
      float a[8], e[8], f[8];
      load8(src, v);
      load8(src + C, a);
      load8(src + row, e);
      load8(src + row + C, f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float m = relu(v[k] + b[k]);
        m = pool_max(m, relu(a[k] + b[k]));
        m = pool_max(m, relu(e[k] + b[k]));
        v[k] = pool_max(m, relu(f[k] + b[k]));
      }
    } else {
      load8(y + p * C + c0, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = relu(v[k] + b[k]);
    }
    store8(out + p * C + c0, v);
  }
}

// The card's SMs and the resident blocks an SM of one instantiation at
// `threads` a block, asked once per device and block size.
template <typename TI, typename TO, bool POOL>
cudaError_t resident_blocks(int threads, int* blocks) {
  struct Seen {
    int threads, blocks;
  };
  static Seen seen[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && seen[dev].threads == threads) {
    *blocks = seen[dev].blocks;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, vgg_epilogue_kernel<TI, TO, POOL>, threads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) seen[dev] = {threads, *blocks};
  return cudaSuccess;
}

template <typename TI, typename TO, bool POOL>
cudaError_t launch(const void* y, const float* bias, void* out, int N, int H,
                   int W, int C, cudaStream_t s) {
  const int lanes = C / 8;
  const int rows = kThreads / lanes;
  const int Ho = POOL ? H / 2 : H, Wo = POOL ? W / 2 : W;
  const long long pixels = (long long)N * Ho * Wo;
  int resident = 0;
  cudaError_t err = resident_blocks<TI, TO, POOL>(rows * lanes, &resident);
  if (err != cudaSuccess) return err;
  const long long needed = (pixels + rows - 1) / rows;
  const int blocks = (int)(needed < resident ? needed : resident);
  vgg_epilogue_kernel<TI, TO, POOL><<<blocks, rows * lanes, 0, s>>>(
      static_cast<const TI*>(y), bias, static_cast<TO*>(out), pixels, H, W,
      Ho, Wo, C, lanes, rows);
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t launch_pool(const void* y, const float* bias, void* out, int N,
                        int H, int W, int C, int pool, cudaStream_t s) {
  return pool ? launch<TI, TO, true>(y, bias, out, N, H, W, C, s)
              : launch<TI, TO, false>(y, bias, out, N, H, W, C, s);
}

}  // namespace vgg
}  // namespace
}  // namespace lctvqa

extern "C" {

// y: [N, H, W, C] contiguous in `in_dtype`, 16-byte aligned; bias: fp32
// [C]; out: [N, H, W, C] (pool == 0) or [N, H / 2, W / 2, C] (pool != 0,
// H >= 2 and W >= 2) contiguous in `out_dtype`, 16-byte aligned; the
// dtypes (in, out) bf16 and bf16, bf16 and fp32, or fp32 and fp32. N, H,
// W >= 1, N H W < 2^32; C a multiple of 8, at most 8 * 256. Anything else
// is refused with cudaErrorInvalidValue, before any launch.
int lctvqa_vgg_epilogue(const void* y, const void* bias, void* out, int N,
                        int H, int W, int C, int pool, int in_dtype,
                        int out_dtype, void* stream) {
  using namespace lctvqa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || H < 1 || W < 1 || C < 8 || C % 8 || C / 8 > vgg::kThreads ||
      (pool && (H < 2 || W < 2)) || (long long)N * H * W > 0xffffffffLL ||
      reinterpret_cast<uintptr_t>(y) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  if (in_dtype == kBFloat16 && out_dtype == kBFloat16)
    return (int)vgg::launch_pool<__nv_bfloat16, __nv_bfloat16>(
        y, b, out, N, H, W, C, pool, s);
  if (in_dtype == kBFloat16 && out_dtype == kFloat32)
    return (int)vgg::launch_pool<__nv_bfloat16, float>(y, b, out, N, H, W, C,
                                                       pool, s);
  if (in_dtype == kFloat32 && out_dtype == kFloat32)
    return (int)vgg::launch_pool<float, float>(y, b, out, N, H, W, C, pool,
                                               s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
