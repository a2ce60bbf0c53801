// Shared device code of the LSTM-family kernels (lstm.cu, generate.cu).
//
// Numerics of every kernel here follow the Pallas kernels they replace
// (lctvqa/ops/pallas_lstm.py, lctvqa/ops/pallas_generate.py): matmul
// operands are values of the compute dtype T (float or bf16), every
// product and sum is fp32, the bias is fp32, and the h/c state is fp32.
// h is rounded to T only where it enters the recurrent product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lctvqa {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round an fp32 value to T and widen it back (round-to-nearest-even, the
// rounding of torch's .to(torch.bfloat16) and of jnp's astype).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

}  // namespace lctvqa
