// Shared device code of the LSTM-family kernels (lstm.cu, generate.cu).
//
// Numerics of every kernel here follow the Pallas kernels they replace
// (lctvqa/ops/pallas_lstm.py, lctvqa/ops/pallas_generate.py): matmul
// operands are values of the compute dtype T (float or bf16), every
// product and sum is fp32, the bias is fp32, and the h/c state is fp32.
// h is rounded to T only where it enters the recurrent product.
//
// Thread layout of a gate computation: the block's threads form `ks`
// slices of `hp` threads (hp a multiple of 32). Thread (s, j), tid =
// s * hp + j, sums the four gate dots of hidden unit j over slice s of
// the concatenated input rows [x; h]. Splitting the rows keeps more
// independent weight loads in flight per SM, which is what bounds these
// kernels (they read the weights from L2 once per row and step).
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

// acc[g] += sum over input rows k in [k0, k1) of in[k] * W[k, g*H + j],
// where rows k < E are x (x_s, w_ih) and rows k >= E are h (hq_s, w_hh).
// Weights are [rows, 4H] row-major: the threads of a warp (neighbouring
// j) read neighbouring addresses.
template <typename T>
__device__ __forceinline__ void gate_partial(
    const float* __restrict__ x_s, const float* __restrict__ hq_s,
    const T* __restrict__ w_ih, const T* __restrict__ w_hh, int E, int H,
    int j, int k0, int k1, float acc[4]) {
  const int G = 4 * H;
  int k = k0;
  const int kx = k1 < E ? k1 : E;
  const T* w = w_ih + (size_t)k * G + j;
#pragma unroll 4
  for (; k < kx; ++k, w += G) {
    const float v = x_s[k];
    acc[0] = fmaf(v, to_f32(w[0]), acc[0]);
    acc[1] = fmaf(v, to_f32(w[H]), acc[1]);
    acc[2] = fmaf(v, to_f32(w[2 * H]), acc[2]);
    acc[3] = fmaf(v, to_f32(w[3 * H]), acc[3]);
  }
  if (k >= k1) return;
  w = w_hh + (size_t)(k - E) * G + j;
#pragma unroll 4
  for (; k < k1; ++k, w += G) {
    const float v = hq_s[k - E];
    acc[0] = fmaf(v, to_f32(w[0]), acc[0]);
    acc[1] = fmaf(v, to_f32(w[H]), acc[1]);
    acc[2] = fmaf(v, to_f32(w[2 * H]), acc[2]);
    acc[3] = fmaf(v, to_f32(w[3 * H]), acc[3]);
  }
}

// The four gate sums of unit j = j0 + (tid % hp) over all E + H rows.
// Every thread of the block must call it (it synchronises); the sums are
// complete in slice 0 (tid < hp), for j < H. part_s holds
// (ks - 1) * 4 * hp floats. Returns false for threads that hold no
// complete sum.
template <typename T>
__device__ __forceinline__ bool block_gates(
    const float* __restrict__ x_s, const float* __restrict__ hq_s,
    const T* __restrict__ w_ih, const T* __restrict__ w_hh, int E, int H,
    int j0, int hp, int ks, float* __restrict__ part_s, float acc[4]) {
  const int s = threadIdx.x / hp;
  const int jj = threadIdx.x % hp;
  const int j = j0 + jj;
  const int rows = E + H;
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  if (j < H)
    gate_partial<T>(x_s, hq_s, w_ih, w_hh, E, H, j, s * rows / ks,
                    (s + 1) * rows / ks, acc);
  if (s > 0 && j < H)
    for (int g = 0; g < 4; ++g) part_s[((s - 1) * 4 + g) * hp + jj] = acc[g];
  __syncthreads();
  if (s > 0 || j >= H) return false;
  for (int s2 = 1; s2 < ks; ++s2)
    for (int g = 0; g < 4; ++g) acc[g] += part_s[((s2 - 1) * 4 + g) * hp + jj];
  return true;
}

// Torch gate order i, f, g, o: c' = f c + i g, h' = o tanh(c').
__device__ __forceinline__ void cell_finish(const float acc[4],
                                            const float* __restrict__ b,
                                            int H, int j, float c_prev,
                                            float* h_new, float* c_new) {
  const float i = sigmoid(acc[0] + b[j]);
  const float f = sigmoid(acc[1] + b[H + j]);
  const float g = tanhf(acc[2] + b[2 * H + j]);
  const float o = sigmoid(acc[3] + b[3 * H + j]);
  const float c = f * c_prev + i * g;
  *c_new = c;
  *h_new = o * tanhf(c);
}

// Slices for a block that owns all H units of a row: hp = H rounded up to
// a warp, ks = as many slices (at most 4) as fit in 1024 threads.
// Requires H <= 1024.
inline void row_layout(int H, int* hp, int* ks) {
  *hp = ((H + 31) / 32) * 32;
  int k = 1024 / *hp;
  *ks = k > 4 ? 4 : (k < 1 ? 1 : k);
}

}  // namespace lctvqa
