// Whole-loop greedy decode for Hopper (sm_90a), bound to Python with
// ctypes (lctvqa_torch/ops/cuda_generate.py). It replaces the Pallas TPU
// kernel of lctvqa/ops/pallas_generate.py (the pallas_call at :142, inside
// greedy_generate_pallas).
//
// Per step: the LSTM cell, logits = fc2(tanh h) + b, the first maximum of
// the logits (jnp.argmax's and torch.argmax's rule), and the next input
// x = table[token] as an fp32 row with no tanh. h0 = c0 = the image
// embedding and x0 = tanh(table[<start>]) come from the wrapper.
//
// What bounds it on an H100: weight reads. Each step of each batch row
// reads the LSTM weights (3.2 MB in bf16 at full width) and the vocabulary
// head fc2 [512, 8192] (8 MB in bf16); together 11 MB, which stays in the
// 50 MB L2. With one block per row the bound is the L2 bandwidth one SM
// can draw, which takes many loads in flight. Sharing weight tiles between
// the rows of a block, and spreading one row's vocabulary head over
// several blocks, are later work.
//
// Design. The TPU kernel keeps every weight resident in VMEM and runs the
// loop in one invocation. Here one block runs one batch row's whole loop
// with the state in shared memory: the cell as in lstm.cu (block_gates,
// ks slices of hp threads, 1024 threads at H = 512); for the head each
// thread reads eight neighbouring columns with one 16-byte load per row
// (bf16) and keeps its (max, lowest index); a warp-shuffle reduction then
// picks the first maximum.
#include <math.h>

#include "lstm_common.cuh"

namespace lctvqa {
namespace {

// Eight consecutive values at p (16-byte aligned) as floats: one 16-byte
// load for bf16, two for fp32.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// (v, i) beats (ov, oi): larger value, or equal value and lower index.
__device__ __forceinline__ bool beats(float v, int i, float ov, int oi) {
  return v > ov || (v == ov && i < oi);
}

template <typename T>
__global__ void __launch_bounds__(1024)
    greedy_generate_kernel(const float* __restrict__ h0,
                           const float* __restrict__ x0,
                           const T* __restrict__ w_ih,
                           const T* __restrict__ w_hh,
                           const float* __restrict__ b,
                           const T* __restrict__ fc2_w,
                           const float* __restrict__ fc2_b,
                           const float* __restrict__ table,
                           int* __restrict__ tokens, int steps, int E, int H,
                           int V, int hp, int ks) {
  extern __shared__ float smem[];
  float* x_s = smem;        // [E]  x rounded to T
  float* hq_s = x_s + E;    // [H]  h rounded to T
  float* hn_s = hq_s + H;   // [H]  new h in fp32
  float* c_s = hn_s + H;    // [H]  c, each unit owned by one thread
  float* th_s = c_s + H;    // [H]  tanh(h) rounded to T
  float* part_s = th_s + H; // [(ks - 1) * 4 * hp]
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int tok_s;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  for (int k = tid; k < H; k += bd) {
    const float v = h0[(size_t)row * H + k];
    hq_s[k] = round_to<T>(v);
    c_s[k] = v;
  }
  for (int k = tid; k < E; k += bd) x_s[k] = round_to<T>(x0[k]);
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    float acc[4];
    if (block_gates<T>(x_s, hq_s, w_ih, w_hh, E, H, 0, hp, ks, part_s,
                       acc)) {
      float hn, cn;
      cell_finish(acc, b, H, tid, c_s[tid], &hn, &cn);
      c_s[tid] = cn;
      hn_s[tid] = hn;
      th_s[tid] = round_to<T>(tanhf(hn));
    }
    __syncthreads();  // th_s complete; x_s, hq_s, part_s no longer read
    for (int k = tid; k < H; k += bd) hq_s[k] = round_to<T>(hn_s[k]);

    // vocabulary head: thread tid owns the eight columns 8 tid ... 8 tid + 7,
    // then 8 (tid + bd) ..., read with 16-byte loads (V is a multiple of
    // 8). Scanning its columns in increasing order with a strict >, it
    // keeps the first of equal maxima.
    float best = -INFINITY;
    int best_i = V;
    for (int v0 = 8 * tid; v0 < V; v0 += 8 * bd) {
      float hacc[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) hacc[c] = 0.f;
      const T* w = fc2_w + v0;
#pragma unroll 4
      for (int k = 0; k < H; ++k, w += V) {
        float wv[8];
        load8(w, wv);
        const float th = th_s[k];
#pragma unroll
        for (int c = 0; c < 8; ++c) hacc[c] = fmaf(th, wv[c], hacc[c]);
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float l = hacc[c] + fc2_b[v0 + c];
        if (l > best) {
          best = l;
          best_i = v0 + c;
        }
      }
    }
    // first maximum across the block: within each warp, then across warps
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (beats(ov, oi, best, best_i)) {
        best = ov;
        best_i = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < bd / 32 ? red_v[lane] : -INFINITY;
      best_i = lane < bd / 32 ? red_i[lane] : V;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
        if (beats(ov, oi, best, best_i)) {
          best = ov;
          best_i = oi;
        }
      }
      if (lane == 0) {
        tok_s = best_i;
        tokens[(size_t)row * steps + t] = best_i;
      }
    }
    __syncthreads();
    const float* emb = table + (size_t)tok_s * E;
    for (int k = tid; k < E; k += bd) x_s[k] = round_to<T>(emb[k]);
    __syncthreads();
  }
}

}  // namespace
}  // namespace lctvqa

extern "C" {

// h0: [B, H] fp32; x0: [E] fp32; w_ih [E, 4H], w_hh [H, 4H] and fc2_w
// [H, V] in `dtype`; b [4H], fc2_b [V] and table [V, E] fp32; tokens:
// [B, steps] int32. H <= 1024; V a multiple of 8 and fc2_w 16-byte
// aligned.
int lctvqa_greedy_generate(const void* h0, const void* x0, const void* w_ih,
                           const void* w_hh, const void* b,
                           const void* fc2_w, const void* fc2_b,
                           const void* table, void* tokens, int B, int steps,
                           int E, int H, int V, int dtype, void* stream) {
  using namespace lctvqa;
  int hp, ks;
  row_layout(H, &hp, &ks);
  const int threads = hp * ks;
  size_t shmem = (size_t)(E + 4 * H + (ks - 1) * 4 * hp) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    greedy_generate_kernel<float><<<B, threads, shmem, s>>>(
        (const float*)h0, (const float*)x0, (const float*)w_ih,
        (const float*)w_hh, (const float*)b, (const float*)fc2_w,
        (const float*)fc2_b, (const float*)table, (int*)tokens, steps, E, H,
        V, hp, ks);
  } else if (dtype == kBFloat16) {
    greedy_generate_kernel<__nv_bfloat16><<<B, threads, shmem, s>>>(
        (const float*)h0, (const float*)x0, (const __nv_bfloat16*)w_ih,
        (const __nv_bfloat16*)w_hh, (const float*)b,
        (const __nv_bfloat16*)fc2_w, (const float*)fc2_b,
        (const float*)table, (int*)tokens, steps, E, H, V, hp, ks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
