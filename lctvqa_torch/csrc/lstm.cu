// LSTM kernels for Hopper (sm_90a), bound to Python with ctypes
// (lctvqa_torch/ops/cuda_lstm.py). They replace the Pallas TPU kernels of
// lctvqa/ops/pallas_lstm.py:
//
//   lctvqa_lstm_cell      <- _forward (_cell_kernel), pallas_lstm.py:42
//   lctvqa_lstm_seq       <- _seq_forward (_seq_kernel), pallas_lstm.py:172,
//                            when `out` is null (final state only), and
//                            _seq_all_forward (_seq_all_kernel),
//                            pallas_lstm.py:311, when `out` is given
//
// What bounds them on an H100: weight reads. At full width W_ih [300, 2048]
// and W_hh [512, 2048] are 3.2 MB in bf16 (6.5 MB in fp32) and each batch
// row reads all of them once per step, against 3.2 MFLOP of work per row
// and step. The weights stay in the 50 MB L2, so the bound is L2
// bandwidth, not device memory. B <= 64 rows is too thin a product for
// the tensor cores to pay off in this first version; tiles of several rows
// per block, wgmma and multi-block persistent recurrences are later work.
//
// Design. The TPU kernels run the time loop as a sequential grid with the
// state in VMEM scratch. Blocks on Hopper run in no order, so here:
//   * the cell gives each (batch row, hidden unit) four threads, which
//     split the gate dots' input rows between them (block_gates); one of
//     them adds the parts and updates the state in registers;
//   * a whole recurrence is one block per batch row that loops over t
//     inside the block: x_t and h live in shared memory, c in shared
//     memory owned by one thread per unit, with __syncthreads between
//     the steps. At H = 512 the block has 1024 threads, two per unit.
#include "lstm_common.cuh"

namespace lctvqa {
namespace {

constexpr int kCellUnits = 128;  // hidden units per block of the cell
constexpr int kCellSlices = 4;   // row slices per unit (block_gates)

// Block (blockIdx.x, blockIdx.y) computes units [128 x, 128 x + 128) of
// batch row y, with kCellSlices threads per unit.
template <typename T>
__global__ void lstm_cell_kernel(const T* __restrict__ x,
                                 const float* __restrict__ h,
                                 const float* __restrict__ c,
                                 const T* __restrict__ w_ih,
                                 const T* __restrict__ w_hh,
                                 const float* __restrict__ b,
                                 float* __restrict__ h_out,
                                 float* __restrict__ c_out, int E, int H) {
  extern __shared__ float smem[];
  float* x_s = smem;                  // [E]
  float* hq_s = x_s + E;              // [H], h rounded to T
  float* part_s = hq_s + H;           // [(ks - 1) * 4 * 128]
  const int row = blockIdx.y;
  for (int k = threadIdx.x; k < E; k += blockDim.x)
    x_s[k] = to_f32(x[(size_t)row * E + k]);
  for (int k = threadIdx.x; k < H; k += blockDim.x)
    hq_s[k] = round_to<T>(h[(size_t)row * H + k]);
  __syncthreads();
  const int j = blockIdx.x * kCellUnits + threadIdx.x % kCellUnits;
  float acc[4];
  if (!block_gates<T>(x_s, hq_s, w_ih, w_hh, E, H,
                      blockIdx.x * kCellUnits, kCellUnits, kCellSlices,
                      part_s, acc))
    return;
  float hn, cn;
  cell_finish(acc, b, H, j, c[(size_t)row * H + j], &hn, &cn);
  h_out[(size_t)row * H + j] = hn;
  c_out[(size_t)row * H + j] = cn;
}

// One block per batch row, ks slices of hp threads (row_layout). xs is
// [B, T, E] batch-major; out, when not null, is [B, T, H] fp32.
template <typename T>
__global__ void lstm_seq_kernel(const T* __restrict__ xs,
                                const float* __restrict__ h0,
                                const float* __restrict__ c0,
                                const T* __restrict__ w_ih,
                                const T* __restrict__ w_hh,
                                const float* __restrict__ b,
                                float* __restrict__ out,
                                float* __restrict__ h_n,
                                float* __restrict__ c_n, int steps, int E,
                                int H, int hp, int ks) {
  extern __shared__ float smem[];
  float* x_s = smem;       // [E]  x_t
  float* hq_s = x_s + E;   // [H]  h_{t-1} rounded to T
  float* hn_s = hq_s + H;  // [H]  h_t in fp32
  float* c_s = hn_s + H;   // [H]  c, each unit owned by one thread
  float* part_s = c_s + H; // [(ks - 1) * 4 * hp]
  const int row = blockIdx.x;
  const int j = threadIdx.x;  // the unit this thread finishes, if < H
  const T* x_row = xs + (size_t)row * steps * E;
  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    hq_s[k] = round_to<T>(h0[(size_t)row * H + k]);
    c_s[k] = c0[(size_t)row * H + k];
  }
  for (int k = threadIdx.x; k < E; k += blockDim.x) x_s[k] = to_f32(x_row[k]);
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    float acc[4];
    if (block_gates<T>(x_s, hq_s, w_ih, w_hh, E, H, 0, hp, ks, part_s,
                       acc)) {
      float hn, cn;
      cell_finish(acc, b, H, j, c_s[j], &hn, &cn);
      c_s[j] = cn;
      hn_s[j] = hn;
      if (out != nullptr) out[((size_t)row * steps + t) * H + j] = hn;
    }
    __syncthreads();  // every thread is done reading x_s, hq_s, part_s
    for (int k = threadIdx.x; k < H; k += blockDim.x)
      hq_s[k] = round_to<T>(hn_s[k]);
    if (t + 1 < steps)
      for (int k = threadIdx.x; k < E; k += blockDim.x)
        x_s[k] = to_f32(x_row[(size_t)(t + 1) * E + k]);
    __syncthreads();
  }
  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    h_n[(size_t)row * H + k] = hn_s[k];
    c_n[(size_t)row * H + k] = c_s[k];
  }
}

}  // namespace
}  // namespace lctvqa

extern "C" {

const char* lctvqa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// h, c, h_out, c_out: [B, H] fp32. x: [B, E] and w_ih: [E, 4H], w_hh:
// [H, 4H] in the dtype `dtype` names. b: [4H] fp32 (b_ih + b_hh).
int lctvqa_lstm_cell(const void* x, const void* h, const void* c,
                     const void* w_ih, const void* w_hh, const void* b,
                     void* h_out, void* c_out, int B, int E, int H,
                     int dtype, void* stream) {
  using namespace lctvqa;
  dim3 grid((H + kCellUnits - 1) / kCellUnits, B);
  const int threads = kCellUnits * kCellSlices;
  size_t shmem =
      (size_t)(E + H + (kCellSlices - 1) * 4 * kCellUnits) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    lstm_cell_kernel<float><<<grid, threads, shmem, s>>>(
        (const float*)x, (const float*)h, (const float*)c,
        (const float*)w_ih, (const float*)w_hh, (const float*)b,
        (float*)h_out, (float*)c_out, E, H);
  } else if (dtype == kBFloat16) {
    lstm_cell_kernel<__nv_bfloat16><<<grid, threads, shmem, s>>>(
        (const __nv_bfloat16*)x, (const float*)h, (const float*)c,
        (const __nv_bfloat16*)w_ih, (const __nv_bfloat16*)w_hh,
        (const float*)b, (float*)h_out, (float*)c_out, E, H);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// xs: [B, steps, E] in `dtype`; h0, c0, h_n, c_n: [B, H] fp32; out: null
// or [B, steps, H] fp32. steps >= 1, H <= 1024.
int lctvqa_lstm_seq(const void* xs, const void* h0, const void* c0,
                    const void* w_ih, const void* w_hh, const void* b,
                    void* out, void* h_n, void* c_n, int B, int steps, int E,
                    int H, int dtype, void* stream) {
  using namespace lctvqa;
  int hp, ks;
  row_layout(H, &hp, &ks);
  const int threads = hp * ks;
  size_t shmem = (size_t)(E + 3 * H + (ks - 1) * 4 * hp) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    lstm_seq_kernel<float><<<B, threads, shmem, s>>>(
        (const float*)xs, (const float*)h0, (const float*)c0,
        (const float*)w_ih, (const float*)w_hh, (const float*)b,
        (float*)out, (float*)h_n, (float*)c_n, steps, E, H, hp, ks);
  } else if (dtype == kBFloat16) {
    lstm_seq_kernel<__nv_bfloat16><<<B, threads, shmem, s>>>(
        (const __nv_bfloat16*)xs, (const float*)h0, (const float*)c0,
        (const __nv_bfloat16*)w_ih, (const __nv_bfloat16*)w_hh,
        (const float*)b, (float*)out, (float*)h_n, (float*)c_n, steps, E, H,
        hp, ks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
