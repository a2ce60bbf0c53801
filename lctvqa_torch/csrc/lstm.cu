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
// The cell. What bounds it on an H100: weight reads. At full width W_ih
// [300, 2048] and W_hh [512, 2048] are 3.2 MB in bf16 (6.5 MB in fp32) and
// each batch row reads all of them, against 3.2 MFLOP of work per row; the
// weights stay in the 50 MB L2, so the bound is L2 bandwidth. Each (batch
// row, hidden unit) has four threads, which split the gate dots' input
// rows between them (block_gates); one of them adds the parts and updates
// the state in registers.
//
// The whole sequence. The operations are few (6.4 GFLOP at B = 64, T = 30:
// microseconds on the tensor cores); what bounds it is the chain of T
// dependent steps, each of which needs all of h_{t-1}, and how often the
// weights are read. The TPU kernels run the time loop as a sequential grid
// with the state in VMEM scratch; blocks on Hopper run in no order, so
// (device code in lstm_seq.cuh):
//   * the input product x_t W_ih + b does not depend on the recurrence: one
//     tiled product over all B T rows at once (mma.sync m16n8k16 for bf16,
//     fmaf for fp32) writes it to an fp32 scratch [B, T, 4H];
//   * one persistent kernel runs all T steps. Block j owns U hidden units,
//     all four gates of them, and keeps its [H, 4U] slice of W_hh in shared
//     memory for the whole call: the weights are read from device memory
//     once per call. U = 8 in bf16; in fp32 U = 4 with a 64-row batch tile
//     when H / 4 blocks fit on the card's SMs and the tile in shared
//     memory, else U = 8 with a 16-row tile;
//   * per step a block multiplies round_T(h_{t-1}) [batch tile, H] by its
//     slice, the batch as the M dimension: bf16 on the tensor cores
//     (ldmatrix and mma.sync, fp32 sums), fp32 with fmaf, k split over the
//     warps and the partial sums added in a fixed order. Then + xw, the gates, c
//     (kept in the c_n output between steps) and h_t, which goes as fp32 to
//     out / h_n and as T to a double-buffered exchange buffer [2, B, H] in
//     device memory (it stays in L2);
//   * one grid barrier per step on a counter that only grows (red.release
//     after a fence, one thread per block spinning on ld.acquire). It needs
//     every block resident at once, so the launch is cooperative and a grid
//     that does not fit is refused, never hung. Counter and exchange buffer
//     are the caller's scratch, zeroed for each call, so calls on several
//     streams share nothing;
//   * B larger than a batch tile loops
//     over tiles inside a step with the weights resident; rows and columns
//     past B and H are zero padding in shared memory. Sums are in a fixed
//     order and the only atomic is the barrier's: two runs give the same
//     bits.
#include "lstm_common.cuh"
#include "lstm_seq.cuh"

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

// The recurrent kernel's launch shape at hidden size H.
struct SeqPlan {
  int units;   // hidden units per block
  int rows;    // batch rows a thread multiplies (fp32)
  int blocks;  // the grid: one block per SM at most
  int smem;    // dynamic shared memory per block, bytes
};

template <typename T, int U, int R>
cudaError_t try_seq_plan(int H, int sms, int smem_max, SeqPlan* plan) {
  const size_t smem = seq::smem_bytes<T, U, R>(H);
  const int blocks = (H + U - 1) / U;
  if (smem > (size_t)smem_max || blocks > sms)
    return cudaErrorCooperativeLaunchTooLarge;
  cudaError_t err = cudaFuncSetAttribute(
      seq::lstm_seq_kernel<T, U, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, seq::lstm_seq_kernel<T, U, R>, seq::kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *plan = {U, R, blocks, (int)smem};
  return cudaSuccess;
}

// The fewest units per block whose grid is resident at once on the current
// device and whose batch tile fits in shared memory; an error where no
// shape does.
template <typename T>
cudaError_t seq_plan(int H, SeqPlan* plan) {
  int dev = 0, sms = 0, smem_max = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  if constexpr (sizeof(T) == 4) {
    if (try_seq_plan<T, 4, 8>(H, sms, smem_max, plan) == cudaSuccess)
      return cudaSuccess;
  }
  return try_seq_plan<T, 8, 4>(H, sms, smem_max, plan);
}

template <typename T>
cudaError_t launch_seq(const T* xs, const float* h0, const float* c0,
                       const T* w_ih, const T* w_hh, const float* b,
                       float* out, float* h_n, float* c_n, float* xw,
                       unsigned char* scratch, int B, int steps, int E, int H,
                       cudaStream_t s) {
  SeqPlan plan;
  cudaError_t err = seq_plan<T>(H, &plan);
  if (err != cudaSuccess) return err;
  const int M = B * steps, N = 4 * H;
  dim3 tiles((M + seq::kGemmRows - 1) / seq::kGemmRows,
             (N + seq::kGemmCols - 1) / seq::kGemmCols);
  // four elements in one load where rows start aligned for it
  const size_t quad = 4 * sizeof(T);
  const int vec_x = E % 4 == 0 && (uintptr_t)xs % quad == 0;
  const int vec_w = (uintptr_t)w_ih % quad == 0;  // N is a multiple of 4
  if constexpr (sizeof(T) == 2)
    seq::xw_gemm_bf16_kernel<<<tiles, seq::kGemmThreads, 0, s>>>(
        xs, w_ih, b, xw, M, E, N, vec_x, vec_w);
  else
    seq::xw_gemm_f32_kernel<<<tiles, seq::kGemmThreads, 0, s>>>(
        xs, w_ih, b, xw, M, E, N, vec_x, vec_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  unsigned* ctr = reinterpret_cast<unsigned*>(scratch);
  T* exch = reinterpret_cast<T*>(scratch + seq::kSyncBytes);
  const float* xw_in = xw;
  void* args[] = {&xw_in, &h0, &c0, &w_hh, &out, &h_n,
                  &c_n,   &ctr, &exch, &B,  &steps, &H};
  void* fn = (void*)seq::lstm_seq_kernel<T, 8, 4>;
  if constexpr (sizeof(T) == 4) {
    if (plan.units == 4) fn = (void*)seq::lstm_seq_kernel<T, 4, 8>;
  }
  return cudaLaunchCooperativeKernel(fn, dim3(plan.blocks),
                                     dim3(seq::kThreads), args,
                                     (size_t)plan.smem, s);
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
// or [B, steps, H] fp32. Scratch of the caller: xw [B, steps, 4H] fp32,
// uninitialised; scratch, 256 + 2 * B * HX * sizeof(dtype) bytes of zeros,
// HX = H rounded up to 8 (the barrier's counter, then the exchange buffer).
// steps >= 1, H <= 1024. Returns cudaErrorCooperativeLaunchTooLarge where
// the grid cannot be resident at once on this device.
int lctvqa_lstm_seq(const void* xs, const void* h0, const void* c0,
                    const void* w_ih, const void* w_hh, const void* b,
                    void* out, void* h_n, void* c_n, void* xw, void* scratch,
                    int B, int steps, int E, int H, int dtype, void* stream) {
  using namespace lctvqa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)launch_seq<float>(
        (const float*)xs, (const float*)h0, (const float*)c0,
        (const float*)w_ih, (const float*)w_hh, (const float*)b, (float*)out,
        (float*)h_n, (float*)c_n, (float*)xw, (unsigned char*)scratch, B,
        steps, E, H, s);
  if (dtype == kBFloat16)
    return (int)launch_seq<__nv_bfloat16>(
        (const __nv_bfloat16*)xs, (const float*)h0, (const float*)c0,
        (const __nv_bfloat16*)w_ih, (const __nv_bfloat16*)w_hh,
        (const float*)b, (float*)out, (float*)h_n, (float*)c_n, (float*)xw,
        (unsigned char*)scratch, B, steps, E, H, s);
  return (int)cudaErrorInvalidValue;
}

// The launch shape lctvqa_lstm_seq takes at hidden size H on the current
// device: plan[0..3] = hidden units per block, rows of a batch tile,
// blocks, shared-memory bytes per block; every block has 512 threads.
int lctvqa_lstm_seq_plan(int H, int dtype, int* plan) {
  using namespace lctvqa;
  SeqPlan p;
  cudaError_t err = dtype == kFloat32    ? seq_plan<float>(H, &p)
                    : dtype == kBFloat16 ? seq_plan<__nv_bfloat16>(H, &p)
                                         : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.units;
  plan[1] = dtype == kBFloat16 ? 64 : p.rows * 32 / p.units;
  plan[2] = p.blocks, plan[3] = p.smem;
  return 0;
}

// `barriers` grid barriers of `blocks` blocks of 512 threads and nothing
// else: the floor of a recurrence's step chain. counter: 4 bytes of zeros.
int lctvqa_grid_barrier_probe(void* counter, int blocks, int barriers,
                              void* stream) {
  using namespace lctvqa;
  unsigned* ctr = static_cast<unsigned*>(counter);
  void* args[] = {&ctr, &barriers};
  return (int)cudaLaunchCooperativeKernel(
      (void*)seq::grid_barrier_probe_kernel, dim3(blocks),
      dim3(seq::kThreads), args, 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
