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
// The cell. At full width (E = 300, H = 512) one step is a [B, E + H] x
// [E + H, 4H] product (0.2 GFLOP at B = 64) and 3.3 MB of bf16 weights
// (6.5 MB in fp32): at the card's rates about a microsecond either way, so
// what bounds it is how often the weights and the activations are read and
// how long the chain load -> product -> epilogue takes. The design:
//   * one block per group of U hidden units, owning all four gate columns
//     of them, so that the epilogue stays in the block: U = 8 in bf16 (64
//     blocks at H = 512), U = 4 in fp32 (128 blocks). Every block reads all
//     of the batch's activations, so fewer blocks read fewer bytes; at
//     B = 64 in bf16 U = 4 took 10.3 us of device time, mostly the copies
//     of [x | h] from L2 into 128 blocks. In fp32 the 64-row product is
//     four times the work of a bf16 one and a 16-row tile is all that fits
//     beside 8 units' weights, so fp32 keeps 4;
//   * the block copies its [E + H, 4U] slice of [W_ih; W_hh] into shared
//     memory once (cp.async, one 16-byte piece per gate and k): the
//     weights are read once per call, not once per batch row;
//   * the batch is the M dimension. A batch tile of up to 64 rows of
//     [round_T(x) | round_T(h)] is staged in shared memory (x and h are
//     rounded to T on the way in, so that x may come in fp32 or in T and h
//     in fp32), k padded to the mma's depth; B larger than a tile loops over
//     tiles with the weight slice resident;
//   * bf16: ldmatrix and mma.sync.m16n8k16 with fp32 sums; the 16 warps are
//     (m-tile, slice of k), with the k dimension split over more warps when
//     the tile has fewer rows. fp32: fmaf, warp = slice of k, lane = (row
//     group, gate). The partial sums are added in a fixed order: two runs
//     give the same bits;
//   * one thread per (row, unit) adds the bias, applies the gates and writes
//     h' and c' to one [2, B, H] fp32 output. One launch, no scratch, no
//     atomics.
// Each block reads all of the batch's activations (B (E + H) values of x
// and h): at B = 64 that, not the weights, is most of the bytes.
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
#include <type_traits>

#include "fragments.cuh"
#include "lstm_common.cuh"
#include "lstm_seq.cuh"

namespace lctvqa {
namespace seq {

__global__ void __launch_bounds__(kThreads, 1)
    grid_barrier_probe_kernel(unsigned* ctr, int barriers) {
  unsigned target = 0;
  for (int t = 0; t < barriers; ++t) {
    target += gridDim.x;
    grid_arrive(ctr);
    grid_wait(ctr, target);
  }
}

// ---------------------------------------------------------------------------
// the input product: xw[m, n] = sum_k x[m, k] w_ih[k, n] + b[n]
// ---------------------------------------------------------------------------

constexpr int kGemmRows = 128;    // rows of xw per block
constexpr int kGemmCols = 64;     // columns of xw per block
constexpr int kGemmThreads = 256;

// Warp w owns rows [16w, 16w + 16) of the tile and all 64 columns (eight
// mma n-tiles). Slabs of 32 k: x as [m][k], w_ih as it lies, [k][n], read
// through ldmatrix.trans; the next slab's global loads are in flight in
// registers while this one is multiplied.
__global__ void __launch_bounds__(kGemmThreads)
    xw_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w_ih,
                        const float* __restrict__ b, float* __restrict__ xw,
                        int M, int E, int N, int vec_x, int vec_w) {
  constexpr int BK = 32, SA = BK + 8, SB = kGemmCols + 8;
  __shared__ __align__(16) __nv_bfloat16 a_s[kGemmRows * SA];
  __shared__ __align__(16) __nv_bfloat16 b_s[BK * SB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.x * kGemmRows, n0 = blockIdx.y * kGemmCols;
  uint2 ra[4], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + kGemmThreads * i, m = m0 + (c >> 3);
      const int k = k0 + (c & 7) * 4;
      ra[i] = load4(x + (size_t)m * E + k, m < M ? E - k : 0, vec_x);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + kGemmThreads * i, k = k0 + (c >> 4);
      const int n = n0 + (c & 15) * 4;
      rb[i] = load4(w_ih + (size_t)k * N + n, k < E ? N - n : 0, vec_w);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + kGemmThreads * i;
      *reinterpret_cast<uint2*>(a_s + (c >> 3) * SA + (c & 7) * 4) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + kGemmThreads * i;
      *reinterpret_cast<uint2*>(b_s + (c >> 4) * SB + (c & 15) * 4) = rb[i];
    }
  };
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  fetch(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < E; k0 += BK) {
    const bool more = k0 + BK < E;
    if (more) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const __nv_bfloat16* ap = a_s + (warp * 16 + g) * SA + kk + 2 * q;
      const uint32_t a0 = ld_pair(ap), a1 = ld_pair(ap + 8 * SA);
      const uint32_t a2 = ld_pair(ap + 8), a3 = ld_pair(ap + 8 * SA + 8);
      const __nv_bfloat16* bp =
          b_s + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * SB +
          (lane >> 4) * 8;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bp + np * 16);
        mma_bf16(acc[2 * np], a0, a1, a2, a3, r[0], r[1]);
        mma_bf16(acc[2 * np + 1], a0, a1, a2, a3, r[2], r[3]);
      }
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = n0 + nt * 8 + 2 * q;  // even, and N is even
    if (n >= N) continue;
    const float b0 = b[n], b1 = b[n + 1];
    const int m = m0 + warp * 16 + g;
    if (m < M)
      *reinterpret_cast<float2*>(xw + (size_t)m * N + n) =
          make_float2(acc[nt][0] + b0, acc[nt][1] + b1);
    if (m + 8 < M)
      *reinterpret_cast<float2*>(xw + (size_t)(m + 8) * N + n) =
          make_float2(acc[nt][2] + b0, acc[nt][3] + b1);
  }
}

// An 8 x 4 patch of the tile per thread, fmaf in a fixed order of k; slabs
// of 16 k, x transposed to [k][m] on the way in, the next slab in flight in
// registers as above.
__global__ void __launch_bounds__(kGemmThreads)
    xw_gemm_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w_ih,
                       const float* __restrict__ b, float* __restrict__ xw,
                       int M, int E, int N, int vec_x, int vec_w) {
  constexpr int BK = 16, SA = kGemmRows + 4;
  __shared__ __align__(16) float a_s[BK * SA];         // [k][m]
  __shared__ __align__(16) float b_s[BK * kGemmCols];  // [k][n]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * kGemmRows, n0 = blockIdx.y * kGemmCols;
  float4 ra[2], rb;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + kGemmThreads * i, m = m0 + (c >> 2);
      const int k = k0 + (c & 3) * 4;
      ra[i] = load4(x + (size_t)m * E + k, m < M ? E - k : 0, vec_x);
    }
    const int k = k0 + (tid >> 4), n = n0 + (tid & 15) * 4;
    rb = load4(w_ih + (size_t)k * N + n, k < E ? N - n : 0, vec_w);
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + kGemmThreads * i;
      float* p = a_s + (c & 3) * 4 * SA + (c >> 2);
      p[0] = ra[i].x, p[SA] = ra[i].y, p[2 * SA] = ra[i].z;
      p[3 * SA] = ra[i].w;
    }
    *reinterpret_cast<float4*>(b_s + (tid >> 4) * kGemmCols +
                               (tid & 15) * 4) = rb;
  };
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  fetch(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < E; k0 += BK) {
    const bool more = k0 + BK < E;
    if (more) fetch(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 lo =
          *reinterpret_cast<const float4*>(a_s + k * SA + 8 * ty);
      const float4 hi =
          *reinterpret_cast<const float4*>(a_s + k * SA + 8 * ty + 4);
      const float4 w =
          *reinterpret_cast<const float4*>(b_s + k * kGemmCols + 4 * tx);
      const float av[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = fmaf(av[i], w.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], w.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], w.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], w.w, acc[i][3]);
      }
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }
  const int n = n0 + 4 * tx;  // N is a multiple of 4
  if (n >= N) return;
  const float bv[4] = {b[n], b[n + 1], b[n + 2], b[n + 3]};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 8 * ty + i;
    if (m >= M) break;
    *reinterpret_cast<float4*>(xw + (size_t)m * N + n) =
        make_float4(acc[i][0] + bv[0], acc[i][1] + bv[1], acc[i][2] + bv[2],
                    acc[i][3] + bv[3]);
  }
}

}  // namespace seq

namespace {

// ---------------------------------------------------------------------------
// the cell
// ---------------------------------------------------------------------------

namespace cell {

constexpr int kThreads = 512;  // 16 warps, one block per SM
constexpr int kWarps = kThreads / 32;

// A block owns U hidden units, all four gates of them: 8 in bf16, 4 in fp32
// (one 16-byte piece of each gate's weight row either way). COLS = 4 U.
// Shared memory of a block, in this order (every part on 16 bytes):
//   p_s  fp32 partial gate sums: bf16 [16 warps][16 rows][COLS], fp32
//        [16 slices][tile][4 gates][U]
//   w_s  [KP][WS] of T: row k = input row k of [W_ih; 0; W_hh; 0], column
//        gate * U + unit. WS = COLS + 8 in bf16 puts the 8 rows of an
//        ldmatrix on 8 different 16-byte bank groups.
//   a_s  [tile][SA] of T: [round_T(x) | 0 | round_T(h) | 0] of the tile's
//        rows. SA = KP + 16 bytes' worth, for ldmatrix / float4 loads that
//        meet on no bank.
// x takes columns [0, E), h [EP, EP + H), EP = E rounded up to 16; KP =
// EP + H rounded up to 16 (bf16: the mma depth) or 64 (fp32: 16 slices of
// whole float4 steps).
template <typename T>
struct Cfg {
  static constexpr bool kMma = sizeof(T) == 2;
  static constexpr int U = kMma ? 8 : 4;
  static constexpr int COLS = 4 * U;
  static constexpr int WS = kMma ? COLS + 8 : COLS;
  static constexpr int PAD = 16 / (int)sizeof(T);
  static constexpr int KQ = kMma ? 16 : 64;
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

template <typename T>
__host__ __device__ inline int k_pad(int E, int H) {
  return round_up(round_up(E, 16) + H, Cfg<T>::KQ);
}

template <typename T>
__host__ __device__ inline int partial_floats(int tile) {
  using C = Cfg<T>;
  return C::kMma ? kWarps * 16 * C::COLS : kWarps * tile * C::COLS;
}

template <typename T>
inline size_t smem_bytes(int E, int H, int tile) {
  using C = Cfg<T>;
  const size_t KP = k_pad<T>(E, H);
  return (size_t)partial_floats<T>(tile) * sizeof(float) +
         (KP * C::WS + (size_t)tile * (KP + C::PAD)) * sizeof(T);
}

template <typename T>
__device__ __forceinline__ void cp_async_row4(T* dst, const T* src) {
  if constexpr (sizeof(T) == 2)
    cp_async8(dst, src);
  else
    cp_async16(dst, src);
}

using bf16 = __nv_bfloat16;

// rows [b0, b0 + rows) of a row-major [., n] array (row stride ld) of X
// into columns [col, col + n) of a_s, rounded to T. vec: n, ld and the
// base are aligned for four elements at a time.
template <typename T, typename X>
__device__ __forceinline__ void stage_rows(const X* __restrict__ src,
                                           long long ld, T* a_s, int SA,
                                           int col, int b0, int rows, int n,
                                           bool vec) {
  if (vec) {
    const int quads = n / 4, total = rows * quads;
    if constexpr (std::is_same<X, T>::value) {
      for (int idx = threadIdx.x; idx < total; idx += kThreads) {
        const int r = idx / quads, k = (idx - r * quads) * 4;
        cp_async_row4(a_s + r * SA + col + k,
                      src + (long long)(b0 + r) * ld + k);
      }
    } else {
      for (int idx = threadIdx.x; idx < total; idx += kThreads) {
        const int r = idx / quads, k = (idx - r * quads) * 4;
        st4(a_s + r * SA + col + k,
            ld4f(src + (long long)(b0 + r) * ld + k));
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * n; idx += kThreads) {
    const int r = idx / n, k = idx - r * n;
    a_s[r * SA + col + k] =
        from_f32<T>(to_f32(src[(long long)(b0 + r) * ld + k]));
  }
}

// p_s[warp] = the warp's [16, COLS] product over its slice of k. Warps
// are (m-tile mt, slice ks) with as many slices as the tile's live m-tiles
// leave: 16 for one m-tile, 8 for two, 4 for three or four.
__device__ __forceinline__ int mma_tiles(int rows) {
  const int mt = (rows + 15) / 16;
  return mt == 1 ? 1 : (mt == 2 ? 2 : 4);
}

__device__ __forceinline__ void mma_product(const bf16* a_s, const bf16* w_s,
                                            float* p_s, int rows, int KP,
                                            int SA) {
  constexpr int WS = Cfg<bf16>::WS, COLS = Cfg<bf16>::COLS;
  constexpr int NT = COLS / 8;  // mma n-tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int mtp = mma_tiles(rows), slices = kWarps / mtp;
  const int mt = warp % mtp, ks = warp / mtp;
  if (mt * 16 >= rows) return;
  const int steps = KP / 16;
  const int s0 = ks * steps / slices, s1 = (ks + 1) * steps / slices;
  // A as [m][k] (ldmatrix); B as [k][n] (ldmatrix.trans): per 16 columns,
  // matrices k 0-7 | 8-15 of columns 0-7, then of 8-15 -> two n-tiles
  const bf16* ap = a_s + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SA +
                   (lane >> 4) * 8;
  const bf16* bp =
      w_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * WS + (lane >> 4) * 8;
  // two sets of sums, for even and odd k-steps: shorter dependent chains
  float acc[2][NT][4] = {};
  auto step = [&](int half, int k) {
    uint32_t a[4];
    ldmatrix_x4(a, ap + k * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, bp + k * 16 * WS + np * 16);
      mma_bf16(acc[half][2 * np], a[0], a[1], a[2], a[3], b[0], b[1]);
      mma_bf16(acc[half][2 * np + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
    }
  };
  int s = s0;
  for (; s + 1 < s1; s += 2) {
    step(0, s);
    step(1, s + 1);
  }
  if (s < s1) step(0, s);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float* p = p_s + (warp * 16 + g) * COLS + nt * 8 + 2 * q;
    *reinterpret_cast<float2*>(p) =
        make_float2(acc[0][nt][0] + acc[1][nt][0],
                    acc[0][nt][1] + acc[1][nt][1]);
    *reinterpret_cast<float2*>(p + 8 * COLS) =
        make_float2(acc[0][nt][2] + acc[1][nt][2],
                    acc[0][nt][3] + acc[1][nt][3]);
  }
}

// fp32: warp = slice ks of k (KP / 16 values), lane = (row group rg,
// gate); rows rg + 8 i, i < R, of the tile, all four units.
template <int R>
__device__ __forceinline__ void fma_product(const float* a_s,
                                            const float* w_s, float* p_s,
                                            int rows, int KP, int SA,
                                            int tile) {
  constexpr int U = Cfg<float>::U, COLS = Cfg<float>::COLS;
  static_assert(U == 4, "a float4 of units per gate");
  const int ks = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gate = lane & 3, rg = lane >> 2;
  if (rg >= rows) return;
  float acc[R][U] = {};
  const int span = KP / kWarps, kb = ks * span;
  for (int k = kb; k < kb + span; k += 4) {
    float av[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          a_s + (i * 8 + rg) * SA + k);
      av[i][0] = v.x, av[i][1] = v.y, av[i][2] = v.z, av[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(
          w_s + (k + kk) * COLS + gate * U);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i][0] = fmaf(av[i][kk], w.x, acc[i][0]);
        acc[i][1] = fmaf(av[i][kk], w.y, acc[i][1]);
        acc[i][2] = fmaf(av[i][kk], w.z, acc[i][2]);
        acc[i][3] = fmaf(av[i][kk], w.w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    *reinterpret_cast<float4*>(
        p_s + ((ks * tile + i * 8 + rg) * 4 + gate) * U) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// The sum over the slices, in their order, of gate `gate` of (row, unit).
template <typename T>
__device__ __forceinline__ float gate_sum(const float* p_s, int rows,
                                          int tile, int row, int unit,
                                          int gate) {
  using C = Cfg<T>;
  float v = 0.f;
  if constexpr (C::kMma) {
    const int mtp = mma_tiles(rows), slices = kWarps / mtp;
    const int mt = row / 16, r = row % 16;
    for (int ks = 0; ks < slices; ++ks)
      v += p_s[((ks * mtp + mt) * 16 + r) * C::COLS + gate * C::U + unit];
  } else {
    for (int ks = 0; ks < kWarps; ++ks)
      v += p_s[((ks * tile + row) * 4 + gate) * C::U + unit];
  }
  return v;
}

// Block j: units [U j, U j + U). x [B, E] of X with row stride x_ld; h, c
// [B, H] fp32; out [2, B, H] fp32 (h', then c'). R: rows of a thread in
// fp32 (tile = 8 R); unused in bf16. vec_*: the four-element loads of the
// weights, x and h are aligned.
template <typename T, typename X, int R>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_cell_kernel(const X* __restrict__ x, long long x_ld,
                     const float* __restrict__ h, const float* __restrict__ c,
                     const T* __restrict__ w_ih, const T* __restrict__ w_hh,
                     const float* __restrict__ b, float* __restrict__ out,
                     int B, int E, int H, int tile, int vec_w, int vec_x,
                     int vec_h) {
  using C = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int EP = round_up(E, 16), KP = k_pad<T>(E, H), SA = KP + C::PAD;
  float* p_s = reinterpret_cast<float*>(smem_raw);
  T* w_s = reinterpret_cast<T*>(p_s + partial_floats<T>(tile));
  T* a_s = w_s + (size_t)KP * C::WS;
  const int tid = threadIdx.x, j0 = blockIdx.x * C::U;
  const size_t G = 4 * (size_t)H;

  // the weight slice, once for the whole call
  for (int idx = tid; idx < KP * 4; idx += kThreads) {
    const int k = idx >> 2, gate = idx & 3;
    const T* src = k < E                         ? w_ih + k * G
                   : (k >= EP && k < EP + H) ? w_hh + (k - EP) * G
                                                 : nullptr;
    T* dst = w_s + k * C::WS + gate * C::U;
    if (src != nullptr && vec_w) {
      cp_async16(dst, src + gate * H + j0);  // U units of T: 16 bytes
    } else {
#pragma unroll
      for (int u = 0; u < C::U; ++u)
        dst[u] = (src != nullptr && j0 + u < H) ? src[gate * H + j0 + u]
                                                : from_f32<T>(0.f);
    }
  }
  // the padding columns of a_s; the loads never write them
  const int pads = (EP - E) + (KP - EP - H);
  for (int idx = tid; idx < tile * pads; idx += kThreads) {
    const int r = idx / pads, p = idx - r * pads;
    a_s[r * SA + (p < EP - E ? E + p : EP + H + p - (EP - E))] =
        from_f32<T>(0.f);
  }

  // the (row, unit) of a tile that this thread finishes
  const int er = tid / C::U, eu = tid % C::U, ej = j0 + eu;
  float bias[4];
#pragma unroll
  for (int gate = 0; gate < 4; ++gate)
    bias[gate] = ej < H ? b[gate * H + ej] : 0.f;
  for (int b0 = 0; b0 < B; b0 += tile) {
    const int rows = B - b0 < tile ? B - b0 : tile;
    const bool live = er < rows && ej < H;
    const float c_prev = live ? c[(size_t)(b0 + er) * H + ej] : 0.f;
    stage_rows<T, X>(x, x_ld, a_s, SA, 0, b0, rows, E, vec_x);
    stage_rows<T, float>(h, (long long)H, a_s, SA, EP, b0, rows, H, vec_h);
    cp_async_wait_all();
    __syncthreads();
    if constexpr (C::kMma)
      mma_product(a_s, w_s, p_s, rows, KP, SA);
    else
      fma_product<R>(a_s, w_s, p_s, rows, KP, SA, tile);
    __syncthreads();
    if (live) {
      const float gi =
          sigmoid(gate_sum<T>(p_s, rows, tile, er, eu, 0) + bias[0]);
      const float gf =
          sigmoid(gate_sum<T>(p_s, rows, tile, er, eu, 1) + bias[1]);
      const float gg = tanhf(gate_sum<T>(p_s, rows, tile, er, eu, 2) + bias[2]);
      const float go =
          sigmoid(gate_sum<T>(p_s, rows, tile, er, eu, 3) + bias[3]);
      const float cn = gf * c_prev + gi * gg;
      const size_t at = (size_t)(b0 + er) * H + ej;
      out[at] = go * tanhf(cn);
      out[(size_t)B * H + at] = cn;
    }
  }
}

}  // namespace cell

// The cell's launch shape: ceil(H / U) blocks of 512 threads; the largest
// batch tile (bf16 64, 32, 16 rows; fp32 32, 16) whose shared memory fits
// the device's block limit.
struct CellPlan {
  int blocks, tile, smem;
};

template <typename T>
cudaError_t cell_plan(int E, int H, CellPlan* plan) {
  int smem_max = 0;
  cudaError_t err = smem_optin(&smem_max);
  if (err != cudaSuccess) return err;
  const int tiles[3] = {64, 32, 16};
  for (int i = sizeof(T) == 2 ? 0 : 1; i < 3; ++i) {
    const int tile = tiles[i];
    const size_t smem = cell::smem_bytes<T>(E, H, tile);
    if (smem <= (size_t)smem_max) {
      constexpr int U = cell::Cfg<T>::U;
      *plan = {(H + U - 1) / U, tile, (int)smem};
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

inline bool aligned(const void* p, size_t bytes) {
  return (uintptr_t)p % bytes == 0;
}

template <typename T, typename X>
cudaError_t launch_cell(const X* x, long long x_ld, const float* h,
                        const float* c, const T* w_ih, const T* w_hh,
                        const float* b, float* out, int B, int E, int H,
                        cudaStream_t s) {
  CellPlan plan;
  cudaError_t err = cell_plan<T>(E, H, &plan);
  if (err != cudaSuccess) return err;
  using Fn = void (*)(const X*, long long, const float*, const float*,
                     const T*, const T*, const float*, float*, int, int, int,
                     int, int, int, int);
  Fn fn;
  if constexpr (sizeof(T) == 2)
    fn = cell::lstm_cell_kernel<T, X, 0>;
  else
    fn = plan.tile == 32 ? cell::lstm_cell_kernel<T, X, 4>
                         : cell::lstm_cell_kernel<T, X, 2>;
  err = allow_dynamic_smem((const void*)fn, plan.smem);
  if (err != cudaSuccess) return err;
  const int vec_w = H % cell::Cfg<T>::U == 0 && aligned(w_ih, 16) &&
                    aligned(w_hh, 16);
  const int vec_x = E % 4 == 0 && x_ld % 4 == 0 && aligned(x, 4 * sizeof(X));
  const int vec_h = H % 4 == 0 && aligned(h, 16);
  fn<<<plan.blocks, cell::kThreads, plan.smem, s>>>(
      x, x_ld, h, c, w_ih, w_hh, b, out, B, E, H, plan.tile, vec_w, vec_x,
      vec_h);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cell_x(const void* x, long long x_ld, int x_dtype,
                          const float* h, const float* c, const T* w_ih,
                          const T* w_hh, const float* b, float* out, int B,
                          int E, int H, cudaStream_t s) {
  if (x_dtype == kFloat32)
    return launch_cell<T, float>((const float*)x, x_ld, h, c, w_ih, w_hh, b,
                                 out, B, E, H, s);
  if (x_dtype == kBFloat16)
    return launch_cell<T, __nv_bfloat16>((const __nv_bfloat16*)x, x_ld, h, c,
                                         w_ih, w_hh, b, out, B, E, H, s);
  return cudaErrorInvalidValue;
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

// x: [B, E] with row stride x_ld (elements), unit column stride, fp32 or
// bf16 (`x_dtype`; rounded to `dtype` in the kernel). h, c: [B, H] fp32
// contiguous. w_ih: [E, 4H], w_hh: [H, 4H] in `dtype`, contiguous. b: [4H]
// fp32 (b_ih + b_hh). out: [2, B, H] fp32, h' then c'. B >= 1.
int lctvqa_lstm_cell(const void* x, long long x_ld, int x_dtype,
                     const void* h, const void* c, const void* w_ih,
                     const void* w_hh, const void* b, void* out, int B,
                     int E, int H, int dtype, void* stream) {
  using namespace lctvqa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)launch_cell_x<float>(
        x, x_ld, x_dtype, (const float*)h, (const float*)c,
        (const float*)w_ih, (const float*)w_hh, (const float*)b, (float*)out,
        B, E, H, s);
  if (dtype == kBFloat16)
    return (int)launch_cell_x<__nv_bfloat16>(
        x, x_ld, x_dtype, (const float*)h, (const float*)c,
        (const __nv_bfloat16*)w_ih, (const __nv_bfloat16*)w_hh,
        (const float*)b, (float*)out, B, E, H, s);
  return (int)cudaErrorInvalidValue;
}

// The launch shape lctvqa_lstm_cell takes at (E, H) on the current device:
// plan[0..3] = hidden units per block, blocks, rows of a batch tile,
// shared-memory bytes per block; every block has 512 threads.
int lctvqa_lstm_cell_plan(int E, int H, int dtype, int* plan) {
  using namespace lctvqa;
  CellPlan p;
  cudaError_t err = dtype == kFloat32    ? cell_plan<float>(E, H, &p)
                    : dtype == kBFloat16 ? cell_plan<__nv_bfloat16>(E, H, &p)
                                         : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  plan[0] = dtype == kFloat32 ? cell::Cfg<float>::U
                              : cell::Cfg<__nv_bfloat16>::U;
  plan[1] = p.blocks, plan[2] = p.tile;
  plan[3] = p.smem;
  return 0;
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
