// Node-batched PC-DARTS mixed op, forward and backward, for Hopper (sm_90a),
// bound to Python with ctypes (lctvqa_torch/ops/cuda_mixedop.py). Replaces
// the Pallas TPU kernels of lctvqa/ops/pallas_mixedop.py (_make_fwd_kernel,
// the pallas_call at pallas_mixedop.py:425, and _make_bwd_kernel, the one at
// :721):
//
//   lctvqa_mixed_node_fwd   out[n,h,w,c] = sum_e w[e,skip] * x_e
//                             + sum_e sum_op w[e,op] * BN_op(op(x_e))
//   lctvqa_mixed_node_bwd   the gradient of that w.r.t. every x_e, the packed
//                           depthwise taps and pointwise matrices of every
//                           edge, and w (see the second half of this file)
//
// for the E stride-1 edges of one cell node, on the first Cs channels of each
// edge's NHWC state: sep_conv 3x3/5x5 (relu, depthwise, pointwise, batch-stat
// BN, relu, depthwise, pointwise), dil_conv 3x3/5x5 (relu, dilation-2
// depthwise, pointwise), max and avg pool 3x3 (avg divides by the valid
// count), skip (raw x), none (0). Each op's final affine-free BN is folded in
// as coef = w * rsqrt(var + eps) and a bias sum coef * mean. Rounding
// points are the Pallas kernel's: inputs of a depthwise stage are values of
// the compute dtype T, the depthwise and pointwise sums are fp32 with fp32
// weights, every stage output `o` is rounded to T once, statistics and the
// fold are fp32 over the rounded `o`, the output is fp32.
//
// What bounds it on an H100: bytes and the chain of launches. The work is
// ~200 operations per input element outside the tensor cores against 2-4
// bytes read, but the batch statistics force every stage output through
// device memory: no block sees all of (N, H, W), and blocks run in no order.
// The TPU kernel is one sequential program over VMEM-resident slabs; here
// one C entry point issues a memset of 2E counters and three launches on one
// stream:
//   A. per (edge, image, tile): the x tile with a 4-pixel halo in shared
//      memory (four channels of a pixel in one load where aligned); the
//      first stage of the four conv branches and both pools from that one
//      tile, a thread computing one channel's depthwise taps (unrolled, the
//      taps in registers) at two pixels, then four output channels of a
//      pixel in the pointwise; writes six `o` planes and, once per block, the
//      per-block sums of o and o^2 of all six. The edge's last block to
//      finish, found by a counter, adds the per-block sums of the sep convs'
//      inner BN in a fixed order and writes mean and 1/sqrt(var + eps).
//   B. per (edge, sep branch, image, tile): inner BN, relu, rounding to T,
//      second depthwise and pointwise; writes `o` and its per-block sums. The
//      edge's last block finishes the six folded BNs' statistics the same
//      way.
//   Z. per (pixel, four channels): coef and bias from the statistics, the
//      weighted sum over ops and edges, minus the bias.
// The counters are the only atomics; no atomic touches a value, and every
// sum is taken in a fixed order, so a result does not change from run to
// run. Scratch `o` planes are channel-planar ([slot, edge, channel, N*H*W])
// so that neighbouring threads (neighbouring pixels) touch neighbouring
// addresses; the edge inputs are read through their strides, so a channel
// slice needs no copy. The planes and statistics are what the backward
// reads.
//
// Data-parallel mode (the *_sync entry points): each rank holds its share
// of the batch, and every batch statistic is the global batch's. Each
// launch is an entry point of its own, so that the caller can sum over the
// ranks between them: the edge's last block writes this rank's per-channel
// sums (in the same fixed order) to a small fp32 buffer instead of the
// statistics, the caller all-reduces that buffer, and the next entry point
// first turns the global sums into the statistics with the global count
// (one small launch), then runs its stage. Forward: A, sums of the inner
// BNs; B, sums of the six folded BNs; Z. Backward (below): R, sum g and
// sum g o; S, sums of dz and dz xhat; X. Each entry point zeroes its own
// counters. The parameter gradients stay this rank's share, taken with the
// global statistics, for the caller to sum with the other gradients.
#include <cmath>
#include <type_traits>

#include "fragments.cuh"
#include "lstm_common.cuh"

namespace lctvqa {
namespace {

constexpr int kMaxEdges = 8;
constexpr int kMaxCs = 64;
constexpr int kNodeThreads = 256;
constexpr int kTaps = 25;   // rows of a packed depthwise kernel (5 x 5)
// Eight scratch planes and statistics per (edge, channel), the slots:
// 0, 1 = sep3, sep5 after their first pointwise (inner BN);
// 2..7 = the six folded ops: sep3, sep5, dil3, dil5, max pool, avg pool
constexpr int kFoldSlots = 6;
constexpr int kFirstFoldSlot = 2;
// column of `weights` ([E, 8], PRIMITIVES order: none, max, avg, skip, sep3,
// sep5, dil3, dil5) that weighs folded slot s
__constant__ int kSlotOp[kFoldSlots] = {4, 5, 6, 7, 1, 2};
constexpr int kSkipOp = 3;

struct NodeEdge {
  const void* x;        // [N, H, W, >= Cs], channel stride 1
  long long sn, sh, sw; // element strides of N, H, W
  const float* dw;      // [8, 25, Cs]: row 2b (+1) = stage 1 (2) of branch b
  const float* pw;      // [8, Cs, Cs] as [ci][co]
};

struct NodeArgs {
  NodeEdge edge[kMaxEdges];
};

struct TileGeom {
  int n, h0, w0;        // image and the tile's first pixel
  long long pixbase;    // n * H * W
  long long blk, nblk;  // this block's index among the edge's blocks
};

template <int TILE>
__device__ __forceinline__ TileGeom tile_geom(int H, int W) {
  const int tiles_x = (W + TILE - 1) / TILE;
  TileGeom g;
  g.n = blockIdx.y;
  g.h0 = (blockIdx.x / tiles_x) * TILE;
  g.w0 = (blockIdx.x % tiles_x) * TILE;
  g.pixbase = (long long)g.n * H * W;
  g.blk = (long long)g.n * gridDim.x + blockIdx.x;
  g.nblk = (long long)gridDim.y * gridDim.x;
  return g;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int kNodeWarps = kNodeThreads / 32;
// halo loads in flight a thread: launch A loads four channels at once and
// keeps four blocks an SM at 64 registers; launch B loads one value
constexpr int kLoadBatchA = 4, kLoadBatchB = 8;

// ts[c][p] = sum over the KK x KK taps (dilation DIL) of xs, which holds
// the stage's input with a HALO-pixel border (RELU: max(., 0) on read). The
// window and dilation are known at compile time: a thread computes one
// channel at kRows pixels of a column, rows r + i DIL, i < kRows, which
// share their input rows (KK + kRows - 1 rows feed kRows outputs), with the
// channel's KK x KK taps in registers and kRows independent sums, each over
// the taps in row-major order. Row groups start at 0, 4, 8, ... for DIL 1
// and at 0, 1, 8, 9, ... for DIL 2; TILE is a multiple of 8.
constexpr int kRows = 4;

template <int KK, int DIL, int TILE, int HALO, bool RELU>
__device__ __forceinline__ void depthwise_fixed(const float* xs,
                                                const float* dw, float* ts,
                                                int Cs) {
  constexpr int PWID = TILE + 2 * HALO;
  constexpr int PLANE = PWID * PWID;
  constexpr int PIX = TILE * TILE;
  constexpr int GROUPS = PIX / kRows;
  constexpr int HALF = (KK - 1) / 2 * DIL;
  static_assert(TILE % 8 == 0 && HALF <= HALO, "row groups, taps in halo");
  for (int it = threadIdx.x; it < Cs * GROUPS; it += blockDim.x) {
    const int c = it / GROUPS, gi = it % GROUPS;
    const int kr = gi / TILE, col = gi % TILE;
    const int r0 = DIL == 1 ? kRows * kr : (kr / 2) * 2 * kRows + (kr % 2);
    float w[KK * KK];
#pragma unroll
    for (int t = 0; t < KK * KK; ++t) w[t] = dw[t * Cs + c];
    const float* src =
        xs + c * PLANE + (r0 + HALO - HALF) * PWID + (col + HALO - HALF);
    float acc[kRows] = {};
#pragma unroll
    for (int i = 0; i < KK + kRows - 1; ++i) {
      float v[KK];
#pragma unroll
      for (int dx = 0; dx < KK; ++dx) {
        v[dx] = src[i * DIL * PWID + dx * DIL];
        if (RELU) v[dx] = fmaxf(v[dx], 0.f);
      }
#pragma unroll
      for (int o = 0; o < kRows; ++o) {
        if (i - o < 0 || i - o >= KK) continue;
#pragma unroll
        for (int dx = 0; dx < KK; ++dx)
          acc[o] = fmaf(v[dx], w[(i - o) * KK + dx], acc[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < kRows; ++o)
      ts[c * PIX + (r0 + o * DIL) * TILE + col] = acc[o];
  }
}

// A thread's sums of o and o^2 (`n` values each, of channels c0 ..) over
// its pixels of one channel group, reduced over the warp; lane 0 adds them
// to the warp's entries red[((c0 + j) * kNodeWarps + warp) * 2]. All 32
// lanes call it with the same c0 and n.
template <int NV>
__device__ __forceinline__ void warp_flush(float (&s)[NV], float (&q)[NV],
                                           int c0, int n, float* red) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (j >= n) break;
    float a = s[j], b = q[j];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, d);
      b += __shfl_down_sync(0xffffffffu, b, d);
    }
    if ((threadIdx.x & 31) == 0) {
      red[((c0 + j) * kNodeWarps + warp) * 2] += a;
      red[((c0 + j) * kNodeWarps + warp) * 2 + 1] += b;
    }
    s[j] = q[j] = 0.f;
  }
}

// o[co] = round_T(sum_ci ts[ci][p] pw[ci][co]) at the tile's pixels, four
// output channels per item (a warp's 32 lanes: 32 pixels of one group of
// four), stored to the channel planes at `o` ([Cs][M]); the sums of o and
// o^2 of each channel, over a thread's items, then over the warp, go to
// the warp's entries of red ([Cs][kNodeWarps][2], zeroed by the caller).
template <typename T, int TILE>
__device__ __forceinline__ void pointwise_store(const float* ts,
                                                const float* pw, T* o,
                                                float* red, int Cs,
                                                long long M,
                                                const TileGeom& g, int H,
                                                int W) {
  constexpr int PIX = TILE * TILE;
  const int groups = (Cs + 3) / 4;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
  int run = -1;  // the channel group s and q hold sums of (warp-uniform)
  for (int it = threadIdx.x; it < groups * PIX; it += blockDim.x) {
    const int cg = it / PIX, p = it % PIX;
    if (cg != run) {
      if (run >= 0) warp_flush(s, q, run * 4, min(4, Cs - run * 4), red);
      run = cg;
    }
    const int h = g.h0 + p / TILE, w = g.w0 + p % TILE;
    const bool valid = h < H && w < W;
    const long long pix = g.pixbase + (long long)h * W + w;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (Cs % 4 == 0) {  // four weights in one load
      for (int ci = 0; ci < Cs; ++ci) {
        const float t = ts[ci * PIX + p];
        const float4 wv =
            *reinterpret_cast<const float4*>(pw + ci * Cs + cg * 4);
        acc[0] = fmaf(t, wv.x, acc[0]);
        acc[1] = fmaf(t, wv.y, acc[1]);
        acc[2] = fmaf(t, wv.z, acc[2]);
        acc[3] = fmaf(t, wv.w, acc[3]);
      }
    } else {
      for (int ci = 0; ci < Cs; ++ci) {
        const float t = ts[ci * PIX + p];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (cg * 4 + j < Cs)
            acc[j] = fmaf(t, pw[ci * Cs + cg * 4 + j], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = cg * 4 + j;
      if (co >= Cs) break;  // uniform over the warp
      const float v = valid ? round_to<T>(acc[j]) : 0.f;
      if (valid) o[co * M + pix] = from_f32<T>(v);
      s[j] += v;
      q[j] = fmaf(v, v, q[j]);
    }
  }
  if (run >= 0) warp_flush(s, q, run * 4, min(4, Cs - run * 4), red);
}

// The block's sums of `slots` stage outputs, red [slots][Cs][kNodeWarps][2],
// into partial[((slot * E + e) * Cs + c) * 2 + k][blk] for the slots
// listed in slot_of, then the fence that makes them visible before the
// block counts itself done. Returns true in the last block of edge e to
// finish (ctr counts the blocks of the edge, `blocks` of them).
__device__ __forceinline__ bool flush_and_count(const float* red,
                                                const int* slot_of,
                                                int slots, float* partial,
                                                unsigned* ctr, int e, int E,
                                                int Cs, const TileGeom& g,
                                                unsigned blocks) {
  __shared__ int last;
  __syncthreads();
  for (int i = threadIdx.x; i < slots * Cs; i += blockDim.x) {
    const int s = i / Cs, c = i % Cs;
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int k = 0; k < kNodeWarps; ++k) {
      sum += red[((s * Cs + c) * kNodeWarps + k) * 2];
      sq += red[((s * Cs + c) * kNodeWarps + k) * 2 + 1];
    }
    float* part =
        partial + ((((long long)slot_of[s] * E + e) * Cs + c) * 2) * g.nblk +
        g.blk;
    part[0] = sum;
    part[g.nblk] = sq;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ctr + e, 1u) == blocks - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// In the last block of edge e: mean and 1/sqrt(var + eps) of `slots` slots
// (slot_of) from the per-block sums, each the sum over blocks in a fixed
// order (a lane's stride of 32, then a shuffle tree), one warp per entry.
// With `sums` (data-parallel mode) it writes the two sums there instead,
// laid out as stat.
__device__ __forceinline__ void finish_stats(const float* partial,
                                             float* stat, float* sums,
                                             const int* slot_of,
                                             int slots, int e, int E, int Cs,
                                             long long nblk,
                                             float inv_count, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < slots * Cs; i += blockDim.x >> 5) {
    const long long entry = ((long long)slot_of[i / Cs] * E + e) * Cs +
                            i % Cs;
    const float* ps = partial + entry * 2 * nblk;
    // four sums a lane, so that four pairs of loads are in flight
    float sv[4] = {0.f, 0.f, 0.f, 0.f}, qv[4] = {0.f, 0.f, 0.f, 0.f};
    long long b = lane;
    for (; b + 96 < nblk; b += 128) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sv[u] += __ldcg(ps + b + 32 * u);
        qv[u] += __ldcg(ps + nblk + b + 32 * u);
      }
    }
    for (; b < nblk; b += 32) {
      sv[0] += __ldcg(ps + b);
      qv[0] += __ldcg(ps + nblk + b);
    }
    float s = (sv[0] + sv[1]) + (sv[2] + sv[3]);
    float q = (qv[0] + qv[1]) + (qv[2] + qv[3]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, d);
      q += __shfl_down_sync(0xffffffffu, q, d);
    }
    if (lane == 0 && sums != nullptr) {
      sums[entry * 2] = s;
      sums[entry * 2 + 1] = q;
    } else if (lane == 0) {
      const float mean = s * inv_count;
      const float var = q * inv_count - mean * mean;
      stat[entry * 2] = mean;
      stat[entry * 2 + 1] = 1.f / sqrtf(var + eps);
    }
  }
}

// Data-parallel mode: mean and 1/sqrt(var + eps) of stat entries [lo, hi)
// from the global sums (laid out as stat) of `count` pixels, with
// finish_stats' arithmetic.
__global__ void __launch_bounds__(kNodeThreads)
    node_stat_finish_kernel(const float* __restrict__ sums,
                            float* __restrict__ stat, long long lo,
                            long long hi, float inv_count, float eps) {
  for (long long i = lo + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < hi; i += (long long)gridDim.x * blockDim.x) {
    const float s = sums[i * 2], q = sums[i * 2 + 1];
    const float mean = s * inv_count;
    const float var = q * inv_count - mean * mean;
    stat[i * 2] = mean;
    stat[i * 2 + 1] = 1.f / sqrtf(var + eps);
  }
}

template <int TILE, int HALO>
constexpr size_t stage_smem_floats(int Cs, int branches, int slots) {
  return (size_t)Cs * (TILE + 2 * HALO) * (TILE + 2 * HALO)  // xs
         + (size_t)Cs * TILE * TILE                          // ts
         + (size_t)branches * kTaps * Cs                     // dws
         + (size_t)branches * Cs * Cs                        // pws
         + (size_t)slots * Cs * kNodeWarps * 2;              // red
}

// Launch A. grid (tiles, N, E). The edge's x tile with a 4-pixel halo, the
// first stage of the four conv branches and both pools: six planes and
// their per-block sums; the edge's last block finishes the statistics of
// slots 0 and 1 (the sep convs' inner BatchNorm), or with `sums` writes
// their sums.
template <typename T, int TILE>
__global__ void __launch_bounds__(kNodeThreads, 4)
    node_stage_a_kernel(NodeArgs args, T* __restrict__ obuf,
                        float* __restrict__ partial,
                        float* __restrict__ stat, float* __restrict__ sums,
                        unsigned* ctr, int E, int H, int W, int Cs,
                        int vec_x) {
  constexpr int HALO = 4;
  constexpr int PWID = TILE + 2 * HALO;
  constexpr int PLANE = PWID * PWID;
  constexpr int PIX = TILE * TILE;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // [Cs][PLANE] raw x, 0 outside
  float* ts = xs + Cs * PLANE;        // [Cs][PIX]
  float* dws = ts + Cs * PIX;         // [4][25][Cs] first-stage taps
  float* pws = dws + 4 * kTaps * Cs;  // [4][Cs][Cs]
  float* red = pws + 4 * Cs * Cs;     // [6][Cs][kNodeWarps][2]
  const int e = blockIdx.z;
  const NodeEdge ed = args.edge[e];
  const TileGeom g = tile_geom<TILE>(H, W);
  const long long M = (long long)gridDim.y * H * W;
  const T* x = (const T*)ed.x + (long long)g.n * ed.sn;

  // the halo tile, four channels of a pixel at a time where aligned
  const int groups = vec_x ? Cs / 4 : Cs;
  const int per = vec_x ? 4 : 1;
  for (int base = threadIdx.x; base < PLANE * groups;
       base += kLoadBatchA * kNodeThreads) {
    float v[kLoadBatchA][4];
#pragma unroll
    for (int b = 0; b < kLoadBatchA; ++b) {
      const int i = base + b * kNodeThreads;
      const int q = i / groups, cg = i % groups;
      const int h = g.h0 + q / PWID - HALO, w = g.w0 + q % PWID - HALO;
      v[b][0] = v[b][1] = v[b][2] = v[b][3] = 0.f;
      if (i < PLANE * groups && h >= 0 && h < H && w >= 0 && w < W) {
        const T* src = x + (long long)h * ed.sh + (long long)w * ed.sw +
                       cg * per;
        if (vec_x) {
          const float4 f = ld4f(src);
          v[b][0] = f.x, v[b][1] = f.y, v[b][2] = f.z, v[b][3] = f.w;
        } else {
          v[b][0] = to_f32(*src);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kLoadBatchA; ++b) {
      const int i = base + b * kNodeThreads;
      if (i >= PLANE * groups) break;
      const int q = i / groups, cg = i % groups;
      for (int j = 0; j < per; ++j) xs[(cg * per + j) * PLANE + q] = v[b][j];
    }
  }
  for (int i = threadIdx.x; i < 4 * kTaps * Cs; i += blockDim.x)
    dws[i] = ed.dw[(size_t)(2 * (i / (kTaps * Cs))) * kTaps * Cs +
                   i % (kTaps * Cs)];
  for (int i = threadIdx.x; i < 4 * Cs * Cs; i += blockDim.x)
    pws[i] = ed.pw[(size_t)(2 * (i / (Cs * Cs))) * Cs * Cs + i % (Cs * Cs)];
  for (int i = threadIdx.x; i < 6 * Cs * kNodeWarps * 2; i += blockDim.x)
    red[i] = 0.f;
  __syncthreads();

  // the four conv branches' first stage: sep3, sep5, dil3, dil5
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float* dw = dws + b * kTaps * Cs;
    if (b == 0) depthwise_fixed<3, 1, TILE, HALO, true>(xs, dw, ts, Cs);
    if (b == 1) depthwise_fixed<5, 1, TILE, HALO, true>(xs, dw, ts, Cs);
    if (b == 2) depthwise_fixed<3, 2, TILE, HALO, true>(xs, dw, ts, Cs);
    if (b == 3) depthwise_fixed<5, 2, TILE, HALO, true>(xs, dw, ts, Cs);
    __syncthreads();
    const int slot = b < 2 ? b : b + 2;
    pointwise_store<T, TILE>(ts, pws + b * Cs * Cs,
                             obuf + ((size_t)slot * E + e) * Cs * M,
                             red + b * Cs * kNodeWarps * 2, Cs, M, g, H, W);
    __syncthreads();
  }

  // max pool (slot 6) and avg pool (slot 7), 3x3, stride 1, pad 1; the
  // window's valid rows and columns are known from the pixel. Their sums
  // are kept per channel as in pointwise_store.
  float sm[1] = {0.f}, qm[1] = {0.f}, sa[1] = {0.f}, qa[1] = {0.f};
  int run = -1;
  for (int it = threadIdx.x; it < Cs * PIX; it += blockDim.x) {
    const int c = it / PIX, p = it % PIX;
    if (c != run) {
      if (run >= 0) {
        warp_flush(sm, qm, run, 1, red + 4 * Cs * kNodeWarps * 2);
        warp_flush(sa, qa, run, 1, red + 5 * Cs * kNodeWarps * 2);
      }
      run = c;
    }
    const int h = g.h0 + p / TILE, w = g.w0 + p % TILE;
    const bool valid = h < H && w < W;
    const float* src =
        xs + c * PLANE + (p / TILE + HALO) * PWID + (p % TILE + HALO);
    const int y0 = h > 0 ? -1 : 0, y1 = h < H - 1 ? 1 : 0;
    const int x0 = w > 0 ? -1 : 0, x1 = w < W - 1 ? 1 : 0;
    float mx = -INFINITY, sum = 0.f;
    for (int dy = y0; dy <= y1; ++dy)
      for (int dx = x0; dx <= x1; ++dx) {
        const float v = src[dy * PWID + dx];
        mx = fmaxf(mx, v);
        sum += v;
      }
    const float vmax = valid ? mx : 0.f;
    const float vavg =
        valid ? round_to<T>(sum / (float)((y1 - y0 + 1) * (x1 - x0 + 1)))
              : 0.f;
    const long long pix = g.pixbase + (long long)h * W + w;
    if (valid) {
      obuf[(((size_t)6 * E + e) * Cs + c) * M + pix] = from_f32<T>(vmax);
      obuf[(((size_t)7 * E + e) * Cs + c) * M + pix] = from_f32<T>(vavg);
    }
    sm[0] += vmax;
    qm[0] = fmaf(vmax, vmax, qm[0]);
    sa[0] += vavg;
    qa[0] = fmaf(vavg, vavg, qa[0]);
  }
  if (run >= 0) {
    warp_flush(sm, qm, run, 1, red + 4 * Cs * kNodeWarps * 2);
    warp_flush(sa, qa, run, 1, red + 5 * Cs * kNodeWarps * 2);
  }

  // the slots of the six outputs in the order of red: sep3 and sep5 after
  // their first pointwise, dil3, dil5, max pool, avg pool
  const int slots[6] = {0, 1, 4, 5, 6, 7};
  if (flush_and_count(red, slots, 6, partial, ctr, e, E, Cs, g,
                      (unsigned)g.nblk))
    finish_stats(partial, stat, sums, slots, 2, e, E, Cs, g.nblk,
                 1.f / (float)M, 1e-5f);
}

// Launch B. grid (tiles, N, 2 * E): z = 2 * e + which (0: sep3, 1: sep5).
// The second stage of the sep convs from the first stage's plane through
// its BatchNorm; the edge's last block finishes the six folded statistics
// (with `sums`: writes their sums).
template <typename T, int TILE>
__global__ void __launch_bounds__(kNodeThreads)
    node_stage_b_kernel(NodeArgs args, T* __restrict__ obuf,
                        float* __restrict__ partial,
                        float* __restrict__ stat, float* __restrict__ sums,
                        unsigned* ctr, int E, int H, int W, int Cs) {
  constexpr int HALO = 2;
  constexpr int PWID = TILE + 2 * HALO;
  constexpr int PLANE = PWID * PWID;
  constexpr int PIX = TILE * TILE;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [Cs][PLANE] relu(BN(o1)) as values of T
  float* ts = xs + Cs * PLANE;    // [Cs][PIX]
  float* dws = ts + Cs * PIX;     // [25][Cs] second-stage taps
  float* pws = dws + kTaps * Cs;  // [Cs][Cs]
  float* red = pws + Cs * Cs;     // [Cs][kNodeWarps][2]
  const int e = blockIdx.z / 2, which = blockIdx.z % 2;
  const NodeEdge ed = args.edge[e];
  const TileGeom g = tile_geom<TILE>(H, W);
  const long long M = (long long)gridDim.y * H * W;
  const size_t mid = ((size_t)which * E + e) * Cs;  // slot 0 or 1

  for (int base = threadIdx.x; base < PLANE * Cs;
       base += kLoadBatchB * kNodeThreads) {
    float v[kLoadBatchB];
    bool in[kLoadBatchB];
#pragma unroll
    for (int b = 0; b < kLoadBatchB; ++b) {
      const int i = base + b * kNodeThreads;
      const int c = i / PLANE, q = i % PLANE;
      const int h = g.h0 + q / PWID - HALO, w = g.w0 + q % PWID - HALO;
      in[b] = i < PLANE * Cs && h >= 0 && h < H && w >= 0 && w < W;
      v[b] = in[b] ? to_f32(obuf[(mid + c) * M + g.pixbase +
                                 (long long)h * W + w])
                   : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kLoadBatchB; ++b) {
      const int i = base + b * kNodeThreads;
      if (i >= PLANE * Cs) break;
      const int c = i / PLANE;
      const float mean = stat[(mid + c) * 2], rstd = stat[(mid + c) * 2 + 1];
      xs[i] = in[b] ? round_to<T>(fmaxf((v[b] - mean) * rstd, 0.f)) : 0.f;
    }
  }
  const int kidx = 2 * which + 1;
  for (int i = threadIdx.x; i < kTaps * Cs; i += blockDim.x)
    dws[i] = ed.dw[(size_t)kidx * kTaps * Cs + i];
  for (int i = threadIdx.x; i < Cs * Cs; i += blockDim.x)
    pws[i] = ed.pw[(size_t)kidx * Cs * Cs + i];
  for (int i = threadIdx.x; i < Cs * kNodeWarps * 2; i += blockDim.x)
    red[i] = 0.f;
  __syncthreads();

  if (which)
    depthwise_fixed<5, 1, TILE, HALO, false>(xs, dws, ts, Cs);
  else
    depthwise_fixed<3, 1, TILE, HALO, false>(xs, dws, ts, Cs);
  __syncthreads();
  const int slot = kFirstFoldSlot + which;
  pointwise_store<T, TILE>(ts, pws, obuf + ((size_t)slot * E + e) * Cs * M,
                           red, Cs, M, g, H, W);
  const int slot_of[1] = {slot};
  // the edge's blocks of both sep convs count on one counter
  if (flush_and_count(red, slot_of, 1, partial, ctr, e, E, Cs, g,
                      2u * (unsigned)g.nblk)) {
    const int folds[kFoldSlots] = {2, 3, 4, 5, 6, 7};
    finish_stats(partial, stat, sums, folds, kFoldSlots, e, E, Cs, g.nblk,
                 1.f / (float)M, 1e-5f);
  }
}

// Launch Z. One item per (PX consecutive pixels, four channels), pixels
// fastest: a warp's plane loads are contiguous, PX values in one load (PX
// = 2 where N H W is even: a warp reads whole 128-byte lines of a bf16
// plane). coef and bias from the statistics, then per (pixel, channel) for
// each edge its skip term and its six folded ops, minus the bias: a fixed
// order.
template <typename T, int PX>
__global__ void __launch_bounds__(kNodeThreads)
    node_final_kernel(NodeArgs args, const float* __restrict__ weights,
                      const T* __restrict__ obuf,
                      const float* __restrict__ stat,
                      float* __restrict__ out, int E, int N, int H, int W,
                      int Cs, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* coef = smem;                        // [E][6][Cs]
  float* bias = coef + E * kFoldSlots * Cs;  // [Cs]
  float* skip = bias + Cs;                   // [E]
  for (int i = threadIdx.x; i < E * kFoldSlots * Cs; i += blockDim.x) {
    const int e = i / (kFoldSlots * Cs), s = (i / Cs) % kFoldSlots;
    const int c = i % Cs;
    const size_t entry = ((size_t)(kFirstFoldSlot + s) * E + e) * Cs + c;
    coef[i] = weights[e * 8 + kSlotOp[s]] * stat[entry * 2 + 1];
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    skip[e] = weights[e * 8 + kSkipOp];
  __syncthreads();
  for (int c = threadIdx.x; c < Cs; c += blockDim.x) {
    float b = 0.f;
    for (int s = 0; s < kFoldSlots; ++s)
      for (int e = 0; e < E; ++e) {
        const size_t entry = ((size_t)(kFirstFoldSlot + s) * E + e) * Cs + c;
        b = fmaf(coef[(e * kFoldSlots + s) * Cs + c], stat[entry * 2], b);
      }
    bias[c] = b;
  }
  __syncthreads();
  const long long M = (long long)N * H * W, units = M / PX;
  const long long HW = (long long)H * W;
  const int groups = (Cs + 3) / 4;
  for (long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       it < groups * units; it += (long long)gridDim.x * blockDim.x) {
    const int c0 = (int)(it / units) * 4;
    const long long pix0 = (it % units) * PX;
    int img[PX], row[PX], col[PX];  // each pixel's n, h, w
#pragma unroll
    for (int q = 0; q < PX; ++q) {
      const long long pix = pix0 + q;
      img[q] = (int)(pix / HW);
      const int rem = (int)(pix % HW);
      row[q] = rem / W, col[q] = rem % W;
    }
    float acc[PX][4] = {};
    for (int e = 0; e < E; ++e) {
      const NodeEdge& ed = args.edge[e];
#pragma unroll
      for (int q = 0; q < PX; ++q) {
        const T* x = (const T*)ed.x + (long long)img[q] * ed.sn +
                     (long long)row[q] * ed.sh + (long long)col[q] * ed.sw +
                     c0;
        float xv[4];
        if (vec) {
          const float4 f = ld4f(x);
          xv[0] = f.x, xv[1] = f.y, xv[2] = f.z, xv[3] = f.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            xv[j] = c0 + j < Cs ? to_f32(x[j]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[q][j] = fmaf(xv[j], skip[e], acc[q][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + j >= Cs) break;
        float o[kFoldSlots][PX];
#pragma unroll
        for (int s = 0; s < kFoldSlots; ++s) {
          const T* src =
              obuf + (((size_t)(kFirstFoldSlot + s) * E + e) * Cs + c0 + j) *
                         M + pix0;
          if constexpr (PX == 2) {
            const float2 v = ld2f(src);
            o[s][0] = v.x, o[s][1] = v.y;
          } else {
            o[s][0] = to_f32(*src);
          }
        }
#pragma unroll
        for (int q = 0; q < PX; ++q)
#pragma unroll
          for (int s = 0; s < kFoldSlots; ++s)
            acc[q][j] = fmaf(o[s][q], coef[(e * kFoldSlots + s) * Cs + c0 + j],
                             acc[q][j]);
      }
    }
#pragma unroll
    for (int q = 0; q < PX; ++q) {
      float* dst = out + (pix0 + q) * Cs + c0;
      if (vec) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[q][0] - bias[c0], acc[q][1] - bias[c0 + 1],
                        acc[q][2] - bias[c0 + 2], acc[q][3] - bias[c0 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < Cs) dst[j] = acc[q][j] - bias[c0 + j];
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return allow_dynamic_smem((const void*)kernel, (int)bytes);
}

// Four consecutive channels of one pixel of every edge load at once.
inline bool edges_vec4(const NodeArgs& args, int E, int Cs, size_t elem) {
  if (Cs % 4 != 0) return false;
  for (int e = 0; e < E; ++e) {
    const NodeEdge& ed = args.edge[e];
    if ((uintptr_t)ed.x % (4 * elem) != 0 || ed.sn % 4 != 0 ||
        ed.sh % 4 != 0 || ed.sw % 4 != 0)
      return false;
  }
  return true;
}

template <int TILE>
long long fwd_blocks(int N, int H, int W) {
  return (long long)N * ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
}

// The counters after the partial sums: E for launch A's, E for launch B's.
template <int TILE>
unsigned* fwd_counters(float* partial, int E, int N, int H, int W, int Cs) {
  return reinterpret_cast<unsigned*>(
      partial + (long long)8 * E * Cs * 2 * fwd_blocks<TILE>(N, H, W));
}

template <typename T, int TILE>
cudaError_t launch_stage_a(const NodeArgs& args, T* obuf, float* partial,
                           float* stat, float* sums, unsigned* ctr, int E,
                           int N, int H, int W, int Cs, cudaStream_t s) {
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  const size_t smem = stage_smem_floats<TILE, 4>(Cs, 4, 6) * sizeof(float);
  const cudaError_t rc = allow_smem(node_stage_a_kernel<T, TILE>, smem);
  if (rc != cudaSuccess) return rc;
  const int vec = edges_vec4(args, E, Cs, sizeof(T));
  node_stage_a_kernel<T, TILE><<<dim3(tiles, N, E), kNodeThreads, smem, s>>>(
      args, obuf, partial, stat, sums, ctr, E, H, W, Cs, vec);
  return cudaGetLastError();
}

template <typename T, int TILE>
cudaError_t launch_stage_b(const NodeArgs& args, T* obuf, float* partial,
                           float* stat, float* sums, unsigned* ctr, int E,
                           int N, int H, int W, int Cs, cudaStream_t s) {
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  const size_t smem = stage_smem_floats<TILE, 2>(Cs, 1, 1) * sizeof(float);
  const cudaError_t rc = allow_smem(node_stage_b_kernel<T, TILE>, smem);
  if (rc != cudaSuccess) return rc;
  node_stage_b_kernel<T, TILE>
      <<<dim3(tiles, N, 2 * E), kNodeThreads, smem, s>>>(
          args, obuf, partial, stat, sums, ctr, E, H, W, Cs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_final(const NodeArgs& args, const float* weights,
                         const T* obuf, const float* stat, float* out, int E,
                         int N, int H, int W, int Cs, cudaStream_t s) {
  const long long M = (long long)N * H * W;
  const int vec = edges_vec4(args, E, Cs, sizeof(T));
  const int px = M % 2 == 0 ? 2 : 1;
  const long long items = (long long)((Cs + 3) / 4) * (M / px);
  const long long want = (items + kNodeThreads - 1) / kNodeThreads;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  const size_t smem_z = (size_t)(E * kFoldSlots * Cs + Cs + E) * sizeof(float);
  if (px == 2)
    node_final_kernel<T, 2><<<blocks, kNodeThreads, smem_z, s>>>(
        args, weights, obuf, stat, out, E, N, H, W, Cs, vec);
  else
    node_final_kernel<T, 1><<<blocks, kNodeThreads, smem_z, s>>>(
        args, weights, obuf, stat, out, E, N, H, W, Cs, vec);
  return cudaGetLastError();
}

// Data-parallel mode: stat entries [lo, hi) from the global sums.
inline cudaError_t launch_stat_finish(const float* sums, float* stat,
                                      long long lo, long long hi,
                                      long long count, cudaStream_t s) {
  const long long want = (hi - lo + kNodeThreads - 1) / kNodeThreads;
  node_stat_finish_kernel<<<(int)(want < 132 ? want : 132), kNodeThreads, 0,
                            s>>>(sums, stat, lo, hi, 1.f / (float)count,
                                 1e-5f);
  return cudaGetLastError();
}

template <typename T, int TILE>
cudaError_t node_fwd(const NodeArgs& args, const float* weights, T* obuf,
                     float* partial, float* stat, float* out, int E, int N,
                     int H, int W, int Cs, cudaStream_t s) {
  unsigned* ctr = fwd_counters<TILE>(partial, E, N, H, W, Cs);
  cudaError_t rc = cudaMemsetAsync(ctr, 0, 2 * E * sizeof(unsigned), s);
  if (rc != cudaSuccess) return rc;
  rc = launch_stage_a<T, TILE>(args, obuf, partial, stat, nullptr, ctr, E, N,
                               H, W, Cs, s);
  if (rc != cudaSuccess) return rc;
  rc = launch_stage_b<T, TILE>(args, obuf, partial, stat, nullptr, ctr + E,
                               E, N, H, W, Cs, s);
  if (rc != cudaSuccess) return rc;
  return launch_final<T>(args, weights, obuf, stat, out, E, N, H, W, Cs, s);
}

// Edge of the square pixel tile of one block of launches A and B: the most
// pixels whose tile and halo fit beside Cs channels (more pixels a block
// amortise its weights, its flush and the halo).
inline int fwd_tile(int Cs) { return Cs <= 4 ? 32 : (Cs <= 16 ? 16 : 8); }

template <typename T>
cudaError_t node_fwd_tile(const NodeArgs& args, const float* weights,
                          void* obuf, float* partial, float* stat, float* out,
                          int E, int N, int H, int W, int Cs, cudaStream_t s) {
  switch (fwd_tile(Cs)) {
    case 32:
      return node_fwd<T, 32>(args, weights, (T*)obuf, partial, stat, out, E,
                             N, H, W, Cs, s);
    case 16:
      return node_fwd<T, 16>(args, weights, (T*)obuf, partial, stat, out, E,
                             N, H, W, Cs, s);
    default:
      return node_fwd<T, 8>(args, weights, (T*)obuf, partial, stat, out, E,
                            N, H, W, Cs, s);
  }
}

// f(std::integral_constant<int, TILE>) at the tile of launches A, B, S, X.
template <typename F>
cudaError_t with_tile(int Cs, F f) {
  switch (fwd_tile(Cs)) {
    case 32:
      return f(std::integral_constant<int, 32>());
    case 16:
      return f(std::integral_constant<int, 16>());
    default:
      return f(std::integral_constant<int, 8>());
  }
}

// The data-parallel forward, one entry point a launch (see the top of the
// file). A: zero A's counters, launch A, its sums of slots 0 and 1 into
// `sums` ([8, E, Cs, 2] as stat).
template <typename T>
cudaError_t node_fwd_sync_a(const NodeArgs& args, void* obuf, float* partial,
                            float* sums, int E, int N, int H, int W, int Cs,
                            cudaStream_t s) {
  return with_tile(Cs, [&](auto tile) {
    constexpr int TILE = decltype(tile)::value;
    unsigned* ctr = fwd_counters<TILE>(partial, E, N, H, W, Cs);
    cudaError_t rc = cudaMemsetAsync(ctr, 0, E * sizeof(unsigned), s);
    if (rc != cudaSuccess) return rc;
    return launch_stage_a<T, TILE>(args, (T*)obuf, partial, nullptr, sums,
                                   ctr, E, N, H, W, Cs, s);
  });
}

// B: the statistics of slots 0 and 1 from the global sums of `count`
// pixels, zero B's counters, launch B, its sums of slots 2..7 into `sums`.
template <typename T>
cudaError_t node_fwd_sync_b(const NodeArgs& args, void* obuf, float* partial,
                            float* sums, float* stat, long long count, int E,
                            int N, int H, int W, int Cs, cudaStream_t s) {
  cudaError_t rc =
      launch_stat_finish(sums, stat, 0, 2LL * E * Cs, count, s);
  if (rc != cudaSuccess) return rc;
  return with_tile(Cs, [&](auto tile) {
    constexpr int TILE = decltype(tile)::value;
    unsigned* ctr = fwd_counters<TILE>(partial, E, N, H, W, Cs) + E;
    cudaError_t rc2 = cudaMemsetAsync(ctr, 0, E * sizeof(unsigned), s);
    if (rc2 != cudaSuccess) return rc2;
    return launch_stage_b<T, TILE>(args, (T*)obuf, partial, stat, sums, ctr,
                                   E, N, H, W, Cs, s);
  });
}

// Z: the statistics of slots 2..7 from the global sums, then launch Z.
template <typename T>
cudaError_t node_fwd_sync_z(const NodeArgs& args, const float* weights,
                            const void* obuf, const float* sums, float* stat,
                            float* out, long long count, int E, int N, int H,
                            int W, int Cs, cudaStream_t s) {
  const cudaError_t rc =
      launch_stat_finish(sums, stat, 2LL * E * Cs, 8LL * E * Cs, count, s);
  if (rc != cudaSuccess) return rc;
  return launch_final<T>(args, weights, (const T*)obuf, stat, out, E, N, H,
                         W, Cs, s);
}

// ---------------------------------------------------------------------------
// Backward. Given g = dL/d out [N, H, W, Cs] fp32, the forward's stage
// outputs `obuf` and statistics `stat` (kept by the caller instead of being
// recomputed, which the TPU kernel has to do: there the planes never leave
// VMEM, here they are in device memory anyway), it computes dx_e in T and, in
// fp32, d dw [E, 8, 25, Cs], d pw [E, 8, Cs, Cs] and d w [E, 8]. The rounding
// of a stage output to T counts as the identity, and every mask (ReLU, the
// max pool's argmax) is taken on the rounded values the forward saw.
//
// What bounds it: bytes again, about twice the forward's (it reads the planes
// the forward wrote, g, and x, and writes dx and one fp32 plane per sep
// conv), and the three grid-wide dependencies of the function: the folded
// BatchNorms' sums of g and g o, then the inner BatchNorms' sums of dz, then
// x's gradient. One C entry point issues a memset of 3E counters and three
// launches on one stream; the last block of each edge to finish a launch
// (a counter per edge, the only atomics) finishes that launch's sums over
// the grid, each sum over blocks in a fixed order, so a training step
// repeats bit for bit:
//   R. per (edge, 1024-pixel chunk, four channels): sum g and sum g o of the
//      six folded ops, a plane at a time, four channels of g in one load.
//      The edge's last block adds the chunks and writes the folded
//      BatchNorms' backward coefficients (d o = A (g - gbar - (o - mu) k2)),
//      gbar, and d w of the six folded ops (and 0 at `none`) straight into
//      [E, 8].
//   S. per (edge, sep branch, image, tile): the sep conv's second stage
//      backwards, d o -> pointwise -> depthwise -> ReLU mask: writes dz as an
//      fp32 plane and the block's sums of dz and dz xhat; the edge's last
//      block (of both branches) writes their means.
//   X. per (edge, image, tile): everything that reaches x, from one x tile
//      with a 4-pixel halo: skip, the first stage of both sep convs (through
//      the inner BatchNorm's backward), both dil convs, max pool (to the
//      first maximal tap in row-major order) and avg pool; writes dx once.
//      The edge's last block adds the blocks' partials of d dw, d pw (S's
//      and its own) and d w[skip].
// A stage backwards, in S and in X (stage_bwd): dt = pw^T d over the tile and
// the taps' reach (one pass, four input channels an item), then one pass in
// which a thread takes one channel at R pixels of a column, taps and window
// rows known at compile time and held in registers, and computes from the
// shared window rows of the stage's input and of dt: the depthwise output t
// again (the one value the forward does not keep), d dw += in dt, d in = dw
// (*) dt, and d pw += t d for every output channel. A channel's d dw and d
// pw are summed per thread, then per warp, then over the channel's warps in
// order, and written once per block. Planes are read pixel-fastest (a
// warp's loads contiguous); tiles are the forward's, 32 x 32 up to 4
// channels.

constexpr int kChunk = 1024;  // pixels per block of launch R
constexpr int kRSums = 7;     // sum g, then sum g * o of the six folded ops
constexpr int kRedFloats = kNodeWarps * (kTaps + 4 + 2);  // see stage_bwd

struct BwdScratch {  // offsets in floats into one fp32 scratch, 16-byte parts
  long long part_r, fc, gbar, dzp, part_s, mstat, part_dw, part_pw,
      part_skip, ctr, total;
};

inline BwdScratch bwd_scratch(int E, long long M, long long nblk, int Cs) {
  BwdScratch b;
  const long long nchunk = (M + kChunk - 1) / kChunk;
  long long at = 0;
  auto take = [&at](long long n) {
    const long long o = at;
    at += (n + 3) / 4 * 4;
    return o;
  };
  b.part_r = take((long long)E * Cs * kRSums * nchunk);
  b.fc = take((long long)kFoldSlots * E * Cs * 3);
  b.gbar = take((long long)E * Cs);
  b.dzp = take(2LL * E * Cs * M);
  b.part_s = take(2LL * E * Cs * 2 * nblk);
  b.mstat = take(2LL * E * Cs * 2);
  b.part_dw = take((long long)E * 8 * kTaps * Cs * nblk);
  b.part_pw = take((long long)E * 8 * Cs * Cs * nblk);
  b.part_skip = take((long long)E * nblk);
  b.ctr = take(3LL * E);  // unsigned: R's, S's and X's counter per edge
  b.total = at;
  return b;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

// After this block's partials are written: true in the last of `blocks`
// blocks that count on ctr, which then sees every block's writes.
__device__ __forceinline__ bool count_done(unsigned* ctr, unsigned blocks) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ctr, 1u) == blocks - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// For i < count: store(i, the sum of the n partials at part + row(i) * n),
// or store(i, 0) where row(i) < 0. Each sum in a fixed order: a lane's
// stride over the row (four values a load where rows start on 16 bytes,
// eight loads in flight), then a shuffle tree over the entry's L lanes, L =
// 1, 2, 4 or 8 as the row is long. The whole block calls it.
template <typename Row, typename Store>
__device__ __forceinline__ void sum_entries(const float* part, long long n,
                                            int count, Row row, Store store) {
  const int L = n >= 256 ? 8 : (n >= 128 ? 4 : (n >= 64 ? 2 : 1));
  const int sub = threadIdx.x % L, per = blockDim.x / L;
  const bool vec = n % 4 == 0 && (uintptr_t)part % 16 == 0;
  for (int base = 0; base < count; base += per) {
    const int i = base + (int)threadIdx.x / L;
    const long long r = i < count ? row(i) : -1;
    float s = 0.f;
    if (r >= 0) {
      const float* p = part + r * n;
      if (vec) {
        long long k = 4 * sub;
        for (; k + 28 * L < n; k += 32 * L) {
          float4 v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            v[u] = __ldcg(reinterpret_cast<const float4*>(p + k + 4 * L * u));
#pragma unroll
          for (int u = 0; u < 8; ++u) s += (v[u].x + v[u].y) + (v[u].z + v[u].w);
        }
        for (; k < n; k += 4 * L) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(p + k));
          s += (v.x + v.y) + (v.z + v.w);
        }
      } else {
        for (long long k = sub; k < n; k += L) s += __ldcg(p + k);
      }
    }
    for (int d = L / 2; d > 0; d >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, d, L);
    if (i < count && sub == 0) store(i, s);
  }
}

// Four channels [c0, c0 + 4) of g at pixel pix (zero past Cs).
__device__ __forceinline__ float4 load_g4(const float* g, long long pix,
                                          int Cs, int c0, bool vec) {
  const float* p = g + pix * Cs + c0;
  if (vec) return *reinterpret_cast<const float4*>(p);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = c0 + j < Cs ? p[j] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float get4(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// The folded BatchNorm's backward at one element.
__device__ __forceinline__ float fold_grad(const float* fc3, float gv,
                                           float gb, float o) {
  return fc3[0] * (gv - gb - (o - fc3[1]) * fc3[2]);
}

// The folded BatchNorms' backward coefficients of edge e and its gbar from
// sums [Cs][kRSums] (sum g, then sum g o of the six folded ops) over
// 1 / inv_count pixels; the whole block calls it.
__device__ __forceinline__ void fold_coefs(const float* sums,
                                           const float* __restrict__ stat,
                                           const float* __restrict__ weights,
                                           float* __restrict__ fc,
                                           float* __restrict__ gbar, int e,
                                           int E, int Cs, float inv_count) {
  for (int c = threadIdx.x; c < Cs; c += blockDim.x) {
    const float gs = sums[c * kRSums];
    gbar[e * Cs + c] = gs * inv_count;
    for (int s = 0; s < kFoldSlots; ++s) {
      const size_t entry = ((size_t)(kFirstFoldSlot + s) * E + e) * Cs + c;
      const float mu = stat[entry * 2], r = stat[entry * 2 + 1];
      const float sc = sums[c * kRSums + 1 + s] - mu * gs;
      float* out = fc + (((size_t)s * E + e) * Cs + c) * 3;
      out[0] = weights[e * 8 + kSlotOp[s]] * r;
      out[1] = mu;
      out[2] = r * r * sc * inv_count;
    }
  }
}

// Launch R. grid (chunks, E * channel groups of 4). With `sums_out`
// (data-parallel mode) the edge's last block writes this rank's sums there
// ([E, Cs, kRSums]) in place of the coefficients; d w comes from this
// rank's sums either way. The chunk's planes one
// at a time (a block reads one contiguous run of a plane at once, as DRAM
// prefers); g, read four channels a load, comes from L1 after the first
// pass.
template <typename T>
__global__ void __launch_bounds__(kNodeThreads)
    node_bwd_r_kernel(const float* __restrict__ g, const T* __restrict__ obuf,
                      const float* __restrict__ stat,
                      const float* __restrict__ weights, float* part_r,
                      float* __restrict__ fc, float* __restrict__ gbar,
                      float* __restrict__ sums_out, float* __restrict__ dwt,
                      unsigned* ctr, int E, long long M, int Cs, int vec_g) {
  constexpr int kPer = kChunk / kNodeThreads;  // pixels a thread
  __shared__ float red[kNodeWarps][4];
  __shared__ float sums[kMaxCs * kRSums];
  const int groups = (Cs + 3) / 4, warp = threadIdx.x >> 5;
  const int e = blockIdx.y / groups, c0 = blockIdx.y % groups * 4;
  const long long nchunk = gridDim.x;
  const long long lo = (long long)blockIdx.x * kChunk;
  {
    const int nc = Cs - c0 < 4 ? Cs - c0 : 4;
    for (int k = 0; k < kRSums; ++k) {  // sum g, then g o of fold slot k - 1
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float ov[kPer][4];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {  // the plane's loads, all in flight
        const long long pix = lo + threadIdx.x + i * kNodeThreads;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ov[i][j] = 1.f;
          if (k > 0 && j < nc && pix < M)
            ov[i][j] = to_f32(obuf[(((size_t)(kFirstFoldSlot + k - 1) * E +
                                     e) * Cs + c0 + j) * M + pix]);
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const long long pix = lo + threadIdx.x + i * kNodeThreads;
        if (pix >= M) break;
        const float4 gv = load_g4(g, pix, Cs, c0, vec_g);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] = fmaf(get4(gv, j), ov[i][j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = warp_sum(acc[j]);
        if ((threadIdx.x & 31) == 0) red[warp][j] = v;
      }
      __syncthreads();
      if ((int)threadIdx.x < nc) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kNodeWarps; ++w) v += red[w][threadIdx.x];
        part_r[(((size_t)e * Cs + c0 + threadIdx.x) * kRSums + k) * nchunk +
               blockIdx.x] = v;
      }
      __syncthreads();
    }
  }
  if (!count_done(ctr + e, (unsigned)(nchunk * groups))) return;

  // the edge's last block: the sums over all pixels, then per channel the
  // folded BatchNorms' coefficients, then d w of the six folded ops
  sum_entries(
      part_r + (size_t)e * Cs * kRSums * nchunk, nchunk, Cs * kRSums,
      [](int i) { return (long long)i; },
      [&](int i, float v) { sums[i] = v; });
  __syncthreads();
  if (sums_out != nullptr) {
    for (int i = threadIdx.x; i < Cs * kRSums; i += blockDim.x)
      sums_out[(size_t)e * Cs * kRSums + i] = sums[i];
  } else {
    fold_coefs(sums, stat, weights, fc, gbar, e, E, Cs, 1.f / (float)M);
  }
  if (threadIdx.x < kFoldSlots) {
    const int s = threadIdx.x;
    float v = 0.f;
    for (int c = 0; c < Cs; ++c) {
      const size_t entry = ((size_t)(kFirstFoldSlot + s) * E + e) * Cs + c;
      const float mu = stat[entry * 2], r = stat[entry * 2 + 1];
      const float gs = sums[c * kRSums];
      v += r * (sums[c * kRSums + 1 + s] - mu * gs);
    }
    dwt[e * 8 + kSlotOp[s]] = v;
  } else if (threadIdx.x == kFoldSlots) {
    dwt[e * 8] = 0.f;  // none
  }
}

// NOUT values of four channels.
template <int NOUT>
struct Vals {
  float4 v[NOUT];
};

// kStageBatch items a thread: their loads are all in flight before the
// first store (eight measured no faster).
constexpr int kStageBatch = 4;

// In[c][PLANE] of a tile with a HALO border: region = the tile and HALF
// pixels around it. out[k][c][.] = f(c0, pix, h, w).v[k] for the four
// channels c0.. of an item at pixels in the image (pix = n H W + h W + w),
// 0 elsewhere in the region. Items are (channel group, pixel), pixels
// fastest.
template <int TILE, int HALO, int HALF, int NOUT, typename F>
__device__ __forceinline__ void stage_region(float* const (&out)[NOUT],
                                             int Cs, const TileGeom& tg,
                                             int H, int W, F f) {
  constexpr int RW = TILE + 2 * HALF, NQ = RW * RW;
  constexpr int PWID = TILE + 2 * HALO, PLANE = PWID * PWID;
  const int items = (Cs + 3) / 4 * NQ;
  for (int base = threadIdx.x; base < items;
       base += kStageBatch * kNodeThreads) {
    Vals<NOUT> v[kStageBatch];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int it = base + k * kNodeThreads;
      const int c0 = it / NQ * 4, q = it % NQ;
      const int h = tg.h0 + q / RW - HALF, w = tg.w0 + q % RW - HALF;
#pragma unroll
      for (int o = 0; o < NOUT; ++o) v[k].v[o] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (it < items && h >= 0 && h < H && w >= 0 && w < W)
        v[k] = f(c0, tg.pixbase + (long long)h * W + w, h, w);
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int it = base + k * kNodeThreads;
      if (it >= items) break;
      const int c0 = it / NQ * 4, q = it % NQ;
      const int at = c0 * PLANE + (q / RW - HALF + HALO) * PWID + q % RW -
                     HALF + HALO;
#pragma unroll
      for (int o = 0; o < NOUT; ++o)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < Cs) out[o][at + j * PLANE] = get4(v[k].v[o], j);
    }
  }
}

// One output: f returns a float4.
template <int TILE, int HALO, int HALF, typename F>
__device__ __forceinline__ void stage_region(float* out, int Cs,
                                             const TileGeom& tg, int H, int W,
                                             F f) {
  float* const outs[1] = {out};
  stage_region<TILE, HALO, HALF, 1>(
      outs, Cs, tg, H, W, [&](int c0, long long pix, int h, int w) {
        return Vals<1>{{f(c0, pix, h, w)}};
      });
}

// dts[ci][q] = sum over co of pw[ci][co] dbuf[co][q] over the region (the
// tile and HALF pixels around it); four input channels an item.
template <int TILE, int HALO, int HALF>
__device__ __forceinline__ void pointwise_t(const float* dbuf,
                                            const float* pw, float* dts,
                                            int Cs) {
  constexpr int RW = TILE + 2 * HALF, NQ = RW * RW;
  constexpr int PWID = TILE + 2 * HALO, PLANE = PWID * PWID;
  const int groups = (Cs + 3) / 4;
  for (int it = threadIdx.x; it < groups * NQ; it += blockDim.x) {
    const int c0 = it / NQ * 4, q = it % NQ;
    const int at = (q / RW - HALF + HALO) * PWID + q % RW - HALF + HALO;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = pw + (c0 + j < Cs ? c0 + j : c0) * Cs;
    for (int co = 0; co < Cs; ++co) {
      const float dv = dbuf[co * PLANE + at];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(w[j][co], dv, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < Cs) dts[(c0 + j) * PLANE + at] = acc[j];
  }
}

// Where a stage's backward sends its input gradient: X adds it to dx where
// x > 0; S writes dz where xhat > 0 as an fp32 plane and sums dz, dz xhat.
struct StageOut {
  float* dxs;             // X: [Cs][PIX] dx of the tile
  const float* xh;        // S: [Cs][PIX] xhat of the tile
  float* dzp;             // S: the plane of channel 0, channel stride M
  float* part_s;          // S: (c * 2 + k) * nblk, offset to this block
  long long M;
};

// One depthwise + pointwise stage backwards for one tile, after pointwise_t:
//   in_s [Cs][PLANE] the stage's input (RELU: max(., 0) on read), dbuf and
//   dts [Cs][PLANE] d of the stage's output and dt = pw^T d; dws [25][Cs].
// A warp takes one channel (Cs >= 8) or 8 / Cs warps take one (Cs < 8, one
// round); a lane takes R pixels of a column, rows r0 + o DIL. d dw of tap t
// goes to part_dw[(t * Cs + c) * nblk], d pw to part_pw[(c * Cs + co) *
// nblk], both offset to (edge, kidx, block). CB: the largest Cs of the tile.
template <int KK, int DIL, int TILE, int HALO, int R, int CB, bool X>
__device__ __forceinline__ void stage_bwd(const float* in_s,
                                          const float* dbuf,
                                          const float* dts, const float* dws,
                                          const StageOut& so, float* red,
                                          float* part_dw, float* part_pw,
                                          long long nblk, const TileGeom& tg,
                                          int H, int W, int Cs) {
  constexpr int PWID = TILE + 2 * HALO, PLANE = PWID * PWID;
  constexpr int PIX = TILE * TILE, GROUPS = PIX / R;
  constexpr int HALF = (KK - 1) / 2 * DIL, NT = KK * KK;
  constexpr int NV = NT + (CB < 4 ? CB : 4) + 2;  // values a warp hands over
  static_assert(TILE % (DIL * R) == 0 && HALF <= HALO, "rows, reach");
  static_assert(NV * kNodeWarps <= kRedFloats || CB > 4, "red");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpc = Cs >= kNodeWarps ? 1 : kNodeWarps / Cs;
  const int grp = warp / wpc, sub = warp % wpc;
  for (int c = grp; c < Cs; c += kNodeWarps / wpc) {
    float w[NT], ddw[NT], dpw[CB];
    float bs = 0.f, bq = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      w[t] = dws[t * Cs + c];
      ddw[t] = 0.f;
    }
#pragma unroll
    for (int co = 0; co < CB; ++co) dpw[co] = 0.f;
    for (int gi = sub * 32 + lane; gi < GROUPS; gi += wpc * 32) {
      const int kr = gi / TILE, col = gi % TILE;
      const int r0 = DIL == 1 ? R * kr : (kr / 2) * 2 * R + (kr % 2);
      const int top = c * PLANE + (r0 + HALO - HALF) * PWID + col + HALO - HALF;
      float dtc[R], t[R], din[R];
#pragma unroll
      for (int o = 0; o < R; ++o) {
        dtc[o] = dts[c * PLANE + (r0 + o * DIL + HALO) * PWID + col + HALO];
        t[o] = din[o] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < KK + R - 1; ++i) {
        float v[KK], u[KK];
#pragma unroll
        for (int dx = 0; dx < KK; ++dx) {
          v[dx] = in_s[top + i * DIL * PWID + dx * DIL];
          if constexpr (X) v[dx] = fmaxf(v[dx], 0.f);
          u[dx] = dts[top + i * DIL * PWID + dx * DIL];
        }
#pragma unroll
        for (int o = 0; o < R; ++o) {
          const int ky = i - o;
          if (ky < 0 || ky >= KK) continue;
#pragma unroll
          for (int dx = 0; dx < KK; ++dx) {
            t[o] = fmaf(v[dx], w[ky * KK + dx], t[o]);
            ddw[ky * KK + dx] = fmaf(v[dx], dtc[o], ddw[ky * KK + dx]);
            din[o] = fmaf(w[(KK - 1 - ky) * KK + KK - 1 - dx], u[dx], din[o]);
          }
        }
      }
#pragma unroll
      for (int o = 0; o < R; ++o) {
        const int r = r0 + o * DIL;
        const int at = (r + HALO) * PWID + col + HALO;
#pragma unroll
        for (int co = 0; co < CB; ++co)
          if (co < Cs) dpw[co] = fmaf(t[o], dbuf[co * PLANE + at], dpw[co]);
        const int p = r * TILE + col;
        if constexpr (X) {
          if (in_s[c * PLANE + at] > 0.f) so.dxs[c * PIX + p] += din[o];
        } else {
          const float xhat = so.xh[c * PIX + p];
          const float dz = xhat > 0.f ? din[o] : 0.f;
          const int h = tg.h0 + r, wc = tg.w0 + col;
          if (h < H && wc < W)
            so.dzp[c * so.M + tg.pixbase + (long long)h * W + wc] = dz;
          bs += dz;
          bq = fmaf(dz, xhat, bq);
        }
      }
    }
    // per warp, then (Cs < 8) over the channel's warps in order
#pragma unroll
    for (int k = 0; k < NT; ++k) ddw[k] = warp_sum(ddw[k]);
#pragma unroll
    for (int co = 0; co < CB; ++co)
      if (co < Cs) dpw[co] = warp_sum(dpw[co]);
    if constexpr (!X) {
      bs = warp_sum(bs);
      bq = warp_sum(bq);
    }
    if (lane == 0) {
      if (wpc == 1) {
#pragma unroll
        for (int k = 0; k < NT; ++k) part_dw[(k * Cs + c) * nblk] = ddw[k];
#pragma unroll
        for (int co = 0; co < CB; ++co)
          if (co < Cs) part_pw[(c * Cs + co) * nblk] = dpw[co];
        if constexpr (!X) {
          so.part_s[(c * 2) * nblk] = bs;
          so.part_s[(c * 2 + 1) * nblk] = bq;
        }
      } else if constexpr (CB <= 4) {
        float* rw = red + warp * NV;
#pragma unroll
        for (int k = 0; k < NT; ++k) rw[k] = ddw[k];
#pragma unroll
        for (int co = 0; co < CB; ++co)
          if (co < Cs) rw[NT + co] = dpw[co];
        rw[NV - 2] = bs;
        rw[NV - 1] = bq;
      }
    }
  }
  if constexpr (CB <= 4) {
    if (wpc > 1) {  // Cs <= 4: one round, channel c on warps c wpc ..
      __syncthreads();
      for (int i = threadIdx.x; i < Cs * NV; i += blockDim.x) {
        const int c = i / NV, k = i % NV;
        float v = 0.f;
        for (int s = 0; s < wpc; ++s) v += red[(c * wpc + s) * NV + k];
        if (k < NT)
          part_dw[(k * Cs + c) * nblk] = v;
        else if (k < NT + Cs)
          part_pw[(c * Cs + k - NT) * nblk] = v;
        else if (!X && k >= NV - 2)
          so.part_s[(c * 2 + k - (NV - 2)) * nblk] = v;
      }
    }
  }
}

template <int TILE>
__host__ __device__ constexpr int rows_per_thread() {
  return TILE >= 16 ? 4 : 2;  // a warp's 32 items in one channel
}

template <int TILE>
__host__ __device__ constexpr int max_cs() {
  return TILE == 32 ? 4 : (TILE == 16 ? 16 : kMaxCs);
}

// pw in shared memory beside the planes where it fits (tiles of 16, 32)
template <int TILE>
__host__ __device__ constexpr bool pw_shared() {
  return TILE >= 16;
}

template <int TILE, int HALO>
constexpr size_t bwd_smem_floats(int Cs) {
  return (size_t)3 * Cs * (TILE + 2 * HALO) * (TILE + 2 * HALO)  // in, d, dt
         + (size_t)Cs * TILE * TILE          // dx (X) or xhat (S)
         + (size_t)kTaps * Cs                // dws
         + (pw_shared<TILE>() ? (size_t)Cs * Cs : 0)
         + kRedFloats + kNodeWarps;
}

// Data-parallel mode, before S: the coefficients from R's global sums
// [E, Cs, kRSums] of `count` pixels. grid (E).
__global__ void __launch_bounds__(kNodeThreads)
    node_bwd_coef_kernel(const float* __restrict__ sums,
                         const float* __restrict__ stat,
                         const float* __restrict__ weights,
                         float* __restrict__ fc, float* __restrict__ gbar,
                         int E, int Cs, float inv_count) {
  const int e = blockIdx.x;
  fold_coefs(sums + (size_t)e * Cs * kRSums, stat, weights, fc, gbar, e, E,
             Cs, inv_count);
}

// Data-parallel mode, before X: the means of dz and dz xhat from S's global
// sums ([2, E, Cs, 2], laid out as mstat).
__global__ void __launch_bounds__(kNodeThreads)
    node_bwd_mean_kernel(const float* __restrict__ sums,
                         float* __restrict__ mstat, int n, float inv_count) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    mstat[i] = sums[i] * inv_count;
}

// Launch S. grid (tiles, N, 2 E): z = 2 e + which (0: sep3, 1: sep5).
template <typename T, int TILE, int KK>
__device__ __forceinline__ void sep2_branch(
    const NodeEdge& ed, const float* g, const T* obuf, const float* stat,
    const float* fc, const float* gbar, float* dzp, float* part_s,
    float* part_dw, float* part_pw, float* smem, int e, int which, int E,
    int H, int W, int Cs, bool vec_g) {
  constexpr int HALO = 2, HALF = (KK - 1) / 2;
  constexpr int PLANE = (TILE + 2 * HALO) * (TILE + 2 * HALO);
  constexpr int PIX = TILE * TILE;
  float* zs = smem;                 // [Cs][PLANE] round_T(relu(xhat))
  float* dbuf = zs + Cs * PLANE;    // [Cs][PLANE] d o2
  float* dts = dbuf + Cs * PLANE;   // [Cs][PLANE] pw^T d o2
  float* xh = dts + Cs * PLANE;     // [Cs][PIX] xhat of the tile
  float* dws = xh + Cs * PIX;       // [25][Cs]
  float* pws = dws + kTaps * Cs;    // [Cs][Cs] (pw_shared)
  float* red = pws + (pw_shared<TILE>() ? Cs * Cs : 0);
  const TileGeom tg = tile_geom<TILE>(H, W);
  const long long M = (long long)gridDim.y * H * W;
  const size_t mid = ((size_t)which * E + e) * Cs;  // slot 0 or 1
  const size_t o2 = ((size_t)(kFirstFoldSlot + which) * E + e) * Cs;
  const int kidx = 2 * which + 1;
  const float* fcw = fc + mid * 3;  // fold slot `which`: sep3 0, sep5 1

  // one pass over the region (0 outside the image): xhat into zs, d o2
  // into dbuf; then xh = xhat on the tile and z = round_T(relu(xhat))
  float* const outs[2] = {zs, dbuf};
  stage_region<TILE, HALO, HALF, 2>(outs, Cs, tg, H, W, [&](int c0,
                                                            long long pix,
                                                            int, int) {
    const float4 gv = load_g4(g, pix, Cs, c0, vec_g);
    Vals<2> r;
    float z[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < Cs) {
        const size_t c = mid + c0 + j;
        z[j] = (to_f32(obuf[c * M + pix]) - stat[c * 2]) * stat[c * 2 + 1];
        d[j] = fold_grad(fcw + (c0 + j) * 3, get4(gv, j),
                         gbar[e * Cs + c0 + j],
                         to_f32(obuf[(o2 + c0 + j) * M + pix]));
      }
    r.v[0] = make_float4(z[0], z[1], z[2], z[3]);
    r.v[1] = make_float4(d[0], d[1], d[2], d[3]);
    return r;
  });
  for (int i = threadIdx.x; i < kTaps * Cs; i += blockDim.x)
    dws[i] = ed.dw[(size_t)kidx * kTaps * Cs + i];
  const float* pw = ed.pw + (size_t)kidx * Cs * Cs;
  if (pw_shared<TILE>()) {
    for (int i = threadIdx.x; i < Cs * Cs; i += blockDim.x) pws[i] = pw[i];
    pw = pws;
  }
  __syncthreads();
  {
    constexpr int RW = TILE + 2 * HALF, NQ = RW * RW;
    constexpr int PWID = TILE + 2 * HALO;
    for (int it = threadIdx.x; it < Cs * NQ; it += blockDim.x) {
      const int c = it / NQ, q = it % NQ;
      const int y = q / RW - HALF, x = q % RW - HALF;
      float* zp = zs + c * PLANE + (y + HALO) * PWID + x + HALO;
      const float xhat = *zp;
      if (y >= 0 && y < TILE && x >= 0 && x < TILE)
        xh[c * PIX + y * TILE + x] = xhat;
      *zp = round_to<T>(fmaxf(xhat, 0.f));
    }
  }
  __syncthreads();
  pointwise_t<TILE, HALO, HALF>(dbuf, pw, dts, Cs);
  __syncthreads();
  const StageOut so{nullptr, xh, dzp + mid * M, part_s + mid * 2 * tg.nblk +
                    tg.blk, M};
  const size_t wrow = (size_t)e * 8 + kidx;
  stage_bwd<KK, 1, TILE, HALO, rows_per_thread<TILE>(), max_cs<TILE>(), false>(
      zs, dbuf, dts, dws, so, red,
      part_dw + wrow * kTaps * Cs * tg.nblk + tg.blk,
      part_pw + wrow * Cs * Cs * tg.nblk + tg.blk, tg.nblk, tg, H, W, Cs);
}

// Two blocks an SM where the planes of two fit (tiles of 16, 32): at most
// 128 registers a thread.
template <int TILE>
__host__ __device__ constexpr int bwd_min_blocks() {
  return TILE >= 16 ? 2 : 1;
}

// With `sums_out` (data-parallel mode) the edge's last block writes the sums
// of dz and dz xhat there in place of their means.
template <typename T, int TILE>
__global__ void __launch_bounds__(kNodeThreads, bwd_min_blocks<TILE>())
    node_bwd_s_kernel(NodeArgs args, const float* __restrict__ g,
                      const T* __restrict__ obuf,
                      const float* __restrict__ stat,
                      const float* __restrict__ fc,
                      const float* __restrict__ gbar, float* __restrict__ dzp,
                      float* part_s, float* __restrict__ part_dw,
                      float* __restrict__ part_pw, float* __restrict__ mstat,
                      float* __restrict__ sums_out, unsigned* ctr, int E,
                      int H, int W, int Cs, int vec_g) {
  extern __shared__ __align__(16) float smem[];
  const int e = blockIdx.z / 2, which = blockIdx.z % 2;
  const NodeEdge ed = args.edge[e];
  if (which)
    sep2_branch<T, TILE, 5>(ed, g, obuf, stat, fc, gbar, dzp, part_s,
                            part_dw, part_pw, smem, e, which, E, H, W, Cs,
                            vec_g);
  else
    sep2_branch<T, TILE, 3>(ed, g, obuf, stat, fc, gbar, dzp, part_s,
                            part_dw, part_pw, smem, e, which, E, H, W, Cs,
                            vec_g);
  // the edge's blocks of both sep convs count on one counter
  const long long nblk = (long long)gridDim.y * gridDim.x;
  if (!count_done(ctr + e, 2u * (unsigned)nblk)) return;
  const float inv_count = 1.f / (float)((long long)gridDim.y * H * W);
  // entries (which, c, k) of edge e: rows ((which E + e) Cs + c) 2 + k
  sum_entries(
      part_s, nblk, 4 * Cs,
      [&](int i) {
        const int which2 = i / (2 * Cs), rest = i % (2 * Cs);
        return (((long long)which2 * E + e) * Cs) * 2 + rest;
      },
      [&](int i, float v) {
        const int which2 = i / (2 * Cs), rest = i % (2 * Cs);
        const size_t at = (((size_t)which2 * E + e) * Cs) * 2 + rest;
        if (sums_out != nullptr)
          sums_out[at] = v;  // data-parallel mode: this rank's sums
        else
          mstat[at] = v * inv_count;
      });
}

// Launch X. grid (tiles, N, E).
template <typename T, int TILE>
__global__ void __launch_bounds__(kNodeThreads, bwd_min_blocks<TILE>())
    node_bwd_x_kernel(NodeArgs args, T* __restrict__ dx,
                      const float* __restrict__ weights,
                      const float* __restrict__ g,
                      const T* __restrict__ obuf,
                      const float* __restrict__ stat,
                      const float* __restrict__ fc,
                      const float* __restrict__ gbar,
                      const float* __restrict__ dzp,
                      const float* __restrict__ mstat, float* part_dw,
                      float* part_pw, float* part_skip,
                      float* __restrict__ ddw, float* __restrict__ dpw,
                      float* __restrict__ dwt, unsigned* ctr, int E, int H,
                      int W, int Cs, int vec_x, int vec_g) {
  constexpr int HALO = 4;
  constexpr int PWID = TILE + 2 * HALO, PLANE = PWID * PWID;
  constexpr int PIX = TILE * TILE;
  constexpr int R = rows_per_thread<TILE>(), CB = max_cs<TILE>();
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                // [Cs][PLANE] raw x, 0 outside the image
  float* dbuf = xs + Cs * PLANE;   // [Cs][PLANE]
  float* dts = dbuf + Cs * PLANE;  // [Cs][PLANE]
  float* dxs = dts + Cs * PLANE;   // [Cs][PIX] dx of this tile
  float* dws = dxs + Cs * PIX;     // [25][Cs]
  float* pws = dws + kTaps * Cs;   // [Cs][Cs] (pw_shared)
  float* red = pws + (pw_shared<TILE>() ? Cs * Cs : 0);
  float* red8 = red + kRedFloats;  // [8]
  const int e = blockIdx.z;
  const NodeEdge ed = args.edge[e];
  const TileGeom tg = tile_geom<TILE>(H, W);
  const long long M = (long long)gridDim.y * H * W;
  const T* x = (const T*)ed.x + (long long)tg.n * ed.sn;

  // the halo tile, four channels of a pixel in one load where aligned
  {
    const int groups = vec_x ? Cs / 4 : Cs, per = vec_x ? 4 : 1;
    const int items = PLANE * groups;
    for (int base = threadIdx.x; base < items;
         base += kStageBatch * kNodeThreads) {
      float4 v[kStageBatch];
#pragma unroll
      for (int k = 0; k < kStageBatch; ++k) {
        const int i = base + k * kNodeThreads;
        const int q = i / groups, cg = i % groups;
        const int h = tg.h0 + q / PWID - HALO, w = tg.w0 + q % PWID - HALO;
        v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < items && h >= 0 && h < H && w >= 0 && w < W) {
          const T* src = x + (long long)h * ed.sh + (long long)w * ed.sw +
                         cg * per;
          v[k] = vec_x ? ld4f(src) : make_float4(to_f32(*src), 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int k = 0; k < kStageBatch; ++k) {
        const int i = base + k * kNodeThreads;
        if (i >= items) break;
        const int q = i / groups, cg = i % groups;
        for (int j = 0; j < per; ++j)
          xs[(cg * per + j) * PLANE + q] = get4(v[k], j);
      }
    }
  }
  __syncthreads();

  // skip: dx = w[e, skip] g, and this block's part of sum g x
  {
    const float wskip = weights[e * 8 + kSkipOp];
    const int groups = (Cs + 3) / 4;
    float acc = 0.f;
    for (int it = threadIdx.x; it < groups * PIX; it += blockDim.x) {
      const int c0 = it / PIX * 4, p = it % PIX;
      const int h = tg.h0 + p / TILE, w = tg.w0 + p % TILE;
      float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (h < H && w < W)
        gv = load_g4(g, tg.pixbase + (long long)h * W + w, Cs, c0, vec_g);
      const int at = (p / TILE + HALO) * PWID + p % TILE + HALO;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + j >= Cs) break;
        dxs[(c0 + j) * PIX + p] = wskip * get4(gv, j);
        acc = fmaf(get4(gv, j), xs[(c0 + j) * PLANE + at], acc);
      }
    }
    acc = warp_sum(acc);
    if ((threadIdx.x & 31) == 0) red8[threadIdx.x >> 5] = acc;
  }

  // the four conv branches' first stage: sep3, sep5, dil3, dil5
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int kidx = 2 * b;
    __syncthreads();  // the previous branch is done with dbuf, dts, dws
    auto sep_d = [&](int c0, long long pix, int, int) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + j >= Cs) break;
        const size_t mid = ((size_t)b * E + e) * Cs + c0 + j;
        const float rstd = stat[mid * 2 + 1];
        const float xhat =
            (to_f32(obuf[mid * M + pix]) - stat[mid * 2]) * rstd;
        v[j] = rstd * (dzp[mid * M + pix] - mstat[mid * 2] -
                       xhat * mstat[mid * 2 + 1]);
      }
      return make_float4(v[0], v[1], v[2], v[3]);
    };
    auto dil_d = [&](int c0, long long pix, int, int) {
      const float4 gv = load_g4(g, pix, Cs, c0, vec_g);
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + j >= Cs) break;
        const size_t c = ((size_t)b * E + e) * Cs + c0 + j;  // fold slot b
        const size_t plane = ((size_t)(kFirstFoldSlot + b) * E + e) * Cs +
                             c0 + j;
        v[j] = fold_grad(fc + c * 3, get4(gv, j), gbar[e * Cs + c0 + j],
                         to_f32(obuf[plane * M + pix]));
      }
      return make_float4(v[0], v[1], v[2], v[3]);
    };
    if (b == 0) stage_region<TILE, HALO, 1>(dbuf, Cs, tg, H, W, sep_d);
    if (b == 1) stage_region<TILE, HALO, 2>(dbuf, Cs, tg, H, W, sep_d);
    if (b == 2) stage_region<TILE, HALO, 2>(dbuf, Cs, tg, H, W, dil_d);
    if (b == 3) stage_region<TILE, HALO, 4>(dbuf, Cs, tg, H, W, dil_d);
    for (int i = threadIdx.x; i < kTaps * Cs; i += blockDim.x)
      dws[i] = ed.dw[(size_t)kidx * kTaps * Cs + i];
    const float* pw = ed.pw + (size_t)kidx * Cs * Cs;
    if (pw_shared<TILE>()) {
      for (int i = threadIdx.x; i < Cs * Cs; i += blockDim.x) pws[i] = pw[i];
      pw = pws;
    }
    __syncthreads();
    if (b == 0) pointwise_t<TILE, HALO, 1>(dbuf, pw, dts, Cs);
    if (b == 1) pointwise_t<TILE, HALO, 2>(dbuf, pw, dts, Cs);
    if (b == 2) pointwise_t<TILE, HALO, 2>(dbuf, pw, dts, Cs);
    if (b == 3) pointwise_t<TILE, HALO, 4>(dbuf, pw, dts, Cs);
    __syncthreads();
    const StageOut so{dxs, nullptr, nullptr, nullptr, M};
    const size_t wrow = (size_t)e * 8 + kidx;
    float* pdw = part_dw + wrow * kTaps * Cs * tg.nblk + tg.blk;
    float* ppw = part_pw + wrow * Cs * Cs * tg.nblk + tg.blk;
    if (b == 0)
      stage_bwd<3, 1, TILE, HALO, R, CB, true>(xs, dbuf, dts, dws, so, red,
                                               pdw, ppw, tg.nblk, tg, H, W,
                                               Cs);
    if (b == 1)
      stage_bwd<5, 1, TILE, HALO, R, CB, true>(xs, dbuf, dts, dws, so, red,
                                               pdw, ppw, tg.nblk, tg, H, W,
                                               Cs);
    if (b == 2)
      stage_bwd<3, 2, TILE, HALO, R, CB, true>(xs, dbuf, dts, dws, so, red,
                                               pdw, ppw, tg.nblk, tg, H, W,
                                               Cs);
    if (b == 3)
      stage_bwd<5, 2, TILE, HALO, R, CB, true>(xs, dbuf, dts, dws, so, red,
                                               pdw, ppw, tg.nblk, tg, H, W,
                                               Cs);
  }

  // max pool (fold slot 4, plane 6) and avg pool (fold slot 5, plane 7): d
  // of both over the tile and one pixel around it in one pass (max into
  // dbuf, avg over its window's count into dts), then per tile pixel the
  // windows that reach it: avg's, then max's. A max window's gradient goes
  // to its first maximal tap in row-major order among the taps in the
  // image: its index (0..8, -1 outside the image) is found once per window,
  // into dts.
  __syncthreads();
  {
    float* const outs[2] = {dbuf, dts};
    stage_region<TILE, HALO, 1, 2>(outs, Cs, tg, H, W, [&](int c0,
                                                          long long pix,
                                                          int h, int w) {
      const float4 gv = load_g4(g, pix, Cs, c0, vec_g);
      const float count = (float)((1 + (h > 0) + (h < H - 1)) *
                                  (1 + (w > 0) + (w < W - 1)));
      float d[2][4] = {};
#pragma unroll
      for (int k = 0; k < 2; ++k)  // fold slots 4 (max) and 5 (avg)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < Cs) {
            const size_t c = ((size_t)(4 + k) * E + e) * Cs + c0 + j;
            const size_t plane =
                ((size_t)(kFirstFoldSlot + 4 + k) * E + e) * Cs + c0 + j;
            d[k][j] = fold_grad(fc + c * 3, get4(gv, j), gbar[e * Cs + c0 + j],
                                to_f32(obuf[plane * M + pix]));
          }
      Vals<2> r;
      r.v[0] = make_float4(d[0][0], d[0][1], d[0][2], d[0][3]);
      r.v[1] = make_float4(d[1][0] / count, d[1][1] / count, d[1][2] / count,
                           d[1][3] / count);
      return r;
    });
  }
  __syncthreads();
  for (int it = threadIdx.x; it < Cs * PIX; it += blockDim.x) {
    const int c = it / PIX, p = it % PIX;
    const int at = c * PLANE + (p / TILE + HALO) * PWID + p % TILE + HALO;
    float acc = 0.f;
#pragma unroll
    for (int qy = -1; qy <= 1; ++qy)
#pragma unroll
      for (int qx = -1; qx <= 1; ++qx) acc += dts[at + qy * PWID + qx];
    dxs[it] += acc;
  }
  __syncthreads();
  {
    constexpr int RW = TILE + 2, NQ = RW * RW;
    for (int it = threadIdx.x; it < Cs * NQ; it += blockDim.x) {
      const int c = it / NQ, q = it % NQ;
      const int y = q / RW - 1, x = q % RW - 1;
      const int h = tg.h0 + y, w = tg.w0 + x;
      const int at = c * PLANE + (y + HALO) * PWID + x + HALO;
      int arg = -1;
      if (h >= 0 && h < H && w >= 0 && w < W) {
        float best = 0.f;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int ty = t / 3 - 1, tx = t % 3 - 1;
          if (h + ty < 0 || h + ty >= H || w + tx < 0 || w + tx >= W) continue;
          const float v = xs[at + ty * PWID + tx];
          if (arg < 0 || v > best) best = v, arg = t;
        }
      }
      dts[at] = (float)arg;
    }
  }
  __syncthreads();
  for (int it = threadIdx.x; it < Cs * PIX; it += blockDim.x) {
    const int c = it / PIX, p = it % PIX;
    const int at = c * PLANE + (p / TILE + HALO) * PWID + p % TILE + HALO;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {  // window q = p - (tap t's offset)
      const int q = at - (t / 3 - 1) * PWID - (t % 3 - 1);
      if (dts[q] == (float)t) acc += dbuf[q];
    }
    dxs[it] += acc;
  }
  __syncthreads();

  // dx of the tile, four channels of a pixel in one store where aligned
  {
    T* dxe = dx + (size_t)e * M * Cs;
    const int groups = (Cs + 3) / 4;
    for (int it = threadIdx.x; it < groups * PIX; it += blockDim.x) {
      const int c0 = it / PIX * 4, p = it % PIX;
      const int h = tg.h0 + p / TILE, w = tg.w0 + p % TILE;
      if (h >= H || w >= W) continue;
      T* dst = dxe + (tg.pixbase + (long long)h * W + w) * Cs + c0;
      if (vec_g) {  // Cs % 4 == 0
        st4(dst, make_float4(dxs[c0 * PIX + p], dxs[(c0 + 1) * PIX + p],
                             dxs[(c0 + 2) * PIX + p],
                             dxs[(c0 + 3) * PIX + p]));
      } else {
        #pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < Cs)
          dst[j] = from_f32<T>(dxs[(c0 + j) * PIX + p]);
      }
    }
    if (threadIdx.x == 0) {
      float v = 0.f;
      for (int w = 0; w < kNodeWarps; ++w) v += red8[w];
      part_skip[(long long)e * tg.nblk + tg.blk] = v;
    }
  }
  if (!count_done(ctr + e, (unsigned)tg.nblk)) return;

  // the edge's last block: d dw, d pw and d w[skip], each the sum over the
  // blocks; rows 5 and 7 and the taps past a 3 x 3 window are 0
  const long long nblk = tg.nblk;
  const int n_dw = 8 * kTaps * Cs, n_pw = 8 * Cs * Cs;
  float* ddw_e = ddw + (size_t)e * n_dw;
  float* dpw_e = dpw + (size_t)e * n_pw;
  for (int i = threadIdx.x; i < n_dw + n_pw; i += blockDim.x) {
    const int kidx = i < n_dw ? i / (kTaps * Cs) : (i - n_dw) / (Cs * Cs);
    const int kk = (kidx >> 1) & 1 ? 5 : 3;
    if (kidx == 5 || kidx == 7)
      (i < n_dw ? ddw_e[i] : dpw_e[i - n_dw]) = 0.f;
    else if (i < n_dw && i / Cs % kTaps >= kk * kk)
      ddw_e[i] = 0.f;
  }
  // the used (row, tap) pairs in order, then the used pw rows
  constexpr int kUsedTaps = 9 + 9 + 25 + 25 + 9 + 25;
  auto used_row = [](int u) { return u < 4 ? u : (u == 4 ? 4 : 6); };
  auto dw_entry = [&](int i) {
    int t = i / Cs, u = 0;
    while (t >= (((used_row(u) >> 1) & 1) ? 25 : 9)) {
      t -= ((used_row(u) >> 1) & 1) ? 25 : 9;
      ++u;
    }
    return (used_row(u) * kTaps + t) * Cs + i % Cs;
  };
  sum_entries(
      part_dw + (size_t)e * n_dw * nblk, nblk, kUsedTaps * Cs,
      [&](int i) { return (long long)dw_entry(i); },
      [&](int i, float v) { ddw_e[dw_entry(i)] = v; });
  sum_entries(
      part_pw + (size_t)e * n_pw * nblk, nblk, 6 * Cs * Cs,
      [&](int i) {
        return (long long)used_row(i / (Cs * Cs)) * Cs * Cs + i % (Cs * Cs);
      },
      [&](int i, float v) {
        dpw_e[used_row(i / (Cs * Cs)) * Cs * Cs + i % (Cs * Cs)] = v;
      });
  sum_entries(
      part_skip + (size_t)e * nblk, nblk, 1, [](int) { return 0LL; },
      [&](int, float v) { dwt[e * 8 + kSkipOp] = v; });
}

// Edge of the square pixel tile of one block of the backward's launches S
// and X: the forward's.
inline int bwd_tile(int Cs) { return fwd_tile(Cs); }

// The backward's block count per edge of S and X, its scratch layout, its
// counters (E each for R, S and X) and whether g (and dx) load four
// channels at once.
template <int TILE>
struct BwdPlan {
  int tiles;
  long long nblk, M, nchunk;
  BwdScratch b;
  unsigned* ctr;
  int vec_g;
  BwdPlan(float* scratch, const float* g, const void* dx, size_t elem, int E,
          int N, int H, int W, int Cs) {
    tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
    nblk = (long long)N * tiles;
    M = (long long)N * H * W;
    nchunk = (M + kChunk - 1) / kChunk;
    b = bwd_scratch(E, M, nblk, Cs);
    ctr = reinterpret_cast<unsigned*>(scratch + b.ctr);
    vec_g = Cs % 4 == 0 && (uintptr_t)g % 16 == 0 &&
            (dx == nullptr || (uintptr_t)dx % (4 * elem) == 0);
  }
};

template <typename T, int TILE>
cudaError_t launch_bwd_r(const BwdPlan<TILE>& p, const float* g,
                         const T* obuf, const float* stat,
                         const float* weights, float* scratch, float* sums,
                         float* dwt, int E, int Cs, cudaStream_t s) {
  node_bwd_r_kernel<T>
      <<<dim3((unsigned)p.nchunk, E * ((Cs + 3) / 4)), kNodeThreads, 0, s>>>(
      g, obuf, stat, weights, scratch + p.b.part_r, scratch + p.b.fc,
      scratch + p.b.gbar, sums, dwt, p.ctr, E, p.M, Cs, p.vec_g);
  return cudaGetLastError();
}

template <typename T, int TILE>
cudaError_t launch_bwd_s(const BwdPlan<TILE>& p, const NodeArgs& args,
                         const float* g, const T* obuf, const float* stat,
                         float* scratch, float* sums, int E, int N, int H,
                         int W, int Cs, cudaStream_t s) {
  const size_t smem = bwd_smem_floats<TILE, 2>(Cs) * sizeof(float);
  const cudaError_t rc = allow_smem(node_bwd_s_kernel<T, TILE>, smem);
  if (rc != cudaSuccess) return rc;
  node_bwd_s_kernel<T, TILE>
      <<<dim3(p.tiles, N, 2 * E), kNodeThreads, smem, s>>>(
          args, g, obuf, stat, scratch + p.b.fc, scratch + p.b.gbar,
          scratch + p.b.dzp, scratch + p.b.part_s, scratch + p.b.part_dw,
          scratch + p.b.part_pw, scratch + p.b.mstat, sums, p.ctr + E, E, H,
          W, Cs, p.vec_g);
  return cudaGetLastError();
}

template <typename T, int TILE>
cudaError_t launch_bwd_x(const BwdPlan<TILE>& p, const NodeArgs& args, T* dx,
                         const float* weights, const float* g, const T* obuf,
                         const float* stat, float* scratch, float* ddw,
                         float* dpw, float* dwt, int E, int N, int H, int W,
                         int Cs, cudaStream_t s) {
  const size_t smem = bwd_smem_floats<TILE, 4>(Cs) * sizeof(float);
  const cudaError_t rc = allow_smem(node_bwd_x_kernel<T, TILE>, smem);
  if (rc != cudaSuccess) return rc;
  const int vec_x = edges_vec4(args, E, Cs, sizeof(T));
  node_bwd_x_kernel<T, TILE><<<dim3(p.tiles, N, E), kNodeThreads, smem, s>>>(
      args, dx, weights, g, obuf, stat, scratch + p.b.fc, scratch + p.b.gbar,
      scratch + p.b.dzp, scratch + p.b.mstat, scratch + p.b.part_dw,
      scratch + p.b.part_pw, scratch + p.b.part_skip, ddw, dpw, dwt,
      p.ctr + 2 * E, E, H, W, Cs, vec_x, p.vec_g);
  return cudaGetLastError();
}

template <typename T, int TILE>
cudaError_t node_bwd(const NodeArgs& args, T* dx, const float* weights,
                     const float* g, const T* obuf, const float* stat,
                     float* scratch, float* ddw, float* dpw, float* dwt,
                     int E, int N, int H, int W, int Cs, cudaStream_t s) {
  const BwdPlan<TILE> p(scratch, g, dx, sizeof(T), E, N, H, W, Cs);
  cudaError_t rc = cudaMemsetAsync(p.ctr, 0, 3 * E * sizeof(unsigned), s);
  if (rc != cudaSuccess) return rc;
  rc = launch_bwd_r<T, TILE>(p, g, obuf, stat, weights, scratch, nullptr,
                             dwt, E, Cs, s);
  if (rc != cudaSuccess) return rc;
  rc = launch_bwd_s<T, TILE>(p, args, g, obuf, stat, scratch, nullptr, E, N,
                             H, W, Cs, s);
  if (rc != cudaSuccess) return rc;
  return launch_bwd_x<T, TILE>(p, args, dx, weights, g, obuf, stat, scratch,
                               ddw, dpw, dwt, E, N, H, W, Cs, s);
}

template <typename T>
cudaError_t node_bwd_tile(const NodeArgs& args, void* dx,
                          const float* weights, const float* g,
                          const void* obuf, const float* stat, float* scratch,
                          float* ddw, float* dpw, float* dwt, int E, int N,
                          int H, int W, int Cs, cudaStream_t s) {
  switch (bwd_tile(Cs)) {
    case 32:
      return node_bwd<T, 32>(args, (T*)dx, weights, g, (const T*)obuf, stat,
                             scratch, ddw, dpw, dwt, E, N, H, W, Cs, s);
    case 16:
      return node_bwd<T, 16>(args, (T*)dx, weights, g, (const T*)obuf, stat,
                             scratch, ddw, dpw, dwt, E, N, H, W, Cs, s);
    default:
      return node_bwd<T, 8>(args, (T*)dx, weights, g, (const T*)obuf, stat,
                            scratch, ddw, dpw, dwt, E, N, H, W, Cs, s);
  }
}

// The data-parallel backward, one entry point a launch (see the top of the
// file). R: zero R's counters, launch R: d w of the folded ops from this
// rank's sums, the sums into `sums` [E, Cs, kRSums].
template <typename T>
cudaError_t node_bwd_sync_r(const float* g, const void* obuf,
                            const float* stat, const float* weights,
                            float* scratch, float* sums, float* dwt, int E,
                            int N, int H, int W, int Cs, cudaStream_t s) {
  return with_tile(Cs, [&](auto tile) {
    constexpr int TILE = decltype(tile)::value;
    const BwdPlan<TILE> p(scratch, g, nullptr, sizeof(T), E, N, H, W, Cs);
    const cudaError_t rc = cudaMemsetAsync(p.ctr, 0, E * sizeof(unsigned), s);
    if (rc != cudaSuccess) return rc;
    return launch_bwd_r<T, TILE>(p, g, (const T*)obuf, stat, weights,
                                 scratch, sums, dwt, E, Cs, s);
  });
}

// S: the folded BatchNorms' coefficients from R's global sums of `count`
// pixels, zero S's counters, launch S: its sums of dz and dz xhat into
// `sums_s` [2, E, Cs, 2].
template <typename T>
cudaError_t node_bwd_sync_s(const NodeArgs& args, const float* g,
                            const void* obuf, const float* stat,
                            const float* weights, float* scratch,
                            const float* sums_r, float* sums_s,
                            long long count, int E, int N, int H, int W,
                            int Cs, cudaStream_t s) {
  return with_tile(Cs, [&](auto tile) {
    constexpr int TILE = decltype(tile)::value;
    const BwdPlan<TILE> p(scratch, g, nullptr, sizeof(T), E, N, H, W, Cs);
    node_bwd_coef_kernel<<<E, kNodeThreads, 0, s>>>(
        sums_r, stat, weights, scratch + p.b.fc, scratch + p.b.gbar, E, Cs,
        1.f / (float)count);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
    rc = cudaMemsetAsync(p.ctr + E, 0, E * sizeof(unsigned), s);
    if (rc != cudaSuccess) return rc;
    return launch_bwd_s<T, TILE>(p, args, g, (const T*)obuf, stat, scratch,
                                 sums_s, E, N, H, W, Cs, s);
  });
}

// X: the means of dz and dz xhat from S's global sums, zero X's counters,
// launch X (dx, d dw, d pw and d w[skip] of this rank's pixels).
template <typename T>
cudaError_t node_bwd_sync_x(const NodeArgs& args, void* dx,
                            const float* weights, const float* g,
                            const void* obuf, const float* stat,
                            float* scratch, const float* sums_s, float* ddw,
                            float* dpw, float* dwt, long long count, int E,
                            int N, int H, int W, int Cs, cudaStream_t s) {
  return with_tile(Cs, [&](auto tile) {
    constexpr int TILE = decltype(tile)::value;
    const BwdPlan<TILE> p(scratch, g, dx, sizeof(T), E, N, H, W, Cs);
    const int n = 4 * E * Cs;
    node_bwd_mean_kernel<<<(n + kNodeThreads - 1) / kNodeThreads,
                           kNodeThreads, 0, s>>>(sums_s, scratch + p.b.mstat,
                                                 n, 1.f / (float)count);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
    rc = cudaMemsetAsync(p.ctr + 2 * E, 0, E * sizeof(unsigned), s);
    if (rc != cudaSuccess) return rc;
    return launch_bwd_x<T, TILE>(p, args, (T*)dx, weights, g, (const T*)obuf,
                                 stat, scratch, ddw, dpw, dwt, E, N, H, W, Cs,
                                 s);
  });
}

}  // namespace
}  // namespace lctvqa

extern "C" {

int lctvqa_mixed_node_max_edges() { return lctvqa::kMaxEdges; }
int lctvqa_mixed_node_max_cs() { return lctvqa::kMaxCs; }
// Edge of the square pixel tile one block of the forward's launch A takes
// at this Cs: it runs N * ceil(H / tile) * ceil(W / tile) blocks per edge,
// and `partial` holds one column per block.
int lctvqa_mixed_node_fwd_tile(int Cs) { return lctvqa::fwd_tile(Cs); }

// args: NodeArgs on the host, its first E edges filled. weights: [E, 8]
// fp32. obuf: scratch [8, E, Cs, N*H*W] in `dtype`. partial: fp32 scratch
// [8, E, Cs, 2, blocks per edge], then 2E unsigned counters (zeroed here).
// stat: fp32 scratch [8, E, Cs, 2]. out: [N, H, W, Cs] fp32. 1 <= E <= 8,
// 1 <= Cs <= 64, N <= 65535.
int lctvqa_mixed_node_fwd(const void* args, const void* weights, void* obuf,
                          void* partial, void* stat, void* out, int E, int N,
                          int H, int W, int Cs, int dtype, void* stream) {
  using namespace lctvqa;
  if (E < 1 || E > kMaxEdges || Cs < 1 || Cs > kMaxCs || N < 1 ||
      N > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const NodeArgs& a = *static_cast<const NodeArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)node_fwd_tile<float>(a, (const float*)weights, obuf,
                                     (float*)partial, (float*)stat,
                                     (float*)out, E, N, H, W, Cs, s);
  if (dtype == kBFloat16)
    return (int)node_fwd_tile<__nv_bfloat16>(
        a, (const float*)weights, obuf, (float*)partial, (float*)stat,
        (float*)out, E, N, H, W, Cs, s);
  return (int)cudaErrorInvalidValue;
}

// Floats of fp32 scratch lctvqa_mixed_node_bwd needs at these sizes (the
// layout is ops/cuda_mixedop.py::node_bwd_scratch's "scratch" part).
long long lctvqa_mixed_node_bwd_scratch(int E, int N, int H, int W, int Cs) {
  using namespace lctvqa;
  const int tile = bwd_tile(Cs);
  const long long nblk =
      (long long)N * ((H + tile - 1) / tile) * ((W + tile - 1) / tile);
  return bwd_scratch(E, (long long)N * H * W, nblk, Cs).total;
}

// args, weights, obuf, stat: as given to and left by lctvqa_mixed_node_fwd on
// the same inputs. g: [N, H, W, Cs] fp32 contiguous. dx: [E, N, H, W, Cs]
// contiguous in `dtype`. scratch: fp32, lctvqa_mixed_node_bwd_scratch
// floats, 16-byte aligned (nothing in it needs zeros: the counters are set
// here). ddw: [E, 8, 25, Cs], dpw: [E, 8, Cs, Cs], dwt: [E, 8] fp32, every
// element written (0 at `none`, at the packed rows 5 and 7 and at the taps
// past a 3 x 3 window).
int lctvqa_mixed_node_bwd(const void* args, void* dx, const void* weights,
                          const void* g, const void* obuf, const void* stat,
                          void* scratch, void* ddw, void* dpw, void* dwt,
                          int E, int N, int H, int W, int Cs, int dtype,
                          void* stream) {
  using namespace lctvqa;
  if (E < 1 || E > kMaxEdges || Cs < 1 || Cs > kMaxCs || N < 1 ||
      N > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const NodeArgs& a = *static_cast<const NodeArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)node_bwd_tile<float>(
        a, dx, (const float*)weights, (const float*)g, obuf,
        (const float*)stat, (float*)scratch, (float*)ddw, (float*)dpw,
        (float*)dwt, E, N, H, W, Cs, s);
  if (dtype == kBFloat16)
    return (int)node_bwd_tile<__nv_bfloat16>(
        a, dx, (const float*)weights, (const float*)g, obuf,
        (const float*)stat, (float*)scratch, (float*)ddw, (float*)dpw,
        (float*)dwt, E, N, H, W, Cs, s);
  return (int)cudaErrorInvalidValue;
}

// The data-parallel mode (the top of the file): the same arguments as
// lctvqa_mixed_node_fwd / _bwd, split over one entry point a launch, with
// `sums` buffers that the caller sums over the ranks between them and
// `count`, the global batch's pixels (N H W times the ranks). Forward
// sums: fp32 [8, E, Cs, 2], A writes its first two slots, B the rest.
// Backward: sums_r fp32 [E, Cs, 7], sums_s fp32 [2, E, Cs, 2]. d w, d dw
// and d pw are this rank's share, taken with the global statistics.
static inline bool node_sizes_ok(int E, int N, int H, int W, int Cs) {
  using namespace lctvqa;
  return E >= 1 && E <= kMaxEdges && Cs >= 1 && Cs <= kMaxCs && N >= 1 &&
         N <= 65535 && H >= 1 && W >= 1;
}

int lctvqa_mixed_node_fwd_sync_a(const void* args, void* obuf, void* partial,
                                 void* sums, int E, int N, int H, int W,
                                 int Cs, int dtype, void* stream) {
  using namespace lctvqa;
  if (!node_sizes_ok(E, N, H, W, Cs)) return (int)cudaErrorInvalidValue;
  const NodeArgs& a = *static_cast<const NodeArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)node_fwd_sync_a<float>(a, obuf, (float*)partial,
                                       (float*)sums, E, N, H, W, Cs, s);
  if (dtype == kBFloat16)
    return (int)node_fwd_sync_a<__nv_bfloat16>(a, obuf, (float*)partial,
                                               (float*)sums, E, N, H, W, Cs,
                                               s);
  return (int)cudaErrorInvalidValue;
}

int lctvqa_mixed_node_fwd_sync_b(const void* args, void* obuf, void* partial,
                                 void* sums, void* stat, long long count,
                                 int E, int N, int H, int W, int Cs,
                                 int dtype, void* stream) {
  using namespace lctvqa;
  if (!node_sizes_ok(E, N, H, W, Cs) || count < 1)
    return (int)cudaErrorInvalidValue;
  const NodeArgs& a = *static_cast<const NodeArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)node_fwd_sync_b<float>(a, obuf, (float*)partial,
                                       (float*)sums, (float*)stat, count, E,
                                       N, H, W, Cs, s);
  if (dtype == kBFloat16)
    return (int)node_fwd_sync_b<__nv_bfloat16>(
        a, obuf, (float*)partial, (float*)sums, (float*)stat, count, E, N, H,
        W, Cs, s);
  return (int)cudaErrorInvalidValue;
}

int lctvqa_mixed_node_fwd_sync_z(const void* args, const void* weights,
                                 const void* obuf, const void* sums,
                                 void* stat, void* out, long long count,
                                 int E, int N, int H, int W, int Cs,
                                 int dtype, void* stream) {
  using namespace lctvqa;
  if (!node_sizes_ok(E, N, H, W, Cs) || count < 1)
    return (int)cudaErrorInvalidValue;
  const NodeArgs& a = *static_cast<const NodeArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)node_fwd_sync_z<float>(a, (const float*)weights, obuf,
                                       (const float*)sums, (float*)stat,
                                       (float*)out, count, E, N, H, W, Cs, s);
  if (dtype == kBFloat16)
    return (int)node_fwd_sync_z<__nv_bfloat16>(
        a, (const float*)weights, obuf, (const float*)sums, (float*)stat,
        (float*)out, count, E, N, H, W, Cs, s);
  return (int)cudaErrorInvalidValue;
}

int lctvqa_mixed_node_bwd_sync_r(const void* g, const void* obuf,
                                 const void* stat, const void* weights,
                                 void* scratch, void* sums_r, void* dwt,
                                 int E, int N, int H, int W, int Cs,
                                 int dtype, void* stream) {
  using namespace lctvqa;
  if (!node_sizes_ok(E, N, H, W, Cs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)node_bwd_sync_r<float>(
        (const float*)g, obuf, (const float*)stat, (const float*)weights,
        (float*)scratch, (float*)sums_r, (float*)dwt, E, N, H, W, Cs, s);
  if (dtype == kBFloat16)
    return (int)node_bwd_sync_r<__nv_bfloat16>(
        (const float*)g, obuf, (const float*)stat, (const float*)weights,
        (float*)scratch, (float*)sums_r, (float*)dwt, E, N, H, W, Cs, s);
  return (int)cudaErrorInvalidValue;
}

int lctvqa_mixed_node_bwd_sync_s(const void* args, const void* g,
                                 const void* obuf, const void* stat,
                                 const void* weights, void* scratch,
                                 const void* sums_r, void* sums_s,
                                 long long count, int E, int N, int H, int W,
                                 int Cs, int dtype, void* stream) {
  using namespace lctvqa;
  if (!node_sizes_ok(E, N, H, W, Cs) || count < 1)
    return (int)cudaErrorInvalidValue;
  const NodeArgs& a = *static_cast<const NodeArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)node_bwd_sync_s<float>(
        a, (const float*)g, obuf, (const float*)stat, (const float*)weights,
        (float*)scratch, (const float*)sums_r, (float*)sums_s, count, E, N,
        H, W, Cs, s);
  if (dtype == kBFloat16)
    return (int)node_bwd_sync_s<__nv_bfloat16>(
        a, (const float*)g, obuf, (const float*)stat, (const float*)weights,
        (float*)scratch, (const float*)sums_r, (float*)sums_s, count, E, N,
        H, W, Cs, s);
  return (int)cudaErrorInvalidValue;
}

int lctvqa_mixed_node_bwd_sync_x(const void* args, void* dx,
                                 const void* weights, const void* g,
                                 const void* obuf, const void* stat,
                                 void* scratch, const void* sums_s, void* ddw,
                                 void* dpw, void* dwt, long long count, int E,
                                 int N, int H, int W, int Cs, int dtype,
                                 void* stream) {
  using namespace lctvqa;
  if (!node_sizes_ok(E, N, H, W, Cs) || count < 1)
    return (int)cudaErrorInvalidValue;
  const NodeArgs& a = *static_cast<const NodeArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)node_bwd_sync_x<float>(
        a, dx, (const float*)weights, (const float*)g, obuf,
        (const float*)stat, (float*)scratch, (const float*)sums_s,
        (float*)ddw, (float*)dpw, (float*)dwt, count, E, N, H, W, Cs, s);
  if (dtype == kBFloat16)
    return (int)node_bwd_sync_x<__nv_bfloat16>(
        a, dx, (const float*)weights, (const float*)g, obuf,
        (const float*)stat, (float*)scratch, (const float*)sums_s,
        (float*)ddw, (float*)dpw, (float*)dwt, count, E, N, H, W, Cs, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
