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
#include <cmath>

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

// red: [Cs][chunks][2] per-warp sums of this block -> part[(c*2 + k) * nblk]
// (the caller has offset `part` to this block's column). Synchronises before
// and after.
__device__ __forceinline__ void flush_partials(const float* red, float* part,
                                               int Cs, int chunks,
                                               long long nblk) {
  __syncthreads();
  for (int c = threadIdx.x; c < Cs; c += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int k = 0; k < chunks; ++k) {
      s += red[(c * chunks + k) * 2];
      q += red[(c * chunks + k) * 2 + 1];
    }
    part[(long long)(c * 2) * nblk] = s;
    part[(long long)(c * 2 + 1) * nblk] = q;
  }
  __syncthreads();
}

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

// ts[c][p] = sum over the kk x kk taps (dilation dil) of xs, which holds
// the stage's input with a HALO-pixel border; RELU applies max(., 0) on read.
// (The backward's recomputation of a depthwise output.)
template <int TILE, int HALO, bool RELU>
__device__ __forceinline__ void depthwise(const float* xs, const float* dw,
                                          float* ts, int Cs, int kk, int dil) {
  constexpr int PWID = TILE + 2 * HALO;
  constexpr int PLANE = PWID * PWID;
  constexpr int PIX = TILE * TILE;
  const int half = (kk - 1) / 2 * dil;
  for (int it = threadIdx.x; it < Cs * PIX; it += blockDim.x) {
    const int c = it / PIX, p = it % PIX;
    const float* src =
        xs + c * PLANE + (p / TILE + HALO) * PWID + (p % TILE + HALO);
    const float* wt = dw + c;
    float acc = 0.f;
    int t = 0;
    for (int dy = -half; dy <= half; dy += dil)
      for (int dx = -half; dx <= half; dx += dil, ++t) {
        float v = src[dy * PWID + dx];
        if (RELU) v = fmaxf(v, 0.f);
        acc = fmaf(v, wt[t * Cs], acc);
      }
    ts[it] = acc;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int kNodeWarps = kNodeThreads / 32;
// halo loads in flight a thread: launch A loads four channels at once and
// keeps four blocks an SM at 64 registers; launch B loads one value
constexpr int kLoadBatchA = 4, kLoadBatchB = 8;

// The same depthwise as `depthwise`, the window and dilation known at
// compile time: a thread computes one channel at kRows pixels of a column,
// rows r + i DIL, i < kRows, which share their input rows (KK + kRows - 1
// rows feed kRows outputs), with the channel's KK x KK taps in registers
// and kRows independent sums (each in the same order as `depthwise`'s).
// Row groups start at 0, 4, 8, ... for DIL 1 and at 0, 1, 8, 9, ... for
// DIL 2; TILE is a multiple of 8.
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
__device__ __forceinline__ void finish_stats(const float* partial,
                                             float* stat, const int* slot_of,
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
    if (lane == 0) {
      const float mean = s * inv_count;
      const float var = q * inv_count - mean * mean;
      stat[entry * 2] = mean;
      stat[entry * 2 + 1] = 1.f / sqrtf(var + eps);
    }
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
// slots 0 and 1 (the sep convs' inner BatchNorm).
template <typename T, int TILE>
__global__ void __launch_bounds__(kNodeThreads, 4)
    node_stage_a_kernel(NodeArgs args, T* __restrict__ obuf,
                        float* __restrict__ partial,
                        float* __restrict__ stat, unsigned* ctr, int E,
                        int H, int W, int Cs, int vec_x) {
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
    finish_stats(partial, stat, slots, 2, e, E, Cs, g.nblk, 1.f / (float)M,
                 1e-5f);
}

// Launch B. grid (tiles, N, 2 * E): z = 2 * e + which (0: sep3, 1: sep5).
// The second stage of the sep convs from the first stage's plane through
// its BatchNorm; the edge's last block finishes the six folded statistics.
template <typename T, int TILE>
__global__ void __launch_bounds__(kNodeThreads)
    node_stage_b_kernel(NodeArgs args, T* __restrict__ obuf,
                        float* __restrict__ partial,
                        float* __restrict__ stat, unsigned* ctr, int E,
                        int H, int W, int Cs) {
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
    finish_stats(partial, stat, folds, kFoldSlots, e, E, Cs, g.nblk,
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

template <typename T, int TILE>
cudaError_t node_fwd(const NodeArgs& args, const float* weights, T* obuf,
                     float* partial, float* stat, float* out, int E, int N,
                     int H, int W, int Cs, cudaStream_t s) {
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  const long long nblk = (long long)N * tiles;
  const long long M = (long long)N * H * W;
  // two counters per edge after the partial sums: launch A's, launch B's
  unsigned* ctr =
      reinterpret_cast<unsigned*>(partial + (long long)8 * E * Cs * 2 * nblk);
  const size_t smem_a = stage_smem_floats<TILE, 4>(Cs, 4, 6) * sizeof(float);
  const size_t smem_b = stage_smem_floats<TILE, 2>(Cs, 1, 1) * sizeof(float);
  cudaError_t rc = allow_smem(node_stage_a_kernel<T, TILE>, smem_a);
  if (rc != cudaSuccess) return rc;
  rc = allow_smem(node_stage_b_kernel<T, TILE>, smem_b);
  if (rc != cudaSuccess) return rc;
  rc = cudaMemsetAsync(ctr, 0, 2 * E * sizeof(unsigned), s);
  if (rc != cudaSuccess) return rc;
  const int vec = edges_vec4(args, E, Cs, sizeof(T));
  node_stage_a_kernel<T, TILE><<<dim3(tiles, N, E), kNodeThreads, smem_a, s>>>(
      args, obuf, partial, stat, ctr, E, H, W, Cs, vec);
  node_stage_b_kernel<T, TILE>
      <<<dim3(tiles, N, 2 * E), kNodeThreads, smem_b, s>>>(
          args, obuf, partial, stat, ctr + E, E, H, W, Cs);
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
// the forward wrote, g, and x, and writes dx, one fp32 plane per sep conv and
// the per-block partials of the weight gradients). One C entry point makes
// seven kinds of launches on one stream; every sum over pixels is a per-block
// partial added later in a fixed order, so a training step repeats bit for
// bit:
//   R. per (edge, pixel chunk): sum g and sum g * o for the six folded ops.
//   C. per (edge, channel): from those, the folded BatchNorm's backward
//      coefficients (d o = A * (g - gbar - (o - mu) * k2)) and the
//      per-channel parts of d w[e, op] = r * (sum g o - mu sum g).
//   S. per (edge, sep branch, tile): second stage of a sep conv backwards:
//      d o -> pointwise -> depthwise -> ReLU mask; writes dz and per-block
//      sums of dz and dz * xhat for the inner BatchNorm.
//   M. adds those sums (mean dz, mean dz * xhat).
//   X. per (edge, tile): everything that reaches x, from one x tile with a
//      4-pixel halo: skip, the first stage of both sep convs (through the
//      inner BatchNorm's backward), both dil convs, max pool (to the first
//      maximal tap in row-major order) and avg pool; writes dx once.
//   W. adds the per-block partials of d dw, d pw, the skip weight and the
//      per-channel parts of d w.
// S and X share conv_stage_bwd: recompute the depthwise output t (the one
// value the forward does not keep), d pw = sum t * d, dt = pw^T d, d dw =
// sum in * dt, d in = dw (*) dt.

constexpr int kChunk = 2048;  // pixels per block of launch R
constexpr int kRSums = 7;     // sum g, then sum g * o of the six folded ops

struct BwdScratch {  // offsets in floats into one fp32 scratch tensor
  long long part_r, fc, gbar, dwpart, dzp, part_s, mstat, part_dw, part_pw,
      part_skip, total;
};

inline BwdScratch bwd_scratch(int E, long long M, long long nblk, int Cs) {
  BwdScratch b;
  const long long nchunk = (M + kChunk - 1) / kChunk;
  long long at = 0;
  b.part_r = at;    at += (long long)E * Cs * kRSums * nchunk;
  b.fc = at;        at += (long long)kFoldSlots * E * Cs * 3;
  b.gbar = at;      at += (long long)E * Cs;
  b.dwpart = at;    at += (long long)E * kFoldSlots * Cs;
  b.dzp = at;       at += 2LL * E * Cs * M;
  b.part_s = at;    at += 2LL * E * Cs * 2 * nblk;
  b.mstat = at;     at += 2LL * E * Cs * 2;
  b.part_dw = at;   at += (long long)E * 8 * kTaps * Cs * nblk;
  b.part_pw = at;   at += (long long)E * 8 * Cs * Cs * nblk;
  b.part_skip = at; at += (long long)E * nblk;
  b.total = at;
  return b;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

// Sum of p[0..n) over a 128-thread block in a fixed order; the result is
// valid in thread 0. sh holds 128 floats. Synchronises.
__device__ __forceinline__ float block_sum_128(const float* p, long long n,
                                               float* sh) {
  float s = 0.f;
  for (long long i = threadIdx.x; i < n; i += 128) s += p[i];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int d = 64; d > 0; d >>= 1) {
    if (threadIdx.x < d) sh[threadIdx.x] += sh[threadIdx.x + d];
    __syncthreads();
  }
  const float out = sh[0];
  __syncthreads();
  return out;
}

// Launch R. grid (chunks, E), 256 threads.
template <typename T>
__global__ void node_bwd_reduce_kernel(const float* __restrict__ g,
                                       const T* __restrict__ obuf,
                                       float* __restrict__ part_r, int E,
                                       long long M, int Cs) {
  __shared__ float sh[8][kRSums];
  const int e = blockIdx.y;
  const long long nchunk = gridDim.x;
  const long long lo = (long long)blockIdx.x * kChunk;
  const long long hi = lo + kChunk < M ? lo + kChunk : M;
  for (int c = 0; c < Cs; ++c) {
    float acc[kRSums];
#pragma unroll
    for (int k = 0; k < kRSums; ++k) acc[k] = 0.f;
    for (long long pix = lo + threadIdx.x; pix < hi; pix += blockDim.x) {
      const float gv = g[pix * Cs + c];
      acc[0] += gv;
#pragma unroll
      for (int s = 0; s < kFoldSlots; ++s) {
        const size_t plane = ((size_t)(kFirstFoldSlot + s) * E + e) * Cs + c;
        acc[1 + s] = fmaf(gv, to_f32(obuf[plane * M + pix]), acc[1 + s]);
      }
    }
#pragma unroll
    for (int k = 0; k < kRSums; ++k) {
      const float v = warp_sum(acc[k]);
      if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5][k] = v;
    }
    __syncthreads();
    if (threadIdx.x < kRSums) {
      float v = 0.f;
      for (int w = 0; w < 8; ++w) v += sh[w][threadIdx.x];
      part_r[(((size_t)e * Cs + c) * kRSums + threadIdx.x) * nchunk +
             blockIdx.x] = v;
    }
    __syncthreads();
  }
}

// Launch C. One 128-thread block per (edge, channel).
__global__ void node_bwd_coef_kernel(const float* __restrict__ part_r,
                                     const float* __restrict__ stat,
                                     const float* __restrict__ weights,
                                     float* __restrict__ fc,
                                     float* __restrict__ gbar,
                                     float* __restrict__ dwpart, int E, int Cs,
                                     long long nchunk, float inv_count) {
  __shared__ float sh[128];
  const int e = blockIdx.x / Cs, c = blockIdx.x % Cs;
  float sums[kRSums];
  for (int k = 0; k < kRSums; ++k)
    sums[k] = block_sum_128(
        part_r + (((size_t)e * Cs + c) * kRSums + k) * nchunk, nchunk, sh);
  if (threadIdx.x != 0) return;
  const float gs = sums[0];
  gbar[e * Cs + c] = gs * inv_count;
  for (int s = 0; s < kFoldSlots; ++s) {
    const size_t entry = ((size_t)(kFirstFoldSlot + s) * E + e) * Cs + c;
    const float mu = stat[entry * 2], r = stat[entry * 2 + 1];
    const float sc = sums[1 + s] - mu * gs;
    float* out = fc + (((size_t)s * E + e) * Cs + c) * 3;
    out[0] = weights[e * 8 + kSlotOp[s]] * r;
    out[1] = mu;
    out[2] = r * r * sc * inv_count;
    dwpart[((size_t)e * kFoldSlots + s) * Cs + c] = r * sc;
  }
}

// Launches M and W. out[row] = scale * sum of part[row * n .. + n), one
// 128-thread block per row. With rows_per_kidx > 0 the rows are laid out
// [.., 8, rows_per_kidx] and those of the packed-weight rows 5 and 7, which
// no branch uses, are set to 0 without being read.
__global__ void node_sums_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, long long n,
                                 float scale, int rows_per_kidx) {
  __shared__ float sh[128];
  const size_t row = blockIdx.x;
  if (rows_per_kidx > 0) {
    const int kidx = (int)((row / rows_per_kidx) % 8);
    if (kidx == 5 || kidx == 7) {
      if (threadIdx.x == 0) out[row] = 0.f;
      return;
    }
  }
  const float v = block_sum_128(part + row * n, n, sh);
  if (threadIdx.x == 0) out[row] = v * scale;
}

// The folded BatchNorm's backward at one element.
__device__ __forceinline__ float fold_grad(const float* fc3, float gv,
                                           float gb, float o) {
  return fc3[0] * (gv - gb - (o - fc3[1]) * fc3[2]);
}

// One depthwise + pointwise stage backwards, for one tile.
//   xs   [Cs][PLANE] the stage's input with a HALO border (RELU: max(., 0)
//        is applied on read), 0 outside the image
//   dbuf [Cs][PLANE] gradient of the stage's output, 0 outside the image
//        and beyond `half` pixels from the tile
//   dts  [Cs][PLANE] scratch
//   dws  [25][Cs] the stage's taps; pw (global) [Cs][Cs] as [ci][co]
// Writes this block's partials of d dw (part_dw[(tap * Cs + c) * nblk]) and
// d pw (part_pw[(ci * Cs + co) * nblk]); the caller has offset both to
// (edge, kidx, this block). Then the gradient of the stage's input at the
// tile's pixels: dins[c][p] = it (mask == nullptr), or dins[c][p] += it where
// mask[c][plane(p)] > 0. Synchronises at its end.
template <int TILE, int HALO, bool RELU>
__device__ __forceinline__ void conv_stage_bwd(
    const float* xs, const float* dbuf, float* dts, float* dins,
    const float* mask, const float* dws, const float* __restrict__ pw,
    float* part_dw, float* part_pw, int Cs, int kk, int dil, long long nblk) {
  constexpr int PWID = TILE + 2 * HALO;
  constexpr int PLANE = PWID * PWID;
  constexpr int PIX = TILE * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int half = (kk - 1) / 2 * dil;
  float* ts = dts;  // [Cs][PIX], dead before dts is written
  depthwise<TILE, HALO, RELU>(xs, dws, ts, Cs, kk, dil);
  for (int pair = warp; pair < Cs * Cs; pair += nwarps) {
    const int ci = pair / Cs, co = pair % Cs;
    float acc = 0.f;
    for (int p = lane; p < PIX; p += 32)
      acc = fmaf(ts[ci * PIX + p],
                 dbuf[co * PLANE + (p / TILE + HALO) * PWID + p % TILE + HALO],
                 acc);
    acc = warp_sum(acc);
    if (lane == 0) part_pw[(long long)pair * nblk] = acc;
  }
  __syncthreads();
  for (int it = threadIdx.x; it < Cs * PLANE; it += blockDim.x) {
    const int ci = it / PLANE, q = it % PLANE;
    float acc = 0.f;
    for (int co = 0; co < Cs; ++co)
      acc = fmaf(pw[ci * Cs + co], dbuf[co * PLANE + q], acc);
    dts[it] = acc;
  }
  __syncthreads();
  for (int pair = warp; pair < kTaps * Cs; pair += nwarps) {
    const int t = pair / Cs, c = pair % Cs;
    float acc = 0.f;
    if (t < kk * kk) {
      const int off = (t / kk * dil - half) * PWID + (t % kk * dil - half);
      for (int p = lane; p < PIX; p += 32) {
        const int at = c * PLANE + (p / TILE + HALO) * PWID + p % TILE + HALO;
        float v = xs[at + off];
        if (RELU) v = fmaxf(v, 0.f);
        acc = fmaf(v, dts[at], acc);
      }
      acc = warp_sum(acc);
    }
    if (lane == 0) part_dw[(long long)pair * nblk] = acc;
  }
  for (int it = threadIdx.x; it < Cs * PIX; it += blockDim.x) {
    const int c = it / PIX, p = it % PIX;
    const int at = c * PLANE + (p / TILE + HALO) * PWID + p % TILE + HALO;
    float acc = 0.f;
    int t = 0;
    for (int dy = -half; dy <= half; dy += dil)
      for (int dx = -half; dx <= half; dx += dil, ++t)
        acc = fmaf(dts[at - dy * PWID - dx], dws[t * Cs + c], acc);
    if (mask == nullptr)
      dins[it] = acc;
    else if (mask[at] > 0.f)
      dins[it] += acc;
  }
  __syncthreads();
}

// Launch S. grid (tiles, N, 2 * E): z = 2 * e + which (0: sep3, 1: sep5).
template <typename T, int TILE>
__global__ void node_bwd_sep2_kernel(NodeArgs args, const float* __restrict__ g,
                                     const T* __restrict__ obuf,
                                     const float* __restrict__ stat,
                                     const float* __restrict__ fc,
                                     const float* __restrict__ gbar,
                                     float* __restrict__ dzp,
                                     float* __restrict__ part_s,
                                     float* __restrict__ part_dw,
                                     float* __restrict__ part_pw, int E, int H,
                                     int W, int Cs) {
  constexpr int HALO = 2;
  constexpr int PWID = TILE + 2 * HALO;
  constexpr int PLANE = PWID * PWID;
  constexpr int PIX = TILE * TILE;
  constexpr int CHUNKS = PIX / 32;
  extern __shared__ float smem[];
  float* zs = smem;                // [Cs][PLANE] relu(BN(y1)) as values of T
  float* dbuf = zs + Cs * PLANE;   // [Cs][PLANE] d o2
  float* dts = dbuf + Cs * PLANE;  // [Cs][PLANE]
  float* dins = dts + Cs * PLANE;  // [Cs][PIX] dz
  float* dws = dins + Cs * PIX;    // [25][Cs]
  float* red = dws + kTaps * Cs;   // [Cs][CHUNKS][2]
  const int e = blockIdx.z / 2, which = blockIdx.z % 2;
  const NodeEdge ed = args.edge[e];
  const TileGeom tg = tile_geom<TILE>(H, W);
  const long long M = (long long)gridDim.y * H * W;
  const size_t mid = ((size_t)which * E + e) * Cs;  // slot 0 or 1
  const size_t outp = ((size_t)(kFirstFoldSlot + which) * E + e) * Cs;
  const int kk = which ? 5 : 3, half = (kk - 1) / 2;
  const int kidx = 2 * which + 1;

  for (int i = threadIdx.x; i < PLANE * Cs; i += blockDim.x) {
    const int c = i % Cs, p = i / Cs;
    const int py = p / PWID - HALO, px = p % PWID - HALO;
    const int h = tg.h0 + py, w = tg.w0 + px;
    float z = 0.f, d = 0.f;
    if (h >= 0 && h < H && w >= 0 && w < W) {
      const long long pix = tg.pixbase + (long long)h * W + w;
      const float o1 = to_f32(obuf[(mid + c) * M + pix]);
      const float mean = stat[(mid + c) * 2], rstd = stat[(mid + c) * 2 + 1];
      z = round_to<T>(fmaxf((o1 - mean) * rstd, 0.f));
      if (py >= -half && py < TILE + half && px >= -half && px < TILE + half)
        d = fold_grad(fc + (((size_t)which * E + e) * Cs + c) * 3,
                      g[pix * Cs + c], gbar[e * Cs + c],
                      to_f32(obuf[(outp + c) * M + pix]));
    }
    zs[c * PLANE + p] = z;
    dbuf[c * PLANE + p] = d;
  }
  for (int i = threadIdx.x; i < kTaps * Cs; i += blockDim.x)
    dws[i] = ed.dw[(size_t)kidx * kTaps * Cs + i];
  __syncthreads();

  const size_t wrow = (size_t)e * 8 + kidx;
  conv_stage_bwd<TILE, HALO, false>(
      zs, dbuf, dts, dins, nullptr, dws, ed.pw + (size_t)kidx * Cs * Cs,
      part_dw + wrow * kTaps * Cs * tg.nblk + tg.blk,
      part_pw + wrow * Cs * Cs * tg.nblk + tg.blk, Cs, kk, 1, tg.nblk);

  // through the ReLU: dz where xhat > 0; the inner BatchNorm's two sums
  for (int it = threadIdx.x; it < Cs * PIX; it += blockDim.x) {
    const int c = it / PIX, p = it % PIX;
    const int h = tg.h0 + p / TILE, w = tg.w0 + p % TILE;
    const bool valid = h < H && w < W;
    float s = 0.f, q = 0.f;
    if (valid) {
      const long long pix = tg.pixbase + (long long)h * W + w;
      const float o1 = to_f32(obuf[(mid + c) * M + pix]);
      const float xhat =
          (o1 - stat[(mid + c) * 2]) * stat[(mid + c) * 2 + 1];
      s = xhat > 0.f ? dins[it] : 0.f;
      q = s * xhat;
      dzp[(mid + c) * M + pix] = s;
    }
    s = warp_sum(s);
    q = warp_sum(q);
    if ((threadIdx.x & 31) == 0) {
      red[(c * CHUNKS + p / 32) * 2] = s;
      red[(c * CHUNKS + p / 32) * 2 + 1] = q;
    }
  }
  flush_partials(red, part_s + mid * 2 * tg.nblk + tg.blk, Cs, CHUNKS,
                 tg.nblk);
}

struct NodeDx {
  void* dx[kMaxEdges];  // [N, H, W, Cs] contiguous, in T
};

// Launch X. grid (tiles, N, E).
template <typename T, int TILE>
__global__ void node_bwd_x_kernel(NodeArgs args, NodeDx outs,
                                  const float* __restrict__ weights,
                                  const float* __restrict__ g,
                                  const T* __restrict__ obuf,
                                  const float* __restrict__ stat,
                                  const float* __restrict__ fc,
                                  const float* __restrict__ gbar,
                                  const float* __restrict__ dzp,
                                  const float* __restrict__ mstat,
                                  float* __restrict__ part_dw,
                                  float* __restrict__ part_pw,
                                  float* __restrict__ part_skip, int E, int H,
                                  int W, int Cs) {
  constexpr int HALO = 4;
  constexpr int PWID = TILE + 2 * HALO;
  constexpr int PLANE = PWID * PWID;
  constexpr int PIX = TILE * TILE;
  extern __shared__ float smem[];
  float* xs = smem;                // [Cs][PLANE] raw x, 0 outside the image
  float* dbuf = xs + Cs * PLANE;   // [Cs][PLANE]
  float* dts = dbuf + Cs * PLANE;  // [Cs][PLANE]
  float* dxs = dts + Cs * PLANE;   // [Cs][PIX] dx of this tile
  float* dws = dxs + Cs * PIX;     // [25][Cs]
  float* red = dws + kTaps * Cs;   // [8]
  const int e = blockIdx.z;
  const NodeEdge ed = args.edge[e];
  const TileGeom tg = tile_geom<TILE>(H, W);
  const long long M = (long long)gridDim.y * H * W;
  const T* x = (const T*)ed.x + (long long)tg.n * ed.sn;

  for (int i = threadIdx.x; i < PLANE * Cs; i += blockDim.x) {
    const int c = i % Cs, p = i / Cs;
    const int h = tg.h0 + p / PWID - HALO, w = tg.w0 + p % PWID - HALO;
    float v = 0.f;
    if (h >= 0 && h < H && w >= 0 && w < W)
      v = to_f32(x[(long long)h * ed.sh + (long long)w * ed.sw + c]);
    xs[c * PLANE + p] = v;
  }
  __syncthreads();

  // skip: dx = w[e, skip] * g, and this block's part of sum g * x
  {
    const float wskip = weights[e * 8 + kSkipOp];
    float acc = 0.f;
    for (int i = threadIdx.x; i < PIX * Cs; i += blockDim.x) {
      const int c = i % Cs, p = i / Cs;
      const int h = tg.h0 + p / TILE, w = tg.w0 + p % TILE;
      float gv = 0.f;
      if (h < H && w < W)
        gv = g[(tg.pixbase + (long long)h * W + w) * Cs + c];
      dxs[c * PIX + p] = wskip * gv;
      acc = fmaf(gv, xs[c * PLANE + (p / TILE + HALO) * PWID + p % TILE + HALO],
                 acc);
    }
    acc = warp_sum(acc);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = 0.f;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v += red[w];
      part_skip[(long long)e * tg.nblk + tg.blk] = v;
    }
  }

  // the four conv branches' first stage: sep3, sep5, dil3, dil5
  for (int b = 0; b < 4; ++b) {
    const int kk = (b & 1) ? 5 : 3, dil = b < 2 ? 1 : 2;
    const int half = (kk - 1) / 2 * dil;
    const int kidx = 2 * b;
    __syncthreads();
    for (int i = threadIdx.x; i < kTaps * Cs; i += blockDim.x)
      dws[i] = ed.dw[(size_t)kidx * kTaps * Cs + i];
    for (int i = threadIdx.x; i < PLANE * Cs; i += blockDim.x) {
      const int c = i % Cs, p = i / Cs;
      const int py = p / PWID - HALO, px = p % PWID - HALO;
      const int h = tg.h0 + py, w = tg.w0 + px;
      float d = 0.f;
      if (h >= 0 && h < H && w >= 0 && w < W && py >= -half &&
          py < TILE + half && px >= -half && px < TILE + half) {
        const long long pix = tg.pixbase + (long long)h * W + w;
        if (b < 2) {  // through the inner BatchNorm of sep conv b
          const size_t mid = ((size_t)b * E + e) * Cs + c;
          const float rstd = stat[mid * 2 + 1];
          const float xhat = (to_f32(obuf[mid * M + pix]) - stat[mid * 2]) *
                             rstd;
          d = rstd * (dzp[mid * M + pix] - mstat[mid * 2] -
                      xhat * mstat[mid * 2 + 1]);
        } else {
          const size_t plane = ((size_t)(kFirstFoldSlot + b) * E + e) * Cs + c;
          d = fold_grad(fc + (((size_t)b * E + e) * Cs + c) * 3,
                        g[pix * Cs + c], gbar[e * Cs + c],
                        to_f32(obuf[plane * M + pix]));
        }
      }
      dbuf[c * PLANE + p] = d;
    }
    __syncthreads();
    const size_t wrow = (size_t)e * 8 + kidx;
    conv_stage_bwd<TILE, HALO, true>(
        xs, dbuf, dts, dxs, xs, dws, ed.pw + (size_t)kidx * Cs * Cs,
        part_dw + wrow * kTaps * Cs * tg.nblk + tg.blk,
        part_pw + wrow * Cs * Cs * tg.nblk + tg.blk, Cs, kk, dil, tg.nblk);
  }

  // max pool (fold slot 4, plane 6) then avg pool (fold slot 5, plane 7)
  for (int pool = 0; pool < 2; ++pool) {
    const int s = 4 + pool;
    for (int i = threadIdx.x; i < PLANE * Cs; i += blockDim.x) {
      const int c = i % Cs, p = i / Cs;
      const int py = p / PWID - HALO, px = p % PWID - HALO;
      const int h = tg.h0 + py, w = tg.w0 + px;
      float d = 0.f, o = 0.f;
      if (h >= 0 && h < H && w >= 0 && w < W && py >= -1 && py <= TILE &&
          px >= -1 && px <= TILE) {
        const long long pix = tg.pixbase + (long long)h * W + w;
        const size_t plane = ((size_t)(kFirstFoldSlot + s) * E + e) * Cs + c;
        o = to_f32(obuf[plane * M + pix]);
        d = fold_grad(fc + (((size_t)s * E + e) * Cs + c) * 3,
                      g[pix * Cs + c], gbar[e * Cs + c], o);
        if (pool == 1) {
          const int rows = 1 + (h > 0) + (h < H - 1);
          const int cols = 1 + (w > 0) + (w < W - 1);
          d = d / (float)(rows * cols);
        }
      }
      dbuf[c * PLANE + p] = d;
      dts[c * PLANE + p] = o;
    }
    __syncthreads();
    for (int it = threadIdx.x; it < Cs * PIX; it += blockDim.x) {
      const int c = it / PIX, p = it % PIX;
      const int h = tg.h0 + p / TILE, w = tg.w0 + p % TILE;
      if (h >= H || w >= W) continue;
      const int at = c * PLANE + (p / TILE + HALO) * PWID + p % TILE + HALO;
      float acc = 0.f;
      if (pool == 1) {
        for (int qy = -1; qy <= 1; ++qy)
          for (int qx = -1; qx <= 1; ++qx) acc += dbuf[at + qy * PWID + qx];
      } else {
        const float xv = xs[at];
        // window q = p + (qy, qx) gives its gradient to its first maximal
        // tap in row-major order; p is its tap (-qy, -qx)
        for (int qy = -1; qy <= 1; ++qy) {
          if (h + qy < 0 || h + qy >= H) continue;
          for (int qx = -1; qx <= 1; ++qx) {
            if (w + qx < 0 || w + qx >= W) continue;
            const int q = at + qy * PWID + qx;
            const float m = dts[q];
            if (xv != m) continue;
            bool first = true;
            for (int t = 0; t < 9; ++t) {
              const int ty = t / 3 - 1, tx = t % 3 - 1;
              if (ty == -qy && tx == -qx) break;  // reached p
              const int rh = h + qy + ty, rw = w + qx + tx;
              if (rh < 0 || rh >= H || rw < 0 || rw >= W) continue;
              if (xs[q + ty * PWID + tx] == m) {
                first = false;
                break;
              }
            }
            if (first) acc += dbuf[q];
          }
        }
      }
      dxs[it] += acc;
    }
    __syncthreads();
  }

  T* dx = (T*)outs.dx[e];
  for (int i = threadIdx.x; i < PIX * Cs; i += blockDim.x) {
    const int c = i % Cs, p = i / Cs;
    const int h = tg.h0 + p / TILE, w = tg.w0 + p % TILE;
    if (h < H && w < W)
      dx[(tg.pixbase + (long long)h * W + w) * Cs + c] =
          from_f32<T>(dxs[c * PIX + p]);
  }
}

template <typename T, int TILE>
cudaError_t node_bwd(const NodeArgs& args, const NodeDx& outs,
                     const float* weights, const float* g, const T* obuf,
                     const float* stat, float* scratch, float* ddw, float* dpw,
                     float* dwt, int E, int N, int H, int W, int Cs,
                     cudaStream_t s) {
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  const long long nblk = (long long)N * tiles;
  const long long M = (long long)N * H * W;
  const long long nchunk = (M + kChunk - 1) / kChunk;
  const float inv_count = 1.f / (float)M;
  const BwdScratch b = bwd_scratch(E, M, nblk, Cs);
  float* part_r = scratch + b.part_r;
  float* fc = scratch + b.fc;
  float* gbar = scratch + b.gbar;
  float* dwpart = scratch + b.dwpart;
  float* dzp = scratch + b.dzp;
  float* part_s = scratch + b.part_s;
  float* mstat = scratch + b.mstat;
  float* part_dw = scratch + b.part_dw;
  float* part_pw = scratch + b.part_pw;
  float* part_skip = scratch + b.part_skip;
  constexpr int PIX = TILE * TILE;
  const size_t smem_s = ((size_t)3 * Cs * (TILE + 4) * (TILE + 4) +
                         (size_t)Cs * PIX + (size_t)kTaps * Cs +
                         (size_t)Cs * (PIX / 32) * 2) * sizeof(float);
  const size_t smem_x = ((size_t)3 * Cs * (TILE + 8) * (TILE + 8) +
                         (size_t)Cs * PIX + (size_t)kTaps * Cs + 8) *
                        sizeof(float);
  cudaError_t rc = allow_smem(node_bwd_sep2_kernel<T, TILE>, smem_s);
  if (rc != cudaSuccess) return rc;
  rc = allow_smem(node_bwd_x_kernel<T, TILE>, smem_x);
  if (rc != cudaSuccess) return rc;

  node_bwd_reduce_kernel<T><<<dim3((unsigned)nchunk, E), kNodeThreads, 0, s>>>(
      g, obuf, part_r, E, M, Cs);
  node_bwd_coef_kernel<<<E * Cs, 128, 0, s>>>(part_r, stat, weights, fc, gbar,
                                              dwpart, E, Cs, nchunk,
                                              inv_count);
  node_bwd_sep2_kernel<T, TILE>
      <<<dim3(tiles, N, 2 * E), kNodeThreads, smem_s, s>>>(
          args, g, obuf, stat, fc, gbar, dzp, part_s, part_dw, part_pw, E, H,
          W, Cs);
  node_sums_kernel<<<2 * E * Cs * 2, 128, 0, s>>>(part_s, mstat, nblk,
                                                  inv_count, 0);
  node_bwd_x_kernel<T, TILE><<<dim3(tiles, N, E), kNodeThreads, smem_x, s>>>(
      args, outs, weights, g, obuf, stat, fc, gbar, dzp, mstat, part_dw,
      part_pw, part_skip, E, H, W, Cs);
  node_sums_kernel<<<E * 8 * kTaps * Cs, 128, 0, s>>>(part_dw, ddw, nblk, 1.f,
                                                      kTaps * Cs);
  node_sums_kernel<<<E * 8 * Cs * Cs, 128, 0, s>>>(part_pw, dpw, nblk, 1.f,
                                                   Cs * Cs);
  node_sums_kernel<<<E * kFoldSlots, 128, 0, s>>>(dwpart, dwt, Cs, 1.f, 0);
  node_sums_kernel<<<E, 128, 0, s>>>(part_skip, dwt + E * kFoldSlots, nblk,
                                     1.f, 0);
  return cudaGetLastError();
}

// Edge of the square pixel tile of one block of the backward's launches S
// and X.
inline int bwd_tile(int Cs) { return Cs <= 16 ? 16 : 8; }

template <typename T>
cudaError_t node_bwd_tile(const NodeArgs& args, const NodeDx& outs,
                          const float* weights, const float* g,
                          const void* obuf, const float* stat, float* scratch,
                          float* ddw, float* dpw, float* dwt, int E, int N,
                          int H, int W, int Cs, cudaStream_t s) {
  if (bwd_tile(Cs) == 16)
    return node_bwd<T, 16>(args, outs, weights, g, (const T*)obuf, stat,
                           scratch, ddw, dpw, dwt, E, N, H, W, Cs, s);
  return node_bwd<T, 8>(args, outs, weights, g, (const T*)obuf, stat, scratch,
                        ddw, dpw, dwt, E, N, H, W, Cs, s);
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

// Floats of fp32 scratch lctvqa_mixed_node_bwd needs at these sizes.
long long lctvqa_mixed_node_bwd_scratch(int E, int N, int H, int W, int Cs) {
  using namespace lctvqa;
  const int tile = bwd_tile(Cs);
  const long long nblk =
      (long long)N * ((H + tile - 1) / tile) * ((W + tile - 1) / tile);
  return bwd_scratch(E, (long long)N * H * W, nblk, Cs).total;
}

// args, weights, obuf, stat: as given to and left by lctvqa_mixed_node_fwd on
// the same inputs. g: [N, H, W, Cs] fp32 contiguous. dxs: NodeDx on the host,
// E pointers to [N, H, W, Cs] contiguous tensors in `dtype`. scratch: fp32,
// lctvqa_mixed_node_bwd_scratch floats. ddw: [E, 8, 25, Cs], dpw:
// [E, 8, Cs, Cs], dwt: [E * 6 + E] fp32 (d weights of the six folded ops as
// [E, 6] in the order sep3, sep5, dil3, dil5, max, avg, then of skip as [E]).
int lctvqa_mixed_node_bwd(const void* args, const void* dxs,
                          const void* weights, const void* g, const void* obuf,
                          const void* stat, void* scratch, void* ddw,
                          void* dpw, void* dwt, int E, int N, int H, int W,
                          int Cs, int dtype, void* stream) {
  using namespace lctvqa;
  if (E < 1 || E > kMaxEdges || Cs < 1 || Cs > kMaxCs || N < 1 ||
      N > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const NodeArgs& a = *static_cast<const NodeArgs*>(args);
  const NodeDx& d = *static_cast<const NodeDx*>(dxs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)node_bwd_tile<float>(
        a, d, (const float*)weights, (const float*)g, obuf,
        (const float*)stat, (float*)scratch, (float*)ddw, (float*)dpw,
        (float*)dwt, E, N, H, W, Cs, s);
  if (dtype == kBFloat16)
    return (int)node_bwd_tile<__nv_bfloat16>(
        a, d, (const float*)weights, (const float*)g, obuf,
        (const float*)stat, (float*)scratch, (float*)ddw, (float*)dpw,
        (float*)dwt, E, N, H, W, Cs, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
