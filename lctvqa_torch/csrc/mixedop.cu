// Node-batched PC-DARTS mixed-op forward for Hopper (sm_90a), bound to
// Python with ctypes (lctvqa_torch/ops/cuda_mixedop.py). Replaces the Pallas
// TPU kernel of lctvqa/ops/pallas_mixedop.py (_make_fwd_kernel, the
// pallas_call at pallas_mixedop.py:425):
//
//   lctvqa_mixed_node_fwd   out[n,h,w,c] = sum_e w[e,skip] * x_e
//                             + sum_e sum_op w[e,op] * BN_op(op(x_e))
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
// What bounds it on an H100: bytes. The work is ~200 operations per input
// element outside the tensor cores against 2-4 bytes read, but the batch
// statistics force every stage output through device memory: no block sees
// all of (N, H, W), and blocks run in no order. The TPU kernel is one
// sequential program over VMEM-resident slabs; here one C entry point issues
// a fixed sequence of five launches on one stream:
//   A. per (edge, image, tile): x tile with a 4-pixel halo in shared memory;
//      the first stage of the four conv branches and both pools from that
//      one tile; writes six `o` planes and per-block sums of o and o^2.
//   F. per (stage, edge, channel): adds the per-block sums in a fixed order
//      (no atomics, so a result does not change from run to run) and writes
//      mean and 1/sqrt(var + eps). Runs after A for the sep convs' inner
//      BN, and after B for the six folded BNs.
//   B. per (edge, sep branch, image, tile): inner BN, relu, rounding to T,
//      second depthwise and pointwise; writes `o` and its per-block sums.
//   Z. per pixel: coef and bias from the statistics, the weighted sum over
//      ops and edges, minus the bias.
// Scratch `o` planes are channel-planar ([slot, edge, channel, N*H*W]) so
// that neighbouring threads (neighbouring pixels) touch neighbouring
// addresses; the edge inputs are read through their strides, so a channel
// slice needs no copy.
#include <cmath>

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

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Stores v (already a value of T) for a valid pixel and leaves the warp's
// sums of v and v^2 in red_slot[0..1]. All 32 lanes of the warp call it.
template <typename T>
__device__ __forceinline__ void store_and_reduce(float v, bool valid, T* dst,
                                                 float* red_slot) {
  if (valid) *dst = from_f32<T>(v);
  float s = valid ? v : 0.f;
  float q = s * s;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, d);
    q += __shfl_down_sync(0xffffffffu, q, d);
  }
  if ((threadIdx.x & 31) == 0) {
    red_slot[0] = s;
    red_slot[1] = q;
  }
}

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

// o[co] = sum_ci ts[ci][p] * pw[ci][co], rounded to T, stored to the plane
// `o` ([Cs][M]) and reduced into `part`. ts: [Cs][TILE*TILE].
template <typename T, int TILE>
__device__ __forceinline__ void pointwise_emit(
    const float* ts, const float* pw, float* red, T* o, float* part, int Cs,
    long long M, const TileGeom& g, int H, int W) {
  constexpr int PIX = TILE * TILE;
  constexpr int CHUNKS = PIX / 32;
  for (int it = threadIdx.x; it < Cs * PIX; it += blockDim.x) {
    const int co = it / PIX, p = it % PIX;
    const int h = g.h0 + p / TILE, w = g.w0 + p % TILE;
    float acc = 0.f;
    for (int ci = 0; ci < Cs; ++ci)
      acc = fmaf(ts[ci * PIX + p], pw[ci * Cs + co], acc);
    store_and_reduce<T>(round_to<T>(acc), h < H && w < W,
                        o + (long long)co * M + g.pixbase + (long long)h * W + w,
                        red + (co * CHUNKS + p / 32) * 2);
  }
  flush_partials(red, part, Cs, CHUNKS, g.nblk);
}

// ts[c][p] = sum over the kk x kk taps (dilation dil) of xs, which holds
// the stage's input with a HALO-pixel border; RELU applies max(., 0) on read.
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

template <int TILE, int HALO>
constexpr size_t stage_smem_floats(int Cs, int branches) {
  return (size_t)Cs * (TILE + 2 * HALO) * (TILE + 2 * HALO)  // xs
         + (size_t)Cs * TILE * TILE                          // ts
         + (size_t)branches * kTaps * Cs                     // dws
         + (size_t)branches * Cs * Cs                        // pws
         + (size_t)Cs * (TILE * TILE / 32) * 2;              // red
}

// Launch A. grid (tiles, N, E).
template <typename T, int TILE>
__global__ void node_stage_a_kernel(NodeArgs args, T* __restrict__ obuf,
                                    float* __restrict__ partial, int E, int H,
                                    int W, int Cs) {
  constexpr int HALO = 4;
  constexpr int PWID = TILE + 2 * HALO;
  constexpr int PLANE = PWID * PWID;
  constexpr int PIX = TILE * TILE;
  constexpr int CHUNKS = PIX / 32;
  extern __shared__ float smem[];
  float* xs = smem;                 // [Cs][PLANE] raw x, 0 outside the image
  float* ts = xs + Cs * PLANE;      // [Cs][PIX]
  float* dws = ts + Cs * PIX;       // [4][25][Cs] first-stage taps
  float* pws = dws + 4 * kTaps * Cs;  // [4][Cs][Cs]
  float* red = pws + 4 * Cs * Cs;   // [Cs][CHUNKS][2]
  const int e = blockIdx.z;
  const NodeEdge ed = args.edge[e];
  const TileGeom g = tile_geom<TILE>(H, W);
  const long long M = (long long)gridDim.y * H * W;
  const T* x = (const T*)ed.x + (long long)g.n * ed.sn;

  for (int i = threadIdx.x; i < PLANE * Cs; i += blockDim.x) {
    const int c = i % Cs, p = i / Cs;
    const int h = g.h0 + p / PWID - HALO, w = g.w0 + p % PWID - HALO;
    float v = 0.f;
    if (h >= 0 && h < H && w >= 0 && w < W)
      v = to_f32(x[(long long)h * ed.sh + (long long)w * ed.sw + c]);
    xs[c * PLANE + p] = v;
  }
  for (int i = threadIdx.x; i < 4 * kTaps * Cs; i += blockDim.x)
    dws[i] = ed.dw[(size_t)(2 * (i / (kTaps * Cs))) * kTaps * Cs +
                   i % (kTaps * Cs)];
  for (int i = threadIdx.x; i < 4 * Cs * Cs; i += blockDim.x)
    pws[i] = ed.pw[(size_t)(2 * (i / (Cs * Cs))) * Cs * Cs + i % (Cs * Cs)];
  __syncthreads();

  // the four conv branches' first stage: sep3, sep5, dil3, dil5
  for (int b = 0; b < 4; ++b) {
    const int slot = b < 2 ? b : b + 2;
    depthwise<TILE, HALO, true>(xs, dws + b * kTaps * Cs, ts, Cs,
                                (b & 1) ? 5 : 3, b < 2 ? 1 : 2);
    const size_t plane = ((size_t)slot * E + e) * Cs;
    pointwise_emit<T, TILE>(ts, pws + b * Cs * Cs, red, obuf + plane * M,
                            partial + plane * 2 * g.nblk + g.blk, Cs, M, g, H,
                            W);
  }

  // max pool (slot 6) and avg pool (slot 7), 3x3, stride 1, pad 1
  for (int pool = 0; pool < 2; ++pool) {
    const size_t plane = ((size_t)(6 + pool) * E + e) * Cs;
    for (int it = threadIdx.x; it < Cs * PIX; it += blockDim.x) {
      const int c = it / PIX, p = it % PIX;
      const int h = g.h0 + p / TILE, w = g.w0 + p % TILE;
      const float* src =
          xs + c * PLANE + (p / TILE + HALO) * PWID + (p % TILE + HALO);
      float mx = -INFINITY, sum = 0.f;
      int rows = 0, cols = 0;
      for (int dy = -1; dy <= 1; ++dy) {
        if (h + dy < 0 || h + dy >= H) continue;
        ++rows;
        cols = 0;
        for (int dx = -1; dx <= 1; ++dx) {
          if (w + dx < 0 || w + dx >= W) continue;
          ++cols;
          const float v = src[dy * PWID + dx];
          mx = fmaxf(mx, v);
          sum += v;
        }
      }
      const bool valid = h < H && w < W;
      const float v =
          !valid ? 0.f
                 : (pool == 0 ? mx : round_to<T>(sum / (float)(rows * cols)));
      store_and_reduce<T>(
          v, valid,
          obuf + (plane + c) * M + g.pixbase + (long long)h * W + w,
          red + (c * CHUNKS + p / 32) * 2);
    }
    flush_partials(red, partial + plane * 2 * g.nblk + g.blk, Cs, CHUNKS,
                   g.nblk);
  }
}

// Launch B. grid (tiles, N, 2 * E): z = 2 * e + which (0: sep3, 1: sep5).
template <typename T, int TILE>
__global__ void node_stage_b_kernel(NodeArgs args, T* __restrict__ obuf,
                                    const float* __restrict__ stat,
                                    float* __restrict__ partial, int E, int H,
                                    int W, int Cs) {
  constexpr int HALO = 2;
  constexpr int PWID = TILE + 2 * HALO;
  constexpr int PLANE = PWID * PWID;
  constexpr int PIX = TILE * TILE;
  extern __shared__ float smem[];
  float* xs = smem;               // [Cs][PLANE] relu(BN(o1)) as values of T
  float* ts = xs + Cs * PLANE;    // [Cs][PIX]
  float* dws = ts + Cs * PIX;     // [25][Cs] second-stage taps
  float* pws = dws + kTaps * Cs;  // [Cs][Cs]
  float* red = pws + Cs * Cs;
  const int e = blockIdx.z / 2, which = blockIdx.z % 2;
  const NodeEdge ed = args.edge[e];
  const TileGeom g = tile_geom<TILE>(H, W);
  const long long M = (long long)gridDim.y * H * W;
  const size_t mid = ((size_t)which * E + e) * Cs;  // slot 0 or 1

  for (int i = threadIdx.x; i < PLANE * Cs; i += blockDim.x) {
    const int c = i / PLANE, p = i % PLANE;
    const int h = g.h0 + p / PWID - HALO, w = g.w0 + p % PWID - HALO;
    float v = 0.f;
    if (h >= 0 && h < H && w >= 0 && w < W) {
      const float o1 =
          to_f32(obuf[(mid + c) * M + g.pixbase + (long long)h * W + w]);
      const float mean = stat[(mid + c) * 2], rstd = stat[(mid + c) * 2 + 1];
      v = round_to<T>(fmaxf((o1 - mean) * rstd, 0.f));
    }
    xs[i] = v;
  }
  const int kidx = 2 * which + 1;
  for (int i = threadIdx.x; i < kTaps * Cs; i += blockDim.x)
    dws[i] = ed.dw[(size_t)kidx * kTaps * Cs + i];
  for (int i = threadIdx.x; i < Cs * Cs; i += blockDim.x)
    pws[i] = ed.pw[(size_t)kidx * Cs * Cs + i];
  __syncthreads();

  depthwise<TILE, HALO, false>(xs, dws, ts, Cs, which ? 5 : 3, 1);
  const size_t plane = ((size_t)(kFirstFoldSlot + which) * E + e) * Cs;
  pointwise_emit<T, TILE>(ts, pws, red, obuf + plane * M,
                          partial + plane * 2 * g.nblk + g.blk, Cs, M, g, H,
                          W);
}

// Launch F. One block per (slot, edge, channel) entry from `first` on.
__global__ void node_finalize_kernel(const float* __restrict__ partial,
                                     float* __restrict__ stat, int first,
                                     long long nblk, float inv_count,
                                     float eps) {
  __shared__ float sh[2][128];
  const size_t entry = (size_t)first + blockIdx.x;
  const float* ps = partial + entry * 2 * nblk;
  float s = 0.f, q = 0.f;
  for (long long i = threadIdx.x; i < nblk; i += blockDim.x) {
    s += ps[i];
    q += ps[nblk + i];
  }
  sh[0][threadIdx.x] = s;
  sh[1][threadIdx.x] = q;
  __syncthreads();
  for (int d = 64; d > 0; d >>= 1) {
    if (threadIdx.x < d) {
      sh[0][threadIdx.x] += sh[0][threadIdx.x + d];
      sh[1][threadIdx.x] += sh[1][threadIdx.x + d];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float mean = sh[0][0] * inv_count;
    const float var = sh[1][0] * inv_count - mean * mean;
    stat[entry * 2] = mean;
    stat[entry * 2 + 1] = 1.f / sqrtf(var + eps);
  }
}

// Launch Z. One thread per pixel, looping over the Cs channels.
template <typename T>
__global__ void node_final_kernel(NodeArgs args,
                                  const float* __restrict__ weights,
                                  const T* __restrict__ obuf,
                                  const float* __restrict__ stat,
                                  float* __restrict__ out, int E, int N, int H,
                                  int W, int Cs) {
  extern __shared__ float smem[];
  float* coef = smem;                       // [E][6][Cs]
  float* bias = coef + E * kFoldSlots * Cs; // [Cs]
  float* skip = bias + Cs;                  // [E]
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
  const long long M = (long long)N * H * W;
  for (long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       pix < M; pix += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(pix / ((long long)H * W));
    const int rem = (int)(pix % ((long long)H * W));
    const int h = rem / W, w = rem % W;
    for (int c = 0; c < Cs; ++c) {
      float acc = 0.f;
      for (int e = 0; e < E; ++e) {
        const NodeEdge& ed = args.edge[e];
        const T* x = (const T*)ed.x;
        acc = fmaf(to_f32(x[(long long)n * ed.sn + (long long)h * ed.sh +
                            (long long)w * ed.sw + c]),
                   skip[e], acc);
      }
      for (int s = 0; s < kFoldSlots; ++s)
        for (int e = 0; e < E; ++e) {
          const size_t plane = ((size_t)(kFirstFoldSlot + s) * E + e) * Cs + c;
          acc = fmaf(to_f32(obuf[plane * M + pix]),
                     coef[(e * kFoldSlots + s) * Cs + c], acc);
        }
      out[pix * Cs + c] = acc - bias[c];
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int TILE>
cudaError_t node_fwd(const NodeArgs& args, const float* weights, T* obuf,
                     float* partial, float* stat, float* out, int E, int N,
                     int H, int W, int Cs, cudaStream_t s) {
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  const long long nblk = (long long)N * tiles;
  const long long M = (long long)N * H * W;
  const float inv_count = 1.f / (float)M;
  const float eps = 1e-5f;
  const size_t smem_a = stage_smem_floats<TILE, 4>(Cs, 4) * sizeof(float);
  const size_t smem_b = stage_smem_floats<TILE, 2>(Cs, 1) * sizeof(float);
  cudaError_t rc = allow_smem(node_stage_a_kernel<T, TILE>, smem_a);
  if (rc != cudaSuccess) return rc;
  rc = allow_smem(node_stage_b_kernel<T, TILE>, smem_b);
  if (rc != cudaSuccess) return rc;

  node_stage_a_kernel<T, TILE><<<dim3(tiles, N, E), kNodeThreads, smem_a, s>>>(
      args, obuf, partial, E, H, W, Cs);
  node_finalize_kernel<<<2 * E * Cs, 128, 0, s>>>(partial, stat, 0, nblk,
                                                  inv_count, eps);
  node_stage_b_kernel<T, TILE>
      <<<dim3(tiles, N, 2 * E), kNodeThreads, smem_b, s>>>(
          args, obuf, stat, partial, E, H, W, Cs);
  node_finalize_kernel<<<kFoldSlots * E * Cs, 128, 0, s>>>(
      partial, stat, kFirstFoldSlot * E * Cs, nblk, inv_count, eps);
  long long want = (M + kNodeThreads - 1) / kNodeThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  const size_t smem_z = (size_t)(E * kFoldSlots * Cs + Cs + E) * sizeof(float);
  node_final_kernel<T><<<blocks, kNodeThreads, smem_z, s>>>(
      args, weights, obuf, stat, out, E, N, H, W, Cs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t node_fwd_tile(const NodeArgs& args, const float* weights,
                          void* obuf, float* partial, float* stat, float* out,
                          int E, int N, int H, int W, int Cs, cudaStream_t s) {
  if (Cs <= 16)
    return node_fwd<T, 16>(args, weights, (T*)obuf, partial, stat, out, E, N,
                           H, W, Cs, s);
  return node_fwd<T, 8>(args, weights, (T*)obuf, partial, stat, out, E, N, H,
                        W, Cs, s);
}

}  // namespace
}  // namespace lctvqa

extern "C" {

int lctvqa_mixed_node_max_edges() { return lctvqa::kMaxEdges; }
int lctvqa_mixed_node_max_cs() { return lctvqa::kMaxCs; }
// Edge of the square pixel tile one block takes at this Cs: a call runs
// N * ceil(H / tile) * ceil(W / tile) blocks per edge, and `partial` holds
// one column per block.
int lctvqa_mixed_node_tile(int Cs) { return Cs <= 16 ? 16 : 8; }

// args: NodeArgs on the host, its first E edges filled. weights: [E, 8]
// fp32. obuf: scratch [8, E, Cs, N*H*W] in `dtype`. partial: fp32 scratch
// [8, E, Cs, 2, blocks per edge]. stat: fp32 scratch [8, E, Cs, 2]. out:
// [N, H, W, Cs] fp32. 1 <= E <= 8, 1 <= Cs <= 64, N <= 65535.
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

}  // extern "C"
