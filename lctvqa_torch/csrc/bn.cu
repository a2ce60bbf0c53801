// Batch-statistics BatchNorm, forward and backward, for Hopper (sm_90a),
// bound to Python with ctypes (lctvqa_torch/ops/cuda_bn.py). Replaces the
// Pallas TPU kernels of lctvqa/ops/pallas_bn.py (_fwd_kernel, the
// pallas_call at pallas_bn.py:81, and _bwd_kernel, the one at :95):
//
//   lctvqa_bn_fwd   y = (x - mean_c) * rsqrt(var_c + eps) over a contiguous
//                   [M, C] view of an NHWC tensor, no scale or bias,
//                   var = E[x^2] - mean^2, statistics and normalize in fp32,
//                   x fp32 or bf16, y fp32 or bf16; leaves mean and
//                   1/sqrt(var + eps) in `stat` for the backward
//   lctvqa_bn_bwd   dx = r * (g - mean(g) - xhat * mean(g * xhat)) with
//                   xhat = (x - mean) * r from the forward's `stat`; g fp32
//                   or bf16, sums in fp32, dx in x's dtype
//
// What bounds it on an H100: bytes. It does 5 (backward 10) operations per
// element it moves, so the least time is one read of x (and g) and one
// write of y (dx) at the memory rate. The TPU kernel gets its "one read,
// one write" by holding the whole tensor in VMEM. Here each call is a
// memset of the barrier's counter and one cooperative launch of a
// persistent grid, every block resident at once, at most one an SM. Block
// b owns the rows [b R, (b + 1) R) of the [M, C] view, a contiguous range
// of bytes, and:
//   1. copies the first `staged` rows of its share (of x, and of g in the
//      backward) into shared memory: one thread issues four bulk copies
//      (TMA, cp.async.bulk), each completing on its own mbarrier;
//   2. sums per channel the rows past `staged` straight from device memory,
//      then each copy's rows as it lands: x and x^2 (forward), g and
//      g * xhat (backward);
//   3. writes one partial [2, C]: a warp's rows by shuffles, then the
//      block's warps in order;
//   4. crosses one grid barrier (lstm_seq.cuh's: a counter that only grows);
//   5. adds the partials of all blocks in block order into the statistics:
//      every block takes the same sums in the same order, so every block
//      holds the same bits; block 0 writes the forward's `stat`;
//   6. normalizes its staged rows from shared memory and the rest from
//      device memory (their second read, mostly from the 50 MB L2), and
//      writes y (dx).
// Where a block reads rows twice, the staged rows' copies and the outputs
// take an evict-first L2 policy and the first read of the other rows an
// evict-last one, so that their second read finds them in L2 (on an H100
// at [64,64,64,32] with fp32 x this took the backward from 52 to 41 us).
// The barrier's counter is the only atomic and every sum is taken in a
// fixed order, so two calls give the same bits, which a served answer
// needs. The grid follows the shape: a block per 16 KiB of the tensor (x
// and g in the backward), at most one an SM, so that a 1 MB tensor does
// not pay for a barrier of 132 blocks. lctvqa_bn_plan reports the launch
// shape, ops/cuda_bn.py::bn_plan mirrors it.
//
// The two-launch mode, for a batch whose rows lie on several processes
// (data parallelism, lctvqa_torch/parallel/): the cooperative launch above
// has no point at which the sums of this rank's rows could be summed over
// the ranks, so each pass over the tensor is a launch of its own, and
// ops/cuda_bn.py all-reduces the [2, C] sums between them:
//   lctvqa_bn_fwd_sums    sum x and x^2 per channel over this rank's rows
//   lctvqa_bn_fwd_apply   y from the global sums and row count; leaves stat
//   lctvqa_bn_bwd_sums    sum g and g * xhat (xhat from the forward's stat)
//   lctvqa_bn_bwd_apply   dx = r * (g - sum g / M - xhat * sum g xhat / M)
// A sums launch is steps 2, 3 and 5 above: each block sums its rows from
// device memory and writes one partial, and the last block to finish,
// found by a counter (a memset zeroes it), adds the partials in block
// order, so two calls give the same bits. An apply launch reads x (and g)
// from device memory again, since shared memory does not outlive a
// launch: one more read of the tensor than the one-launch kernels, which
// bounds the pair at about 1.5 (forward) and 1.4 (backward) times their
// least time. A block per 16 KiB of the tensor, at most kSyncBlocksPerSM
// an SM, 256 threads as rows x lanes as below; ops/cuda_bn.py::sync_plan
// mirrors the grid.
//
// On chip at the supernet's six shapes on a 132-SM H100 (227 KB of shared
// memory a block): blocks, and the share of the rows staged in shared
// memory, the rest read twice (bn_plan's numbers):
//   shape          forward, x fp32 | bf16     backward, x and g: fp32 bf16 |
//                                                 fp32 fp32 | bf16 bf16
//   [64,64,64,16]  132 100% | 132 100%        132 100% | 132 90% | 132 100%
//   [64,64,64,32]  132  90% | 132 100%        132  60% | 132 45% | 132  90%
//   [64,32,32,64]  132 100% | 132 100%        132 100% | 132 88% | 132 100%
//   [64,16,16,64]  132 | 128, all staged      132 | 132 | 132, all staged
//   [64,32,32,8]   128 |  64, all staged      132 | 132 | 128, all staged
//   [64,16,16,16]   64 |  32, all staged       96 | 128 |  64, all staged
// A block has 256 threads where it stages its whole share and 512 where it
// reads rows from device memory itself (twice as many loads in flight);
// they form `rows` x `lanes`: a lane owns VEC neighbouring channels (4
// when C is a multiple of 4, so that a thread moves 16 bytes of fp32 at a
// time; else 1, and the staging is plain copies), lanes is the power of two
// at or above C / VEC, at most 32, and neighbouring threads touch
// neighbouring addresses in shared and device memory alike. The
// lane-packing of the TPU kernel (_select_matrix) is a TPU layout device
// and has no counterpart.
#include <algorithm>
#include <cstdint>

#include "lstm_common.cuh"
#include "lstm_seq.cuh"

namespace lctvqa {
namespace {
namespace bn {

// threads a block: 256 where a block's whole share is staged (cheaper
// reductions and barrier), 512 where rows are read from device memory by
// the threads themselves (twice as many loads in flight)
constexpr int kFewThreads = 256, kManyThreads = 512;
constexpr int kStages = 4;               // bulk copies of the staging
constexpr int kSyncBytes = 16;           // the barrier's counter, padded
constexpr long long kBlockBytes = 16384; // bytes of the tensor a block
constexpr int kMaxDevices = 64;

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float v[VEC]);
template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p,
                                                   float v[1]) {
  v[0] = p[0];
}
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p,
                                                   float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float v[1]) {
  v[0] = __bfloat162float(p[0]);
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 4>(
    const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float v[VEC]);
template <>
__device__ __forceinline__ void store_vec<float, 1>(float* p,
                                                    const float v[1]) {
  p[0] = v[0];
}
template <>
__device__ __forceinline__ void store_vec<float, 4>(float* p,
                                                    const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 1>(
    __nv_bfloat16* p, const float v[1]) {
  p[0] = __float2bfloat16_rn(v[0]);
}
template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16, 4>(
    __nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned*>(&a);
  q.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// L2 policies where a block reads rows twice (HINT, the plans with
// kManyThreads): the staged rows and the outputs are touched once and
// evicted first, the rows past the staged ones are kept until their second
// read, which is their last use (ld.lu). Where every row is staged the
// copies and stores take the default policy.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// load_vec of a row that is read again after the barrier: kept in L2.
template <bool HINT, typename T, int VEC>
__device__ __forceinline__ void load_keep(const T* p, float v[VEC],
                                          uint64_t pol) {
  if constexpr (HINT && VEC == 4 && sizeof(T) == 4) {
    float4 q;
    asm volatile("ld.global.L2::cache_hint.v4.f32 {%0,%1,%2,%3}, [%4], %5;\n"
                 : "=f"(q.x), "=f"(q.y), "=f"(q.z), "=f"(q.w)
                 : "l"(p), "l"(pol));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (HINT && VEC == 4) {
    uint2 q;
    asm volatile("ld.global.L2::cache_hint.v2.u32 {%0,%1}, [%2], %3;\n"
                 : "=r"(q.x), "=r"(q.y)
                 : "l"(p), "l"(pol));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  } else {
    load_vec<T, VEC>(p, v);
  }
}

// load_vec of that row's second read, its last use (.lu).
template <bool HINT, typename T, int VEC>
__device__ __forceinline__ void load_last(const T* p, float v[VEC]) {
  if constexpr (HINT && VEC == 4 && sizeof(T) == 4) {
    const float4 q = __ldlu(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (HINT && VEC == 4) {
    const uint2 q = __ldlu(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  } else {
    load_vec<T, VEC>(p, v);
  }
}

// store_vec of an output: streamed (.cs) under HINT.
template <bool HINT, typename T, int VEC>
__device__ __forceinline__ void store_out(T* p, const float v[VEC]) {
  if constexpr (HINT && VEC == 4 && sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (HINT && VEC == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&a);
    q.y = *reinterpret_cast<const unsigned*>(&b);
    __stcs(reinterpret_cast<uint2*>(p), q);
  } else {
    store_vec<T, VEC>(p, v);
  }
}

// What a launch is told of its plan; offsets in bytes of dynamic shared
// memory: staged x rows at 0, staged g rows at g_at (backward), the
// reduction scratch at red_at, the statistics at stat_at, the staging's
// kStages mbarriers at bar_at.
struct Layout {
  long long M;  // rows of the [M, C] view
  int C;
  int lanes;    // threads across one row's channel groups
  int rows;     // rows of a block's share
  int staged;   // of them held in shared memory
  int g_at, red_at, stat_at, bar_at;
};

struct Plan {
  int threads, blocks, rows, staged, smem;
  Layout lay;
};

inline long long round_up_ll(long long v, long long m) {
  return (v + m - 1) / m * m;
}

// The launch plan at (M, C) for x of ex bytes an element and g of eg (0 in
// the forward) with `threads` threads a block on a card of `sms` SMs and
// `smem_max` bytes of shared memory a block; false where the reductions
// alone do not fit.
inline bool make_plan_at(long long M, int C, int ex, int eg, int threads,
                         int sms, int smem_max, Plan* p) {
  const int vec = C % 4 == 0 ? 4 : 1;
  const int groups = C / vec;
  int lanes = 1;
  while (lanes < groups && lanes < 32) lanes *= 2;
  const long long red = std::max(threads / 32 * lanes * 2 * vec, threads);
  const long long stat = (eg ? 4LL : 2LL) * C;
  const long long fixed =
      4 * round_up_ll(red, 4) + 4 * round_up_ll(stat, 4) + 8 * kStages;
  // rows per block whose bytes start on 16 (the bulk copies)
  long long unit = 1;
  if (vec == 4)
    while (unit * C * ex % 16 || unit * C * eg % 16) unit *= 2;
  const long long row_bytes = (long long)C * (ex + eg);
  long long blocks = (M * row_bytes + kBlockBytes - 1) / kBlockBytes;
  blocks = std::min<long long>(std::max<long long>(blocks, 1), sms);
  const long long rows = round_up_ll((M + blocks - 1) / blocks, unit);
  blocks = (M + rows - 1) / rows;
  const long long room = smem_max - fixed - 32;  // 32: two regions' padding
  if (room < 0 || rows > INT32_MAX) return false;
  const long long staged = std::min(rows, room / row_bytes / unit * unit);
  const long long xb = round_up_ll(staged * C * ex, 16);
  const long long gb = round_up_ll(staged * C * eg, 16);
  p->threads = threads;
  p->blocks = (int)blocks;
  p->rows = (int)rows;
  p->staged = (int)staged;
  p->smem = (int)(xb + gb + fixed);
  const long long stat_at = xb + gb + 4 * round_up_ll(red, 4);
  p->lay = {M,           C,       lanes,          (int)rows,
            (int)staged, (int)xb, (int)(xb + gb), (int)stat_at,
            (int)(stat_at + 4 * round_up_ll(stat, 4))};
  return true;
}

// The plan with kFewThreads where it stages every row, else kManyThreads.
inline bool make_plan(long long M, int C, int ex, int eg, int sms,
                      int smem_max, Plan* p) {
  if (!make_plan_at(M, C, ex, eg, kFewThreads, sms, smem_max, p))
    return false;
  return p->staged == p->rows ||
         make_plan_at(M, C, ex, eg, kManyThreads, sms, smem_max, p);
}

// ---------------------------------------------------------------------------
// device code
// ---------------------------------------------------------------------------

// The staged rows whole once groups 0..k of a copy of `bytes` have landed.
__device__ __forceinline__ int rows_landed(long long bytes,
                                           long long row_bytes, int k,
                                           int staged) {
  if (k == kStages - 1) return staged;
  const long long hi = bytes / 16 * (k + 1) / kStages;
  return (int)min((long long)staged, hi * 16 / row_bytes);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
  } while (!done);
}

// Group k's 16-byte pieces of a copy of `bytes` bytes: [lo, hi) in bytes.
__device__ __forceinline__ void bulk_range(long long bytes, int k,
                                           long long* lo, long long* hi) {
  const long long pieces = bytes / 16;
  *lo = pieces * k / kStages * 16;
  *hi = pieces * (k + 1) / kStages * 16;
}

// By one thread: group k of a copy of `bytes` bytes from src to dst (both
// aligned to 16) as one bulk copy whose bytes complete on `bar`.
template <bool HINT>
__device__ __forceinline__ void bulk_group(unsigned char* dst,
                                           const unsigned char* src,
                                           long long bytes, int k,
                                           uint64_t* bar) {
  long long lo, hi;
  bulk_range(bytes, k, &lo, &hi);
  if (hi <= lo) return;
  if constexpr (HINT)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst + lo)),
        "l"(src + lo), "r"((uint32_t)(hi - lo)), "r"(smem_u32(bar)),
        "l"(l2_evict_first())
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst + lo)),
        "l"(src + lo), "r"((uint32_t)(hi - lo)), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ uint32_t bulk_bytes(long long bytes, int k) {
  long long lo, hi;
  bulk_range(bytes, k, &lo, &hi);
  return (uint32_t)(hi - lo);
}

// The last bytes % 16 (0 or 8) of a copy, which no bulk piece takes.
__device__ __forceinline__ void copy_rest(unsigned char* dst,
                                          const unsigned char* src,
                                          long long bytes) {
  if (bytes % 16) {
    const long long at = bytes / 16 * 16;
    *reinterpret_cast<uint2*>(dst + at) =
        *reinterpret_cast<const uint2*>(src + at);
  }
}

// The first row at or after `lo` that thread row r takes: rows r, r +
// rstep, ... of the share, whatever the staging's group boundaries, so that
// a thread's sums do not depend on them.
__device__ __forceinline__ int first_row(int lo, int r, int rstep) {
  return lo + (r - lo % rstep + rstep) % rstep;
}

// The block's sums s, q of channels [col, col + VEC) into out[col + k] and
// out[C + col + k]: a warp's rows by a butterfly over the row bits of the
// lane, then the warps in order.
template <int VEC, int NT>
__device__ __forceinline__ void block_partial(float s[VEC], float q[VEC],
                                              float* red, float* out, int C,
                                              int col, bool active, int lane,
                                              int lanes) {
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
      q[k] += __shfl_xor_sync(0xffffffffu, q[k], off);
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) < lanes) {
    float* mine = red + (size_t)(warp * lanes + lane) * 2 * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      mine[k] = s[k];
      mine[VEC + k] = q[k];
    }
  }
  __syncthreads();
  if (threadIdx.x < lanes && active) {
    float ts[VEC], tq[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) ts[k] = tq[k] = 0.f;
    for (int w = 0; w < NT / 32; ++w) {
      const float* other = red + (size_t)(w * lanes + lane) * 2 * VEC;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        ts[k] += other[k];
        tq[k] += other[VEC + k];
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      out[col + k] = ts[k];
      out[C + col + k] = tq[k];
    }
  }
  __syncthreads();
}

// st[v] = the sum over blocks b < G of partial[b * nv + v], v < nv, in a
// fixed order, so that every block takes the same sums. Where nv / 4 is a
// power of two up to 32, a thread takes one float4 of values (q) of blocks
// j, j + ways, ... (eight 16-byte loads in flight; a warp reads 512
// contiguous bytes), a butterfly adds a warp's threads of one q, and the
// warps' sums are added in order through `red` (NT / 32 x nv floats, which
// the plan's reduction scratch holds wherever this path is taken). Else a
// thread adds one value's blocks in order.
template <int NT>
__device__ __forceinline__ void finish_sums(const float* partial, float* red,
                                            float* st, int nv, int G) {
  const int nq = nv / 4;
  if (nv % 4 == 0 && nq <= 32 && (nq & (nq - 1)) == 0) {
    const int q = threadIdx.x % nq, j = threadIdx.x / nq;
    const int ways = NT / nq;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = j; b < G; b += 8 * ways) {
      float4 t[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int bi = b + i * ways;
        t[i] = bi < G ? __ldcg(reinterpret_cast<const float4*>(
                            partial + (long long)bi * nv) + q)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc.x += t[i].x;
        acc.y += t[i].y;
        acc.z += t[i].z;
        acc.w += t[i].w;
      }
    }
    for (int off = nq; off < 32; off <<= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) < nq)
      reinterpret_cast<float4*>(red)[warp * nq + q] = acc;
    __syncthreads();
    if (threadIdx.x < nv) {
      float sum = red[threadIdx.x];
      for (int w = 1; w < NT / 32; ++w) sum += red[w * nv + threadIdx.x];
      st[threadIdx.x] = sum;
    }
  } else {
    for (int v = threadIdx.x; v < nv; v += NT) {
      float acc = 0.f;
      for (int b = 0; b < G; ++b)
        acc += __ldcg(partial + (long long)b * nv + v);
      st[v] = acc;
    }
  }
  __syncthreads();
}

// partial: [gridDim.x, 2, C] (sum, sum of squares); stat: [2, C].
template <typename T, typename TO, int VEC, int NT>
__global__ void __launch_bounds__(NT, 1)
    bn_fwd_kernel(const T* __restrict__ x, TO* __restrict__ y,
                  float* __restrict__ stat, unsigned* __restrict__ ctr,
                  float* __restrict__ partial, Layout L, float inv_count,
                  float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kHint = NT == kManyThreads;  // rows read twice
  const int C = L.C;
  const long long r0 = (long long)blockIdx.x * L.rows;
  const int nrows = (int)min((long long)L.rows, L.M - r0);
  const int nst = min(L.staged, nrows);
  const T* xb = x + r0 * C;
  TO* yb = y + r0 * C;
  const T* xs = reinterpret_cast<const T*>(smem);
  float* red = reinterpret_cast<float*>(smem + L.red_at);
  float* st = reinterpret_cast<float*>(smem + L.stat_at);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_at);
  const long long row_bytes = (long long)C * sizeof(T);
  const long long xbytes = nst * row_bytes;
  const unsigned char* xsrc = reinterpret_cast<const unsigned char*>(xb);
  if constexpr (VEC == 4) {
    if (threadIdx.x == 0) {
      for (int k = 0; k < kStages; ++k) bar_init(&bars[k]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int k = 0; k < kStages; ++k) {
        bar_expect(&bars[k], bulk_bytes(xbytes, k));
        bulk_group<kHint>(smem, xsrc, xbytes, k, &bars[k]);
      }
    }
    if (threadIdx.x == 32) copy_rest(smem, xsrc, xbytes);
  } else {
    T* dst = reinterpret_cast<T*>(smem);
    for (long long i = threadIdx.x; i < (long long)nst * C; i += NT)
      dst[i] = xb[i];
  }
  __syncthreads();  // the mbarriers initialized; plain copies visible

  const int lanes = L.lanes, lane = threadIdx.x % lanes;
  const int r = threadIdx.x / lanes, rstep = NT / lanes;
  const int groups = C / VEC;
  const uint64_t keep = l2_evict_last();
  for (int g0 = 0; g0 < groups; g0 += lanes) {
    const int grp = g0 + lane, col = grp * VEC;
    const bool active = grp < groups;
    float s[VEC], q[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.f;
    if (active) {  // the rows past the staged ones, from device memory
#pragma unroll 4
      for (int row = first_row(nst, r, rstep); row < nrows;
           row += rstep) {
        float v[VEC];
        load_keep<kHint, T, VEC>(xb + (long long)row * C + col, v, keep);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          s[k] += v[k];
          q[k] = fmaf(v[k], v[k], q[k]);
        }
      }
    }
    int lo = 0;
#pragma unroll
    for (int k = 0; k < kStages; ++k) {
      if (VEC == 4 && g0 == 0) bar_wait(&bars[k]);
      const int hi = rows_landed(xbytes, row_bytes, k, nst);
      if (active) {
#pragma unroll 4
        for (int row = first_row(lo, r, rstep); row < hi;
             row += rstep) {
          float v[VEC];
          load_vec<T, VEC>(xs + (long long)row * C + col, v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            s[j] += v[j];
            q[j] = fmaf(v[j], v[j], q[j]);
          }
        }
      }
      lo = hi;
    }
    block_partial<VEC, NT>(s, q, red, partial + (long long)blockIdx.x * 2 * C, C,
                       col, active, lane, lanes);
  }

  seq::grid_arrive(ctr);
  seq::grid_wait(ctr, gridDim.x);
  finish_sums<NT>(partial, red, st, 2 * C, gridDim.x);
  for (int c = threadIdx.x; c < C; c += NT) {
    const float mean = st[c] * inv_count;
    const float var = st[C + c] * inv_count - mean * mean;
    const float rstd = 1.f / sqrtf(var + eps);
    st[c] = mean;
    st[C + c] = rstd;
    if (blockIdx.x == 0) {
      stat[c] = mean;
      stat[C + c] = rstd;
    }
  }
  __syncthreads();

  for (int g0 = 0; g0 < groups; g0 += lanes) {
    const int grp = g0 + lane, col = grp * VEC;
    if (grp >= groups) continue;
    float mean[VEC], rstd[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      mean[k] = st[col + k];
      rstd[k] = st[C + col + k];
    }
#pragma unroll 4
    for (int row = r; row < nst; row += rstep) {
      const long long at = (long long)row * C + col;
      float v[VEC];
      load_vec<T, VEC>(xs + at, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = (v[k] - mean[k]) * rstd[k];
      store_out<kHint, TO, VEC>(yb + at, v);
    }
#pragma unroll 4
    for (int row = first_row(nst, r, rstep); row < nrows;
           row += rstep) {
      const long long at = (long long)row * C + col;
      float v[VEC];
      load_last<kHint, T, VEC>(xb + at, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = (v[k] - mean[k]) * rstd[k];
      store_out<kHint, TO, VEC>(yb + at, v);
    }
  }
}

// partial: [gridDim.x, 2, C] (sum g, sum g * xhat); stat: the forward's.
template <typename T, typename TG, int VEC, int NT>
__global__ void __launch_bounds__(NT, 1)
    bn_bwd_kernel(const T* __restrict__ x, const TG* __restrict__ g,
                  const float* __restrict__ stat, T* __restrict__ dx,
                  unsigned* __restrict__ ctr, float* __restrict__ partial,
                  Layout L, float inv_count) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kHint = NT == kManyThreads;  // rows read twice
  const int C = L.C;
  const long long r0 = (long long)blockIdx.x * L.rows;
  const int nrows = (int)min((long long)L.rows, L.M - r0);
  const int nst = min(L.staged, nrows);
  const T* xb = x + r0 * C;
  const TG* gb = g + r0 * C;
  T* db = dx + r0 * C;
  const T* xs = reinterpret_cast<const T*>(smem);
  const TG* gs = reinterpret_cast<const TG*>(smem + L.g_at);
  float* red = reinterpret_cast<float*>(smem + L.red_at);
  float* st = reinterpret_cast<float*>(smem + L.stat_at);  // [4, C]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_at);
  const long long xrow = (long long)C * sizeof(T);
  const long long grow = (long long)C * sizeof(TG);
  const long long xbytes = nst * xrow, gbytes = nst * grow;
  const unsigned char* xsrc = reinterpret_cast<const unsigned char*>(xb);
  const unsigned char* gsrc = reinterpret_cast<const unsigned char*>(gb);
  if constexpr (VEC == 4) {
    if (threadIdx.x == 0) {
      for (int k = 0; k < kStages; ++k) bar_init(&bars[k]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int k = 0; k < kStages; ++k) {
        bar_expect(&bars[k], bulk_bytes(xbytes, k) + bulk_bytes(gbytes, k));
        bulk_group<kHint>(smem, xsrc, xbytes, k, &bars[k]);
        bulk_group<kHint>(smem + L.g_at, gsrc, gbytes, k, &bars[k]);
      }
    }
    if (threadIdx.x == 32) {
      copy_rest(smem, xsrc, xbytes);
      copy_rest(smem + L.g_at, gsrc, gbytes);
    }
  } else {
    T* xd = reinterpret_cast<T*>(smem);
    TG* gd = reinterpret_cast<TG*>(smem + L.g_at);
    for (long long i = threadIdx.x; i < (long long)nst * C; i += NT) {
      xd[i] = xb[i];
      gd[i] = gb[i];
    }
  }
  for (int c = threadIdx.x; c < 2 * C; c += NT) st[c] = stat[c];
  __syncthreads();

  const int lanes = L.lanes, lane = threadIdx.x % lanes;
  const int r = threadIdx.x / lanes, rstep = NT / lanes;
  const int groups = C / VEC;
  const uint64_t keep = l2_evict_last();
  for (int g0 = 0; g0 < groups; g0 += lanes) {
    const int grp = g0 + lane, col = grp * VEC;
    const bool active = grp < groups;
    float s[VEC], q[VEC], mean[VEC], rstd[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s[k] = q[k] = 0.f;
      mean[k] = active ? st[col + k] : 0.f;
      rstd[k] = active ? st[C + col + k] : 0.f;
    }
    if (active) {  // the rows past the staged ones, from device memory
#pragma unroll 4
      for (int row = first_row(nst, r, rstep); row < nrows;
           row += rstep) {
        const long long at = (long long)row * C + col;
        float v[VEC], gv[VEC];
        load_keep<kHint, T, VEC>(xb + at, v, keep);
        load_keep<kHint, TG, VEC>(gb + at, gv, keep);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          s[k] += gv[k];
          q[k] = fmaf(gv[k], (v[k] - mean[k]) * rstd[k], q[k]);
        }
      }
    }
    int lo = 0;
#pragma unroll
    for (int k = 0; k < kStages; ++k) {
      if (VEC == 4 && g0 == 0) bar_wait(&bars[k]);
      const int hi = min(rows_landed(xbytes, xrow, k, nst),
                         rows_landed(gbytes, grow, k, nst));
      if (active) {
#pragma unroll 4
        for (int row = first_row(lo, r, rstep); row < hi;
             row += rstep) {
          const long long at = (long long)row * C + col;
          float v[VEC], gv[VEC];
          load_vec<T, VEC>(xs + at, v);
          load_vec<TG, VEC>(gs + at, gv);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            s[j] += gv[j];
            q[j] = fmaf(gv[j], (v[j] - mean[j]) * rstd[j], q[j]);
          }
        }
      }
      lo = hi;
    }
    block_partial<VEC, NT>(s, q, red, partial + (long long)blockIdx.x * 2 * C, C,
                       col, active, lane, lanes);
  }

  seq::grid_arrive(ctr);
  seq::grid_wait(ctr, gridDim.x);
  finish_sums<NT>(partial, red, st + 2 * C, 2 * C, gridDim.x);
  for (int c = threadIdx.x; c < 2 * C; c += NT)
    st[2 * C + c] *= inv_count;  // mean g, mean g * xhat
  __syncthreads();

  for (int g0 = 0; g0 < groups; g0 += lanes) {
    const int grp = g0 + lane, col = grp * VEC;
    if (grp >= groups) continue;
    float mean[VEC], rstd[VEC], gm[VEC], gxm[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      mean[k] = st[col + k];
      rstd[k] = st[C + col + k];
      gm[k] = st[2 * C + col + k];
      gxm[k] = st[3 * C + col + k];
    }
#pragma unroll 4
    for (int row = r; row < nst; row += rstep) {
      const long long at = (long long)row * C + col;
      float v[VEC], gv[VEC];
      load_vec<T, VEC>(xs + at, v);
      load_vec<TG, VEC>(gs + at, gv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xhat = (v[k] - mean[k]) * rstd[k];
        v[k] = rstd[k] * (gv[k] - gm[k] - xhat * gxm[k]);
      }
      store_out<kHint, T, VEC>(db + at, v);
    }
#pragma unroll 4
    for (int row = first_row(nst, r, rstep); row < nrows;
           row += rstep) {
      const long long at = (long long)row * C + col;
      float v[VEC], gv[VEC];
      load_last<kHint, T, VEC>(xb + at, v);
      load_last<kHint, TG, VEC>(gb + at, gv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xhat = (v[k] - mean[k]) * rstd[k];
        v[k] = rstd[k] * (gv[k] - gm[k] - xhat * gxm[k]);
      }
      store_out<kHint, T, VEC>(db + at, v);
    }
  }
}

// ---------------------------------------------------------------------------
// the two-launch mode
// ---------------------------------------------------------------------------

constexpr int kSyncThreads = 256;
constexpr int kSyncBlocksPerSM = 4;
// block_partial's scratch (warps x 32 lanes x 2 x 4 floats), which also
// holds finish_sums' (warps x 2C floats where it takes its fast path, C <=
// 64)
constexpr int kSyncRed = kSyncThreads / 32 * 32 * 2 * 4;

struct SyncPlan {
  int blocks, rows, lanes;
};

// The grid over [M, C] with x of ex bytes an element and g of eg (0 where
// the launch reads no g): a block per kBlockBytes of the tensor, at most
// kSyncBlocksPerSM an SM, each a whole number of rows; false where M does
// not fit.
inline bool make_sync_plan(long long M, int C, int ex, int eg, int sms,
                           SyncPlan* p) {
  const int vec = C % 4 == 0 ? 4 : 1;
  const int groups = C / vec;
  int lanes = 1;
  while (lanes < groups && lanes < 32) lanes *= 2;
  const long long row_bytes = (long long)C * (ex + eg);
  long long blocks = (M * row_bytes + kBlockBytes - 1) / kBlockBytes;
  blocks = std::min<long long>(std::max<long long>(blocks, 1),
                               (long long)kSyncBlocksPerSM * sms);
  const long long rows = (M + blocks - 1) / blocks;
  if (rows > INT32_MAX) return false;
  p->rows = (int)rows;
  p->blocks = (int)((M + rows - 1) / rows);
  p->lanes = lanes;
  return true;
}

// sums [2, C]: forward (BWD false) sum x, sum x^2; backward sum g, sum g *
// xhat with xhat = (x - stat[0]) * stat[1]. partial: [gridDim.x, 2, C];
// ctr: zero at launch.
template <typename T, typename TG, bool BWD, int VEC>
__global__ void __launch_bounds__(kSyncThreads)
    bn_sums_kernel(const T* __restrict__ x, const TG* __restrict__ g,
                   const float* __restrict__ stat, float* __restrict__ sums,
                   unsigned* __restrict__ ctr, float* __restrict__ partial,
                   long long M, int C, int rows, int lanes) {
  __shared__ __align__(16) float red[kSyncRed];
  __shared__ bool last;
  const long long r0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, M - r0);
  const T* xb = x + r0 * C;
  const TG* gb = g + (BWD ? r0 * C : 0);
  const int lane = threadIdx.x % lanes, r = threadIdx.x / lanes;
  const int rstep = kSyncThreads / lanes, groups = C / VEC;
  for (int g0 = 0; g0 < groups; g0 += lanes) {
    const int grp = g0 + lane, col = grp * VEC;
    const bool active = grp < groups;
    float s[VEC], q[VEC], mean[VEC], rstd[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s[k] = q[k] = 0.f;
      mean[k] = BWD && active ? stat[col + k] : 0.f;
      rstd[k] = BWD && active ? stat[C + col + k] : 0.f;
    }
    if (active) {
#pragma unroll 4
      for (int row = r; row < nrows; row += rstep) {
        const long long at = (long long)row * C + col;
        float v[VEC];
        load_vec<T, VEC>(xb + at, v);
        if constexpr (BWD) {
          float gv[VEC];
          load_vec<TG, VEC>(gb + at, gv);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            s[k] += gv[k];
            q[k] = fmaf(gv[k], (v[k] - mean[k]) * rstd[k], q[k]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            s[k] += v[k];
            q[k] = fmaf(v[k], v[k], q[k]);
          }
        }
      }
    }
    block_partial<VEC, kSyncThreads>(
        s, q, red, partial + (long long)blockIdx.x * 2 * C, C, col, active,
        lane, lanes);
  }
  // the last block to finish adds every block's partial in block order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ctr, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  finish_sums<kSyncThreads>(partial, red, sums, 2 * C, gridDim.x);
}

// y = (x - mean) * rstd with mean = sums[0] / count and rstd = 1/sqrt(
// sums[1] / count - mean^2 + eps); block 0 writes (mean, rstd) to stat.
// Dynamic shared memory: 2C floats.
template <typename T, typename TO, int VEC>
__global__ void __launch_bounds__(kSyncThreads)
    bn_fwd_apply_kernel(const T* __restrict__ x, TO* __restrict__ y,
                        const float* __restrict__ sums,
                        float* __restrict__ stat, long long M, int C,
                        int rows, int lanes, float inv_count, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem);
  for (int c = threadIdx.x; c < C; c += kSyncThreads) {
    const float mean = sums[c] * inv_count;
    const float var = sums[C + c] * inv_count - mean * mean;
    const float rstd = 1.f / sqrtf(var + eps);
    st[c] = mean;
    st[C + c] = rstd;
    if (blockIdx.x == 0) {
      stat[c] = mean;
      stat[C + c] = rstd;
    }
  }
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, M - r0);
  const T* xb = x + r0 * C;
  TO* yb = y + r0 * C;
  const int lane = threadIdx.x % lanes, r = threadIdx.x / lanes;
  const int rstep = kSyncThreads / lanes, groups = C / VEC;
  for (int g0 = 0; g0 < groups; g0 += lanes) {
    const int grp = g0 + lane, col = grp * VEC;
    if (grp >= groups) continue;
    float mean[VEC], rstd[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      mean[k] = st[col + k];
      rstd[k] = st[C + col + k];
    }
#pragma unroll 4
    for (int row = r; row < nrows; row += rstep) {
      const long long at = (long long)row * C + col;
      float v[VEC];
      load_vec<T, VEC>(xb + at, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = (v[k] - mean[k]) * rstd[k];
      store_vec<TO, VEC>(yb + at, v);
    }
  }
}

// dx = rstd * (g - sums[0] / count - xhat * sums[1] / count), xhat = (x -
// mean) * rstd from the forward's stat. Dynamic shared memory: 4C floats.
template <typename T, typename TG, int VEC>
__global__ void __launch_bounds__(kSyncThreads)
    bn_bwd_apply_kernel(const T* __restrict__ x, const TG* __restrict__ g,
                        const float* __restrict__ stat,
                        const float* __restrict__ sums, T* __restrict__ dx,
                        long long M, int C, int rows, int lanes,
                        float inv_count) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem);  // mean, rstd, mean g, g xhat
  for (int c = threadIdx.x; c < 2 * C; c += kSyncThreads) {
    st[c] = stat[c];
    st[2 * C + c] = sums[c] * inv_count;
  }
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, M - r0);
  const T* xb = x + r0 * C;
  const TG* gb = g + r0 * C;
  T* db = dx + r0 * C;
  const int lane = threadIdx.x % lanes, r = threadIdx.x / lanes;
  const int rstep = kSyncThreads / lanes, groups = C / VEC;
  for (int g0 = 0; g0 < groups; g0 += lanes) {
    const int grp = g0 + lane, col = grp * VEC;
    if (grp >= groups) continue;
    float mean[VEC], rstd[VEC], gm[VEC], gxm[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      mean[k] = st[col + k];
      rstd[k] = st[C + col + k];
      gm[k] = st[2 * C + col + k];
      gxm[k] = st[3 * C + col + k];
    }
#pragma unroll 4
    for (int row = r; row < nrows; row += rstep) {
      const long long at = (long long)row * C + col;
      float v[VEC], gv[VEC];
      load_vec<T, VEC>(xb + at, v);
      load_vec<TG, VEC>(gb + at, gv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xhat = (v[k] - mean[k]) * rstd[k];
        v[k] = rstd[k] * (gv[k] - gm[k] - xhat * gxm[k]);
      }
      store_vec<T, VEC>(db + at, v);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Card {
  int sms, smem;
};

// The current device's SM count and shared memory a block may opt into,
// asked once per device; an error where it has no cooperative launch.
inline cudaError_t current_card(int* dev, Card* card) {
  static Card cards[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < kMaxDevices && cards[*dev].sms) {
    *card = cards[*dev];
    return cudaSuccess;
  }
  int coop = 0;
  Card c{};
  cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, *dev);
  cudaDeviceGetAttribute(&c.smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         *dev);
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, *dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (*dev < kMaxDevices) cards[*dev] = c;
  *card = c;
  return cudaSuccess;
}

inline int elem_bytes(int dtype) { return dtype == kBFloat16 ? 2 : 4; }

inline cudaError_t plan_for(long long M, int C, int x_dtype, int g_dtype,
                            int* dev, Card* card, Plan* plan) {
  if (M < 1 || C < 1 || (x_dtype != kFloat32 && x_dtype != kBFloat16))
    return cudaErrorInvalidValue;
  cudaError_t err = current_card(dev, card);
  if (err != cudaSuccess) return err;
  const int eg = g_dtype < 0 ? 0 : elem_bytes(g_dtype);
  if (!make_plan(M, C, elem_bytes(x_dtype), eg, card->sms, card->smem, plan))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Opt `fn` into the card's shared memory once per device.
inline cudaError_t allow_smem(const void* fn, bool* done, int dev,
                              int smem) {
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, typename TO, int VEC, int NT>
cudaError_t launch_fwd(const void* x, void* y, void* stat, void* scratch,
                       const Plan& p, int dev, int smem_max, float eps,
                       cudaStream_t s) {
  static bool done[kMaxDevices];
  const void* fn = (const void*)bn_fwd_kernel<T, TO, VEC, NT>;
  cudaError_t err = allow_smem(fn, done, dev, smem_max);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(scratch, 0, kSyncBytes, s);
  if (err != cudaSuccess) return err;
  const T* xp = (const T*)x;
  TO* yp = (TO*)y;
  float* sp = (float*)stat;
  unsigned* ctr = (unsigned*)scratch;
  float* partial = (float*)((unsigned char*)scratch + kSyncBytes);
  Layout lay = p.lay;
  float inv = 1.f / (float)lay.M;
  void* args[] = {&xp, &yp, &sp, &ctr, &partial, &lay, &inv, &eps};
  return cudaLaunchCooperativeKernel(fn, dim3(p.blocks), dim3(NT), args,
                                     (size_t)p.smem, s);
}

template <typename T, typename TO>
cudaError_t launch_fwd_vec(const void* x, void* y, void* stat, void* scratch,
                           const Plan& p, int dev, int smem_max, float eps,
                           cudaStream_t s) {
  const bool few = p.threads == kFewThreads;
  if (p.lay.C % 4 == 0)
    return few ? launch_fwd<T, TO, 4, kFewThreads>(x, y, stat, scratch, p,
                                                   dev, smem_max, eps, s)
               : launch_fwd<T, TO, 4, kManyThreads>(x, y, stat, scratch, p,
                                                    dev, smem_max, eps, s);
  return few ? launch_fwd<T, TO, 1, kFewThreads>(x, y, stat, scratch, p, dev,
                                                 smem_max, eps, s)
             : launch_fwd<T, TO, 1, kManyThreads>(x, y, stat, scratch, p, dev,
                                                  smem_max, eps, s);
}

template <typename T, typename TG, int VEC, int NT>
cudaError_t launch_bwd(const void* x, const void* g, const void* stat,
                       void* dx, void* scratch, const Plan& p, int dev,
                       int smem_max, cudaStream_t s) {
  static bool done[kMaxDevices];
  const void* fn = (const void*)bn_bwd_kernel<T, TG, VEC, NT>;
  cudaError_t err = allow_smem(fn, done, dev, smem_max);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(scratch, 0, kSyncBytes, s);
  if (err != cudaSuccess) return err;
  const T* xp = (const T*)x;
  const TG* gp = (const TG*)g;
  const float* sp = (const float*)stat;
  T* dp = (T*)dx;
  unsigned* ctr = (unsigned*)scratch;
  float* partial = (float*)((unsigned char*)scratch + kSyncBytes);
  Layout lay = p.lay;
  float inv = 1.f / (float)lay.M;
  void* args[] = {&xp, &gp, &sp, &dp, &ctr, &partial, &lay, &inv};
  return cudaLaunchCooperativeKernel(fn, dim3(p.blocks), dim3(NT), args,
                                     (size_t)p.smem, s);
}

template <typename T, typename TG>
cudaError_t launch_bwd_vec(const void* x, const void* g, const void* stat,
                           void* dx, void* scratch, const Plan& p, int dev,
                           int smem_max, cudaStream_t s) {
  const bool few = p.threads == kFewThreads;
  if (p.lay.C % 4 == 0)
    return few ? launch_bwd<T, TG, 4, kFewThreads>(x, g, stat, dx, scratch, p,
                                                   dev, smem_max, s)
               : launch_bwd<T, TG, 4, kManyThreads>(x, g, stat, dx, scratch,
                                                    p, dev, smem_max, s);
  return few ? launch_bwd<T, TG, 1, kFewThreads>(x, g, stat, dx, scratch, p,
                                                 dev, smem_max, s)
             : launch_bwd<T, TG, 1, kManyThreads>(x, g, stat, dx, scratch, p,
                                                  dev, smem_max, s);
}

// The two-launch mode's plan on the current device, refused unless its
// grid is `blocks` (ops/cuda_bn.py::sync_plan's).
inline cudaError_t sync_plan_for(long long M, int C, int x_dtype,
                                 int g_dtype, int blocks, SyncPlan* plan) {
  if (M < 1 || C < 1 || (x_dtype != kFloat32 && x_dtype != kBFloat16) ||
      (g_dtype >= 0 && g_dtype != kFloat32 && g_dtype != kBFloat16))
    return cudaErrorInvalidValue;
  int dev = 0;
  Card card;
  cudaError_t err = current_card(&dev, &card);
  if (err != cudaSuccess) return err;
  const int eg = g_dtype < 0 ? 0 : elem_bytes(g_dtype);
  if (!make_sync_plan(M, C, elem_bytes(x_dtype), eg, card.sms, plan) ||
      plan->blocks != blocks)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T, typename TG, bool BWD>
cudaError_t launch_sums(const void* x, const void* g, const void* stat,
                        void* sums, void* scratch, const SyncPlan& p,
                        long long M, int C, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(scratch, 0, kSyncBytes, s);
  if (err != cudaSuccess) return err;
  unsigned* ctr = (unsigned*)scratch;
  float* partial = (float*)((unsigned char*)scratch + kSyncBytes);
  if (C % 4 == 0)
    bn_sums_kernel<T, TG, BWD, 4><<<p.blocks, kSyncThreads, 0, s>>>(
        (const T*)x, (const TG*)g, (const float*)stat, (float*)sums, ctr,
        partial, M, C, p.rows, p.lanes);
  else
    bn_sums_kernel<T, TG, BWD, 1><<<p.blocks, kSyncThreads, 0, s>>>(
        (const T*)x, (const TG*)g, (const float*)stat, (float*)sums, ctr,
        partial, M, C, p.rows, p.lanes);
  return cudaGetLastError();
}

// Opt a kernel into `bytes` of dynamic shared memory where that passes the
// default 48 KB (C above 3,072 channels).
inline cudaError_t sync_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, typename TO>
cudaError_t launch_fwd_apply(const void* x, void* y, const void* sums,
                             void* stat, const SyncPlan& p, long long M,
                             int C, float inv_count, float eps,
                             cudaStream_t s) {
  const int smem = 2 * C * (int)sizeof(float);
  const void* fn = C % 4 == 0 ? (const void*)bn_fwd_apply_kernel<T, TO, 4>
                              : (const void*)bn_fwd_apply_kernel<T, TO, 1>;
  cudaError_t err = sync_smem(fn, smem);
  if (err != cudaSuccess) return err;
  if (C % 4 == 0)
    bn_fwd_apply_kernel<T, TO, 4><<<p.blocks, kSyncThreads, smem, s>>>(
        (const T*)x, (TO*)y, (const float*)sums, (float*)stat, M, C, p.rows,
        p.lanes, inv_count, eps);
  else
    bn_fwd_apply_kernel<T, TO, 1><<<p.blocks, kSyncThreads, smem, s>>>(
        (const T*)x, (TO*)y, (const float*)sums, (float*)stat, M, C, p.rows,
        p.lanes, inv_count, eps);
  return cudaGetLastError();
}

template <typename T, typename TG>
cudaError_t launch_bwd_apply(const void* x, const void* g, const void* stat,
                             const void* sums, void* dx, const SyncPlan& p,
                             long long M, int C, float inv_count,
                             cudaStream_t s) {
  const int smem = 4 * C * (int)sizeof(float);
  const void* fn = C % 4 == 0 ? (const void*)bn_bwd_apply_kernel<T, TG, 4>
                              : (const void*)bn_bwd_apply_kernel<T, TG, 1>;
  cudaError_t err = sync_smem(fn, smem);
  if (err != cudaSuccess) return err;
  if (C % 4 == 0)
    bn_bwd_apply_kernel<T, TG, 4><<<p.blocks, kSyncThreads, smem, s>>>(
        (const T*)x, (const TG*)g, (const float*)stat, (const float*)sums,
        (T*)dx, M, C, p.rows, p.lanes, inv_count);
  else
    bn_bwd_apply_kernel<T, TG, 1><<<p.blocks, kSyncThreads, smem, s>>>(
        (const T*)x, (const TG*)g, (const float*)stat, (const float*)sums,
        (T*)dx, M, C, p.rows, p.lanes, inv_count);
  return cudaGetLastError();
}

}  // namespace bn
}  // namespace
}  // namespace lctvqa

extern "C" {

// The launch shape of lctvqa_bn_fwd (g_dtype < 0) or lctvqa_bn_bwd at
// (M, C) on the current device: out = {blocks, threads, rows a block,
// rows staged in shared memory, bytes of shared memory}.
int lctvqa_bn_plan(long long M, int C, int x_dtype, int g_dtype, int* out) {
  using namespace lctvqa;
  int dev = 0;
  bn::Card card;
  bn::Plan p;
  const cudaError_t err = bn::plan_for(M, C, x_dtype, g_dtype, &dev, &card,
                                       &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.blocks;
  out[1] = p.threads;
  out[2] = p.rows;
  out[3] = p.staged;
  out[4] = p.smem;
  return 0;
}

// x: [M, C] contiguous in `in_dtype`, 16-byte aligned where C % 4 == 0;
// y: [M, C] in `out_dtype`; stat: fp32 [2, C], left holding mean and
// 1/sqrt(var + eps); scratch: the barrier's counter (16 bytes, zeroed
// here), then fp32 [blocks, 2, C]; 4-byte aligned, 16 where C is even;
// `blocks` is the plan's (ops/cuda_bn.py::bn_plan; a plan of another size
// is refused). M >= 1, C >= 1.
int lctvqa_bn_fwd(const void* x, void* y, void* stat, void* scratch,
                  int blocks, long long M, int C, float eps, int in_dtype,
                  int out_dtype, void* stream) {
  using namespace lctvqa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  bn::Card card;
  bn::Plan p;
  cudaError_t rc = bn::plan_for(M, C, in_dtype, -1, &dev, &card, &p);
  if (rc != cudaSuccess) return (int)rc;
  if (p.blocks != blocks) return (int)cudaErrorInvalidValue;
  rc = cudaErrorInvalidValue;
  if (in_dtype == kFloat32 && out_dtype == kFloat32)
    rc = bn::launch_fwd_vec<float, float>(x, y, stat, scratch, p, dev,
                                          card.smem, eps, s);
  else if (in_dtype == kFloat32 && out_dtype == kBFloat16)
    rc = bn::launch_fwd_vec<float, __nv_bfloat16>(x, y, stat, scratch, p,
                                                  dev, card.smem, eps, s);
  else if (in_dtype == kBFloat16 && out_dtype == kFloat32)
    rc = bn::launch_fwd_vec<__nv_bfloat16, float>(x, y, stat, scratch, p,
                                                  dev, card.smem, eps, s);
  else if (in_dtype == kBFloat16 && out_dtype == kBFloat16)
    rc = bn::launch_fwd_vec<__nv_bfloat16, __nv_bfloat16>(
        x, y, stat, scratch, p, dev, card.smem, eps, s);
  return (int)rc;
}

// x: [M, C] contiguous in `x_dtype`; g: [M, C] contiguous in `g_dtype`,
// both 16-byte aligned where C % 4 == 0; stat: the forward's fp32 [2, C];
// dx: [M, C] in `x_dtype`; scratch and blocks as for lctvqa_bn_fwd, with
// the backward's plan.
int lctvqa_bn_bwd(const void* x, const void* g, const void* stat, void* dx,
                  void* scratch, int blocks, long long M, int C, int x_dtype,
                  int g_dtype, void* stream) {
  using namespace lctvqa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  bn::Card card;
  bn::Plan p;
  if (g_dtype != kFloat32 && g_dtype != kBFloat16)
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = bn::plan_for(M, C, x_dtype, g_dtype, &dev, &card, &p);
  if (rc != cudaSuccess) return (int)rc;
  if (p.blocks != blocks) return (int)cudaErrorInvalidValue;
  rc = cudaErrorInvalidValue;
  if (x_dtype == kFloat32 && g_dtype == kFloat32)
    rc = bn::launch_bwd_vec<float, float>(x, g, stat, dx, scratch, p, dev,
                                          card.smem, s);
  else if (x_dtype == kFloat32 && g_dtype == kBFloat16)
    rc = bn::launch_bwd_vec<float, __nv_bfloat16>(x, g, stat, dx, scratch, p,
                                                  dev, card.smem, s);
  else if (x_dtype == kBFloat16 && g_dtype == kFloat32)
    rc = bn::launch_bwd_vec<__nv_bfloat16, float>(x, g, stat, dx, scratch, p,
                                                  dev, card.smem, s);
  else if (x_dtype == kBFloat16 && g_dtype == kBFloat16)
    rc = bn::launch_bwd_vec<__nv_bfloat16, __nv_bfloat16>(
        x, g, stat, dx, scratch, p, dev, card.smem, s);
  return (int)rc;
}

// The two-launch mode (several ranks). x: [M, C] contiguous in `x_dtype`;
// g: [M, C] contiguous in `g_dtype`; both 8-byte aligned (16 for fp32)
// where C % 4 == 0. sums: fp32 [2, C]. stat: fp32 [2, C] (mean,
// 1/sqrt(var + eps)): written by lctvqa_bn_fwd_apply, read by the
// backward's. scratch: the counter (16 bytes, zeroed here), then fp32
// [blocks, 2, C]. `blocks` is ops/cuda_bn.py::sync_plan's grid (a grid of
// another size is refused); `count` the global number of rows, the sum of
// every rank's M.
int lctvqa_bn_sync_plan(long long M, int C, int x_dtype, int g_dtype,
                        int* out) {
  using namespace lctvqa;
  int dev = 0;
  bn::Card card;
  cudaError_t err = bn::current_card(&dev, &card);
  if (err != cudaSuccess) return (int)err;
  bn::SyncPlan p;
  const int eg = g_dtype < 0 ? 0 : bn::elem_bytes(g_dtype);
  if (M < 1 || C < 1 ||
      !bn::make_sync_plan(M, C, bn::elem_bytes(x_dtype), eg, card.sms, &p))
    return (int)cudaErrorInvalidValue;
  out[0] = p.blocks;
  out[1] = p.rows;
  out[2] = p.lanes;
  return 0;
}

int lctvqa_bn_fwd_sums(const void* x, void* sums, void* scratch, int blocks,
                       long long M, int C, int x_dtype, void* stream) {
  using namespace lctvqa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bn::SyncPlan p;
  cudaError_t rc = bn::sync_plan_for(M, C, x_dtype, -1, blocks, &p);
  if (rc != cudaSuccess) return (int)rc;
  if (x_dtype == kFloat32)
    rc = bn::launch_sums<float, float, false>(x, nullptr, nullptr, sums,
                                              scratch, p, M, C, s);
  else
    rc = bn::launch_sums<__nv_bfloat16, float, false>(
        x, nullptr, nullptr, sums, scratch, p, M, C, s);
  return (int)rc;
}

int lctvqa_bn_fwd_apply(const void* x, void* y, const void* sums, void* stat,
                        int blocks, long long M, int C, long long count,
                        float eps, int x_dtype, int out_dtype, void* stream) {
  using namespace lctvqa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bn::SyncPlan p;
  cudaError_t rc = bn::sync_plan_for(M, C, x_dtype, -1, blocks, &p);
  if (rc != cudaSuccess) return (int)rc;
  if (count < M || (out_dtype != kFloat32 && out_dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  const float inv = 1.f / (float)count;
  if (x_dtype == kFloat32 && out_dtype == kFloat32)
    rc = bn::launch_fwd_apply<float, float>(x, y, sums, stat, p, M, C, inv,
                                            eps, s);
  else if (x_dtype == kFloat32)
    rc = bn::launch_fwd_apply<float, __nv_bfloat16>(x, y, sums, stat, p, M,
                                                    C, inv, eps, s);
  else if (out_dtype == kFloat32)
    rc = bn::launch_fwd_apply<__nv_bfloat16, float>(x, y, sums, stat, p, M,
                                                    C, inv, eps, s);
  else
    rc = bn::launch_fwd_apply<__nv_bfloat16, __nv_bfloat16>(
        x, y, sums, stat, p, M, C, inv, eps, s);
  return (int)rc;
}

int lctvqa_bn_bwd_sums(const void* x, const void* g, const void* stat,
                       void* sums, void* scratch, int blocks, long long M,
                       int C, int x_dtype, int g_dtype, void* stream) {
  using namespace lctvqa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bn::SyncPlan p;
  cudaError_t rc = bn::sync_plan_for(M, C, x_dtype, g_dtype, blocks, &p);
  if (rc != cudaSuccess) return (int)rc;
  if (x_dtype == kFloat32 && g_dtype == kFloat32)
    rc = bn::launch_sums<float, float, true>(x, g, stat, sums, scratch, p, M,
                                             C, s);
  else if (x_dtype == kFloat32)
    rc = bn::launch_sums<float, __nv_bfloat16, true>(x, g, stat, sums,
                                                     scratch, p, M, C, s);
  else if (g_dtype == kFloat32)
    rc = bn::launch_sums<__nv_bfloat16, float, true>(x, g, stat, sums,
                                                     scratch, p, M, C, s);
  else
    rc = bn::launch_sums<__nv_bfloat16, __nv_bfloat16, true>(
        x, g, stat, sums, scratch, p, M, C, s);
  return (int)rc;
}

int lctvqa_bn_bwd_apply(const void* x, const void* g, const void* stat,
                        const void* sums, void* dx, int blocks, long long M,
                        int C, long long count, int x_dtype, int g_dtype,
                        void* stream) {
  using namespace lctvqa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bn::SyncPlan p;
  cudaError_t rc = bn::sync_plan_for(M, C, x_dtype, g_dtype, blocks, &p);
  if (rc != cudaSuccess) return (int)rc;
  if (count < M) return (int)cudaErrorInvalidValue;
  const float inv = 1.f / (float)count;
  if (x_dtype == kFloat32 && g_dtype == kFloat32)
    rc = bn::launch_bwd_apply<float, float>(x, g, stat, sums, dx, p, M, C,
                                            inv, s);
  else if (x_dtype == kFloat32)
    rc = bn::launch_bwd_apply<float, __nv_bfloat16>(x, g, stat, sums, dx, p,
                                                    M, C, inv, s);
  else if (g_dtype == kFloat32)
    rc = bn::launch_bwd_apply<__nv_bfloat16, float>(x, g, stat, sums, dx, p,
                                                    M, C, inv, s);
  else
    rc = bn::launch_bwd_apply<__nv_bfloat16, __nv_bfloat16>(
        x, g, stat, sums, dx, p, M, C, inv, s);
  return (int)rc;
}

}  // extern "C"
