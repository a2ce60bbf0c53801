// Whole-loop greedy decode for Hopper (sm_90a), bound to Python with
// ctypes (lctvqa_torch/ops/cuda_generate.py). It replaces the Pallas TPU
// kernel of lctvqa/ops/pallas_generate.py (the pallas_call at :142, body
// _gen_kernel).
//
// Per step: the LSTM cell (operands rounded to T, fp32 sums), logits =
// fc2(round_T(tanh h)) + b, the first maximum of the logits (the lowest
// index among equal maxima, jnp.argmax's and torch.argmax's rule), and the
// next input x = table[token] as an fp32 row with no tanh. h0 = c0 = the
// image embedding and x0 = tanh(table[<start>]) come from the wrapper.
//
// What bounds it on an H100: the chain of 2T dependent phases. The
// operations are few (0.3 GFLOP a step at B = 64, microseconds on the
// tensor cores) and the weights (3.3 MB of LSTM and 8.4 MB of head in
// bf16) fit in the SMs' shared memory together, so the bound is how often
// the weights are read and how long each phase's chain of copy, product
// and hand-over takes.
//
// Design. The TPU kernel keeps every weight in VMEM and runs the loop as
// one program. Here one persistent grid, launched cooperatively (every
// block resident at once; a grid that does not fit is refused, never
// hung), one block of 512 threads per SM, in two roles:
//   * gate blocks: block g owns hidden units [8g, 8g + 8), all four gates,
//     and keeps its [E + H, 32] slice of [W_ih; W_hh] in shared memory for
//     the whole call. Per step it stages [round_T(x) | round_T(h)] of a
//     batch tile (the batch as the M dimension) and multiplies it with the
//     resident slice: bf16 on the tensor cores (ldmatrix, mma.sync, fp32
//     sums), fp32 with fmaf (lstm_seq.cuh's tile_product, the recurrence's
//     own product). The epilogue writes h (as T) to a double-buffered
//     exchange buffer and round_T(tanh h) to the head's input buffer, both
//     in device memory (they stay in L2); c stays in an fp32 scratch that
//     only its owner thread touches;
//   * head blocks: block k owns columns [k VC, k VC + VC) of the padded
//     vocabulary. In bf16 its [H, VC] slice of fc2 is resident in shared
//     memory (n-major, the "col" operand of mma.sync) and the product runs
//     on the tensor cores; in fp32 the slice does not fit beside a batch
//     tile, so it is read from L2 each step (the grid reads the head once a
//     step, not once a row) and multiplied with fmaf. Each logit becomes a
//     64-bit key, the logit's order-preserving bits above the complement of
//     its index, so that the largest key is the first maximum; the block
//     takes each row's largest key over its columns and adds it to the
//     row's step slot with atomicMax. A maximum does not depend on the
//     order in which it is taken: the token is exactly the first maximum,
//     whatever block finishes first, and two runs give the same bits;
//   * two hand-overs a step, each a counter that only grows (red.release
//     after the block's writes, one thread spinning on ld.acquire): the
//     head blocks wait for all gate blocks of step t (h_t complete), the
//     gate blocks for all head blocks of step t (the keys of step t
//     complete) before they read the tokens and gather table[token] as the
//     next x. Gate block 0 writes the tokens;
//   * B larger than a batch tile loops over tiles inside a phase with the
//     weights resident.
// The counters, keys, exchange buffers and c are the caller's zeroed
// scratch, so calls on several streams share nothing.
#include <math.h>

#include "fragments.cuh"
#include "lstm_common.cuh"
#include "lstm_seq.cuh"

namespace lctvqa {
namespace {
namespace gen {

constexpr int kThreads = seq::kThreads;  // 512, one block per SM
constexpr int kUnits = 8;                // hidden units of a gate block
constexpr int kRows = 4;                 // lstm_seq.cuh's R at 8 units
constexpr int kCtrB = 32;                // second counter, in unsigned
constexpr int kSyncBytes = 256;

template <typename T>
using GateCfg = seq::Cfg<T, kUnits, kRows>;

using seq::round_up;

// The launch shape. Gate tiles: bf16 64, 32 or 16 rows (the largest whose
// role fits), fp32 lstm_seq's 16. Head: VC columns a block, a multiple of
// 8; bf16 tiles of 64, 32 or 16 rows; fp32 64.
struct Plan {
  int gate_blocks, gate_tile, head_blocks, head_cols, head_tile, smem;
};

struct Dims {
  int EP, KP, S;  // x columns padded, [x | h] columns padded, a_s row
  int HK, SH;     // H padded to the mma depth, head row stride (elements)
};

template <typename T>
__host__ __device__ inline Dims dims(int E, int H) {
  using C = GateCfg<T>;
  Dims d;
  d.EP = round_up(E, 16);
  d.KP = round_up(d.EP + H, C::KPAD);
  d.S = d.KP + C::PAD;
  d.HK = round_up(H, 16);
  d.SH = d.HK + C::PAD;
  return d;
}

template <typename T>
inline size_t gate_smem(int E, int H, int tile) {
  using C = GateCfg<T>;
  const Dims d = dims<T>(E, H);
  const size_t w = C::kMma ? (size_t)4 * kUnits * d.S
                           : (size_t)d.KP * 4 * kUnits;
  return (size_t)C::kPartialFloats * 4 + (w + (size_t)tile * d.S) * sizeof(T);
}

// bf16: the slice [VCA][SH], the tile [tile][SH], the bias [VCA], the
// per-row maxima of the four column groups [4][tile] (64-bit); fp32: the
// tile [tile][HX] only (the slice stays in L2). VCA = VC rounded up to 32,
// HX = H rounded up to 8.
template <typename T>
inline size_t head_smem(int H, int vc, int tile) {
  const Dims d = dims<T>(1, H);
  if (sizeof(T) == 2)
    return ((size_t)round_up(vc, 32) + tile) * d.SH * 2 +
           (size_t)round_up(vc, 32) * 4 + (size_t)4 * tile * 8;
  return (size_t)tile * round_up(H, 8) * 4;
}

template <typename T>
cudaError_t plan_for(int E, int H, int V, int sms, int smem_max, Plan* p) {
  const int gates = (H + kUnits - 1) / kUnits;
  if (sms - gates < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int vc = round_up((V + (sms - gates) - 1) / (sms - gates), 8);
  const int tiles[3] = {64, 32, 16};
  int gt = 0, ht = 0;
  if (sizeof(T) == 2) {
    for (int i = 0; i < 3 && !gt; ++i)
      if (gate_smem<T>(E, H, tiles[i]) <= (size_t)smem_max) gt = tiles[i];
    for (int i = 0; i < 3 && !ht; ++i)
      if (head_smem<T>(H, vc, tiles[i]) <= (size_t)smem_max) ht = tiles[i];
  } else {
    gt = GateCfg<T>::BT;
    if (gate_smem<T>(E, H, gt) > (size_t)smem_max) gt = 0;
    ht = 64;
    if (head_smem<T>(H, vc, ht) > (size_t)smem_max) ht = 0;
  }
  if (!gt || !ht) return cudaErrorCooperativeLaunchTooLarge;
  const size_t a = gate_smem<T>(E, H, gt), b = head_smem<T>(H, vc, ht);
  *p = {gates, gt, (V + vc - 1) / vc, vc, ht, (int)(a > b ? a : b)};
  return cudaSuccess;
}

// The key of logit v at column `col`: its order-preserving bits (-0 taken
// as +0) above ~col, so that the largest key is the first maximum.
__device__ __forceinline__ unsigned long long logit_key(float v, int col) {
  unsigned u = __float_as_uint(v + 0.f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(~col);
}

__device__ __forceinline__ int key_token(unsigned long long key) {
  return (int)~(unsigned)(key & 0xffffffffu);
}

__device__ __forceinline__ unsigned long long umax(unsigned long long a,
                                                   unsigned long long b) {
  return a > b ? a : b;
}

struct Args {
  const float* h0;     // [B, H] fp32 (h0 = c0)
  const float* x0;     // [E] fp32
  const void* w_ih;    // [E, 4H] of T
  const void* w_hh;    // [H, 4H] of T
  const float* b;      // [4H]
  const void* fc2_w;   // [H, V] of T
  const float* fc2_b;  // [V]
  const float* table;  // [V0, E] fp32
  int* tokens;         // [B, steps]
  unsigned char* scratch;
  int B, steps, E, H, V;
  int vec_x;  // E % 4 == 0, table and x0 16-byte aligned
  int vec_w;  // H % 8 == 0, w_ih and w_hh 16-byte aligned
  Plan plan;
};

// Scratch layout (byte offsets), zeroed by the caller: two counters, keys
// [steps][B] u64, exchange [2][B][HX] of T, tanh input [B][HX] of T, c
// [B][H] fp32. HX = H rounded up to 8: rows start on 16 bytes.
struct Scratch {
  size_t keys, exch, th, c, total;
};

__host__ __device__ inline Scratch scratch_layout(int B, int steps, int H,
                                                  int tsize) {
  Scratch s;
  const size_t hx = round_up(H, 8);
  s.keys = kSyncBytes;
  s.exch = s.keys + round_up(8 * B * steps, 16);
  s.th = s.exch + 2 * (size_t)B * hx * tsize;
  s.c = s.th + (size_t)B * hx * tsize;
  s.total = s.c + round_up(4 * B * H, 16);
  return s;
}

// ---------------------------------------------------------------------------
// gate blocks
// ---------------------------------------------------------------------------

template <typename T>
__device__ void gate_role(const Args& a, unsigned char* smem) {
  using C = GateCfg<T>;
  const Dims d = dims<T>(a.E, a.H);
  const int E = a.E, H = a.H, B = a.B, S = d.S, EP = d.EP;
  const int tile = a.plan.gate_tile, HX = round_up(H, 8);
  float* p_s = reinterpret_cast<float*>(smem);
  T* w_s = reinterpret_cast<T*>(p_s + C::kPartialFloats);
  T* a_s = w_s + (C::kMma ? 4 * kUnits * S : d.KP * 4 * kUnits);
  const int tid = threadIdx.x, j0 = blockIdx.x * kUnits;
  const T* w_ih = static_cast<const T*>(a.w_ih);
  const T* w_hh = static_cast<const T*>(a.w_hh);
  const Scratch sc = scratch_layout(B, a.steps, H, sizeof(T));
  unsigned* ctr_a = reinterpret_cast<unsigned*>(a.scratch);
  const unsigned* ctr_b = ctr_a + kCtrB;
  const unsigned long long* keys =
      reinterpret_cast<const unsigned long long*>(a.scratch + sc.keys);
  T* exch = reinterpret_cast<T*>(a.scratch + sc.exch);
  T* th = reinterpret_cast<T*>(a.scratch + sc.th);
  float* c_st = reinterpret_cast<float*>(a.scratch + sc.c);

  // the slice of [W_ih; 0; W_hh; 0], once: bf16 [32][S], row gate * 8 +
  // unit, k contiguous; fp32 [KP][8][4], a float4 of gates per (k, unit)
  for (int idx = tid; idx < d.KP * 4; idx += kThreads) {
    const int k = idx / 4, gate = idx % 4;
    const T* src = k < E ? w_ih + (size_t)k * 4 * H + gate * H + j0
                   : (k >= EP && k < EP + H)
                       ? w_hh + (size_t)(k - EP) * 4 * H + gate * H + j0
                       : nullptr;
    T v[kUnits];
    if (src != nullptr && a.vec_w) {  // the 8 units in 16 or 32 bytes
      uint4* dst = reinterpret_cast<uint4*>(v);
      const uint4* from = reinterpret_cast<const uint4*>(src);
#pragma unroll
      for (int i = 0; i < (int)sizeof(T) / 2; ++i) dst[i] = from[i];
    } else {
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
        v[u] = (src != nullptr && j0 + u < H) ? src[u] : from_f32<T>(0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      if (C::kMma)
        w_s[(gate * kUnits + u) * S + k] = v[u];
      else
        w_s[(k * kUnits + u) * 4 + gate] = v[u];
    }
  }
  // the tile's padding columns stay zero; the loads write [0, E) and
  // [EP, EP + H) only
  for (int i = tid; i < tile * S; i += kThreads) a_s[i] = from_f32<T>(0.f);
  const int er = tid / kUnits, eu = tid % kUnits, ej = j0 + eu;
  float bias[4];
#pragma unroll
  for (int gate = 0; gate < 4; ++gate)
    bias[gate] = ej < H ? a.b[gate * H + ej] : 0.f;
  __syncthreads();

  unsigned target_b = 0;
  for (int t = 0; t < a.steps; ++t) {
    if (t > 0) {
      target_b += a.plan.head_blocks;  // the keys of step t - 1
      seq::grid_wait(ctr_b, target_b);
    }
    // the keys of step t - 1, read past L1: a line of them may have been
    // cached there before its atomics were done
    const unsigned long long* kt = keys + (size_t)(t > 0 ? t - 1 : 0) * B;
    if (t > 0 && blockIdx.x == 0)
      for (int r = tid; r < B; r += kThreads)
        a.tokens[(size_t)r * a.steps + t - 1] = key_token(__ldcg(kt + r));
    const T* exch_prev = exch + (size_t)((t + 1) & 1) * B * HX;
    T* exch_t = exch + (size_t)(t & 1) * B * HX;
    for (int b0 = 0; b0 < B; b0 += tile) {
      const int rows = B - b0 < tile ? B - b0 : tile;
      // x: x0 at the first step, else table[token] (fp32 rows), rounded
      if (a.vec_x) {
        const int quads = E / 4;
        for (int idx = tid; idx < rows * quads; idx += kThreads) {
          const int r = idx / quads, k = (idx % quads) * 4;
          const float* src =
              t == 0 ? a.x0 : a.table + (size_t)key_token(__ldcg(kt + b0 + r)) * E;
          const float4 v = *reinterpret_cast<const float4*>(src + k);
          T* dst = a_s + r * S + k;
          dst[0] = from_f32<T>(v.x), dst[1] = from_f32<T>(v.y);
          dst[2] = from_f32<T>(v.z), dst[3] = from_f32<T>(v.w);
        }
      } else {
        for (int idx = tid; idx < rows * E; idx += kThreads) {
          const int r = idx / E, k = idx % E;
          const float* src =
              t == 0 ? a.x0 : a.table + (size_t)key_token(__ldcg(kt + b0 + r)) * E;
          a_s[r * S + k] = from_f32<T>(src[k]);
        }
      }
      // h: the image embedding at the first step, else the exchange
      if (t == 0) {
        for (int idx = tid; idx < rows * H; idx += kThreads) {
          const int r = idx / H, k = idx % H;
          a_s[r * S + EP + k] = from_f32<T>(a.h0[(size_t)(b0 + r) * H + k]);
        }
      } else {
        constexpr int kPer = 16 / (int)sizeof(T);
        const int chunks = HX / kPer;
        for (int idx = tid; idx < rows * chunks; idx += kThreads) {
          const int r = idx / chunks, cc = idx % chunks;
          cp_async16(a_s + r * S + EP + cc * kPer,
                     exch_prev + (size_t)(b0 + r) * HX + cc * kPer);
        }
        cp_async_wait_all();
      }
      __syncthreads();
      seq::tile_product<T, kUnits, kRows>(a_s, w_s, p_s, rows, d.KP, S);
      __syncthreads();
      const int eb = b0 + er;
      if (er < rows && ej < H) {
        const size_t at = (size_t)eb * H + ej;
        const float c_prev = t == 0 ? a.h0[at] : c_st[at];
        const float gi =
            sigmoid(seq::gate_sum<T, kUnits, kRows>(p_s, er, eu, 0) + bias[0]);
        const float gf =
            sigmoid(seq::gate_sum<T, kUnits, kRows>(p_s, er, eu, 1) + bias[1]);
        const float gg =
            tanhf(seq::gate_sum<T, kUnits, kRows>(p_s, er, eu, 2) + bias[2]);
        const float go =
            sigmoid(seq::gate_sum<T, kUnits, kRows>(p_s, er, eu, 3) + bias[3]);
        const float c = gf * c_prev + gi * gg;
        const float h = go * tanhf(c);
        c_st[at] = c;
        exch_t[(size_t)eb * HX + ej] = from_f32<T>(h);
        th[(size_t)eb * HX + ej] = from_f32<T>(tanhf(h));
      }
    }
    seq::grid_arrive(ctr_a);  // h_t and round_T(tanh h_t) complete
  }
  if (blockIdx.x == 0) {
    target_b += a.plan.head_blocks;
    seq::grid_wait(ctr_b, target_b);
    const unsigned long long* kt = keys + (size_t)(a.steps - 1) * B;
    for (int r = tid; r < B; r += kThreads)
      a.tokens[(size_t)r * a.steps + a.steps - 1] = key_token(__ldcg(kt + r));
  }
}

// ---------------------------------------------------------------------------
// head blocks
// ---------------------------------------------------------------------------

// round_T(tanh h) of rows [b0, b0 + rows) into t_s ([tile][stride] of T),
// 16 bytes at a time past L1; columns [H, HX) of the buffer are zero.
template <typename T>
__device__ __forceinline__ void load_th(const T* th, T* t_s, int b0, int rows,
                                        int HX, int stride) {
  constexpr int kPer = 16 / (int)sizeof(T);
  const int chunks = HX / kPer;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, cc = idx % chunks;
    cp_async16(t_s + r * stride + cc * kPer,
               th + (size_t)(b0 + r) * HX + cc * kPer);
  }
  cp_async_wait_all();
}

// bf16: warp w = (m-tile w % 4, column group w / 4 of four n-tiles, then
// every 16th n-tile after it); each row's largest key over the block's
// columns -> atomicMax into the row's step slot.
__device__ void head_product_bf16(const __nv_bfloat16* t_s,
                                  const __nv_bfloat16* f_s,
                                  const float* fb_s,
                                  unsigned long long* red_s,
                                  unsigned long long* keys_t, int rows,
                                  int tile, int HK, int SH, int c0, int vc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int mt = warp & 3, grp = warp >> 2;
  const int nts = (vc + 7) / 8;
  unsigned long long best[2] = {0ull, 0ull};
  if (mt * 16 < rows) {
    const __nv_bfloat16* ap =
        t_s + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SH +
        (lane >> 4) * 8;
    for (int nt0 = grp * 4; nt0 < nts; nt0 += 16) {
      const __nv_bfloat16* bp =
          f_s + (nt0 * 8 + (lane >> 4) * 8 + (lane & 7)) * SH +
          ((lane >> 3) & 1) * 8;
      float acc[4][4] = {};
#pragma unroll 4
      for (int k = 0; k < HK; k += 16) {
        uint32_t af[4], b01[4], b23[4];
        ldmatrix_x4(af, ap + k);
        ldmatrix_x4(b01, bp + k);
        ldmatrix_x4(b23, bp + 16 * SH + k);
        mma_bf16(acc[0], af[0], af[1], af[2], af[3], b01[0], b01[1]);
        mma_bf16(acc[1], af[0], af[1], af[2], af[3], b01[2], b01[3]);
        mma_bf16(acc[2], af[0], af[1], af[2], af[3], b23[0], b23[1]);
        mma_bf16(acc[3], af[0], af[1], af[2], af[3], b23[2], b23[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = (nt0 + i) * 8 + 2 * q + (e & 1);
          if (col < vc)
            best[e >> 1] = umax(best[e >> 1],
                                logit_key(acc[i][e] + fb_s[col], c0 + col));
        }
      }
    }
  }
  // the four lanes of a row, then the four column groups of a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    best[r] = umax(best[r], __shfl_xor_sync(0xffffffffu, best[r], 1));
    best[r] = umax(best[r], __shfl_xor_sync(0xffffffffu, best[r], 2));
  }
  if (q == 0 && mt * 16 < tile) {
    red_s[grp * tile + mt * 16 + g] = best[0];
    red_s[grp * tile + mt * 16 + g + 8] = best[1];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    unsigned long long m = red_s[r];
    for (int k = 1; k < 4; ++k) m = umax(m, red_s[k * tile + r]);
    if (m) atomicMax(keys_t + r, m);
  }
}

// fp32: thread = (row group tid / 32 of four rows, lane); a lane takes
// four neighbouring columns at a time, 128 columns a pass, the weights
// read from L2 as float4.
__device__ void head_product_f32(const float* t_s, const float* fc2_w,
                                 const float* fc2_b,
                                 unsigned long long* keys_t, int rows,
                                 int stride, int H, int V, int c0, int vc) {
  const int rg = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long best[4] = {0ull, 0ull, 0ull, 0ull};
  if (rg * 4 < rows) {
    for (int cb = 4 * lane; cb < vc; cb += 128) {
      const int col = c0 + cb;  // V and vc are multiples of 4
      float acc[4][4] = {};
      const float* w = fc2_w + col;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(w + (size_t)k * V));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float tv = t_s[(rg * 4 + i) * stride + k];
          acc[i][0] = fmaf(tv, wv.x, acc[i][0]);
          acc[i][1] = fmaf(tv, wv.y, acc[i][1]);
          acc[i][2] = fmaf(tv, wv.z, acc[i][2]);
          acc[i][3] = fmaf(tv, wv.w, acc[i][3]);
        }
      }
      const float4 bv = __ldg(reinterpret_cast<const float4*>(fc2_b + col));
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          best[i] = umax(best[i], logit_key(acc[i][j] + bb[j], col + j));
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      best[i] = umax(best[i], __shfl_xor_sync(0xffffffffu, best[i], o));
    if (lane == 0 && rg * 4 + i < rows && best[i])
      atomicMax(keys_t + rg * 4 + i, best[i]);
  }
}

template <typename T>
__device__ void head_role(const Args& a, unsigned char* smem) {
  const Dims d = dims<T>(a.E, a.H);
  const int H = a.H, B = a.B, V = a.V, HX = round_up(H, 8);
  const int hb = blockIdx.x - a.plan.gate_blocks;
  const int c0 = hb * a.plan.head_cols;
  const int vc = V - c0 < a.plan.head_cols ? V - c0 : a.plan.head_cols;
  const int tile = a.plan.head_tile, tid = threadIdx.x;
  const Scratch sc = scratch_layout(B, a.steps, H, sizeof(T));
  const unsigned* ctr_a = reinterpret_cast<const unsigned*>(a.scratch);
  unsigned* ctr_b = reinterpret_cast<unsigned*>(a.scratch) + kCtrB;
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(a.scratch + sc.keys);
  const T* th = reinterpret_cast<const T*>(a.scratch + sc.th);
  const T* fc2_w = static_cast<const T*>(a.fc2_w);

  T *f_s = nullptr, *t_s;
  float* fb_s = nullptr;
  unsigned long long* red_s = nullptr;
  int stride;
  if constexpr (sizeof(T) == 2) {
    // the slice [VCA][SH], n-major, once; rows past vc and k past H zero
    const int vca = round_up(a.plan.head_cols, 32);
    stride = d.SH;
    f_s = reinterpret_cast<T*>(smem);
    t_s = f_s + vca * d.SH;
    fb_s = reinterpret_cast<float*>(t_s + tile * d.SH);
    red_s = reinterpret_cast<unsigned long long*>(fb_s + vca);
    // eight neighbouring columns of a row of fc2 in one 16-byte load (V,
    // c0 and vc are multiples of 8)
    for (int idx = tid; idx < d.SH * (vca / 8); idx += kThreads) {
      const int k = idx / (vca / 8), n = idx % (vca / 8) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (k < H && n < vc)
        u = *reinterpret_cast<const uint4*>(fc2_w + (size_t)k * V + c0 + n);
      const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) f_s[(n + i) * d.SH + k] = v[i];
    }
    for (int n = tid; n < vca; n += kThreads)
      fb_s[n] = n < vc ? a.fc2_b[c0 + n] : 0.f;
  } else {
    stride = HX;
    t_s = reinterpret_cast<T*>(smem);
  }
  for (int i = tid; i < tile * stride; i += kThreads)
    t_s[i] = from_f32<T>(0.f);
  __syncthreads();

  unsigned target_a = 0;
  for (int t = 0; t < a.steps; ++t) {
    target_a += a.plan.gate_blocks;
    seq::grid_wait(ctr_a, target_a);
    unsigned long long* keys_t = keys + (size_t)t * B;
    for (int b0 = 0; b0 < B; b0 += tile) {
      const int rows = B - b0 < tile ? B - b0 : tile;
      load_th<T>(th, t_s, b0, rows, HX, stride);
      __syncthreads();
      if constexpr (sizeof(T) == 2)
        head_product_bf16(t_s, f_s, fb_s, red_s, keys_t + b0, rows, tile,
                          d.HK, d.SH, c0, vc);
      else
        head_product_f32(t_s, fc2_w, a.fc2_b, keys_t + b0, rows, stride, H,
                         V, c0, vc);
      __syncthreads();
    }
    seq::grid_arrive(ctr_b);  // this block's keys of step t are in
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) greedy_generate_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if ((int)blockIdx.x < a.plan.gate_blocks)
    gate_role<T>(a, smem_raw);
  else
    head_role<T>(a, smem_raw);
}

template <typename T>
cudaError_t plan_on_device(int E, int H, int V, Plan* p) {
  int dev = 0, sms = 0, smem_max = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  err = smem_optin(&smem_max);
  if (err != cudaSuccess) return err;
  return plan_for<T>(E, H, V, sms, smem_max, p);
}

template <typename T>
cudaError_t launch(Args a, cudaStream_t s) {
  cudaError_t err = plan_on_device<T>(a.E, a.H, a.V, &a.plan);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem((const void*)greedy_generate_kernel<T>,
                           a.plan.smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(
      (void*)greedy_generate_kernel<T>,
      dim3(a.plan.gate_blocks + a.plan.head_blocks), dim3(kThreads), args,
      (size_t)a.plan.smem, s);
}

}  // namespace gen
}  // namespace
}  // namespace lctvqa

extern "C" {

// h0: [B, H] fp32; x0: [E] fp32; w_ih [E, 4H], w_hh [H, 4H] and fc2_w
// [H, V] in `dtype`, contiguous; b [4H], fc2_b [V] and table [V0, E] fp32;
// tokens: [B, steps] int32. V a multiple of 8, fc2_w and fc2_b 16-byte
// aligned. scratch: lctvqa_greedy_generate_scratch bytes of zeros. B >= 1,
// steps >= 1. Returns cudaErrorCooperativeLaunchTooLarge where the grid or
// a role's shared memory does not fit this device.
int lctvqa_greedy_generate(const void* h0, const void* x0, const void* w_ih,
                           const void* w_hh, const void* b,
                           const void* fc2_w, const void* fc2_b,
                           const void* table, void* tokens, void* scratch,
                           int B, int steps, int E, int H, int V, int dtype,
                           void* stream) {
  using namespace lctvqa;
  if (B < 1 || steps < 1 || V % 8 != 0 || (uintptr_t)fc2_w % 16 != 0 ||
      (uintptr_t)fc2_b % 16 != 0)
    return (int)cudaErrorInvalidValue;
  gen::Args a{(const float*)h0, (const float*)x0, w_ih, w_hh, (const float*)b,
              fc2_w, (const float*)fc2_b, (const float*)table, (int*)tokens,
              (unsigned char*)scratch, B, steps, E, H, V,
              E % 4 == 0 && (uintptr_t)table % 16 == 0 &&
                  (uintptr_t)x0 % 16 == 0,
              H % 8 == 0 && (uintptr_t)w_ih % 16 == 0 &&
                  (uintptr_t)w_hh % 16 == 0,
              {}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return (int)gen::launch<float>(a, s);
  if (dtype == kBFloat16) return (int)gen::launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of zeroed scratch one call takes.
long long lctvqa_greedy_generate_scratch(int B, int steps, int H, int dtype) {
  using namespace lctvqa;
  return (long long)gen::scratch_layout(B, steps, H, dtype == kBFloat16 ? 2 : 4)
      .total;
}

// The launch shape lctvqa_greedy_generate takes at (E, H, V) on the current
// device: plan[0..5] = gate blocks, gate batch tile, head blocks, head
// columns a block, head batch tile, shared-memory bytes per block; every
// block has 512 threads and each gate block 8 hidden units.
int lctvqa_greedy_generate_plan(int E, int H, int V, int dtype, int* plan) {
  using namespace lctvqa;
  gen::Plan p;
  cudaError_t err =
      dtype == kFloat32    ? gen::plan_on_device<float>(E, H, V, &p)
      : dtype == kBFloat16 ? gen::plan_on_device<__nv_bfloat16>(E, H, V, &p)
                           : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.gate_blocks, plan[1] = p.gate_tile, plan[2] = p.head_blocks;
  plan[3] = p.head_cols, plan[4] = p.head_tile, plan[5] = p.smem;
  return 0;
}

}  // extern "C"
