// Device code of the whole-sequence LSTM (lctvqa_lstm_seq, lstm.cu): the
// persistent recurrent kernel, its tile product and its grid barrier, which
// the greedy decode (generate.cu) shares. The note at the head of lstm.cu
// has the design; here are the layouts. The kernels that are not templates
// (the input product, the barrier probe) are in lstm.cu, so that two
// translation units may include this header.
//
// Recurrent kernel, block `blockIdx.x` owns the U hidden units
// [j0, j0 + U), j0 = U * blockIdx.x, all four gates of them. With
// HP = H rounded up to 128 (bf16) or 64 (fp32) and S = HP + 16 bytes' worth
// of elements:
//   p_s  [KS][BT][4U] fp32   partial gate sums of the KS slices of k; the
//        batch tile has BT rows: 64 in bf16, R * 32 / U in fp32, where a
//        thread multiplies R rows (8 at U = 4, 4 at U = 8)
//   w_s  bf16: [4U][S], row n = gate * 8 + unit (U = 8), k contiguous: the
//        "col" operand of mma.m16n8k16, one n-tile per gate, so that a
//        thread's accumulators hold the four gates of the same units;
//        fp32: [HP][U][4], a float4 of gates per (k, unit)
//   h_s  [BT][S] of T        round_T(h_{t-1}) of the batch tile's rows
// Rows and columns past H are zero. S makes the fragment loads of a warp
// (8 rows x 4 words, or 8 rows x a float4) fall on 32 different banks.
#pragma once

#include <cstdint>

#include "fragments.cuh"
#include "lstm_common.cuh"

namespace lctvqa {
namespace seq {

constexpr int kThreads = 512;          // 16 warps, one block per SM
constexpr int kSyncBytes = 256;        // the barrier's counter, padded

template <typename T, int U, int R>
struct Cfg {
  static constexpr bool kMma = sizeof(T) == 2;
  // rows of a batch tile, slices of k, padding of a row in elements
  static constexpr int BT = kMma ? 64 : R * 32 / U;
  static constexpr int KS = kMma ? 4 : 16;
  static constexpr int PAD = 16 / (int)sizeof(T);
  // H is padded to this: every slice of k a whole number of loop steps
  static constexpr int KPAD = kMma ? 128 : 64;
  static constexpr int kPartialFloats = KS * BT * 4 * U;
  static_assert(!kMma || (U == 8 && R == 4),
                "one mma n-tile of 8 units per gate, m-tiles of 16 rows");
  static_assert(BT * U <= kThreads, "one thread per (row, unit)");
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

template <typename T, int U, int R>
inline size_t smem_bytes(int H) {
  using C = Cfg<T, U, R>;
  const size_t HP = round_up(H, C::KPAD), S = HP + C::PAD;
  const size_t w = C::kMma ? 4 * U * S : HP * 4 * U;
  return C::kPartialFloats * sizeof(float) + (w + C::BT * S) * sizeof(T);
}

// The grid barrier: a counter that only grows, zeroed by the caller before
// the launch. Every block arrives once per barrier, after its writes; the
// k-th barrier is passed when the counter has reached k * gridDim.x. All
// blocks must be resident at once (a cooperative launch).
__device__ __forceinline__ void grid_arrive(unsigned* ctr) {
  __syncthreads();  // the block's writes are done
  if (threadIdx.x == 0)  // release: a fence, then the add
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(ctr),
                 "r"(1u)
                 : "memory");
}

__device__ __forceinline__ void grid_wait(const unsigned* ctr,
                                          unsigned target) {
  if (threadIdx.x == 0) {
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(ctr)
                   : "memory");
    } while (v < target);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the recurrence
// ---------------------------------------------------------------------------

// The block's slice of w_hh [H, 4H] into w_s, once per call.
template <typename T, int U, int R>
__device__ __forceinline__ void load_w_slice(const T* __restrict__ w_hh,
                                             T* __restrict__ w_s, int H,
                                             int HP, int S, int j0) {
  using C = Cfg<T, U, R>;
  for (int idx = threadIdx.x; idx < HP * 4 * U; idx += kThreads) {
    const int k = idx / (4 * U), n = idx % (4 * U);
    const int gate = n / U, ul = n % U, j = j0 + ul;
    const T v = (k < H && j < H) ? w_hh[(size_t)k * 4 * H + gate * H + j]
                                 : from_f32<T>(0.f);
    if (C::kMma)
      w_s[(gate * U + ul) * S + k] = v;
    else
      w_s[(k * U + ul) * 4 + gate] = v;
  }
}

// round_T(h_{t-1}) of rows [b0, b0 + rows) into h_s: from h0 at the first
// step, else from the exchange buffer, 16 bytes at a time past L1.
template <typename T>
__device__ __forceinline__ void load_h_tile(const float* __restrict__ h0,
                                            const T* exch_t, T* h_s, int b0,
                                            int rows, int H, int HX, int S,
                                            bool first) {
  if (first) {
    for (int idx = threadIdx.x; idx < rows * H; idx += kThreads) {
      const int r = idx / H, k = idx % H;
      h_s[r * S + k] = from_f32<T>(h0[(size_t)(b0 + r) * H + k]);
    }
    return;
  }
  constexpr int kPer = 16 / (int)sizeof(T);
  const int chunks = HX / kPer;
  const T* src = exch_t + (size_t)b0 * HX;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, c = idx % chunks;
    cp_async16(h_s + r * S + c * kPer, src + (size_t)r * HX + c * kPer);
  }
  cp_async_wait_all();
}

// The fp32 product of one warp: slice `warp` of k, lane = (row group rg,
// unit), rows i * RG + rg for i < RI, four gates each.
template <int U, int RI, int BT>
__device__ __forceinline__ void fma_product(const float* __restrict__ h_s,
                                            const float* __restrict__ w_s,
                                            float* __restrict__ p_s, int rows,
                                            int HP, int S) {
  constexpr int RG = 32 / U, KS = 16;
  const int ks = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ul = lane % U, rg = lane / U;
  if (rg >= rows) return;
  float acc[RI][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int kb = ks * (HP / KS), ke = kb + HP / KS;
  for (int k = kb; k < ke; k += 4) {
    float hv[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(h_s + (i * RG + rg) * S + k);
      hv[i][0] = v.x, hv[i][1] = v.y, hv[i][2] = v.z, hv[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w =
          *reinterpret_cast<const float4*>(w_s + ((k + kk) * U + ul) * 4);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        acc[i][0] = fmaf(hv[i][kk], w.x, acc[i][0]);
        acc[i][1] = fmaf(hv[i][kk], w.y, acc[i][1]);
        acc[i][2] = fmaf(hv[i][kk], w.z, acc[i][2]);
        acc[i][3] = fmaf(hv[i][kk], w.w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i)
    *reinterpret_cast<float4*>(p_s + ((ks * BT + i * RG + rg) * U + ul) * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// p_s[ks] = h_s[:, slice ks of k] . w_s[slice ks of k, :] for the tile's
// live rows. bf16: warp = (m-tile of 16 rows, slice), four mma n-tiles, one
// per gate. fp32: warp = slice; lane = (row group, unit) with an R-row x
// 4-gate patch, rows interleaved so that a warp's float4 loads of h_s hit
// different banks.
template <typename T, int U, int R>
__device__ __forceinline__ void tile_product(const T* __restrict__ h_s,
                                             const T* __restrict__ w_s,
                                             float* __restrict__ p_s,
                                             int rows, int HP, int S) {
  using C = Cfg<T, U, R>;
  if constexpr (C::kMma) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int mt = warp & 3, ks = warp >> 2;
    if (mt * 16 >= rows) return;
    // two sets of sums, for even and odd k-steps: shorter dependent chains
    float acc[2][4][4] = {};
    const int kb = ks * (HP / C::KS), ke = kb + HP / C::KS;
    // ldmatrix addresses: lane l gives row l % 8 of 8 x 8 matrix l / 8. A:
    // matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15) of the m-tile; B: for a
    // pair of gates, (k 0-7 | 8-15) of each gate's 8 units.
    const T* ap = h_s + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S +
                  (lane >> 4) * 8;
    const T* bp = w_s + ((lane >> 4) * 8 + (lane & 7)) * S +
                  ((lane >> 3) & 1) * 8;
#pragma unroll 2
    for (int k = kb; k < ke; k += 32) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t a[4], b01[4], b23[4];
        ldmatrix_x4(a, ap + k + 16 * half);
        ldmatrix_x4(b01, bp + k + 16 * half);
        ldmatrix_x4(b23, bp + 16 * S + k + 16 * half);
        mma_bf16(acc[half][0], a[0], a[1], a[2], a[3], b01[0], b01[1]);
        mma_bf16(acc[half][1], a[0], a[1], a[2], a[3], b01[2], b01[3]);
        mma_bf16(acc[half][2], a[0], a[1], a[2], a[3], b23[0], b23[1]);
        mma_bf16(acc[half][3], a[0], a[1], a[2], a[3], b23[2], b23[3]);
      }
    }
    // columns of a row are swizzled by the row, gate ^ (row % 4), so that
    // neither these stores nor gate_sum's loads meet on a bank
    const int row = mt * 16 + g;  // row + 8 has the same row % 4
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) {
      float* p = p_s + ((ks * C::BT + row) * 4 + (gate ^ (row & 3))) * 8 +
                 2 * q;
      *reinterpret_cast<float2*>(p) =
          make_float2(acc[0][gate][0] + acc[1][gate][0],
                      acc[0][gate][1] + acc[1][gate][1]);
      *reinterpret_cast<float2*>(p + 8 * 32) =
          make_float2(acc[0][gate][2] + acc[1][gate][2],
                      acc[0][gate][3] + acc[1][gate][3]);
    }
  } else {
    // tiles of at most half the rows take the 4-row patch
    if (R > 4 && rows <= 4 * (32 / U))
      fma_product<U, 4, C::BT>(h_s, w_s, p_s, rows, HP, S);
    else
      fma_product<U, R, C::BT>(h_s, w_s, p_s, rows, HP, S);
  }
}

// The sum over the slices, in their order, of gate `gate` of (row, unit).
template <typename T, int U, int R>
__device__ __forceinline__ float gate_sum(const float* __restrict__ p_s,
                                          int row, int ul, int gate) {
  using C = Cfg<T, U, R>;
  float v = 0.f;
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks)
    v += C::kMma ? p_s[((ks * C::BT + row) * 4 + (gate ^ (row & 3))) * 8 + ul]
                 : p_s[((ks * C::BT + row) * U + ul) * 4 + gate];
  return v;
}

// xw: [B, steps, 4H] fp32, the input product with the bias. exch:
// [2, B, HX] of T, HX = H rounded up to 8, zeroed by the caller like ctr.
// c_n doubles as the c state between steps (each element has one owner
// thread). out may be null.
template <typename T, int U, int R>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_seq_kernel(const float* __restrict__ xw,
                    const float* __restrict__ h0,
                    const float* __restrict__ c0,
                    const T* __restrict__ w_hh, float* __restrict__ out,
                    float* __restrict__ h_n, float* c_n, unsigned* ctr,
                    T* exch, int B, int steps, int H) {
  using C = Cfg<T, U, R>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HP = round_up(H, C::KPAD), S = HP + C::PAD, HX = round_up(H, 8);
  float* p_s = reinterpret_cast<float*>(smem_raw);
  T* w_s = reinterpret_cast<T*>(p_s + C::kPartialFloats);
  T* h_s = w_s + (C::kMma ? 4 * U * S : HP * 4 * U);
  const int tid = threadIdx.x, j0 = blockIdx.x * U;

  load_w_slice<T, U, R>(w_hh, w_s, H, HP, S, j0);
  for (int i = tid; i < C::BT * S; i += kThreads) h_s[i] = from_f32<T>(0.f);
  __syncthreads();

  // the (row, unit) of the tile that this thread finishes
  const int er = tid / U, eu = tid % U, ej = j0 + eu;
  const int n_tiles = (B + C::BT - 1) / C::BT;
  unsigned target = 0;
  for (int t = 0; t < steps; ++t) {
    const T* exch_t = exch + (size_t)(t & 1) * B * HX;
    T* exch_next = exch + (size_t)((t + 1) & 1) * B * HX;
    for (int bt = 0; bt < n_tiles; ++bt) {
      const int b0 = bt * C::BT;
      const int rows = B - b0 < C::BT ? B - b0 : C::BT;
      const int eb = b0 + er;
      const bool live = er < rows && ej < H;  // rows <= BT
      // loads that do not depend on the other blocks go out before the wait
      float xg[4] = {0.f, 0.f, 0.f, 0.f}, c_prev = 0.f;
      if (live) {
        const float* xp = xw + ((size_t)eb * steps + t) * 4 * H + ej;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) xg[gate] = xp[gate * H];
        c_prev = t == 0 ? c0[(size_t)eb * H + ej] : c_n[(size_t)eb * H + ej];
      }
      if (bt == 0 && t > 0) grid_wait(ctr, target);
      load_h_tile<T>(h0, exch_t, h_s, b0, rows, H, HX, S, t == 0);
      __syncthreads();
      tile_product<T, U, R>(h_s, w_s, p_s, rows, HP, S);
      __syncthreads();
      if (live) {
        const float gi = sigmoid(gate_sum<T, U, R>(p_s, er, eu, 0) + xg[0]);
        const float gf = sigmoid(gate_sum<T, U, R>(p_s, er, eu, 1) + xg[1]);
        const float gg = tanhf(gate_sum<T, U, R>(p_s, er, eu, 2) + xg[2]);
        const float go = sigmoid(gate_sum<T, U, R>(p_s, er, eu, 3) + xg[3]);
        const float c = gf * c_prev + gi * gg;
        const float h = go * tanhf(c);
        c_n[(size_t)eb * H + ej] = c;
        if (out != nullptr) out[((size_t)eb * steps + t) * H + ej] = h;
        if (t + 1 == steps)
          h_n[(size_t)eb * H + ej] = h;
        else
          exch_next[(size_t)eb * HX + ej] = from_f32<T>(h);
      }
    }
    if (t + 1 < steps) {
      target += gridDim.x;
      grid_arrive(ctr);
    }
  }
}

}  // namespace seq
}  // namespace lctvqa
