// Block-level 3x3 SAME convolutions on a small H x W grid, for the
// one-block-per-element recurrence kernel B4 (convgru_bwd_mono.cu). B1, B2
// and B3 run on clusters (cluster_conv.cuh).
//
// Layout. An operand with K channels is kept zero-padded on an
// (H+2) x (W+2) grid in a buffer of `R` rows of stride `pad_stride(K)`
// elements. Outputs are computed on an H x (W+2) grid, `Mpad` rows (the two
// extra columns and the tail rows are discarded), so for tap (dy, dx) the
// rows of the A operand are one contiguous run of the padded buffer starting
// at dy*(W+2)+dx. The stride K + 16 keeps rows 32-byte aligned (WMMA's rule)
// and spreads the 8 rows an A-fragment load reads over the banks.
//
// A weight is [9][K][ldw] (HWIO with the taps flattened); a conv reads
// output columns [0, N) of it. In bf16 the products run on the tensor cores
// (WMMA 16x16x16, f32 accumulators); the f32 versions run scalar f32 FMAs.
//
// A transposed conv (the input gradient of a conv) is a SAME conv with the
// kernel flipped spatially and its in/out channels swapped; the wrappers
// build that weight once per call, so the same `conv3x3` serves both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

namespace rgp {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDepth = 4;  // weight fragments a warp keeps in flight per group
constexpr int kMaxSharedBytes = 232448;  // 227 KB: the most a block can use

struct Grid {
  int H, W;
  int Wp;    // padded row width W + 2
  int Mpad;  // output rows on the H x (W+2) grid, rounded up to 16
  int R;     // rows of a padded operand buffer
};

inline Grid make_grid(int H, int W) {
  Grid g;
  g.H = H;
  g.W = W;
  g.Wp = W + 2;
  g.Mpad = (H * g.Wp + 15) / 16 * 16;
  // the last 16-row tile of tap (2, 2) reads up to row Mpad - 1 + 2*Wp + 2;
  // this also covers the (H+2)*(W+2) padded grid
  g.R = g.Mpad + 2 * g.Wp + 2;
  return g;
}

__host__ __device__ inline int pad_stride(int K) { return K + 16; }

__host__ __device__ inline size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// bytes of a padded operand buffer with K channels
__host__ __device__ inline size_t pad_bytes(const Grid& g, int K, size_t elem) {
  return align128((size_t)g.R * pad_stride(K) * elem);
}

// row of interior position p (row-major over H x W) in a padded buffer
__device__ __forceinline__ int pad_row(const Grid& g, int p) {
  return (p / g.W + 1) * g.Wp + p % g.W + 1;
}

// row of position p on the H x (W+2) output grid
__device__ __forceinline__ int out_row(const Grid& g, int p) {
  return (p / g.W) * g.Wp + p % g.W;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Zero a buffer of n elements (the padded operands' borders stay zero).
template <typename T>
__device__ inline void zero_fill(T* buf, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) buf[i] = from_f32<T>(0.0f);
}

using FragB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                     nvcuda::wmma::row_major>;
using FragC = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// Issue the weight-fragment loads of k-steps s0 .. s0+kDepth-1 together, so
// their L2 latencies overlap. Step s covers tap s/kt, rows (s%kt)*16.. of w.
__device__ __forceinline__ void load_weights(FragB (&b)[kDepth], const __nv_bfloat16* w,
                                             int ldw, int s0, int steps, int kt, int K,
                                             int nt) {
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    const int s = s0 + j;
    if (s < steps) {
      const int k = (s / kt) * K + (s % kt) * 16;  // row of w viewed as [9*K][ldw]
      nvcuda::wmma::load_matrix_sync(b[j], w + (size_t)k * ldw + nt * 16, ldw);
    }
  }
}

__device__ __forceinline__ void mma_steps(FragC (&c)[4], const FragB (&b)[kDepth],
                                          const __nv_bfloat16* in_pad, int S, int s0,
                                          int steps, int kt, int mt0, int mts, const Grid& g) {
  using namespace nvcuda;
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    const int s = s0 + j;
    if (s < steps) {  // uniform across the warp
      const int tap = s / kt;
      const int row0 = mt0 * 16 + (tap / 3) * g.Wp + tap % 3;
      const int k0 = (s % kt) * 16;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < mts) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, in_pad + (size_t)(row0 + i * 16) * S + k0, S);
          wmma::mma_sync(c[i], a, b[j], c[i]);
        }
      }
    }
  }
}

// acc[m][n] = sum_{tap, k} in_pad[m + (tap/3)*Wp + tap%3][k] * w[tap][k][n]
// for m < Mpad, n < N; in_pad is [R][S] with K channels, acc is [Mpad][N].
//
// bf16: tensor cores. A work item is one 16-wide column tile and up to four
// 16-row tiles (as many as keep every warp busy), so each weight fragment
// read from L2 feeds up to four products; the next group of weight fragments
// is in flight while the current one computes. K and N are multiples of 16.
__device__ inline void conv3x3(const __nv_bfloat16* __restrict__ in_pad, int S, int K,
                        const __nv_bfloat16* __restrict__ w, int ldw, int N, const Grid& g,
                        float* __restrict__ acc) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int n_tiles = N / 16;
  const int m_tiles = g.Mpad / 16;
  int group = 4;
  while (group > 1 && n_tiles * ((m_tiles + group - 1) / group) < kWarps) group /= 2;
  const int m_groups = (m_tiles + group - 1) / group;
  const int kt = K / 16;
  const int steps = 9 * kt;
  for (int item = warp; item < n_tiles * m_groups; item += kWarps) {
    const int nt = item % n_tiles;
    const int mt0 = (item / n_tiles) * group;
    const int mts = min(group, m_tiles - mt0);
    FragC c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::fill_fragment(c[i], 0.0f);
    FragB b0[kDepth], b1[kDepth];
    load_weights(b0, w, ldw, 0, steps, kt, K, nt);
    for (int s0 = 0; s0 < steps; s0 += 2 * kDepth) {
      load_weights(b1, w, ldw, s0 + kDepth, steps, kt, K, nt);
      mma_steps(c, b0, in_pad, S, s0, steps, kt, mt0, mts, g);
      load_weights(b0, w, ldw, s0 + 2 * kDepth, steps, kt, K, nt);
      mma_steps(c, b1, in_pad, S, s0 + kDepth, steps, kt, mt0, mts, g);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < mts) {
        wmma::store_matrix_sync(acc + (size_t)(mt0 + i) * 16 * N + nt * 16, c[i], N,
                                wmma::mem_row_major);
      }
    }
  }
}

// f32: scalar FMAs, one thread per (valid output position, column). Only the
// H x W valid rows of acc are written; the others are never read.
__device__ inline void conv3x3(const float* __restrict__ in_pad, int S, int K,
                        const float* __restrict__ w, int ldw, int N, const Grid& g,
                        float* __restrict__ acc) {
  const int outputs = g.H * g.W * N;
  for (int i = threadIdx.x; i < outputs; i += blockDim.x) {
    const int n = i % N;
    const int m = out_row(g, i / N);
    float s = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* a = in_pad + (size_t)(m + (tap / 3) * g.Wp + tap % 3) * S;
      const float* wt = w + (size_t)tap * K * ldw + n;
      for (int k = 0; k < K; ++k) s = fmaf(a[k], wt[(size_t)k * ldw], s);
    }
    acc[(size_t)m * N + n] = s;
  }
}

// Weight gradient of a 3x3 SAME conv, accumulated over calls:
//   part[tap][k][n] (first ? = : +=) sum_p in[p + shift(tap)][k] * grad[p][n]
// over the H x W positions p. `in_pad` is the conv's padded input ([R][S],
// K channels); `grad_pad` is the output gradient kept on the padded grid
// ([R][Sg], N channels), whose row m + Wp + 1 holds output-grid row m and is
// zero wherever m is not a valid position. part is [9][K][N] f32 in global
// memory, owned by this block.
//
// bf16: one 16x16 tile of part per work item, its Mpad rows as four
// k-steps, the tile read from and written back to global memory once per
// call. K and N are multiples of 16.
__device__ inline void kernel_grad_acc(const __nv_bfloat16* __restrict__ in_pad, int S, int K,
                                const __nv_bfloat16* __restrict__ grad_pad, int Sg, int N,
                                const Grid& g, float* __restrict__ part, bool first) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int kt = K / 16;
  const int nt = N / 16;
  for (int item = warp; item < 9 * kt * nt; item += kWarps) {
    const int n0 = (item % nt) * 16;
    const int k0 = ((item / nt) % kt) * 16;
    const int tap = item / (nt * kt);
    const int shift = (tap / 3) * g.Wp + tap % 3;
    float* out = part + ((size_t)tap * K + k0) * N + n0;
    FragC c;
    if (first) {
      wmma::fill_fragment(c, 0.0f);
    } else {
      wmma::load_matrix_sync(c, out, N, wmma::mem_row_major);
    }
    for (int m0 = 0; m0 < g.Mpad; m0 += 16) {
      // A = patches^T: A[k][m] = in_pad[m + shift][k], a column-major tile
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
      wmma::load_matrix_sync(a, in_pad + (size_t)(m0 + shift) * S + k0, S);
      FragB b;
      wmma::load_matrix_sync(b, grad_pad + (size_t)(m0 + g.Wp + 1) * Sg + n0, Sg);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(out, c, N, wmma::mem_row_major);
  }
}

// f32: scalar FMAs over the H x W valid positions, one thread per element.
__device__ inline void kernel_grad_acc(const float* __restrict__ in_pad, int S, int K,
                                const float* __restrict__ grad_pad, int Sg, int N,
                                const Grid& g, float* __restrict__ part, bool first) {
  const int total = 9 * K * N;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int n = i % N;
    const int k = (i / N) % K;
    const int tap = i / (N * K);
    const int shift = (tap / 3) * g.Wp + tap % 3;
    float s = 0.0f;
    for (int p = 0; p < g.H * g.W; ++p) {
      const int m = out_row(g, p);
      s = fmaf(in_pad[(size_t)(m + shift) * S + k], grad_pad[(size_t)(m + g.Wp + 1) * Sg + n], s);
    }
    part[i] = first ? s : part[i] + s;
  }
}

}  // namespace rgp
