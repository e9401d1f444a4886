// Cluster-split 3x3 SAME convolutions for the ConvGRU kernels B1
// (convgru_fwd.cu) and B2 (convgru_bwd.cu) and the ConvLSTM kernel B3
// (convlstm_fwd.cu) on Hopper (sm_90a); B4's phases G and W
// (convgru_bwd_gates.cu, convgru_wgrad.cu) use its grid, copies and mma
// helpers.
//
// One batch element runs on a thread-block cluster of C CTAs
// (`cluster_size`); CTA k owns the output channels [k*Ns, (k+1)*Ns),
// Ns = U / C. Each CTA keeps:
//   * its weight slice in shared memory for the whole sequence, copied once
//     per launch with cp.async (bf16; in f32 the slice does not fit, and the
//     f32 conv reads it from global memory);
//   * the whole zero-padded conv operand (every channel). Each CTA computes
//     its own channel slice of the next operand and stores it into every
//     CTA's copy through distributed shared memory (`quad_broadcast`); a
//     cluster barrier then makes the stores visible.
//
// Layout: the padded grid. An operand with K channels is kept zero-padded on
// an (H+2) x (W+2) grid in a buffer of R rows of stride K + 8 elements.
// Outputs are computed on an H x (W+2) grid of Mpad rows (the two extra
// columns and the tail rows are discarded), so for tap (dy, dx) the rows of
// the A operand are one contiguous run of the padded buffer starting at
// dy*(W+2)+dx. In bf16 a row of K + 8 elements is an odd number of 16-byte
// units, so the 8 rows one ldmatrix reads fall on 8 distinct groups of 4
// banks.
//
// Weights. A slice is [9*K][N] (HWIO, taps flattened, the CTA's output
// columns). In bf16 the wrapper stores it in mma fragment order
// (ops/kernels/convgru.py::fragment_order): for k-step s (rows 16s..16s+15)
// and column pair q (columns 16q..16q+15), lane l = 4g + c holds 16 bytes,
//   B[16s+2c][n], B[16s+2c+1][n], B[16s+2c+8][n], B[16s+2c+9][n]
// for n = 16q + g, then the same four for n = 16q + 8 + g. These are the
// b0, b1 registers of mma.m16n8k16 for two n8 tiles, so a warp reads a
// k-step's B fragments as one conflict-free 512-byte LDS.128 per pair.
//
// Products. bf16: mma.sync.m16n8k16 with f32 accumulators, A by ldmatrix
// from the padded operand. A CTA's conv is [Mpad] x [9K] x [N] with N = Ns,
// 2 Ns or 4 Ns: a handful of output tiles. So the 9K depth is split into KG
// groups across warps (a template parameter: kKGroups for B1 and B2; B3's
// shared memory has room for one plane); each writes its partial sums into
// its own plane of `acc`, and the elementwise phase adds the planes in a
// fixed order. The f32 conv runs scalar FMAs into one plane.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace rgpc {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr int kKGroups = 4;              // split of the conv depth (bf16)
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

// CTAs per batch element for U units: the largest divisor of U/16 that is
// at most kMaxCluster, so each CTA owns a multiple of 16 channels
inline int cluster_size(int U) {
  const int tiles = U / 16;
  for (int c = kMaxCluster; c > 1; --c) {
    if (tiles % c == 0) return c;
  }
  return 1;
}

__host__ __device__ inline int pad_stride(int K) { return K + 8; }

__host__ __device__ inline size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// bytes of a padded operand buffer with K channels
__host__ __device__ inline size_t pad_bytes(const Grid& g, int K, size_t elem) {
  return align128((size_t)g.R * pad_stride(K) * elem);
}

// floats of one plane of acc with N columns; its row stride N + 8 spreads
// the rows an accumulator fragment stores over the banks
__host__ __device__ inline size_t acc_plane(const Grid& g, int N) {
  return (size_t)g.Mpad * (N + 8);
}

// planes of acc: the split of the conv depth into KG groups (bf16)
template <typename T, int KG = kKGroups>
__host__ __device__ constexpr int k_groups() {
  return sizeof(T) == 2 ? KG : 1;
}

// row of interior position p (row-major over H x W) in a padded buffer
__device__ __forceinline__ int pad_row(const Grid& g, int p) {
  return (p / g.W + 1) * g.Wp + p % g.W + 1;
}

// row of position p on the H x (W+2) output grid
__device__ __forceinline__ int out_row(const Grid& g, int p) {
  return (p / g.W) * g.Wp + p % g.W;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// sum over the planes of acc at offset i, in plane order
template <typename T, int KG = kKGroups>
__device__ __forceinline__ float acc_sum(const float* acc, size_t plane, size_t i) {
  float s = acc[i];
#pragma unroll
  for (int kg = 1; kg < k_groups<T, KG>(); ++kg) s += acc[kg * plane + i];
  return s;
}

// ---------------------------------------------------------------- copies

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying `bytes` (a multiple of 16) from global to shared memory.
__device__ inline void copy_async(void* dst, const void* src, size_t bytes) {
  for (size_t i = (size_t)threadIdx.x * 16; i < bytes; i += (size_t)blockDim.x * 16) {
    cp_async16(static_cast<char*>(dst) + i, static_cast<const char*>(src) + i);
  }
}

// Start copying rows x width elements, row stride `stride` in global memory,
// into a dense [rows][width] array in shared memory (width * sizeof(T) a
// multiple of 16, both ends 16-byte aligned).
template <typename T>
__device__ inline void copy_slice_async(T* dst, const T* src, int rows, int stride, int width) {
  const int chunks = width * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int row = i / chunks, ch = i % chunks;
    cp_async16(reinterpret_cast<char*>(dst + (size_t)row * width) + ch * 16,
               reinterpret_cast<const char*>(src + (size_t)row * stride) + ch * 16);
  }
}

// Zero `bytes` (a multiple of 16) of shared memory.
__device__ inline void zero_fill(void* buf, size_t bytes) {
  uint4* p = static_cast<uint4*>(buf);
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) p[i] = make_uint4(0, 0, 0, 0);
}

// Two consecutive values at p (4-byte aligned in bf16, 8 in f32), as f32.
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Store two (four) f32 values at p, rounded to the buffer's type (p
// aligned to their size).
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// The four lanes of a quad (lanes 4q .. 4q+3) hold two consecutive channels
// each, (v0, v1): eight consecutive channels, the first of which is at
// element `off` of `buf` (the same `off` in all four lanes). Store the
// eight, rounded to the buffer's type, at `off` in every CTA of the cluster
// (distributed shared memory), the CTAs split over the quad's lanes: one
// 16-byte store per CTA in bf16, two in f32. All 32 lanes of the warp call
// it; `active` is false for a quad that holds nothing.
__device__ inline void quad_broadcast(__nv_bfloat16* buf, size_t off, float v0, float v1,
                                      bool active) {
  const uint32_t mine = pack_bf16x2(v0, v1);
  const int quad = threadIdx.x & 28;
  const uint4 q = make_uint4(__shfl_sync(0xffffffffu, mine, quad),
                             __shfl_sync(0xffffffffu, mine, quad + 1),
                             __shfl_sync(0xffffffffu, mine, quad + 2),
                             __shfl_sync(0xffffffffu, mine, quad + 3));
  if (!active) return;
  cg::cluster_group cluster = cg::this_cluster();
  for (int r = threadIdx.x & 3; r < (int)cluster.num_blocks(); r += 4) {
    *reinterpret_cast<uint4*>(cluster.map_shared_rank(buf + off, r)) = q;
  }
}

__device__ inline void quad_broadcast(float* buf, size_t off, float v0, float v1, bool active) {
  const int quad = threadIdx.x & 28;
  float v[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __shfl_sync(0xffffffffu, v0, quad + j);
    v[2 * j + 1] = __shfl_sync(0xffffffffu, v1, quad + j);
  }
  if (!active) return;
  cg::cluster_group cluster = cg::this_cluster();
  for (int r = threadIdx.x & 3; r < (int)cluster.num_blocks(); r += 4) {
    float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(buf + off, r));
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// ------------------------------------------------------------------ convs

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const __nv_bfloat16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

// The same for four 8x8 matrices stored transposed (rows along k): lane l
// receives elements (2(l%4), l/4) and (2(l%4)+1, l/4) of each.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const __nv_bfloat16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[kg][m][n] = the part over k-group kg of
//   sum_{tap, k} in_pad[m + (tap/3)*Wp + tap%3][k] * w[tap*K + k][n]
// for m < Mpad, n < N (row stride N + 8). in_pad is [R][pad_stride(K)] in
// shared memory, w the [9K][N] slice in fragment order in shared memory.
// K and N are multiples of 16.
//
// A work item is one 16-row tile by up to two column pairs (32 columns) by
// one of KG k-groups: the 16-channel steps kk of every tap with
// kk % KG == kg. Each item writes its partial sums into its group's plane;
// no block barrier is needed inside.
template <int KG = kKGroups>
__device__ inline void conv_slice(const __nv_bfloat16* __restrict__ in_pad, int K,
                                  const __nv_bfloat16* __restrict__ w, int N, const Grid& g,
                                  float* __restrict__ acc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int S = pad_stride(K);
  const int kt = K / 16;
  const int m_tiles = g.Mpad / 16;
  const int pairs = N / 16, n_groups = (pairs + 1) / 2;
  const int ld = N + 8;
  const uint4* wf = reinterpret_cast<const uint4*>(w);
  for (int item = warp; item < m_tiles * n_groups * KG; item += kWarps) {
    const int kg = item % KG, mn = item / KG;
    const int mt = mn % m_tiles, q0 = mn / m_tiles * 2;
    const bool q2 = q0 + 1 < pairs;
    float c[4][4] = {};
    // this lane's ldmatrix row (lane % 16) and 8-column half (lane / 16)
    const __nv_bfloat16* a_lane = in_pad + (size_t)(mt * 16 + lane % 16) * S + (lane / 16) * 8;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const __nv_bfloat16* a_tap = a_lane + ((tap / 3) * g.Wp + tap % 3) * S;
      const uint4* b_tap = wf + ((size_t)tap * kt * pairs + q0) * 32 + lane;
#pragma unroll 2
      for (int kk = kg; kk < kt; kk += KG) {
        uint32_t a[4];
        ldmatrix_x4(a, a_tap + kk * 16);
        const uint4 b0 = b_tap[(size_t)kk * pairs * 32];
        mma_bf16(c[0], a, b0.x, b0.y);
        mma_bf16(c[1], a, b0.z, b0.w);
        if (q2) {
          const uint4 b1 = b_tap[((size_t)kk * pairs + 1) * 32];
          mma_bf16(c[2], a, b1.x, b1.y);
          mma_bf16(c[3], a, b1.z, b1.w);
        }
      }
    }
    // fragment (row g, columns 2c, 2c+1) and (row g + 8, the same columns)
    float* out = acc + (size_t)kg * acc_plane(g, N) + (size_t)(mt * 16 + lane / 4) * ld +
                 q0 * 16 + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < 2 || q2) {
        *reinterpret_cast<float2*>(out + j * 8) = make_float2(c[j][0], c[j][1]);
        *reinterpret_cast<float2*>(out + 8 * ld + j * 8) = make_float2(c[j][2], c[j][3]);
      }
    }
  }
}

// f32: scalar FMAs into plane 0, one thread per (valid position, column);
// w is the plain [9K][N] slice in global memory. Only the H x W valid rows
// of acc are written; the others are never read. KG has no effect.
template <int KG = kKGroups>
__device__ inline void conv_slice(const float* __restrict__ in_pad, int K,
                                  const float* __restrict__ w, int N, const Grid& g,
                                  float* __restrict__ acc) {
  const int S = pad_stride(K);
  for (int i = threadIdx.x; i < g.H * g.W * N; i += blockDim.x) {
    const int n = i % N;
    const int m = out_row(g, i / N);
    float s = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* a = in_pad + (size_t)(m + (tap / 3) * g.Wp + tap % 3) * S;
      const float* wt = w + (size_t)tap * K * N + n;
      for (int k = 0; k < K; ++k) s = fmaf(a[k], __ldg(wt + (size_t)k * N), s);
    }
    acc[(size_t)m * (N + 8) + n] = s;
  }
}

}  // namespace rgpc
