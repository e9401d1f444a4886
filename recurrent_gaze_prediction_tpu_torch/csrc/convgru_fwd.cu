// ConvGRU forward recurrence over precomputed input gates, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_convgru_seq_kernel` of
// recurrent_gaze_prediction_tpu/ops/pallas/convgru.py (called through
// `convgru_scan_pallas`). Per step t, for each batch element:
//
//   uh  = conv3x3(h, [U_z | U_r])            (SAME, no bias)
//   u   = sigmoid(wx_z + uh_z),  r = sigmoid(wx_r + uh_r)
//   c   = tanh(wx_c + conv3x3(r * h, U_c))
//   h'  = u * h + (1 - u) * c                -> ys[t]
//
// Inputs: wx [T,B,H,W,3U] and the weights U_zr [3,3,U,2U], U_c [3,3,U,U] in
// one dtype (bf16, or f32 for the f32 mode); h0 [B,H,W,U] f32.
// Outputs: ys [T,B,H,W,U] f32 and the final state hT [B,H,W,U] f32.
//
// Numerics rule (the one that lets the TPU kernel agree with the plain scan):
//   * h and all gate math are f32;
//   * each state conv's operand (h, then r*h) is rounded to wx's dtype;
//   * products accumulate in f32 (the conv results are not rounded).
//
// Design (a simple one that is right; clusters, wgmma and TMA come later):
//   * One block per batch element loops over T inside the block; this takes
//     the place of the TPU's sequential grid over T.
//   * h (f32), u (f32), the rounded operands h and r*h, and the conv results
//     live in shared memory: ~160 KB at U=128 in bf16, ~208 KB in f32, so the
//     launch raises the dynamic shared memory limit.
//   * The weights stay in global memory and are served from L2 (bf16: U_zr
//     590 KB, U_c 295 KB, more than a block's 227 KB of shared memory). With
//     one block per element nothing can hide their L2 latency but the block
//     itself, so 16 warps each keep a group of 4 weight fragments in flight
//     while the previous group computes.
//   * A 3x3 SAME conv on the HxW grid is 9 shifted [M, U] x [U, N] products.
//     The operand is kept zero-padded on an (H+2)x(W+2) grid and the outputs
//     are computed on an H x (W+2) grid (the two extra columns are discarded),
//     so for tap (dy, dx) the rows of the A operand are one contiguous run of
//     the padded buffer starting at dy*(W+2)+dx. In bf16 the products run on
//     the tensor cores (WMMA 16x16x16, f32 accumulators); the f32 mode runs
//     scalar f32 FMAs.
//   * Each step has two phases separated by __syncthreads(): the z|r conv and
//     the gates, then the candidate conv and the update.
//
// Bound on an H100 SXM at T=42, B=16, U=128, bf16: the state convs are
// T*B*49*9*U*3U*2 = 29.1 GFLOP (29 us at 989 TFLOP/s); the bytes are wx 25.3 MB
// + ys 16.9 MB + weights and states ~1.3 MB = ~43 MB (13 us at 3.35 TB/s).
// So operations bound it. With one block per batch element only B of the 132
// SMs work, which is what the later cluster-split design addresses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDepth = 4;  // weight fragments a warp keeps in flight per group
constexpr int kMaxSharedBytes = 232448;  // 227 KB: the most a block can use

struct Geometry {
  int H, W, U;
  int Wp;    // padded row width W + 2
  int Mpad;  // output rows on the H x (W+2) grid, rounded up to 16
  int R;     // rows of a padded operand buffer
  int S;     // row stride of a padded operand buffer, in elements
};

inline Geometry make_geometry(int H, int W, int U) {
  Geometry g;
  g.H = H;
  g.W = W;
  g.U = U;
  g.Wp = W + 2;
  g.Mpad = (H * g.Wp + 15) / 16 * 16;
  // the last 16-row tile of tap (2, 2) reads up to row Mpad - 1 + 2*Wp + 2;
  // this also covers the (H+2)*(W+2) padded grid
  g.R = g.Mpad + 2 * g.Wp + 2;
  // U + 16: rows stay 32-byte aligned (WMMA's rule) and the 8 rows an A
  // fragment load reads spread over the banks (2-way instead of 8-way at a
  // 256-byte stride)
  g.S = U + 16;
  return g;
}

__host__ __device__ inline size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// Shared memory layout: hs | us | acc | hpad | rhpad
inline size_t smem_bytes(const Geometry& g, size_t elem) {
  const size_t pu = (size_t)g.H * g.W * g.U;
  return align128(pu * 4) * 2 + align128((size_t)g.Mpad * 2 * g.U * 4) +
         align128((size_t)g.R * g.S * elem) * 2;
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

// acc[m][n] = sum_{tap, k} in_pad[m + (tap/3)*Wp + tap%3][k] * w[tap][k][n]
// for m < Mpad, n < N; in_pad is [R][S], w is [9][U][N], acc is [Mpad][N].
// The k-steps of all nine taps run as one sequence s = tap*(U/16) + k0/16.
using FragB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                     nvcuda::wmma::row_major>;
using FragC = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// Issue the weight-fragment loads of k-steps s0 .. s0+kDepth-1 together, so
// their L2 latencies overlap.
__device__ __forceinline__ void load_weights(FragB (&b)[kDepth], const __nv_bfloat16* w,
                                             int s0, int steps, int kt, int U, int N,
                                             int nt) {
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    const int s = s0 + j;
    if (s < steps) {
      const int k = (s / kt) * U + (s % kt) * 16;  // row of w viewed as [9*U][N]
      nvcuda::wmma::load_matrix_sync(b[j], w + (size_t)k * N + nt * 16, N);
    }
  }
}

__device__ __forceinline__ void mma_steps(FragC (&c)[4], const FragB (&b)[kDepth],
                                          const __nv_bfloat16* in_pad, int s0, int steps,
                                          int kt, int mt0, int mts, const Geometry& g) {
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
          wmma::load_matrix_sync(a, in_pad + (size_t)(row0 + i * 16) * g.S + k0, g.S);
          wmma::mma_sync(c[i], a, b[j], c[i]);
        }
      }
    }
  }
}

// bf16: tensor cores. A work item is one 16-wide column tile and up to four
// 16-row tiles (as many as keep every warp busy), so each weight fragment
// read from L2 feeds up to four products; the next group of weight fragments
// is in flight while the current one computes.
__device__ void conv3x3(const __nv_bfloat16* __restrict__ in_pad,
                        const __nv_bfloat16* __restrict__ w, int N,
                        const Geometry& g, float* __restrict__ acc) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int n_tiles = N / 16;
  const int m_tiles = g.Mpad / 16;
  int group = 4;
  while (group > 1 && n_tiles * ((m_tiles + group - 1) / group) < kWarps) group /= 2;
  const int m_groups = (m_tiles + group - 1) / group;
  const int kt = g.U / 16;
  const int steps = 9 * kt;
  for (int item = warp; item < n_tiles * m_groups; item += kWarps) {
    const int nt = item % n_tiles;
    const int mt0 = (item / n_tiles) * group;
    const int mts = min(group, m_tiles - mt0);
    FragC c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::fill_fragment(c[i], 0.0f);
    FragB b0[kDepth], b1[kDepth];
    load_weights(b0, w, 0, steps, kt, g.U, N, nt);
    for (int s0 = 0; s0 < steps; s0 += 2 * kDepth) {
      load_weights(b1, w, s0 + kDepth, steps, kt, g.U, N, nt);
      mma_steps(c, b0, in_pad, s0, steps, kt, mt0, mts, g);
      load_weights(b0, w, s0 + 2 * kDepth, steps, kt, g.U, N, nt);
      mma_steps(c, b1, in_pad, s0 + kDepth, steps, kt, mt0, mts, g);
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
__device__ void conv3x3(const float* __restrict__ in_pad, const float* __restrict__ w,
                        int N, const Geometry& g, float* __restrict__ acc) {
  const int outputs = g.H * g.W * N;
  for (int i = threadIdx.x; i < outputs; i += blockDim.x) {
    const int n = i % N;
    const int p = i / N;
    const int m = (p / g.W) * g.Wp + p % g.W;
    float s = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* a = in_pad + (size_t)(m + (tap / 3) * g.Wp + tap % 3) * g.S;
      const float* wt = w + (size_t)tap * g.U * N + n;
      for (int k = 0; k < g.U; ++k) s = fmaf(a[k], wt[(size_t)k * N], s);
    }
    acc[(size_t)m * N + n] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    convgru_fwd_kernel(const T* __restrict__ wx, const T* __restrict__ u_zr,
                       const T* __restrict__ u_c, const float* __restrict__ h0,
                       float* __restrict__ ys, float* __restrict__ h_final, int steps,
                       int batch, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int U = g.U;
  const int pu = g.H * g.W * U;
  float* hs = reinterpret_cast<float*>(smem);
  float* us = reinterpret_cast<float*>(smem + align128((size_t)pu * 4));
  float* acc = reinterpret_cast<float*>(smem + align128((size_t)pu * 4) * 2);
  T* hpad = reinterpret_cast<T*>(smem + align128((size_t)pu * 4) * 2 +
                                 align128((size_t)g.Mpad * 2 * U * 4));
  T* rhpad = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(hpad) +
                                  align128((size_t)g.R * g.S * sizeof(T)));
  const int b = blockIdx.x;

  // The borders and tail rows of both padded operands stay zero for the
  // whole sequence; only interior rows are rewritten.
  for (int i = threadIdx.x; i < g.R * g.S; i += blockDim.x) {
    hpad[i] = from_f32<T>(0.0f);
    rhpad[i] = from_f32<T>(0.0f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < pu; i += blockDim.x) {
    const int p = i / U, j = i % U;
    const float v = h0[(size_t)b * pu + i];
    hs[i] = v;
    hpad[(size_t)((p / g.W + 1) * g.Wp + p % g.W + 1) * g.S + j] = from_f32<T>(v);
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const T* wxt = wx + ((size_t)t * batch + b) * pu * 3;

    // phase 1: z|r state conv, then the gates
    conv3x3(hpad, u_zr, 2 * U, g, acc);
    __syncthreads();
    for (int i = threadIdx.x; i < pu; i += blockDim.x) {
      const int p = i / U, j = i % U;
      const int m = (p / g.W) * g.Wp + p % g.W;
      const float u = sigmoid(to_f32(wxt[(size_t)p * 3 * U + j]) + acc[(size_t)m * 2 * U + j]);
      const float r =
          sigmoid(to_f32(wxt[(size_t)p * 3 * U + U + j]) + acc[(size_t)m * 2 * U + U + j]);
      us[i] = u;
      rhpad[(size_t)((p / g.W + 1) * g.Wp + p % g.W + 1) * g.S + j] = from_f32<T>(r * hs[i]);
    }
    __syncthreads();

    // phase 2: candidate state conv, then the update
    conv3x3(rhpad, u_c, U, g, acc);
    __syncthreads();
    float* yt = ys + ((size_t)t * batch + b) * pu;
    for (int i = threadIdx.x; i < pu; i += blockDim.x) {
      const int p = i / U, j = i % U;
      const int m = (p / g.W) * g.Wp + p % g.W;
      const float c = tanhf(to_f32(wxt[(size_t)p * 3 * U + 2 * U + j]) + acc[(size_t)m * U + j]);
      const float u = us[i];
      const float h = u * hs[i] + (1.0f - u) * c;
      hs[i] = h;
      hpad[(size_t)((p / g.W + 1) * g.Wp + p % g.W + 1) * g.S + j] = from_f32<T>(h);
      yt[i] = h;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < pu; i += blockDim.x) h_final[(size_t)b * pu + i] = hs[i];
}

template <typename T>
cudaError_t launch(const void* wx, const void* u_zr, const void* u_c, const float* h0,
                   float* ys, float* h_final, int steps, int batch, const Geometry& g,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(g, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      convgru_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  convgru_fwd_kernel<T><<<batch, kThreads, smem, stream>>>(
      static_cast<const T*>(wx), static_cast<const T*>(u_zr), static_cast<const T*>(u_c),
      h0, ys, h_final, steps, batch, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; elem_bytes is 2 (bf16) or 4 (f32).
size_t convgru_fwd_smem_bytes(int H, int W, int U, int elem_bytes) {
  return smem_bytes(make_geometry(H, W, U), (size_t)elem_bytes);
}

size_t convgru_fwd_smem_limit() { return (size_t)kMaxSharedBytes; }

const char* convgru_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// elem_bytes selects the dtype of wx and the weights: 2 = bf16, 4 = f32.
int convgru_fwd(const void* wx, const void* u_zr, const void* u_c, const float* h0,
                float* ys, float* h_final, int steps, int batch, int H, int W, int U,
                int elem_bytes, void* stream) {
  const Geometry g = make_geometry(H, W, U);
  if (steps < 1 || batch < 1 || U < 16 || U % 16 != 0 || H < 1 || W < 1 ||
      (elem_bytes != 2 && elem_bytes != 4) ||
      smem_bytes(g, (size_t)elem_bytes) > (size_t)kMaxSharedBytes) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return (int)launch<__nv_bfloat16>(wx, u_zr, u_c, h0, ys, h_final, steps, batch, g, s);
  }
  return (int)launch<float>(wx, u_zr, u_c, h0, ys, h_final, steps, batch, g, s);
}

}  // extern "C"
