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
// Design (a simple one that is right; clusters, wgmma and TMA come later; the
// conv helpers are in conv3x3.cuh):
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

#include "conv3x3.cuh"

using namespace rgp;

namespace {

// Shared memory layout: hs | us | acc | hpad | rhpad
inline size_t smem_bytes(const Grid& g, int U, size_t elem) {
  const size_t pu = (size_t)g.H * g.W * U;
  return align128(pu * 4) * 2 + align128((size_t)g.Mpad * 2 * U * 4) + pad_bytes(g, U, elem) * 2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    convgru_fwd_kernel(const T* __restrict__ wx, const T* __restrict__ u_zr,
                       const T* __restrict__ u_c, const float* __restrict__ h0,
                       float* __restrict__ ys, float* __restrict__ h_final, int steps,
                       int batch, int U, Grid g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int pu = g.H * g.W * U;
  const int S = pad_stride(U);
  float* hs = reinterpret_cast<float*>(smem);
  float* us = reinterpret_cast<float*>(smem + align128((size_t)pu * 4));
  float* acc = reinterpret_cast<float*>(smem + align128((size_t)pu * 4) * 2);
  T* hpad = reinterpret_cast<T*>(smem + align128((size_t)pu * 4) * 2 +
                                 align128((size_t)g.Mpad * 2 * U * 4));
  T* rhpad = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(hpad) +
                                  pad_bytes(g, U, sizeof(T)));
  const int b = blockIdx.x;

  // The borders and tail rows of both padded operands stay zero for the
  // whole sequence; only interior rows are rewritten.
  zero_fill(hpad, (size_t)g.R * S);
  zero_fill(rhpad, (size_t)g.R * S);
  __syncthreads();
  for (int i = threadIdx.x; i < pu; i += blockDim.x) {
    const int p = i / U, j = i % U;
    const float v = h0[(size_t)b * pu + i];
    hs[i] = v;
    hpad[(size_t)pad_row(g, p) * S + j] = from_f32<T>(v);
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const T* wxt = wx + ((size_t)t * batch + b) * pu * 3;

    // phase 1: z|r state conv, then the gates
    conv3x3(hpad, S, U, u_zr, 2 * U, 2 * U, g, acc);
    __syncthreads();
    for (int i = threadIdx.x; i < pu; i += blockDim.x) {
      const int p = i / U, j = i % U;
      const int m = out_row(g, p);
      const float u = sigmoid(to_f32(wxt[(size_t)p * 3 * U + j]) + acc[(size_t)m * 2 * U + j]);
      const float r =
          sigmoid(to_f32(wxt[(size_t)p * 3 * U + U + j]) + acc[(size_t)m * 2 * U + U + j]);
      us[i] = u;
      rhpad[(size_t)pad_row(g, p) * S + j] = from_f32<T>(r * hs[i]);
    }
    __syncthreads();

    // phase 2: candidate state conv, then the update
    conv3x3(rhpad, S, U, u_c, U, U, g, acc);
    __syncthreads();
    float* yt = ys + ((size_t)t * batch + b) * pu;
    for (int i = threadIdx.x; i < pu; i += blockDim.x) {
      const int p = i / U, j = i % U;
      const int m = out_row(g, p);
      const float c = tanhf(to_f32(wxt[(size_t)p * 3 * U + 2 * U + j]) + acc[(size_t)m * U + j]);
      const float u = us[i];
      const float h = u * hs[i] + (1.0f - u) * c;
      hs[i] = h;
      hpad[(size_t)pad_row(g, p) * S + j] = from_f32<T>(h);
      yt[i] = h;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < pu; i += blockDim.x) h_final[(size_t)b * pu + i] = hs[i];
}

template <typename T>
cudaError_t launch(const void* wx, const void* u_zr, const void* u_c, const float* h0,
                   float* ys, float* h_final, int steps, int batch, int U, const Grid& g,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(g, U, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      convgru_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  convgru_fwd_kernel<T><<<batch, kThreads, smem, stream>>>(
      static_cast<const T*>(wx), static_cast<const T*>(u_zr), static_cast<const T*>(u_c),
      h0, ys, h_final, steps, batch, U, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; elem_bytes is 2 (bf16) or 4 (f32).
size_t convgru_fwd_smem_bytes(int H, int W, int U, int elem_bytes) {
  return smem_bytes(make_grid(H, W), U, (size_t)elem_bytes);
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
  const Grid g = make_grid(H, W);
  if (steps < 1 || batch < 1 || U < 16 || U % 16 != 0 || H < 1 || W < 1 ||
      (elem_bytes != 2 && elem_bytes != 4) ||
      smem_bytes(g, U, (size_t)elem_bytes) > (size_t)kMaxSharedBytes) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return (int)launch<__nv_bfloat16>(wx, u_zr, u_c, h0, ys, h_final, steps, batch, U, g, s);
  }
  return (int)launch<float>(wx, u_zr, u_c, h0, ys, h_final, steps, batch, U, g, s);
}

}  // extern "C"
