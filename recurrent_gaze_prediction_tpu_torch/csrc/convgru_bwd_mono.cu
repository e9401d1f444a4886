// ConvGRU monolithic backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_convgru_bwd_kernel` of
// recurrent_gaze_prediction_tpu/ops/pallas/convgru_vjp.py (called through
// `_convgru_bwd_pallas`, the backward of the custom VJP
// `convgru_scan_fused`). Per step t = T-1 .. 0, for each batch element, with
// dh = 0 before the first, it recomputes the gates from h_prev = h_{t-1},
// then:
//
//   u = sigmoid(wx_z + conv(h_prev, U_z)),  r = sigmoid(wx_r + conv(h_prev, U_r))
//   c = tanh(wx_c + conv(r * h_prev, U_c))
//   dh'    = g[t] + dh
//   du_pre = dh' * (h_prev - c) * u * (1 - u),  da = dh' * (1 - u) * (1 - c^2)
//   drh    = conv_T(da, U_c),                   dU_c  += patches(r * h_prev)^T da
//   dr_pre = drh * h_prev * r * (1 - r),  dzr = [du_pre | dr_pre]
//   dh     = dh' * u + drh * r + conv_T(dzr, U_zr),  dU_zr += patches(h_prev)^T dzr
//   dwx[t] = [du_pre | dr_pre | da]
//
// and dh0 = dh after step 0.
//
// Inputs: wx [T,B,H,W,3U] and the weights U_zr [3,3,U,2U], U_c [3,3,U,U] and
// their transposed-conv forms U_zr^T [3,3,2U,U], U_c^T [3,3,U,U] (built by the
// wrapper), all in bf16, or f32 for the f32 mode; h_prev = [h0, ys[:-1]] and
// g [T,B,H,W,U] f32 (h_prev built by the wrapper).
// Outputs: dwx [T,B,H,W,3U] f32, dh0 [B,H,W,U] f32, and one partial dU_zr
// [9,U,2U] and dU_c [9,U,U] f32 per batch element, which the wrapper sums
// over B with one library reduction.
//
// Numerics rule (the forward kernel's): all elementwise math and dh are f32;
// each conv operand (h_prev, r*h_prev, da, dzr; in the weight gradients both
// sides) is rounded to the weights' dtype; products accumulate in f32.
//
// Design (a simple one that is right; the conv helpers are in conv3x3.cuh):
//   * One block per batch element loops over T in reverse inside the block.
//   * Five convs per step (z, r, candidate, two transposed) and two weight
//     gradients. dh (f32) and the conv results live in shared memory, and in
//     bf16 so do the four padded operands (h_prev, r*h_prev, da, dzr):
//     ~172 KB at U=128. In f32 the operands do not fit beside them (~288
//     KB), so the f32 mode keeps them in a per-block global workspace
//     (served from L1/L2); u and r go to a per-block global workspace in
//     both modes.
//   * The weight gradients (9*U*3U f32 = 1.77 MB at U=128) do not fit in a
//     block's shared memory. Each block keeps its own f32 partial in global
//     memory and reads, adds to and writes back each 16x16 tile once per
//     step (no atomics, deterministic); the sum over B is one reduction
//     after the launch.
//
// Bound on an H100 SXM at T=42, B=8, U=128, bf16: 3x the forward's FLOPs,
// 43.7 GFLOP (44.2 us at 989 TFLOP/s), against ~58 MB of inputs and outputs
// (17 us at 3.35 TB/s). So operations bound it.

#include "conv3x3.cuh"

using namespace rgp;

namespace {

// Shared memory layout: dh | acc [| hpad | rhpad | dapad | zpad in bf16]
__host__ __device__ inline size_t operand_bytes(const Grid& g, int U, size_t elem) {
  return pad_bytes(g, U, elem) * 3 + pad_bytes(g, 2 * U, elem);
}

__host__ __device__ inline bool operands_shared(size_t elem) { return elem == 2; }

inline size_t smem_bytes(const Grid& g, int U, size_t elem) {
  const size_t pu = (size_t)g.H * g.W * U;
  return align128(pu * 4) + align128((size_t)g.Mpad * U * 4) +
         (operands_shared(elem) ? operand_bytes(g, U, elem) : 0);
}

// Global workspace per block: u | r [| the operands in f32]
__host__ __device__ inline size_t workspace_bytes(const Grid& g, int U, size_t elem) {
  const size_t pu = (size_t)g.H * g.W * U;
  return align128(pu * 4) * 2 + (operands_shared(elem) ? 0 : operand_bytes(g, U, elem));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    convgru_bwd_mono_kernel(const T* __restrict__ wx, const float* __restrict__ hprev_s,
                            const float* __restrict__ g_s, const T* __restrict__ uzr,
                            const T* __restrict__ uc, const T* __restrict__ uzr_t,
                            const T* __restrict__ uc_t, float* __restrict__ dwx,
                            float* __restrict__ dh0, float* __restrict__ duzr_part,
                            float* __restrict__ duc_part, unsigned char* __restrict__ workspace,
                            int steps, int batch, int U, Grid g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int pu = g.H * g.W * U;
  const int S = pad_stride(U);
  const int S2 = pad_stride(2 * U);
  const int b = blockIdx.x;
  float* dh = reinterpret_cast<float*>(smem);
  float* acc = reinterpret_cast<float*>(smem + align128((size_t)pu * 4));
  unsigned char* ws = workspace + (size_t)b * workspace_bytes(g, U, sizeof(T));
  float* us = reinterpret_cast<float*>(ws);
  float* rs = reinterpret_cast<float*>(ws + align128((size_t)pu * 4));
  unsigned char* ops = operands_shared(sizeof(T))
                           ? reinterpret_cast<unsigned char*>(acc) +
                                 align128((size_t)g.Mpad * U * 4)
                           : ws + align128((size_t)pu * 4) * 2;
  T* hpad = reinterpret_cast<T*>(ops);
  T* rhpad = reinterpret_cast<T*>(ops + pad_bytes(g, U, sizeof(T)));
  T* dapad = reinterpret_cast<T*>(ops + pad_bytes(g, U, sizeof(T)) * 2);
  T* zpad = reinterpret_cast<T*>(ops + pad_bytes(g, U, sizeof(T)) * 3);
  float* duzr_b = duzr_part + (size_t)b * 9 * U * 2 * U;
  float* duc_b = duc_part + (size_t)b * 9 * U * U;

  zero_fill(hpad, (size_t)g.R * S);
  zero_fill(rhpad, (size_t)g.R * S);
  zero_fill(dapad, (size_t)g.R * S);
  zero_fill(zpad, (size_t)g.R * S2);
  for (int i = threadIdx.x; i < pu; i += blockDim.x) dh[i] = 0.0f;
  __syncthreads();

  for (int t = steps - 1; t >= 0; --t) {
    const size_t base = ((size_t)t * batch + b) * pu;  // [T,B,H,W,U] streams
    const T* wxt = wx + base * 3;
    float* dwxt = dwx + base * 3;

    // phase 1: h_prev into its padded operand; dh' = g + dh
    for (int i = threadIdx.x; i < pu; i += blockDim.x) {
      hpad[(size_t)pad_row(g, i / U) * S + i % U] = from_f32<T>(hprev_s[base + i]);
      dh[i] += g_s[base + i];
    }
    __syncthreads();

    // phase 2: recompute u (the z columns of U_zr)
    conv3x3(hpad, S, U, uzr, 2 * U, U, g, acc);
    __syncthreads();
    for (int i = threadIdx.x; i < pu; i += blockDim.x) {
      const int p = i / U, j = i % U;
      us[i] = sigmoid(to_f32(wxt[(size_t)p * 3 * U + j]) + acc[(size_t)out_row(g, p) * U + j]);
    }
    __syncthreads();

    // phase 3: recompute r (the r columns of U_zr) and r * h_prev
    conv3x3(hpad, S, U, uzr + U, 2 * U, U, g, acc);
    __syncthreads();
    for (int i = threadIdx.x; i < pu; i += blockDim.x) {
      const int p = i / U, j = i % U;
      const float r =
          sigmoid(to_f32(wxt[(size_t)p * 3 * U + U + j]) + acc[(size_t)out_row(g, p) * U + j]);
      rs[i] = r;
      rhpad[(size_t)pad_row(g, p) * S + j] = from_f32<T>(r * hprev_s[base + i]);
    }
    __syncthreads();

    // phase 4: recompute c; the gate cotangents
    conv3x3(rhpad, S, U, uc, U, U, g, acc);
    __syncthreads();
    for (int i = threadIdx.x; i < pu; i += blockDim.x) {
      const int p = i / U, j = i % U;
      const float c = tanhf(to_f32(wxt[(size_t)p * 3 * U + 2 * U + j]) +
                            acc[(size_t)out_row(g, p) * U + j]);
      const float u = us[i];
      const float dhn = dh[i];
      const float dup = dhn * (hprev_s[base + i] - c) * u * (1.0f - u);
      const float da = dhn * (1.0f - u) * (1.0f - c * c);
      dwxt[(size_t)p * 3 * U + j] = dup;
      dwxt[(size_t)p * 3 * U + 2 * U + j] = da;
      const int row = pad_row(g, p);
      dapad[(size_t)row * S + j] = from_f32<T>(da);
      zpad[(size_t)row * S2 + j] = from_f32<T>(dup);
    }
    __syncthreads();

    // phase 5: drh = conv_T(da, U_c); dr_pre; dh = dh' * u + drh * r
    conv3x3(dapad, S, U, uc_t, U, U, g, acc);
    __syncthreads();
    for (int i = threadIdx.x; i < pu; i += blockDim.x) {
      const int p = i / U, j = i % U;
      const float drh = acc[(size_t)out_row(g, p) * U + j];
      const float r = rs[i];
      const float drp = drh * hprev_s[base + i] * r * (1.0f - r);
      dwxt[(size_t)p * 3 * U + U + j] = drp;
      zpad[(size_t)pad_row(g, p) * S2 + U + j] = from_f32<T>(drp);
      dh[i] = dh[i] * us[i] + drh * r;
    }
    __syncthreads();

    // phase 6: conv_T(dzr, U_zr) and both weight gradients (read-only on
    // the operands, so they share one barrier)
    conv3x3(zpad, S2, 2 * U, uzr_t, U, U, g, acc);
    const bool first = t == steps - 1;
    kernel_grad_acc(rhpad, S, U, dapad, S, U, g, duc_b, first);
    kernel_grad_acc(hpad, S, U, zpad, S2, 2 * U, g, duzr_b, first);
    __syncthreads();
    for (int i = threadIdx.x; i < pu; i += blockDim.x) {
      dh[i] += acc[(size_t)out_row(g, i / U) * U + i % U];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < pu; i += blockDim.x) dh0[(size_t)b * pu + i] = dh[i];
}

template <typename T>
cudaError_t launch(const void* wx, const float* hprev, const float* gr, const void* uzr,
                   const void* uc, const void* uzr_t, const void* uc_t, float* dwx, float* dh0,
                   float* duzr_part, float* duc_part, void* workspace, int steps, int batch,
                   int U, const Grid& g, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, U, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      convgru_bwd_mono_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  convgru_bwd_mono_kernel<T><<<batch, kThreads, smem, stream>>>(
      static_cast<const T*>(wx), hprev, gr, static_cast<const T*>(uzr),
      static_cast<const T*>(uc), static_cast<const T*>(uzr_t), static_cast<const T*>(uc_t), dwx,
      dh0, duzr_part, duc_part, static_cast<unsigned char*>(workspace), steps, batch, U, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; elem_bytes is 2 (bf16) or 4 (f32).
size_t convgru_bwd_mono_smem_bytes(int H, int W, int U, int elem_bytes) {
  return smem_bytes(make_grid(H, W), U, (size_t)elem_bytes);
}

// Bytes of global workspace the launch needs, for all `batch` blocks.
size_t convgru_bwd_mono_workspace_bytes(int batch, int H, int W, int U, int elem_bytes) {
  return (size_t)batch * workspace_bytes(make_grid(H, W), U, (size_t)elem_bytes);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// elem_bytes selects the dtype of wx and the weights: 2 = bf16, 4 = f32.
int convgru_bwd_mono(const void* wx, const float* hprev, const float* g, const void* uzr,
                     const void* uc, const void* uzr_t, const void* uc_t, float* dwx,
                     float* dh0, float* duzr_part, float* duc_part, void* workspace, int steps,
                     int batch, int H, int W, int U, int elem_bytes, void* stream) {
  const Grid grid = make_grid(H, W);
  if (steps < 1 || batch < 1 || U < 16 || U % 16 != 0 || H < 1 || W < 1 ||
      (elem_bytes != 2 && elem_bytes != 4) ||
      smem_bytes(grid, U, (size_t)elem_bytes) > (size_t)kMaxSharedBytes) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return (int)launch<__nv_bfloat16>(wx, hprev, g, uzr, uc, uzr_t, uc_t, dwx, dh0, duzr_part,
                                      duc_part, workspace, steps, batch, U, grid, s);
  }
  return (int)launch<float>(wx, hprev, g, uzr, uc, uzr_t, uc_t, dwx, dh0, duzr_part, duc_part,
                            workspace, steps, batch, U, grid, s);
}

}  // extern "C"
