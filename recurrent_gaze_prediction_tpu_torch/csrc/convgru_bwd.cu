// ConvGRU backward: the reverse-time recursion of the state cotangent, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_dh_bwd_kernel` of
// recurrent_gaze_prediction_tpu/ops/pallas/convgru_vjp2.py (called through
// `_dh_bwd_pallas`, stage 2 of the custom VJP `convgru_fused`). Stages 1 (the
// batched gate recompute) and 3 (the weight gradients as one contraction)
// stay library calls in the wrapper (ops/kernels/convgru_vjp2.py). Per step
// t = T-1 .. 0, for each batch element, with dh = 0 before the first:
//
//   dh'    = g[t] + dh
//   dc     = dh' * (1 - u),  du_pre = dh' * (h_prev - c) * u * (1 - u)
//   da     = dc * (1 - c^2)                                    -> da[t]
//   drh    = conv_T(da, U_c)                                   (U -> U)
//   dr_pre = drh * h_prev * r * (1 - r)
//   dzr    = [du_pre | dr_pre]                                 -> dzr[t]
//   dh     = dh' * u + drh * r + conv_T(dzr, U_zr)             (2U -> U)
//
// and dh0 = dh after step 0.
//
// Inputs: u, r, c, h_prev, g [T,B,H,W,U] f32; the transposed-conv weights
// U_c^T [3,3,U,U] and U_zr^T [3,3,2U,U] (flipped spatially, in/out swapped:
// built by the wrapper) in bf16, or f32 for the f32 mode.
// Outputs: dzr [T,B,H,W,2U], da [T,B,H,W,U], dh0 [B,H,W,U], all f32.
//
// Numerics rule (the forward kernel's): all elementwise math and dh are f32;
// each conv operand (da, then dzr) is rounded to the weights' dtype; products
// accumulate in f32.
//
// Design (a simple one that is right, B1's design run backwards; the conv
// helpers are in conv3x3.cuh):
//   * One block per batch element loops over T in reverse inside the block.
//   * dh (f32), the conv results and the two padded operands (da, dzr) live
//     in shared memory: ~125 KB at U=128 in bf16, ~193 KB in f32.
//   * The five input streams are read once each from global memory in the
//     elementwise phases; the weights are served from L2.
//   * Each step has three phases separated by __syncthreads(): the gate
//     cotangents and the first transposed conv; dr_pre and the second
//     transposed conv; the update of dh.
//
// Bound on an H100 SXM at T=42, B=8, U=128, bf16: the two transposed convs
// are T*B*49*9*U*3U*2 = 14.6 GFLOP (14.7 us at 989 TFLOP/s); the bytes are
// eight f32 [T,B,H,W,U] streams (67.4 MB) plus the bf16 weights (0.9 MB):
// 20.4 us at 3.35 TB/s. So bytes bound it. One block per element leaves most
// SMs idle, as in the forward kernel.

#include "conv3x3.cuh"

using namespace rgp;

namespace {

// Shared memory layout: dh | acc | dapad | zpad
inline size_t smem_bytes(const Grid& g, int U, size_t elem) {
  const size_t pu = (size_t)g.H * g.W * U;
  return align128(pu * 4) + align128((size_t)g.Mpad * U * 4) + pad_bytes(g, U, elem) +
         pad_bytes(g, 2 * U, elem);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    convgru_bwd_kernel(const float* __restrict__ u_s, const float* __restrict__ r_s,
                       const float* __restrict__ c_s, const float* __restrict__ hprev_s,
                       const float* __restrict__ g_s, const T* __restrict__ uzr_t,
                       const T* __restrict__ uc_t, float* __restrict__ dzr_s,
                       float* __restrict__ da_s, float* __restrict__ dh0, int steps,
                       int batch, int U, Grid g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int pu = g.H * g.W * U;
  const int S = pad_stride(U);
  const int S2 = pad_stride(2 * U);
  float* dh = reinterpret_cast<float*>(smem);
  float* acc = reinterpret_cast<float*>(smem + align128((size_t)pu * 4));
  T* dapad = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(acc) +
                                  align128((size_t)g.Mpad * U * 4));
  T* zpad = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(dapad) +
                                 pad_bytes(g, U, sizeof(T)));
  const int b = blockIdx.x;

  zero_fill(dapad, (size_t)g.R * S);
  zero_fill(zpad, (size_t)g.R * S2);
  for (int i = threadIdx.x; i < pu; i += blockDim.x) dh[i] = 0.0f;
  __syncthreads();

  for (int t = steps - 1; t >= 0; --t) {
    const size_t base = ((size_t)t * batch + b) * pu;  // [T,B,H,W,U] streams
    float* dzr_t = dzr_s + base * 2;

    // phase 1: gate cotangents; da and du_pre into the padded operands
    for (int i = threadIdx.x; i < pu; i += blockDim.x) {
      const int p = i / U, j = i % U;
      const float u = u_s[base + i];
      const float c = c_s[base + i];
      const float dhn = g_s[base + i] + dh[i];
      const float dup = dhn * (hprev_s[base + i] - c) * u * (1.0f - u);
      const float da = dhn * (1.0f - u) * (1.0f - c * c);
      dh[i] = dhn;
      da_s[base + i] = da;
      dzr_t[(size_t)p * 2 * U + j] = dup;
      const int row = pad_row(g, p);
      dapad[(size_t)row * S + j] = from_f32<T>(da);
      zpad[(size_t)row * S2 + j] = from_f32<T>(dup);
    }
    __syncthreads();
    conv3x3(dapad, S, U, uc_t, U, U, g, acc);  // drh
    __syncthreads();

    // phase 2: dr_pre into the padded dzr; dh = dh' * u + drh * r
    for (int i = threadIdx.x; i < pu; i += blockDim.x) {
      const int p = i / U, j = i % U;
      const float drh = acc[(size_t)out_row(g, p) * U + j];
      const float r = r_s[base + i];
      const float drp = drh * hprev_s[base + i] * r * (1.0f - r);
      dzr_t[(size_t)p * 2 * U + U + j] = drp;
      zpad[(size_t)pad_row(g, p) * S2 + U + j] = from_f32<T>(drp);
      dh[i] = dh[i] * u_s[base + i] + drh * r;
    }
    __syncthreads();
    conv3x3(zpad, S2, 2 * U, uzr_t, U, U, g, acc);
    __syncthreads();

    // phase 3: dh += conv_T(dzr, U_zr)
    for (int i = threadIdx.x; i < pu; i += blockDim.x) {
      dh[i] += acc[(size_t)out_row(g, i / U) * U + i % U];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < pu; i += blockDim.x) dh0[(size_t)b * pu + i] = dh[i];
}

template <typename T>
cudaError_t launch(const float* u, const float* r, const float* c, const float* hprev,
                   const float* gr, const void* uzr_t, const void* uc_t, float* dzr, float* da,
                   float* dh0, int steps, int batch, int U, const Grid& g,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(g, U, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      convgru_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  convgru_bwd_kernel<T><<<batch, kThreads, smem, stream>>>(
      u, r, c, hprev, gr, static_cast<const T*>(uzr_t), static_cast<const T*>(uc_t), dzr, da,
      dh0, steps, batch, U, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; elem_bytes is 2 (bf16) or 4 (f32).
size_t convgru_bwd_smem_bytes(int H, int W, int U, int elem_bytes) {
  return smem_bytes(make_grid(H, W), U, (size_t)elem_bytes);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// elem_bytes selects the dtype of the weights: 2 = bf16, 4 = f32.
int convgru_bwd(const float* u, const float* r, const float* c, const float* hprev,
                const float* g, const void* uzr_t, const void* uc_t, float* dzr, float* da,
                float* dh0, int steps, int batch, int H, int W, int U, int elem_bytes,
                void* stream) {
  const Grid grid = make_grid(H, W);
  if (steps < 1 || batch < 1 || U < 16 || U % 16 != 0 || H < 1 || W < 1 ||
      (elem_bytes != 2 && elem_bytes != 4) ||
      smem_bytes(grid, U, (size_t)elem_bytes) > (size_t)kMaxSharedBytes) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return (int)launch<__nv_bfloat16>(u, r, c, hprev, g, uzr_t, uc_t, dzr, da, dh0, steps,
                                      batch, U, grid, s);
  }
  return (int)launch<float>(u, r, c, hprev, g, uzr_t, uc_t, dzr, da, dh0, steps, batch, U, grid,
                            s);
}

}  // extern "C"
