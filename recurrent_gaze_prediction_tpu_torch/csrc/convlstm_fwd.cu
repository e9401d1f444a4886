// Peephole ConvLSTM forward recurrence over precomputed input gates, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_convlstm_seq_kernel` of
// recurrent_gaze_prediction_tpu/ops/pallas/convlstm.py (called through
// `convlstm_scan_pallas`). Per step t, for each batch element:
//
//   g   = gx[t] + conv3x3(h, [W_hi | W_hf | W_hc | W_ho])   (SAME, no bias)
//   i   = sigmoid(g_i + W_ci * c),  f = sigmoid(g_f + W_cf * c)
//   c'  = f * c + i * tanh(g_c)
//   o   = sigmoid(g_o + W_co * c)                (the OLD c, like the reference)
//   h'  = tanh(c') * o                           -> ys[t]
//
// Inputs: gx [T,B,H,W,4U] and the weight Wh [3,3,U,4U] in one dtype (bf16, or
// f32 for the f32 mode); the peepholes W_ci, W_cf, W_co [H,W,U] f32; the
// carries c0, h0 [B,H,W,U] f32.
// Outputs: ys [T,B,H,W,U] f32 and the final state cT, hT [B,H,W,U] f32. The
// TPU kernel's wrapper drops the final c; this one returns it, so the
// streaming step can carry (c, h) from chunk to chunk through the kernel.
//
// Numerics rule (B1's, so the card compares like with like with the plain
// scan):
//   * c, h, the peepholes and all gate math are f32; gx is added after a
//     cast to f32;
//   * the state conv's operand h is rounded to gx's dtype;
//   * products accumulate in f32 (the conv result is not rounded).
//
// Design (B1's, one phase shorter; a simple one that is right, with clusters,
// wgmma and TMA for later; the conv helper is in conv3x3.cuh):
//   * One block per batch element loops over T inside the block; this takes
//     the place of the TPU's sequential grid over T.
//   * Shared memory holds c (f32), the conv result acc [Mpad, 4U] (f32) and
//     the rounded, zero-padded conv operand hpad: 180,352 B at U=128 in bf16
//     and 204,544 B in f32, so the launch raises the dynamic shared memory
//     limit. h needs no f32 copy: h' depends on c' and o only, so each step
//     writes it straight to ys[t] and, rounded, to hpad.
//   * The peepholes (3 x 25 KB in f32) do not fit beside these; they are read
//     from global memory (L1/L2) in the elementwise phase, where each thread
//     reads the same positions every step.
//   * The weight Wh (1.18 MB in bf16) stays in global memory and is served
//     from L2, as B1's weights are.
//   * Each step is one conv3x3 of hpad against Wh with 4U output columns,
//     then __syncthreads, then one elementwise phase that forms i, f, c', o,
//     h' and writes c, hpad and ys[t] (and cT, hT after the last step).
//
// Bound on an H100 SXM at T=42, U=128, bf16: the state conv is
// T*B*49*9*U*4U*2 = 19.4 GFLOP at B=8 (19.6 us at 989 TFLOP/s) and 38.8 GFLOP
// at B=16 (39.3 us); the bytes are gx 16.9 / 33.7 MB + ys 8.4 / 16.9 MB + Wh
// 1.2 MB + carries ~0.8 / 1.6 MB (~8 / ~16 us at 3.35 TB/s). So operations
// bound it. With one block per batch element only B of the 132 SMs work, which
// is what a later cluster-split design addresses.

#include "conv3x3.cuh"

using namespace rgp;

namespace {

// Shared memory layout: cs | acc | hpad
inline size_t smem_bytes(const Grid& g, int U, size_t elem) {
  const size_t pu = (size_t)g.H * g.W * U;
  return align128(pu * 4) + align128((size_t)g.Mpad * 4 * U * 4) + pad_bytes(g, U, elem);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    convlstm_fwd_kernel(const T* __restrict__ gx, const T* __restrict__ wh,
                        const float* __restrict__ w_ci, const float* __restrict__ w_cf,
                        const float* __restrict__ w_co, const float* __restrict__ c0,
                        const float* __restrict__ h0, float* __restrict__ ys,
                        float* __restrict__ c_final, float* __restrict__ h_final, int steps,
                        int batch, int U, Grid g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int pu = g.H * g.W * U;
  const int S = pad_stride(U);
  float* cs = reinterpret_cast<float*>(smem);
  float* acc = reinterpret_cast<float*>(smem + align128((size_t)pu * 4));
  T* hpad = reinterpret_cast<T*>(smem + align128((size_t)pu * 4) +
                                 align128((size_t)g.Mpad * 4 * U * 4));
  const int b = blockIdx.x;
  const int ldg = 4 * U;

  // The borders and tail rows of the padded operand stay zero for the whole
  // sequence; only interior rows are rewritten.
  zero_fill(hpad, (size_t)g.R * S);
  __syncthreads();
  for (int i = threadIdx.x; i < pu; i += blockDim.x) {
    const int p = i / U, j = i % U;
    cs[i] = c0[(size_t)b * pu + i];
    hpad[(size_t)pad_row(g, p) * S + j] = from_f32<T>(h0[(size_t)b * pu + i]);
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const T* gxt = gx + ((size_t)t * batch + b) * pu * 4;

    // the i|f|c|o state conv
    conv3x3(hpad, S, U, wh, ldg, ldg, g, acc);
    __syncthreads();

    // the gates and the update
    float* yt = ys + ((size_t)t * batch + b) * pu;
    const bool last = t == steps - 1;
    for (int i = threadIdx.x; i < pu; i += blockDim.x) {
      const int p = i / U, j = i % U;
      const T* gp = gxt + (size_t)p * ldg + j;
      const float* ap = acc + (size_t)out_row(g, p) * ldg + j;
      const float c = cs[i];
      const float ig = sigmoid(to_f32(gp[0]) + ap[0] + w_ci[i] * c);
      const float fg = sigmoid(to_f32(gp[U]) + ap[U] + w_cf[i] * c);
      const float nc = fg * c + ig * tanhf(to_f32(gp[2 * U]) + ap[2 * U]);
      const float og = sigmoid(to_f32(gp[3 * U]) + ap[3 * U] + w_co[i] * c);
      const float h = tanhf(nc) * og;
      cs[i] = nc;
      hpad[(size_t)pad_row(g, p) * S + j] = from_f32<T>(h);
      yt[i] = h;
      if (last) {
        c_final[(size_t)b * pu + i] = nc;
        h_final[(size_t)b * pu + i] = h;
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* gx, const void* wh, const float* w_ci, const float* w_cf,
                   const float* w_co, const float* c0, const float* h0, float* ys,
                   float* c_final, float* h_final, int steps, int batch, int U, const Grid& g,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(g, U, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      convlstm_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  convlstm_fwd_kernel<T><<<batch, kThreads, smem, stream>>>(
      static_cast<const T*>(gx), static_cast<const T*>(wh), w_ci, w_cf, w_co, c0, h0, ys,
      c_final, h_final, steps, batch, U, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; elem_bytes is 2 (bf16) or 4 (f32).
size_t convlstm_fwd_smem_bytes(int H, int W, int U, int elem_bytes) {
  return smem_bytes(make_grid(H, W), U, (size_t)elem_bytes);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// elem_bytes selects the dtype of gx and Wh: 2 = bf16, 4 = f32.
int convlstm_fwd(const void* gx, const void* wh, const float* w_ci, const float* w_cf,
                 const float* w_co, const float* c0, const float* h0, float* ys,
                 float* c_final, float* h_final, int steps, int batch, int H, int W, int U,
                 int elem_bytes, void* stream) {
  const Grid g = make_grid(H, W);
  if (steps < 1 || batch < 1 || U < 16 || U % 16 != 0 || H < 1 || W < 1 ||
      (elem_bytes != 2 && elem_bytes != 4) ||
      smem_bytes(g, U, (size_t)elem_bytes) > (size_t)kMaxSharedBytes) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return (int)launch<__nv_bfloat16>(gx, wh, w_ci, w_cf, w_co, c0, h0, ys, c_final, h_final,
                                      steps, batch, U, g, s);
  }
  return (int)launch<float>(gx, wh, w_ci, w_cf, w_co, c0, h0, ys, c_final, h_final, steps,
                            batch, U, g, s);
}

}  // extern "C"
