// ConvGRU forward recurrence over precomputed input gates, for Hopper
// (sm_90a): kernel B1.
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
// Inputs: wx [T,B,H,W,3U] in bf16 (or f32 for the f32 mode); h0 [B,H,W,U]
// f32; the weights U_zr [3,3,U,2U] and U_c [3,3,U,U] as per-CTA column
// slices packed by the wrapper (ops/kernels/convgru.py): wzr [C][9U][2Ns]
// (the z and the r columns of the CTA's channels) and wc [C][9U][Ns], in
// mma fragment order in bf16 and plain in f32.
// Outputs: ys [T,B,H,W,U] f32 and the final state hT [B,H,W,U] f32.
//
// Numerics rule (the one that lets the TPU kernel agree with the plain scan):
//   * h and all gate math are f32;
//   * each state conv's operand (h, then r*h) is rounded to wx's dtype;
//   * products accumulate in f32 (the conv results are not rounded). The
//     depth of each conv is summed in four parts that are then added, a
//     reassociation of the f32 sums (bf16 mode).
//
// Bound on an H100 SXM at T=42, U=128, bf16: the state convs are
// T*B*49*9*U*3U*2 = 14.6 GFLOP at B=8 and 29.1 at B=16 (15 / 29 us at 989
// TFLOP/s), against ~22 / 43 MB moved (7 / 13 us at 3.35 TB/s). So
// operations bound it. The recurrence is sequential in T, so what a step
// costs is latency: one block per element (the previous design) left 124
// of 132 SMs idle at B=8, re-read the 885 KB of weights from L2 every step
// and could not do a step's 57 MFLOP in less than ~7.5 us on one SM.
//
// Design (helpers in cluster_conv.cuh):
//   * One cluster of C CTAs per batch element (C = 8 at U = 128), launched
//     with cudaLaunchKernelEx; CTA k owns the channels [k*Ns, (k+1)*Ns).
//   * Its weight slices (110.6 KB at U = 128 in bf16) are copied into
//     shared memory once per launch; no weight byte is read from L2 inside
//     the T loop.
//   * Every CTA keeps the whole padded operands hpad and rhpad. Each step:
//       1. z|r conv of its 2 Ns columns on hpad;
//       2. its gates; its slice of r*h into every CTA's rhpad (DSMEM);
//       3. cluster barrier A;
//       4. candidate conv of its Ns columns on rhpad;
//       5. its update of h, written to ys[t] and into every CTA's hpad;
//       6. cluster barrier B.
//     A CTA writes into a peer's buffer only after a barrier that every
//     reader of that buffer passed after its conv: hpad is read before A and
//     written after it, rhpad read between A and B and written after B.
//     Barrier B of the last step is also the one that keeps a CTA from
//     leaving while a peer may still store into its shared memory.
//   * In the elementwise phases every lane owns two channels of one
//     position; a quad of lanes gathers its eight channels with shuffles
//     and stores them, 16 bytes per CTA, into all C copies.
//   * The next step's wx slice (49 x 3Ns) is prefetched with cp.async into
//     a second buffer while the current step computes.
//   * Shared memory per CTA at H = W = 7, U = 128, C = 8 (stride K + 8):
//     bf16: weights 110,592 + hpad and rhpad 22,912 each + acc (4 planes of
//     64 x 40 f32) 40,960 + own h and u 3,200 each + wx 9,472 = 213,248 B;
//     f32 (weights from global memory): 126,848 B.
//   * Clusters do not depend on each other; at B = 28 (the train batch)
//     they run in two waves. The launch is refused when not one cluster of
//     this size fits the card.

#include "cluster_conv.cuh"

using namespace rgpc;

namespace {

// Byte offsets into one CTA's shared memory.
struct Layout {
  size_t wzr, wc, hpad, rhpad, acc, hs, us, wxb, total;
};

__host__ __device__ inline Layout layout(const Grid& g, int U, int C, size_t elem) {
  const size_t ns = U / C, hw = (size_t)g.H * g.W;
  const bool resident = elem == 2;  // bf16 weight slices live in shared memory
  Layout l;
  size_t o = 0;
  l.wzr = o;
  o += resident ? align128(9 * U * 2 * ns * elem) : 0;
  l.wc = o;
  o += resident ? align128(9 * U * ns * elem) : 0;
  l.hpad = o;
  o += pad_bytes(g, U, elem);
  l.rhpad = o;
  o += pad_bytes(g, U, elem);
  l.acc = o;
  o += align128(acc_plane(g, 2 * ns) * 4 * (resident ? kKGroups : 1));
  l.hs = o;
  o += align128(hw * ns * 4);
  l.us = o;
  o += align128(hw * ns * 4);
  l.wxb = o;
  o += align128(2 * 3 * hw * ns * elem);
  l.total = o;
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    convgru_fwd_kernel(const T* __restrict__ wx, const T* __restrict__ wzr_all,
                       const T* __restrict__ wc_all, const float* __restrict__ h0,
                       float* __restrict__ ys, float* __restrict__ h_final, int steps,
                       int batch, int U, Grid g) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int ns = U / C, n0 = rank * ns;
  const int hw = g.H * g.W;
  const int S = pad_stride(U);
  const Layout l = layout(g, U, C, sizeof(T));
  constexpr bool kResident = sizeof(T) == 2;
  T* hpad = reinterpret_cast<T*>(smem + l.hpad);
  T* rhpad = reinterpret_cast<T*>(smem + l.rhpad);
  float* acc = reinterpret_cast<float*>(smem + l.acc);
  float* hs = reinterpret_cast<float*>(smem + l.hs);
  float* us = reinterpret_cast<float*>(smem + l.us);
  T* wxb = reinterpret_cast<T*>(smem + l.wxb);
  const size_t wzr_n = (size_t)9 * U * 2 * ns, wc_n = (size_t)9 * U * ns;
  const T* wzr = wzr_all + rank * wzr_n;
  const T* wc = wc_all + rank * wc_n;
  if constexpr (kResident) {
    copy_async(smem + l.wzr, wzr, wzr_n * sizeof(T));
    copy_async(smem + l.wc, wc, wc_n * sizeof(T));
    wzr = reinterpret_cast<const T*>(smem + l.wzr);
    wc = reinterpret_cast<const T*>(smem + l.wc);
  }
  // wx[t]'s slice of this CTA: [3 gates][hw][ns]
  const size_t slice = (size_t)3 * hw * ns;
  auto load_wx = [&](int t, T* dst) {
    const T* src = wx + ((size_t)t * batch + b) * hw * 3 * U + n0;
    for (int gate = 0; gate < 3; ++gate) {
      copy_slice_async(dst + gate * hw * ns, src + gate * U, hw, 3 * U, ns);
    }
  };
  load_wx(0, wxb);
  cp_async_commit();

  // The borders and tail rows of both padded operands stay zero for the
  // whole sequence; only interior rows are rewritten.
  zero_fill(hpad, pad_bytes(g, U, sizeof(T)));
  zero_fill(rhpad, pad_bytes(g, U, sizeof(T)));
  cluster.sync();  // every copy is zero before any CTA stores into it

  // In the elementwise phases lane i = p * (ns / 2) + n / 2 owns channels
  // n, n + 1 of position p; a quad of lanes (8 channels) stores them into
  // every CTA's copy of the next operand. The loops run whole warps
  // (`quad_broadcast` shuffles), and hw * ns / 2 is a multiple of 8, so a
  // quad is active or idle as a whole.
  const int pairs = ns / 2, items = hw * pairs;
  const int lane = threadIdx.x % 32;
  for (int i0 = threadIdx.x - lane; i0 < items; i0 += blockDim.x) {
    const int i = i0 + lane, p = i / pairs, n = (i % pairs) * 2;
    const bool active = i < items;
    float2 v = make_float2(0.0f, 0.0f);
    if (active) {
      v = load2(h0 + ((size_t)b * hw + p) * U + n0 + n);
      hs[p * ns + n] = v.x;
      hs[p * ns + n + 1] = v.y;
    }
    quad_broadcast(hpad, (size_t)pad_row(g, p) * S + n0 + n - 2 * (lane & 3), v.x, v.y, active);
  }
  cp_async_wait<0>();
  cluster.sync();  // h0 in every hpad; the weights and wx[0] have landed

  const size_t plane2 = acc_plane(g, 2 * ns), plane1 = acc_plane(g, ns);
  for (int t = 0; t < steps; ++t) {
    const T* cur = wxb + (t & 1) * slice;
    if (t + 1 < steps) load_wx(t + 1, wxb + ((t + 1) & 1) * slice);
    cp_async_commit();

    // 1-2. z|r conv, then the gates; r*h into every rhpad
    conv_slice(hpad, U, wzr, 2 * ns, g, acc);
    cp_async_wait<1>();  // wx[t] has landed
    __syncthreads();
    for (int i0 = threadIdx.x - lane; i0 < items; i0 += blockDim.x) {
      const int i = i0 + lane, p = i / pairs, n = (i % pairs) * 2;
      const int k = p * ns + n;
      const bool active = i < items;
      float rh0 = 0.0f, rh1 = 0.0f;
      if (active) {
        const size_t row = (size_t)out_row(g, p) * (2 * ns + 8);
        const float2 wz = load2(cur + k), wr = load2(cur + hw * ns + k);
        us[k] = sigmoid(wz.x + acc_sum<T>(acc, plane2, row + n));
        us[k + 1] = sigmoid(wz.y + acc_sum<T>(acc, plane2, row + n + 1));
        rh0 = sigmoid(wr.x + acc_sum<T>(acc, plane2, row + ns + n)) * hs[k];
        rh1 = sigmoid(wr.y + acc_sum<T>(acc, plane2, row + ns + n + 1)) * hs[k + 1];
      }
      quad_broadcast(rhpad, (size_t)pad_row(g, p) * S + n0 + n - 2 * (lane & 3), rh0, rh1,
                     active);
    }
    cluster.sync();  // A

    // 4-5. candidate conv, then the update; h into ys[t] and every hpad
    conv_slice(rhpad, U, wc, ns, g, acc);
    __syncthreads();
    float* yt = ys + ((size_t)t * batch + b) * hw * U + n0;
    for (int i0 = threadIdx.x - lane; i0 < items; i0 += blockDim.x) {
      const int i = i0 + lane, p = i / pairs, n = (i % pairs) * 2;
      const int k = p * ns + n;
      const bool active = i < items;
      float h0n = 0.0f, h1n = 0.0f;
      if (active) {
        const size_t row = (size_t)out_row(g, p) * (ns + 8);
        const float2 wc2 = load2(cur + 2 * hw * ns + k);
        const float c0 = tanhf(wc2.x + acc_sum<T>(acc, plane1, row + n));
        const float c1 = tanhf(wc2.y + acc_sum<T>(acc, plane1, row + n + 1));
        h0n = us[k] * hs[k] + (1.0f - us[k]) * c0;
        h1n = us[k + 1] * hs[k + 1] + (1.0f - us[k + 1]) * c1;
        hs[k] = h0n;
        hs[k + 1] = h1n;
        *reinterpret_cast<float2*>(yt + (size_t)p * U + n) = make_float2(h0n, h1n);
      }
      quad_broadcast(hpad, (size_t)pad_row(g, p) * S + n0 + n - 2 * (lane & 3), h0n, h1n,
                     active);
    }
    cluster.sync();  // B
  }
  for (int i = threadIdx.x; i < hw * ns; i += blockDim.x) {
    h_final[((size_t)b * hw + i / ns) * U + n0 + i % ns] = hs[i];
  }
}

template <typename T>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int batch, int U,
                      const Grid& g, cudaStream_t stream, int* clusters) {
  const int C = cluster_size(U);
  const size_t smem = layout(g, U, C, sizeof(T)).total;
  if (smem > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      convgru_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cfg = {};
  cfg.gridDim = dim3(batch * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, convgru_fwd_kernel<T>, &cfg);
}

template <typename T>
cudaError_t launch(const void* wx, const void* wzr, const void* wc, const float* h0, float* ys,
                   float* h_final, int steps, int batch, int U, const Grid& g,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  cudaError_t err = configure<T>(cfg, attr, batch, U, g, stream, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  return cudaLaunchKernelEx(&cfg, convgru_fwd_kernel<T>, static_cast<const T*>(wx),
                            static_cast<const T*>(wzr), static_cast<const T*>(wc), h0, ys,
                            h_final, steps, batch, U, g);
}

bool valid(int U, int H, int W, int elem_bytes) {
  return U >= 16 && U % 16 == 0 && H >= 1 && W >= 1 && (elem_bytes == 2 || elem_bytes == 4);
}

}  // namespace

extern "C" {

// Shared memory one CTA needs; elem_bytes is 2 (bf16) or 4 (f32).
size_t convgru_fwd_smem_bytes(int H, int W, int U, int elem_bytes) {
  return layout(make_grid(H, W), U, cluster_size(U), (size_t)elem_bytes).total;
}

const char* convgru_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Clusters of this kernel that fit on the card at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
int convgru_fwd_max_clusters(int H, int W, int U, int elem_bytes) {
  if (!valid(U, H, W, elem_bytes)) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  const Grid g = make_grid(H, W);
  const cudaError_t err =
      elem_bytes == 2 ? configure<__nv_bfloat16>(cfg, attr, 1, U, g, nullptr, &clusters)
                      : configure<float>(cfg, attr, 1, U, g, nullptr, &clusters);
  return err == cudaSuccess ? clusters : -(int)err;
}

// Launches on `stream`; returns the launch's error code (0 = ok).
// elem_bytes selects the dtype of wx and the weights: 2 = bf16, 4 = f32.
int convgru_fwd(const void* wx, const void* wzr, const void* wc, const float* h0, float* ys,
                float* h_final, int steps, int batch, int H, int W, int U, int elem_bytes,
                void* stream) {
  if (steps < 1 || batch < 1 || !valid(U, H, W, elem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const Grid g = make_grid(H, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return (int)launch<__nv_bfloat16>(wx, wzr, wc, h0, ys, h_final, steps, batch, U, g, s);
  }
  return (int)launch<float>(wx, wzr, wc, h0, ys, h_final, steps, batch, U, g, s);
}

}  // extern "C"
