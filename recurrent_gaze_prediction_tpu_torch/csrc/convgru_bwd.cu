// ConvGRU backward: the reverse-time recursion of the state cotangent, for
// Hopper (sm_90a): kernel B2.
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
// U_c^T [3,3,U,U] and U_zr^T [3,3,2U,U] (flipped spatially, in/out swapped)
// as per-CTA column slices packed by the wrapper: uct [C][9U][Ns] and uzrt
// [C][18U][Ns], in mma fragment order in bf16 and plain in f32.
// Outputs: dzr [T,B,H,W,2U], da [T,B,H,W,U], dh0 [B,H,W,U], all f32.
//
// Numerics rule (the forward kernel's): all elementwise math and dh are f32;
// each conv operand (da, then dzr) is rounded to the weights' dtype; products
// accumulate in f32, each conv's depth in four parts that are then added
// (bf16 mode).
//
// Bound on an H100 SXM at T=42, U=128, bf16: the two transposed convs are
// T*B*49*9*U*3U*2 = 14.6 / 29.1 GFLOP at B=8 / 16 (15 / 29 us); the bytes
// are eight f32 [T,B,H,W,U] streams plus the bf16 weights, 68 / 136 MB
// (20 / 41 us at 3.35 TB/s). So bytes bound it. As in B1, what a step costs
// is latency, which the one-block-per-element design could not cut.
//
// Design: B1's (cluster_conv.cuh), run backwards. One cluster of C CTAs
// per batch element; CTA k owns the channels [k*Ns, (k+1)*Ns) of dh, da,
// du_pre and dr_pre and the matching output columns of both transposed
// convs, with both weight slices (110.6 KB at U = 128 in bf16) resident in
// shared memory. Every CTA keeps the whole padded operands dapad (U
// channels) and zpad (2U). Each step:
//   1. its dh', du_pre, da (da and du_pre to global memory); da into every
//      CTA's dapad;
//   2. cluster barrier A;
//   3. conv_T on dapad, then its drh, dr_pre, dh' * u + drh * r; du_pre and
//      dr_pre into every CTA's zpad. du_pre goes here and not in 1: a peer
//      may still read zpad from the step before until it passes A;
//   4. cluster barrier B;
//   5. the inputs of the next step are prefetched (cp.async) while the
//      conv_T on zpad runs; then dh += its result.
// The elementwise phases run two channels per lane and store into the
// peers by quads of lanes, as in B1.
// A CTA writes into a peer's buffer only after a barrier that every reader
// of that buffer passed after its conv: dapad is read between A and B and
// written before A, zpad read after B and written between A and B. Barrier
// B of step 0 keeps a CTA from leaving while a peer may store into it.
// Shared memory per CTA at H = W = 7, U = 128, C = 8 (stride K + 8): bf16:
// weights 110,592 + dapad 22,912 + zpad 44,416 + acc (4 planes of 64 x 24
// f32) 24,576 + own dh 3,200 + the five input slices 15,744 = 221,440 B;
// f32 (weights from global memory): 159,488 B. The input slices are
// single-buffered: a second buffer would pass the 232,448 B limit.

#include "cluster_conv.cuh"

using namespace rgpc;

namespace {

constexpr int kStreams = 5;  // u, r, c, h_prev, g
enum { kU, kR, kC, kH, kG };

// Byte offsets into one CTA's shared memory.
struct Layout {
  size_t wct, wzrt, dapad, zpad, acc, dh, in, total;
};

__host__ __device__ inline Layout layout(const Grid& g, int U, int C, size_t elem) {
  const size_t ns = U / C, hw = (size_t)g.H * g.W;
  const bool resident = elem == 2;  // bf16 weight slices live in shared memory
  Layout l;
  size_t o = 0;
  l.wct = o;
  o += resident ? align128(9 * U * ns * elem) : 0;
  l.wzrt = o;
  o += resident ? align128(9 * 2 * U * ns * elem) : 0;
  l.dapad = o;
  o += pad_bytes(g, U, elem);
  l.zpad = o;
  o += pad_bytes(g, 2 * U, elem);
  l.acc = o;
  o += align128(acc_plane(g, ns) * 4 * (resident ? kKGroups : 1));
  l.dh = o;
  o += align128(hw * ns * 4);
  l.in = o;
  o += align128(kStreams * hw * ns * 4);
  l.total = o;
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    convgru_bwd_kernel(const float* __restrict__ u_s, const float* __restrict__ r_s,
                       const float* __restrict__ c_s, const float* __restrict__ hprev_s,
                       const float* __restrict__ g_s, const T* __restrict__ uzrt_all,
                       const T* __restrict__ uct_all, float* __restrict__ dzr_s,
                       float* __restrict__ da_s, float* __restrict__ dh0, int steps,
                       int batch, int U, Grid g) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int ns = U / C, n0 = rank * ns;
  const int hw = g.H * g.W;
  const int S = pad_stride(U), S2 = pad_stride(2 * U);
  const Layout l = layout(g, U, C, sizeof(T));
  T* dapad = reinterpret_cast<T*>(smem + l.dapad);
  T* zpad = reinterpret_cast<T*>(smem + l.zpad);
  float* acc = reinterpret_cast<float*>(smem + l.acc);
  float* dh = reinterpret_cast<float*>(smem + l.dh);
  float* in = reinterpret_cast<float*>(smem + l.in);  // [kStreams][hw][ns]
  const size_t wct_n = (size_t)9 * U * ns, wzrt_n = (size_t)9 * 2 * U * ns;
  const T* wct = uct_all + rank * wct_n;
  const T* wzrt = uzrt_all + rank * wzrt_n;
  if constexpr (sizeof(T) == 2) {
    copy_async(smem + l.wct, wct, wct_n * sizeof(T));
    copy_async(smem + l.wzrt, wzrt, wzrt_n * sizeof(T));
    wct = reinterpret_cast<const T*>(smem + l.wct);
    wzrt = reinterpret_cast<const T*>(smem + l.wzrt);
  }
  const float* streams[kStreams] = {u_s, r_s, c_s, hprev_s, g_s};
  auto load_inputs = [&](int t) {
    const size_t base = ((size_t)t * batch + b) * hw * U + n0;
    for (int s = 0; s < kStreams; ++s) {
      copy_slice_async(in + (size_t)s * hw * ns, streams[s] + base, hw, U, ns);
    }
  };
  load_inputs(steps - 1);
  cp_async_commit();

  // The borders and tail rows of both padded operands stay zero for the
  // whole sequence; only interior rows are rewritten.
  zero_fill(dapad, pad_bytes(g, U, sizeof(T)));
  zero_fill(zpad, pad_bytes(g, 2 * U, sizeof(T)));
  for (int i = threadIdx.x; i < hw * ns; i += blockDim.x) dh[i] = 0.0f;
  cp_async_wait<0>();
  cluster.sync();  // every copy is zero before any CTA stores into it

  // In the elementwise phases lane i = p * (ns / 2) + n / 2 owns channels
  // n, n + 1 of position p; a quad of lanes (8 channels) stores them into
  // every CTA's copy of the next operand. The loops run whole warps
  // (`quad_broadcast` shuffles), and hw * ns / 2 is a multiple of 8, so a
  // quad is active or idle as a whole.
  const int pairs = ns / 2, items = hw * pairs;
  const int lane = threadIdx.x % 32;
  const size_t plane = acc_plane(g, ns);
  const float* u = in + (size_t)kU * hw * ns;
  const float* r = in + (size_t)kR * hw * ns;
  const float* c = in + (size_t)kC * hw * ns;
  const float* hprev = in + (size_t)kH * hw * ns;
  float* gd = in + (size_t)kG * hw * ns;  // g, then du_pre once g is used
  for (int t = steps - 1; t >= 0; --t) {
    const size_t pos0 = ((size_t)t * batch + b) * hw;  // row of position 0

    // 1. gate cotangents; da into every dapad
    for (int i0 = threadIdx.x - lane; i0 < items; i0 += blockDim.x) {
      const int i = i0 + lane, p = i / pairs, n = (i % pairs) * 2;
      const bool active = i < items;
      float da[2] = {0.0f, 0.0f}, dup[2];
      if (active) {
        for (int e = 0; e < 2; ++e) {
          const int k = p * ns + n + e;
          const float dhn = gd[k] + dh[k];
          dup[e] = dhn * (hprev[k] - c[k]) * u[k] * (1.0f - u[k]);
          da[e] = dhn * (1.0f - u[k]) * (1.0f - c[k] * c[k]);
          dh[k] = dhn;
          gd[k] = dup[e];
        }
        *reinterpret_cast<float2*>(da_s + (pos0 + p) * U + n0 + n) = make_float2(da[0], da[1]);
        *reinterpret_cast<float2*>(dzr_s + (pos0 + p) * 2 * U + n0 + n) =
            make_float2(dup[0], dup[1]);
      }
      quad_broadcast(dapad, (size_t)pad_row(g, p) * S + n0 + n - 2 * (lane & 3), da[0], da[1],
                     active);
    }
    cluster.sync();  // A

    // 3. drh = conv_T(da, U_c); dr_pre; du_pre and dr_pre into every zpad
    conv_slice(dapad, U, wct, ns, g, acc);
    __syncthreads();
    for (int i0 = threadIdx.x - lane; i0 < items; i0 += blockDim.x) {
      const int i = i0 + lane, p = i / pairs, n = (i % pairs) * 2;
      const bool active = i < items;
      float drp[2] = {0.0f, 0.0f}, dup[2] = {0.0f, 0.0f};
      if (active) {
        const size_t row = (size_t)out_row(g, p) * (ns + 8);
        for (int e = 0; e < 2; ++e) {
          const int k = p * ns + n + e;
          const float drh = acc_sum<T>(acc, plane, row + n + e);
          drp[e] = drh * hprev[k] * r[k] * (1.0f - r[k]);
          dh[k] = dh[k] * u[k] + drh * r[k];
          dup[e] = gd[k];
        }
        *reinterpret_cast<float2*>(dzr_s + (pos0 + p) * 2 * U + U + n0 + n) =
            make_float2(drp[0], drp[1]);
      }
      const size_t zoff = (size_t)pad_row(g, p) * S2 + n0 + n - 2 * (lane & 3);
      quad_broadcast(zpad, zoff, dup[0], dup[1], active);
      quad_broadcast(zpad, zoff + U, drp[0], drp[1], active);
    }
    cluster.sync();  // B

    // 5. prefetch step t-1's inputs; dh += conv_T(dzr, U_zr)
    if (t > 0) load_inputs(t - 1);
    cp_async_commit();
    conv_slice(zpad, 2 * U, wzrt, ns, g, acc);
    cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int p = i / pairs, n = (i % pairs) * 2;
      const size_t row = (size_t)out_row(g, p) * (ns + 8);
      dh[p * ns + n] += acc_sum<T>(acc, plane, row + n);
      dh[p * ns + n + 1] += acc_sum<T>(acc, plane, row + n + 1);
    }
  }
  __syncthreads();  // the last update of dh, by another thread mapping
  for (int i = threadIdx.x; i < hw * ns; i += blockDim.x) {
    dh0[((size_t)b * hw + i / ns) * U + n0 + i % ns] = dh[i];
  }
}

template <typename T>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int batch, int U,
                      const Grid& g, cudaStream_t stream, int* clusters) {
  const int C = cluster_size(U);
  const size_t smem = layout(g, U, C, sizeof(T)).total;
  if (smem > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      convgru_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  return cudaOccupancyMaxActiveClusters(clusters, convgru_bwd_kernel<T>, &cfg);
}

template <typename T>
cudaError_t launch(const float* u, const float* r, const float* c, const float* hprev,
                   const float* gr, const void* uzrt, const void* uct, float* dzr, float* da,
                   float* dh0, int steps, int batch, int U, const Grid& g,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  cudaError_t err = configure<T>(cfg, attr, batch, U, g, stream, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  return cudaLaunchKernelEx(&cfg, convgru_bwd_kernel<T>, u, r, c, hprev, gr,
                            static_cast<const T*>(uzrt), static_cast<const T*>(uct), dzr, da,
                            dh0, steps, batch, U, g);
}

bool valid(int U, int H, int W, int elem_bytes) {
  return U >= 16 && U % 16 == 0 && H >= 1 && W >= 1 && (elem_bytes == 2 || elem_bytes == 4);
}

}  // namespace

extern "C" {

// Shared memory one CTA needs; elem_bytes is 2 (bf16) or 4 (f32).
size_t convgru_bwd_smem_bytes(int H, int W, int U, int elem_bytes) {
  return layout(make_grid(H, W), U, cluster_size(U), (size_t)elem_bytes).total;
}

// Clusters of this kernel that fit on the card at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
int convgru_bwd_max_clusters(int H, int W, int U, int elem_bytes) {
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
// elem_bytes selects the dtype of the weights: 2 = bf16, 4 = f32.
int convgru_bwd(const float* u, const float* r, const float* c, const float* hprev,
                const float* g, const void* uzrt, const void* uct, float* dzr, float* da,
                float* dh0, int steps, int batch, int H, int W, int U, int elem_bytes,
                void* stream) {
  if (steps < 1 || batch < 1 || !valid(U, H, W, elem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const Grid grid = make_grid(H, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return (int)launch<__nv_bfloat16>(u, r, c, hprev, g, uzrt, uct, dzr, da, dh0, steps, batch,
                                      U, grid, s);
  }
  return (int)launch<float>(u, r, c, hprev, g, uzrt, uct, dzr, da, dh0, steps, batch, U, grid,
                            s);
}

}  // extern "C"
