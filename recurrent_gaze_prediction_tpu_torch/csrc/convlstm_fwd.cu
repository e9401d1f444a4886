// Peephole ConvLSTM forward recurrence over precomputed input gates, for
// Hopper (sm_90a): kernel B3.
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
// Inputs: gx [T,B,H,W,4U] in bf16 (or f32 for the f32 mode); the weight Wh
// [3,3,U,4U] as per-CTA column slices packed by the wrapper
// (ops/kernels/convlstm.py): w [C][9U][4Ns], the i, f, c and o columns of the
// CTA's channels, in mma fragment order in bf16 and plain in f32; the
// peepholes W_ci, W_cf, W_co [H,W,U] f32; the carries c0, h0 [B,H,W,U] f32.
// Outputs: ys [T,B,H,W,U] f32 and the final state cT, hT [B,H,W,U] f32. The
// TPU kernel's wrapper drops the final c; this one returns it, so the
// streaming step can carry (c, h) from chunk to chunk through the kernel.
//
// Numerics rule (B1's, so the card compares like with like with the plain
// scan):
//   * c, h, the peepholes and all gate math are f32; gx is added after a
//     cast to f32;
//   * the state conv's operand h is rounded to gx's dtype;
//   * products accumulate in f32 (the conv result is not rounded), each
//     output's depth in one sum.
//
// Bound on an H100 SXM at T=42, U=128, bf16: the state conv is
// T*B*49*9*U*4U*2 = 19.4 GFLOP at B=8 (19.6 us at 989 TFLOP/s) and 38.8 GFLOP
// at B=16 (39.3 us); the bytes are gx 16.9 / 33.7 MB + ys 8.4 / 16.9 MB + Wh
// 1.2 MB + carries ~0.8 / 1.6 MB (~8 / ~16 us at 3.35 TB/s). So operations
// bound it. The recurrence is sequential in T, so what a step costs is
// latency: one block per element (the previous design) left 124 of 132 SMs
// idle at B=8, read the 1.18 MB of Wh from L2 every step and took ~155 us
// per step.
//
// Design (B1's, one conv and one elementwise phase per step; helpers in
// cluster_conv.cuh):
//   * One cluster of C CTAs per batch element (C = 8 at U = 128), launched
//     with cudaLaunchKernelEx; CTA k owns the channels [k*Ns, (k+1)*Ns) and
//     the 4 Ns output columns of their i, f, c and o gates.
//   * Its weight slice (147,456 B at U = 128 in bf16) is copied into shared
//     memory once per launch; in f32 it does not fit (295 KB) and the conv
//     reads it from global memory.
//   * Every CTA keeps two copies of the whole padded operand, hpad[0] and
//     hpad[1] (ping-pong), and its own slice of c in f32. Step t:
//       1. the conv of its 4 Ns columns on hpad[t % 2]: at U = 128 the 16
//          warps are 4 row tiles x 2 column groups, 8 of them with an item;
//       2. its gates and update: c' into its c slice, h' into ys[t] (and cT,
//          hT after the last step) and into every CTA's hpad[(t + 1) % 2]
//          (DSMEM);
//       3. one cluster barrier.
//     A CTA stores into a peer's hpad[(t + 1) % 2] only after the barrier of
//     step t - 1, which no CTA passes before it has finished its conv of
//     step t - 1, the last read of that buffer; step t + 1's conv reads it
//     only after the barrier of step t, which no CTA passes before every
//     store of the step is done. The barrier of the last step also keeps a
//     CTA from leaving while a peer may still store into its shared memory.
//     With one hpad a second barrier per step would have to separate every
//     CTA's conv from its peers' stores.
//   * In the elementwise phase every lane owns two channels of one position
//     (hw * Ns / 2 = 392 lanes at 7x7, U = 128); a quad of lanes gathers its
//     eight channels with shuffles and stores them, 16 bytes per CTA, into
//     all C copies.
//   * The peepholes are read from global memory; each thread reads the same
//     positions every step, so they stay in L1.
//   * The next step's gx slice (49 x 4Ns) is prefetched with cp.async into a
//     second buffer while the current step computes.
//   * Shared memory per CTA at H = W = 7, U = 128, C = 8 (stride K + 8):
//     bf16: weights 147,456 + two hpads 2 x 22,912 + acc (one plane of 64 x
//     72 f32) 18,432 + own c 3,200 + gx 2 x 6,272 = 227,456 B of the 232,448
//     a CTA may have. So the conv's depth is not split over warps: a second
//     k-group plane (18,432 B) does not fit in the 4,992 B left, nor do the
//     peepholes (9,472 B). f32 (weights from global memory): 138,112 B.
//   * Clusters do not depend on each other; at B = 16, 15 clusters of 8 fit
//     the card at once, so they run in two waves. The launch is refused when
//     not one cluster of this size fits.

#include "cluster_conv.cuh"

using namespace rgpc;

namespace {

constexpr int kGates = 4;        // i, f, c, o
constexpr int kLstmKGroups = 1;  // planes of acc: a second does not fit

// Byte offsets into one CTA's shared memory.
struct Layout {
  size_t w, hpad, acc, cs, gxb, total;  // hpad: both copies, one after the other
};

__host__ __device__ inline Layout layout(const Grid& g, int U, int C, size_t elem) {
  const size_t ns = U / C, hw = (size_t)g.H * g.W;
  const bool resident = elem == 2;  // the bf16 weight slice lives in shared memory
  Layout l;
  size_t o = 0;
  l.w = o;
  o += resident ? align128(9 * U * kGates * ns * elem) : 0;
  l.hpad = o;
  o += 2 * pad_bytes(g, U, elem);
  l.acc = o;
  o += align128(acc_plane(g, kGates * ns) * 4 * (resident ? kLstmKGroups : 1));
  l.cs = o;
  o += align128(hw * ns * 4);
  l.gxb = o;
  o += align128(2 * kGates * hw * ns * elem);
  l.total = o;
  return l;
}

// One channel's update from its gate pre-activations (gx + conv, before the
// peepholes), its peepholes and the old c -> (c', h').
__device__ __forceinline__ float2 lstm_update(float gi, float gf, float gc, float go, float pi,
                                              float pf, float po, float c) {
  const float nc = sigmoid(gf + pf * c) * c + sigmoid(gi + pi * c) * tanhf(gc);
  return make_float2(nc, tanhf(nc) * sigmoid(go + po * c));
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    convlstm_fwd_kernel(const T* __restrict__ gx, const T* __restrict__ w_all,
                        const float* __restrict__ w_ci, const float* __restrict__ w_cf,
                        const float* __restrict__ w_co, const float* __restrict__ c0,
                        const float* __restrict__ h0, float* __restrict__ ys,
                        float* __restrict__ c_final, float* __restrict__ h_final, int steps,
                        int batch, int U, Grid g) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int ns = U / C, n0 = rank * ns, N = kGates * ns;
  const int hw = g.H * g.W;
  const int S = pad_stride(U);
  const Layout l = layout(g, U, C, sizeof(T));
  T* hpad = reinterpret_cast<T*>(smem + l.hpad);  // hpad[0]; hpad[1] follows
  float* acc = reinterpret_cast<float*>(smem + l.acc);
  float* cs = reinterpret_cast<float*>(smem + l.cs);
  T* gxb = reinterpret_cast<T*>(smem + l.gxb);
  const size_t hpad_n = pad_bytes(g, U, sizeof(T)) / sizeof(T);
  const size_t w_n = (size_t)9 * U * N;
  const T* w = w_all + rank * w_n;
  if constexpr (sizeof(T) == 2) {
    copy_async(smem + l.w, w, w_n * sizeof(T));
    w = reinterpret_cast<const T*>(smem + l.w);
  }
  // gx[t]'s slice of this CTA: [4 gates][hw][ns]
  const size_t slice = (size_t)kGates * hw * ns;
  auto load_gx = [&](int t, T* dst) {
    const T* src = gx + ((size_t)t * batch + b) * hw * kGates * U + n0;
    for (int gate = 0; gate < kGates; ++gate) {
      copy_slice_async(dst + gate * hw * ns, src + gate * U, hw, kGates * U, ns);
    }
  };
  load_gx(0, gxb);
  cp_async_commit();

  // The borders and tail rows of both hpads stay zero for the whole
  // sequence; only interior rows are rewritten.
  zero_fill(hpad, 2 * hpad_n * sizeof(T));
  cluster.sync();  // every copy is zero before any CTA stores into it

  // In the elementwise phase lane i = p * (ns / 2) + n / 2 owns channels
  // n, n + 1 of position p; a quad of lanes (8 channels) stores them into
  // every CTA's hpad. The loops run whole warps (`quad_broadcast` shuffles),
  // and hw * ns / 2 is a multiple of 8, so a quad is active or idle as a
  // whole.
  const int pairs = ns / 2, items = hw * pairs;
  const int lane = threadIdx.x % 32;
  const size_t bhw = (size_t)b * hw;
  auto hpad_off = [&](int i) {  // element of item i's first channel, minus its quad offset
    return (size_t)pad_row(g, i / pairs) * S + n0 + (i % pairs) * 2 - 2 * (lane & 3);
  };
  for (int i0 = threadIdx.x - lane; i0 < items; i0 += blockDim.x) {
    const int i = i0 + lane, p = i / pairs, n = (i % pairs) * 2;
    const bool active = i < items;
    float2 v = make_float2(0.0f, 0.0f);
    if (active) {
      const size_t at = (bhw + p) * U + n0 + n;
      v = load2(h0 + at);
      *reinterpret_cast<float2*>(cs + p * ns + n) = load2(c0 + at);
    }
    quad_broadcast(hpad, hpad_off(i), v.x, v.y, active);
  }
  cp_async_wait<0>();
  cluster.sync();  // h0 in every hpad[0]; the weights and gx[0] have landed

  const size_t plane = acc_plane(g, N);
  for (int t = 0; t < steps; ++t) {
    const T* cur = gxb + (t & 1) * slice;
    if (t + 1 < steps) load_gx(t + 1, gxb + ((t + 1) & 1) * slice);
    cp_async_commit();

    // 1. the i|f|c|o conv of this CTA's columns on h_t
    conv_slice<kLstmKGroups>(hpad + (t & 1) * hpad_n, U, w, N, g, acc);
    cp_async_wait<1>();  // gx[t] has landed
    __syncthreads();     // acc is complete

    // 2. the gates and update: c' into cs, h' into ys[t] (and cT, hT after
    // the last step) and into every CTA's other hpad
    T* next = hpad + ((t + 1) & 1) * hpad_n;
    float* yt = ys + ((size_t)t * batch + b) * hw * U + n0;
    const bool last = t == steps - 1;
    for (int i0 = threadIdx.x - lane; i0 < items; i0 += blockDim.x) {
      const int i = i0 + lane, p = i / pairs, n = (i % pairs) * 2;
      const bool active = i < items;
      float2 hn = make_float2(0.0f, 0.0f);
      if (active) {
        const int k = p * ns + n;
        const size_t row = (size_t)out_row(g, p) * (N + 8) + n;
        const size_t at = (size_t)p * U + n0 + n;  // in the peepholes [H,W,U]
        const float2 c = *reinterpret_cast<const float2*>(cs + k);
        const float2 xi = load2(cur + k), xf = load2(cur + hw * ns + k);
        const float2 xc = load2(cur + 2 * hw * ns + k), xo = load2(cur + 3 * hw * ns + k);
        const float2 pi = ldg2(w_ci + at), pf = ldg2(w_cf + at), po = ldg2(w_co + at);
        auto gate = [&](int col) { return acc_sum<T, kLstmKGroups>(acc, plane, row + col); };
        const float2 u0 = lstm_update(xi.x + gate(0), xf.x + gate(ns), xc.x + gate(2 * ns),
                                      xo.x + gate(3 * ns), pi.x, pf.x, po.x, c.x);
        const float2 u1 = lstm_update(xi.y + gate(1), xf.y + gate(ns + 1), xc.y + gate(2 * ns + 1),
                                      xo.y + gate(3 * ns + 1), pi.y, pf.y, po.y, c.y);
        const float2 nc = make_float2(u0.x, u1.x);
        hn = make_float2(u0.y, u1.y);
        *reinterpret_cast<float2*>(cs + k) = nc;
        *reinterpret_cast<float2*>(yt + (size_t)p * U + n) = hn;
        if (last) {
          *reinterpret_cast<float2*>(c_final + (bhw + p) * U + n0 + n) = nc;
          *reinterpret_cast<float2*>(h_final + (bhw + p) * U + n0 + n) = hn;
        }
      }
      quad_broadcast(next, hpad_off(i), hn.x, hn.y, active);
    }
    cluster.sync();  // h_{t+1} in every CTA's next hpad
  }
}

template <typename T>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int batch, int U,
                      const Grid& g, cudaStream_t stream, int* clusters) {
  const int C = cluster_size(U);
  const size_t smem = layout(g, U, C, sizeof(T)).total;
  if (smem > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      convlstm_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  return cudaOccupancyMaxActiveClusters(clusters, convlstm_fwd_kernel<T>, &cfg);
}

template <typename T>
cudaError_t launch(const void* gx, const void* w, const float* w_ci, const float* w_cf,
                   const float* w_co, const float* c0, const float* h0, float* ys,
                   float* c_final, float* h_final, int steps, int batch, int U, const Grid& g,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  cudaError_t err = configure<T>(cfg, attr, batch, U, g, stream, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  return cudaLaunchKernelEx(&cfg, convlstm_fwd_kernel<T>, static_cast<const T*>(gx),
                            static_cast<const T*>(w), w_ci, w_cf, w_co, c0, h0, ys, c_final,
                            h_final, steps, batch, U, g);
}

bool valid(int U, int H, int W, int elem_bytes) {
  return U >= 16 && U % 16 == 0 && H >= 1 && W >= 1 && (elem_bytes == 2 || elem_bytes == 4);
}

}  // namespace

extern "C" {

// Shared memory one CTA needs; elem_bytes is 2 (bf16) or 4 (f32).
size_t convlstm_fwd_smem_bytes(int H, int W, int U, int elem_bytes) {
  return layout(make_grid(H, W), U, cluster_size(U), (size_t)elem_bytes).total;
}

const char* convlstm_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Clusters of this kernel that fit on the card at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
int convlstm_fwd_max_clusters(int H, int W, int U, int elem_bytes) {
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
// elem_bytes selects the dtype of gx and the weight slices: 2 = bf16, 4 = f32.
int convlstm_fwd(const void* gx, const void* w, const float* w_ci, const float* w_cf,
                 const float* w_co, const float* c0, const float* h0, float* ys,
                 float* c_final, float* h_final, int steps, int batch, int H, int W, int U,
                 int elem_bytes, void* stream) {
  if (steps < 1 || batch < 1 || !valid(U, H, W, elem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const Grid g = make_grid(H, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return (int)launch<__nv_bfloat16>(gx, w, w_ci, w_cf, w_co, c0, h0, ys, c_final, h_final,
                                      steps, batch, U, g, s);
  }
  return (int)launch<float>(gx, w, w_ci, w_cf, w_co, c0, h0, ys, c_final, h_final, steps,
                            batch, U, g, s);
}

}  // extern "C"
