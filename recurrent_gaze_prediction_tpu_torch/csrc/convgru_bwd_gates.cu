// ConvGRU backward, phase G: the gate recompute of kernel B4 for every
// frame at once, for Hopper (sm_90a).
//
// Kernel B4 (the monolithic backward, the TPU kernel `_convgru_bwd_kernel`
// of recurrent_gaze_prediction_tpu/ops/pallas/convgru_vjp.py, called through
// `_convgru_bwd_pallas`) recomputes the gates of each reverse step from
// h_{t-1}. That recompute reads only wx and h_{t-1} = [h0, ys[:-1]], not the
// cotangent, so it is not part of the serial recursion: this kernel runs it
// for all T*B frames in parallel, then B2 (convgru_bwd.cu) runs the
// recursion and phase W (convgru_wgrad.cu) the weight gradients
// (ops/kernels/convgru_vjp.py composes the three). Per frame (t, b):
//
//   h     = h0[b] if t == 0 else ys[t-1, b]                 -> hprev
//   u     = sigmoid(wx_z + conv3x3(h, U_z))                 -> u
//   r     = sigmoid(wx_r + conv3x3(h, U_r))                 -> r
//   rh    = r * h                                           -> rh
//   c     = tanh(wx_c + conv3x3(rh, U_c))                   -> c
//
// Inputs: wx [T,B,H,W,3U] in bf16 (or f32 for the f32 mode); h0 [B,H,W,U]
// and ys [T,B,H,W,U] f32; U_zr [3,3,U,2U] and U_c [3,3,U,U] in wx's dtype,
// in mma fragment order in bf16 (`pack_slices(w, 1, bf16)`, one slice of
// every column) and plain [9U][N] in f32.
// Outputs: u, r, c, hprev, rh [T,B,H,W,U] f32, dense, which is the layout
// B2's launcher reads without a copy.
//
// Numerics rule (the forward kernel B1's, so these are the gates it saw):
// all elementwise math is f32; in bf16 mode each conv operand (h, then
// r * h) is rounded to bf16 and the products are summed in f32; in f32
// mode everything is f32 (scalar FMAs). rh is written unrounded, as the
// plain version `recompute_gates` returns it.
//
// Bound on an H100 SXM at T=42, U=128, bf16: the convs are
// T*B*49*9*U*3U*2 = 14.6 / 29.1 GFLOP at B=8 / 16 (14.7 / 29.5 us at 989
// TFLOP/s) against ~52 / 104 MB moved (wx in, five f32 streams out: 16 / 31
// us at 3.35 TB/s). So operations bound it.
//
// Design: an implicit-GEMM conv per frame, M = H*(W+2) rows (64 at 7x7),
// K = 9U, N = 2U then U. A CTA takes F frames (F = 8 / (M/16) in bf16, 2 at
// 7x7) with both padded operands in shared memory (hpad, rhpad: 91.6 KB at
// U = 128 in bf16, so two CTAs share an SM). A warp's work item is 32
// output columns over 4 row tiles: each A fragment it loads (ldmatrix)
// feeds 4 mma.sync.m16n8k16 and each pair of weight fragments it reads
// from L2 (LDG.128 in fragment order) feeds 8. The epilogues run from the
// accumulators: no conv result goes through shared memory. The weights
// (885 KB in bf16) are read from L2 twice per CTA and conv, once per 4 row
// tiles. Each 16-deep k step waits on its weight loads: a cp.async ring of
// weight chunks in shared memory is the next lever.

#include "cluster_conv.cuh"

using namespace rgpc;

namespace {

constexpr int kGThreads = 256;
constexpr int kMaxTiles = 8;  // row tiles of 16 a CTA covers (bf16)
// a warp's work item: kStripTiles row tiles by kStripPairs column pairs
constexpr int kStripTiles = 4, kStripPairs = 2;

// frames per CTA: in bf16 enough for up to kMaxTiles row tiles; f32 keeps
// one frame (its operands are twice the size)
__host__ __device__ inline int frames_per_cta(const Grid& g, size_t elem) {
  const int tiles = g.Mpad / 16;
  return (elem == 2 && tiles < kMaxTiles) ? kMaxTiles / tiles : 1;
}

__host__ __device__ inline size_t smem_bytes(const Grid& g, int U, size_t elem) {
  return (size_t)frames_per_cta(g, elem) * 2 * pad_bytes(g, U, elem);
}

// bf16 conv of the CTA's `tiles` row tiles (tile j: frame j / mt_pf, rows
// 16 * (j % mt_pf) .. of its H x (W+2) output grid) by N columns, K input
// channels. A work item is NP column pairs (16 columns each) over up to MT
// consecutive row tiles: each A fragment feeds 2 NP mma, each weight
// fragment MT. `epi(f, m, n, v0, v1)` takes the sums of output row m of
// frame f at columns n, n + 1.
template <int MT, int NP, typename Epi>
__device__ inline void conv_bf16(const __nv_bfloat16* __restrict__ pad, size_t pad_elems, int K,
                                 const __nv_bfloat16* __restrict__ w, int N, const Grid& g,
                                 int mt_pf, int tiles, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int S = pad_stride(K), kt = K / 16, pairs = N / 16;
  const int groups = (pairs + NP - 1) / NP, chunks = (tiles + MT - 1) / MT;
  const uint4* wf = reinterpret_cast<const uint4*>(w);
  for (int item = warp; item < groups * chunks; item += blockDim.x / 32) {
    const int q0 = item % groups * NP, tile0 = item / groups * MT;
    const int nt = min(MT, tiles - tile0), np = min(NP, pairs - q0);
    float c[MT][2 * NP][4] = {};
    uint32_t a_off[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int tile = tile0 + min(j, nt - 1);
      a_off[j] = (uint32_t)((tile / mt_pf) * pad_elems +
                            (size_t)((tile % mt_pf) * 16 + lane % 16) * S + (lane / 16) * 8);
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * g.Wp + tap % 3) * S;
      const uint4* b_tap = wf + ((size_t)tap * kt * pairs + q0) * 32 + lane;
#pragma unroll 2
      for (int kk = 0; kk < kt; ++kk) {
        uint4 b[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          if (p < np) b[p] = __ldg(b_tap + ((size_t)kk * pairs + p) * 32);
        }
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          if (j < nt) {
            uint32_t a[4];
            ldmatrix_x4(a, pad + a_off[j] + toff + kk * 16);
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              if (p < np) {
                mma_bf16(c[j][2 * p], a, b[p].x, b[p].y);
                mma_bf16(c[j][2 * p + 1], a, b[p].z, b[p].w);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j < nt) {
        const int tile = tile0 + j;
        const int m = (tile % mt_pf) * 16 + lane / 4;
#pragma unroll
        for (int h = 0; h < 2 * NP; ++h) {
          if (h / 2 < np) {
            const int n = q0 * 16 + 8 * h + 2 * (lane % 4);
            epi(tile / mt_pf, m, n, c[j][h][0], c[j][h][1]);
            epi(tile / mt_pf, m + 8, n, c[j][h][2], c[j][h][3]);
          }
        }
      }
    }
  }
}

// f32: scalar FMAs, one thread per (frame, valid position, column pair);
// w is the plain [9K][N] weight in global memory.
template <typename Epi>
__device__ inline void conv_f32(const float* __restrict__ pad, size_t pad_elems, int K,
                                const float* __restrict__ w, int N, const Grid& g, int nf,
                                Epi epi) {
  const int S = pad_stride(K), hw = g.H * g.W, half = N / 2;
  for (int i = threadIdx.x; i < nf * hw * half; i += blockDim.x) {
    const int n = (i % half) * 2, f = i / half / hw, p = i / half % hw;
    const int m = out_row(g, p);
    float s0 = 0.0f, s1 = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* a = pad + f * pad_elems + (size_t)(m + (tap / 3) * g.Wp + tap % 3) * S;
      const float* wt = w + (size_t)tap * K * N + n;
      for (int k = 0; k < K; ++k) {
        const float2 wv = __ldg(reinterpret_cast<const float2*>(wt + (size_t)k * N));
        s0 = fmaf(a[k], wv.x, s0);
        s1 = fmaf(a[k], wv.y, s1);
      }
    }
    epi(f, m, n, s0, s1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kGThreads, 2)
    gates_kernel(const T* __restrict__ wx, const float* __restrict__ h0,
                 const float* __restrict__ ys, const T* __restrict__ wzr,
                 const T* __restrict__ wc, float* __restrict__ u_s, float* __restrict__ r_s,
                 float* __restrict__ c_s, float* __restrict__ hprev_s,
                 float* __restrict__ rh_s, int frames, int batch, int U, Grid g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int F = frames_per_cta(g, sizeof(T));
  const int f0 = blockIdx.x * F;
  const int nf = min(F, frames - f0);
  const int hw = g.H * g.W, S = pad_stride(U);
  const size_t pad_elems = pad_bytes(g, U, sizeof(T)) / sizeof(T);
  T* hpad = reinterpret_cast<T*>(smem);  // F padded frames, then F of rhpad
  T* rhpad = hpad + F * pad_elems;
  // h_{t-1} of frame fg = t * batch + b: h0[b] for t = 0, else ys[t-1, b]
  auto h_of = [&](int fg) {
    return fg < batch ? h0 + (size_t)fg * hw * U : ys + (size_t)(fg - batch) * hw * U;
  };

  // borders and tail rows stay zero
  zero_fill(smem, smem_bytes(g, U, sizeof(T)));
  __syncthreads();
  const int q4 = U / 4;
  for (int i = threadIdx.x; i < nf * hw * q4; i += blockDim.x) {
    const int f = i / (hw * q4), p = i / q4 % hw, n = i % q4 * 4;
    const int fg = f0 + f;
    const float4 v = *reinterpret_cast<const float4*>(h_of(fg) + (size_t)p * U + n);
    *reinterpret_cast<float4*>(hprev_s + ((size_t)fg * hw + p) * U + n) = v;
    store4(hpad + f * pad_elems + (size_t)pad_row(g, p) * S + n, v);
  }
  __syncthreads();

  // z|r conv, then u, r and r*h (f32 out, rounded into rhpad)
  auto gates = [&](int f, int m, int n, float v0, float v1) {
    if (m >= g.H * g.Wp || m % g.Wp >= g.W) return;
    const int p = m / g.Wp * g.W + m % g.Wp;
    const int fg = f0 + f;
    const size_t pos = (size_t)fg * hw + p;
    const T* wxp = wx + pos * 3 * U;
    if (n < U) {
      const float2 wz = load2(wxp + n);
      store2(u_s + pos * U + n, sigmoid(wz.x + v0), sigmoid(wz.y + v1));
    } else {
      const int nr = n - U;
      const float2 wr = load2(wxp + U + nr);
      const float2 h = load2(h_of(fg) + (size_t)p * U + nr);
      const float r0 = sigmoid(wr.x + v0), r1 = sigmoid(wr.y + v1);
      store2(r_s + pos * U + nr, r0, r1);
      store2(rh_s + pos * U + nr, r0 * h.x, r1 * h.y);
      store2(rhpad + f * pad_elems + (size_t)pad_row(g, p) * S + nr, r0 * h.x, r1 * h.y);
    }
  };
  // candidate conv, then c
  auto cand = [&](int f, int m, int n, float v0, float v1) {
    if (m >= g.H * g.Wp || m % g.Wp >= g.W) return;
    const size_t pos = (size_t)(f0 + f) * hw + m / g.Wp * g.W + m % g.Wp;
    const float2 wcv = load2(wx + pos * 3 * U + 2 * U + n);
    store2(c_s + pos * U + n, tanhf(wcv.x + v0), tanhf(wcv.y + v1));
  };
  if constexpr (sizeof(T) == 2) {
    const int mt_pf = g.Mpad / 16;
    conv_bf16<kStripTiles, kStripPairs>(hpad, pad_elems, U, wzr, 2 * U, g, mt_pf, nf * mt_pf,
                                        gates);
    __syncthreads();
    conv_bf16<kStripTiles, kStripPairs>(rhpad, pad_elems, U, wc, U, g, mt_pf, nf * mt_pf,
                                        cand);
  } else {
    conv_f32(hpad, pad_elems, U, wzr, 2 * U, g, nf, gates);
    __syncthreads();
    conv_f32(rhpad, pad_elems, U, wc, U, g, nf, cand);
  }
}

template <typename T>
cudaError_t launch(const void* wx, const float* h0, const float* ys, const void* wzr,
                   const void* wc, float* u, float* r, float* c, float* hprev, float* rh,
                   int frames, int batch, int U, const Grid& g, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, U, sizeof(T));
  if (smem > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gates_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int F = frames_per_cta(g, sizeof(T));
  gates_kernel<T><<<(frames + F - 1) / F, kGThreads, smem, stream>>>(
      static_cast<const T*>(wx), h0, ys, static_cast<const T*>(wzr),
      static_cast<const T*>(wc), u, r, c, hprev, rh, frames, batch, U, g);
  return cudaGetLastError();
}

bool valid(int U, int H, int W, int elem_bytes) {
  return U >= 16 && U % 16 == 0 && H >= 1 && W >= 1 && (elem_bytes == 2 || elem_bytes == 4);
}

}  // namespace

extern "C" {

// Shared memory one CTA needs; elem_bytes is 2 (bf16) or 4 (f32).
size_t convgru_bwd_gates_smem_bytes(int H, int W, int U, int elem_bytes) {
  return smem_bytes(make_grid(H, W), U, (size_t)elem_bytes);
}

// Launches on `stream`; returns the launch's error code (0 = ok).
// elem_bytes selects the dtype of wx and the weights: 2 = bf16, 4 = f32.
int convgru_bwd_gates(const void* wx, const float* h0, const float* ys, const void* wzr,
                      const void* wc, float* u, float* r, float* c, float* hprev, float* rh,
                      int steps, int batch, int H, int W, int U, int elem_bytes,
                      void* stream) {
  if (steps < 1 || batch < 1 || !valid(U, H, W, elem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const Grid g = make_grid(H, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int frames = steps * batch;
  if (elem_bytes == 2) {
    return (int)launch<__nv_bfloat16>(wx, h0, ys, wzr, wc, u, r, c, hprev, rh, frames, batch,
                                      U, g, s);
  }
  return (int)launch<float>(wx, h0, ys, wzr, wc, u, r, c, hprev, rh, frames, batch, U, g, s);
}

}  // extern "C"
