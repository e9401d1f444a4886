// A small-channel ConvGRU over its whole sequence, forward and backward, for
// Hopper (sm_90a): kernel B5.
//
// Replaces no Pallas kernel: the JAX package scans this cell with
// `lax.scan` (the cascade's top cell, `models/gaze_grcn_cascade.py`: 64
// input channels -> U=3 units, 5x5 state convs on the 49x49 grid). On the
// card its plain per-step loop dispatched ~126 small ops a step, forward,
// recompute and backward, and paced the train step from the host; here each
// direction is one launch.
//
// Per step t, for each batch element (the input-side conv wx is hoisted out
// and computed by the caller over all T*B frames):
//
//   uh  = conv(h, [U_z | U_r])               (SAME, KxK, no bias)
//   u   = sigmoid(wx_z + uh_z),  r = sigmoid(wx_r + uh_r)
//   c   = tanh(wx_c + conv(r * h, U_c))
//   h'  = u * h + (1 - u) * c                -> ys[t]
//
// and its reverse-time gradient, with dh carried from step to step:
//
//   dh_new = g[t] + dh
//   du_pre = dh_new (h - c) u (1 - u),  da = dh_new (1 - u) (1 - c^2)
//   drh    = conv_T(da, U_c),            dr_pre = drh h r (1 - r)
//   dh     = dh_new u + drh r + conv_T([du_pre | dr_pre], U_zr)
//   dwx[t] = [du_pre | dr_pre | da]
//   dU_zr += patches(h)^T [du_pre | dr_pre],  dU_c += patches(r h)^T da
//
// Inputs: wx [T,B,H,W,3U] bf16; ys [T,B,H,W,U] f32 (the backward's stored
// states); h0 [B,H,W,U] f32; g [T,B,H,W,U] f32; the weights U_zr [K,K,U,2U]
// and U_c [K,K,U,U] as f32 values already rounded to bf16 by the wrapper
// (ops/kernels/convgru_small.py). Outputs: ys; dwx [T,B,H,W,3U] bf16, dh0
// [B,H,W,U] f32, dU_zr and dU_c in f32.
//
// Numerics rule (ops/kernels/convgru_vjp.py's): the state and all gate math
// are f32; every conv operand (h, r*h, the weights, and the pre-activation
// gradients fed to the transposed convs and the weight products) is rounded
// to bf16; products are summed in f32 and the sums are not rounded. The
// backward recomputes u, r and c from ys[t-1] (or h0) and wx[t] with the
// forward's own conv routine, so it sees the forward's gates bit for bit.
//
// Bound on an H100 SXM at B=28, T=42, K=5, U=3 (989 TFLOP/s bf16, 3.35
// TB/s): the forward's contractions are 2*T*B*H*W*K*K*U*3U = 3.81 GFLOP
// (3.9 us), its bytes wx 50.8 MB + ys 33.9 MB (25 us): bytes bound it. The
// backward does three times the contractions (recompute, the two transposed
// convs, the weight products) and moves wx, ys, g, dwx (~170 MB, 51 us).
//
// Design: one CTA of 512 threads per batch element walks all T steps; there
// is no traffic between CTAs (28 CTAs at B=28, so the kernel is bound by a
// step's latency across T, not by the card's rates). The state lives in
// shared memory: f32 per pixel, and a bf16 copy padded by the halo K/2 for
// the convs (4 channel slots a pixel, 8 bytes). The weights sit in shared
// memory for the whole launch, rows padded to 16 bytes for vector loads.
// Threads own pixels, five at a time, so a weight row read from shared
// memory serves five; __syncthreads separates the phases of a step
// (forward 2, backward 5). The convs run on the CUDA cores (K*K*U*3U = 675
// products a pixel at U=3): the tensor cores' tiles would be mostly padding.
// The weight gradients: thread (tap, chunk of pixels) sums a step's
// products in registers and adds them to its running sums, kept in global
// memory (L2) so that no accumulator stays live across the step's convs;
// after the loop the CTA sums its chunks in a fixed order into a
// per-element partial, and a second launch sums the B partials in a fixed
// order. No atomics: the result is the same bits every run.
//
// The kernels are templates of K and U (U <= 4 fits the weight rows and
// the pixel slots), but only the shape a model runs is built and taken:
// K = 5, U = 3, on grids of at most 512 * 5 pixels, so each thread owns at
// most one group of five pixels in every phase.
//
// Shared memory at H = W = 49, K = 5, U = 3: forward 106,624 B, backward
// 203,136 B (the limit is 232,448).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPix = 5;
constexpr size_t kSmemLimit = 232448;

// The grid, and the grid padded by the halo K/2 on each side.
struct Geo {
  int W, K, Wp, HW, Np;
};

__host__ __device__ inline Geo make_geo(int H, int W, int K) {
  Geo g;
  g.W = W;
  g.K = K;
  g.Wp = W + K - 1;
  g.HW = H * W;
  g.Np = (H + K - 1) * g.Wp;
  return g;
}

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Weight rows: U_zr as [K*K*U][8] floats (2U <= 8 columns), U_c as
// [K*K*U][4] (U <= 4), the unused columns zero.
__host__ __device__ inline size_t weight_bytes(int K, int U) {
  return align128(sizeof(float) * K * K * U * 12);
}

// The weight gradients' work split: thread = chunk * K*K + tap.
__host__ __device__ inline int wgrad_chunks(int K) { return kThreads / (K * K); }

// Byte offsets into one CTA's shared memory.
struct FwdLayout {
  size_t w, hpad, rhpad, h, u, total;
};

struct BwdLayout {
  size_t w, hpad, rhpad, dapad, dzrpad, u, r, dh, total;
};

__host__ __device__ inline FwdLayout fwd_layout(const Geo& g, int U) {
  FwdLayout l;
  size_t o = 0;
  l.w = o;
  o += weight_bytes(g.K, U);
  l.hpad = o;
  o += align128(8 * (size_t)g.Np);
  l.rhpad = o;
  o += align128(8 * (size_t)g.Np);
  l.h = o;
  o += align128(4 * (size_t)g.HW * U);
  l.u = o;
  o += align128(4 * (size_t)g.HW * U);
  l.total = o;
  return l;
}

__host__ __device__ inline BwdLayout bwd_layout(const Geo& g, int U) {
  BwdLayout l;
  size_t o = 0;
  l.w = o;
  o += weight_bytes(g.K, U);
  l.hpad = o;
  o += align128(8 * (size_t)g.Np);
  l.rhpad = o;
  o += align128(8 * (size_t)g.Np);
  l.dapad = o;
  o += align128(8 * (size_t)g.Np);
  l.dzrpad = o;
  o += align128(16 * (size_t)g.Np);
  l.u = o;
  o += align128(4 * (size_t)g.HW * U);
  l.r = o;
  o += align128(4 * (size_t)g.HW * U);
  l.dh = o;
  o += align128(4 * (size_t)g.HW * U);
  l.total = o;
  return l;
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// U <= 4 values rounded to bf16 into one padded pixel's 4 slots.
template <int U>
__device__ __forceinline__ uint2 pack_pixel(const float* v) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < U; ++i) s[i] = v[i];
  return make_uint2(pack2(s[0], s[1]), pack2(s[2], s[3]));
}

__device__ __forceinline__ void unpack4(uint2 w, float* f) {
  f[0] = bf_lo(w.x);
  f[1] = bf_hi(w.x);
  f[2] = bf_lo(w.y);
  f[3] = bf_hi(w.y);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// The pixels a thread takes at once: p0, p0 + 512, ..., p0 + 4*512 (at
// 49x49 one such group per thread, so each weight row read from shared
// memory serves five pixels). A pixel past the grid is dead: it reads
// pixel 0's window and its results are dropped.
struct Pixels {
  int p[kPix], base[kPix];
  bool live[kPix];
};

__device__ __forceinline__ Pixels pixels_from(int p0, const Geo& g) {
  Pixels px;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = p0 + j * kThreads;
    px.live[j] = p < g.HW;
    px.p[j] = px.live[j] ? p : 0;
    const int y = px.p[j] / g.W, x = px.p[j] - y * g.W;
    px.base[j] = y * g.Wp + x;  // the padded index of the window's corner
  }
  return px;
}

// S floats of one weight row (S = 4 or 8), by 16-byte loads.
template <int S>
__device__ __forceinline__ void weight_row(const float* w, float* wr) {
#pragma unroll
  for (int q = 0; q < S / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(w)[q];
    wr[4 * q] = v.x;
    wr[4 * q + 1] = v.y;
    wr[4 * q + 2] = v.z;
    wr[4 * q + 3] = v.w;
  }
}

// out[j][o] = sum over taps (dy, dx) and i < U of pad[base_j + dy*Wp +
// dx][i] * w[tap][i][o], o < NOUT; `w` holds rows of S floats. Each
// pixel's sum runs in the same order, so the backward's recompute gets
// the forward's bits.
template <int K, int U, int NOUT, int S>
__device__ __forceinline__ void conv_px(const uint2* pad, const Pixels& px, int Wp,
                                        const float* w, float (*out)[NOUT]) {
#pragma unroll
  for (int j = 0; j < kPix; ++j)
#pragma unroll
    for (int o = 0; o < NOUT; ++o) out[j][o] = 0.f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      float x[kPix][4];
#pragma unroll
      for (int j = 0; j < kPix; ++j) unpack4(pad[px.base[j] + dy * Wp + dx], x[j]);
#pragma unroll
      for (int i = 0; i < U; ++i) {
        float wr[S];
        weight_row<S>(w + ((dy * K + dx) * U + i) * S, wr);
#pragma unroll
        for (int j = 0; j < kPix; ++j)
#pragma unroll
          for (int o = 0; o < NOUT; ++o) out[j][o] = fmaf(x[j][i], wr[o], out[j][o]);
      }
    }
  }
}

// The transposed conv of a U-channel gradient held in `pad` through U_c
// (rows of 4): out[j][i] = sum over taps and c of pad[base_j + (K-1-dy)*Wp
// + (K-1-dx)][c] * w[dy][dx][i][c].
template <int K, int U>
__device__ __forceinline__ void conv_t_c(const uint2* pad, const Pixels& px, int Wp,
                                         const float* w, float (*out)[U]) {
#pragma unroll
  for (int j = 0; j < kPix; ++j)
#pragma unroll
    for (int i = 0; i < U; ++i) out[j][i] = 0.f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      float gv[kPix][4];
#pragma unroll
      for (int j = 0; j < kPix; ++j)
        unpack4(pad[px.base[j] + (K - 1 - dy) * Wp + (K - 1 - dx)], gv[j]);
#pragma unroll
      for (int i = 0; i < U; ++i) {
        float wr[4];
        weight_row<4>(w + ((dy * K + dx) * U + i) * 4, wr);
#pragma unroll
        for (int j = 0; j < kPix; ++j)
#pragma unroll
          for (int c = 0; c < U; ++c) out[j][i] = fmaf(gv[j][c], wr[c], out[j][i]);
      }
    }
  }
}

// The transposed conv of [du_pre | dr_pre] (slots 0..3 and 4..7 of `pad`)
// through U_zr (rows of 8: z columns 0..U-1, r columns U..2U-1).
template <int K, int U>
__device__ __forceinline__ void conv_t_zr(const uint4* pad, const Pixels& px, int Wp,
                                          const float* w, float (*out)[U]) {
#pragma unroll
  for (int j = 0; j < kPix; ++j)
#pragma unroll
    for (int i = 0; i < U; ++i) out[j][i] = 0.f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      float z[kPix][4], r[kPix][4];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const uint4 v = pad[px.base[j] + (K - 1 - dy) * Wp + (K - 1 - dx)];
        unpack4(make_uint2(v.x, v.y), z[j]);
        unpack4(make_uint2(v.z, v.w), r[j]);
      }
#pragma unroll
      for (int i = 0; i < U; ++i) {
        float wr[8];
        weight_row<8>(w + ((dy * K + dx) * U + i) * 8, wr);
#pragma unroll
        for (int j = 0; j < kPix; ++j)
#pragma unroll
          for (int c = 0; c < U; ++c) {
            out[j][i] = fmaf(z[j][c], wr[c], out[j][i]);
            out[j][i] = fmaf(r[j][c], wr[U + c], out[j][i]);
          }
      }
    }
  }
}

// Copy U_zr [K*K*U][2U] and U_c [K*K*U][U] into their padded rows.
template <int K, int U>
__device__ __forceinline__ void load_weights(const float* __restrict__ wzr,
                                             const float* __restrict__ wc, float* wzr_s,
                                             float* wc_s) {
  for (int e = threadIdx.x; e < K * K * U * 8; e += kThreads) {
    const int row = e / 8, j = e % 8;
    wzr_s[e] = j < 2 * U ? wzr[row * 2 * U + j] : 0.f;
  }
  for (int e = threadIdx.x; e < K * K * U * 4; e += kThreads) {
    const int row = e / 4, j = e % 4;
    wc_s[e] = j < U ? wc[row * U + j] : 0.f;
  }
}

template <int K, int U>
__global__ void __launch_bounds__(kThreads, 1)
    convgru_small_fwd_kernel(const __nv_bfloat16* __restrict__ wx, const float* __restrict__ wzr,
                             const float* __restrict__ wc, const float* __restrict__ h0,
                             float* __restrict__ ys, int T, int B, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geo g = make_geo(H, W, K);
  const FwdLayout l = fwd_layout(g, U);
  float* wzr_s = reinterpret_cast<float*>(smem + l.w);
  float* wc_s = wzr_s + K * K * U * 8;
  uint2* hpad = reinterpret_cast<uint2*>(smem + l.hpad);
  uint2* rhpad = reinterpret_cast<uint2*>(smem + l.rhpad);
  float* hs = reinterpret_cast<float*>(smem + l.h);
  float* us = reinterpret_cast<float*>(smem + l.u);
  constexpr int P = K / 2;
  const int b = blockIdx.x, tid = threadIdx.x, Wp = g.Wp;

  load_weights<K, U>(wzr, wc, wzr_s, wc_s);
  for (int e = tid; e < g.Np; e += kThreads) {
    hpad[e] = make_uint2(0u, 0u);
    rhpad[e] = make_uint2(0u, 0u);
  }
  __syncthreads();
  const float* h0b = h0 + (size_t)b * g.HW * U;
  for (int p = tid; p < g.HW; p += kThreads) {
    float v[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      v[i] = h0b[p * U + i];
      hs[p * U + i] = v[i];
    }
    const int y = p / W, x = p - y * W;
    hpad[(y + P) * Wp + x + P] = pack_pixel<U>(v);
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* wxt = wx + ((size_t)t * B + b) * g.HW * 3 * U;
    float* yt = ys + ((size_t)t * B + b) * g.HW * U;
    // phase 1: the z|r conv, the gates, r*h
    for (int p0 = tid; p0 < g.HW; p0 += kThreads * kPix) {
      const Pixels px = pixels_from(p0, g);
      float zr[kPix][2 * U];
      conv_px<K, U, 2 * U, 8>(hpad, px, Wp, wzr_s, zr);
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (!px.live[j]) continue;
        const int p = px.p[j];
        float rh[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const float u = sigmoidf(__fadd_rn(__bfloat162float(wxt[p * 3 * U + i]), zr[j][i]));
          const float r =
              sigmoidf(__fadd_rn(__bfloat162float(wxt[p * 3 * U + U + i]), zr[j][U + i]));
          us[p * U + i] = u;
          rh[i] = __fmul_rn(r, hs[p * U + i]);
        }
        rhpad[px.base[j] + P * Wp + P] = pack_pixel<U>(rh);
      }
    }
    __syncthreads();
    // phase 2: the candidate's conv and the update
    for (int p0 = tid; p0 < g.HW; p0 += kThreads * kPix) {
      const Pixels px = pixels_from(p0, g);
      float cc[kPix][U];
      conv_px<K, U, U, 4>(rhpad, px, Wp, wc_s, cc);
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (!px.live[j]) continue;
        const int p = px.p[j];
        float hn[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const float c =
              tanhf(__fadd_rn(__bfloat162float(wxt[p * 3 * U + 2 * U + i]), cc[j][i]));
          const float u = us[p * U + i];
          hn[i] = __fadd_rn(__fmul_rn(u, hs[p * U + i]), __fmul_rn(__fsub_rn(1.f, u), c));
          hs[p * U + i] = hn[i];
          yt[p * U + i] = hn[i];
        }
        hpad[px.base[j] + P * Wp + P] = pack_pixel<U>(hn);
      }
    }
    __syncthreads();
  }
}

template <int K, int U>
__global__ void __launch_bounds__(kThreads, 1)
    convgru_small_bwd_kernel(const __nv_bfloat16* __restrict__ wx, const float* __restrict__ ys,
                             const float* __restrict__ h0, const float* __restrict__ gy,
                             const float* __restrict__ wzr, const float* __restrict__ wc,
                             __nv_bfloat16* __restrict__ dwx, float* __restrict__ dh0,
                             float* __restrict__ sums, float* __restrict__ partial, int T,
                             int B, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geo g = make_geo(H, W, K);
  const BwdLayout l = bwd_layout(g, U);
  float* wzr_s = reinterpret_cast<float*>(smem + l.w);
  float* wc_s = wzr_s + K * K * U * 8;
  uint2* hpad = reinterpret_cast<uint2*>(smem + l.hpad);
  uint2* rhpad = reinterpret_cast<uint2*>(smem + l.rhpad);
  uint2* dapad = reinterpret_cast<uint2*>(smem + l.dapad);
  uint4* dzrpad = reinterpret_cast<uint4*>(smem + l.dzrpad);
  float* us = reinterpret_cast<float*>(smem + l.u);
  float* rs = reinterpret_cast<float*>(smem + l.r);
  float* dhs = reinterpret_cast<float*>(smem + l.dh);
  constexpr int P = K / 2, KK = K * K, NW = 3 * U * U;
  const int b = blockIdx.x, tid = threadIdx.x, Wp = g.Wp;

  load_weights<K, U>(wzr, wc, wzr_s, wc_s);
  for (int e = tid; e < g.Np; e += kThreads) {
    hpad[e] = make_uint2(0u, 0u);
    rhpad[e] = make_uint2(0u, 0u);
    dapad[e] = make_uint2(0u, 0u);
    dzrpad[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int e = tid; e < g.HW * U; e += kThreads) dhs[e] = 0.f;

  // this thread's share of the weight gradients: one tap, one chunk of
  // pixels; its running sums [dU_zr's U*2U | dU_c's U*U]
  const int nchunk = wgrad_chunks(K);
  const int wtap = tid % KK, wchunk = tid / KK;
  const bool wlive = wchunk < nchunk;
  const int woff = (wtap / K) * Wp + wtap % K;
  const int p_lo = wlive ? (int)((long long)wchunk * g.HW / nchunk) : 0;
  const int p_hi = wlive ? (int)((long long)(wchunk + 1) * g.HW / nchunk) : 0;
  float* my_sums = sums + ((size_t)b * kThreads + tid) * NW;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const float* hprev = t > 0 ? ys + ((size_t)(t - 1) * B + b) * g.HW * U
                               : h0 + (size_t)b * g.HW * U;
    const __nv_bfloat16* wxt = wx + ((size_t)t * B + b) * g.HW * 3 * U;
    const float* gt = gy + ((size_t)t * B + b) * g.HW * U;
    __nv_bfloat16* dwxt = dwx + ((size_t)t * B + b) * g.HW * 3 * U;
    // phase A0: h_{t-1} into the padded bf16 operand
    for (int p = tid; p < g.HW; p += kThreads) {
      const int y = p / W, x = p - y * W;
      float v[U];
#pragma unroll
      for (int i = 0; i < U; ++i) v[i] = hprev[p * U + i];
      hpad[(y + P) * Wp + x + P] = pack_pixel<U>(v);
    }
    __syncthreads();
    // phase A: the forward's z|r conv and gates, r*h
    for (int p0 = tid; p0 < g.HW; p0 += kThreads * kPix) {
      const Pixels px = pixels_from(p0, g);
      float zr[kPix][2 * U];
      conv_px<K, U, 2 * U, 8>(hpad, px, Wp, wzr_s, zr);
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (!px.live[j]) continue;
        const int p = px.p[j];
        float rh[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const float u = sigmoidf(__fadd_rn(__bfloat162float(wxt[p * 3 * U + i]), zr[j][i]));
          const float r =
              sigmoidf(__fadd_rn(__bfloat162float(wxt[p * 3 * U + U + i]), zr[j][U + i]));
          us[p * U + i] = u;
          rs[p * U + i] = r;
          rh[i] = __fmul_rn(r, hprev[p * U + i]);
        }
        rhpad[px.base[j] + P * Wp + P] = pack_pixel<U>(rh);
      }
    }
    __syncthreads();
    // phase B: the candidate, du_pre and da
    for (int p0 = tid; p0 < g.HW; p0 += kThreads * kPix) {
      const Pixels px = pixels_from(p0, g);
      float cc[kPix][U];
      conv_px<K, U, U, 4>(rhpad, px, Wp, wc_s, cc);
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (!px.live[j]) continue;
        const int p = px.p[j], base = px.base[j];
        float du[U], da[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const float c =
              tanhf(__fadd_rn(__bfloat162float(wxt[p * 3 * U + 2 * U + i]), cc[j][i]));
          const float u = us[p * U + i], h = hprev[p * U + i];
          const float dh_new = __fadd_rn(gt[p * U + i], dhs[p * U + i]);
          const float one_u = __fsub_rn(1.f, u);
          du[i] = __fmul_rn(__fmul_rn(__fmul_rn(dh_new, __fsub_rn(h, c)), u), one_u);
          da[i] = __fmul_rn(__fmul_rn(dh_new, one_u), __fsub_rn(1.f, __fmul_rn(c, c)));
          dhs[p * U + i] = __fmul_rn(dh_new, u);
          dwxt[p * 3 * U + i] = __float2bfloat16_rn(du[i]);
          dwxt[p * 3 * U + 2 * U + i] = __float2bfloat16_rn(da[i]);
        }
        dapad[base + P * Wp + P] = pack_pixel<U>(da);
        reinterpret_cast<uint2*>(dzrpad + base + P * Wp + P)[0] = pack_pixel<U>(du);
      }
    }
    __syncthreads();
    // phase C: drh, dr_pre; dU_c's products
    for (int p0 = tid; p0 < g.HW; p0 += kThreads * kPix) {
      const Pixels px = pixels_from(p0, g);
      float drh[kPix][U];
      conv_t_c<K, U>(dapad, px, Wp, wc_s, drh);
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (!px.live[j]) continue;
        const int p = px.p[j];
        float dr[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const float r = rs[p * U + i];
          dr[i] = __fmul_rn(__fmul_rn(__fmul_rn(drh[j][i], hprev[p * U + i]), r),
                            __fsub_rn(1.f, r));
          dhs[p * U + i] = __fadd_rn(dhs[p * U + i], __fmul_rn(drh[j][i], r));
          dwxt[p * 3 * U + U + i] = __float2bfloat16_rn(dr[i]);
        }
        reinterpret_cast<uint2*>(dzrpad + px.base[j] + P * Wp + P)[1] = pack_pixel<U>(dr);
      }
    }
    if (wlive) {
      float acc[U * U];
#pragma unroll
      for (int e = 0; e < U * U; ++e) acc[e] = 0.f;
      int y = p_lo / W, x = p_lo - y * W;
#pragma unroll 4
      for (int p = p_lo; p < p_hi; ++p) {
        float xv[4], gv[4];
        unpack4(rhpad[y * Wp + x + woff], xv);
        unpack4(dapad[(y + P) * Wp + x + P], gv);
#pragma unroll
        for (int i = 0; i < U; ++i)
#pragma unroll
          for (int j = 0; j < U; ++j) acc[i * U + j] = fmaf(xv[i], gv[j], acc[i * U + j]);
        if (++x == W) {
          x = 0;
          ++y;
        }
      }
#pragma unroll
      for (int e = 0; e < U * U; ++e)
        my_sums[U * 2 * U + e] =
            t == T - 1 ? acc[e] : __fadd_rn(my_sums[U * 2 * U + e], acc[e]);
    }
    __syncthreads();
    // phase D: dh_{t-1}; dU_zr's products
    for (int p0 = tid; p0 < g.HW; p0 += kThreads * kPix) {
      const Pixels px = pixels_from(p0, g);
      float dz[kPix][U];
      conv_t_zr<K, U>(dzrpad, px, Wp, wzr_s, dz);
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (!px.live[j]) continue;
#pragma unroll
        for (int i = 0; i < U; ++i)
          dhs[px.p[j] * U + i] = __fadd_rn(dhs[px.p[j] * U + i], dz[j][i]);
      }
    }
    if (wlive) {
      float acc[U * 2 * U];
#pragma unroll
      for (int e = 0; e < U * 2 * U; ++e) acc[e] = 0.f;
      int y = p_lo / W, x = p_lo - y * W;
#pragma unroll 4
      for (int p = p_lo; p < p_hi; ++p) {
        float xv[4], z[4], r[4];
        unpack4(hpad[y * Wp + x + woff], xv);
        const uint4 v = dzrpad[(y + P) * Wp + x + P];
        unpack4(make_uint2(v.x, v.y), z);
        unpack4(make_uint2(v.z, v.w), r);
#pragma unroll
        for (int i = 0; i < U; ++i) {
#pragma unroll
          for (int j = 0; j < U; ++j) {
            acc[i * 2 * U + j] = fmaf(xv[i], z[j], acc[i * 2 * U + j]);
            acc[i * 2 * U + U + j] = fmaf(xv[i], r[j], acc[i * 2 * U + U + j]);
          }
        }
        if (++x == W) {
          x = 0;
          ++y;
        }
      }
#pragma unroll
      for (int e = 0; e < U * 2 * U; ++e)
        my_sums[e] = t == T - 1 ? acc[e] : __fadd_rn(my_sums[e], acc[e]);
    }
    __syncthreads();
  }

  float* dh0b = dh0 + (size_t)b * g.HW * U;
  for (int e = tid; e < g.HW * U; e += kThreads) dh0b[e] = dhs[e];
  // the CTA's partial: its chunks' running sums added in order, per tap, i
  // and j (the last step's __syncthreads made every thread's sums visible)
  const float* cta_sums = sums + (size_t)b * kThreads * NW;
  float* out = partial + (size_t)b * KK * NW;
  for (int o = tid; o < KK * NW; o += kThreads) {
    int tap, local;
    if (o < KK * U * 2 * U) {
      tap = o / (U * 2 * U);
      local = o % (U * 2 * U);
    } else {
      tap = (o - KK * U * 2 * U) / (U * U);
      local = U * 2 * U + (o - KK * U * 2 * U) % (U * U);
    }
    float s = 0.f;
    for (int c = 0; c < nchunk; ++c) s = __fadd_rn(s, cta_sums[(c * KK + tap) * NW + local]);
    out[o] = s;
  }
}

// dw[o] = sum over b = 0..B-1 of partial[b][o], in that order.
__global__ void convgru_small_wsum_kernel(const float* __restrict__ partial,
                                          float* __restrict__ dw, int B, int n) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s = __fadd_rn(s, partial[(size_t)b * n + o]);
  dw[o] = s;
}

// The one shape that is built: the cascade's top cell (K = 5, U = 3) on a
// grid whose every pixel group of five has a thread (H*W <= 512*5).
bool valid(int T, int B, int H, int W, int K, int U) {
  return T >= 1 && B >= 1 && H >= 1 && W >= 1 && H * W <= kThreads * kPix && K == 5 && U == 3;
}

template <int K, int U>
cudaError_t launch_fwd(const void* wx, const float* wzr, const float* wc, const float* h0,
                       float* ys, int T, int B, int H, int W, cudaStream_t s) {
  const size_t smem = fwd_layout(make_geo(H, W, K), U).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = convgru_small_fwd_kernel<K, U>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, s>>>(static_cast<const __nv_bfloat16*>(wx), wzr, wc, h0, ys, T, B,
                                   H, W);
  return cudaGetLastError();
}

template <int K, int U>
cudaError_t launch_bwd(const void* wx, const float* ys, const float* h0, const float* gy,
                       const float* wzr, const float* wc, void* dwx, float* dh0, float* sums,
                       float* partial, float* dw, int T, int B, int H, int W, cudaStream_t s) {
  const size_t smem = bwd_layout(make_geo(H, W, K), U).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = convgru_small_bwd_kernel<K, U>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, s>>>(static_cast<const __nv_bfloat16*>(wx), ys, h0, gy, wzr, wc,
                                   static_cast<__nv_bfloat16*>(dwx), dh0, sums, partial, T, B,
                                   H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = K * K * 3 * U * U;
  convgru_small_wsum_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, dw, B, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one CTA: of the forward (backward = 0) or the backward.
size_t convgru_small_smem_bytes(int H, int W, int K, int U, int backward) {
  const Geo g = make_geo(H, W, K);
  return backward ? bwd_layout(g, U).total : fwd_layout(g, U).total;
}

// The forward: ys [T,B,H,W,U] from wx [T,B,H,W,3U] bf16 and h0. Returns
// the launch's error code (0 = ok).
int convgru_small_fwd(const void* wx, const float* wzr, const float* wc, const float* h0,
                      float* ys, int T, int B, int H, int W, int K, int U, void* stream) {
  if (!valid(T, B, H, W, K, U)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_fwd<5, 3>(wx, wzr, wc, h0, ys, T, B, H, W, s);
}

// The backward: dwx (bf16), dh0, and dw = [dU_zr | dU_c] (K*K*3U*U floats)
// through the f32 scratch `sums` [B, 512, 3U*U] (each thread's running
// sums) and `partial` [B, K*K*3U*U]. Two launches on `stream`.
int convgru_small_bwd(const void* wx, const float* ys, const float* h0, const float* gy,
                      const float* wzr, const float* wc, void* dwx, float* dh0, float* sums,
                      float* partial, float* dw, int T, int B, int H, int W, int K, int U,
                      void* stream) {
  if (!valid(T, B, H, W, K, U)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_bwd<5, 3>(wx, ys, h0, gy, wzr, wc, dwx, dh0, sums, partial, dw, T, B, H, W,
                              s);
}

}  // extern "C"
