// Kernel Q1: one layer of the int8 C3D tower, a 3x3x3 SAME convolution
// (stride 1) of int8 activations by int8 weights with int32 accumulation,
// and its fused epilogue; and Q1-pool, the int8 max pool between layers.
// For Hopper (sm_90a).
//
// There is no Pallas kernel for this: the JAX package computes a layer of
// `apply_int8` (recurrent_gaze_prediction_tpu/models/quant.py:100-119) with
// `lax.conv_general_dilated` on int8 with `preferred_element_type=int32`
// (`_conv3d_int8`, quant.py:91-97), and XLA fuses the epilogue. PyTorch has
// no int8 conv3d on CUDA, so the port writes it.
//
// What one launch computes, per output position m = (n, d, h, w) and output
// channel c (x and w int8, acc int32):
//
//   acc   = sum_{kd,kh,kw,ci} x[n, d+kd-1, h+kh-1, w+kw-1, ci] * w[c, kd, kh, kw, ci]
//   alpha = xscale * wscale[c]
//   y     = relu(float(acc) * alpha + b[c])
//   out   = clip(round_half_even(y / xscale_next), -127, 127)  as int8   (conv1a..conv5a)
//   out   = y                                                  as f32    (conv5b)
//
// The epilogue uses IEEE single operations in the JAX package's order
// (__int2float_rn, __fmul_rn, __fadd_rn, __fdiv_rn, __float2int_rn): no
// contraction into an FMA and a true division, so the kernel and its plain
// version (ops/kernels/conv3d_int8.py) agree bit for bit.
//
// Layouts: x is [N, D, H, W, Cin] int8 (NDHWC, contiguous); the weights are
// packed once at quantize time as [Cout, K] int8 rows in (tap, ci) order,
// tap = (kd * 3 + kh) * 3 + kw: k = tap * Cin + ci for Cin a multiple of 64
// (K = 27 * Cin); for Cin <= 4 (conv1a) each tap's channels fill one 32-bit
// word, zero-padded, k = tap * 4 + ci, and K = 108 is padded to 128. The
// output is [N, D, H, W, Cout], int8 or f32.
//
// Bound on an H100 SXM (1,979 TOP/s dense int8, 3.35 TB/s): the tower's
// eight layers are 77.0 GOP per 16x112x112 clip against ~27 MB of int8
// activations moved, so operations bound every layer but conv1a, which
// moves 13.4 MB per clip (0.6 MB in, 12.8 MB out) for 2.08 GOP: bytes, at
// ~4x its operation time.
//
// Design (a simple implicit GEMM; TMA and wgmma are later work): M = N*D*H*W
// positions, N = Cout, K = 27 * Cin. A CTA of 8 warps (4 x 2, each 32 x 32)
// computes a 128 x 64 tile with mma.sync.m16n8k32 (s8 x s8 -> s32), staging
// 64-byte K chunks of A and B through a 3-stage cp.async ring in shared
// memory (row stride 80 bytes: the fragment loads of a warp fall on 32
// distinct banks). A row of A is gathered on the fly from x at the chunk's
// tap, zero-filled (cp.async src-size 0) outside the volume and past M; the
// im2col matrix is never formed. Cin a multiple of 64 (conv2a..conv5b)
// makes each 16-byte piece of a chunk one tap's contiguous channels.
// conv1a (Cin = 3) gathers its A chunks into shared memory a tap (one
// 32-bit word) at a time: each thread computes its 8 taps' offsets, then
// issues all 32 byte loads at once (addresses clamped inside the tensor,
// the bytes of absent channels and taps masked to zero), so no padded copy
// of the activations is ever made and the loads' latencies overlap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 64, BK = 64;
constexpr int kStages = 3;
constexpr int LDS = BK + 16;  // bytes per staged row

struct Shape {
  int N, D, H, W, Cin, Cout, K;  // K = packed row length of the weights
  long long M;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The output position of row r of the tile, decoded once per thread.
struct Row {
  long long m;  // -1 past M
  int d, h, w;
};

__device__ __forceinline__ Row decode_row(const Shape& s, long long m) {
  Row r;
  if (m >= s.M) {
    r.m = -1;
    r.d = r.h = r.w = 0;
    return r;
  }
  r.m = m;
  long long q = m;
  r.w = (int)(q % s.W);
  q /= s.W;
  r.h = (int)(q % s.H);
  q /= s.H;
  r.d = (int)(q % s.D);
  return r;
}

// The input element offset of row `r` at tap (kd, kh, kw), or -1 outside
// the volume (SAME padding: zeros).
__device__ __forceinline__ long long tap_offset(const Shape& s, const Row& r, int kd, int kh,
                                                int kw) {
  const int dd = r.d + kd - 1, hh = r.h + kh - 1, ww = r.w + kw - 1;
  if (r.m < 0 || dd < 0 || dd >= s.D || hh < 0 || hh >= s.H || ww < 0 || ww >= s.W) return -1;
  return (r.m + ((long long)(kd - 1) * s.H + (kh - 1)) * s.W + (kw - 1)) * s.Cin;
}

// Stage K chunk `kc` of A (gathered) and B into buffer `buf`.
template <bool kSmall>
__device__ __forceinline__ void load_chunk(const Shape& s, const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ w, int8_t* As, int8_t* Bs,
                                           const Row (&rows)[2], int n0, int kc, int tid) {
  // B: 64 rows x 4 pieces of 16 bytes, one piece per thread
  {
    const int row = tid >> 2, piece = tid & 3;
    const int8_t* src = w + (long long)(n0 + row) * s.K + (long long)kc * BK + piece * 16;
    cp_async16(Bs + row * LDS + piece * 16, src, true);
  }
  if (!kSmall) {
    // A: 128 rows x 4 pieces; a chunk is one tap's channels [c0, c0 + 64)
    const int per_tap = s.Cin / BK;
    const int tap = kc / per_tap, c0 = (kc - tap * per_tap) * BK;
    const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
    const int piece = tid & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + i * 64;
      const long long off = tap_offset(s, rows[i], kd, kh, kw);
      const int8_t* src = off < 0 ? x : x + off + c0 + piece * 16;
      cp_async16(As + row * LDS + piece * 16, src, off >= 0);
    }
  } else {
    // A, Cin <= 4: thread handles row tid / 2, taps [half * 8, half * 8 + 8)
    // of the chunk's 16, one 32-bit word each
    const int row = tid >> 1, half = tid & 1;
    const Row& r = rows[0];
    const int tap0 = kc * (BK / 4) + half * 8;
    long long offs[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int tap = tap0 + j;
      offs[j] = tap < 27 ? tap_offset(s, r, tap / 9, (tap / 3) % 3, tap % 3) : -1;
    }
    uint32_t words[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int8_t* p = x + (offs[j] < 0 ? 0 : offs[j]);
      uint32_t w = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t v = (uint8_t)__ldg(p + (c < s.Cin ? c : 0));
        w |= (c < s.Cin ? v : 0u) << (8 * c);
      }
      words[j] = offs[j] < 0 ? 0u : w;
    }
    uint4* dst = reinterpret_cast<uint4*>(As + row * LDS + half * 32);
    dst[0] = make_uint4(words[0], words[1], words[2], words[3]);
    dst[1] = make_uint4(words[4], words[5], words[6], words[7]);
  }
}

template <bool kSmall, bool kOutF32>
__global__ void __launch_bounds__(kThreads)
    conv3d_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ wscale, const float* __restrict__ bias,
                       float xscale, float xscale_next, void* __restrict__ out, Shape s) {
  __shared__ __align__(16) int8_t As[kStages][BM * LDS];
  __shared__ __align__(16) int8_t Bs[kStages][BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the tile rows this thread gathers: (tid >> 2) and +64, or (tid >> 1)
  Row rows[2];
  if (kSmall) {
    rows[0] = decode_row(s, m0 + (tid >> 1));
    rows[1] = rows[0];
  } else {
    rows[0] = decode_row(s, m0 + (tid >> 2));
    rows[1] = decode_row(s, m0 + (tid >> 2) + 64);
  }

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = s.K / BK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_chunk<kSmall>(s, x, w, As[st], Bs[st], rows, n0, st, tid);
    cp_async_commit();
  }

  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kc + kStages - 1;
    if (next < nk) {
      load_chunk<kSmall>(s, x, w, As[next % kStages], Bs[next % kStages], rows, n0, next, tid);
    }
    cp_async_commit();

    const int8_t* a_s = As[kc % kStages];
    const int8_t* b_s = Bs[kc % kStages];
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = a_s + (warp_m * 32 + mi * 16 + g) * LDS + ks * 32 + tig * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = b_s + (warp_n * 32 + ni * 8 + g) * LDS + ks * 32 + tig * 4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();

  // epilogue: dequant, bias, relu, then requant (or f32 for conv5b)
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int c = n0 + warp_n * 32 + ni * 8 + tig * 2;
    float alpha[2], b[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      alpha[e] = __fmul_rn(xscale, wscale[c + e]);
      b[e] = bias[c + e];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + warp_m * 32 + mi * 16 + g + half * 8;
        if (m >= s.M) continue;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v =
              __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + e]), alpha[e]), b[e]);
          y[e] = v > 0.f ? v : 0.f;
        }
        const long long o = m * s.Cout + c;
        if (kOutF32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(y[0], y[1]);
        } else {
          int q[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            q[e] = __float2int_rn(__fdiv_rn(y[e], xscale_next));
            q[e] = q[e] > 127 ? 127 : (q[e] < -127 ? -127 : q[e]);
          }
          const uint16_t packed = (uint16_t)(uint8_t)(int8_t)q[0] |
                                  (uint16_t)((uint16_t)(uint8_t)(int8_t)q[1] << 8);
          *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(out) + o) = packed;
        }
      }
    }
  }
}

// Q1-pool: max over a (wd, wh, ww) window with stride (sd, sh, sw) and SAME
// padding (lo pads pd, ph, pw; a padded element never wins, as JAX's
// lowest-value padding), on NDHWC int8. A thread takes 16 channels of one
// output position: one 16-byte load per window element, __vmaxs4 per word.
__global__ void __launch_bounds__(256)
    maxpool3d_int8_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ y, int N, int D,
                          int H, int W, int C, int Do, int Ho, int Wo, int wd, int wh, int ww,
                          int sd, int sh, int sw, int pd, int ph, int pw) {
  const int groups = C / 16;
  const long long total = (long long)N * Do * Ho * Wo * groups;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long q = i;
  const int gi = (int)(q % groups);
  q /= groups;
  const int wo = (int)(q % Wo);
  q /= Wo;
  const int ho = (int)(q % Ho);
  q /= Ho;
  const int d_o = (int)(q % Do);
  const int n = (int)(q / Do);
  uint4 best = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
  for (int a = 0; a < wd; ++a) {
    const int dd = d_o * sd - pd + a;
    if (dd < 0 || dd >= D) continue;
    for (int b = 0; b < wh; ++b) {
      const int hh = ho * sh - ph + b;
      if (hh < 0 || hh >= H) continue;
      for (int c = 0; c < ww; ++c) {
        const int wi = wo * sw - pw + c;
        if (wi < 0 || wi >= W) continue;
        const long long off = ((((long long)n * D + dd) * H + hh) * W + wi) * C + gi * 16;
        const uint4 v = *reinterpret_cast<const uint4*>(x + off);
        best.x = __vmaxs4(best.x, v.x);
        best.y = __vmaxs4(best.y, v.y);
        best.z = __vmaxs4(best.z, v.z);
        best.w = __vmaxs4(best.w, v.w);
      }
    }
  }
  *reinterpret_cast<uint4*>(y + i * 16) = best;
}

template <bool kSmall>
cudaError_t launch_conv(const int8_t* x, const int8_t* w, const float* wscale, const float* bias,
                        float xscale, float xscale_next, int out_f32, void* out, const Shape& s,
                        cudaStream_t stream) {
  const dim3 grid((unsigned)((s.M + BM - 1) / BM), (unsigned)(s.Cout / BN));
  if (out_f32) {
    conv3d_int8_kernel<kSmall, true>
        <<<grid, kThreads, 0, stream>>>(x, w, wscale, bias, xscale, xscale_next, out, s);
  } else {
    conv3d_int8_kernel<kSmall, false>
        <<<grid, kThreads, 0, stream>>>(x, w, wscale, bias, xscale, xscale_next, out, s);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one layer on `stream`; returns the launch's error code (0 = ok).
// K is the packed weights' row length: 27 * Cin for Cin a multiple of 64,
// 128 for Cin <= 4.
int conv3d_int8(const int8_t* x, const int8_t* w, const float* wscale, const float* bias,
                float xscale, float xscale_next, int out_f32, void* out, int N, int D, int H, int W,
                int Cin, int Cout, int K, void* stream) {
  const bool small = Cin >= 1 && Cin <= 4;
  if (N < 1 || D < 1 || H < 1 || W < 1 || Cout < BN || Cout % BN ||
      !(small ? K == 128 : (Cin % BK == 0 && K == 27 * Cin))) {
    return (int)cudaErrorInvalidValue;
  }
  Shape s{N, D, H, W, Cin, Cout, K, (long long)N * D * H * W};
  if ((s.M + BM - 1) / BM > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (small) {
    return (int)launch_conv<true>(x, w, wscale, bias, xscale, xscale_next, out_f32, out, s, st);
  }
  return (int)launch_conv<false>(x, w, wscale, bias, xscale, xscale_next, out_f32, out, s, st);
}

int maxpool3d_int8(const int8_t* x, int8_t* y, int N, int D, int H, int W, int C, int Do, int Ho,
                   int Wo, int wd, int wh, int ww, int sd, int sh, int sw, int pd, int ph, int pw,
                   void* stream) {
  if (N < 1 || C < 16 || C % 16 || Do < 1 || Ho < 1 || Wo < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)N * Do * Ho * Wo * (C / 16);
  const long long blocks = (total + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  maxpool3d_int8_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, N, D, H, W, C, Do, Ho, Wo, wd, wh, ww, sd, sh, sw, pd, ph, pw);
  return (int)cudaGetLastError();
}

const char* conv3d_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

const char* maxpool3d_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
