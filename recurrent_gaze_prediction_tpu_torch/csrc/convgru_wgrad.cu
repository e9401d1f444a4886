// ConvGRU backward, phase W: the weight gradients of kernel B4 as one
// split-K implicit GEMM, for Hopper (sm_90a).
//
// Kernel B4 (the TPU kernel `_convgru_bwd_kernel` of
// recurrent_gaze_prediction_tpu/ops/pallas/convgru_vjp.py) accumulates, at
// each reverse step,
//
//   dU_zr += patches(h_{t-1})^T dzr_t,   dU_c += patches(r * h_{t-1})^T da_t
//
// (`_conv3x3_kernel_grad`). Both are sums over T*B frames of per-frame
// products, so once B2 (convgru_bwd.cu) has emitted every dzr and da they
// run in parallel, here, after phase G (convgru_bwd_gates.cu) and B2:
//
//   dU_zr[dy,dx,i,o] = sum_{f,y,x} h_{f}[y+dy-1, x+dx-1, i] * dzr_f[y,x,o]
//
// (zero outside the grid), dU_c the same with r * h and da. As a GEMM:
// M = 9U rows (tap, input channel), N = 2U or U, K = T*B*H*W (16,464 at
// B=8 on 7x7). A is read on the fly from the unpadded f32 frames (an
// implicit im2col: a row of A at tap (dy, dx) is the frame shifted, zero at
// the borders); patches() is never materialised.
//
// Inputs: hprev, rh, da [T*B,H,W,U] and dzr [T*B,H,W,2U], f32.
// Outputs: dU_zr [3,3,U,2U] then dU_c [3,3,U,U] in one f32 buffer, in
// (dy, dx, cin) row order, the layout of `kernel_grad`.
//
// Numerics rule (`kernel_grad`'s): in bf16 mode both operands are rounded
// to bf16 and the products summed in f32 (mma.sync.m16n8k16); in f32 mode
// everything is f32 (scalar FMAs).
//
// Bound on an H100 SXM at T=42, U=128, bf16: 2 * 9U * 3U * K = 14.6 / 29.1
// GFLOP at B=8 / 16 (14.7 / 29.5 us at 989 TFLOP/s), against 42 / 84 MB
// read (four f32 streams; 13 / 25 us at 3.35 TB/s). So operations bound it.
//
// Design: 128 x 128 output tiles (27 at U = 128: 18 of dU_zr, 9 of dU_c),
// too few for 132 SMs, so K is split into `slices` equal ranges (a pure
// function of the shapes, chosen by the wrapper: 9 at U = 128, 243 CTAs,
// which two per SM hold in one wave). A CTA of 8 warps (2 x 4, each 64 x 32)
// stages 32-row K chunks of A and B through double-buffered shared memory:
// float4 loads into registers for the next chunk while the tensor cores
// work on this one, rounded to bf16 on the store; fragments by
// ldmatrix.trans. Each slice writes its f32 tile once into a workspace
// [slices][9U*3U]; a second kernel adds the slices in slice order, so two
// calls give the same bits (no atomics).

#include "cluster_conv.cuh"

using namespace rgpc;

namespace {

constexpr int kWThreads = 256;
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kLoads = BK * BM / 4 / kWThreads;  // float4 loads per thread per operand

// row stride of a staged chunk: 16 bytes past a multiple of 128 in bf16
// (ldmatrix rows on distinct banks), 16 in f32
template <typename T>
__host__ __device__ constexpr int ld() {
  return sizeof(T) == 2 ? BM + 8 : BM + 4;
}

template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)2 * 2 * BK * ld<T>() * sizeof(T);  // 2 buffers of A and B
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline int tiles_of(int U) {
  return cdiv(9 * U, BM) * (cdiv(2 * U, BN) + cdiv(U, BN));
}

template <typename T>
__global__ void __launch_bounds__(kWThreads, 2)
    wgrad_kernel(const float* __restrict__ hprev, const float* __restrict__ dzr,
                 const float* __restrict__ rh, const float* __restrict__ da,
                 float* __restrict__ ws, long long K, int U, Grid g) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = ld<T>();
  T* stage = reinterpret_cast<T*>(smem);  // [2 buffers][A, B][BK][LD]
  const int M = 9 * U;
  const int m_tiles = cdiv(M, BM);
  const int zr_tiles = m_tiles * cdiv(2 * U, BN);
  int tile = blockIdx.x;
  const bool zr = tile < zr_tiles;
  if (!zr) tile -= zr_tiles;
  const float* x = zr ? hprev : rh;
  const float* gr = zr ? dzr : da;
  const int N = zr ? 2 * U : U;
  const int n_tiles = cdiv(N, BN);
  const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
  const int slices = gridDim.y, slice = blockIdx.y;
  const long long k_begin = K * slice / slices, k_end = K * (slice + 1) / slices;
  const int chunks = (int)((k_end - k_begin + BK - 1) / BK);
  const int hw = g.H * g.W;
  float* out = ws + (size_t)slice * 27 * U * U + (zr ? 0 : (size_t)M * 2 * U);

  float4 ra[kLoads], rb[kLoads];
  // chunk c's A (rows k, columns m = (tap, cin)) and B (rows k, columns n)
  // into registers; a row past k_end or a column past M / N reads zeros
  auto load = [&](int c) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int i = threadIdx.x + l * kWThreads;
      const int kr = i / (BM / 4), col = i % (BM / 4) * 4;
      const long long k = k_begin + (long long)c * BK + kr;
      ra[l] = rb[l] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (k >= k_end) continue;
      const long long frame = k / hw;
      const int p = (int)(k % hw);
      const int m = m0 + col;
      if (m < M) {
        const int tap = m / U, cin = m % U;
        const int y = p / g.W + tap / 3 - 1, xx = p % g.W + tap % 3 - 1;
        if (y >= 0 && y < g.H && xx >= 0 && xx < g.W) {
          ra[l] = __ldg(reinterpret_cast<const float4*>(
              x + ((size_t)frame * hw + y * g.W + xx) * U + cin));
        }
      }
      const int n = n0 + col;
      if (n < N) rb[l] = __ldg(reinterpret_cast<const float4*>(gr + (size_t)k * N + n));
    }
  };
  auto store = [&](int buf) {
    T* a = stage + (size_t)buf * 2 * BK * LD;
    T* b = a + BK * LD;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int i = threadIdx.x + l * kWThreads;
      const int kr = i / (BM / 4), col = i % (BM / 4) * 4;
      store4(a + kr * LD + col, ra[l]);
      store4(b + kr * LD + col, rb[l]);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (sizeof(T) == 2) {
    // warp (wm, wn) owns rows wm*64 .. +64 and columns wn*32 .. +32
    const int wm = warp / 4, wn = warp % 4;
    float acc[4][4][4] = {};
    // ldmatrix.trans row of this lane: A matrix j = lane / 8 covers k
    // (j / 2) * 8.., m (j % 2) * 8..; B matrix j covers k (j % 2) * 8..,
    // n (j / 2) * 8..
    const int a_row = (lane / 16) * 8 + lane % 8, a_col = (lane / 8) % 2 * 8;
    const int b_row = (lane / 8) % 2 * 8 + lane % 8, b_col = (lane / 16) * 8;
    load(0);
    store(0);
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) load(c + 1);
      const T* a = stage + (size_t)(c & 1) * 2 * BK * LD;
      const T* b = a + BK * LD;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[4][4], bf[2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ldmatrix_x4_trans(af[i], a + (ks * 16 + a_row) * LD + wm * 64 + i * 16 + a_col);
        }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          ldmatrix_x4_trans(bf[jp], b + (ks * 16 + b_row) * LD + wn * 32 + jp * 16 + b_col);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma_bf16(acc[i][j], af[i], bf[j / 2][(j % 2) * 2], bf[j / 2][(j % 2) * 2 + 1]);
          }
        }
      }
      if (c + 1 < chunks) store((c + 1) & 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + wm * 64 + i * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * (lane % 4);
        if (n >= N) continue;
        if (m < M) {
          *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
              make_float2(acc[i][j][0], acc[i][j][1]);
        }
        if (m + 8 < M) {
          *reinterpret_cast<float2*>(out + (size_t)(m + 8) * N + n) =
              make_float2(acc[i][j][2], acc[i][j][3]);
        }
      }
    }
  } else {
    // thread (tm, tn) owns rows tm*8 .. +8 and columns tn*8 .. +8
    const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
    float acc[8][8] = {};
    load(0);
    store(0);
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) load(c + 1);
      const float* a = reinterpret_cast<const float*>(stage) + (size_t)(c & 1) * 2 * BK * LD;
      const float* b = a + BK * LD;
      for (int k = 0; k < BK; ++k) {
        float av[8], bv[8];
        *reinterpret_cast<float4*>(av) = *reinterpret_cast<const float4*>(a + k * LD + tm * 8);
        *reinterpret_cast<float4*>(av + 4) =
            *reinterpret_cast<const float4*>(a + k * LD + tm * 8 + 4);
        *reinterpret_cast<float4*>(bv) = *reinterpret_cast<const float4*>(b + k * LD + tn * 8);
        *reinterpret_cast<float4*>(bv + 4) =
            *reinterpret_cast<const float4*>(b + k * LD + tn * 8 + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      if (c + 1 < chunks) store((c + 1) & 1);
      __syncthreads();
    }
    const int n = n0 + tn * 8;
    if (n < N) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + tm * 8 + i;
        if (m >= M) continue;
        float* o = out + (size_t)m * N + n;
        *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(o + 4) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
  }
}

// out[i] = sum over slices of ws[s][i], added in slice order
__global__ void wgrad_reduce(const float4* __restrict__ ws, int slices, size_t n4,
                             float4* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 s = ws[i];
    for (int sl = 1; sl < slices; ++sl) {
      const float4 v = ws[(size_t)sl * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

template <typename T>
cudaError_t launch(const float* hprev, const float* dzr, const float* rh, const float* da,
                   float* ws, float* out, long long K, int slices, int U, const Grid& g,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wgrad_kernel<T><<<dim3(tiles_of(U), slices), kWThreads, smem, stream>>>(hprev, dzr, rh, da,
                                                                          ws, K, U, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n4 = (size_t)27 * U * U / 4;
  wgrad_reduce<<<(int)((n4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(ws), slices, n4, reinterpret_cast<float4*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Output tiles of one launch (both gradients): the grid is tiles x slices.
int convgru_wgrad_tiles(int U) { return tiles_of(U); }

// Launches on `stream`; returns the launch's error code (0 = ok).
// workspace holds slices * 27 U^2 floats; out 27 U^2 (dU_zr, then dU_c).
// elem_bytes selects the operands' rounding: 2 = bf16, 4 = f32.
int convgru_wgrad(const float* hprev, const float* dzr, const float* rh, const float* da,
                  float* workspace, float* out, int frames, int slices, int H, int W, int U,
                  int elem_bytes, void* stream) {
  if (frames < 1 || slices < 1 || slices > 65535 || U < 16 || U % 16 || H < 1 || W < 1 ||
      (elem_bytes != 2 && elem_bytes != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const Grid g = make_grid(H, W);
  const long long K = (long long)frames * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return (int)launch<__nv_bfloat16>(hprev, dzr, rh, da, workspace, out, K, slices, U, g, s);
  }
  return (int)launch<float>(hprev, dzr, rh, da, workspace, out, K, slices, U, g, s);
}

}  // extern "C"
