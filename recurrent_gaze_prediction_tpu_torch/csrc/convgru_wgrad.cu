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
// M = 9U rows (tap, input channel), N = 2U or U, K = T*B*H*W.
//
// Inputs: hprev, rh, da [T*B,H,W,U] and dzr [T*B,H,W,2U], f32.
// Outputs: dU_zr [3,3,U,2U] then dU_c [3,3,U,U] in one f32 buffer, in
// (dy, dx, cin) row order, the layout of `kernel_grad`.
//
// Numerics rule (`kernel_grad`'s): in bf16 mode both operands are rounded
// to bf16 and the products summed in f32; in f32 mode everything is f32
// (scalar FMAs). Each K slice writes its partial sums once into a
// workspace [slices][27 U^2]; a second kernel adds the slices in slice
// order, so two calls give the same bits (no atomics).
//
// Bound on an H100 SXM at T=42, U=128, bf16: 2 * 9U * 3U * K = 14.6 / 29.1
// / 51.0 GFLOP at B = 8 / 16 / 28 (15 / 29 / 52 us at 989 TFLOP/s),
// against 42 / 84 / 147 MB read (four f32 streams; 13 / 25 / 44 us at
// 3.35 TB/s). So operations bound it.
//
// bf16 design (wgmma, tap-shared tiles). A CTA owns 64 input channels (all
// nine taps: M = 9 x 64) by 64 output columns of one gradient, over one
// slice of the frames: 12 tiles at U = 128 (2 channel blocks x (4 + 2)
// column blocks), 11 slices, one CTA per SM. For each frame:
//   * one thread TMA-loads the frame's [H*W][64] f32 boxes of the input
//     (h or r*h) and of the cotangent (dzr or da) into a 3-deep ring
//     (full mbarriers; refilled once every thread has read a stage);
//   * the CTA rounds them to bf16 once, into 128B-swizzled MN-major tiles:
//     the cotangent on a K grid of H+1 rows of RS = round8(W+1) positions
//     (zero past the frame), the input three times, shifted by dx = 0, 1,
//     2 and framed by a zero block of RS rows above and below. A tap
//     (dy, dx) is then copy dx read from row dy * RS: a whole number of
//     8-row swizzle atoms, so one descriptor start address serves it, and
//     no im2col tile is built;
//   * warpgroup dy runs wgmma m64n64k16 (both operands MN-major from
//     shared memory, the descriptors' transpose bits set) for its three
//     taps, while the CTA converts the next frame into the other buffer.
// Each input byte crosses L2 to the SMs 2 (cotangent) to 4 (h at U = 128)
// times, where 128 x 128 single-tap tiles read every input 9 times: 0.35
// GB at B=28 against 1.6 GB, and device memory about once (the tiles of
// one slice are neighbours in the grid). The zero rows make K = 64 per 49
// positions at 7x7 (x1.31 the products: 67 GFLOP at B=28). On the card,
// of the ~3 k clocks a frame takes, it waits ~1.1 k for its boxes and
// ~1.4 k at the barrier after its rounding (the clock64 timeline of
// scripts/torch_gw_variants.py). Halving the cotangent's L2 reads (TMA
// multicast over 2-CTA clusters, one read per pair of channel blocks)
// changed nothing (0.1925 against 0.1909 ms at B=28), so L2 is not the
// bound; the likely one is the shared-memory port, which the products'
// operand reads (~144 KB a frame) and the rounding's stores share.
//
// f32 mode: 128 x 128 single-tap tiles, scalar FMAs, split K into `slices`
// ranges of positions.

#include "cluster_conv.cuh"
#include "hopper.cuh"

using namespace rgpc;

namespace {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------------------ bf16: wgmma

constexpr int kThreadsW = 384;  // three warpgroups: taps of dy = 0, 1, 2
constexpr int kBlock = 64;      // input channels and output columns of a tile
constexpr int kStages = 3;      // the f32 ring
constexpr int kSlots = 132;     // CTAs an H100 holds at once (one per SM)

struct WGeo {
  int H, W, U, hw;
  int RS;     // positions per row of the K grid: W + 1 rounded up to 8
  int P;      // K rows per frame: (H + 1) * RS rounded up to 16
  int XR;     // rows of a shifted input copy: P + 2 RS
  int cb;     // input-channel blocks
  int ob_zr;  // output-column blocks of dU_zr, then of dU_c
  int ob_c;
  int tiles;
};

__host__ __device__ inline WGeo make_wgeo(int H, int W, int U) {
  WGeo q;
  q.H = H;
  q.W = W;
  q.U = U;
  q.hw = H * W;
  q.RS = (W + 1 + 7) / 8 * 8;
  q.P = ((H + 1) * q.RS + 15) / 16 * 16;
  q.XR = q.P + 2 * q.RS;
  q.cb = cdiv(U, kBlock);
  q.ob_zr = cdiv(2 * U, kBlock);
  q.ob_c = cdiv(U, kBlock);
  q.tiles = q.cb * (q.ob_zr + q.ob_c);
  return q;
}

// bytes of one bf16 operand buffer: three input copies, the cotangent tile
__host__ __device__ inline size_t operand_bytes(const WGeo& q) {
  return (size_t)(3 * q.XR + q.P) * 128;
}

// the slack to align to 1024, two operand buffers, the f32 ring (an input
// and a cotangent box of [H*W][64] per stage), its barriers
__host__ __device__ inline size_t wgmma_smem_bytes(const WGeo& q) {
  return 1024 + 2 * operand_bytes(q) + (size_t)kStages * 2 * q.hw * kBlock * 4 + 8 * kStages;
}

// the bf16 route takes a grid whose frame fits one TMA box (H*W <= 256)
// and whose buffers fit shared memory
__host__ __device__ inline bool wgmma_takes(const WGeo& q) {
  return q.hw <= 256 && wgmma_smem_bytes(q) <= (size_t)kMaxSharedBytes;
}

__host__ __device__ inline int wgmma_slices(const WGeo& q, int frames) {
  const int s = kSlots / q.tiles;
  return s < 1 ? 1 : (s > frames ? frames : s);
}

__global__ void __launch_bounds__(kThreadsW, 1)
    wgrad_wgmma(const __grid_constant__ CUtensorMap thp, const __grid_constant__ CUtensorMap trh,
                const __grid_constant__ CUtensorMap tdzr,
                const __grid_constant__ CUtensorMap tda, float* __restrict__ ws, int frames,
                const WGeo q) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const size_t ops = operand_bytes(q);
  const int box = q.hw * kBlock * 4;  // bytes of one f32 box
  uint8_t* stage = smem + 2 * ops;    // [kStages][input box, cotangent box]
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + (size_t)kStages * 2 * box);

  // this CTA's tile (the tiles of one slice are neighbours) and frames
  const int slices = gridDim.x / q.tiles, slice = blockIdx.x / q.tiles;
  int tile = blockIdx.x % q.tiles;
  const int cbi = tile % q.cb;
  tile /= q.cb;
  const bool zr = tile < q.ob_zr;
  const int obi = zr ? tile : tile - q.ob_zr;
  const int U = q.U, N = zr ? 2 * U : U;
  const int c0 = cbi * kBlock, o0 = obi * kBlock;
  const int f0 = (int)((long long)frames * slice / slices);
  const int nf = (int)((long long)frames * (slice + 1) / slices) - f0;
  const CUtensorMap* tx = zr ? &thp : &trh;
  const CUtensorMap* tg = zr ? &tdzr : &tda;

  const int tid = threadIdx.x;
  auto fetch = [&](int i) {  // frame f0 + i into stage i % kStages
    const int st = i % kStages;
    uint8_t* dst = stage + (size_t)st * 2 * box;
    mbar_expect_tx(&full[st], 2 * box);
    tma_load_2d(dst, tx, &full[st], c0, (f0 + i) * q.hw);
    tma_load_2d(dst + box, tg, &full[st], o0, (f0 + i) * q.hw);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int i = 0; i < kStages && i < nf; ++i) fetch(i);
  }
  zero_fill(smem, 2 * ops);  // the zero blocks and columns are never written again
  __syncthreads();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;  // wg = dy
  float acc[3][32];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[dx][i] = 0.0f;
  }
  for (int i = 0; i < nf; ++i) {
    const int st = i % kStages;
    uint8_t* buf = smem + (size_t)(i & 1) * ops;
    // buf was read by frame i - 2's products: retire this warpgroup's, then
    // wait for every warpgroup
    wgmma_wait<1>();
    __syncthreads();
    mbar_wait(&full[st], (i / kStages) & 1);
    // round the frame to bf16: 8 channels (16 bytes) a step, the input into
    // its three shifted copies, the cotangent into its tile
    const float* sx = reinterpret_cast<const float*>(stage + (size_t)st * 2 * box);
    const float* sg = sx + q.hw * kBlock;
    uint8_t* gt = buf + (size_t)3 * q.XR * 128;
    for (int it = tid; it < 2 * q.hw * 8; it += kThreadsW) {
      const bool is_g = it >= q.hw * 8;
      const int e = is_g ? it - q.hw * 8 : it;
      const int p = e >> 3, ch = (e & 7) * 8;
      const float* src = (is_g ? sg : sx) + p * kBlock + ch;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      const uint4 v = make_uint4(pack_bf16x2(lo.x, lo.y), pack_bf16x2(lo.z, lo.w),
                                 pack_bf16x2(hi.x, hi.y), pack_bf16x2(hi.z, hi.w));
      const int y = p / q.W, x = p - y * q.W;
      if (is_g) {
        *reinterpret_cast<uint4*>(gt + sw128_offset(y * q.RS + x, ch)) = v;
      } else {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int xs = x + 1 - dx;  // copy dx holds h[y][x' + dx - 1] at x'
          if (xs >= 0) {
            *reinterpret_cast<uint4*>(buf + (size_t)dx * q.XR * 128 +
                                      sw128_offset((y + 1) * q.RS + xs, ch)) = v;
          }
        }
      }
    }
    fence_proxy_async();
    __syncthreads();  // the tiles are written and the stage is read
    if (tid == 0 && i + kStages < nf) fetch(i + kStages);

    wgmma_fence();
    const uint32_t gb = smem_u32(gt);
#pragma unroll 1
    for (int k = 0; k < q.P; k += 16) {
      const uint64_t db = desc_sw128(gb + k * 128, 1024, 1024);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint32_t a = smem_u32(buf + (size_t)dx * q.XR * 128) + (wg * q.RS + k) * 128;
        wgmma_ss_mn_64(acc[dx], desc_sw128(a, 1024, 1024), db);
      }
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[dx][i])::"memory");
  }

  // rows (tap, c0 + m), columns o0 + n of this slice's partial gradient
  float* out = ws + (size_t)slice * 27 * U * U + (zr ? 0 : (size_t)18 * U * U);
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int tap = wg * 3 + dx;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cin = c0 + warp * 16 + (lane >> 2) + 8 * half;
      if (cin >= U) continue;
      float* row = out + ((size_t)tap * U + cin) * N + o0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + 2 * (lane & 3);
        if (o0 + n < N) {
          *reinterpret_cast<float2*>(row + n) =
              make_float2(acc[dx][4 * j + 2 * half], acc[dx][4 * j + 2 * half + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------- f32: scalar

constexpr int kFThreads = 256;
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kLoads = BK * BM / 4 / kFThreads;  // float4 loads per thread per operand
constexpr int LD = BM + 4;                       // row stride of a staged chunk
constexpr size_t kFSmem = (size_t)2 * 2 * BK * LD * 4;  // 2 buffers of A and B
constexpr int kFSlots = 264;  // CTAs an H100 holds at once (two per SM)

__host__ __device__ inline int f32_tiles(int U) {
  return cdiv(9 * U, BM) * (cdiv(2 * U, BN) + cdiv(U, BN));
}

__host__ __device__ inline int f32_slices(int U, int frames, int hw) {
  const long long chunks = ((long long)frames * hw + BK - 1) / BK;
  const long long s = kFSlots / f32_tiles(U);
  return (int)(s < 1 ? 1 : (s > chunks ? chunks : s));
}

// 128 x 128 output tiles of one tap; the grid is tiles x slices. Thread
// (tm, tn) owns rows tm*8 .. +8 and columns tn*8 .. +8.
__global__ void __launch_bounds__(kFThreads, 2)
    wgrad_f32(const float* __restrict__ hprev, const float* __restrict__ dzr,
              const float* __restrict__ rh, const float* __restrict__ da,
              float* __restrict__ ws, long long K, int U, Grid g) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);  // [2 buffers][A, B][BK][LD]
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
      const int i = threadIdx.x + l * kFThreads;
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
    float* a = stage + (size_t)buf * 2 * BK * LD;
    float* b = a + BK * LD;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int i = threadIdx.x + l * kFThreads;
      const int kr = i / (BM / 4), col = i % (BM / 4) * 4;
      store4(a + kr * LD + col, ra[l]);
      store4(b + kr * LD + col, rb[l]);
    }
  };

  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  float acc[8][8] = {};
  load(0);
  store(0);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) load(c + 1);
    const float* a = stage + (size_t)(c & 1) * 2 * BK * LD;
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
      *reinterpret_cast<float4*>(o + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
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

cudaError_t launch_wgmma(const float* hprev, const float* dzr, const float* rh, const float* da,
                         float* ws, int frames, int slices, const WGeo& q, cudaStream_t stream) {
  CUtensorMap thp, trh, tdzr, tda;
  const uint64_t rows = (uint64_t)frames * q.hw, U = q.U;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  if (!encode_2d(&thp, f32, hprev, U, rows, U * 4, kBlock, q.hw, none) ||
      !encode_2d(&trh, f32, rh, U, rows, U * 4, kBlock, q.hw, none) ||
      !encode_2d(&tdzr, f32, dzr, 2 * U, rows, 2 * U * 4, kBlock, q.hw, none) ||
      !encode_2d(&tda, f32, da, U, rows, U * 4, kBlock, q.hw, none)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = wgmma_smem_bytes(q);
  cudaError_t err =
      cudaFuncSetAttribute(wgrad_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wgrad_wgmma<<<q.tiles * slices, kThreadsW, smem, stream>>>(thp, trh, tdzr, tda, ws, frames, q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Phase W's plan, a function of the shapes alone (elem_bytes 2 = bf16, 4 =
// f32): output tiles, and the K slices of `frames` frames.
int convgru_wgrad_tiles(int H, int W, int U, int elem_bytes) {
  return elem_bytes == 2 ? make_wgeo(H, W, U).tiles : f32_tiles(U);
}

int convgru_wgrad_slices(int frames, int H, int W, int U, int elem_bytes) {
  return elem_bytes == 2 ? wgmma_slices(make_wgeo(H, W, U), frames)
                         : f32_slices(U, frames, H * W);
}

// Shared memory of one CTA.
size_t convgru_wgrad_smem_bytes(int H, int W, int U, int elem_bytes) {
  return elem_bytes == 2 ? wgmma_smem_bytes(make_wgeo(H, W, U)) : kFSmem;
}

// Launches on `stream`; returns the launch's error code (0 = ok).
// workspace holds slices * 27 U^2 floats; out 27 U^2 (dU_zr, then dU_c).
// elem_bytes selects the operands' rounding: 2 = bf16, 4 = f32. `slices`
// must be the plan's (`convgru_wgrad_slices`).
int convgru_wgrad(const float* hprev, const float* dzr, const float* rh, const float* da,
                  float* workspace, float* out, int frames, int slices, int H, int W, int U,
                  int elem_bytes, void* stream) {
  if (frames < 1 || U < 16 || U % 16 || H < 1 || W < 1 ||
      (elem_bytes != 2 && elem_bytes != 4) ||
      slices != convgru_wgrad_slices(frames, H, W, U, elem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (elem_bytes == 2) {
    const WGeo q = make_wgeo(H, W, U);
    if (!wgmma_takes(q)) return (int)cudaErrorInvalidValue;
    err = launch_wgmma(hprev, dzr, rh, da, workspace, frames, slices, q, s);
  } else {
    err = cudaFuncSetAttribute(wgrad_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kFSmem);
    if (err == cudaSuccess) {
      wgrad_f32<<<dim3(f32_tiles(U), slices), kFThreads, kFSmem, s>>>(
          hprev, dzr, rh, da, workspace, (long long)frames * H * W, U, make_grid(H, W));
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return (int)err;
  const size_t n4 = (size_t)27 * U * U / 4;
  wgrad_reduce<<<(int)((n4 + 255) / 256), 256, 0, s>>>(
      reinterpret_cast<const float4*>(workspace), slices, n4, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
