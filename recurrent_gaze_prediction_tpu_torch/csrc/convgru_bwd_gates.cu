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
// and ys [T,B,H,W,U] f32. Weights in bf16: U_zr as [2U][9U] and U_c as
// [U][9U] (output column major, K = (dy, dx, cin) contiguous); in f32 the
// plain [9U][N].
// Outputs: u, r, c, hprev, rh [T,B,H,W,U] f32, dense, which is the layout
// B2's launcher reads without a copy.
//
// Numerics rule (the forward kernel B1's, so these are the gates it saw):
// all elementwise math is f32; in bf16 mode each conv operand (h, then
// r * h) is rounded to bf16 and the products are summed in f32; in f32
// mode everything is f32 (scalar FMAs). rh is written unrounded, as the
// plain version `recompute_gates` returns it.
//
// Bound on an H100 SXM at T=42, U=128, bf16 (989 TFLOP/s, 3.35 TB/s): the
// convs are T*B*49*9U*3U*2 = 14.6 / 29.1 / 51.0 GFLOP at B = 8 / 16 / 28
// (15 / 29 / 52 us), against wx in (bf16) and h in, five f32 streams out:
// 64 / 128 / 224 MB (19 / 38 / 67 us). So bytes bound it, operations close
// behind.
//
// bf16 design (wgmma). An implicit-GEMM conv per frame, M = one padded
// output grid H x (W+2) in 64-row tiles (one tile at 7x7: 63 rows), K = 9U,
// N = 2U then U. A CTA (one per SM, persistent over pairs of frames) holds
// two consumer warpgroups, one frame each, and two producer warps:
//   * the weights: 64-deep K chunks of [N tile][64] bf16, 128B-swizzled,
//     come through a ring of shared-memory stages (3 at U = 128) that one
//     producer fills by TMA under full / empty mbarriers. Both warpgroups
//     read each chunk, so the weights cross L2 once per pair of frames, not
//     twice per pair as in the mma.sync kernel this replaces (which also
//     waited on each 16-deep load): at B=28, 588 x 0.885 MB = 0.52 GB of L2
//     traffic (was 1.04 GB);
//   * the frames: the other producer bulk-copies a frame's h_{t-1} (f32)
//     and wx (bf16) into shared memory a pair ahead; the warpgroup writes h
//     out as hprev and rounds it into a zero-padded bf16 buffer (TMA cannot
//     round). The A operand of each k16 step is that buffer shifted by the
//     step's tap, read by ldmatrix into registers (wgmma's A from
//     registers), so no im2col tile is built. Device memory: wx, h and the
//     five f32 outputs once, 0.22 GB at B=28;
//   * products: wgmma.mma_async m64nNk16 (N = the conv's N tile, 128 at
//     U = 128: the z|r conv in two tiles), a chunk's four steps one commit
//     group, one group in flight while the next chunk's A loads;
//   * epilogues from the accumulators: u, r and r*h (the latter also rounded
//     into the frame's buffer, in place of h once every warp of the
//     warpgroup is done with h), then c; wx and h read from shared memory.
// The register sums of a warpgroup (64 x 128 f32) bound how many frames a
// weight chunk serves: two per CTA. What bounds the kernel on the card is
// neither the weights' TMA nor the ring's depth beyond 3 (variants in
// scripts/torch_gw_variants.py): its three K loops run at ~30% of the
// tensor rate, and ptxas serializes wgmma whose A registers come from
// ldmatrix (C7513). A guard on the thread around the products serialized
// them outright (C7520): they run under warpgroup-uniform control flow.
//
// f32 mode: scalar FMAs, one frame per CTA, the weights read from L2.

#include "cluster_conv.cuh"
#include "hopper.cuh"

using namespace rgpc;

namespace {

// ------------------------------------------------------------ bf16: wgmma

constexpr int kConsumers = 256;             // two warpgroups, one frame each
constexpr int kWThreads = kConsumers + 64;  // and two producer warps: weights, frames
constexpr int kChunk = 64;                  // K elements of a weight chunk: 128 bytes
constexpr int kMaxStages = 4;

// The N tile of a conv with N columns (a multiple of 16): the widest of
// 128, 64, 32 and 16 that divides N. (At 256 the sums take 128 registers
// a thread, and under the 168 that two warpgroups and the producers leave,
// ptxas spilled and serialized the wgmma.)
__host__ __device__ inline int n_tile(int N) {
  int bn = 128;
  while (N % bn) bn /= 2;
  return bn;
}

struct GGeo {
  int H, W, Wp, U;
  int frames, batch;
  int mt;       // 64-row M tiles of a frame's H x (W+2) output grid
  int R;        // rows of a padded frame buffer
  int S;        // its row stride in elements, U + 8 (ldmatrix rows on distinct banks)
  int kc;       // weight chunks per N tile: ceil(9U / 64)
  int bn1, bn2;  // N tiles of the two convs
  int nbuf;     // frame buffers per warpgroup: 1 when r*h overwrites h in place
  int padb;     // bytes of one frame buffer
  int hsb;      // bytes of a frame's h_{t-1}, staged in f32
  int wxb;      // bytes of its wx, staged in bf16
  int stages;   // weight ring depth
};

__host__ __device__ inline GGeo make_ggeo(int H, int W, int U) {
  GGeo q;
  q.H = H;
  q.W = W;
  q.Wp = W + 2;
  q.U = U;
  q.frames = q.batch = 0;
  q.mt = (H * q.Wp + 63) / 64;
  q.R = 64 * q.mt + 2 * q.Wp + 2;
  q.S = U + 8;
  q.kc = (9 * U + kChunk - 1) / kChunk;
  q.bn1 = n_tile(2 * U);
  q.bn2 = n_tile(U);
  // In place only when one M tile covers the frame and the r columns all
  // lie in the last N tile of the first conv: no K loop reads h after r*h
  // is written.
  q.nbuf = (q.mt == 1 && q.bn1 >= U) ? 1 : 2;
  q.padb = (int)align128((size_t)q.R * q.S * 2);
  q.hsb = (int)align128((size_t)H * W * U * 4);
  q.wxb = (int)align128((size_t)H * W * 3 * U * 2);
  const long long fixed = 1024 + 2LL * (q.nbuf * q.padb + q.hsb + q.wxb) + 64;
  const long long per = 128LL * q.bn1 + 16;  // a stage of the widest tile and its barriers
  const long long s = (kMaxSharedBytes - fixed) / per;
  q.stages = (int)(s > kMaxStages ? kMaxStages : (s < 2 ? 2 : s));
  return q;
}

// the slack to align to 1024, the weight ring, two frames' padded buffers
// and staged h and wx, the ring's barriers and the frames'
__host__ __device__ inline size_t wgmma_smem_bytes(const GGeo& q) {
  return 1024 + (size_t)q.stages * 128 * q.bn1 + 2 * ((size_t)q.nbuf * q.padb + q.hsb + q.wxb) +
         16 * q.stages + 64;
}

// The gates' activations through the fast exponential: sigmoid within ~2
// ulp of 1 / (1 + expf(-x)), tanh(x) = 2 sigmoid(2x) - 1 within ~1e-7
// absolutely (the f32 mode keeps expf and tanhf)
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) { return 2.0f * sigmoid_fast(2.0f * x) - 1.0f; }

// row of interior position p in a padded frame buffer
__device__ __forceinline__ int g_pad_row(const GGeo& q, int p) {
  return (p / q.W + 1) * q.Wp + p % q.W + 1;
}

// position p of row mg of the H x (W+2) output grid; false past the grid
__device__ __forceinline__ bool g_position(const GGeo& q, int mg, int& p) {
  if (mg >= q.H * q.Wp || mg % q.Wp >= q.W) return false;
  p = mg / q.Wp * q.W + mg % q.Wp;
  return true;
}

// One N tile of one 64-row M tile: acc += pad(shifted by tap) x the tile's
// weight chunks, which this warpgroup takes from the ring in step `s` (both
// warpgroups walk the same chunk sequence). A chunk's four k16 steps are one
// commit group, their A fragments loaded before it (two sets, alternating by
// chunk); a chunk's group runs while the next one's fragments load, and its
// stage is released once the group has retired. The products run under
// warpgroup-uniform control flow only (a guard that depends on the thread
// makes ptxas serialize every wgmma): a warpgroup with no frame multiplies
// its buffer anyway, and a step past K = 9U reads a valid row of the buffer
// against the zeros TMA fills past the weights' end.
template <int BN>
__device__ inline void conv_tile(float (&acc)[BN / 2], const __nv_bfloat16* pad, int m,
                                 const GGeo& q, uint8_t* ring, int stage_bytes, uint64_t* full,
                                 uint64_t* empty, int& s) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const __nv_bfloat16* a_lane =
      pad + (size_t)(m * 64 + warp * 16 + (lane & 15)) * q.S + (lane >> 4) * 8;
  const int K = 9 * q.U;
  // the sums stay in their registers while products are in flight
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  // chunk kc with its A fragments in `ak`: load them, issue its four k16
  // steps as one group, retire the chunk before and release its stage
  auto chunk = [&](int kc, uint32_t (&ak)[kChunk / 16][4]) {
    const int st = s % q.stages;
    mbar_wait(&full[st], (s / q.stages) & 1);
    const uint32_t b = smem_u32(ring + (size_t)st * stage_bytes);
#pragma unroll
    for (int j = 0; j < kChunk / 16; ++j) {
      const int k = min(kc * kChunk + j * 16, K - 16);
      const int tap = k / q.U, c = k - tap * q.U;
      ldmatrix_x4(ak[j], a_lane + ((tap / 3) * q.Wp + tap % 3) * q.S + c);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kChunk / 16; ++j) {
      WgmmaRS<BN>::mma(acc, ak[j], desc_sw128(b + 32 * j, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the chunk before has retired: its stage and A set are free
    if (kc > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % q.stages]);
    ++s;
  };
  uint32_t a0[kChunk / 16][4], a1[kChunk / 16][4];
  for (int kc = 0; kc < q.kc; kc += 2) {
    chunk(kc, a0);
    if (kc + 1 < q.kc) chunk(kc + 1, a1);
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(&empty[(s - 1) % q.stages]);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

template <int BN1, int BN2>
__global__ void __launch_bounds__(kWThreads, 1)
    gates_wgmma(const __grid_constant__ CUtensorMap tzr, const __grid_constant__ CUtensorMap tc,
                const __nv_bfloat16* __restrict__ wx, const float* __restrict__ h0,
                const float* __restrict__ ys, float* __restrict__ u_s, float* __restrict__ r_s,
                float* __restrict__ c_s, float* __restrict__ hprev_s, float* __restrict__ rh_s,
                const GGeo q) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kStage = 128 * BN1;  // [BN1 rows][64 K] bf16: the widest tile
  uint8_t* ring = smem;
  uint8_t* pads = ring + (size_t)q.stages * kStage;
  uint8_t* hstage = pads + 2 * (size_t)q.nbuf * q.padb;  // [2][H*W][U] f32
  uint8_t* xstage = hstage + 2 * (size_t)q.hsb;          // [2][H*W][3U] bf16
  uint64_t* full = reinterpret_cast<uint64_t*>(xstage + 2 * (size_t)q.wxb);
  uint64_t* empty = full + q.stages;
  uint64_t* hfull = empty + q.stages;  // [2]: a frame's h has landed
  uint64_t* hfree = hfull + 2;         // [2]: its warpgroup is done with it
  uint64_t* xfull = hfree + 2;         // [2]: the same for the frame's wx
  uint64_t* xfree = xfull + 2;
  const int tid = threadIdx.x;
  const int pairs = (q.frames + 1) / 2;
  const int U = q.U, hw = q.H * q.W;

  if (tid == 0) {
    for (int s = 0; s < q.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(&hfull[w], 1);
      mbar_init(&xfull[w], 1);
      mbar_init(&hfree[w], 4);  // one arrival per warp of the warpgroup
      mbar_init(&xfree[w], 4);
    }
    mbar_init_fence();
  }
  zero_fill(pads, 2 * (size_t)q.nbuf * q.padb);  // borders and tail rows stay zero
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      // the weights: every chunk, in the order the consumers take them
      int s = 0;
      auto load = [&](const CUtensorMap* map, int k0, int n0, int bytes) {
        const int st = s % q.stages;
        mbar_wait(&empty[st], ((s / q.stages) & 1) ^ 1);
        mbar_expect_tx(&full[st], bytes);
        tma_load_2d(ring + (size_t)st * kStage, map, &full[st], k0, n0);
        ++s;
      };
      for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
        for (int m = 0; m < q.mt; ++m)
          for (int n0 = 0; n0 < 2 * U; n0 += BN1)
            for (int kc = 0; kc < q.kc; ++kc) load(&tzr, kc * kChunk, n0, 128 * BN1);
        for (int m = 0; m < q.mt; ++m)
          for (int n0 = 0; n0 < U; n0 += BN2)
            for (int kc = 0; kc < q.kc; ++kc) load(&tc, kc * kChunk, n0, 128 * BN2);
      }
    } else if (tid == kConsumers + 32) {
      // the frames, a pair ahead of the consumers: h_{t-1} of frame
      // fg = t * batch + b (h0[b] for t = 0, else ys[t-1, b]) once the
      // warpgroup's z|r epilogues are done with the last one, wx once its
      // candidate epilogues are
      int i = 0;
      for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x, ++i) {
        for (int w = 0; w < 2; ++w) {
          const int fg = 2 * pair + w;
          if (fg >= q.frames) continue;
          const float* h = fg < q.batch ? h0 + (size_t)fg * hw * U
                                        : ys + (size_t)(fg - q.batch) * hw * U;
          mbar_wait(&hfree[w], (i & 1) ^ 1);
          mbar_expect_tx(&hfull[w], hw * U * 4);
          bulk_load(hstage + (size_t)w * q.hsb, h, hw * U * 4, &hfull[w]);
        }
        for (int w = 0; w < 2; ++w) {
          const int fg = 2 * pair + w;
          if (fg >= q.frames) continue;
          mbar_wait(&xfree[w], (i & 1) ^ 1);
          mbar_expect_tx(&xfull[w], hw * 3 * U * 2);
          bulk_load(xstage + (size_t)w * q.wxb, wx + (size_t)fg * hw * 3 * U, hw * 3 * U * 2,
                    &xfull[w]);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes frame 2 * pair + wg
  const int wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  __nv_bfloat16* hpad = reinterpret_cast<__nv_bfloat16*>(pads + (size_t)wg * q.nbuf * q.padb);
  __nv_bfloat16* rhpad = hpad + (q.nbuf - 1) * (q.padb / 2);
  const float* hs = reinterpret_cast<const float*>(hstage + (size_t)wg * q.hsb);
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(xstage + (size_t)wg * q.wxb);
  int s = 0, i = 0;
  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x, ++i) {
    const int fg = 2 * pair + wg;
    const bool live = fg < q.frames;
    if (live) {
      // h_{t-1}: out as hprev, rounded into the padded buffer
      mbar_wait(&hfull[wg], i & 1);
      const int q4 = U / 4;
      for (int e = wtid; e < hw * q4; e += 128) {
        const int p = e / q4, n = (e - p * q4) * 4;
        const float4 v = *reinterpret_cast<const float4*>(hs + (size_t)p * U + n);
        *reinterpret_cast<float4*>(hprev_s + ((size_t)fg * hw + p) * U + n) = v;
        store4(hpad + (size_t)g_pad_row(q, p) * q.S + n, v);
      }
    }
    named_sync(1 + wg, 128);

    // z|r conv, then u, r and r*h (f32 out, rounded into rhpad); sums at
    // rows 16 warp + lane / 4 (+ 8), columns n0 + 8 j + 2 (lane % 4) (+ 1)
    for (int m = 0; m < q.mt; ++m) {
      for (int n0 = 0; n0 < 2 * U; n0 += BN1) {
        float acc[BN1 / 2];
#pragma unroll
        for (int k = 0; k < BN1 / 2; ++k) acc[k] = 0.0f;
        conv_tile<BN1>(acc, hpad, m, q, ring, kStage, full, empty, s);
        named_sync(1 + wg, 128);  // every warp is done reading h before r*h may replace it
        if (!live) continue;
        if (m == 0 && n0 == 0) mbar_wait(&xfull[wg], i & 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          int p;
          if (!g_position(q, m * 64 + warp * 16 + (lane >> 2) + 8 * half, p)) continue;
          const size_t pos = (size_t)fg * hw + p;
          const __nv_bfloat16* wxp = xs + (size_t)p * 3 * U;
#pragma unroll
          for (int j = 0; j < BN1 / 8; ++j) {
            const int n = n0 + 8 * j + 2 * (lane & 3);
            const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
            const float2 w = load2(wxp + n);
            if (n < U) {
              store2(u_s + pos * U + n, sigmoid_fast(w.x + v0), sigmoid_fast(w.y + v1));
            } else {
              const int nr = n - U;
              const float2 hv = load2(hs + (size_t)p * U + nr);
              const float r0 = sigmoid_fast(w.x + v0), r1 = sigmoid_fast(w.y + v1);
              store2(r_s + pos * U + nr, r0, r1);
              store2(rh_s + pos * U + nr, r0 * hv.x, r1 * hv.y);
              store2(rhpad + (size_t)g_pad_row(q, p) * q.S + nr, r0 * hv.x, r1 * hv.y);
            }
          }
        }
      }
    }
    // this warp is done with the staged h: the next pair's may land
    __syncwarp();
    if (live && lane == 0) mbar_arrive(&hfree[wg]);
    named_sync(1 + wg, 128);  // r*h is complete

    // candidate conv, then c
    for (int m = 0; m < q.mt; ++m) {
      for (int n0 = 0; n0 < U; n0 += BN2) {
        float acc[BN2 / 2];
#pragma unroll
        for (int k = 0; k < BN2 / 2; ++k) acc[k] = 0.0f;
        conv_tile<BN2>(acc, rhpad, m, q, ring, kStage, full, empty, s);
        if (!live) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          int p;
          if (!g_position(q, m * 64 + warp * 16 + (lane >> 2) + 8 * half, p)) continue;
          const size_t pos = (size_t)fg * hw + p;
          const __nv_bfloat16* wxp = xs + (size_t)p * 3 * U + 2 * U;
#pragma unroll
          for (int j = 0; j < BN2 / 8; ++j) {
            const int n = n0 + 8 * j + 2 * (lane & 3);
            const float2 w = load2(wxp + n);
            store2(c_s + pos * U + n, tanh_fast(w.x + acc[4 * j + 2 * half]),
                   tanh_fast(w.y + acc[4 * j + 2 * half + 1]));
          }
        }
      }
    }
    // this warp is done with the staged wx
    __syncwarp();
    if (live && lane == 0) mbar_arrive(&xfree[wg]);
    named_sync(1 + wg, 128);  // every warp is done with r*h before the next frame's h
  }
}

template <int BN1, int BN2>
cudaError_t launch_wgmma(const void* wx, const float* h0, const float* ys, const void* wzr,
                         const void* wc, float* u, float* r, float* c, float* hprev, float* rh,
                         const GGeo& q, cudaStream_t stream) {
  CUtensorMap tzr, tc;
  const uint64_t K = 9 * (uint64_t)q.U;
  if (!encode_2d(&tzr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wzr, K, 2 * q.U, K * 2, kChunk, BN1,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&tc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wc, K, q.U, K * 2, kChunk, BN2,
                 CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = wgmma_smem_bytes(q);
  cudaError_t err = cudaFuncSetAttribute(
      gates_wgmma<BN1, BN2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  const int pairs = (q.frames + 1) / 2;
  gates_wgmma<BN1, BN2><<<pairs < sms ? pairs : sms, kWThreads, smem, stream>>>(
      tzr, tc, static_cast<const __nv_bfloat16*>(wx), h0, ys, u, r, c, hprev, rh, q);
  return cudaGetLastError();
}

// ---------------------------------------------------------- f32: scalar

constexpr int kFThreads = 256;

__host__ __device__ inline size_t f32_smem_bytes(const Grid& g, int U) {
  return 2 * pad_bytes(g, U, 4);  // hpad and rhpad of one frame
}

// scalar FMAs, one thread per (valid position, column pair); w is the plain
// [9K][N] weight in global memory
template <typename Epi>
__device__ inline void conv_f32(const float* __restrict__ pad, int K,
                                const float* __restrict__ w, int N, const Grid& g, Epi epi) {
  const int S = pad_stride(K), hw = g.H * g.W, half = N / 2;
  for (int i = threadIdx.x; i < hw * half; i += blockDim.x) {
    const int n = (i % half) * 2, p = i / half;
    const int m = out_row(g, p);
    float s0 = 0.0f, s1 = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* a = pad + (size_t)(m + (tap / 3) * g.Wp + tap % 3) * S;
      const float* wt = w + (size_t)tap * K * N + n;
      for (int k = 0; k < K; ++k) {
        const float2 wv = __ldg(reinterpret_cast<const float2*>(wt + (size_t)k * N));
        s0 = fmaf(a[k], wv.x, s0);
        s1 = fmaf(a[k], wv.y, s1);
      }
    }
    epi(p, n, s0, s1);
  }
}

__global__ void __launch_bounds__(kFThreads, 2)
    gates_f32(const float* __restrict__ wx, const float* __restrict__ h0,
              const float* __restrict__ ys, const float* __restrict__ wzr,
              const float* __restrict__ wc, float* __restrict__ u_s, float* __restrict__ r_s,
              float* __restrict__ c_s, float* __restrict__ hprev_s, float* __restrict__ rh_s,
              int batch, int U, Grid g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int fg = blockIdx.x;
  const int hw = g.H * g.W, S = pad_stride(U);
  float* hpad = reinterpret_cast<float*>(smem);
  float* rhpad = hpad + pad_bytes(g, U, 4) / 4;
  const float* h = fg < batch ? h0 + (size_t)fg * hw * U : ys + (size_t)(fg - batch) * hw * U;

  zero_fill(smem, f32_smem_bytes(g, U));
  __syncthreads();
  const int q4 = U / 4;
  for (int i = threadIdx.x; i < hw * q4; i += blockDim.x) {
    const int p = i / q4, n = i % q4 * 4;
    const float4 v = *reinterpret_cast<const float4*>(h + (size_t)p * U + n);
    *reinterpret_cast<float4*>(hprev_s + ((size_t)fg * hw + p) * U + n) = v;
    store4(hpad + (size_t)pad_row(g, p) * S + n, v);
  }
  __syncthreads();

  conv_f32(hpad, U, wzr, 2 * U, g, [&](int p, int n, float v0, float v1) {
    const size_t pos = (size_t)fg * hw + p;
    const float* wxp = wx + pos * 3 * U;
    if (n < U) {
      store2(u_s + pos * U + n, sigmoid(wxp[n] + v0), sigmoid(wxp[n + 1] + v1));
    } else {
      const int nr = n - U;
      const float2 hv = load2(h + (size_t)p * U + nr);
      const float r0 = sigmoid(wxp[U + nr] + v0), r1 = sigmoid(wxp[U + nr + 1] + v1);
      store2(r_s + pos * U + nr, r0, r1);
      store2(rh_s + pos * U + nr, r0 * hv.x, r1 * hv.y);
      store2(rhpad + (size_t)pad_row(g, p) * S + nr, r0 * hv.x, r1 * hv.y);
    }
  });
  __syncthreads();
  conv_f32(rhpad, U, wc, U, g, [&](int p, int n, float v0, float v1) {
    const size_t pos = (size_t)fg * hw + p;
    const float* wxc = wx + pos * 3 * U + 2 * U;
    store2(c_s + pos * U + n, tanhf(wxc[n] + v0), tanhf(wxc[n + 1] + v1));
  });
}

bool valid(int U, int H, int W, int elem_bytes) {
  return U >= 16 && U % 16 == 0 && H >= 1 && W >= 1 && (elem_bytes == 2 || elem_bytes == 4);
}

}  // namespace

extern "C" {

// Shared memory one CTA needs; elem_bytes is 2 (bf16) or 4 (f32).
size_t convgru_bwd_gates_smem_bytes(int H, int W, int U, int elem_bytes) {
  if (elem_bytes == 2) return wgmma_smem_bytes(make_ggeo(H, W, U));
  return f32_smem_bytes(make_grid(H, W), U);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int frames = steps * batch;
  if (elem_bytes == 4) {
    const Grid g = make_grid(H, W);
    const size_t smem = f32_smem_bytes(g, U);
    if (smem > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
    cudaError_t err =
        cudaFuncSetAttribute(gates_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gates_f32<<<frames, kFThreads, smem, s>>>(
        static_cast<const float*>(wx), h0, ys, static_cast<const float*>(wzr),
        static_cast<const float*>(wc), u, r, c, hprev, rh, batch, U, g);
    return (int)cudaGetLastError();
  }
  GGeo q = make_ggeo(H, W, U);
  q.frames = frames;
  q.batch = batch;
  if (wgmma_smem_bytes(q) > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  cudaError_t (*fn)(const void*, const float*, const float*, const void*, const void*, float*,
                    float*, float*, float*, float*, const GGeo&, cudaStream_t) = nullptr;
  switch (q.bn2) {
    case 16: fn = launch_wgmma<32, 16>; break;
    case 32: fn = launch_wgmma<64, 32>; break;
    case 64: fn = launch_wgmma<128, 64>; break;
    default: fn = launch_wgmma<128, 128>; break;
  }
  return (int)fn(wx, h0, ys, wzr, wc, u, r, c, hprev, rh, q, s);
}

}  // extern "C"
