// A wide ConvGRU on a small grid over its whole sequence, forward and the
// backward's reverse-time recursion, for Hopper (sm_90a): kernel B6.
//
// Replaces no Pallas kernel: the JAX package scans this cell with
// `lax.scan` (the cascade's bottom cell, `models/gaze_grcn_cascade.py`:
// 512 input channels -> U=256 units, 3x3 state convs on the 7x7 grid).
// The cluster kernels B1/B2 keep a CTA's weight slice resident, which at
// U=256 needs 636 KB a CTA; the plain per-step loop, rematerialized,
// dispatched ~40 ops a step forward, recompute and backward and paced the
// train step from the host. Here each direction is one launch.
//
// Per step t (the input-side conv wx is hoisted out and computed by the
// caller over all T*B frames):
//
//   [z|r] = conv(h, [U_z | U_r])             (SAME 3x3, no bias)
//   u = sigmoid(wx_z + z),  r = sigmoid(wx_r + r)
//   c = tanh(wx_c + conv(r * h, U_c))
//   h' = u * h + (1 - u) * c                  -> ys[t]
//
// and the backward's recursion, with dh carried from step to step and the
// gates u, r, c read from what the forward stored (no recompute):
//
//   dh_new = g[t] + dh
//   du_pre = dh_new (h - c) u (1 - u),  da = dh_new (1 - u) (1 - c^2)
//   drh    = conv_T(da, U_c),            dr_pre = drh h r (1 - r)
//   dh     = dh_new u + drh r + conv_T(du_pre, U_z) + conv_T(dr_pre, U_r)
//   dwx[t] = [du_pre | dr_pre | da]
//
// The weight gradients are sums over all frames of per-frame products, so
// they run after the recursion, in parallel over T*B, in phase W
// (convgru_wgrad.cu), from the dwx written here.
//
// Inputs: wx [T,B,H,W,3U] bf16; h0 [B,H,W,U] f32; g [T,B,H,W,U] f32; the
// weights as a stream of 16 KB stages in mma fragment order, one stream a
// CTA's channel slice (ops/kernels/convgru_grid.py::pack_stream). Outputs:
// ys [T,B,H,W,U] f32 and, when training, the gates u, r, c [3][T,B,H,W,U]
// f32; dwx [T,B,H,W,3U] bf16 and dh0 [B,H,W,U] f32.
//
// Numerics rule (ops/kernels/convgru_vjp.py's): the state and all gate math
// are f32; every conv operand (h, r*h, the weights, and the pre-activation
// gradients fed to the transposed convs) is rounded to bf16; products are
// summed in f32 by the tensor cores and the sums are not rounded.
//
// Bound on an H100 SXM at B=28, T=42, U=256 (989 TFLOP/s bf16, 3.35 TB/s):
// each direction's state convs are 2*T*B*49*9U*3U = 204 GFLOP (0.21 ms),
// against wx 88.5 MB + ys 59.0 MB (forward, 44 us): operations bound it.
// In practice the latency of the 84 dependent phases of each direction
// sets the time.
//
// Design. A step is two dependent 3x3 convs as implicit GEMMs of 9U deep:
// the forward's h -> [z|r] (N = 2U) then r*h -> c (N = U); the backward's
// [da|du_pre] -> [drh|dh] (two operands, N = U each) then dr_pre -> dh
// (N = U). The grid splits the rows (batch elements) and the output
// channels: a CTA owns one batch element's 64 output rows (the H x (W+2)
// grid of cluster_conv.cuh, so a tap's rows are one contiguous run of the
// padded operand) and a slice of 64 channels. Its eight warps tile that as
// 2 (rows) x 4 (channels): a warp holds every gate of its 32 rows and 16
// channels in its mma fragments, so all elementwise math stays in
// registers. The CTAs of one batch element (U/64 of them) swap their
// slices of each conv operand through global memory (L2): a CTA writes its
// slice, the group meets at a counter in global memory (`group_sync`), and
// each CTA gathers the whole operand into its padded copy in shared
// memory. The launch is cooperative, so every CTA is resident while the
// others wait for it. At B=28, U=256: 112 CTAs.
//
// Weights. No CTA holds 3.54 MB: each streams its slice (864 KB a step at
// U=256) from L2 through a ring of 16 KB stages filled by bulk copies that
// complete on mbarriers; the last warp to release a stage issues the copy
// of the stage kStages later, so the stream runs ahead across the step's
// barriers (it does not depend on the state). A stage holds, per 8-channel
// tile, the B fragments of mma.m16n8k16 for four k-steps of two weights
// (phase 1) or eight k-steps of one (phase 2): one 16-byte LDS a lane a
// k-step (pair).
//
// A step's two convs take ~77% of its time (a clock64 timeline of the
// forward); they wait on shared-memory reads (the A fragments by ldmatrix,
// the B fragments by LDS) more than on the tensor cores. The 2 x 4 warp
// tiling reads 28 KB a k-step pair of the forward where one warp per 8
// channels over all 64 rows read 38 KB: the backward's recursion ran 1.4x
// slower that way (2.86 against 2.03 ms), the forward alike (~1.95 ms).
//
// The layout timed against it, the grid tiled by two batch elements (128
// rows) by the same slices with grid-wide barriers (half the weight reads
// a step, half the CTAs), took 76-77 us a forward step against 49-50: the
// products wait on shared-memory reads per CTA, which twice the rows a
// CTA doubles.

#include "cluster_conv.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChanWarps = 4;  // warps along the channels
constexpr int kRowWarps = 2;   // warps along the rows
constexpr int kWarps = kChanWarps * kRowWarps;
constexpr int kThreads = kWarps * 32;
constexpr int kTiles = 2;                     // 8-channel tiles a warp owns
constexpr int kSliceTiles = kTiles * kChanWarps;
constexpr int kSlice = 8 * kSliceTiles;       // output channels a CTA owns
constexpr int kMTiles = 4;                    // 16-row tiles: 64 output rows
constexpr int kWarpTiles = kMTiles / kRowWarps;
constexpr int kStageBytes = 16384;
constexpr int kStages = 4;
constexpr size_t kSmemLimit = 232448;

struct GGeo {
  int H, W, Wp, HW, U;
  int S;   // row stride of a padded operand: U + 8 (an odd number of 16 B)
  int R;   // rows of a padded operand
  int kt;  // k-steps (16 channels) a tap
};

__host__ __device__ inline GGeo make_ggeo(int H, int W, int U) {
  GGeo g;
  g.H = H;
  g.W = W;
  g.Wp = W + 2;
  g.HW = H * W;
  g.U = U;
  g.S = U + 8;
  // the last tile of tap (2, 2) reads row 16 kMTiles - 1 + 2 Wp + 2
  g.R = 16 * kMTiles + 2 * g.Wp + 2;
  g.kt = U / 16;
  return g;
}

__host__ __device__ inline size_t pad_bytes(const GGeo& g) {
  return rgpc::align128((size_t)g.R * g.S * sizeof(bf16));
}

// the ring, `pads` padded operands, the ring's barriers and counters
__host__ __device__ inline size_t smem_total(const GGeo& g, int pads) {
  return (size_t)kStages * kStageBytes + pads * pad_bytes(g) + 16 * kStages;
}

// stages a step: phase 1 (two tiles, four k-steps a stage), phase 2 (one
// tile, eight k-steps a stage)
__host__ __device__ inline int phase1_stages(int U) { return 9 * U / 64; }
__host__ __device__ inline int phase2_stages(int U) { return 9 * U / 128; }

// The shapes that are built and tested: U a multiple of 128 (a stage never
// straddles a tap) up to 256, the H x (W+2) output grid within the 64 rows.
bool valid(int T, int B, int H, int W, int U) {
  return T >= 1 && B >= 1 && H >= 1 && W >= 1 && H * (W + 2) <= 16 * kMTiles && U >= 128 &&
         U <= 256 && U % 128 == 0 && smem_total(make_ggeo(H, W, U), 2) <= kSmemLimit;
}

// ------------------------------------------------------------------ ring

// The weight ring. Stage n of the stream (the `per_step` stages of `src`,
// `total` in all) lands in slot n % kStages; `full[slot]` completes when
// its bytes have arrived. Every warp releases every stage it read, counting
// itself in `released[slot]`; the last to do so issues the bulk copy of
// stage n + kStages into the slot. The stream does not depend on the state,
// so the copies run ahead across the step's barriers.
struct Ring {
  uint8_t* base;
  uint64_t* full;
  unsigned* released;
  const uint8_t* src;
  uint32_t per_step, total;
  uint32_t n;  // stages consumed so far

  // One thread: stage k into its slot (the slot's readers are done).
  __device__ __forceinline__ void fill(uint32_t k) const {
    const uint32_t slot = k % kStages;
    rgpc::fence_proxy_async();
    rgpc::mbar_expect_tx(&full[slot], kStageBytes);
    rgpc::bulk_load(base + slot * kStageBytes, src + (size_t)(k % per_step) * kStageBytes,
                    kStageBytes, &full[slot]);
  }

  __device__ __forceinline__ const uint4* acquire() const {
    const uint32_t slot = n % kStages;
    rgpc::mbar_wait(&full[slot], (n / kStages) & 1);
    return reinterpret_cast<const uint4*>(base + slot * kStageBytes);
  }

  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const uint32_t slot = n % kStages;
      __threadfence_block();
      if (atomicAdd(&released[slot], 1u) == kWarps - 1) {
        atomicExch(&released[slot], 0u);
        __threadfence_block();
        if (n + kStages < total) fill(n + kStages);
      }
    }
    ++n;
  }
};

// Set up the ring at the start of a launch: its barriers, its counters and
// the first kStages stages. The whole CTA calls it.
__device__ Ring make_ring(uint8_t* smem_ring, uint64_t* full, const uint8_t* src,
                          uint32_t per_step, uint32_t steps) {
  Ring ring{smem_ring, full, reinterpret_cast<unsigned*>(full + kStages), src, per_step,
            per_step * steps, 0};
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      rgpc::mbar_init(&full[i], 1);
      ring.released[i] = 0;
    }
    rgpc::mbar_init_fence();
    for (uint32_t k = 0; k < kStages && k < ring.total; ++k) ring.fill(k);
  }
  return ring;
}

// ----------------------------------------------------------------- convs

// element offset in a padded operand of k-step ks (tap ks / kt, channels
// 16 (ks % kt) ..) for output row 0
__device__ __forceinline__ int tap_offset(const GGeo& g, int ks) {
  const int tap = ks / g.kt, kk = ks - tap * g.kt;
  return ((tap / 3) * g.Wp + tap % 3) * g.S + kk * 16;
}


// A warp's mma fragments: its row tiles x its channel tiles
using Frags = float[kWarpTiles][kTiles][4];

__device__ __forceinline__ void zero(Frags& acc) {
#pragma unroll
  for (int mt = 0; mt < kWarpTiles; ++mt)
#pragma unroll
    for (int q = 0; q < kTiles; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][q][i] = 0.f;
}

// this warp's first row tile, and this lane's ldmatrix row (lane % 16) and
// 8-channel half (lane / 16), as an element offset in a padded operand
__device__ __forceinline__ int lane_offset(const GGeo& g) {
  const int lane = threadIdx.x & 31;
  return ((threadIdx.x / 32 / kChanWarps) * kWarpTiles * 16 + lane % 16) * g.S + (lane / 16) * 8;
}

// this warp's B fragments of k-step i of a stage: one per channel tile
__device__ __forceinline__ void b_frags(const uint4* stage, int i, uint4 (&b)[kTiles]) {
  const int first = (threadIdx.x / 32 % kChanWarps) * kTiles;
#pragma unroll
  for (int q = 0; q < kTiles; ++q)
    b[q] = stage[(i * kSliceTiles + first + q) * 32 + (threadIdx.x & 31)];
}

// Phase 1: acc0 += conv(a0, W0), acc1 += conv(a1, W1) over 9U on the
// warp's tiles; a0 == a1 in the forward (kSameA).
template <bool kSameA>
__device__ __forceinline__ void conv_pair(Ring& ring, const GGeo& g, const bf16* a0,
                                          const bf16* a1, Frags& acc0, Frags& acc1) {
  const int lo = lane_offset(g);
  const int stages = phase1_stages(g.U);
  for (int st = 0; st < stages; ++st) {
    const uint4* stage = ring.acquire();
    const int base = tap_offset(g, 4 * st) + lo;  // four k-steps of one tap
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 b[kTiles];
      b_frags(stage, i, b);
#pragma unroll
      for (int mt = 0; mt < kWarpTiles; ++mt) {
        const int off = base + mt * 16 * g.S + i * 16;
        uint32_t a[4];
        rgpc::ldmatrix_x4(a, a0 + off);
#pragma unroll
        for (int q = 0; q < kTiles; ++q) rgpc::mma_bf16(acc0[mt][q], a, b[q].x, b[q].y);
        if (!kSameA) rgpc::ldmatrix_x4(a, a1 + off);
#pragma unroll
        for (int q = 0; q < kTiles; ++q) rgpc::mma_bf16(acc1[mt][q], a, b[q].z, b[q].w);
      }
    }
    ring.release();
  }
}

// Phase 2: acc += conv(a, W2) over 9U on the warp's tiles.
__device__ __forceinline__ void conv_one(Ring& ring, const GGeo& g, const bf16* a,
                                         Frags& acc) {
  const int lo = lane_offset(g);
  const int stages = phase2_stages(g.U);
  for (int st = 0; st < stages; ++st) {
    const uint4* stage = ring.acquire();
    const int base = tap_offset(g, 8 * st) + lo;  // eight k-steps of one tap
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 b[kTiles];
      b_frags(stage, i, b);
#pragma unroll
      for (int mt = 0; mt < kWarpTiles; ++mt) {
        const int off = base + mt * 16 * g.S + 32 * i;
        uint32_t x[4];
        rgpc::ldmatrix_x4(x, a + off);
#pragma unroll
        for (int q = 0; q < kTiles; ++q) rgpc::mma_bf16(acc[mt][q], x, b[q].x, b[q].y);
        rgpc::ldmatrix_x4(x, a + off + 16);
#pragma unroll
        for (int q = 0; q < kTiles; ++q) rgpc::mma_bf16(acc[mt][q], x, b[q].z, b[q].w);
      }
    }
    ring.release();
  }
}

// ------------------------------------------------------ state exchange

// This lane's place in its warp's fragments: the pixel of each fragment
// row, 16 (the warp's first row tile + mt) + lane / 4 + 8 half on the H x
// (W+2) grid, or -1 for a row past the grid; the first of its two
// channels in each of the warp's 8-channel tiles.
struct Lane {
  int p[kWarpTiles][2];
  int ch[kTiles];
};

__device__ __forceinline__ Lane lane_of(const GGeo& g, int slice) {
  Lane l;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int first = (warp / kChanWarps) * kWarpTiles;
#pragma unroll
  for (int mt = 0; mt < kWarpTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (first + mt) * 16 + lane / 4 + 8 * half;
      const int y = m / g.Wp, x = m - y * g.Wp;
      l.p[mt][half] = (y < g.H && x < g.W) ? y * g.W + x : -1;
    }
  }
#pragma unroll
  for (int q = 0; q < kTiles; ++q)
    l.ch[q] = slice * kSlice + ((warp % kChanWarps) * kTiles + q) * 8 + 2 * (lane % 4);
  return l;
}

__device__ __forceinline__ int pad_row(const GGeo& g, int p) {
  return (p / g.W + 1) * g.Wp + p % g.W + 1;
}

// Copy one element's [HW][U] bf16 operand, which the CTAs of the group
// wrote, from global memory (through L2: `__ldcg` never reads a stale L1
// line) into the interior rows of a padded operand.
__device__ void gather(bf16* pad, const bf16* src, const GGeo& g) {
  const int chunks = g.U / 8;
  for (int i = threadIdx.x; i < g.HW * chunks; i += kThreads) {
    const int p = i / chunks, c = i - p * chunks;
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src + (size_t)p * g.U) + c);
    *reinterpret_cast<uint4*>(pad + (size_t)pad_row(g, p) * g.S + c * 8) = v;
  }
}

// The same from one element's f32 h0, rounded to bf16.
__device__ void gather_f32(bf16* pad, const float* src, const GGeo& g) {
  const int chunks = g.U / 8;
  for (int i = threadIdx.x; i < g.HW * chunks; i += kThreads) {
    const int p = i / chunks, c = i - p * chunks;
    const float4* s = reinterpret_cast<const float4*>(src + (size_t)p * g.U + c * 8);
    const float4 a = s[0], b = s[1];
    *reinterpret_cast<uint4*>(pad + (size_t)pad_row(g, p) * g.S + c * 8) =
        make_uint4(rgpc::pack_bf16x2(a.x, a.y), rgpc::pack_bf16x2(a.z, a.w),
                   rgpc::pack_bf16x2(b.x, b.y), rgpc::pack_bf16x2(b.z, b.w));
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every CTA of a group past this point sees the global writes each made
// before it: the CTA meets, one thread makes the CTA's writes visible,
// counts the CTA in and waits for the group's count to reach `target` (the
// group's size times the syncs so far). A wait that outlasts ~10 s of
// clocks traps (the launch fails) rather than hang.
__device__ void group_sync(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    const long long start = clock64();
    while (ld_acquire(ctr) < target) {
      if (clock64() - start > 20000000000LL) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// two bf16 packed in a word (the lower first), as f32
__device__ __forceinline__ float2 bf2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// --------------------------------------------------------------- forward

__global__ void __launch_bounds__(kThreads, 1)
    convgru_grid_fwd_kernel(const bf16* __restrict__ wx, const uint8_t* __restrict__ wpack,
                            const float* __restrict__ h0, float* __restrict__ ys,
                            float* __restrict__ gates, bf16* hx, bf16* rhx, unsigned* ctr, int T,
                            int B, int H, int W, int U) {
  extern __shared__ __align__(128) uint8_t smem[];
  const GGeo g = make_ggeo(H, W, U);
  const int slices = U / kSlice;
  const int s = blockIdx.x % slices, b = blockIdx.x / slices;
  bf16* pad = reinterpret_cast<bf16*>(smem + (size_t)kStages * kStageBytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + (size_t)kStages * kStageBytes + pad_bytes(g));
  const int per_step = phase1_stages(U) + phase2_stages(U);

  for (size_t i = threadIdx.x; i < pad_bytes(g) / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(pad)[i] = make_uint4(0, 0, 0, 0);
  Ring ring = make_ring(smem, full, wpack + (size_t)s * per_step * kStageBytes, per_step, T);
  __syncthreads();

  unsigned* group_ctr = ctr + b;
  const unsigned group = slices;
  unsigned syncs = 0;
  const Lane l = lane_of(g, s);
  const size_t HWU = (size_t)g.HW * U, plane = (size_t)T * B * HWU;
  const size_t elem = (size_t)b * HWU;
  Frags h;  // this lane's share of the state, f32
  gather_f32(pad, h0 + elem, g);
#pragma unroll
  for (int mt = 0; mt < kWarpTiles; ++mt)
#pragma unroll
    for (int q = 0; q < kTiles; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = l.p[mt][half];
        const float2 v =
            p >= 0 ? ld2(h0 + elem + (size_t)p * U + l.ch[q]) : make_float2(0.f, 0.f);
        h[mt][q][2 * half] = v.x;
        h[mt][q][2 * half + 1] = v.y;
      }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (t > 0) {
      gather(pad, hx + elem, g);
      __syncthreads();
    }
    // this step's wx at this lane's rows and channels, used after the convs
    uint32_t wxv[kWarpTiles][kTiles][2][3];
#pragma unroll
    for (int mt = 0; mt < kWarpTiles; ++mt)
#pragma unroll
      for (int q = 0; q < kTiles; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = l.p[mt][half];
          const bf16* x = p >= 0 ? wx + (((size_t)t * B + b) * g.HW + p) * 3 * U + l.ch[q] : wx;
#pragma unroll
          for (int gate = 0; gate < 3; ++gate)
            wxv[mt][q][half][gate] =
                p >= 0 ? __ldg(reinterpret_cast<const uint32_t*>(x + gate * U)) : 0u;
        }

    Frags zr, rr;
    zero(zr);
    zero(rr);
    conv_pair<true>(ring, g, pad, pad, zr, rr);

    // u, r; r * h to the group
    Frags u;
#pragma unroll
    for (int mt = 0; mt < kWarpTiles; ++mt)
#pragma unroll
      for (int q = 0; q < kTiles; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = l.p[mt][half], i0 = 2 * half;
          const float2 fz = bf2(wxv[mt][q][half][0]), fr = bf2(wxv[mt][q][half][1]);
          const float u0 = rgpc::sigmoid(fz.x + zr[mt][q][i0]);
          const float u1 = rgpc::sigmoid(fz.y + zr[mt][q][i0 + 1]);
          const float r0 = rgpc::sigmoid(fr.x + rr[mt][q][i0]);
          const float r1 = rgpc::sigmoid(fr.y + rr[mt][q][i0 + 1]);
          u[mt][q][i0] = u0;
          u[mt][q][i0 + 1] = u1;
          if (p < 0) continue;
          const size_t at = elem + (size_t)p * U + l.ch[q];
          rgpc::store2(rhx + at, r0 * h[mt][q][i0], r1 * h[mt][q][i0 + 1]);
          if (gates != nullptr) {
            const size_t gt = (size_t)t * B * HWU + at;
            rgpc::store2(gates + gt, u0, u1);
            rgpc::store2(gates + plane + gt, r0, r1);
          }
        }
    group_sync(group_ctr, ++syncs * group);
    gather(pad, rhx + elem, g);
    __syncthreads();

    Frags cc;
    zero(cc);
    conv_one(ring, g, pad, cc);

    // c, h'; h' to ys and to the group
#pragma unroll
    for (int mt = 0; mt < kWarpTiles; ++mt)
#pragma unroll
      for (int q = 0; q < kTiles; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = l.p[mt][half], i0 = 2 * half;
          const float2 fc = bf2(wxv[mt][q][half][2]);
          const float c0 = tanhf(fc.x + cc[mt][q][i0]);
          const float c1 = tanhf(fc.y + cc[mt][q][i0 + 1]);
          const float u0 = u[mt][q][i0], u1 = u[mt][q][i0 + 1];
          const float h0n = u0 * h[mt][q][i0] + (1.f - u0) * c0;
          const float h1n = u1 * h[mt][q][i0 + 1] + (1.f - u1) * c1;
          h[mt][q][i0] = h0n;
          h[mt][q][i0 + 1] = h1n;
          if (p < 0) continue;
          const size_t at = elem + (size_t)p * U + l.ch[q];
          const size_t gt = (size_t)t * B * HWU + at;
          rgpc::store2(ys + gt, h0n, h1n);
          if (gates != nullptr) rgpc::store2(gates + 2 * plane + gt, c0, c1);
          if (t + 1 < T) rgpc::store2(hx + at, h0n, h1n);
        }
    if (t + 1 < T) group_sync(group_ctr, ++syncs * group);
  }
}

// -------------------------------------------------------------- backward

__global__ void __launch_bounds__(kThreads, 1)
    convgru_grid_bwd_kernel(const uint8_t* __restrict__ wpack, const float* __restrict__ gates,
                            const float* __restrict__ ys, const float* __restrict__ h0,
                            const float* __restrict__ gy, bf16* __restrict__ dwx,
                            float* __restrict__ dh0, bf16* dax, bf16* dux, bf16* drx,
                            unsigned* ctr, int T, int B, int H, int W, int U) {
  extern __shared__ __align__(128) uint8_t smem[];
  const GGeo g = make_ggeo(H, W, U);
  const int slices = U / kSlice;
  const int s = blockIdx.x % slices, b = blockIdx.x / slices;
  bf16* pad_a = reinterpret_cast<bf16*>(smem + (size_t)kStages * kStageBytes);
  bf16* pad_b = pad_a + pad_bytes(g) / sizeof(bf16);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + (size_t)kStages * kStageBytes + 2 * pad_bytes(g));
  const int per_step = phase1_stages(U) + phase2_stages(U);

  for (size_t i = threadIdx.x; i < 2 * pad_bytes(g) / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(pad_a)[i] = make_uint4(0, 0, 0, 0);
  Ring ring = make_ring(smem, full, wpack + (size_t)s * per_step * kStageBytes, per_step, T);
  __syncthreads();

  unsigned* group_ctr = ctr + b;
  const unsigned group = slices;
  unsigned syncs = 0;
  const Lane l = lane_of(g, s);
  const size_t HWU = (size_t)g.HW * U, plane = (size_t)T * B * HWU;
  const size_t elem = (size_t)b * HWU;

  // this lane's values of step t: g, u, r, c, h_{t-1}
  Frags gv, uv, rv, cv, hv;
  auto load_step = [&](int t) {
#pragma unroll
    for (int mt = 0; mt < kWarpTiles; ++mt)
#pragma unroll
      for (int q = 0; q < kTiles; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = l.p[mt][half], i0 = 2 * half;
          float2 x[5] = {};
          if (p >= 0) {
            const size_t at = (size_t)t * B * HWU + elem + (size_t)p * U + l.ch[q];
            x[0] = ld2(gy + at);
            x[1] = ld2(gates + at);
            x[2] = ld2(gates + plane + at);
            x[3] = ld2(gates + 2 * plane + at);
            x[4] = t > 0 ? ld2(ys + at - (size_t)B * HWU)
                         : ld2(h0 + elem + (size_t)p * U + l.ch[q]);
          }
          gv[mt][q][i0] = x[0].x;
          gv[mt][q][i0 + 1] = x[0].y;
          uv[mt][q][i0] = x[1].x;
          uv[mt][q][i0 + 1] = x[1].y;
          rv[mt][q][i0] = x[2].x;
          rv[mt][q][i0 + 1] = x[2].y;
          cv[mt][q][i0] = x[3].x;
          cv[mt][q][i0 + 1] = x[3].y;
          hv[mt][q][i0] = x[4].x;
          hv[mt][q][i0 + 1] = x[4].y;
        }
  };

  Frags dh;
  zero(dh);
  load_step(T - 1);

  for (int t = T - 1; t >= 0; --t) {
    const size_t step = (size_t)t * B * HWU + elem;
    // dh_new; du_pre and da to dwx and to the group
#pragma unroll
    for (int mt = 0; mt < kWarpTiles; ++mt)
#pragma unroll
      for (int q = 0; q < kTiles; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float du[2], da[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * half + e;
            const float dn = gv[mt][q][i] + dh[mt][q][i];
            const float u = uv[mt][q][i], c = cv[mt][q][i];
            du[e] = dn * (hv[mt][q][i] - c) * u * (1.f - u);
            da[e] = dn * (1.f - u) * (1.f - c * c);
            dh[mt][q][i] = dn;
          }
          const int p = l.p[mt][half];
          if (p < 0) continue;
          const size_t at = elem + (size_t)p * U + l.ch[q];
          rgpc::store2(dux + at, du[0], du[1]);
          rgpc::store2(dax + at, da[0], da[1]);
          bf16* d = dwx + (step + (size_t)p * U) * 3 + l.ch[q];  // [t][b][p][3U]
          rgpc::store2(d, du[0], du[1]);
          rgpc::store2(d + 2 * U, da[0], da[1]);
        }
    group_sync(group_ctr, ++syncs * group);
    gather(pad_a, dax + elem, g);
    gather(pad_b, dux + elem, g);
    __syncthreads();

    Frags drh, dc;
    zero(drh);
    zero(dc);
    conv_pair<false>(ring, g, pad_a, pad_b, drh, dc);

    // dr_pre to dwx and to the group; dh_new u + drh r
#pragma unroll
    for (int mt = 0; mt < kWarpTiles; ++mt)
#pragma unroll
      for (int q = 0; q < kTiles; ++q)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float dr[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * half + e;
            const float d = drh[mt][q][i], r = rv[mt][q][i];
            dr[e] = d * hv[mt][q][i] * r * (1.f - r);
            dh[mt][q][i] = dh[mt][q][i] * uv[mt][q][i] + d * r;
          }
          const int p = l.p[mt][half];
          if (p < 0) continue;
          rgpc::store2(drx + elem + (size_t)p * U + l.ch[q], dr[0], dr[1]);
          rgpc::store2(dwx + (step + (size_t)p * U) * 3 + U + l.ch[q], dr[0], dr[1]);
        }
    if (t > 0) load_step(t - 1);  // in flight through the rest of the step
    group_sync(group_ctr, ++syncs * group);
    gather(pad_a, drx + elem, g);
    __syncthreads();

    conv_one(ring, g, pad_a, dc);
#pragma unroll
    for (int mt = 0; mt < kWarpTiles; ++mt)
#pragma unroll
      for (int q = 0; q < kTiles; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) dh[mt][q][i] += dc[mt][q][i];
  }

#pragma unroll
  for (int mt = 0; mt < kWarpTiles; ++mt)
#pragma unroll
    for (int q = 0; q < kTiles; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = l.p[mt][half];
        if (p >= 0)
          rgpc::store2(dh0 + elem + (size_t)p * U + l.ch[q], dh[mt][q][2 * half],
                       dh[mt][q][2 * half + 1]);
      }
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename Kernel>
cudaError_t cooperative(Kernel kernel, int ctas, size_t smem, void** args, cudaStream_t s) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(ctas),
                                    dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one CTA with `pads` padded operands (the forward 1, the
// backward 2).
size_t convgru_grid_smem_bytes(int H, int W, int U, int pads) {
  return smem_total(make_ggeo(H, W, U), pads);
}

// CTAs the card holds at once of the forward (backward = 0) or the
// backward: a cooperative launch takes at most these.
int convgru_grid_max_ctas(int H, int W, int U, int backward) {
  const GGeo g = make_ggeo(H, W, U);
  const size_t smem = smem_total(g, backward ? 2 : 1);
  int per_sm = 0, sms = 0, device = 0;
  if (smem > kSmemLimit || cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  cudaError_t err =
      backward ? prepare(convgru_grid_bwd_kernel, smem) : prepare(convgru_grid_fwd_kernel, smem);
  if (err != cudaSuccess) return 0;
  err = backward ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, convgru_grid_bwd_kernel,
                                                                 kThreads, smem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, convgru_grid_fwd_kernel, kThreads, smem);
  return err == cudaSuccess ? per_sm * sms : 0;
}

// The forward: ys (and, if `gates` is not null, u, r, c) from wx and h0.
// hx, rhx [B,H,W,U] bf16 are the exchange buffers, ctr B zeroed counters:
// a CTA per batch element and 64-channel slice, a group per element.
int convgru_grid_fwd(const void* wx, const void* wpack, const float* h0, float* ys, float* gates,
                     void* hx, void* rhx, unsigned* ctr, int T, int B, int H, int W, int U,
                     void* stream) {
  if (!valid(T, B, H, W, U)) return (int)cudaErrorInvalidValue;
  const bf16* x = static_cast<const bf16*>(wx);
  const uint8_t* w = static_cast<const uint8_t*>(wpack);
  bf16* hxb = static_cast<bf16*>(hx);
  bf16* rhxb = static_cast<bf16*>(rhx);
  void* args[] = {&x, &w, &h0, &ys, &gates, &hxb, &rhxb, &ctr, &T, &B, &H, &W, &U};
  return (int)cooperative(convgru_grid_fwd_kernel, B * (U / kSlice),
                          smem_total(make_ggeo(H, W, U), 1), args,
                          static_cast<cudaStream_t>(stream));
}

// The backward's recursion: dwx (bf16) and dh0 from the forward's gates
// [3][T,B,H,W,U], ys, h0 and the cotangent gy; dax, dux, drx [B,H,W,U]
// bf16 are the exchange buffers, ctr B zeroed counters.
int convgru_grid_bwd(const void* wpack, const float* gates, const float* ys, const float* h0,
                     const float* gy, void* dwx, float* dh0, void* dax, void* dux, void* drx,
                     unsigned* ctr, int T, int B, int H, int W, int U, void* stream) {
  if (!valid(T, B, H, W, U)) return (int)cudaErrorInvalidValue;
  const GGeo g = make_ggeo(H, W, U);
  const uint8_t* w = static_cast<const uint8_t*>(wpack);
  bf16* d = static_cast<bf16*>(dwx);
  bf16 *a = static_cast<bf16*>(dax), *u = static_cast<bf16*>(dux), *r = static_cast<bf16*>(drx);
  void* args[] = {&w, &gates, &ys, &h0, &gy, &d, &dh0, &a, &u, &r, &ctr, &T, &B, &H, &W, &U};
  return (int)cooperative(convgru_grid_bwd_kernel, B * (U / kSlice), smem_total(g, 2), args,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
