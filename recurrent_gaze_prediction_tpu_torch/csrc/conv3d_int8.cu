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
// version (ops/kernels/conv3d_int8.py) agree bit for bit. The int32 sums are
// exact in any order (|acc| <= 127 * 127 * 13824 < 2^31), so the summation
// order below is free.
//
// Layouts: x is [N, D, H, W, Cin] int8 (NDHWC, contiguous); the weights are
// packed once at quantize time as [Cout, K] int8 rows in (tap, ci) order,
// tap = (kd * 3 + kh) * 3 + kw: k = tap * Cin + ci for Cin a multiple of 64
// (K = 27 * Cin); for Cin <= 4 (conv1a) each tap's channels fill one 32-bit
// word, zero-padded, k = tap * 4 + ci, and K = 108 is padded to 128. The
// output is [N, D, H, W, Cout], int8 or f32.
//
// The M tile of both paths is a box of 128 output positions bd x bh x bw in
// one clip, chosen per layer shape by the wrapper (`tile_plan`: least waste
// past the volume, then the smallest halo). Rows of the box past the volume
// are computed and never stored.
//
// Bound on an H100 SXM (1,979 TOP/s dense int8, 3.35 TB/s): the tower's
// eight layers are 77.0 GOP per 16x112x112 clip against ~27 MB of int8
// activations moved, so operations bound conv2a..conv5b, and bytes bound
// conv1a, which writes 12.8 MB per clip (reads 0.6 MB) for 2.08 GOP.
//
// conv2a..conv5b (Cin a multiple of 64): an implicit GEMM on wgmma fed by
// TMA. M = the box's 128 positions, N = BN output channels (256 where Cout
// allows, else 128 or 64), K = 27 * Cin walked a (tap, channel chunk) at a
// time, BK = 128 bytes (64 for Cin = 64). For each K step one TMA tiled load
// brings the 5-D box [1, bd, bh, bw, BK] of x at (n, d0+kd-1, h0+kh-1,
// w0+kw-1, c0): the tensor map's out-of-range fill writes zeros for
// coordinates outside the volume, negative ones included, which is exactly
// SAME padding and the ragged edge, so the kernel does no gather arithmetic
// and no masking on loads. A second TMA load brings the [BN, BK] slice of
// the packed weights. Both land 128B- (or 64B-) swizzled, the K-major layout
// `wgmma` reads through shared-memory descriptors. One producer warp keeps
// the loads in flight through an mbarrier ring (full/empty per stage); two
// consumer warpgroups, 64 rows each, run wgmma.mma_async m64nBNk32 s8 x s8
// -> s32 with the sums in registers, keep one group in flight, and release
// a stage when its group retires. The CTA is 288 threads: at BN = 256 one
// per SM (4 stages of 48 KB), below that two per SM, so one CTA's epilogue
// overlaps the other's products. The epilogue stages the box's rows in
// shared memory (over the retired ring) and writes each position's BN
// outputs with 16-byte stores, consecutive threads on consecutive bytes.
// Past the products, what these layers pay for is the epilogue, which at
// one CTA per SM nothing overlaps: so it reads the tile's alpha and bias
// from shared memory, and requantizes without a division or a conversion
// instruction (`Requant`).
//
// conv1a (Cin <= 4, K = 128) would be byte-bound (the 2 GB it writes at 160
// clips), but in practice its epilogue, run on 2 G outputs, takes the most
// time. So the design keeps everything else small and off the memory bus. A persistent CTA keeps its 64 channels' weights in
// registers as mma fragments, stages each box's halo (bd+2) x (bh+2) x
// (bw+2) once in shared memory, one 32-bit word per position (the channels
// and a zero), and fetches the next box's halo into registers while it
// computes the current one. An A fragment register of mma.sync.m16n8k32 is
// 4 consecutive K bytes of a row, i.e. one tap's word, so fragments are
// read straight from the halo (no A tile is built); taps past 26 meet zero
// weights. Its sums stay below 2^22, so they convert to float exactly on
// the FP32 pipe. The outputs go through shared memory to 16-byte stores, a
// box row of bw positions being one contiguous run of bw * 64 bytes.

#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, the encoder, wgmma fence / commit / wait

using namespace rgpc;

namespace {

constexpr int kBoxRows = 128;  // the M tile: one box of output positions

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// 1.5 * 2^23: adding it to a float in [-2^22, 2^22] rounds that float to an
// integer (ulp 1, ties to even), which its low mantissa bits then hold
constexpr float kMagic = 12582912.f;
constexpr int kMagicBits = 0x4B400000;

// The epilogue of one output: dequant, bias, relu; `alpha` = xscale * wscale.
// kSmall: |acc| < 2^22 (the halo route: 108 products of 127 * 127), so
// float(acc) is exact through the magic number, on the FP32 pipe instead
// of the quarter-rate conversion one; it equals __int2float_rn(acc).
template <bool kSmall = false>
__device__ __forceinline__ float dequant_relu(int acc, float alpha, float b) {
  const float a = kSmall ? __fsub_rn(__int_as_float(kMagicBits + acc), kMagic)
                         : __int2float_rn(acc);
  const float v = __fadd_rn(__fmul_rn(a, alpha), b);
  return v > 0.f ? v : 0.f;
}

// The requant step, clip(round_half_even(y / s), +-127) with the division
// correctly rounded (__fdiv_rn), for y = relu(...) >= +0. The division's
// checked fast path refuses a zero dividend (half the outputs: relu), and
// its slow path costs several times the rest of the epilogue, so the
// quotient is first estimated as t = y * r, r = 1/s correctly rounded:
// |t - RN(y / s)| <= 3 * 2^-24 * |y / s|, below 2.3e-5 where t < 127.5.
// With t clipped to 127 (where t >= 127, RN(y / s) rounds to 127 or more,
// which clips to 127), wherever t lies farther than 2e-4 from a
// half-integer, rint(t) is the output. Only the rest (near a tie, or a
// scale outside [1e-30, 1e30]) divides. rint(t) comes from the magic
// number, whose sum with t holds it in its low byte: no conversion
// instruction (a quarter of the FP32 rate on Hopper).
struct Requant {
  float s, r;  // the scale and its reciprocal
  bool fast;

  __device__ __forceinline__ uint32_t exact(float y) const {
    int q = __float2int_rn(__fdiv_rn(y, s));
    q = q > 127 ? 127 : (q < -127 ? -127 : q);
    return (uint32_t)(uint8_t)(int8_t)q;
  }

  // two outputs, packed as the low two bytes: one branch per pair
  __device__ __forceinline__ uint32_t pair(float y0, float y1) const {
    if (fast) {
      const float t0 = fminf(__fmul_rn(y0, r), 127.f), t1 = fminf(__fmul_rn(y1, r), 127.f);
      const float m0 = __fadd_rn(t0, kMagic), m1 = __fadd_rn(t1, kMagic);
      if (fabsf(__fsub_rn(t0, __fsub_rn(m0, kMagic))) < 0.4998f &&
          fabsf(__fsub_rn(t1, __fsub_rn(m1, kMagic))) < 0.4998f) {
        return __byte_perm(__float_as_uint(m0), __float_as_uint(m1), 0x0040);
      }
    }
    return exact(y0) | (exact(y1) << 8);
  }
};

__device__ __forceinline__ Requant make_requant(float scale) {
  return Requant{scale, __frcp_rn(scale), scale >= 1e-30f && scale <= 1e30f};
}

// Writes the two outputs (columns col, col + 1) of one row into the staged
// tile at byte `p`.
template <bool kF32>
__device__ __forceinline__ void stage_pair(uint8_t* p, float y0, float y1, const Requant& rq) {
  if (kF32) {
    *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
  } else {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)rq.pair(y0, y1);
  }
}

// Row pitch in bytes of the staged output tile (bn columns): padded so that
// a warp's pair stores fall on distinct banks, a multiple of 16 for the
// 16-byte reads.
__host__ __device__ constexpr int staged_pitch(int bn, bool f32) {
  return f32 ? (bn + 8) * 4 : bn + 16;
}

// Copies the staged box (kBoxRows rows of `row_bytes`) to the output: 16
// bytes a thread, a row's bytes contiguous at (position * Cout + n0) * esize.
// Rows past the volume are dropped.
__device__ __forceinline__ void store_box(const uint8_t* staged, int pitch, int row_bytes,
                                          uint8_t* __restrict__ out, int esize, int n, int d0,
                                          int h0, int w0, int bh, int bw, int D, int H, int W,
                                          int Cout, int n0, int tid, int nthreads) {
  const int cpr = row_bytes / 16;
  for (int i = tid; i < kBoxRows * cpr; i += nthreads) {
    const int r = i / cpr, piece = i - r * cpr;
    const int rw = r % bw, rh = (r / bw) % bh, rd = r / (bw * bh);
    const int d = d0 + rd, h = h0 + rh, w = w0 + rw;
    if (d < D && h < H && w < W) {
      const long long pos = (((long long)n * D + d) * H + h) * W + w;
      const uint4 v = *reinterpret_cast<const uint4*>(staged + r * pitch + piece * 16);
      *reinterpret_cast<uint4*>(out + (pos * Cout + n0) * esize + piece * 16) = v;
    }
  }
}

// ------------------------------------------------ conv2a..conv5b: wgmma + TMA

constexpr int kConsumers = 256;               // two warpgroups
constexpr int kWgmmaThreads = kConsumers + 32;  // and one producer warp

__host__ __device__ constexpr int stage_bytes(int bn, int bk) { return (kBoxRows + bn) * bk; }

// Ring depth: at BN = 256 one CTA per SM (4 stages of 48 KB); below, two
// CTAs per SM, each within ~100 KB.
__host__ __device__ constexpr int ring_stages(int bn, int bk) {
  return cmin(6, (bn == 256 ? 200 : 100) * 1024 / stage_bytes(bn, bk));
}

// Shared memory before the barriers: the ring, which the staged output
// tile reuses once the ring has retired.
__host__ __device__ constexpr int wgmma_main_bytes(int bn, int bk, bool f32) {
  return cmax(ring_stages(bn, bk) * stage_bytes(bn, bk), kBoxRows * staged_pitch(bn, f32));
}

// the slack to align the ring to 1024 bytes, the ring, its barriers, and
// the tile's alpha and bias (BN floats each)
__host__ __device__ constexpr int wgmma_smem_bytes(int bn, int bk, bool f32) {
  return 1024 + wgmma_main_bytes(bn, bk, f32) + 16 * ring_stages(bn, bk) + 8 * bn;
}

struct Geo {
  int N, D, H, W, Cin, Cout;
  int bd, bh, bw;     // the box
  int nbd, nbh, nbw;  // boxes along d, h, w
  int ntiles;         // Cout / BN
  int nk;             // K steps: 27 * Cin / BK
};

// A wgmma shared-memory descriptor for a K-major tile of BK-byte rows,
// swizzled as TMA wrote it (128B for BK = 128, 64B for BK = 64): start
// address, leading offset 1 (unused when swizzled), 8-row groups 8 * BK
// bytes apart.
template <int BK>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t layout = BK == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(8 * BK / 16) << 32) |
         (layout << 62);
}

// D[64 x N] += A[64 x 32] * B[N x 32]^T, s8 x s8 -> s32, both from shared
// memory; d holds this thread's N / 2 sums (the m64nNk32 fragment).
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(int (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};


template <int BN, int BK, bool kF32>
__global__ void __launch_bounds__(kWgmmaThreads, BN == 256 ? 1 : 2)
    conv3d_int8_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                      const float* __restrict__ wscale, const float* __restrict__ bias,
                      float xscale, float xscale_next, void* __restrict__ out, const Geo g) {
  constexpr int S = ring_stages(BN, BK);
  constexpr int kStage = stage_bytes(BN, BK), kABytes = kBoxRows * BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + wgmma_main_bytes(BN, BK, kF32));
  uint64_t* empty = full + S;
  float* alpha = reinterpret_cast<float*>(empty + S);  // [BN], then bias [BN]

  // this CTA's box and Cout tile; the tiles of one box are neighbours
  int bid = blockIdx.x;
  const int nt = bid % g.ntiles;
  bid /= g.ntiles;
  const int bwi = bid % g.nbw;
  bid /= g.nbw;
  const int bhi = bid % g.nbh;
  bid /= g.nbh;
  const int bdi = bid % g.nbd;
  const int n = bid / g.nbd;
  const int d0 = bdi * g.bd, h0 = bhi * g.bh, w0 = bwi * g.bw, n0 = nt * BN;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: one thread issues every load
    if (tid == kConsumers) {
      const int cpt = g.Cin / BK;  // channel chunks per tap
      for (int s = 0; s < g.nk; ++s) {
        const int st = s % S;
        mbar_wait(&empty[st], ((s / S) & 1) ^ 1);
        uint8_t* a = smem + st * kStage;
        mbar_expect_tx(&full[st], kStage);
        const int tap = s / cpt, c0 = (s - tap * cpt) * BK;
        const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
        tma_load_5d(a, &tx, &full[st], c0, w0 + kw - 1, h0 + kh - 1, d0 + kd - 1, n);
        tma_load_2d(a + kABytes, &tw, &full[st], tap * g.Cin + c0, n0);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the box
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  if (tid < BN) {  // read by the epilogue, after the named barriers below
    alpha[tid] = __fmul_rn(xscale, wscale[n0 + tid]);
    alpha[BN + tid] = bias[n0 + tid];
  }
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  for (int s = 0; s < g.nk; ++s) {
    const int st = s % S;
    mbar_wait(&full[st], (s / S) & 1);
    const uint32_t a = smem_u32(smem + st * kStage) + wg * 64 * BK;
    const uint32_t b = smem_u32(smem + st * kStage + kABytes);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 32; ++k) {
      Wgmma<BN>::mma(acc, smem_desc<BK>(a + 32 * k), smem_desc<BK>(b + 32 * k));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's group has retired: free its stage
    if (s > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % S]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");
  named_sync(1, kConsumers);  // both warpgroups are done with the ring

  // epilogue: row r = 64 wg + 16 warp + lane / 4 (+ 8), columns
  // 8 j + 2 (lane % 4) (+ 1), staged over the ring
  constexpr int kEsize = kF32 ? 4 : 1, kPitch = staged_pitch(BN, kF32);
  const int row = wg * 64 + warp * 16 + (lane >> 2), t = lane & 3;
  const Requant rq = make_requant(xscale_next);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 a = *reinterpret_cast<const float2*>(alpha + col);
    const float2 b = *reinterpret_cast<const float2*>(alpha + BN + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      stage_pair<kF32>(smem + (row + 8 * half) * kPitch + col * kEsize,
                       dequant_relu(acc[4 * j + 2 * half], a.x, b.x),
                       dequant_relu(acc[4 * j + 2 * half + 1], a.y, b.y), rq);
    }
  }
  named_sync(1, kConsumers);
  store_box(smem, kPitch, BN * kEsize, static_cast<uint8_t*>(out), kEsize, n, d0, h0, w0, g.bh,
            g.bw, g.D, g.H, g.W, g.Cout, n0, tid, kConsumers);
}

// ------------------------------------------------ conv1a: halo tile + mma.sync

constexpr int kHaloThreads = 256;  // 8 warps: 4 row groups of 32 x 2 halves of 32 channels
constexpr int kHaloMax = 512;      // halo words of a box (the wrapper plans within it)
constexpr int kHaloPerThread = kHaloMax / kHaloThreads;

struct HaloGeo {
  int N, D, H, W, Cin, Cout;
  int bd, bh, bw;
  int nbd, nbh, nbw;
  int nboxes;
  int halo;  // (bd + 2) * (bh + 2) * (bw + 2)
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void box_origin(const HaloGeo& g, int box, int& n, int& d0, int& h0,
                                           int& w0) {
  w0 = (box % g.nbw) * g.bw;
  box /= g.nbw;
  h0 = (box % g.nbh) * g.bh;
  box /= g.nbh;
  d0 = (box % g.nbd) * g.bd;
  n = box / g.nbd;
}

// (a, b, c) < 256 each, packed in one register: a thread's fixed halo
// positions and output rows, decoded once per launch
__device__ __forceinline__ int pack3(int a, int b, int c) { return (a << 16) | (b << 8) | c; }
__device__ __forceinline__ int unpack3(int v, int i) { return (v >> (16 - 8 * i)) & 255; }

// This thread's share of a box's halo: its positions p = tid + 256 i at
// halo coordinates hc[i] (packed; -1 past the halo), the Cin channel bytes
// of the input at (d0 - 1, h0 - 1, w0 - 1) + hc[i], zero outside the
// volume, one register per byte: nothing reads them until `pack_word`, so
// the loads stay in flight while the current box is computed.
__device__ __forceinline__ void fetch_halo(const HaloGeo& g, const int8_t* __restrict__ x, int n,
                                           int d0, int h0, int w0,
                                           const int (&hc)[kHaloPerThread],
                                           uint32_t (&bytes)[kHaloPerThread][4]) {
#pragma unroll
  for (int i = 0; i < kHaloPerThread; ++i) {
    const int d = d0 - 1 + unpack3(hc[i], 0), h = h0 - 1 + unpack3(hc[i], 1),
              w = w0 - 1 + unpack3(hc[i], 2);
    const bool inside =
        hc[i] >= 0 && d >= 0 && d < g.D && h >= 0 && h < g.H && w >= 0 && w < g.W;
    const int8_t* src =
        x + (inside ? ((((long long)n * g.D + d) * g.H + h) * g.W + w) * g.Cin : 0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // volatile: the compiler may not sink the load past the mma asm
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\nmov.u32 %0, 0;\n"
          "@p ld.global.nc.u8 %0, [%1];\n}\n"
          : "=r"(bytes[i][c])
          : "l"(src + c), "r"((int)(inside && c < g.Cin)));
    }
  }
}

__device__ __forceinline__ uint32_t pack_word(const uint32_t (&b)[4]) {
  return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
}

template <bool kF32>
__global__ void __launch_bounds__(kHaloThreads, 2)
    conv3d_int8_halo(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ wscale, const float* __restrict__ bias,
                     float xscale, float xscale_next, void* __restrict__ out, const HaloGeo g) {
  constexpr int kEsize = kF32 ? 4 : 1, kPitch = staged_pitch(64, kF32);
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* halo = reinterpret_cast<uint32_t*>(smem);  // [2][g.halo]
  uint8_t* staged = smem + ((2 * g.halo * 4 + 15) & ~15);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int rg = warp & 3, nh = warp >> 2;  // rows [32 rg, 32 rg + 32), channels [32 nh, +32)
  const int n0 = blockIdx.y * 64;
  const int hw = g.bw + 2, hhw = (g.bh + 2) * hw;
  const Requant rq = make_requant(xscale_next);

  // B fragments of this warp's 32 channels over all of K = 128, for the
  // whole launch: b0 = k 4t..4t+3, b1 = k 16+4t.., column g of each n8 tile
  uint32_t bf[4][4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int8_t* p = w + (long long)(n0 + nh * 32 + ni * 8 + gq) * 128 + 4 * t;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      bf[ni][kc][0] = __ldg(reinterpret_cast<const uint32_t*>(p + kc * 32));
      bf[ni][kc][1] = __ldg(reinterpret_cast<const uint32_t*>(p + kc * 32 + 16));
    }
  }
  float alpha[4][2], bb[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n0 + nh * 32 + ni * 8 + 2 * t + e;
      alpha[ni][e] = __fmul_rn(xscale, __ldg(wscale + c));
      bb[ni][e] = __ldg(bias + c);
    }
  }
  // halo offsets of this thread's taps kc * 8 + t (a0, a1) and kc * 8 + 4 + t
  // (a2, a3); a tap past 26 reads any word (its weights are zero)
  int toff[4][2];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int tap = min(kc * 8 + e * 4 + t, 26);
      toff[kc][e] = ((tap / 9) * (g.bh + 2) + (tap / 3) % 3) * hw + tap % 3;
    }
  }
  // halo offsets of this thread's rows 32 rg + 16 mt + g (+ 8)
  int rbase[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = rg * 32 + mt * 16 + gq + 8 * e;
      rbase[mt][e] = (r / (g.bw * g.bh)) * hhw + ((r / g.bw) % g.bh) * hw + r % g.bw;
    }
  }

  // this thread's halo positions and the rows of its output chunks
  int hc[kHaloPerThread];
#pragma unroll
  for (int i = 0; i < kHaloPerThread; ++i) {
    const int p = tid + i * kHaloThreads;
    hc[i] = p < g.halo ? pack3(p / hhw, (p % hhw) / hw, p % hw) : -1;
  }
  constexpr int kChunks = 64 * kEsize / 16;                           // 16-byte chunks a row
  constexpr int kOutPerThread = kBoxRows * kChunks / kHaloThreads;  // 2 or 8
  int orow[kOutPerThread];
#pragma unroll
  for (int k = 0; k < kOutPerThread; ++k) {
    const int r = (tid + k * kHaloThreads) / kChunks;
    orow[k] = pack3(r / (g.bw * g.bh), (r / g.bw) % g.bh, r % g.bw);
  }

  uint32_t bytes[kHaloPerThread][4];
  int box = blockIdx.x;
  int n, d0, h0, w0;
  if (box < g.nboxes) {
    box_origin(g, box, n, d0, h0, w0);
    fetch_halo(g, x, n, d0, h0, w0, hc, bytes);
#pragma unroll
    for (int i = 0; i < kHaloPerThread; ++i) {
      if (tid + i * kHaloThreads < g.halo) halo[tid + i * kHaloThreads] = pack_word(bytes[i]);
    }
  }
  __syncthreads();
  for (int it = 0; box < g.nboxes; box += gridDim.x, ++it) {
    const int next = box + gridDim.x;
    int nn = 0, nd0 = 0, nh0 = 0, nw0 = 0;
    if (next < g.nboxes) {  // in flight while this box is computed
      box_origin(g, next, nn, nd0, nh0, nw0);
      fetch_halo(g, x, nn, nd0, nh0, nw0, hc, bytes);
    }
    const uint32_t* hb = halo + (it & 1) * g.halo;

    // one m16 tile at a time (16 sums live, not 32): products, then epilogue
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      int acc[4][4];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ni][e] = 0;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const uint32_t a[4] = {hb[rbase[mt][0] + toff[kc][0]], hb[rbase[mt][1] + toff[kc][0]],
                               hb[rbase[mt][0] + toff[kc][1]], hb[rbase[mt][1] + toff[kc][1]]};
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[ni], a, bf[ni][kc]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = nh * 32 + ni * 8 + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rg * 32 + mt * 16 + gq + 8 * half;
          stage_pair<kF32>(staged + r * kPitch + col * kEsize,
                           dequant_relu<true>(acc[ni][2 * half], alpha[ni][0], bb[ni][0]),
                           dequant_relu<true>(acc[ni][2 * half + 1], alpha[ni][1], bb[ni][1]),
                           rq);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOutPerThread; ++k) {
      const int i = tid + k * kHaloThreads, r = i / kChunks, piece = i % kChunks;
      const int od = d0 + unpack3(orow[k], 0), oh = h0 + unpack3(orow[k], 1),
                ow = w0 + unpack3(orow[k], 2);
      if (od < g.D && oh < g.H && ow < g.W) {
        const long long pos = (((long long)n * g.D + od) * g.H + oh) * g.W + ow;
        *reinterpret_cast<uint4*>(static_cast<uint8_t*>(out) + (pos * g.Cout + n0) * kEsize +
                                  piece * 16) =
            *reinterpret_cast<const uint4*>(staged + r * kPitch + piece * 16);
      }
    }
    n = nn, d0 = nd0, h0 = nh0, w0 = nw0;
    if (next < g.nboxes) {
      uint32_t* nb = halo + ((it + 1) & 1) * g.halo;
#pragma unroll
      for (int i = 0; i < kHaloPerThread; ++i) {
        if (tid + i * kHaloThreads < g.halo) nb[tid + i * kHaloThreads] = pack_word(bytes[i]);
      }
    }
    __syncthreads();
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

// A tiled map over a uint8 tensor of `rank` dims (innermost first, strides
// in bytes for dims 1..), boxes of `box`, swizzled for wgmma; coordinates
// outside the tensor read as zeros.
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box, int bk) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int BK, bool kF32>
cudaError_t launch_wgmma(const int8_t* x, const int8_t* w, const float* wscale, const float* bias,
                         float xscale, float xscale_next, void* out, const Geo& g, int K,
                         cudaStream_t stream) {
  CUtensorMap tx, tw;
  const cuuint64_t xdims[5] = {(cuuint64_t)g.Cin, (cuuint64_t)g.W, (cuuint64_t)g.H,
                               (cuuint64_t)g.D, (cuuint64_t)g.N};
  const cuuint64_t xstrides[4] = {(cuuint64_t)g.Cin, (cuuint64_t)g.W * g.Cin,
                                  (cuuint64_t)g.H * g.W * g.Cin,
                                  (cuuint64_t)g.D * g.H * g.W * g.Cin};
  const cuuint32_t xbox[5] = {BK, (cuuint32_t)g.bw, (cuuint32_t)g.bh, (cuuint32_t)g.bd, 1};
  const cuuint64_t wdims[2] = {(cuuint64_t)K, (cuuint64_t)g.Cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)K};
  const cuuint32_t wbox[2] = {BK, BN};
  if (!encode(&tx, x, 5, xdims, xstrides, xbox, BK) ||
      !encode(&tw, w, 2, wdims, wstrides, wbox, BK)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = wgmma_smem_bytes(BN, BK, kF32);
  cudaError_t err = cudaFuncSetAttribute(conv3d_int8_wgmma<BN, BK, kF32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)g.N * g.nbd * g.nbh * g.nbw * g.ntiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv3d_int8_wgmma<BN, BK, kF32><<<(unsigned)blocks, kWgmmaThreads, smem, stream>>>(
      tx, tw, wscale, bias, xscale, xscale_next, out, g);
  return cudaGetLastError();
}

template <int BN, int BK>
cudaError_t launch_wgmma(const int8_t* x, const int8_t* w, const float* wscale, const float* bias,
                         float xscale, float xscale_next, int out_f32, void* out, const Geo& g,
                         int K, cudaStream_t stream) {
  return out_f32 ? launch_wgmma<BN, BK, true>(x, w, wscale, bias, xscale, xscale_next, out, g, K,
                                              stream)
                 : launch_wgmma<BN, BK, false>(x, w, wscale, bias, xscale, xscale_next, out, g,
                                               K, stream);
}

template <bool kF32>
cudaError_t launch_halo(const int8_t* x, const int8_t* w, const float* wscale, const float* bias,
                        float xscale, float xscale_next, void* out, const HaloGeo& g,
                        cudaStream_t stream) {
  const auto kernel = conv3d_int8_halo<kF32>;
  const int smem = ((2 * g.halo * 4 + 15) & ~15) + kBoxRows * staged_pitch(64, kF32);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kHaloThreads, smem)) !=
          cudaSuccess) {
    return err;
  }
  // persistent: as many CTAs per Cout tile as fit at once, each walking boxes
  const int tiles = g.Cout / 64;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1) / tiles;
  const int grid_x = (int)(g.nboxes < fit ? g.nboxes : (fit > 0 ? fit : 1));
  conv3d_int8_halo<kF32><<<dim3(grid_x, tiles), kHaloThreads, smem, stream>>>(
      x, w, wscale, bias, xscale, xscale_next, out, g);
  return cudaGetLastError();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Launches one layer on `stream`; returns the launch's error code (0 = ok).
// K is the packed weights' row length: 27 * Cin for Cin a multiple of 64,
// 128 for Cin <= 4. (bd, bh, bw) is the box of 128 output positions, `bn`
// the Cout tile and `stages` the ring depth (the halo's 2 buffers for Cin
// <= 4), as the wrapper planned them (`tile_plan`); a plan this build does
// not compile is refused.
int conv3d_int8(const int8_t* x, const int8_t* w, const float* wscale, const float* bias,
                float xscale, float xscale_next, int out_f32, void* out, int N, int D, int H, int W,
                int Cin, int Cout, int K, int bd, int bh, int bw, int bn, int stages,
                void* stream) {
  const bool small = Cin >= 1 && Cin <= 4;
  if (N < 1 || D < 1 || H < 1 || W < 1 || Cout < 64 || Cout % 64 || bd < 1 || bh < 1 ||
      bw < 1 || bd * bh * bw != kBoxRows) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbd = cdiv(D, bd), nbh = cdiv(H, bh), nbw = cdiv(W, bw);
  if (small) {
    const int halo = (bd + 2) * (bh + 2) * (bw + 2);
    const long long nboxes = (long long)N * nbd * nbh * nbw;
    if (K != 128 || bn != 64 || stages != 2 || halo > kHaloMax || nboxes > 0x7fffffffLL) {
      return (int)cudaErrorInvalidValue;
    }
    const HaloGeo g{N, D, H, W, Cin, Cout, bd, bh, bw, nbd, nbh, nbw, (int)nboxes, halo};
    return (int)(out_f32 ? launch_halo<true>(x, w, wscale, bias, xscale, xscale_next, out, g, st)
                         : launch_halo<false>(x, w, wscale, bias, xscale, xscale_next, out, g,
                                              st));
  }
  const int bk = Cin % 128 == 0 ? 128 : 64;
  if (Cin % 64 || K != 27 * Cin || !(bn == 64 || bn == 128 || bn == 256) || Cout % bn ||
      stages != ring_stages(bn, bk) || bd > 256 || bh > 256 || bw > 256) {
    return (int)cudaErrorInvalidValue;
  }
  const Geo g{N, D, H, W, Cin, Cout, bd, bh, bw, nbd, nbh, nbw, Cout / bn, 27 * Cin / bk};
  cudaError_t err;
  if (bk == 128) {
    err = bn == 256   ? launch_wgmma<256, 128>(x, w, wscale, bias, xscale, xscale_next, out_f32,
                                             out, g, K, st)
          : bn == 128 ? launch_wgmma<128, 128>(x, w, wscale, bias, xscale, xscale_next, out_f32,
                                               out, g, K, st)
                      : launch_wgmma<64, 128>(x, w, wscale, bias, xscale, xscale_next, out_f32,
                                              out, g, K, st);
  } else {
    err = bn == 256   ? launch_wgmma<256, 64>(x, w, wscale, bias, xscale, xscale_next, out_f32,
                                            out, g, K, st)
          : bn == 128 ? launch_wgmma<128, 64>(x, w, wscale, bias, xscale, xscale_next, out_f32,
                                              out, g, K, st)
                      : launch_wgmma<64, 64>(x, w, wscale, bias, xscale, xscale_next, out_f32,
                                             out, g, K, st);
  }
  return (int)err;
}

// CTAs of one launch that fit on an SM at once (the wgmma route for Cin a
// multiple of 64, the halo route with `halo` words for Cin <= 4), or a
// negative error code.
int conv3d_int8_ctas_per_sm(int cin, int bn, int out_f32, int halo) {
  int per_sm = 0;
  cudaError_t err;
  if (cin >= 1 && cin <= 4) {
    const int smem = ((2 * halo * 4 + 15) & ~15) + kBoxRows * staged_pitch(64, out_f32 != 0);
    err = out_f32 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, conv3d_int8_halo<true>, kHaloThreads, smem)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, conv3d_int8_halo<false>, kHaloThreads, smem);
    return err == cudaSuccess ? per_sm : -(int)err;
  }
  if (cin % 64 || !(bn == 64 || bn == 128 || bn == 256)) return -(int)cudaErrorInvalidValue;
#define RGP_Q1_OCCUPANCY(BN, BK, F32)                                                          \
  if (bn == BN && (cin % 128 == 0 ? 128 : 64) == BK && (out_f32 != 0) == F32) {              \
    constexpr int smem = wgmma_smem_bytes(BN, BK, F32);                                      \
    err = cudaFuncSetAttribute(conv3d_int8_wgmma<BN, BK, F32>,                               \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);           \
    if (err == cudaSuccess) {                                                                \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                   \
          &per_sm, conv3d_int8_wgmma<BN, BK, F32>, kWgmmaThreads, smem);                     \
    }                                                                                        \
    return err == cudaSuccess ? per_sm : -(int)err;                                          \
  }
  RGP_Q1_OCCUPANCY(256, 128, false)
  RGP_Q1_OCCUPANCY(256, 128, true)
  RGP_Q1_OCCUPANCY(128, 128, false)
  RGP_Q1_OCCUPANCY(128, 128, true)
  RGP_Q1_OCCUPANCY(64, 128, false)
  RGP_Q1_OCCUPANCY(64, 128, true)
  RGP_Q1_OCCUPANCY(256, 64, false)
  RGP_Q1_OCCUPANCY(256, 64, true)
  RGP_Q1_OCCUPANCY(128, 64, false)
  RGP_Q1_OCCUPANCY(128, 64, true)
  RGP_Q1_OCCUPANCY(64, 64, false)
  RGP_Q1_OCCUPANCY(64, 64, true)
#undef RGP_Q1_OCCUPANCY
  return -(int)cudaErrorInvalidValue;
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
