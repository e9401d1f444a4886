// Kernel M1: a bf16 matrix product with f32 sums, for Hopper (sm_90a):
// the dense layers' products (`ops/layers.matmul_f32` in bf16 on the card),
// forward and backward.
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA
// (`jnp.dot(..., preferred_element_type=f32)` with bf16 operands). The
// port multiplied f32 copies of the bf16-rounded operands on the CUDA
// cores, since every bf16 x bf16 product is exact in f32. The tensor cores
// compute the same products, but a wgmma chain adds them into its f32
// accumulator with truncated alignment: over K = 7,203 terms its relative
// error reached 24x an f32 GEMM's (7.7e-6 against 3.2e-7, cuBLAS's bf16
// GEMM with f32 output, PERF.md). So this kernel sums each 64-deep block of
// K on the tensor cores from zero (the first wgmma's scale-d = 0) and adds
// the block into a separate f32 sum with ordinary round-to-nearest adds:
// the tensor cores' error then covers 64 terms, not K.
//
//   C[m, n] = sum over segments s, over r < R of A_s[m, r] * B_s[r, n]
//
// Each operand is a 3-D view (inner, t, outer) of a bf16 tensor, read by
// TMA in 64 x 128 (K-major) or 64 x 64 (MN-major, one 128-byte swizzle
// atom wide) boxes with 128B swizzle. Segment s reads plane t = s of the
// operands whose t follows the segment, plane 0 of the others; segments
// run from the last to the first, so the backward's three bf16 terms of
// an f32 cotangent (lo, mid, hi: `layers.split_bf16`) are summed smallest
// first. The three uses (`ops/kernels/gemm.py`):
//   forward   A = a [M, K] (K-major), B = w [K, N] (MN-major), 1 segment;
//   input     A = terms [M, 3, N] (K-major, t = term), B = w (K-major
//             as w^T), 3 segments over R = N;
//   weight    A = a (MN-major as a^T), B = terms (MN-major, t = term),
//             3 segments over R = M.
//
// Design: a CTA owns a 128 x 128 tile of C: two consumer warpgroups of 64
// rows, each running wgmma m64n64k16 on both 64-column halves of B, A and
// B from shared memory; one producer thread keeps a ring of kStages
// stages of A and B boxes in flight (full / empty mbarriers). grid.z
// splits the blocks of R (split-K) where the tiles alone would leave SMs
// idle; each slice writes its own f32 partial (the wrapper adds them in
// order), so two calls give the same bits.
//
// Bound on an H100 SXM: operations (989 TFLOP/s) for the cascade's
// products: fc1 7203 -> 4802 over 1,176 rows is 81 GFLOP a product (82 us)
// against 89 MB (27 us).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace rgpc;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStages = 5;
constexpr int kTileBytes = kBM * kBK * 2;           // an A or B stage, 16 KB
constexpr int kAtomBytes = 64 * kBK * 2;            // a 64 x 64 box, 8 KB
constexpr int kThreads = 384;                       // 2 consumer + 1 producer warpgroups
constexpr size_t kSmem = 1024 + (size_t)kStages * 2 * kTileBytes + 16 * kStages;

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], both from shared memory, bf16 ->
// f32; the transpose bits select MN-major operands, `accumulate` 0 starts
// D from zero
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss_64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A descriptor of the 64 x 16 slice (k16 step s) of a 64-row K-major box
// (rows of 64 bf16 of K, 128 bytes) or of a 64-wide MN-major box (rows of
// K, 64 bf16 of M or N each) at shared address `base`
template <int kTrans>
__device__ __forceinline__ uint64_t slice_desc(uint32_t base, int s) {
  return kTrans ? desc_sw128(base + s * 16 * 128, 1024, 1024) : desc_sw128(base + s * 32, 16, 1024);
}

struct Plan {
  int mo, no;       // C's rows and columns
  long long ldc;    // C's row stride (elements)
  int blocks;       // blocks of kBK per segment: ceil(R / kBK)
  int segs;         // segments (1 or 3)
  int a_seg, b_seg; // whether the operand's plane follows the segment
};

template <int kTransA, int kTransB>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                     float* __restrict__ c, const Plan p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* tiles = smem;  // [kStages][A tile, B tile]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)kStages * 2 * kTileBytes);
  uint64_t* empty = full + kStages;

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int total = p.segs * p.blocks;
  const int first = (int)((long long)total * blockIdx.z / gridDim.z);
  const int count = (int)((long long)total * (blockIdx.z + 1) / gridDim.z) - first;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warpgroup: one thread issues every load
    if (tid == 256) {
      for (int i = 0; i < count; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(&empty[st], ((i / kStages) - 1) & 1);
        const int blk = first + i;
        const int seg = p.segs - 1 - blk / p.blocks;  // the last segment first
        const int r0 = (blk % p.blocks) * kBK;
        uint8_t* a = tiles + (size_t)st * 2 * kTileBytes;
        uint8_t* b = a + kTileBytes;
        mbar_expect_tx(&full[st], 2 * kTileBytes);
        const int at = p.a_seg ? seg : 0, bt = p.b_seg ? seg : 0;
        if (kTransA) {
          tma_load_3d(a, &ta, &full[st], m0, at, r0);
          tma_load_3d(a + kAtomBytes, &ta, &full[st], m0 + 64, at, r0);
        } else {
          tma_load_3d(a, &ta, &full[st], r0, at, m0);
        }
        if (kTransB) {
          tma_load_3d(b, &tb, &full[st], n0, bt, r0);
          tma_load_3d(b + kAtomBytes, &tb, &full[st], n0 + 64, bt, r0);
        } else {
          tma_load_3d(b, &tb, &full[st], r0, bt, n0);
        }
      }
    }
    return;
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float sum[2][32], acc[2][32];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 32; ++e) sum[j][e] = acc[j][e] = 0.0f;
  }
  for (int i = 0; i < count; ++i) {
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    const uint32_t a = smem_u32(tiles + (size_t)st * 2 * kTileBytes) + wg * kAtomBytes;
    const uint32_t b = smem_u32(tiles + (size_t)st * 2 * kTileBytes + kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s) {
      const uint64_t da = slice_desc<kTransA>(a, s);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wgmma_ss_64<kTransA, kTransB>(acc[j], da, slice_desc<kTransB>(b + j * kAtomBytes, s),
                                      s > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(acc[j][e])::"memory");
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    // this block's sums, added to the running f32 sums
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 32; ++e) sum[j][e] += acc[j][e];
    }
  }

  // rows m0 + 64 wg + 16 warp + lane / 4 (+ 8), columns n0 + 64 j + 8 q +
  // 2 (lane % 4) (+ 1) of this slice's C
  float* out = c + (size_t)blockIdx.z * p.mo * p.ldc;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * half;
    if (row >= p.mo) continue;
    float* dst = out + (size_t)row * p.ldc;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = n0 + 64 * j + 8 * q + 2 * (lane & 3);
        if (col < p.no) dst[col] = sum[j][4 * q + 2 * half];
        if (col + 1 < p.no) dst[col + 1] = sum[j][4 * q + 2 * half + 1];
      }
    }
  }
}

// A 3-D map (inner, planes, outer) over a bf16 tensor, element strides
// tstride and ostride, boxes of 64 inner by `box_outer` outer, 128B swizzle
bool encode_3d(CUtensorMap* map, const void* base, uint64_t inner, uint64_t planes,
               uint64_t outer, uint64_t tstride, uint64_t ostride, uint32_t box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {inner, planes, outer};
  const cuuint64_t strides[2] = {tstride * 2, ostride * 2};
  const cuuint32_t box[3] = {64, 1, box_outer};
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kTransA, int kTransB>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb, float* c, const Plan& p,
                   int splits, cudaStream_t stream) {
  auto kernel = gemm_bf16_kernel<kTransA, kTransB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.no + kBN - 1) / kBN, (p.mo + kBM - 1) / kBM, splits);
  kernel<<<grid, kThreads, kSmem, stream>>>(ta, tb, c, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// C (f32; `splits` slices of [mo][ldc], one per split of R's blocks) =
// sum over segments of A_s B_s. Operand X (A or B) is the bf16 tensor at
// x with dims (x_inner, x_planes, x_outer), element strides x_tstride and
// x_ostride (each a multiple of 8), K-major (trans 0: inner along R,
// outer along C's rows or columns) or MN-major (trans 1: inner along C's
// rows or columns, outer along R); x_seg 1 reads plane s in segment s.
// R is the reduction's length per segment. Returns the launch's error
// code (0 = ok).
int gemm_bf16(const void* a, long long a_inner, long long a_planes, long long a_outer,
              long long a_tstride, long long a_ostride, int a_trans, int a_seg, const void* b,
              long long b_inner, long long b_planes, long long b_outer, long long b_tstride,
              long long b_ostride, int b_trans, int b_seg, float* c, int mo, int no,
              long long ldc, long long r, int segs, int splits, void* stream) {
  if (mo < 1 || no < 1 || r < 1 || segs < 1 || splits < 1 || (a_tstride | a_ostride) % 8 ||
      (b_tstride | b_ostride) % 8 || ((uintptr_t)a | (uintptr_t)b) % 16 ||
      !((a_trans == 0 && b_trans == 1) || (a_trans == 0 && b_trans == 0) ||
        (a_trans == 1 && b_trans == 1))) {
    return (int)cudaErrorInvalidValue;
  }
  Plan p;
  p.mo = mo;
  p.no = no;
  p.ldc = ldc;
  p.blocks = (int)((r + kBK - 1) / kBK);
  p.segs = segs;
  p.a_seg = a_seg;
  p.b_seg = b_seg;
  if (splits > segs * p.blocks) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!encode_3d(&ta, a, a_inner, a_planes, a_outer, a_tstride, a_ostride, a_trans ? 64 : kBM) ||
      !encode_3d(&tb, b, b_inner, b_planes, b_outer, b_tstride, b_ostride, b_trans ? 64 : kBN)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a_trans) {
    err = launch<1, 1>(ta, tb, c, p, splits, s);
  } else if (b_trans) {
    err = launch<0, 1>(ta, tb, c, p, splits, s);
  } else {
    err = launch<0, 0>(ta, tb, c, p, splits, s);
  }
  return (int)err;
}

}  // extern "C"
