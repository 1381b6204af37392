// Fused 1x1-conv product + BatchNorm batch statistics for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel examples/benchmark/fused_conv_stats.py::_kernel
// (launched by fused_matmul_stats): a 1x1 convolution over NHWC activations is
// the product y32 = x . w of x [M = N*H*W, K] and w [K, N], and BatchNorm
// needs the per-column sum and sum of squares of that output. One pass
// computes all three:
//   y  = y32 rounded to x's dtype            [M, N]
//   s1 = sum over rows of y32               [N] fp32
//   s2 = sum over rows of y32 * y32         [N] fp32
// with the product accumulated in fp32 (bf16 x bf16 products are exact in
// fp32, so up to summation order this is the TPU kernel's arithmetic).
//
// The TPU grid walks the M blocks in order on one core and carries the
// column sums in VMEM scratch from block to block. Hopper blocks run in no
// order, so a block owns one N tile and a fixed run of `per_block`
// consecutive 128-row M tiles, carries its column sums across the run, and
// writes one row of fp32 partials per run into a [groups, N] scratch (no
// float atomics: their order, and so the sums' rounding, would change from
// launch to launch). sum_partials_kernel then adds the partials of each
// column in a fixed order, so the result repeats bit for bit.
//
// bf16 (the main path), conv_stats_wgmma_kernel. Bound on an H100 SXM: bytes
// at ResNet-50's shapes with K <= 256 (at (401408, 64, 256): 257 MB, 0.077 ms,
// against 13.2 GFLOP, 0.013 ms), operations at the deep stage-2/3 shapes
// (e.g. (6272, 2048, 512): 13.2 GFLOP, 0.013 ms, against 0.010 ms of bytes).
// So the design reads x once, overlaps every load with the product, and keeps
// the tensor cores fed:
// - 288 threads: two consumer warpgroups (rows 0-63 and 64-127 of the M
//   tile) and one producer warp. The producer's lane 0 issues TMA copies of
//   x tiles [128 rows, 64 K] (128-byte rows, 128B swizzle) into a ring of
//   `stages` buffers with full/empty mbarrier pairs, running ahead across
//   M-tile boundaries, so one tile's epilogue overlaps the next one's loads.
// - BN = 64, 128 or 256 columns by N (ops/fused_conv_stats.py::block_n), so
//   one block covers all of N up to 256 and x is read from device memory
//   once (at N = 512..2048 the 2..8 blocks of one M run read it together,
//   the repeats from L2).
// - w [K, N] has N contiguous: an MN-major B operand (wgmma's transpose-B
//   bit), stored as [64 K rows, 64 N] boxes of 128-byte rows, 128B swizzle.
//   Descriptor: LBO = 8 KB from one 64-column box to the next along N, SBO =
//   1 KB from one 8-row group of K to the next. The block's w tile stays
//   resident in shared memory for the whole run when K x BN x 2 bytes fits
//   beside a ring of at least 3 stages; otherwise each stage carries its w
//   chunk beside the x chunk.
// - Each consumer warpgroup issues wgmma.mma_async m64nBNk16 (bf16 in, fp32
//   accumulate in registers), four per 64-deep K chunk.
// - Epilogue from the accumulator registers: each thread rounds its values
//   to bf16 into a swizzled staging tile that one thread writes out with TMA
//   stores (clipped at M and N by the hardware); in place of the values it
//   keeps the sums of its two rows for each of its columns, Σy and Σy². Three
//   xor shuffles add the 8 lanes that hold the same columns (16 rows), one
//   shared-memory step adds the 8 warps in order (128 rows), and thread c
//   adds column c's tile sum to its running sums. No fp32 tile goes through
//   shared memory. TMA zero-fills loads past M and K, so a padded row adds
//   exactly 0; sums of columns past N are not written.
// - Longest addition chain a product term goes through (the tolerance
//   argument of chip_smoke.py's CONV_STAT_TOL): 1 (its thread's two rows) + 3
//   (shuffles) + 7 (warps) + per_block (the run) + ceil(groups / 32) + 5
//   (sum_partials_kernel): ops/fused_conv_stats.py::chain_length, 45 at
//   (401408, 64, 256), at most 45 at ResNet-50's shapes, 1040 at M = 2^30
//   and 1552 at M = 2^31 - 1 (runs of at most 512 tiles).
//
// fp32 (off the main path): an FMA kernel, conv_stats_fma_kernel, with a
// 64-column N tile, 32-deep K chunks through shared memory, each thread an
// 8 x 4 register tile; the fp32 tile goes through shared memory to an
// epilogue where thread (column, row group) writes 32 rows of y and adds them
// to its column sums.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (autodist_tpu_torch/ops/_build.py). The TMA tensor maps are encoded
// on the host for every call by cuTensorMapEncodeTiled of the CUDA API in
// libcuda, reached with cudaGetDriverEntryPoint (no -lcuda): host work only,
// so a CUDA graph can capture the launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kSumCols = 32;          // columns per block of sum_partials_kernel
constexpr int kSumLanes = 32;         // lanes per column (a 5-level tree)

// ------------------------------------------------------------ fp32: FMA
constexpr int kBM = 128;              // rows of an M tile (both kernels)
constexpr int kFmaBN = 64;            // columns of the FMA kernel's N tile
constexpr int kFmaBK = 32;            // depth of its staged K chunk
constexpr int kFmaThreads = 256;
constexpr int kFmaGroups = kFmaThreads / kFmaBN;     // row groups of the epilogue
constexpr int kFmaRowsPerGroup = kBM / kFmaGroups;   // 32
constexpr int kLdA32 = kFmaBK + 4;    // fp32 row strides in shared memory
constexpr int kLdB32 = kFmaBN + 4;
constexpr int kLdC = kFmaBN + 4;      // the fp32 output tile's row stride
constexpr int kFmaSmemBytes = kBM * kLdC * 4;        // operands and C share it
static_assert((kBM * kLdA32 + kFmaBK * kLdB32) * 4 <= kFmaSmemBytes, "fp32 tiles");

// The [128, 64] fp32 tile x[m0:m0+128, :] . w[:, n0:n0+64] by fp32 FMAs,
// left in smem as float[kBM][kLdC]: thread (ty, tx) owns rows ty*8 ..
// ty*8+7 and columns tx, tx+16, tx+32, tx+48. Ends with a __syncthreads().
__device__ __forceinline__ void fma_tile(const float* __restrict__ x,
                                         const float* __restrict__ w, float* smem, int m0,
                                         int n0, int m, int k, int n) {
  float* sa = smem;                                     // [kBM][kLdA32]
  float* sb = sa + kBM * kLdA32;                        // [kFmaBK][kLdB32]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kFmaBK) {
    // A chunk: 128 x 32 floats = 1024 vectors of 4, four per thread.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = tid + i * kFmaThreads;
      const int r = v >> 3, c = (v & 7) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < m && k0 + c < k)
        val = *reinterpret_cast<const float4*>(x + (long)(m0 + r) * k + k0 + c);
      *reinterpret_cast<float4*>(sa + r * kLdA32 + c) = val;
    }
    // B chunk: 32 x 64 floats = 512 vectors of 4, two per thread.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kFmaThreads;
      const int r = v >> 4, c = (v & 15) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < k && n0 + c < n)
        val = *reinterpret_cast<const float4*>(w + (long)(k0 + r) * n + n0 + c);
      *reinterpret_cast<float4*>(sb + r * kLdB32 + c) = val;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kFmaBK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = sa[(ty * 8 + r) * kLdA32 + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = sb[kk * kLdB32 + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) smem[(ty * 8 + r) * kLdC + tx + 16 * c] = acc[r][c];
  __syncthreads();
}

// Grid (N tiles, groups): block (nt, g) computes the M tiles
// [g * per_block, (g + 1) * per_block) of N tile nt, writes their y and one
// row of column partials part1/part2[g, n0:n0+64].
__global__ void __launch_bounds__(kFmaThreads)
conv_stats_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ y, float* __restrict__ part1,
                      float* __restrict__ part2, int m, int k, int n, int per_block) {
  __shared__ __align__(16) float smem[kFmaSmemBytes / 4];
  __shared__ float red1[kFmaGroups][kFmaBN];
  __shared__ float red2[kFmaGroups][kFmaBN];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kFmaBN;
  const int tiles_m = (m + kBM - 1) / kBM;
  const int t_begin = blockIdx.y * per_block;
  const int t_end = min(t_begin + per_block, tiles_m);
  const int col = tid % kFmaBN, grp = tid / kFmaBN;
  const bool col_ok = n0 + col < n;
  float sum1 = 0.0f, sum2 = 0.0f;
  for (int t = t_begin; t < t_end; ++t) {
    const int m0 = t * kBM;
    fma_tile(x, w, smem, m0, n0, m, k, n);
    const int r_end = min((grp + 1) * kFmaRowsPerGroup, m - m0);
    if (col_ok) {
      for (int r = grp * kFmaRowsPerGroup; r < r_end; ++r) {
        const float v = smem[r * kLdC + col];
        y[(long)(m0 + r) * n + n0 + col] = v;
        sum1 += v;
        sum2 += v * v;
      }
    }
    __syncthreads();  // the next tile's operands overwrite smem
  }
  red1[grp][col] = sum1;
  red2[grp][col] = sum2;
  __syncthreads();
  if (tid < kFmaBN && n0 + tid < n) {
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int g = 0; g < kFmaGroups; ++g) {
      a += red1[g][tid];
      b += red2[g][tid];
    }
    part1[(long)blockIdx.y * n + n0 + tid] = a;
    part2[(long)blockIdx.y * n + n0 + tid] = b;
  }
}

// ------------------------------------------- bf16: TMA + wgmma, warp-specialised
constexpr int kBK = 64;               // K depth of a ring stage (128-byte rows)
constexpr int kBox = 64;              // a swizzled box: 64 rows of 64 bf16
constexpr int kBoxBytes = kBox * 128;                // 8 KB
constexpr int kXStageBytes = kBM * 128;              // 16 KB: [128 rows, 64 K]
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kWgmmaThreads = kConsumers + 32;       // and one producer warp
constexpr int kMaxStages = 6;
constexpr int kMinStages = 3;
// Dynamic shared memory a block may use (227 KB), less the 1 KB kept to
// align the buffers to the 128B swizzle's 1024-byte atoms.
constexpr int kSmemLimit = 232448;
constexpr int kSmemUsable = kSmemLimit - 1024;
// Named barriers (0 is __syncthreads): one per consumer warpgroup, one for both.
constexpr int kBarAll = 3;

// The shared-memory plan of one launch; the wrapper's mirror is
// ops/fused_conv_stats.py::smem_plan.
struct Plan {
  int bn, k_chunks, stages, resident, smem;
};

__host__ __device__ constexpr int w_chunk_bytes(int bn) { return (bn / kBox) * kBoxBytes; }
// Staging of y (2 warpgroups x bn/64 boxes) and the [8 warps][bn] Σ, Σ² step.
__host__ __device__ constexpr int epilogue_bytes(int bn) {
  return 2 * w_chunk_bytes(bn) + 2 * 8 * bn * 4;
}

Plan make_plan(int k, int n) {
  Plan p{};
  p.bn = n <= 64 ? 64 : (n <= 128 ? 128 : 256);
  p.k_chunks = (k + kBK - 1) / kBK;
  const int barriers = 8 * (2 * kMaxStages + 1);
  const int room = kSmemUsable - epilogue_bytes(p.bn) - barriers;
  const int w_all = p.k_chunks * w_chunk_bytes(p.bn);
  const int resident_stages = (room - w_all) / kXStageBytes;
  if (resident_stages >= kMinStages) {
    p.resident = 1;
    p.stages = resident_stages < kMaxStages ? resident_stages : kMaxStages;
    p.smem = p.stages * kXStageBytes + w_all;
  } else {
    p.resident = 0;
    const int stage = kXStageBytes + w_chunk_bytes(p.bn);
    p.stages = room / stage < kMaxStages ? room / stage : kMaxStages;
    p.smem = p.stages * stage;
  }
  p.smem += epilogue_bytes(p.bn) + barriers + 1024;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The box at (c0 inner, c1 outer) of `map` into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The committed stores have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Threads' shared-memory writes become visible to the async (TMA) proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor, 128B swizzle: start address, leading and
// stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= A . B for one k16 step: A [64, 16] K-major from x, B [16, N] MN-major
// from w (transpose-B set); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}


template <int BN>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                           int accumulate) {
  if constexpr (BN == 64) wgmma_n64(d, da, db, accumulate);
  else if constexpr (BN == 128) wgmma_n128(d, da, db, accumulate);
  else wgmma_n256(d, da, db, accumulate);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Grid: tiles_n x groups blocks, N tiles fastest (the blocks of one M run read
// the same x rows together). Block (nt, g) computes the M tiles
// [g * per_block, (g + 1) * per_block) of N tile nt, writes their y through
// TMA and one row of column partials part1/part2[g, n0:n0+BN].
template <int BN, bool kResident>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
conv_stats_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_w,
                        const __grid_constant__ CUtensorMap map_y, float* __restrict__ part1,
                        float* __restrict__ part2, int m, int n, int k_chunks, int stages,
                        int per_block) {
  constexpr int kWBytes = w_chunk_bytes(BN);  // one 64-deep K chunk of the w tile
  constexpr int kBoxes = BN / kBox;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  // Layout: x ring | w (resident: all K chunks; else one per stage) | y
  // staging (2 warpgroups) | Σ, Σ² step [8 warps][BN] each | mbarriers.
  const uint32_t s_x = raw + pad;
  const uint32_t s_w = s_x + stages * kXStageBytes;
  const uint32_t s_y = s_w + (kResident ? k_chunks : stages) * kWBytes;
  const uint32_t s_red = s_y + 2 * kWBytes;
  float* red1 = reinterpret_cast<float*>(smem_raw + pad + (s_red - s_x));
  float* red2 = red1 + 8 * BN;
  const uint32_t full0 = s_red + 2 * 8 * BN * 4;
  const uint32_t empty0 = full0 + 8 * stages;
  const uint32_t wbar = empty0 + 8 * stages;

  const int tiles_m = (m + kBM - 1) / kBM;
  const int tiles_n = (n + BN - 1) / BN;
  const int nt = blockIdx.x % tiles_n, grp = blockIdx.x / tiles_n;
  const int n0 = nt * BN;
  const int t_begin = grp * per_block;
  const int t_end = min(t_begin + per_block, tiles_m);

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumers / 32);  // one arrival per consumer warp
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: lane 0 of the last warp issues every copy, running ahead of
    // the consumers by up to `stages` K chunks, across M-tile boundaries.
    if (threadIdx.x == kConsumers) {
      if (kResident) {
        mbar_expect_tx(wbar, k_chunks * kWBytes);
        for (int kc = 0; kc < k_chunks; ++kc)
          for (int b = 0; b < kBoxes; ++b)
            tma_load(s_w + kc * kWBytes + b * kBoxBytes, &map_w, n0 + b * kBox, kc * kBK, wbar);
      }
      int stage = 0, phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        for (int kc = 0; kc < k_chunks; ++kc) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, kXStageBytes + (kResident ? 0 : kWBytes));
          tma_load(s_x + stage * kXStageBytes, &map_x, kc * kBK, t * kBM, full);
          if (!kResident)
            for (int b = 0; b < kBoxes; ++b)
              tma_load(s_w + stage * kWBytes + b * kBoxBytes, &map_w, n0 + b * kBox, kc * kBK,
                       full);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each M tile.
  // Thread (warp, lane) holds rows r and r + 8 of columns 8j + 2q, 8j + 2q + 1
  // in acc[4j .. 4j + 3] (wgmma's accumulator layout).
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int r = (warp % 4) * 16 + lane / 4, q = lane % 4;
  const uint32_t y_stage = s_y + wg * kWBytes;
  float acc[BN / 2];
  float run1 = 0.0f, run2 = 0.0f;
  if (kResident) mbar_wait(wbar, 0);
  int stage = 0, phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    for (int kc = 0; kc < k_chunks; ++kc) {
      mbar_wait(full0 + 8 * stage, phase);
      // A: 64 rows of 128 bytes, 8-row atoms 1 KB apart; a k16 step is 32
      // bytes along the row. B: boxes of 64 columns 8 KB apart (LBO), 8-row
      // K groups 1 KB apart (SBO); a k16 step is two groups, 2 KB.
      const uint32_t a0 = s_x + stage * kXStageBytes + wg * (kXStageBytes / 2);
      const uint32_t b0 = s_w + (kResident ? kc : stage) * kWBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_step<BN>(acc, gmma_desc(a0 + kk * 32, 16, 1024),
                       gmma_desc(b0 + kk * 2048, kBoxBytes, 1024), kc > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // y: bf16 pairs into the swizzled staging boxes (the layout the TMA
    // store reads: 16-byte chunk c of row r at chunk c ^ (r % 8)); in their
    // place each thread keeps its two rows' Σ and Σ² per column.
    const int m0 = t * kBM;
    if (tid % 128 == 0) bulk_wait_read();  // the last tile's store has read it
    named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const uint32_t box = y_stage + (j / 8) * kBoxBytes + q * 4;
      const uint32_t chunk = (j % 8) ^ (r % 8);  // (r + 8) % 8 == r % 8
      st_shared_u32(box + r * 128 + (chunk << 4), pack_bf16(acc[4 * j], acc[4 * j + 1]));
      st_shared_u32(box + (r + 8) * 128 + (chunk << 4),
                    pack_bf16(acc[4 * j + 2], acc[4 * j + 3]));
      const float a = acc[4 * j], b = acc[4 * j + 1], c = acc[4 * j + 2], d = acc[4 * j + 3];
      acc[4 * j] = a + c;
      acc[4 * j + 1] = b + d;
      acc[4 * j + 2] = a * a + c * c;
      acc[4 * j + 3] = b * b + d * d;
    }
    fence_async_shared();
    named_sync(1 + wg, 128);
    if (tid % 128 == 0 && m0 + wg * 64 < m) {
      for (int b = 0; b < kBoxes && n0 + b * kBox < n; ++b)
        tma_store(&map_y, y_stage + b * kBoxBytes, n0 + b * kBox, m0 + wg * 64);
      bulk_commit();
    }

    // Σ over the 8 lanes that share columns (lane / 4 differs), then the 8
    // warps in order, into column c's running sums (thread c).
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      float v = acc[i];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[i] = v;
    }
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = warp * BN + 8 * j + 2 * lane;
        red1[col] = acc[4 * j];
        red1[col + 1] = acc[4 * j + 1];
        red2[col] = acc[4 * j + 2];
        red2[col + 1] = acc[4 * j + 3];
      }
    }
    named_sync(kBarAll, kConsumers);
    if (tid < BN) {
      float a = red1[tid], b = red2[tid];
#pragma unroll
      for (int w = 1; w < 8; ++w) {
        a += red1[w * BN + tid];
        b += red2[w * BN + tid];
      }
      run1 += a;
      run2 += b;
    }
    named_sync(kBarAll, kConsumers);  // the next tile rewrites red1/red2
  }
  if (tid < BN && n0 + tid < n) {
    part1[(long)grp * n + n0 + tid] = run1;
    part2[(long)grp * n + n0 + tid] = run2;
  }
  if (tid % 128 == 0) bulk_wait_all();  // y written before the block's smem goes
}

// ------------------------------------------------------------ both dtypes
// s1/s2[n] = the partials' column sums over `groups` rows, in a fixed order:
// lane l adds rows l, l + 32, ...; then a 5-level tree adds the 32 lanes.
__global__ void __launch_bounds__(kSumCols * kSumLanes)
sum_partials_kernel(const float* __restrict__ part1, const float* __restrict__ part2,
                    float* __restrict__ s1, float* __restrict__ s2, int groups, int n) {
  __shared__ float red1[kSumLanes][kSumCols + 1];
  __shared__ float red2[kSumLanes][kSumCols + 1];
  const int c = threadIdx.x % kSumCols, lane = threadIdx.x / kSumCols;
  const int col = blockIdx.x * kSumCols + c;
  float a = 0.0f, b = 0.0f;
  if (col < n) {
    for (int g = lane; g < groups; g += kSumLanes) {
      a += part1[(long)g * n + col];
      b += part2[(long)g * n + col];
    }
  }
  red1[lane][c] = a;
  red2[lane][c] = b;
  __syncthreads();
#pragma unroll
  for (int s = kSumLanes / 2; s > 0; s /= 2) {
    if (lane < s) {
      red1[lane][c] += red1[lane + s][c];
      red2[lane][c] += red2[lane + s][c];
    }
    __syncthreads();
  }
  if (lane == 0 && col < n) {
    s1[col] = red1[0][c];
    s2[col] = red2[0][c];
  }
}

// ----------------------------------------------------------------- host side
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major bf16 [rows, cols] matrix as a TMA map of [box_rows, 64] boxes
// (128-byte rows, 128B swizzle); loads past the edges fill zeros, stores
// past them are dropped.
bool encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kBox, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool kResident>
cudaError_t launch_wgmma(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& my,
                         float* part1, float* part2, int m, int n, const Plan& plan,
                         int per_block, int groups, cudaStream_t stream) {
  auto kernel = conv_stats_wgmma_kernel<BN, kResident>;
  // Once per process (the port runs on one card): no attribute call per launch.
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return attr;
  const long blocks = (long)((n + BN - 1) / BN) * groups;
  kernel<<<(unsigned)blocks, kWgmmaThreads, plan.smem, stream>>>(
      mx, mw, my, part1, part2, m, n, plan.k_chunks, plan.stages, per_block);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* x, const void* w, void* y, float* part1, float* part2,
                        int m, int k, int n, int per_block, int groups, cudaStream_t stream) {
  for (const void* p : {x, w, static_cast<const void*>(y)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  CUtensorMap mx, mw, my;
  if (!encode(&mx, x, m, k, kBM) || !encode(&mw, w, k, n, kBox) || !encode(&my, y, m, n, kBox))
    return cudaErrorInvalidValue;
  const Plan plan = make_plan(k, n);
  const int key = plan.bn * 2 + plan.resident;
#define CONV_STATS_CASE(BN, RES)                                                              \
  case BN * 2 + RES:                                                                          \
    return launch_wgmma<BN, (RES != 0)>(mx, mw, my, part1, part2, m, n, plan, per_block,     \
                                        groups, stream);
  switch (key) {
    CONV_STATS_CASE(64, 1)
    CONV_STATS_CASE(64, 0)
    CONV_STATS_CASE(128, 1)
    CONV_STATS_CASE(128, 0)
    CONV_STATS_CASE(256, 1)
    CONV_STATS_CASE(256, 0)
  }
#undef CONV_STATS_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// y [m, n] (x's dtype), s1 and s2 [n] fp32 from x [m, k] and w [k, n], all
// contiguous and 16-byte aligned; part is fp32 scratch of 2 * groups * n
// floats, groups = ceil(ceil(m / 128) / per_block). dtype 0 fp32 (the FMA
// kernel; groups at most 65535), 1 bf16 (TMA + wgmma). Returns a cudaError_t.
extern "C" int fused_conv_stats(const void* x, const void* w, void* y, void* part,
                                void* s1, void* s2, int m, int k, int n, int dtype,
                                int per_block, void* stream) {
  if (m < 1 || k < 8 || n < 8 || k % 8 || n % 8 || per_block < 1)
    return cudaErrorInvalidValue;
  const int tiles_m = (m + kBM - 1) / kBM;
  const int groups = (tiles_m + per_block - 1) / per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part1 = static_cast<float*>(part);
  float* part2 = part1 + (long)groups * n;
  cudaError_t err;
  if (dtype == kF32) {
    if (groups > 65535) return cudaErrorInvalidValue;
    conv_stats_fma_kernel<<<dim3((n + kFmaBN - 1) / kFmaBN, groups), kFmaThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y),
        part1, part2, m, k, n, per_block);
    err = cudaGetLastError();
  } else if (dtype == kBF16) {
    err = launch_bf16(x, w, y, part1, part2, m, k, n, per_block, groups, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<(n + kSumCols - 1) / kSumCols, kSumCols * kSumLanes, 0, s>>>(
      part1, part2, static_cast<float*>(s1), static_cast<float*>(s2), groups, n);
  return cudaGetLastError();
}

// The bf16 kernel's shared-memory plan at (k, n), for the wrapper's mirror:
// out = {bn, k_chunks, stages, resident, dynamic shared bytes}.
extern "C" void fused_conv_stats_plan(int k, int n, int* out) {
  const Plan p = make_plan(k, n);
  out[0] = p.bn;
  out[1] = p.k_chunks;
  out[2] = p.stages;
  out[3] = p.resident;
  out[4] = p.smem;
}
