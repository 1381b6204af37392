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
// Design. The TPU grid walks the M blocks in order on one core and carries
// the column sums in VMEM scratch from block to block. Hopper blocks run in
// no order, so:
// - one block owns a 64-column N tile and a fixed run of `per_block`
//   consecutive 128-row M tiles, loops over them, and keeps its threads'
//   column sums in registers across the run;
// - it writes one row of fp32 partials per run into a [groups, N] scratch
//   (no float atomics: their order, and so the sums' rounding, would change
//   from launch to launch);
// - a second small kernel sums the partials of each column in a fixed
//   order. The result repeats bit for bit from launch to launch.
// Per M tile the block loops over K in 32-wide chunks staged through shared
// memory with 16-byte loads (K and N are multiples of 8, so a vector never
// straddles an edge; rows past M and columns past N stage zeros):
// - bf16: 8 warps as a 4 x 2 grid, each warp a 32 x 32 tile of 2 x 2
//   16x16x16 wmma fragments (bf16 in, fp32 accumulate on the tensor cores);
// - fp32: each thread an 8 x 4 register tile of fp32 FMAs.
// The fp32 tile then goes through shared memory to the epilogue, where
// thread (column c, row group g) writes 32 rows of y and adds them to its
// column sums.
//
// Bound on an H100 SXM. At ResNet-50's bottleneck shapes (batch 128, 224 px)
// the work is 2*M*K*N = 13.2 GFLOP against (M*K + K*N + M*N)*2 bytes =
// 257 MB at (401408, 64, 256): 0.013 ms of bf16 tensor-core time against
// 0.077 ms of memory time, so bytes bound it by a wide margin, at every
// shape of the model. This first version stages without cp.async or TMA
// and does not overlap loads with the product; wgmma, TMA and a pipelined
// K loop are the next steps. The measured times are in PERF.md.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (autodist_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;             // rows of an M tile
constexpr int kBN = 64;              // columns of an N tile
constexpr int kBK = 32;              // depth of a staged K chunk
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kBN;        // row groups of the epilogue
constexpr int kRowsPerGroup = kBM / kGroups;   // 32
constexpr int kLdA16 = kBK + 8;      // bf16 row strides in shared memory
constexpr int kLdB16 = kBN + 8;
constexpr int kLdA32 = kBK + 4;      // fp32 row strides in shared memory
constexpr int kLdB32 = kBN + 4;
constexpr int kLdC = kBN + 4;        // the fp32 output tile's row stride
// The operand tiles and the fp32 output tile share one buffer.
constexpr int kSmemBytes = kBM * kLdC * 4;
static_assert(kBM * kLdA16 * 2 + kBK * kLdB16 * 2 <= kSmemBytes, "bf16 tiles");
static_assert((kBM * kLdA32 + kBK * kLdB32) * 4 <= kSmemBytes, "fp32 tiles");
constexpr int kReduceCols = 32;      // columns per block of the partials' sum
constexpr int kReduceLanes = kThreads / kReduceCols;

enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as .to(bfloat16) does
}

// The [128, 64] fp32 tile x[m0:m0+128, :] . w[:, n0:n0+64] of bf16 inputs,
// left in smem as float[kBM][kLdC]. Ends with a __syncthreads().
__device__ __forceinline__ void tile_product(const bf16* __restrict__ x,
                                             const bf16* __restrict__ w,
                                             unsigned char* smem, int m0, int n0,
                                             int m, int k, int n) {
  using namespace nvcuda;
  bf16* sa = reinterpret_cast<bf16*>(smem);             // [kBM][kLdA16]
  bf16* sb = sa + kBM * kLdA16;                         // [kBK][kLdB16]
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;               // 4 x 2 warps
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // A chunk: 128 rows x 32 columns = 512 vectors of 8, two per thread.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      const int r = v >> 2, c = (v & 3) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m && k0 + c < k)
        val = *reinterpret_cast<const uint4*>(x + (long)(m0 + r) * k + k0 + c);
      *reinterpret_cast<uint4*>(sa + r * kLdA16 + c) = val;
    }
    // B chunk: 32 rows x 64 columns = 256 vectors of 8, one per thread.
    {
      const int r = tid >> 3, c = (tid & 7) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < k && n0 + c < n)
        val = *reinterpret_cast<const uint4*>(w + (long)(k0 + r) * n + n0 + c);
      *reinterpret_cast<uint4*>(sb + r * kLdB16 + c) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sa + (wm * 32 + i * 16) * kLdA16 + kk, kLdA16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sb + kk * kLdB16 + wn * 32 + j * 16, kLdB16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* sc = reinterpret_cast<float*>(smem);           // overlays sa, sb
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sc + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
}

// The same tile of fp32 inputs, by fp32 FMAs: thread (ty, tx) owns rows
// ty*8 .. ty*8+7 and columns tx, tx+16, tx+32, tx+48.
__device__ __forceinline__ void tile_product(const float* __restrict__ x,
                                             const float* __restrict__ w,
                                             unsigned char* smem, int m0, int n0,
                                             int m, int k, int n) {
  float* sa = reinterpret_cast<float*>(smem);           // [kBM][kLdA32]
  float* sb = sa + kBM * kLdA32;                        // [kBK][kLdB32]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // A chunk: 128 x 32 floats = 1024 vectors of 4, four per thread.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = tid + i * kThreads;
      const int r = v >> 3, c = (v & 7) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < m && k0 + c < k)
        val = *reinterpret_cast<const float4*>(x + (long)(m0 + r) * k + k0 + c);
      *reinterpret_cast<float4*>(sa + r * kLdA32 + c) = val;
    }
    // B chunk: 32 x 64 floats = 512 vectors of 4, two per thread.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      const int r = v >> 4, c = (v & 15) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < k && n0 + c < n)
        val = *reinterpret_cast<const float4*>(w + (long)(k0 + r) * n + n0 + c);
      *reinterpret_cast<float4*>(sb + r * kLdB32 + c) = val;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
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
  float* sc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[(ty * 8 + r) * kLdC + tx + 16 * c] = acc[r][c];
  __syncthreads();
}

// Grid (N tiles, groups): block (nt, g) computes the M tiles
// [g * per_block, (g + 1) * per_block) of N tile nt, writes their y and one
// row of column partials part1/part2[g, n0:n0+64].
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_conv_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ y, float* __restrict__ part1,
                        float* __restrict__ part2, int m, int k, int n, int per_block) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __shared__ float red1[kGroups][kBN];
  __shared__ float red2[kGroups][kBN];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int tiles_m = (m + kBM - 1) / kBM;
  const int t_begin = blockIdx.y * per_block;
  const int t_end = min(t_begin + per_block, tiles_m);
  const int col = tid % kBN, grp = tid / kBN;
  const bool col_ok = n0 + col < n;
  const float* sc = reinterpret_cast<const float*>(smem);
  float sum1 = 0.0f, sum2 = 0.0f;
  for (int t = t_begin; t < t_end; ++t) {
    const int m0 = t * kBM;
    tile_product(x, w, smem, m0, n0, m, k, n);
    const int r_end = min((grp + 1) * kRowsPerGroup, m - m0);
    if (col_ok) {
      for (int r = grp * kRowsPerGroup; r < r_end; ++r) {
        const float v = sc[r * kLdC + col];
        y[(long)(m0 + r) * n + n0 + col] = from_f32<T>(v);
        sum1 += v;
        sum2 += v * v;
      }
    }
    __syncthreads();  // the next tile's operands overwrite sc
  }
  red1[grp][col] = sum1;
  red2[grp][col] = sum2;
  __syncthreads();
  if (tid < kBN && n0 + tid < n) {
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      a += red1[g][tid];
      b += red2[g][tid];
    }
    part1[(long)blockIdx.y * n + n0 + tid] = a;
    part2[(long)blockIdx.y * n + n0 + tid] = b;
  }
}

// s1/s2[n] = the partials' column sums over `groups` rows, in a fixed order:
// lane l adds rows l, l + 8, ...; then the 8 lanes are added in lane order.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ part1, const float* __restrict__ part2,
                    float* __restrict__ s1, float* __restrict__ s2, int groups, int n) {
  __shared__ float red1[kReduceLanes][kReduceCols];
  __shared__ float red2[kReduceLanes][kReduceCols];
  const int c = threadIdx.x % kReduceCols, lane = threadIdx.x / kReduceCols;
  const int col = blockIdx.x * kReduceCols + c;
  float a = 0.0f, b = 0.0f;
  if (col < n) {
    for (int g = lane; g < groups; g += kReduceLanes) {
      a += part1[(long)g * n + col];
      b += part2[(long)g * n + col];
    }
  }
  red1[lane][c] = a;
  red2[lane][c] = b;
  __syncthreads();
  if (lane == 0 && col < n) {
#pragma unroll
    for (int l = 1; l < kReduceLanes; ++l) {
      a += red1[l][c];
      b += red2[l][c];
    }
    s1[col] = a;
    s2[col] = b;
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, void* part, void* s1, void* s2, int m,
           int k, int n, int per_block, cudaStream_t stream) {
  const int tiles_m = (m + kBM - 1) / kBM;
  const int groups = (tiles_m + per_block - 1) / per_block;
  float* part1 = static_cast<float*>(part);
  float* part2 = part1 + (long)groups * n;
  dim3 grid((n + kBN - 1) / kBN, groups);
  fused_conv_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), part1,
      part2, m, k, n, per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<(n + kReduceCols - 1) / kReduceCols, kThreads, 0, stream>>>(
      part1, part2, static_cast<float*>(s1), static_cast<float*>(s2), groups, n);
  return cudaGetLastError();
}

}  // namespace

// y [m, n] (x's dtype), s1 and s2 [n] fp32 from x [m, k] and w [k, n], all
// contiguous and 16-byte aligned; part is fp32 scratch of 2 * groups * n
// floats, groups = ceil(ceil(m / 128) / per_block). Returns a cudaError_t.
extern "C" int fused_conv_stats(const void* x, const void* w, void* y, void* part,
                                void* s1, void* s2, int m, int k, int n, int dtype,
                                int per_block, void* stream) {
  if (m < 1 || k < 8 || n < 8 || k % 8 || n % 8 || per_block < 1)
    return cudaErrorInvalidValue;
  const int tiles_m = (m + kBM - 1) / kBM;
  if ((tiles_m + per_block - 1) / per_block > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(x, w, y, part, s1, s2, m, k, n, per_block, s);
  if (dtype == kBF16) return launch<bf16>(x, w, y, part, s1, s2, m, k, n, per_block, s);
  return cudaErrorInvalidValue;
}
