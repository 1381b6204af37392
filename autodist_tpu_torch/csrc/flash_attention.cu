// Flash attention forward and backward (dK/dV, dQ) for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of autodist_tpu/ops/flash_attention.py:
//   _fwd_kernel   (launched by _pallas_forward) <- flash_fwd_bf16_kernel (bf16),
//                                                  flash_fwd_kernel (fp32)
//   _dkdv_kernel  (launched by _flash_bwd)      <- flash_dkdv_bf16_kernel (bf16),
//                                                  flash_dkdv_kernel (fp32)
//   _dq_kernel    (launched by _flash_bwd)      <- flash_dq_bf16_kernel (bf16),
//                                                  flash_dq_kernel (fp32)
// and keeps their arithmetic: scores with fp32 sums, scale 1/sqrt(D), causal
// mask value -1e30 (not -inf, so a fully masked row gives the same lse as
// the TPU kernel), online softmax with fp32 m / l / acc, p rounded to V's
// dtype before P.V, l == 0 read as 1, lse = m + log l. The backward
// recomputes P = exp(S - lse) from the forward's lse, takes delta =
// rowsum(dO * O) from the caller (a plain tensor op, as the JAX package
// leaves it to XLA) and keeps the reference's fp32 semantics: dK is the sum
// of dS^T (q * scale), dQ is scaled once at the end. Outputs are written in
// the inputs' dtype.
//
// Layout. q, k, v, o, dO, dq, dk, dv are [B, S, H, D] contiguous (the
// transformer's natural shape); each block reads its (b, h) slice through
// the row stride H * D instead of a folded [B*H, S, D] copy. lse and delta
// are [B*H, S] fp32. D is 64 (every zoo transformer); S a multiple of 64;
// pointers 16-byte aligned.
//
// Grid. The TPU grid is sequential per (b*h) and carries m/l/acc (fwd, dq)
// or dk/dv (dkdv) in VMEM from one grid step to the next. Hopper blocks run
// in no order, so the streamed axis becomes a loop inside one block:
// - fwd and dq: one block per (64-query tile, b*h) loops over 64-key tiles
//   (up to the diagonal tile when causal);
// - dkdv: one block per (64-key tile, b*h) loops over 64-query tiles (from
//   the diagonal tile when causal).
// The two-kernel backward needs no atomics: every output row has one owner.
//
// Bound on an H100 SXM. At the training shape (B = 32, S = 512, H = 12,
// D = 64, bf16, non-causal) the forward moves 101 MB (0.0303 ms at
// 3.35 TB/s) against 26 GFLOP (0.026 ms at the 989 TFLOP/s bf16 peak), so
// bytes bound it, barely; dK/dV's 52 GFLOP (0.0521 ms) and dQ's 39 GFLOP
// (0.039 ms) bound them; causal, or at S <= 256, all three are bound by
// bytes.
//
// Two designs. bf16 inputs, the main path, take the tensor-core kernels
// (the "bf16 path" section): mma.sync m16n8k16 with bf16 operands and fp32
// accumulation, bf16 tiles staged by cp.async. fp32 inputs take the FMA
// kernels (fp32 tiles in shared memory, products as fp32 FMAs on the CUDA
// cores, 67 TFLOP/s peak and one shared-memory load an FMA), which run far
// above the bounds. The measured times are in PERF.md.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (autodist_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kD = 64;          // head dim
constexpr int kTile = 64;       // rows of a Q or K tile
constexpr int kPad = kD + 1;    // shared-memory row stride (floats)
constexpr int kLanes = 4;       // threads per tile row
constexpr int kPer = kTile / kLanes;  // score columns / output dims per thread
constexpr int kThreads = kTile * kLanes;
constexpr int kTileFloats = kTile * kPad;
constexpr float kNegInf = -1e30f;  // the JAX package's _NEG_INF

// FMA kernels: tiles are 64 x 64 and staged in shared memory as fp32, rows
// padded to D + 1 floats so the column walks of the score loops hit distinct
// banks. A block has 256 threads: 4 per tile row. Thread (row r, lane g)
// owns the 16 score columns g, g + 4, ..., g + 60 of its row and the 16
// output dims g, g + 4, ..., g + 60; its row's operand (q, k, v or dO) sits
// in 64 registers. Row reductions of the softmax are two shuffles among the
// 4 lanes of a row.

enum DType : int { kF32 = 0, kBF16 = 1 };

// Max / sum over the 4 consecutive lanes of a warp that hold one row: of an
// fp32 FMA tile, or of an mma accumulator fragment (lanes 4g .. 4g + 3).
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stage rows [0, 64) of a [*, row_stride] slice into dst[64][kPad], times
// mul (1, or the softmax scale for the backward's pre-scaled q).
__device__ __forceinline__ void stage_tile(float* dst, const float* src, long row_stride,
                                           float mul) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    dst[r * kPad + d] = src[r * row_stride + d] * mul;
  }
}

// ------------------------------------------------------------ forward, fp32
// Replaces autodist_tpu/ops/flash_attention.py::_fwd_kernel for fp32
// inputs. Bound at the training shape: bytes (q, k, v, o; 2 products per
// tile pair come close). Design: q row in registers, K and V tiles staged
// once per iteration for all 64 query rows; the causal loop stops at the
// diagonal tile.
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int seq, int n_heads, float scale, int causal) {
  extern __shared__ float smem[];
  float* k_s = smem;                 // [64][65] key tile
  float* v_s = k_s + kTileFloats;    // [64][65] value tile
  float* p_s = v_s + kTileFloats;    // [64][65] p of the tile, in V's dtype
  const int qb = blockIdx.x, bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const long rs = (long)n_heads * kD;
  const long base = (long)b * seq * rs + (long)h * kD;
  const int r = threadIdx.x / kLanes, g = threadIdx.x % kLanes;
  const int q_row = qb * kTile + r;

  float qreg[kD];
  const float* qp = q + base + (long)q_row * rs;
#pragma unroll
  for (int d = 0; d < kD; ++d) qreg[d] = qp[d];

  float m = kNegInf, l = 0.f, acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;

  const int n_kb = causal ? qb + 1 : seq / kTile;  // causal: tiles up to the diagonal
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();  // the previous tile is consumed
    stage_tile(k_s, k + base + (long)kb * kTile * rs, rs, 1.f);
    stage_tile(v_s, v + base + (long)kb * kTile * rs, rs, 1.f);
    __syncthreads();
    float s[kPer];
    float mx = kNegInf;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int c = g + kLanes * t;
      const float* kr = k_s + c * kPad;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) dot = fmaf(qreg[d], kr[d], dot);
      dot *= scale;
      if (causal && kb * kTile + c > q_row) dot = kNegInf;
      s[t] = dot;
      mx = fmaxf(mx, dot);
    }
    const float m_new = fmaxf(m, row_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const float p = expf(s[t] - m_new);
      sum += p;
      p_s[r * kPad + g + kLanes * t] = p;  // p.astype(v.dtype) is p for fp32 V
    }
    const float alpha = expf(m - m_new);
    l = alpha * l + row_sum(sum);
    m = m_new;
    __syncwarp();  // a row's p is written and read by the 4 lanes of one warp
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] *= alpha;
    const float* pr = p_s + r * kPad;
    for (int c = 0; c < kTile; ++c) {
      const float pc = pr[c];
      const float* vr = v_s + c * kPad + g;
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[j] = fmaf(pc, vr[kLanes * j], acc[j]);
    }
  }
  const float l_safe = (l == 0.f) ? 1.f : l;
  float* op = o + base + (long)q_row * rs;
#pragma unroll
  for (int j = 0; j < kPer; ++j) op[g + kLanes * j] = acc[j] / l_safe;
  if (g == 0) lse[(long)bh * seq + q_row] = m + logf(l_safe);
}

// ---------------------------------------------------------- dK and dV, fp32
// Replaces autodist_tpu/ops/flash_attention.py::_dkdv_kernel for fp32
// inputs. Bound at the training shape: operations (4 products per tile
// pair). Design: this block's K and V tiles stay in shared memory for the
// whole query loop; P and dS go through shared memory so each key row's 4
// lanes can sum P^T dO and dS^T q over the query tile.
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int seq, int n_heads,
                  float scale, int causal) {
  extern __shared__ float smem[];
  float* k_s = smem;                  // [64][65] this block's keys
  float* v_s = k_s + kTileFloats;     // [64][65] this block's values
  float* q_s = v_s + kTileFloats;     // [64][65] query tile, times scale
  float* do_s = q_s + kTileFloats;    // [64][65] dO tile
  float* p_s = do_s + kTileFloats;    // [64 q][65] P
  float* ds_s = p_s + kTileFloats;    // [64 q][65] dS
  float* lse_s = ds_s + kTileFloats;  // [64]
  float* delta_s = lse_s + kTile;     // [64]
  const int kb = blockIdx.x, bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const long rs = (long)n_heads * kD;
  const long base = (long)b * seq * rs + (long)h * kD;
  const int r = threadIdx.x / kLanes, g = threadIdx.x % kLanes;  // r: key row
  const int k_row = kb * kTile + r;

  stage_tile(k_s, k + base + (long)kb * kTile * rs, rs, 1.f);
  stage_tile(v_s, v + base + (long)kb * kTile * rs, rs, 1.f);

  float dk_acc[kPer], dv_acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  const int first_qb = causal ? kb : 0;  // causal: query tiles from the diagonal
  for (int qb = first_qb; qb < seq / kTile; ++qb) {
    __syncthreads();  // the previous tile is consumed (and k_s / v_s staged)
    stage_tile(q_s, q + base + (long)qb * kTile * rs, rs, scale);
    stage_tile(do_s, dout + base + (long)qb * kTile * rs, rs, 1.f);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse[(long)bh * seq + qb * kTile + threadIdx.x];
      delta_s[threadIdx.x] = delta[(long)bh * seq + qb * kTile + threadIdx.x];
    }
    __syncthreads();
    float row[kD];
    float p[kPer];
#pragma unroll
    for (int d = 0; d < kD; ++d) row[d] = k_s[r * kPad + d];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int qi = g + kLanes * t;
      const float* qr = q_s + qi * kPad;
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) sc = fmaf(qr[d], row[d], sc);
      if (causal && qb * kTile + qi < k_row) sc = kNegInf;
      p[t] = expf(sc - lse_s[qi]);
    }
#pragma unroll
    for (int d = 0; d < kD; ++d) row[d] = v_s[r * kPad + d];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int qi = g + kLanes * t;
      const float* dr = do_s + qi * kPad;
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) dp = fmaf(dr[d], row[d], dp);
      p_s[qi * kPad + r] = p[t];
      ds_s[qi * kPad + r] = p[t] * (dp - delta_s[qi]);
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T (q * scale), for this thread's key row.
    for (int qi = 0; qi < kTile; ++qi) {
      const float pv = p_s[qi * kPad + r];
      const float dsv = ds_s[qi * kPad + r];
      const float* dr = do_s + qi * kPad + g;
      const float* qr = q_s + qi * kPad + g;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        dv_acc[j] = fmaf(pv, dr[kLanes * j], dv_acc[j]);
        dk_acc[j] = fmaf(dsv, qr[kLanes * j], dk_acc[j]);
      }
    }
  }
  float* dkp = dk + base + (long)k_row * rs;
  float* dvp = dv + base + (long)k_row * rs;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    dkp[g + kLanes * j] = dk_acc[j];
    dvp[g + kLanes * j] = dv_acc[j];
  }
}

// ----------------------------------------------------------------- dQ, fp32
// Replaces autodist_tpu/ops/flash_attention.py::_dq_kernel for fp32 inputs.
// Bound at the training shape: operations (3 products per tile pair).
// Design: the query and dO tiles stay in shared memory for the whole key
// loop; dS needs no barrier across warps, since a row's dS is made and used
// by its own lanes.
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int seq, int n_heads, float scale, int causal) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // [64][65] query tile, times scale
  float* do_s = q_s + kTileFloats;   // [64][65] dO tile
  float* k_s = do_s + kTileFloats;   // [64][65] key tile
  float* v_s = k_s + kTileFloats;    // [64][65] value tile
  float* ds_s = v_s + kTileFloats;   // [64 q][65] dS
  const int qb = blockIdx.x, bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const long rs = (long)n_heads * kD;
  const long base = (long)b * seq * rs + (long)h * kD;
  const int r = threadIdx.x / kLanes, g = threadIdx.x % kLanes;  // r: query row
  const int q_row = qb * kTile + r;

  stage_tile(q_s, q + base + (long)qb * kTile * rs, rs, scale);
  stage_tile(do_s, dout + base + (long)qb * kTile * rs, rs, 1.f);
  const float lse_r = lse[(long)bh * seq + q_row];
  const float delta_r = delta[(long)bh * seq + q_row];

  float dq_acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) dq_acc[j] = 0.f;

  const int n_kb = causal ? qb + 1 : seq / kTile;
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();  // the previous tile is consumed (and q_s / do_s staged)
    stage_tile(k_s, k + base + (long)kb * kTile * rs, rs, 1.f);
    stage_tile(v_s, v + base + (long)kb * kTile * rs, rs, 1.f);
    __syncthreads();
    float row[kD];
    float p[kPer];
#pragma unroll
    for (int d = 0; d < kD; ++d) row[d] = q_s[r * kPad + d];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int c = g + kLanes * t;
      const float* kr = k_s + c * kPad;
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) sc = fmaf(row[d], kr[d], sc);
      if (causal && kb * kTile + c > q_row) sc = kNegInf;
      p[t] = expf(sc - lse_r);
    }
#pragma unroll
    for (int d = 0; d < kD; ++d) row[d] = do_s[r * kPad + d];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int c = g + kLanes * t;
      const float* vr = v_s + c * kPad;
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) dp = fmaf(row[d], vr[d], dp);
      ds_s[r * kPad + c] = p[t] * (dp - delta_r);
    }
    __syncwarp();  // a row's dS is written and read by the 4 lanes of one warp
    const float* dr = ds_s + r * kPad;
    for (int c = 0; c < kTile; ++c) {
      const float dsv = dr[c];
      const float* kr = k_s + c * kPad + g;
#pragma unroll
      for (int j = 0; j < kPer; ++j) dq_acc[j] = fmaf(dsv, kr[kLanes * j], dq_acc[j]);
    }
  }
  float* dqp = dq + base + (long)q_row * rs;
#pragma unroll
  for (int j = 0; j < kPer; ++j) dqp[g + kLanes * j] = dq_acc[j] * scale;
}

// ================================================================ bf16 path
// Tensor-core kernels for bf16 inputs. A block has 4 warps; each warp owns
// 16 rows of the block's 64-row tile (query rows in the forward, key rows in
// dK/dV) and computes with mma.sync.m16n8k16 (bf16 operands, fp32
// accumulators). Fragment layouts of m16n8k16, lane = 4 g + t:
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                           a3 (g+8, 2t+8..);
//   B (16 x 8, k x n):      b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
//   C (16 x 8, fp32):       c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
// So the accumulators of two neighbouring 8-column tiles, packed to bf16 in
// pairs, are exactly the A fragment of a 16-deep product over those columns:
// P (and dS) go from one product to the next without leaving registers.
//
// Tiles are 64 rows x 64 bf16 (8 KB) in shared memory, loaded with 16-byte
// cp.async straight from the [B, S, H, D] rows. A row is 128 bytes, eight
// 16-byte chunks; chunk c of row r sits at chunk c ^ (r % 8), so the eight
// row addresses of each ldmatrix phase fall in distinct banks. ldmatrix
// reads a tile whose rows are the product's n (or m) index as it is, and a
// tile whose rows are the k index with .trans.
//
// Pipeline: two buffers for the streamed tiles. At the top of iteration i
// every thread waits for its copies and the block meets at one barrier;
// tile i is then visible to all and every warp is done with tile i - 1, so
// the copies of tile i + 1 go into that buffer while tile i is used.
using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;                               // 4 warps
constexpr uint32_t kTileBytes = kTile * kD * sizeof(bf16);    // 8 KB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b (m16n8k16, bf16 in, fp32 accumulate).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest even (as astype does), x0 in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo to 2^-16 relative: hi = bf16(x), lo = bf16(x - hi) (x - hi is
// exact in fp32). Two products, one with each half, carry an fp32 operand.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// Rows [0, 64) of a [*, rs] slice into a swizzled tile: 512 chunks, 4 a thread,
// 8 consecutive threads on one 128-byte row.
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, long rs) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + i * kMmaThreads;
    const int row = idx >> 3, chunk = idx & 7;
    cp_async16(dst + swz(row, chunk), src + row * rs + chunk * 8);
  }
}

// A fragments of rows [row0, row0 + 16) over all 64 columns: f[kk] covers
// columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void load_a_frags(uint32_t tile, int row0, uint32_t (&f)[4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(tile + swz(row0 + (lane & 15), 2 * kk + (lane >> 4)), f[kk]);
}

// B fragments of A . X^T with X's rows [row0, row0 + 16) as n and columns
// 16 kk .. 16 kk + 15 as k: {b[0], b[1]} for n rows row0 .. row0 + 7,
// {b[2], b[3]} for the next 8.
__device__ __forceinline__ void load_b_rows(uint32_t tile, int row0, int kk, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(tile + swz(row0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)), b);
}

// B fragments of A . X with X's rows [row0, row0 + 16) as k and columns
// 16 dp .. 16 dp + 15 as n: {b[0], b[1]} for columns 16 dp .. + 7,
// {b[2], b[3]} for the next 8.
__device__ __forceinline__ void load_b_cols(uint32_t tile, int row0, int dp, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(tile + swz(row0 + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * dp + (lane >> 4)),
                b);
}

// A warp's 16 x 64 fp32 accumulator rounded to bf16, written to rows
// [row0, row0 + 16) of `dst` (row stride rs) through rows [row0, row0 + 16) of
// the swizzled tile at `stage`, so that the global stores are 16 bytes wide.
__device__ __forceinline__ void store_rows(unsigned char* stage, int row0,
                                           const float (&acc)[8][4], bf16* dst, long rs) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + swz(row0 + g, j) + 4 * t) =
        pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(stage + swz(row0 + g + 8, j) + 4 * t) =
        pack_bf16(acc[j][2], acc[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + 32 * i;
    const int r = row0 + (idx >> 3), c = idx & 7;
    *reinterpret_cast<uint4*>(dst + r * rs + c * 8) =
        *reinterpret_cast<const uint4*>(stage + swz(r, c));
  }
}

// ------------------------------------------------------------ forward, bf16
// Replaces autodist_tpu/ops/flash_attention.py::_fwd_kernel for bf16 inputs.
// Bound at the training shape: bytes, 0.0303 ms (q, k, v read and O written
// once; its 26 GFLOP take 0.026 ms at the bf16 peak). The reference already
// multiplies bf16 operands with fp32 sums (q . k^T, and p rounded to V's
// dtype before p . v), so bf16 mma with fp32 accumulation is its arithmetic
// up to summation order. Design: one block per (64-query tile, b*h), warp w
// owns query rows 16 w .. 16 w + 15 and keeps their Q fragments in
// registers; K and V tiles stream through two cp.async buffers. S = Q K^T
// reads K with ldmatrix; the online softmax runs on the accumulators (row
// max: two quad shuffles; row sums kept per thread and summed once at the
// end); P, packed to bf16, is the A operand of O += P V, V read with
// ldmatrix.trans. Causal: key tiles past the diagonal are skipped and only
// the diagonal tile is masked.
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int seq, int n_heads, float scale,
                      int causal) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  // [q | k0 | v0 | k1 | v1], each a swizzled 64 x 64 tile; q stages O at the end.
  const uint32_t s0 = smem_addr(smem_bytes);
  const int qb = blockIdx.x, bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const long rs = (long)n_heads * kD;
  const long base = (long)b * seq * rs + (long)h * kD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const int n_kb = causal ? qb + 1 : seq / kTile;

  load_tile(s0, q + base + (long)qb * kTile * rs, rs);
  load_tile(s0 + kTileBytes, k + base, rs);
  load_tile(s0 + 2 * kTileBytes, v + base, rs);
  cp_async_commit();

  uint32_t qf[4][4];
  float m[2] = {kNegInf, kNegInf};  // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};          // this thread's part of their sums
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kb = 0; kb < n_kb; ++kb) {
    cp_async_wait_all();
    __syncthreads();
    if (kb == 0) load_a_frags(s0, row0, qf);
    if (kb + 1 < n_kb) {
      const uint32_t nxt = s0 + kTileBytes * (1 + 2 * ((kb + 1) & 1));
      load_tile(nxt, k + base + (long)(kb + 1) * kTile * rs, rs);
      load_tile(nxt + kTileBytes, v + base + (long)(kb + 1) * kTile * rs, rs);
      cp_async_commit();
    }
    const uint32_t ks = s0 + kTileBytes * (1 + 2 * (kb & 1)), vs = ks + kTileBytes;

    float s[8][4];  // s[j]: key columns 8 j .. 8 j + 7
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bf[4];
        load_b_rows(ks, 16 * jp, kk, bf);
        mma_bf16(s[2 * jp], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bf[2], bf[3]);
      }

    const bool diag = causal && kb == qb;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (diag && 8 * j + 2 * t + (e & 1) > row0 + g + 8 * (e >> 1)) x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = row_max(mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[j][e] = p;
        acc[j][e] *= alpha[e >> 1];
      }
    // O += P V: the key columns 16 kc .. 16 kc + 15 of P are tiles 2 kc, 2 kc + 1.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t bf[4];
        load_b_cols(vs, 16 * kc, dp, bf);
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
  }

  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = row_sum(l[r]);
    l_safe[r] = (lr == 0.f) ? 1.f : lr;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] /= l_safe[e >> 1];
  store_rows(smem_bytes, row0, acc, o + base + (long)qb * kTile * rs, rs);
  if (t == 0) {
    float* lp = lse + (long)bh * seq + qb * kTile + row0 + g;
    lp[0] = m[0] + logf(l_safe[0]);
    lp[8] = m[1] + logf(l_safe[1]);
  }
}

// ---------------------------------------------------------- dK and dV, bf16
// Replaces autodist_tpu/ops/flash_attention.py::_dkdv_kernel for bf16
// inputs. Bound at the training shape: operations, 0.0521 ms for the four
// products' 52 GFLOP at the bf16 peak; this kernel runs 1.5x that tensor-core
// work (78 GFLOP, 0.078 ms), for the split below.
// Arithmetic. The reference widens everything to fp32. q, k, v and dO are
// bf16 values and scale = 2^-3 (D = 64), so S = (q scale) k^T and
// dP = dO v^T are exact bf16 products with fp32 sums: bf16 mma computes them
// as the reference does, up to summation order (S as scale (k q^T), exact
// for a power of two). P and dS are true fp32 operands of dV += P^T dO and
// dK += dS^T (q scale): each is split into hi = bf16(x) and lo = bf16(x - hi)
// and multiplied twice, which carries it to 2^-16 relative (one bf16
// rounding would be 2^-8, as large as the output's own rounding). dK is
// summed as dS^T q and multiplied by the scale once, exactly.
// Design: one block per (64-key tile, b*h), looping over 64-query tiles
// (from the diagonal tile when causal); warp w owns key rows 16 w .. 16 w +
// 15, keeps their K and V fragments and its dK, dV accumulators in
// registers: no atomics, no reduction across warps. It works transposed, in
// halves of 32 queries: S^T = K_w q^T and dP^T = V_w dO^T read the q and dO
// tiles with ldmatrix; P^T = exp(scale S^T - lse) and dS^T = P^T (dP^T -
// delta) with lse and delta staged in shared memory; then P^T and dS^T, from
// registers, are the A operands of dV += P^T dO and dK += dS^T q, with dO and
// q read through ldmatrix.trans. q, dO, lse and delta stream through two
// cp.async buffers.
__global__ void __launch_bounds__(kMmaThreads)
flash_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, int n_heads,
                       float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  // [k | v | q0 | dO0 | q1 | dO1] swizzled tiles, then [lse0 | delta0 | lse1 |
  // delta1], 64 floats each; k and v stage dK and dV at the end.
  const uint32_t s0 = smem_addr(smem_bytes);
  const uint32_t rows_off = 6 * kTileBytes;
  const float* rows_s = reinterpret_cast<const float*>(smem_bytes + rows_off);
  const int kb = blockIdx.x, bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const long rs = (long)n_heads * kD;
  const long base = (long)b * seq * rs + (long)h * kD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const int first_qb = causal ? kb : 0, n_qb = seq / kTile;
  const float* lse_bh = lse + (long)bh * seq;
  const float* delta_bh = delta + (long)bh * seq;

  auto load_query_tile = [&](int qb, int buf) {
    const uint32_t dst = s0 + kTileBytes * (2 + 2 * buf);
    load_tile(dst, q + base + (long)qb * kTile * rs, rs);
    load_tile(dst + kTileBytes, dout + base + (long)qb * kTile * rs, rs);
    if (threadIdx.x < 32) {  // 16 chunks of lse, 16 of delta
      const int i = threadIdx.x & 15, which = threadIdx.x >> 4;
      const float* src = (which ? delta_bh : lse_bh) + qb * kTile + 4 * i;
      cp_async16(s0 + rows_off + (2 * buf + which) * kTile * 4 + 16 * i, src);
    }
  };

  load_tile(s0, k + base + (long)kb * kTile * rs, rs);
  load_tile(s0 + kTileBytes, v + base + (long)kb * kTile * rs, rs);
  load_query_tile(first_qb, 0);
  cp_async_commit();

  uint32_t kf[4][4], vf[4][4];
  float dk_acc[8][4], dv_acc[8][4];  // [j]: dims 8 j .. 8 j + 7
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int qb = first_qb; qb < n_qb; ++qb) {
    const int buf = (qb - first_qb) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (qb == first_qb) {
      load_a_frags(s0, row0, kf);
      load_a_frags(s0 + kTileBytes, row0, vf);
    }
    if (qb + 1 < n_qb) {
      load_query_tile(qb + 1, buf ^ 1);
      cp_async_commit();
    }
    const uint32_t qs = s0 + kTileBytes * (2 + 2 * buf), dos = qs + kTileBytes;
    const float* lse_s = rows_s + 2 * buf * kTile;
    const float* delta_s = lse_s + kTile;
    const bool diag = causal && qb == kb;

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q0 = 32 * half;
      float st[4][4], dpt[4][4];  // [j]: queries q0 + 8 j .. q0 + 8 j + 7
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t bf[4];
          load_b_rows(qs, q0 + 16 * jp, kk, bf);
          mma_bf16(st[2 * jp], kf[kk], bf[0], bf[1]);
          mma_bf16(st[2 * jp + 1], kf[kk], bf[2], bf[3]);
          load_b_rows(dos, q0 + 16 * jp, kk, bf);
          mma_bf16(dpt[2 * jp], vf[kk], bf[0], bf[1]);
          mma_bf16(dpt[2 * jp + 1], vf[kk], bf[2], bf[3]);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + 8 * j + 2 * t + (e & 1);
          float sc = st[j][e] * scale;
          if (diag && qi < row0 + g + 8 * (e >> 1)) sc = kNegInf;
          const float p = expf(sc - lse_s[qi]);
          dpt[j][e] = p * (dpt[j][e] - delta_s[qi]);  // dS^T
          st[j][e] = p;                               // P^T
        }
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {  // queries q0 + 16 kc .. + 15
        uint32_t ph[4], pl[4], dh[4], dl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 2 * kc + (i >> 1), e = 2 * (i & 1);
          split_bf16(st[j][e], st[j][e + 1], ph[i], pl[i]);
          split_bf16(dpt[j][e], dpt[j][e + 1], dh[i], dl[i]);
        }
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t bf[4];
          load_b_cols(dos, q0 + 16 * kc, dp, bf);
          mma_bf16(dv_acc[2 * dp], ph, bf[0], bf[1]);
          mma_bf16(dv_acc[2 * dp], pl, bf[0], bf[1]);
          mma_bf16(dv_acc[2 * dp + 1], ph, bf[2], bf[3]);
          mma_bf16(dv_acc[2 * dp + 1], pl, bf[2], bf[3]);
          load_b_cols(qs, q0 + 16 * kc, dp, bf);
          mma_bf16(dk_acc[2 * dp], dh, bf[0], bf[1]);
          mma_bf16(dk_acc[2 * dp], dl, bf[0], bf[1]);
          mma_bf16(dk_acc[2 * dp + 1], dh, bf[2], bf[3]);
          mma_bf16(dk_acc[2 * dp + 1], dl, bf[2], bf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] *= scale;
  store_rows(smem_bytes, row0, dk_acc, dk + base + (long)kb * kTile * rs, rs);
  store_rows(smem_bytes + kTileBytes, row0, dv_acc, dv + base + (long)kb * kTile * rs, rs);
}

// ----------------------------------------------------------------- dQ, bf16
// Replaces autodist_tpu/ops/flash_attention.py::_dq_kernel for bf16 inputs.
// Bound at the training shape: operations, 0.0391 ms for the three
// products' 39 GFLOP at the bf16 peak; this kernel runs 4 products' worth of
// tensor-core work (S, dP, and dS K twice, for the split below).
// Arithmetic, as in dK/dV: S = q k^T and dP = dO v^T are exact bf16
// products with fp32 sums, and S times scale = 2^-3 afterwards is exactly
// the reference's (q scale) k^T (D = 64); dS = P (dP - delta) is a true fp32
// operand of dQ += dS K, split into hi = bf16(x) and lo = bf16(x - hi) and
// multiplied twice (2^-16 relative). dQ is summed as dS K and multiplied by
// the scale once at the end, as the reference does.
// Design: the forward's layout. One block per (64-query tile, b*h) loops
// over 64-key tiles (up to the diagonal tile when causal, only that tile
// masked); warp w owns query rows 16 w .. 16 w + 15 and keeps in registers
// their q and dO A fragments, lse and delta of its rows g and g + 8, and a
// 16 x 64 fp32 dQ accumulator: no atomics, no reduction across warps, so
// results are deterministic. K and V stream through two swizzled cp.async
// buffers. Each key tile is taken in halves of 32 keys (S and dP
// accumulators for 32 keys, not 64, keep the kernel clear of spills): S and
// dP read K and V with ldmatrix; P and dS are formed on the accumulators;
// dS, split hi/lo from registers, is the A operand of dQ += dS K with K read
// through ldmatrix.trans.
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dq, int seq, int n_heads, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  // [q | dO | k0 | v0 | k1 | v1], each a swizzled 64 x 64 tile; q stages dQ
  // at the end.
  const uint32_t s0 = smem_addr(smem_bytes);
  const int qb = blockIdx.x, bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const long rs = (long)n_heads * kD;
  const long base = (long)b * seq * rs + (long)h * kD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const int n_kb = causal ? qb + 1 : seq / kTile;

  load_tile(s0, q + base + (long)qb * kTile * rs, rs);
  load_tile(s0 + kTileBytes, dout + base + (long)qb * kTile * rs, rs);
  load_tile(s0 + 2 * kTileBytes, k + base, rs);
  load_tile(s0 + 3 * kTileBytes, v + base, rs);
  cp_async_commit();

  const float* lse_r = lse + (long)bh * seq + qb * kTile + row0 + g;
  const float* delta_r = delta + (long)bh * seq + qb * kTile + row0 + g;
  const float lse_g[2] = {lse_r[0], lse_r[8]};      // rows g, g + 8
  const float delta_g[2] = {delta_r[0], delta_r[8]};

  uint32_t qf[4][4], df[4][4];
  float acc[8][4];  // [j]: dims 8 j .. 8 j + 7
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kb = 0; kb < n_kb; ++kb) {
    cp_async_wait_all();
    __syncthreads();
    if (kb == 0) {
      load_a_frags(s0, row0, qf);
      load_a_frags(s0 + kTileBytes, row0, df);
    }
    if (kb + 1 < n_kb) {
      const uint32_t nxt = s0 + kTileBytes * (2 + 2 * ((kb + 1) & 1));
      load_tile(nxt, k + base + (long)(kb + 1) * kTile * rs, rs);
      load_tile(nxt + kTileBytes, v + base + (long)(kb + 1) * kTile * rs, rs);
      cp_async_commit();
    }
    const uint32_t ks = s0 + kTileBytes * (2 + 2 * (kb & 1)), vs = ks + kTileBytes;
    const bool diag = causal && kb == qb;

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k0 = 32 * half;
      float sc[4][4], dp[4][4];  // [j]: keys k0 + 8 j .. k0 + 8 j + 7
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t bf[4];
          load_b_rows(ks, k0 + 16 * jp, kk, bf);
          mma_bf16(sc[2 * jp], qf[kk], bf[0], bf[1]);
          mma_bf16(sc[2 * jp + 1], qf[kk], bf[2], bf[3]);
          load_b_rows(vs, k0 + 16 * jp, kk, bf);
          mma_bf16(dp[2 * jp], df[kk], bf[0], bf[1]);
          mma_bf16(dp[2 * jp + 1], df[kk], bf[2], bf[3]);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * scale;
          if (diag && k0 + 8 * j + 2 * t + (e & 1) > row0 + g + 8 * (e >> 1)) x = kNegInf;
          const float p = expf(x - lse_g[e >> 1]);
          dp[j][e] = p * (dp[j][e] - delta_g[e >> 1]);  // dS
        }
      // dQ += dS K: keys k0 + 16 kc .. + 15 of dS are tiles 2 kc, 2 kc + 1.
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t dh[4], dl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 2 * kc + (i >> 1), e = 2 * (i & 1);
          split_bf16(dp[j][e], dp[j][e + 1], dh[i], dl[i]);
        }
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          uint32_t bf[4];
          load_b_cols(ks, k0 + 16 * kc, dd, bf);
          mma_bf16(acc[2 * dd], dh, bf[0], bf[1]);
          mma_bf16(acc[2 * dd], dl, bf[0], bf[1]);
          mma_bf16(acc[2 * dd + 1], dh, bf[2], bf[3]);
          mma_bf16(acc[2 * dd + 1], dl, bf[2], bf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= scale;
  store_rows(smem_bytes, row0, acc, dq + base + (long)qb * kTile * rs, rs);
}

// ------------------------------------------------------------------ launch
constexpr size_t kFwdSmem = sizeof(float) * 3 * kTileFloats;
constexpr size_t kDkdvSmem = sizeof(float) * (6 * kTileFloats + 2 * kTile);
constexpr size_t kDqSmem = sizeof(float) * 5 * kTileFloats;
constexpr size_t kFwdBf16Smem = 5 * kTileBytes;                          // 40 KB
constexpr size_t kDkdvBf16Smem = 6 * kTileBytes + 4 * kTile * sizeof(float);  // 49 KB
constexpr size_t kDqBf16Smem = 6 * kTileBytes;                           // 48 KB

bool shape_ok(int batch, int seq, int n_heads, int head_dim) {
  return head_dim == kD && seq > 0 && seq % kTile == 0 && batch > 0 && n_heads > 0 &&
         (long)batch * n_heads <= 65535;
}

// cp.async and the 16-byte stores of the bf16 kernels need 16-byte alignment.
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// Sets the kernel's dynamic shared memory, launches it over (seq / 64, B*H)
// blocks and returns the launch's error.
template <typename... Params>
cudaError_t launch(void (*kernel)(Params...), int threads, size_t smem, int batch, int seq,
                   int n_heads, cudaStream_t stream, Params... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(seq / kTile, batch * n_heads), threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// Each returns 0 on success, else the cudaError_t of the launch (or
// cudaErrorInvalidValue for a shape, dtype or alignment that is not built:
// head_dim must be 64, seq a multiple of 64, batch * heads at most 65535,
// bf16 pointers 16-byte aligned; dtype 0 fp32, 1 bf16). Tensors are
// [B, S, H, D] contiguous; lse and delta [B*H, S] fp32. bf16 takes the
// tensor-core kernels, fp32 the FMA kernels.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int batch, int seq, int n_heads,
                                   int head_dim, int dtype, int causal, float scale,
                                   void* stream) {
  if (!shape_ok(batch, seq, n_heads, head_dim)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch(flash_fwd_kernel, kThreads, kFwdSmem, batch, seq, n_heads, s,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<float*>(o),
                  static_cast<float*>(lse), seq, n_heads, scale, causal);
  if (dtype == kBF16) {
    if (!aligned16({q, k, v, o, lse})) return cudaErrorInvalidValue;
    return launch(flash_fwd_bf16_kernel, kMmaThreads, kFwdBf16Smem, batch, seq, n_heads, s,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<bf16*>(o),
                  static_cast<float*>(lse), seq, n_heads, scale, causal);
  }
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_dkdv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int batch, int seq, int n_heads,
                                    int head_dim, int dtype, int causal, float scale,
                                    void* stream) {
  if (!shape_ok(batch, seq, n_heads, head_dim)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch(flash_dkdv_kernel, kThreads, kDkdvSmem, batch, seq, n_heads, s,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<float*>(dk), static_cast<float*>(dv), seq, n_heads, scale,
                  causal);
  if (dtype == kBF16) {
    if (!aligned16({q, k, v, dout, lse, delta, dk, dv})) return cudaErrorInvalidValue;
    return launch(flash_dkdv_bf16_kernel, kMmaThreads, kDkdvBf16Smem, batch, seq, n_heads,
                  s, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq, n_heads, scale,
                  causal);
  }
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dq_out, int batch, int seq, int n_heads,
                                  int head_dim, int dtype, int causal, float scale,
                                  void* stream) {
  if (!shape_ok(batch, seq, n_heads, head_dim)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch(flash_dq_kernel, kThreads, kDqSmem, batch, seq, n_heads, s,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<float*>(dq_out), seq, n_heads, scale, causal);
  if (dtype == kBF16) {
    if (!aligned16({q, k, v, dout, lse, delta, dq_out})) return cudaErrorInvalidValue;
    return launch(flash_dq_bf16_kernel, kMmaThreads, kDqBf16Smem, batch, seq, n_heads, s,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<bf16*>(dq_out), seq, n_heads, scale, causal);
  }
  return cudaErrorInvalidValue;
}
