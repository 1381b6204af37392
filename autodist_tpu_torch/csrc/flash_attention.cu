// Flash attention forward and backward (dK/dV, dQ) for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of autodist_tpu/ops/flash_attention.py:
//   flash_fwd_kernel   <- _fwd_kernel   (launched by _pallas_forward)
//   flash_dkdv_kernel  <- _dkdv_kernel  (launched by _flash_bwd)
//   flash_dq_kernel    <- _dq_kernel    (launched by _flash_bwd)
// and keeps their arithmetic: scores in fp32 (inputs widened, fp32 sums),
// scale 1/sqrt(D), causal mask value -1e30 (not -inf, so a fully masked row
// gives the same lse as the TPU kernel), online softmax with fp32 m / l /
// acc, p rounded to V's dtype before P.V, l == 0 read as 1, lse = m + log l.
// The backward recomputes P = exp(S - lse) from the forward's lse, takes
// delta = rowsum(dO * O) from the caller (a plain tensor op, as the JAX
// package leaves it to XLA) and works in fp32 throughout: q is widened and
// pre-scaled, so dK = dS^T (q * scale) is already dL/dK and dQ is scaled once
// at the end. Outputs are written in the inputs' dtype.
//
// Layout. q, k, v, o, dO, dq, dk, dv are [B, S, H, D] contiguous (the
// transformer's natural shape); each block reads its (b, h) slice through
// the row stride H * D instead of a folded [B*H, S, D] copy. lse and delta
// are [B*H, S] fp32. D is 64 (every zoo transformer); S a multiple of 64.
//
// Design. The TPU grid is sequential per (b*h) and carries m/l/acc (fwd, dq)
// or dk/dv (dkdv) in VMEM from one grid step to the next. Hopper blocks run
// in no order, so the streamed axis becomes a loop inside one block:
// - fwd and dq: one block per (64-query tile, b*h) loops over 64-key tiles
//   (up to the diagonal tile when causal);
// - dkdv: one block per (64-key tile, b*h) loops over 64-query tiles (from
//   the diagonal tile when causal).
// The two-kernel backward needs no atomics: every output row has one owner.
// Tiles are 64 x 64 and staged in shared memory as fp32, rows padded to
// D + 1 floats so the column walks of the score loops hit distinct banks.
// A block has 256 threads: 4 per tile row. Thread (row r, lane g) owns the
// 16 score columns g, g + 4, ..., g + 60 of its row and the 16 output dims
// g, g + 4, ..., g + 60; its row's operand (q, k, v or dO) sits in 64
// registers. Row reductions of the softmax are two shuffles among the 4
// lanes of a row.
//
// Bound on an H100 SXM. At the training shape (B = 32, S = 512, H = 12,
// D = 64, bf16, non-causal) the forward moves 101 MB (0.030 ms at
// 3.35 TB/s) against 26 GFLOP (0.026 ms at the 989 TFLOP/s bf16 peak), so
// bytes bound it, barely; the backward kernels' 52 and 39 GFLOP (0.052 and
// 0.039 ms) bound them; causal, or at S <= 256, all three are bound by
// bytes. This version does its products as fp32 FMAs on the CUDA cores
// (67 TFLOP/s peak, and each FMA also reads one operand from shared
// memory), so it runs far above those bounds; tensor-core tiles and TMA
// staging are the next steps. The measured times are in PERF.md.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (autodist_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head dim
constexpr int kTile = 64;       // rows of a Q or K tile
constexpr int kPad = kD + 1;    // shared-memory row stride (floats)
constexpr int kLanes = 4;       // threads per tile row
constexpr int kPer = kTile / kLanes;  // score columns / output dims per thread
constexpr int kThreads = kTile * kLanes;
constexpr int kTileFloats = kTile * kPad;
constexpr float kNegInf = -1e30f;  // the JAX package's _NEG_INF

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Max / sum over the 4 lanes of one tile row (consecutive lanes of a warp).
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stage rows [0, 64) of a [*, row_stride] slice into dst[64][kPad] as fp32,
// times mul (1, or the softmax scale for the backward's pre-scaled q).
template <typename T>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, long row_stride,
                                           float mul) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    dst[r * kPad + d] = to_f32(src[r * row_stride + d]) * mul;
  }
}

// ------------------------------------------------------------------ forward
// Replaces autodist_tpu/ops/flash_attention.py::_fwd_kernel. Bound at the
// training shape: bytes (q, k, v, o; 2 products per tile pair come close).
// Design: q row in registers, K and V tiles staged once per iteration for
// all 64 query rows; the causal loop stops at the diagonal tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
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
  const T* qp = q + base + (long)q_row * rs;
#pragma unroll
  for (int d = 0; d < kD; ++d) qreg[d] = to_f32(qp[d]);

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
      p_s[r * kPad + g + kLanes * t] = to_f32(from_f32<T>(p));  // p.astype(v.dtype)
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
  T* op = o + base + (long)q_row * rs;
#pragma unroll
  for (int j = 0; j < kPer; ++j) op[g + kLanes * j] = from_f32<T>(acc[j] / l_safe);
  if (g == 0) lse[(long)bh * seq + q_row] = m + logf(l_safe);
}

// ---------------------------------------------------------------- dK and dV
// Replaces autodist_tpu/ops/flash_attention.py::_dkdv_kernel. Bound at the
// training shape: operations (4 products per tile pair). Design: this block's K and V tiles stay in shared memory
// for the whole query loop; P and dS go through shared memory so each key
// row's 4 lanes can sum P^T dO and dS^T q over the query tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv, int seq, int n_heads,
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
  T* dkp = dk + base + (long)k_row * rs;
  T* dvp = dv + base + (long)k_row * rs;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    dkp[g + kLanes * j] = from_f32<T>(dk_acc[j]);
    dvp[g + kLanes * j] = from_f32<T>(dv_acc[j]);
  }
}

// ----------------------------------------------------------------------- dQ
// Replaces autodist_tpu/ops/flash_attention.py::_dq_kernel. Bound at the
// training shape: operations (3 products per tile pair). Design: the query
// and dO tiles stay in shared memory for the whole key loop; dS needs no
// barrier across warps, since a row's dS is made and used by its own lanes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int seq, int n_heads, float scale, int causal) {
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
  T* dqp = dq + base + (long)q_row * rs;
#pragma unroll
  for (int j = 0; j < kPer; ++j) dqp[g + kLanes * j] = from_f32<T>(dq_acc[j] * scale);
}

// ------------------------------------------------------------------ launch
constexpr size_t kFwdSmem = sizeof(float) * 3 * kTileFloats;
constexpr size_t kDkdvSmem = sizeof(float) * (6 * kTileFloats + 2 * kTile);
constexpr size_t kDqSmem = sizeof(float) * 5 * kTileFloats;

bool shape_ok(int batch, int seq, int n_heads, int head_dim) {
  return head_dim == kD && seq > 0 && seq % kTile == 0 && batch > 0 && n_heads > 0 &&
         (long)batch * n_heads <= 65535;
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                int batch, int seq, int n_heads, float scale, int causal,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / kTile, batch * n_heads);
  flash_fwd_kernel<T><<<grid, kThreads, kFwdSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), seq, n_heads, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkdv(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dk, void* dv, int batch,
                 int seq, int n_heads, float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDkdvSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / kTile, batch * n_heads);
  flash_dkdv_kernel<T><<<grid, kThreads, kDkdvSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), seq,
      n_heads, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq_out, int batch, int seq,
               int n_heads, float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDqSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(seq / kTile, batch * n_heads);
  flash_dq_kernel<T><<<grid, kThreads, kDqSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq_out), seq, n_heads, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// Each returns 0 on success, else the cudaError_t of the launch (or
// cudaErrorInvalidValue for a shape or dtype that is not built: head_dim must
// be 64, seq a multiple of 64, batch * heads at most 65535; dtype 0 fp32,
// 1 bf16). Tensors are [B, S, H, D] contiguous; lse and delta [B*H, S] fp32.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int batch, int seq, int n_heads,
                                   int head_dim, int dtype, int causal, float scale,
                                   void* stream) {
  if (!shape_ok(batch, seq, n_heads, head_dim)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return fwd<float>(q, k, v, o, lse, batch, seq, n_heads, scale, causal, s);
  if (dtype == kBF16)
    return fwd<__nv_bfloat16>(q, k, v, o, lse, batch, seq, n_heads, scale, causal, s);
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
    return dkdv<float>(q, k, v, dout, lse, delta, dk, dv, batch, seq, n_heads, scale,
                       causal, s);
  if (dtype == kBF16)
    return dkdv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, batch, seq, n_heads,
                               scale, causal, s);
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
    return dq<float>(q, k, v, dout, lse, delta, dq_out, batch, seq, n_heads, scale,
                     causal, s);
  if (dtype == kBF16)
    return dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq_out, batch, seq, n_heads,
                             scale, causal, s);
  return cudaErrorInvalidValue;
}
