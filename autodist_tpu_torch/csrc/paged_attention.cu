// Paged attention over a KV page pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel autodist_tpu/ops/paged_attention.py::
// _paged_kernel (launched by _kernel_attention). It computes, for each row b
// and query i of q [B, Q, H, D], softmax(q_i . K^T / sqrt(D)) V over the
// row's KV timeline, read page by page through page_tables [B, P]; timeline
// slot t = p * page_len + off is admitted iff t <= q_positions[b, i].
// Pages hold the cache dtype (fp32 or bf16) or int8 with fp32 per-(position,
// head) scales, dequantised here as they are staged.
//
// Design. The TPU kernel walks a sequential (B, P) grid and carries m/l/acc
// in VMEM from one grid step to the next. Blocks on Hopper run in no order,
// so the page walk is a loop inside the block instead: one block per (row b,
// head h, tile of up to 16 queries). Each iteration stages the K and V
// slices of head h for the next 64 timeline slots — whole pages, in table
// order — in shared memory as fp32 (K rows padded to D + 1 floats so the
// score loop's row reads hit distinct banks), forms the fp32 scores of the
// tile's queries against them, and runs the online softmax with one warp
// per query row, m/l in shared memory and acc in registers. The walk starts
// at page 0: slot 0 is always admitted (positions are >= 0), so the first
// iteration seeds m with a finite logit and every later masked slot
// contributes exp(-1e30 - m) == 0 exactly. That is also why the walk stops
// after page max(qpos of the tile) / page_len: the pages past it contribute
// exactly 0. Finalise: acc / l with l == 0 read as 1, in q's dtype.
//
// Bound on an H100 SXM: decode (Q = 1) is bound by bytes, i.e. the K, V (and
// scale) bytes of each row's live pages over 3.35 TB/s. This version does
// its arithmetic in fp32 on the CUDA cores (no tensor cores, no TMA; K/V
// come in as 16-byte vector loads, all issued before use); its times
// against that bound are in PERF.md.
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (autodist_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQTile = 16;
constexpr int kSlots = 64;   // timeline slots staged per iteration (page_len <= 64)
constexpr float kNegInf = -1e30f;  // the JAX package's NEG_INF

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory floats for one block (q tile, padded K, V, scores).
template <int D>
constexpr size_t smem_floats() {
  return kQTile * D + kSlots * (D + 1) + kSlots * D + kQTile * kSlots;
}

template <typename QT, typename PT, bool kQuant, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q,
                       const PT* __restrict__ k_pages,
                       const PT* __restrict__ v_pages,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ qpos,
                       QT* __restrict__ out,
                       int n_q, int n_heads, int page_len, int n_tables,
                       float scale) {
  constexpr int kKStride = D + 1;       // padded: the score loop reads K by row
  constexpr int kVec = 16 / sizeof(PT);  // page elements per 16-byte load
  constexpr int kVecPerRow = D / kVec;
  constexpr int kLoads = (kSlots * kVecPerRow + kThreads - 1) / kThreads;
  static_assert(D % kVec == 0, "a K/V row must be whole 16-byte vectors");
  extern __shared__ float smem[];
  float* q_s = smem;                    // [kQTile][D]
  float* k_s = q_s + kQTile * D;        // [kSlots][D + 1]
  float* v_s = k_s + kSlots * kKStride; // [kSlots][D]
  float* s_s = v_s + kSlots * D;        // [kQTile][kSlots] scores, then p
  __shared__ float m_s[kQTile];
  __shared__ float l_s[kQTile];
  __shared__ float alpha_s[kQTile];
  __shared__ int qpos_s[kQTile];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * kQTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rows = min(kQTile, n_q - q0);

  if (tid < kQTile) {
    qpos_s[tid] = tid < rows ? qpos[(size_t)b * n_q + q0 + tid] : -1;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    alpha_s[tid] = 1.f;
  }
  for (int e = tid; e < rows * D; e += kThreads) {
    const int qi = e / D, d = e % D;
    q_s[e] = to_f32(q[(((size_t)b * n_q + q0 + qi) * n_heads + h) * D + d]);
  }
  __syncthreads();

  int max_pos = 0;
  for (int i = 0; i < rows; ++i) max_pos = max(max_pos, qpos_s[i]);
  const int n_live = min(n_tables, max_pos / page_len + 1);
  const int group = kSlots / page_len;  // whole pages staged per iteration

  constexpr int kAcc = kQTile * D / kThreads;  // D=64: 8, D=16: 2
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const int32_t* table = tables + (size_t)b * n_tables;
  for (int p0 = 0; p0 < n_live; p0 += group) {
    // The group's pages p0, p0 + 1, ... in order: its slot j is timeline
    // slot p0 * page_len + j.
    const int n_slots = min(group, n_live - p0) * page_len;
    // Stage K and V as 16-byte vectors: every load of the group is issued
    // before the first one is used, then dequantised into shared memory.
    const int n_vec = n_slots * kVecPerRow;
    uint4 kr[kLoads], vr[kLoads];
    float ksc[kLoads], vsc[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = tid + i * kThreads;
      if (c < n_vec) {
        const int j = c / kVecPerRow, dv = (c % kVecPerRow) * kVec;
        const size_t page = (size_t)table[p0 + j / page_len];
        const size_t row = (page * page_len + j % page_len) * n_heads + h;
        kr[i] = *reinterpret_cast<const uint4*>(k_pages + row * D + dv);
        vr[i] = *reinterpret_cast<const uint4*>(v_pages + row * D + dv);
        if constexpr (kQuant) {
          ksc[i] = k_scale[row];
          vsc[i] = v_scale[row];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = tid + i * kThreads;
      if (c < n_vec) {
        const int j = c / kVecPerRow, dv = (c % kVecPerRow) * kVec;
        const PT* ke = reinterpret_cast<const PT*>(&kr[i]);
        const PT* ve = reinterpret_cast<const PT*>(&vr[i]);
        const float ks = kQuant ? ksc[i] : 1.f;
        const float vs = kQuant ? vsc[i] : 1.f;
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          k_s[j * kKStride + dv + u] = kQuant ? to_f32(ke[u]) * ks : to_f32(ke[u]);
          v_s[j * D + dv + u] = kQuant ? to_f32(ve[u]) * vs : to_f32(ve[u]);
        }
      }
    }
    __syncthreads();
    // Scaled, masked fp32 scores of the tile's queries against the group.
    const int t0 = p0 * page_len;
    for (int e = tid; e < rows * n_slots; e += kThreads) {
      const int qi = e / n_slots, j = e % n_slots;
      const float* qr = q_s + qi * D;
      const float* kr = k_s + j * kKStride;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      s_s[qi * kSlots + j] = (t0 + j <= qpos_s[qi]) ? dot * scale : kNegInf;
    }
    __syncthreads();
    // Online softmax update, one warp per query row.
    for (int qi = warp; qi < rows; qi += kThreads / 32) {
      float* srow = s_s + qi * kSlots;
      const float m_old = m_s[qi];
      float mx = kNegInf;
      for (int j = lane; j < n_slots; j += 32) mx = fmaxf(mx, srow[j]);
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < n_slots; j += 32) {
        const float pe = expf(srow[j] - m_new);
        srow[j] = pe;
        sum += pe;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[qi] = alpha * l_s[qi] + sum;
        m_s[qi] = m_new;
        alpha_s[qi] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p . V
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads;
      const int qi = e / D, d = e % D;
      if (qi < rows) {
        const float* prow = s_s + qi * kSlots;
        float pv = 0.f;
        for (int j = 0; j < n_slots; ++j) pv = fmaf(prow[j], v_s[j * D + d], pv);
        acc[i] = acc[i] * alpha_s[qi] + pv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    const int qi = e / D, d = e % D;
    if (qi < rows) {
      float l = l_s[qi];
      l = (l == 0.f) ? 1.f : l;
      out[(((size_t)b * n_q + q0 + qi) * n_heads + h) * D + d] = from_f32<QT>(acc[i] / l);
    }
  }
}

template <typename QT, typename PT, bool kQuant, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* tables, const void* qpos, void* out,
                   int batch, int n_q, int n_heads, int page_len, int n_tables,
                   cudaStream_t stream) {
  const dim3 grid(batch, n_heads, (n_q + kQTile - 1) / kQTile);
  const size_t smem = sizeof(float) * smem_floats<D>();
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  paged_attention_kernel<QT, PT, kQuant, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k), static_cast<const PT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(qpos),
      static_cast<QT*>(out), n_q, n_heads, page_len, n_tables, scale);
  return cudaGetLastError();
}

template <typename QT, typename PT, bool kQuant>
cudaError_t launch_d(int head_dim, const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* tables,
                     const void* qpos, void* out, int batch, int n_q, int n_heads,
                     int page_len, int n_tables, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<QT, PT, kQuant, 16>(q, k, v, ks, vs, tables, qpos, out, batch,
                                        n_q, n_heads, page_len, n_tables, stream);
    case 64:
      return launch<QT, PT, kQuant, 64>(q, k, v, ks, vs, tables, qpos, out, batch,
                                        n_q, n_heads, page_len, n_tables, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns 0 on success, else the cudaError_t of the launch (or
// cudaErrorInvalidValue for a head_dim / dtype combination not built).
// q_dtype: 0 fp32, 1 bf16; page_dtype: 0 fp32, 1 bf16, 2 int8 (needs scales).
extern "C" int paged_attention_forward(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const void* tables, const void* qpos, void* out,
    int batch, int n_q, int n_heads, int head_dim, int page_len, int n_tables,
    int q_dtype, int page_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_ARGS head_dim, q, k_pages, v_pages, k_scale, v_scale, tables, qpos, out, \
                batch, n_q, n_heads, page_len, n_tables, s
  if (q_dtype == kF32 && page_dtype == kF32)
    return launch_d<float, float, false>(PA_ARGS);
  if (q_dtype == kBF16 && page_dtype == kBF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16, false>(PA_ARGS);
  if (q_dtype == kF32 && page_dtype == kBF16)
    return launch_d<float, __nv_bfloat16, false>(PA_ARGS);
  if (q_dtype == kBF16 && page_dtype == kF32)
    return launch_d<__nv_bfloat16, float, false>(PA_ARGS);
  if (q_dtype == kBF16 && page_dtype == kI8)
    return launch_d<__nv_bfloat16, int8_t, true>(PA_ARGS);
  if (q_dtype == kF32 && page_dtype == kI8)
    return launch_d<float, int8_t, true>(PA_ARGS);
#undef PA_ARGS
  return cudaErrorInvalidValue;
}
