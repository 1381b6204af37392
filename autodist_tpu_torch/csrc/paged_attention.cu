// Paged attention over a KV page pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel autodist_tpu/ops/paged_attention.py::
// _paged_kernel (launched by _kernel_attention). It computes, for each row b
// and query i of q [B, Q, H, D], softmax(q_i . K^T / sqrt(D)) V over the
// row's KV timeline, read page by page through page_tables [B, P]; timeline
// slot t = p * page_len + off is admitted iff t <= q_positions[b, i].
// Pages hold the cache dtype (fp32 or bf16) or int8 with fp32 per-(position,
// head) scales, dequantised here in registers. Arithmetic is fp32 throughout.
//
// Design. The TPU kernel walks a sequential (B, P) grid and carries m/l/acc
// in VMEM from one grid step to the next. Blocks on Hopper run in no order
// and one walk per (row, head) leaves most of the 132 SMs idle (12 blocks at
// prefill), so the walk is split:
// - paged_split_kernel: one block of 4 warps per (q-tile, split, head, row).
//   A q-tile is 1 query (decode) or 4; a split is a run of whole pages,
//   chosen by the host from the table width, B * H * tiles and the SM count
//   (ops/paged_attention.py::split_plan). The block stages its split's page
//   numbers in shared memory, then each warp takes runs of 16 timeline slots
//   in turn. A lane owns 8 dims (D / 8 lanes a slot) of one slot of a step;
//   it reads K and V with 16-byte loads (8 bytes for int8) straight into
//   registers, all of a run's loads issued before the first is used,
//   dequantises there, forms partial dot products for the tile's queries
//   and sums them over the slot's lanes with shuffles. Each warp runs its
//   own online softmax (m, l, acc in registers); the 4 warps' states are
//   combined by log-sum-exp through shared memory at the end. No barrier
//   inside the walk.
// - paged_merge_kernel: when there is more than one split, combines the
//   splits' fp32 (m, l, acc) partials by log-sum-exp in split order (no
//   atomics: repeated launches are bitwise equal) and writes acc / l, with
//   l == 0 read as 1, in q's dtype. With one split the split kernel writes
//   the output itself.
// Masking. A slot past the query's position (or past the split) gets p = 0
// exactly and leaves m alone, so a split, or a warp, in which every slot of
// a query is masked carries m = -1e30, l = 0, acc = 0: weight 0 in the merge.
// (The TPU kernel instead relies on slot 0, always admitted, seeding m with a
// finite logit before any masked slot, so that exp(-1e30 - m) == 0; in a
// split that begins past a query's position that seed is missing.) The two
// agree for positions >= 0, the engine's; a negative position admits no slot
// here and gives 0. Splits past the q-tile's last live slot exit at once,
// and the merge reads only the splits a query's position reaches.
//
// Bound on an H100 SXM: decode (Q = 1) is bound by bytes, i.e. the K, V (and
// scale) bytes of each row's live pages over 3.35 TB/s; its times against
// that bound are in PERF.md. Tensor cores for prefill and verify are later
// work (ROADMAP).
//
// Plain C interface, built by nvcc into a shared library and loaded with
// ctypes (autodist_tpu_torch/ops/_build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRun = 16;            // timeline slots a warp takes at once
constexpr float kNegInf = -1e30f;   // the JAX package's NEG_INF
constexpr int kMaxPagesPerSplit = 8192;  // page numbers a split stages

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// 8 consecutive page elements as raw vector registers: 32 bytes of fp32 (two
// 16-byte loads), 16 of bf16, 8 of int8; widened to fp32 with bit operations
// on the registers (bf16 is the high half of an fp32; int8 is sign-extended
// by an arithmetic shift), so nothing goes through local memory.
template <typename PT> struct Vec8;
template <> struct Vec8<float> {
  uint4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const uint4*>(p)[0];
    b = reinterpret_cast<const uint4*>(p)[1];
  }
  __device__ __forceinline__ void to_f32(float mul, float (&x)[8]) const {
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = __uint_as_float(w[u]);
  }
};
template <> struct Vec8<__nv_bfloat16> {
  uint4 a;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    a = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void to_f32(float mul, float (&x)[8]) const {
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[2 * u] = __uint_as_float(w[u] << 16);               // low half: element 2u
      x[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);  // high half: 2u + 1
    }
  }
};
template <> struct Vec8<int8_t> {
  uint2 a;
  __device__ __forceinline__ void load(const int8_t* p) { a = *reinterpret_cast<const uint2*>(p); }
  // int8 times its row's fp32 scale, as dequantize_kv does.
  __device__ __forceinline__ void to_f32(float mul, float (&x)[8]) const {
    const uint32_t w[2] = {a.x, a.y};
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = static_cast<int>(w[u >> 2] << (24 - 8 * (u & 3))) >> 24;
      x[u] = static_cast<float>(e) * mul;
    }
  }
};

// Shared memory of a split block: the 4 warps' (m, l, acc) for the merge at
// the end, then the split's page numbers.
template <int D, int kQ>
__host__ __device__ constexpr size_t merge_floats() {
  return kWarps * kQ * (D + 2);
}
// Within the 48 KB a launch may take without opting in, at every layout.
static_assert(sizeof(float) * merge_floats<64, 4>() + sizeof(int32_t) * kMaxPagesPerSplit <=
                  48 * 1024,
              "a split's shared memory fits the default limit");

template <typename QT, typename PT, bool kQuant, int D, int kQ>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const QT* __restrict__ q,
                   const PT* __restrict__ k_pages,
                   const PT* __restrict__ v_pages,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int32_t* __restrict__ tables,
                   const int32_t* __restrict__ qpos,
                   QT* __restrict__ out,
                   float2* __restrict__ part_ml,   // [n_split][B * Q * H] (m, l)
                   float* __restrict__ part_acc,   // [n_split][B * Q * H][D]
                   int n_q, int n_heads, int page_len, int n_tables,
                   int pages_per_split, int n_split, float scale) {
  constexpr int kL = D / 8;           // lanes of a slot, 8 dims each
  constexpr int kS = 32 / kL;         // slots of a warp step
  constexpr int kSteps = kRun / kS;   // steps of a run
  static_assert(kSteps * kS == kRun, "a run is whole steps");
  extern __shared__ float smem[];
  float* m_s = smem;                           // [kWarps][kQ]
  float* l_s = m_s + kWarps * kQ;              // [kWarps][kQ]
  float* acc_s = l_s + kWarps * kQ;            // [kWarps][kQ][D]
  int32_t* page_s = reinterpret_cast<int32_t*>(smem + merge_floats<D, kQ>());

  const int n_tiles = (n_q + kQ - 1) / kQ;
  const int split = blockIdx.x / n_tiles, q0 = (blockIdx.x % n_tiles) * kQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = lane % kL, sg = lane / kL;     // dims 8 c .. 8 c + 7 of step slot sg

  // The split's page numbers, its queries' positions (-1 past n_q: admits
  // nothing) and q, all loads issued together.
  const int first_page = split * pages_per_split;
  const int n_pages = min(pages_per_split, n_tables - first_page);
  const int32_t* table = tables + (size_t)b * n_tables + first_page;
  for (int i = tid; i < n_pages; i += kThreads) page_s[i] = table[i];
  int pos[kQ];
  int max_pos = 0;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    pos[i] = q0 + i < n_q ? qpos[(size_t)b * n_q + q0 + i] : -1;
    max_pos = max(max_pos, pos[i]);
  }
  float qf[kQ][8];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const QT* qr = q + (((size_t)b * n_q + q0 + i) * n_heads + h) * D + 8 * c;
#pragma unroll
    for (int u = 0; u < 8; ++u) qf[i][u] = q0 + i < n_q ? to_f32(qr[u]) : 0.f;
  }
  const int begin = first_page * page_len;
  const int end = min(begin + n_pages * page_len, max_pos + 1);
  if (begin >= end) return;  // past the tile's last live slot (never split 0)
  __syncthreads();

  float m[kQ], l[kQ], acc[kQ][8];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.f;
  }

  for (int r0 = begin + warp * kRun; r0 < end; r0 += kWarps * kRun) {
    // A slot past the end reads the last live slot again (finite, masked to
    // p = 0 below), so every load is unconditional and no register selects
    // between a loaded value and a default.
    Vec8<PT> kr[kSteps], vr[kSteps];
    float ksc[kSteps], vsc[kSteps];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int t = min(r0 + st * kS + sg, end - 1);
      const size_t page = (size_t)page_s[t / page_len - first_page];
      const size_t row = (page * page_len + t % page_len) * n_heads + h;
      kr[st].load(k_pages + row * D + 8 * c);
      vr[st].load(v_pages + row * D + 8 * c);
      if constexpr (kQuant) {
        ksc[st] = k_scale[row];
        vsc[st] = v_scale[row];
      }
    }
    // Scaled fp32 scores of the tile's queries against the run's slots.
    float s[kQ][kSteps];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      float kf[8];
      kr[st].to_f32(kQuant ? ksc[st] : 1.f, kf);
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) dot = fmaf(qf[i][u], kf[u], dot);
#pragma unroll
        for (int o = kL / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[i][st] = dot * scale;
      }
    }
    float vf[kSteps][8];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) vr[st].to_f32(kQuant ? vsc[st] : 1.f, vf[st]);
    // Online softmax of each query over the run: masked slots get p = 0.
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int t = r0 + st * kS + sg;
        if (t < end && t <= pos[i]) mx = fmaxf(mx, s[i][st]);
      }
#pragma unroll
      for (int o = kL; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[i][u] *= alpha;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int t = r0 + st * kS + sg;
        const float p = (t < end && t <= pos[i]) ? expf(s[i][st] - m_new) : 0.f;
        l[i] += p;
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[i][u] = fmaf(p, vf[st][u], acc[i][u]);
      }
    }
  }

  // The warp's l and acc summed over its step slots; then the 4 warps
  // combined by log-sum-exp.
#pragma unroll
  for (int i = 0; i < kQ; ++i)
#pragma unroll
    for (int o = kL; o < 32; o <<= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[i][u] += __shfl_xor_sync(0xffffffffu, acc[i][u], o);
    }
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      m_s[warp * kQ + i] = m[i];
      l_s[warp * kQ + i] = l[i];
    }
  if (sg == 0)
#pragma unroll
    for (int i = 0; i < kQ; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) acc_s[(warp * kQ + i) * D + 8 * c + u] = acc[i][u];
  __syncthreads();
  const size_t rows = (size_t)gridDim.z * n_q * n_heads;
  for (int e = tid; e < kQ * D; e += kThreads) {
    const int i = e / D, d = e % D;
    if (q0 + i >= n_q) break;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_s[w * kQ + i]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(m_s[w * kQ + i] - mm);
      ll += l_s[w * kQ + i] * wt;
      aa += acc_s[(w * kQ + i) * D + d] * wt;
    }
    const size_t row = ((size_t)b * n_q + q0 + i) * n_heads + h;
    if (n_split == 1) {
      out[row * D + d] = from_f32<QT>(aa / (ll == 0.f ? 1.f : ll));
    } else {
      part_acc[(split * rows + row) * D + d] = aa;
      if (d == 0) part_ml[split * rows + row] = make_float2(mm, ll);
    }
  }
}

// One thread per output element: the splits that the query's position
// reaches, combined in split order.
template <typename QT, int D>
__global__ void __launch_bounds__(256)
paged_merge_kernel(const float2* __restrict__ part_ml, const float* __restrict__ part_acc,
                   const int32_t* __restrict__ qpos, QT* __restrict__ out, int n_q,
                   int n_heads, int rows, int split_slots, int n_split) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long)rows * D) return;
  const int row = (int)(e / D), d = (int)(e % D);
  const int pos = max(qpos[row / n_heads], 0);
  const int n = min(n_split, pos / split_slots + 1);
  float mm = kNegInf;
  for (int sp = 0; sp < n; ++sp) mm = fmaxf(mm, part_ml[(size_t)sp * rows + row].x);
  float ll = 0.f, aa = 0.f;
  for (int sp = 0; sp < n; ++sp) {
    const float2 ml = part_ml[(size_t)sp * rows + row];
    const float wt = expf(ml.x - mm);
    ll += ml.y * wt;
    aa += part_acc[((size_t)sp * rows + row) * D + d] * wt;
  }
  out[e] = from_f32<QT>(aa / (ll == 0.f ? 1.f : ll));
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *tables, *qpos;
  void *out;
  float2* part_ml;
  float* part_acc;
  int batch, n_q, n_heads, page_len, n_tables, pages_per_split;
};

template <typename QT, typename PT, bool kQuant, int D, int kQ>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n_split = (a.n_tables + a.pages_per_split - 1) / a.pages_per_split;
  const int n_tiles = (a.n_q + kQ - 1) / kQ;
  const size_t smem = sizeof(float) * merge_floats<D, kQ>() + sizeof(int32_t) * a.pages_per_split;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  paged_split_kernel<QT, PT, kQuant, D, kQ>
      <<<dim3(n_split * n_tiles, a.n_heads, a.batch), kThreads, smem, stream>>>(
          static_cast<const QT*>(a.q), static_cast<const PT*>(a.k),
          static_cast<const PT*>(a.v), static_cast<const float*>(a.ks),
          static_cast<const float*>(a.vs), static_cast<const int32_t*>(a.tables),
          static_cast<const int32_t*>(a.qpos), static_cast<QT*>(a.out), a.part_ml,
          a.part_acc, a.n_q, a.n_heads, a.page_len, a.n_tables, a.pages_per_split,
          n_split, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int rows = a.batch * a.n_q * a.n_heads;
  const long n = (long)rows * D;
  paged_merge_kernel<QT, D><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      a.part_ml, a.part_acc, static_cast<const int32_t*>(a.qpos), static_cast<QT*>(a.out),
      a.n_q, a.n_heads, rows, a.pages_per_split * a.page_len, n_split);
  return cudaGetLastError();
}

template <typename QT, typename PT, bool kQuant>
cudaError_t launch_d(int head_dim, const Args& a, cudaStream_t stream) {
  const bool one = a.n_q == 1;  // decode: a tile of one query
  switch (head_dim) {
    case 16:
      return one ? launch<QT, PT, kQuant, 16, 1>(a, stream)
                 : launch<QT, PT, kQuant, 16, 4>(a, stream);
    case 64:
      return one ? launch<QT, PT, kQuant, 64, 1>(a, stream)
                 : launch<QT, PT, kQuant, 64, 4>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns 0 on success, else the cudaError_t of a launch (or
// cudaErrorInvalidValue for a head_dim / dtype combination not built, or a
// split plan that does not fit). q_dtype: 0 fp32, 1 bf16; page_dtype: 0
// fp32, 1 bf16, 2 int8 (needs scales). The timeline is split into runs of
// pages_per_split pages; with more than one split, part (fp32, n_split *
// B * Q * H * (head_dim + 2) values) holds the splits' partials, the (m, l)
// pairs [n_split][B * Q * H] then acc [n_split][B * Q * H][head_dim], and a
// second kernel merges them.
extern "C" int paged_attention_forward(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const void* tables, const void* qpos, void* out, void* part,
    int batch, int n_q, int n_heads, int head_dim, int page_len, int n_tables,
    int pages_per_split, int q_dtype, int page_dtype, void* stream) {
  if (pages_per_split < 1 || pages_per_split > n_tables ||
      pages_per_split > kMaxPagesPerSplit || batch > 65535 || n_heads > 65535)
    return cudaErrorInvalidValue;
  if (pages_per_split < n_tables && part == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_split = (n_tables + pages_per_split - 1) / pages_per_split;
  const size_t rows = (size_t)n_split * batch * n_q * n_heads;
  float* part_f = static_cast<float*>(part);
  const Args a{q, k_pages, v_pages, k_scale, v_scale, tables, qpos, out,
               static_cast<float2*>(part), part_f ? part_f + 2 * rows : nullptr,
               batch, n_q, n_heads, page_len, n_tables, pages_per_split};
  if (q_dtype == kF32 && page_dtype == kF32)
    return launch_d<float, float, false>(head_dim, a, s);
  if (q_dtype == kBF16 && page_dtype == kBF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16, false>(head_dim, a, s);
  if (q_dtype == kF32 && page_dtype == kBF16)
    return launch_d<float, __nv_bfloat16, false>(head_dim, a, s);
  if (q_dtype == kBF16 && page_dtype == kF32)
    return launch_d<__nv_bfloat16, float, false>(head_dim, a, s);
  if (q_dtype == kBF16 && page_dtype == kI8)
    return launch_d<__nv_bfloat16, int8_t, true>(head_dim, a, s);
  if (q_dtype == kF32 && page_dtype == kI8)
    return launch_d<float, int8_t, true>(head_dim, a, s);
  return cudaErrorInvalidValue;
}
