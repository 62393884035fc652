// Flash attention: online-softmax GQA attention for sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/attention/flash.py:84 flash_attention (body
// _flash_kernel), widened to the contract of the plain version
// kernels/attention/ref.py::attention_ref, which is what the LM stack's
// models/attention.py::_attend_chunked asks of it:
//   - q (B, Hq, Lq, D), k and v (B, Hkv, Lk, D), contiguous, float32 or
//     bfloat16; out (B, Hq, Lq, D) in q's dtype. Query head h reads KV head
//     h / (Hq / Hkv): GQA without repeating K and V.
//   - Query row i sits at absolute position qpos = q_offset + i (cached
//     prefill attends a prompt against the whole cache; scalar decode is
//     Lq = 1 at q_offset = pos). Key j is visible where j < Lk, j <= qpos
//     (causal) and j > qpos - window (window > 0). Any Lq and Lk: the
//     ragged last tiles are masked here, with no padding.
//   - As the TPU kernel: masked scores are -1e30, K tiles that no row of
//     the query tile can see are skipped (on the same absolute positions),
//     the running max m, sum l and accumulator acc are float32, and the
//     output is acc / max(l, 1e-20). A masked score adds exactly 0 to l and
//     acc (its p is set to 0 rather than exp(-1e30 - m)), so a row that sees
//     no key gives 0, as attention_ref does; where a row sees a key the two
//     are the same numbers.
//
// Bound: operations, at the LM's shapes. A live query-key pair costs 4·D
// flops (q·k and p·v); a 2,048-token causal prefill of Yi-6B (32 query
// heads, D = 128) is 34 GFLOP against 37 MB moved, 35 µs at the card's
// 989 TFLOP/s dense bf16 tensor rate against 11 µs at 3.35 TB/s.
// Design: simple first. A block of 256 threads takes a 64-row query tile
// of one (batch row, query head); blockIdx.x runs the tiles backwards, so
// the long causal tiles start first. The query tile is staged once in
// shared memory as float32, transposed; each 64-key tile of K (transposed)
// and then V is staged through one shared buffer. Each thread owns a 4×4
// patch of the 64×64 score tile (rows ty + 16i, columns tx + 16j) and the
// same 4 rows of the output (columns tx + 16j, D/16 of them), so a row's
// max and sum are shuffles within a half-warp and its m, l and acc stay in
// registers. The products run on the CUDA cores in float32, with no tensor
// cores (wgmma and TMA are later work): the kernel sits far from its
// tensor-core bound, and PERF.md says by how much. Padded shared strides
// (65 floats) keep the transposed stores and the inner loops' reads free
// of bank conflicts; at D = 128 the block holds 83 KB of shared memory, so
// two blocks share an SM. No fast math: expf, IEEE division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kPad = kBK + 1;     // shared stride of transposed tiles
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // query tile (D × kPad) + one K-or-V tile (D × kPad >= kBK × D)
  // + probabilities (kBQ × kPad), float32
  return sizeof(float) * (2 * D * kPad + kBQ * kPad);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
             int Lq, int Lk, int causal, int window, int q_offset, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kCols = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // [D][kPad]: q tile, transposed
  float* kv = qs + D * kPad;      // [D][kPad]: K tile, transposed; then V [kBK][D]
  float* ps = kv + D * kPad;      // [kBQ][kPad]: probabilities

  const int nq = (Lq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qg = q + ((size_t)b * Hq + h) * Lq * D;
  const T* kg = k + ((size_t)b * Hkv + hk) * Lk * D;
  const T* vg = v + ((size_t)b * Hkv + hk) * Lk * D;
  T* og = o + ((size_t)b * Hq + h) * Lq * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    qs[d * kPad + r] = q0 + r < Lq ? to_float(qg[(size_t)(q0 + r) * D + d]) : 0.0f;
  }

  // keys any row of this tile can see: [k_lo, k_hi)
  const int last_row = min(q0 + kBQ, Lq) - 1;
  int k_lo = 0, k_hi = Lk;
  if (causal) k_hi = min(Lk, q_offset + last_row + 1);
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's V and P are no longer read
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      kv[d * kPad + c] = k0 + c < Lk ? to_float(kg[(size_t)(k0 + c) * D + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[d * kPad + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = kv[d * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * c[j];
    }

    // mask, then the online softmax of each row: its 64 scores are spread
    // over the 16 threads of a half-warp
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q_offset + q0 + r;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Lk && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        ps[r * kPad + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha[i] + half_warp_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();  // P written; K no longer read

    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      kv[c * D + d] = k0 + c < Lk ? to_float(vg[(size_t)(k0 + c) * D + d]) : 0.0f;
    }
    __syncthreads();

    float pv[4][kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) pv[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], w[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPad + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) w[j] = kv[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) pv[i][j] += p[i] * w[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = acc[i][j] * alpha[i] + pv[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Lq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      store(og + (size_t)r * D + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(int B, int Hq, int Hkv, int Lq, int Lk, int causal, int window,
           int q_offset, float scale, const void* q, const void* k,
           const void* v, void* o, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((Lq + kBQ - 1) / kBQ), (unsigned)Hq, (unsigned)B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Lq, Lk, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, int B, int Hq, int Hkv, int Lq, int Lk, int causal,
             int window, int q_offset, float scale, const void* q,
             const void* k, const void* v, void* o, cudaStream_t stream) {
  switch (D) {
#define FLASH_CASE(d)                                                        \
  case d:                                                                    \
    return launch<T, d>(B, Hq, Hkv, Lq, Lk, causal, window, q_offset, scale, \
                        q, k, v, o, stream);
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(128)
#undef FLASH_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Attention of q over k and v on `stream`; dtype 0 is float32, 1 bfloat16.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a head dim,
// dtype or shape the kernel is not built for).
extern "C" int flash_attention(int dtype, int B, int Hq, int Hkv, int Lq,
                               int Lk, int D, int causal, int window,
                               int q_offset, float scale, const void* q,
                               const void* k, const void* v, void* o,
                               void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Lq < 1 || Lk < 1 ||
      B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, B, Hq, Hkv, Lq, Lk, causal, window, q_offset,
                           scale, q, k, v, o, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, B, Hq, Hkv, Lq, Lk, causal, window,
                                   q_offset, scale, q, k, v, o, s);
  return (int)cudaErrorInvalidValue;
}
