// Flash attention: online-softmax GQA attention for sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/attention/flash.py:84 flash_attention (body
// _flash_kernel), widened to the contract of the plain version
// kernels/attention/ref.py::attention_ref, which is what the LM stack's
// models/attention.py::_attend_chunked asks of it:
//   - q (B, Hq, Lq, D), k (B, Hkv, Lk, D) and v (B, Hkv, Lk, Dv),
//     contiguous, float32 or bfloat16; out (B, Hq, Lq, Dv) in q's dtype.
//     Query head h reads KV head h / (Hq / Hkv): GQA without repeating K
//     and V. The value head dim is a template parameter of its own: MLA
//     (MiniCPM3-4B) attends with q and k of nope + rope = 96 and v of
//     v_head_dim = 64 (the JAX package's _attend_chunked takes Dv from v).
//     Q·Kᵀ and the default scale use D; the V tile, P·V, the accumulator
//     and the output use Dv.
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
// Bound: operations, at the LM's shapes. A live query-key pair costs
// 2·(D + Dv) flops (q·k and p·v); a 2,048-token causal prefill of Yi-6B
// (32 query heads, D = Dv = 128) is 34 GFLOP against 37 MB moved, 35 µs at
// the card's 989 TFLOP/s dense bf16 tensor rate against 11 µs at 3.35 TB/s.
//
// Two kernels, picked by dtype, behind the one C entry point:
//
// bfloat16 (the serving path: the engine prefills from its bf16 copy):
// flash_bf16_kernel, on the tensor cores. A block of 4 warps takes a 64-row
// query tile of one (query head, batch row); each warp owns 16 of its rows
// (two 16-row m-tiles a warp, each K and V fragment feeding two products,
// ran slower at Yi's shape; PERF.md). 64 rows rather than 128: a
// 2,048-token prompt still makes 1,024 blocks over Yi's 32 heads, the
// causal diagonal wastes half as many products, and the serving run's
// 128-token prompts fill the card. blockIdx.x runs the
// heads and blockIdx.y the tiles backwards, so every head's long causal
// tiles are launched first. Q, K and V are staged in shared memory as bf16
// by cp.async (16 bytes a thread, ragged rows zero-filled), rows padded by
// 16 bytes: a row of W + 8 elements (W = D for Q and K, Dv for V, each a
// multiple of 16) is an odd number of 16-byte units, so the 8 rows an
// ldmatrix phase reads fall in 8 distinct 4-bank groups at every head dim
// (16, 32, 64, 80, 96, 128). K and V tiles of 64 keys come through a
// ring of two stages: the next tile's loads are in flight while this tile's
// products run; two barriers a tile. S = Q·Kᵀ is mma.sync.m16n8k16 bf16 ->
// f32, with Q's and K's fragments by ldmatrix (Q's reloaded at each k-step
// rather than held: 32 registers fewer). Scale, mask, max and sum run on
// the f32 accumulator fragment, the scores kept in base 2 (s·scale·log2 e,
// p = exp2f(s - m): one multiply folded into the scale instead of expf's
// range reduction), with the CUDA-core kernel's mask rules: p = 0 exactly
// where masked, and tiles that need no mask skip it. P·V reuses the S
// accumulator's layout as the A operand (FlashAttention-2's register
// trick), V fragments by ldmatrix.trans: D / 16 k-steps for S, Dv / 16
// column pairs for P·V. At D = 128: 168 registers, 87 KB of shared memory,
// two blocks an SM; at (96, 64) 57 KB.
//
// MLA's absorbed form, (D, Dv) = (288, 256) with one KV head for all 40
// query heads (MiniCPM3-4B: q and k of kv_lora_rank + rope, v of
// kv_lora_rank), is the same two kernels instantiated at that pair, with
// the tile rows taken across heads: a block takes G = Hq / Hkv query heads
// of its KV head, its 64 rows position-major and heads inner (row r is
// position r / G of head r % G: grouped_row), so a decode step (Lq = 1)
// puts all 40 heads in one tile and reads the latent once, not 40 times,
// and a prompt's tiles span 64 / G positions each. The other pairs take G
// = 1: one head a tile, as before. The bf16 tiles stay at 64 rows: the
// query tile and the two-stage K and V ring are 177 KB (3 × 64 × 296 × 2 +
// 2 × 64 × 264 × 2 bytes) of the block's 227 KB, one block an SM, and the
// Dv-256 accumulator is 128 floats a thread (ptxas: 255 registers, 68 bytes
// spilled, on the first build); the f32 kernel's Q, K-or-V and P buffers
// are 162.5 KB (254 registers, no spill).
//
// Numbers of the bf16 path. A single bf16 P rounds each probability by up
// to 2^-9 relative, which moves the f32 output across a bf16 rounding
// boundary for a large share of outputs (the CPU emulation in
// tests/test_torch_flash_numerics.py measures it; PERF.md has the share);
// chip_smoke.py refuses more than 1% of output bits differing from
// attention_ref. So P is split into two bf16 terms, p_hi = bf16(p) and
// p_lo = bf16(p - p_hi) (the difference is exact in f32), and both products
// with V are accumulated into the same f32 accumulator: P is then carried
// to about 2^-18, and the products of bf16 values are exact. This costs
// 1.5 times the MMA work of a single P. Q·Kᵀ needs no split: Q and K are
// bf16 already.
//
// float32: flash_kernel, the CUDA-core kernel, as before. TF32 products
// would break the 3e-5 float32 contract. A block of 256 threads takes a
// 64-row query tile of one (batch row, query head); blockIdx.x runs the
// tiles backwards, so the long causal tiles start first. The query tile is
// staged once in shared memory as float32, transposed; each 64-key tile of
// K (transposed) and then V is staged through one shared buffer of
// max(D, Dv) × 65 floats. Each thread owns a 4×4 patch of the 64×64 score
// tile (rows ty + 16i, columns tx + 16j) and the same 4 rows of the output
// (columns tx + 16j, Dv/16 of them), so a row's max and sum are shuffles within a half-warp and its m,
// l and acc stay in registers. Padded shared strides (65 floats) keep the
// transposed stores and the inner loops' reads free of bank conflicts; at
// D = 128 the block holds 83 KB of shared memory, so two blocks share an
// SM. No fast math in either kernel: expf or exp2f, IEEE division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kPad = kBK + 1;     // shared stride of transposed tiles
constexpr float kNeg = -1e30f;

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

// Tile row r of a block that takes G query heads of one KV head together:
// the rows are position-major, heads inner (r = i·G + h_local), so a tile of
// 64 rows spans 64 / G positions and a decode step (Lq = 1) puts all G heads
// in one tile, which reads K and V once. Returns the row's offset from
// (b, h0, 0) in rows of q and o: h_local·Lq + i. G = 1 is one head a tile.
__device__ __forceinline__ size_t grouped_row(int r, int G, int Lq) {
  const int i = r / G;
  return (size_t)(r - i * G) * Lq + i;
}

template <int D, int DV>
constexpr size_t smem_bytes() {
  // query tile (D × kPad) + one K-or-V tile (max(D, DV) × kPad: K is D ×
  // kPad, V kBK × DV <= DV × kPad) + probabilities (kBQ × kPad), float32
  return sizeof(float) * ((D + (D > DV ? D : DV)) * kPad + kBQ * kPad);
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Hq, int Hkv,
             int Lq, int Lk, int causal, int window, int q_offset, float scale,
             int G) {
  static_assert(D % 16 == 0 && DV % 16 == 0,
                "head dims must be multiples of 16");
  constexpr int kCols = DV / 16;  // output columns per thread
  constexpr int kKV = D > DV ? D : DV;
  extern __shared__ float smem[];
  float* qs = smem;               // [D][kPad]: q tile, transposed
  float* kv = qs + D * kPad;      // [D][kPad]: K tile, transposed; then V [kBK][DV]
  float* ps = kv + kKV * kPad;    // [kBQ][kPad]: probabilities

  // tile rows are the G·Lq rows of G query heads (grouped_row)
  const int nv = G * Lq;
  const int nq = (nv + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;
  const int h0 = blockIdx.y * G, b = blockIdx.z;
  const int hk = h0 / (Hq / Hkv);
  const size_t row0 = ((size_t)b * Hq + h0) * Lq;   // (b, h0, 0)
  const float* kg = k + ((size_t)b * Hkv + hk) * Lk * D;
  const float* vg = v + ((size_t)b * Hkv + hk) * Lk * DV;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    qs[d * kPad + r] = q0 + r < nv
        ? q[(row0 + grouped_row(q0 + r, G, Lq)) * D + d] : 0.0f;
  }

  // keys any row of this tile can see: [k_lo, k_hi)
  const int pos_first = q0 / G, pos_last = (min(q0 + kBQ, nv) - 1) / G;
  int k_lo = 0, k_hi = Lk;
  if (causal) k_hi = min(Lk, q_offset + pos_last + 1);
  if (window > 0) k_lo = max(0, q_offset + pos_first - window + 1);

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
      kv[d * kPad + c] = k0 + c < Lk ? kg[(size_t)(k0 + c) * D + d] : 0.0f;
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
      const int qpos = q_offset + (q0 + r) / G;
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

    for (int idx = tid; idx < kBK * DV; idx += kThreads) {
      const int c = idx / DV, d = idx - c * DV;
      kv[c * DV + d] = k0 + c < Lk ? vg[(size_t)(k0 + c) * DV + d] : 0.0f;
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
      for (int j = 0; j < kCols; ++j) w[j] = kv[c * DV + tx + 16 * j];
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
    if (r >= nv) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    float* orow = o + (row0 + grouped_row(r, G, Lq)) * DV;
#pragma unroll
    for (int j = 0; j < kCols; ++j) orow[tx + 16 * j] = acc[i][j] / denom;
  }
}

// -- the bfloat16 kernel: tensor cores ----------------------------------------

constexpr int kTcThreads = 32 * (kBQ / 16);   // each warp owns 16 query rows

// a 64-row bf16 tile of rows W elements wide, padded
template <int W>
struct Bf16Tile {
  static constexpr int kStride = W + 8;              // elements per shared row
  static constexpr int kBytes = kBK * kStride * 2;   // one 64-row tile
};

// the query tile, then the ring: K stage 0, K stage 1 (rows of D), V stage
// 0, V stage 1 (rows of DV)
template <int D, int DV>
constexpr size_t bf16_smem() {
  return 3 * (size_t)Bf16Tile<D>::kBytes + 2 * (size_t)Bf16Tile<DV>::kBytes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; the bytes past src_bytes (0 or 16) are
// zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16×16, row-major fragment) · b (16×8, column-major fragment); a
// pure register op, which the compiler may schedule freely
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p = (a, b) as two bf16 pairs: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// rows [r0, r0 + 64) of a (n, W) bf16 matrix into a padded shared tile;
// rows at or past n are zero
template <int W>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          int r0, int n) {
  constexpr int kChunks = W / 8;     // 16-byte chunks per row
  static_assert(kBK * kChunks % kTcThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < kBK * kChunks / kTcThreads; ++i) {
    const int c = threadIdx.x + i * kTcThreads;
    const int r = c / kChunks, ch = c - r * kChunks;
    const bool in = r0 + r < n;
    cp_async16(dst + (r * Bf16Tile<W>::kStride + ch * 8) * 2,
               src + (size_t)(in ? r0 + r : 0) * W + ch * 8, in ? 16 : 0);
  }
}

// tile rows [r0, r0 + 64) of the G·Lq query rows that start at src (the
// rows of G heads, grouped_row), into a padded shared tile; rows at or
// past nv are zero
template <int W>
__device__ __forceinline__ void load_q_tile(uint32_t dst, const __nv_bfloat16* src,
                                            int r0, int nv, int G, int Lq) {
  constexpr int kChunks = W / 8;     // 16-byte chunks per row
  static_assert(kBK * kChunks % kTcThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < kBK * kChunks / kTcThreads; ++i) {
    const int c = threadIdx.x + i * kTcThreads;
    const int r = c / kChunks, ch = c - r * kChunks;
    const bool in = r0 + r < nv;
    cp_async16(dst + (r * Bf16Tile<W>::kStride + ch * 8) * 2,
               src + (in ? grouped_row(r0 + r, G, Lq) : 0) * W + ch * 8,
               in ? 16 : 0);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kTcThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Lq,
                  int Lk, int causal, int window, int q_offset, float scale,
                  int G) {
  static_assert(D % 16 == 0 && DV % 16 == 0,
                "head dims must be multiples of 16");
  constexpr int kStride = Bf16Tile<D>::kStride;     // Q and K rows
  constexpr int kVStride = Bf16Tile<DV>::kStride;   // V rows
  constexpr int kTileBytes = Bf16Tile<D>::kBytes;
  constexpr int kSteps = D / 16;     // k-steps of Q·Kᵀ
  constexpr int kVSteps = DV / 16;   // 16-column pairs of P·V
  constexpr int kN = kBK / 8;        // 8-key column tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t q_tile = smem_addr(smem_raw);
  const auto k_stage = [&](int st) { return q_tile + (1 + st) * kTileBytes; };
  const auto v_stage = [&](int st) {
    return q_tile + 3 * kTileBytes + st * Bf16Tile<DV>::kBytes;
  };

  // tile rows are the G·Lq rows of G query heads (grouped_row)
  const int nv = G * Lq;
  const int nq = (nv + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kBQ;
  const int h0 = blockIdx.x * G, b = blockIdx.z;
  const int hk = h0 / (Hq / Hkv);
  const size_t row0 = ((size_t)b * Hq + h0) * Lq;   // (b, h0, 0)
  const __nv_bfloat16* kg = k + ((size_t)b * Hkv + hk) * Lk * D;
  const __nv_bfloat16* vg = v + ((size_t)b * Hkv + hk) * Lk * DV;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;      // fragment row and column pair
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: matrix, its row

  // keys any row of this tile can see: [k_lo, k_hi), whole tiles from k_first
  const int pos_first = q0 / G, pos_last = (min(q0 + kBQ, nv) - 1) / G;
  int k_lo = 0, k_hi = Lk;
  if (causal) k_hi = min(Lk, q_offset + pos_last + 1);
  if (window > 0) k_lo = max(0, q_offset + pos_first - window + 1);
  const int k_first = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > k_first ? (k_hi - k_first + kBK - 1) / kBK : 0;

  // the query tile and the first K and V tiles: one group
  load_q_tile<D>(q_tile, q + row0 * D, q0, nv, G, Lq);
  if (n_tiles > 0) {
    load_tile<D>(k_stage(0), kg, k_first, Lk);
    load_tile<DV>(v_stage(0), vg, k_first, Lk);
  }
  cp_async_commit();

  // this thread's rows: tile rows warp·16 + g and + 8; e = 0, 1 -> the
  // first, e = 2, 3 -> the second of an accumulator fragment
  const int qpos[2] = {q_offset + (q0 + warp * 16 + g) / G,
                       q_offset + (q0 + warp * 16 + g + 8) / G};
  const bool warp_live = q0 + warp * 16 < nv;
  // scores are kept in base 2: s·scale·log2(e), so p = exp2(s - m)
  const float scale2 = scale * 1.4426950408889634f;
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.0f, 0.0f};
  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int k0 = k_first + it * kBK;
    if (it + 1 < n_tiles) {   // the next tile's loads overlap this one's work
      load_tile<D>(k_stage(st ^ 1), kg, k0 + kBK, Lk);
      load_tile<DV>(v_stage(st ^ 1), vg, k0 + kBK, Lk);
    }
    cp_async_commit();
    cp_async_wait<1>();       // this tile's group has landed
    __syncthreads();

    if (warp_live) {
      // S = Q·Kᵀ: 16 rows × 64 keys per warp
      float s[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t qf[4];
        ldmatrix_x4(qf, q_tile + ((warp * 16 + (mat & 1) * 8 + mrow) * kStride
                                  + ks * 16 + (mat >> 1) * 8) * 2);
#pragma unroll
        for (int np = 0; np < kN / 2; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, k_stage(st) + ((np * 16 + (mat >> 1) * 8 + mrow) * kStride
                                         + ks * 16 + (mat & 1) * 8) * 2);
          mma_bf16(s[2 * np], qf, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
        }
      }

      // scale and mask; a tile every key of which every row sees needs no mask
      const bool full = k0 + kBK <= Lk &&
                        (!causal || k0 + kBK - 1 <= q_offset + pos_first) &&
                        (window <= 0 || k0 > q_offset + pos_last - window);
      uint32_t ok = 0xffffffffu;   // bit 4j + e: s[j][e] is visible
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!full) {
            const int kpos = k0 + j * 8 + 2 * t4 + (e & 1);
            const int qp = qpos[e >> 1];
            const bool vis = kpos < Lk && (!causal || kpos <= qp) &&
                             (window <= 0 || kpos > qp - window);
            if (!vis) ok &= ~(1u << (4 * j + e));
          }
          s[j][e] = (ok >> (4 * j + e)) & 1u ? s[j][e] * scale2 : kNeg;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      // online softmax: a row's 64 scores lie in the 4 threads of a quad
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];   // this thread's share of the row's sum
      }
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (ok >> (4 * j + e)) & 1u ? exp2f(s[j][e] - m_run[e >> 1])
                                                   : 0.0f;
          s[j][e] = p;
          l_run[e >> 1] += p;
        }
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }

      // acc += P·V, P in two bf16 terms; 16 keys a step
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < kVSteps; ++np) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, v_stage(st) + ((kk * 16 + (mat & 1) * 8 + mrow) * kVStride
                                               + np * 16 + (mat >> 1) * 8) * 2);
          mma_bf16(acc[2 * np], ph, vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], ph, vf[2], vf[3]);
          mma_bf16(acc[2 * np], pl, vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], pl, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();          // this stage is read: the next tile may refill it
  }
  cp_async_wait<0>();         // nothing in flight at exit (no tile to see)

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= nv) continue;
    const float denom = fmaxf(l, 1e-20f);
    uint32_t* out = reinterpret_cast<uint32_t*>(
        o + (row0 + grouped_row(row, G, Lq)) * DV + 2 * t4);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      out[j * 4] = pack_bf16(acc[j][2 * r] / denom, acc[j][2 * r + 1] / denom);
  }
}

template <int D, int DV>
int launch_f32(int B, int Hq, int Hkv, int Lq, int Lk, int causal, int window,
               int q_offset, float scale, const void* q, const void* k,
               const void* v, void* o, cudaStream_t stream, int G) {
  constexpr size_t smem = smem_bytes<D, DV>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((G * Lq + kBQ - 1) / kBQ), (unsigned)(Hq / G),
                  (unsigned)B);
  flash_kernel<D, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Lq, Lk,
      causal, window, q_offset, scale, G);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_bf16(int B, int Hq, int Hkv, int Lq, int Lk, int causal, int window,
                int q_offset, float scale, const void* q, const void* k,
                const void* v, void* o, cudaStream_t stream, int G) {
  constexpr size_t smem = bf16_smem<D, DV>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nq = (G * Lq + kBQ - 1) / kBQ;
  if (nq > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(Hq / G), (unsigned)nq, (unsigned)B);
  flash_bf16_kernel<D, DV><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Hq,
      Hkv, Lq, Lk, causal, window, q_offset, scale, G);
  return (int)cudaGetLastError();
}

}  // namespace

// Attention of q (head dim D) over k (D) and v (Dv) on `stream`; dtype 0 is
// float32 (the CUDA-core kernel), 1 bfloat16 (the tensor-core kernel; q, k,
// v and o 16-byte aligned). Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a pair of head dims, dtype or shape the
// kernels are not built for).
extern "C" int flash_attention(int dtype, int B, int Hq, int Hkv, int Lq,
                               int Lk, int D, int Dv, int causal, int window,
                               int q_offset, float scale, const void* q,
                               const void* k, const void* v, void* o,
                               void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Lq < 1 || Lk < 1 ||
      B > 65535 || Hq > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the (D, Dv) pairs built: D = Dv for the GQA models (Yi 128, Danube 80,
  // the tests'), (96, 64) for MLA's naive form and (288, 256) for its
  // absorbed form (MiniCPM3-4B). The absorbed form has one KV head for all
  // query heads, so its tiles take every query head of a KV head (G = Hq /
  // Hkv, grouped_row); the others take one head a tile (G = 1).
#define FLASH_CASE(d, dv, g)                                                    \
  if (D == d && Dv == dv) {                                                     \
    const int G = (g);                                                          \
    if ((long long)G * Lq >= (1LL << 31)) return (int)cudaErrorInvalidValue;    \
    return dtype == 0                                                           \
               ? launch_f32<d, dv>(B, Hq, Hkv, Lq, Lk, causal, window,          \
                                   q_offset, scale, q, k, v, o, s, G)           \
               : launch_bf16<d, dv>(B, Hq, Hkv, Lq, Lk, causal, window,         \
                                    q_offset, scale, q, k, v, o, s, G);         \
  }
  FLASH_CASE(16, 16, 1)
  FLASH_CASE(32, 32, 1)
  FLASH_CASE(64, 64, 1)
  FLASH_CASE(80, 80, 1)
  FLASH_CASE(128, 128, 1)
  FLASH_CASE(96, 64, 1)
  FLASH_CASE(288, 256, Hq / Hkv)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}
