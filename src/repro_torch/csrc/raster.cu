// Software rasteriser: capsule scenes to float32 framebuffers, for sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/raster/raster.py::rasterize_pallas (body _raster_kernel).
// Input: segs (N, S, 5) capsules [x0, y0, x1, y1, r] and intens (N, S), the
// coordinates in [0, 1]² with x rightward and y downward, the intensities in
// [0, 1]. Output: out (N, H, W), each pixel the max over segments of
// clip((r - dist(pixel centre, segment)) / softness + 0.5, 0, 1) * intensity,
// softness = 1/H. All float32, row-major.
//
// Bound: operations. Each pixel-segment pair costs about 25 float ops (two
// of them IEEE divisions and one a square root, each several instructions),
// against 4 bytes written per pixel. A capsule reaches only the pixels
// within r + softness/2 of it, so what the inputs need is the pairs of
// non-zero coverage, plus the per-pixel and per-segment ops; chip_smoke.py
// counts those pairs on the card from the scenes and prints the all-pairs
// count beside them.
//
// Design: a 2-D grid of (frame, block of pixel tiles). The tile, the unit
// of the cull, is one warp's: kTileH × kTileW pixels (8 rows × 32 columns),
// kPixels a thread (one column, rows kRowStep apart), so a warp stores whole
// runs of a row. A block of kWarpsX × kWarpsY warps (32 rows × 64 columns)
// stages its frame's S segments once in shared memory, each with its dx,
// dy, squared length and grown box computed there once instead of per
// pixel; that is the one block-wide barrier. Each warp then builds, in
// shared memory, the list of the segments that pass a conservative reach
// test against its tile's box of pixel centres, in their original order (a
// ballot and a prefix count, 32 segments a step), and loops over that list
// only, reading each segment once for its kPixels pixels and keeping their
// running maxima in registers. Small tiles cut the most pairs, many pixels
// a thread pay each segment's loads for more pixels, and the block around
// the tiles pays the staging once for eight of them. 8 × 32 is the tile of
// least raster time summed over the launches of chip_smoke.py's main paths
// (kernel_ab.py, PERF.md): most of them draw the classic render scenes of
// two to eight segments, where wide tiles win; on the 64-segment Maze
// scenes 8 × 16 is 19% faster. Warps whose tile lies past the frame's edge
// stop after the staging, the ragged ones are masked, with no padding;
// stores are row-major (N, H, W).
//
// The reach test keeps a segment if its intensity is not 0 and its
// axis-aligned box, grown by r + softness on every side, meets the tile's
// box of pixel centres. Its plain twin is kernels/raster/ref.py::tile_keep,
// held against rasterize_ref in tests/test_torch_raster_cull.py.
//
// Numbers: the kernel must give the bits of the plain PyTorch version
// (kernels/raster/ref.py::rasterize_ref) on the card, op by op. So every
// product is mul() (__fmul_rn), which nvcc never contracts into a fused
// multiply-add with a neighbouring add; divisions are IEEE and sqrtf is the
// correctly rounded one (no fast math); clips are min(max(v, lo), hi), as
// torch.clamp computes them; and softness is 1/H in double, rounded to float
// once. Why a culled segment changes no bit:
//   - A zero-intensity segment's coverage is 0 and cannot raise the max.
//   - A segment that fails the test lies more than r + softness from every
//     pixel centre of the tile along x or along y, so the true distance d
//     from each centre to it exceeds r + softness. The point the kernel
//     computes on it (t clamped to [0, 1]) and the distance are off by a few
//     float32 roundings of numbers of size ~1, about 1e-6, and the test's
//     own roundings are as small: far below the half softness the test
//     keeps in hand (1/(2H), 6e-3 at H = 84).
//   - So (r - d) / softness + 0.5 < 0, the clip gives +0 (never -0: x + 0.5
//     is +0 when it is exactly 0), and +0 times a non-negative intensity is
//     +0. The running max starts at +0 and every coverage is +0 or more, so
//     a +0 leaves it as it is, whatever the order: skipping the segment
//     changes no bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 8, kTileW = 32;               // one warp's tile, the cull's unit
constexpr int kWarpsX = 2, kWarpsY = 4;              // warp tiles per block
constexpr int kWarps = kWarpsX * kWarpsY;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowStep = 32 / kTileW;                // rows a warp covers at once
constexpr int kPixels = kTileH / kRowStep;           // pixels per thread
static_assert(32 % kTileW == 0 && kTileH % kRowStep == 0,
              "a warp covers its tile in whole rows");
constexpr float kEps = (float)1e-8;
// per segment in shared memory: x0, y0, r, intensity, dx, dy, l2, and the
// box grown by r + softness: x_lo, x_hi, y_lo, y_hi
constexpr int kFields = 11;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return hi < v ? hi : v;
}

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ segs, const float* __restrict__ intens,
              float* __restrict__ out, int S, int H, int W, float softness) {
  extern __shared__ float seg[];                            // [S][kFields]
  const size_t frame = blockIdx.x;
  for (int i = threadIdx.x; i < S; i += kThreads) {
    const float* g = segs + (frame * S + i) * 5;
    const float x0 = g[0], y0 = g[1], x1 = g[2], y1 = g[3], r = g[4];
    const float dx = x1 - x0, dy = y1 - y0, reach = r + softness;
    float* o = seg + i * kFields;
    o[0] = x0;
    o[1] = y0;
    o[2] = r;
    o[3] = intens[frame * S + i];
    o[4] = dx;
    o[5] = dy;
    o[6] = fmaxf(mul(dx, dx) + mul(dy, dy), kEps);
    o[7] = fminf(x0, x1) - reach;
    o[8] = fmaxf(x0, x1) + reach;
    o[9] = fminf(y0, y1) - reach;
    o[10] = fmaxf(y0, y1) + reach;
  }
  __syncthreads();   // the last block-wide barrier: warps part ways below

  // this warp's tile, its box of pixel centres, and its pixels
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blocks_x = (W + kWarpsX * kTileW - 1) / (kWarpsX * kTileW);
  const int col0 = ((blockIdx.y % blocks_x) * kWarpsX + warp % kWarpsX) * kTileW;
  const int row0 = ((blockIdx.y / blocks_x) * kWarpsY + warp / kWarpsX) * kTileH;
  if (col0 >= W || row0 >= H) return;
  const int col1 = min(col0 + kTileW, W) - 1, row1 = min(row0 + kTileH, H) - 1;
  const float bx0 = ((float)col0 + 0.5f) / (float)W;
  const float bx1 = ((float)col1 + 0.5f) / (float)W;
  const float by0 = ((float)row0 + 0.5f) / (float)H;
  const float by1 = ((float)row1 + 0.5f) / (float)H;

  // the segments that can reach the tile, in order, by ballot
  int* kept = reinterpret_cast<int*>(seg + S * kFields) + warp * S;
  int n_kept = 0;
  for (int base = 0; base < S; base += 32) {
    const int i = base + lane;
    const float* q = seg + i * kFields;
    const bool keep = i < S && q[3] != 0.0f && q[7] <= bx1 && q[8] >= bx0 &&
                      q[9] <= by1 && q[10] >= by0;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) kept[n_kept + __popc(ballot & ((1u << lane) - 1u))] = i;
    n_kept += __popc(ballot);
  }
  __syncwarp();

  const int col = col0 + lane % kTileW, trow = row0 + lane / kTileW;
  // pixels past the frame's edge compute the edge pixel and are not stored
  const float px = ((float)min(col, W - 1) + 0.5f) / (float)W;
  float py[kPixels], fb[kPixels];
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    py[j] = ((float)min(trow + j * kRowStep, H - 1) + 0.5f) / (float)H;
    fb[j] = 0.0f;
  }
  for (int n = 0; n < n_kept; ++n) {
    const float* q = seg + kept[n] * kFields;
    const float x0 = q[0], y0 = q[1], r = q[2], inten = q[3], dx = q[4],
                dy = q[5], l2 = q[6];
#pragma unroll
    for (int j = 0; j < kPixels; ++j) {
      const float t =
          clampf((mul(px - x0, dx) + mul(py[j] - y0, dy)) / l2, 0.0f, 1.0f);
      const float ex = px - (x0 + mul(t, dx));
      const float ey = py[j] - (y0 + mul(t, dy));
      const float d = sqrtf(mul(ex, ex) + mul(ey, ey));
      const float cov = mul(clampf((r - d) / softness + 0.5f, 0.0f, 1.0f), inten);
      fb[j] = fmaxf(fb[j], cov);
    }
  }
  if (col >= W) return;
  float* o = out + frame * H * W + col;
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    const int row = trow + j * kRowStep;
    if (row < H) o[(size_t)row * W] = fb[j];
  }
}

}  // namespace

// N frames of S segments into H×W framebuffers on `stream`. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for shapes the grid cannot
// hold).
extern "C" int rasterize(int N, int S, int H, int W, const float* segs,
                         const float* intens, float* out, void* stream) {
  const long long blocks =
      (long long)((H + kWarpsY * kTileH - 1) / (kWarpsY * kTileH)) *
      ((W + kWarpsX * kTileW - 1) / (kWarpsX * kTileW));
  if (N < 1 || S < 1 || H < 1 || W < 1 || blocks > 65535)
    return (int)cudaErrorInvalidValue;
  // the segments, and one kept list per warp
  const size_t smem = (size_t)S * (kFields * sizeof(float) + kWarps * sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float softness = (float)(1.0 / (double)H);
  const dim3 grid((unsigned)N, (unsigned)blocks);
  raster_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      segs, intens, out, S, H, W, softness);
  return (int)cudaGetLastError();
}
