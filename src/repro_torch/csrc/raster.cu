// Software rasteriser: capsule scenes to float32 framebuffers, for sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/raster/raster.py::rasterize_pallas (body _raster_kernel).
// Input: segs (N, S, 5) capsules [x0, y0, x1, y1, r] and intens (N, S), in
// [0, 1]² with x rightward and y downward. Output: out (N, H, W), each pixel
// the max over segments of clip((r - dist(pixel centre, segment)) / softness
// + 0.5, 0, 1) * intensity, softness = 1/H. All float32, row-major.
//
// Bound: operations. Each pixel costs about 25 float ops per segment (two
// of them IEEE divisions and one a square root, each several instructions),
// against 4 bytes written per pixel: at 84×84 the work passes the memory
// time at about S = 3, so the arcade scenes (S = 4 for Pong, 26 for Breakout)
// are bound by the arithmetic.
// Design: a 2-D grid of (frame, pixel tile), 256 threads a block, each
// thread kPixels pixels of its tile, 256 apart. The TPU kernel's (BB, H,
// 128-padded W) VMEM tile has no use here: the block stages its frame's S
// segments once in shared memory, with each segment's dx, dy and squared
// length computed there once instead of per pixel; every thread then loops
// over S, reads each segment once for its kPixels pixels, and keeps their
// running maxima in registers; several pixels a thread pay the block's
// staging, barrier and load latency once for a quarter as many blocks as
// one pixel a thread would (PERF.md has both times). Writes are row-major
// (N, H, W): neighbouring threads write neighbouring pixels, so every store
// is coalesced, and the ragged last tile is masked, with no padding.
// Zero-intensity segments are skipped: their coverage is 0 and cannot
// raise the max, so the result is the same bits.
//
// Numbers: the kernel must give the bits of the plain PyTorch version
// (kernels/raster/ref.py) on the card, op by op. So every product is mul()
// (__fmul_rn), which nvcc never contracts into a fused multiply-add with a
// neighbouring add; divisions are IEEE and sqrtf is the correctly rounded
// one (no fast math); clips are min(max(v, lo), hi), as torch.clamp computes
// them; and softness is 1/H in double, rounded to float once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixels = 4;                  // pixels per thread
constexpr int kTile = kThreads * kPixels;   // pixels per block
constexpr float kEps = (float)1e-8;
// per segment in shared memory: x0, y0, r, intensity, dx, dy, l2
constexpr int kFields = 7;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return hi < v ? hi : v;
}

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ segs, const float* __restrict__ intens,
              float* __restrict__ out, int S, int H, int W, float softness) {
  extern __shared__ float seg[];
  const size_t frame = blockIdx.x;
  for (int i = threadIdx.x; i < S; i += kThreads) {
    const float* g = segs + (frame * S + i) * 5;
    const float x0 = g[0], y0 = g[1], x1 = g[2], y1 = g[3];
    const float dx = x1 - x0, dy = y1 - y0;
    float* o = seg + i * kFields;
    o[0] = x0;
    o[1] = y0;
    o[2] = g[4];
    o[3] = intens[frame * S + i];
    o[4] = dx;
    o[5] = dy;
    o[6] = fmaxf(mul(dx, dx) + mul(dy, dy), kEps);
  }
  __syncthreads();

  const int hw = H * W;
  const int first = blockIdx.y * kTile + threadIdx.x;
  float px[kPixels], py[kPixels], fb[kPixels];
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    // pixels past the frame's end compute the last pixel and are not stored
    const int pix = min(first + j * kThreads, hw - 1);
    const int row = pix / W, col = pix - row * W;
    px[j] = ((float)col + 0.5f) / (float)W;
    py[j] = ((float)row + 0.5f) / (float)H;
    fb[j] = 0.0f;
  }
  for (int i = 0; i < S; ++i) {
    const float* q = seg + i * kFields;
    const float inten = q[3];
    if (inten == 0.0f) continue;
    const float x0 = q[0], y0 = q[1], r = q[2], dx = q[4], dy = q[5], l2 = q[6];
#pragma unroll
    for (int j = 0; j < kPixels; ++j) {
      const float t =
          clampf((mul(px[j] - x0, dx) + mul(py[j] - y0, dy)) / l2, 0.0f, 1.0f);
      const float ex = px[j] - (x0 + mul(t, dx));
      const float ey = py[j] - (y0 + mul(t, dy));
      const float d = sqrtf(mul(ex, ex) + mul(ey, ey));
      const float cov = mul(clampf((r - d) / softness + 0.5f, 0.0f, 1.0f), inten);
      fb[j] = fmaxf(fb[j], cov);
    }
  }
  float* o = out + frame * hw;
#pragma unroll
  for (int j = 0; j < kPixels; ++j)
    if (first + j * kThreads < hw) o[first + j * kThreads] = fb[j];
}

}  // namespace

// N frames of S segments into H×W framebuffers on `stream`. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for shapes the grid cannot
// hold).
extern "C" int rasterize(int N, int S, int H, int W, const float* segs,
                         const float* intens, float* out, void* stream) {
  const long long tiles = ((long long)H * W + kTile - 1) / kTile;
  if (N < 1 || S < 1 || H < 1 || W < 1 || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)S * kFields * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float softness = (float)(1.0 / (double)H);
  const dim3 grid((unsigned)N, (unsigned)tiles);
  raster_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      segs, intens, out, S, H, W, softness);
  return (int)cudaGetLastError();
}
