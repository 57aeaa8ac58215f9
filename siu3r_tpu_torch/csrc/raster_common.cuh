// What the tile-compositing kernels (raster.cu) and their backward
// (raster_bwd.cu) share: the tile and chunk sizes, the alpha cut, the
// cp.async copies that stage a chunk, the alpha's power rounded as the plain
// version rounds it, the per-warp test that skips a gaussian whose alpha is
// below the cut at every pixel of the warp, and the order in which a launch
// takes the tiles (longest first).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace siu3r_raster {

constexpr int kTileH = 16;
constexpr int kTileW = 128;
constexpr int kChunk = 128;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kSubW = 16;              // a block's sub-tile: 16 rows x 16 columns
constexpr int kSubs = kTileW / kSubW;  // blocks a tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// 4 bytes, or zeros where !valid (the source is then not read)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// power = -0.5 (a dx^2 + c dy^2) - b dx dy, with p0 = (mx, my, a, b) and
// p1 = (c, op, depth, 0), rounded op by op in the plain version's order
// with no fused multiply-add: the cut at 1/255 is a step, and an alpha one
// ulp on the other side of it moves a pixel by up to 1/255 * T
__device__ __forceinline__ float power_of(float4 p0, float4 p1, float dx, float dy) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(p0.z, dx), dx), __fmul_rn(__fmul_rn(p1.x, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(p0.w, dx), dy));
}

// A gaussian's skip test, (h, t): its alpha op exp(power) is below 1/255
// at every pixel at least sqrt(d2) from its mean where h * d2 > t. With
// Q = [[a, b], [b, c]], power = -0.5 Q(d) <= -0.5 lam |d|^2 for lam Q's
// smaller eigenvalue, and alpha < 1/255 once 0.5 lam |d|^2 > ln(255 op).
// The slack covers fp32: lam is lowered by 4e-6 (|a| + |c| + 2|b|), more
// than the rounding of lam and of the power as power_of takes it (about
// 2e-7 of that times |d|^2); t = ln(255 op) + 1e-4, more than the relative
// errors of expf, logf and the product with op; h = 0.5 lam lowered by 1e-5
// relative, more than the rounding of h * d2. Where lam is not positive, h
// is -inf and nothing is skipped; a parameter that is not finite makes the
// comparison false.
__device__ __forceinline__ float2 skip_test(float4 p0, float4 p1) {
  const float a = p0.z, b = p0.w, c = p1.x;
  const float lam = 0.5f * (a + c) - sqrtf(0.25f * (a - c) * (a - c) + b * b) -
                    4e-6f * (fabsf(a) + fabsf(c) + 2.f * fabsf(b));
  return make_float2(lam > 0.f ? 0.5f * lam * (1.f - 1e-5f) : -INFINITY, logf(255.f * p1.y) + 1e-4f);
}

// the test on the rectangle [x0, x1] x [y0, y1] of pixel centres: true where
// the gaussian (mean mx, my) can be skipped there
__device__ __forceinline__ bool skipped(float2 test, float mx, float my, float x0, float x1, float y0, float y1) {
  const float ex = fmaxf(fmaxf(x0 - mx, mx - x1), 0.f);
  const float ey = fmaxf(fmaxf(y0 - my, my - y1), 0.f);
  return test.x * (ex * ex + ey * ey) > test.y;
}

// The gaussians of a staged chunk (nj of them: params prm, tests test) that
// the warp's rectangle does not skip, as bit masks: lane l tests gaussians
// l, 32 + l, ..., so the warp's loop over the chunk visits only these, in
// list order, with no test of its own.
__device__ __forceinline__ void live_masks(unsigned (&live)[kChunk / 32], const float4 (*prm)[2],
                                           const float2* test, int nj, int lane, float x0, float x1, float y0,
                                           float y1) {
#pragma unroll
  for (int q = 0; q < kChunk / 32; ++q) {
    const int j = q * 32 + lane;
    live[q] = __ballot_sync(0xffffffffu, j < nj && !skipped(test[j], prm[j][0].x, prm[j][0].y, x0, x1, y0, y1));
  }
}

// the next live gaussian of a mask (the caller checks m != 0 first)
__device__ __forceinline__ int pop_live(unsigned& m) {
  const int j = __ffs(m) - 1;
  m &= m - 1;
  return j;
}

// order[r] = the tile (view * tiles + tile) with the r-th largest work, ties
// in tile order, so that a launch takes its longest tiles first and no long
// tile starts last. The work of tile i is counts[i] gaussians, or, given the
// forward's swept, the min(counts[i], swept[i] * 128) that it composited.
// One thread a tile, counting the tiles ahead of it (n is a few hundred).
static __global__ void order_tiles_kernel(const int* __restrict__ counts, const int* __restrict__ swept, int n,
                                          int* __restrict__ order) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  auto work = [&](int t) { return swept ? min(counts[t], max(swept[t], 0) * kChunk) : counts[t]; };
  const int wi = work(i);
  int rank = 0;
  for (int t = 0; t < n; ++t) {
    const int wt = work(t);
    rank += wt > wi || (wt == wi && t < i);
  }
  order[rank] = i;
}

static inline cudaError_t order_tiles(const int* counts, const int* swept, int n, int* order, cudaStream_t stream) {
  order_tiles_kernel<<<(n + 255) / 256, 256, 0, stream>>>(counts, swept, n, order);
  return cudaGetLastError();
}

}  // namespace siu3r_raster
