// Multi-scale deformable attention forward for Hopper (sm_90a), all levels in
// one launch.
//
// Replaces the TPU kernel `_level_kernel` (siu3r_tpu/ops/msda_pallas.py:44),
// which built a one-hot bilinear weight matrix per level and fed it to the
// MXU. Here the same function is a gather: for each (batch, query, head) and
// each level and point, the sample point gx = x * W - 0.5, gy = y * H - 0.5
// is floored and its four taps are read from `value`, with zero padding for
// taps outside the level (align_corners=False), weighted by the bilinear
// weights and the attention weight, and summed in fp32.
//
// What bounds it on the card: each output channel takes L*P*4 taps, about
// 2 flops each, and reads one value row per tap: a memory-bound gather whose
// value tensor (2 MB at the main path's shapes) fits the 50 MB L2 of an H100
// SXM (700 W). The design makes every tap one coalesced row read: one warp per
// (batch, query, head), lanes over the head dim (D = 32: one channel a lane;
// D = 64: two), and the sampling location and weight of a point are one
// broadcast load for the warp.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

template <int D>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) msda_fwd_kernel(
    const float* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ aw, float* __restrict__ out, const Levels lv,
    int B, int len_in, int Lq, int H, int P) {
  constexpr int C = D / 32;  // channels per lane
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * Lq * H) return;  // whole warps leave together
  const int h = (int)(warp % H);
  const long long bq = warp / H;  // b * Lq + q
  const int b = (int)(bq / Lq);

  const float* vbase = value + ((long long)b * len_in * H + h) * D + lane * C;
  const long long row_stride = (long long)H * D;
  const float* locp = loc + warp * lv.n * P * 2;
  const float* awp = aw + warp * lv.n * P;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  for (int l = 0; l < lv.n; ++l) {
    const int hh = lv.h[l];
    const int ww = lv.w[l];
    const float* vlev = vbase + (long long)lv.start[l] * row_stride;
    for (int pt = 0; pt < P; ++pt) {
      const int i = l * P + pt;
      // rounded multiply then subtract (no fused multiply-add), as the plain
      // version computes it, so floor() sees the same value; clamping
      // far-away points keeps the int conversion defined, and all their taps
      // stay outside the level either way
      const float gx = fminf(fmaxf(__fsub_rn(__fmul_rn(locp[2 * i], (float)ww), 0.5f), -2.f), (float)ww + 1.f);
      const float gy = fminf(fmaxf(__fsub_rn(__fmul_rn(locp[2 * i + 1], (float)hh), 0.5f), -2.f), (float)hh + 1.f);
      const float a = awp[i];
      const float x0f = floorf(gx);
      const float y0f = floorf(gy);
      const float wx = gx - x0f;
      const float wy = gy - y0f;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const int dy = tap >> 1;
        const int dx = tap & 1;
        const int yi = y0 + dy;
        const int xi = x0 + dx;
        if (yi < 0 || yi >= hh || xi < 0 || xi >= ww) continue;
        const float w = a * (dy ? wy : 1.f - wy) * (dx ? wx : 1.f - wx);
        const float* row = vlev + (long long)(yi * ww + xi) * row_stride;
        if (C == 2) {
          const float2 val = *reinterpret_cast<const float2*>(row);
          acc[0] += w * val.x;
          acc[C - 1] += w * val.y;
        } else {
          acc[0] += w * row[0];
        }
      }
    }
  }
  float* optr = out + bq * row_stride + h * D + lane * C;
#pragma unroll
  for (int c = 0; c < C; ++c) optr[c] = acc[c];
}

}  // namespace

// value [B, len_in, H, D], loc [B, Lq, H, L, P, 2], aw [B, Lq, H, L, P],
// out [B, Lq, H*D]: contiguous fp32. level_hw holds (h, w) per level and
// level_start the first row of each level, both host arrays of n_levels.
extern "C" int siu3r_msda_fwd(
    const float* value, const float* loc, const float* aw, float* out,
    const int* level_hw, const int* level_start, int n_levels,
    int B, int len_in, int Lq, int H, int D, int P, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv{};
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    lv.start[l] = level_start[l];
  }
  const long long warps = (long long)B * Lq * H;
  const int blocks = (int)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int threads = kWarpsPerBlock * 32;
  if (D == 64) {
    msda_fwd_kernel<64><<<blocks, threads, 0, stream>>>(value, loc, aw, out, lv, B, len_in, Lq, H, P);
  } else if (D == 32) {
    msda_fwd_kernel<32><<<blocks, threads, 0, stream>>>(value, loc, aw, out, lv, B, len_in, Lq, H, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
