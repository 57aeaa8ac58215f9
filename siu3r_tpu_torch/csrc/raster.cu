// Front-to-back alpha compositing of 16x128 pixel tiles over their binned,
// depth-ordered gaussian lists, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_raster_kernel` (siu3r_tpu/render/rasterizer.py:379).
// Per pixel of a tile, over the tile's list in order:
//   alpha = min(op * exp(-0.5 (a dx^2 + c dy^2) - b dx dy), 0.99),
//   dropped below 1/255 and past the tile's count;
//   color += c alpha T, depth += d alpha T, T *= (1 - alpha);
// out: color, depth and alpha = 1 - T. The whole tile stops at a 128-gaussian
// chunk boundary once every pixel has T <= 1e-4, as the TPU kernel does (its
// tril-matmul log-sum transmittance is a device for its matrix unit; here
// each pixel keeps a running product).
//
// What bounds it on the card: operations. Each (gaussian, pixel) pair costs
// about 12 fp32 operations and an exp for the alpha, plus 2 per colour
// channel and 2 for depth where the alpha is kept, over up to K = 4096
// gaussians x 2048 pixels per tile; the bytes (params and colours of the
// listed gaussians, the image out) are small beside that.
//
// Design: one block per (view, tile), all views in one launch; each thread
// owns a few pixels of one column and keeps their sums in registers. The
// block stages each chunk's ids, params (32 bytes a gaussian) and colours in
// shared memory, reading them through the binning table (no gathered copy in
// device memory), and every thread sweeps the chunk for its pixels. The
// colours are taken in groups of CG channels: CG = 4 with 512 threads of 4
// pixels, CG = 16 with 256 threads of 8 pixels, so that the pixels x CG sums
// stay in registers without spilling (ptxas' report is in build.log). A group
// past the first sweeps the same number of chunks that the first one found,
// recomputing the alphas. The whole-tile exit is a __syncthreads_or at each
// chunk boundary.
// The alpha is rounded as the plain PyTorch version rounds it (no fused
// multiply-add), so both keep and drop the same (gaussian, pixel) pairs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 128;
constexpr int kChunk = 128;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// CG channels a sweep, kThreads threads a block, each owning kPix pixels
template <int CG, int kThreads>
__global__ void __launch_bounds__(kThreads, 1) raster_kernel(
    const int* __restrict__ table, const int* __restrict__ counts,
    const float* __restrict__ params, const float* __restrict__ colors,
    float* __restrict__ color_out, float* __restrict__ depth_out,
    float* __restrict__ alpha_out, int* __restrict__ swept_out,
    int n_tiles, int n_tx, int K, int G, int H, int W, int C,
    int views_per_color, long long color_view_stride, long long color_g_stride) {
  static_assert(CG % 4 == 0, "colour groups are whole float4s");
  static_assert(kThreads >= kChunk, "one thread stages each gaussian of a chunk");
  constexpr int CG4 = CG / 4;
  constexpr int kPix = kTileH * kTileW / kThreads;
  __shared__ int s_id[kChunk];
  __shared__ float4 s_prm[kChunk][2];  // (mx, my, a, b), (c, op, depth, 0)
  __shared__ float4 s_col[kChunk][CG4];

  const int tid = threadIdx.x;
  const int view = blockIdx.x / n_tiles;
  const int tile = blockIdx.x % n_tiles;
  const int row0 = (tile / n_tx) * kTileH;
  const int col0 = (tile % n_tx) * kTileW;
  const int count = counts[blockIdx.x];
  const int* tbl = table + (long long)blockIdx.x * K;
  const float4* prm_v = reinterpret_cast<const float4*>(params + (long long)view * G * 8);
  const float* col_v = colors + (long long)(view / views_per_color) * color_view_stride;

  // pixel i of this thread: p = tid + i * kThreads, so one column and rows
  // kRowStep apart
  static_assert(kThreads % kTileW == 0, "a thread's pixels share one column");
  constexpr int kRowStep = kThreads / kTileW;
  const float px = (float)(col0 + tid % kTileW);
  const float py0 = (float)(row0 + tid / kTileW);

  int n_chunks = 0;  // chunks the first colour group swept before the exit
  for (int c0 = 0; c0 < C; c0 += CG) {
    float trans[kPix], depth[kPix], acc[kPix][CG];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      trans[i] = 1.f;
      depth[i] = 0.f;
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[i][c] = 0.f;
    }
    int ci = 0;
    for (int base = 0; base < count; base += kChunk, ++ci) {
      if (c0 == 0) {
        bool live = false;
#pragma unroll
        for (int i = 0; i < kPix; ++i) live |= trans[i] > kTEps;
        if (!__syncthreads_or(live)) break;  // the whole tile is saturated
      } else {
        if (ci >= n_chunks) break;
        __syncthreads();  // the previous chunk's shared memory is read
      }
      const int nj = min(kChunk, count - base);
      if (tid < nj) {
        const int id = tbl[base + tid];
        s_id[tid] = id;
        s_prm[tid][0] = prm_v[2LL * id];
        s_prm[tid][1] = prm_v[2LL * id + 1];
      }
      __syncthreads();
      for (int idx = tid; idx < nj * CG; idx += kThreads) {
        const int j = idx / CG;
        const int c = idx % CG;
        const float v = c0 + c < C ? col_v[(long long)s_id[j] * color_g_stride + c0 + c] : 0.f;
        reinterpret_cast<float*>(&s_col[j][0])[c] = v;
      }
      __syncthreads();
      for (int j = 0; j < nj; ++j) {
        const float4 p0 = s_prm[j][0];
        const float4 p1 = s_prm[j][1];
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          const float dx = px - p0.x;
          const float dy = (py0 + (float)(i * kRowStep)) - p0.y;
          // rounded op by op, in the plain version's order, with no fused
          // multiply-add: the cut at 1/255 is a step, and an alpha one ulp
          // on the other side of it moves a pixel by up to 1/255 * T
          const float q = __fadd_rn(__fmul_rn(__fmul_rn(p0.z, dx), dx), __fmul_rn(__fmul_rn(p1.x, dy), dy));
          const float power = __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(p0.w, dx), dy));
          const float alpha = fminf(__fmul_rn(p1.y, expf(power)), kAlphaMax);
          if (alpha < kAlphaMin) continue;
          const float w = alpha * trans[i];
#pragma unroll
          for (int c4 = 0; c4 < CG4; ++c4) {
            const float4 col = s_col[j][c4];
            acc[i][4 * c4 + 0] += w * col.x;
            acc[i][4 * c4 + 1] += w * col.y;
            acc[i][4 * c4 + 2] += w * col.z;
            acc[i][4 * c4 + 3] += w * col.w;
          }
          depth[i] += w * p1.z;
          trans[i] *= 1.f - alpha;
        }
      }
    }
    if (c0 == 0) n_chunks = ci;

#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int p = tid + i * kThreads;
      const int y = row0 + p / kTileW;
      const int x = col0 + p % kTileW;
      if (y >= H || x >= W) continue;
      const long long pix = ((long long)view * H + y) * W + x;
#pragma unroll
      for (int c = 0; c < CG; ++c)
        if (c0 + c < C) color_out[pix * C + c0 + c] = acc[i][c];
      if (c0 == 0) {
        depth_out[pix] = depth[i];
        alpha_out[pix] = 1.f - trans[i];
      }
    }
  }
  if (tid == 0) swept_out[blockIdx.x] = n_chunks;
}

}  // namespace

// table [views, T, K] int32 and counts [views, T] int32 from the binning;
// params [views, G, 8] fp32 (mx, my, a, b, c, opacity, depth, 0); colors:
// view v reads the slab v / views_per_color, element (g, c) at
// g * color_g_stride + c from the slab's start, slabs color_view_stride
// apart. Out: color [views, H, W, C], depth and alpha [views, H, W] fp32,
// swept [views, T] int32 (chunks composited before the exit). Contiguous
// unless said otherwise.
extern "C" int siu3r_raster_fwd(
    const int* table, const int* counts, const float* params, const float* colors,
    float* color_out, float* depth_out, float* alpha_out, int* swept_out,
    int n_views, int n_ty, int n_tx, int K, int G, int H, int W, int C,
    int views_per_color, long long color_view_stride, long long color_g_stride,
    cudaStream_t stream) {
  const long long blocks = (long long)n_views * n_ty * n_tx;
  if (n_views < 1 || n_ty < 1 || n_tx < 1 || K < 1 || G < 1 || C < 1 || views_per_color < 1 ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = n_ty * n_tx;
  // 4 pixels x 4 channels a thread at 512 threads; 8 x 16 at 256 threads, so
  // the 16-channel sums take registers that 512 threads would not have
  if (C <= 4) {
    raster_kernel<4, 512><<<(unsigned)blocks, 512, 0, stream>>>(
        table, counts, params, colors, color_out, depth_out, alpha_out, swept_out, n_tiles, n_tx,
        K, G, H, W, C, views_per_color, color_view_stride, color_g_stride);
  } else {
    raster_kernel<16, 256><<<(unsigned)blocks, 256, 0, stream>>>(
        table, counts, params, colors, color_out, depth_out, alpha_out, swept_out, n_tiles, n_tx,
        K, G, H, W, C, views_per_color, color_view_stride, color_g_stride);
  }
  return (int)cudaGetLastError();
}
