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
// listed gaussians, the image out) are small beside that. What held it back
// was the work's spread: with one block per tile, a tile swept to K ran on
// one SM at a few warps a scheduler while most SMs had finished, so the
// longest tile set the launch's length.
//
// Design: each tile is split over a cluster of 8 blocks, one 16x16 sub-tile
// a block (views x tiles x 8 blocks, co-scheduled on neighbouring SMs), 128
// threads of 2 pixels (one column, 2 rows), so that several blocks share an
// SM and a long tile spreads over 8. A small kernel first ranks the tiles by
// their counts, and the clusters take them longest first, so that no long
// tile starts last. Each block walks the tile's whole list for its 256
// pixels: chunk i + 1's params (32 bytes a gaussian) and colours are
// gathered through the binning table into a second shared-memory buffer by
// cp.async while chunk i composites (the ids come a chunk earlier, into
// registers). The whole-tile exit is voted across the cluster at each chunk
// boundary: each block takes __syncthreads_or over its pixels, one thread a
// block writes the result into every block's flag slot through distributed
// shared memory, and after one cluster barrier every block reads the 8 flags
// (two flag buffers, alternating, so that one barrier a chunk is enough; a
// barrier at entry makes sure every block runs before its flags are written,
// and one at exit that none leaves while another may still write them).
// Most listed pairs are dropped at the 1/255 cut, so a warp first skips
// the gaussians whose alpha is below 1/255 at every pixel of its 16x4
// rectangle (skip_test, raster_common.cuh: its lanes test 32 gaussians at
// once, and the warp visits the others only); that leaves out only pairs
// that would be dropped, so the outputs do not change. The warp takes the
// gaussians it visits two at a time, both alphas first (they do not depend
// on T), so that the chain through T does not wait on each exp. Colours are taken in groups of CG channels (4 for C <= 4, else 16)
// with the pixels x CG sums in registers; a group past the first sweeps the
// number of chunks that the first one found, recomputing the alphas.
// The alpha is rounded as the plain PyTorch version rounds it (no fused
// multiply-add), so both keep and drop the same (gaussian, pixel) pairs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "raster_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace siu3r_raster;

constexpr int kCluster = kSubs;  // a tile's blocks form one cluster
constexpr int kThreads = kChunk;                 // thread t stages gaussian t of each chunk
constexpr int kPix = kTileH * kSubW / kThreads;  // pixels a thread: one column, kPix rows
constexpr int kWarpRows = 32 / kSubW * kPix;     // rows of a warp's 16-column rectangle

// CG channels a sweep
template <int CG>
__global__ void __launch_bounds__(kThreads) raster_kernel(
    const int* __restrict__ table, const int* __restrict__ counts, const int* __restrict__ order,
    const float* __restrict__ params, const float* __restrict__ colors,
    float* __restrict__ color_out, float* __restrict__ depth_out,
    float* __restrict__ alpha_out, int* __restrict__ swept_out,
    int n_tiles, int n_tx, int K, int G, int H, int W, int C,
    int views_per_color, long long color_view_stride, long long color_g_stride) {
  __shared__ __align__(16) float4 s_prm[2][kChunk][2];  // (mx, my, a, b), (c, op, depth, 0)
  __shared__ __align__(16) float s_col[2][kChunk][CG];
  __shared__ float2 s_skip[2][kChunk];  // skip_test of each staged gaussian
  __shared__ int s_flag[2][kCluster];  // each block's vote, by rank, two rounds

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rank = (int)cluster.block_rank();
  cluster.sync();  // every block of the cluster runs before one writes another's flags
  const int vt = order[blockIdx.x / kCluster];  // view * n_tiles + tile, longest first
  const int view = vt / n_tiles;
  const int tile = vt % n_tiles;
  const int row0 = (tile / n_tx) * kTileH + (tid / kSubW) * kPix;
  const int col = (tile % n_tx) * kTileW + rank * kSubW + tid % kSubW;
  const int count = counts[vt];
  const int* tbl = table + (long long)vt * K;
  const float4* prm_v = reinterpret_cast<const float4*>(params + (long long)view * G * 8);
  const float* col_v = colors + (long long)(view / views_per_color) * color_view_stride;
  const float px = (float)col;
  const float py0 = (float)row0;
  // this warp's rectangle of pixels, for skip_test
  const float wx0 = (float)(col - tid % kSubW);
  const float wy0 = (float)((tile / n_tx) * kTileH + tid / 32 * kWarpRows);

  // the id of this thread's gaussian in the next chunk to stage (-1: none)
  int next_id;
  auto load_id = [&](int base) { next_id = base + tid < count ? tbl[base + tid] : -1; };
  // that gaussian's params and colour group c0 into buffer b
  auto stage = [&](int b, int c0) {
    if (next_id < 0) return;
    cp_async16(&s_prm[b][tid][0], prm_v + 2LL * next_id);
    cp_async16(&s_prm[b][tid][1], prm_v + 2LL * next_id + 1);
    const float* src = col_v + (long long)next_id * color_g_stride + c0;
#pragma unroll
    for (int c = 0; c < CG; ++c) cp_async4(&s_col[b][tid][c], c0 + c < C ? src + c : col_v, c0 + c < C);
  };

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
    // pixel i takes gaussian j (staged in buffer b) with this alpha
    auto composite = [&](int i, float alpha, float d, int b, int j) {
      if (alpha < kAlphaMin) return;
      const float w = alpha * trans[i];
#pragma unroll
      for (int c4 = 0; c4 < CG / 4; ++c4) {
        const float4 cv = reinterpret_cast<const float4*>(&s_col[b][j][0])[c4];
        acc[i][4 * c4 + 0] += w * cv.x;
        acc[i][4 * c4 + 1] += w * cv.y;
        acc[i][4 * c4 + 2] += w * cv.z;
        acc[i][4 * c4 + 3] += w * cv.w;
      }
      depth[i] += w * d;
      trans[i] *= 1.f - alpha;
    };
    load_id(0);
    stage(0, c0);
    cp_async_commit();
    load_id(kChunk);
    int ci = 0;
    for (int base = 0; base < count; base += kChunk, ++ci) {
      if (c0 == 0) {
        if (ci > 0) {
          // the cluster's vote on T after chunk ci - 1; the block barrier also
          // ends chunk ci - 1's reads of the buffer that chunk ci + 1 fills
          bool live = false;
#pragma unroll
          for (int i = 0; i < kPix; ++i) live |= trans[i] > kTEps;
          const int mine = __syncthreads_or(live);
          if (tid < kCluster) *cluster.map_shared_rank(&s_flag[ci & 1][rank], tid) = mine;
          cluster.sync();
          int any = 0;
#pragma unroll
          for (int r = 0; r < kCluster; ++r) any |= s_flag[ci & 1][r];
          if (!any) break;  // the whole tile is saturated
        }
      } else {
        if (ci >= n_chunks) break;
        __syncthreads();  // chunk ci - 1's reads of the buffer chunk ci + 1 fills are done
      }
      if (base + kChunk < count) {
        stage((ci + 1) & 1, c0);
        load_id(base + 2 * kChunk);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this thread's copies of chunk ci have landed
      const int b = ci & 1;
      const int nj = min(kChunk, count - base);
      if (tid < nj) s_skip[b][tid] = skip_test(s_prm[b][tid][0], s_prm[b][tid][1]);
      __syncthreads();  // every thread's copies and tests
      unsigned live[kChunk / 32];
      live_masks(live, s_prm[b], s_skip[b], nj, lane, wx0, wx0 + (kSubW - 1), wy0, wy0 + (kWarpRows - 1));
      // the live gaussians two at a time: both alphas first (they do not
      // depend on T), then both composited in list order
#pragma unroll
      for (int q = 0; q < kChunk / 32; ++q) {
        unsigned m = live[q];
        while (m) {
          const int j0 = q * 32 + pop_live(m);
          const bool two = m != 0;  // the same for the whole warp
          const int j1 = two ? q * 32 + pop_live(m) : j0;
          const float4 a0 = s_prm[b][j0][0], a1 = s_prm[b][j0][1];
          const float4 c0p = s_prm[b][j1][0], c1p = s_prm[b][j1][1];
          const float dxa = px - a0.x, dxc = px - c0p.x;
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            const float py = py0 + (float)i;
            const float alpha_a = fminf(__fmul_rn(a1.y, expf(power_of(a0, a1, dxa, py - a0.y))), kAlphaMax);
            const float alpha_c = fminf(__fmul_rn(c1p.y, expf(power_of(c0p, c1p, dxc, py - c0p.y))), kAlphaMax);
            composite(i, alpha_a, a1.z, b, j0);
            if (two) composite(i, alpha_c, c1p.z, b, j1);
          }
        }
      }
    }
    if (c0 == 0) n_chunks = ci;
    cp_async_wait<0>();  // a copy issued for a chunk after the exit lands before the buffers are reused
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int y = row0 + i;
      if (y >= H || col >= W) continue;
      const long long pix = ((long long)view * H + y) * W + col;
#pragma unroll
      for (int c = 0; c < CG; ++c)
        if (c0 + c < C) color_out[pix * C + c0 + c] = acc[i][c];
      if (c0 == 0) {
        depth_out[pix] = depth[i];
        alpha_out[pix] = 1.f - trans[i];
      }
    }
  }
  if (rank == 0 && tid == 0) swept_out[vt] = n_chunks;
  cluster.sync();  // no block leaves while another may still write its flags
}

template <int CG>
cudaLaunchConfig_t launch_config(long long tiles, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int CG>
int launch(long long tiles, cudaStream_t stream, const int* table, const int* counts, const int* order,
           const float* params,
           const float* colors, float* color_out, float* depth_out, float* alpha_out, int* swept_out,
           int n_tiles, int n_tx, int K, int G, int H, int W, int C, int views_per_color,
           long long color_view_stride, long long color_g_stride) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<CG>(tiles, stream, &attr);
  return (int)cudaLaunchKernelEx(&cfg, raster_kernel<CG>, table, counts, order, params, colors, color_out, depth_out,
                                 alpha_out, swept_out, n_tiles, n_tx, K, G, H, W, C, views_per_color,
                                 color_view_stride, color_g_stride);
}

template <int CG>
int occupancy(long long tiles, int* clusters) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<CG>(tiles, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, raster_kernel<CG>, &cfg);
}

}  // namespace

// table [views, T, K] int32 and counts [views, T] int32 from the binning;
// params [views, G, 8] fp32 (mx, my, a, b, c, opacity, depth, 0), 16-byte
// aligned; colors: view v reads the slab v / views_per_color, element (g, c)
// at g * color_g_stride + c from the slab's start, slabs color_view_stride
// apart. Out: color [views, H, W, C], depth and alpha [views, H, W] fp32,
// swept [views, T] int32 (chunks composited before the exit). Contiguous
// unless said otherwise.
extern "C" int siu3r_raster_fwd(
    const int* table, const int* counts, int* order, const float* params, const float* colors,
    float* color_out, float* depth_out, float* alpha_out, int* swept_out,
    int n_views, int n_ty, int n_tx, int K, int G, int H, int W, int C,
    int views_per_color, long long color_view_stride, long long color_g_stride,
    cudaStream_t stream) {
  const long long tiles = (long long)n_views * n_ty * n_tx;
  if (n_views < 1 || n_ty < 1 || n_tx < 1 || K < 1 || G < 1 || C < 1 || views_per_color < 1 ||
      tiles * kCluster > 0x7fffffffLL || reinterpret_cast<unsigned long long>(params) % 16)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = n_ty * n_tx;
  int err = (int)order_tiles(counts, nullptr, (int)tiles, order, stream);
  if (err) return err;
  err = C <= 4
      ? launch<4>(tiles, stream, table, counts, order, params, colors, color_out, depth_out, alpha_out, swept_out,
                  n_tiles, n_tx, K, G, H, W, C, views_per_color, color_view_stride, color_g_stride)
      : launch<16>(tiles, stream, table, counts, order, params, colors, color_out, depth_out, alpha_out, swept_out,
                   n_tiles, n_tx, K, G, H, W, C, views_per_color, color_view_stride, color_g_stride);
  return err ? err : (int)cudaGetLastError();
}

// The launch siu3r_raster_fwd makes for these sizes. out[0..5]: blocks,
// threads a block, blocks a cluster, blocks a 16x128 tile, static shared
// bytes a block, and the clusters that can be resident on the device at once
// (cudaOccupancyMaxActiveClusters).
extern "C" int siu3r_raster_fwd_launch_config(int n_views, int n_ty, int n_tx, int C, int* out) {
  const long long tiles = (long long)n_views * n_ty * n_tx;
  if (n_views < 1 || n_ty < 1 || n_tx < 1 || C < 1 || tiles * kCluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  int err = C <= 4 ? (int)cudaFuncGetAttributes(&fa, raster_kernel<4>)
                   : (int)cudaFuncGetAttributes(&fa, raster_kernel<16>);
  if (err) return err;
  err = C <= 4 ? occupancy<4>(tiles, &out[5]) : occupancy<16>(tiles, &out[5]);
  out[0] = (int)(tiles * kCluster);
  out[1] = kThreads;
  out[2] = kCluster;
  out[3] = kCluster;
  out[4] = (int)fa.sharedSizeBytes;
  return err;
}
