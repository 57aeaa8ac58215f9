// Backward of the tile compositing (csrc/raster.cu), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_raster_bwd_kernel` (siu3r_tpu/render/rasterizer.py:527).
// Per pixel, over a tile's list in order, with the forward's alpha
// (alpha_i = min(raw_i, 0.99), raw_i = op_i * exp(power_i), kept where
// alpha_i >= 1/255 and i < count), T_i the transmittance in front of i,
// w_i = alpha_i T_i, r_i = c_i . gC + depth_i gD and gT = -g(alpha out):
//   dL/dalpha_i = T_i r_i - (S_i + T_N gT) / (1 - alpha_i),  S_i = sum_{j>i} w_j r_j,
// zero where raw_i >= 0.99 (alpha clamped); d colour_i = sum_p w_i gC,
// d depth_i = sum_p w_i gD, and the conic, mean and opacity gradients follow
// from d power = dL/dalpha * raw. Like the forward, it stops at the chunk
// where every pixel of the tile had T <= 1e-4: later chunks get no gradient.
//
// What bounds it on the card: operations. The function needs each (gaussian,
// pixel) pair's alpha up to the tile's exit once (about 15 fp32 operations)
// and about 36 + 4C more for a kept pair; this design sweeps every pair
// twice, so it does that alpha work twice. The bytes (the listed params and
// colours, the image cotangents in; the gradients out) are small beside it.
//
// Design: one block per (view, tile), 256 threads of 8 pixels (one column,
// rows 2 apart), the chunk's ids, params and colours staged in shared memory
// through the binning table, as in the forward. Two forward sweeps and no
// scratch memory:
//   1. re-sweep the tile as the forward does (alpha rounded op by op, the
//      same whole-tile exit), keeping per pixel the total R = sum_i w_i r_i
//      and the final T_N;
//   2. sweep the same chunks again, recomputing T_i as the forward does (no
//      division by 1 - alpha, which loses T where a pixel saturates inside a
//      chunk and drifts near alpha = 0.99) and the suffix as
//      S_i = R - sum_{j<=i} w_j r_j. Both sums are kept in fp64: S_i can be
//      far smaller than R where a pixel saturates, and an fp32 difference
//      would lose it (about 1e-7 R of error, then divided by 1 - alpha).
// Gradients are summed over the tile's 2048 pixels by a warp shuffle and a
// shared-memory atomicAdd per warp, then added to device memory with one
// atomicAdd per (gaussian, value) and tile. atomicAdd, not a per-slot buffer
// and index_add_: a gaussian is listed by up to 8 tiles a view, and the
// per-slot buffer ([views x tiles, K, 8 + C], 17 MB at the training shapes)
// would be written and read again in full, where the atomics touch only the
// listed slots up to each tile's exit. The order of the atomics varies from
// run to run, so results differ in the last bits between runs.
// Colours are taken in groups of CG channels (CG = 4 for C <= 4, else 8): the
// backward is linear in the image cotangents, so each group sweeps with its
// channels' cotangents (depth and alpha in the first group only) and the
// groups' parameter gradients add up. A group past the first sweeps the
// chunks that the first one found.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 128;
constexpr int kChunk = 128;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kThreads = 256;
constexpr int kPix = kTileH * kTileW / kThreads;  // pixels a thread
constexpr int kRowStep = kThreads / kTileW;      // rows between a thread's pixels
constexpr int kNParam = 7;                       // mx, my, a, b, c, opacity, depth

// the forward's power and raw alpha (raster.cu), rounded op by op with no
// fused multiply-add, so both keep and drop the same pairs
__device__ __forceinline__ float power_of(float4 p0, float4 p1, float dx, float dy) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(p0.z, dx), dx), __fmul_rn(__fmul_rn(p1.x, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(p0.w, dx), dy));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int CG>
__global__ void __launch_bounds__(kThreads, 1) raster_bwd_kernel(
    const int* __restrict__ table, const int* __restrict__ counts,
    const float* __restrict__ params, const float* __restrict__ colors,
    const float* __restrict__ gcolor, const float* __restrict__ gdepth,
    const float* __restrict__ galpha, float* __restrict__ dparams, float* __restrict__ dcolors,
    int n_tiles, int n_tx, int K, int G, int H, int W, int C,
    int views_per_color, long long color_view_stride, long long color_g_stride) {
  constexpr int kAcc = kNParam + CG;
  __shared__ int s_id[kChunk];
  __shared__ float4 s_prm[kChunk][2];  // (mx, my, a, b), (c, op, depth, 0)
  __shared__ float s_col[kChunk][CG];
  __shared__ float s_acc[kChunk][kAcc];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int view = blockIdx.x / n_tiles;
  const int tile = blockIdx.x % n_tiles;
  const int row0 = (tile / n_tx) * kTileH;
  const int col0 = (tile % n_tx) * kTileW;
  const int count = counts[blockIdx.x];
  const int* tbl = table + (long long)blockIdx.x * K;
  const float4* prm_v = reinterpret_cast<const float4*>(params + (long long)view * G * 8);
  const int slab = view / views_per_color;
  const float* col_v = colors + (long long)slab * color_view_stride;
  float* dprm_v = dparams + (long long)view * G * 8;
  float* dcol_v = dcolors + (long long)slab * G * C;
  const float px = (float)(col0 + tid % kTileW);
  const float py0 = (float)(row0 + tid / kTileW);

  // stage chunk `base` (nj gaussians) of colour group c0 in shared memory
  auto stage = [&](int base, int nj, int c0) {
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
      s_col[j][c] = c0 + c < C ? col_v[(long long)s_id[j] * color_g_stride + c0 + c] : 0.f;
    }
  };

  int n_chunks = 0;  // chunks the forward composited before its exit
  for (int c0 = 0; c0 < C; c0 += CG) {
    float gc[kPix][CG], gd[kPix], gt[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int p = tid + i * kThreads;
      const int y = row0 + p / kTileW;
      const int x = col0 + p % kTileW;
      const bool inside = y < H && x < W;
      const long long pix = ((long long)view * H + y) * W + x;
#pragma unroll
      for (int c = 0; c < CG; ++c) gc[i][c] = inside && c0 + c < C ? gcolor[pix * C + c0 + c] : 0.f;
      gd[i] = inside && c0 == 0 ? gdepth[pix] : 0.f;
      gt[i] = inside && c0 == 0 ? -galpha[pix] : 0.f;
    }

    // ---- sweep 1: the forward's transmittance, the total R and T_N
    float trans[kPix];
    double total[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      trans[i] = 1.f;
      total[i] = 0.0;
    }
    int ci = 0;
    for (int base = 0; base < count; base += kChunk, ++ci) {
      if (c0 == 0) {
        bool live = false;
#pragma unroll
        for (int i = 0; i < kPix; ++i) live |= trans[i] > kTEps;
        if (!__syncthreads_or(live)) break;  // the forward stopped here
      } else {
        if (ci >= n_chunks) break;
        __syncthreads();  // the previous chunk's shared memory is read
      }
      const int nj = min(kChunk, count - base);
      stage(base, nj, c0);
      __syncthreads();
      for (int j = 0; j < nj; ++j) {
        const float4 p0 = s_prm[j][0];
        const float4 p1 = s_prm[j][1];
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          const float dx = px - p0.x;
          const float dy = (py0 + (float)(i * kRowStep)) - p0.y;
          const float alpha = fminf(__fmul_rn(p1.y, expf(power_of(p0, p1, dx, dy))), kAlphaMax);
          if (alpha < kAlphaMin) continue;
          const float w = alpha * trans[i];
          float r = p1.z * gd[i];
#pragma unroll
          for (int c = 0; c < CG; ++c) r = fmaf(s_col[j][c], gc[i][c], r);
          total[i] = fma((double)w, (double)r, total[i]);
          trans[i] *= 1.f - alpha;
        }
      }
    }
    if (c0 == 0) n_chunks = ci;

    // ---- sweep 2: the gradients
    float tn_gt[kPix];
    double prefix[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      tn_gt[i] = trans[i] * gt[i];
      trans[i] = 1.f;
      prefix[i] = 0.0;
    }
    for (ci = 0; ci < n_chunks; ++ci) {
      const int base = ci * kChunk;
      const int nj = min(kChunk, count - base);
      __syncthreads();  // the previous chunk's shared memory is read and flushed
      for (int idx = tid; idx < kChunk * kAcc; idx += kThreads) (&s_acc[0][0])[idx] = 0.f;
      stage(base, nj, c0);
      __syncthreads();
      for (int j = 0; j < nj; ++j) {
        const float4 p0 = s_prm[j][0];
        const float4 p1 = s_prm[j][1];
        float col[CG];
#pragma unroll
        for (int c = 0; c < CG; ++c) col[c] = s_col[j][c];
        float acc[kAcc];
#pragma unroll
        for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
        bool touched = false;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          const float dx = px - p0.x;
          const float dy = (py0 + (float)(i * kRowStep)) - p0.y;
          const float e = expf(power_of(p0, p1, dx, dy));
          const float raw = __fmul_rn(p1.y, e);
          const float alpha = fminf(raw, kAlphaMax);
          if (alpha < kAlphaMin) continue;
          touched = true;
          const float t = trans[i];
          const float w = alpha * t;
          float r = p1.z * gd[i];
#pragma unroll
          for (int c = 0; c < CG; ++c) r = fmaf(col[c], gc[i][c], r);
          prefix[i] = fma((double)w, (double)r, prefix[i]);
          const float suffix = (float)(total[i] - prefix[i]);
          const float da = raw < kAlphaMax ? t * r - (suffix + tn_gt[i]) / (1.f - alpha) : 0.f;
          const float dpw = da * raw;
          acc[0] += dpw * (p0.z * dx + p0.w * dy);
          acc[1] += dpw * (p1.x * dy + p0.w * dx);
          acc[2] += dpw * (-0.5f * dx * dx);
          acc[3] += dpw * (-dx * dy);
          acc[4] += dpw * (-0.5f * dy * dy);
          acc[5] += da * e;
          acc[6] += w * gd[i];
#pragma unroll
          for (int c = 0; c < CG; ++c) acc[kNParam + c] += w * gc[i][c];
          trans[i] = t * (1.f - alpha);
        }
        if (__any_sync(0xffffffffu, touched)) {
#pragma unroll
          for (int a = 0; a < kAcc; ++a) {
            const float v = warp_sum(acc[a]);
            if (lane == 0 && v != 0.f) atomicAdd(&s_acc[j][a], v);
          }
        }
      }
      __syncthreads();
      for (int idx = tid; idx < nj * kAcc; idx += kThreads) {
        const int j = idx / kAcc;
        const int a = idx % kAcc;
        const float v = s_acc[j][a];
        if (v == 0.f) continue;
        if (a < kNParam) {
          atomicAdd(&dprm_v[(long long)s_id[j] * 8 + a], v);
        } else if (c0 + a - kNParam < C) {
          atomicAdd(&dcol_v[(long long)s_id[j] * C + c0 + a - kNParam], v);
        }
      }
    }
    __syncthreads();  // the last chunk's flush is done before the next group stages
  }
}

}  // namespace

// table [views, T, K] int32, counts [views, T] int32, params [views, G, 8] and
// colors (view v reads slab v / views_per_color; element (g, c) at
// g * color_g_stride + c from the slab's start, slabs color_view_stride apart)
// as the forward took them; gcolor [views, H, W, C], gdepth and galpha
// [views, H, W] fp32 contiguous, the cotangents of the forward's outputs.
// Out, added to (the caller zeroes them): dparams [views, G, 8] (the last
// slot stays 0) and dcolors [slabs, G, C] fp32 contiguous.
extern "C" int siu3r_raster_bwd(
    const int* table, const int* counts, const float* params, const float* colors,
    const float* gcolor, const float* gdepth, const float* galpha, float* dparams, float* dcolors,
    int n_views, int n_ty, int n_tx, int K, int G, int H, int W, int C,
    int views_per_color, long long color_view_stride, long long color_g_stride,
    cudaStream_t stream) {
  const long long blocks = (long long)n_views * n_ty * n_tx;
  if (n_views < 1 || n_ty < 1 || n_tx < 1 || K < 1 || G < 1 || C < 1 || views_per_color < 1 ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = n_ty * n_tx;
  if (C <= 4) {
    raster_bwd_kernel<4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        table, counts, params, colors, gcolor, gdepth, galpha, dparams, dcolors, n_tiles, n_tx,
        K, G, H, W, C, views_per_color, color_view_stride, color_g_stride);
  } else {
    raster_bwd_kernel<8><<<(unsigned)blocks, kThreads, 0, stream>>>(
        table, counts, params, colors, gcolor, gdepth, galpha, dparams, dcolors, n_tiles, n_tx,
        K, G, H, W, C, views_per_color, color_view_stride, color_g_stride);
  }
  return (int)cudaGetLastError();
}
