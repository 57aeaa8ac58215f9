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
// where every pixel of the tile had T <= 1e-4: it takes the forward's
// `swept` (chunks composited per tile) and sweeps min(count, swept * 128)
// gaussians; later ones get no gradient.
//
// What bounds it on the card: operations. The function needs each (gaussian,
// pixel) pair's alpha up to the tile's exit once (about 15 fp32 operations)
// and about 36 + 4C more for a kept pair; this design sweeps every pair
// twice, so it does that alpha work twice. The bytes (the listed params and
// colours, the image cotangents in; the gradients out) are small beside it.
// What held it back was the work's spread (one block per tile: a tile swept
// to K ran on one SM at two warps a scheduler) and the cost of a kept pair
// (fp64 sums and their conversions, an IEEE division, eleven warp sums).
//
// Design: each 16x128 tile is split over 8 independent blocks of 16x16
// pixels (views x tiles x 8 blocks): with the forward's `swept` no block
// needs another's vote, and a small kernel first ranks the tiles by the
// gaussians they composited so that the longest go first. 128 threads a
// block, each owning 2 pixels of one column. The chunk's ids, params and
// colours are gathered through the binning table into shared memory by
// cp.async, chunk i + 1's while chunk i is swept; as in the forward, a warp
// visits only the gaussians whose alpha can pass 1/255 somewhere in its
// 16x4 rectangle (skip_test, raster_common.cuh), the first sweep two at a
// time. Two forward sweeps and no scratch memory:
//   1. the forward's transmittance, keeping per pixel the total
//      R = sum_i w_i r_i and the final T_N;
//   2. the same chunks again, recomputing T_i as the forward does (no
//      division by 1 - alpha, which loses T where a pixel saturates), and the
//      suffix as S_i = R - sum_{j<=i} w_j r_j. S_i can be far smaller than R
//      where a pixel saturates, and an fp32 difference would lose it (about
//      1e-7 R of error, then divided by 1 - alpha): R and the prefix are
//      compensated fp32 pairs (each product split exactly by an FMA, each sum
//      by TwoSum). Both sweeps make the same operations in the same order,
//      so R - prefix_i cancels everything up to pair i exactly and keeps
//      what the later pairs add, the bits each addition rounds away carried
//      in the low part: fp32 rates, where fp64 sums cost five fp32-fp64
//      conversions a pair.
// 1 / (1 - alpha) is one approximate reciprocal (2 ulp; the gradient has no
// step there). The second sweep also takes the gaussians two at a time; for
// each pair a warp sums their 32 values (7 parameter slots, CG colours and
// padding each) over its lanes by one reduce-scatter (31 shuffles, where
// two gaussians' eleven warp sums took 110), after which lane l owns value
// l and adds it to shared memory; at the end of a chunk the block adds its
// totals to device memory with one atomicAdd per (gaussian, value). The
// order of the atomics varies from run to run, so results differ in the
// last bits between runs.
// Colours are taken in groups of CG channels (CG = 4 for C <= 4, else 8): the
// backward is linear in the image cotangents, so each group sweeps with its
// channels' cotangents (depth and alpha in the first group only) and the
// groups' parameter gradients add up.

#include <cuda_runtime.h>
#include <math.h>

#include "raster_common.cuh"

namespace {

using namespace siu3r_raster;

constexpr int kThreads = kChunk;                 // thread t stages gaussian t of each chunk
constexpr int kPix = kTileH * kSubW / kThreads;  // pixels a thread: one column, kPix rows
constexpr int kWarpRows = 32 / kSubW * kPix;     // rows of a warp's 16-column rectangle
constexpr int kNParam = 7;                       // mx, my, a, b, c, opacity, depth
constexpr int kVals = 16;                        // values a gaussian sums per warp, padded

// (hi, lo) += a * b, compensated: the product split exactly by an FMA, the
// sum by TwoSum (intrinsics, so that nothing is contracted or reassociated);
// lo gathers the rounding errors unnormalised
__device__ __forceinline__ void add_product(float& hi, float& lo, float a, float b) {
  const float p = __fmul_rn(a, b);
  const float pe = fmaf(a, b, -p);
  const float s = __fadd_rn(hi, p);
  const float bb = __fsub_rn(s, hi);
  const float e = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(p, bb));
  hi = s;
  lo = __fadd_rn(lo, __fadd_rn(e, pe));
}

// one halving step of the reduce-scatter: lanes apart by O swap halves of
// their 2 O values, each keeping (and summing) the half its bit O selects
template <int O>
__device__ __forceinline__ void halve(float (&v)[2 * kVals], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = upper ? v[k] : v[k + O];
    const float keep = upper ? v[k + O] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// v[0..31], two gaussians' values, summed over the warp's lanes: afterwards
// lane l holds the sum of value l in v[0]
__device__ __forceinline__ void reduce_scatter(float (&v)[2 * kVals], int lane) {
  static_assert(2 * kVals == 32, "five halvings from one value a lane");
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
}

template <int CG>
__global__ void __launch_bounds__(kThreads) raster_bwd_kernel(
    const int* __restrict__ table, const int* __restrict__ counts, const int* __restrict__ swept,
    const int* __restrict__ order, const float* __restrict__ params, const float* __restrict__ colors,
    const float* __restrict__ gcolor, const float* __restrict__ gdepth,
    const float* __restrict__ galpha, float* __restrict__ dparams, float* __restrict__ dcolors,
    int n_tiles, int n_tx, int K, int G, int H, int W, int C,
    int views_per_color, long long color_view_stride, long long color_g_stride) {
  static_assert(kNParam + CG <= kVals, "a gaussian's values fit the reduce-scatter");
  __shared__ int s_id[2][kChunk];
  __shared__ __align__(16) float4 s_prm[2][kChunk][2];  // (mx, my, a, b), (c, op, depth, 0)
  __shared__ __align__(16) float s_col[2][kChunk][CG];
  __shared__ float2 s_skip[2][kChunk];  // skip_test of each staged gaussian
  __shared__ float s_acc[kChunk][kVals];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int vt = order[blockIdx.x / kSubs];  // view * n_tiles + tile, longest first
  const int sub = blockIdx.x % kSubs;
  const int view = vt / n_tiles;
  const int tile = vt % n_tiles;
  const int row0 = (tile / n_tx) * kTileH + (tid / kSubW) * kPix;
  const int col = (tile % n_tx) * kTileW + sub * kSubW + tid % kSubW;
  const int n = min(counts[vt], max(swept[vt], 0) * kChunk);  // what the forward composited
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const int* tbl = table + (long long)vt * K;
  const float4* prm_v = reinterpret_cast<const float4*>(params + (long long)view * G * 8);
  const int slab = view / views_per_color;
  const float* col_v = colors + (long long)slab * color_view_stride;
  float* dprm_v = dparams + (long long)view * G * 8;
  float* dcol_v = dcolors + (long long)slab * G * C;
  const float px = (float)col;
  const float py0 = (float)row0;
  // this warp's rectangle of pixels, for skip_test
  const float wx0 = (float)(col - tid % kSubW);
  const float wx1 = wx0 + (float)(kSubW - 1);
  const float wy0 = (float)((tile / n_tx) * kTileH + tid / 32 * kWarpRows);
  const float wy1 = wy0 + (float)(kWarpRows - 1);

  for (int idx = tid; idx < kChunk * kVals; idx += kThreads) (&s_acc[0][0])[idx] = 0.f;

  // the id of this thread's gaussian in the next chunk to stage (-1: none)
  int next_id;
  auto load_id = [&](int base) { next_id = base + tid < n ? tbl[base + tid] : -1; };
  // that gaussian's id, params and colour group c0 into buffer b
  auto stage = [&](int b, int c0) {
    if (next_id < 0) return;
    s_id[b][tid] = next_id;
    cp_async16(&s_prm[b][tid][0], prm_v + 2LL * next_id);
    cp_async16(&s_prm[b][tid][1], prm_v + 2LL * next_id + 1);
    const float* src = col_v + (long long)next_id * color_g_stride + c0;
#pragma unroll
    for (int c = 0; c < CG; ++c) cp_async4(&s_col[b][tid][c], c0 + c < C ? src + c : col_v, c0 + c < C);
  };
  // stage chunk 0 now, and the ids of chunk 1
  auto start = [&](int c0) {
    load_id(0);
    stage(0, c0);
    cp_async_commit();
    load_id(kChunk);
  };
  // at the top of chunk ci: stage chunk ci + 1, wait for chunk ci and take
  // the skip test of the gaussian this thread staged
  auto advance = [&](int ci, int c0) {
    if ((ci + 1) * kChunk < n) {
      stage((ci + 1) & 1, c0);
      load_id((ci + 2) * kChunk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    const int b = ci & 1;
    if (tid < n - ci * kChunk) s_skip[b][tid] = skip_test(s_prm[b][tid][0], s_prm[b][tid][1]);
    __syncthreads();
  };

  for (int c0 = 0; c0 < C; c0 += CG) {
    float gc[kPix][CG], gd[kPix], gt[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int y = row0 + i;
      const bool inside = y < H && col < W;
      const long long pix = ((long long)view * H + y) * W + col;
#pragma unroll
      for (int c = 0; c < CG; ++c) gc[i][c] = inside && c0 + c < C ? gcolor[pix * C + c0 + c] : 0.f;
      gd[i] = inside && c0 == 0 ? gdepth[pix] : 0.f;
      gt[i] = inside && c0 == 0 ? -galpha[pix] : 0.f;
    }

    // ---- sweep 1: the forward's transmittance, the total R and T_N
    float trans[kPix], tot_hi[kPix], tot_lo[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      trans[i] = 1.f;
      tot_hi[i] = 0.f;
      tot_lo[i] = 0.f;
    }
    start(c0);
    for (int ci = 0; ci < n_chunks; ++ci) {
      __syncthreads();  // chunk ci - 1's reads of the buffer chunk ci + 1 fills are done
      advance(ci, c0);
      const int b = ci & 1;
      const int nj = min(kChunk, n - ci * kChunk);
      unsigned live[kChunk / 32];
      live_masks(live, s_prm[b], s_skip[b], nj, lane, wx0, wx1, wy0, wy1);
      // pixel i takes gaussian j with this alpha
      auto total = [&](int i, float alpha, float d, int j) {
        if (alpha < kAlphaMin) return;
        const float w = alpha * trans[i];
        float r = d * gd[i];
#pragma unroll
        for (int c = 0; c < CG; ++c) r = fmaf(s_col[b][j][c], gc[i][c], r);
        add_product(tot_hi[i], tot_lo[i], w, r);
        trans[i] *= 1.f - alpha;
      };
      // the live gaussians two at a time, as in the forward
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
            total(i, alpha_a, a1.z, j0);
            if (two) total(i, alpha_c, c1p.z, j1);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // ---- sweep 2: the gradients
    float tn_gt[kPix], pre_hi[kPix], pre_lo[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      tn_gt[i] = trans[i] * gt[i];
      trans[i] = 1.f;
      pre_hi[i] = 0.f;
      pre_lo[i] = 0.f;
    }
    start(c0);
    for (int ci = 0; ci < n_chunks; ++ci) {
      __syncthreads();  // the last flush is done: its ids' buffer and s_acc are free
      advance(ci, c0);
      const int b = ci & 1;
      const int nj = min(kChunk, n - ci * kChunk);
      unsigned live[kChunk / 32];
      live_masks(live, s_prm[b], s_skip[b], nj, lane, wx0, wx1, wy0, wy1);
#pragma unroll
      // pixel i's gradient terms of gaussian j (params p0, p1, exp(power) e)
      // into v[o..o + 15]; false where the pair is dropped
      auto gradient = [&](int i, float4 p0, float4 p1, float dx, float dy, float e, int j, float(&v)[2 * kVals],
                          int o) {
        const float raw = __fmul_rn(p1.y, e);
        const float alpha = fminf(raw, kAlphaMax);
        if (alpha < kAlphaMin) return false;
        const float t = trans[i];
        const float w = alpha * t;
        float r = p1.z * gd[i];
#pragma unroll
        for (int c = 0; c < CG; ++c) r = fmaf(s_col[b][j][c], gc[i][c], r);
        add_product(pre_hi[i], pre_lo[i], w, r);
        const float suffix = (tot_hi[i] - pre_hi[i]) + (tot_lo[i] - pre_lo[i]);
        const float da = raw < kAlphaMax ? t * r - __fdividef(suffix + tn_gt[i], 1.f - alpha) : 0.f;
        const float dpw = da * raw;
        v[o + 0] += dpw * (p0.z * dx + p0.w * dy);
        v[o + 1] += dpw * (p1.x * dy + p0.w * dx);
        v[o + 2] += dpw * (-0.5f * dx * dx);
        v[o + 3] += dpw * (-dx * dy);
        v[o + 4] += dpw * (-0.5f * dy * dy);
        v[o + 5] += da * e;
        v[o + 6] += w * gd[i];
#pragma unroll
        for (int c = 0; c < CG; ++c) v[o + kNParam + c] += w * gc[i][c];
        trans[i] = t * (1.f - alpha);
        return true;
      };
      // the live gaussians two at a time: both exps first, then both in list
      // order, then one reduce-scatter of their 32 values
#pragma unroll
      for (int q = 0; q < kChunk / 32; ++q) {
        for (unsigned m = live[q]; m;) {
          const int j0 = q * 32 + pop_live(m);
          const bool two = m != 0;  // the same for the whole warp
          const int j1 = two ? q * 32 + pop_live(m) : j0;
          const float4 a0 = s_prm[b][j0][0], a1 = s_prm[b][j0][1];
          const float4 c0p = s_prm[b][j1][0], c1p = s_prm[b][j1][1];
          const float dxa = px - a0.x, dxc = px - c0p.x;
          float v[2 * kVals];
#pragma unroll
          for (int a = 0; a < 2 * kVals; ++a) v[a] = 0.f;
          bool touched = false;
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            const float py = py0 + (float)i;
            const float ea = expf(power_of(a0, a1, dxa, py - a0.y));
            const float ec = expf(power_of(c0p, c1p, dxc, py - c0p.y));
            touched |= gradient(i, a0, a1, dxa, py - a0.y, ea, j0, v, 0);
            if (two) touched |= gradient(i, c0p, c1p, dxc, py - c0p.y, ec, j1, v, kVals);
          }
          if (__any_sync(0xffffffffu, touched)) {
            reduce_scatter(v, lane);
            if (v[0] != 0.f) atomicAdd(&s_acc[lane < kVals ? j0 : j1][lane % kVals], v[0]);
          }
        }
      }
      __syncthreads();  // the chunk's sums are complete
      for (int idx = tid; idx < nj * kVals; idx += kThreads) {
        const int j = idx / kVals;
        const int a = idx % kVals;
        const float v = s_acc[j][a];
        if (v == 0.f) continue;
        s_acc[j][a] = 0.f;
        if (a < kNParam) {
          atomicAdd(&dprm_v[(long long)s_id[b][j] * 8 + a], v);
        } else if (c0 + a - kNParam < C) {
          atomicAdd(&dcol_v[(long long)s_id[b][j] * C + c0 + a - kNParam], v);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the last chunk's flush is done before the next group stages
  }
}

}  // namespace

// table [views, T, K] int32, counts and swept [views, T] int32 (swept: the
// forward's chunks composited per tile), params [views, G, 8] (16-byte
// aligned) and colors (view v reads slab v / views_per_color; element (g, c)
// at g * color_g_stride + c from the slab's start, slabs color_view_stride
// apart) as the forward took them; gcolor [views, H, W, C], gdepth and
// galpha [views, H, W] fp32 contiguous, the cotangents of the forward's
// outputs. Out, added to (the caller zeroes them): dparams [views, G, 8]
// (the last slot stays 0) and dcolors [slabs, G, C] fp32 contiguous.
extern "C" int siu3r_raster_bwd(
    const int* table, const int* counts, const int* swept, int* order, const float* params,
    const float* colors, const float* gcolor, const float* gdepth, const float* galpha, float* dparams, float* dcolors,
    int n_views, int n_ty, int n_tx, int K, int G, int H, int W, int C,
    int views_per_color, long long color_view_stride, long long color_g_stride,
    cudaStream_t stream) {
  const long long blocks = (long long)n_views * n_ty * n_tx * kSubs;
  if (n_views < 1 || n_ty < 1 || n_tx < 1 || K < 1 || G < 1 || C < 1 || views_per_color < 1 ||
      blocks > 0x7fffffffLL || reinterpret_cast<unsigned long long>(params) % 16)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = n_ty * n_tx;
  const int err = (int)order_tiles(counts, swept, n_views * n_tiles, order, stream);
  if (err) return err;
  if (C <= 4) {
    raster_bwd_kernel<4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        table, counts, swept, order, params, colors, gcolor, gdepth, galpha, dparams, dcolors, n_tiles, n_tx,
        K, G, H, W, C, views_per_color, color_view_stride, color_g_stride);
  } else {
    raster_bwd_kernel<8><<<(unsigned)blocks, kThreads, 0, stream>>>(
        table, counts, swept, order, params, colors, gcolor, gdepth, galpha, dparams, dcolors, n_tiles, n_tx,
        K, G, H, W, C, views_per_color, color_view_stride, color_g_stride);
  }
  return (int)cudaGetLastError();
}

// The launch siu3r_raster_bwd makes for these sizes. out[0..5]: blocks,
// threads a block, blocks a cluster (1: the blocks are independent), blocks
// a 16x128 tile, static shared bytes a block, and the blocks that can be
// resident on one SM at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int siu3r_raster_bwd_launch_config(int n_views, int n_ty, int n_tx, int C, int* out) {
  const long long blocks = (long long)n_views * n_ty * n_tx * kSubs;
  if (n_views < 1 || n_ty < 1 || n_tx < 1 || C < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  int err = C <= 4 ? (int)cudaFuncGetAttributes(&fa, raster_bwd_kernel<4>)
                   : (int)cudaFuncGetAttributes(&fa, raster_bwd_kernel<8>);
  if (err) return err;
  err = C <= 4 ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[5], raster_bwd_kernel<4>, kThreads, 0)
               : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[5], raster_bwd_kernel<8>, kThreads, 0);
  out[0] = (int)blocks;
  out[1] = kThreads;
  out[2] = 1;
  out[3] = kSubs;
  out[4] = (int)fa.sharedSizeBytes;
  return err;
}
