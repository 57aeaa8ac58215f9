// Per-tile gaussian lists for the splat rasterizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bin_kernel` (siu3r_tpu/render/rasterizer.py:189).
// Its function: for each 16x128 tile of each view, the first K alive
// gaussians, in stable depth order, whose slot-clamped 3-sigma tile range
// covers the tile (table [views, T, K] of gaussian ids, counts [views, T]).
// As on the TPU, the tile ranges are computed and the payloads stably sorted
// by depth outside the kernel (in torch, by the wrapper); dead gaussians come
// in with the empty range y0 = 1 > y1 = 0. This kernel does the per-tile
// compaction.
//
// What bounds it on the card: it reads each view's depth-ordered ranges and
// ids (20 bytes a gaussian, 2.6 MB a view at G = 131072) once per tile, and
// writes K ids per tile; the work is a few integer compares per (gaussian,
// tile). The reads come from L2 (the six views' arrays, 16 MB, fit the
// 50 MB L2 of an H100), so it is bound by bytes, and by how soon a tile can
// stop: a block stops sweeping once its list holds K ids.
//
// Design: one block of 256 threads per (view, tile), all views in one
// launch. The block sweeps the depth-ordered arrays in steps of 1024
// gaussians (4 per thread, each a 16-byte load of the range); a warp ballot
// and popcount rank the members inside each warp, and one warp scans the 32
// (item, warp) totals of the step, so each member gets its exact rank in
// depth order and writes its id at base + rank while that is below K.
// Entries past the count are zero-filled, so a later gather stays in range.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;  // gaussians per thread per step
constexpr int kStep = kThreads * kItems;
static_assert(kItems * kWarps == 32, "one warp scans the step's totals");

__global__ void __launch_bounds__(kThreads) bin_kernel(
    const int4* __restrict__ ranges, const int* __restrict__ ids,
    int* __restrict__ table, int* __restrict__ counts,
    int G, int n_tiles, int n_tx, int K) {
  __shared__ int s_cnt[32];
  __shared__ int s_pre[33];
  const int view = blockIdx.x / n_tiles;
  const int tile = blockIdx.x % n_tiles;
  const int ty = tile / n_tx;
  const int tx = tile % n_tx;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int4* rv = ranges + (long long)view * G;
  const int* iv = ids + (long long)view * G;
  int* out = table + (long long)blockIdx.x * K;

  int base = 0;  // members found so far; the same in every thread
  for (long long start = 0; start < G && base < K; start += kStep) {
    unsigned ballot[kItems];
    bool member[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = start + j * kThreads + tid;
      member[j] = false;
      if (i < G) {
        const int4 r = rv[i];  // (y0, y1, x0, x1)
        member[j] = r.x <= ty && ty <= r.y && r.z <= tx && tx <= r.w;
      }
      ballot[j] = __ballot_sync(0xffffffffu, member[j]);
      if (lane == 0) s_cnt[j * kWarps + warp] = __popc(ballot[j]);
    }
    __syncthreads();
    if (warp == 0) {
      // inclusive scan of the 32 totals in (item, warp) order = depth order
      const int v = s_cnt[lane];
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      s_pre[lane] = incl - v;
      if (lane == 31) s_pre[32] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (member[j]) {
        const int rank = base + s_pre[j * kWarps + warp] + __popc(ballot[j] & lanes_below);
        if (rank < K) out[rank] = iv[start + j * kThreads + tid];
      }
    }
    base += s_pre[32];
    __syncthreads();  // s_cnt and s_pre are rewritten by the next step
  }
  const int count = base < K ? base : K;
  for (int k = count + tid; k < K; k += kThreads) out[k] = 0;
  if (tid == 0) counts[blockIdx.x] = count;
}

}  // namespace

// ranges [views, G] int4 (y0, y1, x0, x1) and ids [views, G] int32, both in
// stable depth order per view; table [views, n_ty * n_tx, K] and counts
// [views, n_ty * n_tx] int32 out. All contiguous.
extern "C" int siu3r_bin_gaussians(
    const void* ranges, const int* ids, int* table, int* counts,
    int n_views, int G, int n_ty, int n_tx, int K, cudaStream_t stream) {
  const long long blocks = (long long)n_views * n_ty * n_tx;
  if (n_views < 1 || G < 0 || n_ty < 1 || n_tx < 1 || K < 1 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  bin_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const int4*>(ranges), ids, table, counts, G, n_ty * n_tx, n_tx, K);
  return (int)cudaGetLastError();
}
