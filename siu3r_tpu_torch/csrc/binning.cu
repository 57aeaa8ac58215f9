// Per-tile gaussian lists for the splat rasterizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bin_kernel` (siu3r_tpu/render/rasterizer.py:189).
// Its function: for each 16x128 tile of each view, the first K alive
// gaussians, in stable depth order, whose slot-clamped 3-sigma tile range
// covers the tile (table [views, T, K] of gaussian ids, counts [views, T]).
// As on the TPU, the stable depth sort runs outside the kernels (one
// torch.sort in the wrapper, as the JAX package's jax.lax.sort); the tile
// ranges are computed here.
//
// What bounds it on the card: it reads each gaussian's mean, radius and
// depth-order index once and writes K ids per tile; the work is one box a
// gaussian and one rank per (gaussian, covered tile) pair, at most
// slots_y * slots_x of them. Bytes bound it, at a few microseconds for six
// views of 131,072 gaussians (H100 SXM, 700 W).
//
// Design: the work spreads over (view, chunk of 1024 gaussians in depth
// order), so that each gaussian visits only the tiles it covers.
// 1. bin_prep_kernel, a thread a gaussian in submission order (coalesced
//    reads): the tile box in the plain version's fp32 arithmetic (no FMA),
//    packed into one 32-bit code (8 bits each of y0, y1, x0, x1; dead
//    gaussians get the empty box y0 = 1 > y1 = 0).
// 2. bin_count_kernel, grid (chunk, view), a warp a run of 128 gaussians of
//    the chunk: gathers the codes through the depth permutation (4 bytes a
//    gaussian), writes codes and ids in depth order, and counts each tile's
//    members per warp and per chunk: hist_warp [views, chunks, 8, T] and
//    hist_chunk [views, chunks, T].
// 3. bin_write_kernel, grid (chunk, view): sums the chunks before it into
//    its base in each tile's list (the scan over chunks, a few KB a block)
//    and each tile's total, writes the counts min(total, K) (chunk 0),
//    zero-fills its share of the view's tiles past their counts, and exits
//    unless some tile it covers has its base below K. Otherwise each warp
//    walks its 128 gaussians in depth order, 32 at a time, from its base (the
//    chunk's, plus the earlier warps' counts): a member's rank in a tile is
//    the warp's run so far plus its lower lanes' members, and it writes its
//    id there while that is below K.
// A warp finds every tile's members among its lanes from the lane masks of
// the tile rows and columns (a lane covers a tile iff its box spans the
// tile's row and column): a 32 x 32 bit transpose where rows and columns
// number at most 32, else n_ty + n_tx ballots. No atomics, and no block
// barrier inside the walks. Each thread loads its 4 gaussians at once, so
// that the loads' latency is paid once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;               // gaussians a block, in depth order
constexpr int kSteps = kChunk / kThreads;  // 32-gaussian steps a warp
// shared memory of the write kernel: 10 ints a tile and 8 a tile row or
// column; at most 4096 tiles and 512 rows and columns
constexpr int kMaxTiles = 4096;
constexpr int kMaxSmem = (10 * kMaxTiles + kWarps * 512) * 4;
constexpr unsigned kEmpty = 1u;  // y0 = 1 > y1 = 0, x0 = x1 = 0

int n_chunks(int G) { return G > 0 ? (G + kChunk - 1) / kChunk : 1; }

__device__ __forceinline__ int tile_of(float x, float inv_size, int n) {
  // torch.floor(x / size).clamp(0, n - 1).to(int32) in IEEE fp32: size is a
  // power of two, so x * (1 / size) is x / size exactly
  const float f = floorf(__fmul_rn(x, inv_size));
  return (int)fminf(fmaxf(f, 0.f), (float)(n - 1));
}

struct Box {
  int y0, y1, x0, x1;
};

__device__ __forceinline__ Box unpack(unsigned code) {
  return {(int)(code & 255u), (int)(code >> 8 & 255u), (int)(code >> 16 & 255u), (int)(code >> 24)};
}

// rc[0, n_ty): for each tile row, the warp's lanes whose box spans it;
// rc[n_ty, n_ty + n_tx): the same for the tile columns. A lane's box covers
// tile (ty, tx) iff its bit is in rc[ty] & rc[n_ty + tx].
__device__ __forceinline__ void warp_masks(const Box& bx, unsigned* rc, int n_ty, int n_tx, int lane) {
  if (n_ty + n_tx <= 32) {
    // each lane's rows and columns as the bits of one word, then a 32 x 32
    // bit transpose across the warp (five shuffles): lane r gets rc[r]
    unsigned x = 0u;
    if (bx.y0 <= bx.y1) x = ((2u << bx.y1) - (1u << bx.y0)) | ((2u << bx.x1) - (1u << bx.x0)) << n_ty;
    unsigned m = 0x0000FFFFu;
#pragma unroll
    for (int j = 16; j > 0; j >>= 1, m ^= m << j) {
      const unsigned y = __shfl_xor_sync(0xffffffffu, x, j);
      x = lane & j ? ((y >> j) & m) | (x & ~m) : (x & m) | ((y & m) << j);
    }
    if (lane < n_ty + n_tx) rc[lane] = x;
    return;
  }
  for (int base = 0; base < n_ty + n_tx; base += 32) {
    const int lim = min(32, n_ty + n_tx - base);
    unsigned mine = 0u;
    for (int j = 0; j < lim; ++j) {
      const int r = base + j;
      const bool in = r < n_ty ? bx.y0 <= r && r <= bx.y1 : bx.x0 <= r - n_ty && r - n_ty <= bx.x1;
      const unsigned b = __ballot_sync(0xffffffffu, in);
      if (lane == j) mine = b;
    }
    if (lane < lim) rc[base + lane] = mine;
  }
}

__global__ void __launch_bounds__(kThreads) bin_prep_kernel(
    const float2* __restrict__ mean2d, const float* __restrict__ radius, unsigned* __restrict__ codes,
    long long n, int n_ty, int n_tx, float inv_tile_h, float inv_tile_w, int slots_y, int slots_x) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float r = radius[i];
  unsigned code = kEmpty;
  if (r > 0.f) {
    const float2 uv = mean2d[i];
    const int x0 = tile_of(__fsub_rn(uv.x, r), inv_tile_w, n_tx);
    const int x1 = min(tile_of(__fadd_rn(uv.x, r), inv_tile_w, n_tx), x0 + slots_x - 1);
    const int y0 = tile_of(__fsub_rn(uv.y, r), inv_tile_h, n_ty);
    const int y1 = min(tile_of(__fadd_rn(uv.y, r), inv_tile_h, n_ty), y0 + slots_y - 1);
    code = (unsigned)y0 | (unsigned)y1 << 8 | (unsigned)x0 << 16 | (unsigned)x1 << 24;
  }
  codes[i] = code;
}

__global__ void __launch_bounds__(kThreads) bin_count_kernel(
    const unsigned* __restrict__ codes_in, const long long* __restrict__ order, unsigned* __restrict__ codes,
    int* __restrict__ ids, int* __restrict__ hist_warp, int* __restrict__ hist_chunk, int G, int n_ty, int n_tx) {
  extern __shared__ int smem[];
  const int T = n_ty * n_tx;
  const int R = n_ty + n_tx;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* wh = smem + warp * T;                                                 // [kWarps][T]
  unsigned* rc = reinterpret_cast<unsigned*>(smem + kWarps * T) + warp * R;  // [kWarps][R]
  const unsigned below = (1u << lane) - 1u;
  const int view = blockIdx.y;
  const int chunk = blockIdx.x;
  for (int t = lane; t < T; t += 32) wh[t] = 0;
  const long long vg = (long long)view * G;
  const int first = chunk * kChunk + warp * (kChunk / kWarps);
  // the warp's gaussians in depth order, then their codes: all loads in flight at once
  long long g[kSteps];
  unsigned code[kSteps];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int i = first + j * 32 + lane;
    g[j] = i < G ? order[vg + i] : -1;
  }
#pragma unroll
  for (int j = 0; j < kSteps; ++j) code[j] = g[j] >= 0 ? codes_in[vg + g[j]] : kEmpty;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    if (g[j] >= 0) {
      codes[vg + first + j * 32 + lane] = code[j];
      ids[vg + first + j * 32 + lane] = (int)g[j];
    }
    const Box bx = unpack(code[j]);
    warp_masks(bx, rc, n_ty, n_tx, lane);
    __syncwarp();
    // the warp's first member of a tile adds the warp's members
    for (int ty = bx.y0; ty <= bx.y1; ++ty)
      for (int tx = bx.x0; tx <= bx.x1; ++tx) {
        const unsigned m = rc[ty] & rc[n_ty + tx];
        if ((m & below) == 0u) wh[ty * n_tx + tx] += __popc(m);
      }
    __syncwarp();
  }
  __syncthreads();
  int* hw = hist_warp + ((long long)view * gridDim.x + chunk) * kWarps * T;
  int* hc = hist_chunk + ((long long)view * gridDim.x + chunk) * T;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) {
      hw[w * T + t] = smem[w * T + t];
      sum += smem[w * T + t];
    }
    hc[t] = sum;
  }
}

__global__ void __launch_bounds__(kThreads) bin_write_kernel(
    const unsigned* __restrict__ codes, const int* __restrict__ ids, const int* __restrict__ hist_warp,
    const int* __restrict__ hist_chunk, int* __restrict__ table, int* __restrict__ counts, int G, int n_ty,
    int n_tx, int K) {
  extern __shared__ int smem[];
  const int T = n_ty * n_tx;
  const int R = n_ty + n_tx;
  int* base = smem;                                                      // [T]: the chunk's base
  int* total = smem + T;                                                 // [T]: the tile's members
  int* run = smem + 2 * T;                                               // [kWarps][T]: a warp's run
  unsigned* rcs = reinterpret_cast<unsigned*>(smem + (2 + kWarps) * T);  // [kWarps][R]
  __shared__ int open;
  const int view = blockIdx.y;
  const int chunk = blockIdx.x;
  const int chunks = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int* vhist = hist_chunk + (long long)view * chunks * T;
  const int* whist = hist_warp + ((long long)view * chunks + chunk) * kWarps * T;
  int* vtable = table + (long long)view * T * K;

  if (tid == 0) open = 0;
  for (int t = tid; t < T; t += kThreads) base[t] = total[t] = 0;
  __syncthreads();
  // the chunk's base in each tile's list (the chunks before it) and the
  // tile's total: the histograms, a warp a stride of chunks, a lane a tile
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    if (t >= T) break;
    int before = 0, all = 0;
    for (int c = warp; c < chunks; c += kWarps) {
      const int v = vhist[(long long)c * T + t];
      all += v;
      before += c < chunk ? v : 0;
    }
    atomicAdd(&base[t], before);
    atomicAdd(&total[t], all);
  }
  __syncthreads();
  for (int t = tid; t < T; t += kThreads) {
    if (chunk == 0) counts[(long long)view * T + t] = min(total[t], K);
    if (vhist[(long long)chunk * T + t] > 0 && base[t] < K) open = 1;
    int acc = base[t];  // each warp's base: the chunk's, then the earlier warps' members
    for (int w = 0; w < kWarps; ++w) {
      run[w * T + t] = acc;
      acc += whist[w * T + t];
    }
  }
  // this block's share of the view's tiles: zero past each one's count
  for (int t = chunk; t < T; t += chunks) {
    int* row = vtable + (long long)t * K;
    for (int k = min(total[t], K) + tid; k < K; k += kThreads) row[k] = 0;
  }
  __syncthreads();
  if (!open) return;  // every tile this chunk covers is full already

  // the warp's gaussians, all loads in flight at once, then 32 at a time
  const long long vg = (long long)view * G;
  const int first = chunk * kChunk + warp * (kChunk / kWarps);
  unsigned code[kSteps];
  int id[kSteps];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int i = first + j * 32 + lane;
    code[j] = i < G ? codes[vg + i] : kEmpty;
    id[j] = i < G ? ids[vg + i] : 0;
  }
  int* wrun = run + warp * T;
  unsigned* rc = rcs + warp * R;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const Box bx = unpack(code[j]);
    warp_masks(bx, rc, n_ty, n_tx, lane);
    __syncwarp();
    // rank: the warp's run and its lower lanes' members
    for (int ty = bx.y0; ty <= bx.y1; ++ty)
      for (int tx = bx.x0; tx <= bx.x1; ++tx) {
        const int t = ty * n_tx + tx;
        const int rank = wrun[t] + __popc(rc[ty] & rc[n_ty + tx] & below);
        if (rank < K) vtable[(long long)t * K + rank] = id[j];
      }
    __syncwarp();
    // the tile's first member moves the warp's run on
    for (int ty = bx.y0; ty <= bx.y1; ++ty)
      for (int tx = bx.x0; tx <= bx.x1; ++tx) {
        const unsigned m = rc[ty] & rc[n_ty + tx];
        if ((m & below) == 0u) wrun[ty * n_tx + tx] += __popc(m);
      }
    __syncwarp();
  }
}

}  // namespace

// int32 scratch entries siu3r_bin_gaussians needs: codes in submission and in
// depth order and ids [views, G]; hist_warp [views, chunks, 8, T] and
// hist_chunk [views, chunks, T].
extern "C" int siu3r_bin_scratch_ints(int n_views, int G, int n_ty, int n_tx) {
  const long long n = 3LL * n_views * G + (long long)n_views * n_chunks(G) * (kWarps + 1) * n_ty * n_tx;
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// mean2d [views, G, 2] and radius [views, G] fp32, order [views, G] int64
// (the stable depth order of each view), scratch of siu3r_bin_scratch_ints
// int32 entries; table [views, n_ty * n_tx, K] and counts [views, n_ty *
// n_tx] int32 out. All contiguous. tile_h and tile_w are powers of two.
extern "C" int siu3r_bin_gaussians(
    const void* mean2d, const float* radius, const long long* order, int* scratch, int* table, int* counts,
    int n_views, int G, int n_ty, int n_tx, int tile_h, int tile_w, int slots_y, int slots_x, int K,
    cudaStream_t stream) {
  const int T = n_ty * n_tx;
  const int chunks = n_chunks(G);
  if (n_views < 1 || n_views > 65535 || G < 0 || n_ty < 1 || n_tx < 1 || n_ty > 256 || n_tx > 256 ||
      T > kMaxTiles || K < 1 || slots_y < 1 || slots_x < 1 || tile_h < 1 || (tile_h & (tile_h - 1)) ||
      tile_w < 1 || (tile_w & (tile_w - 1)) || siu3r_bin_scratch_ints(n_views, G, n_ty, n_tx) < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)n_views * G;
  unsigned* codes_in = reinterpret_cast<unsigned*>(scratch);
  unsigned* codes = codes_in + n;
  int* ids = scratch + 2 * n;
  int* hist_warp = scratch + 3 * n;
  int* hist_chunk = hist_warp + (long long)n_views * chunks * kWarps * T;
  const size_t count_smem = (size_t)kWarps * (T + n_ty + n_tx) * sizeof(int);
  const size_t write_smem = ((size_t)(2 + kWarps) * T + (size_t)kWarps * (n_ty + n_tx)) * sizeof(int);
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(bin_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(bin_write_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  if (n > 0) {
    bin_prep_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        static_cast<const float2*>(mean2d), radius, codes_in, n, n_ty, n_tx, 1.f / (float)tile_h,
        1.f / (float)tile_w, slots_y, slots_x);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(chunks, n_views);
  bin_count_kernel<<<grid, kThreads, count_smem, stream>>>(codes_in, order, codes, ids, hist_warp, hist_chunk,
                                                           G, n_ty, n_tx);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bin_write_kernel<<<grid, kThreads, write_smem, stream>>>(codes, ids, hist_warp, hist_chunk, table, counts, G,
                                                           n_ty, n_tx, K);
  return (int)cudaGetLastError();
}
