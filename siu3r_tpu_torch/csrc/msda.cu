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
// 2 flops each, and the value tensor (2.1 MB for the adapter, 2.75 MB for
// the pixel decoder at the main path's shapes) is read once: bytes bound it
// at a few microseconds a launch (H100 SXM, 700 W). A gather straight from
// L2 does not get there: each point costs a load of its location, then four
// row loads that depend on it, one point after another.
//
// Design, `msda_kernel<D, NL, NP, STAGED>`:
// - Staged (the main path): one block of 16 warps per (batch, head, chunk of
//   queries). At entry the block copies that head's value slice [len_in, D]
//   (rows H*D*4 bytes apart) into shared memory with 16-byte cp.async
//   copies, so every tap afterwards is a shared-memory read. The chunks are
//   as many as the card holds blocks at once (occupancy query: one wave);
//   each chunk stages the slice again, from L2.
// - Per warp step, a lane per (query, point): the lanes load their points'
//   locations and weights in one coalesced load (issued a step ahead, the
//   first one while the slice is copied), compute each point's row and
//   column weights (0 where its taps fall outside the level) and its
//   top-left row, and put them in the warp's tap buffer (16 bytes a
//   point); an out-of-level tap
//   reads a row clamped into the slice with weight 0: no branch. Each
//   half-warp then spans the
//   channels (a float2 a lane at D = 32, a float4 at D = 64) and sums every
//   other point of the step's queries, a point's taps one broadcast read for
//   its 16 lanes; a shuffle adds the two halves. Shared-memory wavefronts
//   bound this loop: the value rows' bytes, plus the tap reads. With
//   (L, P) fixed at compile time, (1, 4) and (3, 4) on the main path, a step
//   covers 32 / (L*P) queries and every loop unrolls; the generic
//   instantiation takes one query a step and its points 32 at a time.
// - Global (a slice too large for shared memory): the same steps, with the
//   taps read from global memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// one (query, point) item's taps in 16 bytes, one shared-memory read: the
// rows' bilinear weights with the attention weight in them, each 0 where its
// taps fall outside the level; the column weight wx; the top-left tap's row
// in the head's slice, which of the two columns lie inside the level and
// the level. Tap (dy, dx) weighs ay[dy] * bx[dx], bx = (1 - wx, wx) where
// inside, else 0.
struct alignas(16) Taps {
  float ay0, ay1, wx;
  int code;  // r00 << 5 | inside(x0 + 1) << 4 | inside(x0) << 3 | level
};

constexpr size_t kTapBytes = (size_t)kWarps * 32 * sizeof(Taps);

__device__ __forceinline__ Taps point_taps(float x, float y, float a, int l, int hh, int ww, int start) {
  // rounded multiply then subtract (no fused multiply-add), as the plain
  // version computes it, so floor() sees the same value; clamping far-away
  // points keeps the int conversion defined, and all their taps stay outside
  // the level either way
  const float gx = fminf(fmaxf(__fsub_rn(__fmul_rn(x, (float)ww), 0.5f), -2.f), (float)ww + 1.f);
  const float gy = fminf(fmaxf(__fsub_rn(__fmul_rn(y, (float)hh), 0.5f), -2.f), (float)hh + 1.f);
  const float x0f = floorf(gx);
  const float y0f = floorf(gy);
  const float wx = gx - x0f;
  const float wy = gy - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  Taps t;
  // a * (1 - wy) * (1 - wx) and so on, in the plain version's order
  t.ay0 = y0 >= 0 && y0 < hh ? a * (1.f - wy) : 0.f;
  t.ay1 = y0 + 1 >= 0 && y0 + 1 < hh ? a * wy : 0.f;
  t.wx = wx;
  t.code = (int)((unsigned)(start + y0 * ww + x0) << 5) | (x0 + 1 >= 0 && x0 + 1 < ww) << 4 |
           (x0 >= 0 && x0 < ww) << 3 | l;
  return t;
}

template <int C>
__device__ __forceinline__ void add_row(float (&acc)[C], const float* row, float w, bool shared) {
  if (C == 4) {
    const float4 v = shared ? *reinterpret_cast<const float4*>(row) : __ldg(reinterpret_cast<const float4*>(row));
    acc[0] += w * v.x;
    acc[1 % C] += w * v.y;
    acc[2 % C] += w * v.z;
    acc[3 % C] += w * v.w;
  } else {
    const float2 v = shared ? *reinterpret_cast<const float2*>(row) : __ldg(reinterpret_cast<const float2*>(row));
    acc[0] += w * v.x;
    acc[1 % C] += w * v.y;
  }
}

// a point's item: its location, attention weight and level, or none
struct Item {
  float2 xy;
  float a;
  int l;
  bool live;
};

template <int NL>
__device__ __forceinline__ int level_field(const int (&f)[kMaxLevels], int l) {
  // a constant-index select, so that the levels stay in the parameter bank
  // (a dynamic index would copy them to local memory)
  int v = f[0];
#pragma unroll
  for (int k = 1; k < (NL > 0 ? NL : kMaxLevels); ++k) v = l == k ? f[k] : v;
  return v;
}

// NL, NP > 0: L and P fixed, L*P <= 32, a warp step takes 32 / (L*P)
// queries; NL = NP = 0: L and P from the arguments, one query a step.
template <int D, int NL, int NP, bool STAGED>
__global__ void __launch_bounds__(kThreads) msda_kernel(
    const float* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ aw, float* __restrict__ out, const Levels lv,
    int len_in, int Lq, int H, int P, int q_per_block) {
  constexpr bool kFixed = NL > 0;
  constexpr int C = D / 16;                        // channels a lane: a half-warp spans D
  constexpr int PPB = kFixed ? NL * NP : 32;       // points a batch
  constexpr int QB = kFixed ? 32 / (NL * NP) : 1;  // queries a warp step
  static_assert(!kFixed || NL * NP <= 32, "a fixed step holds at most 32 points");
  static_assert(PPB % 2 == 0, "the two half-warps take a query's points in turn");
  static_assert(!kFixed || NP % 2 == 0, "a point and the next are on one level");
  extern __shared__ __align__(16) unsigned char smem[];
  Taps* taps = reinterpret_cast<Taps*>(smem);               // [kWarps][32]
  float* slice = reinterpret_cast<float*>(smem + kTapBytes);  // [len_in][D], staged only

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = lane >> 4;
  const long long row_stride = (long long)H * D;
  const float* vhead = value + (long long)b * len_in * row_stride + (long long)h * D;

  if (STAGED) {
    constexpr int kPieces = D / 4;  // 16-byte pieces a row
    const int pieces = len_in * kPieces;
    for (int i = threadIdx.x; i < pieces; i += kThreads) {
      const int r = i / kPieces;
      const int c = i % kPieces;
      const size_t src = __cvta_generic_to_global(vhead + r * row_stride + c * 4);
      const uint32_t dst = (uint32_t)__cvta_generic_to_shared(slice + r * D + c * 4);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
    }
  }
  const float* vrows = STAGED ? slice + (lane & 15) * C : vhead + (lane & 15) * C;
  const long long vstride = STAGED ? D : row_stride;

  const int n_p = kFixed ? NP : P;
  const int npts = kFixed ? NL * NP : lv.n * P;
  const int n_batches = kFixed ? 1 : (npts + 31) / 32;
  const int q_end = min(((int)blockIdx.x + 1) * q_per_block, Lq);
  Taps* wt = taps + warp * 32;
  const int qi = lane / PPB;  // this lane's item in the coordinate phase
  const int pj = lane % PPB;

  // the lane's item at (step qs, batch), loaded one step ahead of its use
  auto load = [&](int qs, int batch) {
    Item it{make_float2(0.f, 0.f), 0.f, 0, false};
    const int pt = batch * 32 + pj;
    const int q = qs + qi;
    if (qi < QB && q < q_end && pt < npts) {
      const long long item = (((long long)b * Lq + q) * H + h) * npts + pt;
      it.xy = *reinterpret_cast<const float2*>(loc + 2 * item);
      it.a = aw[item];
      it.l = pt / n_p;
      it.live = true;
    }
    return it;
  };
  int qs = (int)blockIdx.x * q_per_block + warp * QB;
  int batch = 0;
  Item cur = load(qs, 0);
  if (STAGED) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  float acc[QB][C];
  while (qs < q_end) {
    Taps t = {0.f, 0.f, 0.f, 0};
    if (cur.live)
      t = point_taps(cur.xy.x, cur.xy.y, cur.a, cur.l, level_field<NL>(lv.h, cur.l), level_field<NL>(lv.w, cur.l),
                     level_field<NL>(lv.start, cur.l));
    const int next_batch = batch + 1 < n_batches ? batch + 1 : 0;
    const int next_qs = next_batch ? qs : qs + kWarps * QB;
    cur = load(next_qs, next_batch);
    if (batch == 0) {
#pragma unroll
      for (int i = 0; i < QB; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
    }
    wt[lane] = t;
    __syncwarp();
    // each half-warp takes every other point of the step's queries: one
    // read of a point's taps (a broadcast to its 16 lanes) serves D channels
#pragma unroll
    for (int i = 0; i < QB; ++i) {
#pragma unroll
      for (int j = 0; j < PPB; j += 2) {
        const float4 tp = *reinterpret_cast<const float4*>(wt + i * PPB + j + half);
        const int code = __float_as_int(tp.w);
        const float bx0 = code & 8 ? 1.f - tp.z : 0.f;
        const float bx1 = code & 16 ? tp.z : 0.f;
        // the level's width: fixed by the point's place in the step (a
        // point and the next share their level), else from the record
        const int ww = kFixed ? lv.w[j / (kFixed ? NP : 1)] : level_field<NL>(lv.w, code & 7);
        const int r00 = code >> 5;
        // rows of taps outside the level (weight 0) are clamped into the slice
        const int r0 = min(max(r00, 0), len_in - 1);
        const int r1 = min(max(r00 + 1, 0), len_in - 1);
        const int r2 = min(max(r00 + ww, 0), len_in - 1);
        const int r3 = min(max(r00 + ww + 1, 0), len_in - 1);
        add_row<C>(acc[i], vrows + r0 * vstride, tp.x * bx0, STAGED);
        add_row<C>(acc[i], vrows + r1 * vstride, tp.x * bx1, STAGED);
        add_row<C>(acc[i], vrows + r2 * vstride, tp.y * bx0, STAGED);
        add_row<C>(acc[i], vrows + r3 * vstride, tp.y * bx1, STAGED);
      }
    }
    __syncwarp();  // the buffer is rewritten by the next batch or step
    if (batch == n_batches - 1) {
#pragma unroll
      for (int i = 0; i < QB; ++i) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], 16);
        const int q = qs + i;
        if (q < q_end && half == 0) {
          float* o = out + ((long long)b * Lq + q) * row_stride + h * D + lane * C;
          if (C == 4) {
            *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1 % C], acc[i][2 % C], acc[i][3 % C]);
          } else {
            *reinterpret_cast<float2*>(o) = make_float2(acc[i][0], acc[i][1 % C]);
          }
        }
      }
    }
    qs = next_qs;
    batch = next_batch;
  }
}

int max_optin_smem() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cached[dev]) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
    cached[dev] = v;
  }
  return cached[dev];
}

int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return v;
}

template <int D, int NL, int NP, bool STAGED>
int launch(const float* value, const float* loc, const float* aw, float* out, const Levels& lv,
           int B, int len_in, int Lq, int H, int P, cudaStream_t stream) {
  constexpr int QB = NL > 0 ? 32 / (NL * NP) : 1;
  auto kernel = msda_kernel<D, NL, NP, STAGED>;
  const size_t smem = kTapBytes + (STAGED ? (size_t)len_in * D * sizeof(float) : 0);
  static bool opted_in = false;  // one instantiation, one attribute
  if (!opted_in) {
    const int optin = max_optin_smem();
    if (optin < (int)smem) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int steps = (Lq + QB - 1) / QB;  // warp steps over all queries of a (batch, head)
  int chunks;
  if (STAGED) {
    // as many (batch, head, chunk) blocks as fit the card at once (one
    // wave), so that every SM holds as many; at most a step a query chunk
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long slots = (long long)sm_count() * per_sm;
    const long long bh = (long long)B * H;
    chunks = (int)std::max(1LL, std::min<long long>(slots / bh, steps));
  } else {
    chunks = (steps + kWarps - 1) / kWarps;  // a step a warp
  }
  const int steps_per_block = (steps + chunks - 1) / chunks;
  const int q_per_block = steps_per_block * QB;
  chunks = (Lq + q_per_block - 1) / q_per_block;
  const dim3 grid(chunks, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(value, loc, aw, out, lv, len_in, Lq, H, P, q_per_block);
  return (int)cudaGetLastError();
}

template <int D, bool STAGED>
int dispatch(const float* value, const float* loc, const float* aw, float* out, const Levels& lv,
             int B, int len_in, int Lq, int H, int P, cudaStream_t stream) {
  if (lv.n == 1 && P == 4) return launch<D, 1, 4, STAGED>(value, loc, aw, out, lv, B, len_in, Lq, H, P, stream);
  if (lv.n == 3 && P == 4) return launch<D, 3, 4, STAGED>(value, loc, aw, out, lv, B, len_in, Lq, H, P, stream);
  return launch<D, 0, 0, STAGED>(value, loc, aw, out, lv, B, len_in, Lq, H, P, stream);
}

}  // namespace

// value [B, len_in, H, D], loc [B, Lq, H, L, P, 2], aw [B, Lq, H, L, P],
// out [B, Lq, H*D]: contiguous fp32, value on 16 bytes and loc on 8. level_hw holds (h, w) per level and
// level_start the first row of each level, both host arrays of n_levels.
// *variant is set to 1 where the staged kernel launched, 2 where the global
// one did.
extern "C" int siu3r_msda_fwd(
    const float* value, const float* loc, const float* aw, float* out,
    const int* level_hw, const int* level_start, int n_levels,
    int B, int len_in, int Lq, int H, int D, int P, int* variant, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || B < 1 || Lq < 1 || H < 1 || P < 1 || len_in < 1 ||
      B > 65535 || H > 65535 || (D != 32 && D != 64))
    return (int)cudaErrorInvalidValue;
  Levels lv{};
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    lv.start[l] = level_start[l];
  }
  const size_t staged_smem = kTapBytes + (size_t)len_in * D * sizeof(float);
  const bool staged = staged_smem <= (size_t)max_optin_smem();
  *variant = staged ? 1 : 2;
  if (D == 64) {
    return staged ? dispatch<64, true>(value, loc, aw, out, lv, B, len_in, Lq, H, P, stream)
                  : dispatch<64, false>(value, loc, aw, out, lv, B, len_in, Lq, H, P, stream);
  }
  return staged ? dispatch<32, true>(value, loc, aw, out, lv, B, len_in, Lq, H, P, stream)
                : dispatch<32, false>(value, loc, aw, out, lv, B, len_in, Lq, H, P, stream);
}
