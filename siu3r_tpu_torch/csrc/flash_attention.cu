// Fused attention forward for Hopper (sm_90a): softmax(rot(q) rot(k)^T * scale) v
// with an optional RoPE2D rotation of q and k and an optional per-batch key mask.
//
// Replaces the TPU kernels `_attn_rope_kernel` (siu3r_tpu/ops/flash_attention.py:67)
// and `_attn_kernel` (siu3r_tpu/ops/flash_attention.py:33); the RoPE switch, the
// head dim (32 or 64) and the block's layout are template parameters of one
// kernel.
//
// What bounds it on the card: at the main path's shapes (N = 257 or 100 tokens,
// D = 64 or 32, fp32) the work is 4*N*N*D flops per (batch, head) over only
// 4*N*D*4 bytes of input and output, so the bound is arithmetic. Both products
// run on the tensor cores as `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`
// in 3xTF32: each fp32 operand x is split into big = tf32(x), rounded to
// nearest by `cvt.rna.tf32.f32`, and small = x - big, which the tensor core
// reads truncated to tf32 (2^-21 of x at most); a*b is taken as
// a_small*b_big + a_big*b_small + a_big*b_big into an fp32 accumulator, the
// small cross terms first, as CUTLASS's OpMultiplyAddFastF32 does. That keeps
// fp32-level accuracy (plain TF32, one product, misses the 2e-5 gate by 30x)
// at three tensor-core products per fp32 product: the bound is 4*N*N*D flops
// at 495 / 3 TFLOP/s (H100 SXM dense TF32 at 700 W), not at the 67 TFLOP/s of
// the fp32 FMA units. mma.sync and not wgmma: a warp owns 16 query rows and
// their softmax state, so the scores go from the first product's accumulators
// to the second product's A operand without leaving registers, and a
// 257-token sequence wastes 15 rows and not 63.
//
// Design. 128 threads a block: 4 row groups of 16 query rows, one warp each,
// when the launch has at least one such block per SM; else 2 row groups of
// 2 warps, which split every key tile's column tiles between them, each with
// its own softmax state, merged through shared memory at the end (the 12-
// and 8-head calls put twice the warps to work). q is loaded once into
// registers in the A-fragment layout, rotated there (RoPE2D pairs quarter i
// with quarter i^1, a multiple of 8 columns away, so a lane holds both
// halves of every pair), scaled by scale * log2(e) and split. The k index of
// both operands of q k^T runs over columns 2t, 2t + 1 (t, t + 4 of the
// fragment), the same permutation on both sides, so a K fragment is one
// 8-byte load. K and V stream through shared memory in 64-key tiles, two
// stages, filled by 16-byte `cp.async.cg` copies (rows past Nk zero-filled);
// the tile after the current one is in flight while the current one is
// multiplied. With RoPE the cos/sin rows of the tile come the same way (one
// stage: the next tile's are requested once this one is rotated), and K is
// rotated in shared memory, four pairs a thread and step, once its tile has
// landed. K rows are padded to D + 8 floats and V rows to D + 4: the K
// fragment loads (key g, columns 2t and 2t + 1) and the V fragment loads
// (key 2t, column g) then hit distinct banks. K and V are split as each
// fragment is loaded. Each of the three products runs over all of a
// warp's column tiles before the next, so updates of one accumulator are
// independent products apart; a tile's live column tiles are rounded up to
// 1, 2, 4 or 8, each a branch-free body.
// The softmax is online, once per key tile: a row's scores sit on the four
// lanes of a quad, so its max takes two quad shuffles; exp2f on the
// pre-scaled scores; each lane keeps its own share of the row sum, added
// across the quad once at the end. The score accumulator's layout (columns
// 2t, 2t+1) is used as the A operand of P.V as it stands, with the key order
// permuted to match: A column t is key 2t and column t+4 is key 2t+1, and the
// V fragment reads the same keys. Keys past Nk take no part (-inf); keys with
// kv_mask == 0 get the logit -1e30 as in the plain version, so a row whose
// keys are all masked averages v uniformly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;  // keys per shared-memory tile
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct AttnParams {
  const float* q;
  const float* k;
  const float* v;
  const float* qcos;
  const float* qsin;
  const float* kcos;
  const float* ksin;
  const unsigned char* kv_mask;
  float* out;
  int B, H, Nq, Nk;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  float scale;
};

// Shared memory, in floats: [2 stages][K [kBK][D + 8], V [kBK][D + 4]];
// with RoPE the tile's cos then sin rows [kBK][D]; then one byte a key and
// stage, 1 where kv_mask masks the key.
template <int D, bool ROPE>
struct Smem {
  static constexpr int kKStride = D + 8;
  static constexpr int kVStride = D + 4;
  static constexpr int kStage = kBK * (kKStride + kVStride);
  static constexpr int kKV = 2 * kStage;
  static constexpr int kCS = ROPE ? 2 * kBK * D : 0;
  static constexpr int kBytes = (kKV + kCS) * 4 + 2 * kBK;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small with big = tf32(x) (round to nearest); the tensor core
// reads small = x - big truncated to tf32, which drops at most 2^-10 of
// small, 2^-21 of x
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (gmem
// must still be a valid address)
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// One key tile for one warp's 16 rows: the scores of the tile's first NTL
// 8-key column tiles (keys past kend are zero rows in shared memory and are
// masked to -inf; `check` also applies kv_mask), the online softmax update,
// and o += p v.
template <int D, int NTL>
__device__ __forceinline__ void attend_tile(const float* ks, const float* vs, const unsigned char* masked,
                                            int kend, bool check, const uint32_t (&q_big)[D / 8][4],
                                            const uint32_t (&q_small)[D / 8][4], float (&o)[D / 8][4],
                                            float (&m)[2], float (&l)[2], int g, int t) {
  constexpr int KS = D / 8;
  constexpr int KST = D + 8;
  constexpr int VST = D + 4;
  float s[NTL][4];
#pragma unroll
  for (int j = 0; j < NTL; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
  // s += q k^T in 3xTF32, each of the three products over all column tiles
  // before the next (the cross terms first), so that updates of one
  // accumulator are NTL products apart. B's k index t is column 2t of the
  // k-step and t + 4 is 2t + 1 (q's fragment matches): one 8-byte load.
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t kb[NTL][2], ksm[NTL][2];
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
      const float2 kv = *reinterpret_cast<const float2*>(ks + (j * 8 + g) * KST + kk * 8 + 2 * t);
      split(kv.x, kb[j][0], ksm[j][0]);
      split(kv.y, kb[j][1], ksm[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NTL; ++j) mma_tf32(s[j], q_small[kk], kb[j]);
#pragma unroll
    for (int j = 0; j < NTL; ++j) mma_tf32(s[j], q_big[kk], ksm[j]);
#pragma unroll
    for (int j = 0; j < NTL; ++j) mma_tf32(s[j], q_big[kk], kb[j]);
  }
  // s[j][e]: row g + 8 * (e >> 1), key j * 8 + 2 * t + (e & 1)
  if (check) {
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * t + (e & 1);
        if (key >= kend) {
          s[j][e] = -INFINITY;
        } else if (masked[key]) {
          s[j][e] = -1e30f;
        }
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NTL; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    corr[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int dn = 0; dn < KS; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] *= corr[e >> 1];
  }
#pragma unroll
  for (int j = 0; j < NTL; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(s[j][e] - m[e >> 1]);
      l[e >> 1] += s[j][e];
    }
  }
  // o += p v: A column t is key 2t, column t + 4 is key 2t + 1
#pragma unroll
  for (int j = 0; j < NTL; ++j) {
    uint32_t pb[4], psm[4];
    split(s[j][0], pb[0], psm[0]);
    split(s[j][2], pb[1], psm[1]);
    split(s[j][1], pb[2], psm[2]);
    split(s[j][3], pb[3], psm[3]);
    const float* const vr = vs + (j * 8 + 2 * t) * VST + g;
    uint32_t vb[KS][2], vsm[KS][2];
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) {
      split(vr[dn * 8], vb[dn][0], vsm[dn][0]);
      split(vr[VST + dn * 8], vb[dn][1], vsm[dn][1]);
    }
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) mma_tf32(o[dn], psm, vb[dn]);
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) mma_tf32(o[dn], pb, vsm[dn]);
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) mma_tf32(o[dn], pb, vb[dn]);
  }
}

// RG row groups of 16 query rows, each taken by KG warps: with KG = 2 the
// warps of a row group split every key tile's column tiles between them,
// each keeps its own softmax state, and the two states are merged at the end.
template <int D, bool ROPE, int RG, int KG>
__global__ void __launch_bounds__(32 * RG * KG) flash_attn_fwd_kernel(const AttnParams p) {
  using S = Smem<D, ROPE>;
  constexpr int KS = D / 8;   // k-steps of q k^T, column tiles of the output
  constexpr int DQ = D / 4;   // RoPE2D quarter
  constexpr int CH = D / 4;   // 16-byte chunks of a row
  constexpr int KST = S::kKStride;
  constexpr int VST = S::kVStride;
  constexpr int kThreads = 32 * RG * KG;
  constexpr int NTW = 8 / KG;  // column tiles of a key tile per warp

  extern __shared__ __align__(16) float smem[];
  float* const cs = smem + S::kKV;  // cos rows, then sin rows
  unsigned char* const kmasked = reinterpret_cast<unsigned char*>(smem + S::kKV + S::kCS);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;  // row of the fragment (and row + 8)
  const int t = lane % 4;  // column pair of the fragment
  const int kg = (tid / 32) % KG;  // this warp's key group
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int row0 = (blockIdx.x * RG + tid / 32 / KG) * 16;
  const bool active = row0 < p.Nq;  // uniform over the warp
  const float* const kbase = p.k + b * p.k_sb + h * p.k_sh;
  const float* const vbase = p.v + b * p.v_sb + h * p.v_sh;
  const int n_tiles = (p.Nk + kBK - 1) / kBK;

  // request key tile `tile` into stage `stage`
  auto issue = [&](int tile, int stage) {
    const int k0 = tile * kBK;
    const int kend = min(kBK, p.Nk - k0);
    float* const ks = smem + stage * S::kStage;
    float* const vs = ks + kBK * KST;
    for (int e = tid; e < kBK * CH; e += kThreads) {
      const int j = e / CH;
      const int c = (e % CH) * 4;
      const bool live = j < kend;
      const long long key = live ? k0 + j : 0;
      cp_async16(ks + j * KST + c, kbase + key * p.k_sn + c, live);
      cp_async16(vs + j * VST + c, vbase + key * p.v_sn + c, live);
      if constexpr (ROPE) {
        const long long at = ((long long)b * p.Nk + key) * D + c;
        cp_async16(cs + j * D + c, p.kcos + at, live);
        cp_async16(cs + (kBK + j) * D + c, p.ksin + at, live);
      }
    }
    cp_async_commit();
    if (tid < kBK) {
      const int key = k0 + tid;
      kmasked[stage * kBK + tid] =
          key < p.Nk && p.kv_mask != nullptr && !p.kv_mask[(long long)b * p.Nk + key];
    }
  };

  issue(0, 0);

  // q: rows row0 + g and row0 + g + 8 (the tail clamped to a valid row, its
  // store skipped), columns 2t and 2t + 1 of each k-step (k index t and
  // t + 4), rotated, scaled, split
  uint32_t q_big[KS][4], q_small[KS][4];
  {
    const int r_lo = min(row0 + g, p.Nq - 1);
    const int r_hi = min(row0 + g + 8, p.Nq - 1);
    const float* const qrow[2] = {p.q + b * p.q_sb + h * p.q_sh + r_lo * p.q_sn,
                                  p.q + b * p.q_sb + h * p.q_sh + r_hi * p.q_sn};
    float qf[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) qf[kk][e] = qrow[e & 1][kk * 8 + 2 * t + (e >> 1)];
    }
    if constexpr (ROPE) {
      const long long t_lo = ((long long)b * p.Nq + r_lo) * D;
      const long long t_hi = ((long long)b * p.Nq + r_hi) * D;
      float rot[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        constexpr int kq = DQ / 8;  // k-steps per quarter
        const bool odd = (kk / kq) & 1;
        const int partner = odd ? kk - kq : kk + kq;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long at = ((e & 1) ? t_hi : t_lo) + kk * 8 + 2 * t + (e >> 1);
          const float other = odd ? qf[partner][e] : -qf[partner][e];
          rot[kk][e] = qf[kk][e] * p.qcos[at] + other * p.qsin[at];
        }
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[kk][e] = rot[kk][e];
      }
    }
    const float sl2 = p.scale * kLog2e;  // scores in log2 units: exp2f below
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) split(qf[kk][e] * sl2, q_big[kk][e], q_small[kk][e]);
    }
  }

  float o[KS][4];
#pragma unroll
  for (int dn = 0; dn < KS; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};              // this lane's share of the running sums

#pragma unroll 1
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    const int kend = min(kBK, p.Nk - tile * kBK);
    float* const ks = smem + stage * S::kStage;
    const float* const vs = ks + kBK * KST;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed for every thread
    if constexpr (ROPE) {
      // four pairs a step: columns c0..c0+3 of quarter 0 or 2 and their
      // partners DQ further on
      for (int e = tid; e < kend * (D / 8); e += kThreads) {
        const int j = e / (D / 8);
        const int w = (e % (D / 8)) * 4;
        const int c0 = (w / DQ) * 2 * DQ + w % DQ;
        const int c1 = c0 + DQ;
        float4* const k0p = reinterpret_cast<float4*>(ks + j * KST + c0);
        float4* const k1p = reinterpret_cast<float4*>(ks + j * KST + c1);
        const float4 x0 = *k0p, x1 = *k1p;
        const float4 cos0 = *reinterpret_cast<const float4*>(cs + j * D + c0);
        const float4 cos1 = *reinterpret_cast<const float4*>(cs + j * D + c1);
        const float4 sin0 = *reinterpret_cast<const float4*>(cs + (kBK + j) * D + c0);
        const float4 sin1 = *reinterpret_cast<const float4*>(cs + (kBK + j) * D + c1);
        *k0p = make_float4(x0.x * cos0.x - x1.x * sin0.x, x0.y * cos0.y - x1.y * sin0.y,
                           x0.z * cos0.z - x1.z * sin0.z, x0.w * cos0.w - x1.w * sin0.w);
        *k1p = make_float4(x1.x * cos1.x + x0.x * sin1.x, x1.y * cos1.y + x0.y * sin1.y,
                           x1.z * cos1.z + x0.z * sin1.z, x1.w * cos1.w + x0.w * sin1.w);
      }
      __syncthreads();  // K rotated; the cos/sin rows are free
    }
    if (tile + 1 < n_tiles) issue(tile + 1, stage ^ 1);

    // this warp's column tiles holding a live key, rounded up to 1, 2, 4 or
    // 8: branch-free bodies, so independent products can overlap
    const int key0 = kg * NTW * 8;
    const int kend_w = kend - key0;
    const int nt = min(NTW, (kend_w + 7) / 8);
    if (active && nt > 0) {
      const bool check = kend_w < NTW * 8 || p.kv_mask != nullptr;
      const float* const kw = ks + key0 * KST;
      const float* const vw = vs + key0 * VST;
      const unsigned char* const masked = kmasked + stage * kBK + key0;
      if (nt > 4) {
        if constexpr (NTW == 8) attend_tile<D, 8>(kw, vw, masked, kend_w, check, q_big, q_small, o, m, l, g, t);
      } else if (nt > 2) {
        attend_tile<D, 4>(kw, vw, masked, kend_w, check, q_big, q_small, o, m, l, g, t);
      } else if (nt > 1) {
        attend_tile<D, 2>(kw, vw, masked, kend_w, check, q_big, q_small, o, m, l, g, t);
      } else {
        attend_tile<D, 1>(kw, vw, masked, kend_w, check, q_big, q_small, o, m, l, g, t);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  if constexpr (KG == 2) {
    // key group 1 hands its state to key group 0 through shared memory (the
    // stages are free): lane by lane, the fragment layouts match
    constexpr int kState = 4 * KS + 4;
    float* const xchg = smem + ((tid / 32 / KG) * 32 + lane) * kState;
    if (kg == 1) {
#pragma unroll
      for (int dn = 0; dn < KS; ++dn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) xchg[4 * dn + e] = o[dn][e];
      }
      xchg[4 * KS] = m[0];
      xchg[4 * KS + 1] = m[1];
      xchg[4 * KS + 2] = l[0];
      xchg[4 * KS + 3] = l[1];
    }
    __syncthreads();
    if (kg == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = xchg[4 * KS + r];
      const float mx = fmaxf(m[r], m1);  // finite: group 0 always holds key 0
      a0[r] = exp2f(m[r] - mx);
      a1[r] = exp2f(m1 - mx);  // 0 where group 1 saw no key
      l[r] = l[r] * a0[r] + xchg[4 * KS + 2 + r] * a1[r];
    }
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = o[dn][e] * a0[e >> 1] + xchg[4 * dn + e] * a1[e >> 1];
    }
  }

  if (active) {
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    float* const out = p.out + (long long)bh * p.Nq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row < p.Nq) {
#pragma unroll
        for (int dn = 0; dn < KS; ++dn) {
          *reinterpret_cast<float2*>(out + (long long)row * D + dn * 8 + 2 * t) =
              make_float2(o[dn][2 * r] * inv[r], o[dn][2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// 4 warps a block either way: 4 row groups (64 query rows) when that gives
// at least one block per SM, else 2 row groups of 2 key groups (32 rows), so
// that the launches with few heads put twice the warps to work
bool split_keys(int B, int H, int Nq) { return (long long)B * H * ((Nq + 63) / 64) < sm_count(); }

int smem_bytes(int D, bool rope) {
  if (D == 64) return rope ? Smem<64, true>::kBytes : Smem<64, false>::kBytes;
  return rope ? Smem<32, true>::kBytes : Smem<32, false>::kBytes;
}

template <int D, bool ROPE, int RG, int KG>
int launch(const AttnParams& p, cudaStream_t stream) {
  const auto kernel = flash_attn_fwd_kernel<D, ROPE, RG, KG>;
  constexpr int smem = Smem<D, ROPE>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Nq + 16 * RG - 1) / (16 * RG), p.B * p.H);
  kernel<<<grid, 32 * RG * KG, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D, bool ROPE>
int launch_warps(const AttnParams& p, cudaStream_t stream) {
  return split_keys(p.B, p.H, p.Nq) ? launch<D, ROPE, 2, 2>(p, stream) : launch<D, ROPE, 4, 1>(p, stream);
}

}  // namespace

// q [B, H, Nq, D], k/v [B, H, Nk, D] with unit stride on D, the given element
// strides (multiples of 4) and 16-byte-aligned bases; cos/sin [B, N, D]
// contiguous (all four null for no RoPE); kv_mask [B, Nk] bytes or null; out
// [B, H, Nq, D] contiguous. fp32 throughout.
extern "C" int siu3r_flash_attn_fwd(
    const float* q, const float* k, const float* v,
    const float* qcos, const float* qsin, const float* kcos, const float* ksin,
    const unsigned char* kv_mask, float* out,
    int B, int H, int Nq, int Nk, int D,
    long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn,
    long long v_sb, long long v_sh, long long v_sn,
    float scale, cudaStream_t stream) {
  const AttnParams p{q, k, v, qcos, qsin, kcos, ksin, kv_mask, out,
                     B, H, Nq, Nk,
                     q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn,
                     scale};
  const bool rope = qcos != nullptr;
  if (D == 64) return rope ? launch_warps<64, true>(p, stream) : launch_warps<64, false>(p, stream);
  if (D == 32) return rope ? launch_warps<32, true>(p, stream) : launch_warps<32, false>(p, stream);
  return (int)cudaErrorInvalidValue;
}

// The launch's shape for these sizes: blocks, threads a block, dynamic shared
// memory bytes a block.
extern "C" int siu3r_flash_attn_launch_config(int B, int H, int Nq, int D, int rope,
                                              int* blocks, int* threads, int* smem) {
  if (D != 32 && D != 64) return (int)cudaErrorInvalidValue;
  const int rows = split_keys(B, H, Nq) ? 32 : 64;
  *blocks = B * H * ((Nq + rows - 1) / rows);
  *threads = 128;
  *smem = smem_bytes(D, rope != 0);
  return 0;
}
