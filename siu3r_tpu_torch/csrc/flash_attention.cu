// Fused attention forward for Hopper (sm_90a): softmax(rot(q) rot(k)^T * scale) v
// with an optional RoPE2D rotation of q and k and an optional per-batch key mask.
//
// Replaces the TPU kernels `_attn_rope_kernel` (siu3r_tpu/ops/flash_attention.py:67)
// and `_attn_kernel` (siu3r_tpu/ops/flash_attention.py:33); the RoPE switch, the
// head dim (32 or 64) and the block's layout are template parameters of one
// kernel. On bf16 inputs `_attn_rope_kernel` is a sibling kernel, kernel 1b
// (below the fp32 design notes).
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
//
// Kernel 1b, `flash_attn_rope_bf16_kernel`: `_attn_rope_kernel` on bf16 q,
// k, v (the backbone's attention under `model.dtype: bfloat16`), RoPE only,
// no key mask. The same two products, each one
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` per fragment, fp32
// accumulation. Bound at the main path's shapes (N = 257, D = 64): the
// 4*N*N*D flops at the dense bf16 rate (989 TFLOP/s) take less time than the
// bytes (q, k, v, the bf16 tables, out; 2 bytes each), so bytes; the kernel
// is far from either. Where it rounds, following the JAX kernel on bf16
// inputs (siu3r_tpu/ops/flash_attention.py:67-91):
// - the rotation: the tables are bf16, and x * cos and rot(x) * sin are
//   each rounded to bf16, then their sum, as PyTorch's bf16 ops (the plain
//   version) round, two columns at a time (`mul.rn.bf16x2`, `add.rn.bf16x2`);
//   XLA may keep the products in fp32 before the add, which moves a rotated
//   value by at most one bf16 ulp;
// - the scores stay in the fp32 accumulator, and scale (with log2 e, for
//   exp2f) multiplies the accumulator, not q (no second rounding of q);
// - the probabilities: JAX rounds the *normalised* p to bf16 before p v. An
//   online softmax rounds an unnormalised p and divides at the end, which
//   rounds each p differently. So the kernel takes two passes over the key
//   tiles: the first finds each row's max and sum of exp (online, fp32), the
//   second recomputes the scores (the same products in the same order, so
//   the same values), normalises p = exp(s - max) * (1 / sum) in fp32 (an
//   IEEE division a score costs several times the exponential; the product
//   with the rounded reciprocal is within an fp32 ulp of the quotient, far
//   inside p's bf16 rounding), rounds it to bf16 and multiplies it into V.
//   The first product is paid twice: at 257 keys that is 5 more tiles of
//   q k^T, and K is rotated twice;
// - the output: the fp32 accumulator rounded to bf16 once.
// Layout: one warp per 16 query rows, 4 warps a block (2 when that gives
// fewer blocks than SMs); K, V (pass 2 only) and the tile's cos/sin rows in
// shared memory by 16-byte `cp.async` copies (8 bf16), two stages, the next
// tile requested before this one is rotated and multiplied; rows
// padded to D + 8 bf16 (D/2 + 4 words), so that the K fragment loads and the
// V `ldmatrix` rows hit distinct banks. q is loaded into A fragments and
// rotated in registers (its RoPE partner, DQ columns away, sits in the same
// lane). The scores of column tiles 2i and 2i + 1, packed to bf16 pairs, are
// the A fragment of the 16-key step i of p v as they stand; V's B fragments
// come from `ldmatrix.x4.trans` (keys 2t, 2t + 1 of column g).

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

// ---------------------------------------------------------------- kernel 1b

// bf16 values travel as their 16 raw bits, two to a 32-bit word with the
// lower column in the lower half (the order of the mma fragments)
struct AttnBf16Params {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const uint16_t* qcos;
  const uint16_t* qsin;
  const uint16_t* kcos;
  const uint16_t* ksin;
  uint16_t* out;
  int B, H, Nq, Nk;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  float scale;
};

// Shared memory, in bf16 elements: [2 stages][K [kBK][D + 8], V [kBK][D + 8],
// cos [kBK][D], sin [kBK][D]]. A K or V row of D + 8 elements is D / 2 + 4
// words: the K fragment loads (key g, word t) and the ldmatrix rows (8 keys,
// 16 bytes each) then hit distinct banks.
template <int D>
struct SmemBf16 {
  static constexpr int kStride = D + 8;
  static constexpr int kCS = 2 * kBK * kStride;  // the cos rows' offset in a stage
  static constexpr int kStage = kCS + 2 * kBK * D;
  static constexpr int kBytes = 2 * kStage * 2;
};

// two floats rounded to the nearest bf16 (ties to even) and packed, lo in
// the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

constexpr uint32_t kSigns = 0x80008000u;  // the sign bits of a bf16 pair

// x * c + o * s on bf16 pairs as PyTorch computes it on bf16 tensors: each
// product rounded to bf16, then their sum (round to nearest even, sm_90's
// packed bf16 multiply and add)
__device__ __forceinline__ uint32_t rotate_bf16x2(uint32_t x, uint32_t c, uint32_t o, uint32_t s) {
  uint32_t xc, os, r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(xc) : "r"(x), "r"(c));
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(os) : "r"(o), "r"(s));
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(xc), "r"(os));
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 and receives of matrix i, in r[i],
// its rows 2t and 2t + 1 of column g
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint16_t* smem, const uint16_t* gmem, bool valid) {
  cp_async16(reinterpret_cast<float*>(smem), reinterpret_cast<const float*>(gmem), valid);
}

// s = q k^T over the 8 column tiles of a 64-key tile: s[j][e] is row
// g + 8 * (e >> 1), key 8 * j + 2 * t + (e & 1). B's k index 2t, 2t + 1 is
// one word of K's row, and 2t + 8, 2t + 9 the word 4 further on.
template <int D>
__device__ __forceinline__ void scores_bf16(const uint16_t* ks, const uint32_t (&qa)[D / 16][4], float (&s)[8][4],
                                            int g, int t) {
  constexpr int KST = SmemBf16<D>::kStride;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint16_t* const row = ks + (j * 8 + g) * KST + kk * 16 + 2 * t;
      mma_bf16(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(row), *reinterpret_cast<const uint32_t*>(row + 8));
    }
  }
}

// RG warps a block, 16 query rows each. Two passes over the key tiles: the
// first takes each row's max and sum of exp, the second the normalised
// probabilities, rounded to bf16, times V.
template <int D, int RG>
__global__ void __launch_bounds__(32 * RG) flash_attn_rope_bf16_kernel(const AttnBf16Params p) {
  static_assert(D == 32 || D == 64, "head dim 32 or 64");
  using S = SmemBf16<D>;
  constexpr int KS = D / 16;  // k-steps of q k^T
  constexpr int NT = D / 8;   // column tiles of the output
  constexpr int DQ = D / 4;   // RoPE2D quarter
  constexpr int CH = D / 8;   // 16-byte chunks of a row
  constexpr int KST = S::kStride;
  constexpr int kThreads = 32 * RG;

  extern __shared__ __align__(16) float smem[];
  uint16_t* const sh = reinterpret_cast<uint16_t*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int row0 = (blockIdx.x * RG + tid / 32) * 16;
  const bool active = row0 < p.Nq;  // uniform over the warp
  const uint16_t* const kbase = p.k + b * p.k_sb + h * p.k_sh;
  const uint16_t* const vbase = p.v + b * p.v_sb + h * p.v_sh;
  const int n_tiles = (p.Nk + kBK - 1) / kBK;
  const int n_steps = 2 * n_tiles;  // pass 0 on steps < n_tiles, pass 1 after

  // request the key tile of `step` into `stage`: K and its cos/sin rows, and
  // V in pass 1
  auto issue = [&](int step, int stage) {
    const bool with_v = step >= n_tiles;
    const int k0 = (with_v ? step - n_tiles : step) * kBK;
    const int kend = min(kBK, p.Nk - k0);
    uint16_t* const ks = sh + stage * S::kStage;
    uint16_t* const vs = ks + kBK * KST;
    uint16_t* const cs = ks + S::kCS;
    for (int e = tid; e < kBK * CH; e += kThreads) {
      const int j = e / CH;
      const int c = (e % CH) * 8;
      const bool live = j < kend;
      const long long key = live ? k0 + j : 0;
      cp_async16(ks + j * KST + c, kbase + key * p.k_sn + c, live);
      if (with_v) cp_async16(vs + j * KST + c, vbase + key * p.v_sn + c, live);
      const long long at = ((long long)b * p.Nk + key) * D + c;
      cp_async16(cs + j * D + c, p.kcos + at, live);
      cp_async16(cs + (kBK + j) * D + c, p.ksin + at, live);
    }
    cp_async_commit();
  };

  issue(0, 0);

  // q: rows row0 + g and row0 + g + 8 (the tail clamped to a valid row, its
  // store skipped) in the A-fragment layout, rotated in registers: fragment
  // register r of k-step kk holds row g + 8 * (r & 1), columns
  // kk * 16 + 8 * (r >> 1) + 2t and + 1, and its RoPE partner (the column
  // DQ away) sits in the same lane: k-step kk ^ 1 at D = 64, register r ^ 2
  // at D = 32
  uint32_t qa[KS][4];
  {
    const int rows[2] = {min(row0 + g, p.Nq - 1), min(row0 + g + 8, p.Nq - 1)};
    uint32_t qx[KS][4], qc[KS][4], qs[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = rows[r & 1];
        const int col = kk * 16 + 8 * (r >> 1) + 2 * t;
        const long long at = ((long long)b * p.Nq + row) * D + col;
        qx[kk][r] = *reinterpret_cast<const uint32_t*>(p.q + b * p.q_sb + h * p.q_sh + row * p.q_sn + col);
        qc[kk][r] = *reinterpret_cast<const uint32_t*>(p.qcos + at);
        qs[kk][r] = *reinterpret_cast<const uint32_t*>(p.qsin + at);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int pk = DQ == 16 ? kk ^ 1 : kk;
        const int pr = DQ == 16 ? r : r ^ 2;
        const bool first = DQ == 16 ? (kk & 1) == 0 : (r >> 1) == 0;  // quarter 0 or 2: takes -partner
        const uint32_t other = first ? qx[pk][pr] ^ kSigns : qx[pk][pr];
        qa[kk][r] = rotate_bf16x2(qx[kk][r], qc[kk][r], other, qs[kk][r]);
      }
    }
  }

  float o[NT][4];
#pragma unroll
  for (int dn = 0; dn < NT; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // max of rows g and g + 8, in log2 units
  float l[2] = {0.f, 0.f};              // their sums of exp2(s - m): this lane's share, then 1 / the row's
  const float sl2 = p.scale * kLog2e;

#pragma unroll 1
  for (int step = 0; step < n_steps; ++step) {
    const int stage = step & 1;
    const bool products = step >= n_tiles;
    const int kend = min(kBK, p.Nk - (products ? step - n_tiles : step) * kBK);
    uint16_t* const ks = sh + stage * S::kStage;
    const uint16_t* const vs = ks + kBK * KST;
    const uint16_t* const cs = ks + S::kCS;
    cp_async_wait_all();
    // this tile has landed for every thread, and every thread is done with
    // the other stage: the next tile's copies run under this one's rotation
    // and products
    __syncthreads();
    if (step + 1 < n_steps) issue(step + 1, stage ^ 1);
    // rotate K in place: two adjacent columns of quarter 0 or 2 and their
    // partners DQ further on, per item
    for (int e = tid; e < kend * (D / 4); e += kThreads) {
      const int j = e / (D / 4);
      const int w = (e % (D / 4)) * 2;
      const int c0 = (w / DQ) * 2 * DQ + w % DQ;
      const int c1 = c0 + DQ;
      uint32_t* const k0p = reinterpret_cast<uint32_t*>(ks + j * KST + c0);
      uint32_t* const k1p = reinterpret_cast<uint32_t*>(ks + j * KST + c1);
      const uint32_t x0 = *k0p, x1 = *k1p;
      const uint32_t cos0 = *reinterpret_cast<const uint32_t*>(cs + j * D + c0);
      const uint32_t cos1 = *reinterpret_cast<const uint32_t*>(cs + j * D + c1);
      const uint32_t sin0 = *reinterpret_cast<const uint32_t*>(cs + (kBK + j) * D + c0);
      const uint32_t sin1 = *reinterpret_cast<const uint32_t*>(cs + (kBK + j) * D + c1);
      *k0p = rotate_bf16x2(x0, cos0, x1 ^ kSigns, sin0);
      *k1p = rotate_bf16x2(x1, cos1, x0, sin1);
    }
    __syncthreads();  // K rotated

    if (active) {
      float s[8][4];
      scores_bf16<D>(ks, qa, s, g, t);
      // the fp32 scores times scale, in log2 units; keys past Nk take no part
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = j * 8 + 2 * t + (e & 1) < kend ? s[j][e] * sl2 : -INFINITY;
      }
      if (!products) {
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
          l[r] *= exp2f(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
          m[r] = mx[r];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[j][e] - m[e >> 1]);
        }
        if (step == n_tiles - 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(kFull, l[r], 1);
            l[r] += __shfl_xor_sync(kFull, l[r], 2);
            l[r] = __frcp_rn(l[r]);  // from here on, 1 / the row's sum
          }
        }
      } else {
        // o += p v over four 16-key steps: the score accumulators of column
        // tiles 2i and 2i + 1, normalised and packed to bf16 pairs, are the
        // A fragment of keys 16i..16i + 15 as they stand
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float pr[2][4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) pr[jj][e] = exp2f(s[2 * i + jj][e] - m[e >> 1]) * l[e >> 1];
          }
          const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                                  pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
          // matrices 0, 1: keys 16i + 0..7 and + 8..15 at columns 16n..16n + 7
          // (B of output tile 2n); matrices 2, 3: the same at 16n + 8.. (tile 2n + 1)
          const uint16_t* const vrow = vs + (16 * i + (lane & 7) + ((lane >> 3) & 1) * 8) * KST + (lane >> 4) * 8;
#pragma unroll
          for (int n = 0; n < D / 16; ++n) {
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, vrow + 16 * n);
            mma_bf16(o[2 * n], pa, vb[0], vb[1]);
            mma_bf16(o[2 * n + 1], pa, vb[2], vb[3]);
          }
        }
      }
    }
  }

  if (active) {
    uint16_t* const out = p.out + (long long)bh * p.Nq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row < p.Nq) {
#pragma unroll
        for (int dn = 0; dn < NT; ++dn) {
          *reinterpret_cast<uint32_t*>(out + (long long)row * D + dn * 8 + 2 * t) =
              pack_bf16(o[dn][2 * r], o[dn][2 * r + 1]);
        }
      }
    }
  }
}

template <int D, int RG>
int launch_bf16(const AttnBf16Params& p, cudaStream_t stream) {
  const auto kernel = flash_attn_rope_bf16_kernel<D, RG>;
  constexpr int smem = SmemBf16<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Nq + 16 * RG - 1) / (16 * RG), p.B * p.H);
  kernel<<<grid, 32 * RG, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// 4 warps (64 query rows) a block when that gives at least one block per SM,
// else 2 (32 rows)
template <int D>
int launch_bf16_warps(const AttnBf16Params& p, cudaStream_t stream) {
  return split_keys(p.B, p.H, p.Nq) ? launch_bf16<D, 2>(p, stream) : launch_bf16<D, 4>(p, stream);
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

// Kernel 1b: q [B, H, Nq, D], k/v [B, H, Nk, D] bf16 with unit stride on D,
// the given element strides (multiples of 8) and 16-byte-aligned bases;
// cos/sin [B, N, D] bf16 contiguous; out [B, H, Nq, D] bf16 contiguous.
extern "C" int siu3r_flash_attn_rope_bf16_fwd(
    const uint16_t* q, const uint16_t* k, const uint16_t* v,
    const uint16_t* qcos, const uint16_t* qsin, const uint16_t* kcos, const uint16_t* ksin, uint16_t* out,
    int B, int H, int Nq, int Nk, int D,
    long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn,
    long long v_sb, long long v_sh, long long v_sn,
    float scale, cudaStream_t stream) {
  const AttnBf16Params p{q, k, v, qcos, qsin, kcos, ksin, out,
                         B, H, Nq, Nk,
                         q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn,
                         scale};
  if (D == 64) return launch_bf16_warps<64>(p, stream);
  if (D == 32) return launch_bf16_warps<32>(p, stream);
  return (int)cudaErrorInvalidValue;
}

// Kernel 1b's launch for these sizes: blocks, threads a block, dynamic
// shared memory bytes a block.
extern "C" int siu3r_flash_attn_bf16_launch_config(int B, int H, int Nq, int D, int* blocks, int* threads, int* smem) {
  if (D != 32 && D != 64) return (int)cudaErrorInvalidValue;
  const int rg = split_keys(B, H, Nq) ? 2 : 4;
  *blocks = B * H * ((Nq + 16 * rg - 1) / (16 * rg));
  *threads = 32 * rg;
  *smem = D == 64 ? SmemBf16<64>::kBytes : SmemBf16<32>::kBytes;
  return 0;
}
