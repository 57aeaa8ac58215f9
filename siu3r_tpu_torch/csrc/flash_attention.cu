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
// Kernel 1b: `_attn_rope_kernel` (siu3r_tpu/ops/flash_attention.py:67) on
// bf16 q, k, v (the backbone's attention under `model.dtype: bfloat16`),
// RoPE only, no key mask. Both products are
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`, fp32 accumulation.
// Bound at the main path's shapes (N = 257, D = 64): the 4*N*N*D flops at
// the dense bf16 rate (989 TFLOP/s) take less time than the bytes (q, k, v,
// the bf16 tables, out; 2 bytes each), so bytes: 0.0566 ms a two-view bf16
// forward (72 launches). Where it rounds, following the JAX kernel on bf16
// inputs (siu3r_tpu/ops/flash_attention.py:75-91):
// - the rotation: the tables are bf16, and x * cos and rot(x) * sin are
//   each rounded to bf16, then their sum, as PyTorch's bf16 ops (the plain
//   version) round, two columns at a time (`mul.rn.bf16x2`, `add.rn.bf16x2`);
//   XLA may keep the products in fp32 before the add, which moves a rotated
//   value by at most one bf16 ulp;
// - the scores stay in the fp32 accumulator, and scale (with log2 e, for
//   exp2) multiplies the accumulator, not q (no second rounding of q);
// - the probabilities: JAX rounds the *normalised* p to bf16 before p v. An
//   online softmax rounds an unnormalised p and divides at the end, which
//   rounds each p differently. So every row takes two passes over its keys:
//   the first finds the row's max and sum of exp (online, fp32), the second
//   forms the normalised p in fp32, rounds it to bf16 and multiplies it into
//   V; the fp32 p is within a few fp32 ulps of the quotient, far inside its
//   bf16 rounding (chip_smoke.py holds the output to one bf16 ulp of the
//   plain version's, tests/test_torch_attn_bf16_schedule.py to 99% of it
//   bit-equal, where rounding the unnormalised p scores 51%);
// - the output: the fp32 accumulator rounded to bf16 once.
//
// What held the first design back (now the streamed kernel below):
// each block walked its 64-key tiles twice in series, 10 steps at N = 257,
// each waiting on its own `cp.async` group and passing two block barriers,
// and rotated every K tile again in each pass with its cos/sin rows staged
// in shared memory. The products were about 1% of a launch; the rest was
// about 2 us of dependent latency a step (24.5 us an encoder launch, 22.1
// a decoder one, where the 12 heads gave 108 blocks of 2 warps).
//
// The resident kernel, `flash_attn_rope_bf16_resident_kernel`, takes every
// launch whose K, V and pass 1's record fit a block's shared memory:
// - a block owns one (batch, head) and RG groups of 16 query rows. It
//   requests, in the order they are needed, all of its head's K rows
//   (16-byte `cp.async` copies, rows past Nk zero-filled up to a multiple of
//   16 keys), the k cos/sin rows of its first rotation batch and q, read
//   straight from global memory (the tables are one a batch, shared by its
//   heads: L2 hits, no shared-memory stage), then all of its V rows, whose
//   copies arrive on an mbarrier. Once K has landed it is rotated in place,
//   once, eight columns and their RoPE partners a thread and item. The
//   barrier after that is the block's last: each warp runs pass 1 from
//   shared memory alone, waits on V's mbarrier and runs pass 2;
// - rows stay padded to D + 8 bf16 (D / 2 + 4 words), so that the K
//   fragment loads (key g, word t) and the V `ldmatrix` rows (8 keys, 16
//   bytes each) hit distinct banks; at N = 257, D = 64 K and V take 78 KB;
// - a warp walks its keys in 16-key chunks, four at a time (64 keys: 8
//   column tiles of q k^T, 4 k-steps of p v), then a tail of two and of one,
//   so a 257-key set costs 17 chunks and not 5 tiles of 64; only the chunk
//   holding key Nk masks (keys past Nk take no part, -inf). In pass 1 the
//   next four chunks' products are issued before this tile's softmax. The
//   scores enter exp2 as one fused multiply-add, s * sl2 - max with sl2 =
//   scale * log2 e;
// - pass 1 records what pass 2 needs in shared memory: each e =
//   exp2(s * sl2 - m) of the warp's keys with m its tile's running max
//   (fp32, 1 KB a chunk of 16 keys and rows) and m after each tile. Pass 2
//   then takes p = e * f, f = exp2(m - max) * (1 / sum) once a tile and
//   row, without q k^T or an exp2 a score (on an H100: 13.1 -> 11.3 us an
//   encoder launch, 9.0 -> 8.4 a decoder one). With the record a 6-warp
//   block takes 188 KB at N = 257, one block an SM. It fits up to 320 keys
//   at D = 64 (400 at D = 32), the resident limit;
// - two layouts: where the launch has as many 64-row blocks as SMs (the
//   16-head encoder at B = 2), 6 row groups of one warp a block (96 blocks;
//   4 row groups would make 160 blocks of 148 KB, two waves); else (the
//   12-head decoder, few
//   heads) 2 row groups of 2 warps that split the keys, contiguous and
//   disjoint ranges of the chunks (108 blocks for the decoder). After pass 1
//   the two exchange their rows' (max, sum) through shared memory behind a
//   named barrier of the group's warps, and each merges them in the same
//   order into the row's exact max and sum, so p is normalised with the
//   global values before it is rounded, as in JAX; after pass 2, warp 1
//   hands its partial fp32 accumulator to warp 0, which adds it and rounds
//   once. Only the order of fp32 sums changes. More warps a block (6 x 2,
//   5 x 2) spill registers and were slower on an H100.
// Longer key sets take the streamed kernel, `flash_attn_rope_bf16_kernel`:
// K, V (pass 2 only) and the tile's cos/sin rows in shared memory by 16-byte
// `cp.async` copies (8 bf16), two stages, the next tile requested before
// this one is rotated and multiplied, one warp per 16 query rows, 4 warps a
// block (2 when that gives fewer blocks than SMs), the scores times scale
// in the accumulator and exp2f(s - max). In both, q is loaded into A
// fragments and rotated in registers (its RoPE partner, DQ columns away,
// sits in the same lane); the scores of column tiles 2i and 2i + 1, packed
// to bf16 pairs, are the A fragment of the 16-key step i of p v as they
// stand; V's B fragments come from `ldmatrix.x4.trans` (keys 2t, 2t + 1 of
// column g). Which variant runs follows from Nk and D alone
// (`siu3r_flash_attn_bf16_variant`).

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

// q: rows row0 + g and row0 + g + 8 (the tail clamped to a valid row, its
// store skipped) in the A-fragment layout, rotated in registers: fragment
// register r of k-step kk holds row g + 8 * (r & 1), columns
// kk * 16 + 8 * (r >> 1) + 2t and + 1, and its RoPE partner (the column
// DQ away) sits in the same lane: k-step kk ^ 1 at D = 64, register r ^ 2
// at D = 32
template <int D>
__device__ __forceinline__ void load_q_bf16(const AttnBf16Params& p, int b, int h, int row0, int g, int t,
                                            uint32_t (&qa)[D / 16][4]) {
  constexpr int KS = D / 16;
  constexpr int DQ = D / 4;
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

  uint32_t qa[KS][4];
  load_q_bf16<D>(p, b, h, row0, g, t, qa);

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

// ------------------------------------------------------- kernel 1b, resident

// A block of the resident kernel: RG row groups of 16 query rows, each
// taken by KG warps over disjoint key ranges. kWide where the launch has at
// least one block of 64 query rows per SM, else kSplit (`split_keys`, kernel
// 1's rule).
struct Bf16Layout {
  int rg, kg;
};
constexpr Bf16Layout kWide{6, 1};
constexpr Bf16Layout kSplit{2, 2};

constexpr int kMaxBlockSmem = 232448;  // a block's dynamic shared memory on sm_90 (227 KB)

// Its shared memory, in bytes: V's mbarrier (16 bytes); with KG > 1, per
// row group the KG warps'
// (max, sum) of its 16 rows [RG][KG][16][2] fp32 and the partial
// accumulators of warps 1..KG-1 [RG][KG - 1][D / 2][32 lanes] fp32; then K
// and V, [Nk rounded up to 16][D + 8] bf16 each; then each
// warp's record of pass 1: the exp2(s - m) of its chunks, [chunks][2][32
// lanes] float4 (1 KB a chunk), and the running max m of its rows after each
// of its tiles, [tiles][32 lanes] float2.
template <int D, int RG, int KG>
struct ResidentSmem {
  static constexpr int kStride = D + 8;
  static constexpr int kBar = 16;  // V's mbarrier
  static constexpr int kStats = KG > 1 ? RG * KG * 16 * 2 * 4 : 0;
  static constexpr int kAccs = RG * (KG - 1) * (D / 2) * 32 * 4;
  static constexpr int kKV = kBar + kStats + kAccs;  // K's offset
  static constexpr int kPerKey = 2 * kStride * 2;
  // the most chunks and tiles one warp takes
  __host__ __device__ static constexpr int chunks(int nk) { return ((nk + 15) / 16 + KG - 1) / KG; }
  __host__ __device__ static constexpr int tiles(int nk) { return chunks(nk) / 4 + 2; }
  // the record's offset
  __host__ __device__ static constexpr int cache(int nk) { return kKV + ((nk + 15) & ~15) * kPerKey; }
  __host__ __device__ static constexpr int bytes(int nk) {
    return cache(nk) + RG * KG * (chunks(nk) * 1024 + tiles(nk) * 256);
  }
};

template <int D>
using WideSmem = ResidentSmem<D, kWide.rg, kWide.kg>;
template <int D>
using SplitSmem = ResidentSmem<D, kSplit.rg, kSplit.kg>;

// The most keys (a multiple of 16) that a block of either layout holds with
// pass 1's record: 320 at D = 64, 400 at D = 32
template <int D>
constexpr int resident_keys() {
  int nk = 16;
  const auto fits = [](int n) {
    return WideSmem<D>::bytes(n) <= kMaxBlockSmem && SplitSmem<D>::bytes(n) <= kMaxBlockSmem;
  };
  while (fits(nk + 16)) nk += 16;
  return nk;
}

// kernel 1b's variants, as siu3r_flash_attn_bf16_variant reports them
enum Bf16Variant { kResident = 1, kStreamed = 2 };

// from Nk and D alone: resident where K, V and pass 1's record fit a block,
// else streamed
Bf16Variant bf16_variant(int Nk, int D) {
  constexpr int kResident64 = resident_keys<64>(), kResident32 = resident_keys<32>();
  return Nk <= (D == 64 ? kResident64 : kResident32) ? kResident : kStreamed;
}

// 2^x by the special function unit alone (`ex2.approx.ftz.f32`: exp2f's
// own approximation, 2 ulp, without its rescaling of subnormal inputs and
// results): results below 2^-126 are 0, where the row's largest is 1, far
// inside p's bf16 rounding
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// the mbarrier's pending count falls by one when every cp.async this thread
// has issued so far has landed
__device__ __forceinline__ void cp_async_mbarrier_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the mbarrier has completed phase `parity`
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// a barrier of `threads` threads (whole warps) on hardware barrier `id` (0 is
// __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The raw fp32 scores of NC 16-key chunks from key0 for a warp's 16 rows:
// s[j][e] is row g + 8 * (e >> 1), key key0 + 8 * j + 2 * t + (e & 1). B's k
// index 2t, 2t + 1 is one word of K's row, and 2t + 8, 2t + 9 the word 4
// further on. Only issues the products: nothing here waits on them.
template <int D, int NC>
__device__ __forceinline__ void chunk_scores(const uint16_t* ks, int key0, const uint32_t (&qa)[D / 16][4],
                                             float (&s)[2 * NC][4], int g, int t) {
  constexpr int KST = D + 8;
#pragma unroll
  for (int j = 0; j < 2 * NC; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 2 * NC; ++j) {
      const uint16_t* const row = ks + (key0 + j * 8 + g) * KST + kk * 16 + 2 * t;
      mma_bf16(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(row), *reinterpret_cast<const uint32_t*>(row + 8));
    }
  }
}

// keys at or past nk take no part: -inf (only the chunk holding key nk - 1
// has keys past it)
template <int NC>
__device__ __forceinline__ void mask_keys(float (&s)[2 * NC][4], int key0, int nk, int t) {
  if (key0 + 16 * NC > nk) {
#pragma unroll
    for (int j = 0; j < 2 * NC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (key0 + j * 8 + 2 * t + (e & 1) >= nk) s[j][e] = -INFINITY;
      }
    }
  }
}

// Pass 1's update over NC chunks of raw scores s: the online max m of rows g
// and g + 8 in log2 units (the raw maximum times sl2 = scale * log2 e: the
// product is monotonic, so this is the maximum of the scaled scores), this
// lane's share l of their sums of e = exp2(s * sl2 - m) (the argument one
// fused multiply-add) and each e to the warp's record of these
// chunks (two float4 a chunk and lane). Maxima and sums by trees over the
// column tiles.
template <int NC>
__device__ __forceinline__ void chunk_softmax(float (&s)[2 * NC][4], int key0, int nk, float sl2, float (&m)[2],
                                              float (&l)[2], float4* record, int t, int lane) {
  mask_keys<NC>(s, key0, nk, t);
  float x[2 * NC][2];
#pragma unroll
  for (int j = 0; j < 2 * NC; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) x[j][r] = fmaxf(s[j][2 * r], s[j][2 * r + 1]);
  }
#pragma unroll
  for (int w = NC; w >= 1; w /= 2) {
#pragma unroll
    for (int j = 0; j < w; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) x[j][r] = fmaxf(x[j][r], x[j + w][r]);
    }
  }
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(m[r], x[0][r] * sl2);
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    l[r] *= exp2_ftz(m[r] - mx[r]);  // 0 on the first chunks (m = -inf)
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < 2 * NC; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = exp2_ftz(fmaf(s[j][e], sl2, -m[e >> 1]));
    record[j * 32 + lane] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
#pragma unroll
    for (int r = 0; r < 2; ++r) x[j][r] = s[j][2 * r] + s[j][2 * r + 1];
  }
#pragma unroll
  for (int w = NC; w >= 1; w /= 2) {
#pragma unroll
    for (int j = 0; j < w; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) x[j][r] += x[j + w][r];
    }
  }
  l[0] += x[0][0];
  l[1] += x[0][1];
}

// o += p v over the 16 keys from key: pr[jj][e] is p of row g + 8 * (e >> 1),
// key + 8 * jj + 2 * t + (e & 1), rounded here to bf16; packed to pairs, it
// is the A fragment of the step as it stands
template <int D>
__device__ __forceinline__ void pv_step(const uint16_t* vs, int key, const float (&pr)[2][4], float (&o)[D / 8][4],
                                        int lane) {
  constexpr int KST = D + 8;
  const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                          pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
  // matrices 0, 1: keys key + 0..7 and + 8..15 at columns 16n..16n + 7 (B of
  // output tile 2n); matrices 2, 3: the same at 16n + 8.. (tile 2n + 1)
  const uint16_t* const vrow = vs + (key + (lane & 7) + ((lane >> 3) & 1) * 8) * KST + (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    uint32_t vb[4];
    ldmatrix_x4_trans(vb, vrow + 16 * n);
    mma_bf16(o[2 * n], pa, vb[0], vb[1]);
    mma_bf16(o[2 * n + 1], pa, vb[2], vb[3]);
  }
}

// Pass 2 over NC chunks from pass 1's record: p = e * f rounded to bf16,
// where e = exp2(s * sl2 - m_tile) was recorded with the tile's running max and
// f = exp2(m_tile - max) * inv is taken once a tile and row
template <int D, int NC>
__device__ __forceinline__ void chunk_pv_recorded(const float4* record, const uint16_t* vs, int key0,
                                                  const float (&f)[2], float (&o)[D / 8][4], int lane) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    float pr[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const float4 e = record[(2 * i + jj) * 32 + lane];
      pr[jj][0] = e.x * f[0];
      pr[jj][1] = e.y * f[0];
      pr[jj][2] = e.z * f[1];
      pr[jj][3] = e.w * f[1];
    }
    pv_step<D>(vs, key0 + 16 * i, pr, o, lane);
  }
}

// K's rotation in place, in items of eight columns of quarter 0 or 2 and
// their partners D / 4 further on, D / 16 items a key: item e is key j,
// columns c0..c0 + 7
template <int D>
__device__ __forceinline__ void rotation_item(int e, int& j, int& c0) {
  constexpr int DQ = D / 4;
  j = e / (D / 16);
  const int w = (e % (D / 16)) * 8;
  c0 = (w / DQ) * 2 * DQ + w % DQ;
}

// a 257-key head's 1028 items at D = 64 in one batch of 128 threads
constexpr int kRotBatch = 9;

// the cos/sin rows of items e0, e0 + STEP, ... (N of them, those below
// n_items) straight from global memory: the tables are one a batch, shared
// by its heads (L2 hits); 16-byte loads, all in flight together
template <int D, int N, int STEP>
__device__ __forceinline__ void fetch_tables(const uint16_t* kcos, const uint16_t* ksin, int e0, int n_items,
                                             uint4 (&tab)[N][4]) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int e = e0 + u * STEP;
    if (e < n_items) {
      int j, c0;
      rotation_item<D>(e, j, c0);
      const long long at = (long long)j * D + c0;
      tab[u][0] = __ldg(reinterpret_cast<const uint4*>(kcos + at));
      tab[u][1] = __ldg(reinterpret_cast<const uint4*>(ksin + at));
      tab[u][2] = __ldg(reinterpret_cast<const uint4*>(kcos + at + D / 4));
      tab[u][3] = __ldg(reinterpret_cast<const uint4*>(ksin + at + D / 4));
    }
  }
}

__device__ __forceinline__ uint4 rotate_bf16x8(uint4 x, uint4 c, uint4 o, uint4 s, uint32_t sign) {
  return make_uint4(rotate_bf16x2(x.x, c.x, o.x ^ sign, s.x), rotate_bf16x2(x.y, c.y, o.y ^ sign, s.y),
                    rotate_bf16x2(x.z, c.z, o.z ^ sign, s.z), rotate_bf16x2(x.w, c.w, o.w ^ sign, s.w));
}

// rotate the K columns of items e0, e0 + STEP, ... with their fetched rows:
// x0 * cos - x1 * sin at c0, x1 * cos + x0 * sin at c0 + D / 4
template <int D, int N, int STEP>
__device__ __forceinline__ void rotate_items(uint16_t* ks, int e0, int n_items, const uint4 (&tab)[N][4]) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int e = e0 + u * STEP;
    if (e < n_items) {
      int j, c0;
      rotation_item<D>(e, j, c0);
      uint4* const k0p = reinterpret_cast<uint4*>(ks + j * (D + 8) + c0);
      uint4* const k1p = reinterpret_cast<uint4*>(ks + j * (D + 8) + c0 + D / 4);
      const uint4 x0 = *k0p, x1 = *k1p;
      *k0p = rotate_bf16x8(x0, tab[u][0], x1, tab[u][1], kSigns);
      *k1p = rotate_bf16x8(x1, tab[u][2], x0, tab[u][3], 0u);
    }
  }
}

// RG row groups of 16 query rows, KG warps each. K and V of the block's head
// in shared memory for the whole launch, K rotated once; then each warp's
// two passes over its keys with no block barrier (see the note at the top).
template <int D, int RG, int KG>
__global__ void __launch_bounds__(32 * RG * KG) flash_attn_rope_bf16_resident_kernel(const AttnBf16Params p) {
  static_assert(D == 32 || D == 64, "head dim 32 or 64");
  using S = ResidentSmem<D, RG, KG>;
  constexpr int NT = D / 8;  // column tiles of the output
  constexpr int CH = D / 8;  // 16-byte pieces of a row
  constexpr int KST = S::kStride;
  constexpr int kThreads = 32 * RG * KG;

  extern __shared__ __align__(16) float smem[];
  uint16_t* const ks = reinterpret_cast<uint16_t*>(smem + S::kKV / 4);
  const int nkp = (p.Nk + 15) & ~15;
  uint16_t* const vs = ks + nkp * KST;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rg = tid / 32 / KG;  // this warp's row group
  const int kg = tid / 32 % KG;  // and its key group in it
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int row0 = (blockIdx.x * RG + rg) * 16;
  const bool active = row0 < p.Nq;  // uniform over the row group's warps

  // V lands on an mbarrier that every thread's copies arrive on: the warps
  // wait for it before pass 2, with no block barrier
  uint64_t* const v_landed = reinterpret_cast<uint64_t*>(smem);
  if (tid == 0) mbarrier_init(v_landed, kThreads);
  __syncthreads();

  // in the order they are needed: every row of K (16-byte copies, rows past
  // Nk zero-filled, one commit group), the first batch of K's table rows
  // and q, then every row of V
  const uint16_t* const kbase = p.k + b * p.k_sb + h * p.k_sh;
  const uint16_t* const vbase = p.v + b * p.v_sb + h * p.v_sh;
  for (int e = tid; e < nkp * CH; e += kThreads) {
    const int j = e / CH;
    const int c = (e % CH) * 8;
    const bool live = j < p.Nk;
    cp_async16(ks + j * KST + c, kbase + (live ? j : 0) * p.k_sn + c, live);
  }
  cp_async_commit();
  // K's rotation: kRotBatch items a thread at a time, their table rows in
  // flight together
  const int n_items = p.Nk * (D / 16);
  const uint16_t* const kcos = p.kcos + (long long)b * p.Nk * D;
  const uint16_t* const ksin = p.ksin + (long long)b * p.Nk * D;
  uint4 tab[kRotBatch][4];
  fetch_tables<D, kRotBatch, kThreads>(kcos, ksin, tid, n_items, tab);
  uint32_t qa[D / 16][4];
  load_q_bf16<D>(p, b, h, row0, g, t, qa);
  for (int e = tid; e < nkp * CH; e += kThreads) {
    const int j = e / CH;
    const int c = (e % CH) * 8;
    const bool live = j < p.Nk;
    cp_async16(vs + j * KST + c, vbase + (live ? j : 0) * p.v_sn + c, live);
  }
  cp_async_commit();
  cp_async_mbarrier_arrive(v_landed);

  cp_async_wait_one();  // this thread's K copies
  __syncthreads();      // every K row has landed
#pragma unroll 1
  for (int e0 = tid; e0 < n_items; e0 += kRotBatch * kThreads) {
    if (e0 != tid) fetch_tables<D, kRotBatch, kThreads>(kcos, ksin, e0, n_items, tab);
    rotate_items<D, kRotBatch, kThreads>(ks, e0, n_items, tab);
  }
  __syncthreads();  // K rotated: the last block barrier
  if (!active) {
    mbarrier_wait(v_landed, 0);  // no thread leaves while copies it issued are in flight
    return;
  }

  // this warp's 16-key chunks: a contiguous share of the head's
  const int chunks = nkp / 16;
  const int c_lo = kg * chunks / KG;
  const int c_hi = (kg + 1) * chunks / KG;
  const float sl2 = p.scale * kLog2e;

  // this warp's record of pass 1: its chunks' exp2(s - m), then
  // m after each tile
  const int warp = tid / 32;
  float4* const record = reinterpret_cast<float4*>(reinterpret_cast<char*>(smem) + S::cache(p.Nk)) +
                         warp * S::chunks(p.Nk) * 64;
  float2* const tile_max = reinterpret_cast<float2*>(
                               reinterpret_cast<char*>(smem) + S::cache(p.Nk) + RG * KG * S::chunks(p.Nk) * 1024) +
                           warp * S::tiles(p.Nk) * 32 + lane;

  // pass 1: each row's max and sum of exp2(s * sl2 - max), in log2 units.
  // Full tiles of four chunks take two score sets in turn: the next tile's
  // products are issued before this tile's softmax, which runs under them
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  int c = c_lo;
  int tile = 0;
  float sa[8][4], sb[8][4];
  if (c + 4 <= c_hi) chunk_scores<D, 4>(ks, 16 * c, qa, sa, g, t);
#pragma unroll 1
  while (c + 4 <= c_hi) {
    const bool next = c + 8 <= c_hi;
    if (next) chunk_scores<D, 4>(ks, 16 * (c + 4), qa, sb, g, t);
    chunk_softmax<4>(sa, 16 * c, p.Nk, sl2, m, l, record + (c - c_lo) * 64, t, lane);
    tile_max[tile * 32] = make_float2(m[0], m[1]);
    c += 4;
    ++tile;
    if (!next) break;
    const bool after = c + 8 <= c_hi;
    if (after) chunk_scores<D, 4>(ks, 16 * (c + 4), qa, sa, g, t);
    chunk_softmax<4>(sb, 16 * c, p.Nk, sl2, m, l, record + (c - c_lo) * 64, t, lane);
    tile_max[tile * 32] = make_float2(m[0], m[1]);
    c += 4;
    ++tile;
    if (!after) break;
  }
  if (c + 2 <= c_hi) {
    float s2[4][4];
    chunk_scores<D, 2>(ks, 16 * c, qa, s2, g, t);
    chunk_softmax<2>(s2, 16 * c, p.Nk, sl2, m, l, record + (c - c_lo) * 64, t, lane);
    tile_max[tile++ * 32] = make_float2(m[0], m[1]);
    c += 2;
  }
  if (c < c_hi) {
    float s1[2][4];
    chunk_scores<D, 1>(ks, 16 * c, qa, s1, g, t);
    chunk_softmax<1>(s1, 16 * c, p.Nk, sl2, m, l, record + (c - c_lo) * 64, t, lane);
    tile_max[tile * 32] = make_float2(m[0], m[1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  if constexpr (KG > 1) {
    // the row group's warps exchange their rows' (max, sum), and each merges
    // all of them in the same order: every warp holds the row's exact max
    // and sum (a warp without keys holds -inf and 0, and adds nothing)
    float* const stats = smem + S::kBar / 4 + rg * KG * 32;  // [KG][16 rows][max, sum]
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        stats[(kg * 16 + g + 8 * r) * 2] = m[r];
        stats[(kg * 16 + g + 8 * r) * 2 + 1] = l[r];
      }
    }
    named_barrier(1 + rg, 32 * KG);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* const row = stats + (g + 8 * r) * 2;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < KG; ++w) mx = fmaxf(mx, row[w * 32]);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < KG; ++w) sum += row[w * 32 + 1] * exp2_ftz(row[w * 32] - mx);
      m[r] = mx;
      l[r] = sum;
    }
  }
  const float inv[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};

  // pass 2: o += p v, p normalised and rounded to bf16, once V has landed
  mbarrier_wait(v_landed, 0);
  float o[NT][4];
#pragma unroll
  for (int dn = 0; dn < NT; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  }
  // f = exp2(m_tile - max) * inv of each row, once a tile
  auto tile_factor = [&](int i, float (&f)[2]) {
    const float2 mt = tile_max[i * 32];
    f[0] = exp2_ftz(mt.x - m[0]) * inv[0];
    f[1] = exp2_ftz(mt.y - m[1]) * inv[1];
  };
  c = c_lo;
  tile = 0;
  float f[2];
#pragma unroll 1
  for (; c + 4 <= c_hi; c += 4, ++tile) {
    tile_factor(tile, f);
    chunk_pv_recorded<D, 4>(record + (c - c_lo) * 64, vs, 16 * c, f, o, lane);
  }
  if (c + 2 <= c_hi) {
    tile_factor(tile++, f);
    chunk_pv_recorded<D, 2>(record + (c - c_lo) * 64, vs, 16 * c, f, o, lane);
    c += 2;
  }
  if (c < c_hi) {
    tile_factor(tile, f);
    chunk_pv_recorded<D, 1>(record + (c - c_lo) * 64, vs, 16 * c, f, o, lane);
  }
  if constexpr (KG > 1) {
    // warps 1..KG-1 hand their partial fp32 accumulators to warp 0, which
    // adds them in order (lane-major: conflict-free)
    float* const accs = smem + (S::kBar + S::kStats) / 4 + rg * (KG - 1) * (D / 2) * 32 + lane;
    if (kg > 0) {
#pragma unroll
      for (int dn = 0; dn < NT; ++dn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) accs[((kg - 1) * (D / 2) + dn * 4 + e) * 32] = o[dn][e];
      }
    }
    named_barrier(1 + rg, 32 * KG);
    if (kg > 0) return;
#pragma unroll
    for (int w = 1; w < KG; ++w) {
#pragma unroll
      for (int dn = 0; dn < NT; ++dn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dn][e] += accs[((w - 1) * (D / 2) + dn * 4 + e) * 32];
      }
    }
  }

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

template <int D, int RG, int KG>
int launch_bf16_resident(const AttnBf16Params& p, cudaStream_t stream) {
  const auto kernel = flash_attn_rope_bf16_resident_kernel<D, RG, KG>;
  const int smem = ResidentSmem<D, RG, KG>::bytes(p.Nk);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Nq + 16 * RG - 1) / (16 * RG), p.B * p.H);
  kernel<<<grid, 32 * RG * KG, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// the variant and, resident, the layout the launch's size takes
template <int D>
int launch_bf16_variant(const AttnBf16Params& p, cudaStream_t stream) {
  if (bf16_variant(p.Nk, D) == kStreamed) return launch_bf16_warps<D>(p, stream);
  return split_keys(p.B, p.H, p.Nq) ? launch_bf16_resident<D, kSplit.rg, kSplit.kg>(p, stream)
                                    : launch_bf16_resident<D, kWide.rg, kWide.kg>(p, stream);
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
  if (D == 64) return launch_bf16_variant<64>(p, stream);
  if (D == 32) return launch_bf16_variant<32>(p, stream);
  return (int)cudaErrorInvalidValue;
}

// Kernel 1b's variant for these sizes, from Nk and D alone: 1 the resident
// kernel, 2 the streamed one; 0 for a head dim it does not take.
extern "C" int siu3r_flash_attn_bf16_variant(int Nk, int D) {
  if (D != 32 && D != 64) return 0;
  return (int)bf16_variant(Nk, D);
}

// Kernel 1b's launch for these sizes (the variant's): blocks, threads a
// block, dynamic shared memory bytes a block.
extern "C" int siu3r_flash_attn_bf16_launch_config(int B, int H, int Nq, int Nk, int D, int* blocks, int* threads,
                                                   int* smem) {
  if (D != 32 && D != 64) return (int)cudaErrorInvalidValue;
  const Bf16Variant variant = bf16_variant(Nk, D);
  int rg, kg;
  if (variant == kStreamed) {
    rg = split_keys(B, H, Nq) ? 2 : 4;
    kg = 1;
    *smem = D == 64 ? SmemBf16<64>::kBytes : SmemBf16<32>::kBytes;
  } else if (split_keys(B, H, Nq)) {
    rg = kSplit.rg;
    kg = kSplit.kg;
    *smem = D == 64 ? SplitSmem<64>::bytes(Nk) : SplitSmem<32>::bytes(Nk);
  } else {
    rg = kWide.rg;
    kg = kWide.kg;
    *smem = D == 64 ? WideSmem<64>::bytes(Nk) : WideSmem<32>::bytes(Nk);
  }
  *blocks = B * H * ((Nq + 16 * rg - 1) / (16 * rg));
  *threads = 32 * rg * kg;
  return 0;
}
