// Fused attention forward for Hopper (sm_90a): softmax(q k^T * scale) v with
// optional RoPE2D rotation of q and k and an optional per-batch key mask.
//
// Replaces the TPU kernels `_attn_rope_kernel` (siu3r_tpu/ops/flash_attention.py:67)
// and `_attn_kernel` (siu3r_tpu/ops/flash_attention.py:33); the RoPE switch and
// the head dim (32 or 64) are template parameters of one kernel.
//
// What bounds it on the card: at the main path's shapes (N = 257 or 100 tokens,
// D = 64 or 32, fp32) the work is 4*N*N*D flops per (batch, head) over only
// 4*N*D*4 bytes of input and output, so the bound is arithmetic. This first
// version runs on the fp32 FMA units (67 TFLOP/s peak on an H100 SXM at its
// 700 W limit, far below the tensor cores); the design keeps everything else
// off the critical path: no [N, N] score matrix ever reaches device memory,
// K/V tiles are read once per 64-query block, and the rotation is applied
// while tiles are loaded.
// Moving the two products onto tensor cores (mma.sync / wgmma) is later work.
//
// Design: one block per (64-query tile, batch*head); 4 threads per query, each
// owning one quarter of the head dim. The RoPE2D quarter layout pairs quarter
// i with quarter i^1, so the q rotation is one shuffle between neighbouring
// lanes. K/V stream through shared memory in 64-key tiles (K rotated on
// load); the softmax is online and in fp32, one key at a time. Keys past Nk
// take no part; keys with kv_mask == 0 get the logit -1e30, as in the plain
// version, so a row whose keys are all masked averages v uniformly.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;   // queries per block
constexpr int kBK = 64;   // keys per shared-memory tile
constexpr int kTPQ = 4;   // threads per query (one rotation quarter each)
constexpr int kThreads = kBQ * kTPQ;
constexpr unsigned kFull = 0xffffffffu;

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

template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads) flash_attn_fwd_kernel(const AttnParams p) {
  constexpr int DQ = D / 4;
  __shared__ __align__(16) float ks[kBK][D];
  __shared__ __align__(16) float vs[kBK][D];
  __shared__ unsigned char kstate[kBK];  // 1 = attend, 2 = masked (-1e30)

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int tid = threadIdx.x;
  const int part = tid % kTPQ;
  const int qrow = blockIdx.x * kBQ + tid / kTPQ;
  const int qload = min(qrow, p.Nq - 1);  // ragged tail: load a valid row, skip the store

  float qreg[DQ];
  const float* qptr = p.q + b * p.q_sb + h * p.q_sh + qload * p.q_sn + part * DQ;
#pragma unroll
  for (int i = 0; i < DQ; ++i) qreg[i] = qptr[i];
  if (ROPE) {
    const long long t = ((long long)b * p.Nq + qload) * D + part * DQ;
#pragma unroll
    for (int i = 0; i < DQ; ++i) {
      const float partner = __shfl_xor_sync(kFull, qreg[i], 1);
      const float rot = (part & 1) ? partner : -partner;
      qreg[i] = qreg[i] * p.qcos[t + i] + rot * p.qsin[t + i];
    }
  }

  float m = -INFINITY;
  float l = 0.f;
  float acc[DQ];
#pragma unroll
  for (int i = 0; i < DQ; ++i) acc[i] = 0.f;

  const float* kbase = p.k + b * p.k_sb + h * p.k_sh;
  const float* vbase = p.v + b * p.v_sb + h * p.v_sh;
  for (int k0 = 0; k0 < p.Nk; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D;
      const int c = e % D;
      const int key = k0 + j;
      float kval = 0.f, vval = 0.f;
      if (key < p.Nk) {
        const float* krow = kbase + key * p.k_sn;
        kval = krow[c];
        if (ROPE) {
          const int quarter = c / DQ;
          const float partner = krow[(quarter & 1) ? c - DQ : c + DQ];
          const float rot = (quarter & 1) ? partner : -partner;
          const long long t = ((long long)b * p.Nk + key) * D + c;
          kval = kval * p.kcos[t] + rot * p.ksin[t];
        }
        vval = vbase[key * p.v_sn + c];
      }
      ks[j][c] = kval;
      vs[j][c] = vval;
    }
    if (tid < kBK) {
      const int key = k0 + tid;
      kstate[tid] = (key < p.Nk && p.kv_mask != nullptr && !p.kv_mask[(long long)b * p.Nk + key]) ? 2 : 1;
    }
    __syncthreads();

    const int kend = min(kBK, p.Nk - k0);
    for (int j = 0; j < kend; ++j) {
      const float4* krow = reinterpret_cast<const float4*>(&ks[j][part * DQ]);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DQ / 4; ++i) {
        const float4 kk = krow[i];
        s += qreg[4 * i] * kk.x + qreg[4 * i + 1] * kk.y + qreg[4 * i + 2] * kk.z + qreg[4 * i + 3] * kk.w;
      }
      s += __shfl_xor_sync(kFull, s, 1);
      s += __shfl_xor_sync(kFull, s, 2);
      s = (kstate[j] == 1) ? s * p.scale : -1e30f;
      if (s > m) {
        const float corr = expf(m - s);
        l *= corr;
#pragma unroll
        for (int i = 0; i < DQ; ++i) acc[i] *= corr;
        m = s;
      }
      const float pj = expf(s - m);
      l += pj;
      const float4* vrow = reinterpret_cast<const float4*>(&vs[j][part * DQ]);
#pragma unroll
      for (int i = 0; i < DQ / 4; ++i) {
        const float4 vv = vrow[i];
        acc[4 * i] += pj * vv.x;
        acc[4 * i + 1] += pj * vv.y;
        acc[4 * i + 2] += pj * vv.z;
        acc[4 * i + 3] += pj * vv.w;
      }
    }
  }

  if (qrow < p.Nq) {
    const float inv = 1.f / l;
    float* optr = p.out + (((long long)b * p.H + h) * p.Nq + qrow) * D + part * DQ;
#pragma unroll
    for (int i = 0; i < DQ; ++i) optr[i] = acc[i] * inv;
  }
}

template <int D>
void launch(const AttnParams& p, bool rope, cudaStream_t stream) {
  const dim3 grid((p.Nq + kBQ - 1) / kBQ, p.B * p.H);
  if (rope) {
    flash_attn_fwd_kernel<D, true><<<grid, kThreads, 0, stream>>>(p);
  } else {
    flash_attn_fwd_kernel<D, false><<<grid, kThreads, 0, stream>>>(p);
  }
}

}  // namespace

// q [B, H, Nq, D], k/v [B, H, Nk, D] with unit stride on D and the given
// element strides; cos/sin [B, N, D] contiguous (all four null for no RoPE);
// kv_mask [B, Nk] bytes or null; out [B, H, Nq, D] contiguous. fp32 throughout.
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
  if (D == 64) {
    launch<64>(p, rope, stream);
  } else if (D == 32) {
    launch<32>(p, rope, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
