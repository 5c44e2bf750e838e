// Exact softmax attention over flattened heads, with the per-row
// logsumexp: out = softmax(q k^T * scale) v, lse = log sum exp(q k^T * scale),
// and its backward (dq, dk, dv) from the saved out and lse.
//
// Replaces attention_pallas
// (efficient_multimodal_perception_tpu/ops/pallas_kernels.py:
// attention_pallas; forward _attn_impl, _attn_kernel; backward _attn_bwd,
// _attn_bwd_dq_kernel, _attn_bwd_dkv_kernel).
//
// What bounds it on an H100: operations.  At the neck's shape (G = 4B
// groups, N = 4096 tokens, head dim 256) a forward does 4*G*N^2*hd flops
// (68.7 GFLOP at B=1) against 4*G*N*hd*2 bytes of q, k, v and out; the
// backward 10*G*Nq*Nk*hd (score and dP recomputed, dq, dk, dv).
//
// Forward design: the TPU kernel keeps all of K and V resident in VMEM and
// takes the (bq, N) f32 score tile in one piece.  A Hopper block cannot,
// so K/V stream through shared memory in 64-row tiles with an online
// softmax (flash-attention forward).  A block owns 64 queries of one
// group (4 warps, 16 rows each).  Scores and P @ V use wmma bf16
// 16x16x16 with f32 accumulators; P is rounded to bf16 before its
// product, as the TPU kernel rounds p.  With head dim 256 the f32 output
// accumulator is 16 x 256 per warp, so it lives in shared memory (64 KB
// for the block) and is rescaled there; the block uses 190 KB, one block
// per SM.  A head dim that is a multiple of 8 but not of 16 (the MAE
// decoders' 24) is zero-padded to the next multiple of 16 in shared
// memory only; rows are still read with 16-byte loads.
//
// Backward design: two kernels, as on the TPU, each recomputing
// P = exp(s - lse) from the saved logsumexp so no score tensor reaches
// device memory.  The dq kernel owns 64 queries and streams K/V tiles;
// the dk/dv kernel owns a tile of keys and streams 64-query tiles of Q and
// dO.  The TPU kernels hold all of K/V (or Q/dO) in VMEM; here they
// stream, and the f32 dq (or dk and dv) accumulators live in shared
// memory.  At head dim 256 a 64-row key tile's dk and dv accumulators
// alone would be 128 KB, so that instantiation owns 32 keys (2 warps) and
// streams 32-row K/V tiles in the dq kernel, keeping both under 200 KB.
// ds and p are rounded to bf16 before their products, as the TPU kernels
// round them.  The head dim is zero-padded in shared memory to HDP, a
// power of two >= 16.  Simple first: no cp.async pipeline, no wgmma.

#include <math.h>

#include "common.cuh"

using namespace nvcuda;

namespace emp {

constexpr int AT_BQ = 64;
constexpr int AT_BK = 64;
constexpr int AT_THREADS = 128;
constexpr int AT_LDS = AT_BK + 4;  // f32 score row stride
constexpr int AT_LDP = AT_BK + 8;  // bf16 probability row stride

inline int pad16(int hd) { return (hd + 15) / 16 * 16; }

inline size_t attention_smem_bytes(int hd) {
  const int hdp = pad16(hd);
  return (size_t)(AT_BQ + 2 * AT_BK) * (hdp + 8) * 2 +
         (size_t)AT_BQ * (hdp + 4) * 4 + 4 * 16 * AT_LDS * 4 +
         4 * 16 * AT_LDP * 2;
}

// Copy a (rows x hd) bf16 tile at row stride hd into shared memory at
// row stride ld with 16-byte vectors (hd % 8 == 0).
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int rows, int hd, int tid,
                                          int nthreads) {
  const int vpr = hd / 8;
  for (int t = tid; t < rows * vpr; t += nthreads) {
    const int r = t / vpr, c = (t % vpr) * 8;
    st16(dst + r * ld + c, ld16(src + (size_t)r * hd + c));
  }
}

// Two tiles of the same shape in one loop: both loads of an iteration
// are in flight together.
__device__ __forceinline__ void load_tile2(bf16* dst0, const bf16* src0,
                                           bf16* dst1, const bf16* src1,
                                           int ld, int rows, int hd, int tid,
                                           int nthreads) {
  const int vpr = hd / 8;
  for (int t = tid; t < rows * vpr; t += nthreads) {
    const int r = t / vpr, c = (t % vpr) * 8;
    const uint4 a = ld16(src0 + (size_t)r * hd + c);
    const uint4 b = ld16(src1 + (size_t)r * hd + c);
    st16(dst0 + r * ld + c, a);
    st16(dst1 + r * ld + c, b);
  }
}

// Zero columns [hd, hdp) of a (rows x ld) bf16 tile.
__device__ __forceinline__ void zero_pad_cols(bf16* dst, int ld, int rows,
                                              int hd, int hdp, int tid,
                                              int nthreads) {
  const int w = hdp - hd;
  for (int t = tid; t < rows * w; t += nthreads)
    dst[(t / w) * ld + hd + t % w] = __float2bfloat16(0.f);
}

__global__ void __launch_bounds__(AT_THREADS) attention_fwd_kernel(
    const bf16* __restrict__ q,  // (G, Nq, hd)
    const bf16* __restrict__ k,  // (G, Nk, hd)
    const bf16* __restrict__ v,  // (G, Nk, hd)
    bf16* __restrict__ out,      // (G, Nq, hd)
    float* __restrict__ lse,     // (G, Nq)
    int Nq, int Nk, int hd, float scale) {
  extern __shared__ __align__(32) unsigned char smem[];
  const int hdp = (hd + 15) / 16 * 16;  // head dim, zero-padded
  const int ldh = hdp + 8;  // bf16 row stride of the Q/K/V tiles
  const int ldo = hdp + 4;  // f32 row stride of O
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + AT_BQ * ldh;
  bf16* vs = ks + AT_BK * ldh;
  float* os = reinterpret_cast<float*>(vs + AT_BK * ldh);
  float* ss = os + AT_BQ * ldo;
  bf16* ps = reinterpret_cast<bf16*>(ss + 4 * 16 * AT_LDS);

  const int g = blockIdx.y, q0 = blockIdx.x * AT_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* qg = q + ((size_t)g * Nq + q0) * hd;
  const bf16* kg = k + (size_t)g * Nk * hd;
  const bf16* vg = v + (size_t)g * Nk * hd;
  load_tile(qs, ldh, qg, AT_BQ, hd, tid, AT_THREADS);
  if (hdp != hd) {
    zero_pad_cols(qs, ldh, AT_BQ, hd, hdp, tid, AT_THREADS);
    zero_pad_cols(ks, ldh, AT_BK, hd, hdp, tid, AT_THREADS);
    zero_pad_cols(vs, ldh, AT_BK, hd, hdp, tid, AT_THREADS);
  }
  for (int t = tid; t < AT_BQ * hdp; t += AT_THREADS)
    os[(t / hdp) * ldo + t % hdp] = 0.f;

  // two lanes per query row, each owning 32 of the tile's 64 columns
  const int prow = lane >> 1, half = lane & 1;
  float m_run = -INFINITY, l_run = 0.f;
  float* sw = ss + warp * 16 * AT_LDS;
  bf16* pw = ps + warp * 16 * AT_LDP;
  float* ow = os + warp * 16 * ldo;
  const bf16* qw = qs + warp * 16 * ldh;
  __syncthreads();

  for (int k0 = 0; k0 < Nk; k0 += AT_BK) {
    load_tile2(ks, kg + (size_t)k0 * hd, vs, vg + (size_t)k0 * hd, ldh,
               AT_BK, hd, tid, AT_THREADS);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int j = 0; j < AT_BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
      for (int d = 0; d < hdp; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, qw + d, ldh);
        wmma::load_matrix_sync(b, ks + 16 * j * ldh + d, ldh);
        wmma::mma_sync(s, a, b, s);
      }
      wmma::store_matrix_sync(sw + 16 * j, s, AT_LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile
    float* srow = sw + prow * AT_LDS + half * 32;
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      srow[c] *= scale;
      mx = fmaxf(mx, srow[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
    bf16* prow_p = pw + prow * AT_LDP + half * 32;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = expf(srow[c] - m_new);
      sum += p;
      prow_p[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    float* orow = ow + prow * ldo;
    for (int c = half; c < hdp; c += 2) orow[c] *= alpha;
    __syncwarp();

    // O += P V
    for (int j = 0; j < hdp / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, ow + 16 * j, ldo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < AT_BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, pw + kk, AT_LDP);
        wmma::load_matrix_sync(b, vs + kk * ldh + 16 * j, ldh);
        wmma::mma_sync(o, a, b, o);
      }
      wmma::store_matrix_sync(ow + 16 * j, o, ldo, wmma::mem_row_major);
    }
    __syncthreads();
  }

  __syncwarp();
  const float inv = 1.f / l_run;
  const float* orow = ow + prow * ldo;
  const size_t qi = (size_t)g * Nq + q0 + warp * 16 + prow;
  bf16* og = out + qi * hd;
  for (int c = half * 8; c < hd; c += 16) {
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = orow[c + i] * inv;
    st16(og + c, pack8(f));
  }
  if (half == 0) lse[qi] = m_run + logf(l_run);
}


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <int HDP>
struct AttnBwd {
  static constexpr int LDH = HDP + 8;  // bf16 row stride of q/k/v/dO tiles
  static constexpr int LDA = HDP + 4;  // f32 row stride of accumulators
  static constexpr int BKV = HDP >= 256 ? 32 : 64;  // dq: K/V tile rows
  static constexpr int BKT = HDP >= 256 ? 32 : 64;  // dk/dv: keys per block
  static constexpr int BQS = 64;                    // dk/dv: Q/dO tile rows
};

template <int HDP>
constexpr size_t dq_smem_bytes() {
  using T = AttnBwd<HDP>;
  return (size_t)(2 * AT_BQ + 2 * T::BKV) * T::LDH * 2 +
         (size_t)AT_BQ * T::LDA * 4 + (size_t)2 * 4 * 16 * (T::BKV + 4) * 4 +
         (size_t)4 * 16 * (T::BKV + 8) * 2;
}

template <int HDP>
constexpr size_t dkv_smem_bytes() {
  using T = AttnBwd<HDP>;
  constexpr int NW = T::BKT / 16;
  return (size_t)(2 * T::BKT + 2 * T::BQS) * T::LDH * 2 +
         (size_t)2 * T::BKT * T::LDA * 4 +
         (size_t)2 * NW * 16 * (T::BQS + 4) * 4 +
         (size_t)2 * NW * 16 * (T::BQS + 8) * 2 + (size_t)2 * T::BQS * 4;
}

// dq for 64 queries: recompute s = q k^T and dp = dO v^T per K/V tile,
// ds = p * (dp - D) * scale with p = exp(s * scale - lse), dq += ds K.
template <int HDP>
__global__ void __launch_bounds__(AT_THREADS) attention_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse,  // (G, Nq)
    const float* __restrict__ D,    // (G, Nq) rowsum(dO * O)
    bf16* __restrict__ dq, int Nq, int Nk, int hd, float scale) {
  using T = AttnBwd<HDP>;
  constexpr int LDH = T::LDH, LDA = T::LDA, BKV = T::BKV;
  constexpr int LDS = BKV + 4, LDP = BKV + 8;
  extern __shared__ __align__(32) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + AT_BQ * LDH;
  bf16* ks = dos + AT_BQ * LDH;
  bf16* vs = ks + BKV * LDH;
  float* acc = reinterpret_cast<float*>(vs + BKV * LDH);
  float* ss = acc + AT_BQ * LDA;
  float* dps = ss + 4 * 16 * LDS;
  bf16* dss = reinterpret_cast<bf16*>(dps + 4 * 16 * LDS);

  const int g = blockIdx.y, q0 = blockIdx.x * AT_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t qrow0 = (size_t)g * Nq + q0;
  load_tile2(qs, q + qrow0 * hd, dos, dout + qrow0 * hd, LDH, AT_BQ, hd,
             tid, AT_THREADS);
  if (hd != HDP) {
    zero_pad_cols(qs, LDH, AT_BQ, hd, HDP, tid, AT_THREADS);
    zero_pad_cols(dos, LDH, AT_BQ, hd, HDP, tid, AT_THREADS);
    zero_pad_cols(ks, LDH, BKV, hd, HDP, tid, AT_THREADS);
    zero_pad_cols(vs, LDH, BKV, hd, HDP, tid, AT_THREADS);
  }
  for (int t = tid; t < AT_BQ * HDP; t += AT_THREADS)
    acc[(t / HDP) * LDA + t % HDP] = 0.f;

  const int prow = lane >> 1, half = lane & 1;
  const size_t qi = qrow0 + warp * 16 + prow;
  const float lse_r = lse[qi], d_r = D[qi];
  float* sw = ss + warp * 16 * LDS;
  float* dpw = dps + warp * 16 * LDS;
  bf16* dsw = dss + warp * 16 * LDP;
  float* aw = acc + warp * 16 * LDA;
  const bf16* qw = qs + warp * 16 * LDH;
  const bf16* dow = dos + warp * 16 * LDH;
  const bf16* kg = k + (size_t)g * Nk * hd;
  const bf16* vg = v + (size_t)g * Nk * hd;
  __syncthreads();

  for (int k0 = 0; k0 < Nk; k0 += BKV) {
    load_tile2(ks, kg + (size_t)k0 * hd, vs, vg + (size_t)k0 * hd, LDH, BKV,
               hd, tid, AT_THREADS);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s, dp;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(dp, 0.f);
#pragma unroll
      for (int d = 0; d < HDP; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, qw + d, LDH);
        wmma::load_matrix_sync(b, ks + 16 * j * LDH + d, LDH);
        wmma::mma_sync(s, a, b, s);
        wmma::load_matrix_sync(a, dow + d, LDH);
        wmma::load_matrix_sync(b, vs + 16 * j * LDH + d, LDH);
        wmma::mma_sync(dp, a, b, dp);
      }
      wmma::store_matrix_sync(sw + 16 * j, s, LDS, wmma::mem_row_major);
      wmma::store_matrix_sync(dpw + 16 * j, dp, LDS, wmma::mem_row_major);
    }
    __syncwarp();
    for (int c = half * (BKV / 2); c < (half + 1) * (BKV / 2); ++c) {
      const float p = expf(sw[prow * LDS + c] * scale - lse_r);
      dsw[prow * LDP + c] =
          __float2bfloat16(p * (dpw[prow * LDS + c] - d_r) * scale);
    }
    __syncwarp();
#pragma unroll 4
    for (int jd = 0; jd < HDP / 16; ++jd) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, aw + 16 * jd, LDA, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, dsw + kk, LDP);
        wmma::load_matrix_sync(b, ks + kk * LDH + 16 * jd, LDH);
        wmma::mma_sync(o, a, b, o);
      }
      wmma::store_matrix_sync(aw + 16 * jd, o, LDA, wmma::mem_row_major);
    }
    __syncthreads();
  }

  const float* arow = aw + prow * LDA;
  bf16* dg = dq + qi * hd;
  for (int c = half * 8; c < hd; c += 16) {
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = arow[c + i];
    st16(dg + c, pack8(f));
  }
}

// dk, dv for BKT keys: per 64-query tile recompute s^T = k q^T and
// dp^T = v dO^T, p^T = exp(s^T * scale - lse), ds^T = p^T (dp^T - D) * scale,
// then dv += p^T dO and dk += ds^T Q.
template <int HDP>
__global__ void __launch_bounds__(2 * AttnBwd<HDP>::BKT)
    attention_bwd_dkv_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ D,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int Nq, int Nk, int hd, float scale) {
  using T = AttnBwd<HDP>;
  constexpr int LDH = T::LDH, LDA = T::LDA, BKT = T::BKT, BQS = T::BQS;
  constexpr int NW = BKT / 16, NT = 32 * NW;
  constexpr int LDS = BQS + 4, LDP = BQS + 8;
  extern __shared__ __align__(32) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BKT * LDH;
  bf16* qs = vs + BKT * LDH;
  bf16* dos = qs + BQS * LDH;
  float* dka = reinterpret_cast<float*>(dos + BQS * LDH);
  float* dva = dka + BKT * LDA;
  float* sts = dva + BKT * LDA;
  float* dpts = sts + NW * 16 * LDS;
  bf16* pts = reinterpret_cast<bf16*>(dpts + NW * 16 * LDS);
  bf16* dsts = pts + NW * 16 * LDP;
  float* lse_s = reinterpret_cast<float*>(dsts + NW * 16 * LDP);
  float* d_s = lse_s + BQS;

  const int g = blockIdx.y, kt0 = blockIdx.x * BKT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t krow0 = (size_t)g * Nk + kt0;
  load_tile2(ks, k + krow0 * hd, vs, v + krow0 * hd, LDH, BKT, hd, tid, NT);
  if (hd != HDP) {
    zero_pad_cols(ks, LDH, BKT, hd, HDP, tid, NT);
    zero_pad_cols(vs, LDH, BKT, hd, HDP, tid, NT);
    zero_pad_cols(qs, LDH, BQS, hd, HDP, tid, NT);
    zero_pad_cols(dos, LDH, BQS, hd, HDP, tid, NT);
  }
  for (int t = tid; t < BKT * HDP; t += NT) {
    dka[(t / HDP) * LDA + t % HDP] = 0.f;
    dva[(t / HDP) * LDA + t % HDP] = 0.f;
  }

  const int prow = lane >> 1, half = lane & 1;
  const bf16* kw = ks + warp * 16 * LDH;
  const bf16* vw = vs + warp * 16 * LDH;
  float* stw = sts + warp * 16 * LDS;
  float* dptw = dpts + warp * 16 * LDS;
  bf16* ptw = pts + warp * 16 * LDP;
  bf16* dstw = dsts + warp * 16 * LDP;
  float* dkw = dka + warp * 16 * LDA;
  float* dvw = dva + warp * 16 * LDA;
  const bf16* qg = q + (size_t)g * Nq * hd;
  const bf16* dog = dout + (size_t)g * Nq * hd;

  for (int q0 = 0; q0 < Nq; q0 += BQS) {
    load_tile2(qs, qg + (size_t)q0 * hd, dos, dog + (size_t)q0 * hd, LDH, BQS,
               hd, tid, NT);
    for (int t = tid; t < BQS; t += NT) {
      lse_s[t] = lse[(size_t)g * Nq + q0 + t];
      d_s[t] = D[(size_t)g * Nq + q0 + t];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BQS / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s, dp;
      wmma::fill_fragment(s, 0.f);
      wmma::fill_fragment(dp, 0.f);
#pragma unroll
      for (int d = 0; d < HDP; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, kw + d, LDH);
        wmma::load_matrix_sync(b, qs + 16 * j * LDH + d, LDH);
        wmma::mma_sync(s, a, b, s);
        wmma::load_matrix_sync(a, vw + d, LDH);
        wmma::load_matrix_sync(b, dos + 16 * j * LDH + d, LDH);
        wmma::mma_sync(dp, a, b, dp);
      }
      wmma::store_matrix_sync(stw + 16 * j, s, LDS, wmma::mem_row_major);
      wmma::store_matrix_sync(dptw + 16 * j, dp, LDS, wmma::mem_row_major);
    }
    __syncwarp();
    for (int c = half * (BQS / 2); c < (half + 1) * (BQS / 2); ++c) {
      const float p = expf(stw[prow * LDS + c] * scale - lse_s[c]);
      ptw[prow * LDP + c] = __float2bfloat16(p);
      dstw[prow * LDP + c] =
          __float2bfloat16(p * (dptw[prow * LDS + c] - d_s[c]) * scale);
    }
    __syncwarp();
#pragma unroll 4
    for (int jd = 0; jd < HDP / 16; ++jd) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> ov, ok;
      wmma::load_matrix_sync(ov, dvw + 16 * jd, LDA, wmma::mem_row_major);
      wmma::load_matrix_sync(ok, dkw + 16 * jd, LDA, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BQS; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, ptw + kk, LDP);
        wmma::load_matrix_sync(b, dos + kk * LDH + 16 * jd, LDH);
        wmma::mma_sync(ov, a, b, ov);
        wmma::load_matrix_sync(a, dstw + kk, LDP);
        wmma::load_matrix_sync(b, qs + kk * LDH + 16 * jd, LDH);
        wmma::mma_sync(ok, a, b, ok);
      }
      wmma::store_matrix_sync(dvw + 16 * jd, ov, LDA, wmma::mem_row_major);
      wmma::store_matrix_sync(dkw + 16 * jd, ok, LDA, wmma::mem_row_major);
    }
    __syncthreads();
  }

  const size_t ki = krow0 + warp * 16 + prow;
  for (int c = half * 8; c < hd; c += 16) {
    float fk[8], fv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      fk[i] = dkw[prow * LDA + c + i];
      fv[i] = dvw[prow * LDA + c + i];
    }
    st16(dk + ki * hd + c, pack8(fk));
    st16(dv + ki * hd + c, pack8(fv));
  }
}

template <int HDP>
int launch_attention_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* D,
                         void* dq, void* dk, void* dv, int G, int Nq, int Nk,
                         int hd, float scale, cudaStream_t s) {
  using T = AttnBwd<HDP>;
  const size_t sq = dq_smem_bytes<HDP>(), skv = dkv_smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)skv);
  if (err != cudaSuccess) return (int)err;
  const bf16 *q_ = (const bf16*)q, *k_ = (const bf16*)k, *v_ = (const bf16*)v,
             *do_ = (const bf16*)dout;
  attention_bwd_dq_kernel<HDP><<<dim3(Nq / AT_BQ, G), AT_THREADS, sq, s>>>(
      q_, k_, v_, do_, (const float*)lse, (const float*)D, (bf16*)dq, Nq, Nk,
      hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_kernel<HDP>
      <<<dim3(Nk / T::BKT, G), 2 * T::BKT, skv, s>>>(
          q_, k_, v_, do_, (const float*)lse, (const float*)D, (bf16*)dk,
          (bf16*)dv, Nq, Nk, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace emp

extern "C" {

// Shapes: Nq % 64 == 0, Nk % 64 == 0, hd % 8 == 0, hd <= 256.
int emp_attention_fwd(const void* q, const void* k, const void* v, void* out,
                      void* lse, int G, int Nq, int Nk, int hd, float scale,
                      void* stream) {
  const size_t smem = emp::attention_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      emp::attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Nq / emp::AT_BQ, G);
  emp::attention_fwd_kernel<<<grid, emp::AT_THREADS, smem,
                              (cudaStream_t)stream>>>(
      (const emp::bf16*)q, (const emp::bf16*)k, (const emp::bf16*)v,
      (emp::bf16*)out, (float*)lse, Nq, Nk, hd, scale);
  return (int)cudaGetLastError();
}

// dq, dk, dv from q, k, v, dO, the forward's lse and D = rowsum(dO * O)
// (both (G, Nq) f32).  Shapes as for the forward.
int emp_attention_bwd(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* D,
                      void* dq, void* dk, void* dv, int G, int Nq, int Nk,
                      int hd, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 16)
    return emp::launch_attention_bwd<16>(q, k, v, dout, lse, D, dq, dk, dv, G, Nq, Nk, hd, scale, s);
  if (hd <= 32)
    return emp::launch_attention_bwd<32>(q, k, v, dout, lse, D, dq, dk, dv, G, Nq, Nk, hd, scale, s);
  if (hd <= 64)
    return emp::launch_attention_bwd<64>(q, k, v, dout, lse, D, dq, dk, dv, G, Nq, Nk, hd, scale, s);
  if (hd <= 128)
    return emp::launch_attention_bwd<128>(q, k, v, dout, lse, D, dq, dk, dv, G, Nq, Nk, hd, scale, s);
  if (hd <= 256)
    return emp::launch_attention_bwd<256>(q, k, v, dout, lse, D, dq, dk, dv, G, Nq, Nk, hd, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
