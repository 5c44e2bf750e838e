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
// All three kernels are built from the GEMM family's primitives
// (gemm_sm90.cuh): 3-D TMA maps over (G, N, hd) whose 128-byte-swizzled
// boxes are 64 head-dim columns by a tile of rows, an mbarrier ring fed
// by one thread of a producer warpgroup, and wgmma on two consumer
// warpgroups of 64 rows each (384 threads; setmaxnreg moves registers
// from the producer to the consumers).  The head dim is padded to HDP
// (64, 128 or 256) by TMA's zero fill, so any hd % 8 == 0 up to 256 is
// taken; the score products run only ceil(hd / 16) k16 steps.  Row tiles
// past N are zero-filled by the 3-D map (never the next group's rows)
// and their results not stored.
//
// Forward (flash-attention): a block owns 128 queries of one group and
// streams K and V tiles of BN keys (64 at HDP 256, else 128) through a
// ring (K and V on separate barriers, so S = Q K^T starts before V has
// landed).  S is an SS wgmma with both operands K-major; the online
// softmax runs in registers on the accumulator layout (a row's max and
// sum reduce over the 4 lanes of a quad, in base 2 with scale * log2(e)
// folded in); P is rounded to bf16 (as _attn_kernel rounds p) straight
// into wgmma A fragments, since a 64 x 16 slice of the f32 accumulator
// has the A fragment's layout, and O += P V is an RS wgmma with V read
// MN-major.  O (64 x HDP f32) stays in registers: 128 a
// thread at HDP 256.  out = O / l is rounded once; lse = m + log(l) in
// natural log of the scaled scores, as B6 and the twin read it.
//
// Backward: a row pass forms D = rowsum(dO * O) (the JAX package forms
// it in XLA), then two kernels, as on the TPU, each recompute
// P = exp(s * scale - lse):
// - dq: a block owns 128 queries (Q, dO resident) and streams K / V tiles
//   of BN keys (32 at HDP 256, else 64): S = Q K^T and dP = dO V^T (SS),
//   dS = P (dP - D) scale rounded to bf16 into A fragments, dq += dS K
//   (RS, K read MN-major from the tile that fed S).
// - dk / dv: a block owns 64 keys (K, V resident) and streams 64-query
//   tiles of Q and dO with their lse and D; warpgroup c computes S^T and
//   dP^T for the tile's queries 32c .. 32c + 31 (m64n32, full head-dim
//   contraction) and forms P^T and dS^T (bf16-rounded, as
//   _attn_bwd_dkv_kernel does).  dk and dv of 64 keys are 2 x HDP / 2
//   f32 registers a thread, too many at HDP 256, so:
//   - HDP <= 128: each warpgroup accumulates dk and dv over its own
//     queries with P^T / dS^T straight from registers (RS, dO and Q read
//     MN-major), and the two partial sums are added once at the end
//     through shared memory;
//   - HDP 256: warpgroup c accumulates only head-dim columns 128c ..
//     128c + 127 of dk and dv (128 registers); the two write P^T and dS^T
//     into swizzled 64 x 64 K-major tiles in shared memory and, after a
//     barrier, each multiplies the whole tiles (SS).  That costs 16 KB
//     and two barriers a tile, not a recomputed score product.
// Nothing is accumulated with atomics: each output element is summed by
// one thread (or two partials added) in a fixed order, so two calls give
// the same bits.

#include <math.h>

#include "gemm_sm90.cuh"

namespace emp {

constexpr int AT_BQ = 128;           // query rows a block
constexpr int AT_THREADS = 128 * 3;  // two consumer WGs + a producer WG
constexpr float AT_LOG2E = 1.4426950408889634f;
constexpr float AT_LN2 = 0.6931471805599453f;

// Tile plans (ops/kernels.attention_plan mirrors them).
template <int HDP>
struct FwdPlan {
  static constexpr int BN = HDP >= 256 ? 64 : 128;  // keys a tile
  static constexpr int STAGES = HDP >= 128 ? 2 : 3;
  static constexpr int Q_BYTES = AT_BQ * HDP * 2;
  static constexpr int KV_BYTES = BN * HDP * 2;  // each of K and V
  static constexpr int SMEM =
      Q_BYTES + STAGES * 2 * KV_BYTES + 1024 + 8 * (1 + 3 * STAGES);
};

template <int HDP>
struct DqPlan {
  static constexpr int BN = HDP >= 256 ? 32 : 64;
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = AT_BQ * HDP * 2;  // each of Q and dO
  static constexpr int KV_BYTES = BN * HDP * 2;
  static constexpr int SMEM =
      2 * Q_BYTES + STAGES * 2 * KV_BYTES + 1024 + 8 * (1 + 2 * STAGES);
};

template <int HDP>
struct DkvPlan {
  // HDP 256: the warpgroups split the head dim of dk / dv and exchange
  // P^T / dS^T through shared memory; else they split the queries and
  // sum their partial dk / dv once at the end
  static constexpr bool SPLIT_HD = HDP >= 256;
  static constexpr int BN = 64;  // keys a block
  static constexpr int BM = 64;  // queries a tile
  static constexpr int STAGES = 2;
  static constexpr int KV_BYTES = BN * HDP * 2;  // each of K and V
  static constexpr int QT_BYTES = BM * HDP * 2;  // each of Q and dO
  static constexpr int LD_BYTES = 2 * BM * 4;    // lse and D
  static constexpr int PT_BYTES = SPLIT_HD ? BN * BM * 2 : 0;  // P^T, dS^T
  static constexpr int SMEM = 2 * KV_BYTES + STAGES * (2 * QT_BYTES + LD_BYTES) +
                              2 * PT_BYTES + 1024 + 8 * (1 + 2 * STAGES);
};

// The producer warpgroup gives registers to the consumers: 24 + 2 x 240
// a thread of the 512 a warpgroup-triple may hold (65536 / 128), so a
// consumer keeps its 64 x 256 f32 accumulator and a score tile without
// spilling (the launch bound alone allows 168).
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

struct AttnMaps {
  CUtensorMap a, b, c, d;
};

__device__ __forceinline__ unsigned char* align1k(unsigned char* raw) {
  const uint32_t r = smem_u32(raw);
  return raw + (((r + 1023) & ~1023u) - r);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x (the softmax's exponent; -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Both rows' values of a quad reduced over its 4 lanes.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int N>
__device__ __forceinline__ void zero_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
  fence_acc<N>(d);
}

// d (64 x BN) = [d +] A . B^T (scale_d 0: d's old value ignored), both
// K-major in shared memory.
template <int BN>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d = 1) {
  static_assert(BN == 32 || BN == 64 || BN == 128, "score tile width");
  if constexpr (BN == 32)
    wgmma_n32<0, 0>(d, da, db, scale_d);
  else if constexpr (BN == 64)
    wgmma_n64<0, 0>(d, da, db, scale_d);
  else
    wgmma_n128<0, 0>(d, da, db, scale_d);
}

// d (64 x N) += A (registers) . B, B MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "head-dim width");
  if constexpr (N == 64)
    wgmma_rs_n64<1>(d, a, db);
  else if constexpr (N == 128)
    wgmma_rs_n128<1>(d, a, db);
  else
    wgmma_rs_n256<1>(d, a, db);
}

// The A fragments of the BN / 16 k16 slices of a 64 x BN accumulator:
// slice kb is d[8kb .. 8kb + 7] as (row r, cols 0-1), (row r + 8, cols
// 0-1), (row r, cols 8-9), (row r + 8, cols 8-9), bf16 pairs.
template <int BN>
__device__ __forceinline__ void to_frags(const float* d, uint32_t (*f)[4]) {
#pragma unroll
  for (int kb = 0; kb < BN / 16; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f[kb][r] = pack_bf16(d[8 * kb + 2 * r], d[8 * kb + 2 * r + 1]);
}

// A 64 x HDP f32 accumulator (rows row0 + 16 * warp + lane / 4 + 8h,
// cols 8j + 2 * (lane % 4)) times mul[h], rounded to bf16 and stored to
// row-major dst of row stride hd; rows >= nrows and cols >= hd skipped.
template <int HDP>
__device__ __forceinline__ void store_rows(const float* d, const float* mul,
                                           bf16* dst, int row0, int nrows,
                                           int col0, int hd, int t) {
  const int lane = t & 31, r = row0 + 16 * (t >> 5) + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= nrows) continue;
    bf16* p = dst + (size_t)row * hd;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = col0 + 8 * j + 2 * (lane & 3);
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(
            d[4 * j + 2 * h] * mul[h], d[4 * j + 2 * h + 1] * mul[h]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Issue S (64 x BN) = Q (this warpgroup's 64 rows) . K^T over ks k16
// steps and commit, without waiting; the first step overwrites sc
// (scale_d 0).
template <int HDP, int BN>
__device__ __forceinline__ void fwd_scores(float* sc, const bf16* sq,
                                           const bf16* sk, int c, int ks) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    if (kk < ks)
      wgmma_ss<BN>(sc,
                   smem_desc(sq + (kk / 4) * AT_BQ * 64 + c * 64 * 64 +
                             (kk % 4) * 16),
                   smem_desc(sk + (kk / 4) * BN * 64 + (kk % 4) * 16),
                   kk > 0);
  wgmma_commit();
}

// The online softmax (base 2) of one tile of raw scores sc: the running
// max m and sum l of both rows updated, alpha = the factor the earlier
// output is rescaled by, P rounded to bf16 into A fragments.  Keys from
// `valid` on (a ragged last tile) are masked.
template <int BN>
__device__ __forceinline__ void fwd_softmax(float* sc, float* m, float* l,
                                            float* alpha, uint32_t (*pf)[4],
                                            float sl2, int valid, int lane) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    float v = sc[i] * sl2;
    if (valid < BN && 8 * (i / 4) + 2 * (lane & 3) + (i & 1) >= valid)
      v = -INFINITY;
    sc[i] = v;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    alpha[h] = ex2(m[h] - mx[h]);
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const float p = ex2(sc[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += p;
    sc[i] = p;
  }
  to_frags<BN>(sc, pf);
}

// Keep A fragments live (their registers unreused) until here: a wgmma
// reads them asynchronously, after the instruction that names them.
template <int BN>
__device__ __forceinline__ void fence_frags(uint32_t (*f)[4]) {
#pragma unroll
  for (int kb = 0; kb < BN / 16; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[kb][r])::"memory");
}

// maps: a = q (box 128 rows), b = k, c = v (box BN rows).
template <int HDP>
__global__ void __launch_bounds__(AT_THREADS, 1)
    attention_fwd_kernel(const __grid_constant__ AttnMaps maps,
                         bf16* __restrict__ out, float* __restrict__ lse,
                         int Nq, int Nk, int hd, float scale) {
  using P = FwdPlan<HDP>;
  constexpr int BN = P::BN, ST = P::STAGES, BOX = HDP / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1k(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* skv = reinterpret_cast<bf16*>(smem + P::Q_BYTES);  // [ST][K | V]
  uint64_t* full_q = reinterpret_cast<uint64_t*>(
      smem + P::Q_BYTES + ST * 2 * P::KV_BYTES);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty = full_v + ST;

  const int g = blockIdx.y, q0 = blockIdx.x * AT_BQ;
  const int nt = Nk / BN + (Nk % BN ? 1 : 0);
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup: one thread loads
    producer_regs();
    if (threadIdx.x == 256) {
      mbar_expect_tx(full_q, P::Q_BYTES);
#pragma unroll
      for (int b = 0; b < BOX; ++b)
        tma_load_3d(sq + b * AT_BQ * 64, &maps.a, full_q, 64 * b, q0, g);
      for (int j = 0; j < nt; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(&empty[s], ((j / ST) - 1) & 1);
        bf16* sk = skv + s * 2 * (BN * HDP);
        bf16* sv = sk + BN * HDP;
        mbar_expect_tx(&full_k[s], P::KV_BYTES);
#pragma unroll
        for (int b = 0; b < BOX; ++b)
          tma_load_3d(sk + b * BN * 64, &maps.b, &full_k[s], 64 * b, j * BN, g);
        mbar_expect_tx(&full_v[s], P::KV_BYTES);
#pragma unroll
        for (int b = 0; b < BOX; ++b)
          tma_load_3d(sv + b * BN * 64, &maps.c, &full_v[s], 64 * b, j * BN, g);
      }
    }
    return;
  }

  consumer_regs();
  const int c = threadIdx.x >> 7, t = threadIdx.x & 127, lane = t & 31;
  const int ks = (hd + 15) / 16;  // k16 steps of the score product
  const float sl2 = scale * AT_LOG2E;
  float o[HDP / 2];
  zero_acc<HDP / 2>(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(full_q, 0);

  float sc[BN / 2], alpha[2];
  uint32_t pf[BN / 16][4];
  for (int j = 0; j < nt; ++j) {
    const int s = j % ST, ph = (j / ST) & 1;
    const bf16* sk = skv + s * 2 * (BN * HDP);
    mbar_wait(&full_k[s], ph);
    fwd_scores<HDP, BN>(sc, sq, sk, c, ks);
    wgmma_wait<0>();
    fence_acc<BN / 2>(sc);
    fwd_softmax<BN>(sc, m, l, alpha, pf, sl2, Nk - j * BN, lane);
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    mbar_wait(&full_v[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb)
      wgmma_rs<HDP>(o, pf[kb], smem_desc_mn(sk + BN * HDP + kb * 16 * 64,
                                            BN * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<HDP / 2>(o);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  float inv[2];
  const size_t grow = (size_t)g * Nq;
  const int r = q0 + 64 * c + 16 * (t >> 5) + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = quad_sum(l[h]);
    inv[h] = 1.f / lt;
    if ((lane & 3) == 0 && r + 8 * h < Nq)
      lse[grow + r + 8 * h] = (m[h] + log2f(lt)) * AT_LN2;
  }
  store_rows<HDP>(o, inv, out + grow * hd, q0 + 64 * c, Nq, 0, hd, t);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// dq for 128 queries.  maps: a = q, b = dO (box 128 rows), c = k, d = v
// (box BN rows).
template <int HDP>
__global__ void __launch_bounds__(AT_THREADS, 1)
    attention_bwd_dq_kernel(const __grid_constant__ AttnMaps maps,
                            const float* __restrict__ lse,
                            const float* __restrict__ D,
                            bf16* __restrict__ dq, int Nq, int Nk, int hd,
                            float scale) {
  using P = DqPlan<HDP>;
  constexpr int BN = P::BN, ST = P::STAGES, BOX = HDP / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1k(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + AT_BQ * HDP;
  bf16* skv = sdo + AT_BQ * HDP;  // [ST][K | V]
  uint64_t* full_q = reinterpret_cast<uint64_t*>(
      smem + 2 * P::Q_BYTES + ST * 2 * P::KV_BYTES);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + ST;

  const int g = blockIdx.y, q0 = blockIdx.x * AT_BQ, nt = Nk / BN;
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    producer_regs();
    if (threadIdx.x == 256) {
      mbar_expect_tx(full_q, 2 * P::Q_BYTES);
#pragma unroll
      for (int b = 0; b < BOX; ++b) {
        tma_load_3d(sq + b * AT_BQ * 64, &maps.a, full_q, 64 * b, q0, g);
        tma_load_3d(sdo + b * AT_BQ * 64, &maps.b, full_q, 64 * b, q0, g);
      }
      for (int j = 0; j < nt; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(&empty[s], ((j / ST) - 1) & 1);
        bf16* sk = skv + s * 2 * (BN * HDP);
        bf16* sv = sk + BN * HDP;
        mbar_expect_tx(&full[s], 2 * P::KV_BYTES);
#pragma unroll
        for (int b = 0; b < BOX; ++b) {
          tma_load_3d(sk + b * BN * 64, &maps.c, &full[s], 64 * b, j * BN, g);
          tma_load_3d(sv + b * BN * 64, &maps.d, &full[s], 64 * b, j * BN, g);
        }
      }
    }
    return;
  }

  consumer_regs();
  const int c = threadIdx.x >> 7, t = threadIdx.x & 127, lane = t & 31;
  const int ks = (hd + 15) / 16;
  const float sl2 = scale * AT_LOG2E;
  const size_t grow = (size_t)g * Nq;
  const int r = q0 + 64 * c + 16 * (t >> 5) + (lane >> 2);
  float lse2[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = r + 8 * h < Nq;
    lse2[h] = in ? lse[grow + r + 8 * h] * AT_LOG2E : 0.f;
    dr[h] = in ? D[grow + r + 8 * h] : 0.f;
  }
  float acc[HDP / 2];
  zero_acc<HDP / 2>(acc);
  mbar_wait(full_q, 0);

  for (int j = 0; j < nt; ++j) {
    const int s = j % ST, ph = (j / ST) & 1;
    const bf16* sk = skv + s * 2 * (BN * HDP);
    const bf16* sv = sk + BN * HDP;
    float sc[BN / 2], dp[BN / 2];
    zero_acc<BN / 2>(sc);
    zero_acc<BN / 2>(dp);
    mbar_wait(&full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      if (kk < ks) {
        const int qo = (kk / 4) * AT_BQ * 64 + c * 64 * 64 + (kk % 4) * 16;
        const int ko = (kk / 4) * BN * 64 + (kk % 4) * 16;
        wgmma_ss<BN>(sc, smem_desc(sq + qo), smem_desc(sk + ko));
        wgmma_ss<BN>(dp, smem_desc(sdo + qo), smem_desc(sv + ko));
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<BN / 2>(sc);
    fence_acc<BN / 2>(dp);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int h = (i >> 1) & 1;
      const float p = ex2(sc[i] * sl2 - lse2[h]);
      sc[i] = p * (dp[i] - dr[h]) * scale;
    }
    uint32_t df[BN / 16][4];
    to_frags<BN>(sc, df);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb)
      wgmma_rs<HDP>(acc, df[kb], smem_desc_mn(sk + kb * 16 * 64, BN * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<HDP / 2>(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<HDP>(acc, one, dq + grow * hd, q0 + 64 * c, Nq, 0, hd, t);
}

// dk, dv for 64 keys.  maps: a = k, b = v, c = q, d = dO (box 64 rows).
template <int HDP>
__global__ void __launch_bounds__(AT_THREADS, 1)
    attention_bwd_dkv_kernel(const __grid_constant__ AttnMaps maps,
                             const float* __restrict__ lse,
                             const float* __restrict__ D,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int Nq, int Nk, int hd, float scale) {
  using P = DkvPlan<HDP>;
  constexpr int BN = P::BN, BM = P::BM, ST = P::STAGES, BOX = HDP / 64;
  constexpr bool SPLIT_HD = P::SPLIT_HD;
  // head-dim columns of dk / dv a warpgroup accumulates
  constexpr int ACC = SPLIT_HD ? HDP / 2 : HDP;
  static_assert(ACC % 64 == 0, "a warpgroup's columns are whole boxes");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1k(smem_raw);
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + BN * HDP;
  bf16* spt = sv + BN * HDP;  // P^T (64 keys x 64 queries, K-major)
  bf16* sdst = spt + BN * BM;  // dS^T (SPLIT_HD only)
  unsigned char* ring = smem + 2 * P::KV_BYTES + 2 * P::PT_BYTES;
  constexpr int STAGE = 2 * P::QT_BYTES + P::LD_BYTES;
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(ring + ST * STAGE);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + ST;

  const int g = blockIdx.y, k0 = blockIdx.x * BN, nt = Nq / BM;
  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    producer_regs();
    if (threadIdx.x == 256) {
      mbar_expect_tx(full_kv, 2 * P::KV_BYTES);
#pragma unroll
      for (int b = 0; b < BOX; ++b) {
        tma_load_3d(sk + b * BN * 64, &maps.a, full_kv, 64 * b, k0, g);
        tma_load_3d(sv + b * BN * 64, &maps.b, full_kv, 64 * b, k0, g);
      }
      for (int j = 0; j < nt; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(&empty[s], ((j / ST) - 1) & 1);
        bf16* sq = reinterpret_cast<bf16*>(ring + s * STAGE);
        bf16* sdo = sq + BM * HDP;
        float* sl = reinterpret_cast<float*>(sdo + BM * HDP);
        mbar_expect_tx(&full[s], STAGE);
#pragma unroll
        for (int b = 0; b < BOX; ++b) {
          tma_load_3d(sq + b * BM * 64, &maps.c, &full[s], 64 * b, j * BM, g);
          tma_load_3d(sdo + b * BM * 64, &maps.d, &full[s], 64 * b, j * BM, g);
        }
        const size_t row = (size_t)g * Nq + j * BM;
        bulk_load(sl, lse + row, BM * 4, &full[s]);
        bulk_load(sl + BM, D + row, BM * 4, &full[s]);
      }
    }
    return;
  }

  consumer_regs();
  const int c = threadIdx.x >> 7, t = threadIdx.x & 127, lane = t & 31;
  const int ks = (hd + 15) / 16;
  const float sl2 = scale * AT_LOG2E;
  float adk[ACC / 2], adv[ACC / 2];
  zero_acc<ACC / 2>(adk);
  zero_acc<ACC / 2>(adv);
  const int kr = 16 * (t >> 5) + (lane >> 2);  // this thread's key rows
  mbar_wait(full_kv, 0);

  for (int j = 0; j < nt; ++j) {
    const int s = j % ST, ph = (j / ST) & 1;
    const bf16* sq = reinterpret_cast<const bf16*>(ring + s * STAGE);
    const bf16* sdo = sq + BM * HDP;
    const float* sl = reinterpret_cast<const float*>(sdo + BM * HDP);
    float st[16], dpt[16];  // S^T, dP^T: 64 keys x this WG's 32 queries
    zero_acc<16>(st);
    zero_acc<16>(dpt);
    mbar_wait(&full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      if (kk < ks) {
        const int ko = (kk / 4) * BN * 64 + (kk % 4) * 16;
        const int qo = (kk / 4) * BM * 64 + 32 * c * 64 + (kk % 4) * 16;
        wgmma_n32<0, 0>(st, smem_desc(sk + ko), smem_desc(sq + qo));
        wgmma_n32<0, 0>(dpt, smem_desc(sv + ko), smem_desc(sdo + qo));
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<16>(st);
    fence_acc<16>(dpt);

    // P^T and dS^T (bf16-rounded before their products) in place
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int qc = 32 * c + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      st[i] = ex2(st[i] * sl2 - sl[qc] * AT_LOG2E);
      dpt[i] = st[i] * (dpt[i] - sl[BM + qc]) * scale;
    }
    if constexpr (SPLIT_HD) {
      // the other warpgroup is done with the last tile's P^T / dS^T
      named_sync(1, 256);
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int row = kr + 8 * ((i >> 1) & 1);
        const int qc = 32 * c + 8 * (i >> 2) + 2 * (lane & 3);
        const int off = row * 64 + (((qc >> 3) ^ (row & 7)) << 3) + (qc & 7);
        *reinterpret_cast<uint32_t*>(spt + off) = pack_bf16(st[i], st[i + 1]);
        *reinterpret_cast<uint32_t*>(sdst + off) =
            pack_bf16(dpt[i], dpt[i + 1]);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1, 256);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const int bo = (c * ACC / 64) * BM * 64 + kk * 16 * 64;
        wgmma_n128<0, 1>(adv, smem_desc(spt + kk * 16), smem_desc_mn(sdo + bo));
        wgmma_n128<0, 1>(adk, smem_desc(sdst + kk * 16),
                         smem_desc_mn(sq + bo));
      }
      wgmma_commit();
      wgmma_wait<0>();
    } else {
      // this warpgroup's 32 queries: P^T / dS^T straight from registers
      uint32_t pf[2][4], dsf[2][4];
      to_frags<32>(st, pf);
      to_frags<32>(dpt, dsf);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const int ro = (32 * c + 16 * kb) * 64;
        wgmma_rs<HDP>(adv, pf[kb], smem_desc_mn(sdo + ro, BM * 128));
        wgmma_rs<HDP>(adk, dsf[kb], smem_desc_mn(sq + ro, BM * 128));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_frags<32>(pf);
      fence_frags<32>(dsf);
    }
    fence_acc<ACC / 2>(adv);
    fence_acc<ACC / 2>(adk);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  const float one[2] = {1.f, 1.f};
  const size_t grow = (size_t)g * Nk + k0;
  if constexpr (SPLIT_HD) {
    store_rows<ACC>(adk, one, dk + grow * hd, 0, Nk - k0, c * ACC, hd, t);
    store_rows<ACC>(adv, one, dv + grow * hd, 0, Nk - k0, c * ACC, hd, t);
  } else {
    // dk = WG0's + WG1's partial, dv likewise (a fixed order), through
    // the ring, idle now: WG0 hands over its dv, WG1 its dk
    float* red = reinterpret_cast<float*>(ring);  // [2][ACC / 2][128]
    named_sync(1, 256);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < ACC / 2; ++i) red[i * 128 + t] = adv[i];
    } else {
#pragma unroll
      for (int i = 0; i < ACC / 2; ++i) red[(ACC / 2 + i) * 128 + t] = adk[i];
    }
    named_sync(1, 256);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < ACC / 2; ++i) adk[i] += red[(ACC / 2 + i) * 128 + t];
      store_rows<ACC>(adk, one, dk + grow * hd, 0, Nk - k0, 0, hd, t);
    } else {
#pragma unroll
      for (int i = 0; i < ACC / 2; ++i) adv[i] = red[i * 128 + t] + adv[i];
      store_rows<ACC>(adv, one, dv + grow * hd, 0, Nk - k0, 0, hd, t);
    }
  }
}

// D[row] = sum_c dO[row, c] * O[row, c] in f32, the softmax Jacobian's
// row term that both backward kernels read: lpr lanes a row (a power of
// two, lpr * 8 >= hd or 32), 16-byte loads, a fixed-order sum.
__global__ void __launch_bounds__(256)
    attention_rowdot_kernel(const bf16* __restrict__ dout,
                            const bf16* __restrict__ out,
                            float* __restrict__ D, int rows, int hd,
                            int lpr) {
  const int lane = threadIdx.x & 31, sub = lane % lpr;
  const int row = (blockIdx.x * 8 + (threadIdx.x >> 5)) * (32 / lpr) +
                  lane / lpr;
  float acc = 0.f;
  if (row < rows) {
    const bf16* a = dout + (size_t)row * hd;
    const bf16* b = out + (size_t)row * hd;
    for (int c = sub * 8; c < hd; c += lpr * 8) {
      float fa[8], fb[8];
      unpack8(ld16(a + c), fa);
      unpack8(ld16(b + c), fb);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc += fa[i] * fb[i];
    }
  }
  for (int o = lpr / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (row < rows && sub == 0) D[row] = acc;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <class K>
static int set_smem(K kern, int bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HDP>
static int launch_fwd(const void* q, const void* k, const void* v, void* out,
                      void* lse, int G, int Nq, int Nk, int hd, float scale,
                      cudaStream_t st) {
  using P = FwdPlan<HDP>;
  AttnMaps m;
  if (!make_map_3d(&m.a, q, hd, Nq, G, AT_BQ) ||
      !make_map_3d(&m.b, k, hd, Nk, G, P::BN) ||
      !make_map_3d(&m.c, v, hd, Nk, G, P::BN))
    return (int)cudaErrorInvalidValue;
  auto kern = attention_fwd_kernel<HDP>;
  static const int attr = set_smem(kern, P::SMEM);
  if (attr) return attr;
  kern<<<dim3((Nq + AT_BQ - 1) / AT_BQ, G), AT_THREADS, P::SMEM, st>>>(
      m, (bf16*)out, (float*)lse, Nq, Nk, hd, scale);
  return (int)cudaGetLastError();
}

template <int HDP>
static int launch_bwd(const void* q, const void* k, const void* v,
                      const void* out, const void* dout, const void* lse,
                      void* D, void* dq, void* dk, void* dv, int G, int Nq,
                      int Nk, int hd, float scale, cudaStream_t st) {
  using Q = DqPlan<HDP>;
  using KV = DkvPlan<HDP>;
  AttnMaps mq, mkv;
  if (!make_map_3d(&mq.a, q, hd, Nq, G, AT_BQ) ||
      !make_map_3d(&mq.b, dout, hd, Nq, G, AT_BQ) ||
      !make_map_3d(&mq.c, k, hd, Nk, G, Q::BN) ||
      !make_map_3d(&mq.d, v, hd, Nk, G, Q::BN) ||
      !make_map_3d(&mkv.a, k, hd, Nk, G, KV::BN) ||
      !make_map_3d(&mkv.b, v, hd, Nk, G, KV::BN) ||
      !make_map_3d(&mkv.c, q, hd, Nq, G, KV::BM) ||
      !make_map_3d(&mkv.d, dout, hd, Nq, G, KV::BM))
    return (int)cudaErrorInvalidValue;
  auto kq = attention_bwd_dq_kernel<HDP>;
  auto kkv = attention_bwd_dkv_kernel<HDP>;
  static const int attr = [&] {
    const int e = set_smem(kq, Q::SMEM);
    return e ? e : set_smem(kkv, KV::SMEM);
  }();
  if (attr) return attr;
  int lpr = 1;
  while (lpr < 32 && lpr * 8 < hd) lpr *= 2;
  const int rows = G * Nq, per_block = 8 * (32 / lpr);
  attention_rowdot_kernel<<<(rows + per_block - 1) / per_block, 256, 0, st>>>(
      (const bf16*)dout, (const bf16*)out, (float*)D, rows, hd, lpr);
  int err = (int)cudaGetLastError();
  if (err) return err;
  kq<<<dim3((Nq + AT_BQ - 1) / AT_BQ, G), AT_THREADS, Q::SMEM, st>>>(
      mq, (const float*)lse, (const float*)D, (bf16*)dq, Nq, Nk, hd, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  kkv<<<dim3(Nk / KV::BN, G), AT_THREADS, KV::SMEM, st>>>(
      mkv, (const float*)lse, (const float*)D, (bf16*)dk, (bf16*)dv, Nq, Nk,
      hd, scale);
  return (int)cudaGetLastError();
}

static inline bool attention_shape_ok(int G, int Nq, int Nk, int hd) {
  return G > 0 && Nq > 0 && Nk > 0 && Nq % 64 == 0 && Nk % 64 == 0 &&
         hd > 0 && hd % 8 == 0 && hd <= 256;
}

inline int fwd_hdp(int hd) { return hd <= 64 ? 64 : hd <= 128 ? 128 : 256; }
inline int bwd_hdp(int hd) { return hd <= 64 ? 64 : hd <= 128 ? 128 : 256; }

}  // namespace emp

extern "C" {

// Shapes: Nq % 64 == 0, Nk % 64 == 0, hd % 8 == 0, hd <= 256.
int emp_attention_fwd(const void* q, const void* k, const void* v, void* out,
                      void* lse, int G, int Nq, int Nk, int hd, float scale,
                      void* stream) {
  if (!emp::attention_shape_ok(G, Nq, Nk, hd))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (emp::fwd_hdp(hd)) {
    case 64:
      return emp::launch_fwd<64>(q, k, v, out, lse, G, Nq, Nk, hd, scale, s);
    case 128:
      return emp::launch_fwd<128>(q, k, v, out, lse, G, Nq, Nk, hd, scale, s);
    default:
      return emp::launch_fwd<256>(q, k, v, out, lse, G, Nq, Nk, hd, scale, s);
  }
}

// dq, dk, dv from q, k, v, the forward's out and lse ((G, Nq) f32) and
// dO; D ((G, Nq) f32 scratch) receives rowsum(dO * O).  Shapes as for
// the forward.
int emp_attention_bwd(const void* q, const void* k, const void* v,
                      const void* out, const void* dout, const void* lse,
                      void* D, void* dq, void* dk, void* dv, int G, int Nq,
                      int Nk, int hd, float scale, void* stream) {
  if (!emp::attention_shape_ok(G, Nq, Nk, hd))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (emp::bwd_hdp(hd)) {
    case 64:
      return emp::launch_bwd<64>(q, k, v, out, dout, lse, D, dq, dk, dv, G,
                                 Nq, Nk, hd, scale, s);
    case 128:
      return emp::launch_bwd<128>(q, k, v, out, dout, lse, D, dq, dk, dv, G,
                                  Nq, Nk, hd, scale, s);
    default:
      return emp::launch_bwd<256>(q, k, v, out, dout, lse, D, dq, dk, dv, G,
                                  Nq, Nk, hd, scale, s);
  }
}

// The tile plan for head dim hd (ops/kernels.attention_plan mirrors it):
// out[0..9] = forward HDP, keys a tile, stages, dynamic shared memory
// bytes; backward HDP; dq keys a tile, stages, bytes; dk/dv stages,
// bytes.  Returns cudaErrorInvalidValue for an hd the kernels refuse.
int emp_attention_config(int hd, int* out) {
  if (hd <= 0 || hd % 8 || hd > 256) return (int)cudaErrorInvalidValue;
  using namespace emp;
  const int f = fwd_hdp(hd), b = bwd_hdp(hd);
  out[0] = f;
  out[1] = f == 64 ? FwdPlan<64>::BN : f == 128 ? FwdPlan<128>::BN
                                                : FwdPlan<256>::BN;
  out[2] = f == 64 ? FwdPlan<64>::STAGES : f == 128 ? FwdPlan<128>::STAGES
                                                    : FwdPlan<256>::STAGES;
  out[3] = f == 64 ? FwdPlan<64>::SMEM : f == 128 ? FwdPlan<128>::SMEM
                                                  : FwdPlan<256>::SMEM;
  out[4] = b;
  out[5] = b == 64 ? DqPlan<64>::BN : b == 128 ? DqPlan<128>::BN
                                               : DqPlan<256>::BN;
  out[6] = b == 64 ? DqPlan<64>::STAGES : b == 128 ? DqPlan<128>::STAGES
                                                   : DqPlan<256>::STAGES;
  out[7] = b == 64 ? DqPlan<64>::SMEM : b == 128 ? DqPlan<128>::SMEM
                                                 : DqPlan<256>::SMEM;
  out[8] = b == 64 ? DkvPlan<64>::STAGES : b == 128 ? DkvPlan<128>::STAGES
                                                    : DkvPlan<256>::STAGES;
  out[9] = b == 64 ? DkvPlan<64>::SMEM : b == 128 ? DkvPlan<128>::SMEM
                                                  : DkvPlan<256>::SMEM;
  return 0;
}

}  // extern "C"
