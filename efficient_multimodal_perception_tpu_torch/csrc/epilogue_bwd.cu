// Backward of the ConvNeXt block epilogue f(y) = gamma * (fc2(GELU(fc1(LN(y)) + b1)) + b2).
//
// Replaces post_epilogue_bwd (C <= 384) and post_epilogue_bwd_wide
// (C = 768) (efficient_multimodal_perception_tpu/ops/pallas_kernels.py:
// post_epilogue_bwd, _post_bwd_kernel, post_epilogue_bwd_wide,
// _post_bwd_wide_kernel).  Both keep the TPU kernel's rounding points:
// z = LN(y), h = GELU(hpre), do = g * gamma and dhpre are bf16 before
// their products; hpre, dh, dz and opre stay f32.  No float atomics: every
// partial sum is reduced in a fixed order, so two runs give the same
// gradients.
//
// What bounds it on an H100: operations.  A row costs 48*C^2 flops (the
// forward's two GEMMs recomputed and four backward products: dh, dz, dW1,
// dW2) against ~4*C bytes of y and g read and dy written.
//
// Every width (C = 96, 192, 384 for post_epilogue_bwd, 768 for the wide
// variant; any multiple of 8 up to 1024) runs one chain of row passes and
// the shared Hopper GEMM of gemm_sm90.cuh (TMA loads, mbarrier ring,
// wgmma), every product on the tensor cores:
//
// 1. Row pass A (16 rows a block): mu and rstd (f32, kept for pass B),
//    z = bf16(LN(y)), doc = bf16(g * gamma), and column partials of the
//    unrounded g * gamma (db2).
// 2. Dual GEMM, out (M, 4C), K = C: hpre = z W1^T and dh = doc W2 (W2
//    transposed once a call into a (4C, C) K-major copy); two 128 x 128
//    accumulators per CTA share the tile.  Epilogue: h = bf16(GELU(hpre
//    + b1)), dhpre = bf16(dh * GELU'(hpre + b1)), column partials of the
//    unrounded dhpre (db1) per warp.
// 3. Dual GEMM, out (M, C), K = 4C: dz = dhpre W1 (W1 transposed once a
//    call into a (C, 4C) copy) and opre = h W2^T.  Epilogue: dz in f32,
//    column partials of g * (opre + b2) (dgamma); opre is never stored.
//    Its tile width bn2 (96 or 128) is the wrapper's plan: 96 where C is
//    not a multiple of 128 (C = 96, 192), so no tile is partly empty.
// 4. Row pass B: dzhat = dz * ln_s, its row means m1 and m2 (against
//    zhat), dy = bf16(rstd (dzhat - m1 - zhat m2)), column partials of
//    dz * zhat (dlns) and dz (dlnb).
// 5. colsum_kernel reduces the (P, 8C) partials, P = 8 per 128 rows, 64
//    lanes a column (there are few columns and many rows).
// 6. dW1 = dhpre^T z and dW2 = doc^T h as MN-major GEMMs (K = M, f32
//    out).  At the narrow widths their outputs have few tiles (dW1 3 / 6
//    / 24 at C = 96 / 192 / 384) while M reaches 98304, so M is split
//    into s1 / s2 ranges (the wrapper's plan, ops/kernels.plan_atb_splits:
//    enough to fill the card's SMs, each range at least 512 rows); each
//    range's f32 partial product goes to its own slice of wpart and
//    colsum_kernel adds the slices in a fixed order.  At the wide train
//    shapes (72 tiles each) the plan is one range, written straight out.

#include "gemm_sm90.cuh"

namespace emp {

// out[j] = sum over i of part[i, j]: LANES threads of a column sum the
// rows lane, lane + LANES, ... in ascending order, then the LANES sums
// are added in order: a fixed order for a given shape, so the result is
// the same on every run.  512 / LANES columns a block.
template <int LANES>
__global__ void __launch_bounds__(512) colsum_kernel(
    const float* __restrict__ part, float* __restrict__ out, int rows,
    long long cols) {
  constexpr int CW = 512 / LANES;
  __shared__ float red[LANES][CW + 1];
  const long long j = (long long)blockIdx.x * CW + threadIdx.x;
  float s = 0.f;
  if (j < cols)
    for (int i = threadIdx.y; i < rows; i += LANES)
      s += part[(size_t)i * cols + j];
  if (LANES == 1) {
    if (j < cols) out[j] = s;
    return;
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < cols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < LANES; ++i) t += red[i][threadIdx.x];
    out[j] = t;
  }
}

template <int LANES>
static int colsum(const float* part, float* out, int rows, long long cols,
                  cudaStream_t s) {
  constexpr int CW = 512 / LANES;
  const long long grid = (cols + CW - 1) / CW;
  colsum_kernel<LANES><<<(unsigned)grid, dim3(CW, LANES), 0, s>>>(
      part, out, rows, cols);
  return (int)cudaGetLastError();
}

// The lanes a column gets: one for a few rows (the weight gradients'
// 3-7 splits at C = 384, where 16 lanes took 6x the device time on an
// H100), 16 where 32-column blocks fill the card twice (the larger
// splits: 4C^2 columns), else 64 (the partial rows of the row passes and
// epilogues: up to 6144 rows of only 8C columns at the train shapes,
// where 16 lanes took 3x the device time).
static int launch_colsum(const float* part, float* out, int rows,
                         long long cols, cudaStream_t s) {
  if (rows <= 8) return colsum<1>(part, out, rows, cols, s);
  if ((cols + 31) / 32 >= 2 * sm_count())
    return colsum<16>(part, out, rows, cols, s);
  return colsum<64>(part, out, rows, cols, s);
}

// ---- the chain ------------------------------------------------------------

constexpr int WB_RB = 16;       // rows a block of the row passes
constexpr int WB_DUAL_BN = 128; // dual GEMM 1: two 64-register accumulators
constexpr int WB_DUAL_STAGES = 3;
constexpr int WB_ATB_BN = 256;
constexpr int WB_ATB_STAGES = 4;

// out (Cc, R) = in (R, Cc)^T, bf16, through 32 x 32 shared tiles.
__global__ void __launch_bounds__(256) transpose_kernel(
    const bf16* __restrict__ in, bf16* __restrict__ out, int R, int Cc) {
  __shared__ bf16 tile[32][33];
  int x = blockIdx.x * 32 + threadIdx.x, y = blockIdx.y * 32 + threadIdx.y;
#pragma unroll
  for (int j = 0; j < 32; j += 8)
    if (x < Cc && y + j < R)
      tile[threadIdx.y + j][threadIdx.x] = in[(size_t)(y + j) * Cc + x];
  __syncthreads();
  x = blockIdx.y * 32 + threadIdx.x;
  y = blockIdx.x * 32 + threadIdx.y;
#pragma unroll
  for (int j = 0; j < 32; j += 8)
    if (x < R && y + j < Cc)
      out[(size_t)(y + j) * R + x] = tile[threadIdx.x][threadIdx.y + j];
}

static int launch_transpose(const void* in, void* out, int R, int Cc,
                            cudaStream_t s) {
  const dim3 grid((Cc + 31) / 32, (R + 31) / 32), block(32, 8);
  transpose_kernel<<<grid, block, 0, s>>>((const bf16*)in, (bf16*)out, R, Cc);
  return (int)cudaGetLastError();
}

// Row pass A: per row mu and rstd into stats ([0, M) and [M, 2M)),
// z = bf16(LN(y)), doc = bf16(g * gamma); column partials of g * gamma
// into part's row blockIdx.x (zeros where the block has no rows).
__global__ void __launch_bounds__(128) rows_a_kernel(
    const bf16* __restrict__ y, const bf16* __restrict__ g,
    const float* __restrict__ ln_s, const float* __restrict__ ln_b,
    const float* __restrict__ gamma, bf16* __restrict__ z,
    bf16* __restrict__ doc, float* __restrict__ stats,
    float* __restrict__ part, int M, int C, int ld) {
  __shared__ float mu_s[WB_RB], rs_s[WB_RB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * WB_RB;
  for (int r = warp; r < WB_RB; r += 4) {
    const int row = r0 + r;
    float mu = 0.f, rs = 0.f;
    if (row < M) {
      const bf16* yr = y + (size_t)row * C;
      float f[8], sum = 0.f, var = 0.f;
      for (int k = lane * 8; k < C; k += 256) {
        unpack8(ld16(yr + k), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += f[i];
      }
      mu = warp_sum(sum) / C;
      for (int k = lane * 8; k < C; k += 256) {
        unpack8(ld16(yr + k), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) var += (f[i] - mu) * (f[i] - mu);
      }
      rs = rsqrtf(warp_sum(var) / C + 1e-6f);
      if (lane == 0) {
        stats[row] = mu;
        stats[M + row] = rs;
      }
    }
    if (lane == 0) {
      mu_s[r] = mu;
      rs_s[r] = rs;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x * 8; k < C; k += 128 * 8) {
    float sv[8], bv[8], gm[8], acc[8];
    ld_f32x8(ln_s + k, sv);
    ld_f32x8(ln_b + k, bv);
    ld_f32x8(gamma + k, gm);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int r = 0; r < WB_RB; ++r) {
      const int row = r0 + r;
      if (row >= M) break;
      const size_t o = (size_t)row * C + k;
      float f[8], d[8];
      unpack8(ld16(y + o), f);
      unpack8(ld16(g + o), d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        f[i] = (f[i] - mu_s[r]) * rs_s[r] * sv[i] + bv[i];
        d[i] *= gm[i];
        acc[i] += d[i];
      }
      st16(z + o, pack8(f));
      st16(doc + o, pack8(d));
    }
    float* pr = part + (size_t)blockIdx.x * ld + k;
#pragma unroll
    for (int i = 0; i < 8; ++i) pr[i] = acc[i];
  }
}

// Row pass B: dy = bf16(rstd (dz * s - m1 - zhat m2)); column partials of
// dz * zhat and dz into part's columns [0, C) and [C, 2C).
__global__ void __launch_bounds__(128) rows_b_kernel(
    const float* __restrict__ dz, const bf16* __restrict__ y,
    const float* __restrict__ stats, const float* __restrict__ ln_s,
    bf16* __restrict__ dy, float* __restrict__ part, int M, int C, int ld) {
  __shared__ float m1_s[WB_RB], m2_s[WB_RB], mu_s[WB_RB], rs_s[WB_RB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * WB_RB;
  for (int r = warp; r < WB_RB; r += 4) {
    const int row = r0 + r;
    float m1 = 0.f, m2 = 0.f, mu = 0.f, rs = 0.f;
    if (row < M) {
      mu = stats[row];
      rs = stats[M + row];
      float s1 = 0.f, s2 = 0.f;
      for (int k = lane * 8; k < C; k += 256) {
        float f[8], dv[8], sv[8];
        unpack8(ld16(y + (size_t)row * C + k), f);
        ld_f32x8(dz + (size_t)row * C + k, dv);
        ld_f32x8(ln_s + k, sv);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float dzh = dv[i] * sv[i];
          s1 += dzh;
          s2 += dzh * ((f[i] - mu) * rs);
        }
      }
      m1 = warp_sum(s1) / C;
      m2 = warp_sum(s2) / C;
    }
    if (lane == 0) {
      m1_s[r] = m1;
      m2_s[r] = m2;
      mu_s[r] = mu;
      rs_s[r] = rs;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x * 8; k < C; k += 128 * 8) {
    float sv[8], a1[8], a2[8];
    ld_f32x8(ln_s + k, sv);
#pragma unroll
    for (int i = 0; i < 8; ++i) a1[i] = a2[i] = 0.f;
    for (int r = 0; r < WB_RB; ++r) {
      const int row = r0 + r;
      if (row >= M) break;
      const size_t o = (size_t)row * C + k;
      float f[8], dv[8];
      unpack8(ld16(y + o), f);
      ld_f32x8(dz + o, dv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float zh = (f[i] - mu_s[r]) * rs_s[r];
        a1[i] += dv[i] * zh;
        a2[i] += dv[i];
        f[i] = rs_s[r] * (dv[i] * sv[i] - m1_s[r] - zh * m2_s[r]);
      }
      st16(dy + o, pack8(f));
    }
    float* pr = part + (size_t)blockIdx.x * ld + k;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      pr[i] = a1[i];
      pr[C + i] = a2[i];
    }
  }
}

// Sum over the warp's 16 rows of a column pair (lanes with equal t % 4).
__device__ __forceinline__ void rows_reduce2(float& a, float& b) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Dual GEMM 1 epilogue: d[0] = z W1^T, d[1] = dh.  Writes h and dhpre
// (M, N) bf16 and, per warp, column sums of the unrounded dhpre into
// part's row 8 * (m0 / 128) + 4c + warp.
struct EpiBwd1 : EpiBase {
  const float* b1;
  bf16* h;
  bf16* dhpre;
  float* part;
  int M, N, ld;

  template <int BN, int NACC>
  __device__ __forceinline__ void run(float (&d)[NACC][BN / 2], int m0,
                                      int n0, int c, int t, unsigned char*,
                                      int) const {
    const int warp = t >> 5, lane = t & 31;
    const int r0 = m0 + 64 * c + warp * 16 + (lane >> 2);
    float* prow = part + (size_t)((m0 / GM_BM) * 8 + 4 * c + warp) * ld;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      const bool live = col < N;
      const float bb0 = live ? b1[col] : 0.f, bb1 = live ? b1[col + 1] : 0.f;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        float hv[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float hp = d[0][4 * j + 2 * hh + e] + (e ? bb1 : bb0);
          const float phi = 0.5f * (1.0f + erff(hp * 0.70710678118654752f));
          const float pdf = 0.3989422804014327f * expf(-0.5f * hp * hp);
          hv[e] = hp * phi;
          dv[e] = d[1][4 * j + 2 * hh + e] * (phi + hp * pdf);
        }
        if (row < M && live) {
          const size_t o = (size_t)row * N + col;
          *reinterpret_cast<__nv_bfloat162*>(h + o) =
              __floats2bfloat162_rn(hv[0], hv[1]);
          *reinterpret_cast<__nv_bfloat162*>(dhpre + o) =
              __floats2bfloat162_rn(dv[0], dv[1]);
          s0 += dv[0];
          s1 += dv[1];
        }
      }
      rows_reduce2(s0, s1);
      if (lane < 4 && live) {
        prow[col] = s0;
        prow[col + 1] = s1;
      }
    }
  }
};

// Dual GEMM 2 epilogue: d[0] = dz, d[1] = h W2^T.  Writes dz (M, N) f32
// and, per warp, column sums of g * (opre + b2) into part's row as above.
struct EpiBwd2 : EpiBase {
  const float* b2;
  const bf16* g;
  float* dz;
  float* part;
  int M, N, ld;

  template <int BN, int NACC>
  __device__ __forceinline__ void run(float (&d)[NACC][BN / 2], int m0,
                                      int n0, int c, int t, unsigned char*,
                                      int) const {
    const int warp = t >> 5, lane = t & 31;
    const int r0 = m0 + 64 * c + warp * 16 + (lane >> 2);
    float* prow = part + (size_t)((m0 / GM_BM) * 8 + 4 * c + warp) * ld;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      const bool live = col < N;
      const float bb0 = live ? b2[col] : 0.f, bb1 = live ? b2[col + 1] : 0.f;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        if (row < M && live) {
          const size_t o = (size_t)row * N + col;
          *reinterpret_cast<float2*>(dz + o) =
              make_float2(d[0][4 * j + 2 * hh], d[0][4 * j + 2 * hh + 1]);
          const float2 gv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(g + o));
          s0 += gv.x * (d[1][4 * j + 2 * hh] + bb0);
          s1 += gv.y * (d[1][4 * j + 2 * hh + 1] + bb1);
        }
      }
      rows_reduce2(s0, s1);
      if (lane < 4 && live) {
        prow[col] = s0;
        prow[col + 1] = s1;
      }
    }
  }
};

// A^T B epilogue: the f32 tile of split ks into out + ks * M * N (M, N),
// rows < M and columns < N.
struct EpiF32 : EpiBase {
  float* out;
  int M, N;

  template <int BN, int NACC>
  __device__ __forceinline__ void run(float (&d)[NACC][BN / 2], int m0,
                                      int n0, int c, int t, unsigned char*,
                                      int ks) const {
    const int warp = t >> 5, lane = t & 31;
    const int r0 = m0 + 64 * c + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        if (row < M && col < N)
          *reinterpret_cast<float2*>(out + ((size_t)ks * M + row) * N +
                                     col) =
              make_float2(d[0][4 * j + 2 * hh], d[0][4 * j + 2 * hh + 1]);
      }
    }
  }
};

// out (N1, N2) f32 = A^T B for A (M, N1), B (M, N2) bf16 through the
// MN-major GEMM, K = M.  splits > 1: M in that many ranges, each range's
// product into wpart (splits, N1, N2) f32, then summed in a fixed order.
static int atb(const void* A, const void* B, float* out, float* wpart,
                    int M, int N1, int N2, int splits, cudaStream_t st) {
  GemmArgs<1> g;
  const void* pa[1] = {A};
  const void* pb[1] = {B};
  if (!gemm_args<WB_ATB_BN, true, 1>(&g, pa, pb, N1, N2, M))
    return (int)cudaErrorInvalidValue;
  const int s = split_k(&g, splits);
  if (s > 1 && !wpart) return (int)cudaErrorInvalidValue;
  EpiF32 epi;
  epi.out = s > 1 ? wpart : out;
  epi.M = N1;
  epi.N = N2;
  const int e =
      launch_gemm<EpiF32, WB_ATB_BN, true, 1, WB_ATB_STAGES>(g, epi, st);
  if (e || s == 1) return e;
  return launch_colsum(wpart, out, s, (long long)N1 * N2, st);
}

// The dual GEMM of step 3 at tile width BN.
template <int BN>
static int dual2(const void* dhpre, const void* h, const void* w1t,
                 const void* w2, const void* b2, const void* g, void* dz,
                 float* part, int M, int C, int ld, cudaStream_t st) {
  GemmArgs<2> ga;
  const void* pa[2] = {dhpre, h};
  const void* pb[2] = {w1t, w2};
  if (!gemm_args<BN, false, 2>(&ga, pa, pb, M, C, 4 * C))
    return (int)cudaErrorInvalidValue;
  EpiBwd2 epi;
  epi.b2 = (const float*)b2;
  epi.g = (const bf16*)g;
  epi.dz = (float*)dz;
  epi.part = part;
  epi.M = M;
  epi.N = C;
  epi.ld = ld;
  return launch_gemm<EpiBwd2, BN, false, 2, WB_DUAL_STAGES>(ga, epi, st);
}

static int epilogue_bwd(const void* y, const void* g, const void* ln_s,
                        const void* ln_b, const void* w1, const void* b1,
                        const void* w2, const void* b2, const void* gamma,
                        void* w1t, void* w2t, void* dy, void* z, void* doc,
                        void* h, void* dhpre, void* dz, void* stats,
                        void* part, void* vec, void* dw1, void* dw2,
                        void* wpart, int M, int C, int bn2, int s1, int s2,
                        cudaStream_t st) {
  if (M < 1 || C % 8 || C > 1024) return (int)cudaErrorInvalidValue;
  const int H = 4 * C, ld = 8 * C;
  const int P = (M + GM_BM - 1) / GM_BM * 8;  // partial rows
  float* pt = (float*)part;
  int e = launch_transpose(w2, w2t, C, H, st);
  if (!e) e = launch_transpose(w1, w1t, H, C, st);
  if (e) return e;
  rows_a_kernel<<<P, 128, 0, st>>>(
      (const bf16*)y, (const bf16*)g, (const float*)ln_s, (const float*)ln_b,
      (const float*)gamma, (bf16*)z, (bf16*)doc, (float*)stats, pt + 4 * C, M,
      C, ld);
  if ((e = (int)cudaGetLastError())) return e;
  {
    GemmArgs<2> ga;
    const void* pa[2] = {z, doc};
    const void* pb[2] = {w1, w2t};
    if (!gemm_args<WB_DUAL_BN, false, 2>(&ga, pa, pb, M, H, C))
      return (int)cudaErrorInvalidValue;
    EpiBwd1 epi;
    epi.b1 = (const float*)b1;
    epi.h = (bf16*)h;
    epi.dhpre = (bf16*)dhpre;
    epi.part = pt;
    epi.M = M;
    epi.N = H;
    epi.ld = ld;
    e = launch_gemm<EpiBwd1, WB_DUAL_BN, false, 2, WB_DUAL_STAGES>(ga, epi, st);
    if (e) return e;
  }
  if (bn2 == 128)
    e = dual2<128>(dhpre, h, w1t, w2, b2, g, dz, pt + 7 * C, M, C, ld, st);
  else if (bn2 == 96)
    e = dual2<96>(dhpre, h, w1t, w2, b2, g, dz, pt + 7 * C, M, C, ld, st);
  else
    e = (int)cudaErrorInvalidValue;
  if (e) return e;
  rows_b_kernel<<<P, 128, 0, st>>>(
      (const float*)dz, (const bf16*)y, (const float*)stats,
      (const float*)ln_s, (bf16*)dy, pt + 5 * C, M, C, ld);
  if ((e = (int)cudaGetLastError())) return e;
  if ((e = launch_colsum(pt, (float*)vec, P, (long long)ld, st))) return e;
  float* wp = (float*)wpart;
  if ((e = atb(dhpre, z, (float*)dw1, wp, M, H, C, s1, st))) return e;
  return atb(doc, h, (float*)dw2, wp, M, C, H, s2, st);
}

}  // namespace emp

extern "C" {

// The backward chain for C a multiple of 8 up to 1024.  Scratch from the
// wrapper: w1t (C, 4C), w2t (4C, C), z, doc (M, C) bf16; h, dhpre (M, 4C)
// bf16; dz (M, C) f32; stats (2M) f32; part (P, 8C) f32 with P = 8 *
// ceil(M / 128); wpart (max(s1, s2) * 4C * C) f32, or null when s1 = s2 =
// 1.  bn2: dual GEMM 2's tile width (96 or 128); s1 / s2: the ranges of M
// of dW1 / dW2.  Outputs: dy (M, C) bf16; vec (8C) f32 = db1 | db2 | dlns
// | dlnb | dgamma; dw1 (4C, C), dw2 (C, 4C) f32.
int emp_epilogue_bwd(const void* y, const void* g, const void* ln_s,
                     const void* ln_b, const void* w1, const void* b1,
                     const void* w2, const void* b2, const void* gamma,
                     void* w1t, void* w2t, void* dy, void* z, void* doc,
                     void* h, void* dhpre, void* dz, void* stats, void* part,
                     void* vec, void* dw1, void* dw2, void* wpart, int M,
                     int C, int bn2, int s1, int s2, void* stream) {
  return emp::epilogue_bwd(y, g, ln_s, ln_b, w1, b1, w2, b2, gamma, w1t, w2t,
                           dy, z, doc, h, dhpre, dz, stats, part, vec, dw1,
                           dw2, wpart, M, C, bn2, s1, s2,
                           (cudaStream_t)stream);
}

}  // extern "C"
