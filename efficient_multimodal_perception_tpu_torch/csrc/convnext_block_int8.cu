// int8 ConvNeXt block epilogue (B10) as a row pass and three int8 wgmma
// GEMMs on the GEMM family of gemm_sm90.cuh.
//
// B10: out = x + gamma * (deq(q(h) . W2q) + b2), h = GELU(deq(q(z) . W1q) + b1),
// z = LN(y), over the (M, C) row view, y being the bf16 7x7 depthwise-conv
// output that the wrapper computes outside the kernel.  q() is symmetric
// per-row int8 of an f32 row (scale max(amax, 1e-12) / 127, code
// clip(rint(v / scale), -127, 127), half to even); the weights arrive
// quantized per output channel (int8 codes and f32 scales, cached by the
// wrapper); both products are int8 x int8 with int32 accumulation;
// deq(acc) = acc * row_scale * col_scale.  LN and every elementwise step
// are f32 (LN's mean and variance are summed in f64, then rounded to
// f32); the result is rounded to bf16 once.
//
// Replaces convnext_block_int8_fused
// (efficient_multimodal_perception_tpu/ops/pallas_kernels.py:
// convnext_block_int8_fused, _block_int8_impl, _post_kernel_int8), with
// exact erf in place of Mosaic's A&S approximation.
//
// What bounds it on an H100.  A row costs 16*C^2 int8 operations against
// 6*C bytes (x, y read, out written): 8*C/3 op/byte, at or above the ~590
// op/byte int8 ridge (1979 TOP/s over 3.35 TB/s) from C = 384 on, under
// it at C = 96 and 192, where the stage-0 and stage-1 rows are.  What
// the card spends at small C is neither: it is the f32 elementwise work
// of the epilogues (a dequantization, an erf and a true division for
// every one of the 4C hidden values of a row).
//
// Design.  h's row scale needs the whole 4C-wide row before fc2 can
// start.  The chain, over row chunks planned by the wrapper
// (ops/kernels.plan_b10_chunks: at most 128 MiB of zq and hq scratch):
// 1. b10_rows_kernel: 16 (C = 96) or 32 lanes a row; LN as the twin
//    rounds it, then z's per-row int8 codes zq (rows, C) and scale zs
//    (rows,); zeroes the row's |h| maximum hmax.
// 2. fc1, amax pass: zq . W1q^T (K = C) on the family's persistent TMA +
//    wgmma int8 mainloop (s32 accumulators); the epilogue (EpiHmax)
//    dequantizes, applies GELU where it can be the row's maximum, and
//    folds each row's |h| maximum over the tile's columns into hmax with
//    atomicMax on the bits of a non-negative float (a maximum: the
//    order of arrival cannot change it).
// 3. fc1, quantize pass: the same product again; the epilogue (EpiHq)
//    recomputes h bit for bit, quantizes it with the row's now known
//    scale and writes hq (rows, 4C) int8 through swizzled shared memory
//    and TMA stores.
// 4. fc2: hq . W2q^T (K = 4C, N = C); the epilogue (EpiB10Out) computes
//    bf16(x + (deq(acc, hs, w2s) + b2) * gamma) from the accumulators in
//    registers, reading the residual beside them.
// The epilogues' f32 work bounds these passes, not the products: they
// run two CTAs an SM (Epi::MIN_BLOCKS), so one CTA's epilogue overlaps
// the other's mainloop and twice the warps hide the latency of erf and
// division (fc2 with 192- or 256-wide tiles keeps one CTA on 4 stages).
// No int32 sum and no f32 h reaches device memory.  Recomputing fc1
// costs one more int8 product of K = C, cheap at 1979 TOP/s; storing h
// in f32 and reading it back would move 32*C bytes a row where the
// whole chain moves about 17*C.  Every f32 step is an explicitly rounded
// operation (no contraction into FMA, true division, half-to-even rint,
// exact erf), so the two fc1 passes give the same h and the chain
// matches its PyTorch twin bit for bit, whatever order the products sum
// in: the int32 sums are exact.

#include <cfloat>

#include "gemm_sm90.cuh"

namespace emp {

// max / f64 sum over the TPR lanes of a row (aligned groups of a warp)
template <int TPR>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int TPR>
__device__ __forceinline__ double row_sum_d(double v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float quant_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
}

__device__ __forceinline__ int quant_code(float v, float scale) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f);
}

// acc * row_scale * col_scale + bias, each step rounded on its own
__device__ __forceinline__ float dequant(int acc, float rs, float cs,
                                         float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn((float)acc, rs), cs), bias);
}

__device__ __forceinline__ float gelu_rn(float x) {
  return __fmul_rn(__fmul_rn(0.5f, x),
                   __fadd_rn(1.0f, erff(__fmul_rn(x, 0.70710678118654752f))));
}

// fc1's passes and the narrow fc2 run two CTAs an SM (Epi::MIN_BLOCKS)
// on a 2-stage ring, 128 columns a tile (a wider fc2 one CTA on 4 stages)
constexpr int B10_FC1_BN = 128;
constexpr int B10_ROW_THREADS = 256;  // 8 warps a block

// ---- 1. the row pass ------------------------------------------------------

// Lanes a row: 16 at C = 96 (two rows a warp, 12 of each 16 lanes
// holding 8 values), else 32.
template <int C>
constexpr int B10_ROW_LANES = C <= 128 ? 16 : 32;

template <int C>
__global__ void __launch_bounds__(B10_ROW_THREADS) b10_rows_kernel(
    const bf16* __restrict__ y,      // (M, C) dwconv output
    const float* __restrict__ ln_s,  // (C,)
    const float* __restrict__ ln_b,  // (C,)
    int8_t* __restrict__ zq,         // (M, C) codes
    float* __restrict__ zs,          // (M,) scales
    unsigned* __restrict__ hmax,     // (M,) |h| maxima, zeroed here
    int M) {
  constexpr int TPR = B10_ROW_LANES<C>;
  constexpr int NIT = (C + 8 * TPR - 1) / (8 * TPR);
  const int lane = threadIdx.x % TPR;
  const int r = (blockIdx.x * B10_ROW_THREADS + threadIdx.x) / TPR;
  if (r >= M) return;  // a whole row's lanes leave together
  const bf16* row = y + (size_t)r * C;
  // LayerNorm (eps 1e-6; f64 statistics rounded to f32), then z's
  // per-row int8 from f32
  float f[NIT][8];
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < NIT; ++i) {
    const int c = lane * 8 + 8 * TPR * i;
    if (c < C) {
      unpack8(ld16(row + c), f[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[i][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) s = __dadd_rn(s, (double)f[i][j]);
  }
  const double mu_d = row_sum_d<TPR>(s) / C;
  double v = 0.0;
#pragma unroll
  for (int i = 0; i < NIT; ++i) {
    if (lane * 8 + 8 * TPR * i < C) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const double d = __dsub_rn((double)f[i][j], mu_d);
        v = __dadd_rn(v, __dmul_rn(d, d));
      }
    }
  }
  const float mu = (float)mu_d;
  const float rs = (float)(1.0 / sqrt(row_sum_d<TPR>(v) / C + 1e-6));
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NIT; ++i) {
    const int c = lane * 8 + 8 * TPR * i;
    if (c < C) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        f[i][j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[i][j], mu), rs),
                                      ln_s[c + j]), ln_b[c + j]);
        amax = fmaxf(amax, fabsf(f[i][j]));
      }
    }
  }
  const float sc = quant_scale(row_max<TPR>(amax));
  if (lane == 0) {
    zs[r] = sc;
    hmax[r] = 0u;
  }
#pragma unroll
  for (int i = 0; i < NIT; ++i) {
    const int c = lane * 8 + 8 * TPR * i;
    if (c < C) {
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j >> 2] |= (uint32_t)(quant_code(f[i][j], sc) & 0xff) << (8 * (j & 3));
      *reinterpret_cast<uint2*>(zq + (size_t)r * C + c) = make_uint2(w[0], w[1]);
    }
  }
}

// ---- 2, 3. fc1's epilogues ------------------------------------------------

// h = GELU(deq(acc, zs, w1s) + b1) at the accumulators' rows and columns
// (the layout of EpiBase's comment: row r0 + 8 h, column n0 + 8 j + 2 q +
// e of d[0][4 j + 2 h + e]); columns >= N give 0.
struct EpiFc1Base : EpiBase {
  using Operand = int8_t;
  static constexpr int MIN_BLOCKS = 2;
  const float* zs;
  const float* w1s;
  const float* b1;
  unsigned* hmax;
  int M, N;

  // the row's zs (0 past M) for rows row0 and row0 + 8
  __device__ __forceinline__ void row_scales(int row0, float (&z)[2]) const {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      z[hh] = row0 + 8 * hh < M ? zs[row0 + 8 * hh] : 0.f;
  }

  __device__ __forceinline__ void hidden(const int32_t* d, const float (&z)[2],
                                         int n0, int q, int j,
                                         float (&h)[2][2]) const {
    // no branch: a column past N (N is even, so col + 1 is past too)
    // reads column 0 and gives 0
    const bool in = n0 + 8 * j + 2 * q < N;
    const int col = in ? n0 + 8 * j + 2 * q : 0;
    const float s0 = w1s[col], s1 = w1s[col + 1];
    const float c0 = b1[col], c1 = b1[col + 1];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float h0 = gelu_rn(dequant(d[4 * j + 2 * hh], z[hh], s0, c0));
      const float h1 = gelu_rn(dequant(d[4 * j + 2 * hh + 1], z[hh], s1, c1));
      h[hh][0] = in ? h0 : 0.f;
      h[hh][1] = in ? h1 : 0.f;
    }
  }
};

// 2: each row's |h| maximum over the tile's columns, into hmax, with
// GELU evaluated only where it can be the maximum.  For v >= 0 GELU
// rises (its slope is at least 0.84 from v = 1 on), and |GELU(v)| <=
// 0.17 for v < 0.  So when the row's largest pre-activation v* is at
// least 1, a v below v* (1 - 2e-5) has GELU(v) below GELU(v*) by about
// 2e-5 of it (the slope is at least 1 there), far more than gelu_rn's
// rounding (a few ulps: exact roundings and erff's 2-ulp bound) could
// close: only the v in
// [v* (1 - 2e-5), v*] are candidates, usually v* alone.  A row whose v*
// is below 1 evaluates every v.  The maximum is the same float the twin
// takes over all 4C values.
struct EpiHmax : EpiFc1Base {
  template <int BN, int NACC>
  __device__ __forceinline__ void run(int32_t (&d)[NACC][BN / 2], int m0,
                                      int n0, int c, int t, unsigned char*,
                                      int) const {
    const int warp = t >> 5, lane = t & 31, q = lane & 3;
    const int row0 = m0 + 64 * c + 16 * warp + (lane >> 2);
    float z[2], top[2] = {-INFINITY, -INFINITY};
    row_scales(row0, z);
    // the pre-activations, in place of the accumulators (-inf past N)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const bool in = n0 + 8 * j + 2 * q < N;
      const int col = in ? n0 + 8 * j + 2 * q : 0;
      const float s0 = w1s[col], s1 = w1s[col + 1];
      const float c0 = b1[col], c1 = b1[col + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float v0 = in ? dequant(d[0][4 * j + 2 * hh], z[hh], s0, c0)
                            : -INFINITY;
        const float v1 = in ? dequant(d[0][4 * j + 2 * hh + 1], z[hh], s1, c1)
                            : -INFINITY;
        d[0][4 * j + 2 * hh] = __float_as_int(v0);
        d[0][4 * j + 2 * hh + 1] = __float_as_int(v1);
        top[hh] = fmaxf(top[hh], fmaxf(v0, v1));
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float vs = top[hh];  // the tile row's v*, over the quad's lanes
      vs = fmaxf(vs, __shfl_xor_sync(0xffffffffu, vs, 1));
      vs = fmaxf(vs, __shfl_xor_sync(0xffffffffu, vs, 2));
      const float thr = vs >= 1.f ? __fmul_rn(vs, 0.99998f) : -FLT_MAX;
      int cand = 0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          cand += __int_as_float(d[0][4 * j + 2 * hh + e]) >= thr;
      float m = 0.f;
      if (cand == 1) {  // this lane's own largest v
        m = fabsf(gelu_rn(top[hh]));
      } else if (cand > 1) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = __int_as_float(d[0][4 * j + 2 * hh + e]);
            if (v >= thr) m = fmaxf(m, fabsf(gelu_rn(v)));
          }
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const int row = row0 + 8 * hh;
      // non-negative floats order as their bits do
      if (q == 0 && row < M) atomicMax(&hmax[row], __float_as_uint(m));
    }
  }
};

// 3: hq = q(h) with the row's scale from hmax.  Each consumer stages its
// 64 rows as up to two 64 x 128 int8 blocks (16-byte chunk k of row r at
// k ^ (r % 8), the TMA store's 128-byte swizzle) and stores them; BN is
// 128 (the ring's width; 256 would need MIN_BLOCKS 1), one round a tile.
struct EpiHq : EpiFc1Base {
  static constexpr int SMEM = GM_CONSUMERS * 2 * 64 * 128;
  CUtensorMap out;

  template <int BN, int NACC>
  __device__ __forceinline__ void run(int32_t (&d)[NACC][BN / 2], int m0,
                                      int n0, int c, int t, unsigned char* cb,
                                      int) const {
    static_assert(BN == 128 || BN == 256, "quantize pass tile width");
    const int warp = t >> 5, lane = t & 31, q = lane & 3;
    const int r0 = 16 * warp + (lane >> 2);
    const int row0 = m0 + 64 * c + r0;
    float z[2], hs[2];
    row_scales(row0, z);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      hs[hh] = quant_scale(row < M ? __uint_as_float(hmax[row]) : 0.f);
    }
    // cb is free once the previous tile's stores have read it
    if (t == 0) bulk_wait_all<true>();
    named_sync(1 + c, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float h[2][2];
      hidden(d[0], z, n0, q, j, h);
      const int jj = j % 16;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        const uint32_t lo = quant_code(h[hh][0], hs[hh]) & 0xff;
        const uint32_t hi = quant_code(h[hh][1], hs[hh]) & 0xff;
        *reinterpret_cast<uint16_t*>(
            cb + (j / 16) * 8192 + r * 128 + (((jj >> 1) ^ (r % 8)) << 4) +
            8 * (jj & 1) + 2 * q) = (uint16_t)(lo | (hi << 8));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + c, 128);
    if (t == 0) {
#pragma unroll
      for (int b = 0; b < BN / 128; ++b)
        if (n0 + 128 * b < N)
          tma_store_2d(&out, cb + b * 8192, n0 + 128 * b, m0 + 64 * c);
      bulk_commit();
    }
  }
  __device__ __forceinline__ void finish(int t) const {
    if (t == 0) bulk_wait_all<false>();
  }
};

// ---- 4. fc2's epilogue ----------------------------------------------------

// out = bf16(x + (deq(acc, hs, w2s) + b2) * gamma) in the twin's order,
// stored from registers (rows >= M and columns >= N masked); gamma may be
// null.  MINB: CTAs an SM (2 for BN <= 128).
template <int MINB>
struct EpiB10Out : EpiBase {
  using Operand = int8_t;
  static constexpr int MIN_BLOCKS = MINB;
  const unsigned* hmax;
  const float* w2s;
  const float* b2;
  const float* gamma;
  const bf16* x;
  bf16* out;
  int M, N;

  template <int BN, int NACC>
  __device__ __forceinline__ void run(int32_t (&d)[NACC][BN / 2], int m0,
                                      int n0, int c, int t, unsigned char*,
                                      int) const {
    const int warp = t >> 5, lane = t & 31, q = lane & 3;
    const int row0 = m0 + 64 * c + 16 * warp + (lane >> 2);
    float hs[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      hs[hh] = quant_scale(row < M ? __uint_as_float(hmax[row]) : 0.f);
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      if (col < N) {
        const float s0 = w2s[col], s1 = w2s[col + 1];
        const float c0 = b2[col], c1 = b2[col + 1];
        const float g0 = gamma ? gamma[col] : 1.f;
        const float g1 = gamma ? gamma[col + 1] : 1.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + 8 * hh;
          if (row < M) {
            const size_t at = (size_t)row * N + col;
            const float2 xf = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(x + at));
            float o0 = dequant(d[0][4 * j + 2 * hh], hs[hh], s0, c0);
            float o1 = dequant(d[0][4 * j + 2 * hh + 1], hs[hh], s1, c1);
            if (gamma) {
              o0 = __fmul_rn(o0, g0);
              o1 = __fmul_rn(o1, g1);
            }
            *reinterpret_cast<__nv_bfloat162*>(out + at) =
                __floats2bfloat162_rn(__fadd_rn(xf.x, o0), __fadd_rn(xf.y, o1));
          }
        }
      }
    }
  }
};

// ---- the chain over one chunk of rows -------------------------------------

struct B10Args {
  const bf16* x;
  const bf16* y;
  const float *ln_s, *ln_b;
  const int8_t* w1q;
  const float *w1s, *b1;
  const int8_t* w2q;
  const float *w2s, *b2, *gamma;
  bf16* out;
  int8_t* zq;
  float* zs;
  unsigned* hmax;
  int8_t* hq;
};

static int b10_fc1(const B10Args& a, int M, int C, cudaStream_t st) {
  constexpr int BN = B10_FC1_BN;
  GemmArgs<1> g;
  const void* pa[1] = {a.zq};
  const void* pw[1] = {a.w1q};
  if (!gemm_args<BN, false, 1, int8_t>(&g, pa, pw, M, 4 * C, C))
    return (int)cudaErrorInvalidValue;
  EpiHmax em;
  EpiHq eq;
  auto init = [&](EpiFc1Base& e) {
    e.zs = a.zs;
    e.w1s = a.w1s;
    e.b1 = a.b1;
    e.hmax = a.hmax;
    e.M = M;
    e.N = 4 * C;
  };
  init(em);
  init(eq);
  if (!make_map(&eq.out, a.hq, 4 * C, M, 64, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1))
    return (int)cudaErrorInvalidValue;
  int e = launch_gemm<EpiHmax, BN, false, 1, 2>(g, em, st);
  if (e) return e;
  return launch_gemm<EpiHq, BN, false, 1, 2>(g, eq, st);
}

template <int BN>
static int b10_fc2(const B10Args& a, int M, int C, cudaStream_t st) {
  constexpr int MINB = BN <= 128 ? 2 : 1;
  GemmArgs<1> g;
  const void* pa[1] = {a.hq};
  const void* pw[1] = {a.w2q};
  if (!gemm_args<BN, false, 1, int8_t>(&g, pa, pw, M, C, 4 * C))
    return (int)cudaErrorInvalidValue;
  EpiB10Out<MINB> eo;
  eo.hmax = a.hmax;
  eo.w2s = a.w2s;
  eo.b2 = a.b2;
  eo.gamma = a.gamma;
  eo.x = a.x;
  eo.out = a.out;
  eo.M = M;
  eo.N = C;
  return launch_gemm<EpiB10Out<MINB>, BN, false, 1, MINB == 2 ? 2 : 4>(g, eo,
                                                                      st);
}

template <int C>
static int b10_rows(const B10Args& a, int M, cudaStream_t st) {
  const int rows_a_block = B10_ROW_THREADS / B10_ROW_LANES<C>;
  b10_rows_kernel<C><<<(M + rows_a_block - 1) / rows_a_block,
                       B10_ROW_THREADS, 0, st>>>(a.y, a.ln_s, a.ln_b, a.zq,
                                                 a.zs, a.hmax, M);
  return (int)cudaGetLastError();
}

static int b10_chunk(const B10Args& a, int M, int C, int bn2,
                     cudaStream_t st) {
  int e;
  switch (C) {
    case 96: e = b10_rows<96>(a, M, st); break;
    case 192: e = b10_rows<192>(a, M, st); break;
    case 384: e = b10_rows<384>(a, M, st); break;
    case 768: e = b10_rows<768>(a, M, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e) return e;
  e = b10_fc1(a, M, C, st);
  if (e) return e;
  switch (bn2) {
    case 96: return b10_fc2<96>(a, M, C, st);
    case 128: return b10_fc2<128>(a, M, C, st);
    case 192: return b10_fc2<192>(a, M, C, st);
    case 256: return b10_fc2<256>(a, M, C, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace emp

extern "C" {

// C must be one of 96, 192, 384, 768 (ConvNeXt-tiny widths).  The chain
// runs over row chunks of `chunk` rows (the last takes the rest) through
// the scratch zq (chunk, C) int8, zs (chunk,) f32, hmax (chunk,) u32 and
// hq (chunk, 4C) int8; bn2 (96, 128, 192 or 256) is fc2's tile width
// (fc1's is 128); gamma may be null.
int emp_convnext_block_int8(const void* x, const void* y, const void* ln_s,
                            const void* ln_b, const void* w1q,
                            const void* w1s, const void* b1, const void* w2q,
                            const void* w2s, const void* b2,
                            const void* gamma, void* out, void* zq, void* zs,
                            void* hmax, void* hq, int M, int C, int chunk,
                            int bn2, void* stream) {
  using namespace emp;
  if (M <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  for (int r0 = 0; r0 < M; r0 += chunk) {
    const size_t off = (size_t)r0 * C;
    const B10Args a{(const bf16*)x + off, (const bf16*)y + off,
                    (const float*)ln_s,   (const float*)ln_b,
                    (const int8_t*)w1q,   (const float*)w1s,
                    (const float*)b1,     (const int8_t*)w2q,
                    (const float*)w2s,    (const float*)b2,
                    (const float*)gamma,  (bf16*)out + off,
                    (int8_t*)zq,          (float*)zs,
                    (unsigned*)hmax,      (int8_t*)hq};
    const int e = b10_chunk(a, M - r0 < chunk ? M - r0 : chunk, C, bn2, st);
    if (e) return e;
  }
  return 0;
}

}  // extern "C"
