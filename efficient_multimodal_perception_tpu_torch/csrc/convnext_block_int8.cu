// int8 ConvNeXt block epilogue (B10).
//
// B10: out = x + gamma * (deq(q(h) . W2q) + b2), h = GELU(deq(q(z) . W1q) + b1),
// z = LN(y), over the (M, C) row view, y being the bf16 7x7 depthwise-conv
// output that the wrapper computes outside the kernel.  q() is symmetric
// per-row int8 of an f32 row (scale max(amax, 1e-12) / 127, code
// clip(rint(v / scale), -127, 127), half to even); the weights arrive
// quantized per output channel (int8 codes and f32 scales, made by the
// wrapper from the f32 parameters); both products are int8 x int8 with
// int32 accumulation; deq(acc) = acc * row_scale * col_scale.  LN and
// every elementwise step are f32 (LN's mean and variance are summed in
// f64, then rounded to f32); the result is rounded to bf16 once.
//
// Replaces convnext_block_int8_fused
// (efficient_multimodal_perception_tpu/ops/pallas_kernels.py:
// convnext_block_int8_fused, _block_int8_impl, _post_kernel_int8), with
// exact erf in place of Mosaic's A&S approximation.
//
// What bounds it on an H100: operations.  A row costs 16*C^2 int8
// operations (two products C <-> 4C) against 6*C bytes, so the
// intensity is 8*C/3 op/byte, at or above the ~590 op/byte int8 ridge
// (1979 TOP/s over 3.35 TB/s) from C = 384 on.
//
// Design.  h's scale needs its whole row (all 4C values) before fc2 can
// start, so fc1 runs twice: pass 1 streams the hidden dimension in
// 128-column chunks and keeps only each row's amax of GELU(h); pass 2
// recomputes each chunk, quantizes it with the now known scale into
// shared memory and accumulates fc2 into int32 registers, as K1
// (csrc/convnext_block.cu) streams its hidden chunks.  The int32 sums are
// exact and every f32 step is an explicitly rounded operation (no
// contraction into FMA), so both passes compute the same h bit for bit.
// For the same reason the kernel matches its PyTorch twin bit for bit: a
// code at a rounding tie flips on one ulp, one flip moves a product by
// ~1e-4 relative and flips more codes downstream, so the LN statistics
// are summed in f64 (order-independent once rounded to f32) and every
// other step rounds where the twin's eager PyTorch ops do.  This costs 1.5x the MMA work of one fc1 + fc2 pass, and needs
// only 31 KB of shared memory at C = 768; keeping h in f32 instead
// (16 rows x 3072 x 4 B = 192 KB at C = 768) would leave one block per
// SM.  A block owns 32 rows and 8 warps.  The tile routine is
// mma.sync m16n8k32 s8 (int32 accumulators); A fragments come from
// shared memory, B fragments straight from the int8 weights in global
// memory (at most 2.4 MB each, L2-resident).  Simple first: no cp.async
// pipeline, no wgmma.

#include "common.cuh"

namespace emp {

// D (16x8 s32) += A (16x32 s8, row-major) * B (32x8 s8, column-major).
// Fragments (PTX ISA, matrix fragments for mma.m16n8k32), g = lane / 4,
// t = lane % 4: a[0] = A[g][4t..4t+3], a[1] = A[g+8][4t..], a[2] =
// A[g][16+4t..], a[3] = A[g+8][16+4t..]; b[0] = B[4t..4t+3][g], b[1] =
// B[16+4t..][g]; d[0], d[1] = D[g][2t], D[g][2t+1]; d[2], d[3] the same
// in row g+8.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of the 16 x 32 tile at p (row-major, ld bytes a row).
__device__ __forceinline__ void load_a(uint32_t* a, const int8_t* p, int ld,
                                       int lane) {
  const int8_t* r0 = p + (lane >> 2) * ld + 4 * (lane & 3);
  const int8_t* r1 = r0 + 8 * ld;
  a[0] = ld32(r0);
  a[1] = ld32(r1);
  a[2] = ld32(r0 + 16);
  a[3] = ld32(r1 + 16);
}

// B fragment of the 32 x 8 tile whose column n is row n of the (N, K)
// row-major matrix at p (ld bytes a row), the nn.Linear weight layout.
__device__ __forceinline__ void load_b(uint32_t* b, const int8_t* p, int ld,
                                       int lane) {
  const int8_t* r = p + (lane >> 2) * ld + 4 * (lane & 3);
  b[0] = ld32(r);
  b[1] = ld32(r + 16);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
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

constexpr int Q8_BM = 32;
constexpr int Q8_HC = 128;  // hidden chunk width
constexpr int Q8_LDH = Q8_HC + 16;
constexpr int Q8_THREADS = 256;

// One hidden chunk's fc1 for this warp: int32 sums of rows 16*rt + g (+8)
// and hidden columns j0 + 16*warp + 8*nt + 2t (+1).
template <int C>
__device__ __forceinline__ void fc1_chunk(int (&acc)[2][2][4],
                                          const int8_t* zq,
                                          const int8_t* __restrict__ w1q,
                                          int j0, int warp, int lane) {
  constexpr int LDZ = C + 16;
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[rt][nt][i] = 0;
  const int8_t* wp = w1q + (size_t)(j0 + 16 * warp) * C;
#pragma unroll 4
  for (int k = 0; k < C; k += 32) {
    uint32_t a[2][4], b[2][2];
    load_a(a[0], zq + k, LDZ, lane);
    load_a(a[1], zq + 16 * LDZ + k, LDZ, lane);
    load_b(b[0], wp + k, C, lane);
    load_b(b[1], wp + 8 * C + k, C, lane);
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma_s8(acc[rt][nt], a[rt], b[nt]);
  }
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int C>
__global__ void __launch_bounds__(Q8_THREADS) convnext_int8_kernel(
    const bf16* __restrict__ x,      // (M, C) residual input
    const bf16* __restrict__ y,      // (M, C) dwconv output
    const float* __restrict__ ln_s,  // (C,)
    const float* __restrict__ ln_b,  // (C,)
    const int8_t* __restrict__ w1q,  // (4C, C) codes, nn.Linear layout
    const float* __restrict__ w1s,   // (4C,) scales
    const float* __restrict__ b1,    // (4C,)
    const int8_t* __restrict__ w2q,  // (C, 4C) codes
    const float* __restrict__ w2s,   // (C,) scales
    const float* __restrict__ b2,    // (C,)
    const float* __restrict__ gamma, // (C,) or null
    bf16* __restrict__ out,          // (M, C)
    int M) {
  constexpr int HID = 4 * C;
  constexpr int LDZ = C + 16;  // bytes a zq row: conflict-free A loads
  constexpr int NIT = (C + 255) / 256;
  constexpr int CT = C / 8;        // 8-wide output column tiles
  constexpr int NT = 2 * CT / 8;   // fc2 tiles of a warp (2 row tiles)

  __shared__ __align__(16) int8_t zq[Q8_BM * LDZ];
  __shared__ __align__(16) int8_t hq[Q8_BM * Q8_LDH];
  __shared__ float zsc[Q8_BM], hsc[Q8_BM];
  __shared__ float red[8][Q8_BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * Q8_BM;

  // LayerNorm (eps 1e-6; f64 statistics rounded to f32), then z's
  // per-row int8 from f32
  for (int r = warp; r < Q8_BM; r += 8) {
    const int gr = m0 + r;
    const bf16* row = y + (size_t)gr * C;
    float f[NIT][8];
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < NIT; ++i) {
      const int c = lane * 8 + 256 * i;
      if (gr < M && c < C) {
        unpack8(ld16(row + c), f[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[i][j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) s = __dadd_rn(s, (double)f[i][j]);
    }
    const double mu_d = warp_sum_d(s) / C;
    double v = 0.0;
#pragma unroll
    for (int i = 0; i < NIT; ++i) {
      if (lane * 8 + 256 * i < C) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const double d = __dsub_rn((double)f[i][j], mu_d);
          v = __dadd_rn(v, __dmul_rn(d, d));
        }
      }
    }
    const float mu = (float)mu_d;
    const float rs = (float)(1.0 / sqrt(warp_sum_d(v) / C + 1e-6));
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < NIT; ++i) {
      const int c = lane * 8 + 256 * i;
      if (c < C) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          f[i][j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[i][j], mu), rs),
                                        ln_s[c + j]), ln_b[c + j]);
          amax = fmaxf(amax, fabsf(f[i][j]));
        }
      }
    }
    const float sc = quant_scale(warp_max(amax));
    if (lane == 0) zsc[r] = sc;
#pragma unroll
    for (int i = 0; i < NIT; ++i) {
      const int c = lane * 8 + 256 * i;
      if (c < C) {
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          w[j >> 2] |= (uint32_t)(quant_code(f[i][j], sc) & 0xff) << (8 * (j & 3));
        *reinterpret_cast<uint2*>(zq + r * LDZ + c) = make_uint2(w[0], w[1]);
      }
    }
  }
  __syncthreads();

  // pass 1: each row's amax of GELU(h) over all 4C hidden columns
  float amax[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int j0 = 0; j0 < HID; j0 += Q8_HC) {
    int acc[2][2][4];
    fc1_chunk<C>(acc, zq, w1q, j0, warp, lane);
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 16 * rt + g + 8 * (i >> 1);
          const int col = j0 + 16 * warp + 8 * nt + 2 * t + (i & 1);
          const float h = gelu_rn(dequant(acc[rt][nt][i], zsc[row], w1s[col],
                                          b1[col]));
          amax[rt][i >> 1] = fmaxf(amax[rt][i >> 1], fabsf(h));
        }
  }
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float m = amax[rt][hf];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (t == 0) red[warp][16 * rt + g + 8 * hf] = m;
    }
  __syncthreads();
  if (tid < Q8_BM) {
    float m = red[0][tid];
#pragma unroll
    for (int w = 1; w < 8; ++w) m = fmaxf(m, red[w][tid]);
    hsc[tid] = quant_scale(m);
  }
  __syncthreads();

  // pass 2: recompute each chunk, quantize it, accumulate fc2
  int oacc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0;
  for (int j0 = 0; j0 < HID; j0 += Q8_HC) {
    int acc[2][2][4];
    fc1_chunk<C>(acc, zq, w1q, j0, warp, lane);
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = 16 * rt + g + 8 * hf;
          const int lc = 16 * warp + 8 * nt + 2 * t;
          char2 q;
          q.x = (signed char)quant_code(
              gelu_rn(dequant(acc[rt][nt][2 * hf], zsc[row], w1s[j0 + lc],
                              b1[j0 + lc])), hsc[row]);
          q.y = (signed char)quant_code(
              gelu_rn(dequant(acc[rt][nt][2 * hf + 1], zsc[row],
                              w1s[j0 + lc + 1], b1[j0 + lc + 1])), hsc[row]);
          *reinterpret_cast<char2*>(hq + row * Q8_LDH + lc) = q;
        }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < Q8_HC; kk += 32) {
      uint32_t a[2][4];
      load_a(a[0], hq + kk, Q8_LDH, lane);
      load_a(a[1], hq + 16 * Q8_LDH + kk, Q8_LDH, lane);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int ti = warp + 8 * i, rt = ti / CT, ct = ti % CT;
        uint32_t b[2];
        load_b(b, w2q + (size_t)(8 * ct) * HID + j0 + kk, HID, lane);
        mma_s8(oacc[i], a[rt], b);
      }
    }
    __syncthreads();
  }

  // epilogue: dequantize, + b2, * gamma, + x, one bf16 rounding
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int ti = warp + 8 * i, rt = ti / CT, ct = ti % CT;
    const int col = 8 * ct + 2 * t;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = 16 * rt + g + 8 * hf;
      const int gr = m0 + row;
      if (gr < M) {
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
            x + (size_t)gr * C + col);
        const float2 xf = __bfloat1622float2(xv);
        float o0 = dequant(oacc[i][2 * hf], hsc[row], w2s[col], b2[col]);
        float o1 = dequant(oacc[i][2 * hf + 1], hsc[row], w2s[col + 1],
                           b2[col + 1]);
        if (gamma) {
          o0 = __fmul_rn(o0, gamma[col]);
          o1 = __fmul_rn(o1, gamma[col + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)gr * C + col) =
            __floats2bfloat162_rn(__fadd_rn(xf.x, o0), __fadd_rn(xf.y, o1));
      }
    }
  }
}

template <int C>
int launch_int8(const void* x, const void* y, const void* ln_s,
                const void* ln_b, const void* w1q, const void* w1s,
                const void* b1, const void* w2q, const void* w2s,
                const void* b2, const void* gamma, void* out, int M,
                cudaStream_t stream) {
  const int blocks = (M + Q8_BM - 1) / Q8_BM;
  convnext_int8_kernel<C><<<blocks, Q8_THREADS, 0, stream>>>(
      (const bf16*)x, (const bf16*)y, (const float*)ln_s, (const float*)ln_b,
      (const int8_t*)w1q, (const float*)w1s, (const float*)b1,
      (const int8_t*)w2q, (const float*)w2s, (const float*)b2,
      (const float*)gamma, (bf16*)out, M);
  return (int)cudaGetLastError();
}

}  // namespace emp

extern "C" {

// C must be one of 96, 192, 384, 768 (ConvNeXt-tiny widths).
int emp_convnext_block_int8(const void* x, const void* y, const void* ln_s,
                            const void* ln_b, const void* w1q,
                            const void* w1s, const void* b1, const void* w2q,
                            const void* w2s, const void* b2,
                            const void* gamma, void* out, int M, int C,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 96:
      return emp::launch_int8<96>(x, y, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, gamma, out, M, s);
    case 192:
      return emp::launch_int8<192>(x, y, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, gamma, out, M, s);
    case 384:
      return emp::launch_int8<384>(x, y, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, gamma, out, M, s);
    case 768:
      return emp::launch_int8<768>(x, y, ln_s, ln_b, w1q, w1s, b1, w2q, w2s, b2, gamma, out, M, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
