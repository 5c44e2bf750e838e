// ConvNeXt block epilogue: out = x + gamma * (fc2(GELU(fc1(LN(y)) + b1)) + b2)
// over the (M, C) row view, y being the 7x7 depthwise-conv output that
// the wrapper computes outside the kernel.  With RESID = false the same
// kernel computes the residual-free epilogue gamma * MLP(LN(y)) of the
// training path, where stochastic depth sits between it and the residual.
//
// Replaces convnext_block_fused
// (efficient_multimodal_perception_tpu/ops/pallas_kernels.py:
// convnext_block_fused, _block_fused_impl, _post_kernel) and, with
// RESID = false, epilogue_fused (_epilogue_impl, _epilogue_kernel).
//
// What bounds it on an H100: operations.  A row costs 16*C^2 flops
// (two GEMMs C <-> 4C) against 6*C bytes (x and y read, out written), so
// the intensity is 8*C/3 flop/byte: 256 at C=96 (just under the
// ~295 ridge) and 2048 at C=768.
//
// Design: a block owns 32 rows.  It takes two-pass f32 LayerNorm
// statistics of its rows, keeps the normalized rows (32 x C bf16) in
// shared memory, and streams the hidden dimension 4C in chunks of 128:
// fc1 for the chunk (wmma bf16 16x16x16, f32 accumulators), bias and
// exact GELU in f32, the chunk back to shared memory as bf16, then fc2's
// partial product accumulated into f32 fragments that stay in registers
// for the whole block (C/64 per warp; 12 at C=768).  The TPU kernel held
// the whole (R, 4C) hidden tile in VMEM; at C=768 that is 384 KB for 64
// rows in bf16, over the 227 KB a block may use, so the chunked hidden
// dimension is what makes the block fit: 66 KB of shared memory at
// C=768.  Weights are read as wmma fragments straight from global
// memory; they are at most 4.7 MB and stay in the 50 MB L2.  Simple
// first: no cp.async pipeline, no wgmma.

#include "common.cuh"

using namespace nvcuda;

namespace emp {

constexpr int CB_BM = 32;
constexpr int CB_HC = 128;  // hidden chunk width
constexpr int CB_LDH = CB_HC + 8;
constexpr int CB_THREADS = 256;

// 8 values of a row, or zeros past the last row.
__device__ __forceinline__ void load_row8(const bf16* p, bool live, float* f) {
  if (live) {
    unpack8(ld16(p), f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = 0.f;
  }
}

template <int C>
constexpr size_t cb_smem_bytes() {
  return (size_t)CB_BM * (C + 8) * 2 + (size_t)CB_BM * CB_LDH * 2 +
         8 * 256 * 4;
}

template <int C, bool RESID>
__global__ void __launch_bounds__(CB_THREADS) convnext_post_kernel(
    const bf16* __restrict__ x,      // (M, C) residual input (RESID only)
    const bf16* __restrict__ y,      // (M, C) dwconv output
    const float* __restrict__ ln_s,  // (C,)
    const float* __restrict__ ln_b,  // (C,)
    const bf16* __restrict__ w1,     // (4C, C), nn.Linear layout
    const float* __restrict__ b1,    // (4C,)
    const bf16* __restrict__ w2,     // (C, 4C), nn.Linear layout
    const float* __restrict__ b2,    // (C,)
    const float* __restrict__ gamma, // (C,) or null
    bf16* __restrict__ out,          // (M, C)
    int M) {
  constexpr int LDZ = C + 8;
  constexpr int HID = 4 * C;
  constexpr int CT = C / 16;        // output column tiles
  constexpr int NF = 2 * CT;        // output fragments of the block
  constexpr int NFW = (NF + 7) / 8; // per warp

  extern __shared__ __align__(32) unsigned char smem[];
  bf16* zs = reinterpret_cast<bf16*>(smem);                // BM x LDZ
  bf16* hs = zs + CB_BM * LDZ;                             // BM x LDH
  float* cs_all = reinterpret_cast<float*>(hs + CB_BM * CB_LDH);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * CB_BM;
  float* cs = cs_all + warp * 256;

  // LayerNorm (eps 1e-6, f32 statistics) -> zs as bf16
  for (int r = warp; r < CB_BM; r += 8) {
    const int gr = m0 + r;
    const bool live = gr < M;
    const bf16* row = y + (size_t)gr * C;
    float s = 0.f;
    for (int c = lane * 8; c < C; c += 256) {
      float f[8];
      load_row8(row + c, live, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += f[i];
    }
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane * 8; c < C; c += 256) {
      float f[8];
      load_row8(row + c, live, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = f[i] - mu;
        v += d * d;
      }
    }
    const float rs = rsqrtf(warp_sum(v) / C + 1e-6f);
    for (int c = lane * 8; c < C; c += 256) {
      float f[8];
      load_row8(row + c, live, f);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        f[i] = (f[i] - mu) * rs * ln_s[c + i] + ln_b[c + i];
      st16(zs + r * LDZ + c, pack8(f));
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[NFW];
#pragma unroll
  for (int t = 0; t < NFW; ++t) wmma::fill_fragment(oacc[t], 0.f);

  const int er = lane >> 1, ec = (lane & 1) * 8;
  for (int j0 = 0; j0 < HID; j0 += CB_HC) {
    // fc1 for hidden columns [j0 + 16*warp, +16), both 16-row tiles
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc[2];
    wmma::fill_fragment(hacc[0], 0.f);
    wmma::fill_fragment(hacc[1], 0.f);
    const bf16* w1p = w1 + (size_t)(j0 + 16 * warp) * C;
    for (int k = 0; k < C; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, w1p + k, C);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, zs + 16 * r * LDZ + k, LDZ);
        wmma::mma_sync(hacc[r], a, b, hacc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wmma::store_matrix_sync(cs, hacc[r], 16, wmma::mem_row_major);
      __syncwarp();
      const int hc = 16 * warp + ec;
      float f[8];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        f[t] = gelu_erf(cs[er * 16 + ec + t] + b1[j0 + hc + t]);
      st16(hs + (16 * r + er) * CB_LDH + hc, pack8(f));
      __syncwarp();
    }
    __syncthreads();

    // fc2 partial product of this chunk into the resident accumulators
#pragma unroll
    for (int t = 0; t < NFW; ++t) {
      const int f = warp + 8 * t;
      if (f < NF) {
        const int rt = f / CT, ct = f % CT;
        const bf16* w2p = w2 + (size_t)(16 * ct) * HID + j0;
#pragma unroll
        for (int kk = 0; kk < CB_HC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(a, hs + 16 * rt * CB_LDH + kk, CB_LDH);
          wmma::load_matrix_sync(b, w2p + kk, HID);
          wmma::mma_sync(oacc[t], a, b, oacc[t]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: + b2, * gamma, + residual (RESID)
#pragma unroll
  for (int t = 0; t < NFW; ++t) {
    const int f = warp + 8 * t;
    if (f < NF) {
      const int rt = f / CT, ct = f % CT;
      wmma::store_matrix_sync(cs, oacc[t], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + 16 * rt + er, gc = 16 * ct + ec;
      if (gr < M) {
        float xf[8], o[8];
        if (RESID) {
          unpack8(ld16(x + (size_t)gr * C + gc), xf);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) xf[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float a = cs[er * 16 + ec + i] + b2[gc + i];
          if (gamma) a *= gamma[gc + i];
          o[i] = xf[i] + a;
        }
        st16(out + (size_t)gr * C + gc, pack8(o));
      }
      __syncwarp();
    }
  }
}

template <int C, bool RESID>
int launch_post(const void* x, const void* y, const void* ln_s,
                const void* ln_b, const void* w1, const void* b1,
                const void* w2, const void* b2, const void* gamma, void* out,
                int M, cudaStream_t stream) {
  const size_t smem = cb_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(
      convnext_post_kernel<C, RESID>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + CB_BM - 1) / CB_BM;
  convnext_post_kernel<C, RESID><<<blocks, CB_THREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)y, (const float*)ln_s, (const float*)ln_b,
      (const bf16*)w1, (const float*)b1, (const bf16*)w2, (const float*)b2,
      (const float*)gamma, (bf16*)out, M);
  return (int)cudaGetLastError();
}

}  // namespace emp

extern "C" {

// C must be one of 96, 192, 384, 768 (ConvNeXt-tiny widths).
int emp_convnext_block_post(const void* x, const void* y, const void* ln_s,
                            const void* ln_b, const void* w1, const void* b1,
                            const void* w2, const void* b2,
                            const void* gamma, void* out, int M, int C,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 96:
      return emp::launch_post<96, true>(x, y, ln_s, ln_b, w1, b1, w2, b2, gamma, out, M, s);
    case 192:
      return emp::launch_post<192, true>(x, y, ln_s, ln_b, w1, b1, w2, b2, gamma, out, M, s);
    case 384:
      return emp::launch_post<384, true>(x, y, ln_s, ln_b, w1, b1, w2, b2, gamma, out, M, s);
    case 768:
      return emp::launch_post<768, true>(x, y, ln_s, ln_b, w1, b1, w2, b2, gamma, out, M, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// gamma * MLP(LN(y)) without the residual; same widths.
int emp_epilogue_fwd(const void* y, const void* ln_s, const void* ln_b,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* gamma, void* out, int M,
                     int C, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 96:
      return emp::launch_post<96, false>(nullptr, y, ln_s, ln_b, w1, b1, w2, b2, gamma, out, M, s);
    case 192:
      return emp::launch_post<192, false>(nullptr, y, ln_s, ln_b, w1, b1, w2, b2, gamma, out, M, s);
    case 384:
      return emp::launch_post<384, false>(nullptr, y, ln_s, ln_b, w1, b1, w2, b2, gamma, out, M, s);
    case 768:
      return emp::launch_post<768, false>(nullptr, y, ln_s, ln_b, w1, b1, w2, b2, gamma, out, M, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
