// Backward of the ConvNeXt block epilogue f(y) = gamma * (fc2(GELU(fc1(LN(y)) + b1)) + b2).
//
// Replaces post_epilogue_bwd (C <= 384) and post_epilogue_bwd_wide
// (C = 768) (efficient_multimodal_perception_tpu/ops/pallas_kernels.py:
// post_epilogue_bwd, _post_bwd_kernel, post_epilogue_bwd_wide,
// _post_bwd_wide_kernel).  One design serves both widths.
//
// What bounds it on an H100: operations.  A row costs 48*C^2 flops (the
// forward's two GEMMs recomputed and four backward products: dh, dz, dW1,
// dW2) against ~4*C bytes of y and g read and dy written.
//
// Design, three kernels:
//
// 1. epilogue_bwd_rows_kernel<C, BM>: a block owns BM rows.  It takes the
//    LayerNorm statistics of its rows, keeps z = LN(y) and do = g * gamma
//    (both bf16, as the TPU kernel rounds them) in shared memory, and
//    streams the hidden dimension 4C in chunks of 128.  Per chunk it
//    recomputes hpre = z W1^T + b1 and forms dh = do W2, then h = GELU(hpre)
//    and dhpre = dh * GELU'(hpre) elementwise (exact erf), and accumulates
//    opre = h W2^T (for dgamma) and dz = dhpre W1 into f32 fragments that
//    stay in registers across chunks.  After the last chunk it runs the
//    LayerNorm backward per row and writes dy.  It also writes z, h, dhpre
//    and do in bf16 for the weight-gradient products, and per-block column
//    partial sums of db1, db2, dlns, dlnb and dgamma.  The TPU kernel keeps
//    the (C, 4C) weight-gradient accumulators in VMEM across its sequential
//    grid; Hopper blocks run in no order and 227 KB of shared memory cannot
//    hold them, so the weight gradients leave the row pass.  At C = 768 two
//    register-resident accumulators fit only with 16-row blocks.
// 2. atb_kernel<TM, TN>: out = A^T B for A (M, N1), B (M, N2) bf16 row-major,
//    f32 accumulation: dW1 = dhpre^T z and dW2 = do^T h.  wmma 16x16x16
//    tiles over a (TM x TN) output tile, M streamed in 32-row steps through
//    shared memory, split over M when the output has too few tiles to fill
//    the card.
// 3. colsum_kernel: out[j] = sum_i part[i, j] in a fixed order, which
//    reduces the per-block and per-split partial sums deterministically
//    (no float atomics), so two runs give the same gradients.
//
// Simple first: no cp.async pipeline, no wgmma.

#include "common.cuh"

using namespace nvcuda;

namespace emp {

constexpr int EB_HC = 128;  // hidden chunk width
constexpr int EB_LDH = EB_HC + 8;
constexpr int EB_THREADS = 256;

template <int C, int BM>
constexpr size_t eb_smem_bytes() {
  // zs + ds (aliased by the f32 dz tile after the chunk loop), hs + dhs,
  // two 16x16 f32 scratch tiles per warp, row statistics
  return (size_t)2 * BM * (C + 8) * 2 + (size_t)2 * BM * EB_LDH * 2 +
         8 * 2 * 256 * 4 + 2 * BM * 4;
}

// Sum over the 16 rows of a fragment tile: lanes (2*er + half) hold 8
// columns each; reduce across er (lane bits 1..4).
__device__ __forceinline__ void rows_reduce8(float* v) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = 2; o < 32; o <<= 1)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
}

template <int C, int BM>
__global__ void __launch_bounds__(EB_THREADS) epilogue_bwd_rows_kernel(
    const bf16* __restrict__ y,      // (M, C) dwconv output
    const bf16* __restrict__ g,      // (M, C) upstream gradient of f(y)
    const float* __restrict__ ln_s,  // (C,)
    const float* __restrict__ ln_b,  // (C,)
    const bf16* __restrict__ w1,     // (4C, C), nn.Linear layout
    const float* __restrict__ b1,    // (4C,)
    const bf16* __restrict__ w2,     // (C, 4C), nn.Linear layout
    const float* __restrict__ b2,    // (C,)
    const float* __restrict__ gamma, // (C,)
    bf16* __restrict__ dy,           // (M, C)
    bf16* __restrict__ z_out,        // (M, C)
    bf16* __restrict__ h_out,        // (M, 4C)
    bf16* __restrict__ dhpre_out,    // (M, 4C)
    bf16* __restrict__ do_out,       // (M, C)
    float* __restrict__ part,        // (gridDim.x, 8C): db1|db2|dlns|dlnb|dgamma
    int M) {
  constexpr int LDZ = C + 8;
  constexpr int HID = 4 * C;
  constexpr int RT = BM / 16;          // row tiles
  constexpr int CT = C / 16;           // output column tiles
  constexpr int NCW = (CT + 7) / 8;    // column tiles per warp
  constexpr int PW = 8 * C;            // partial-row width

  extern __shared__ __align__(32) unsigned char smem[];
  bf16* zs = reinterpret_cast<bf16*>(smem);    // BM x LDZ
  bf16* ds = zs + BM * LDZ;                    // BM x LDZ (do, bf16)
  float* dzs = reinterpret_cast<float*>(smem); // BM x LDZ f32, after the loop
  bf16* hs = ds + BM * LDZ;                    // BM x EB_LDH
  bf16* dhs = hs + BM * EB_LDH;                // BM x EB_LDH
  float* cs_all = reinterpret_cast<float*>(dhs + BM * EB_LDH);
  float* mu_s = cs_all + 8 * 2 * 256;
  float* rs_s = mu_s + BM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  float* cs0 = cs_all + warp * 512;
  float* cs1 = cs0 + 256;
  float* prow = part + (size_t)blockIdx.x * PW;
  const int er = lane >> 1, ec = (lane & 1) * 8;

  // ---- LayerNorm statistics, z and do ------------------------------------
  for (int r = warp; r < BM; r += 8) {
    const int gr = m0 + r;
    const bool live = gr < M;
    const bf16* row = y + (size_t)gr * C;
    float s = 0.f;
    for (int c = lane * 8; c < C; c += 256) {
      float f[8];
      if (live) unpack8(ld16(row + c), f);
      else for (int i = 0; i < 8; ++i) f[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += f[i];
    }
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane * 8; c < C; c += 256) {
      float f[8];
      if (live) unpack8(ld16(row + c), f);
      else for (int i = 0; i < 8; ++i) f[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = f[i] - mu;
        v += d * d;
      }
    }
    const float rs = rsqrtf(warp_sum(v) / C + 1e-6f);
    if (lane == 0) {
      mu_s[r] = mu;
      rs_s[r] = rs;
    }
    for (int c = lane * 8; c < C; c += 256) {
      float f[8], o[8];
      if (live) {
        unpack8(ld16(row + c), f);
        unpack8(ld16(g + (size_t)gr * C + c), o);
      } else {
        for (int i = 0; i < 8; ++i) f[i] = o[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        f[i] = (f[i] - mu) * rs * ln_s[c + i] + ln_b[c + i];
        o[i] *= gamma[c + i];
      }
      const uint4 zp = pack8(f), op = pack8(o);
      st16(zs + r * LDZ + c, zp);
      st16(ds + r * LDZ + c, op);
      if (live) {
        st16(z_out + (size_t)gr * C + c, zp);
        st16(do_out + (size_t)gr * C + c, op);
      }
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[NCW][RT];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> zacc[NCW][RT];
#pragma unroll
  for (int i = 0; i < NCW; ++i)
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      wmma::fill_fragment(oacc[i][r], 0.f);
      wmma::fill_fragment(zacc[i][r], 0.f);
    }

  for (int j0 = 0; j0 < HID; j0 += EB_HC) {
    // hpre = z W1^T and dh = do W2 for hidden columns [j0 + 16 warp, +16)
    const int jc = j0 + 16 * warp;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc[RT], dacc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      wmma::fill_fragment(hacc[r], 0.f);
      wmma::fill_fragment(dacc[r], 0.f);
    }
    for (int k = 0; k < C; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw1;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw2;
      wmma::load_matrix_sync(bw1, w1 + (size_t)jc * C + k, C);
      wmma::load_matrix_sync(bw2, w2 + (size_t)k * HID + jc, HID);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, zs + 16 * r * LDZ + k, LDZ);
        wmma::mma_sync(hacc[r], a, bw1, hacc[r]);
        wmma::load_matrix_sync(a, ds + 16 * r * LDZ + k, LDZ);
        wmma::mma_sync(dacc[r], a, bw2, dacc[r]);
      }
    }
    float db1[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) db1[t] = 0.f;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      wmma::store_matrix_sync(cs0, hacc[r], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(cs1, dacc[r], 16, wmma::mem_row_major);
      __syncwarp();
      float hf[8], df[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float hp = cs0[er * 16 + ec + t] + b1[jc + ec + t];
        const float phi = 0.5f * (1.0f + erff(hp * 0.70710678118654752f));
        const float pdf = 0.3989422804014327f * expf(-0.5f * hp * hp);
        hf[t] = hp * phi;
        df[t] = cs1[er * 16 + ec + t] * (phi + hp * pdf);
        db1[t] += df[t];
      }
      const uint4 hp8 = pack8(hf), dp8 = pack8(df);
      const int lr = 16 * r + er;
      st16(hs + lr * EB_LDH + 16 * warp + ec, hp8);
      st16(dhs + lr * EB_LDH + 16 * warp + ec, dp8);
      if (m0 + lr < M) {
        st16(h_out + (size_t)(m0 + lr) * HID + jc + ec, hp8);
        st16(dhpre_out + (size_t)(m0 + lr) * HID + jc + ec, dp8);
      }
      __syncwarp();
    }
    rows_reduce8(db1);
    if (lane < 2) {
#pragma unroll
      for (int t = 0; t < 8; ++t) prow[jc + ec + t] = db1[t];
    }
    __syncthreads();

    // opre += h W2^T and dz += dhpre W1 over this chunk
#pragma unroll
    for (int i = 0; i < NCW; ++i) {
      const int ct = warp + 8 * i;
      if (ct < CT) {
#pragma unroll
        for (int kk = 0; kk < EB_HC; kk += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bo;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bz;
          wmma::load_matrix_sync(bo, w2 + (size_t)(16 * ct) * HID + j0 + kk, HID);
          wmma::load_matrix_sync(bz, w1 + (size_t)(j0 + kk) * C + 16 * ct, C);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::load_matrix_sync(a, hs + 16 * r * EB_LDH + kk, EB_LDH);
            wmma::mma_sync(oacc[i][r], a, bo, oacc[i][r]);
            wmma::load_matrix_sync(a, dhs + 16 * r * EB_LDH + kk, EB_LDH);
            wmma::mma_sync(zacc[i][r], a, bz, zacc[i][r]);
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- dgamma partial: sum over rows of g * (opre + b2) ------------------
#pragma unroll
  for (int i = 0; i < NCW; ++i) {
    const int ct = warp + 8 * i;
    if (ct < CT) {
      const int gc = 16 * ct + ec;
      float dg[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) dg[t] = 0.f;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        wmma::store_matrix_sync(cs0, oacc[i][r], 16, wmma::mem_row_major);
        __syncwarp();
        const int gr = m0 + 16 * r + er;
        if (gr < M) {
          float gv[8];
          unpack8(ld16(g + (size_t)gr * C + gc), gv);
#pragma unroll
          for (int t = 0; t < 8; ++t)
            dg[t] += gv[t] * (cs0[er * 16 + ec + t] + b2[gc + t]);
        }
        __syncwarp();
      }
      rows_reduce8(dg);
      if (lane < 2) {
#pragma unroll
        for (int t = 0; t < 8; ++t) prow[7 * C + gc + t] = dg[t];
      }
    }
  }

  // ---- dz to shared memory (over zs/ds, no longer read) ------------------
#pragma unroll
  for (int i = 0; i < NCW; ++i) {
    const int ct = warp + 8 * i;
    if (ct < CT) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
        wmma::store_matrix_sync(dzs + 16 * r * LDZ + 16 * ct, zacc[i][r], LDZ,
                                wmma::mem_row_major);
    }
  }
  __syncthreads();

  // ---- column partials db2, dlns, dlnb (rows in order) -------------------
  for (int c = tid; c < C; c += EB_THREADS) {
    float sdo = 0.f, sdzz = 0.f, sdz = 0.f;
    const float gm = gamma[c];
    for (int r = 0; r < BM; ++r) {
      const int gr = m0 + r;
      if (gr >= M) break;
      const float dz = dzs[r * LDZ + c];
      const float zh =
          (__bfloat162float(y[(size_t)gr * C + c]) - mu_s[r]) * rs_s[r];
      sdo += __bfloat162float(g[(size_t)gr * C + c]) * gm;
      sdzz += dz * zh;
      sdz += dz;
    }
    prow[4 * C + c] = sdo;
    prow[5 * C + c] = sdzz;
    prow[6 * C + c] = sdz;
  }

  // ---- LayerNorm backward per row -> dy ----------------------------------
  for (int r = warp; r < BM; r += 8) {
    const int gr = m0 + r;
    if (gr >= M) break;
    const float mu = mu_s[r], rs = rs_s[r];
    const bf16* row = y + (size_t)gr * C;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * 8; c < C; c += 256) {
      float f[8];
      unpack8(ld16(row + c), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dzh = dzs[r * LDZ + c + i] * ln_s[c + i];
        s1 += dzh;
        s2 += dzh * (f[i] - mu) * rs;
      }
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
    for (int c = lane * 8; c < C; c += 256) {
      float f[8];
      unpack8(ld16(row + c), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float zh = (f[i] - mu) * rs;
        const float dzh = dzs[r * LDZ + c + i] * ln_s[c + i];
        f[i] = rs * (dzh - m1 - zh * m2);
      }
      st16(dy + (size_t)gr * C + c, pack8(f));
    }
  }
}

constexpr int AT_KT = 32;  // rows of M per step of the A^T B kernel

template <int TM, int TN>
__global__ void __launch_bounds__(128) atb_kernel(
    const bf16* __restrict__ A,  // (M, N1)
    const bf16* __restrict__ B,  // (M, N2)
    float* __restrict__ out,     // (splits, N1, N2)
    int M, int N1, int N2, int rows_per_split) {
  constexpr int LDA = TM + 8, LDB = TN + 8;
  constexpr int FM = TM / 32, FN = TN / 32;  // fragments per warp (2x2 warps)
  __shared__ __align__(32) bf16 As[AT_KT * LDA];
  __shared__ __align__(32) bf16 Bs[AT_KT * LDB];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wy = warp >> 1, wx = warp & 1;
  const int n1 = blockIdx.y * TM, n2 = blockIdx.x * TN;
  const int r0 = blockIdx.z * rows_per_split;
  const int r1 = min(M, r0 + rows_per_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = r0; k0 < r1; k0 += AT_KT) {
    for (int t = tid; t < AT_KT * TM / 8; t += 128) {
      const int r = t / (TM / 8), c = (t % (TM / 8)) * 8;
      st16(As + r * LDA + c,
           k0 + r < r1 ? ld16(A + (size_t)(k0 + r) * N1 + n1 + c) : zero);
    }
    for (int t = tid; t < AT_KT * TN / 8; t += 128) {
      const int r = t / (TN / 8), c = (t % (TN / 8)) * 8;
      st16(Bs + r * LDB + c,
           k0 + r < r1 ? ld16(B + (size_t)(k0 + r) * N2 + n2 + c) : zero);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < AT_KT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + kk * LDA + wy * (TM / 2) + 16 * i,
                               LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs + kk * LDB + wx * (TN / 2) + 16 * j, LDB);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* o = out + (size_t)blockIdx.z * N1 * N2;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(
          o + (size_t)(n1 + wy * (TM / 2) + 16 * i) * N2 + n2 + wx * (TN / 2) +
              16 * j,
          acc[i][j], N2, wmma::mem_row_major);
}

// out[j] = sum over i of part[i, j], i ascending within each of 16 lanes,
// then the 16 lane sums in order: a fixed order, so the result is the
// same on every run.
__global__ void __launch_bounds__(512) colsum_kernel(
    const float* __restrict__ part, float* __restrict__ out, int rows,
    long long cols) {
  __shared__ float red[16][33];
  const long long j = (long long)blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (j < cols)
    for (int i = threadIdx.y; i < rows; i += 16) s += part[(size_t)i * cols + j];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < cols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) t += red[i][threadIdx.x];
    out[j] = t;
  }
}

int launch_colsum(const float* part, float* out, int rows, long long cols,
                  cudaStream_t s) {
  const dim3 block(32, 16);
  const long long grid = (cols + 31) / 32;
  colsum_kernel<<<(unsigned)grid, block, 0, s>>>(part, out, rows, cols);
  return (int)cudaGetLastError();
}

template <int C, int BM>
int launch_rows(const void* y, const void* g, const void* ln_s,
                const void* ln_b, const void* w1, const void* b1,
                const void* w2, const void* b2, const void* gamma, void* dy,
                void* z, void* h, void* dhpre, void* dout, void* part,
                int M, cudaStream_t s) {
  const size_t smem = eb_smem_bytes<C, BM>();
  cudaError_t err = cudaFuncSetAttribute(
      epilogue_bwd_rows_kernel<C, BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + BM - 1) / BM;
  epilogue_bwd_rows_kernel<C, BM><<<blocks, EB_THREADS, smem, s>>>(
      (const bf16*)y, (const bf16*)g, (const float*)ln_s, (const float*)ln_b,
      (const bf16*)w1, (const float*)b1, (const bf16*)w2, (const float*)b2,
      (const float*)gamma, (bf16*)dy, (bf16*)z, (bf16*)h, (bf16*)dhpre,
      (bf16*)dout, (float*)part, M);
  return (int)cudaGetLastError();
}

}  // namespace emp

extern "C" {

// Rows per block of the row pass at width C (0 for a width it lacks).
int emp_epilogue_bwd_block_rows(int C) {
  switch (C) {
    case 96: case 192: case 384: return 32;
    case 768: return 16;
    default: return 0;
  }
}

// Row pass.  part: (ceil(M / block_rows), 8C) f32 per-block partials.
int emp_epilogue_bwd_rows(const void* y, const void* g, const void* ln_s,
                          const void* ln_b, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* gamma,
                          void* dy, void* z, void* h, void* dhpre,
                          void* dout, void* part, int M, int C,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 96:
      return emp::launch_rows<96, 32>(y, g, ln_s, ln_b, w1, b1, w2, b2, gamma, dy, z, h, dhpre, dout, part, M, s);
    case 192:
      return emp::launch_rows<192, 32>(y, g, ln_s, ln_b, w1, b1, w2, b2, gamma, dy, z, h, dhpre, dout, part, M, s);
    case 384:
      return emp::launch_rows<384, 32>(y, g, ln_s, ln_b, w1, b1, w2, b2, gamma, dy, z, h, dhpre, dout, part, M, s);
    case 768:
      return emp::launch_rows<768, 16>(y, g, ln_s, ln_b, w1, b1, w2, b2, gamma, dy, z, h, dhpre, dout, part, M, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out (N1, N2) f32 = A^T B for A (M, N1), B (M, N2) bf16.  N1, N2 multiples
// of 32.  With splits > 1, part holds (splits, N1, N2) f32 scratch and the
// splits are summed into out in a fixed order.
int emp_atb(const void* A, const void* B, void* out, void* part, int M,
            int N1, int N2, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N1 % 32 || N2 % 32 || splits < 1) return (int)cudaErrorInvalidValue;
  const int rps = ((M + splits - 1) / splits + emp::AT_KT - 1) / emp::AT_KT *
                  emp::AT_KT;
  float* dst = splits > 1 ? (float*)part : (float*)out;
  const bool m64 = N1 % 64 == 0, n64 = N2 % 64 == 0;
  const dim3 grid(N2 / (n64 ? 64 : 32), N1 / (m64 ? 64 : 32), splits);
  const emp::bf16* a = (const emp::bf16*)A;
  const emp::bf16* b = (const emp::bf16*)B;
  if (m64 && n64) emp::atb_kernel<64, 64><<<grid, 128, 0, s>>>(a, b, dst, M, N1, N2, rps);
  else if (m64) emp::atb_kernel<64, 32><<<grid, 128, 0, s>>>(a, b, dst, M, N1, N2, rps);
  else if (n64) emp::atb_kernel<32, 64><<<grid, 128, 0, s>>>(a, b, dst, M, N1, N2, rps);
  else emp::atb_kernel<32, 32><<<grid, 128, 0, s>>>(a, b, dst, M, N1, N2, rps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return emp::launch_colsum((const float*)part, (float*)out, splits,
                            (long long)N1 * N2, s);
}

// out (cols,) f32 = column sums of part (rows, cols) f32, fixed order.
int emp_colsum(const void* part, void* out, int rows, long long cols,
               void* stream) {
  return emp::launch_colsum((const float*)part, (float*)out, rows, cols,
                            (cudaStream_t)stream);
}

}  // extern "C"
