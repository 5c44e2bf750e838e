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
// C <= 384, three kernels:
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
//    hold them, so the weight gradients leave the row pass.
// 2. atb_kernel<TM, TN>: out = A^T B for A (M, N1), B (M, N2) bf16 row-major,
//    f32 accumulation: dW1 = dhpre^T z and dW2 = do^T h.  wmma 16x16x16
//    tiles over a (TM x TN) output tile, M streamed in 32-row steps through
//    shared memory, split over M when the output has too few tiles to fill
//    the card.
// 3. colsum_kernel: out[j] = sum_i part[i, j] in a fixed order, which
//    reduces the per-block and per-split partial sums.
//
// C = 768 (the wide variant), a chain of row passes and the shared Hopper
// GEMM of gemm_sm90.cuh (TMA loads, mbarrier ring, wgmma), every product
// on the tensor cores at their rate instead of one 16-row block
// re-reading 4.7 MB of weights per product from L2:
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
// 4. Row pass B: dzhat = dz * ln_s, its row means m1 and m2 (against
//    zhat), dy = bf16(rstd (dzhat - m1 - zhat m2)), column partials of
//    dz * zhat (dlns) and dz (dlnb).
// 5. colsum_kernel reduces the (P, 8C) partials, P = 8 per 128 rows.
// 6. dW1 = dhpre^T z and dW2 = doc^T h as MN-major GEMMs (K = M, f32
//    out), each tile over all of M.  At the train shapes (M = 6144 and
//    2048 at batch 2) their 72 tiles leave 60 of 132 SMs idle; a split
//    over M would fill them at the price of a sum over the splits, and
//    none is made.

#include "gemm_sm90.cuh"

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

// ---- C = 768: the wide chain ---------------------------------------------

constexpr int WB_RB = 16;       // rows a block of the wide row passes
constexpr int WB_DUAL_BN = 128; // dual GEMMs: two 64-register accumulators
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
__global__ void __launch_bounds__(128) wide_rows_a_kernel(
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
__global__ void __launch_bounds__(128) wide_rows_b_kernel(
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
                                      int n0, int c, int t,
                                      unsigned char*) const {
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
                                      int n0, int c, int t,
                                      unsigned char*) const {
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

// A^T B epilogue: the f32 tile into out (M, N), rows < M and columns < N.
struct EpiF32 : EpiBase {
  float* out;
  int M, N;

  template <int BN, int NACC>
  __device__ __forceinline__ void run(float (&d)[NACC][BN / 2], int m0,
                                      int n0, int c, int t,
                                      unsigned char*) const {
    const int warp = t >> 5, lane = t & 31;
    const int r0 = m0 + 64 * c + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        if (row < M && col < N)
          *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
              make_float2(d[0][4 * j + 2 * hh], d[0][4 * j + 2 * hh + 1]);
      }
    }
  }
};

// out (N1, N2) f32 = A^T B for A (M, N1), B (M, N2) bf16 through the
// MN-major GEMM, K = M.
static int wide_atb(const void* A, const void* B, float* out, int M, int N1,
                    int N2, cudaStream_t st) {
  GemmArgs<1> g;
  const void* pa[1] = {A};
  const void* pb[1] = {B};
  if (!gemm_args<WB_ATB_BN, true, 1>(&g, pa, pb, N1, N2, M))
    return (int)cudaErrorInvalidValue;
  EpiF32 epi;
  epi.out = out;
  epi.M = N1;
  epi.N = N2;
  return launch_gemm<EpiF32, WB_ATB_BN, true, 1, WB_ATB_STAGES>(g, epi, st);
}

static int epilogue_bwd_wide(const void* y, const void* g, const void* ln_s,
                             const void* ln_b, const void* w1, const void* b1,
                             const void* w2, const void* b2,
                             const void* gamma, void* w1t, void* w2t,
                             void* dy, void* z, void* doc, void* h,
                             void* dhpre, void* dz, void* stats, void* part,
                             void* vec, void* dw1, void* dw2, int M, int C,
                             cudaStream_t st) {
  if (M < 1 || C % 8 || C > 1024) return (int)cudaErrorInvalidValue;
  const int H = 4 * C, ld = 8 * C;
  const int P = (M + GM_BM - 1) / GM_BM * 8;  // partial rows
  float* pt = (float*)part;
  int e = launch_transpose(w2, w2t, C, H, st);
  if (!e) e = launch_transpose(w1, w1t, H, C, st);
  if (e) return e;
  wide_rows_a_kernel<<<P, 128, 0, st>>>(
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
  {
    GemmArgs<2> ga;
    const void* pa[2] = {dhpre, h};
    const void* pb[2] = {w1t, w2};
    if (!gemm_args<WB_DUAL_BN, false, 2>(&ga, pa, pb, M, C, H))
      return (int)cudaErrorInvalidValue;
    EpiBwd2 epi;
    epi.b2 = (const float*)b2;
    epi.g = (const bf16*)g;
    epi.dz = (float*)dz;
    epi.part = pt + 7 * C;
    epi.M = M;
    epi.N = C;
    epi.ld = ld;
    e = launch_gemm<EpiBwd2, WB_DUAL_BN, false, 2, WB_DUAL_STAGES>(ga, epi, st);
    if (e) return e;
  }
  wide_rows_b_kernel<<<P, 128, 0, st>>>(
      (const float*)dz, (const bf16*)y, (const float*)stats,
      (const float*)ln_s, (bf16*)dy, pt + 5 * C, M, C, ld);
  if ((e = (int)cudaGetLastError())) return e;
  if ((e = launch_colsum(pt, (float*)vec, P, (long long)ld, st))) return e;
  if ((e = wide_atb(dhpre, z, (float*)dw1, M, H, C, st))) return e;
  return wide_atb(doc, h, (float*)dw2, M, C, H, st);
}

}  // namespace emp

extern "C" {

// Rows per block of the row pass at width C (0 for a width it lacks).
int emp_epilogue_bwd_block_rows(int C) {
  switch (C) {
    case 96: case 192: case 384: return 32;
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


// The wide chain (C = 768; any C a multiple of 8 up to 1024).  Scratch
// from the wrapper: w1t (C, 4C), w2t (4C, C), z, doc (M, C) bf16; h,
// dhpre (M, 4C) bf16; dz (M, C) f32; stats (2M) f32; part (P, 8C) f32
// with P = 8 * ceil(M / 128).  Outputs: dy (M, C) bf16; vec (8C) f32 =
// db1 | db2 | dlns | dlnb | dgamma; dw1 (4C, C), dw2 (C, 4C) f32.
int emp_epilogue_bwd_wide(const void* y, const void* g, const void* ln_s,
                          const void* ln_b, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* gamma,
                          void* w1t, void* w2t, void* dy, void* z, void* doc,
                          void* h, void* dhpre, void* dz, void* stats,
                          void* part, void* vec, void* dw1, void* dw2, int M,
                          int C, void* stream) {
  return emp::epilogue_bwd_wide(y, g, ln_s, ln_b, w1, b1, w2, b2, gamma, w1t,
                                w2t, dy, z, doc, h, dhpre, dz, stats, part,
                                vec, dw1, dw2, M, C, (cudaStream_t)stream);
}

}  // extern "C"
