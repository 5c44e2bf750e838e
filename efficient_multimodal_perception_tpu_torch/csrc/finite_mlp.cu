// The point projector's per-plane MLP over the raw axis pools:
// out = relu(finite0(x) @ W1^T + b1) @ W2^T + b2, where finite0 turns the
// -inf that the pools leave in empty cells into 0.
//
// Replaces finite_mlp_fused
// (efficient_multimodal_perception_tpu/ops/pallas_kernels.py:
// finite_mlp_fused, _finite_mlp_impl, _finite_mlp_kernel).
//
// What bounds it on an H100: bytes.  At serve batch 4 the xy plane is
// x (65536, 2560) bf16, 335.5 MB read once, against 2*M*K*128 + 2*M*128^2
// = 45.1 GFLOP: 134 flop/byte, under the ~295 ridge, so the x stream sets
// the time (0.105 ms at 3.35 TB/s; the yz and xz planes, (40960, 3200),
// 0.082 ms each).  Neither the cleaned x nor the hidden h may touch device
// memory: writing the cleaned pools back alone would double the bytes.
//
// Design: a block owns 128 rows and all 128 hidden columns (8 warps,
// each 32 x 64 as 2 x 4 wmma bf16 16x16x16 tiles with f32 accumulators)
// and streams K in chunks of 32.  The TPU kernel kept W1 resident in
// VMEM; at K = 2560 / 3200 W1 is 640 / 800 KB, over the 227 KB of shared
// memory a block may use, so here each chunk of W1 (128 x 32) comes in
// beside the matching x chunk (128 x 32), from L2 (W1 stays there: every
// block reads all of it).  The next chunk's global loads are issued into
// registers before the current chunk's products, so they are in flight
// while the tensor cores work; the x chunk is cleaned (-inf -> 0, on the
// bf16 bits) as it goes from registers to shared memory.  After the
// last chunk the block adds b1, applies ReLU and rounds h to bf16 in
// shared memory (reusing the chunk buffers), then multiplies it by W2,
// whose wmma fragments are read straight from global memory (32 KB, in
// L2), adds b2 and writes the bf16 rows.  Rows past M load as zeros and
// are not stored.  Simple first: no TMA, no wgmma.

#include "common.cuh"

using namespace nvcuda;

namespace emp {

constexpr int FM_BM = 128;            // rows per block
constexpr int FM_N = 128;             // hidden = output width
constexpr int FM_BK = 32;             // K chunk
constexpr int FM_LDK = FM_BK + 8;     // bf16 stride of the staged chunks
constexpr int FM_LDH = FM_N + 8;      // bf16 stride of h
constexpr int FM_THREADS = 256;
constexpr int FM_CHUNK_VECS = FM_BM * FM_BK / 8 / FM_THREADS;  // 2
constexpr size_t FM_STAGE_BYTES = (size_t)2 * FM_BM * FM_LDK * 2;
constexpr size_t FM_H_BYTES = (size_t)FM_BM * FM_LDH * 2;
constexpr size_t FM_BUF_BYTES =
    FM_STAGE_BYTES > FM_H_BYTES ? FM_STAGE_BYTES : FM_H_BYTES;
// one (row, column) map stages both chunks: x has BM rows, W1 N rows
static_assert(FM_BM == FM_N, "x and W1 chunks share their thread map");

// Zero every bf16 -inf (0xFF80) of an 8-value vector; other values,
// NaN and +inf included, pass unchanged (the TPU kernel's
// where(x == -inf, 0, x)).
__device__ __forceinline__ uint4 zero_neg_inf8(uint4 u) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t lo = w[i] & 0xFFFFu, hi = w[i] >> 16;
    lo = lo == 0xFF80u ? 0u : lo;
    hi = hi == 0xFF80u ? 0u : hi;
    w[i] = lo | (hi << 16);
  }
  return u;
}

__global__ void __launch_bounds__(FM_THREADS, 2) finite_mlp_kernel(
    const bf16* __restrict__ x,    // (M, K) raw pools
    const bf16* __restrict__ w1,   // (128, K), nn.Linear layout
    const float* __restrict__ b1,  // (128,)
    const bf16* __restrict__ w2,   // (128, 128), nn.Linear layout
    const float* __restrict__ b2,  // (128,)
    bf16* __restrict__ out,        // (M, 128)
    int M, int K) {
  __shared__ __align__(32) unsigned char buf[FM_BUF_BYTES];
  __shared__ __align__(32) float Cs[8][16 * 16];
  bf16* As = reinterpret_cast<bf16*>(buf);  // BM x LDK, x chunk
  bf16* Bs = As + FM_BM * FM_LDK;           // N x LDK, W1 chunk
  bf16* Hs = reinterpret_cast<bf16*>(buf);  // BM x LDH, after the K loop

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * FM_BM;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  // this thread's vectors of a chunk: row r, 8 columns from c
  int vr[FM_CHUNK_VECS], vc[FM_CHUNK_VECS];
#pragma unroll
  for (int i = 0; i < FM_CHUNK_VECS; ++i) {
    const int t = tid + i * FM_THREADS;
    vr[i] = t >> 2;
    vc[i] = (t & 3) * 8;
  }
  uint4 xa[FM_CHUNK_VECS], wa[FM_CHUNK_VECS];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int i = 0; i < FM_CHUNK_VECS; ++i) {
      const int gr = m0 + vr[i];
      xa[i] = gr < M ? ld16(x + (size_t)gr * K + k0 + vc[i])
                     : make_uint4(0u, 0u, 0u, 0u);
      wa[i] = ld16(w1 + (size_t)vr[i] * K + k0 + vc[i]);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load_chunk(0);
  for (int k0 = 0; k0 < K; k0 += FM_BK) {
#pragma unroll
    for (int i = 0; i < FM_CHUNK_VECS; ++i) {
      st16(&As[vr[i] * FM_LDK + vc[i]], zero_neg_inf8(xa[i]));
      st16(&Bs[vr[i] * FM_LDK + vc[i]], wa[i]);
    }
    __syncthreads();
    if (k0 + FM_BK < K) load_chunk(k0 + FM_BK);
#pragma unroll
    for (int kk = 0; kk < FM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm + 16 * i) * FM_LDK + kk], FM_LDK);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], &Bs[(wn + 16 * j) * FM_LDK + kk], FM_LDK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // h = bf16(relu(acc + b1)) into shared memory (the chunk buffers are
  // free: the loop ended on a barrier)
  float* cs = Cs[warp];
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int hc = wn + 16 * j + ec;
      float f[8];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        f[t] = fmaxf(cs[er * 16 + ec + t] + b1[hc + t], 0.f);
      st16(&Hs[(wm + 16 * i + er) * FM_LDH + hc], pack8(f));
      __syncwarp();
    }
  }
  __syncthreads();

  // out = h @ W2^T + b2
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
  for (int kk = 0; kk < FM_N; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], &Hs[(wm + 16 * i) * FM_LDH + kk], FM_LDH);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::load_matrix_sync(b[j], w2 + (size_t)(wn + 16 * j) * FM_N + kk, FM_N);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm + 16 * i + er, gc = wn + 16 * j + ec;
      if (gr < M) {
        float f[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) f[t] = cs[er * 16 + ec + t] + b2[gc + t];
        st16(out + (size_t)gr * FM_N + gc, pack8(f));
      }
      __syncwarp();
    }
  }
}

}  // namespace emp

extern "C" {

// Shapes: w1 (128, K), w2 (128, 128), K % 32 == 0, any M >= 1 (the
// wrapper checks).
int emp_finite_mlp(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, int M, int K,
                   void* stream) {
  const int blocks = (M + emp::FM_BM - 1) / emp::FM_BM;
  emp::finite_mlp_kernel<<<blocks, emp::FM_THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const emp::bf16*)x, (const emp::bf16*)w1, (const float*)b1,
      (const emp::bf16*)w2, (const float*)b2, (emp::bf16*)out, M, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
