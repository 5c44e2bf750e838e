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
// Design: the Hopper GEMM family's shape (gemm_sm90.cuh's primitives),
// persistent, one CTA an SM walking 128-row tiles.  A producer warpgroup
// (one thread) keeps TMA loads in flight through a 4-stage mbarrier ring:
// each stage is a 128 x 64 x tile and the matching 128 x 64 W1 tile, both
// with 128-byte swizzle (W1 is 640 / 800 KB, over the 227 KB of shared
// memory a block may use, so its tiles stream beside x's from L2, where
// every CTA finds them).  Two consumer warpgroups own 64 rows each: they
// zero the bf16 -inf pattern (0xFF80) of their rows in the shared x tile
// (NaN and +inf pass unchanged), fence the generic writes for the async
// proxy, and run wgmma m64n128k16 on the tile (f32 accumulators, the
// first k-step overwriting them).  After the last K step each adds b1,
// applies ReLU and rounds h to bf16 into shared memory in the swizzled
// K-major layout wgmma reads, then runs the second product against W2
// (128 x 128 bf16, 32 KB, TMA-loaded once a CTA), adds b2 and stores the
// bf16 rows through the same shared tile and TMA.  Loads past M, and past
// K (any K % 8 == 0), are zero-filled, stores past M clipped.  The
// accumulators are 64 registers a thread, inside the 168 the launch
// bound allows, so no register moves between warpgroups (setmaxnreg).

#include "gemm_sm90.cuh"

namespace emp {

constexpr int FM_BM = 128;          // rows a tile
constexpr int FM_N = 128;           // hidden = output width
constexpr int FM_BK = 64;           // K-values a stage: one 128-byte row
constexpr int FM_STAGES = 4;
constexpr int FM_THREADS = 384;     // producer + two consumer warpgroups
constexpr int FM_X_TILE = FM_BM * FM_BK;  // bf16 elements
constexpr int FM_W_TILE = FM_N * FM_BK;
constexpr int FM_STAGE = FM_X_TILE + FM_W_TILE;
constexpr int FM_STAGE_BYTES = FM_STAGE * 2;
constexpr int FM_W2_BYTES = FM_N * FM_N * 2;      // two 128 x 64 blocks
constexpr int FM_H_BYTES = GM_CONSUMERS * 2 * 64 * 64 * 2;  // h / out tiles
constexpr int FM_SMEM = FM_STAGES * FM_STAGE_BYTES + FM_W2_BYTES +
                        FM_H_BYTES + 1024 + 8 * (2 * FM_STAGES + 1);

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

struct FmMaps {
  CUtensorMap x, w1, w2, out;
};

// Write bf16(f(d)) of this consumer's 64 x 128 accumulator tile into its
// two swizzled 64 x 64 blocks at cb (16-byte chunk k of row r at
// k ^ (r % 8): the layout TMA stores and wgmma's K-major A reads); f adds
// the column's bias, then for RELU takes 0 for a negative sum (a NaN
// stays NaN, as torch.relu and jnp.maximum leave it).
template <bool RELU>
__device__ __forceinline__ void fm_stage(const float* d, const float* bias,
                                         unsigned char* cb, int t) {
  const int warp = t >> 5, lane = t & 31, q = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < FM_N / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const float c0 = bias[col], c1 = bias[col + 1];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      float v0 = d[4 * j + 2 * hh] + c0, v1 = d[4 * j + 2 * hh + 1] + c1;
      if (RELU) v0 = v0 < 0.f ? 0.f : v0, v1 = v1 < 0.f ? 0.f : v1;
      *reinterpret_cast<__nv_bfloat162*>(
          cb + (j / 8) * 8192 + r * 128 + (((j % 8) ^ (r % 8)) << 4) + 4 * q) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

__global__ void __launch_bounds__(FM_THREADS, 1)
    finite_mlp_kernel(const __grid_constant__ FmMaps maps,
                      const float* __restrict__ b1,  // (128,)
                      const float* __restrict__ b2,  // (128,)
                      int M, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* w2s = ring + FM_STAGES * FM_STAGE;
  unsigned char* hs = reinterpret_cast<unsigned char*>(w2s) + FM_W2_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(hs + FM_H_BYTES);
  uint64_t* empty = full + FM_STAGES;
  uint64_t* w2bar = empty + FM_STAGES;

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int tiles = (M + FM_BM - 1) / FM_BM, nk = (K + FM_BK - 1) / FM_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < FM_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], GM_CONSUMERS * 4);  // one arrival a warp
    }
    mbar_init(w2bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    if (t == 0) {
      mbar_expect_tx(w2bar, FM_W2_BYTES);
      tma_load_2d(w2s, &maps.w2, w2bar, 0, 0);
      tma_load_2d(w2s + FM_N * 64, &maps.w2, w2bar, 64, 0);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % FM_STAGES;
          if (it >= FM_STAGES) mbar_wait(&empty[s], ((it / FM_STAGES) - 1) & 1);
          mbar_expect_tx(&full[s], FM_STAGE_BYTES);
          bf16* sx = ring + s * FM_STAGE;
          tma_load_2d(sx, &maps.x, &full[s], kt * FM_BK, tile * FM_BM);
          tma_load_2d(sx + FM_X_TILE, &maps.w1, &full[s], kt * FM_BK, 0);
        }
      }
    }
    return;
  }

  // consumer warpgroup c: rows 64c .. 64c + 63 of each tile
  const int c = wg - 1, lane = t & 31;
  unsigned char* hc = hs + c * (FM_H_BYTES / GM_CONSUMERS);
  const bf16* hb = reinterpret_cast<const bf16*>(hc);
  float d[FM_N / 2];
  mbar_wait(w2bar, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * FM_BM;
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % FM_STAGES;
      mbar_wait(&full[s], (it / FM_STAGES) & 1);
      bf16* sx = ring + s * FM_STAGE + c * 64 * FM_BK;
      // this warpgroup's 64 x 64 of x: -inf -> 0 in place (8 KB, four
      // 16-byte vectors a thread), then hand it to the async proxy
      uint4* v = reinterpret_cast<uint4*>(sx);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[t + 128 * i] = zero_neg_inf8(v[t + 128 * i]);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1 + c, 128);
      const bf16* sw = ring + s * FM_STAGE + FM_X_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FM_BK / 16; ++kk)
        wgmma_n128<0, 0>(d, smem_desc(sx + kk * 16), smem_desc(sw + kk * 16),
                         kt > 0 || kk > 0);
      wgmma_commit();
      fence_acc<FM_N / 2>(d);
      wgmma_wait<1>();  // the previous k-tile's group is done with its stage
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc<FM_N / 2>(d);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

    // h = bf16(relu(acc + b1)) into the tile, once the last tile's output
    // stores have read it
    if (t == 0) bulk_wait_all<true>();
    named_sync(1 + c, 128);
    fm_stage<true>(d, b1, hc, t);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + c, 128);
    // out = h . W2^T: eight k-steps over two 64-wide blocks
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FM_N / 16; ++kk)
      wgmma_n128<0, 0>(d, smem_desc(hb + (kk / 4) * 64 * 64 + (kk % 4) * 16),
                       smem_desc(w2s + (kk / 4) * FM_N * 64 + (kk % 4) * 16),
                       kk > 0);
    wgmma_commit();
    fence_acc<FM_N / 2>(d);
    wgmma_wait<0>();
    fence_acc<FM_N / 2>(d);
    named_sync(1 + c, 128);  // every warp's product has read h
    fm_stage<false>(d, b2, hc, t);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + c, 128);
    if (t == 0) {
      tma_store_2d(&maps.out, hc, 0, m0 + 64 * c);
      tma_store_2d(&maps.out, hc + 8192, 64, m0 + 64 * c);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait_all<false>();
}

}  // namespace emp

extern "C" {

// Shapes: x (M, K), w1 (128, K), w2 (128, 128), out (M, 128), bf16;
// K % 8 == 0 (16-byte rows for TMA), any M >= 1, pointers 16-byte aligned
// (the wrapper checks).
int emp_finite_mlp(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, int M, int K,
                   void* stream) {
  using namespace emp;
  if (M <= 0 || K <= 0 || K % 8) return (int)cudaErrorInvalidValue;
  FmMaps maps;
  if (!make_map(&maps.x, x, K, M, FM_BM) ||
      !make_map(&maps.w1, w1, K, FM_N, FM_N) ||
      !make_map(&maps.w2, w2, FM_N, FM_N, FM_N) ||
      !make_map(&maps.out, out, FM_N, M, 64))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      finite_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FM_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = (M + FM_BM - 1) / FM_BM, sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidValue;
  finite_mlp_kernel<<<tiles < sms ? tiles : sms, FM_THREADS, FM_SMEM,
                      (cudaStream_t)stream>>>(maps, (const float*)b1,
                                              (const float*)b2, M, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
