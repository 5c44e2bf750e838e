// The int8 GEMM: out (M, N) int32 = x (M, K) int8 . w (N, K)^T int8,
// exact (int32 accumulation).
//
// Replaces the int8 dot probe of tools/measure_int8.py
// (_pallas_int8_probe: an in-kernel int8 x int8 -> int32 jnp.dot under
// pl.pallas_call), the gate of the fused int8 epilogue.  Its counterpart
// on Hopper is an int8 wgmma (m64nNk32.s32.s8.s8) fed by TMA, so the
// probe runs the GEMM family of gemm_sm90.cuh with int8 operands: the
// mainloop the int8 ConvNeXt block (B10) will be rebuilt on.
//
// What bounds it on an H100: operations at large K (2 M N K int8
// operations over 1979 TOP/s), bytes at small K, where the int32 output
// (4 M N bytes over 3.35 TB/s) outweighs the products (the B10 shapes,
// K = 96 and 384: ridge at about 590 operations a byte).
//
// Design: the family's persistent TMA + mbarrier ring with two consumer
// warpgroups, 128 x BN tiles (BN 96, 128, 192 or 256, planned by the
// wrapper), 128 int8 K-values a stage (one 128-byte swizzled row, four
// k32 wgmma steps), a 4-stage ring; the s32 accumulators leave through
// shared memory and TMA stores (EpiStoreS32), which clip the ragged edges
// as the loads zero-fill them.  The wgmma takes int8 operands K-major
// only, as x and w are.

#include "gemm_sm90.cuh"

namespace emp {

constexpr int I8_STAGES = 4;

// s32 out through shared memory and TMA stores.  Each consumer stages two
// swizzled 64 x 32 int32 blocks (128-byte rows, 16-byte chunk q of row r
// at q ^ (r % 8)) and stores them, BN / 64 rounds a tile (one more for a
// last 32-column block at BN = 96); the next pair is written while the
// last one's stores run.
struct EpiStoreS32 : EpiBase {
  using Operand = int8_t;
  static constexpr int SMEM = GM_CONSUMERS * 2 * 64 * 32 * 4;
  CUtensorMap out;

  template <int BN, int NACC>
  __device__ __forceinline__ void run(int32_t (&d)[NACC][BN / 2], int m0,
                                      int n0, int c, int t, unsigned char* cb,
                                      int) const {
    const int warp = t >> 5, lane = t & 31;
    const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
    for (int b0 = 0; b0 < BN / 32; b0 += 2) {  // 32-column blocks, two a round
      // cb is free once the previous stores have read it
      if (t == 0) bulk_wait_all<true>();
      named_sync(1 + c, 128);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {  // the round's 8-column groups
        const int j = 4 * b0 + jj;
        if (j < BN / 8) {
          const int q = 2 * (jj & 3) + ((lane & 3) >> 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            *reinterpret_cast<int2*>(cb + (jj >> 2) * 8192 + r * 128 +
                                     ((q ^ (r % 8)) << 4) + 8 * (lane & 1)) =
                make_int2(d[0][4 * j + 2 * h], d[0][4 * j + 2 * h + 1]);
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1 + c, 128);
      if (t == 0) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (b0 + q < BN / 32)
            tma_store_2d(&out, cb + q * 8192, n0 + 32 * (b0 + q), m0 + 64 * c);
        bulk_commit();
      }
    }
  }
  __device__ __forceinline__ void finish(int t) const {
    if (t == 0) bulk_wait_all<false>();
  }
};

template <int BN>
static int launch_int8_gemm(const void* x, const void* w, void* out, int M,
                            int N, int K, cudaStream_t st) {
  GemmArgs<1> g;
  EpiStoreS32 epi;
  const void* pa[1] = {x};
  const void* pw[1] = {w};
  if (!gemm_args<BN, false, 1, int8_t>(&g, pa, pw, M, N, K) ||
      !make_map(&epi.out, out, N, M, 64, CU_TENSOR_MAP_DATA_TYPE_INT32, 4))
    return (int)cudaErrorInvalidValue;
  return launch_gemm<EpiStoreS32, BN, false, 1, I8_STAGES>(g, epi, st);
}

}  // namespace emp

extern "C" {

// out (M, N) int32 = x (M, K) int8 . w (N, K)^T int8 in 128 x bn tiles
// (bn 96, 128, 192 or 256).  K % 16 == 0 and N % 4 == 0 (16-byte rows for
// TMA), pointers 16-byte aligned (the wrapper checks).
int emp_int8_gemm(const void* x, const void* w, void* out, int M, int N,
                  int K, int bn, void* stream) {
  using namespace emp;
  const cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 4)
    return (int)cudaErrorInvalidValue;
  switch (bn) {
    case 96:
      return launch_int8_gemm<96>(x, w, out, M, N, K, st);
    case 128:
      return launch_int8_gemm<128>(x, w, out, M, N, K, st);
    case 192:
      return launch_int8_gemm<192>(x, w, out, M, N, K, st);
    case 256:
      return launch_int8_gemm<256>(x, w, out, M, N, K, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
