// LN->GEMM (K3) and GELU->GEMM (K4): a row prologue pass, then one Hopper
// GEMM (TMA + mbarrier ring + wgmma) shared by both.
//
// Replaces ln_dense_fused and gelu_dense_fused
// (efficient_multimodal_perception_tpu/ops/pallas_kernels.py:
// _ln_dense_kernel, _gelu_dense_kernel, _prologue_dense_impl).  Same
// arithmetic: f32 LN statistics (mean, then the mean of squared
// deviations, then rsqrt(var + eps)) and affine, or f32 exact-erf GELU;
// the prologue rounded to bf16 before the product; bf16 x bf16 with f32
// accumulation; the f32 bias added; bf16 out.
//
// What bounds it on an H100: operations.  A call does 2*M*K*N flops at
// 989 TFLOP/s dense bf16; at the neck's shapes (M = B*4096; LN sites
// 1024 -> 3072 and 1024 -> 2048, GELU site 2048 -> 1024) that is 25.8
// GFLOP at B=1 for the q|kv site against 8 MB moved, far past the ~295
// flop/byte ridge.
//
// Design (what it does about that):
// 1. The prologue runs once per row, not once per column block: a warp
//    per row takes the LN statistics from registers (x read once) and
//    writes z = bf16(LN(x)); for GELU one vectorised elementwise pass
//    writes z = bf16(gelu(x)).  z is the tensor the TPU kernel rounds to
//    before its dot, so the GEMM's operand is the twin's bit for bit.
//    The wrapper allocates z (M x K bf16).
// 2. out = z . W^T + bias through the shared GEMM of gemm_sm90.cuh
//    (BN = 256, K-major, one product, 4 stages, EpiStore<0>), both
//    operands K-major (z (M, K), W (N, K)): wgmma's native bf16 "TN" form.  A CTA owns a 128 x 256 tile.  One
//    producer warpgroup (one thread) keeps TMA loads of 128 x 64 and
//    256 x 64 tiles (128-byte swizzle) in flight through a ring of 4
//    stages (48 KB each) with full / empty mbarriers; two consumer
//    warpgroups each run wgmma m64n256k16 on their 64 rows with f32
//    accumulators in registers, keeping one k-tile's wgmma group in
//    flight while the next is issued.
// 3. The epilogue adds the f32 bias in registers, writes bf16 into a
//    swizzled 64 x 128 shared-memory tile per consumer and hands it to
//    TMA stores, twice a tile (the ring's fourth stage left no room for
//    a whole 64 x 256 tile); the second half's stores run while the
//    consumer starts its next tile.  At K = 1024, direct 4-byte global
//    stores from registers were the largest cost after the products.
// 4. Persistent grid, one CTA an SM, walking the tiles column tiles
//    fastest, so CTAs in flight share their A rows in L2 and all of W
//    stays there; the ring runs on across tiles, so the producer loads
//    the next tile during the epilogue.
// TMA zero-fills reads past M, N and K and clips stores, so any M, and N
// and K multiples of 8, are taken (N = 128 or 384 leave part of the last
// column tile idle).  No setmaxnreg: 128 accumulators a thread fit the
// 168 registers that 384 threads leave each.  Tried on the card and not
// kept: 2-CTA clusters multicasting the W tile and releasing a stage
// before issuing the next k-tile (no gain), 3 stages with whole 64 x 256
// output tiles (slower).

#include "gemm_sm90.cuh"

namespace emp {

constexpr int GM_BN = 256;  // columns per CTA (one wgmma n256)
constexpr int GM_STAGES = 4;
using DenseEpi = EpiStore<0>;
using DenseShape = GemmShape<DenseEpi, GM_BN, false, 1, GM_STAGES>;

// z = bf16(gelu(x)) over n8 vectors of 8 values.
__global__ void __launch_bounds__(256)
    gelu_rows_kernel(const bf16* __restrict__ x, bf16* __restrict__ z,
                     size_t n8) {
  const size_t v = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (v >= n8) return;
  float f[8];
  unpack8(ld16(x + 8 * v), f);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = gelu_erf(f[i]);
  st16(z + 8 * v, pack8(f));
}

// out (M, N) bf16 = a (M, K) bf16 . w (N, K)^T + bias (N,) f32 or null.
static int launch_dense(const bf16* a, const bf16* w, const float* bias,
                        bf16* out, int M, int K, int N, cudaStream_t st) {
  GemmArgs<1> g;
  DenseEpi epi;
  const void* pa[1] = {a};
  const void* pw[1] = {w};
  if (!gemm_args<GM_BN, false, 1>(&g, pa, pw, M, N, K) ||
      !make_map(&epi.out, out, N, M, 64))
    return (int)cudaErrorInvalidValue;
  epi.bias = bias;
  epi.gamma = nullptr;
  epi.N = N;
  return launch_gemm<DenseEpi, GM_BN, false, 1, GM_STAGES>(g, epi, st);
}

}  // namespace emp

extern "C" {

// Shapes: N % 8 == 0, K % 8 == 0, pointers 16-byte aligned (the wrapper
// checks); z is the (M, K) bf16 scratch the prologue writes.
int emp_ln_dense(const void* x, const void* ln_s, const void* ln_b,
                 const void* w, const void* bias, void* z, void* out, int M,
                 int K, int N, float eps, void* stream) {
  using namespace emp;
  const cudaStream_t st = (cudaStream_t)stream;
  bf16* zb = (bf16*)z;
  const int e = launch_ln_rows((const bf16*)x, (const float*)ln_s,
                               (const float*)ln_b, zb, M, K, eps, st);
  if (e) return e;
  return launch_dense(zb, (const bf16*)w, (const float*)bias, (bf16*)out, M,
                      K, N, st);
}

int emp_gelu_dense(const void* x, const void* w, const void* bias, void* z,
                   void* out, int M, int K, int N, void* stream) {
  using namespace emp;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t n8 = (size_t)M * K / 8;
  gelu_rows_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
      (const bf16*)x, (bf16*)z, n8);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_dense((const bf16*)z, (const bf16*)w, (const float*)bias,
                      (bf16*)out, M, K, N, st);
}

// The GEMM's launch configuration: {stages, dynamic shared memory bytes,
// BM, BN, BK, threads} into cfg[6].
int emp_dense_config(int* cfg) {
  using namespace emp;
  const int v[6] = {GM_STAGES, DenseShape::SMEM, GM_BM, GM_BN, GM_BK,
                    GM_THREADS};
  for (int i = 0; i < 6; ++i) cfg[i] = v[i];
  return 0;
}

}  // extern "C"
