// The ConvNeXt block epilogue of the training path, gamma * MLP(LN(y))
// without the residual (stochastic depth sits between it and the
// residual), as a chain of a row pass and two Hopper GEMMs.
//
// Replaces epilogue_fused
// (efficient_multimodal_perception_tpu/ops/pallas_kernels.py:
// epilogue_fused, _epilogue_impl, _epilogue_kernel).  Same arithmetic and
// rounding points: f32 two-pass LN statistics (eps 1e-6) and affine,
// z = bf16(LN(y)); hpre = z . W1^T + b1 in f32, h = bf16(GELU(hpre))
// (exact erf); out = bf16((h . W2^T + b2) * gamma).
//
// What bounds it on an H100: operations.  A row costs 16*C^2 flops (two
// GEMMs C <-> 4C) against 4*C bytes of y read and out written: 8*C/3
// flop/byte after the hidden activation, 512 at C = 192, past the ~295
// ridge.
//
// Design: three launches on the caller's stream.
// 1. ln_rows_kernel (shared with K3) writes z (M, C) bf16, a warp a row.
// 2. fc1: the shared TMA + wgmma GEMM (gemm_sm90.cuh; 128 x 256 tiles,
//    4-stage ring) of z (M, C) and W1 (4C, C), both K-major as stored;
//    its epilogue adds b1, applies GELU once per element in f32 and
//    stores h (M, 4C) bf16 through swizzled shared memory and TMA.  h's
//    round trip through device memory (2 x 8C bytes a row) is the price
//    of running both products at the card's GEMM rate: a fused MLP would
//    hold a 128 x 4C hidden tile (768 KB at C = 768) that shared memory
//    cannot.
// 3. fc2: the same GEMM of h (M, 4C) and W2 (C, 4C); its epilogue adds
//    b2, multiplies by gamma and stores bf16 out.
// Each GEMM's column-tile width (fc1 256 or 192, fc2 192 or 128) is the
// wrapper's plan (ops/kernels.plan_tile_width): the width whose rounds
// of tiles over the card's SMs move the fewest operand bytes.  The
// camera rows (6144 to 98304) take fc1 256 / fc2 192; the lidar rows
// (2048 to 8192), whose wide tiles leave most SMs idle, take 192 / 128,
// which ran 16-27% less device time a call there on an H100
// (tools/ab_trees.py, both widths in one run).  The wrapper allocates z
// and h.

#include "gemm_sm90.cuh"

namespace emp {

constexpr int EF_STAGES = 4;

template <int BN, int OP>
static int launch_fc(const bf16* a, const bf16* w, const float* bias,
                     const float* gamma, bf16* out, int M, int K, int N,
                     cudaStream_t st) {
  GemmArgs<1> g;
  EpiStore<OP> epi;
  const void* pa[1] = {a};
  const void* pw[1] = {w};
  if (!gemm_args<BN, false, 1>(&g, pa, pw, M, N, K) ||
      !make_map(&epi.out, out, N, M, 64))
    return (int)cudaErrorInvalidValue;
  epi.bias = bias;
  epi.gamma = gamma;
  epi.N = N;
  return launch_gemm<EpiStore<OP>, BN, false, 1, EF_STAGES>(g, epi, st);
}

}  // namespace emp

extern "C" {

// out (M, C) = gamma * (fc2(GELU(fc1(LN(y)))));  C a multiple of 8 up to
// 1024; z (M, C) and h (M, 4C) bf16 scratch; gamma may be null.  bn1 /
// bn2: the column-tile widths of fc1 (256 or 192) and fc2 (192 or 128),
// the wrapper's plan.
int emp_epilogue_fwd(const void* y, const void* ln_s, const void* ln_b,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* gamma, void* z, void* h,
                     void* out, int M, int C, int bn1, int bn2,
                     void* stream) {
  using namespace emp;
  const cudaStream_t st = (cudaStream_t)stream;
  if (C % 8 || C > 1024) return (int)cudaErrorInvalidValue;
  int e = launch_ln_rows((const bf16*)y, (const float*)ln_s,
                         (const float*)ln_b, (bf16*)z, M, C, 1e-6f, st);
  if (e) return e;
  const bf16 *zb = (const bf16*)z, *hb = (const bf16*)h;
  const bf16 *w1b = (const bf16*)w1, *w2b = (const bf16*)w2;
  const float *b1f = (const float*)b1, *b2f = (const float*)b2;
  const float* gm = (const float*)gamma;
  bf16* o = (bf16*)out;
  if (bn1 == 256)
    e = launch_fc<256, 1>(zb, w1b, b1f, nullptr, (bf16*)h, M, C, 4 * C, st);
  else if (bn1 == 192)
    e = launch_fc<192, 1>(zb, w1b, b1f, nullptr, (bf16*)h, M, C, 4 * C, st);
  else
    e = (int)cudaErrorInvalidValue;
  if (e) return e;
  if (bn2 == 192) return launch_fc<192, 2>(hb, w2b, b2f, gm, o, M, 4 * C, C, st);
  if (bn2 == 128) return launch_fc<128, 2>(hb, w2b, b2f, gm, o, M, 4 * C, C, st);
  return (int)cudaErrorInvalidValue;
}

// The card's SM count (the persistent GEMMs launch one CTA an SM).
int emp_sm_count() { return emp::sm_count(); }

}  // extern "C"
