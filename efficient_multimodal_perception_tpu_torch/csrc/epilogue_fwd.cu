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
// Design: three launches on the caller's stream (emp::mlp_chain in
// gemm_sm90.cuh, shared with K1 in convnext_block.cu).
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
  return mlp_chain<2>((const bf16*)y, (const float*)ln_s, (const float*)ln_b,
                      (const bf16*)w1, (const float*)b1, (const bf16*)w2,
                      (const float*)b2, (const float*)gamma, nullptr,
                      (bf16*)z, (bf16*)h, (bf16*)out, M, C, bn1, bn2,
                      (cudaStream_t)stream);
}

// The card's SM count (the persistent GEMMs launch one CTA an SM).
int emp_sm_count() { return emp::sm_count(); }

}  // extern "C"
