// The inference ConvNeXt block's epilogue, out = x + gamma * (fc2(GELU(
// fc1(LN(y)) + b1)) + b2) over the (M, C) row view, y being the 7x7
// depthwise-conv output that the wrapper computes outside the kernel, as
// a chain of a row pass and two Hopper GEMMs.
//
// Replaces convnext_block_fused
// (efficient_multimodal_perception_tpu/ops/pallas_kernels.py:
// convnext_block_fused, _block_fused_impl, _post_kernel).  Same
// arithmetic and rounding points as the TPU kernel and the plain twin:
// f32 two-pass LN statistics (eps 1e-6) and affine, z = bf16(LN(y));
// hpre = z . W1^T + b1 in f32, h = bf16(GELU(hpre)) (exact erf);
// out = bf16(x + (h . W2^T + b2) * gamma), the sum in f32.
//
// What bounds it on an H100.  A row costs 16*C^2 flops (two GEMMs C <->
// 4C) against 6*C bytes of x and y read and out written: 8*C/3 flop/byte,
// 256 at C = 96 and 2048 at C = 768, so the function is bound by
// operations.  The chain adds z's and h's round trips through device
// memory (2 * 10*C bytes a row): fc1 -> fc2 then runs at C flop/byte, so
// at C = 96 (the camera's stage 0) the chain is bound by memory and past
// the ~295 ridge from C = 384 on.  A fused MLP would keep h on chip, but
// a 128 x 4C hidden tile (768 KB at C = 768) does not fit shared memory.
//
// Design: the B5 forward's chain (emp::mlp_chain in gemm_sm90.cuh):
// 1. ln_rows_kernel writes z (rows, C) bf16, a warp a row;
// 2. fc1, the persistent TMA + wgmma GEMM of z and W1 (4C, C), both
//    K-major as stored; its epilogue adds b1, applies GELU in f32 and
//    stores h (rows, 4C) bf16 through swizzled shared memory and TMA;
// 3. fc2, the same GEMM of h and W2 (C, 4C); its epilogue (EpiStore<3>)
//    adds b2, multiplies by gamma, adds the residual x read from device
//    memory at the same row and column, and stores bf16 out.
// The wrapper (ops/kernels.convnext_block_fused) plans each GEMM's tile
// width and runs the chain over row chunks of at most
// ops/kernels.K1_CHUNK_BYTES of z and h scratch, reused chunk after
// chunk, so the serve path's peak memory grows by that much at most.

#include "gemm_sm90.cuh"

extern "C" {

// out (M, C) = x + gamma * MLP(LN(y)) for C a multiple of 8 up to 1024;
// gamma may be null; z (M, C) and h (M, 4C) bf16 scratch; bn1 / bn2 the
// tile widths of fc1 (256 or 192) and fc2 (192 or 128).
int emp_convnext_block(const void* x, const void* y, const void* ln_s,
                       const void* ln_b, const void* w1, const void* b1,
                       const void* w2, const void* b2, const void* gamma,
                       void* z, void* h, void* out, int M, int C, int bn1,
                       int bn2, void* stream) {
  using namespace emp;
  return mlp_chain<3>((const bf16*)y, (const float*)ln_s, (const float*)ln_b,
                      (const bf16*)w1, (const float*)b1, (const bf16*)w2,
                      (const float*)b2, (const float*)gamma, (const bf16*)x,
                      (bf16*)z, (bf16*)h, (bf16*)out, M, C, bn1, bn2,
                      (cudaStream_t)stream);
}

}  // extern "C"
