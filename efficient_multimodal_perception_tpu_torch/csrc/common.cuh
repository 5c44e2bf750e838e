// Shared helpers of the port's Hopper kernels (bf16 storage, f32 math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace emp {

using bf16 = __nv_bfloat16;

// Exact-erf GELU (the TPU kernels approximate erf only because Mosaic
// has none).
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 bf16 (one 16-byte vector) <-> 8 floats.
__device__ __forceinline__ void unpack8(uint4 u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st16(bf16* p, uint4 u) {
  *reinterpret_cast<uint4*>(p) = u;
}

// Inclusive prefix sum of v over the warp.
__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Exclusive prefix sum of v over the block's blockDim.x (<= 1024)
// threads, in thread order; *total gets the block's sum.  ws: 33 ints of
// shared memory, free again when the call returns.
__device__ __forceinline__ int block_exclusive_scan(int v, int* ws,
                                                    int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int x = warp_inclusive_scan(v, lane);
  if (lane == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    const int own = lane < (int)(blockDim.x >> 5) ? ws[lane] : 0;
    const int s = warp_inclusive_scan(own, lane);
    ws[lane] = s - own;
    if (lane == 31) ws[32] = s;
  }
  __syncthreads();
  const int r = ws[w] + x - v;
  *total = ws[32];
  __syncthreads();
  return r;
}

}  // namespace emp
