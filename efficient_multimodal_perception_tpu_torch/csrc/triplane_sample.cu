// Per-point triplane sampling and its backward.
//
// out[b, p, c] = sum over planes (xy, yz, xz) of the bilinear sample of
// plane[b, i] at the point's two normalized coords, zero padding,
// align_corners=False (ix = ((u + 1) * S - 1) / 2).  Plane 0 is indexed
// (H <- y, W <- x), plane 1 (H <- z, W <- y), plane 2 (H <- z, W <- x).
//
// Replaces triplane_sample_pallas
// (efficient_multimodal_perception_tpu/ops/pallas_kernels.py:
// triplane_sample_pallas; forward _sample_fwd_impl, _kernel; backward
// _sample_bwd, _bwd_kernel).
//
// What bounds it on an H100: bytes.  A point reads 12 corner rows of C
// values and writes one; about 1 flop per byte.
//
// Design: the TPU kernel turns the gather into matrix work (one-hot row
// weights times the VMEM-resident plane) because a TPU gathers poorly.  A
// GPU gathers well: one warp per point, lanes over channels, so each
// corner read is one contiguous C-value row.  Weights and sums are f32
// (the TPU kernel rounds its row weights to the plane's dtype before its
// product; this kernel does not).  The backward scatters g * weight into a
// (B, 3, S, S, C) f32 gradient with f32 atomics, as the TPU kernel also
// accumulates in f32; the wrapper casts it to the plane dtype.  Atomics
// add in no fixed order, so the plane gradient can differ in its last
// bits from run to run.  Coordinates get no gradient.

#include "common.cuh"

namespace emp {

struct Corner {
  int off;  // (y * S + x) * C, or -1 when out of range
  float w;
};

// The four corners of a bilinear sample at normalized (u -> W, v -> H).
__device__ __forceinline__ void corners(float u, float v, int S, int C,
                                        Corner* out) {
  const float ix = ((u + 1.f) * S - 1.f) * 0.5f;
  const float iy = ((v + 1.f) * S - 1.f) * 0.5f;
  const float x0 = floorf(ix), y0 = floorf(iy);
  const float wx1 = ix - x0, wy1 = iy - y0;
  const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
  const float ys[4] = {y0, y0, y0 + 1.f, y0 + 1.f};
  const float xs[4] = {x0, x0 + 1.f, x0, x0 + 1.f};
  const float ws[4] = {wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool inb = xs[i] >= 0.f && xs[i] <= S - 1 && ys[i] >= 0.f &&
                     ys[i] <= S - 1;
    out[i].off = inb ? ((int)ys[i] * S + (int)xs[i]) * C : -1;
    out[i].w = ws[i];
  }
}

// (u, v) coordinate indices of each plane.
__device__ __constant__ int kPlaneU[3] = {0, 1, 0};
__device__ __constant__ int kPlaneV[3] = {1, 2, 2};

__global__ void __launch_bounds__(256) triplane_sample_fwd_kernel(
    const bf16* __restrict__ tri,     // (B, 3, S, S, C)
    const float* __restrict__ coords, // (B, P, 3)
    bf16* __restrict__ out,           // (B, P, C)
    int B, int P, int S, int C) {
  const long long gw = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= (long long)B * P) return;
  const int b = (int)(gw / P);
  const float* cp = coords + gw * 3;
  const float cc[3] = {cp[0], cp[1], cp[2]};
  Corner cn[3][4];
#pragma unroll
  for (int pl = 0; pl < 3; ++pl)
    corners(cc[kPlaneU[pl]], cc[kPlaneV[pl]], S, C, cn[pl]);
  for (int c = lane; c < C; c += 32) {
    float acc = 0.f;
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      const bf16* plane = tri + ((size_t)b * 3 + pl) * S * S * C;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (cn[pl][i].off >= 0)
          s += __bfloat162float(plane[cn[pl][i].off + c]) * cn[pl][i].w;
      acc += s;
    }
    out[gw * C + c] = __float2bfloat16(acc);
  }
}

__global__ void __launch_bounds__(256) triplane_sample_bwd_kernel(
    const float* __restrict__ coords, // (B, P, 3)
    const bf16* __restrict__ g,       // (B, P, C)
    float* __restrict__ grad,         // (B, 3, S, S, C), zeroed
    int B, int P, int S, int C) {
  const long long gw = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= (long long)B * P) return;
  const int b = (int)(gw / P);
  const float* cp = coords + gw * 3;
  const float cc[3] = {cp[0], cp[1], cp[2]};
  Corner cn[3][4];
#pragma unroll
  for (int pl = 0; pl < 3; ++pl)
    corners(cc[kPlaneU[pl]], cc[kPlaneV[pl]], S, C, cn[pl]);
  for (int c = lane; c < C; c += 32) {
    const float gv = __bfloat162float(g[gw * C + c]);
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      float* plane = grad + ((size_t)b * 3 + pl) * S * S * C;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (cn[pl][i].off >= 0)
          atomicAdd(plane + cn[pl][i].off + c, gv * cn[pl][i].w);
    }
  }
}

}  // namespace emp

extern "C" {

int emp_triplane_sample_fwd(const void* tri, const void* coords, void* out,
                            int B, int P, int S, int C, void* stream) {
  const long long threads = (long long)B * P * 32;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  emp::triplane_sample_fwd_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const emp::bf16*)tri, (const float*)coords, (emp::bf16*)out, B, P, S,
      C);
  return (int)cudaGetLastError();
}

int emp_triplane_sample_bwd(const void* coords, const void* g, void* grad,
                            int B, int P, int S, int C, void* stream) {
  const long long threads = (long long)B * P * 32;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  emp::triplane_sample_bwd_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)coords, (const emp::bf16*)g, (float*)grad, B, P, S, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
