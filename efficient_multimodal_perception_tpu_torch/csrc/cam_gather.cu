// Camera -> range gather-sum of the interact, and its backward.
//
// Forward:  out[b, p, :] = sum over cameras n of valid[b, n, p] *
//           feats[b, n, idx[b, n, p], :], summed in f32 and written once
//           as f32.  An index outside [0, K) contributes 0, as a one-hot
//           row with no match does in the TPU kernel.
// Backward: dfeats[b, n, idx[b, n, p], :] += g[b, p, :] for every valid
//           (b, n, p), g rounded to bf16 first (the TPU kernel rounds g to
//           the features' dtype before its product), summed in a zeroed f32
//           buffer and cast to bf16 by a second pass.
//
// Replaces cam_gather_sum
// (efficient_multimodal_perception_tpu/ops/pallas_kernels.py:
// cam_gather_sum; forward _cam_gather_impl, _cam_gather_kernel; backward
// _cam_gather_bwd, _cam_gather_bwd_kernel).
//
// What bounds it on an H100: bytes.  The forward reads idx and valid, the
// feature rows that valid pixels hit and writes the f32 output; no math to
// speak of.  The backward reads idx, valid and g, adds into the f32 buffer
// and casts it.
//
// Design: the TPU kernel builds a masked one-hot (block, K) tile in VMEM
// and runs it through the MXU, because a TPU gathers poorly; its cost
// grows with K and it holds the whole (K, C) block of a camera in VMEM.
// A GPU gathers well, so this is a direct gather: one thread per
// (output row, 8 channels), loading 16-byte vectors of the row that each
// valid camera hits, accumulating in f32 registers and storing 32 bytes
// once.  The threads of one row read the same idx / valid entries, which
// the L1 serves.  The backward is one thread per (b, n, p, 8 channels)
// with f32 atomics (few collide: about one valid camera per pixel and a
// few points per feature row), so the sum order is not fixed and the
// gradient can differ in its last bits from run to run.

#include "common.cuh"

namespace emp {

__global__ void __launch_bounds__(256) cam_gather_fwd_kernel(
    const bf16* __restrict__ feats,     // (B, N, K, C)
    const int* __restrict__ idx,        // (B, N, P)
    const uint8_t* __restrict__ valid,  // (B, N, P)
    float* __restrict__ out,            // (B, P, C)
    int B, int N, int P, int K, int C) {
  const int chunks = C >> 3;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * P * chunks) return;
  const long long row = t / chunks;  // b * P + p
  const int c0 = (int)(t - row * chunks) << 3;
  const int b = (int)(row / P);
  const int p = (int)(row - (long long)b * P);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n = 0; n < N; ++n) {
    const long long bn = (long long)b * N + n;
    const long long at = bn * P + p;
    const int r = __ldg(idx + at);
    if (!__ldg(valid + at) || (unsigned)r >= (unsigned)K) continue;
    float f[8];
    unpack8(ld16(feats + (bn * K + r) * C + c0), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += f[i];
  }
  float4* o = reinterpret_cast<float4*>(out + row * C + c0);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

__global__ void __launch_bounds__(256) cam_gather_bwd_kernel(
    const float* __restrict__ g,        // (B, P, C)
    const int* __restrict__ idx,        // (B, N, P)
    const uint8_t* __restrict__ valid,  // (B, N, P)
    float* __restrict__ grad,           // (B, N, K, C), zeroed
    int B, int N, int P, int K, int C) {
  const int chunks = C >> 3;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * N * P * chunks) return;
  const long long at = t / chunks;  // (b * N + n) * P + p
  const int c0 = (int)(t - at * chunks) << 3;
  const int r = __ldg(idx + at);
  if (!__ldg(valid + at) || (unsigned)r >= (unsigned)K) return;
  const long long bn = at / P;
  const int p = (int)(at - bn * P);
  const int b = (int)(bn / N);
  const float4* gp =
      reinterpret_cast<const float4*>(g + ((long long)b * P + p) * C + c0);
  const float4 g0 = gp[0], g1 = gp[1];
  const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  float* dst = grad + (bn * K + r) * C + c0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    atomicAdd(dst + i, __bfloat162float(__float2bfloat16(gv[i])));
}

// f32 -> bf16, 8 values a thread (n % 8 == 0).
__global__ void __launch_bounds__(256) cast_bf16_kernel(
    const float* __restrict__ src, bf16* __restrict__ dst, long long n8) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n8) return;
  const float4* s = reinterpret_cast<const float4*>(src) + 2 * t;
  const float4 a = s[0], b = s[1];
  const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  st16(dst + 8 * t, pack8(f));
}

}  // namespace emp

extern "C" {

int emp_cam_gather_fwd(const void* feats, const void* idx, const void* valid,
                       void* out, int B, int N, int P, int K, int C,
                       void* stream) {
  const long long threads = (long long)B * P * (C / 8);
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  emp::cam_gather_fwd_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const emp::bf16*)feats, (const int*)idx, (const uint8_t*)valid,
      (float*)out, B, N, P, K, C);
  return (int)cudaGetLastError();
}

int emp_cam_gather_bwd(const void* g, const void* idx, const void* valid,
                       void* grad, void* out, int B, int N, int P, int K,
                       int C, void* stream) {
  const long long threads = (long long)B * N * P * (C / 8);
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  emp::cam_gather_bwd_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const int*)idx, (const uint8_t*)valid, (float*)grad,
      B, N, P, K, C);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long n8 = (long long)B * N * K * C / 8;
  emp::cast_bf16_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0,
                          (cudaStream_t)stream>>>((const float*)grad,
                                                  (emp::bf16*)out, n8);
  return (int)cudaGetLastError();
}

}  // extern "C"
