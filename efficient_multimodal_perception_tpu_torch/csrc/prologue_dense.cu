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
// 2. out = z . W^T + bias, both operands K-major (z (M, K), W (N, K)):
//    wgmma's native bf16 "TN" form.  A CTA owns a 128 x 256 tile.  One
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

#include <cuda.h>

#include "common.cuh"

namespace emp {

constexpr int GM_BM = 128;  // rows per CTA (two consumer warpgroups)
constexpr int GM_BN = 256;  // columns per CTA (one wgmma n256)
constexpr int GM_BK = 64;   // bf16 along K per stage: one 128-byte row
constexpr int GM_STAGES = 4;
constexpr int GM_CONSUMERS = 2;
constexpr int GM_THREADS = 128 * (GM_CONSUMERS + 1);
constexpr int GM_A_TILE = GM_BM * GM_BK;  // elements
constexpr int GM_B_TILE = GM_BN * GM_BK;
constexpr int GM_C_TILE = 64 * GM_BN / 2;  // half a consumer's output
constexpr int GM_STAGE_BYTES = (GM_A_TILE + GM_B_TILE) * 2;
// the ring, the output tiles, 1 KB of slack to align them to the
// swizzle atom, the barriers
constexpr int GM_SMEM = GM_STAGES * GM_STAGE_BYTES +
                        GM_CONSUMERS * GM_C_TILE * 2 + 1024 +
                        2 * GM_STAGES * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the barrier's phase `parity` has completed.  A wait of more
// than ~2 s (4e9 cycles) cannot be a slow load: trap, so a fault ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > 4000000000LL) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until this thread's TMA stores have read their shared memory
// (READ) or finished writing device memory.
template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Barrier `id` over the `n` threads of one consumer warpgroup.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), LBO unused.
__device__ __forceinline__ uint64_t smem_desc(const bf16* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

#define EMP_F8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define EMP_F32(i) EMP_F8(i), EMP_F8(i + 8), EMP_F8(i + 16), EMP_F8(i + 24)

// d (64 x 256 f32, 128 a thread) += A (64 x 16, K-major) . B (256 x 16,
// K-major)^T, both read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : EMP_F32(0), EMP_F32(32), EMP_F32(64), EMP_F32(96)
      : "l"(da), "l"(db), "r"(1));
}

// Keep the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma (no instruction is emitted).
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#undef EMP_F32
#undef EMP_F8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Consumer warpgroup c of the GEMM: rows 64c .. 64c + 63 of each of its
// CTA's tiles, f32 accumulators in registers, then bias, bf16 and TMA
// stores from its output tile sC (two 64 x 64 blocks, 128-byte swizzle),
// one half of the 256 columns at a time.
__device__ __forceinline__ void consume(const bf16* sA, const bf16* sB,
                                        bf16* sC, uint64_t* full,
                                        uint64_t* empty,
                                        const CUtensorMap* tm_out,
                                        const float* __restrict__ bias, int N,
                                        int nk, int tiles_n, int tiles, int c,
                                        int t) {
  const int warp = t >> 5, lane = t & 31;
  float d[128];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * GM_BM, n0 = (tile % tiles_n) * GM_BN;
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    fence_acc(d);
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % GM_STAGES;
      mbar_wait(&full[s], (it / GM_STAGES) & 1);
      const bf16* a = sA + s * GM_A_TILE + c * 64 * GM_BK;
      const bf16* b = sB + s * GM_B_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GM_BK / 16; ++kk)
        wgmma_m64n256k16(d, smem_desc(a + kk * 16), smem_desc(b + kk * 16));
      wgmma_commit();
      fence_acc(d);
      wgmma_wait<1>();  // the previous k-tile's group is done with its stage
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // d[4j + r]: row warp*16 + lane/4 + 8*(r/2), column 8j + 2*(lane%4) +
    // r%2; in half j/16, column block (j/8)%2 of sC, 16-byte chunk
    // (j%8) ^ (row%8)
    const int r0 = warp * 16 + (lane >> 2);
    unsigned char* cb = reinterpret_cast<unsigned char*>(sC);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // sC is free once the previous stores have read it
      if (t == 0) bulk_wait_all<true>();
      named_sync(1 + c, 128);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = 16 * hf + jj;
        const int col = n0 + 8 * j + 2 * (lane & 3);
        float b0 = 0.f, b1 = 0.f;
        if (bias && col < N) {
          b0 = bias[col];
          b1 = bias[col + 1];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(
              cb + (jj / 8) * 8192 + r * 128 + (((j % 8) ^ (r % 8)) << 4) +
              4 * (lane & 3)) =
              __floats2bfloat162_rn(d[4 * j + 2 * h] + b0,
                                    d[4 * j + 2 * h + 1] + b1);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1 + c, 128);
      if (t == 0) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          tma_store_2d(tm_out, sC + q * 64 * 64, n0 + 128 * hf + 64 * q,
                       m0 + 64 * c);
        bulk_commit();
      }
    }
  }
  if (t == 0) bulk_wait_all<false>();
}

// out (M, N) bf16 = a (M, K) bf16 . w (N, K)^T + bias (N,) f32 or null.
__global__ void __launch_bounds__(GM_THREADS, 1)
    dense_tn_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_out,
                    const float* __restrict__ bias, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + GM_STAGES * GM_A_TILE;
  bf16* sC = sB + GM_STAGES * GM_B_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(sC + GM_CONSUMERS * GM_C_TILE);
  uint64_t* empty = full + GM_STAGES;

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int nk = (K + GM_BK - 1) / GM_BK;
  const int tiles_n = (N + GM_BN - 1) / GM_BN;
  const int tiles = tiles_n * ((M + GM_BM - 1) / GM_BM);

  if (threadIdx.x == 0) {
    for (int s = 0; s < GM_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], GM_CONSUMERS * 4);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Persistent: CTA i takes tiles i, i + grid, ...  (column tiles
  // fastest).  The ring's position `it` runs on across tiles, so the
  // producer loads the next tile's first stages during the epilogue.
  if (wg == 0) {  // producer
    if (t == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * GM_BM, n0 = (tile % tiles_n) * GM_BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % GM_STAGES;
          if (it >= GM_STAGES)
            mbar_wait(&empty[s], ((it / GM_STAGES) - 1) & 1);
          mbar_expect_tx(&full[s], GM_STAGE_BYTES);
          tma_load_2d(sA + s * GM_A_TILE, &tm_a, &full[s], kt * GM_BK, m0);
          tma_load_2d(sB + s * GM_B_TILE, &tm_w, &full[s], kt * GM_BK, n0);
        }
      }
    }
    return;
  }
  consume(sA, sB, sC + (wg - 1) * GM_C_TILE, full, empty, &tm_out, bias, N,
          nk, tiles_n, tiles, wg - 1, t);
}

// 8 floats from 32-byte-aligned p (two 16-byte loads).
__device__ __forceinline__ void ld_f32x8(const float* p, float* f) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
  f[4] = v.x, f[5] = v.y, f[6] = v.z, f[7] = v.w;
}

// z = bf16(LN(x)), one warp per row.  NCH > 0: the lane holds its NCH
// 8-wide chunks of the row in registers (K <= 256 * NCH); NCH == 0 reads
// the row again for each pass (any K).
template <int NCH>
__global__ void __launch_bounds__(256)
    ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ s,
                   const float* __restrict__ b, bf16* __restrict__ z, int M,
                   int K, float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * K;
  bf16* zr = z + (size_t)row * K;
  if (NCH > 0) {
    float f[NCH > 0 ? NCH : 1][8];
    float sum = 0.f;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int k = (ch * 32 + lane) * 8;
      if (k < K) {
        unpack8(ld16(xr + k), f[ch]);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += f[ch][i];
      }
    }
    const float mu = warp_sum(sum) / K;
    float var = 0.f;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int k = (ch * 32 + lane) * 8;
      if (k < K) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float dv = f[ch][i] - mu;
          var += dv * dv;
        }
      }
    }
    const float rs = rsqrtf(warp_sum(var) / K + eps);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int k = (ch * 32 + lane) * 8;
      if (k < K) {
        float o[8], sv[8], bv[8];
        ld_f32x8(s + k, sv);
        ld_f32x8(b + k, bv);
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] = (f[ch][i] - mu) * rs * sv[i] + bv[i];
        st16(zr + k, pack8(o));
      }
    }
  } else {
    float f[8], sum = 0.f, var = 0.f;
    for (int k = lane * 8; k < K; k += 256) {
      unpack8(ld16(xr + k), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += f[i];
    }
    const float mu = warp_sum(sum) / K;
    for (int k = lane * 8; k < K; k += 256) {
      unpack8(ld16(xr + k), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) var += (f[i] - mu) * (f[i] - mu);
    }
    const float rs = rsqrtf(warp_sum(var) / K + eps);
    for (int k = lane * 8; k < K; k += 256) {
      float sv[8], bv[8];
      unpack8(ld16(xr + k), f);
      ld_f32x8(s + k, sv);
      ld_f32x8(b + k, bv);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = (f[i] - mu) * rs * sv[i] + bv[i];
      st16(zr + k, pack8(f));
    }
  }
}

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

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
#endif
      return (EncodeTiledFn) nullptr;
    return q == cudaDriverEntryPointSuccess ? (EncodeTiledFn)p : nullptr;
  }();
  return fn;
}

// A (rows, cols) row-major bf16 tensor moved in (box_rows, 64) tiles with
// 128-byte swizzle; loads past the edges are zero-filled, stores clipped.
static bool make_map(CUtensorMap* map, const void* ptr, int cols, int rows,
                     int box_rows) {
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

static int launch_dense(const bf16* a, const bf16* w, const float* bias,
                        bf16* out, int M, int K, int N, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      dense_tn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GM_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  CUtensorMap ta, tw, to;
  if (sms <= 0 || !make_map(&ta, a, K, M, GM_BM) ||
      !make_map(&tw, w, K, N, GM_BN) || !make_map(&to, out, N, M, 64))
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)((N + GM_BN - 1) / GM_BN) * ((M + GM_BM - 1) / GM_BM);
  const int grid = (int)(tiles < sms ? tiles : sms);  // one CTA an SM
  dense_tn_kernel<<<grid, GM_THREADS, GM_SMEM, st>>>(ta, tw, to, bias, M, N,
                                                      K);
  return (int)cudaGetLastError();
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
  const dim3 grid((M + 7) / 8);
  const bf16* xb = (const bf16*)x;
  const float *s = (const float*)ln_s, *b = (const float*)ln_b;
  bf16* zb = (bf16*)z;
  if (K <= 1024)
    ln_rows_kernel<4><<<grid, 256, 0, st>>>(xb, s, b, zb, M, K, eps);
  else if (K <= 2048)
    ln_rows_kernel<8><<<grid, 256, 0, st>>>(xb, s, b, zb, M, K, eps);
  else
    ln_rows_kernel<0><<<grid, 256, 0, st>>>(xb, s, b, zb, M, K, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
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
  const int v[6] = {GM_STAGES, GM_SMEM, GM_BM, GM_BN, GM_BK, GM_THREADS};
  for (int i = 0; i < 6; ++i) cfg[i] = v[i];
  return 0;
}

}  // extern "C"
