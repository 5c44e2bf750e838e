// One Hopper GEMM family (sm_90a), shared by K3 / K4 (prologue_dense.cu),
// K1 and the B5 training chains (convnext_block.cu, epilogue_fwd.cu,
// epilogue_bwd.cu) and the int8 GEMM (int8_gemm.cu); attention.cu builds
// its flash-attention kernels from the same primitives (TMA loads,
// mbarriers, swizzled descriptors, wgmma, and the m64n32 / m64n64 and
// register-A forms below).
//
// out tile (128 x BN) = sum over a < NACC of A_a . B_a^T, accumulators in
// registers, handed with their row and column indices to an epilogue
// functor (Epi).  NACC = 2 is a "dual GEMM": two products of the same
// shape whose accumulators share an output tile (the B5 backward's
// hpre | dh and dz | opre).
//
// - Operand type.  The epilogue names it (Epi::Operand; EpiBase: bf16):
//   bf16 with f32 accumulators and wgmma k16 steps, 64 K-values a stage,
//   or int8 with s32 accumulators (exact) and k32 steps, 128 K-values a
//   stage.  Either way a stage row is one 128-byte swizzled row, and a
//   stage takes four wgmma steps.
// - Operands.  MN = false: both K-major (A (M, K), B (N, K) row-major),
//   wgmma's native "TN" form, TMA boxes of one 128-byte row of K by 128
//   or BN rows.  MN = true (bf16 only: wgmma transposes 16-bit operands
//   only): both MN-major (A (K, M), B (K, N) row-major, the A^T B of the
//   weight gradients): TMA boxes of 64 M- or N-values by 64 K-rows, read
//   by wgmma through its transpose flags and MN-major descriptors (core
//   matrices 64 wide: LBO = 8192 bytes between 64-wide boxes, SBO = 1024
//   bytes between 8-row groups).  128-byte swizzle either way.
// - Pipeline.  One producer warpgroup (one thread) keeps TMA loads in
//   flight through a ring of STAGES stages with full / empty mbarriers;
//   two consumer warpgroups run wgmma m64nBNk16 (int8: k32) on 64 rows
//   each, keeping one k-tile's wgmma group in flight while the next is
//   issued.
// - Grid.  Persistent, one CTA an SM (two for an epilogue that asks,
//   Epi::MIN_BLOCKS), walking tiles column tiles fastest,
//   then row tiles, each over all of K; the ring runs on across tiles, so
//   the producer loads the next tile during the epilogue.
// - Edges.  TMA zero-fills loads past M, N and K and clips stores, so any
//   M, and N and K whose rows are multiples of 16 bytes (bf16: 8 values,
//   int8: 16), are taken; an epilogue that stores from registers masks
//   rows >= M and columns >= N itself.
// Every mbarrier wait traps after ~2 s instead of hanging the card.

#pragma once

#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace emp {

constexpr int GM_BM = 128;  // rows per CTA (two consumer warpgroups)
constexpr int GM_BK = 64;   // bf16 along K per stage: one 128-byte row
constexpr int GM_CONSUMERS = 2;
constexpr int GM_THREADS = 128 * (GM_CONSUMERS + 1);

// The operand types: accumulator, K-values a stage (one 128-byte row),
// K-values a wgmma step, and the TMA element type.
template <class T>
struct GemmOp;
template <>
struct GemmOp<bf16> {
  using Acc = float;
  static constexpr int BK = GM_BK, KSTEP = 16;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct GemmOp<int8_t> {
  using Acc = int32_t;
  static constexpr int BK = 128, KSTEP = 32;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

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

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
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

// wgmma shared-memory descriptors, 128-byte swizzle.  K-major: rows of
// 128 bytes, 8-row atoms 1024 bytes apart (SBO), LBO unused.  MN-major:
// 64 M/N values a 128-byte row, one row per k; 8-row groups 1024 bytes
// apart (SBO), 64-wide boxes 8192 bytes apart (LBO).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t smem_desc_mn(const bf16* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(8192 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

// MN-major with `lbo` bytes between 64-wide boxes (boxes of lbo / 128
// K-rows; smem_desc_mn is lbo = 8192).
__device__ __forceinline__ uint64_t smem_desc_mn(const bf16* p, int lbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

#define EMP_F8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define EMP_F32(i) EMP_F8(i), EMP_F8(i + 8), EMP_F8(i + 16), EMP_F8(i + 24)

// d (64 x 96 f32, 48 a thread) += A (64 x 16) . B (96 x 16)^T; TA / TB
// 1: that operand is MN-major in shared memory (else K-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n96(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, %51, %52;\n"
      "}\n"
      : EMP_F32(0), EMP_F8(32), EMP_F8(40)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 128 f32, 64 a thread) += A (64 x 16) . B (128 x 16)^T; TA / TB
// 1: that operand is MN-major in shared memory (else K-major); scale_d
// 0: d = A . B^T (d's old value ignored).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db,
                                           int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : EMP_F32(0), EMP_F32(32)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 192 f32, 96 a thread) += A (64 x 16) . B (192 x 16)^T; TA / TB
// 1: that operand is MN-major in shared memory (else K-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n"
      "}\n"
      : EMP_F32(0), EMP_F32(32), EMP_F32(64)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 256 f32, 128 a thread) += A (64 x 16) . B (256 x 16)^T; TA / TB
// 1: that operand is MN-major in shared memory (else K-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : EMP_F32(0), EMP_F32(32), EMP_F32(64), EMP_F32(96)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// Attention's products (csrc/attention.cu): m64n32 / m64n64 with both
// operands in shared memory, and m64n64 / n128 / n256 with A from
// registers (the "RS" form: A is a bf16 fragment, the layout of a
// 64 x 16 slice of an f32 accumulator, so a score tile feeds the next
// product without passing through shared memory).

// d (64 x 32 f32, 16 a thread) += A (64 x 16) . B (32 x 16)^T; TA / TB
// 1: that operand is MN-major in shared memory (else K-major); scale_d
// 0: d = A . B^T.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db,
                                          int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, %16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : EMP_F8(0), EMP_F8(8)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64 f32, 32 a thread) += A (64 x 16) . B (64 x 16)^T; TA / TB
// 1: that operand is MN-major in shared memory (else K-major); scale_d
// 0: d = A . B^T.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db,
                                          int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : EMP_F32(0)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64 f32, 32 a thread) += A (64 x 16, bf16 in registers: the
// wgmma A fragment a[4]) . B (64 x 16)^T; TB 1: B is MN-major in shared
// memory (else K-major).
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : EMP_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// d (64 x 128 f32, 64 a thread) += A (64 x 16, bf16 in registers: the
// wgmma A fragment a[4]) . B (128 x 16)^T; TB 1: B is MN-major in shared
// memory (else K-major).
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : EMP_F32(0), EMP_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// d (64 x 256 f32, 128 a thread) += A (64 x 16, bf16 in registers: the
// wgmma A fragment a[4]) . B (256 x 16)^T; TB 1: B is MN-major in shared
// memory (else K-major).
template <int TB>
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n"
      "}\n"
      : EMP_F32(0), EMP_F32(32), EMP_F32(64), EMP_F32(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

#define EMP_I8(i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),            \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define EMP_I32(i) EMP_I8(i), EMP_I8(i + 8), EMP_I8(i + 16), EMP_I8(i + 24)

// d (64 x 96 s32, 48 a thread) += A (64 x 32) . B (96 x 32)^T, int8,
// both K-major in shared memory.
__device__ __forceinline__ void wgmma_s8_n96(int32_t* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n"
      "}\n"
      : EMP_I32(0), EMP_I8(32), EMP_I8(40)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128 s32, 64 a thread) += A (64 x 32) . B (128 x 32)^T, int8,
// both K-major in shared memory.
__device__ __forceinline__ void wgmma_s8_n128(int32_t* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : EMP_I32(0), EMP_I32(32)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 192 s32, 96 a thread) += A (64 x 32) . B (192 x 32)^T, int8,
// both K-major in shared memory.
__device__ __forceinline__ void wgmma_s8_n192(int32_t* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95"
      "}, %96, %97, p;\n"
      "}\n"
      : EMP_I32(0), EMP_I32(32), EMP_I32(64)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256 s32, 128 a thread) += A (64 x 32) . B (256 x 32)^T, int8,
// both K-major in shared memory.
__device__ __forceinline__ void wgmma_s8_n256(int32_t* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, %128, %129, p;\n"
      "}\n"
      : EMP_I32(0), EMP_I32(32), EMP_I32(64), EMP_I32(96)
      : "l"(da), "l"(db), "r"(1));
}

#undef EMP_I32
#undef EMP_I8
#undef EMP_F32
#undef EMP_F8

template <int BN, int T>
__device__ __forceinline__ void wgmma_bn(float* d, uint64_t da, uint64_t db) {
  static_assert(BN == 96 || BN == 128 || BN == 192 || BN == 256,
                "tile width");
  if constexpr (BN == 96)
    wgmma_n96<T, T>(d, da, db);
  else if constexpr (BN == 128)
    wgmma_n128<T, T>(d, da, db);
  else if constexpr (BN == 192)
    wgmma_n192<T, T>(d, da, db);
  else
    wgmma_n256<T, T>(d, da, db);
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(int32_t* d, uint64_t da,
                                         uint64_t db) {
  static_assert(BN == 96 || BN == 128 || BN == 192 || BN == 256,
                "tile width");
  if constexpr (BN == 96)
    wgmma_s8_n96(d, da, db);
  else if constexpr (BN == 128)
    wgmma_s8_n128(d, da, db);
  else if constexpr (BN == 192)
    wgmma_s8_n192(d, da, db);
  else
    wgmma_s8_n256(d, da, db);
}

// Keep the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma (no instruction is emitted).
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

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

// The GEMM's operands and its walk over tiles.  nk: k-tiles of BK.  The
// K range may be split: split s sums k-tiles [s * kps, (s + 1) * kps)
// into a tile of its own (the epilogue sees s), splits * kps >= nk.
template <int NACC>
struct GemmArgs {
  CUtensorMap a[NACC];
  CUtensorMap b[NACC];
  int M, N, nk, tiles_m, tiles_n, splits, kps;
};

// Tile `tile` of the walk: its split, first row and column, and k-tiles.
struct TileAt {
  int ks, m0, n0, k0, k1;
  template <int NACC>
  __device__ __forceinline__ TileAt(const GemmArgs<NACC>& g, int tile,
                                    int bn) {
    const int per = g.tiles_m * g.tiles_n, r = tile % per;
    ks = tile / per;
    m0 = (r / g.tiles_n) * GM_BM;
    n0 = (r % g.tiles_n) * bn;
    k0 = ks * g.kps;
    k1 = min(g.nk, k0 + g.kps);
  }
};

// An epilogue sees, per consumer warpgroup c (rows m0 + 64c .. + 63) of
// split ks and thread t of it, d[a][4j + r] = row 16 * (t / 32) +
// (t % 32) / 4 + 8 * (r / 2), column n0 + 8j + 2 * (t % 4) + r % 2 of
// product a (f32 for bf16 operands, s32 for int8).  SMEM: the bytes of
// shared memory it needs (half per consumer).  Operand: the type of A and
// B.  MIN_BLOCKS: CTAs an SM.  At 2 (for epilogues whose f32 work, not
// the product, takes the time: twice the warps to hide its latency, and
// one CTA's epilogue runs beside the other's mainloop) the producer is
// one warp after the consumer warpgroups (288 threads; wgmma needs a
// consumer warpgroup to start at a multiple of four warps), so the
// launch bound leaves 112 registers a thread: accumulators of BN <= 128.
struct EpiBase {
  using Operand = bf16;
  static constexpr int SMEM = 0;
  static constexpr int MIN_BLOCKS = 1;
  __device__ __forceinline__ void finish(int) const {}
};

template <class Epi, int BN, bool MN, int NACC, int STAGES>
struct GemmShape {
  using T = typename Epi::Operand;
  static constexpr int BK = GemmOp<T>::BK;
  static constexpr int A_TILE = GM_BM * BK;  // elements
  static constexpr int B_TILE = BN * BK;
  static constexpr int STAGE = NACC * (A_TILE + B_TILE);
  static constexpr int STAGE_BYTES = STAGE * (int)sizeof(T);
  // the ring, the epilogue's tiles, 1 KB of slack to align them to the
  // swizzle atom, the barriers
  static constexpr int SMEM =
      STAGES * STAGE_BYTES + Epi::SMEM + 1024 + 2 * STAGES * 8;
};

// Threads of a CTA: a producer warpgroup and the consumers, or at two
// CTAs an SM a producer warp after them.
template <class Epi>
constexpr int GEMM_THREADS =
    Epi::MIN_BLOCKS == 2 ? 128 * GM_CONSUMERS + 32 : GM_THREADS;

template <class Epi, int BN, bool MN, int NACC, int STAGES>
__global__ void __launch_bounds__(GEMM_THREADS<Epi>, Epi::MIN_BLOCKS)
    gemm_kernel(const __grid_constant__ GemmArgs<NACC> g,
                const __grid_constant__ Epi epi) {
  using S = GemmShape<Epi, BN, MN, NACC, STAGES>;
  using T = typename S::T;
  using Acc = typename GemmOp<T>::Acc;
  constexpr int BK = S::BK, KSTEP = GemmOp<T>::KSTEP;
  static_assert(!MN || BN % 64 == 0, "MN-major B loads 64-wide boxes");
  static_assert(!MN || std::is_same<T, bf16>::value,
                "wgmma reads int8 operands K-major only");
  static_assert(Epi::MIN_BLOCKS == 1 || (Epi::MIN_BLOCKS == 2 && BN <= 128),
                "two CTAs an SM hold accumulators of BN <= 128");
  constexpr int TR = MN ? 1 : 0;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  T* ring = reinterpret_cast<T*>(smem);
  unsigned char* sC = smem + STAGES * S::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sC + Epi::SMEM);
  uint64_t* empty = full + STAGES;

  constexpr bool LEAN = Epi::MIN_BLOCKS == 2;  // a producer warp, last
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int tiles = g.tiles_m * g.tiles_n * g.splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], GM_CONSUMERS * 4);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (LEAN ? wg == GM_CONSUMERS : wg == 0) {  // producer
    if (t == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const TileAt at(g, tile, BN);
        const int m0 = at.m0, n0 = at.n0;
        for (int kt = at.k0; kt < at.k1; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          mbar_expect_tx(&full[s], S::STAGE_BYTES);
#pragma unroll
          for (int a = 0; a < NACC; ++a) {
            T* sa = ring + s * S::STAGE + a * (S::A_TILE + S::B_TILE);
            T* sb = sa + S::A_TILE;
            if (MN) {
#pragma unroll
              for (int q = 0; q < GM_BM / 64; ++q)
                tma_load_2d(sa + q * 64 * BK, &g.a[a], &full[s],
                            m0 + 64 * q, kt * BK);
#pragma unroll
              for (int q = 0; q < BN / 64; ++q)
                tma_load_2d(sb + q * 64 * BK, &g.b[a], &full[s],
                            n0 + 64 * q, kt * BK);
            } else {
              tma_load_2d(sa, &g.a[a], &full[s], kt * BK, m0);
              tma_load_2d(sb, &g.b[a], &full[s], kt * BK, n0);
            }
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup c: rows 64c .. 64c + 63 of each tile
  const int c = LEAN ? wg : wg - 1, lane = t & 31;
  unsigned char* sCc = sC + c * (Epi::SMEM / 2);
  Acc d[NACC][BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileAt at(g, tile, BN);
    const int m0 = at.m0, n0 = at.n0;
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[a][i] = Acc(0);
      fence_acc<BN / 2>(d[a]);
    }
    int prev = -1;
    for (int kt = at.k0; kt < at.k1; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / KSTEP; ++kk) {
#pragma unroll
        for (int a = 0; a < NACC; ++a) {
          const T* sa = ring + s * S::STAGE + a * (S::A_TILE + S::B_TILE);
          const T* sb = sa + S::A_TILE;
          if constexpr (!std::is_same<T, bf16>::value)
            wgmma_bn<BN>(d[a], smem_desc(sa + c * 64 * BK + kk * KSTEP),
                         smem_desc(sb + kk * KSTEP));
          else if (MN)
            wgmma_bn<BN, TR>(d[a], smem_desc_mn(sa + c * 64 * BK + kk * 16 * 64),
                             smem_desc_mn(sb + kk * 16 * 64));
          else
            wgmma_bn<BN, TR>(d[a], smem_desc(sa + c * 64 * BK + kk * 16),
                             smem_desc(sb + kk * 16));
        }
      }
      wgmma_commit();
#pragma unroll
      for (int a = 0; a < NACC; ++a) fence_acc<BN / 2>(d[a]);
      wgmma_wait<1>();  // the previous k-tile's group is done with its stage
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < NACC; ++a) fence_acc<BN / 2>(d[a]);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    epi.template run<BN, NACC>(d, m0, n0, c, t, sCc, at.ks);
  }
  epi.finish(t);
}

// ---- epilogues ------------------------------------------------------------

// bf16 out through shared memory and TMA stores: v -> v + bias (OP 0),
// gelu(v + bias) (OP 1), (v + bias) * gamma (OP 2) or resid + (v + bias)
// * gamma (OP 3, all in f32; resid (M, N) bf16, the ConvNeXt block's
// residual), bias and gamma f32 per column or null.  Each consumer stages
// two swizzled 64 x 64 blocks (chunk (j % 8) ^ (row % 8), conflict-free)
// and stores them, BN / 128 times a tile; the next pair is written while
// the last one's stores run.
template <int OP>
struct EpiStore : EpiBase {
  static constexpr int SMEM = GM_CONSUMERS * 2 * 64 * 64 * 2;
  CUtensorMap out;
  const float* bias;
  const float* gamma;
  const bf16* resid = nullptr;  // OP 3 only
  int M = 0, N;

  template <int BN, int NACC>
  __device__ __forceinline__ void run(float (&d)[NACC][BN / 2], int m0,
                                      int n0, int c, int t, unsigned char* cb,
                                      int) const {
    // one branch on the (uniform) bias pointer, so the bias-free tiles
    // of K3's q|kv product pay no per-column test
    if (bias)
      store<true, BN, NACC>(d, m0, n0, c, t, cb);
    else
      store<false, BN, NACC>(d, m0, n0, c, t, cb);
  }

  template <bool BIAS, int BN, int NACC>
  __device__ __forceinline__ void store(float (&d)[NACC][BN / 2], int m0,
                                        int n0, int c, int t,
                                        unsigned char* cb) const {
    const int warp = t >> 5, lane = t & 31;
    const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
    for (int cb0 = 0; cb0 < BN / 64; cb0 += 2) {
      // cb is free once the previous stores have read it
      if (t == 0) bulk_wait_all<true>();
      named_sync(1 + c, 128);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = 8 * cb0 + jj;
        if (j < BN / 8) {
          const int col = n0 + 8 * j + 2 * (lane & 3);
          float b0 = 0.f, b1 = 0.f, g0 = 1.f, g1 = 1.f;
          if (col < N) {
            if (BIAS) b0 = bias[col], b1 = bias[col + 1];
            if (OP >= 2 && gamma) g0 = gamma[col], g1 = gamma[col + 1];
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            float v0 = d[0][4 * j + 2 * h] + b0, v1 = d[0][4 * j + 2 * h + 1] + b1;
            if (OP == 1) v0 = gelu_erf(v0), v1 = gelu_erf(v1);
            if (OP >= 2) v0 *= g0, v1 *= g1;
            if (OP == 3) {
              const int row = m0 + 64 * c + r;
              if (row < M && col < N) {
                const float2 x = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(
                        resid + (size_t)row * N + col));
                v0 += x.x, v1 += x.y;
              }
            }
            *reinterpret_cast<__nv_bfloat162*>(
                cb + (jj / 8) * 8192 + r * 128 + (((j % 8) ^ (r % 8)) << 4) +
                4 * (lane & 3)) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1 + c, 128);
      if (t == 0) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (cb0 + q < BN / 64)
            tma_store_2d(&out, cb + q * 8192, n0 + 64 * (cb0 + q),
                         m0 + 64 * c);
        bulk_commit();
      }
    }
  }
  __device__ __forceinline__ void finish(int t) const {
    if (t == 0) bulk_wait_all<false>();
  }
};

// ---- host side ------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_tiled() {
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

// A (rows, cols) row-major tensor of `bytes`-byte elements moved in tiles
// of box_rows rows by one 128-byte row (64 bf16, 128 int8, 32 int32) with
// 128-byte swizzle; loads past the edges are zero-filled, stores clipped.
static inline bool make_map(CUtensorMap* map, const void* ptr, int cols,
                            int rows, int box_rows,
                            CUtensorMapDataType type =
                                CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            int bytes = 2) {
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / bytes), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (G, N, C) row-major bf16 tensor moved in boxes of one 128-byte row
// (64 values of C) by box_rows rows of one group, 128-byte swizzle;
// loads past C or N are zero-filled (never read the next group), stores
// clipped.  C % 8 == 0.
static inline bool make_map_3d(CUtensorMap* map, const void* ptr, int C,
                               int N, int G, int box_rows) {
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)N * C * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

static inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// The maps and the tile walk of out (M, N) = sum_a A_a B_a^T over K, for
// operands of type T.  MN = false: a[i] (M, K), b[i] (N, K).  MN = true:
// a[i] (K, M), b[i] (K, N).
template <int BN, bool MN, int NACC, class T = bf16>
static inline bool gemm_args(GemmArgs<NACC>* g, const void* const* a,
                             const void* const* b, int M, int N, int K) {
  static_assert(!MN || std::is_same<T, bf16>::value, "int8 is K-major");
  constexpr CUtensorMapDataType ty = GemmOp<T>::TMA;
  constexpr int sz = (int)sizeof(T), BK = GemmOp<T>::BK;
  for (int i = 0; i < NACC; ++i) {
    const bool ok = MN ? make_map(&g->a[i], a[i], M, K, 64) &&
                             make_map(&g->b[i], b[i], N, K, 64)
                       : make_map(&g->a[i], a[i], K, M, GM_BM, ty, sz) &&
                             make_map(&g->b[i], b[i], K, N, BN, ty, sz);
    if (!ok) return false;
  }
  g->M = M;
  g->N = N;
  g->nk = (K + BK - 1) / BK;
  g->tiles_m = (M + GM_BM - 1) / GM_BM;
  g->tiles_n = (N + BN - 1) / BN;
  g->splits = 1;
  g->kps = g->nk;
  return true;
}

// Split the K walk of g (nk >= 1) into `splits` ranges of equal k-tiles;
// returns the number of non-empty ranges (the splits the epilogue sees).
template <int NACC>
static inline int split_k(GemmArgs<NACC>* g, int splits) {
  if (splits < 1) splits = 1;
  g->kps = (g->nk + splits - 1) / splits;
  g->splits = (g->nk + g->kps - 1) / g->kps;
  return g->splits;
}

template <class Epi, int BN, bool MN, int NACC, int STAGES>
static int launch_gemm(const GemmArgs<NACC>& g, const Epi& epi,
                       cudaStream_t st) {
  constexpr int smem = GemmShape<Epi, BN, MN, NACC, STAGES>::SMEM;
  auto kern = gemm_kernel<Epi, BN, MN, NACC, STAGES>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)g.tiles_m * g.tiles_n * g.splits;
  const long long ctas = (long long)sms * Epi::MIN_BLOCKS;
  const int grid = (int)(tiles < ctas ? tiles : ctas);
  if (grid <= 0) return 0;
  kern<<<grid, GEMM_THREADS<Epi>, smem, st>>>(g, epi);
  return (int)cudaGetLastError();
}

// out (M, N) = bf16 epilogue OP of a (M, K) . w (N, K)^T through the
// TN GEMM (4-stage ring) and EpiStore<OP>; K1's and the B5 forward's fc1
// and fc2.
constexpr int FC_STAGES = 4;

template <int BN, int OP>
static int launch_fc(const bf16* a, const bf16* w, const float* bias,
                     const float* gamma, const bf16* resid, bf16* out, int M,
                     int K, int N, cudaStream_t st) {
  GemmArgs<1> g;
  EpiStore<OP> epi;
  const void* pa[1] = {a};
  const void* pw[1] = {w};
  if (!gemm_args<BN, false, 1>(&g, pa, pw, M, N, K) ||
      !make_map(&epi.out, out, N, M, 64))
    return (int)cudaErrorInvalidValue;
  epi.bias = bias;
  epi.gamma = gamma;
  epi.resid = resid;
  epi.M = M;
  epi.N = N;
  return launch_gemm<EpiStore<OP>, BN, false, 1, FC_STAGES>(g, epi, st);
}

// ---- row pass shared by K3 and the B5 forward ----------------------------

// 8 floats from 32-byte-aligned p (two 16-byte loads).
__device__ __forceinline__ void ld_f32x8(const float* p, float* f) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
  f[4] = v.x, f[5] = v.y, f[6] = v.z, f[7] = v.w;
}

// z = bf16(LN(x)), one warp per row, two-pass f32 statistics.  NCH > 0:
// the lane holds its NCH 8-wide chunks of the row in registers (K <= 256
// * NCH); NCH == 0 reads the row again for each pass (any K).
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

// The LN row pass for any K (multiple of 8).
static inline int launch_ln_rows(const bf16* x, const float* s, const float* b,
                                 bf16* z, int M, int K, float eps,
                                 cudaStream_t st) {
  const dim3 grid((M + 7) / 8);
  if (K <= 1024)
    ln_rows_kernel<4><<<grid, 256, 0, st>>>(x, s, b, z, M, K, eps);
  else if (K <= 2048)
    ln_rows_kernel<8><<<grid, 256, 0, st>>>(x, s, b, z, M, K, eps);
  else
    ln_rows_kernel<0><<<grid, 256, 0, st>>>(x, s, b, z, M, K, eps);
  return (int)cudaGetLastError();
}

// ---- the MLP chain of K1 and the B5 forward --------------------------------

// out (M, C) = [resid +] gamma * (fc2(GELU(fc1(LN(y)))) over rows: the LN
// row pass into z (M, C) bf16, fc1 with b1 and GELU into h (M, 4C) bf16,
// fc2 with b2, gamma (null: 1) and, for OP 3, the residual resid (M, C).
// bn1 / bn2: fc1's (256 or 192) and fc2's (192 or 128) tile widths.
template <int OP>
static int mlp_chain(const bf16* y, const float* ln_s, const float* ln_b,
                     const bf16* w1, const float* b1, const bf16* w2,
                     const float* b2, const float* gamma, const bf16* resid,
                     bf16* z, bf16* h, bf16* out, int M, int C, int bn1,
                     int bn2, cudaStream_t st) {
  static_assert(OP == 2 || OP == 3, "fc2 epilogue");
  if (C % 8 || C > 1024) return (int)cudaErrorInvalidValue;
  int e = launch_ln_rows(y, ln_s, ln_b, z, M, C, 1e-6f, st);
  if (e) return e;
  if (bn1 == 256)
    e = launch_fc<256, 1>(z, w1, b1, nullptr, nullptr, h, M, C, 4 * C, st);
  else if (bn1 == 192)
    e = launch_fc<192, 1>(z, w1, b1, nullptr, nullptr, h, M, C, 4 * C, st);
  else
    e = (int)cudaErrorInvalidValue;
  if (e) return e;
  if (bn2 == 192)
    return launch_fc<192, OP>(h, w2, b2, gamma, resid, out, M, 4 * C, C, st);
  if (bn2 == 128)
    return launch_fc<128, OP>(h, w2, b2, gamma, resid, out, M, 4 * C, C, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace emp
