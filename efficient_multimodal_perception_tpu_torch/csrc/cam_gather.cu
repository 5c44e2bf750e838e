// Camera -> range gather-sum of the interact, and its backward.
//
// Forward:  out[b, p, :] = sum over cameras n of valid[b, n, p] *
//           feats[b, n, idx[b, n, p], :], summed in f32 and written once
//           as f32.  An index outside [0, K) contributes 0, as a one-hot
//           row with no match does in the TPU kernel.
// Backward: dfeats[b, n, k, :] = sum over the valid (b, n, p) with
//           idx[b, n, p] = k of g[b, p, :], g rounded to bf16 first (the
//           TPU kernel rounds g to the features' dtype before its
//           product), summed in f32 in ascending p and rounded to bf16
//           once; a row that no pixel hits is 0.
//
// Replaces cam_gather_sum
// (efficient_multimodal_perception_tpu/ops/pallas_kernels.py:
// cam_gather_sum; forward _cam_gather_impl, _cam_gather_kernel; backward
// _cam_gather_bwd, _cam_gather_bwd_kernel).
//
// What bounds it on an H100: bytes.  The forward reads idx and valid, the
// feature rows that valid pixels hit and writes the f32 output; no math to
// speak of.  The backward must write its bf16 output once (B N K C 2
// bytes, 37.7 MB at the train shape (2, 6, 8192, 192)) and read idx,
// valid and the g rows of the pixels some camera sees: about 45 MB,
// 0.0134 ms at 3.35 TB/s.
//
// Design: the TPU kernel builds a masked one-hot (block, K) tile in VMEM
// and runs it through the MXU, because a TPU gathers poorly; its cost
// grows with K and it holds the whole (K, C) block of a camera in VMEM.
// A GPU gathers well, so the forward is a streaming writer: a warp owns
// a tile of FW_ROWS (4) consecutive pixels of one batch row.  Lane i
// loads the N (idx, valid) entries of pixel i once, keeps the row each
// of the first FW_MAX_N (16) cameras hits (or -1) in shared memory and a
// ballot marks the pixels some camera sees; the entries of any further
// cameras are read again, from L1, where they are summed.  The warp then
// writes the tile's FW_ROWS x C f32 output, a contiguous block, 16 bytes
// (4 channels) a lane, so that each warp store covers 512 contiguous
// bytes: zeros for the pixels no camera sees, and for the others the
// 8-byte bf16 feature pieces of the cameras that see them, summed in f32
// in camera order.  Feature rows are read only for hits.
// The output (100.7 MB at the serve shape) is larger than the 50 MB L2,
// so the stores bypass it (st.global.cs).
// The backward inverts the scatter into a gather, with no f32 scratch and
// no atomics on data, in three kernels:
// 1. cam_compact_kernel, a block a slice of 2048 pixels of a (b, n):
//    compacts the slice's valid in-range entries (row, pixel) in pixel
//    order (a block scan) and counts them.  192 blocks at the train shape
//    read idx and valid once; one block a (b, n) could not pull them from
//    device memory fast enough.
// 2. cam_rows_kernel, a block a (b, n): buckets the entries by feature
//    row (CSR).  It stages them in shared memory, counts each row's,
//    scans the counts into row offsets (rowptr, K + 1 a (b, n)), and
//    places each entry at its row's offset plus its rank among the row's
//    entries in pixel order, so each row's list ascends in p.  The ranks
//    come from a bucket of stage indices per row (every entry counts the
//    smaller ones in its bucket), or, past 4096 entries a (b, n), from
//    one warp walking them in order (__match_any_sync).  At the train
//    shape 1.7% of the entries are valid, so the metadata is small
//    beside the output.
// 3. cam_gather_bwd_kernel, one thread per (b, n, k, 8 channels) and two
//    rows, reads its row's list, gathers the bf16-rounded g rows in list
//    order, sums them in f32 and stores 16 bytes of bf16 once (zeros for
//    an empty row).
// The sum order is fixed, ascending p as the TPU kernel's blocks of 256
// pixels run in order, so the gradient is the same bit for bit from call
// to call, and equals a float32 np.add.at in (b, n, p) order rounded to
// bf16.

#include "common.cuh"

namespace emp {

// The forward: warps of a block, pixels of a warp's tile, and cameras
// whose rows a warp holds in shared memory.
constexpr int FW_WARPS = 8;
constexpr int FW_ROWS = 4;
constexpr int FW_MAX_N = 16;

__global__ void __launch_bounds__(FW_WARPS * 32) cam_gather_fwd_kernel(
    const bf16* __restrict__ feats,     // (B, N, K, C)
    const int* __restrict__ idx,        // (B, N, P)
    const uint8_t* __restrict__ valid,  // (B, N, P)
    float* __restrict__ out,            // (B, P, C)
    int B, int N, int P, int K, int C) {
  __shared__ int hit_row[FW_WARPS][FW_MAX_N][FW_ROWS];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int tiles = (P + FW_ROWS - 1) / FW_ROWS;  // a batch row's tiles
  const long long tile = (long long)blockIdx.x * FW_WARPS + wib;
  if (tile >= (long long)B * tiles) return;  // the whole warp
  const int b = (int)(tile / tiles);
  const int p0 = (int)(tile - (long long)b * tiles) * FW_ROWS;
  const int rows = min(FW_ROWS, P - p0);
  int(*hr)[FW_ROWS] = hit_row[wib];
  bool seen = false;
  for (int n = 0; n < N; ++n) {
    int r = -1;
    if (lane < rows) {
      const long long at = ((long long)b * N + n) * P + p0 + lane;
      const int k = __ldg(idx + at);
      if (__ldg(valid + at) && (unsigned)k < (unsigned)K) r = k;
    }
    if (lane < FW_ROWS && n < FW_MAX_N) hr[n][lane] = r;
    seen |= r >= 0;
  }
  const unsigned hits = __ballot_sync(0xffffffffu, seen);
  __syncwarp();
  // the tile's output in units of 4 channels: unit u = (row r, column c)
  // of the contiguous rows x C block; lane l stores units l, l + 32, ...
  // so each warp store covers 512 contiguous bytes
  const int units = C >> 2;
  const bf16* fb = feats + (long long)b * N * K * C;
  float4* ob = reinterpret_cast<float4*>(out + ((long long)b * P + p0) * C);
  int r = lane / units, c = lane - r * units;
  for (int u = lane; u < rows * units; u += 32) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if ((hits >> r) & 1u) {
      for (int n = 0; n < N; ++n) {
        int k;
        if (n < FW_MAX_N) {
          k = hr[n][r];
        } else {
          const long long at = ((long long)b * N + n) * P + p0 + r;
          k = __ldg(idx + at);
          if (!__ldg(valid + at) || (unsigned)k >= (unsigned)K) k = -1;
        }
        if (k < 0) continue;
        const uint2 v = *reinterpret_cast<const uint2*>(
            fb + ((long long)n * K + k) * C + c * 4);
        const float2 f0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&v.x));
        const float2 f1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&v.y));
        acc[0] += f0.x;
        acc[1] += f0.y;
        acc[2] += f1.x;
        acc[3] += f1.y;
      }
    }
    __stcs(ob + u, make_float4(acc[0], acc[1], acc[2], acc[3]));
    for (c += 32; c >= units; c -= units) ++r;
  }
}

// The backward's bucketing: slices of CS_SLICE pixels, each compacted by
// a block of CS_THREADS threads (CS_PER consecutive pixels a thread);
// then a block of CR_THREADS threads a (b, n) places the compacted
// entries, CR_STAGE at a time through shared memory, in their rows.
constexpr int CS_THREADS = 256;
constexpr int CS_PER = 8;
constexpr int CS_SLICE = CS_THREADS * CS_PER;
constexpr int CR_THREADS = 1024;
constexpr int CR_STAGE = 4096;

// Slice blockIdx.x of (b, n) = blockIdx.y: its valid in-range entries in
// pixel order, rows into comp_r and pixels into comp_p from the slice's
// first pixel on, and their count into segcnt[bn * S + slice].
__global__ void __launch_bounds__(CS_THREADS) cam_compact_kernel(
    const int* __restrict__ idx,        // (B, N, P)
    const uint8_t* __restrict__ valid,  // (B, N, P)
    int* __restrict__ comp_r,           // (B N, P)
    int* __restrict__ comp_p,           // (B N, P)
    int* __restrict__ segcnt,           // (B N, S)
    int P, int K) {
  __shared__ int ws[33];
  const long long bn = blockIdx.y;
  const int base = blockIdx.x * CS_SLICE;
  const int p0 = base + threadIdx.x * CS_PER;
  const int* ib = idx + bn * P;
  const uint8_t* vb = valid + bn * P;
  int rows[CS_PER], n = 0;
#pragma unroll
  for (int i = 0; i < CS_PER; ++i) {
    const int p = p0 + i;
    const int r = p < P ? __ldg(ib + p) : -1;
    const bool ok = p < P && __ldg(vb + p) && (unsigned)r < (unsigned)K;
    rows[i] = ok ? r : -1;
    n += ok;
  }
  int total;
  int at = base + block_exclusive_scan(n, ws, &total);
#pragma unroll
  for (int i = 0; i < CS_PER; ++i) {
    if (rows[i] < 0) continue;
    comp_r[bn * P + at] = rows[i];
    comp_p[bn * P + at++] = p0 + i;
  }
  if (threadIdx.x == 0) segcnt[bn * gridDim.x + blockIdx.x] = total;
}

// rowptr (B N, K + 1): row k of (b, n) owns list[bn * P + rowptr[k] ..
// rowptr[k + 1]), the pixels p with valid[b, n, p] and idx[b, n, p] = k,
// ascending.  One block a (b, n); dynamic shared memory: K + 1 counts
// (then offsets, then cursors), S + 1 slice offsets, a stage of CR_STAGE
// rows, pixels and bucket slots, 33 scan slots.
__global__ void __launch_bounds__(CR_THREADS) cam_rows_kernel(
    const int* __restrict__ comp_r, const int* __restrict__ comp_p,
    const int* __restrict__ segcnt, int* __restrict__ rowptr,
    int* __restrict__ list, int P, int K, int S) {
  extern __shared__ int smem_i[];
  int* cnt = smem_i;
  int* sbase = cnt + K + 1;
  int* sr = sbase + S + 1;
  int* sp = sr + CR_STAGE;
  int* se = sp + CR_STAGE;
  int* ws = se + CR_STAGE;
  const long long bn = blockIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int* cr = comp_r + bn * P;
  const int* cp = comp_p + bn * P;
  int* lb = list + bn * P;

  for (int k = threadIdx.x; k <= K; k += CR_THREADS) cnt[k] = 0;
  if (w == 0) {  // slice offsets into the flat order of the entries
    int carry = 0;
    for (int j0 = 0; j0 < S; j0 += 32) {
      const int v = j0 + lane < S ? segcnt[bn * S + j0 + lane] : 0;
      const int x = warp_inclusive_scan(v, lane);
      if (j0 + lane < S) sbase[j0 + lane] = carry + x - v;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) sbase[S] = carry;
  }
  __syncthreads();
  const int m = sbase[S];

  // Entries e0 .. e1 - 1 of the flat (pixel) order into the stage.
  auto stage = [&](int e0, int e1) {
    for (int e = e0 + threadIdx.x; e < e1; e += CR_THREADS) {
      int lo = 0, hi = S - 1;  // the slice j: sbase[j] <= e < sbase[j + 1]
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (sbase[mid] <= e)
          lo = mid;
        else
          hi = mid - 1;
      }
      const int at = lo * CS_SLICE + e - sbase[lo];
      sr[e - e0] = cr[at];
      sp[e - e0] = cp[at];
    }
  };

  // count each row's entries, a stage at a time (one stage holds all
  // entries unless there are more than CR_STAGE)
  for (int e0 = 0; e0 < m; e0 += CR_STAGE) {
    const int e1 = min(m, e0 + CR_STAGE);
    stage(e0, e1);
    __syncthreads();
    for (int e = threadIdx.x; e < e1 - e0; e += CR_THREADS)
      atomicAdd(&cnt[sr[e]], 1);
    __syncthreads();
  }

  // counts -> exclusive row offsets, warp w scanning rows [w * kw, ...)
  // in steps of 32 (two passes: the warp's sum, then its offsets)
  const int kw = (K + 31) / 32;
  const int k0 = min(K, w * kw), k1 = min(K, k0 + kw);
  int sum = 0;
  for (int k = k0 + lane; k < k1; k += 32) sum += cnt[k];
  sum = warp_inclusive_scan(sum, lane);
  if (lane == 31) ws[w] = sum;
  __syncthreads();
  if (w == 0) {
    const int x = warp_inclusive_scan(ws[lane], lane);
    ws[lane] = x - ws[lane];
  }
  __syncthreads();
  int* rp = rowptr + bn * (K + 1);
  int carry = ws[w];
  for (int kb = k0; kb < k1; kb += 32) {
    const int k = kb + lane;
    const int v = k < k1 ? cnt[k] : 0;
    const int x = warp_inclusive_scan(v, lane);
    if (k < k1) {
      cnt[k] = carry + x - v;
      rp[k] = carry + x - v;
    }
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  if (threadIdx.x == 0) rp[K] = m;
  __syncthreads();

  if (m <= CR_STAGE) {
    // All entries are staged: each one's rank in its row is the number of
    // the row's entries before it in pixel order.  Bucket the stage
    // indices by row in any order, then every entry counts the smaller
    // indices in its bucket (the rows are short: at most m^2 reads).
    for (int e = threadIdx.x; e < m; e += CR_THREADS)
      se[atomicAdd(&cnt[sr[e]], 1)] = e;
    __syncthreads();  // cnt[r] is now the end of row r, cnt[r - 1] its start
    for (int e = threadIdx.x; e < m; e += CR_THREADS) {
      const int r = sr[e], lo = r ? cnt[r - 1] : 0, hi = cnt[r];
      int rank = 0;
      for (int j = lo; j < hi; ++j) rank += se[j] < e;
      lb[lo + rank] = sp[e];
    }
    return;
  }

  // More entries than a stage: place them in flat (pixel) order, a stage
  // at a time, by one warp (lanes on one row ranked by __match_any_sync),
  // so each row's list ascends in p.
  for (int e0 = 0; e0 < m; e0 += CR_STAGE) {
    const int e1 = min(m, e0 + CR_STAGE);
    stage(e0, e1);
    __syncthreads();
    if (w == 0) {
      for (int e = lane; e - lane < e1 - e0; e += 32) {
        const unsigned act = __ballot_sync(0xffffffffu, e < e1 - e0);
        if (e < e1 - e0) {
          const int r = sr[e];
          const unsigned same = __match_any_sync(act, r);
          const int rank = __popc(same & ((1u << lane) - 1));
          lb[cnt[r] + rank] = sp[e];
          __syncwarp(act);  // every lane has read cnt[r] before it moves
          if (rank == __popc(same) - 1) cnt[r] += __popc(same);
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

// Block (C / 8, rows): thread (x, y) owns channels 8x .. 8x + 7 of rows
// (blockIdx.x * CG_RPT + i) * rows + y, i < CG_RPT, of (b, n) =
// blockIdx.y; no index divisions.  Two rows a thread and at most 40
// registers (6 blocks an SM) keep more stores in flight.
constexpr int CG_RPT = 2;

__global__ void __launch_bounds__(256, 6) cam_gather_bwd_kernel(
    const float* __restrict__ g,       // (B, P, C)
    const int* __restrict__ rowptr,    // (B N, K + 1)
    const int* __restrict__ list,      // (B N, P)
    bf16* __restrict__ out,            // (B, N, K, C)
    int N, int P, int K, int C) {
  const int c0 = threadIdx.x << 3;
  const long long bn = blockIdx.y;
  const int b = blockIdx.y / N;
  const int* lb = list + bn * P;
#pragma unroll
  for (int i = 0; i < CG_RPT; ++i) {
    const int k = (blockIdx.x * CG_RPT + i) * blockDim.y + threadIdx.y;
    if (k >= K) return;
    const int* rp = rowptr + bn * (K + 1) + k;
    const int s = __ldg(rp), e = __ldg(rp + 1);
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = s; j < e; ++j) {
      const float4* gp = reinterpret_cast<const float4*>(
          g + ((long long)b * P + __ldg(lb + j)) * C + c0);
      const float4 g0 = __ldg(gp), g1 = __ldg(gp + 1);
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int q = 0; q < 8; ++q)
        acc[q] += __bfloat162float(__float2bfloat16(gv[q]));
    }
    st16(out + (bn * K + k) * C + c0, pack8(acc));
  }
}

// Dynamic shared memory of cam_rows_kernel at K rows and S slices.
static inline size_t cam_rows_smem(int K, int S) {
  return sizeof(int) * ((size_t)K + 1 + S + 1 + 3 * CR_STAGE + 33);
}

}  // namespace emp

extern "C" {

// C % 8 == 0.
int emp_cam_gather_fwd(const void* feats, const void* idx, const void* valid,
                       void* out, int B, int N, int P, int K, int C,
                       void* stream) {
  using namespace emp;
  if (B <= 0 || N <= 0 || P <= 0 || K <= 0 || C <= 0 || C % 8)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)B * ((P + FW_ROWS - 1) / FW_ROWS);
  const unsigned blocks = (unsigned)((tiles + FW_WARPS - 1) / FW_WARPS);
  cam_gather_fwd_kernel<<<blocks, FW_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)feats, (const int*)idx, (const uint8_t*)valid,
      (float*)out, B, N, P, K, C);
  return (int)cudaGetLastError();
}

// meta: int32 scratch of B N (K + 1 + 3 P + S), S = ceil(P / 2048)
// slices (rowptr, the lists, the compacted rows and pixels, the slices'
// counts); K <= 32768 and S <= 4096 (cam_rows_kernel's shared memory),
// C <= 2048, B N <= 65535 (the grids).
int emp_cam_gather_bwd(const void* g, const void* idx, const void* valid,
                       void* meta, void* out, int B, int N, int P, int K,
                       int C, void* stream) {
  using namespace emp;
  const cudaStream_t st = (cudaStream_t)stream;
  const int S = (P + CS_SLICE - 1) / CS_SLICE;
  if (K <= 0 || K > 32768 || P < 0 || S > 4096 || C <= 0 || C % 8 ||
      C > 2048 || B * N <= 0 || B * N > 65535)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      cam_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cam_rows_smem(32768, 4096));
  if (attr != cudaSuccess) return (int)attr;
  const size_t bnp = (size_t)B * N * P;
  int* rowptr = (int*)meta;
  int* list = rowptr + (size_t)B * N * (K + 1);
  int* comp_r = list + bnp;
  int* comp_p = comp_r + bnp;
  int* segcnt = comp_p + bnp;
  if (S > 0) {
    cam_compact_kernel<<<dim3(S, B * N), CS_THREADS, 0, st>>>(
        (const int*)idx, (const uint8_t*)valid, comp_r, comp_p, segcnt, P,
        K);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  cam_rows_kernel<<<B * N, CR_THREADS, cam_rows_smem(K, S), st>>>(
      comp_r, comp_p, segcnt, rowptr, list, P, K, S);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int chunks = C / 8, rows = 256 / chunks;
  const dim3 grid((K + rows * CG_RPT - 1) / (rows * CG_RPT), B * N),
      block(chunks, rows);
  cam_gather_bwd_kernel<<<grid, block, 0, st>>>((const float*)g, rowptr,
                                                list, (bf16*)out, N, P, K,
                                                C);
  return (int)cudaGetLastError();
}

}  // extern "C"
