// Per-point triplane sampling and its backward.
//
// out[b, p, c] = sum over planes (xy, yz, xz) of the bilinear sample of
// plane[b, i] at the point's two normalized coords, zero padding,
// align_corners=False (ix = ((u + 1) * S - 1) / 2).  Plane 0 is indexed
// (H <- y, W <- x), plane 1 (H <- z, W <- y), plane 2 (H <- z, W <- x).
// The backward is the gradient with respect to the planes, in bf16 (the
// TPU kernel's is cast to the plane's dtype); coordinates get none.
//
// Replaces triplane_sample_pallas
// (efficient_multimodal_perception_tpu/ops/pallas_kernels.py:
// triplane_sample_pallas; forward _sample_fwd_impl, _kernel; backward
// _sample_bwd, _bwd_kernel).
//
// What bounds it on an H100: bytes.  The forward reads the coordinates
// and writes one C-value row a point; its 12 corner rows a point come
// from the L2 (the 6.3 MB of planes of the pretraining shape stay there).
// The backward reads the coordinates and g and writes the bf16 gradient
// once: 0.79 + 4.19 + 6.29 MB at (2, 3, 128, 128, 32) and 32768 points,
// 0.0034 ms at 3.35 TB/s.
//
// Both directions compute a point's bilinear footprint with one function
// (footprint(): every step rounded on its own, no FMA contraction), so
// they agree on the weights with each other, with the plain twin and
// with a float32 host reference.
//
// Forward design: the TPU kernel turns the gather into matrix work
// (one-hot row weights times the VMEM-resident plane) because a TPU
// gathers poorly.  A GPU gathers well: a point gets TPP threads of 8
// channels (C / 8 rounded up to a power of two in [4, 32]; 4 at C = 32,
// so a warp holds 8 points).  The warp's points' coordinates are loaded
// once, one float a lane, and shuffled to the threads of each point;
// each thread issues its 12 corner rows as independent 16-byte loads
// before any math, sums in f32 (corners of a plane, then planes) and
// stores 16 bytes.  Points come in range-image order, so neighbours share
// texels in L1 and L2.
//
// Backward design: the gradient of texel t is the sum of g[p] * w over
// the points whose footprint covers t.  Scattering that with atomics adds
// in no fixed order and needs an f32 plane and a cast.  Instead the
// points are bucketed by their footprint's cell (x0, y0) in [-1, S-1]^2,
// (S + 1)^2 cells a (b, plane), and every texel gathers from the four
// cells it is a corner of, writing its bf16 value once.  The path's
// points are heavily skewed (every empty range pixel samples the plane's
// centre: one cell holds half of a sample's 32768 points), and points
// near the ground fill a row of cells on the yz and xz planes with tens
// to hundreds each, so no step walks a long list serially.  Five kernels:
// 1. tri_sort_kernel, a block a slice of 2048 points of a (b, plane):
//    each point's cell (a point with no corner on the plane, NaN
//    coordinates included, is dropped); a bitonic sort of the slice's
//    (cell, point) keys, 4 a thread in registers (partners in the thread,
//    in the warp through shuffles, else through shared memory); each
//    key's rank among its cell's keys of the slice (a block max-scan of
//    run starts); the slice's count of every cell, a dense row.
// 2. tri_count_kernel, a thread a cell: its entries in earlier slices
//    (in place of the counts), its entry count n, and two block scans
//    over its tile of 1024 cells: of n and of its chunk count (a cell
//    with more than TB_LIGHT entries is "heavy" and split into chunks of
//    TB_CHUNK entries from its list's start, the last one shorter).
// 3. tri_place_kernel, a thread a key: the tiles' offsets (a warp scan
//    each), the cells' list offsets (cellptr) and first chunks
//    (chunkptr), each chunk's cell (chunk_cell), and the key's entry at
//    its cell's offset + the cell's entries in earlier slices + its
//    rank, so each cell's list ascends in p (a stable counting sort).  An
//    entry holds its point and its four corner weights.
// 4. tri_parts_kernel, a block a chunk (looping over the (b, plane)'s
//    chunks) and 8 channels: thread t sums the chunk's entries i
//    (counted from the chunk's start) with i % TB_LANES == t in ascending
//    i (their loads all in flight), then a tree adds the threads' sums
//    (t + TB_LANES / 2, then / 4, ... apart), for the four corners.
// 5. tri_grad_kernel, a thread a (texel, 8 channels): for its corners
//    k = 0..3 of the cells (y, x), (y, x - 1), (y - 1, x), (y - 1, x - 1)
//    in that order, the cell's sum s_k (a light cell's entries in list
//    order from 0, 4 entries' loads in flight; a heavy cell's chunk sums
//    in order from 0), added into 0 in order k = 0..3; 16 bytes of bf16
//    stored once.
// Every product and sum is rounded on its own in f32, and the texel once
// to bf16, so the gradient is the same bit for bit from call to call and
// equals ops.kernels.triplane_sample_bwd_reference (float32 numpy, the
// same order).  The constants that fix that order (TB_LIGHT, TB_LANES,
// TB_CHUNK) come from ops/_build.py as -D flags, which the reference
// reads too.

#include "common.cuh"

namespace emp {

// (u, v) coordinate indices of plane pl: xy, yz, xz.
__host__ __device__ constexpr int plane_u(int pl) { return pl == 1 ? 1 : 0; }
__host__ __device__ constexpr int plane_v(int pl) { return pl == 0 ? 1 : 2; }

// The bilinear footprint of normalized (u -> W, v -> H) on an S x S
// plane: its cell (x0, y0), the floor of the continuous texel position,
// and the weights of the corners (y0, x0), (y0, x0 + 1), (y0 + 1, x0),
// (y0 + 1, x0 + 1).
struct Footprint {
  float x0, y0;
  float w[4];
};

__device__ __forceinline__ Footprint footprint(float u, float v, int S) {
  const float s = (float)S;
  const float ix =
      __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(u, 1.f), s), 1.f), 0.5f);
  const float iy =
      __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(v, 1.f), s), 1.f), 0.5f);
  Footprint f;
  f.x0 = floorf(ix);
  f.y0 = floorf(iy);
  const float wx1 = __fsub_rn(ix, f.x0), wy1 = __fsub_rn(iy, f.y0);
  const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
  f.w[0] = __fmul_rn(wy0, wx0);
  f.w[1] = __fmul_rn(wy0, wx1);
  f.w[2] = __fmul_rn(wy1, wx0);
  f.w[3] = __fmul_rn(wy1, wx1);
  return f;
}

// The footprint's cell index (y0 + 1) (S + 1) + x0 + 1, or -1 when no
// corner lies on the plane (NaN coordinates included).
__device__ __forceinline__ int cell_of(const Footprint& f, int S) {
  const float hi = (float)(S - 1);
  if (!(f.x0 >= -1.f && f.x0 <= hi && f.y0 >= -1.f && f.y0 <= hi))
    return -1;
  return ((int)f.y0 + 1) * (S + 1) + (int)f.x0 + 1;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// 2^tpp_log2 threads a point; a thread owns the chunks of 8 channels
// ch0, ch0 + TPP, ... of its point.
__global__ void __launch_bounds__(256, 4) triplane_sample_fwd_kernel(
    const bf16* __restrict__ tri,     // (B, 3, S, S, C)
    const float* __restrict__ coords, // (B, P, 3)
    bf16* __restrict__ out,           // (B, P, C)
    int B, int P, int S, int C, int tpp_log2) {
  const int lane = threadIdx.x & 31;
  const int ppw_log2 = 5 - tpp_log2;  // points a warp
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long first = warp << ppw_log2;  // b P + p of its first point
  const long long total = (long long)B * P;
  // the warp's points' coordinates, one float a lane (at most 24)
  const long long ci = first * 3 + lane;
  const float mine = lane < (3 << ppw_log2) && ci < total * 3
                         ? __ldg(coords + ci) : 0.f;
  const int q = lane >> tpp_log2;  // the thread's point in the warp
  float cc[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    cc[a] = __shfl_sync(0xffffffffu, mine, q * 3 + a);
  const long long pt = first + q;
  if (pt >= total) return;
  const int b = (int)(pt / P);
  // corner offsets from the batch row's first plane (elements) and
  // weights; a corner off the plane reads nothing and weighs 0
  int off[12];
  float w[12];
  const float hi = (float)(S - 1);
#pragma unroll
  for (int pl = 0; pl < 3; ++pl) {
    const Footprint f = footprint(pl == 1 ? cc[1] : cc[0],
                                  pl == 0 ? cc[1] : cc[2], S);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float x = f.x0 + (float)(k & 1), y = f.y0 + (float)(k >> 1);
      const bool on = x >= 0.f && x <= hi && y >= 0.f && y <= hi;
      off[pl * 4 + k] = on ? ((pl * S + (int)y) * S + (int)x) * C : -1;
      w[pl * 4 + k] = on ? f.w[k] : 0.f;
    }
  }
  const bf16* base = tri + (long long)b * 3 * S * S * C;
  const int tpp = 1 << tpp_log2;
  for (int ch = lane & (tpp - 1); ch < (C >> 3); ch += tpp) {
    uint4 v[12];
#pragma unroll
    for (int i = 0; i < 12; ++i)
      v[i] = off[i] >= 0 ? ld16(base + off[i] + ch * 8)
                         : make_uint4(0u, 0u, 0u, 0u);
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float f[8];
        unpack8(v[pl * 4 + k], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] += f[i] * w[pl * 4 + k];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += s[i];
    }
    st16(out + pt * C + ch * 8, pack8(acc));
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

#if !defined(EMP_TB_LIGHT) || !defined(EMP_TB_LANES) || !defined(EMP_TB_CHUNK)
#error "ops/_build.py passes the B7 backward's sum order as -DEMP_TB_*"
#endif
constexpr int TB_SLICE_LOG2 = 11;
constexpr int TB_SLICE = 1 << TB_SLICE_LOG2;  // points a sort block
constexpr int TB_KPT = 4;                     // keys a thread
constexpr int TB_SORT_THREADS = TB_SLICE / TB_KPT;
constexpr int TB_TILE = 1024;                 // cells a count block
constexpr int TB_PLACE_THREADS = 256;         // keys a place block
constexpr int TB_LIGHT = EMP_TB_LIGHT;  // the most entries a texel sums itself
constexpr int TB_LANES = EMP_TB_LANES;  // threads a chunk block
constexpr int TB_CHUNK = EMP_TB_CHUNK;  // entries a chunk
constexpr int TB_PPT = TB_CHUNK / TB_LANES;   // entries a chunk thread
constexpr unsigned TB_NONE = 0xffffffffu;     // a dropped point's key
static_assert(TB_LANES >= 64 && TB_LANES <= 1024 &&
                  (TB_LANES & (TB_LANES - 1)) == 0,
              "the chunk tree halves a power of two down to a warp");
static_assert(TB_CHUNK % TB_LANES == 0, "whole entries a chunk thread");
// a heavy cell of n entries has ceil(n / TB_CHUNK) <= n / (TB_LIGHT + 1)
// chunks, so a (b, plane) of P points has at most P / (TB_LIGHT + 1)
static_assert(TB_LIGHT >= 0 && TB_CHUNK >= 2 * (TB_LIGHT + 1),
              "the chunk scratch bound");

// Bitonic sort, ascending, of TB_SLICE keys held TB_KPT a thread (thread
// t: positions TB_KPT t ...).  One stage (K, H): position i meets i ^ H
// and keeps the smaller key when it is the lower position of the pair
// and (i & K) == 0, or the upper one and (i & K) != 0.
template <int K, int H>
__device__ __forceinline__ void bitonic_stage(unsigned (&key)[TB_KPT],
                                              unsigned* sk, int base) {
  if constexpr (H < TB_KPT) {  // both in this thread
#pragma unroll
    for (int i = 0; i < TB_KPT; ++i) {
      if (i & H) continue;
      const bool up = ((base + i) & K) == 0;
      const unsigned a = key[i], c = key[i + H];
      key[i] = up ? min(a, c) : max(a, c);
      key[i + H] = up ? max(a, c) : min(a, c);
    }
    return;
  }
  unsigned other[TB_KPT];
  if constexpr (H < TB_KPT * 32) {  // the partner is lane ^ (H / TB_KPT)
#pragma unroll
    for (int i = 0; i < TB_KPT; ++i)
      other[i] = __shfl_xor_sync(0xffffffffu, key[i], H / TB_KPT);
  } else {  // through shared memory
    __syncthreads();  // the previous such stage has read sk
#pragma unroll
    for (int i = 0; i < TB_KPT; ++i) sk[base + i] = key[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TB_KPT; ++i) other[i] = sk[(base + i) ^ H];
  }
#pragma unroll
  for (int i = 0; i < TB_KPT; ++i) {
    const bool keep_min = (((base + i) & H) == 0) == (((base + i) & K) == 0);
    key[i] = keep_min ? min(key[i], other[i]) : max(key[i], other[i]);
  }
}

template <int K, int H>
struct BitonicStages {
  static __device__ __forceinline__ void run(unsigned (&key)[TB_KPT],
                                             unsigned* sk, int base) {
    bitonic_stage<K, H>(key, sk, base);
    BitonicStages<K, H / 2>::run(key, sk, base);
  }
};
template <int K>
struct BitonicStages<K, 0> {
  static __device__ __forceinline__ void run(unsigned (&)[TB_KPT],
                                             unsigned*, int) {}
};
template <int K>
struct BitonicSort {
  static __device__ __forceinline__ void run(unsigned (&key)[TB_KPT],
                                             unsigned* sk, int base) {
    BitonicStages<K, K / 2>::run(key, sk, base);
    BitonicSort<2 * K>::run(key, sk, base);
  }
};
template <>
struct BitonicSort<2 * TB_SLICE> {
  static __device__ __forceinline__ void run(unsigned (&)[TB_KPT],
                                             unsigned*, int) {}
};

// Exclusive max-scan of v over the block, in thread order (init -1).
// ws: 33 ints of shared memory, free again when the call returns.
__device__ __forceinline__ int block_exclusive_max(int v, int* ws) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = max(x, y);
  }
  if (lane == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    const int own = lane < (int)(blockDim.x >> 5) ? ws[lane] : -1;
    int s = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s = max(s, y);
    }
    const int before = __shfl_up_sync(0xffffffffu, s, 1);
    ws[lane] = lane ? before : -1;
  }
  __syncthreads();
  const int up = __shfl_up_sync(0xffffffffu, x, 1);
  const int r = max(ws[w], lane ? up : -1);
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(TB_SORT_THREADS) tri_sort_kernel(
    const float* __restrict__ coords,  // (B, P, 3)
    unsigned* __restrict__ keys,       // (3B, NS SLICE)
    int* __restrict__ rank,            // (3B, NS SLICE)
    int* __restrict__ slice_cnt,       // (3B, NS, ncell)
    int P, int S, int NS) {
  __shared__ unsigned sk[TB_SLICE];
  __shared__ int ws[33];
  const int bp = blockIdx.y, b = bp / 3, pl = bp - 3 * b, j = blockIdx.x;
  const int ncell = (S + 1) * (S + 1);
  const int pu = plane_u(pl), pv = plane_v(pl);
  const int base = threadIdx.x * TB_KPT, p0 = j * TB_SLICE;
  unsigned key[TB_KPT];
#pragma unroll
  for (int i = 0; i < TB_KPT; ++i) {
    const int p = p0 + base + i;
    key[i] = TB_NONE;
    if (p < P) {
      const float* c = coords + ((long long)b * P + p) * 3;
      const int cell = cell_of(footprint(__ldg(c + pu), __ldg(c + pv), S), S);
      if (cell >= 0) key[i] = ((unsigned)cell << TB_SLICE_LOG2) | (base + i);
    }
  }
  const long long row = (long long)bp * NS + j;
  int* cnt = slice_cnt + row * ncell;
  for (int c = threadIdx.x; c < ncell; c += TB_SORT_THREADS) cnt[c] = 0;
  BitonicSort<2>::run(key, sk, base);
  // runs of one cell: the start of each key's run (a max-scan of the
  // positions where the cell changes), and the key before and after
  // this thread's keys
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TB_KPT; ++i) sk[base + i] = key[i];
  __syncthreads();  // also orders the zeroed counts before the writes below
  const unsigned prev = base ? sk[base - 1] : TB_NONE;
  const unsigned next = base + TB_KPT < TB_SLICE ? sk[base + TB_KPT] : TB_NONE;
  int start[TB_KPT], last = -1;
#pragma unroll
  for (int i = 0; i < TB_KPT; ++i) {
    const unsigned before = i ? key[i - 1] : prev;
    if (before == TB_NONE || (before >> TB_SLICE_LOG2) !=
                                 (key[i] >> TB_SLICE_LOG2))
      last = base + i;
    start[i] = last;
  }
  const int carry = block_exclusive_max(last, ws);
  unsigned* ko = keys + row * TB_SLICE + base;
  int* ro = rank + row * TB_SLICE + base;
  int r[TB_KPT];
#pragma unroll
  for (int i = 0; i < TB_KPT; ++i) {
    r[i] = base + i - (start[i] < 0 ? carry : start[i]);
    const unsigned after = i + 1 < TB_KPT ? key[i + 1] : next;
    if (key[i] != TB_NONE &&
        (after == TB_NONE ||
         (after >> TB_SLICE_LOG2) != (key[i] >> TB_SLICE_LOG2)))
      cnt[key[i] >> TB_SLICE_LOG2] = r[i] + 1;
  }
#pragma unroll
  for (int i = 0; i < TB_KPT; i += 4) {
    reinterpret_cast<uint4*>(ko)[i / 4] =
        make_uint4(key[i], key[i + 1], key[i + 2], key[i + 3]);
    reinterpret_cast<int4*>(ro)[i / 4] =
        make_int4(r[i], r[i + 1], r[i + 2], r[i + 3]);
  }
}

// slice_cnt[bp, j, c] -> the cell's entries in slices before j;
// tile_off / tile_coff: the cell's offsets among its tile's cells in
// entries and in chunks; tile_sum / tile_csum: the tile's entries and
// chunks.
__global__ void __launch_bounds__(TB_TILE) tri_count_kernel(
    int* __restrict__ slice_cnt, int* __restrict__ tile_off,
    int* __restrict__ tile_sum, int* __restrict__ tile_coff,
    int* __restrict__ tile_csum, int S, int NS) {
  __shared__ int ws[33];
  const int bp = blockIdx.y, ncell = (S + 1) * (S + 1);
  const int c = blockIdx.x * TB_TILE + threadIdx.x;
  int* sc = slice_cnt + (long long)bp * NS * ncell + c;
  int n = 0;
  for (int j0 = 0; j0 < NS; j0 += 8) {  // 8 loads in flight
    int t[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      t[q] = c < ncell && j0 + q < NS ? sc[(long long)(j0 + q) * ncell] : 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (c < ncell && j0 + q < NS) sc[(long long)(j0 + q) * ncell] = n;
      n += t[q];
    }
  }
  int total, chunks;
  const int off = block_exclusive_scan(n, ws, &total);
  const int coff = block_exclusive_scan(
      n > TB_LIGHT ? (n + TB_CHUNK - 1) / TB_CHUNK : 0, ws, &chunks);
  if (c < ncell) {
    tile_off[(long long)bp * ncell + c] = off;
    tile_coff[(long long)bp * ncell + c] = coff;
  }
  if (threadIdx.x == 0) {
    tile_sum[bp * gridDim.x + blockIdx.x] = total;
    tile_csum[bp * gridDim.x + blockIdx.x] = chunks;
  }
}

// Exclusive scan of the ntiles values v[0..] into o[0..], their total
// into o[TB_TILE]; one warp.
__device__ __forceinline__ void warp_scan_tiles(const int* v, int* o,
                                                int ntiles, int lane) {
  int carry = 0;
  for (int t0 = 0; t0 < ntiles; t0 += 32) {
    const int t = t0 + lane;
    const int x0 = t < ntiles ? v[t] : 0;
    const int x = warp_inclusive_scan(x0, lane);
    if (t < ntiles) o[t] = carry + x - x0;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) o[TB_TILE] = carry;
}

// cellptr (3B, ncell + 1): cell c of (b, plane) owns entries cellptr[c]
// .. cellptr[c + 1] - 1, in ascending p; an entry holds its point (ep)
// and its corner weights (ew).  chunkptr (3B, ncell + 1): a heavy cell's
// chunks are chunkptr[c] .. chunkptr[c + 1] - 1 of its (b, plane), and
// chunk_cell (3B, MC) names each chunk's cell.  A thread a key (and a
// cell).
__global__ void __launch_bounds__(TB_PLACE_THREADS) tri_place_kernel(
    const float* __restrict__ coords, const unsigned* __restrict__ keys,
    const int* __restrict__ rank, const int* __restrict__ slice_cnt,
    const int* __restrict__ tile_off, const int* __restrict__ tile_sum,
    const int* __restrict__ tile_coff, const int* __restrict__ tile_csum,
    int* __restrict__ cellptr, int* __restrict__ chunkptr,
    int* __restrict__ chunk_cell, int* __restrict__ ep,
    float4* __restrict__ ew, int P, int S, int NS, int ntiles, int MC) {
  __shared__ int toff[TB_TILE + 1];   // the tiles' entry offsets, total
  __shared__ int tcoff[TB_TILE + 1];  // the tiles' chunk offsets, total
  const int bp = blockIdx.y, b = bp / 3, pl = bp - 3 * b;
  const int ncell = (S + 1) * (S + 1), lane = threadIdx.x & 31;
  if (threadIdx.x < 32)
    warp_scan_tiles(tile_sum + bp * ntiles, toff, ntiles, lane);
  else if (threadIdx.x < 64)
    warp_scan_tiles(tile_csum + bp * ntiles, tcoff, ntiles, lane);
  __syncthreads();
  const int i = blockIdx.x * TB_PLACE_THREADS + threadIdx.x;
  const int* to = tile_off + (long long)bp * ncell;
  const int* tco = tile_coff + (long long)bp * ncell;
  int* cp = cellptr + (long long)bp * (ncell + 1);
  int* kp = chunkptr + (long long)bp * (ncell + 1);
  if (i < ncell) {
    cp[i] = toff[i / TB_TILE] + __ldg(to + i);
    const int q0 = tcoff[i / TB_TILE] + __ldg(tco + i);
    const int q1 = i + 1 < ncell
                       ? tcoff[(i + 1) / TB_TILE] + __ldg(tco + i + 1)
                       : tcoff[TB_TILE];
    kp[i] = q0;
    for (int q = q0; q < q1; ++q) chunk_cell[(long long)bp * MC + q] = i;
  }
  if (i == ncell) {
    cp[i] = toff[TB_TILE];
    kp[i] = tcoff[TB_TILE];
  }
  if (i >= NS * TB_SLICE) return;
  const long long k0 = (long long)bp * NS * TB_SLICE + i;
  const unsigned key = __ldg(keys + k0);
  if (key == TB_NONE) return;
  const int j = i >> TB_SLICE_LOG2, cell = (int)(key >> TB_SLICE_LOG2);
  const int p = j * TB_SLICE + (int)(key & (TB_SLICE - 1));
  const int* sc = slice_cnt + ((long long)bp * NS + j) * ncell;
  const long long at = (long long)bp * P + toff[cell / TB_TILE] +
                       __ldg(to + cell) + __ldg(sc + cell) + __ldg(rank + k0);
  const float* c = coords + ((long long)b * P + p) * 3;
  const Footprint f =
      footprint(__ldg(c + plane_u(pl)), __ldg(c + plane_v(pl)), S);
  ep[at] = p;
  ew[at] = make_float4(f.w[0], f.w[1], f.w[2], f.w[3]);
}

// parts (3B, MC, 4, C) f32: each chunk's sums for its cell's four
// corners.  A block (blockIdx.x, 8 channels, (b, plane)) takes the
// (b, plane)'s chunks blockIdx.x, + gridDim.x, ...: thread t sums the
// chunk's entries i (from the chunk's start) with i % TB_LANES == t in
// ascending i, then a tree adds the threads' sums, TB_LANES / 2 apart,
// then / 4, ... 32 apart through shared memory, then 16, ... 1 apart in
// warp 0 (shuffles).
__global__ void __launch_bounds__(TB_LANES) tri_parts_kernel(
    const bf16* __restrict__ g, const int* __restrict__ cellptr,
    const int* __restrict__ chunkptr, const int* __restrict__ chunk_cell,
    const int* __restrict__ ep, const float4* __restrict__ ew,
    float* __restrict__ parts, int P, int S, int C, int MC) {
  __shared__ float red[TB_LANES / 2][33];  // 4 corners x 8, padded
  const int ch = blockIdx.y, bp = blockIdx.z;
  const int b = bp / 3, ncell = (S + 1) * (S + 1);
  const long long eb = (long long)bp * P;
  const int* cp = cellptr + (long long)bp * (ncell + 1);
  const int* kp = chunkptr + (long long)bp * (ncell + 1);
  const int nq = __ldg(kp + ncell);
  const bf16* gb = g + (long long)b * P * C + ch * 8;
  for (int q = blockIdx.x; q < nq; q += gridDim.x) {
    const int cell = __ldg(chunk_cell + (long long)bp * MC + q);
    const int lo = __ldg(cp + cell) + (q - __ldg(kp + cell)) * TB_CHUNK;
    const int hi = min(lo + TB_CHUNK, __ldg(cp + cell + 1));
    int p[TB_PPT];
    float4 wv[TB_PPT];
    uint4 gv[TB_PPT];
#pragma unroll
    for (int i = 0; i < TB_PPT; ++i) {
      const int e = lo + i * TB_LANES + threadIdx.x;
      const bool in = e < hi;
      p[i] = in ? __ldg(ep + eb + e) : -1;
      wv[i] = in ? __ldg(ew + eb + e) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < TB_PPT; ++i)
      gv[i] = p[i] >= 0 ? ld16(gb + (long long)p[i] * C)
                        : make_uint4(0u, 0u, 0u, 0u);
    float part[32];  // corner k, channel v at 8 k + v
#pragma unroll
    for (int v = 0; v < 32; ++v) part[v] = 0.f;
#pragma unroll
    for (int i = 0; i < TB_PPT; ++i) {
      if (p[i] < 0) continue;
      float gf[8];
      unpack8(gv[i], gf);
      const float wk[4] = {wv[i].x, wv[i].y, wv[i].z, wv[i].w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int v = 0; v < 8; ++v)
          part[k * 8 + v] =
              __fadd_rn(part[k * 8 + v], __fmul_rn(gf[v], wk[k]));
    }
    // warp 0 reads red only before the last barrier of this loop, so the
    // other warps may start the next chunk while it finishes this one
    for (int off = TB_LANES / 2; off >= 32; off >>= 1) {
      if (threadIdx.x >= off && threadIdx.x < 2 * off) {
#pragma unroll
        for (int v = 0; v < 32; ++v) red[threadIdx.x - off][v] = part[v];
      }
      __syncthreads();
      if (threadIdx.x < off) {
#pragma unroll
        for (int v = 0; v < 32; ++v)
          part[v] = __fadd_rn(part[v], red[threadIdx.x][v]);
      }
      __syncthreads();
    }
    if (threadIdx.x < 32) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int v = 0; v < 32; ++v)
          part[v] = __fadd_rn(part[v],
                              __shfl_down_sync(0xffffffffu, part[v], off));
      if (threadIdx.x == 0) {
        float* o = parts + ((long long)bp * MC + q) * 4 * C + ch * 8;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float4* o4 = reinterpret_cast<float4*>(o + k * C);
          o4[0] = make_float4(part[8 * k], part[8 * k + 1], part[8 * k + 2],
                              part[8 * k + 3]);
          o4[1] = make_float4(part[8 * k + 4], part[8 * k + 5],
                              part[8 * k + 6], part[8 * k + 7]);
        }
      }
    }
  }
}

// grad (B, 3, S, S, C) bf16: a thread a (b plane, texel, 8 channels).  For
// its corners k = 0..3 of the cells (y, x), (y, x - 1), (y - 1, x),
// (y - 1, x - 1): the cell's sum s_k (a light cell's entries in list
// order from 0, four entries' loads in flight; a heavy cell's chunk sums
// in order from 0), added into 0 in order k = 0..3.
__global__ void __launch_bounds__(256) tri_grad_kernel(
    const bf16* __restrict__ g, const int* __restrict__ cellptr,
    const int* __restrict__ chunkptr, const int* __restrict__ ep,
    const float4* __restrict__ ew, const float* __restrict__ parts,
    bf16* __restrict__ grad, int B, int P, int S, int C, int MC) {
  const int chunks = C >> 3;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int ch = (int)(t % chunks);
  const long long r = t / chunks;
  const int texel = (int)(r % ((long long)S * S)), bp = (int)(r / S / S);
  if (bp >= 3 * B) return;
  const int b = bp / 3, ncell = (S + 1) * (S + 1);
  const int y = texel / S, x = texel - y * S;
  const int* cp = cellptr + (long long)bp * (ncell + 1);
  const long long eb = (long long)bp * P;
  const bf16* gb = g + (long long)b * P * C + ch * 8;
  int a[4], e[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cell = (y - (k >> 1) + 1) * (S + 1) + x - (k & 1) + 1;
    a[k] = __ldg(cp + cell);
    e[k] = __ldg(cp + cell + 1);
  }
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (e[k] - a[k] <= TB_LIGHT) {
      for (int i0 = a[k]; i0 < e[k]; i0 += 4) {
        int p[4];
        float wk[4];
        uint4 gv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool in = i0 + q < e[k];
          p[q] = in ? __ldg(ep + eb + i0 + q) : 0;
          const float4 wv = in ? __ldg(ew + eb + i0 + q)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          wk[q] = k == 0 ? wv.x : k == 1 ? wv.y : k == 2 ? wv.z : wv.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gv[q] = i0 + q < e[k] ? ld16(gb + (long long)p[q] * C)
                                : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (i0 + q >= e[k]) break;
          float gf[8];
          unpack8(gv[q], gf);
#pragma unroll
          for (int v = 0; v < 8; ++v)
            s[v] = __fadd_rn(s[v], __fmul_rn(gf[v], wk[q]));
        }
      }
    } else {
      const int cell = (y - (k >> 1) + 1) * (S + 1) + x - (k & 1) + 1;
      const int q0 = __ldg(chunkptr + (long long)bp * (ncell + 1) + cell);
      const int nq = (e[k] - a[k] + TB_CHUNK - 1) / TB_CHUNK;
#pragma unroll 4
      for (int q = q0; q < q0 + nq; ++q) {
        const float4* pp = reinterpret_cast<const float4*>(
            parts + (((long long)bp * MC + q) * 4 + k) * C + ch * 8);
        const float4 u0 = __ldg(pp), u1 = __ldg(pp + 1);
        const float u[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
        for (int v = 0; v < 8; ++v) s[v] = __fadd_rn(s[v], u[v]);
      }
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[v] = __fadd_rn(acc[v], s[v]);
  }
  st16(grad + ((long long)bp * S * S + texel) * C + ch * 8, pack8(acc));
}

// The backward's scratch (int32 words unless noted), every array over the
// 3B (b, plane) rows; ew and parts start 16-byte aligned.  MC bounds a
// (b, plane)'s chunks.  With meta null only the sizes are set.
struct TriBwdScratch {
  long long words;
  int NS, ncell, ntiles, W, MC;
  unsigned* keys;
  int *rank, *slice_cnt, *tile_off, *tile_sum, *tile_coff, *tile_csum;
  int *cellptr, *chunkptr, *chunk_cell, *ep;
  float4* ew;
  float* parts;
};

static TriBwdScratch tri_bwd_scratch(void* meta, int B, int P, int S,
                                     int C) {
  TriBwdScratch s;
  s.NS = (P + TB_SLICE - 1) / TB_SLICE;
  s.ncell = (S + 1) * (S + 1);
  s.ntiles = (s.ncell + TB_TILE - 1) / TB_TILE;
  s.W = (P + TB_CHUNK - 1) / TB_CHUNK;
  s.MC = P / (TB_LIGHT + 1) > 0 ? P / (TB_LIGHT + 1) : 1;
  const long long bp = 3LL * B;
  int* m = (int*)meta;
  long long at = 0;
  auto take = [&](long long n) {
    int* p = m ? m + at : nullptr;
    at += n;
    return p;
  };
  s.keys = (unsigned*)take(bp * s.NS * TB_SLICE);
  s.rank = take(bp * s.NS * TB_SLICE);
  s.slice_cnt = take(bp * s.NS * s.ncell);
  s.tile_off = take(bp * s.ncell);
  s.tile_sum = take(bp * s.ntiles);
  s.tile_coff = take(bp * s.ncell);
  s.tile_csum = take(bp * s.ntiles);
  s.cellptr = take(bp * (s.ncell + 1));
  s.chunkptr = take(bp * (s.ncell + 1));
  s.chunk_cell = take(bp * s.MC);
  s.ep = take(bp * P);
  at = (at + 3) & ~3LL;
  s.ew = (float4*)take(bp * P * 4);
  s.parts = (float*)take(bp * s.MC * 4 * C);
  s.words = at;
  return s;
}

static bool tri_bwd_takes(int B, int P, int S, int C) {
  return B > 0 && 3 * B <= 65535 && P > 0 && S > 0 && S <= 1022 && C > 0 &&
         C % 8 == 0 && C / 8 <= 65535;
}

}  // namespace emp

extern "C" {

// C % 8 == 0; 3 S^2 C < 2^31 (int offsets into a batch row's planes).
int emp_triplane_sample_fwd(const void* tri, const void* coords, void* out,
                            int B, int P, int S, int C, void* stream) {
  if (B <= 0 || P <= 0 || S <= 0 || C <= 0 || C % 8 ||
      3LL * S * S * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int tpp_log2 = 2;  // threads a point: C / 8 rounded up, in [4, 32]
  while (tpp_log2 < 5 && (1 << tpp_log2) < C / 8) ++tpp_log2;
  const long long warps =
      ((long long)B * P + (32 >> tpp_log2) - 1) >> (5 - tpp_log2);
  const unsigned blocks = (unsigned)((warps * 32 + 255) / 256);
  emp::triplane_sample_fwd_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const emp::bf16*)tri, (const float*)coords, (emp::bf16*)out, B, P, S,
      C, tpp_log2);
  return (int)cudaGetLastError();
}

// The int32 words of emp_triplane_sample_bwd's scratch, into *words.
int emp_triplane_bwd_scratch_words(int B, int P, int S, int C, void* words) {
  if (!emp::tri_bwd_takes(B, P, S, C)) return (int)cudaErrorInvalidValue;
  *(long long*)words = emp::tri_bwd_scratch(nullptr, B, P, S, C).words;
  return 0;
}

// meta: int32 scratch of at least meta_words words
// (emp_triplane_bwd_scratch_words); grad: bf16 (B, 3, S, S, C), every
// value written.  S <= 1022, C % 8 == 0, C / 8 <= 65535, 3B <= 65535.
int emp_triplane_sample_bwd(const void* coords, const void* g, void* meta,
                            long long meta_words, void* grad, int B, int P,
                            int S, int C, void* stream) {
  using namespace emp;
  if (!tri_bwd_takes(B, P, S, C)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const TriBwdScratch s = tri_bwd_scratch(meta, B, P, S, C);
  if (s.words > meta_words) return (int)cudaErrorInvalidValue;
  const float* cd = (const float*)coords;
  const bf16* gd = (const bf16*)g;
  tri_sort_kernel<<<dim3(s.NS, 3 * B), TB_SORT_THREADS, 0, st>>>(
      cd, s.keys, s.rank, s.slice_cnt, P, S, s.NS);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  tri_count_kernel<<<dim3(s.ntiles, 3 * B), TB_TILE, 0, st>>>(
      s.slice_cnt, s.tile_off, s.tile_sum, s.tile_coff, s.tile_csum, S,
      s.NS);
  if ((rc = (int)cudaGetLastError())) return rc;
  const int keys = s.NS * TB_SLICE, cells = s.ncell + 1;
  tri_place_kernel<<<dim3(((keys > cells ? keys : cells) +
                           TB_PLACE_THREADS - 1) /
                              TB_PLACE_THREADS, 3 * B),
                     TB_PLACE_THREADS, 0, st>>>(
      cd, s.keys, s.rank, s.slice_cnt, s.tile_off, s.tile_sum, s.tile_coff,
      s.tile_csum, s.cellptr, s.chunkptr, s.chunk_cell, s.ep, s.ew, P, S,
      s.NS, s.ntiles, s.MC);
  if ((rc = (int)cudaGetLastError())) return rc;
  // a block for each TB_CHUNK entries of a (b, plane): one round when its
  // heavy cells are few and long (the path), more when many are short
  tri_parts_kernel<<<dim3(s.W, C / 8, 3 * B), TB_LANES, 0, st>>>(
      gd, s.cellptr, s.chunkptr, s.chunk_cell, s.ep, s.ew, s.parts, P, S, C,
      s.MC);
  if ((rc = (int)cudaGetLastError())) return rc;
  const long long texels = 3LL * B * S * S * (C / 8);
  tri_grad_kernel<<<(unsigned)((texels + 255) / 256), 256, 0, st>>>(
      gd, s.cellptr, s.chunkptr, s.ep, s.ew, s.parts, (bf16*)grad, B, P, S,
      C, s.MC);
  return (int)cudaGetLastError();
}

}  // extern "C"
