// Weighted 4-row gather (kernel C) and its backward, for Hopper.
//
// Forward replaces: pixelnerf_tpu/ops/gather_pallas.py, gather_rows_lerp /
// _gather_kernel. For each point n with row indices idx[n] (4 taps, rows
// [00, 01, 10, 11] of a border-clamped bilinear lookup, view offset folded
// in) and weights w[n]:
//   out[n] = ((w0*r0 + w1*r1) + w2*r2) + w3*r3
// in float32, in the TPU kernel's order, then cast to the output dtype.
//
// Backward has no Pallas counterpart: the JAX package trains through XLA's
// gather transpose (pixelnerf_tpu/ops/grid_sample.py:126-133). Given
// grad_out (N, C) it computes
//   grad_table[r] = sum over (n,k) with idx[n,k] = r of w[n,k] * grad_out[n]
//   grad_w[n,k]   = sum_c grad_out[n,c] * table[idx[n,k],c]
// in float32, grad_table rounded once to the table's dtype. Either output
// may be skipped (null pointer).
//
// Bound on this card: bytes. Forward, per point: 4 row reads (from L2: a
// 16384x512 bf16 table is 16 MB, resident in the 50 MB L2), one row write,
// 32 bytes of idx/w; 7 flops per channel. Backward: grad_out, the table,
// idx and w read once, grad_table and grad_w written once (~104 MB at
// 65,536 points into 16384x512, 0.031 ms at 3.35 TB/s).
//
// Design, forward: one warp per point; each lane moves 16-byte vectors of
// 8 channels, neighbouring lanes on neighbouring chunks, so every row
// access is coalesced. It uses __fadd_rn/__fmul_rn so that no multiply-add
// is contracted: it is bit-equal to the plain PyTorch version.
//
// Design, backward: a scatter-add turned into a gather by rows, with no
// float atomics and no float32 copy of the table, in a fixed order of
// summation. The E = 4N taps (entry e = 4n + k) are indexed by row in four
// small launches (count: integer atomics on R counters; scan: offsets,
// chunks and the list of rows of more than one chunk, by blocks of 1024
// rows that add their predecessors' sums; fill: each entry takes a place
// in its row, in an order that the fill's atomics set; sort: each row of
// more than one chunk, one block a row, sorted ascending in shared memory
// by a block merge sort, in tiles and merge passes if it is longer), then
// a row's entries are cut into chunks of T = 64 (a row with none has one
// empty chunk, so its zeros are written). owner: one warp per chunk, in
// ascending row order, sorts its chunk's entries in registers (a bitonic
// network: a row of one chunk, the common case, needs no other sort),
// streams their grad_out rows
// through a small cp.async ring in shared memory (bytes in flight that
// hold no registers, so that enough warps fit on an SM to cover the
// latency), sums w * grad_out[n] into float32 registers (up to 1024
// channels; wider rows loop over blocks of 1024) and takes each entry's
// dot with the row's table slice, loaded once per chunk, so that every
// grad_w[e] is written by exactly one warp. A row of one chunk is written
// in the table's dtype at once; a chunk of a row of several writes a
// float32 partial, and combine adds a row's partials in chunk order. A
// point's four taps are rows r, r+1, r+W, r+W+1, whose chunks run close
// together, so grad_out comes from device memory about once and from L2
// after that: the owner reads ~4x grad_out through L2, which bounds it,
// not the device memory. Summation order, the same on every run: within a
// chunk the entries ascending, each product rounded before its add (no
// contracted multiply-add), then the chunks in order; this is
// row_owner_bwd_plain (ops/gather_rows.py) bit for bit. Without
// grad_table a warp per point takes the four dots alone
// (gather_rows_bwd_kernel) and no index is built.
#include "gather_common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;

// One warp per point; each lane handles chunks of 8 channels, strided by
// 32 chunks, so C must be a multiple of 8.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
gather_rows_kernel(const TIn* __restrict__ table, const int32_t* __restrict__ idx,
                   const float* __restrict__ w, TOut* __restrict__ out, int64_t n, int c) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (p >= n) return;
  const int4 rows = __ldg(reinterpret_cast<const int4*>(idx) + p);
  const float4 wt = __ldg(reinterpret_cast<const float4*>(w) + p);
  const TIn* r0p = table + (int64_t)rows.x * c;
  const TIn* r1p = table + (int64_t)rows.y * c;
  const TIn* r2p = table + (int64_t)rows.z * c;
  const TIn* r3p = table + (int64_t)rows.w * c;
  TOut* op = out + p * c;
  for (int ch = lane * 8; ch < c; ch += 32 * 8) {
    float r0[8], r1[8], r2[8], r3[8], o[8];
    load8(r0p + ch, r0);
    load8(r1p + ch, r1);
    load8(r2p + ch, r2);
    load8(r3p + ch, r3);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float acc = __fmul_rn(wt.x, r0[i]);
      acc = __fadd_rn(acc, __fmul_rn(wt.y, r1[i]));
      acc = __fadd_rn(acc, __fmul_rn(wt.z, r2[i]));
      o[i] = __fadd_rn(acc, __fmul_rn(wt.w, r3[i]));
    }
    store8(op + ch, o);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// grad_w alone (the table needs no gradient): one warp per point, its four
// dots in one pass over grad_out[n]; builds no index.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
gather_rows_bwd_kernel(const TIn* __restrict__ table, const int32_t* __restrict__ idx,
                       const TOut* __restrict__ grad_out, float* __restrict__ grad_w, int64_t n, int c) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (p >= n) return;  // the whole warp leaves together: p is warp-uniform
  const int4 rows4 = __ldg(reinterpret_cast<const int4*>(idx) + p);
  const int32_t rows[4] = {rows4.x, rows4.y, rows4.z, rows4.w};
  const TOut* gp = grad_out + p * c;
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ch = lane * 8; ch < c; ch += 32 * 8) {
    float g[8];
    load8(gp + ch, g);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float r[8];
      load8(table + (int64_t)rows[k] * c + ch, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) dot[k] = fmaf(g[i], r[i], dot[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) dot[k] = warp_sum(dot[k]);
  if (lane == 0) reinterpret_cast<float4*>(grad_w)[p] = make_float4(dot[0], dot[1], dot[2], dot[3]);
}

// ---- the row-owner pass's index: count, scan, fill ----
//
// E = 4N entries, entry e = 4n + k going to row idx[n, k]. The index lives
// in int32 words at the start of a scratch buffer that the wrapper
// allocates (ops/gather_rows.py, _plan_sections lists them): counts (R),
// cursor (R), the scan's blocks' state (SCAN_WORDS), offsets (R+1),
// chunk_start (R+1), multi_start (R+1), chunk_row (Q), chunk_first (Q),
// multi_rows (1 + M), perm (E), perm_tmp (E), where Q = R + ceil(E/T)
// bounds the chunks and M = floor(E/(T+1)) the rows of two chunks or
// more. The first three sections are zeroed by launch_plan.
constexpr int SCAN_MAX_BLOCKS = 128;
constexpr int SCAN_SUMS = 4;  // entries, chunks, chunks of rows of >= 2, rows of >= 2
constexpr int SCAN_WORDS = 1 + SCAN_MAX_BLOCKS + SCAN_SUMS * SCAN_MAX_BLOCKS;

struct Plan {
  int32_t* counts;
  int32_t* cursor;
  int32_t* scan_ticket;  // the scan's blocks' order of arrival
  int32_t* scan_flags;   // set once a block's sums are published
  int32_t* scan_sums;    // each block's three sums
  int32_t* offsets;      // exclusive scan of counts
  int32_t* chunk_start;  // exclusive scan of max(1, ceil(count/T)); T a power of two
  int32_t* multi_start;  // exclusive scan of the chunks of rows with >= 2
  int32_t* chunk_row;
  int32_t* chunk_first;  // the chunk's first position in perm
  int32_t* multi_count;  // the number of rows of two chunks or more
  int32_t* multi_rows;   // those rows, ascending
  int32_t* perm;         // entries grouped by row
  int32_t* perm_tmp;     // the sort's merge passes' second buffer
};

int64_t max_multi_rows(int64_t entries, int chunk) { return entries / (chunk + 1); }

int64_t plan_words(int rows, int64_t entries, int chunk) {
  const int64_t q = rows + (entries + chunk - 1) / chunk;
  return 2 * (int64_t)rows + SCAN_WORDS + 3 * ((int64_t)rows + 1) + 2 * q +
         (1 + max_multi_rows(entries, chunk)) + 2 * entries;
}

int64_t partials_offset(int rows, int64_t entries, int chunk) {
  return (plan_words(rows, entries, chunk) * 4 + 15) / 16 * 16;
}

Plan plan_of(void* buf, int rows, int64_t entries, int chunk) {
  const int64_t q = rows + (entries + chunk - 1) / chunk;
  Plan p;
  p.counts = static_cast<int32_t*>(buf);
  p.cursor = p.counts + rows;
  p.scan_ticket = p.cursor + rows;
  p.scan_flags = p.scan_ticket + 1;
  p.scan_sums = p.scan_flags + SCAN_MAX_BLOCKS;
  p.offsets = p.scan_ticket + SCAN_WORDS;
  p.chunk_start = p.offsets + rows + 1;
  p.multi_start = p.chunk_start + rows + 1;
  p.chunk_row = p.multi_start + rows + 1;
  p.chunk_first = p.chunk_row + q;
  p.multi_count = p.chunk_first + q;
  p.multi_rows = p.multi_count + 1;
  p.perm = p.multi_rows + max_multi_rows(entries, chunk);
  p.perm_tmp = p.perm + entries;
  return p;
}

constexpr int INDEX_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_TILES = 8;

// count: one thread per entry; integer atomics on R counters, one per row
// met in a warp (the lanes of a row are matched and their leader adds
// them all), so a row that many entries share costs its warps one add each
__global__ void __launch_bounds__(INDEX_THREADS)
gather_rows_bwd_count(const int32_t* __restrict__ idx, Plan p, int64_t entries) {
  const int64_t e = (int64_t)blockIdx.x * INDEX_THREADS + threadIdx.x;
  const int r = e < entries ? idx[e] : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, r);
  if (r >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&p.counts[r], __popc(peers));
}

// The SCAN_SUMS sums of a block, in thread 0's v[] (the others' are partial).
__device__ __forceinline__ void block_sums(int v[SCAN_SUMS], int (*red)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < SCAN_SUMS; ++k) v[k] = __reduce_add_sync(0xffffffffu, v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < SCAN_SUMS; ++k) red[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < SCAN_SUMS; ++k) v[k] = __reduce_add_sync(0xffffffffu, red[k][lane]);
  }
  __syncthreads();
}

// scan: the rows cut into contiguous ranges of whole tiles of
// SCAN_THREADS rows, one block each (at most SCAN_MAX_BLOCKS). A block
// takes a ticket, so that it only ever waits for blocks that run already;
// sums its range's entries, chunks, chunks of rows of two or more and rows
// of two or more; publishes them; adds those of the blocks before it. Then
// it walks its range in passes of SCAN_TILES tiles, thread t on row t of
// each tile, their counts loaded at once (coalesced): the SCAN_SUMS sums
// of all the pass's tiles are scanned together (within each warp by
// shuffles, then the warps' totals, then the tiles') and carried to the
// next pass. Each thread writes its rows' offsets and their chunks' rows
// and first entries, and lists its rows of two chunks or more; a row of
// many chunks is one thread's loop of stores.
__global__ void __launch_bounds__(SCAN_THREADS, 1)
gather_rows_bwd_scan(Plan p, int rows, int chunk, int rows_per_block) {
  __shared__ int warp_tot[SCAN_SUMS][SCAN_TILES][32];
  __shared__ int tile_base[SCAN_SUMS][SCAN_TILES + 1];
  __shared__ int ticket;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int shift = __ffs(chunk) - 1;  // chunk is a power of two
  if (threadIdx.x == 0) ticket = atomicAdd(p.scan_ticket, 1);
  __syncthreads();
  const int b = ticket;
  const int lo = b * rows_per_block, hi = min(rows, lo + rows_per_block);
  // the range's sums, published
  int carry[SCAN_SUMS] = {0, 0, 0, 0};
  for (int r = lo + threadIdx.x; r < hi; r += SCAN_THREADS) {
    const int cnt = p.counts[r];
    const int nch = max(1, (cnt + chunk - 1) >> shift);
    carry[0] += cnt;
    carry[1] += nch;
    carry[2] += nch >= 2 ? nch : 0;
    carry[3] += nch >= 2 ? 1 : 0;
  }
  block_sums(carry, warp_tot[0]);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < SCAN_SUMS; ++k) p.scan_sums[SCAN_SUMS * b + k] = carry[k];
    __threadfence();
    atomicExch(&p.scan_flags[b], 1);
  }
  // the sums of the blocks before this one (b <= SCAN_MAX_BLOCKS < SCAN_THREADS)
#pragma unroll
  for (int k = 0; k < SCAN_SUMS; ++k) carry[k] = 0;
  if (threadIdx.x < b) {
    while (atomicAdd(&p.scan_flags[threadIdx.x], 0) == 0) {
    }
    __threadfence();
#pragma unroll
    for (int k = 0; k < SCAN_SUMS; ++k) carry[k] = atomicAdd(&p.scan_sums[SCAN_SUMS * threadIdx.x + k], 0);
  }
  block_sums(carry, warp_tot[0]);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < SCAN_SUMS; ++k) tile_base[k][SCAN_TILES] = carry[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SCAN_SUMS; ++k) carry[k] = tile_base[k][SCAN_TILES];
  __syncthreads();
  for (int base = lo; base < hi; base += SCAN_TILES * SCAN_THREADS) {
    int cnt[SCAN_TILES], v[SCAN_SUMS][SCAN_TILES];
#pragma unroll
    for (int i = 0; i < SCAN_TILES; ++i) {
      const int r = base + i * SCAN_THREADS + threadIdx.x;
      cnt[i] = r < hi ? p.counts[r] : 0;
    }
#pragma unroll
    for (int i = 0; i < SCAN_TILES; ++i) {
      const int r = base + i * SCAN_THREADS + threadIdx.x;
      const int nch = r < hi ? max(1, (cnt[i] + chunk - 1) >> shift) : 0;
      v[0][i] = cnt[i];
      v[1][i] = nch;
      v[2][i] = nch >= 2 ? nch : 0;
      v[3][i] = nch >= 2 ? 1 : 0;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < SCAN_SUMS; ++k)
#pragma unroll
        for (int i = 0; i < SCAN_TILES; ++i) {
          const int u = __shfl_up_sync(0xffffffffu, v[k][i], off);
          if (lane >= off) v[k][i] += u;
        }
    }
    if (lane == 31) {
#pragma unroll
      for (int k = 0; k < SCAN_SUMS; ++k)
#pragma unroll
        for (int i = 0; i < SCAN_TILES; ++i) warp_tot[k][i][warp] = v[k][i];
    }
    __syncthreads();
    for (int ki = warp; ki < SCAN_SUMS * SCAN_TILES; ki += SCAN_THREADS / 32) {
      int* tot = warp_tot[ki / SCAN_TILES][ki % SCAN_TILES];
      int x = tot[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += u;
      }
      tot[lane] = x;
    }
    __syncthreads();
    if (threadIdx.x < SCAN_SUMS) {
      int acc = carry[threadIdx.x];
      for (int i = 0; i < SCAN_TILES; ++i) {
        tile_base[threadIdx.x][i] = acc;
        acc += warp_tot[threadIdx.x][i][31];
      }
      tile_base[threadIdx.x][SCAN_TILES] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < SCAN_TILES; ++i) {
      const int r = base + i * SCAN_THREADS + threadIdx.x;
      if (r >= hi) break;
      int incl[SCAN_SUMS];
#pragma unroll
      for (int k = 0; k < SCAN_SUMS; ++k)
        incl[k] = tile_base[k][i] + (warp > 0 ? warp_tot[k][i][warp - 1] : 0) + v[k][i];
      const int nch = max(1, (cnt[i] + chunk - 1) >> shift);
      const int off = incl[0] - cnt[i], cs = incl[1] - nch;
      p.offsets[r] = off;
      p.chunk_start[r] = cs;
      p.multi_start[r] = incl[2] - (nch >= 2 ? nch : 0);
      if (nch >= 2) p.multi_rows[incl[3] - 1] = r;
      for (int j = 0; j < nch; ++j) {
        p.chunk_row[cs + j] = r;
        p.chunk_first[cs + j] = off + j * chunk;
      }
    }
#pragma unroll
    for (int k = 0; k < SCAN_SUMS; ++k) carry[k] = tile_base[k][SCAN_TILES];
    __syncthreads();
  }
  if (hi == rows && threadIdx.x == 0) {
    p.offsets[rows] = carry[0];
    p.chunk_start[rows] = carry[1];
    p.multi_start[rows] = carry[2];
    *p.multi_count = carry[3];
  }
}

// fill: one thread per entry takes the next place in its row: the lanes
// of a warp that share a row take neighbouring places, in lane order, by
// one atomic of their leader; the order between warps is the order in
// which their atomics land, so a row's entries are not in order yet: sort
// orders the rows of several chunks, the owner each chunk of the others
__global__ void __launch_bounds__(INDEX_THREADS)
gather_rows_bwd_fill(const int32_t* __restrict__ idx, Plan p, int64_t entries) {
  const int lane = threadIdx.x & 31;
  const int64_t e = (int64_t)blockIdx.x * INDEX_THREADS + threadIdx.x;
  const int r = e < entries ? idx[e] : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, r);
  const int leader = __ffs(peers) - 1;
  int first = 0;
  if (r >= 0 && lane == leader) first = p.offsets[r] + atomicAdd(&p.cursor[r], __popc(peers));
  first = __shfl_sync(0xffffffffu, first, leader);
  if (r >= 0) p.perm[first + __popc(peers & ((1u << lane) - 1))] = (int32_t)e;
}

constexpr int SORT_THREADS = 512;
constexpr int SORT_RUN = 32;                                  // entries a thread sorts in registers
constexpr int SORT_TILE = SORT_THREADS * SORT_RUN;            // entries a block sorts in shared memory
constexpr int SORT_TILE_WORDS = SORT_TILE + SORT_TILE / 32;   // the tile with a pad word every 32
constexpr int SORT_MAX_BLOCKS = 264;  // two blocks an SM: the rows of several chunks are few
constexpr int32_t NO_ENTRY = 0x7fffffff;  // sorts after every entry

// the number of the n ascending values a[0..n) that are below v
__device__ __forceinline__ int count_below(const int32_t* a, int n, int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// position p of a tile in shared memory: a pad word after every 32, so
// that the lanes of a warp, each at its own run (p = 32 l + c), fall in
// 32 different banks
__device__ __forceinline__ int padded(int p) { return p + (p >> 5); }

// SORT_RUN values in registers, sorted ascending by a bitonic network
// (15 steps, unrolled: no value leaves its register file)
__device__ __forceinline__ void sort_run(int32_t v[SORT_RUN]) {
#pragma unroll
  for (int k = 2; k <= SORT_RUN; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < SORT_RUN; ++i) {
        const int q = i ^ j;
        if (q > i) {
          const int32_t a = v[i], b = v[q];
          const bool up = (i & k) == 0;
          v[i] = up ? min(a, b) : max(a, b);
          v[q] = up ? max(a, b) : min(a, b);
        }
      }
    }
  }
}

// Outputs [d, d + SORT_RUN) of the merge of the ascending runs at tile
// positions [a0, a0 + w) and [a0 + w, a0 + 2w) of src (an entry of the
// first before an equal one of the second), written to dst at a0 + d: the
// merge path's split on diagonal d by a binary search, then SORT_RUN steps.
__device__ __forceinline__ void merge_step(const int32_t* src, int32_t* dst, int a0, int w, int d) {
  const int b0 = a0 + w;
  int lo = max(0, d - w), hi = min(d, w);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (src[padded(a0 + mid)] <= src[padded(b0 + d - 1 - mid)]) lo = mid + 1;
    else hi = mid;
  }
  int i = lo, j = d - lo;
  int32_t x = i < w ? src[padded(a0 + i)] : NO_ENTRY;
  int32_t y = j < w ? src[padded(b0 + j)] : NO_ENTRY;
#pragma unroll 4
  for (int s = 0; s < SORT_RUN; ++s) {
    const bool take_a = j >= w || (i < w && x <= y);
    dst[padded(a0 + d + s)] = take_a ? x : y;
    if (take_a) {
      ++i;
      x = i < w ? src[padded(a0 + i)] : NO_ENTRY;
    } else {
      ++j;
      y = j < w ? src[padded(b0 + j)] : NO_ENTRY;
    }
  }
}

// sort: one block per row of two chunks or more (a row's entries are
// distinct), a block merge sort of tiles of SORT_TILE entries in shared
// memory: each thread sorts a run of SORT_RUN entries in registers, then
// the runs are merged in pairs, two buffers in turn, each thread writing
// SORT_RUN outputs of its pair (log2 of the runs rounds: 9 for a full
// tile). A longer row's sorted tiles are then merged in pairs, between
// perm and perm_tmp, each entry placed by its rank in the other run (a
// binary search), one pass per doubling. The block's own stores are all it
// reads back, after a __syncthreads, so perm is read through plain
// (coherent) loads.
__global__ void __launch_bounds__(SORT_THREADS)
gather_rows_bwd_sort(Plan p) {
  extern __shared__ int32_t smem[];  // two tiles of SORT_TILE_WORDS
  const int n_multi = *p.multi_count;
  for (int m = blockIdx.x; m < n_multi; m += gridDim.x) {
    const int r = p.multi_rows[m];
    const int off = p.offsets[r], n = p.offsets[r + 1] - off;
    int32_t* const perm = p.perm + off;
    for (int t0 = 0; t0 < n; t0 += SORT_TILE) {
      const int len = min(SORT_TILE, n - t0);
      int size = SORT_RUN;  // runs of SORT_RUN, a power of two of them
      while (size < len) size <<= 1;
      const int runs = size / SORT_RUN;
      int32_t* buf = smem;
      int32_t* other = smem + SORT_TILE_WORDS;
      for (int i = threadIdx.x; i < size; i += SORT_THREADS) buf[padded(i)] = i < len ? perm[t0 + i] : NO_ENTRY;
      __syncthreads();
      if (threadIdx.x < runs) {
        int32_t v[SORT_RUN];
#pragma unroll
        for (int c = 0; c < SORT_RUN; ++c) v[c] = buf[padded(threadIdx.x * SORT_RUN + c)];
        sort_run(v);
#pragma unroll
        for (int c = 0; c < SORT_RUN; ++c) buf[padded(threadIdx.x * SORT_RUN + c)] = v[c];
      }
      __syncthreads();
      for (int w = SORT_RUN; w < size; w <<= 1) {
        if (threadIdx.x < runs) {
          const int first = threadIdx.x * SORT_RUN;
          const int a0 = first / (2 * w) * (2 * w);
          merge_step(buf, other, a0, w, first - a0);
        }
        __syncthreads();
        int32_t* const t = buf;
        buf = other;
        other = t;
      }
      for (int i = threadIdx.x; i < len; i += SORT_THREADS) perm[t0 + i] = buf[padded(i)];
      __syncthreads();
    }
    int32_t* from = perm;
    int32_t* to = p.perm_tmp + off;
    for (int width = SORT_TILE; width < n; width <<= 1) {
      for (int i = threadIdx.x; i < n; i += SORT_THREADS) {
        const int lo = i / width * width;
        const int mate = lo ^ width;  // the other run of the pair
        const int mate_n = max(0, min(width, n - mate));
        const int32_t v = from[i];
        to[min(lo, mate) + (i - lo) + count_below(from + mate, mate_n, v)] = v;
      }
      __syncthreads();
      int32_t* const t = from;
      from = to;
      to = t;
    }
    if (from != perm) {
      for (int i = threadIdx.x; i < n; i += SORT_THREADS) perm[i] = from[i];
      __syncthreads();
    }
  }
}

#define RETURN_IF_LAUNCH_FAILED()                 \
  do {                                            \
    const cudaError_t err_ = cudaGetLastError();  \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

int launch_plan(const void* idx, const Plan& p, int rows, int64_t entries, int chunk, cudaStream_t s) {
  if (chunk < 1 || (chunk & (chunk - 1)) != 0) return -2;
  const cudaError_t zeroed =
      cudaMemsetAsync(p.counts, 0, (2 * (size_t)rows + SCAN_WORDS) * sizeof(int32_t), s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  const unsigned blocks = (unsigned)((entries + INDEX_THREADS - 1) / INDEX_THREADS);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  if (entries > 0) {
    gather_rows_bwd_count<<<blocks, INDEX_THREADS, 0, s>>>(ix, p, entries);
    RETURN_IF_LAUNCH_FAILED();
  }
  // whole tiles a block, as few as give each of at most SCAN_MAX_BLOCKS blocks its share
  const int tiles = max(1, (rows + SCAN_THREADS - 1) / SCAN_THREADS);
  const int tiles_per_block = (tiles + SCAN_MAX_BLOCKS - 1) / SCAN_MAX_BLOCKS;
  const int scan_blocks = (tiles + tiles_per_block - 1) / tiles_per_block;
  gather_rows_bwd_scan<<<scan_blocks, SCAN_THREADS, 0, s>>>(p, rows, chunk, tiles_per_block * SCAN_THREADS);
  RETURN_IF_LAUNCH_FAILED();
  if (entries > 0) {
    gather_rows_bwd_fill<<<blocks, INDEX_THREADS, 0, s>>>(ix, p, entries);
    RETURN_IF_LAUNCH_FAILED();
  }
  // the grid covers the most rows of several chunks there can be, up to a
  // cap (its blocks then loop); blocks past the true count leave at once
  const int64_t most = max_multi_rows(entries, chunk);
  if (most > 0) {
    constexpr int smem = 2 * SORT_TILE_WORDS * sizeof(int32_t);
    static const cudaError_t opted_in =
        cudaFuncSetAttribute(gather_rows_bwd_sort, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (opted_in != cudaSuccess) return (int)opted_in;
    const unsigned sort_blocks = (unsigned)(most < SORT_MAX_BLOCKS ? most : SORT_MAX_BLOCKS);
    gather_rows_bwd_sort<<<sort_blocks, SORT_THREADS, smem, s>>>(p);
    RETURN_IF_LAUNCH_FAILED();
  }
  return 0;
}

// ---- the row-owner pass: owner, combine ----

// 16-byte copies from device memory into shared memory that hold no
// registers while in flight (cp.async, L2 only), in groups a thread waits for
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 channels of a grad_out slice as staged in shared memory (16 bytes of
// bf16, 32 of float), turned into floats where they are used
__device__ __forceinline__ float raw_at(const uint4* s, int i, __nv_bfloat16*) {
  const unsigned w = i < 2 ? s->x : i < 4 ? s->y : i < 6 ? s->z : s->w;
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ float raw_at(const uint4* s, int i, float*) {
  const uint4 h = s[i >> 2];
  const int k = i & 3;
  return __uint_as_float(k == 0 ? h.x : k == 1 ? h.y : k == 2 ? h.z : h.w);
}

constexpr int OWNER_WARPS = 4;
constexpr int OWNER_STAGES = 2;
constexpr int OWNER_STAGE_BYTES = 4096;  // a warp's stage: 8 KB a warp, 32 KB a block
constexpr int MAX_CHUNK = 64;            // a chunk's entries sit in two registers a lane

// The 64 values a warp holds, lane l at positions l (lo) and l + 32 (hi),
// sorted ascending by a bitonic network: 21 compare-exchange steps, each a
// shuffle (or, between a lane's own two values, none).
__device__ __forceinline__ void warp_sort64(int32_t& lo, int32_t& hi) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {  // k == 64: positions l and l + 32, ascending
        const int32_t a = min(lo, hi), b = max(lo, hi);
        lo = a;
        hi = b;
        continue;
      }
      // position i and its partner i ^ j: the lower takes the min where
      // the run of k that holds them ascends (bit k of i clear)
      const bool upper = (lane & j) != 0;
      const int32_t olo = __shfl_xor_sync(0xffffffffu, lo, j);
      const int32_t ohi = __shfl_xor_sync(0xffffffffu, hi, j);
      const bool up_lo = (lane & k) == 0, up_hi = ((lane + 32) & k) == 0;
      lo = up_lo != upper ? min(lo, olo) : max(lo, olo);
      hi = up_hi != upper ? min(hi, ohi) : max(hi, ohi);
    }
  }
}

// owner: one warp per chunk (at most MAX_CHUNK entries), G groups of 256
// channels a block of channels (lane l on channels l*8 + j*256). The
// chunk's entries are sorted first (a row of several chunks is sorted
// already: the chunk keeps its order). The entries' grad_out slices stream
// through a ring of OWNER_STAGES stages in shared memory, BATCH entries a
// stage, each lane copying and reading back only its own 16-byte pieces:
// OWNER_STAGES - 1 batches are in flight while one is summed, in entry
// order, into float32 registers, each product rounded before its add. A row of
// one chunk is written in the table's dtype; a chunk of a row of several
// writes its float32 partial to its slot. grad_w[e] is written by the one
// warp whose chunk holds e: set in the first block of channels, added to
// after.
template <typename TIn, typename TOut, int G>
__global__ void __launch_bounds__(OWNER_WARPS * 32)
gather_rows_bwd_owner(const TIn* __restrict__ table, const float* __restrict__ w,
                      const TOut* __restrict__ grad_out, TIn* __restrict__ grad_table,
                      float* __restrict__ partials, float* __restrict__ grad_w, Plan p, int rows,
                      int c, int chunk) {
  constexpr int V = sizeof(TOut) / 2;                    // 16-byte pieces of 8 channels
  constexpr int SLOT = G * 32 * V;                       // one entry's pieces, in uint4
  constexpr int BATCH_RAW = OWNER_STAGE_BYTES / (SLOT * 16);
  constexpr int BATCH = BATCH_RAW < 1 ? 1 : BATCH_RAW > 8 ? 8 : BATCH_RAW;
  __shared__ uint4 ring[OWNER_WARPS][OWNER_STAGES][BATCH * SLOT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * OWNER_WARPS + warp;
  if (q >= p.chunk_start[rows]) return;  // warp-uniform
  const int r = p.chunk_row[q];
  const int first = p.chunk_first[q];
  const int n = min(first + chunk, p.offsets[r + 1]) - first;
  const int own_chunk = p.chunk_start[r];
  const bool single = p.chunk_start[r + 1] - own_chunk == 1;
  const int slot = p.multi_start[r] + q - own_chunk;
  // the chunk's entries, ascending, and their weights, lane l holding
  // entries l and l+32
  int32_t e_lo = lane < n ? p.perm[first + lane] : NO_ENTRY;
  int32_t e_hi = lane + 32 < n ? p.perm[first + 32 + lane] : NO_ENTRY;
  warp_sort64(e_lo, e_hi);
  const float w_lo = lane < n ? w[e_lo] : 0.f;
  const float w_hi = lane + 32 < n ? w[e_hi] : 0.f;
  const int batches = (n + BATCH - 1) / BATCH;
  for (int cb = 0; cb < c; cb += G * 256) {
    // copies batch b of this block of channels into its stage (an empty
    // group past the last batch keeps the count of groups in step)
    auto prefetch = [&](int b) {
      uint4* stage = ring[warp][b % OWNER_STAGES];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int k = b * BATCH + u;
        if (k >= n) break;  // warp-uniform
        const int e = __shfl_sync(0xffffffffu, k < 32 ? e_lo : e_hi, k & 31);
        const char* src = reinterpret_cast<const char*>(grad_out + (int64_t)(e >> 2) * c);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int ch = cb + lane * 8 + j * 256;
          if (ch >= c) continue;
#pragma unroll
          for (int v = 0; v < V; ++v)
            cp_async16(stage + u * SLOT + (j * 32 + lane) * V + v, src + ch * sizeof(TOut) + 16 * v);
        }
      }
      cp_async_commit();
    };
    // the row's table slice, kept as loaded (for the dots)
    constexpr int VT = sizeof(TIn) / 2;
    float acc[G][8];
    uint4 t[G][VT];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int ch = cb + lane * 8 + j * 256;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
#pragma unroll
      for (int v = 0; v < VT; ++v)
        t[j][v] = grad_w != nullptr && n > 0 && ch < c  // an empty row's dots are not taken
                      ? __ldg(reinterpret_cast<const uint4*>(table + (int64_t)r * c + ch) + v)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int b = 0; b < OWNER_STAGES - 1; ++b) prefetch(b);
    for (int b = 0; b < batches; ++b) {
      prefetch(b + OWNER_STAGES - 1);
      cp_async_wait<OWNER_STAGES - 1>();  // batch b has landed
      const uint4* stage = ring[warp][b % OWNER_STAGES];
      float dot[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int k = b * BATCH + u;
        dot[u] = 0.f;
        if (k >= n) continue;  // warp-uniform
        const float wt = __shfl_sync(0xffffffffu, k < 32 ? w_lo : w_hi, k & 31);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (cb + lane * 8 + j * 256 >= c) continue;
          const uint4* g = stage + u * SLOT + (j * 32 + lane) * V;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float gi = raw_at(g, i, static_cast<TOut*>(nullptr));
            acc[j][i] = __fadd_rn(acc[j][i], __fmul_rn(wt, gi));
            dot[u] = fmaf(gi, raw_at(t[j], i, static_cast<TIn*>(nullptr)), dot[u]);
          }
        }
      }
      if (grad_w != nullptr) {  // warp-uniform
#pragma unroll
        for (int u = 0; u < BATCH; ++u) dot[u] = warp_sum(dot[u]);
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int k = b * BATCH + u;
          const int e = __shfl_sync(0xffffffffu, k < 32 ? e_lo : e_hi, k & 31);
          if (lane == 0 && k < n) grad_w[e] = cb == 0 ? dot[u] : grad_w[e] + dot[u];
        }
      }
    }
    cp_async_wait<0>();  // the empty groups, before the ring is used again
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int ch = cb + lane * 8 + j * 256;
      if (ch >= c) continue;
      if (single) store8(grad_table + (int64_t)r * c + ch, acc[j]);
      else store8(partials + (int64_t)slot * c + ch, acc[j]);
    }
  }
}

// combine: a warp takes 32 rows and one slab of 256 channels (blockIdx.y);
// for each of its rows of two chunks or more, in turn, it adds the row's
// partials in chunk order in float32 (8 loaded ahead of their adds) and
// writes the slab in the table's dtype. The other rows cost one ballot.
template <typename TIn>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
gather_rows_bwd_combine(const float* __restrict__ partials, TIn* __restrict__ grad_table, Plan p,
                        int rows, int c) {
  constexpr int AHEAD = 8;
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5)) * 32;
  const int ch = blockIdx.y * 256 + lane * 8;
  const int mine = base + lane;
  unsigned todo = __ballot_sync(
      0xffffffffu, mine < rows && p.chunk_start[mine + 1] - p.chunk_start[mine] >= 2);
  while (todo != 0u) {
    const int r = base + __ffs(todo) - 1;
    todo &= todo - 1u;
    if (ch >= c) continue;
    const int n_chunks = p.chunk_start[r + 1] - p.chunk_start[r];
    const float* src = partials + (int64_t)p.multi_start[r] * c + ch;
    float acc[8];
    load8(src, acc);
    for (int j = 1; j < n_chunks; j += AHEAD) {
      float v[AHEAD][8];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u)
        if (j + u < n_chunks) load8(src + (int64_t)(j + u) * c, v[u]);
#pragma unroll
      for (int u = 0; u < AHEAD; ++u)
        if (j + u < n_chunks) {
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] += v[u][i];
        }
    }
    store8(grad_table + (int64_t)r * c + ch, acc);
  }
}

int64_t blocks_for(int64_t n) { return (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK; }

template <typename TIn, typename TOut>
int launch_fwd(const void* table, const void* idx, const void* w, void* out, int64_t n, int c,
               cudaStream_t stream) {
  if (n == 0) return 0;
  gather_rows_kernel<TIn, TOut><<<(unsigned)blocks_for(n), WARPS_PER_BLOCK * 32, 0, stream>>>(
      static_cast<const TIn*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<TOut*>(out), n, c);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut, int G>
void launch_owner(const void* table, const void* w, const void* grad_out, void* grad_table,
                  void* partials, void* grad_w, const Plan& p, int rows, int c, int chunk,
                  int64_t max_chunks, cudaStream_t s) {
  gather_rows_bwd_owner<TIn, TOut, G><<<(unsigned)((max_chunks + OWNER_WARPS - 1) / OWNER_WARPS), OWNER_WARPS * 32, 0, s>>>(
      static_cast<const TIn*>(table), static_cast<const float*>(w), static_cast<const TOut*>(grad_out),
      static_cast<TIn*>(grad_table), static_cast<float*>(partials), static_cast<float*>(grad_w), p, rows,
      c, chunk);
}

template <typename TIn, typename TOut>
int launch_bwd(const void* table, const void* idx, const void* w, const void* grad_out,
               void* grad_table, void* grad_w, void* scratch, int64_t n, int c, int rows,
               int chunk, cudaStream_t s) {
  if (grad_table == nullptr) {
    if (n == 0 || grad_w == nullptr) return 0;
    gather_rows_bwd_kernel<TIn, TOut><<<(unsigned)blocks_for(n), WARPS_PER_BLOCK * 32, 0, s>>>(
        static_cast<const TIn*>(table), static_cast<const int32_t*>(idx),
        static_cast<const TOut*>(grad_out), static_cast<float*>(grad_w), n, c);
    return (int)cudaGetLastError();
  }
  if (chunk < 1 || chunk > MAX_CHUNK) return -2;
  const int64_t entries = 4 * n;
  const Plan p = plan_of(scratch, rows, entries, chunk);
  void* partials = static_cast<char*>(scratch) + partials_offset(rows, entries, chunk);
  const int err = launch_plan(idx, p, rows, entries, chunk, s);
  if (err != 0) return err;
  // the grid covers the most chunks there can be; warps past the true
  // count (chunk_start[R], known only on the device) leave at once
  const int64_t max_chunks = rows + (entries + chunk - 1) / chunk;
  switch (min(4, (c + 255) / 256)) {
    case 1: launch_owner<TIn, TOut, 1>(table, w, grad_out, grad_table, partials, grad_w, p, rows, c, chunk, max_chunks, s); break;
    case 2: launch_owner<TIn, TOut, 2>(table, w, grad_out, grad_table, partials, grad_w, p, rows, c, chunk, max_chunks, s); break;
    case 3: launch_owner<TIn, TOut, 3>(table, w, grad_out, grad_table, partials, grad_w, p, rows, c, chunk, max_chunks, s); break;
    default: launch_owner<TIn, TOut, 4>(table, w, grad_out, grad_table, partials, grad_w, p, rows, c, chunk, max_chunks, s); break;
  }
  RETURN_IF_LAUNCH_FAILED();
  const dim3 combine_grid((unsigned)blocks_for((rows + 31) / 32), (unsigned)((c + 255) / 256));
  gather_rows_bwd_combine<TIn><<<combine_grid, WARPS_PER_BLOCK * 32, 0, s>>>(
      static_cast<const float*>(partials), static_cast<TIn*>(grad_table), p, rows, c);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Each entry point returns
// cudaGetLastError() after the launch (0 = success); -1 for a dtype pair it
// does not take.
extern "C" int gather_rows_lerp(const void* table, const void* idx, const void* w, void* out,
                                int64_t n, int c, int table_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1 && out_dtype == 1)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16>(table, idx, w, out, n, c, s);
  if (table_dtype == 1 && out_dtype == 0)
    return launch_fwd<__nv_bfloat16, float>(table, idx, w, out, n, c, s);
  if (table_dtype == 0 && out_dtype == 1)
    return launch_fwd<float, __nv_bfloat16>(table, idx, w, out, n, c, s);
  if (table_dtype == 0 && out_dtype == 0)
    return launch_fwd<float, float>(table, idx, w, out, n, c, s);
  return -1;
}

// grad_table: an (R, C) buffer in the table's dtype, or null to skip it;
// grad_w: an (N, 4) float32 buffer, or null to skip it; scratch (unused
// without grad_table): the index's int32 words (plan_words), then, 16-byte
// aligned, float32 partials for at most 2*ceil(4N/chunk) chunks of rows of
// two chunks or more. -2 for a chunk that is not a power of two in
// [1, MAX_CHUNK].
extern "C" int gather_rows_lerp_bwd(const void* table, const void* idx, const void* w,
                                    const void* grad_out, void* grad_table, void* grad_w,
                                    void* scratch, int64_t n, int c, int rows, int chunk,
                                    int table_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD(TIN, TOUT) \
  launch_bwd<TIN, TOUT>(table, idx, w, grad_out, grad_table, grad_w, scratch, n, c, rows, chunk, s)
  if (table_dtype == 1 && out_dtype == 1) return BWD(__nv_bfloat16, __nv_bfloat16);
  if (table_dtype == 1 && out_dtype == 0) return BWD(__nv_bfloat16, float);
  if (table_dtype == 0 && out_dtype == 1) return BWD(float, __nv_bfloat16);
  if (table_dtype == 0 && out_dtype == 0) return BWD(float, float);
#undef BWD
  return -1;
}

// The index launches alone (count, scan, fill), for the tests: plan holds
// the index's int32 words.
extern "C" int gather_rows_bwd_plan(const void* idx, void* plan, int64_t n, int rows, int chunk,
                                    void* stream) {
  return launch_plan(idx, plan_of(plan, rows, 4 * n, chunk), rows, 4 * n, chunk,
                     static_cast<cudaStream_t>(stream));
}
