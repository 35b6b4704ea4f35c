// The weighted 4-row gather in four formulations, for Hopper: a study of
// how rows are addressed and staged (kernels E and F).
//
// Replaces: the Pallas bodies of scripts/probe_gather_kernels.py (k_loop_ds,
// k_take, k_adv_index and the block-mask kernel, run by `run`) and
// block_mask_gather of scripts/bench_gather_pallas.py. All compute what the
// weighted 4-row gather kernel (gather_rows.cu) computes,
//   out[n] = ((w0*r0 + w1*r1) + w2*r2) + w3*r3,   r_k = table[idx[n,k]],
// to float32 from a float32 or bf16 table, with __fmul_rn/__fadd_rn so that
// every formulation is bit-equal to the plain PyTorch version. The TPU
// study asked which dynamic row access Mosaic compiles and what it costs,
// along two axes: how a row is addressed (a dynamic one-row slice, a
// vectorised take, an aligned 8-row block load plus a one-hot select) and
// where the indices live (SMEM or VMEM). The Hopper readings:
//
// 0 warp_direct        a warp per point straight from the table (k_loop_ds;
//                      gather_rows.cu's layout): lane l loads quads (4
//                      channels: 16 bytes of float32, 8 of bf16) l, l + 32,
//                      ... of the point's four rows, all of them (four at
//                      C = 512) before any sum
// 1 thread_global_idx  a block per tile of points, a thread per group of 8
//                      channels (quads x and x + c/8) times k point lanes
//                      (c/8 x k = 128 threads; above C = 1024 a thread takes
//                      groups x, x + 128, ...), each lane walking
//                      its share of the tile; idx and w read from global
//                      memory (the "VMEM index" axis: k_take, k_adv_index)
// 2 thread_smem_idx    the same with the tile's idx and w staged in shared
//                      memory (the "SMEM index" axis) by cp.async, while the
//                      lanes' first rows are already on their way
//   Both request the next point's rows before this point's sum. Every
//   load and store of a warp, in all four, is 32 neighbouring quads.
// 3 block_stage        the block-mask kernel's idea on Hopper: the TPU kernel
//                      holds the whole table in VMEM and selects rows from
//                      it; here a block stages a slab of S contiguous table
//                      rows in shared memory with cp.async.bulk (S*C*sizeof
//                      up to 192 KB: 96 rows at float32, 192 at bf16 for
//                      C = 512) and serves from it every point that falls
//                      in it. Four binning passes first (span, count, scan,
//                      fill) order the points by their lowest tap row in
//                      bins of `step` rows, stably, so the order is the
//                      plain mirror's (ops/gather_study.py,
//                      block_stage_plan_plain); then one persistent block
//                      per SM walks its equal share of that order, staging
//                      the slab of each bin it enters. The span pass gives
//                      the widest tap span of any point, and
//                      step = S - span when that leaves at least S/8 rows:
//                      then every point is served from its bin's slab (a
//                      64-wide bilinear map: span 65, step 31 at float32,
//                      127 at bf16). Otherwise (random rows) step = S, and
//                      a point whose taps leave its slab reads them from
//                      the table, so any idx is served right.
//
// Bound on this card: bytes (the float32 output, 4*C bytes per point, and
// the table read once). What each formulation reads through L2 besides: the
// first three every tap's row, 4*C*sizeof bytes per point (3.2 GB a launch
// of 393,216 points at C = 512 from a float32 table), so their ceiling is
// L2's read rate; block_stage one slab per bin a block enters (~50-85 MB),
// so its launch is bound by the output's write, in bin order (rows
// scattered over the output). Outputs are written with evict-first stores:
// each output line is written once, and the table's lines, read again and
// again, should keep their place in L2.
#include <type_traits>

#include "mlp_body.cuh"   // mbarrier, cp.async.bulk and proxy-fence helpers

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int GROUP_THREADS = 128;      // threads of a thread_per_group block
// block_stage
constexpr int SLAB_BYTES = 196608;      // 192 KB of the block's shared memory
constexpr int MIN_SLAB_ROWS = 8;        // the least S that block_stage takes
constexpr int HIST_BINS = 2048;         // most bins of the binning (step >= rows / HIST_BINS)
constexpr int SEG = 1024;               // points per segment of the count and fill passes
constexpr int SPAN_THREADS = 256;
constexpr int COUNT_THREADS = 256;
constexpr int SCAN_THREADS = 256;
constexpr int SERVE_THREADS = 512;
constexpr int SERVE_UNROLL = 4;         // 4-channel quads a lane loads before its math
constexpr uint32_t BULK_PIECE = 16384;  // bytes per cp.async.bulk of a slab

// ---- the weighted sum ---------------------------------------------------

__device__ __forceinline__ float wsum(float wx, float a, float wy, float b, float wz, float c,
                                      float ww, float d) {
  float acc = __fmul_rn(wx, a);
  acc = __fadd_rn(acc, __fmul_rn(wy, b));
  acc = __fadd_rn(acc, __fmul_rn(wz, c));
  return __fadd_rn(acc, __fmul_rn(ww, d));
}

__device__ __forceinline__ float4 wsum4(const float4 wt, const float4 a, const float4 b, const float4 c,
                                        const float4 d) {
  return make_float4(wsum(wt.x, a.x, wt.y, b.x, wt.z, c.x, wt.w, d.x),
                     wsum(wt.x, a.y, wt.y, b.y, wt.z, c.y, wt.w, d.y),
                     wsum(wt.x, a.z, wt.y, b.z, wt.z, c.z, wt.w, d.z),
                     wsum(wt.x, a.w, wt.y, b.w, wt.z, c.w, wt.w, d.w));
}

// 4 channels of a row as loaded: 16 bytes of float32, 8 of bf16
template <typename TIn>
using quad_t = typename std::conditional<std::is_same<TIn, float>::value, float4, uint2>::type;

__device__ __forceinline__ float4 quad_f32(const float4 q) { return q; }

__device__ __forceinline__ float4 quad_f32(const uint2 q) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <bool SHARED, typename Q>
__device__ __forceinline__ Q load_quad(const Q* p) {
  if (SHARED) return *p;
  return __ldg(p);
}

// One point by one warp: lane l sums the quads l, l + 32, ... of its four
// rows (SHARED: rows in shared memory, else in the table), SERVE_UNROLL
// quads' loads ahead of their sums; every load and store of the warp is
// 32 neighbouring quads.
template <typename TIn, bool SHARED>
__device__ __forceinline__ void serve_point(const TIn* r0, const TIn* r1, const TIn* r2, const TIn* r3,
                                            const float4 wt, int c, float* dst, int lane) {
  typedef quad_t<TIn> Q;
  const int quads = c / 4;
  for (int u0 = lane; u0 < quads; u0 += 32 * SERVE_UNROLL) {
    Q v[SERVE_UNROLL][4];
#pragma unroll
    for (int k = 0; k < SERVE_UNROLL; ++k) {
      const int u = u0 + 32 * k;
      if (u < quads) {
        v[k][0] = load_quad<SHARED>(reinterpret_cast<const Q*>(r0) + u);
        v[k][1] = load_quad<SHARED>(reinterpret_cast<const Q*>(r1) + u);
        v[k][2] = load_quad<SHARED>(reinterpret_cast<const Q*>(r2) + u);
        v[k][3] = load_quad<SHARED>(reinterpret_cast<const Q*>(r3) + u);
      }
    }
#pragma unroll
    for (int k = 0; k < SERVE_UNROLL; ++k) {
      const int u = u0 + 32 * k;
      if (u < quads)
        __stcs(reinterpret_cast<float4*>(dst) + u,
                  wsum4(wt, quad_f32(v[k][0]), quad_f32(v[k][1]), quad_f32(v[k][2]), quad_f32(v[k][3])));
    }
  }
}

// ---- F: warp_direct ----------------------------------------------------

template <typename TIn>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
warp_direct_kernel(const TIn* __restrict__ table, const int32_t* __restrict__ idx,
                   const float* __restrict__ w, float* __restrict__ out, int64_t n, int c) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (p >= n) return;
  const int4 r = __ldg(reinterpret_cast<const int4*>(idx) + p);
  const float4 wt = __ldg(reinterpret_cast<const float4*>(w) + p);
  serve_point<TIn, false>(table + (int64_t)r.x * c, table + (int64_t)r.y * c, table + (int64_t)r.z * c,
                          table + (int64_t)r.w * c, wt, c, out + p * c, lane);
}

// ---- F: thread_global_idx, thread_smem_idx -----------------------------

// The group of 8 channels of thread x of c/8, for each of a point's four
// taps: quads x and x + c/8, so that a warp's every load and store is 32
// neighbouring quads (whole 32-byte sectors; eight neighbouring channels
// would leave every 16-byte access half a sector)
template <typename TIn>
struct Group {
  typedef quad_t<TIn> Q;
  Q q[4][2];

  __device__ __forceinline__ static int quad(int x, int h, int c) { return x + h * (c / 8); }

  __device__ __forceinline__ void load(const TIn* table, const int4 rows, int c, int x) {
    const int32_t r[4] = {rows.x, rows.y, rows.z, rows.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h) q[k][h] = __ldg(reinterpret_cast<const Q*>(table + (int64_t)r[k] * c) + quad(x, h, c));
  }

  __device__ __forceinline__ void store(const float4 wt, float* dst, int c, int x) const {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      __stcs(reinterpret_cast<float4*>(dst) + quad(x, h, c),
                wsum4(wt, quad_f32(q[0][h]), quad_f32(q[1][h]), quad_f32(q[2][h]), quad_f32(q[3][h])));
  }
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* global_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(global_src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// blockDim = (g, k), g * k <= GROUP_THREADS, g = min(c/8, GROUP_THREADS):
// thread x owns the groups of 8 channels x, x + g, ... (one at C <= 1024),
// point lane y the tile's points y, y + k, ...; the next point's rows are
// requested before this point's sum. SMEM_IDX: the tile's idx and w come to
// shared memory by cp.async while each lane's first point (its indices read
// from global memory) is already loading. Only WIDE (C > 1024) compiles the
// walk over a thread's further groups: compiled into the kernel for C <= 1024
// too, it slowed thread_global_idx's float32 launch at C = 512 on an H100
// from 0.39 to 0.50 ms (scripts/bench_gather_torch.py).
template <typename TIn, bool SMEM_IDX, bool WIDE>
__global__ void __launch_bounds__(GROUP_THREADS)
thread_per_group_kernel(const TIn* __restrict__ table, const int32_t* __restrict__ idx,
                        const float* __restrict__ w, float* __restrict__ out, int64_t n, int c,
                        int tile) {
  extern __shared__ uint4 tile_smem[];
  int4* s_idx = reinterpret_cast<int4*>(tile_smem);
  float4* s_w = reinterpret_cast<float4*>(s_idx + tile);
  const int64_t p0 = (int64_t)blockIdx.x * tile;
  const int count = (int)min((int64_t)tile, n - p0);
  const int4* g_idx = reinterpret_cast<const int4*>(idx) + p0;
  const float4* g_w = reinterpret_cast<const float4*>(w) + p0;
  const int lanes = blockDim.y, groups = c / 8;
  if (SMEM_IDX) {
    const int tid = threadIdx.y * blockDim.x + threadIdx.x, threads = blockDim.x * blockDim.y;
    for (int j = tid; j < count; j += threads) {
      cp_async16(s_idx + j, g_idx + j);
      cp_async16(s_w + j, g_w + j);
    }
    cp_async_commit();
  }
  int x = threadIdx.x, j = threadIdx.y;
  Group<TIn> cur;
  float4 wt = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j < count) {
    wt = __ldg(g_w + j);
    cur.load(table, __ldg(g_idx + j), c, x);
  }
  if (SMEM_IDX) {
    cp_async_wait_all();
    __syncthreads();
  }
  for (;;) {
    for (; j < count; j += lanes) {
      const int jn = j + lanes;
      Group<TIn> next;
      float4 wn = wt;
      if (jn < count) {
        wn = SMEM_IDX ? s_w[jn] : __ldg(g_w + jn);
        next.load(table, SMEM_IDX ? s_idx[jn] : __ldg(g_idx + jn), c, x);
      }
      cur.store(wt, out + (p0 + j) * c, c, x);
      cur = next;
      wt = wn;
    }
    x += blockDim.x;   // the thread's next group
    if (!WIDE || x >= groups) break;
    j = threadIdx.y;
    if (j < count) {
      wt = SMEM_IDX ? s_w[j] : __ldg(g_w + j);
      cur.load(table, SMEM_IDX ? s_idx[j] : __ldg(g_idx + j), c, x);
    }
  }
}

// ---- E: block_stage ----------------------------------------------------
//
// Its plan lives in int32 words of a scratch buffer that the wrapper
// allocates (gather_study_scratch_words): head (span, step, bins, pad),
// perm (n: the points, grouped by bin, ascending within one), offsets
// (bins_max + 1: each bin's first place in perm), totals (bins_max: the
// points of each bin), counts (bins_max x segments, bin-major; scanned in
// place into each segment's first place within its bin).

enum { HEAD_SPAN = 0, HEAD_STEP = 1, HEAD_BINS = 2, HEAD_WORDS = 4 };

__host__ __device__ inline int slab_rows(int c, int elem) { return SLAB_BYTES / (c * elem); }

__host__ __device__ inline int min_step(int rows, int s) {
  const int a = s / 8 > 1 ? s / 8 : 1;
  const int b = (rows + HIST_BINS - 1) / HIST_BINS;
  return a > b ? a : b;
}

// the bins' width: every point served from its slab where the span allows
__host__ __device__ inline int step_of(int span, int s, int least) {
  if (s - span >= least) return s - span;
  return s > least ? s : least;
}

struct Dims {
  int64_t n, segments;
  int bins_max;
};

__host__ __device__ inline Dims dims_of(int64_t n, int rows, int c, int elem) {
  const int s = slab_rows(c, elem);
  const int least = min_step(rows, s);
  return {n, (n + SEG - 1) / SEG, (rows + least - 1) / least};
}

struct StagePlan {
  int32_t* head;
  int32_t* perm;
  int32_t* offsets;
  int32_t* totals;
  int32_t* counts;
};

__host__ __device__ inline StagePlan stage_plan_of(int32_t* words, Dims d) {
  StagePlan p;
  p.head = words;
  p.perm = words + HEAD_WORDS;
  p.offsets = p.perm + d.n;
  p.totals = p.offsets + d.bins_max + 1;
  p.counts = p.totals + d.bins_max;
  return p;
}

__host__ __device__ inline int64_t stage_plan_words(Dims d) {
  return HEAD_WORDS + d.n + 2 * d.bins_max + 1 + d.segments * d.bins_max;
}

__device__ __forceinline__ int lowest_tap(const int4 r) { return min(min(r.x, r.y), min(r.z, r.w)); }

// span: the widest tap span of any point, by an atomicMax per block
__global__ void __launch_bounds__(SPAN_THREADS)
stage_span_kernel(const int32_t* __restrict__ idx, int64_t n, int32_t* __restrict__ head) {
  __shared__ int warp_max[SPAN_THREADS / 32];
  int m = 0;
  for (int64_t e = (int64_t)blockIdx.x * SPAN_THREADS + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * SPAN_THREADS) {
    const int4 r = __ldg(reinterpret_cast<const int4*>(idx) + e);
    m = max(m, max(max(r.x, r.y), max(r.z, r.w)) - lowest_tap(r));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < SPAN_THREADS / 32; ++i) m = max(m, warp_max[i]);
    if (m > 0) atomicMax(&head[HEAD_SPAN], m);
  }
}

// count: a block per segment of SEG points, its bins counted in shared
// memory, then written whole to the segment's column
__global__ void __launch_bounds__(COUNT_THREADS)
stage_count_kernel(const int32_t* __restrict__ idx, int64_t n, int rows, int s, int32_t* words, Dims d) {
  __shared__ int hist[HIST_BINS];
  const StagePlan p = stage_plan_of(words, d);
  const int step = step_of(p.head[HEAD_SPAN], s, min_step(rows, s));
  const int bins = (rows + step - 1) / step;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.head[HEAD_STEP] = step;
    p.head[HEAD_BINS] = bins;
  }
  for (int b = threadIdx.x; b < bins; b += COUNT_THREADS) hist[b] = 0;
  __syncthreads();
  const int64_t s0 = (int64_t)blockIdx.x * SEG;
  for (int j = threadIdx.x; j < SEG && s0 + j < n; j += COUNT_THREADS)
    atomicAdd(&hist[lowest_tap(__ldg(reinterpret_cast<const int4*>(idx) + s0 + j)) / step], 1);
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += COUNT_THREADS) p.counts[(int64_t)b * d.segments + blockIdx.x] = hist[b];
}

// scan: a block per bin, an exclusive scan of the bin's segment counts in
// place (each segment's first place within the bin) and the bin's total
__global__ void __launch_bounds__(SCAN_THREADS)
stage_scan_kernel(int32_t* words, Dims d) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  const StagePlan p = stage_plan_of(words, d);
  if ((int)blockIdx.x >= p.head[HEAD_BINS]) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* counts = p.counts + (int64_t)blockIdx.x * d.segments;
  int carry = 0;
  for (int64_t t0 = 0; t0 < d.segments; t0 += SCAN_THREADS) {
    const int64_t e = t0 + threadIdx.x;
    const int v = e < d.segments ? counts[e] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = carry;
    for (int i = 0; i < warp; ++i) before += warp_sums[i];
    if (e < d.segments) counts[e] = before + incl - v;
    for (int i = 0; i < SCAN_THREADS / 32; ++i) carry += warp_sums[i];
    __syncthreads();
  }
  if (threadIdx.x == 0) p.totals[blockIdx.x] = carry;
}

// fill: one warp per segment. Each bin's first place in perm is the sum of
// the totals before it (the first segment's warp writes it to offsets);
// the segment's points' bins are read, then placed in rounds of 32 in
// point order (a lane's rank among its round's lanes of the same bin), so
// each bin lists its points ascending
__global__ void __launch_bounds__(32)
stage_fill_kernel(const int32_t* __restrict__ idx, int64_t n, int32_t* words, Dims d) {
  __shared__ int cursor[HIST_BINS];
  __shared__ int bin_of[SEG];
  const StagePlan p = stage_plan_of(words, d);
  const int step = p.head[HEAD_STEP], bins = p.head[HEAD_BINS];
  const int lane = threadIdx.x;
  const int64_t s0 = (int64_t)blockIdx.x * SEG;
  const int count = (int)min((int64_t)SEG, n - s0);
#pragma unroll 8
  for (int j = lane; j < count; j += 32)
    bin_of[j] = lowest_tap(__ldg(reinterpret_cast<const int4*>(idx) + s0 + j)) / step;
  int carry = 0;
  for (int b0 = 0; b0 < bins; b0 += 32) {
    const int b = b0 + lane;
    const int total = b < bins ? p.totals[b] : 0;
    int incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (b < bins) {
      const int first = carry + incl - total;
      cursor[b] = first + p.counts[(int64_t)b * d.segments + blockIdx.x];
      if (blockIdx.x == 0) p.offsets[b] = first;
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (blockIdx.x == 0 && lane == 0) p.offsets[bins] = (int)n;
  __syncwarp();
  for (int r = 0; r < count; r += 32) {
    const int j = r + lane;
    const bool valid = j < count;
    const int bin = valid ? bin_of[j] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    const int pos = valid ? cursor[bin] + __popc(peers & ((1u << lane) - 1)) : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) cursor[bin] += __popc(peers);
    __syncwarp();
    if (valid) p.perm[pos] = (int)(s0 + j);
  }
}

// serve: a persistent block per SM takes places [q0, q1) of perm, an equal
// share; for each bin it meets it stages rows [bin*step, bin*step + S) with
// cp.async.bulk on one mbarrier, then its warps take the bin's places 32 at
// a time (a lane reads one point's perm entry, idx and w; the warp serves
// the 32 points one by one)
template <typename TIn>
__global__ void __launch_bounds__(SERVE_THREADS, 1)
block_stage_serve_kernel(const TIn* __restrict__ table, const int32_t* __restrict__ idx,
                         const float* __restrict__ w, float* __restrict__ out, int64_t n, int c,
                         int rows, int32_t* words, Dims d) {
  extern __shared__ __align__(128) uint8_t slab_smem[];
  const int s = slab_rows(c, (int)sizeof(TIn));
  TIn* slab = reinterpret_cast<TIn*>(slab_smem);
  const uint32_t bar = smem_u32(slab_smem + SLAB_BYTES);
  const StagePlan p = stage_plan_of(words, d);
  const int step = p.head[HEAD_STEP], bins = p.head[HEAD_BINS];
  const int64_t q0 = (int64_t)blockIdx.x * n / gridDim.x, q1 = (int64_t)(blockIdx.x + 1) * n / gridDim.x;
  if (q0 >= q1) return;
  // the bin holding place q0: the last whose offset is <= q0
  int bin = 0, hi = bins;
  while (hi - bin > 1) {
    const int mid = (bin + hi) / 2;
    if (p.offsets[mid] <= q0) bin = mid; else hi = mid;
  }
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = SERVE_THREADS / 32;
  uint32_t phase = 0;
  for (int64_t q = q0; q < q1;) {
    while (p.offsets[bin + 1] <= q) ++bin;   // skip empty bins
    const int64_t end = min((int64_t)p.offsets[bin + 1], q1);
    const int base = bin * step;
    const int srows = min(s, rows - base);
    if (threadIdx.x == 0) {
      // the last slab's reads are done (the __syncthreads below, or above
      // for the first); order them before the copy's writes
      fence_proxy_async();
      const uint32_t bytes = (uint32_t)srows * c * sizeof(TIn);
      mbar_expect_tx(bar, bytes);
      const char* src = reinterpret_cast<const char*>(table + (int64_t)base * c);
      for (uint32_t off = 0; off < bytes; off += BULK_PIECE)
        bulk_copy(smem_u32(slab_smem + off), src + off, min(BULK_PIECE, bytes - off), bar);
    }
    mbar_wait(bar, phase);
    phase ^= 1;
    for (int64_t i0 = q + (int64_t)warp * 32; i0 < end; i0 += (int64_t)warps * 32) {
      int pt = 0;
      int4 r = make_int4(0, 0, 0, 0);
      float4 wt = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i0 + lane < end) {
        pt = p.perm[i0 + lane];
        r = __ldg(reinterpret_cast<const int4*>(idx) + pt);
        wt = __ldg(reinterpret_cast<const float4*>(w) + pt);
      }
      const int m = (int)min((int64_t)32, end - i0);
      for (int j = 0; j < m; ++j) {
        const int ptj = __shfl_sync(0xffffffffu, pt, j);
        const int4 rj = make_int4(__shfl_sync(0xffffffffu, r.x, j), __shfl_sync(0xffffffffu, r.y, j),
                                  __shfl_sync(0xffffffffu, r.z, j), __shfl_sync(0xffffffffu, r.w, j));
        const float4 wj = make_float4(__shfl_sync(0xffffffffu, wt.x, j), __shfl_sync(0xffffffffu, wt.y, j),
                                      __shfl_sync(0xffffffffu, wt.z, j), __shfl_sync(0xffffffffu, wt.w, j));
        float* dst = out + (int64_t)ptj * c;
        const bool served = (unsigned)(rj.x - base) < (unsigned)srows && (unsigned)(rj.y - base) < (unsigned)srows &&
                            (unsigned)(rj.z - base) < (unsigned)srows && (unsigned)(rj.w - base) < (unsigned)srows;
        if (served) {
          serve_point<TIn, true>(slab + (rj.x - base) * c, slab + (rj.y - base) * c, slab + (rj.z - base) * c,
                                 slab + (rj.w - base) * c, wj, c, dst, lane);
        } else {
          serve_point<TIn, false>(table + (int64_t)rj.x * c, table + (int64_t)rj.y * c,
                                  table + (int64_t)rj.z * c, table + (int64_t)rj.w * c, wj, c, dst, lane);
        }
      }
    }
    q = end;
    __syncthreads();
  }
}

// the four binning passes of block_stage into `words`
int launch_plan(const int32_t* idx, int64_t n, int rows, int c, int elem, int32_t* words,
                cudaStream_t stream) {
  const int s = slab_rows(c, elem);
  if (s < MIN_SLAB_ROWS) return -1;
  const Dims d = dims_of(n, rows, c, elem);
  cudaError_t err = cudaMemsetAsync(words, 0, HEAD_WORDS * sizeof(int32_t), stream);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int64_t span_blocks = (n + SPAN_THREADS - 1) / SPAN_THREADS;
  const unsigned span_grid = (unsigned)(span_blocks < 2 * sms ? span_blocks : 2 * sms);
  stage_span_kernel<<<span_grid, SPAN_THREADS, 0, stream>>>(idx, n, words);
  stage_count_kernel<<<(unsigned)d.segments, COUNT_THREADS, 0, stream>>>(idx, n, rows, s, words, d);
  stage_scan_kernel<<<(unsigned)d.bins_max, SCAN_THREADS, 0, stream>>>(words, d);
  stage_fill_kernel<<<(unsigned)d.segments, 32, 0, stream>>>(idx, n, words, d);
  return (int)cudaGetLastError();
}

template <typename TIn>
int launch(const void* table_, const void* idx_, const void* w_, void* out_, int64_t n, int c, int rows,
           int formulation, int tile, void* scratch, cudaStream_t stream) {
  if (n == 0) return 0;
  const TIn* table = static_cast<const TIn*>(table_);
  const int32_t* idx = static_cast<const int32_t*>(idx_);
  const float* w = static_cast<const float*>(w_);
  float* out = static_cast<float*>(out_);
  cudaError_t err;
  if (formulation == 0) {
    const int64_t blocks = (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    warp_direct_kernel<TIn><<<(unsigned)blocks, WARPS_PER_BLOCK * 32, 0, stream>>>(table, idx, w, out, n, c);
  } else if (formulation == 1 || formulation == 2) {
    const bool wide = c / 8 > GROUP_THREADS;
    const int gx = wide ? GROUP_THREADS : c / 8;
    const dim3 block(gx, GROUP_THREADS / gx);
    const unsigned tiles = (unsigned)((n + tile - 1) / tile);
    if (formulation == 1) {
      auto kernel = wide ? thread_per_group_kernel<TIn, false, true> : thread_per_group_kernel<TIn, false, false>;
      kernel<<<tiles, block, 0, stream>>>(table, idx, w, out, n, c, tile);
    } else {
      const int smem = tile * (int)(sizeof(int4) + sizeof(float4));
      auto kernel = wide ? thread_per_group_kernel<TIn, true, true> : thread_per_group_kernel<TIn, true, false>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<tiles, block, smem, stream>>>(table, idx, w, out, n, c, tile);
    }
  } else if (formulation == 3) {
    int32_t* words = static_cast<int32_t*>(scratch);
    const int planned = launch_plan(idx, n, rows, c, (int)sizeof(TIn), words, stream);
    if (planned != 0) return planned;
    const int smem = SLAB_BYTES + 16;   // the slab, then its mbarrier
    err = cudaFuncSetAttribute(block_stage_serve_kernel<TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    block_stage_serve_kernel<TIn><<<(unsigned)sms, SERVE_THREADS, smem, stream>>>(
        table, idx, w, out, n, c, rows, words, dims_of(n, rows, c, (int)sizeof(TIn)));
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

int elem_size(int table_dtype) { return table_dtype == 0 ? 4 : table_dtype == 1 ? 2 : 0; }

}  // namespace

// table dtype codes: 0 = float32, 1 = bfloat16; formulation 0..3 as listed
// at the top. `rows` is the table's row count; `scratch` holds
// gather_study_scratch_words int32 words for block_stage (unused by the
// others). Returns cudaGetLastError() after the launches (0 = success); -1
// for a dtype, formulation or width it does not take.
extern "C" int gather_study(const void* table, const void* idx, const void* w, void* out, int64_t n, int c,
                            int rows, int table_dtype, int formulation, int tile, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1)
    return launch<__nv_bfloat16>(table, idx, w, out, n, c, rows, formulation, tile, scratch, s);
  if (table_dtype == 0) return launch<float>(table, idx, w, out, n, c, rows, formulation, tile, scratch, s);
  return -1;
}

// int32 words of block_stage's plan for n points of a (rows, c) table
extern "C" int64_t gather_study_scratch_words(int64_t n, int rows, int c, int table_dtype) {
  const int elem = elem_size(table_dtype);
  if (elem == 0 || slab_rows(c, elem) < MIN_SLAB_ROWS) return -1;
  return stage_plan_words(dims_of(n, rows, c, elem));
}

// block_stage's binning passes alone, for holding its plan to the plain
// mirror: afterwards `scratch` holds the head, offsets and perm
extern "C" int gather_study_plan(const void* idx, int64_t n, int rows, int c, int table_dtype, void* scratch,
                                 void* stream) {
  const int elem = elem_size(table_dtype);
  if (elem == 0) return -1;
  if (n == 0) return 0;
  return launch_plan(static_cast<const int32_t*>(idx), n, rows, c, elem, static_cast<int32_t*>(scratch),
                     static_cast<cudaStream_t>(stream));
}
