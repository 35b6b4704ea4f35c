// Pixel-aligned bilinear gather (border padding, align_corners) for Hopper.
//
// Replaces: pixelnerf_tpu/ops/gather_pallas.py, gather_packed_lerp /
// _gather_packed_kernel (the lerp in packed_bilerp). It computes, for each
// point n with row bases base[n] = [y0*W+x0, y1*W+x0] and weights
// w[n] = [wx, wy]:
//   top = l0 + wx*(r0-l0);  bot = l1 + wx*(r1-l1);  out = top + wy*(bot-top)
// in float32, where l/r are the rows at x0 and min(x0+1, W-1). The TPU kernel
// packed both x-corners into int32 lanes to work around Mosaic's row loads;
// here the bf16 (or f32) table is read directly. The table may hold many
// views as one flat (views*H*W, C) table: the view offset is folded into the
// bases, and since H*W is a multiple of W, base % W is still x0.
//
// Bound on this card: bytes. Per point it writes one row and reads its two
// bases and two weights (16 bytes); the table is read once. The arithmetic
// is 6 flops per channel. The table of one view (64x64x512 or 128x128x128
// bf16 = 4 MB) stays resident in the 50 MB L2, so device memory sees mostly
// the output and the records; L2 and L1 serve the four corner rows of every
// point, 4x the output's bytes (1.07 GB a launch of 1,048,576 points at 128
// bf16 channels), and the SM's issue slots take the unpack and lerp of
// every channel.
//
// Design. A row is cut into 16-byte pieces (8 bf16 channels or 4 float32);
// neighbouring lanes take neighbouring pieces of one row, so every warp
// access is whole 32-byte sectors.
// - Rows of at most 32 pieces (up to 256 bf16 or 128 float32 channels): a
//   point is served by L lanes, its pieces rounded up to a power of two
//   (launch_lanes), one piece a lane, and a warp serves G = 32/L points
//   side by side (2 at 128 bf16 channels, 4 at 64), so no lane idles.
//   A persistent grid (the blocks that fit on the card at once)
//   walks chunks of 256 neighbouring points, one a block at a time: each
//   thread loads one record (two coalesced 8-byte loads) and works out its
//   right step (one modulo a point), the next chunk's records are loaded
//   under this chunk's work, and __shfl_sync hands them out. The 8 warps of
//   a block take the chunk's groups of G points in turns (warp w groups w,
//   w + 8, ...), so that at any moment a block works on neighbouring points,
//   which on a request's ray-major points share corner rows in L1. A lane
//   requests the rows of UNROLL groups before the first lerp. Outputs are
//   written with evict-first stores (st.global.cs): each line is written
//   once, and the table's lines keep their place in L2.
// - Wider rows (the SRN latent's 512 channels, a baked map's 1536): a warp a
//   point, lane l taking pieces l, l + 32, ..., and a block of 8 warps 8
//   neighbouring points, as before this design. Here the four corner rows'
//   reads through L2 hold the kernel, not the lanes or the chain of a point.
// The lerp is gather_common.cuh's lerp_rn (__fadd_rn/__fmul_rn, no
// contracted multiply-add), as in the fused gather+MLP kernel
// (fused_field.cu): the result is bit-equal to the plain PyTorch version and
// to kernel D's gathered latents.
#include "gather_common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = WARPS_PER_BLOCK * 32;
constexpr int CHUNK = THREADS;   // points a block takes at a time, one record a thread
constexpr int UNROLL = 2;       // groups of points whose rows a lane requests before any lerp
constexpr unsigned FULL = 0xffffffffu;

// 16 bytes of a table row: 8 bf16 channels or 4 float32
template <typename TIn>
struct Piece;

template <>
struct Piece<__nv_bfloat16> {
  typedef uint4 raw;
  static constexpr int channels = 8;
};

template <>
struct Piece<float> {
  typedef float4 raw;
  static constexpr int channels = 4;
};

__device__ __forceinline__ void unpack(const uint4 r, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const float4 r, float v[4]) {
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}

// Evict-first stores (st.global.cs) of one piece's channels.
template <int K>
__device__ __forceinline__ void store_piece(__nv_bfloat16* p, const float (&v)[K]) {
  if constexpr (K == 8) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    __stcs(reinterpret_cast<uint4*>(p), raw);
  } else {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    __stcs(reinterpret_cast<uint2*>(p), raw);
  }
}

template <int K>
__device__ __forceinline__ void store_piece(float* p, const float (&v)[K]) {
#pragma unroll
  for (int i = 0; i < K / 4; ++i)
    __stcs(reinterpret_cast<float4*>(p) + i, make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]));
}

// The record of point p, or a zero record past the end (row 0 exists: its
// loads are harmless and its lerp is never stored).
__device__ __forceinline__ void load_record(const int2* __restrict__ base, const float2* __restrict__ w,
                                            int64_t n, int64_t p, int2& b, float2& wt) {
  if (p < n) {
    b = __ldg(base + p);
    wt = __ldg(w + p);
  } else {
    b = make_int2(0, 0);
    wt = make_float2(0.f, 0.f);
  }
}

// The point of a block's chunk whose record lane i of warp `warp` holds:
// the warp's groups are the block's groups warp, warp + 8, ..., and lane i
// holds point i % G of the warp's group i / G.
template <int G>
__device__ __forceinline__ int chunk_point(int warp, int i) {
  return (warp + WARPS_PER_BLOCK * (i / G)) * G + i % G;
}

// The lerp of one piece of a point's four corner rows, stored.
template <typename TIn, typename TOut>
__device__ __forceinline__ void lerp_store(const typename Piece<TIn>::raw (&v)[4], float wx, float wy,
                                           TOut* dst) {
  constexpr int K = Piece<TIn>::channels;
  float l0[K], r0[K], l1[K], r1[K], o[K];
  unpack(v[0], l0);
  unpack(v[1], r0);
  unpack(v[2], l1);
  unpack(v[3], r1);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float top = lerp_rn(l0[i], r0[i], wx);
    const float bot = lerp_rn(l1[i], r1[i], wx);
    o[i] = lerp_rn(top, bot, wy);
  }
  store_piece<K>(dst, o);
}

// Rows of at most 32 pieces: L lanes per point (a power of two, 1..32),
// G = 32 / L points side by side, a block's chunk of 256 points at a time.
template <typename TIn, typename TOut, int L>
__global__ void __launch_bounds__(THREADS)
gather_bilerp_kernel(const TIn* __restrict__ table, const int2* __restrict__ base,
                     const float2* __restrict__ w, TOut* __restrict__ out, int64_t n, int c,
                     int width) {
  typedef typename Piece<TIn>::raw Raw;
  constexpr int K = Piece<TIn>::channels;
  constexpr int G = 32 / L;                      // points side by side; a warp's chunk share is L groups
  constexpr int U = UNROLL < L ? UNROLL : L;     // groups a batch
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % L;                      // the lane's piece of its point's row
  const int slot = lane / L;                     // the lane's point within its group
  const int pieces = c / K;
  const int64_t chunks = (n + CHUNK - 1) / CHUNK;
  const int own = chunk_point<G>(warp, lane);
  int64_t chunk = blockIdx.x;
  int2 rb;
  float2 rw;
  load_record(base, w, n, chunk * CHUNK + own, rb, rw);
  for (; chunk < chunks; chunk += gridDim.x) {
    int2 nb;
    float2 nw;
    load_record(base, w, n, (chunk + gridDim.x) * CHUNK + own, nb, nw);
    const int rdx = right_step(rb.x, width);
    const int64_t p0 = chunk * CHUNK;
    for (int j0 = 0; j0 < L; j0 += U) {
      int32_t b0[U], b1[U], dx[U];
      float wx[U], wy[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = (j0 + u) * G + slot;
        b0[u] = __shfl_sync(FULL, rb.x, q);
        b1[u] = __shfl_sync(FULL, rb.y, q);
        dx[u] = __shfl_sync(FULL, rdx, q);
        wx[u] = __shfl_sync(FULL, rw.x, q);
        wy[u] = __shfl_sync(FULL, rw.y, q);
      }
      if (sub < pieces) {
        Raw v[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const Raw* r0 = reinterpret_cast<const Raw*>(table + (int64_t)b0[u] * c) + sub;
          const Raw* r1 = reinterpret_cast<const Raw*>(table + (int64_t)b1[u] * c) + sub;
          v[u][0] = __ldg(r0);
          v[u][1] = __ldg(r0 + dx[u] * pieces);
          v[u][2] = __ldg(r1);
          v[u][3] = __ldg(r1 + dx[u] * pieces);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t p = p0 + (warp + WARPS_PER_BLOCK * (j0 + u)) * G + slot;
          if (p < n) lerp_store<TIn, TOut>(v[u], wx[u], wy[u], out + p * c + (int64_t)sub * K);
        }
      }
    }
    rb = nb;
    rw = nw;
  }
}

// One wide row (more than 32 pieces) of a point, served by a warp: lane l
// takes pieces l, l + 32, ... of the lerp of its four corner rows.
template <typename TIn, typename TOut>
__device__ __forceinline__ void wide_row(const TIn* __restrict__ table, int32_t b0, int32_t b1, float wx,
                                         float wy, int c, int width, int lane, TOut* __restrict__ dst) {
  typedef typename Piece<TIn>::raw Raw;
  constexpr int K = Piece<TIn>::channels;
  if constexpr (K == 8) {
    const Corners<TIn> k = corners_of(table, b0, b1, c, width);
    for (int ch = lane * 8; ch < c; ch += 32 * 8) {
      float o[8];
      bilerp8(k, ch, wx, wy, o);
      store8(dst + ch, o);
    }
  } else {
    const int pieces = c / K;
    const int right = right_step(b0, width) * pieces;
    const Raw* r0 = reinterpret_cast<const Raw*>(table + (int64_t)b0 * c);
    const Raw* r1 = reinterpret_cast<const Raw*>(table + (int64_t)b1 * c);
    for (int k = lane; k < pieces; k += 32) {
      const Raw v[4] = {__ldg(r0 + k), __ldg(r0 + right + k), __ldg(r1 + k), __ldg(r1 + right + k)};
      lerp_store<TIn, TOut>(v, wx, wy, dst + (int64_t)k * K);
    }
  }
}

// Rows of more than 32 pieces: a warp a point, lane l taking pieces l,
// l + 32, ...; a block of 8 warps takes 8 neighbouring points. A bf16
// row's piece is gather_common.cuh's 8-channel chunk: its loads, lerp and
// plain stores (bilerp8, store8) are the parent kernel's. On an H100 80GB
// HBM3 at 700 W (scripts/bench_gather_a_torch.py, 1,048,576 points, four
// runs of each body, alternated on one card) they took 0.5005-0.5015
// ms at 512 channels against 0.5055-0.5064 for lerp_store with evict-first
// stores, and 0.4530-0.4597 against 0.4729-0.4732 on a request's points;
// at 1536 channels lerp_store was 1% faster on uniform points (1.5401-1.5431
// against 1.5552-1.5565) and no faster on a request's (1.1619-1.1997
// against 1.1493-1.1722). A float32 row's 4-channel pieces are loaded
// whole (the header's 8-channel float32 load takes half a sector per
// access) and stored evict-first.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
gather_bilerp_wide_kernel(const TIn* __restrict__ table, const int2* __restrict__ base,
                          const float2* __restrict__ w, TOut* __restrict__ out, int64_t n, int c,
                          int width) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (p >= n) return;
  // the record as four scalar loads: on bf16 rows, 8-byte loads of it
  // measured slower, on request-shaped points (PERF.md)
  const int32_t b0 = __ldg(reinterpret_cast<const int32_t*>(base) + 2 * p);
  const int32_t b1 = __ldg(reinterpret_cast<const int32_t*>(base) + 2 * p + 1);
  const float wx = __ldg(reinterpret_cast<const float*>(w) + 2 * p);
  const float wy = __ldg(reinterpret_cast<const float*>(w) + 2 * p + 1);
  wide_row<TIn, TOut>(table, b0, b1, wx, wy, c, width, lane, out + p * c);
}

template <typename TIn, typename TOut, int L>
int launch(const void* table, const void* base, const void* w, void* out, int64_t n, int c,
           int width, cudaStream_t stream) {
  if (n == 0) return 0;
  auto kernel = gather_bilerp_kernel<TIn, TOut, L>;
  // blocks an SM holds at once, asked once per instantiation
  static int resident = 0;
  if (resident == 0) {
    int r = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, kernel, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    resident = r > 0 ? r : 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (n + CHUNK - 1) / CHUNK;
  const int64_t persistent = (int64_t)sms * resident;
  if (blocks > persistent) blocks = persistent;
  kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const TIn*>(table), static_cast<const int2*>(base), static_cast<const float2*>(w),
      static_cast<TOut*>(out), n, c, width);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int launch_wide(const void* table, const void* base, const void* w, void* out, int64_t n, int c,
                int width, cudaStream_t stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  gather_bilerp_wide_kernel<TIn, TOut><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const TIn*>(table), static_cast<const int2*>(base), static_cast<const float2*>(w),
      static_cast<TOut*>(out), n, c, width);
  return (int)cudaGetLastError();
}

// L, the lanes a point: its row's pieces rounded up to a power of two; rows
// of more than 32 pieces take a warp a point.
template <typename TIn, typename TOut>
int launch_lanes(const void* table, const void* base, const void* w, void* out, int64_t n, int c,
                 int width, cudaStream_t s) {
  const int pieces = c / Piece<TIn>::channels;
  if (pieces > 32) return launch_wide<TIn, TOut>(table, base, w, out, n, c, width, s);
  if (pieces <= 1) return launch<TIn, TOut, 1>(table, base, w, out, n, c, width, s);
  if (pieces <= 2) return launch<TIn, TOut, 2>(table, base, w, out, n, c, width, s);
  if (pieces <= 4) return launch<TIn, TOut, 4>(table, base, w, out, n, c, width, s);
  if (pieces <= 8) return launch<TIn, TOut, 8>(table, base, w, out, n, c, width, s);
  if (pieces <= 16) return launch<TIn, TOut, 16>(table, base, w, out, n, c, width, s);
  return launch<TIn, TOut, 32>(table, base, w, out, n, c, width, s);
}

// ---- The field instance: the feature stage from world points ----------
//
// gather_bilerp_field_kernel computes, for each (scene, view, point) row
// r = (s*NS + v)*B + p, what models/pixelnerf.py's feature stage composes
// in PyTorch: the camera transform of the point's world xyz by the view's
// world->camera pose, the uv projection (uv = -xy/z * f + c), the
// normalized and border-clamped source index, the two row bases and
// weights; then the gather and lerp of the row (wide_row, as
// gather_bilerp_wide_kernel), and the MLP's x row: the positional code
// [xyz_rot, sin(xyz_rot_j * f_k + phase_k) ...] in PositionalEncoding's
// column order, then the rotated view direction. Nothing of a row goes
// through memory but the point, the direction, its view's parameters and
// the two outputs. Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn, no contraction) in the order that
// ops/gather.py gather_bilerp_field_plain writes out; the division is
// IEEE's and the sine sinf, as torch.div and torch.sin on the card, so
// the kernel is bit-equal to that mirror. The rotation's sums run in the
// order written there, where the separate path's einsum takes cuBLAS's.
struct FieldArgs {
  const float* xyz;           // (SB, B, 3) world points
  const float* dirs;          // (SB, B, 3) view directions
  const float* w2c;           // (SB*NS, 3, 4) world->camera poses
  const float* focal;         // [fx, fy] rows: a row's at (n / focal_div) * focal_s0
  const float* pp;            // principal points, likewise
  const float* image_shape;   // (2,) [W, H] of the encoded images
  const float* freqs;         // (codes,) the code's frequencies
  const float* phases;        // (codes,) and phases
  int64_t focal_s0, focal_s1, pp_s0, pp_s1;
  int64_t points;             // B
  int64_t rows;               // SB*NS*B
  int views;                  // NS
  int focal_div, pp_div;      // 1: a row a view; NS: a row a scene
  float scale_x, scale_y;     // latent_scaling: size / (size - 1) * 2 a map axis
  int codes;                  // sines a coordinate
  int hl, wl, c;              // the latent maps
  int dx;                     // columns of an x row
};

// Row m of a pose times (x, y, z): (m0 x + m1 y) + m2 z, each step rounded.
__device__ __forceinline__ float dot3_rn(const float* m, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__ldg(m), x), __fmul_rn(__ldg(m + 1), y)), __fmul_rn(__ldg(m + 2), z));
}

__device__ __forceinline__ float pick3(int i, float a, float b, float c) {
  return i == 0 ? a : (i == 1 ? b : c);
}

// ops/grid_sample.py _compute_source_index at border padding and
// align_corners, of the normalized coordinate uv * scale - 1; a NaN
// passes, as torch.minimum and torch.maximum pass it.
__device__ __forceinline__ float source_index(float uv, float scale, int size) {
  const float g = __fsub_rn(__fmul_rn(uv, scale), 1.0f);
  const float hi = (float)(size - 1);
  const float x = __fmul_rn(__fmul_rn(__fadd_rn(g, 1.0f), 0.5f), hi);
  return x != x ? x : fminf(fmaxf(x, 0.0f), hi);
}

// One axis of ops/grid_sample.py bilinear_pair_bases: the pixel of the
// floor, clamped to the map, and the fraction past it.
__device__ __forceinline__ void floor_split(float x, int size, int& i0, float& frac) {
  const float f = floorf(x);
  frac = __fsub_rn(x, f);
  i0 = min(max((int)f, 0), size - 1);
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// A warp takes 32 neighbouring rows at a time. Lane j works out row j's
// camera transform, source index, bases and weights, and leaves its rotated
// point and direction in shared memory; the warp then writes the 32 x rows,
// contiguous in memory, an element a lane, and gathers the 32 latent rows
// one after another as gather_bilerp_wide_kernel gathers one (bases and
// weights handed out by __shfl_sync). On an H100 80GB HBM3 at 700 W
// (scripts/bench_gather_field_torch.py, a dtu.render coarse chunk) this took
// 4.55 ms against 7.37 for a warp a row with the prologue in every lane, and
// 4.81 with the latent loop unrolled by 2.
constexpr int FIELD_ROWS = 32;

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
gather_bilerp_field_kernel(const TIn* __restrict__ table, const FieldArgs a, TOut* __restrict__ out,
                           TOut* __restrict__ x_out) {
  __shared__ float rotated[WARPS_PER_BLOCK][6][FIELD_ROWS];   // xyz_rot, then the rotated direction
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r0 = ((int64_t)blockIdx.x * WARPS_PER_BLOCK + warp) * FIELD_ROWS;
  if (r0 >= a.rows) return;
  const int rows = (int)min((int64_t)FIELD_ROWS, a.rows - r0);
  int32_t b0 = 0, b1 = 0;
  float wx = 0.0f, wy = 0.0f;
  if (lane < rows) {
    const int64_t r = r0 + lane;
    const int64_t n = r / a.points;                                  // s*NS + v
    const int64_t q = (n / a.views) * a.points + (r - n * a.points);  // the point (s, p)
    const float* m = a.w2c + n * 12;
    const float* pt = a.xyz + q * 3;
    const float px = __ldg(pt), py = __ldg(pt + 1), pz = __ldg(pt + 2);
    const float rx = dot3_rn(m, px, py, pz), ry = dot3_rn(m + 4, px, py, pz), rz = dot3_rn(m + 8, px, py, pz);
    const float cx = __fadd_rn(rx, __ldg(m + 3)), cy = __fadd_rn(ry, __ldg(m + 7));
    const float cz = __fadd_rn(rz, __ldg(m + 11));
    const float* f = a.focal + (n / a.focal_div) * a.focal_s0;
    const float* pp = a.pp + (n / a.pp_div) * a.pp_s0;
    const float u = __fadd_rn(__fmul_rn(__fdiv_rn(-cx, cz), __ldg(f)), __ldg(pp));
    const float v = __fadd_rn(__fmul_rn(__fdiv_rn(-cy, cz), __ldg(f + a.focal_s1)), __ldg(pp + a.pp_s1));
    const float ix = source_index(u, __fdiv_rn(a.scale_x, __ldg(a.image_shape)), a.wl);
    const float iy = source_index(v, __fdiv_rn(a.scale_y, __ldg(a.image_shape + 1)), a.hl);
    int x0, y0;
    floor_split(ix, a.wl, x0, wx);
    floor_split(iy, a.hl, y0, wy);
    const int32_t view0 = (int32_t)n * (a.hl * a.wl);
    b0 = view0 + y0 * a.wl + x0;
    b1 = view0 + min(y0 + 1, a.hl - 1) * a.wl + x0;
    const float* d = a.dirs + q * 3;
    const float dx = __ldg(d), dy = __ldg(d + 1), dz = __ldg(d + 2);
    float* mine = &rotated[warp][0][lane];
    mine[0 * FIELD_ROWS] = rx;
    mine[1 * FIELD_ROWS] = ry;
    mine[2 * FIELD_ROWS] = rz;
    mine[3 * FIELD_ROWS] = dot3_rn(m, dx, dy, dz);
    mine[4 * FIELD_ROWS] = dot3_rn(m + 4, dx, dy, dz);
    mine[5 * FIELD_ROWS] = dot3_rn(m + 8, dx, dy, dz);
  }
  __syncwarp();

  // the x rows: element e of the warp's rows * dx, row e / dx, column e % dx
  const int lead = 3;   // the code's input, xyz_rot
  const int sines = 3 * a.codes;
  const int total = rows * a.dx;
  TOut* xr = x_out + r0 * a.dx;
  int j = 0, col = lane;
  while (col >= a.dx) col -= a.dx, ++j;
  for (int e = lane; e < total; e += 32) {
    const int k = col - lead;
    float val;
    if (k < 0) {
      val = rotated[warp][col][j];
    } else if (k < sines) {
      const int fk = k / 3;
      val = sinf(__fadd_rn(__fmul_rn(rotated[warp][k - 3 * fk][j], __ldg(a.freqs + fk)), __ldg(a.phases + fk)));
    } else {
      val = rotated[warp][3 + k - sines][j];
    }
    store1(xr + e, val);
    col += 32;
    while (col >= a.dx) col -= a.dx, ++j;
  }

  // the latent rows
  for (int i = 0; i < rows; ++i) {
    const int32_t c0 = __shfl_sync(FULL, b0, i), c1 = __shfl_sync(FULL, b1, i);
    const float tx = __shfl_sync(FULL, wx, i), ty = __shfl_sync(FULL, wy, i);
    wide_row<TIn, TOut>(table, c0, c1, tx, ty, a.c, a.wl, lane, out + (r0 + i) * a.c);
  }
}

template <typename TIn, typename TOut>
int launch_field(const void* table, const FieldArgs& a, void* out, void* x_out, cudaStream_t stream) {
  if (a.rows == 0) return 0;
  const int64_t rows_a_block = (int64_t)WARPS_PER_BLOCK * FIELD_ROWS;
  const int64_t blocks = (a.rows + rows_a_block - 1) / rows_a_block;
  gather_bilerp_field_kernel<TIn, TOut><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const TIn*>(table), a, static_cast<TOut*>(out), static_cast<TOut*>(x_out));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after
// the launch (0 = success); -1 for a dtype pair it does not take.
extern "C" int gather_bilerp(const void* table, const void* base, const void* w,
                             void* out, int64_t n, int c, int width,
                             int table_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1 && out_dtype == 1)
    return launch_lanes<__nv_bfloat16, __nv_bfloat16>(table, base, w, out, n, c, width, s);
  if (table_dtype == 1 && out_dtype == 0)
    return launch_lanes<__nv_bfloat16, float>(table, base, w, out, n, c, width, s);
  if (table_dtype == 0 && out_dtype == 1)
    return launch_lanes<float, __nv_bfloat16>(table, base, w, out, n, c, width, s);
  if (table_dtype == 0 && out_dtype == 0)
    return launch_lanes<float, float>(table, base, w, out, n, c, width, s);
  return -1;
}

// The field instance (gather_bilerp_field_kernel): dtype codes as above,
// the latent table (SB*NS*hl*wl, c) and both outputs in their dtypes, every
// other pointer float32. Returns as gather_bilerp.
extern "C" int gather_bilerp_field(const void* table, const float* xyz, const float* dirs, const float* w2c,
                                   const float* focal, int64_t focal_s0, int64_t focal_s1, int focal_div,
                                   const float* pp, int64_t pp_s0, int64_t pp_s1, int pp_div,
                                   const float* image_shape, float scale_x, float scale_y,
                                   const float* freqs, const float* phases, int codes,
                                   int64_t points, int views, int64_t rows, int hl, int wl, int c,
                                   void* out, void* x_out, int table_dtype, int out_dtype, void* stream) {
  FieldArgs a;
  a.xyz = xyz; a.dirs = dirs; a.w2c = w2c;
  a.focal = focal; a.focal_s0 = focal_s0; a.focal_s1 = focal_s1; a.focal_div = focal_div;
  a.pp = pp; a.pp_s0 = pp_s0; a.pp_s1 = pp_s1; a.pp_div = pp_div;
  a.image_shape = image_shape; a.scale_x = scale_x; a.scale_y = scale_y;
  a.freqs = freqs; a.phases = phases; a.codes = codes;
  a.points = points; a.views = views; a.rows = rows; a.hl = hl; a.wl = wl; a.c = c;
  a.dx = 3 + 3 * codes + 3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1 && out_dtype == 1) return launch_field<__nv_bfloat16, __nv_bfloat16>(table, a, out, x_out, s);
  if (table_dtype == 1 && out_dtype == 0) return launch_field<__nv_bfloat16, float>(table, a, out, x_out, s);
  if (table_dtype == 0 && out_dtype == 1) return launch_field<float, __nv_bfloat16>(table, a, out, x_out, s);
  if (table_dtype == 0 && out_dtype == 0) return launch_field<float, float>(table, a, out, x_out, s);
  return -1;
}
