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
// Bound on this card: bytes. Per point it reads 4 rows of C values and
// writes one row; the arithmetic is 6 flops per channel. The table of one
// view (64x64x512 bf16 = 4 MB) stays resident in the 50 MB L2, so device
// memory sees mostly the output and the indices. Design: one warp per
// point; each lane moves 16-byte vectors, and neighbouring lanes touch
// neighbouring 16-byte chunks of a row, so every row load and output store
// is one coalesced 512-byte (bf16) transaction per warp instruction. The
// lerp uses __fadd_rn/__fmul_rn so that no multiply-add is contracted: the
// result is bit-equal to the plain PyTorch version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;

__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  return __fadd_rn(a, __fmul_rn(t, __fsub_rn(b, a)));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// One warp per point; each lane handles chunks of 8 channels, strided by
// 32 chunks, so C must be a multiple of 8.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
gather_bilerp_kernel(const TIn* __restrict__ table, const int32_t* __restrict__ base,
                     const float* __restrict__ w, TOut* __restrict__ out,
                     int64_t n, int c, int width) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (p >= n) return;
  const int32_t b0 = __ldg(base + 2 * p);
  const int32_t b1 = __ldg(base + 2 * p + 1);
  const float wx = __ldg(w + 2 * p);
  const float wy = __ldg(w + 2 * p + 1);
  const int32_t dx = (b0 % width) < width - 1 ? 1 : 0;  // right = min(x0+1, W-1)
  const TIn* l0p = table + (int64_t)b0 * c;
  const TIn* r0p = table + (int64_t)(b0 + dx) * c;
  const TIn* l1p = table + (int64_t)b1 * c;
  const TIn* r1p = table + (int64_t)(b1 + dx) * c;
  TOut* op = out + p * c;
  for (int ch = lane * 8; ch < c; ch += 32 * 8) {
    float l0[8], r0[8], l1[8], r1[8], o[8];
    load8(l0p + ch, l0);
    load8(r0p + ch, r0);
    load8(l1p + ch, l1);
    load8(r1p + ch, r1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float top = lerp_rn(l0[i], r0[i], wx);
      const float bot = lerp_rn(l1[i], r1[i], wx);
      o[i] = lerp_rn(top, bot, wy);
    }
    store8(op + ch, o);
  }
}

template <typename TIn, typename TOut>
int launch(const void* table, const void* base, const void* w, void* out, int64_t n,
           int c, int width, cudaStream_t stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  gather_bilerp_kernel<TIn, TOut><<<(unsigned)blocks, WARPS_PER_BLOCK * 32, 0, stream>>>(
      static_cast<const TIn*>(table), static_cast<const int32_t*>(base),
      static_cast<const float*>(w), static_cast<TOut*>(out), n, c, width);
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
    return launch<__nv_bfloat16, __nv_bfloat16>(table, base, w, out, n, c, width, s);
  if (table_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(table, base, w, out, n, c, width, s);
  if (table_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(table, base, w, out, n, c, width, s);
  if (table_dtype == 0 && out_dtype == 0)
    return launch<float, float>(table, base, w, out, n, c, width, s);
  return -1;
}
