// Shared pieces of the gather kernels: 8-channel vector loads and stores
// and the bilinear lerp of kernel A.
//
// The lerp is the counterpart of packed_bilerp
// (pixelnerf_tpu/ops/gather_pallas.py): top = l0 + wx*(r0-l0), bot likewise,
// out = top + wy*(bot-top), in float32. This ONE definition is used by the
// gather kernel (gather.cu) and by the fused gather+MLP kernel
// (fused_field.cu), so the two cannot drift apart: the fused kernel must
// equal the MLP kernel fed by the gather kernel bit for bit. The lerp uses
// __fadd_rn/__fmul_rn so that no multiply-add is contracted, which also
// makes it bit-equal to the plain PyTorch version.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// works for global and shared destinations alike
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

__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  return __fadd_rn(a, __fmul_rn(t, __fsub_rn(b, a)));
}

// Rows to the right neighbour of the pixel at row `base` of a table whose
// views are `width` pixels wide: min(x0+1, W-1) - x0. The table may fold
// many views into its rows; H*W is a multiple of W, so base % W is x0.
__device__ __forceinline__ int right_step(int32_t base, int width) {
  return (base % width) < width - 1 ? 1 : 0;
}

// The four corner rows of one point: bases b0 (row y0) and b1 (row y1) at
// x0, and their right neighbours.
template <typename TIn>
struct Corners {
  const TIn* l0;
  const TIn* r0;
  const TIn* l1;
  const TIn* r1;
};

template <typename TIn>
__device__ __forceinline__ Corners<TIn> corners_of(const TIn* table, int32_t b0, int32_t b1,
                                                   int c, int width) {
  const int dx = right_step(b0, width);
  Corners<TIn> k;
  k.l0 = table + (int64_t)b0 * c;
  k.r0 = table + (int64_t)(b0 + dx) * c;
  k.l1 = table + (int64_t)b1 * c;
  k.r1 = table + (int64_t)(b1 + dx) * c;
  return k;
}

// Bilinear lerp of the 8 channels starting at channel `ch`.
template <typename TIn>
__device__ __forceinline__ void bilerp8(const Corners<TIn>& k, int ch, float wx, float wy,
                                        float o[8]) {
  float l0[8], r0[8], l1[8], r1[8];
  load8(k.l0 + ch, l0);
  load8(k.r0 + ch, r0);
  load8(k.l1 + ch, l1);
  load8(k.r1 + ch, r1);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float top = lerp_rn(l0[i], r0[i], wx);
    const float bot = lerp_rn(l1[i], r1[i], wx);
    o[i] = lerp_rn(top, bot, wy);
  }
}

}  // namespace
