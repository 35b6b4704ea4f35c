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
// lerp (gather_common.cuh, shared with the fused gather+MLP kernel) uses
// __fadd_rn/__fmul_rn so that no multiply-add is contracted: the result is
// bit-equal to the plain PyTorch version.
#include "gather_common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;

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
  const Corners<TIn> k = corners_of(table, b0, b1, c, width);
  TOut* op = out + p * c;
  for (int ch = lane * 8; ch < c; ch += 32 * 8) {
    float o[8];
    bilerp8(k, ch, wx, wy, o);
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
