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
// grad_out (N, C) it computes, in one pass over the points,
//   grad_table[idx[n,k]] += w[n,k] * grad_out[n]      (float32 atomics)
//   grad_w[n,k] = sum_c grad_out[n,c] * table[idx[n,k],c]
// the second as a warp reduction (__shfl_xor_sync), so the rows read for
// grad_w need no second pass. Either output may be skipped (null pointer).
//
// Bound on this card: bytes. Forward, per point: 4 row reads (from L2: a
// 16384x512 bf16 table is 16 MB, resident in the 50 MB L2), one row write,
// 32 bytes of idx/w; 7 flops per channel. Backward, per point: one grad_out
// row read, 4 table rows (for grad_w), 4x C float32 atomic adds into a
// zeroed float32 buffer (32 MB for the table above, also L2-resident).
// The atomics, not the bytes, limit the backward: they are issued as
// Hopper's 16-byte vector atomics (atomicAdd on float4, sm_90), a quarter
// of the scalar count.
// Design, both kernels: one warp per point; each lane moves 16-byte vectors
// of 8 channels, neighbouring lanes on neighbouring chunks, so every row
// access is coalesced. The forward uses __fadd_rn/__fmul_rn so that no
// multiply-add is contracted: it is bit-equal to the plain PyTorch version.
// The atomics make the backward's summation order vary from run to run.
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

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
gather_rows_bwd_kernel(const TIn* __restrict__ table, const int32_t* __restrict__ idx,
                       const float* __restrict__ w, const TOut* __restrict__ grad_out,
                       float* __restrict__ grad_table, float* __restrict__ grad_w,
                       int64_t n, int c) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (p >= n) return;  // the whole warp leaves together: p is warp-uniform
  const int4 rows4 = __ldg(reinterpret_cast<const int4*>(idx) + p);
  const float4 wt4 = __ldg(reinterpret_cast<const float4*>(w) + p);
  const int32_t rows[4] = {rows4.x, rows4.y, rows4.z, rows4.w};
  const float wt[4] = {wt4.x, wt4.y, wt4.z, wt4.w};
  const TOut* gp = grad_out + p * c;
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ch = lane * 8; ch < c; ch += 32 * 8) {
    float g[8];
    load8(gp + ch, g);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (grad_table != nullptr) {
        float4* dst = reinterpret_cast<float4*>(grad_table + (int64_t)rows[k] * c + ch);
        atomicAdd(dst, make_float4(wt[k] * g[0], wt[k] * g[1], wt[k] * g[2], wt[k] * g[3]));
        atomicAdd(dst + 1, make_float4(wt[k] * g[4], wt[k] * g[5], wt[k] * g[6], wt[k] * g[7]));
      }
      if (grad_w != nullptr) {
        float r[8];
        load8(table + (int64_t)rows[k] * c + ch, r);
#pragma unroll
        for (int i = 0; i < 8; ++i) dot[k] = fmaf(g[i], r[i], dot[k]);
      }
    }
  }
  if (grad_w != nullptr) {
#pragma unroll
    for (int k = 0; k < 4; ++k) dot[k] = warp_sum(dot[k]);
    if (lane == 0)
      reinterpret_cast<float4*>(grad_w)[p] = make_float4(dot[0], dot[1], dot[2], dot[3]);
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

template <typename TIn, typename TOut>
int launch_bwd(const void* table, const void* idx, const void* w, const void* grad_out,
               void* grad_table, void* grad_w, int64_t n, int c, cudaStream_t stream) {
  if (n == 0) return 0;
  gather_rows_bwd_kernel<TIn, TOut><<<(unsigned)blocks_for(n), WARPS_PER_BLOCK * 32, 0, stream>>>(
      static_cast<const TIn*>(table), static_cast<const int32_t*>(idx),
      static_cast<const float*>(w), static_cast<const TOut*>(grad_out),
      static_cast<float*>(grad_table), static_cast<float*>(grad_w), n, c);
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

// grad_table: a zeroed (R, C) float32 buffer, or null to skip it;
// grad_w: an (N, 4) float32 buffer, or null to skip it.
extern "C" int gather_rows_lerp_bwd(const void* table, const void* idx, const void* w,
                                    const void* grad_out, void* grad_table, void* grad_w,
                                    int64_t n, int c, int table_dtype, int out_dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1 && out_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(table, idx, w, grad_out, grad_table, grad_w, n, c, s);
  if (table_dtype == 1 && out_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(table, idx, w, grad_out, grad_table, grad_w, n, c, s);
  if (table_dtype == 0 && out_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(table, idx, w, grad_out, grad_table, grad_w, n, c, s);
  if (table_dtype == 0 && out_dtype == 0)
    return launch_bwd<float, float>(table, idx, w, grad_out, grad_table, grad_w, n, c, s);
  return -1;
}
