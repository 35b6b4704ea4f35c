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
// 0 warp_direct        a warp per point, each lane 16-byte loads straight
//                      from the table (k_loop_ds; the layout of
//                      gather_rows.cu)
// 1 thread_global_idx  a block per tile of points, a thread per group of 8
//                      channels looping over the tile's points, idx and w
//                      read from global memory by every thread (the "VMEM
//                      index" axis: k_take, k_adv_index)
// 2 thread_smem_idx    the same with the tile's idx and w staged in shared
//                      memory first (the "SMEM index" axis)
// 3 block_stage        a block per tile that fetches each tap's row whole
//                      into shared memory with cp.async (16-byte pieces of
//                      rows that start on 128-byte lines when C*sizeof is a
//                      multiple of 128), four points at a time, and reduces
//                      from there: "aligned block load, then select" (the
//                      block-mask kernel)
//
// Bound on this card: bytes (the float32 output, 4*C bytes per point; the
// table stays in L2).
#include "gather_common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int STAGE_POINTS = 4;     // points per stage of block_stage
constexpr int STAGE_THREADS = 256;

__device__ __forceinline__ void weighted_sum8(const float r0[8], const float r1[8],
                                              const float r2[8], const float r3[8],
                                              const float4 wt, float o[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float acc = __fmul_rn(wt.x, r0[i]);
    acc = __fadd_rn(acc, __fmul_rn(wt.y, r1[i]));
    acc = __fadd_rn(acc, __fmul_rn(wt.z, r2[i]));
    o[i] = __fadd_rn(acc, __fmul_rn(wt.w, r3[i]));
  }
}

// the 8 channels at `ch` of point (rows, wt), rows read from `table`
template <typename TIn>
__device__ __forceinline__ void point_chunk(const TIn* table, const int4 rows, const float4 wt,
                                            int c, int ch, float* out_row) {
  float r0[8], r1[8], r2[8], r3[8], o[8];
  load8(table + (int64_t)rows.x * c + ch, r0);
  load8(table + (int64_t)rows.y * c + ch, r1);
  load8(table + (int64_t)rows.z * c + ch, r2);
  load8(table + (int64_t)rows.w * c + ch, r3);
  weighted_sum8(r0, r1, r2, r3, wt, o);
  store8(out_row + ch, o);
}

template <typename TIn>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
warp_direct_kernel(const TIn* __restrict__ table, const int32_t* __restrict__ idx,
                   const float* __restrict__ w, float* __restrict__ out, int64_t n, int c) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (p >= n) return;
  const int4 rows = __ldg(reinterpret_cast<const int4*>(idx) + p);
  const float4 wt = __ldg(reinterpret_cast<const float4*>(w) + p);
  for (int ch = lane * 8; ch < c; ch += 32 * 8) point_chunk(table, rows, wt, c, ch, out + p * c);
}

// blockDim.x = c / 8 threads, one group of 8 channels each
template <typename TIn, bool SMEM_IDX>
__global__ void thread_per_group_kernel(const TIn* __restrict__ table,
                                        const int32_t* __restrict__ idx,
                                        const float* __restrict__ w, float* __restrict__ out,
                                        int64_t n, int c, int tile) {
  extern __shared__ uint4 smem_raw[];
  int4* s_idx = reinterpret_cast<int4*>(smem_raw);
  float4* s_w = reinterpret_cast<float4*>(s_idx + tile);
  const int64_t p0 = (int64_t)blockIdx.x * tile;
  const int count = (int)min((int64_t)tile, n - p0);
  if (SMEM_IDX) {
    for (int j = threadIdx.x; j < count; j += blockDim.x) {
      s_idx[j] = __ldg(reinterpret_cast<const int4*>(idx) + p0 + j);
      s_w[j] = __ldg(reinterpret_cast<const float4*>(w) + p0 + j);
    }
    __syncthreads();
  }
  const int ch = threadIdx.x * 8;
  for (int j = 0; j < count; ++j) {
    const int4 rows = SMEM_IDX ? s_idx[j] : __ldg(reinterpret_cast<const int4*>(idx) + p0 + j);
    const float4 wt = SMEM_IDX ? s_w[j] : __ldg(reinterpret_cast<const float4*>(w) + p0 + j);
    point_chunk(table, rows, wt, c, ch, out + (p0 + j) * c);
  }
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* global_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(global_src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void load8_smem(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8_smem(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// shared memory: STAGE_POINTS*4 rows of c values, then the tile's idx and w
template <typename TIn>
__global__ void __launch_bounds__(STAGE_THREADS)
block_stage_kernel(const TIn* __restrict__ table, const int32_t* __restrict__ idx,
                   const float* __restrict__ w, float* __restrict__ out, int64_t n, int c,
                   int tile) {
  extern __shared__ uint4 smem_raw[];
  TIn* s_rows = reinterpret_cast<TIn*>(smem_raw);
  int4* s_idx = reinterpret_cast<int4*>(s_rows + STAGE_POINTS * 4 * c);
  float4* s_w = reinterpret_cast<float4*>(s_idx + tile);
  const int64_t p0 = (int64_t)blockIdx.x * tile;
  const int count = (int)min((int64_t)tile, n - p0);
  for (int j = threadIdx.x; j < count; j += STAGE_THREADS) {
    s_idx[j] = __ldg(reinterpret_cast<const int4*>(idx) + p0 + j);
    s_w[j] = __ldg(reinterpret_cast<const float4*>(w) + p0 + j);
  }
  __syncthreads();
  const int vec = 16 / (int)sizeof(TIn);     // values per 16-byte piece
  const int pieces = c / vec;                // pieces per row
  const int groups = c / 8;                  // 8-channel groups per row
  for (int j0 = 0; j0 < count; j0 += STAGE_POINTS) {
    const int pts = min(STAGE_POINTS, count - j0);
    // fetch the 4 rows of each of the stage's points, whole
    for (int i = threadIdx.x; i < pts * 4 * pieces; i += STAGE_THREADS) {
      const int slot = i / pieces, piece = i % pieces;
      const int32_t* taps = reinterpret_cast<const int32_t*>(&s_idx[j0 + slot / 4]);
      const int32_t row = taps[slot % 4];
      cp_async16(s_rows + slot * c + piece * vec, table + (int64_t)row * c + piece * vec);
    }
    cp_async_wait_all();
    __syncthreads();
    // reduce from the staged rows
    for (int i = threadIdx.x; i < pts * groups; i += STAGE_THREADS) {
      const int pt = i / groups, ch = (i % groups) * 8;
      const TIn* rows = s_rows + pt * 4 * c + ch;
      float r0[8], r1[8], r2[8], r3[8], o[8];
      load8_smem(rows, r0);
      load8_smem(rows + c, r1);
      load8_smem(rows + 2 * c, r2);
      load8_smem(rows + 3 * c, r3);
      weighted_sum8(r0, r1, r2, r3, s_w[j0 + pt], o);
      store8(out + (p0 + j0 + pt) * c + ch, o);
    }
    __syncthreads();
  }
}

template <typename TIn>
int launch(const void* table_, const void* idx_, const void* w_, void* out_, int64_t n, int c,
           int formulation, int tile, cudaStream_t stream) {
  if (n == 0) return 0;
  const TIn* table = static_cast<const TIn*>(table_);
  const int32_t* idx = static_cast<const int32_t*>(idx_);
  const float* w = static_cast<const float*>(w_);
  float* out = static_cast<float*>(out_);
  const int64_t tiles = (n + tile - 1) / tile;
  const size_t idx_bytes = (size_t)tile * (sizeof(int4) + sizeof(float4));
  if (formulation == 0) {
    const int64_t blocks = (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    warp_direct_kernel<TIn><<<(unsigned)blocks, WARPS_PER_BLOCK * 32, 0, stream>>>(
        table, idx, w, out, n, c);
  } else if (formulation == 1) {
    thread_per_group_kernel<TIn, false><<<(unsigned)tiles, c / 8, 0, stream>>>(
        table, idx, w, out, n, c, tile);
  } else if (formulation == 2) {
    thread_per_group_kernel<TIn, true><<<(unsigned)tiles, c / 8, idx_bytes, stream>>>(
        table, idx, w, out, n, c, tile);
  } else if (formulation == 3) {
    const size_t smem = (size_t)STAGE_POINTS * 4 * c * sizeof(TIn) + idx_bytes;
    cudaError_t err = cudaFuncSetAttribute(
        block_stage_kernel<TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    block_stage_kernel<TIn><<<(unsigned)tiles, STAGE_THREADS, smem, stream>>>(
        table, idx, w, out, n, c, tile);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// table dtype codes: 0 = float32, 1 = bfloat16; formulation 0..3 as listed
// at the top. Returns cudaGetLastError() after the launch (0 = success);
// -1 for a dtype or formulation it does not take.
extern "C" int gather_study(const void* table, const void* idx, const void* w, void* out,
                            int64_t n, int c, int table_dtype, int formulation, int tile,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1)
    return launch<__nv_bfloat16>(table, idx, w, out, n, c, formulation, tile, s);
  if (table_dtype == 0) return launch<float>(table, idx, w, out, n, c, formulation, tile, s);
  return -1;
}
