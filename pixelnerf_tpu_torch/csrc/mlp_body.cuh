// The conditioned ResnetFC MLP on one tile of T rows, shared by the fused
// MLP kernel (fused_mlp.cu) and the fused gather+MLP kernel (fused_field.cu):
//   h = x.Win + bin
//   for block i:  if i < n_lin_z: h += tz[:, i*dh:(i+1)*dh]
//                 net = relu(h).W0_i + b0_i;  h += relu(net).W1_i + b1_i
//   out = relu(h).Wout + bout          (first 4 columns, float32)
// where tz = z.Wz + bz is computed one block's column slice at a time from
// the z tile in shared memory, or, with Z_IS_TZ, read from global memory
// (the injections were folded into the feature map at encode time).
//
// Rounding contract, as in the TPU kernel (pixelnerf_tpu/ops/fused_mlp.py,
// _mlp_kernel) and nn.Dense(dtype=bfloat16): each product accumulates in
// float32 on the tensor cores (mma.sync m16n8k16 bf16), is rounded to bf16,
// then the bf16 bias is added and the sum rounded to bf16. The residual adds
// and the latent injections are bf16 adds. This ONE definition serves both
// kernels, so the fused gather+MLP kernel equals the MLP kernel fed by the
// gather kernel bit for bit.
//
// Shared memory: the x and z tiles and h and net, T = 64 rows, rows padded
// by 8 bf16 so the fragment loads are free of bank conflicts; with Z_IS_TZ
// there is no z tile. The weights are streamed from global memory through
// L2 straight into the tensor-core fragments. Eight warps split each layer's
// output columns in 32-wide chunks; every warp covers all 64 rows, so a
// weight fragment is read once per block.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int T = 64;          // rows per block
constexpr int WARPS = 8;
constexpr int PAD = 8;         // bf16 padding per shared-memory row

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* x;     // (n, d_in)
  const bf16* z;     // (n, d_z): the latents, or with Z_IS_TZ the injections
  const bf16* win;   // (dh, d_in_pad)       torch (out, in) layout
  const bf16* bin;   // (dh)
  const bf16* wz;    // (n_lin_z*dh, d_z); unused with Z_IS_TZ
  const bf16* bz;    // (n_lin_z*dh); unused with Z_IS_TZ
  const bf16* w0;    // (n_blocks, dh, dh)
  const bf16* b0;    // (n_blocks, dh)
  const bf16* w1;    // (n_blocks, dh, dh)
  const bf16* b1;    // (n_blocks, dh)
  const bf16* wout;  // (>= 8, dh)
  const bf16* bout;  // (>= 8)
  float* out;        // (n, 4)
  int64_t n;
  int d_in, d_in_pad, d_z, dh, n_blocks, n_lin_z;
};

// The block's tiles in dynamic shared memory; sz is null without a z tile.
struct Tiles {
  bf16* sx;
  bf16* sz;
  bf16* sh;
  bf16* snet;
  int ldx, ldz, ldh;
};

__host__ __device__ inline size_t mlp_smem_bytes(int d_in_pad, int d_z, int d_hidden,
                                                 bool z_tile) {
  return sizeof(bf16) * (size_t)T *
         ((d_in_pad + PAD) + (z_tile ? (d_z + PAD) : 0) + 2 * (size_t)(d_hidden + PAD));
}

__device__ __forceinline__ Tiles carve_tiles(const Params& p, void* smem, bool z_tile) {
  Tiles t;
  t.ldx = p.d_in_pad + PAD;
  t.ldz = p.d_z + PAD;
  t.ldh = p.dh + PAD;
  t.sx = reinterpret_cast<bf16*>(smem);
  bf16* next = t.sx + T * t.ldx;
  t.sz = nullptr;
  if (z_tile) {
    t.sz = next;
    next += T * t.ldz;
  }
  t.sh = next;
  t.snet = t.sh + T * t.ldh;
  return t;
}

__device__ __forceinline__ uint32_t ld_smem32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_global32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t relu2(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hmax2(h, __float2bfloat162_rn(0.0f));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16(bf16(acc) + bias): the dense layer's rounding contract.
__device__ __forceinline__ float dense_round(float acc, bf16 bias) {
  const float y = __bfloat162float(__float2bfloat16_rn(acc));
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(y, __bfloat162float(bias))));
}

// bf16 add of two bf16 values held as floats.
__device__ __forceinline__ float bf16_add(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, b)));
}

// One warp: C[0:64, n0:n0+8*NT] = A[0:64, 0:K] . Wt[n0:n0+8*NT, 0:K]^T, with A
// in shared memory (row stride lda, relu applied on load if RELU) and Wt in
// global memory (row stride ldw). Calls epi(row, col, v_col, v_col+1) on
// each pair of adjacent output columns.
template <bool RELU, int NT, typename Epi>
__device__ __forceinline__ void warp_gemm(const bf16* A, int lda, int K, const bf16* Wt,
                                          int ldw, int n0, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[4][NT][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* bp = Wt + (int64_t)(n0 + j * 8 + g) * ldw + k0 + 2 * t;
      b[j][0] = ld_global32(bp);
      b[j][1] = ld_global32(bp + 8);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const bf16* ap = A + (m * 16 + g) * lda + k0 + 2 * t;
      uint32_t a[4];
      a[0] = ld_smem32(ap);
      a[1] = ld_smem32(ap + 8 * lda);
      a[2] = ld_smem32(ap + 8);
      a[3] = ld_smem32(ap + 8 * lda + 8);
      if (RELU) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = relu2(a[e]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[m][j], a, b[j]);
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = m * 16 + g;
      const int col = n0 + j * 8 + 2 * t;
      epi(row, col, acc[m][j][0], acc[m][j][1]);
      epi(row + 8, col, acc[m][j][2], acc[m][j][3]);
    }
}

__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x tile, zero-padded to d_in_pad columns and past the last row
__device__ __forceinline__ void fill_x_tile(const Params& p, const Tiles& t, int64_t row0) {
  for (int i = threadIdx.x; i < T * p.d_in_pad; i += WARPS * 32) {
    const int r = i / p.d_in_pad, c = i % p.d_in_pad;
    bf16 v = __float2bfloat16_rn(0.0f);
    if (row0 + r < p.n && c < p.d_in) v = p.x[(row0 + r) * p.d_in + c];
    t.sx[r * t.ldx + c] = v;
  }
}

// z tile from global memory, 16-byte vectors, zero past the last row
__device__ __forceinline__ void fill_z_tile(const Params& p, const Tiles& t, int64_t row0) {
  const int zv = p.d_z / 8;
  for (int i = threadIdx.x; i < T * zv; i += WARPS * 32) {
    const int r = i / zv, c8 = i % zv;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < p.n)
      v = __ldg(reinterpret_cast<const uint4*>(p.z + (row0 + r) * p.d_z) + c8);
    *reinterpret_cast<uint4*>(t.sz + r * t.ldz + c8 * 8) = v;
  }
}

// The MLP on the block's tile, after the x tile (and, without Z_IS_TZ, the
// z tile) is filled and the block has synchronised.
template <bool Z_IS_TZ>
__device__ __forceinline__ void mlp_chain(const Params& p, const Tiles& t, int64_t row0) {
  bf16* sh = t.sh;
  bf16* snet = t.snet;
  const int ldh = t.ldh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int dh = p.dh;
  const int n_chunks = dh / 32;

  // h = x.Win + bin
  for (int ch = warp; ch < n_chunks; ch += WARPS) {
    warp_gemm<false, 4>(t.sx, t.ldx, p.d_in_pad, p.win, p.d_in_pad, ch * 32,
                        [&](int r, int c, float v0, float v1) {
                          st_pair(sh + r * ldh + c, dense_round(v0, p.bin[c]),
                                  dense_round(v1, p.bin[c + 1]));
                        });
  }
  __syncthreads();

  for (int blk = 0; blk < p.n_blocks; ++blk) {
    if (blk < p.n_lin_z) {
      if constexpr (Z_IS_TZ) {
        // h += tz[:, blk*dh:(blk+1)*dh], each slice read once from global
        // memory, 16-byte vectors; rows past the last are left alone. Each
        // thread issues TZ_LOADS loads before it uses the first: with one
        // load in flight per thread the slice arrives at the latency of
        // device memory, not at its rate.
        constexpr int TZ_LOADS = 8;
        const int hv = dh / 8;
        for (int i0 = tid; i0 < T * hv; i0 += WARPS * 32 * TZ_LOADS) {
          uint4 raw[TZ_LOADS];
#pragma unroll
          for (int u = 0; u < TZ_LOADS; ++u) {
            const int i = i0 + u * WARPS * 32;
            const int r = i / hv, c8 = i % hv;
            raw[u] = make_uint4(0u, 0u, 0u, 0u);
            if (i < T * hv && row0 + r < p.n)
              raw[u] = __ldg(
                  reinterpret_cast<const uint4*>(p.z + (row0 + r) * p.d_z + (int64_t)blk * dh) + c8);
          }
#pragma unroll
          for (int u = 0; u < TZ_LOADS; ++u) {
            const int i = i0 + u * WARPS * 32;
            const int r = i / hv, c8 = i % hv;
            if (i >= T * hv || row0 + r >= p.n) continue;
            const __nv_bfloat162* tz = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
            bf16* hp = sh + r * ldh + c8 * 8;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 h = ld_pair(hp + 2 * e);
              const float2 v = __bfloat1622float2(tz[e]);
              st_pair(hp + 2 * e, bf16_add(h.x, v.x), bf16_add(h.y, v.y));
            }
          }
        }
      } else {
        // h += z.Wz[:, blk*dh:(blk+1)*dh] + bz[blk*dh:(blk+1)*dh]
        const bf16* wz = p.wz + (int64_t)blk * dh * p.d_z;
        const bf16* bz = p.bz + blk * dh;
        for (int ch = warp; ch < n_chunks; ch += WARPS) {
          warp_gemm<false, 4>(t.sz, t.ldz, p.d_z, wz, p.d_z, ch * 32,
                              [&](int r, int c, float v0, float v1) {
                                bf16* hp = sh + r * ldh + c;
                                const float2 h = ld_pair(hp);
                                st_pair(hp, bf16_add(h.x, dense_round(v0, bz[c])),
                                        bf16_add(h.y, dense_round(v1, bz[c + 1])));
                              });
        }
      }
      __syncthreads();
    }
    // net = relu(h).W0 + b0
    const bf16* w0 = p.w0 + (int64_t)blk * dh * dh;
    const bf16* b0 = p.b0 + blk * dh;
    for (int ch = warp; ch < n_chunks; ch += WARPS) {
      warp_gemm<true, 4>(sh, ldh, dh, w0, dh, ch * 32,
                         [&](int r, int c, float v0, float v1) {
                           st_pair(snet + r * ldh + c, dense_round(v0, b0[c]),
                                   dense_round(v1, b0[c + 1]));
                         });
    }
    __syncthreads();
    // h += relu(net).W1 + b1
    const bf16* w1 = p.w1 + (int64_t)blk * dh * dh;
    const bf16* b1 = p.b1 + blk * dh;
    for (int ch = warp; ch < n_chunks; ch += WARPS) {
      warp_gemm<true, 4>(snet, ldh, dh, w1, dh, ch * 32,
                         [&](int r, int c, float v0, float v1) {
                           bf16* hp = sh + r * ldh + c;
                           const float2 h = ld_pair(hp);
                           st_pair(hp, bf16_add(h.x, dense_round(v0, b1[c])),
                                   bf16_add(h.y, dense_round(v1, b1[c + 1])));
                         });
    }
    __syncthreads();
  }

  // out = relu(h).Wout + bout, columns 0..3 of one 8-wide tile
  if (warp == 0) {
    warp_gemm<true, 1>(sh, ldh, dh, p.wout, dh, 0,
                       [&](int r, int c, float v0, float v1) {
                         const int64_t row = row0 + r;
                         if (row < p.n && c < 4) {
                           p.out[row * 4 + c] = dense_round(v0, p.bout[c]);
                           p.out[row * 4 + c + 1] = dense_round(v1, p.bout[c + 1]);
                         }
                       });
  }
}

// The weight and shape arguments every entry point takes, into a Params.
inline Params make_params(const void* x, const void* z, const void* win, const void* bin,
                          const void* wz, const void* bz, const void* w0, const void* b0,
                          const void* w1, const void* b1, const void* wout, const void* bout,
                          void* out, int64_t n, int d_in, int d_in_pad, int d_z, int d_hidden,
                          int n_blocks, int n_lin_z) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.z = static_cast<const bf16*>(z);
  p.win = static_cast<const bf16*>(win);
  p.bin = static_cast<const bf16*>(bin);
  p.wz = static_cast<const bf16*>(wz);
  p.bz = static_cast<const bf16*>(bz);
  p.w0 = static_cast<const bf16*>(w0);
  p.b0 = static_cast<const bf16*>(b0);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.wout = static_cast<const bf16*>(wout);
  p.bout = static_cast<const bf16*>(bout);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.d_in = d_in;
  p.d_in_pad = d_in_pad;
  p.d_z = d_z;
  p.dh = d_hidden;
  p.n_blocks = n_blocks;
  p.n_lin_z = n_lin_z;
  return p;
}

// Launch `kernel` with one block per T rows and `smem` bytes of dynamic
// shared memory; returns cudaGetLastError() after the launch (0 = success).
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, size_t smem, int64_t n, cudaStream_t stream, Args... args) {
  if (n == 0) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (n + T - 1) / T;
  kernel<<<(unsigned)blocks, WARPS * 32, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
