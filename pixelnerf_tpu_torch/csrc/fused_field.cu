// Fused pixel-aligned gather + conditioned ResnetFC MLP for Hopper (kernel D).
//
// Replaces: pixelnerf_tpu/ops/fused_field.py, fused_gather_resnetfc_infer /
// _fused_kernel. Per point it combines two rows of the feature map
// bilinearly in float32 (the gather kernel's lerp, gather_common.cuh),
// rounds the latent to bf16, and runs the whole conditioned MLP
// (mlp_body.cuh) on it, in one launch: the gathered latents never reach
// global memory. It equals the MLP kernel (fused_mlp.cu) fed by the gather
// kernel (gather.cu) bit for bit, because all three share one lerp and one
// MLP chain.
//
// The TPU kernel's LR-packed int32 table, rolled index pairs and gather
// spans interleaved between the dense ops answer Mosaic's limits and are
// not carried over. Here it is the MLP kernel's block with the z tile in
// shared memory filled by the block's own gather from the bf16 map: a warp
// per row of the tile, 16-byte vectors per lane, the right-hand neighbour
// clamped to the map's width as in the gather kernel. The map of one view
// (64x64x512 bf16 = 4 MB) stays in L2.
//
// Bound on this card: operations (the MLP's ~7 MFLOP per row); the bytes
// fall by the z rows the MLP kernel reads and the gather kernel writes. The
// block's 212 KB of shared memory leave no room for a second z tile, so the
// gather of a tile runs before its MLP, not under the MLP of the tile
// before (the TPU kernel's overlap), and at one block per SM no other block
// hides it either. A producer warp, cp.async/TMA prefetch or a smaller T
// are left for the redesign of this kernel and the MLP kernel.
#include "gather_common.cuh"
#include "mlp_body.cuh"

namespace {

// PROBE: stop after the gather prologue and write the first 4 latent
// channels of each row, to time the prologue alone.
template <bool PROBE>
__global__ void __launch_bounds__(WARPS * 32, 1)
fused_field_kernel(Params p, const bf16* __restrict__ table, const int32_t* __restrict__ base,
                   const float* __restrict__ wg, int width) {
  extern __shared__ uint4 smem_raw[];
  const Tiles t = carve_tiles(p, smem_raw, true);
  const int64_t row0 = (int64_t)blockIdx.x * T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  fill_x_tile(p, t, row0);
  // z tile: the block's own bilinear gather, rounded to bf16; zero past
  // the last row
  for (int r = warp; r < T; r += WARPS) {
    const int64_t row = row0 + r;
    bf16* zp = t.sz + r * t.ldz;
    if (row < p.n) {
      const int32_t b0 = __ldg(base + 2 * row);
      const int32_t b1 = __ldg(base + 2 * row + 1);
      const float wx = __ldg(wg + 2 * row);
      const float wy = __ldg(wg + 2 * row + 1);
      const Corners<bf16> k = corners_of(table, b0, b1, p.d_z, width);
      for (int ch = lane * 8; ch < p.d_z; ch += 32 * 8) {
        float o[8];
        bilerp8(k, ch, wx, wy, o);
        store8(zp + ch, o);
      }
    } else {
      for (int ch = lane * 8; ch < p.d_z; ch += 32 * 8)
        *reinterpret_cast<uint4*>(zp + ch) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();
  if constexpr (PROBE) {
    for (int i = threadIdx.x; i < T * 4; i += WARPS * 32) {
      const int r = i / 4, c = i % 4;
      if (row0 + r < p.n) p.out[(row0 + r) * 4 + c] = __bfloat162float(t.sz[r * t.ldz + c]);
    }
  } else {
    mlp_chain<false>(p, t, row0);
  }
}

}  // namespace

extern "C" size_t fused_field_smem_bytes(int d_in_pad, int d_z, int d_hidden) {
  return mlp_smem_bytes(d_in_pad, d_z, d_hidden, true);
}

// table (rows, d_z) bf16 feature rows of views `width` pixels wide; base
// (n, 2) int32; wg (n, 2) float32; the rest as fused_resnetfc_infer. With
// probe != 0 only the gather prologue runs. Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int fused_gather_resnetfc_infer(const void* table, const void* base, const void* wg,
                                           const void* x, const void* win, const void* bin,
                                           const void* wz, const void* bz, const void* w0,
                                           const void* b0, const void* w1, const void* b1,
                                           const void* wout, const void* bout, void* out,
                                           int64_t n, int d_in, int d_in_pad, int d_z,
                                           int d_hidden, int n_blocks, int n_lin_z, int width,
                                           int probe, void* stream) {
  const Params p = make_params(x, nullptr, win, bin, wz, bz, w0, b0, w1, b1, wout, bout, out,
                               n, d_in, d_in_pad, d_z, d_hidden, n_blocks, n_lin_z);
  const size_t smem = mlp_smem_bytes(d_in_pad, d_z, d_hidden, true);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* tb = static_cast<const bf16*>(table);
  const int32_t* bs = static_cast<const int32_t*>(base);
  const float* w = static_cast<const float*>(wg);
  if (probe) return launch_tiles(fused_field_kernel<true>, smem, n, s, p, tb, bs, w, width);
  return launch_tiles(fused_field_kernel<false>, smem, n, s, p, tb, bs, w, width);
}
