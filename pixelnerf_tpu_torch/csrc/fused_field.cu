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
// not carried over. Here it is the MLP kernel's block with the z tile
// filled by the block's own gather from the bf16 map: a filler warp per row
// of the tile, 16-byte vectors per lane, the right-hand neighbour clamped
// to the map's width as in the gather kernel. The map of one view
// (64x64x512 bf16 = 4 MB) stays in L2.
//
// Bound on this card: as the MLP kernel (mlp_body.cuh); the bytes fall by
// the z rows the MLP kernel reads and the gather kernel writes. The gather
// runs in the producer warpgroup, once per tile, into the z buffer, which
// is free from the tile's last injection to the next tile's first: it lies
// under the later blocks of the tile before, not before its own MLP.
#include "gather_common.cuh"
#include "mlp_body.cuh"

namespace {

// The z tile: the bilinear gather of the tile's rows, rounded to bf16; zero
// from row `end` on.
struct GatherFill {
  const bf16* table;
  const int32_t* base;
  const float* wg;
  int d_z, width;
  __device__ __forceinline__ void operator()(int, int64_t row0, int64_t end, uint8_t* dst, int ft) const {
    const int lane = ft & 31;
    for (int r = ft >> 5; r < T; r += FILLERS / 32) {
      const int64_t row = row0 + r;
      if (row < end) {
        const int32_t b0 = __ldg(base + 2 * row);
        const int32_t b1 = __ldg(base + 2 * row + 1);
        const float wx = __ldg(wg + 2 * row);
        const float wy = __ldg(wg + 2 * row + 1);
        const Corners<bf16> k = corners_of(table, b0, b1, d_z, width);
        for (int ch = lane * 8; ch < d_z; ch += 32 * 8) {
          float o[8];
          bilerp8(k, ch, wx, wy, o);
          store8(reinterpret_cast<bf16*>(dst + swz_unit(r, ch >> 3)), o);
        }
      } else {
        for (int ch = lane * 8; ch < d_z; ch += 32 * 8)
          *reinterpret_cast<uint4*>(dst + swz_unit(r, ch >> 3)) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
};

template <int NI, int NH>
__global__ void __launch_bounds__(THREADS, 1)
fused_field_kernel(const Params p, const GatherFill fill) {
  mlp_block<NI, NH, MODE_Z>(p, fill);
}

int launch_width(const Params& p, const GatherFill& f, cudaStream_t s) {
  switch (p.dh) {
    case 64: return launch_mlp(fused_field_kernel<32, 1>, p, s, p, f);
    case 128: return launch_mlp(fused_field_kernel<64, 1>, p, s, p, f);
    case 256: return launch_mlp(fused_field_kernel<128, 1>, p, s, p, f);
    case 512: return launch_mlp(fused_field_kernel<128, 2>, p, s, p, f);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// As in fused_mlp.cu: the block's shared memory at these widths, 0 if refused.
extern "C" size_t mlp_body_smem_bytes(int kx, int zw, int d_hidden) {
  return body_smem_bytes(kx, zw, d_hidden);
}

// table (rows, d_z) bf16 feature rows of views `width` pixels wide; base
// (n, 2) int32; wg (n, 2) float32; the rest as fused_resnetfc_infer.
// Returns the CUDA error of the launch (0 = success).
extern "C" int fused_gather_resnetfc_infer(const void* table, const void* base, const void* wg,
                                           const void* x, const void* image, const void* bin,
                                           const void* bz, const void* b0, const void* b1,
                                           const void* wout, const void* bout, void* out,
                                           int64_t n, int d_in, int kx, int d_z, int d_hidden,
                                           int n_blocks, int n_lin_z, int width, void* stream) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.image = static_cast<const bf16*>(image);
  p.bin = static_cast<const bf16*>(bin);
  p.bz = static_cast<const bf16*>(bz);
  p.b0 = static_cast<const bf16*>(b0);
  p.b1 = static_cast<const bf16*>(b1);
  p.wout = static_cast<const bf16*>(wout);
  p.bout = static_cast<const bf16*>(bout);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.d_in = d_in;
  p.kx = kx;
  p.zw = d_z;
  p.dh = d_hidden;
  p.n_blocks = n_blocks;
  p.n_lin_z = n_lin_z;
  p.stages = stages_that_fit(kx, d_z, d_hidden);
  if (!p.stages) return (int)cudaErrorInvalidValue;
  const GatherFill f = {static_cast<const bf16*>(table), static_cast<const int32_t*>(base),
                        static_cast<const float*>(wg), d_z, width};
  return launch_width(p, f, static_cast<cudaStream_t>(stream));
}
