// Fused single-view ResnetFC inference MLP for Hopper (kernel B).
//
// Replaces: pixelnerf_tpu/ops/fused_mlp.py, fused_resnetfc_infer / _mlp_kernel,
// with its z_is_tz variant. Per tile of 64 rows it runs the whole conditioned
// MLP (mlp_body.cuh holds the chain, its rounding contract and the block's
// design, shared with the fused gather+MLP kernel):
//   h = x.Win + bin
//   for block i:  if i < n_lin_z: h += z.Wz[:, i*dh:(i+1)*dh] + bz[i*dh:(i+1)*dh]
//                 net = relu(h).W0_i + b0_i;  h += relu(net).W1_i + b1_i
//   out = relu(h).Wout + bout          (first 4 columns, float32)
// With z_is_tz, z already holds the injections tz = z_raw.Wz + bz (folded
// into the feature map at encode time, n_lin_z*dh wide): block i adds
// tz[:, i*dh:(i+1)*dh] to h in bf16 and there is no Wz product.
//
// Bound on this card: operations against device memory (about 7 MFLOP per
// row, 5.5 with z_is_tz, against ~1.3 KB or ~3.2 KB of inputs), but the
// weights do not fit beside a tile's activations in shared memory, so what
// the kernel really waits for is the stream of all the weights from L2 once
// per 64-row tile, at the rate one SM can take them in. mlp_body.cuh: a
// persistent block per SM, wgmma fed from a ring of weight slabs that a
// producer thread fills with bulk copies, the residual stream in registers.
//
// What this file adds is the tile of the injections: the producer's filler
// warps copy the 64 rows of z, once per tile and a tile ahead, or with
// z_is_tz block i's dh-wide slice of the injections, a block ahead, into
// the z buffer. A latent whose width d_z is not a multiple of 64 (a global
// encoder's vector before the spatial latent) takes a tile rounded up to the
// next 64 columns, zero past d_z; the tiled Wz has zero columns there too.
#include "mlp_body.cuh"

namespace {

// The tile of injection `inj`: the latents (zero past d_z: PAD, taken only
// where d_z is not a multiple of 64), or the injection's own slice.
template <bool PAD>
struct RowsFill {
  const bf16* z;
  int64_t ld, n;
  int src_width, width, step;   // columns read; of the tile; from one injection to the next
  __device__ __forceinline__ void operator()(int inj, int64_t row0, uint8_t* dst, int ft) const {
    fill_tile_rows<PAD>(z + (int64_t)inj * step, ld, src_width, width, row0, n, dst, ft);
  }
};

template <int NI, int NH, int MODE, class Fill>
__global__ void __launch_bounds__(THREADS, 1) fused_mlp_kernel(const Params p, const Fill fill) {
  mlp_block<NI, NH, MODE>(p, fill);
}

template <int MODE, class Fill>
int launch_width(const Params& p, const Fill& f, cudaStream_t s) {
  switch (p.dh) {
    case 64: return launch_mlp(fused_mlp_kernel<32, 1, MODE, Fill>, p, s, p, f);
    case 128: return launch_mlp(fused_mlp_kernel<64, 1, MODE, Fill>, p, s, p, f);
    case 256: return launch_mlp(fused_mlp_kernel<128, 1, MODE, Fill>, p, s, p, f);
    case 512: return launch_mlp(fused_mlp_kernel<128, 2, MODE, Fill>, p, s, p, f);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shared memory the MLP body's block takes with kx columns of x, a zw-wide
// z tile and d_hidden hidden units, 0 for widths it does not take: what
// ops/fused_mlp.py check_kernel_fits asks before a launch.
extern "C" size_t mlp_body_smem_bytes(int kx, int zw, int d_hidden) {
  return body_smem_bytes(kx, zw, d_hidden);
}

// The weight ring's stages the block holds at these widths, 0 as above.
extern "C" int mlp_body_ring_stages(int kx, int zw, int d_hidden) {
  return stages_that_fit(kx, zw, d_hidden);
}

// image: the tiled weights (with the Wz slabs unless z_is_tz, their columns
// padded to d_z rounded up to 64); bz is not read with z_is_tz and may be
// null. d_z is a multiple of 8 (whole 16-byte units a row). Returns the CUDA
// error of the launch (0 = success).
extern "C" int fused_resnetfc_infer(const void* x, const void* z, const void* image,
                                    const void* bin, const void* bz, const void* b0,
                                    const void* b1, const void* wout, const void* bout, void* out,
                                    int64_t n, int d_in, int kx, int d_z, int d_hidden,
                                    int n_blocks, int n_lin_z, int z_is_tz, void* stream) {
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
  p.zw = z_is_tz ? d_hidden : (d_z + 63) / 64 * 64;
  p.dh = d_hidden;
  p.n_blocks = n_blocks;
  p.n_lin_z = n_lin_z;
  p.stages = stages_that_fit(kx, p.zw, d_hidden);
  if (!p.stages || d_z % 8) return (int)cudaErrorInvalidValue;
  const bf16* zp = static_cast<const bf16*>(z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_is_tz) return launch_width<MODE_TZ>(p, RowsFill<false>{zp, d_z, n, d_hidden, d_hidden, d_hidden}, s);
  if (p.zw != d_z) return launch_width<MODE_Z>(p, RowsFill<true>{zp, d_z, n, d_z, p.zw, 0}, s);
  return launch_width<MODE_Z>(p, RowsFill<false>{zp, d_z, n, d_z, p.zw, 0}, s);
}
