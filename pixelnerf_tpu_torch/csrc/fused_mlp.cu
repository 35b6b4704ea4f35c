// Fused ResnetFC inference MLP for Hopper (kernel B).
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
//
// The multi-view mode (views >= 2; mlp_body.cuh, MULTI_VIEW) replaces no TPU
// kernel: the JAX package gates its Pallas kernel to one view and leaves NS
// > 1 to XLA, as the port's dense bf16 chain did. It was added because at
// three source views (pixelNeRF's DTU model) that chain wrote every layer's
// (rows, dh) bf16 activations to device memory and read them back, ~4x the
// time of its matrix products. Here the views of a 64-point tile run through
// the block one after another and are averaged in registers at the combine
// layer, so its bound is the single-view kernel's: the weight stream from L2,
// the slabs before the combine layer once a view (~15.7 MB a 64-point tile at
// the DTU widths and NS 3, against 6.9 MB a single-view tile), at the same
// operations per slab byte. Beside it, each block stores and reloads NS-1
// views of its 64 x dh bf16 h a tile through L2 (128 KB at NS 3).
#include "mlp_body.cuh"

namespace {

// The tile of injection `inj`: the latents (zero past d_z: PAD, taken only
// where d_z is not a multiple of 64), or the injection's own slice.
template <bool PAD>
struct RowsFill {
  const bf16* z;
  int64_t ld;
  int src_width, width, step;   // columns read; of the tile; from one injection to the next
  __device__ __forceinline__ void operator()(int inj, int64_t row0, int64_t end, uint8_t* dst, int ft) const {
    fill_tile_rows<PAD>(z + (int64_t)inj * step, ld, src_width, width, row0, end, dst, ft);
  }
};

// The multi-view mode's z tile, a view's latents, and the mode's Views.
template <bool PAD>
struct ViewsFill : RowsFill<PAD> {
  Views views;
};

template <int NI, int NH, int MODE, class Fill, bool MULTI_VIEW>
__global__ void __launch_bounds__(THREADS, 1) fused_mlp_kernel(const Params p, const Fill fill) {
  mlp_block<NI, NH, MODE, Fill, MULTI_VIEW>(p, fill);
}

// tiles: the grid's tiles; max_blocks: its cap (0: none); MV: the multi-view mode
template <int MODE, bool MV, class Fill>
int launch_width(const Params& p, const Fill& f, int64_t tiles, int64_t max_blocks, cudaStream_t s) {
  switch (p.dh) {
    case 64: return launch_mlp_grid(fused_mlp_kernel<32, 1, MODE, Fill, MV>, p, tiles, max_blocks, s, p, f);
    case 128: return launch_mlp_grid(fused_mlp_kernel<64, 1, MODE, Fill, MV>, p, tiles, max_blocks, s, p, f);
    case 256: return launch_mlp_grid(fused_mlp_kernel<128, 1, MODE, Fill, MV>, p, tiles, max_blocks, s, p, f);
    case 512: return launch_mlp_grid(fused_mlp_kernel<128, 2, MODE, Fill, MV>, p, tiles, max_blocks, s, p, f);
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
// null. d_z is a multiple of 8 (whole 16-byte units a row). With views >= 2
// (the multi-view mode; not with z_is_tz, and n_lin_z < n_blocks) the n rows
// are (scene, view, point) with `points` points a view, out has n / views
// rows (scene, point), and scratch holds views-1 tiles of 64 x d_hidden bf16
// for each of scratch_blocks blocks (the grid is capped to it). Returns the
// CUDA error of the launch (0 = success).
extern "C" int fused_resnetfc_infer(const void* x, const void* z, const void* image,
                                    const void* bin, const void* bz, const void* b0,
                                    const void* b1, const void* wout, const void* bout, void* out,
                                    int64_t n, int d_in, int kx, int d_z, int d_hidden,
                                    int n_blocks, int n_lin_z, int z_is_tz, int views, int64_t points,
                                    void* scratch, int scratch_blocks, void* stream) {
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
  if (views > 1) {
    if (z_is_tz || n_lin_z < 1 || n_lin_z >= n_blocks || points < 1 || n % (views * points) || !scratch ||
        scratch_blocks < 1)
      return (int)cudaErrorInvalidValue;
    const Views w = {views, points, static_cast<uint4*>(scratch), 1.0f / (float)views};
    const int64_t tiles = view_tiles(p, w);
    if (p.zw != d_z)
      return launch_width<MODE_Z, true>(p, ViewsFill<true>{{zp, d_z, d_z, p.zw, 0}, w}, tiles,
                                        scratch_blocks, s);
    return launch_width<MODE_Z, true>(p, ViewsFill<false>{{zp, d_z, d_z, p.zw, 0}, w}, tiles,
                                      scratch_blocks, s);
  }
  const int64_t tiles = (n + T - 1) / T;
  if (z_is_tz)
    return launch_width<MODE_TZ, false>(p, RowsFill<false>{zp, d_z, d_hidden, d_hidden, d_hidden}, tiles, 0, s);
  if (p.zw != d_z) return launch_width<MODE_Z, false>(p, RowsFill<true>{zp, d_z, d_z, p.zw, 0}, tiles, 0, s);
  return launch_width<MODE_Z, false>(p, RowsFill<false>{zp, d_z, d_z, p.zw, 0}, tiles, 0, s);
}
