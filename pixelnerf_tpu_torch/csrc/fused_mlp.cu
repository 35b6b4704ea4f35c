// Fused single-view ResnetFC inference MLP for Hopper.
//
// Replaces: pixelnerf_tpu/ops/fused_mlp.py, fused_resnetfc_infer / _mlp_kernel,
// with its z_is_tz variant. Per tile of T rows it runs the whole conditioned
// MLP (mlp_body.cuh holds the chain, its rounding contract and the tile
// layout, shared with the fused gather+MLP kernel):
//   h = x.Win + bin
//   for block i:  if i < n_lin_z: h += z.Wz[:, i*dh:(i+1)*dh] + bz[i*dh:(i+1)*dh]
//                 net = relu(h).W0_i + b0_i;  h += relu(net).W1_i + b1_i
//   out = relu(h).Wout + bout          (first 4 columns, float32)
// With z_is_tz, z already holds the injections tz = z_raw.Wz + bz (folded
// into the feature map at encode time, n_lin_z*dh wide): block i adds
// tz[:, i*dh:(i+1)*dh] to h in bf16 and there is no Wz product.
//
// Bound on this card: operations. About 7 MFLOP per row (5.5 with z_is_tz)
// against ~1.3 KB (~3.2 KB) of inputs, above the H100's ~295 flop/byte
// balance point. The TPU kernel pinned all ~6.8 MB of bf16 weights in VMEM;
// a block here has 227 KB of shared memory, so a block keeps only its rows'
// activations on chip: the x and z tiles and h and net (T=64 rows, 512 wide,
// 212 KB in all). The weights are streamed from global memory through L2
// (where all of them fit) straight into the tensor-core fragments. The
// injections are computed one block's column slice at a time
// (z.Wz[:, i*dh:(i+1)*dh]): the whole (T, 3*dh) tz would not fit beside h
// and net, and each output element is the same dot product. For the same
// reason the z_is_tz variant keeps no z tile: a 64 x 1536 bf16 tile is
// 196 KB, and each block's 512-wide slice is consumed once, so it is read
// from global memory where it is added. wgmma, TMA and warp specialisation
// are left for later work.
#include "mlp_body.cuh"

namespace {

template <bool Z_IS_TZ>
__global__ void __launch_bounds__(WARPS * 32, 1) fused_mlp_kernel(Params p) {
  extern __shared__ uint4 smem_raw[];
  const Tiles t = carve_tiles(p, smem_raw, !Z_IS_TZ);
  const int64_t row0 = (int64_t)blockIdx.x * T;
  fill_x_tile(p, t, row0);
  if constexpr (!Z_IS_TZ) fill_z_tile(p, t, row0);
  __syncthreads();
  mlp_chain<Z_IS_TZ>(p, t, row0);
}

}  // namespace

extern "C" size_t fused_resnetfc_smem_bytes(int d_in_pad, int d_z, int d_hidden, int z_is_tz) {
  return mlp_smem_bytes(d_in_pad, d_z, d_hidden, !z_is_tz);
}

// Returns cudaGetLastError() after the launch (0 = success). With z_is_tz,
// wz and bz are not read and may be null.
extern "C" int fused_resnetfc_infer(const void* x, const void* z, const void* win,
                                    const void* bin, const void* wz, const void* bz,
                                    const void* w0, const void* b0, const void* w1,
                                    const void* b1, const void* wout, const void* bout,
                                    void* out, int64_t n, int d_in, int d_in_pad, int d_z,
                                    int d_hidden, int n_blocks, int n_lin_z, int z_is_tz,
                                    void* stream) {
  const Params p = make_params(x, z, win, bin, wz, bz, w0, b0, w1, b1, wout, bout, out, n,
                               d_in, d_in_pad, d_z, d_hidden, n_blocks, n_lin_z);
  const size_t smem = mlp_smem_bytes(d_in_pad, d_z, d_hidden, !z_is_tz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_is_tz) return launch_tiles(fused_mlp_kernel<true>, smem, n, s, p);
  return launch_tiles(fused_mlp_kernel<false>, smem, n, s, p);
}
