// The conditioned ResnetFC MLP on tiles of T = 64 rows, shared by the fused
// MLP kernel (fused_mlp.cu) and the fused gather+MLP kernel (fused_field.cu):
//   h = x.Win + bin
//   for block i:  if i < n_lin_z: h += tz[:, i*dh:(i+1)*dh]
//                 net = relu(h).W0_i + b0_i;  h += relu(net).W1_i + b1_i
//   out = relu(h).Wout + bout          (first 4 columns, float32)
// where tz = z.Wz + bz is computed one block's column slice at a time from
// the z tile, or, in the TZ mode, read as it is (the injections were folded
// into the feature map at encode time).
//
// Rounding contract, as in the TPU kernel (pixelnerf_tpu/ops/fused_mlp.py,
// _mlp_kernel) and nn.Dense(dtype=bfloat16): each product accumulates in
// float32 on the tensor cores, is rounded to bf16, then the bf16 bias is
// added and the sum rounded to bf16. The residual adds and the latent
// injections are bf16 adds. This ONE definition serves both kernels, so the
// fused gather+MLP kernel equals the MLP kernel fed by the gather kernel bit
// for bit.
//
// What bounds it on an H100: 7 MFLOP per row, far above the card's
// flop-per-byte balance against device memory, but a block can keep only one
// 64-row tile of activations in its 227 KB of shared memory, so every tile
// streams all the weights (6.9 MB at the SRN widths) from L2. Fetched with
// 4-byte loads straight into mma.sync fragments, one block per tile, those
// loads alone take 86% of the kernel's 46 ms, and mma.sync fed from shared
// memory by 4-byte loads does not go below 25 ms either (PERF.md). This
// design:
//
// - One persistent block per SM walks the tiles. It has two consumer
//   warpgroups and one producer warpgroup that never reconverge;
//   setmaxnreg moves registers from the producer to the consumers.
// - Tensor cores: wgmma m64nNk16, A and B both from shared memory in the
//   128-byte swizzle, the sum in registers. The two consumer warpgroups
//   split a layer's output columns; a warpgroup's half is NH slabs of NI
//   columns (NI <= 128, 64 float32 registers a thread per slab).
// - Weights: ops/fused_mlp.py lays every matrix out once per model as the
//   sequence of (NI x 64) slabs the consumers walk, each slab already the
//   swizzled shared-memory image. Lane 0 of the producer's first warp copies
//   slab after slab into a ring of stages with one cp.async.bulk each; full
//   and empty mbarriers order it against the consumers, which release a
//   stage as soon as the wgmma group that read it has completed.
// - The residual stream h lives in the consumers' registers (bf16 pairs, in
//   the accumulator's layout: a thread always owns the same elements), so
//   shared memory holds only what a product reads, and relu(h) and relu(net)
//   are only ever read through the ReLU: the epilogue that writes them
//   rectifies them, and both take turns in ONE activation buffer (a sync of
//   the consumers between a product's last read and the next write).
// - That leaves a buffer for the z tile of the injections (the latents, or
//   kernel D's gather), filled by the producer's other three warps once per
//   tile and a tile ahead, under the blocks that follow the last injection;
//   in the TZ mode it holds one injection's slice, filled a block ahead.
//   The x tile (64 columns, not 128) has its own buffer, a tile ahead too.
//   Wout's 8 rows stay resident. At the SRN widths: activations 64 KB, z
//   64 KB, x 8 KB, Wout 8 KB, ring 5 x 16 KB.
//
// The multi-view mode (MULTI_VIEW, MODE_Z only) takes NS >= 2 source views
// averaged at the combine layer, the field of pixelNeRF's DTU model. Rows of
// x and z are (scene, view, point): row (s*NS + v)*B + p, the layout that
// query_features hands over. A tile is 64 points of one scene (the ragged end
// of B masked, no tile across two scenes); for each view in turn the block
// runs lin_in, the injections and blocks 0 .. n_lin_z-1 on that view's 64
// rows, the x and z tiles filled a view ahead; then the views' mean, then the
// blocks from the combine layer on and lin_out on the tile's 64 points, one
// output row a point. The producer walks the slabs before the combine layer
// NS times a tile, the rest once. Every instance runs these steps: outside the
// multi-view mode the rows are one scene of one view (NS = 1 at compile time,
// B = n), and there is no mean. The mean cannot keep a float32 sum in the
// registers (h and the accumulator hold 192 of a consumer's 224 at dh 512) nor
// in shared memory (full): before the last view each thread stores its own
// fragment of h, 16-byte units, in the block's slice of a scratch in global
// memory (NS-1 x 64 rows x dh bf16 a block, ~17 MB at NS 3 on 132 SMs: it
// stays in L2), and the last view reads its own fragments back and adds them.
//
// The mean's rounding is torch.mean's of a bf16 tensor on the card (ATen's
// MeanOps for reduced types): the views' bf16 values summed in float32 from
// 0 in view order, times the float32 factor 1/NS (ATen's float(M)/float(NS*M),
// which is 1/NS wherever its element counts are exact in float32), rounded
// once to bf16.
//
// What it is left waiting for: the weight stream. With the tensor cores'
// work taken out the kernel takes the same time, half the grid takes twice
// the time, and a thread block cluster whose blocks each fetch a part of
// every slab and multicast it to the others (tried, 2 and 4 blocks) gains
// nothing: an SM takes in ~65 GB/s of slabs whatever L2 is asked for, and a
// 64-row tile needs all 6.9 MB. More rows per fetched byte need a block that
// holds more than 64 rows of activations (PERF.md).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int T = 64;                  // rows per tile: one wgmma M
constexpr int CONSUMERS = 256;         // two warpgroups
constexpr int FILLERS = 96;            // the producer warpgroup's warps 1-3
constexpr int THREADS = CONSUMERS + 32 + FILLERS;
constexpr int CHUNK = T * 128;         // bytes of a 64-row x 64-column chunk
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory a Hopper block may use
constexpr int CONSUMER_REGS = 224;
constexpr int PRODUCER_REGS = 56;

// What the z buffer holds: the tile's z rows (given, or gathered by kernel D),
// or one injection's slice of the baked injections.
enum Mode { MODE_Z = 0, MODE_TZ = 1 };

struct Params {
  const bf16* x;      // (n, d_in)
  const bf16* image;  // the tiled weights (ops/fused_mlp.py, tile_weights)
  const bf16* bin;    // (dh)
  const bf16* bz;     // (n_lin_z*dh); unused in the TZ mode
  const bf16* b0;     // (n_blocks, dh)
  const bf16* b1;     // (n_blocks, dh)
  const bf16* wout;   // (>= 8, dh)
  const bf16* bout;   // (>= 8)
  float* out;         // (n, 4); in the multi-view mode (n / ns, 4)
  int64_t n;
  int d_in, kx;       // x columns, and their count rounded up to 64
  int zw;             // width of the z tile: d_z, or dh in the TZ mode
  int dh, n_blocks, n_lin_z, stages;
};

// The multi-view mode's own parameters, carried by its fill (fill.views):
// Params stays as the single-view instances know it (a field more there
// changes their code).
struct Views {
  int ns;             // views, averaged at the combine layer (n_lin_z)
  int64_t pts;        // points a view of a scene: rows (scene, view, point)
  uint4* scratch;     // the saved views' h: ns-1 tiles of 64 rows x dh a block
  float mean_scale;   // 1/ns in float32
};

// Byte offsets of the block's buffers from the 1024-aligned base.
struct Layout {
  int act, z, x, wout, ring, bars, total;
};

__host__ __device__ inline Layout layout_of(int kx, int zw, int dh, int ni, int stages) {
  Layout l;
  l.act = 0;
  l.z = 128 * dh;
  l.x = l.z + 128 * zw;
  l.wout = l.x + 128 * kx;
  l.ring = l.wout + ((16 * dh + 1023) / 1024) * 1024;
  l.bars = l.ring + stages * ni * 128;
  l.total = l.bars + 256 + 1024;       // barriers; slack to align the base
  return l;
}

// Columns of a weight slab: half of dh, at most 128.
__host__ __device__ inline int slab_columns(int dh) { return dh / 2 < 128 ? dh / 2 : 128; }

// Ring stages that fit beside the activations; 0 for widths the body is not
// built for (the launchers instantiate dh 64, 128, 256, 512; the tiles are
// whole 64-column chunks) or that do not fit.
inline int stages_that_fit(int kx, int zw, int dh) {
  if (dh != 64 && dh != 128 && dh != 256 && dh != 512) return 0;
  if (kx < 64 || zw < 64 || kx % 64 || zw % 64) return 0;
  const int ni = slab_columns(dh);
  int stages = (SMEM_LIMIT - layout_of(kx, zw, dh, ni, 0).total) / (ni * 128);
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  return stages < 2 ? 0 : stages;
}

// Shared memory of the block at these widths, 0 if stages_that_fit refuses them.
inline size_t body_smem_bytes(int kx, int zw, int dh) {
  const int stages = stages_that_fit(kx, zw, dh);
  return stages ? layout_of(kx, zw, dh, slab_columns(dh), stages).total : 0;
}

// ---- PTX: barriers, bulk copies, fences -------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A new barrier is in
// phase 0: waiting for parity 1 passes at once, for parity 0 blocks.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// ---- PTX: wgmma -------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Descriptor of a K-major operand in the 128-byte swizzle: rows of 128 bytes
// (64 bf16 of K), 8-row groups 1024 bytes apart. The k-th 16-column step of
// a chunk starts 32 bytes, i.e. 2 address units, further.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// D (64 x N, float32 in registers) = or += A (64 x 16) . B (N x 16)^T
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// keep the compiler from moving reads of a wgmma's sums above its wait
template <int N>
__device__ __forceinline__ void fence_registers(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- the rounding contract --------------------------------------------
//
// The sum of two bf16 values is exact in float32 unless their exponents lie
// 17 or more apart, and then neither rounding can move it off the larger
// one; so one add.rn.bf16x2 equals the float32 add followed by the rounding
// to bf16 that the plain version makes, bit for bit.

typedef __nv_bfloat162 bf162;

__device__ __forceinline__ bf162 as_bf162(uint32_t u) { return *reinterpret_cast<bf162*>(&u); }
__device__ __forceinline__ uint32_t as_u32(bf162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// bf16(bf16(acc) + bias) on two adjacent columns: the dense layer's
// rounding contract.
__device__ __forceinline__ bf162 dense_round(float acc0, float acc1, bf162 bias) {
  return __hadd2(__floats2bfloat162_rn(acc0, acc1), bias);
}

__device__ __forceinline__ uint32_t relu2(bf162 v) {
  return as_u32(__hmax2(v, __float2bfloat162_rn(0.0f)));
}

// two adjacent bf16 (a bias pair, 4-byte aligned)
__device__ __forceinline__ bf162 ld_pair(const bf16* p) {
  return as_bf162(__ldg(reinterpret_cast<const unsigned int*>(p)));
}

// ---- tiles in shared memory -------------------------------------------

// Byte offset of the 16-byte unit `cu` (columns 8cu..8cu+7) of row `r` in a
// 64-row tile: 64-column chunks of CHUNK bytes, rows of 128 bytes, the
// unit's place in its row XOR-ed with the row (the 128-byte swizzle).
__device__ __forceinline__ int swz_unit(int r, int cu) {
  return (cu >> 3) * CHUNK + r * 128 + (((cu & 7) ^ (r & 7)) << 4);
}

// x tile, zero-padded to kx columns and from row `end` on (the last row, or
// a view's in the multi-view mode)
__device__ __forceinline__ void fill_x_tile(const Params& p, uint8_t* xs, int64_t row0, int64_t end, int ft) {
  for (int i = ft; i < T * p.kx; i += FILLERS) {
    const int r = i / p.kx, c = i % p.kx;
    bf16 v = __float2bfloat16_rn(0.0f);
    if (row0 + r < end && c < p.d_in) v = p.x[(row0 + r) * p.d_in + c];
    *reinterpret_cast<bf16*>(xs + swz_unit(r, c >> 3) + (c & 7) * 2) = v;
  }
}

// A tile of `width` columns of the rows row0.. of src (row stride ld), by
// 16-byte vectors, zero past the last row; with PAD only the first
// src_width columns (a multiple of 8) come from src, and the rest of the
// tile is zero. Each thread starts LOADS loads before it uses the first, so
// the tile arrives at the rate of the memory, not at its latency. (Without
// PAD the check is compiled out, for the TZ mode and for latents of whole
// 64-column chunks: in the TZ mode a fill runs before every injection, and
// there the check cost 12% of kernel B-tz's time on an H100.)
template <bool PAD>
__device__ __forceinline__ void fill_tile_rows(const bf16* src, int64_t ld, int src_width, int width,
                                               int64_t row0, int64_t n, uint8_t* dst, int ft) {
  constexpr int LOADS = 8;
  const int units = width / 8, src_units = src_width / 8;
  const int total = T * units;
  for (int i0 = ft; i0 < total; i0 += FILLERS * LOADS) {
    uint4 raw[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * FILLERS;
      const int r = i / units, cu = i % units;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && row0 + r < n && (!PAD || cu < src_units))
        raw[u] = __ldg(reinterpret_cast<const uint4*>(src + (row0 + r) * ld) + cu);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * FILLERS;
      if (i < total) *reinterpret_cast<uint4*>(dst + swz_unit(i / units, i % units)) = raw[u];
    }
  }
}

// ---- the consumers' pieces --------------------------------------------

// A consumer warpgroup's view of the weight ring: it takes every second
// slab, starting with its own index. With an odd number of stages a stage
// serves the two warpgroups in turn.
struct Ring {
  uint32_t full, empty, data;   // shared-memory addresses: barriers, stages
  int stages, stage;
  uint32_t phase;
};

// acc = A . W^T for this warpgroup's NH slabs of NI columns: A (64 rows,
// 64*kchunks columns) at shared address a_addr, the slabs from the ring in
// the order (slab of columns, chunk of K). A stage goes back to the producer
// as soon as the wgmma group that read it has completed: the ring's refill,
// not the tensor cores, is what the kernel waits for, so the short drain of
// the tensor pipe between slabs costs nothing and the earlier refill gains.
// Each of the four warps reports its own completion (`first`: the warp's
// lane 0), so a warp that lags never finds a stage, or the A tile, refilled
// under it.
//
// A wait on a barrier's parity is sound only while the waiter cannot be a
// whole phase ahead of the barrier. On a stage that serves the warpgroups in
// turn, the one that runs ahead (the other's slab came late, from device
// memory) would wait for the stage's next fill before its present fill has
// completed, and pass. So a warpgroup first waits until the stage's fill
// before its own has been released (the fill before that was its own), and
// only then for its own fill.
template <int NI, int NH>
__device__ __forceinline__ void product(float (&acc)[NH][NI / 2], uint32_t a_addr, int kchunks,
                                        Ring& rg, bool first) {
#pragma unroll
  for (int nh = 0; nh < NH; ++nh) {
    for (int kc = 0; kc < kchunks; ++kc) {
      mbar_wait(rg.empty + 8 * rg.stage, rg.phase ^ 1);
      mbar_wait(rg.full + 8 * rg.stage, rg.phase);
      wgmma_fence();
      const uint64_t da = make_desc(a_addr + kc * CHUNK);
      const uint64_t db = make_desc(rg.data + rg.stage * (NI * 128));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<NI>::mma(acc[nh], da + 2 * kk, db + 2 * kk, (kc | kk) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      if (first) mbar_arrive(rg.empty + 8 * rg.stage);
      rg.stage += 2;
      if (rg.stage >= rg.stages) {
        rg.stage -= rg.stages;
        rg.phase ^= 1;
      }
    }
  }
#pragma unroll
  for (int nh = 0; nh < NH; ++nh) fence_registers(acc[nh]);
}

// Where a consumer thread's elements lie. Its sums acc[nh][4j + 2*half + e]
// are row row_a + 8*half, column col0 + nh*NI + 8j + e; in a shared-memory
// tile that pair is 4 bytes at unit_off(nh, j) + 1024*half.
template <int NI, int NH>
struct Place {
  int col0, cu0, r7, rowoff;
  __device__ __forceinline__ Place(int wg, int row_a, int lane)
      : col0(wg * NH * NI + 2 * (lane & 3)), cu0(wg * NH * NI / 8), r7(row_a & 7),
        rowoff(row_a * 128 + (lane & 3) * 4) {}
  __device__ __forceinline__ int unit_off(int nh, int j) const {
    const int cu = cu0 + nh * (NI / 8) + j;
    return (cu >> 3) * CHUNK + (((cu & 7) ^ r7) << 4) + rowoff;
  }
};

enum Epilogue { EPI_SET, EPI_ADD, EPI_NET };

// The epilogue of a product, y = bf16(bf16(acc) + bias) per element:
// EPI_SET: h = y;  EPI_ADD: h = bf16(h + y);  EPI_NET: tile = relu(y).
template <int NI, int NH, int EPI>
__device__ __forceinline__ void epilogue(float (&acc)[NH][NI / 2], uint32_t (&h)[NH][NI / 8][2],
                                         const bf16* bias, const Place<NI, NH>& pl, uint8_t* tile) {
#pragma unroll
  for (int nh = 0; nh < NH; ++nh) {
#pragma unroll
    for (int j = 0; j < NI / 8; ++j) {
      const bf162 b = ld_pair(bias + pl.col0 + nh * NI + 8 * j);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const bf162 y = dense_round(acc[nh][4 * j + 2 * half], acc[nh][4 * j + 2 * half + 1], b);
        if constexpr (EPI == EPI_SET) {
          h[nh][j][half] = as_u32(y);
        } else if constexpr (EPI == EPI_ADD) {
          h[nh][j][half] = as_u32(__hadd2(as_bf162(h[nh][j][half]), y));
        } else {
          *reinterpret_cast<uint32_t*>(tile + pl.unit_off(nh, j) + 1024 * half) = relu2(y);
        }
      }
    }
  }
}

// tile = relu(h)
template <int NI, int NH>
__device__ __forceinline__ void store_relu(const uint32_t (&h)[NH][NI / 8][2],
                                           const Place<NI, NH>& pl, uint8_t* tile) {
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int j = 0; j < NI / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(tile + pl.unit_off(nh, j) + 1024 * half) =
            relu2(as_bf162(h[nh][j][half]));
}

// h = bf16(h + tile)
template <int NI, int NH>
__device__ __forceinline__ void add_tile(uint32_t (&h)[NH][NI / 8][2], const Place<NI, NH>& pl,
                                         const uint8_t* tile) {
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int j = 0; j < NI / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        h[nh][j][half] = as_u32(__hadd2(
            as_bf162(h[nh][j][half]),
            as_bf162(*reinterpret_cast<const uint32_t*>(tile + pl.unit_off(nh, j) + 1024 * half))));
}

// ---- the views' mean (the multi-view mode) ----------------------------

// The 16-byte units of a consumer thread's h: unit u holds the pairs
// h[nh][j][0..1], h[nh][j+1][0..1] with u = (nh*NI/8 + j)/2. Unit u of a
// saved view lies CONSUMERS units after unit u-1, so a warp's stores are
// 512 contiguous bytes.

// store this thread's h, the view's values at the combine layer
template <int NI, int NH>
__device__ __forceinline__ void save_view(const uint32_t (&h)[NH][NI / 8][2], uint4* dst) {
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int j = 0; j < NI / 8; j += 2)
      __stcg(dst + ((nh * (NI / 8) + j) / 2) * CONSUMERS,
             make_uint4(h[nh][j][0], h[nh][j][1], h[nh][j + 1][0], h[nh][j + 1][1]));
}

// a += the bf16 pair u, element by element in float32
__device__ __forceinline__ void add_pair(float& a0, float& a1, uint32_t u) {
  const float2 f = __bfloat1622float2(as_bf162(u));
  a0 += f.x;
  a1 += f.y;
}

// h = bf16((0 + v_0 + ... + v_{saved-1} + h) * scale) in float32, the saved
// views v_i (units CONSUMERS * U apart, U = NH*NI/16) first, this view last.
// The sum lies in acc, which holds no product's sums here and has an element
// for each of h's: h[nh][j][half] is acc[nh][4j + 2half .. +1].
template <int NI, int NH>
__device__ __forceinline__ void mean_views(float (&acc)[NH][NI / 2], uint32_t (&h)[NH][NI / 8][2],
                                           const uint4* src, int saved, float scale) {
  constexpr int U = NH * NI / 16;
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int i = 0; i < NI / 2; ++i) acc[nh][i] = 0.f;
  for (int v = 0; v < saved; ++v) {
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) {
#pragma unroll
      for (int j = 0; j < NI / 8; j += 2) {
        const uint4 w = __ldcg(src + (v * U + (nh * (NI / 8) + j) / 2) * CONSUMERS);
        float* a = acc[nh] + 4 * j;
        add_pair(a[0], a[1], w.x);
        add_pair(a[2], a[3], w.y);
        add_pair(a[4], a[5], w.z);
        add_pair(a[6], a[7], w.w);
      }
    }
  }
#pragma unroll
  for (int nh = 0; nh < NH; ++nh) {
#pragma unroll
    for (int j = 0; j < NI / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float& a0 = acc[nh][4 * j + 2 * half];
        float& a1 = acc[nh][4 * j + 2 * half + 1];
        add_pair(a0, a1, h[nh][j][half]);
        h[nh][j][half] = as_u32(__floats2bfloat162_rn(a0 * scale, a1 * scale));
      }
    }
  }
}

// Where tile t's rows lie: 64 points from p0 of one scene, rows (scene,
// view, point) of x and z and (scene, point) of out, ns views of pts points
// a scene; the rows of a view end at the view's last point. Outside the
// multi-view mode (one scene of one view, pts = n) tile t is rows 64t.. .
template <bool MULTI_VIEW>
struct ViewTile {
  int64_t scene, p0;
  __device__ __forceinline__ ViewTile(int64_t pts, int64_t t) {
    if constexpr (MULTI_VIEW) {
      const int64_t tiles = (pts + T - 1) / T;
      scene = t / tiles;
      p0 = (t - scene * tiles) * T;
    } else {
      scene = 0;
      p0 = t * T;
    }
  }
  __device__ __forceinline__ int64_t row0(int ns, int64_t pts, int v) const { return (scene * ns + v) * pts + p0; }
  __device__ __forceinline__ int64_t end(int ns, int64_t pts, int v) const { return (scene * ns + v + 1) * pts; }
};

// Tiles of the multi-view mode: ceil(pts/64) a scene.
__host__ __device__ inline int64_t view_tiles(const Params& p, const Views& w) {
  return p.n / ((int64_t)w.ns * w.pts) * ((w.pts + T - 1) / T);
}

// ---- the block's steps ------------------------------------------------

// `count` slabs of the image from src into the ring, one bulk copy each
__device__ __forceinline__ void stream_slabs(const uint8_t* src, int count, uint32_t slab, uint32_t ring,
                                             uint32_t wfull, uint32_t wempty, int stages, int& stage,
                                             uint32_t& phase) {
  for (int s = 0; s < count; ++s, src += slab) {
    mbar_wait(wempty + 8 * stage, phase);
    mbar_expect_tx(wfull + 8 * stage, slab);
    bulk_copy(ring + stage * slab, src, slab, wfull + 8 * stage);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// h = x.Win + bin, from the x tile, which goes back to the fillers
template <int NI, int NH>
__device__ __forceinline__ void lin_in(float (&acc)[NH][NI / 2], uint32_t (&h)[NH][NI / 8][2], const Params& p,
                                       const Place<NI, NH>& pl, uint32_t x_addr, uint32_t xfull,
                                       uint32_t xempty, uint32_t& ph_x, Ring& rg, bool first) {
  mbar_wait(xfull, ph_x);
  ph_x ^= 1;
  product<NI, NH>(acc, x_addr, p.kx / 64, rg, first);
  if (first) mbar_arrive(xempty);
  epilogue<NI, NH, EPI_SET>(acc, h, p.bin, pl, nullptr);
}

// h += z.Wz[:, blk*dh:(blk+1)*dh] + bz, from the tile's one z tile, which
// goes back to the fillers after the last injection
template <int NI, int NH>
__device__ __forceinline__ void inject_z(float (&acc)[NH][NI / 2], uint32_t (&h)[NH][NI / 8][2], const Params& p,
                                         int blk, const Place<NI, NH>& pl, uint32_t z_addr, uint32_t zfull,
                                         uint32_t zempty, uint32_t& ph_z, Ring& rg, bool first) {
  if (blk == 0) {
    mbar_wait(zfull, ph_z);
    ph_z ^= 1;
  }
  product<NI, NH>(acc, z_addr, p.zw / 64, rg, first);
  if (blk == p.n_lin_z - 1 && first) mbar_arrive(zempty);
  epilogue<NI, NH, EPI_ADD>(acc, h, p.bz + blk * p.dh, pl, nullptr);
}

// h += tz[:, blk*dh:(blk+1)*dh] (the TZ mode), from the injection's own
// slice, which goes back to the fillers at once
template <int NI, int NH>
__device__ __forceinline__ void inject_tz(uint32_t (&h)[NH][NI / 8][2], const Place<NI, NH>& pl,
                                          const uint8_t* ztile, uint32_t zfull, uint32_t zempty, uint32_t& ph_z) {
  mbar_wait(zfull, ph_z);
  ph_z ^= 1;
  add_tile<NI, NH>(h, pl, ztile);
  mbar_arrive(zempty);
}

// net = relu(h).W0 + b0;  h += relu(net).W1 + b1. Each sync: the product
// before has read the activation buffer in both warpgroups, or the epilogue
// has written it.
template <int NI, int NH>
__device__ __forceinline__ void residual_block(float (&acc)[NH][NI / 2], uint32_t (&h)[NH][NI / 8][2],
                                               const Params& p, int blk, const Place<NI, NH>& pl, uint8_t* act,
                                               uint32_t act_addr, Ring& rg, bool first) {
  const int hc = p.dh / 64;
  consumer_sync();
  store_relu<NI, NH>(h, pl, act);
  fence_proxy_async();
  consumer_sync();
  product<NI, NH>(acc, act_addr, hc, rg, first);
  consumer_sync();
  epilogue<NI, NH, EPI_NET>(acc, h, p.b0 + blk * p.dh, pl, act);
  fence_proxy_async();
  consumer_sync();
  product<NI, NH>(acc, act_addr, hc, rg, first);
  epilogue<NI, NH, EPI_ADD>(acc, h, p.b1 + blk * p.dh, pl, nullptr);
}

// out = relu(h).Wout + bout, columns 0..3 of one 8-wide wgmma, for the
// tile's rows from row0 below end
template <int NI, int NH>
__device__ __forceinline__ void head(const uint32_t (&h)[NH][NI / 8][2], const Params& p, const Place<NI, NH>& pl,
                                     uint8_t* act, uint32_t act_addr, uint32_t wout_addr, int wg, int lane,
                                     int row_a, int64_t row0, int64_t end) {
  const int hc = p.dh / 64;
  consumer_sync();
  store_relu<NI, NH>(h, pl, act);
  fence_proxy_async();
  consumer_sync();
  if (wg == 0) {
    float o[4];
    wgmma_fence();
    for (int kc = 0; kc < hc; ++kc) {
      const uint64_t da = make_desc(act_addr + kc * CHUNK);
      const uint64_t db = make_desc(wout_addr + kc * 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<8>::mma(o, da + 2 * kk, db + 2 * kk, (kc | kk) != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(o);
    const int c = 2 * (lane & 3);
    if (c < 4) {
      const bf162 b = ld_pair(p.bout + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t row = row0 + row_a + 8 * half;
        if (row < end)
          *reinterpret_cast<float2*>(p.out + row * 4 + c) =
              __bfloat1622float2(dense_round(o[2 * half], o[2 * half + 1], b));
      }
    }
  }
}

// ---- the block --------------------------------------------------------

// The whole kernel body. NI, NH: a warpgroup's columns are NH slabs of NI
// (dh = 2*NH*NI). MODE: what the z buffer holds (Mode). fill(inj, row0, end,
// dst, ft) is called by the 96 filler threads (ft = 0..95) and writes the z
// tile of the rows from row0 (in the TZ mode: the slice of injection `inj`)
// into dst, 64 rows in the swizzled layout of swz_unit, zero from row `end`
// on. MULTI_VIEW: the multi-view mode (MODE_Z; see the top), whose
// fill.views holds its Views.
template <int NI, int NH, int MODE, typename Fill, bool MULTI_VIEW = false>
__device__ __forceinline__ void mlp_block(const Params& p, const Fill& fill) {
  static_assert(!MULTI_VIEW || MODE == MODE_Z, "the multi-view mode takes the latents");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout L = layout_of(p.kx, p.zw, p.dh, NI, p.stages);
  const uint32_t sbase = smem_u32(base);
  const uint32_t wfull = sbase + L.bars, wempty = wfull + 8 * MAX_STAGES;
  const uint32_t xfull = wempty + 8 * MAX_STAGES, xempty = xfull + 8;
  const uint32_t zfull = xfull + 16, zempty = xfull + 24;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, 4);
    }
    mbar_init(xfull, FILLERS);
    mbar_init(xempty, CONSUMERS / 32);
    mbar_init(zfull, FILLERS);
    mbar_init(zempty, MODE == MODE_TZ ? CONSUMERS : CONSUMERS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Wout's first 8 rows stay in shared memory for the whole kernel
  const int units = p.dh / 8;
  for (int i = tid; i < 8 * units; i += THREADS) {
    const int r = i / units, cu = i % units;
    *reinterpret_cast<uint4*>(base + L.wout + (cu >> 3) * 1024 + r * 128 + (((cu & 7) ^ r) << 4)) =
        __ldg(reinterpret_cast<const uint4*>(p.wout + r * p.dh) + cu);
  }
  fence_proxy_async();
  __syncthreads();

  // the views a scene and the points a view (one of the n rows outside the
  // multi-view mode); the block walks the tiles blockIdx.x, blockIdx.x +
  // gridDim.x, ...
  int ns = 1;
  int64_t pts = p.n, n_tiles = (p.n + T - 1) / T;
  if constexpr (MULTI_VIEW) {
    ns = fill.views.ns;
    pts = fill.views.pts;
    n_tiles = view_tiles(p, fill.views);
  }
  const int iters = (int)((n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);

  if (tid >= CONSUMERS) {
    // ======== producer warpgroup ========
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pt = tid - CONSUMERS;
    if (pt < 32) {
      if (pt == 0) {
        // the weight ring: every tile takes the whole image, slab by slab,
        // the slabs before the combine layer (lin_in and the injected
        // blocks) once a view
        const uint32_t slab = NI * 128;
        const int wz_chunks = MODE == MODE_TZ ? 0 : p.n_lin_z * (p.zw / 64);
        const int slabs = 2 * NH * (p.kx / 64 + wz_chunks + 2 * p.n_blocks * (p.dh / 64));
        const int pre = 2 * NH * (p.kx / 64 + wz_chunks + 2 * p.n_lin_z * (p.dh / 64));
        const uint8_t* image = reinterpret_cast<const uint8_t*>(p.image);
        int stage = 0;
        uint32_t phase = 1;
        for (int it = 0; it < iters; ++it) {
          for (int v = 0; v < ns; ++v)
            stream_slabs(image, pre, slab, sbase + L.ring, wfull, wempty, p.stages, stage, phase);
          stream_slabs(image + (size_t)pre * slab, slabs - pre, slab, sbase + L.ring, wfull, wempty, p.stages,
                       stage, phase);
        }
      }
    } else {
      // the x tile and the tile of the injections of each view in turn, a
      // view ahead (in the TZ mode a slice per injection, a block ahead)
      const int ft = pt - 32;
      const int fills = MODE == MODE_TZ ? p.n_lin_z : 1;
      uint32_t ph_x = 1, ph_z = 1;
      for (int it = 0; it < iters; ++it) {
        const ViewTile<MULTI_VIEW> vt(pts, (int64_t)it * gridDim.x + blockIdx.x);
        for (int v = 0; v < ns; ++v) {
          const int64_t row0 = vt.row0(ns, pts, v), end = vt.end(ns, pts, v);
          mbar_wait(xempty, ph_x);
          ph_x ^= 1;
          fill_x_tile(p, base + L.x, row0, end, ft);
          fence_proxy_async();
          mbar_arrive(xfull);
          for (int inj = 0; inj < fills; ++inj) {
            mbar_wait(zempty, ph_z);
            ph_z ^= 1;
            fill(inj, row0, end, base + L.z, ft);
            fence_proxy_async();
            mbar_arrive(zfull);
          }
        }
      }
    }
  } else {
    // ======== consumer warpgroups ========
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = tid >> 7, wtid = tid & 127, lane = tid & 31;
    const bool first = lane == 0;     // reports for its warp
    const int row_a = (wtid >> 5) * 16 + (lane >> 2);
    float acc[NH][NI / 2];
    uint32_t h[NH][NI / 8][2];       // the residual stream, bf16 pairs
    const Place<NI, NH> pl(wg, row_a, lane);
    Ring rg = {wfull, wempty, sbase + L.ring, p.stages, wg, 0u};
    uint8_t* const act = base + L.act;       // relu(h), then relu(net): what a product reads
    const uint32_t act_addr = sbase + L.act, z_addr = sbase + L.z;
    uint32_t ph_x = 0, ph_z = 0;
    // this thread's units of the block's saved views (the multi-view mode)
    uint4* saved = nullptr;
    if constexpr (MULTI_VIEW)
      saved = fill.views.scratch + (int64_t)blockIdx.x * (ns - 1) * (NH * NI / 16) * CONSUMERS + tid;
    for (int it = 0; it < iters; ++it) {
      const ViewTile<MULTI_VIEW> vt(pts, (int64_t)it * gridDim.x + blockIdx.x);
      for (int v = 0; v < ns; ++v) {
        lin_in<NI, NH>(acc, h, p, pl, sbase + L.x, xfull, xempty, ph_x, rg, first);
        for (int blk = 0; blk < p.n_lin_z; ++blk) {
          if constexpr (MODE == MODE_TZ)
            inject_tz<NI, NH>(h, pl, base + L.z, zfull, zempty, ph_z);
          else
            inject_z<NI, NH>(acc, h, p, blk, pl, z_addr, zfull, zempty, ph_z, rg, first);
          residual_block<NI, NH>(acc, h, p, blk, pl, act, act_addr, rg, first);
        }
        if constexpr (MULTI_VIEW) {
          if (v < ns - 1)
            save_view<NI, NH>(h, saved + (int64_t)v * (NH * NI / 16) * CONSUMERS);
          else
            mean_views<NI, NH>(acc, h, saved, ns - 1, fill.views.mean_scale);
        }
      }
      for (int blk = p.n_lin_z; blk < p.n_blocks; ++blk)
        residual_block<NI, NH>(acc, h, p, blk, pl, act, act_addr, rg, first);
      head<NI, NH>(h, p, pl, act, act_addr, sbase + L.wout, wg, lane, row_a, vt.scene * pts + vt.p0,
                   (vt.scene + 1) * pts);
    }
  }
}

// ---- host side --------------------------------------------------------

// Launch `kernel` (a __global__ instance of mlp_block) as a persistent grid
// over n_tiles tiles, one block per SM or per tile if there are fewer, and
// no more than max_blocks if that is above 0. Returns the CUDA error of the
// launch (0 = success).
template <typename Kernel, typename... Args>
int launch_mlp_grid(Kernel kernel, const Params& p, int64_t n_tiles, int64_t max_blocks, cudaStream_t stream,
                    Args... args) {
  if (p.n == 0) return 0;
  const int smem = layout_of(p.kx, p.zw, p.dh, slab_columns(p.dh), p.stages).total;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  int64_t blocks = n_tiles < sms ? n_tiles : sms;
  if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The same over the (n + 63) / 64 tiles of n rows.
template <typename Kernel, typename... Args>
int launch_mlp(Kernel kernel, const Params& p, cudaStream_t stream, Args... args) {
  return launch_mlp_grid(kernel, p, (p.n + T - 1) / T, 0, stream, args...);
}

}  // namespace
