// The MLP + LayerNorm tail of the fused GN-block kernels on Hopper's
// warpgroup tensor-core products, for a tile of 64 rows whose bf16 inputs
// A = [residual base | neighbours] (64 x K0) are already in shared memory:
//
//   h0 = A @ W0 + b0 -> SiLU -> @ W1 + b1 -> SiLU -> @ W2 + b2
//   hn = LayerNorm(h), eps 1e-5, var = E[h^2] - mean^2 (unclamped)
//   raw = bf16(hn), res = bf16(A[:, :128] + hn)
//
// Numerics follow the JAX package's _mlp_ln_tail (ops/pallas_agg.py:516):
// bf16 operands, f32 products and all elementwise math in f32, the hidden
// activations rounded to bf16 before each product, bf16 stores. Templated on
// the input width K0: K1 (face_block.cu) runs it at K0 = 384, K2
// (cell_block.cu) at K0 = 192.
//
// Design. One warpgroup (4 warps, 128 threads) per block, one block per SM.
// W0, W1 and W2 sit in shared memory for the block's whole life: three bulk
// asynchronous copies on three mbarriers, issued before the first tile's
// gather so that they overlap it, each waited for just before its product.
// The weights arrive already in the layout the products read (packed once
// per model on the host, ops/kernels.py::pack_weights), so the copies are
// plain contiguous ones; the five bias and LayerNorm vectors are copied to
// shared memory too. Each product is a chain of wgmma m64n128k16 (bf16 x
// bf16 -> f32) with the 64 x 128 accumulator in registers, 64 f32 per
// thread, its partial sums added into a second f32 accumulator every
// PROMOTE k steps. The first reads A from shared memory; bias and SiLU are
// applied in registers, and the result, rounded to bf16, is the next
// product's A straight from the registers: a warp's accumulator rows and
// columns for 16 columns are exactly its m16n8k16 A fragment. LayerNorm
// takes each row's 128 values from the accumulators: they lie in the 4
// threads of a quad, so the sums take two shuffles. The residual is read
// from A; both outputs go through a padded shared tile, so every store to
// device memory is 16 bytes.
//
// What bounds it, measured for K1 (PERF.md §6): every SM takes in the
// weights (160 KB for K1, 112 KB for K2) plus its tile before the first
// product, and then runs dependent phases with one warpgroup; latency, not
// bytes or operations.
//
// Operand layout in shared memory ("core matrices", no swizzle): an
// operand of R rows (M for A, N for the weights) and K columns, K-major, is
// stored as 8 x 8 blocks of 128 contiguous bytes, element (row, k) at byte
//   ((k / 8) * (R / 8) + row / 8) * 128 + (row % 8) * 16 + (k % 8) * 2,
// so a descriptor's leading byte offset (the next 8 columns of k) is
// R * 16 and its stride byte offset (the next 8 rows) is 128.
//
// Bound, as chip_smoke.py counts it: bytes for both kernels at the FluxD
// mesh (K1 1.146 us at 5,361 faces, K2 0.913 us at 3,462 cells), the
// products close behind (0.89 and 0.40 us at 989 TFLOP/s); either way the
// floor is a microsecond, and what the kernels have to beat is latency:
// the weights' trip from L2, the gather, and three dependent product chains
// per tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "common.cuh"
#include "wgmma.cuh"

namespace gfd {

constexpr int ROWS = 64;            // rows per tile: one wgmma M
constexpr int THREADS = 128;        // one warpgroup
constexpr int OUT_LD = H * 2 + 16;  // bytes per row of an output tile
// k steps (of 16) whose products the tensor cores sum before the partial
// sum is added into the f32 accumulator in registers: the tensor cores'
// own f32 accumulation over a whole chain was measured less accurate than
// the plain version's (PERF.md §6)
constexpr int PROMOTE = 4;

// Shared memory for input width K0: the weights, A, the output tiles, the
// bias and LayerNorm vectors and three mbarriers. The raw output's tile
// reuses A's columns past the residual base where they have room (free once
// the first product is done).
template <int K0>
struct TileSmem {
  static_assert(K0 % 16 == 0 && K0 > H, "input width");
  static constexpr int w0_bytes = K0 * H * 2;
  static constexpr int w_bytes = w0_bytes + 2 * H * H * 2;
  static constexpr int a_off = w_bytes;
  static constexpr int a_bytes = ROWS * K0 * 2;
  static constexpr int out_bytes = ROWS * OUT_LD;
  static constexpr int res_off = a_off + a_bytes;
  static constexpr bool raw_in_a = (K0 - H) * ROWS * 2 >= out_bytes;
  static constexpr int raw_off =
      raw_in_a ? a_off + H * ROWS * 2 : res_off + out_bytes;
  static constexpr int vec_off = res_off + (raw_in_a ? 1 : 2) * out_bytes;
  static constexpr int bar_off = vec_off + 5 * H * 2;
  static constexpr int total = bar_off + 3 * 8;
  static_assert(total <= 232448, "more shared memory than a block can have");
};

// The bias and LayerNorm vectors, (H) bf16 each.
struct MlpVecs {
  const bf16* b0;
  const bf16* b1;
  const bf16* b2;
  const bf16* ln_g;
  const bf16* ln_b;
};

// A no-swizzle, K-major wgmma operand descriptor.
// Bits 0-13: start address / 16; 16-29: leading byte offset / 16 (the next
// 8 columns of k); 32-45: stride byte offset / 16 (the next 8 rows);
// 62-63: 0, no swizzle.
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint32_t sbo = 128;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// The fast exponential and division (a few f32 ulps): with one warpgroup
// per SM the IEEE forms' instruction sequences, 64 values per thread, were
// the tail's largest phase (PERF.md §6).
__device__ __forceinline__ float silu(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 vec_pair(const bf16* v, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v + col));
}

// d += bias, SiLU, then d rounded to bf16 as the next product's A: for
// k-step kk, a[kk] holds columns 16kk..16kk+15 of this thread's rows. The
// accumulator's element 4i + (0, 1) is row g, columns 8i + 2q (+1), and
// 4i + (2, 3) the same columns of row g + 8 (g = lane / 4, q = lane % 4).
__device__ __forceinline__ void bias_silu_to_a(float* d, const bf16* bias,
                                               int q, uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < H / 8; ++i) {
    const float2 b = vec_pair(bias, 8 * i + 2 * q);
    d[4 * i] = silu(d[4 * i] + b.x);
    d[4 * i + 1] = silu(d[4 * i + 1] + b.y);
    d[4 * i + 2] = silu(d[4 * i + 2] + b.x);
    d[4 * i + 3] = silu(d[4 * i + 3] + b.y);
  }
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
}

// All threads, once per block: the five (H) vectors into shared memory;
// returns them there. Visible after the next __syncthreads.
template <int K0>
__device__ __forceinline__ MlpVecs load_vecs(unsigned char* smem,
                                             const MlpVecs& v) {
  bf16* dst = reinterpret_cast<bf16*>(smem + TileSmem<K0>::vec_off);
  const bf16* src[5] = {v.b0, v.b1, v.b2, v.ln_g, v.ln_b};
#pragma unroll
  for (int j = 0; j < 5; ++j)
    if (threadIdx.x < H / 8)
      reinterpret_cast<uint4*>(dst + j * H)[threadIdx.x] =
          reinterpret_cast<const uint4*>(src[j])[threadIdx.x];
  return MlpVecs{dst, dst + H, dst + 2 * H, dst + 3 * H, dst + 4 * H};
}

// Thread 0 only, once per block: the barriers and the weights' copies.
// w0, w1, w2 are packed (pack_weights), K0 x H, H x H, H x H bf16.
template <int K0>
__device__ __forceinline__ void load_weights(unsigned char* smem,
                                             const bf16* w0, const bf16* w1,
                                             const bf16* w2) {
  using L = TileSmem<K0>;
  constexpr uint32_t hh = H * H * 2;
  const uint32_t bar = smem_addr(smem + L::bar_off);
  const uint32_t w = smem_addr(smem);
  for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
  fence_barrier_init();
  mbar_expect_tx(bar, L::w0_bytes);
  bulk_copy(w, w0, L::w0_bytes, bar);
  mbar_expect_tx(bar + 8, hh);
  bulk_copy(w + L::w0_bytes, w1, hh, bar + 8);
  mbar_expect_tx(bar + 16, hh);
  bulk_copy(w + L::w0_bytes + hh, w2, hh, bar + 16);
}

// One tile: A (rows row0.., already in shared memory, made visible to the
// async proxy and synchronised) through the MLP and LayerNorm; stores the
// rows below n_rows. raw may be null (no dual output). Ends with the
// stores issued; the caller synchronises before A is written again.
template <int K0>
__device__ __forceinline__ void mlp_ln_tile(unsigned char* smem,
                                            const MlpVecs& v, int row0,
                                            int n_rows, bf16* __restrict__ raw,
                                            bf16* __restrict__ res) {
  using L = TileSmem<K0>;
  constexpr uint32_t a_lbo = ROWS * 16, w_lbo = H * 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const uint32_t w_base = smem_addr(smem);
  const uint32_t a_base = smem_addr(smem + L::a_off);
  const uint32_t bar = smem_addr(smem + L::bar_off);
  float d[64];
  uint32_t a[H / 16][4];

  // h0 = A @ W0
  mbar_wait(bar, 0);
  float t[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
#pragma unroll
  for (int s0 = 0; s0 < K0 / 16; s0 += PROMOTE) {
    wgmma_fence();
#pragma unroll
    for (int s = s0; s < s0 + PROMOTE && s < K0 / 16; ++s)
      wgmma_ss(t, operand_desc(a_base + 2 * s * a_lbo, a_lbo),
               operand_desc(w_base + 2 * s * w_lbo, w_lbo), s > s0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(t);
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] += t[i];
  }
  bias_silu_to_a(d, v.b0, q, a);

  // h1 = silu(h0) @ W1, then h2 = silu(h1) @ W2
#pragma unroll
  for (int layer = 1; layer < 3; ++layer) {
    const uint32_t w = w_base + L::w0_bytes + (layer - 1) * H * H * 2;
    mbar_wait(bar + 8 * layer, 0);
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < H / 16; k0 += PROMOTE) {
      wgmma_fence();
#pragma unroll
      for (int kk = k0; kk < k0 + PROMOTE && kk < H / 16; ++kk)
        wgmma_rs(t, a[kk], operand_desc(w + 2 * kk * w_lbo, w_lbo), kk > k0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(t);
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] += t[i];
    }
    if (layer == 1) bias_silu_to_a(d, v.b1, q, a);
  }

  // + b2, LayerNorm over each row's 128 columns (a quad's 4 threads)
  float s[2] = {0.0f, 0.0f}, ss[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < H / 8; ++i) {
    const float2 b = vec_pair(v.b2, 8 * i + 2 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      d[4 * i + 2 * h] += b.x;
      d[4 * i + 2 * h + 1] += b.y;
      s[h] += d[4 * i + 2 * h] + d[4 * i + 2 * h + 1];
      ss[h] += d[4 * i + 2 * h] * d[4 * i + 2 * h] +
               d[4 * i + 2 * h + 1] * d[4 * i + 2 * h + 1];
    }
  }
  float mu[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], o);
      ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], o);
    }
    mu[h] = s[h] / H;
    inv[h] = rsqrtf(ss[h] / H - mu[h] * mu[h] + 1e-5f);
  }

  // the outputs into their shared tiles; the residual base from A
  unsigned char* res_tile = smem + L::res_off;
  unsigned char* raw_tile = smem + L::raw_off;
  const unsigned char* a_tile = smem + L::a_off;
#pragma unroll
  for (int i = 0; i < H / 8; ++i) {
    const int col = 8 * i + 2 * q;
    const float2 gm = vec_pair(v.ln_g, col), be = vec_pair(v.ln_b, col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + 8 * h + g;  // row in the tile
      const float x0 = (d[4 * i + 2 * h] - mu[h]) * inv[h] * gm.x + be.x;
      const float x1 = (d[4 * i + 2 * h + 1] - mu[h]) * inv[h] * gm.y + be.y;
      const float2 e = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          a_tile + (i * (ROWS / 8) + r / 8) * 128 + (r % 8) * 16 + 4 * q));
      *reinterpret_cast<uint32_t*>(res_tile + r * OUT_LD + 2 * col) =
          pack_bf16(e.x + x0, e.y + x1);
      if (raw != nullptr)
        *reinterpret_cast<uint32_t*>(raw_tile + r * OUT_LD + 2 * col) =
            pack_bf16(x0, x1);
    }
  }
  __syncthreads();
  // 16-byte stores: 16 threads per row
  for (int i = threadIdx.x; i < ROWS * H / 8; i += THREADS) {
    const int r = i / (H / 8), c = i % (H / 8);
    const int row = row0 + r;
    if (row >= n_rows) continue;
    *reinterpret_cast<uint4*>(res + (size_t)row * H + 8 * c) =
        *reinterpret_cast<const uint4*>(res_tile + r * OUT_LD + 16 * c);
    if (raw != nullptr)
      *reinterpret_cast<uint4*>(raw + (size_t)row * H + 8 * c) =
          *reinterpret_cast<const uint4*>(raw_tile + r * OUT_LD + 16 * c);
  }
}

}  // namespace gfd
