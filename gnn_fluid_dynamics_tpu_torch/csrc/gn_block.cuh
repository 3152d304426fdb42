// Body of the fused cell-block kernel K2 (cell_block.cu); the face block K1
// runs on gn_wgmma.cuh. A tile of TILE rows, already gathered into shared
// memory as the bf16 rows A = [residual base | neighbours], goes through the
// block's MLP and LayerNorm without leaving the SM:
//
//   h0 = A @ W0 + b0 -> SiLU -> @ W1 + b1 -> SiLU -> @ W2 + b2
//   hn = LayerNorm(h), eps 1e-5, var = E[h^2] - mean^2
//   raw = bf16(hn), res = bf16(A[:, :H] + hn)
//
// Numerics follow the JAX package's _mlp_ln_tail (ops/pallas_agg.py:516):
// bf16 operands, f32 products and all elementwise math in f32, the hidden
// activations rounded to bf16 before each product, bf16 stores.
//
// Bound, as chip_smoke.py::bounds counts it: bytes. K2 at the FluxD mesh's
// 3,462 cells moves 3.06 MB (0.913 us at 3.35 TB/s) against 0.40 GFLOP of
// products (0.40 us at 989 TFLOP/s). The products run on the tensor cores
// through WMMA (16x16x16 bf16, f32 accumulate), one 16-row by 64-column
// strip per warp; the weights are read from global memory, where every
// block of the grid shares them through L1/L2. Keeping the three hidden
// activations in shared memory is what the fusion buys: nothing but the
// gathered inputs and the outputs touches device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace gfd {

constexpr int H = 128;               // latent width
constexpr int TILE = 32;             // rows per block
constexpr int THREADS = 128;         // 4 warps: 2 row strips x 2 column halves
constexpr int HF_LD = H + 4;         // row stride of the f32 staging tile
constexpr int HB_LD = H + 8;         // row stride of the bf16 activation tile

typedef __nv_bfloat16 bf16;

struct MlpWeights {
  const bf16* w0;  // (K0, H) row-major: inputs x outputs
  const bf16* b0;  // (H)
  const bf16* w1;  // (H, H)
  const bf16* b1;
  const bf16* w2;  // (H, H)
  const bf16* b2;
  const bf16* ln_g;
  const bf16* ln_b;
};

// Shared-memory layout for an input width K0; every region starts on a
// 32-byte boundary, as WMMA loads and stores require.
template <int K0>
struct Smem {
  static constexpr int A_LD = K0 + 8;  // +8 columns: rows off the bank stride
  static constexpr int a_bytes = TILE * A_LD * 2;
  static constexpr int hf_bytes = TILE * HF_LD * 4;
  static constexpr int hb_bytes = TILE * HB_LD * 2;
  static constexpr int total = a_bytes + hf_bytes + hb_bytes;
  static_assert(a_bytes % 32 == 0 && hf_bytes % 32 == 0, "alignment");
};

// out (TILE x H, f32) = A (TILE x K, bf16, row stride lda) @ W (K x H, bf16)
template <int K>
__device__ __forceinline__ void tile_matmul(const bf16* A, int lda,
                                            const bf16* __restrict__ W,
                                            float* out) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int rs = warp & 1;    // 16-row strip
  const int ch = warp >> 1;   // 64-column half
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    wmma::load_matrix_sync(a, A + rs * 16 * lda + k, lda);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::load_matrix_sync(b, W + k * H + ch * 64 + j * 16, H);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(out + rs * 16 * HF_LD + ch * 64 + j * 16, acc[j],
                            HF_LD, wmma::mem_row_major);
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// hb = bf16(silu(hf + bias))
__device__ __forceinline__ void bias_silu(const float* hf,
                                          const bf16* __restrict__ bias,
                                          bf16* hb) {
  for (int i = threadIdx.x; i < TILE * H; i += THREADS) {
    const int r = i / H, c = i % H;
    const float v = hf[r * HF_LD + c] + __bfloat162float(bias[c]);
    hb[r * HB_LD + c] = __float2bfloat16(silu(v));
  }
}

// The MLP, the LayerNorm and the stores of rows [row0, row0 + TILE) that are
// below n_rows. A holds the gathered inputs (row stride lda); its first H
// columns are the residual base. raw may be null (no dual output).
template <int K0>
__device__ __forceinline__ void mlp_ln_tail(const bf16* A, float* hf, bf16* hb,
                                            const MlpWeights& w, int row0,
                                            int n_rows, bf16* __restrict__ raw,
                                            bf16* __restrict__ res) {
  constexpr int lda = Smem<K0>::A_LD;
  tile_matmul<K0>(A, lda, w.w0, hf);
  __syncthreads();
  bias_silu(hf, w.b0, hb);
  __syncthreads();
  tile_matmul<H>(hb, HB_LD, w.w1, hf);
  __syncthreads();
  bias_silu(hf, w.b1, hb);
  __syncthreads();
  tile_matmul<H>(hb, HB_LD, w.w2, hf);
  __syncthreads();

  // LayerNorm: one warp per row, 4 columns per lane
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane * 4;
  float b2[4], g[4], be[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b2[j] = __bfloat162float(w.b2[c + j]);
    g[j] = __bfloat162float(w.ln_g[c + j]);
    be[j] = __bfloat162float(w.ln_b[c + j]);
  }
  for (int r = warp; r < TILE; r += THREADS / 32) {
    float v[4], s = 0.0f, ss = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = hf[r * HF_LD + c + j] + b2[j];
      s += v[j];
      ss += v[j] * v[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const int row = row0 + r;
    if (row >= n_rows) continue;  // warp-uniform
    const float mu = s / H;
    const float inv = rsqrtf(ss / H - mu * mu + 1e-5f);
    __align__(8) bf16 o_raw[4];
    __align__(8) bf16 o_res[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float hn = (v[j] - mu) * inv * g[j] + be[j];
      o_raw[j] = __float2bfloat16(hn);
      o_res[j] = __float2bfloat16(__bfloat162float(A[r * lda + c + j]) + hn);
    }
    if (raw != nullptr)
      *reinterpret_cast<uint2*>(raw + (size_t)row * H + c) =
          *reinterpret_cast<const uint2*>(o_raw);
    *reinterpret_cast<uint2*>(res + (size_t)row * H + c) =
        *reinterpret_cast<const uint2*>(o_res);
  }
}

}  // namespace gfd

// Name of a CUDA error code returned by one of the entry points.
extern "C" const char* gfd_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
