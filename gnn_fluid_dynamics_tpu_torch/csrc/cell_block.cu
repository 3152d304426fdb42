// K2, the fused cell block of a GN block, for Hopper (sm_90a).
//
// Replaces the TPU kernels of gnn_fluid_dynamics_tpu/ops/pallas_agg.py:
// _fused_cell_kernel_chunk (fused_cell_tiles_chunked) and _fused_cell_kernel
// (fused_cell_tiles_pallas), wrapped there by fused_cell_block_pallas.
//
// Per cell c with vertices (i0, i1, i2):
//   agg = bf16((v[i0] + v[i1] + v[i2]) * (1/3))   (64 channels, f32 sum)
//   [c | agg] -> the MLP + LayerNorm tail of gn_block.cuh; out c + raw, and
//   raw itself when raw_out is not null.
// v is the (V, 64) bf16 vertex sum of K3 (edge_vertex.cu).
//
// The TPU kernel built the 3-vertex mean as a one-hot product over a DMA'd
// band of vertices; here each block gathers its cells' three vertex rows
// directly. Bound: operations (0.40 GFLOP per launch at the rollout's 3,462
// cells); see gn_block.cuh.
#include "gn_block.cuh"

namespace gfd {

constexpr int H2 = H / 2;
constexpr int K_CELL = H + H2;

__global__ void __launch_bounds__(THREADS)
cell_block_kernel(const bf16* __restrict__ cells, const bf16* __restrict__ vtx,
                  const int* __restrict__ v0, const int* __restrict__ v1,
                  const int* __restrict__ v2, int n_cells, MlpWeights w,
                  bf16* __restrict__ raw, bf16* __restrict__ res) {
  using S = Smem<K_CELL>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* A = reinterpret_cast<bf16*>(smem);
  float* hf = reinterpret_cast<float*>(smem + S::a_bytes);
  bf16* hb = reinterpret_cast<bf16*>(smem + S::a_bytes + S::hf_bytes);
  const int row0 = blockIdx.x * TILE;

  // the cell latents: 16 chunks of 8 bf16 per row; rows past the end are 0
  constexpr int CHUNKS = H / 8;
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, col = (i % CHUNKS) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_cells)
      val = *reinterpret_cast<const uint4*>(cells + (size_t)row * H + col);
    *reinterpret_cast<uint4*>(A + r * S::A_LD + col) = val;
  }
  // the 3-vertex mean: 32 pairs of channels per row
  constexpr int PAIRS = H2 / 2;
  for (int i = threadIdx.x; i < TILE * PAIRS; i += THREADS) {
    const int r = i / PAIRS, c = (i % PAIRS) * 2;
    const int row = row0 + r;
    float2 m = make_float2(0.0f, 0.0f);
    if (row < n_cells) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vtx + (size_t)v0[row] * H2 + c));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vtx + (size_t)v1[row] * H2 + c));
      const float2 d = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vtx + (size_t)v2[row] * H2 + c));
      const float third = 1.0f / 3.0f;
      m.x = (a.x + b.x + d.x) * third;
      m.y = (a.y + b.y + d.y) * third;
    }
    *reinterpret_cast<__nv_bfloat162*>(A + r * S::A_LD + H + c) =
        __floats2bfloat162_rn(m.x, m.y);
  }
  __syncthreads();
  mlp_ln_tail<K_CELL>(A, hf, hb, w, row0, n_cells, raw, res);
}

}  // namespace gfd

// Launches K2 on `stream`; returns the CUDA error code (0 on success).
extern "C" int gfd_cell_block(int device, const void* cells, const void* vtx,
                              const void* v0, const void* v1, const void* v2,
                              int n_cells, const void* w0, const void* b0,
                              const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* ln_g,
                              const void* ln_b, void* raw, void* res,
                              void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  constexpr int smem = Smem<K_CELL>::total;
  err = cudaFuncSetAttribute(cell_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (n_cells == 0) return cudaSuccess;
  const MlpWeights w{(const bf16*)w0, (const bf16*)b0, (const bf16*)w1,
                     (const bf16*)b1, (const bf16*)w2, (const bf16*)b2,
                     (const bf16*)ln_g, (const bf16*)ln_b};
  const int blocks = (n_cells + TILE - 1) / TILE;
  cell_block_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)cells, (const bf16*)vtx, (const int*)v0, (const int*)v1,
      (const int*)v2, n_cells, w, (bf16*)raw, (bf16*)res);
  return cudaGetLastError();
}
