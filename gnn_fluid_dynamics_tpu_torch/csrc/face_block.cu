// K1, the fused face block of a GN block, for Hopper (sm_90a).
//
// Replaces the TPU kernels of gnn_fluid_dynamics_tpu/ops/pallas_agg.py:
// _fused_face_kernel_chunk (fused_face_tiles_chunked) and _fused_face_kernel
// (fused_face_tiles_pallas), wrapped there by fused_face_block_pallas.
//
// Per face f: [e_f | x[owner_f] | x[neighbour_f]] -> the MLP + LayerNorm tail
// of gn_block.cuh; out e_f + raw, and raw itself when raw_out is not null.
//
// The TPU kernel rebuilt the owner/neighbour rows as one-hot products over a
// DMA'd band of cells, because row gathers are slow there. Here each block
// gathers its 32 faces' rows directly (16-byte loads, the cell latents stay
// in L2 between blocks), so the only device-memory traffic is the edge
// latents in, the cell latents once, and the outputs. Bound: operations
// (0.88 GFLOP per launch at the rollout's 5,361 faces); see gn_block.cuh.
#include "gn_block.cuh"

namespace gfd {

constexpr int K_FACE = 3 * H;

__global__ void __launch_bounds__(THREADS)
face_block_kernel(const bf16* __restrict__ edge, const bf16* __restrict__ cells,
                  const int* __restrict__ owner, const int* __restrict__ nbr,
                  int n_faces, MlpWeights w, bf16* __restrict__ raw,
                  bf16* __restrict__ res) {
  using S = Smem<K_FACE>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* A = reinterpret_cast<bf16*>(smem);
  float* hf = reinterpret_cast<float*>(smem + S::a_bytes);
  bf16* hb = reinterpret_cast<bf16*>(smem + S::a_bytes + S::hf_bytes);
  const int row0 = blockIdx.x * TILE;

  // gather: 3 parts x 16 chunks of 8 bf16 per row; rows past the end are 0
  constexpr int CHUNKS = H / 8;
  for (int i = threadIdx.x; i < TILE * 3 * CHUNKS; i += THREADS) {
    const int r = i / (3 * CHUNKS), q = i % (3 * CHUNKS);
    const int part = q / CHUNKS, col = (q % CHUNKS) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_faces) {
      const bf16* src = part == 0 ? edge + (size_t)row * H
                      : cells + (size_t)(part == 1 ? owner[row] : nbr[row]) * H;
      val = *reinterpret_cast<const uint4*>(src + col);
    }
    *reinterpret_cast<uint4*>(A + r * S::A_LD + part * H + col) = val;
  }
  __syncthreads();
  mlp_ln_tail<K_FACE>(A, hf, hb, w, row0, n_faces, raw, res);
}

}  // namespace gfd

// Launches K1 on `stream`; returns the CUDA error code (0 on success).
extern "C" int gfd_face_block(int device, const void* edge, const void* cells,
                              const void* owner, const void* nbr, int n_faces,
                              const void* w0, const void* b0, const void* w1,
                              const void* b1, const void* w2, const void* b2,
                              const void* ln_g, const void* ln_b, void* raw,
                              void* res, void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  constexpr int smem = Smem<K_FACE>::total;
  err = cudaFuncSetAttribute(face_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (n_faces == 0) return cudaSuccess;
  const MlpWeights w{(const bf16*)w0, (const bf16*)b0, (const bf16*)w1,
                     (const bf16*)b1, (const bf16*)w2, (const bf16*)b2,
                     (const bf16*)ln_g, (const bf16*)ln_b};
  const int blocks = (n_faces + TILE - 1) / TILE;
  face_block_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)edge, (const bf16*)cells, (const int*)owner,
      (const int*)nbr, n_faces, w, (bf16*)raw, (bf16*)res);
  return cudaGetLastError();
}
