// K1, the fused face block of a GN block, for Hopper (sm_90a).
//
// Replaces the TPU kernels of gnn_fluid_dynamics_tpu/ops/pallas_agg.py:
// _fused_face_kernel_chunk (fused_face_tiles_chunked) and _fused_face_kernel
// (fused_face_tiles_pallas), wrapped there by fused_face_block_pallas.
//
// Per face f: [e_f | x[owner_f] | x[neighbour_f]] -> the MLP + LayerNorm tail
// of gn_wgmma.cuh; out e_f + raw, and raw itself when raw is not null.
//
// The TPU kernel rebuilt the owner/neighbour rows as one-hot products over a
// DMA'd band of cells, because row gathers are slow there. Here each block
// gathers its tile's 64 rows directly, 16-byte cp.async copies straight into
// the products' operand layout (the cell latents stay in L2 between blocks),
// so the only device-memory traffic is the edge latents in, the cell
// latents once, the weights and the outputs. Bound: bytes, 1.146 us at the
// FluxD mesh's 5,361 faces (gn_wgmma.cuh). The grid is persistent, at most
// one block per SM, each loading the weights into shared memory once and
// walking tiles blockIdx.x, blockIdx.x + gridDim.x, ...: 84 tiles at 5,361
// faces, 652 at the 41,728 of the validation batch.
#include "gn_wgmma.cuh"

namespace gfd {

constexpr int K_FACE = 3 * H;

__global__ void __launch_bounds__(THREADS, 1)
face_block_kernel(const bf16* __restrict__ edge, const bf16* __restrict__ cells,
                  const int* __restrict__ owner, const int* __restrict__ nbr,
                  int n_faces, const bf16* __restrict__ w0,
                  const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                  MlpVecs v, bf16* __restrict__ raw, bf16* __restrict__ res) {
  using L = TileSmem<K_FACE>;
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x == 0) load_weights<K_FACE>(smem, w0, w1, w2);
  const MlpVecs vs = load_vecs<K_FACE>(smem, v);
  __syncthreads();
  unsigned char* a_tile = smem + L::a_off;
  const uint32_t a_base = smem_addr(a_tile);
  const int tiles = (n_faces + ROWS - 1) / ROWS;
  // gather: 64 rows x 48 chunks of 16 bytes (3 parts of 16 chunks). A warp
  // takes 8 rows x 4 neighbouring chunks at a time; a thread, 2 rows x 12
  // chunks, its rows' indices loaded once. Chunk (row r, column block kc)
  // goes to its 8 x 8 core matrix (gn_wgmma.cuh). Rows past the end are 0.
  const int r_lo = threadIdx.x & 7, kq = (threadIdx.x >> 3) & 3;
  const int rg = threadIdx.x >> 5;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * ROWS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * (rg + 4 * h);
      const int row = row0 + r;
      const bool live = row < n_faces;
      const bf16* src[3];
      if (live) {
        src[0] = edge + (size_t)row * H;
        src[1] = cells + (size_t)owner[row] * H;
        src[2] = cells + (size_t)nbr[row] * H;
      }
#pragma unroll
      for (int kg = 0; kg < K_FACE / 32; ++kg) {
        const int kc = kq + 4 * kg;
        const int dst = (kc * (ROWS / 8) + r / 8) * 128 + (r % 8) * 16;
        if (live)
          cp_async16(a_base + dst, src[kg / 4] + (kq + 4 * (kg % 4)) * 8);
        else
          *reinterpret_cast<uint4*>(a_tile + dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    mlp_ln_tile<K_FACE>(smem, vs, row0, n_faces, raw, res);
    __syncthreads();
  }
}

}  // namespace gfd

// Launches K1 on `stream`; returns the CUDA error code (0 on success).
// w0, w1, w2 are the packed weights (ops/kernels.py::pack_weights).
extern "C" int gfd_face_block(int device, const void* edge, const void* cells,
                              const void* owner, const void* nbr, int n_faces,
                              const void* w0, const void* b0, const void* w1,
                              const void* b1, const void* w2, const void* b2,
                              const void* ln_g, const void* ln_b, void* raw,
                              void* res, void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  constexpr int smem = TileSmem<K_FACE>::total;
  static std::atomic<uint64_t> opted_in{0};
  err = smem_opt_in_once((const void*)face_block_kernel, device, smem,
                         opted_in);
  if (err != cudaSuccess) return err;
  if (n_faces == 0) return cudaSuccess;
  const int sms = sm_count(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  const MlpVecs v{(const bf16*)b0, (const bf16*)b1, (const bf16*)b2,
                  (const bf16*)ln_g, (const bf16*)ln_b};
  const int tiles = (n_faces + ROWS - 1) / ROWS;
  const int blocks = tiles < sms ? tiles : sms;
  face_block_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)edge, (const bf16*)cells, (const int*)owner,
      (const int*)nbr, n_faces, (const bf16*)w0, (const bf16*)w1,
      (const bf16*)w2, v, (bf16*)raw, (bf16*)res);
  return cudaGetLastError();
}
