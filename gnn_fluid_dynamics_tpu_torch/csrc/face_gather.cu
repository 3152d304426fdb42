// K4, the owner/neighbour gather of the unfused GN block, for Hopper (sm_90a).
//
// Replaces the TPU kernel of gnn_fluid_dynamics_tpu/ops/pallas_agg.py:
// _dual_rowidx_kernel (banded_dual_rowidx_pallas), wrapped there by
// gather_face_cells_pallas.
//
// Per face f: own[f] = x[owner_f] and nbr[f] = x[neighbour_f], rows of the
// bf16 (C, 128) cell latents. The TPU kernel multiplied iota one-hot
// selectors with a DMA'd band of cells on the MXU, which copies each row
// exactly (one nonzero per output row, f32 accumulation). On Hopper a gather
// is an ordinary load, so this is a plain copy: bit-identical to its plain
// version.
//
// Bound: bytes. A launch reads the cell latents once (C * 256 B; a row that
// several faces share is served again from L2), the owner and neighbour ids
// (8 B per face), and writes 512 B per face: 3.67 MB at the rollout's 3,462
// cells and 5,361 faces, 1.1 us at 3.35 TB/s. Design: 16 threads per face,
// each moving one 16-byte chunk (8 bf16) of both rows, so every warp reads
// and writes whole 256-byte rows in 16-byte accesses. No shared memory and
// no products: the band DMA and the one-hot selectors are not carried over.
#include "common.cuh"

namespace gfd {

constexpr int ROW_CHUNKS = H / 8;                   // 16-byte chunks per row
constexpr int GATHER_THREADS = 256;
constexpr int FACES_PER_BLOCK = GATHER_THREADS / ROW_CHUNKS;

__global__ void __launch_bounds__(GATHER_THREADS)
face_gather_kernel(const bf16* __restrict__ cells, const int* __restrict__ owner,
                   const int* __restrict__ nbr, int n_faces,
                   bf16* __restrict__ own_out, bf16* __restrict__ nbr_out) {
  const int f = blockIdx.x * FACES_PER_BLOCK + threadIdx.x / ROW_CHUNKS;
  const int q = threadIdx.x % ROW_CHUNKS;
  if (f >= n_faces) return;
  const uint4* src = reinterpret_cast<const uint4*>(cells);
  const size_t dst = (size_t)f * ROW_CHUNKS + q;
  reinterpret_cast<uint4*>(own_out)[dst] = src[(size_t)owner[f] * ROW_CHUNKS + q];
  reinterpret_cast<uint4*>(nbr_out)[dst] = src[(size_t)nbr[f] * ROW_CHUNKS + q];
}

}  // namespace gfd

// Launches K4 on `stream`; returns the CUDA error code (0 on success).
extern "C" int gfd_face_gather(int device, const void* cells, const void* owner,
                               const void* nbr, int n_faces, void* own_out,
                               void* nbr_out, void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_faces == 0) return cudaSuccess;
  const int blocks = (n_faces + FACES_PER_BLOCK - 1) / FACES_PER_BLOCK;
  face_gather_kernel<<<blocks, GATHER_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)cells, (const int*)owner, (const int*)nbr, n_faces,
      (bf16*)own_out, (bf16*)nbr_out);
  return cudaGetLastError();
}
