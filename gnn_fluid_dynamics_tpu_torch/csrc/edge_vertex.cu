// K3, the edge -> vertex "twice message passing" sum, for Hopper (sm_90a).
//
// Replaces the TPU kernels of gnn_fluid_dynamics_tpu/ops/pallas_agg.py:
// _dual_colidx_kernel_chunk (banded_dual_colidx_chunked) and
// _dual_colidx_kernel (banded_dual_colidx_pallas), wrapped there by
// aggregate_edges_to_vertices_pallas.
//
// Vertex v sums, in f32, the forward halves (channels 0:64) of the edges it
// sends and the reverse halves (channels 64:128) of the edges it receives,
// and stores the sum as bf16 (V, 64). Viewing the (F, 128) edge latents as
// (2F, 64) half-rows, the incidences of v are the half-rows
// inc_row[inc_ptr[v] : inc_ptr[v + 1]] (2f + 0 sent, 2f + 1 received).
//
// The TPU kernel rebuilt send/receive one-hot tables on chip and multiplied
// them with a DMA'd band of edges. Here one warp owns one vertex and walks
// its CSR row, each lane adding 2 of the 64 channels: no atomics, so the sum
// is deterministic. Bound: bytes (each half-row is read once, ~2.7 MB per
// launch at the rollout's 5,361 faces); the launch is short enough that its
// fixed cost dominates at this size.
#include "common.cuh"

namespace gfd {

constexpr int HALF = H / 2;
constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
edge_vertex_kernel(const bf16* __restrict__ edge, const int* __restrict__ ptr,
                   const int* __restrict__ inc_row, int n_vertices,
                   bf16* __restrict__ out) {
  const int v = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (v >= n_vertices) return;
  float sx = 0.0f, sy = 0.0f;
  const int end = ptr[v + 1];
  for (int j = ptr[v]; j < end; ++j) {
    const float2 x = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(
        edge + (size_t)inc_row[j] * HALF)[lane]);
    sx += x.x;
    sy += x.y;
  }
  reinterpret_cast<__nv_bfloat162*>(out + (size_t)v * HALF)[lane] =
      __floats2bfloat162_rn(sx, sy);
}

}  // namespace gfd

// Launches K3 on `stream`; returns the CUDA error code (0 on success).
extern "C" int gfd_edge_vertex(int device, const void* edge, const void* ptr,
                               const void* inc_row, int n_vertices, void* out,
                               void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_vertices == 0) return cudaSuccess;
  const int blocks = (n_vertices + WARPS - 1) / WARPS;
  edge_vertex_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)edge, (const int*)ptr, (const int*)inc_row, n_vertices,
      (bf16*)out);
  return cudaGetLastError();
}
