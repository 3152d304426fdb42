// K5, the 3-vertex cell mean of the unfused GN block, for Hopper (sm_90a).
//
// Replaces the TPU kernel of gnn_fluid_dynamics_tpu/ops/pallas_agg.py:
// _rowidx3_kernel (banded_rowidx3_pallas), wrapped there by
// aggregate_vertices_to_cells_pallas, together with that wrapper's epilogue.
//
// Per cell c with vertices v0, v1, v2 (vertex_face): the f32 sum
// (x[v0] + x[v1]) + x[v2] of three rows of K3's bf16 (V, HALF) vertex sums
// (HALF 64, or 128 behind K3's wide form: a template parameter),
// rounded to bf16 (the TPU kernel's output dtype is its source's), then
// divided by 3 in f32 (pallas_agg.py:471-473). The kernel stores that f32
// mean, so the wrapper's cast and division cost no launches of their own;
// the rounding points are the TPU wrapper's.
//
// What bounds it: not bytes. A launch reads the vertex sums once (V * 128
// B), the three vertex ids (12 B per cell) and writes 256 B per cell: 1.17
// MB at the rollout's 1,899 vertices and 3,462 cells, 0.35 us at 3.35 TB/s.
// Each cell is two dependent round trips (its vertex ids, then its three
// rows), and the launch's fixed cost is most of its time. Design: HALF / 8
// threads per cell (8, or 16 at HALF 128), each summing one 16-byte chunk
// (8 bf16) of the three rows in f32 registers and storing 32 bytes of the
// f32 mean. It is launched by
// programmatic dependent launch (pdl.cuh) behind K3: a thread loads its
// cell's vertex ids (a constant index vector) while K3 still runs, waits,
// and then issues its three row loads and its stores. No shared memory and
// no products: the band DMA and the one-hot selectors are not carried over.
#include "common.cuh"
#include "pdl.cuh"

namespace gfd {

constexpr int MEAN_THREADS = 256;

template <int HALF>
__global__ void __launch_bounds__(MEAN_THREADS)
vertex_cell_kernel(const bf16* vtx, const int* __restrict__ v0,
                   const int* __restrict__ v1, const int* __restrict__ v2,
                   int n_cells, float* out) {
  constexpr int VTX_CHUNKS = HALF / 8;               // 16-byte chunks per row
  constexpr int CELLS_PER_BLOCK = MEAN_THREADS / VTX_CHUNKS;
  const int c = blockIdx.x * CELLS_PER_BLOCK + threadIdx.x / VTX_CHUNKS;
  const int q = threadIdx.x % VTX_CHUNKS;
  int i0 = 0, i1 = 0, i2 = 0;  // before the wait: the constant vertex ids
  if (c < n_cells) {
    i0 = v0[c];
    i1 = v1[c];
    i2 = v2[c];
  }
  pdl_wait();
  if (c >= n_cells) return;
  const uint4* src = reinterpret_cast<const uint4*>(vtx);
  const uint4 a = src[(size_t)i0 * VTX_CHUNKS + q];
  const uint4 b = src[(size_t)i1 * VTX_CHUNKS + q];
  const uint4 d = src[(size_t)i2 * VTX_CHUNKS + q];
  const bf16* pa = reinterpret_cast<const bf16*>(&a);
  const bf16* pb = reinterpret_cast<const bf16*>(&b);
  const bf16* pd = reinterpret_cast<const bf16*>(&d);
  float m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s = __bfloat162float(pa[j]) + __bfloat162float(pb[j]);
    s += __bfloat162float(pd[j]);
    m[j] = __bfloat162float(__float2bfloat16(s)) / 3.0f;
  }
  float4* dst = reinterpret_cast<float4*>(out + (size_t)c * HALF + q * 8);
  dst[0] = make_float4(m[0], m[1], m[2], m[3]);
  dst[1] = make_float4(m[4], m[5], m[6], m[7]);
}

}  // namespace gfd

// Launches K5 on `stream` for (V, half) vertex sums, half 64 or 128;
// returns the CUDA error code (0 on success).
extern "C" int gfd_vertex_cell(int device, const void* vtx, const void* v0,
                               const void* v1, const void* v2, int n_cells,
                               int half, void* out, void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (half != H / 2 && half != H) return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  const int cells_per_block = MEAN_THREADS / (half / 8);
  const int blocks = (n_cells + cells_per_block - 1) / cells_per_block;
  return launch_pdl(half == H / 2 ? vertex_cell_kernel<H / 2>
                                  : vertex_cell_kernel<H>,
                    dim3(blocks), dim3(MEAN_THREADS), (cudaStream_t)stream,
                    (const bf16*)vtx, (const int*)v0, (const int*)v1,
                    (const int*)v2, n_cells, (float*)out);
}
