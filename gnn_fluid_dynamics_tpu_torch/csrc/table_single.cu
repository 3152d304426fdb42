// K7, the dense-table single apply, for Hopper (sm_90a).
//
// Replaces the TPU kernel of gnn_fluid_dynamics_tpu/ops/pallas_agg.py:
// _single_kernel (banded_single_pallas), which the GN block of a graph on
// the table route runs once, on the vc table, wrapped there by
// aggregate_vertices_to_cells_pallas, together with that wrapper's
// epilogue.
//
// Per tile t of 128 cells, with the tile's band of B vertex rows starting
// at src_off[t] (already a row of the batched source), each cell's row is
//
//   s = oh[t] @ src[src_off[t] : src_off[t] + B]        (f32 accumulation)
//   out = f32(bf16(s)) / 3
//
// with every table weight first rounded to bf16, as the TPU kernel's
// oh.astype(band.dtype) does. The source is K6's bf16 (V, 64) vertex sum
// (the lanes the TPU wrapper keeps, pallas_agg.py:471). The TPU kernel
// stores bf16(s); its wrapper casts that to f32 and divides by 3
// (pallas_agg.py:471-473). This kernel stores the f32 mean, so the cast and
// division cost no launches of their own, with the wrapper's rounding
// points. The weights are not always 1: vc stores 3 on a padded cell whose
// three vertices are all the pad vertex, so the kernel multiplies by the
// stored weight. Zero weights are skipped, not multiplied: a dense product
// gives 0 * NaN = NaN where this kernel gives 0, so the two agree on finite
// sources, which is what the rollout feeds.
//
// Bound: bytes (10.5 MB of int8 vc tables, 1.8 MB of vertex rows and
// 7.0 MB of f32 means at the validation batch of two 13,696-cell meshes).
// Design, simple first (table.cuh): one warp per cell, 8 cells per block;
// the warp reads the row's table entries with 16-byte loads, finds the
// nonzeros with __ballot_sync, and all 32 lanes read each referenced vertex
// row (128 B), two at a time, and accumulate two channels each in f32.
#include "table.cuh"

namespace gfd {

constexpr int HALF = 64;             // the vertex sums' width

template <typename T>
__global__ void __launch_bounds__(TABLE_WARPS * 32)
table_single_kernel(const T* __restrict__ oh, const int* __restrict__ src_off,
                    const bf16* __restrict__ src, int n_rows, int band,
                    float* __restrict__ out) {
  // rows from the last: a graph's heaviest row (its pad slot) starts first
  const int row = n_rows - 1 - (blockIdx.x * TABLE_WARPS + threadIdx.x / 32);
  const int lane = threadIdx.x % 32;
  if (row < 0) return;
  float acc[2] = {};
  apply_rows<T, 1, false, 2>(oh + (size_t)row * band, nullptr, band, src,
                             HALF, (size_t)src_off[row / TABLE_TILE], lane, 0,
                             acc, 0, acc);
  const float2 r = __bfloat1622float2(__floats2bfloat162_rn(acc[0], acc[1]));
  reinterpret_cast<float2*>(out + (size_t)row * HALF)[lane] =
      make_float2(r.x / 3.0f, r.y / 3.0f);
}

template <typename T>
cudaError_t launch_table_single(const void* oh, const void* src_off,
                                const void* src, int n_rows, int band,
                                void* out, cudaStream_t stream) {
  const int blocks = (n_rows + TABLE_WARPS - 1) / TABLE_WARPS;
  table_single_kernel<T><<<blocks, TABLE_WARPS * 32, 0, stream>>>(
      (const T*)oh, (const int*)src_off, (const bf16*)src, n_rows, band,
      (float*)out);
  return cudaGetLastError();
}

}  // namespace gfd

// Launches K7 on `stream`; returns the CUDA error code (0 on success).
// table_dtype: 0 int8, 1 bf16, 2 f32. n_rows = tiles * 128; band is a
// multiple of 128; src is (S, 64) bf16, out (n_rows, 64) f32.
extern "C" int gfd_table_single(int device, const void* oh, const void* src_off,
                                const void* src, int n_rows, int band,
                                int table_dtype, void* out, void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_rows == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (table_dtype) {
    case 0:
      return launch_table_single<int8_t>(oh, src_off, src, n_rows, band, out, s);
    case 1:
      return launch_table_single<bf16>(oh, src_off, src, n_rows, band, out, s);
    case 2:
      return launch_table_single<float>(oh, src_off, src, n_rows, band, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}
