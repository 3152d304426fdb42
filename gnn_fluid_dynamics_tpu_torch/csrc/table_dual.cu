// K6, the dense-table dual apply, for Hopper (sm_90a).
//
// Replaces the TPU kernel of gnn_fluid_dynamics_tpu/ops/pallas_agg.py:
// _dual_kernel (banded_dual_pallas), which the GN block of a graph on the
// table route runs twice: on the es/er tables with combine_roll = H/2
// (aggregate_edges_to_vertices_pallas, the edge -> vertex sum) and on the
// cf row/col tables without (gather_face_cells_pallas, the owner/neighbour
// rows of each face).
//
// Per tile t of 128 target rows, with the tile's band of B source rows
// starting at src_off[t] (already a row of the batched source):
//
//   A = oh_a[t] @ src[src_off[t] : src_off[t] + B]
//   Bt = oh_b[t] @ the same band
//
// with every table weight first rounded to bf16 (the TPU kernel's
// oh.astype(band.dtype)), multiplied by the bf16 source row and accumulated
// in f32. The weights are not always 1 (vc stores 3 on padded cells), so the
// kernel multiplies by the stored weight. What it stores:
//
// * combine_roll (es/er): only the vertex sum, bf16(A[:, 0:64] +
//   Bt[:, 64:128]), as a (rows, 64) array. The TPU kernel stores the whole
//   A + roll(Bt, 64) row, but its consumer keeps lanes 0:64 only
//   (pallas_agg.py:471); this is K3's output, the same function on the
//   other representation.
// * otherwise (cf): two bf16 (rows, 128) arrays, A and Bt.
//
// The table tile is read as the graph carries it: int8, bf16 or f32.
// Zero weights are skipped rather than multiplied: a dense product gives
// 0 * NaN = NaN where this kernel gives 0, so the two agree on finite
// sources only (the rollout feeds finite latents, and the check holds every
// field finite).
//
// Bound: bytes, and the table's bytes above all (25.7 MB of int8 es/er and
// 42.7 MB of cf tables at the validation batch of two 13,696-cell meshes,
// against 10.7 and 7.0 MB of source rows). Design, simple first: one warp
// per target row, 8 rows per block (table.cuh). The warp reads the row's B
// table entries of both tables with 16-byte loads (one per lane per 512
// bytes), finds the nonzero entries with __ballot_sync, and for each of them
// all 32 lanes read the source row (256 B of bf16, or the 128 B half the
// roll keeps) and accumulate the weighted row in f32 registers, up to 8
// source rows in flight, the rows walked from the last (the pad vertex's
// row, which holds every padded face, is each graph's last). The TPU's band DMA and its one-hot x band MXU
// products are not carried over. No shared memory, no atomics: the sum is
// deterministic.
#include "table.cuh"

namespace gfd {

constexpr int H = 128;               // latent width
constexpr int HALF = H / 2;

template <typename T, bool ROLL>
__global__ void __launch_bounds__(TABLE_WARPS * 32)
table_dual_kernel(const T* __restrict__ oh_a, const T* __restrict__ oh_b,
                  const int* __restrict__ src_off,
                  const bf16* __restrict__ src, int n_rows, int band,
                  bf16* __restrict__ out_a, bf16* __restrict__ out_b) {
  // with the roll a lane keeps 2 channels of its table's half (a: 0:64,
  // b: 64:128), else 4 channels of the whole row
  constexpr int PAIRS = ROLL ? 1 : 2;
  // rows from the last: a graph's heaviest row (its pad slot) starts first
  const int row = n_rows - 1 - (blockIdx.x * TABLE_WARPS + threadIdx.x / 32);
  const int lane = threadIdx.x % 32;
  if (row < 0) return;
  float acc_a[2 * PAIRS] = {}, acc_b[2 * PAIRS] = {};
  apply_rows<T, PAIRS, 8>(oh_a + (size_t)row * band,
                                oh_b + (size_t)row * band, band, src, H,
                                (size_t)src_off[row / TABLE_TILE], lane, 0,
                                acc_a, ROLL ? HALF : 0, acc_b);
  if constexpr (ROLL) {
    reinterpret_cast<__nv_bfloat162*>(out_a + (size_t)row * HALF)[lane] =
        __floats2bfloat162_rn(acc_a[0] + acc_b[0], acc_a[1] + acc_b[1]);
  } else {
    __nv_bfloat162 a[2] = {__floats2bfloat162_rn(acc_a[0], acc_a[1]),
                           __floats2bfloat162_rn(acc_a[2], acc_a[3])};
    __nv_bfloat162 b[2] = {__floats2bfloat162_rn(acc_b[0], acc_b[1]),
                           __floats2bfloat162_rn(acc_b[2], acc_b[3])};
    reinterpret_cast<uint2*>(out_a + (size_t)row * H)[lane] =
        *reinterpret_cast<const uint2*>(a);
    reinterpret_cast<uint2*>(out_b + (size_t)row * H)[lane] =
        *reinterpret_cast<const uint2*>(b);
  }
}

template <typename T>
cudaError_t launch_table_dual(const void* oh_a, const void* oh_b,
                              const void* src_off, const void* src, int n_rows,
                              int band, int roll, void* out_a, void* out_b,
                              cudaStream_t stream) {
  const int blocks = (n_rows + TABLE_WARPS - 1) / TABLE_WARPS;
  if (roll)
    table_dual_kernel<T, true><<<blocks, TABLE_WARPS * 32, 0, stream>>>(
        (const T*)oh_a, (const T*)oh_b, (const int*)src_off, (const bf16*)src,
        n_rows, band, (bf16*)out_a, nullptr);
  else
    table_dual_kernel<T, false><<<blocks, TABLE_WARPS * 32, 0, stream>>>(
        (const T*)oh_a, (const T*)oh_b, (const int*)src_off, (const bf16*)src,
        n_rows, band, (bf16*)out_a, (bf16*)out_b);
  return cudaGetLastError();
}

}  // namespace gfd

// Launches K6 on `stream`; returns the CUDA error code (0 on success).
// table_dtype: 0 int8, 1 bf16, 2 f32. n_rows = tiles * 128; band is a
// multiple of 128. With roll, out_a is (n_rows, 64) and out_b unused.
extern "C" int gfd_table_dual(int device, const void* oh_a, const void* oh_b,
                              const void* src_off, const void* src, int n_rows,
                              int band, int table_dtype, int roll, void* out_a,
                              void* out_b, void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_rows == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (table_dtype) {
    case 0:
      return launch_table_dual<int8_t>(oh_a, oh_b, src_off, src, n_rows, band,
                                       roll, out_a, out_b, s);
    case 1:
      return launch_table_dual<bf16>(oh_a, oh_b, src_off, src, n_rows, band,
                                     roll, out_a, out_b, s);
    case 2:
      return launch_table_dual<float>(oh_a, oh_b, src_off, src, n_rows, band,
                                      roll, out_a, out_b, s);
    default:
      return cudaErrorInvalidValue;
  }
}
