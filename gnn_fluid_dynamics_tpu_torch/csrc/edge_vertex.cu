// K3, the edge -> vertex "twice message passing" sum, for Hopper (sm_90a).
//
// Replaces the TPU kernels of gnn_fluid_dynamics_tpu/ops/pallas_agg.py:
// _dual_colidx_kernel_chunk (banded_dual_colidx_chunked) and
// _dual_colidx_kernel (banded_dual_colidx_pallas), wrapped there by
// aggregate_edges_to_vertices_pallas.
//
// Vertex v sums, in f32, the forward halves (channels 0:W/2) of the edges it
// sends and the reverse halves (channels W/2:W) of the edges it receives,
// and stores the sum as bf16 (V, W/2). Viewing the (F, W) edge latents as
// (2F, W/2) half-rows, the incidences of v are the half-rows
// inc_row[inc_ptr[v] : inc_ptr[v + 1]] (2f + 0 sent, 2f + 1 received). W is
// 128 (every model's GN block) or 256 (ConservativeH/J/K, whose twice
// message passing takes [e_s | e_s] of their 128-wide symmetric latents);
// the half-row width is a template parameter, one instantiation per width.
//
// The TPU kernel rebuilt send/receive one-hot tables on chip and multiplied
// them with a DMA'd band of edges. Here one warp owns one vertex; no
// atomics, so the sum is deterministic.
//
// What bounds it: not bytes. A launch at the rollout's mesh moves 1.7 MB
// (10,722 half-rows of 128 B, 0.5 us at 3.35 TB/s), but each vertex is a
// chain of dependent loads (row bounds, then incidence ids, then half-rows)
// and the launch's fixed cost is most of its time. The design shortens the
// chain and hides what it can:
//  * a round brings 32 incidence ids in one coalesced load, one per lane;
//    the half-rows go as 16-byte loads, HALF / 8 lanes per half-row (8 at
//    W = 128, 16 at W = 256), 32 / (HALF / 8) half-rows per pass (4 or 2),
//    all passes of a round issued before any is summed, with the next
//    round's ids already in flight (rows past 32, as the pad vertex of a
//    padded graph has, take more rounds);
//  * it is launched by programmatic dependent launch (pdl.cuh): a warp's
//    row bounds and first ids, constant index vectors, load while the
//    kernel before it finishes, and K5 may start once every block of it
//    has started.
#include "common.cuh"
#include "pdl.cuh"

namespace gfd {

constexpr int ROUND = 32;                      // incidence ids per round

// A warp's layout for half-rows of HALF channels: ROW_LANES lanes of 16 B
// per half-row, ROWS_PER_PASS half-rows per warp load, PASSES loads a round.
template <int HALF>
struct Rows {
  static constexpr int ROW_LANES = HALF / 8;
  static constexpr int ROWS_PER_PASS = 32 / ROW_LANES;
  static constexpr int PASSES = ROUND / ROWS_PER_PASS;
  static_assert(ROW_LANES == 8 || ROW_LANES == 16, "HALF is 64 or 128");
};
constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void add_bf16x8(float (&s)[8], const uint4& x) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(p[k]);
    s[2 * k] += f.x;
    s[2 * k + 1] += f.y;
  }
}

// The f32 sum of the half-rows edge[inc_row[j]], j in [start, end), in
// channels 8q .. 8q + 7 (q = lane % ROW_LANES), left in every lane. `ids`
// holds the first round's ids (lane l: inc_row[start + l], where that lies
// below end). Lane group g = lane / ROW_LANES sums each round's incidences
// g, g + ROWS_PER_PASS, ... in order; the groups' sums meet by shuffles in
// a fixed order (xor 8 then 16 at HALF 64, xor 16 at HALF 128), so every
// run gives the same bits.
template <int HALF>
__device__ __forceinline__ void vertex_sum(const bf16* edge,
                                           const int* __restrict__ inc_row,
                                           int start, int end, int ids,
                                           int lane, float (&s)[8]) {
  using R = Rows<HALF>;
  const int g = lane / R::ROW_LANES, q = lane % R::ROW_LANES;
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = 0.0f;
  for (int base = start; base < end; base += ROUND) {
    const int next = base + ROUND + lane;
    const int next_ids = next < end ? inc_row[next] : 0;
    const int n = min(end - base, ROUND);
    uint4 x[R::PASSES];
#pragma unroll
    for (int p = 0; p < R::PASSES; ++p) {
      const int i = p * R::ROWS_PER_PASS + g;
      const int row = __shfl_sync(FULL, ids, i);
      x[p] = i < n ? reinterpret_cast<const uint4*>(edge + (size_t)row * HALF)[q]
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int p = 0; p < R::PASSES; ++p) add_bf16x8(s, x[p]);  // + 0 is exact
    ids = next_ids;
  }
#pragma unroll
  for (int m = R::ROW_LANES; m < 32; m *= 2)
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] += __shfl_xor_sync(FULL, s[k], m);
}

template <int HALF>
__global__ void __launch_bounds__(WARPS * 32)
edge_vertex_kernel(const bf16* edge, const int* __restrict__ ptr,
                   const int* __restrict__ inc_row, int n_vertices,
                   bf16* out) {
  pdl_launch_dependents();
  const int lane = threadIdx.x % 32;
  const int v = blockIdx.x * WARPS + threadIdx.x / 32;
  // constant index vectors only, before the wait: the row bounds, first ids
  int start = 0, end = 0, ids = 0;
  if (v < n_vertices) {
    start = ptr[v];
    end = ptr[v + 1];
    if (start + lane < end) ids = inc_row[start + lane];
  }
  pdl_wait();
  if (v >= n_vertices) return;
  float s[8];
  vertex_sum<HALF>(edge, inc_row, start, end, ids, lane, s);
  if (lane < Rows<HALF>::ROW_LANES) {
    uint4 o;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      p[k] = __floats2bfloat162_rn(s[2 * k], s[2 * k + 1]);
    reinterpret_cast<uint4*>(out + (size_t)v * HALF)[lane] = o;
  }
}

// An empty kernel that keeps the PDL rules, for the launch floor.
__global__ void launch_floor_kernel() {
  pdl_launch_dependents();
  pdl_wait();
}

// The writer of the PDL hazard check: lets a PDL launch behind it start at
// once, idles for `cycles` clock cycles, then writes dst = src, negated
// when `negate`. A kernel behind it that read dst before its wait would
// read the previous round's values.
__global__ void slow_writer_kernel(const bf16* src, int n, int negate,
                                   int cycles, bf16* dst) {
  pdl_launch_dependents();
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    dst[i] = negate ? __hneg(src[i]) : src[i];
}

}  // namespace gfd

// Launches K3 on `stream` for (F, width) edge latents, width 128 or 256;
// returns the CUDA error code (0 on success).
extern "C" int gfd_edge_vertex(int device, const void* edge, const void* ptr,
                               const void* inc_row, int n_vertices, int width,
                               void* out, void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (width != H && width != 2 * H) return cudaErrorInvalidValue;
  if (n_vertices == 0) return cudaSuccess;
  const int blocks = (n_vertices + WARPS - 1) / WARPS;
  return launch_pdl(width == H ? edge_vertex_kernel<H / 2>
                               : edge_vertex_kernel<H>,
                    dim3(blocks), dim3(WARPS * 32), (cudaStream_t)stream,
                    (const bf16*)edge, (const int*)ptr, (const int*)inc_row,
                    n_vertices, (bf16*)out);
}

// Launches the empty kernel on `stream` with `blocks` x `threads` through
// the PDL launch path: the fixed cost of a launch, for measuring. Returns
// the CUDA error code.
extern "C" int gfd_launch_floor(int device, int blocks, int threads,
                                void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_pdl(launch_floor_kernel, dim3(blocks), dim3(threads),
                    (cudaStream_t)stream);
}

// Launches the hazard check's writer on `stream` as a plain launch of
// `blocks` blocks of 256 threads (few, so that the PDL launch behind it
// finds room beside it); returns the CUDA error code.
extern "C" int gfd_slow_writer(int device, const void* src, int n, int negate,
                               int cycles, int blocks, void* dst,
                               void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  slow_writer_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)src, n, negate, cycles, (bf16*)dst);
  return cudaGetLastError();
}
