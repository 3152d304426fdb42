// K2, the fused cell block of a GN block, for Hopper (sm_90a).
//
// Replaces the TPU kernels of gnn_fluid_dynamics_tpu/ops/pallas_agg.py:
// _fused_cell_kernel_chunk (fused_cell_tiles_chunked) and _fused_cell_kernel
// (fused_cell_tiles_pallas), wrapped there by fused_cell_block_pallas.
//
// Per cell c with vertices (i0, i1, i2):
//   agg = bf16((v[i0] + v[i1] + v[i2]) * (1/3))   (64 channels, f32 sum)
//   [c | agg] -> the MLP + LayerNorm tail of gn_wgmma.cuh at K0 = 192; out
//   c + raw, and raw itself when raw is not null.
// v is the (V, 64) bf16 vertex sum of K3 (edge_vertex.cu).
//
// Bound: bytes, as chip_smoke.py::bounds counts them. At the FluxD mesh's
// 3,462 cells a dual-output launch reads the cell latents (0.89 MB), the
// vertex sums (0.24 MB), the vertex indices and the weights (0.16 MB) and
// writes two outputs (1.77 MB): 0.91 us at 3.35 TB/s, against 0.40 GFLOP of
// products, 0.40 us at 989 TFLOP/s. What it has to beat is latency: each
// block takes in 112 KB of weights, gathers its tile and runs three
// dependent product chains, and at 3,462 cells (55 tiles) each block runs
// one tile.
//
// The TPU kernel built the 3-vertex mean as a one-hot product over a DMA'd
// band of vertices; here each block gathers its tile's rows directly,
// straight into the products' operand layout (core matrices, gn_wgmma.cuh):
// the cell row by 16 cp.async copies of 16 bytes, and the mean computed in
// registers, per 8 channels three 16-byte loads of the vertex rows, the sum
// in f32 times 1/3, and one 16-byte store of bf16. The grid is persistent,
// at most one block per SM, each copying the packed weights into shared
// memory once and walking tiles blockIdx.x, blockIdx.x + gridDim.x, ...:
// 55 tiles at 3,462 cells, 428 at the 27,392 of the validation batch.
#include "gn_wgmma.cuh"

namespace gfd {

constexpr int H2 = H / 2;
constexpr int K_CELL = H + H2;

// 8 bf16 of each of three vertex rows -> bf16((a + b + c) * (1/3)).
__device__ __forceinline__ uint4 mean3(const uint4& a, const uint4& b,
                                       const uint4& c) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(&c);
  const float third = 1.0f / 3.0f;
  uint4 out;
  uint32_t* po = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(pa[i]);
    const float2 y = __bfloat1622float2(pb[i]);
    const float2 z = __bfloat1622float2(pc[i]);
    po[i] = pack_bf16((x.x + y.x + z.x) * third, (x.y + y.y + z.y) * third);
  }
  return out;
}

__global__ void __launch_bounds__(THREADS, 1)
cell_block_kernel(const bf16* __restrict__ cells, const bf16* __restrict__ vtx,
                  const int* __restrict__ v0, const int* __restrict__ v1,
                  const int* __restrict__ v2, int n_cells,
                  const bf16* __restrict__ w0, const bf16* __restrict__ w1,
                  const bf16* __restrict__ w2, MlpVecs v,
                  bf16* __restrict__ raw, bf16* __restrict__ res) {
  using L = TileSmem<K_CELL>;
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x == 0) load_weights<K_CELL>(smem, w0, w1, w2);
  const MlpVecs vs = load_vecs<K_CELL>(smem, v);
  __syncthreads();
  unsigned char* a_tile = smem + L::a_off;
  const uint32_t a_base = smem_addr(a_tile);
  const int tiles = (n_cells + ROWS - 1) / ROWS;
  // gather: 64 rows x 24 chunks of 16 bytes (16 of the cell row, 8 of the
  // mean). A warp takes 8 rows x 4 neighbouring chunks at a time; a thread,
  // 2 rows x 6 chunks (4 copied, 2 computed), its rows' indices loaded
  // once. Chunk (row r, column block kc) goes to its 8 x 8 core matrix
  // (gn_wgmma.cuh). Rows past the end are 0.
  const int r_lo = threadIdx.x & 7, kq = (threadIdx.x >> 3) & 3;
  const int rg = threadIdx.x >> 5;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * ROWS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * (rg + 4 * h);
      const int row = row0 + r;
      const bool live = row < n_cells;
      const bf16* cell = cells + (size_t)row * H;
      const bf16* vr[3];
      if (live) {
        vr[0] = vtx + (size_t)v0[row] * H2;
        vr[1] = vtx + (size_t)v1[row] * H2;
        vr[2] = vtx + (size_t)v2[row] * H2;
      }
#pragma unroll
      for (int kg = 0; kg < K_CELL / 32; ++kg) {
        const int kc = kq + 4 * kg;
        const int dst = (kc * (ROWS / 8) + r / 8) * 128 + (r % 8) * 16;
        if (!live) {
          *reinterpret_cast<uint4*>(a_tile + dst) = make_uint4(0u, 0u, 0u, 0u);
        } else if (kg < H / 32) {
          cp_async16(a_base + dst, cell + 8 * kc);
        } else {
          const int c = 8 * (kc - H / 8);
          *reinterpret_cast<uint4*>(a_tile + dst) =
              mean3(*reinterpret_cast<const uint4*>(vr[0] + c),
                    *reinterpret_cast<const uint4*>(vr[1] + c),
                    *reinterpret_cast<const uint4*>(vr[2] + c));
        }
      }
    }
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    mlp_ln_tile<K_CELL>(smem, vs, row0, n_cells, raw, res);
    __syncthreads();
  }
}

}  // namespace gfd

// Launches K2 on `stream`; returns the CUDA error code (0 on success).
// w0, w1, w2 are the packed weights (ops/kernels.py::pack_weights).
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
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  constexpr int smem = TileSmem<K_CELL>::total;
  static std::atomic<uint64_t> opted_in{0};
  err = smem_opt_in_once((const void*)cell_block_kernel, device, smem,
                         opted_in);
  if (err != cudaSuccess) return err;
  if (n_cells == 0) return cudaSuccess;
  const int sms = sm_count(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  const MlpVecs v{(const bf16*)b0, (const bf16*)b1, (const bf16*)b2,
                  (const bf16*)ln_g, (const bf16*)ln_b};
  const int tiles = (n_cells + ROWS - 1) / ROWS;
  const int blocks = tiles < sms ? tiles : sms;
  cell_block_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)cells, (const bf16*)vtx, (const int*)v0, (const int*)v1,
      (const int*)v2, n_cells, (const bf16*)w0, (const bf16*)w1,
      (const bf16*)w2, v, (bf16*)raw, (bf16*)res);
  return cudaGetLastError();
}
