// K4, the owner/neighbour gather of the unfused GN block, for Hopper (sm_90a).
//
// Replaces the TPU kernel of gnn_fluid_dynamics_tpu/ops/pallas_agg.py:
// _dual_rowidx_kernel (banded_dual_rowidx_pallas), wrapped there by
// gather_face_cells_pallas, together with that wrapper's prologue, the cast
// of the cell latents to bf16 (pallas_agg.py:485).
//
// Per face f: own[f] = bf16(x[owner_f]) and nbr[f] = bf16(x[neighbour_f]),
// rows of the (C, 128) cell latents, f32 or bf16, stored as bf16 (what the
// TPU kernel returns). An f32 value is rounded in registers to nearest, ties
// to even (__floats2bfloat162_rn, the conversion tensor.to(torch.bfloat16)
// makes on the card): values beyond bf16's largest finite one round to
// +-Inf, subnormals round as any other value, +-Inf and NaN stay so (a NaN's
// payload may differ from torch's on the CPU). A bf16 row is copied. The
// TPU kernel multiplied iota one-hot selectors with a DMA'd band of cells
// on the MXU, which copies each row exactly (one nonzero per output row, f32
// accumulation); on Hopper a gather is an ordinary load. The wrapper's
// widening of the two outputs to f32 is left to the concatenation the face
// block runs anyway (torch.cat promotes them exactly).
//
// Bound: bytes. A launch reads the cell latents once (C * 512 B in f32,
// 256 in bf16; a row that several faces share is served again from L2), the
// owner and neighbour ids (8 B per face), and writes 512 B per face: 4.56 MB
// in f32 at the rollout's 3,462 cells and 5,361 faces, 1.36 us at 3.35
// TB/s. Each face is two dependent round trips (its ids, then its rows), and
// the launch's fixed cost, which grows with the number of blocks, is most
// of its time. Design: 16 lanes per face, 16 faces per 256-thread block.
// Each lane loads two 16-byte chunks of f32 (8 channels; one chunk of
// bf16) of the owner row and of the neighbour row, all loads in flight
// before either store, rounds them and stores 16 bytes of each, so every
// half-warp reads a row in 512 (or 256) bytes and writes it in 256,
// coalesced. Every lane loads the two ids itself (one broadcast load
// each). Measured against a warp per face, larger blocks and ids shuffled
// from one lane (scripts/torch_kernel_studies.py k4), this was the fastest
// at the rollout's shape. No shared memory and no products: the band DMA
// and the one-hot selectors are not carried over.
#include "common.cuh"

namespace gfd {

constexpr int FACE_LANES = 16;                      // lanes per face
constexpr int CH = H / FACE_LANES;                  // channels per lane
constexpr int GATHER_THREADS = 256;
constexpr int FACES_PER_BLOCK = GATHER_THREADS / FACE_LANES;

template <int BYTES> struct VecOf;
template <> struct VecOf<8> { typedef uint2 type; };
template <> struct VecOf<16> { typedef uint4 type; };
// a lane's CH bf16: 16 bytes here, 8 in the warp-per-face layout the k4
// study builds (scripts/torch_kernel_studies.py)
typedef VecOf<CH * 2>::type Packed;

// A lane's CH channels of one row, as loaded.
template <typename T> struct Loaded;
template <> struct Loaded<float> { float4 v[CH / 4]; };
template <> struct Loaded<bf16> { Packed v; };

__device__ __forceinline__ void load(const float* __restrict__ row, int lane,
                                     Loaded<float>& x) {
  const float4* p = reinterpret_cast<const float4*>(row) + lane * (CH / 4);
#pragma unroll
  for (int i = 0; i < CH / 4; ++i) x.v[i] = __ldg(p + i);
}

__device__ __forceinline__ void load(const bf16* __restrict__ row, int lane,
                                     Loaded<bf16>& x) {
  x.v = __ldg(reinterpret_cast<const Packed*>(row) + lane);
}

// Two f32 values as one word of bf16, each rounded to nearest even; `lo`
// in the low half (the lower address).
__device__ __forceinline__ unsigned bf16_pair_rn(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}

__device__ __forceinline__ uint2 packed(const unsigned (&w)[2]) {
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ uint4 packed(const unsigned (&w)[4]) {
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ Packed to_bf16(const Loaded<float>& x) {
  unsigned w[CH / 2];
#pragma unroll
  for (int i = 0; i < CH / 4; ++i) {
    w[2 * i] = bf16_pair_rn(x.v[i].x, x.v[i].y);
    w[2 * i + 1] = bf16_pair_rn(x.v[i].z, x.v[i].w);
  }
  return packed(w);
}

__device__ __forceinline__ Packed to_bf16(const Loaded<bf16>& x) { return x.v; }

template <typename T>
__global__ void __launch_bounds__(GATHER_THREADS)
face_gather_kernel(const T* __restrict__ cells, const int* __restrict__ owner,
                   const int* __restrict__ nbr, int n_faces,
                   bf16* __restrict__ own_out, bf16* __restrict__ nbr_out) {
  const int f = blockIdx.x * FACES_PER_BLOCK + threadIdx.x / FACE_LANES;
  const int lane = threadIdx.x % FACE_LANES;
  if (f >= n_faces) return;
  const int o = __ldg(owner + f), n = __ldg(nbr + f);
  Loaded<T> a, b;
  load(cells + (size_t)o * H, lane, a);
  load(cells + (size_t)n * H, lane, b);
  reinterpret_cast<Packed*>(own_out + (size_t)f * H)[lane] = to_bf16(a);
  reinterpret_cast<Packed*>(nbr_out + (size_t)f * H)[lane] = to_bf16(b);
}

}  // namespace gfd

// Launches K4 on `stream` for f32 latents (`cells_f32` 1) or bf16 ones (0);
// returns the CUDA error code (0 on success).
extern "C" int gfd_face_gather(int device, const void* cells, const void* owner,
                               const void* nbr, int n_faces, int cells_f32,
                               void* own_out, void* nbr_out, void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_faces == 0) return cudaSuccess;
  const int blocks = (n_faces + FACES_PER_BLOCK - 1) / FACES_PER_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  if (cells_f32)
    face_gather_kernel<float><<<blocks, GATHER_THREADS, 0, s>>>(
        (const float*)cells, (const int*)owner, (const int*)nbr, n_faces,
        (bf16*)own_out, (bf16*)nbr_out);
  else
    face_gather_kernel<bf16><<<blocks, GATHER_THREADS, 0, s>>>(
        (const bf16*)cells, (const int*)owner, (const int*)nbr, n_faces,
        (bf16*)own_out, (bf16*)nbr_out);
  return cudaGetLastError();
}
