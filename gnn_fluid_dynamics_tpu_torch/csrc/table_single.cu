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
//   s = bf16(oh[t]) @ src[src_off[t] : src_off[t] + B]   (f32 accumulation)
//   out = f32(bf16(s)) / 3
//
// every table weight rounded to bf16 first, as the TPU kernel's
// oh.astype(band.dtype) does (int8 weights are exact in bf16; vc stores 3
// on a padded cell, whose three vertices are all the pad vertex). The
// source is K6's bf16 (V, HALF) vertex sum (the lanes the TPU wrapper keeps,
// pallas_agg.py:471): HALF 64, or 128 behind K6's wide roll form
// (ConservativeH/J/K), a template parameter. The TPU kernel stores bf16(s) and its wrapper casts
// that to f32 and divides by 3 (pallas_agg.py:471-473); this kernel stores
// the f32 mean, with the wrapper's rounding points. The product is dense,
// as on the TPU: a zero weight times a NaN source gives NaN.
//
// Bound: bytes. At the validation batch of two 9,700-point meshes (214
// tiles, B = 256, int8) a launch reads 7.0 MB of tables and 1.8 MB of
// vertex rows and writes 7.0 MB of f32 means: 4.7 us at 3.35 TB/s. The
// dense product is 0.9 GFLOP, under 1 us on the tensor cores.
//
// Design: one block of 8 warps per tile (128 cells), warp w taking cells
// 16w..16w+15 and all HALF channels (HALF / 8 n-tiles of mma.sync
// m16n8k16, bf16 x bf16 -> f32): the tile's 8 warps share one copy of its
// band (measured faster than two 64-cell blocks, which load it twice;
// PERF.md §6).
// * The band (B rows of 2 HALF bytes) streams through a ring of slots in
//   shared memory, a slot holding 128 rows (one box of 64 channels, or two
//   side by side at HALF 128) brought by bulk tensor copies. A slot has a
//   `full` mbarrier, which the copies complete, and an `empty` one, on which
//   the 8 warps arrive once their products on it are done. Thread 0 copies
//   the boxes in order: at each box it refills every slot already free, and
//   waits only for a box it needs itself (as K6's ring does). The f32
//   accumulators stay in registers across all boxes. The ring has as many
//   slots as one block's 232,448 bytes of shared memory hold (14 of 16 KB at
//   HALF 64, 7 of 32 KB at HALF 128), and a band of that many boxes or fewer
//   takes one slot a box, every copy issued at the start: at the bands that
//   fitted whole before (up to 1,792 rows, 896 at HALF 128) the schedule is
//   that of the kernel that held its whole band, with the same shared
//   memory to within the barriers' bytes. A band of any width streams, as
//   banded_single_pallas takes any band that its memory holds.
// * The table goes straight from device memory into registers, a chunk of
//   128 columns ahead of the product (its rows addressed in size_t: a
//   batch's table of rows x B entries may pass 2^31), in the permuted k
//   order of table_mma.cuh (with `swap` for q >= 2), which also holds the
//   word loads and the tensor-map cache that K6 shares. ldmatrix.trans
//   reads the B fragments with the band rows permuted to match (band_lane);
//   the permutation keeps the 8 rows of each ldmatrix on 8 different rows
//   mod 8, hence, with the swizzle, on 8 different bank groups. Every slot
//   starts on a multiple of 1,024 bytes, so the swizzle and band_lane's
//   rows hold in each.
// * mma.sync rather than wgmma: the product is far below the card's
//   operations-per-byte line, and mma.sync takes the table fragments from
//   registers in this permuted order.
// * The epilogue rounds, divides and pairs neighbouring lanes' values by one
//   shuffle, so each lane stores 16 bytes.
#include "table_mma.cuh"

namespace gfd {

constexpr int ROWS = TABLE_TILE;    // cells per block: a whole tile
constexpr int WARPS = ROWS / 16;     // a warp per 16 cells
constexpr int THREADS = WARPS * 32;
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may have

// Shared memory for a ring of `slots` slots of 128 rows of `half`
// channels: a `full` and an `empty` barrier per slot, then the slots,
// aligned to 1,024 bytes as the 128-byte swizzle requires.
inline int smem_bytes(int slots, int half) {
  return 16 * slots + 1024 + slots * BOX * half * 2;
}

// The ring's slots at HALF channels: as many as one block's shared memory
// holds (14 at HALF 64, 7 at HALF 128).
template <int HALF>
constexpr int ring_slots() {
  return (SMEM_LIMIT - 1024) / (16 + BOX * HALF * 2);
}

// Where this lane's ldmatrix.trans reads in a box: lane l gives a row of
// block l / 8 (k positions 0-7 or 8-15, channels n or n + 8), the band row
// holding that k position. `row` is the row's byte offset in a box.
struct BandLane {
  uint32_t row;  // row_in_step * 128
  int swz;       // row_in_step % 8, the 128-byte swizzle's xor
  int hi_n;      // 1 for the lanes giving channels n + 8
};

__device__ __forceinline__ BandLane band_lane(int lane) {
  const int hi_k = (lane >> 3) & 1, hi_n = lane >> 4;
  const int pr = (lane & 7) >> 1;
  const int row_in_step =
      4 * pr + (lane & 1) + ((pr >= 2) != (hi_k == 1) ? 2 : 0);
  return BandLane{(uint32_t)row_in_step * BOX_COLS * 2, row_in_step & 7, hi_n};
}

__device__ __forceinline__ void mma_16816(float* d, const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One mma step over a box's 64 channels: `step` is the shared address of
// the box plus the step's 16 rows (box + 16 * s * 128), and acc[0..7] the
// box's 8 n-tiles of 8 channels.
__device__ __forceinline__ void box_step(uint32_t step, const BandLane& b,
                                         const uint32_t (&a)[4],
                                         float (*acc)[4]) {
  const uint32_t row = step + b.row;
#pragma unroll
  for (int n = 0; n < BOX_COLS; n += 16) {
    uint32_t b0, b1, b2, b3;
    const uint32_t addr = row + (((n / 8 + b.hi_n) ^ b.swz) << 4);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
        : "r"(addr));
    mma_16816(acc[n / 8], a, b0, b1);
    mma_16816(acc[n / 8 + 1], a, b2, b3);
  }
}

// The words of one 128-column chunk for this thread's two rows.
template <typename T>
__device__ __forceinline__ void load_words(typename Word<T>::type (*w)[8],
                                           const T* r0, const T* r1, int k0) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    w[0][s] = load_word(r0 + k0 + 16 * s);
    w[1][s] = load_word(r1 + k0 + 16 * s);
  }
}

template <typename T, int HALF>
__global__ void __launch_bounds__(THREADS)
table_single_kernel(const T* __restrict__ oh, const int* __restrict__ src_off,
                    const __grid_constant__ CUtensorMap band_map, int band,
                    int slots, float* __restrict__ out) {
  typedef typename Word<T>::type W;
  constexpr int CBOXES = HALF / BOX_COLS;  // channel boxes per 128 rows
  constexpr int NT = HALF / 8;             // n-tiles of 8 channels
  constexpr int SLOT_BYTES = CBOXES * BOX_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full = smem_addr(smem), empty = full + 8 * slots;
  const uint32_t ring = (full + 16 * slots + 1023) & ~1023u;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;  // fragment row group, column pair
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  const int boxes = band / BOX;

  // thread 0 copies the boxes in order; `next` is the next one to copy
  int next = 0, off = 0;
  auto copy_boxes = [&](int need) {
    // every box whose slot is free, waiting for the slot only for boxes
    // below `need` (the ones this warp is about to use)
    while (next < boxes) {
      const int ns = next % slots;  // next's slot
      if (next >= slots) {
        // the slot's last box released: phase next / slots - 1 of `empty`
        const uint32_t freed = (next / slots - 1) & 1;
        if (next < need)
          mbar_wait(empty + 8 * ns, freed);
        else if (!mbar_test(empty + 8 * ns, freed))
          break;
      }
      mbar_expect_tx(full + 8 * ns, SLOT_BYTES);
#pragma unroll
      for (int cb = 0; cb < CBOXES; ++cb)
        tensor_copy_2d(ring + ns * SLOT_BYTES + cb * BOX_BYTES, &band_map,
                       cb * BOX_COLS, off + next * BOX, full + 8 * ns);
      ++next;
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < slots; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, WARPS);
    }
    fence_barrier_init();
    off = src_off[row0 / TABLE_TILE];
    copy_boxes(slots);
  }

  // this lane's entries: rows g and g + 8 of its warp, columns 16s + 4q ..
  const T* r0 = oh + (row0 + 16 * warp + g) * band + 4 * q;
  const T* r1 = r0 + 8 * (size_t)band;
  const BandLane bl = band_lane(lane);

  W cur[2][8], nxt[2][8];
  load_words<T>(cur, r0, r1, 0);
  __syncthreads();  // the barriers are initialised
  // a band of more boxes than slots refills them; one of at most as many
  // takes one slot a box, every copy already issued, and skips the refills
  const bool turns = boxes > slots;
  int st = 0;              // box c's slot, c % slots
  uint32_t parity = 0;     // its fill's phase parity, (c / slots) & 1
  float acc[NT][4] = {};
  for (int c = 0; c < boxes; ++c) {
    if (c + 1 < boxes) load_words<T>(nxt, r0, r1, (c + 1) * BOX);
    if (turns && threadIdx.x == 0) copy_boxes(c + 1);
    mbar_wait(full + 8 * st, parity);
    if (turns) __syncwarp();
    const uint32_t slot = ring + st * SLOT_BYTES;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      uint32_t a[4];
      a_fragment(cur[0][s], cur[1][s], q >= 2, a);
#pragma unroll
      for (int cb = 0; cb < CBOXES; ++cb)
        box_step(slot + cb * BOX_BYTES + 16 * s * BOX_COLS * 2, bl, a,
                 acc + 8 * cb);
    }
    if (turns) {
      // the warp's reads of the slot are done: it may be refilled
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int s = 0; s < 8; ++s) cur[r][s] = nxt[r][s];
    if (++st == slots) {
      st = 0;
      parity ^= 1;
    }
  }

  // epilogue: f32(bf16(s)) / 3. acc[j][0..1] is row g, channels 8j + 2q
  // (+1), acc[j][2..3] row g + 8. Lanes q and q ^ 1 swap one pair per two
  // n-tiles, so each holds 4 neighbouring channels: 16-byte stores.
  float* base = out + (row0 + warp * 16 + g) * HALF;
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2][2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[u][e] = __bfloat162float(__float2bfloat16(acc[j + u][2 * h + e])) /
                    3.0f;
      const bool even = (q & 1) == 0;
      const float sx = even ? v[1][0] : v[0][0];
      const float sy = even ? v[1][1] : v[0][1];
      const float rx = __shfl_xor_sync(0xffffffffu, sx, 1);
      const float ry = __shfl_xor_sync(0xffffffffu, sy, 1);
      const float4 o = even ? make_float4(v[0][0], v[0][1], rx, ry)
                            : make_float4(rx, ry, v[1][0], v[1][1]);
      const int col = even ? 8 * j + 2 * q : 8 * (j + 1) + 2 * (q - 1);
      *reinterpret_cast<float4*>(base + h * 8 * HALF + col) = o;
    }
  }
}

template <typename T, int HALF>
cudaError_t launch_table_single(int device, const void* oh, const void* src_off,
                                const CUtensorMap& map, int n_rows, int band,
                                void* out, cudaStream_t stream) {
  // opted in once per device at the whole ring's size; a band of fewer
  // boxes than the ring has slots asks for one slot a box
  constexpr int SLOTS = ring_slots<HALF>();
  static std::atomic<uint64_t> opted_in{0};
  cudaError_t err =
      smem_opt_in_once((const void*)table_single_kernel<T, HALF>, device,
                       smem_bytes(SLOTS, HALF), opted_in);
  if (err != cudaSuccess) return err;
  const int boxes = band / BOX;
  const int slots = boxes < SLOTS ? boxes : SLOTS;
  table_single_kernel<T, HALF>
      <<<n_rows / ROWS, THREADS, smem_bytes(slots, HALF), stream>>>(
          (const T*)oh, (const int*)src_off, map, band, slots, (float*)out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_table_single(int device, const void* oh, const void* src_off,
                                const CUtensorMap& map, int n_rows, int band,
                                int half, void* out, cudaStream_t stream) {
  return half == H / 2
             ? launch_table_single<T, H / 2>(device, oh, src_off, map, n_rows,
                                             band, out, stream)
             : launch_table_single<T, H>(device, oh, src_off, map, n_rows,
                                         band, out, stream);
}

}  // namespace gfd

// Launches K7 on `stream`; returns the CUDA error code (0 on success).
// table_dtype: 0 int8, 1 bf16, 2 f32. n_rows = tiles * 128; src is
// (src_rows, half) bf16, half 64 or 128, out (n_rows, half) f32; band is a
// positive multiple of 128, of any width.
extern "C" int gfd_table_single(int device, const void* oh, const void* src_off,
                                const void* src, int src_rows, int n_rows,
                                int band, int table_dtype, int half, void* out,
                                void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (half != H / 2 && half != H) return cudaErrorInvalidValue;
  if (n_rows % TABLE_TILE || band % BOX || band <= 0 || src_rows < band)
    return cudaErrorInvalidValue;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (n_rows == 0) return cudaSuccess;
  CUtensorMap map;
  err = band_map(device, src, src_rows, half, false, BOX, &map);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (table_dtype) {
    case 0:
      return launch_table_single<int8_t>(device, oh, src_off, map, n_rows,
                                         band, half, out, s);
    case 1:
      return launch_table_single<bf16>(device, oh, src_off, map, n_rows, band,
                                       half, out, s);
    case 2:
      return launch_table_single<float>(device, oh, src_off, map, n_rows, band,
                                        half, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}
