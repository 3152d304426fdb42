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
//   A = bf16(oh_a[t]) @ src[src_off[t] : src_off[t] + B]
//   Bt = bf16(oh_b[t]) @ the same band            (f32 accumulation)
//
// a dense product, as on the TPU: every weight is multiplied, so a zero
// weight times a NaN source row gives NaN. What it stores:
//
// * with the roll (es/er): only the vertex sum, bf16(A[:, 0:W/2] +
//   Bt[:, W/2:W]), a (rows, W/2) array, for a (S, W) source of W = 128
//   channels or, in the wide form, 256 (ConservativeH/J/K's twice message
//   passing on [e_s | e_s]). The TPU kernel stores the whole A + roll(Bt,
//   W/2) row, but its consumer keeps lanes 0:W/2 only (pallas_agg.py:471);
//   this is K3's output, the same function on the other representation.
// * without (cf): two bf16 (rows, 128) arrays, A and Bt (128 channels
//   only).
//
// The tables are read as the graph carries them: int8, bf16 or f32.
//
// Bound: bytes, as chip_smoke.py::table_form_bound counts them. At the
// validation batch of two 9,700-point meshes (int8, B = 768 for es/er and
// 384 for cf) a launch reads 22.0 MB of es/er tables, 10.7 MB of edge
// latents, and writes 1.8 MB of vertex sums (10.3 us at 3.35 TB/s); or
// 32.0 MB of cf tables, 7.0 MB of cell latents, and writes 21.4 MB (18.0
// us). The dense products are 2.8 and 8.2 GFLOP, about 3 and 8 us at the
// tensor cores' 989 TFLOP/s: under the bytes, if the two overlap.
//
// Design: two warpgroups of 64 target rows, each warp 16 of them, on a
// persistent grid of min(tiles, SMs) blocks, each walking tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... Each step below was measured against the one
// before (PERF.md §6; the figures here are scripts/torch_kernel_studies.py's
// on an NVIDIA H100 80GB HBM3 at 700 W).
// * The products are wgmma, A (the table) from registers and B (the band)
//   from shared memory, MN-major (channels contiguous). mma.sync, as in K7,
//   was its own limit here: with the table loads taken out it was still
//   slower than the bytes bound.
// * Both tables and the band come by bulk tensor copies with the 128-byte
//   swizzle, through a ring of up to 8 stages in 192 KB. A stage holds one
//   unit: one 128-byte box of each table row of the tile (128 int8, 64 bf16
//   or 32 f32 columns; one table with the roll, both without) and the
//   matching band rows in boxes of 64 channels (both channel halves
//   without the roll). Loading the tables straight into registers, every
//   lane loading, stalled the warps on the loads' issue and latency; the
//   bulk copies hold no registers. The table copies carry an evict-first
//   L2 policy, as each entry is read once, and the stores are streaming:
//   the band rows, which neighbouring tiles share, stay in L2 (cf 33.1 ->
//   27.5 us, es/er on bf16 tables 23.2 -> 20.2; es/er on int8 tables, whose
//   working set fits L2 without it, 14.6 -> 15.2).
// * The A fragments come from the table box by ldmatrix: for bf16 tables
//   the product's own fragment, in the band's row order; for int8 (and, by
//   16-byte loads, f32) a word of four neighbouring entries per lane, row
//   and step, which a_fragment places in table_mma.cuh's permuted k order,
//   the band's copies permuting its rows to match (band_map, `permuted`).
// * Each warpgroup runs the products of a group of steps asynchronously
//   while it loads and converts the next group's fragments, one group in
//   flight (wgmma.wait_group 1), also across a tile's end. Thread 0 copies
//   the units: at each new unit it refills every stage already free, and
//   waits only for a unit it needs itself. (A producer warp of its own
//   would cost a whole warpgroup's registers: ptxas gave each thread 168
//   and the form without the roll spilled.) A stage is refilled once all 8
//   warps have arrived on its `empty` barrier, which they do once the
//   products that read it are done. The ring takes any band width and runs
//   on from one tile into the block's next. The tables are read only
//   through their tensor maps (64-bit strides: a batch's table of rows x B
//   entries may pass 2^31 bytes), and a box's coordinates, a column of the
//   band and a row of the tile, stay far below 2^31.
// * With the roll the output is one (128 x W/2) accumulator over k = 2B:
//   the first B steps take oh_a with the band's channels 0:W/2, the next B
//   take oh_b with channels W/2:W; m64n64k16 products at W = 128, one band
//   box a unit. The add of the roll costs nothing. The wide form (W = 256)
//   holds a (128 x 128) accumulator, 64 f32 registers a thread, and takes
//   m64n128k16 products, the n-tiles of the form without the roll: a unit
//   brings both 64-channel boxes of its half, side by side in the stage.
// * Without the roll, two (128 x 128) accumulators in one block, 128 f32
//   registers a thread: m64n128k16 products, one per table and step, B
//   both channel halves (two boxes, side by side in the stage). Chosen over
//   a block per (tile, table), which reads each band twice, and over a
//   block per (tile, channel half), which reads each table twice and
//   converts each int8 entry twice.
// * The epilogue transposes each quad's pairs by shuffles, so each lane
//   stores 16 bytes. What bounds the form without the roll is its 21.4 MB
//   of stores beside 39 MB of reads: without the stores it took 13.4 us.
#include "table_mma.cuh"
#include "wgmma.cuh"

namespace gfd {

constexpr int WARPS = TABLE_TILE / 16;  // warps of 16 target rows
constexpr int THREADS = WARPS * 32;
constexpr int SLICE_BYTES = TABLE_TILE * 128;  // a table box: 128 rows x 128 B
constexpr unsigned FULL_MASK = 0xffffffffu;

// How a block walks its tables. A unit is the table columns of one
// 128-byte box per table row (128 int8, 64 bf16 or 32 f32 columns, STEPS
// product steps) and the matching band rows, in BOXES boxes of 64 channels;
// a stage of the ring holds one. GROUP steps are one wgmma group, whose
// fragments take 32 registers or fewer. WIDE: the roll form on a 256-channel
// source.
template <typename T, bool ROLL, bool WIDE = false>
struct Plan {
  static_assert(ROLL || !WIDE, "only the roll form takes 256 channels");
  static constexpr int TABLES = ROLL ? 1 : 2;  // tables per product step
  static constexpr int WIDTH = WIDE ? 2 * H : H;  // the source's channels
  static constexpr int OUT = ROLL ? WIDTH / 2 : WIDTH;  // stored per table
  static constexpr int BOXES = OUT / BOX_COLS;  // band boxes per unit
  static constexpr int NT = OUT / 8;            // n-tiles of 8 per table
  static constexpr int UNIT_COLS = 128 / (int)sizeof(T);
  static constexpr int STEPS = UNIT_COLS / 16;
  static constexpr int GROUP = ROLL || STEPS < 4 ? STEPS : 4;
  static constexpr int GROUPS = STEPS / GROUP;  // per unit
  static constexpr int BAND_BOX = UNIT_COLS * BOX_COLS * 2;  // bytes
  static constexpr int STAGE_BYTES =
      TABLES * SLICE_BYTES + BOXES * BAND_BOX;
  static constexpr int RING = 192 * 1024;
  static constexpr int STAGES =
      RING / STAGE_BYTES > 8 ? 8 : RING / STAGE_BYTES;
  static constexpr int SMEM = 2 * 8 * STAGES + 1024 + STAGES * STAGE_BYTES;
  // bf16 tables give the product's own fragments, in the band's order
  static constexpr bool PERMUTED = sizeof(T) != 2;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(SMEM <= 232448, "more shared memory than a block can have");
};

// A unit's tables and channel half: with the roll every chunk of 128 rows
// with oh_a in channels 0:W/2, then every chunk with oh_b in channels
// W/2:W; without, each chunk with both tables and both halves.
template <bool ROLL>
__device__ __forceinline__ void unit_coords(int u, int chunks, int& chunk,
                                            int& half) {
  chunk = ROLL ? u % chunks : u;
  half = ROLL ? u / chunks : 0;
}

// A wgmma descriptor of B in a stage's band boxes, MN-major with the
// 128-byte swizzle: bits 0-13 the address / 16; 16-29 the leading byte
// offset / 16, from one 64-channel block to the next (`lbo`: the form
// without the roll reads both channel halves, two neighbouring boxes);
// 32-45 the stride byte offset / 16, from one 8-row group of k to the next
// (1,024 bytes); 62-63 the swizzle, 1 for 128 bytes.
__device__ __forceinline__ uint64_t band_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// The A fragments of steps s0 .. s0 + N - 1 of one table from its box in a
// stage (128 rows of 128 bytes, swizzled; this warp's rows from `row` = 16 *
// warp). A lane's ldmatrix address names row row + lane % 8 (+ 8 for lanes
// 8-15 and 24-31) at a 16-byte chunk (+ 1 for lanes 16-31), stored at
// chunk ^ (row % 8).
template <typename T, int N>
__device__ __forceinline__ void fragments(uint32_t box, int row, int lane,
                                          int s0, uint32_t (*a)[4]) {
  const int r = row + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int hi = lane >> 4;
  const uint32_t base = box + r * 128;
  if constexpr (sizeof(T) == 1) {
    // int8: chunk s is step s; a matrix row gives a lane its word of 4
    // entries. x4: (rows g, step s), (g + 8, s), (g, s + 1), (g + 8, s + 1)
    static_assert(N % 2 == 0, "int8 steps come in pairs");
#pragma unroll
    for (int s = 0; s < N; s += 2) {
      uint32_t w0, w1, w2, w3;
      ldmatrix_x4(base + (((s0 + s + hi) ^ (r & 7)) << 4), w0, w1, w2, w3);
      a_fragment(w0, w1, false, a[s]);
      a_fragment(w2, w3, false, a[s + 1]);
    }
  } else if constexpr (sizeof(T) == 2) {
    // bf16: step s is chunks 2s, 2s + 1; x4 gives the fragment itself:
    // (g, k 0-7), (g + 8, k 0-7), (g, k 8-15), (g + 8, k 8-15)
#pragma unroll
    for (int s = 0; s < N; ++s)
      ldmatrix_x4(base + (((2 * (s0 + s) + hi) ^ (r & 7)) << 4), a[s][0],
                  a[s][1], a[s][2], a[s][3]);
  } else {
    // f32: step s is chunks 4s .. 4s + 3; a lane's word, 4 entries, is its
    // own 16-byte load, rows g and g + 8
    const int g = lane / 4, q = lane % 4;
    const int r0 = row + g, r1 = r0 + 8;
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const int c = 4 * (s0 + s) + q;
      uint4 w0, w1;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(w0.x), "=r"(w0.y), "=r"(w0.z), "=r"(w0.w)
                   : "r"(box + r0 * 128 + ((c ^ (r0 & 7)) << 4)));
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(w1.x), "=r"(w1.y), "=r"(w1.z), "=r"(w1.w)
                   : "r"(box + r1 * 128 + ((c ^ (r1 & 7)) << 4)));
      a_fragment(w0, w1, false, a[s]);
    }
  }
}

// 16 target rows x 8 * NT channels of f32 accumulators (row g in acc[j][0,
// 1], row g + 8 in acc[j][2, 3], channels 8j + 2q, + 1) as bf16 into
// `out` (row g of the warp's rows, ld channels a row). Within each quad a
// 4 x 4 transpose of bf16 pairs, by shuffles, gives each lane 8
// neighbouring channels: 16-byte stores, marked streaming (evict first).
template <int NT>
__device__ __forceinline__ void store_rows(bf16* out, int ld,
                                           const float (*acc)[4], int q) {
  auto pick = [](const uint32_t (&x)[4], int i) {
    return (i & 2) ? ((i & 1) ? x[3] : x[2]) : ((i & 1) ? x[1] : x[0]);
  };
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += 4) {
      uint32_t p[4], o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[j] = pack_bf16(acc[j0 + j][2 * h], acc[j0 + j][2 * h + 1]);
      // round r: lane q takes lane (q ^ r)'s pair of n-tile j0 + q, the
      // pair of channels 2 (q ^ r) of the 8 it stores
#pragma unroll
      for (int r = 0; r < 4; ++r)
        o[r] = r == 0 ? pick(p, q)
                      : __shfl_xor_sync(FULL_MASK, pick(p, q ^ r), r);
      const uint4 v = make_uint4(pick(o, q), pick(o, 1 ^ q), pick(o, 2 ^ q),
                                 pick(o, 3 ^ q));
      __stcs(reinterpret_cast<uint4*>(out + (size_t)(8 * h) * ld +
                                      8 * (j0 + q)),
             v);
    }
}

template <typename T, bool ROLL, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
table_dual_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const int* __restrict__ src_off,
                  const __grid_constant__ CUtensorMap band_map, int band,
                  int tiles, bf16* __restrict__ out_a,
                  bf16* __restrict__ out_b) {
  using P = Plan<T, ROLL, WIDE>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full = smem_addr(smem), empty = full + 8 * P::STAGES;
  const uint32_t ring = (full + 16 * P::STAGES + 1023) & ~1023u;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = band / P::UNIT_COLS;
  const int per_tile = (ROLL ? 2 : 1) * chunks;  // units of a tile
  const int my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int units = my_tiles * per_tile;
  auto tile_of = [&](int u) { return blockIdx.x + (u / per_tile) * gridDim.x; };

  // thread 0 copies the units in order; `next` is the next one to copy.
  // The tables, read once, leave L2 first (as the stores do), and the band
  // rows, which neighbouring tiles share, stay.
  int next = 0;
  const uint64_t read_once = l2_evict_first();
  auto copy_units = [&](int need) {
    // every unit whose stage is free, waiting for the stage only for units
    // below `need` (the ones this warp is about to use)
    while (next < units) {
      const int st = next % P::STAGES;
      if (next >= P::STAGES) {
        const uint32_t parity = (next / P::STAGES - 1) & 1;
        if (next < need)
          mbar_wait(empty + 8 * st, parity);
        else if (!mbar_test(empty + 8 * st, parity))
          break;
      }
      int chunk, half;
      unit_coords<ROLL>(next % per_tile, chunks, chunk, half);
      const int tile = tile_of(next), row0 = tile * TABLE_TILE;
      const uint32_t bar = full + 8 * st, stage = ring + st * P::STAGE_BYTES;
      mbar_expect_tx(bar, P::STAGE_BYTES);
#pragma unroll
      for (int t = 0; t < P::TABLES; ++t)
        tensor_copy_2d(stage + t * SLICE_BYTES,
                       (ROLL ? half : t) ? &map_b : &map_a,
                       chunk * P::UNIT_COLS, row0, bar, read_once);
      const uint32_t bands = stage + P::TABLES * SLICE_BYTES;
#pragma unroll
      for (int h = 0; h < P::BOXES; ++h) {
        const int x = (half * P::BOXES + h) * BOX_COLS;
        const int y = src_off[tile] + chunk * P::UNIT_COLS;
        if constexpr (P::PERMUTED)
          tensor_copy_5d(bands + h * P::BAND_BOX, &band_map, x, y, 0, 0, 0,
                         bar);
        else
          tensor_copy_2d(bands + h * P::BAND_BOX, &band_map, x, y, bar);
      }
      ++next;
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < P::STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, WARPS);
    }
    fence_barrier_init();
    copy_units(P::STAGES);
  }
  __syncthreads();  // the barriers are initialised

  // groups of GROUP steps, in order; group gi belongs to unit gi / GROUPS.
  // The fragments of group gi + 1 are loaded while group gi's products run
  // (also across tiles); after a tile's last group its rows are stored.
  const int groups = units * P::GROUPS;
  int released = 0;  // units this warp has released
  auto release_upto = [&](int n) {
    __syncwarp();
    for (; released < n; ++released)
      if (lane == 0) mbar_arrive(empty + 8 * (released % P::STAGES));
  };
  auto load = [&](int gi, uint32_t (*a)[P::GROUP][4]) {
    const int u = gi / P::GROUPS, st = u % P::STAGES;
    if (gi % P::GROUPS == 0) {
      if (threadIdx.x == 0) copy_units(u + 1);
      mbar_wait(full + 8 * st, (u / P::STAGES) & 1);
    }
    const uint32_t stage = ring + st * P::STAGE_BYTES;
#pragma unroll
    for (int t = 0; t < P::TABLES; ++t)
      fragments<T, P::GROUP>(stage + t * SLICE_BYTES, 16 * warp, lane,
                             (gi % P::GROUPS) * P::GROUP, a[t]);
  };
  auto products = [&](int gi, uint32_t (*a)[P::GROUP][4],
                      float (*acc)[P::NT][4]) {
    const int u = gi / P::GROUPS;
    const uint32_t bands =
        ring + (u % P::STAGES) * P::STAGE_BYTES + P::TABLES * SLICE_BYTES;
#pragma unroll
    for (int t = 0; t < P::TABLES; ++t) {
      fence_operands<P::GROUP * 4>(&a[t][0][0]);
      fence_operands<P::NT * 4>(&acc[t][0][0]);
    }
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < P::GROUP; ++s) {
      const int step = (gi % P::GROUPS) * P::GROUP + s;
      const uint64_t desc =
          band_desc(bands + step * 16 * BOX_COLS * 2, P::BAND_BOX);
#pragma unroll
      for (int t = 0; t < P::TABLES; ++t) {
        if constexpr (P::NT == 8)
          wgmma_rs64<true>(&acc[t][0][0], a[t][s], desc, 1);
        else
          wgmma_rs<true>(&acc[t][0][0], a[t][s], desc, 1);
      }
    }
    wgmma_commit();
  };

  float acc[P::TABLES][P::NT][4] = {};
  uint32_t a[2][P::TABLES][P::GROUP][4];
  const int tile_groups = per_tile * P::GROUPS;  // even
  load(0, a[0]);
  for (int tl = 0; tl < my_tiles; ++tl) {
    // unrolled by 2, so each group's fragments sit in a fixed buffer
    for (int g0 = tl * tile_groups; g0 < (tl + 1) * tile_groups; g0 += 2) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int gi = g0 + i;
        products(gi, a[i], acc);
        wgmma_wait<1>();  // group gi - 1 is done
        release_upto(gi / P::GROUPS);
        if (gi + 1 < groups) load(gi + 1, a[i ^ 1]);
      }
    }
    // the tile's products done: store its rows and start over
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < P::TABLES; ++t) fence_operands<P::NT * 4>(&acc[t][0][0]);
    const int r = tile_of(tl * per_tile) * TABLE_TILE + 16 * warp + lane / 4;
    const int q = lane % 4;
    if constexpr (ROLL) {
      store_rows<P::NT>(out_a + (size_t)r * P::OUT, P::OUT, acc[0], q);
    } else {
      store_rows<P::NT>(out_a + (size_t)r * H, H, acc[0], q);
      store_rows<P::NT>(out_b + (size_t)r * H, H, acc[1], q);
    }
#pragma unroll
    for (int t = 0; t < P::TABLES; ++t)
#pragma unroll
      for (int j = 0; j < P::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.0f;
  }
  release_upto(units);
}

template <typename T, bool ROLL, bool WIDE>
cudaError_t launch(int device, const CUtensorMap& map_a,
                   const CUtensorMap& map_b, const void* src_off,
                   const CUtensorMap& band, int n_rows, int band_rows,
                   void* out_a, void* out_b, cudaStream_t stream) {
  using P = Plan<T, ROLL, WIDE>;
  static std::atomic<uint64_t> opted_in{0};
  const cudaError_t err =
      smem_opt_in_once((const void*)table_dual_kernel<T, ROLL, WIDE>, device,
                       P::SMEM, opted_in);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int tiles = n_rows / TABLE_TILE;
  table_dual_kernel<T, ROLL, WIDE>
      <<<tiles < sms ? tiles : sms, THREADS, P::SMEM, stream>>>(
          map_a, map_b, (const int*)src_off, band, band_rows, tiles,
          (bf16*)out_a, (bf16*)out_b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_table_dual(int device, const void* oh_a, const void* oh_b,
                              const void* src_off, const void* src,
                              int src_rows, int n_rows, int band, int roll,
                              int width, void* out_a, void* out_b,
                              cudaStream_t stream) {
  CUtensorMap map_a, map_b, band_map_;
  cudaError_t err = table_map(device, oh_a, n_rows, band, sizeof(T), &map_a);
  if (err == cudaSuccess)
    err = table_map(device, oh_b, n_rows, band, sizeof(T), &map_b);
  if (err == cudaSuccess)
    err = band_map(device, src, src_rows, width, Plan<T, true>::PERMUTED,
                   Plan<T, true>::UNIT_COLS, &band_map_);
  if (err != cudaSuccess) return err;
  if (!roll)
    return launch<T, false, false>(device, map_a, map_b, src_off, band_map_,
                                   n_rows, band, out_a, out_b, stream);
  return width == H
             ? launch<T, true, false>(device, map_a, map_b, src_off,
                                      band_map_, n_rows, band, out_a, nullptr,
                                      stream)
             : launch<T, true, true>(device, map_a, map_b, src_off, band_map_,
                                     n_rows, band, out_a, nullptr, stream);
}

}  // namespace gfd

// Launches K6 on `stream`; returns the CUDA error code (0 on success).
// table_dtype: 0 int8, 1 bf16, 2 f32. n_rows = tiles * 128; band is a
// positive multiple of 128, of any width; src is (src_rows, width) bf16, width 128,
// or 256 with roll. With roll, out_a is (n_rows, width / 2) and out_b
// unused; else both are (n_rows, 128).
extern "C" int gfd_table_dual(int device, const void* oh_a, const void* oh_b,
                              const void* src_off, const void* src,
                              int src_rows, int n_rows, int band,
                              int table_dtype, int roll, int width,
                              void* out_a, void* out_b, void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_rows % TABLE_TILE || band % BOX || band <= 0 || src_rows < band ||
      !(width == H || (roll && width == 2 * H)))
    return cudaErrorInvalidValue;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (n_rows == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (table_dtype) {
    case 0:
      return launch_table_dual<int8_t>(device, oh_a, oh_b, src_off, src,
                                       src_rows, n_rows, band, roll, width,
                                       out_a, out_b, s);
    case 1:
      return launch_table_dual<bf16>(device, oh_a, oh_b, src_off, src,
                                     src_rows, n_rows, band, roll, width,
                                     out_a, out_b, s);
    case 2:
      return launch_table_dual<float>(device, oh_a, oh_b, src_off, src,
                                      src_rows, n_rows, band, roll, width,
                                      out_a, out_b, s);
    default:
      return cudaErrorInvalidValue;
  }
}
