// What the dense-table kernels K6 (table_dual.cu) and K7 (table_single.cu)
// share: a (T, 128, B) banded table applied to each tile's band of bf16
// source rows as a dense product on the tensor cores (bf16 x bf16 -> f32),
// every table weight rounded to bf16 first (the TPU kernels'
// oh.astype(band.dtype); int8 weights are exact in bf16). A zero weight is
// multiplied like any other, so 0 x NaN gives NaN, as on the TPU.
//
// * The A fragments are built from words: lane (g, q) (g = lane / 4,
//   q = lane % 4) of a warp of 16 target rows takes, for rows g and g + 8
//   and each product step of 16 columns, the word of four neighbouring
//   entries at columns 16s + 4q .. + 3 (4, 8 or 16 bytes for int8, bf16,
//   f32), and a_fragment places them at the fragment's k positions 2q,
//   2q + 1, 2q + 8, 2q + 9. K7 loads the words straight from device memory;
//   K6 from a copy of the table in shared memory (bf16 tables there give
//   the fragments themselves). The k order of each step is thereby
//   permuted, and the band rows are permuted to match: K7 by its ldmatrix
//   addresses, K6 by the shape of its tensor copies (band_map,
//   `permuted`). split turns int8 entries into bf16 without a conversion
//   instruction.
// * The band arrives in shared memory in boxes of 64 channels (128 bytes)
//   by bulk tensor copies with the 128-byte swizzle: a row's 16-byte chunk
//   c lands at c ^ (row % 8).
// * The tensor maps are made on the host once per buffer and kept
//   (kept_map).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#include "async_copy.cuh"
#include "common.cuh"

namespace gfd {

constexpr int TABLE_TILE = 128;  // target rows per table tile
constexpr int BOX = 128;         // band rows per tensor copy
constexpr int BOX_COLS = 64;     // channels per tensor copy: 128 bytes
constexpr int BOX_BYTES = BOX * BOX_COLS * 2;

// A lane's four table entries of one row for one mma step: 4 neighbouring
// columns, as one load.
template <typename T>
struct Word;
template <>
struct Word<int8_t> {
  typedef uint32_t type;
};
template <>
struct Word<bf16> {
  typedef uint2 type;
};
template <>
struct Word<float> {
  typedef uint4 type;
};

template <typename T>
__device__ __forceinline__ typename Word<T>::type load_word(const T* p) {
  return *reinterpret_cast<const typename Word<T>::type*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Entries (0, 1) and (2, 3) of a word as bf16 pairs, each weight rounded to
// bf16 (exact for int8 and bf16). An int8 entry e goes through f32 without a
// conversion instruction: the bits 0x4B000000 | (e ^ 0x80) are the f32
// 2^23 + 128 + e, and subtracting 2^23 + 128 leaves e exactly; e has at
// most 8 significant bits, so its bf16 is the f32's upper half.
__device__ __forceinline__ void split(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
        8388736.0f);
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}
__device__ __forceinline__ void split(uint2 w, uint32_t& lo, uint32_t& hi) {
  lo = w.x;
  hi = w.y;
}
__device__ __forceinline__ void split(uint4 w, uint32_t& lo, uint32_t& hi) {
  lo = pack_bf16(__uint_as_float(w.x), __uint_as_float(w.y));
  hi = pack_bf16(__uint_as_float(w.z), __uint_as_float(w.w));
}

// The A fragment of one mma step (mma.sync m16n8k16, or a warp's 16 rows of
// wgmma) from this lane's words of rows g and g + 8: entries (0, 1) of each
// word at k positions (2q, 2q + 1) and entries (2, 3) at (2q + 8, 2q + 9),
// or the other way with `swap`.
template <typename W>
__device__ __forceinline__ void a_fragment(const W& w0, const W& w1,
                                           bool swap, uint32_t (&a)[4]) {
  uint32_t lo0, hi0, lo1, hi1;
  split(w0, lo0, hi0);
  split(w1, lo1, hi1);
  a[0] = swap ? hi0 : lo0;
  a[2] = swap ? lo0 : hi0;
  a[1] = swap ? hi1 : lo1;
  a[3] = swap ? lo1 : hi1;
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// table, so that the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The kernels' tensor maps, all with the 128-byte swizzle, made once per
// buffer and layout and kept: a rollout applies the tables to the same
// buffers step after step. A few are kept, the oldest replaced first.
//
// * band_map: a bf16 (rows, width) source in boxes of 64 channels. Plain
//   (K7, and K6 on bf16 tables), a box is its rows in
//   order, at coordinates (channel, row). Permuted (K6 on int8 and f32
//   tables, whose words a_fragment places without swap), k position
//   8h + 2q + j of step s takes band row 16s + 4q + 2h + j: the source is
//   seen as 5-D, (channel, j, q, h, s) at row j + 4q + 2h + 16s from the
//   box's first row, and a box lands in shared memory in the order j, q, h,
//   s, its row 16s + 8h + 2q + j holding that band row. Coordinates
//   (channel, first row, 0, 0, 0). A box has `box_rows` rows (a multiple of
//   16).
// * table_map: a (rows, band) table of `entry_bytes`-byte entries in boxes
//   of 128 rows x 128 bytes, at coordinates (column, row).
struct MapKey {
  int device;
  const void* ptr;
  int rows;
  int width;
  int kind;  // band: box rows, negated permuted; table: entry bytes
};

inline cudaError_t encode_map(const MapKey& k, CUtensorMap* map) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const cuuint64_t rows = (cuuint64_t)k.rows, width = (cuuint64_t)k.width;
  CUresult r;
  if (k.kind > 0 && k.kind <= 4) {
    const cuuint64_t bytes = k.kind;
    const CUtensorMapDataType type =
        bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                   : bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const cuuint64_t dims[2] = {width, rows};
    const cuuint64_t strides[1] = {width * bytes};
    const cuuint32_t box[2] = {(cuuint32_t)(128 / bytes), TABLE_TILE};
    r = encode(map, type, 2, const_cast<void*>(k.ptr), dims, strides, box,
               unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const bool permuted = k.kind < 0;
    const cuuint32_t box_rows = permuted ? -k.kind : k.kind;
    const cuuint64_t row = width * 2;  // bytes
    const cuuint64_t dims2[2] = {width, rows};
    const cuuint64_t strides2[1] = {row};
    const cuuint32_t box2[2] = {BOX_COLS, box_rows};
    const cuuint64_t dims5[5] = {width, rows, 4, 2, box_rows / 16};
    const cuuint64_t strides5[4] = {row, 4 * row, 2 * row, 16 * row};
    const cuuint32_t box5[5] = {BOX_COLS, 2, 4, 2, box_rows / 16};
    r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, permuted ? 5 : 2,
               const_cast<void*>(k.ptr), permuted ? dims5 : dims2,
               permuted ? strides5 : strides2, permuted ? box5 : box2, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t kept_map(const MapKey& k, CUtensorMap* out) {
  constexpr int KEEP = 16;
  static std::mutex lock;
  static MapKey keys[KEEP];
  static CUtensorMap maps[KEEP];
  static int n_kept = 0, oldest = 0;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n_kept; ++i)
    if (keys[i].device == k.device && keys[i].ptr == k.ptr &&
        keys[i].rows == k.rows && keys[i].width == k.width &&
        keys[i].kind == k.kind) {
      *out = maps[i];
      return cudaSuccess;
    }
  const cudaError_t err = encode_map(k, out);
  if (err != cudaSuccess) return err;
  const int slot = n_kept < KEEP ? n_kept++ : (oldest++ % KEEP);
  keys[slot] = k;
  maps[slot] = *out;
  return cudaSuccess;
}

inline cudaError_t band_map(int device, const void* src, int rows, int width,
                            bool permuted, int box_rows, CUtensorMap* out) {
  return kept_map(
      MapKey{device, src, rows, width, permuted ? -box_rows : box_rows}, out);
}

inline cudaError_t table_map(int device, const void* oh, int rows, int band,
                             int entry_bytes, CUtensorMap* out) {
  return kept_map(MapKey{device, oh, rows, band, entry_bytes}, out);
}

}  // namespace gfd
