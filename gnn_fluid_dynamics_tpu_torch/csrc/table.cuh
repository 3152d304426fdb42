// Body of the dense-table dual apply K6 (table_dual.cu): one warp per
// target row of a pair of (T, 128, B) banded tables, the row's nonzero
// weights found by __ballot_sync over 16-byte loads of the tables, and each
// nonzero's source row read by all 32 lanes and accumulated, weight times
// row, in f32 registers.
//
// The nonzeros of one ballot round are drained BATCH at a time: their
// source rows are all loaded before any is accumulated, so a warp keeps up
// to BATCH loads in flight (8 in K6).
// A row with many nonzeros sets the launch's tail: the pad vertex of the
// es/er tables receives every padded face (up to 127 per mesh in each
// table), and one load at a time put ~250 L2 round trips in a row on one
// warp. The kernels walk the rows from the last, so that those rows, the
// last of each graph, start first. A ballot round is taken only for the
// entry positions of a 16-byte chunk that hold a nonzero in some lane (a
// mesh row has a few), and the drain is inlined once per table, so the
// kernel stays small. Within each table the terms are accumulated in column
// order, so the sums are deterministic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gfd {

typedef __nv_bfloat16 bf16;

constexpr int TABLE_TILE = 128;      // target rows per table tile
constexpr int TABLE_WARPS = 8;       // target rows per block
constexpr unsigned FULL_MASK = 0xffffffffu;

// A table weight, rounded to bf16 first (the TPU kernel's
// oh.astype(band.dtype)); an int8 weight is exact in bf16.
__device__ __forceinline__ float table_weight(int8_t w) { return (float)w; }
__device__ __forceinline__ float table_weight(bf16 w) {
  return __bfloat162float(w);
}
__device__ __forceinline__ float table_weight(float w) {
  return __bfloat162float(__float2bfloat16(w));
}

// Entry j (a runtime index) of a 16-byte chunk of table entries of type T,
// as a weight; selects and shifts, so the chunk stays in registers.
__device__ __forceinline__ unsigned chunk_word(const uint4& v, int k) {
  return k < 2 ? (k == 0 ? v.x : v.y) : (k == 2 ? v.z : v.w);
}
__device__ __forceinline__ float chunk_entry(const uint4& v, int j, int8_t) {
  return table_weight((int8_t)(chunk_word(v, j >> 2) >> (8 * (j & 3))));
}
__device__ __forceinline__ float chunk_entry(const uint4& v, int j, bf16) {
  return table_weight(__ushort_as_bfloat16(
      (unsigned short)(chunk_word(v, j >> 1) >> (16 * (j & 1)))));
}
__device__ __forceinline__ float chunk_entry(const uint4& v, int j, float) {
  return table_weight(__uint_as_float(chunk_word(v, j)));
}

// A lane's PAIRS consecutive bf16 pairs of one source row.
template <int PAIRS>
struct RowSlice {
  __nv_bfloat162 v[PAIRS];
};

template <int PAIRS>
__device__ __forceinline__ RowSlice<PAIRS> load_slice(const bf16* p) {
  RowSlice<PAIRS> r;
  if constexpr (PAIRS == 1) {
    *reinterpret_cast<unsigned*>(&r) = *reinterpret_cast<const unsigned*>(p);
  } else {
    static_assert(PAIRS == 2, "a lane reads 4 or 8 bytes of a row");
    *reinterpret_cast<uint2*>(&r) = *reinterpret_cast<const uint2*>(p);
  }
  return r;
}

template <int PAIRS>
__device__ __forceinline__ void fma_slice(float* acc, float w,
                                          const RowSlice<PAIRS>& s) {
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) {
    const float2 x = __bfloat1622float2(s.v[k]);
    acc[2 * k] += w * x.x;
    acc[2 * k + 1] += w * x.y;
  }
}

// One table's nonzeros of one ballot round: lane l of mask m is a nonzero
// at source row row0 + l * per, weight wv held by lane l. Each lane adds
// w * src[row, off + 2 * PAIRS * lane ...] to acc, in lane order;
// row_stride is the source's row length in elements.
template <int PAIRS, int BATCH>
__device__ __forceinline__ void drain(const bf16* __restrict__ src,
                                      int row_stride, size_t row0, int per,
                                      int lane, unsigned m, float wv, int off,
                                      float* acc) {
  const bf16* p0 = src + row0 * row_stride + off + 2 * PAIRS * lane;
  const size_t step = (size_t)per * row_stride;
  while (m) {
    int l[BATCH];
    float w[BATCH];
    int n = 0;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (!m) break;                      // uniform: m is a ballot
      l[u] = __ffs(m) - 1;
      m &= m - 1;
      w[u] = __shfl_sync(FULL_MASK, wv, l[u]);
      n = u + 1;
    }
    RowSlice<PAIRS> x[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (u < n) x[u] = load_slice<PAIRS>(p0 + l[u] * step);
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (u < n) fma_slice<PAIRS>(acc, w[u], x[u]);
  }
}

// Walks a pair of table rows sharing a band, `band` entries of type T each,
// in 16-byte loads, applying every ballot round's nonzeros.
template <typename T, int PAIRS, int BATCH>
__device__ __forceinline__ void apply_rows(
    const T* __restrict__ ta, const T* __restrict__ tb, int band,
    const bf16* __restrict__ src, int row_stride, size_t base, int lane,
    int off_a, float* acc_a, int off_b, float* acc_b) {
  constexpr int PER = 16 / sizeof(T);         // table entries per 16 bytes
  for (int c0 = 0; c0 < band; c0 += 32 * PER) {
    const int col = c0 + lane * PER;
    uint4 va = make_uint4(0, 0, 0, 0), vb = va;
    if (col < band) {
      va = *reinterpret_cast<const uint4*>(ta + col);
      vb = *reinterpret_cast<const uint4*>(tb + col);
    }
    // the entry positions j holding a nonzero in any lane: only those get a
    // ballot round
    unsigned any = 0;
    const T* ea = reinterpret_cast<const T*>(&va);
    const T* eb = reinterpret_cast<const T*>(&vb);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const bool nz = table_weight(ea[j]) != 0.0f ||
                      table_weight(eb[j]) != 0.0f;
      any |= (unsigned)nz << j;
    }
    any = __reduce_or_sync(FULL_MASK, any);
    while (any) {
      const int j = __ffs(any) - 1;
      any &= any - 1;
      const float wa = chunk_entry(va, j, T());
      const float wb = chunk_entry(vb, j, T());
      const unsigned ma = __ballot_sync(FULL_MASK, wa != 0.0f);
      const unsigned mb = __ballot_sync(FULL_MASK, wb != 0.0f);
      drain<PAIRS, BATCH>(src, row_stride, base + c0 + j, PER, lane, ma, wa,
                          off_a, acc_a);
      drain<PAIRS, BATCH>(src, row_stride, base + c0 + j, PER, lane, mb, wb,
                          off_b, acc_b);
    }
  }
}

}  // namespace gfd

// Name of a CUDA error code returned by one of the entry points.
extern "C" const char* gfd_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
