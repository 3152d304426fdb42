// K8, the unfused GN sub-block's MLP -> LayerNorm -> residual, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel. It is the port's counterpart of the fusion XLA
// does on the TPU around banded_*_pallas (gnn_fluid_dynamics_tpu/ops/
// pallas_agg.py) on the unfused route: there the aggregation kernels hand
// their outputs to an MLP that XLA fuses with the concatenation, the bias
// adds, SiLU, LayerNorm and the residual. In PyTorch's eager mode the same
// sub-block was some 70 launches (the concatenation, casts, three cuBLAS
// products with separate bias adds and SiLUs, LayerNorm's dozen kernels,
// the residual add), every intermediate in device memory. The aggregation
// kernels (K3 -> K5 and K4 on the index route, K6 -> K7 and K6's cf form on
// the table route) feed K8 their outputs as they are.
//
// Per row, in one of two forms:
//   cell: x = [c f32 (128) | vertex mean f32 (64)]                 K0 = 192
//   face: x = [e f32 (128) | owner bf16 (128) | neighbour bf16 (128)] K0 = 384
// with, where the model has one (FvgnF), the step scalar s as one more
// column:
//   h0 = bf16(bf16(bf16(x) @ W0 + bf16(s) * W0[K0]) + b0) -> SiLU -> bf16
//   h1 = bf16(bf16(h0 @ W1) + b1) -> SiLU -> bf16
//   h2 = bf16(bf16(h1 @ W2) + b2)
//   raw = bf16(LayerNorm(h2)): f32 statistics, var = E[h^2] - mean^2
//         clamped at 0, eps 1e-5, f32 gamma and beta
//   res = x[:, :128] (f32) + raw, f32
// which is models/arch.py's MLP.forward on the concatenated row, rounding
// for rounding (cuBLAS's bf16 product, PyTorch's bf16 bias add and its SiLU
// computed in f32, the separate roundings of LayerNorm's elementwise ops),
// and GNBlock's f32 residual. Only the order of the sums inside a product
// (and of LayerNorm's row sums) differs. The step scalar's product, exact
// in f32, starts the first product's accumulator.
//
// Bound: bytes. At the benchmark's b8 batch (~165k faces, ~109k cells) the
// face form reads 1,024 bytes a row and writes 768 (res f32, raw bf16), the
// cell form 768 and 768: about 88 and 50 us at 3.35 TB/s, against 27 and
// 13 GFLOP of products (27 and 13 us at 989 TFLOP/s).
//
// Design. The weights stay in shared memory for a block's whole life (160
// KB for the face form, 112 KB for the cell form): three bulk copies, one
// mbarrier each, waited for before the first product that reads them. The
// input rows are dense, so no tile is staged in shared memory: each thread
// loads its own rows' columns straight into registers, 16 bytes a load for
// f32 parts (8 for bf16 ones), rounds them to bf16 there and hands them to
// the first product as its A operand (wgmma with A from registers). To make
// that possible the input columns are permuted inside each 16-column k
// step, and W0's rows with them, so that the four values a thread's A
// fragment holds of a row are four neighbouring columns. The hidden
// activations go from one product's accumulator to the next one's A in
// registers, as in K1/K2. W2's output columns are permuted too, so that a
// thread's accumulator holds four neighbouring columns of each of its rows
// per 16: its stores are 16 bytes (f32) and 8 (bf16), and its residual base
// is exactly the f32 values it loaded for part 0, kept in shared memory
// meanwhile (256 bytes a thread, read back by the same thread). With the
// weights resident and no tile staged, two warpgroups fit on an SM, and each
// walks its own tiles with no barrier between them: while one runs its
// products, LayerNorm and stores, the other's loads are in flight. (K1/K2,
// with one warpgroup running dependent phases, stop at about a fifth of
// their bound.)
//
// What bounds it, measured on an H100 at b8's rows (PERF.md §6): first
// instructions, then bytes. With the SiLU's IEEE exponential and division
// on every value a launch took 0.145 ms (cell form) and 0.250 ms (face
// form), both outputs; with the fast forms where they round alike
// (silu_f32) 0.098 and 0.180, 51 and 49 % of the bound. Loads served from L2
// instead of device memory would take another 11 % off the face form; the
// stores are 17 % of it. One warpgroup an SM was 1.5x slower, three in the
// cell form and prefetching each warpgroup's next tile into L2 slower too.
#include "gn_wgmma.cuh"

namespace gfd {
namespace k8 {

// Warpgroups per block, each on its own tiles. The face form has room for
// no more (its first product's A alone is 96 registers a thread, its
// weights 160 KB); the cell form has room for three, but ran slower with
// them (fewer rounds of tiles, a longer tail).
constexpr int WGS = 2;
constexpr int WG_THREADS = 128;
constexpr int BLOCK_THREADS = WGS * WG_THREADS;
constexpr int STASH = 16;            // float4 a thread: 2 rows x 8 k steps

// Shared memory for input width K0 (the step-scalar row not included).
template <int K0>
struct Smem {
  static constexpr int w0_bytes = K0 * H * 2;
  static constexpr int hh = H * H * 2;
  static constexpr int stash_off = w0_bytes + 2 * hh;
  static constexpr int stash_bytes = STASH * WG_THREADS * 16;
  // bf16 (H) each: W0's step-scalar row, b0, b1, b2
  static constexpr int vec_off = stash_off + WGS * stash_bytes;
  // f32 (H) each: LayerNorm's gamma and beta
  static constexpr int ln_off = vec_off + 4 * H * 2;
  static constexpr int bar_off = ln_off + 2 * H * 4;
  static constexpr int total = bar_off + 3 * 8;
  static_assert(total <= 232448, "more shared memory than a block can have");
};

struct Args {
  const float* base;   // part 0, (n, H) f32: the residual base
  const void* p1;      // cell: (n, H/2) f32; face: (n, H) bf16
  const void* p2;      // face: (n, H) bf16
  int n_rows;
  const float* step;   // the step scalar, or null
  const bf16* w0;      // packed (ops/kernels.py::pack_mlp_block)
  const bf16* w1;
  const bf16* w2;
  const bf16* w0_step;  // W0's step-scalar row (H), or null
  const bf16* b0;
  const bf16* b1;
  const bf16* b2;
  const float* ln_g;
  const float* ln_b;
  bf16* raw;            // (n, H) bf16, or null
  float* res;           // (n, H) f32, or null
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A product's f32 sum rounded to bf16, plus the bf16 bias, rounded again:
// the bf16 product and the separate bias add.
__device__ __forceinline__ float add_bias(float acc, float b) {
  return round_bf16(__fadd_rn(round_bf16(acc), b));
}

// PyTorch's SiLU of a bf16 value x in f32, x / (1 + expf(-x)) with the
// IEEE exponential and division, as far as its rounding to bf16 can tell.
// From SILU_FAST_MIN up the fast exponential and division give a value
// that rounds to the same bf16 on every bf16 input, checked on the card over
// all 65,536 of them against PyTorch's own SiLU (chip_smoke.py phase 2,
// kernels.mlp_block_silu_table); below it, where 1 + e passes 2^126 and
// __fdividef gives 0 (x = -87.5, -88, -88.5 on an H100), the IEEE forms.
// (The IEEE forms on every value took a third of the kernel's time.)
constexpr float SILU_FAST_MIN = -87.0f;
__device__ __forceinline__ float silu_fast(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}
__device__ __forceinline__ float silu_ieee(float x) {
  return x / (1.0f + expf(-x));
}
__device__ __forceinline__ float silu_f32(float x) {
  return x >= SILU_FAST_MIN ? silu_fast(x) : silu_ieee(x);
}

// Hidden layer: bias, SiLU, each rounded to bf16, into the next product's A
// fragments (element 4i + 2h + j is row g + 8h, column 8i + 2q + j). The
// SiLU is silu_f32, with the IEEE forms in a branch of their own that a
// warp takes only where one of its values lies below SILU_FAST_MIN (a NaN
// takes either form: both give NaN): a branch per value kept the compiler
// from interleaving the 64 values' fast forms and cost more than it saved.
__device__ __forceinline__ void hidden_to_a(float* d, const bf16* bias,
                                            int q, uint32_t (*a)[4]) {
  float x[64];
  float lo = 0.0f;
#pragma unroll
  for (int i = 0; i < H / 8; ++i) {
    const float2 b = vec_pair(bias, 8 * i + 2 * q);
#pragma unroll
    for (int e = 4 * i; e < 4 * i + 4; ++e) {
      d[e] = add_bias(d[e], e % 2 ? b.y : b.x);
      lo = fminf(lo, d[e]);
      x[e] = silu_fast(d[e]);
    }
  }
  if (__any_sync(0xffffffffu, !(lo >= SILU_FAST_MIN))) {
#pragma unroll
    for (int e = 0; e < 64; ++e)
      if (!(d[e] >= SILU_FAST_MIN)) x[e] = silu_ieee(d[e]);
  }
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// d = A @ W for one layer: K / 16 wgmma k steps, A from registers.
template <int KSTEPS>
__device__ __forceinline__ void product(float* d, uint32_t (*a)[4],
                                        uint32_t w) {
  constexpr uint32_t w_lbo = H * 16;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
    wgmma_rs(d, a[s], operand_desc(w + 2 * s * w_lbo, w_lbo), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(d);
}

// The output column of accumulator element e = 4i + 2h + j (W2's columns
// are permuted so): 16 (i / 2) + 4q + 2 (i % 2) + j.
__device__ __forceinline__ int out_col(int i, int q) {
  return 16 * (i / 2) + 4 * q + 2 * (i % 2);
}

// K0 = 192: [c f32 | vertex mean f32 (64)]; K0 = 384: [e f32 | owner bf16 |
// neighbour bf16]. One warpgroup per tile of 64 rows; warp w holds rows
// 16w..16w+15, thread (g, q) rows g and g + 8 of them.
template <int K0>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
mlp_block_kernel(const Args args) {
  using L = Smem<K0>;
  constexpr bool FACE = K0 == 3 * H;
  constexpr int KS = K0 / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t w_base = smem_addr(smem);
  const uint32_t bar = smem_addr(smem + L::bar_off);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
    fence_barrier_init();
    mbar_expect_tx(bar, L::w0_bytes);
    bulk_copy(w_base, args.w0, L::w0_bytes, bar);
    mbar_expect_tx(bar + 8, L::hh);
    bulk_copy(w_base + L::w0_bytes, args.w1, L::hh, bar + 8);
    mbar_expect_tx(bar + 16, L::hh);
    bulk_copy(w_base + L::w0_bytes + L::hh, args.w2, L::hh, bar + 16);
  }
  bf16* vecs = reinterpret_cast<bf16*>(smem + L::vec_off);
  float* ln = reinterpret_cast<float*>(smem + L::ln_off);
  {
    const bf16* src[4] = {args.w0_step, args.b0, args.b1, args.b2};
    const int j = threadIdx.x / (H / 8), c = threadIdx.x % (H / 8);
    if (j < 4)
      reinterpret_cast<uint4*>(vecs + j * H)[c] =
          src[j] != nullptr ? reinterpret_cast<const uint4*>(src[j])[c]
                            : make_uint4(0u, 0u, 0u, 0u);
    const int k = threadIdx.x / (H / 4), e = threadIdx.x % (H / 4);
    if (k < 2)
      reinterpret_cast<float4*>(ln + k * H)[e] =
          reinterpret_cast<const float4*>(k == 0 ? args.ln_g : args.ln_b)[e];
  }
  __syncthreads();
  const bf16* w0_step = vecs;
  const bf16* b0 = vecs + H;
  const bf16* b1 = vecs + 2 * H;
  const bf16* b2 = vecs + 3 * H;
  const float* ln_g = ln;
  const float* ln_b = ln + H;

  const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  float4* stash = reinterpret_cast<float4*>(smem + L::stash_off +
                                            wg * L::stash_bytes) + tid;
  const float step =
      args.step != nullptr ? round_bf16(*args.step) : 0.0f;
  const int n = args.n_rows;
  const int tiles = (n + ROWS - 1) / ROWS;
  for (int t = blockIdx.x * WGS + wg; t < tiles; t += gridDim.x * WGS) {
    const int r0 = t * ROWS + 16 * warp + g;  // and r0 + 8
    const bool live[2] = {r0 < n, r0 + 8 < n};

    // the first product's A: k step s holds columns 16s + 4q .. 16s + 4q + 3
    // of both rows (W0's rows permuted to match, pack_mlp_block)
    uint32_t a[KS][4];
    {
      float4 v0[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int s = 0; s < 8; ++s)
          v0[h][s] = live[h] ? __ldg(reinterpret_cast<const float4*>(
                                   args.base + (size_t)(r0 + 8 * h) * H +
                                   16 * s + 4 * q))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (FACE) {
        uint2 v1[2][16];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int s = 0; s < 16; ++s) {
            const bf16* part = static_cast<const bf16*>(s < 8 ? args.p1 : args.p2);
            v1[h][s] = live[h] ? __ldg(reinterpret_cast<const uint2*>(
                                     part + (size_t)(r0 + 8 * h) * H +
                                     16 * (s % 8) + 4 * q))
                               : make_uint2(0u, 0u);
          }
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          a[8 + s][0] = v1[0][s].x;
          a[8 + s][2] = v1[0][s].y;
          a[8 + s][1] = v1[1][s].x;
          a[8 + s][3] = v1[1][s].y;
        }
      } else {
        const float* part = static_cast<const float*>(args.p1);
        float4 v1[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            v1[h][s] = live[h] ? __ldg(reinterpret_cast<const float4*>(
                                     part + (size_t)(r0 + 8 * h) * (H / 2) +
                                     16 * s + 4 * q))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          a[8 + s][0] = pack_bf16(v1[0][s].x, v1[0][s].y);
          a[8 + s][2] = pack_bf16(v1[0][s].z, v1[0][s].w);
          a[8 + s][1] = pack_bf16(v1[1][s].x, v1[1][s].y);
          a[8 + s][3] = pack_bf16(v1[1][s].z, v1[1][s].w);
        }
      }
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        a[s][0] = pack_bf16(v0[0][s].x, v0[0][s].y);
        a[s][2] = pack_bf16(v0[0][s].z, v0[0][s].w);
        a[s][1] = pack_bf16(v0[1][s].x, v0[1][s].y);
        a[s][3] = pack_bf16(v0[1][s].z, v0[1][s].w);
        if (args.res != nullptr) {
          stash[s * WG_THREADS] = v0[0][s];
          stash[(8 + s) * WG_THREADS] = v0[1][s];
        }
      }
    }

    // h0: the step scalar's column (exact in f32) starts the accumulator
    float d[64];
#pragma unroll
    for (int i = 0; i < H / 8; ++i) {
      const float2 w = vec_pair(w0_step, 8 * i + 2 * q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        d[4 * i + 2 * h] = step * w.x;
        d[4 * i + 2 * h + 1] = step * w.y;
      }
    }
    mbar_wait(bar, 0);
    product<KS>(d, a, w_base);
    uint32_t x[H / 16][4];
    hidden_to_a(d, b0, q, x);

    // h1, then h2
#pragma unroll
    for (int layer = 1; layer < 3; ++layer) {
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.0f;
      mbar_wait(bar + 8 * layer, 0);
      product<H / 16>(d, x, w_base + L::w0_bytes + (layer - 1) * L::hh);
      if (layer == 1) hidden_to_a(d, b1, q, x);
    }

    // + b2 (bf16), then LayerNorm over each row's 128 columns, which lie in
    // the 4 threads of a quad
    float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < H / 8; ++i) {
      const float2 b = vec_pair(b2, out_col(i, q));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& y0 = d[4 * i + 2 * h];
        float& y1 = d[4 * i + 2 * h + 1];
        y0 = add_bias(y0, b.x);
        y1 = add_bias(y1, b.y);
        s1[h] += y0 + y1;
        s2[h] += __fmul_rn(y0, y0) + __fmul_rn(y1, y1);
      }
    }
    float mu[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], o);
        s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], o);
      }
      mu[h] = s1[h] * (1.0f / H);
      const float var =
          fmaxf(__fsub_rn(s2[h] * (1.0f / H), __fmul_rn(mu[h], mu[h])), 0.0f);
      inv[h] = rsqrtf(__fadd_rn(var, 1e-5f));
    }

    // y = (h - mean) * (inv * gamma) + beta, rounded to bf16: raw; res = base
    // + raw. Per row and 16 columns, this thread's four neighbouring ones.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
#pragma unroll
      for (int m = 0; m < H / 16; ++m) {
        const int col = 16 * m + 4 * q;
        const float4 gm = *reinterpret_cast<const float4*>(ln_g + col);
        const float4 be = *reinterpret_cast<const float4*>(ln_b + col);
        const float y[4] = {d[8 * m + 2 * h], d[8 * m + 2 * h + 1],
                            d[8 * m + 4 + 2 * h], d[8 * m + 4 + 2 * h + 1]};
        const float gv[4] = {gm.x, gm.y, gm.z, gm.w};
        const float bv[4] = {be.x, be.y, be.z, be.w};
        float r[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          r[k] = round_bf16(__fadd_rn(
              __fmul_rn(__fsub_rn(y[k], mu[h]), __fmul_rn(inv[h], gv[k])),
              bv[k]));
        if (!live[h]) continue;
        if (args.raw != nullptr)
          *reinterpret_cast<uint2*>(args.raw + (size_t)row * H + col) =
              make_uint2(pack_bf16(r[0], r[1]), pack_bf16(r[2], r[3]));
        if (args.res != nullptr) {
          const float4 e = stash[(8 * h + m) * WG_THREADS];
          *reinterpret_cast<float4*>(args.res + (size_t)row * H + col) =
              make_float4(__fadd_rn(e.x, r[0]), __fadd_rn(e.y, r[1]),
                          __fadd_rn(e.z, r[2]), __fadd_rn(e.w, r[3]));
        }
      }
    }
  }
}

// silu_f32 on every bf16 value (its bits the index), rounded to bf16.
__global__ void silu_table_kernel(bf16* out) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 65536u) out[i] = __float2bfloat16_rn(silu_f32(__uint_as_float(i << 16)));
}

template <int K0>
cudaError_t launch(const Args& args, int device, cudaStream_t stream) {
  constexpr int smem = Smem<K0>::total;
  static std::atomic<uint64_t> opted_in{0};
  cudaError_t err = smem_opt_in_once((const void*)mlp_block_kernel<K0>,
                                     device, smem, opted_in);
  if (err != cudaSuccess) return err;
  if (args.n_rows == 0) return cudaSuccess;
  const int sms = sm_count(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int tiles = (args.n_rows + ROWS - 1) / ROWS;
  const int want = (tiles + WGS - 1) / WGS;
  const int blocks = want < sms ? want : sms;
  mlp_block_kernel<K0><<<blocks, BLOCK_THREADS, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace k8
}  // namespace gfd

// Launches K8 on `stream` in the face form (face != 0) or the cell form;
// returns the CUDA error code (0 on success). w0, w1, w2 are the packed
// matrices (ops/kernels.py::pack_mlp_block); step and w0_step are both null
// or both given; raw or res may be null.
extern "C" int gfd_mlp_block(int device, int face, const void* base,
                             const void* p1, const void* p2, int n_rows,
                             const void* step, const void* w0, const void* w1,
                             const void* w2, const void* w0_step,
                             const void* b0, const void* b1, const void* b2,
                             const void* ln_g, const void* ln_b, void* raw,
                             void* res, void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if ((step == nullptr) != (w0_step == nullptr)) return cudaErrorInvalidValue;
  const k8::Args args{(const float*)base, p1, p2, n_rows,
                      (const float*)step, (const bf16*)w0, (const bf16*)w1,
                      (const bf16*)w2, (const bf16*)w0_step, (const bf16*)b0,
                      (const bf16*)b1, (const bf16*)b2, (const float*)ln_g,
                      (const float*)ln_b, (bf16*)raw, (float*)res};
  return face ? k8::launch<3 * H>(args, device, (cudaStream_t)stream)
              : k8::launch<H + H / 2>(args, device, (cudaStream_t)stream);
}

// Writes K8's SiLU of every bf16 value, by its bits, into `out` (65,536
// bf16) on `stream`; for checking it against PyTorch's.
extern "C" int gfd_mlp_block_silu(int device, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  gfd::k8::silu_table_kernel<<<256, 256, 0, (cudaStream_t)stream>>>(
      (gfd::bf16*)out);
  return cudaGetLastError();
}
