"""Design studies of the port's K1-K6 on one card, each from
a patched copy of ``gnn_fluid_dynamics_tpu_torch/csrc`` under the ignored
``build/studies/``; the shipped sources are read, never changed.

    python3 scripts/torch_kernel_studies.py [study ...]   # default: all


* ``w0_split``: K1 and K2 with W0 copied in one piece (the shipped design)
  or in 16 KB pieces on barriers of their own, the first product starting
  on the first piece; timed in turns base, variant, variant, base.
* ``k2_phases``: where one K2 tile's cycles go (clock stamps of thread 0 of
  each block, summed over blocks, per tile).
* ``k6``: K6 on the FluxD-valid batch's tables (int8, and cast to bf16),
  shipped and with one part taken out: the output stores, the products, or
  the L2 policies (the table copies' evict-first policy and the streaming
  stores); in turns.
* ``k35``: K3 alone, K5 alone and the pair K3 -> K5, at the FvgnF mesh and
  at the FluxD-valid batch on its index route, shipped (``base``) and as
  commit 25f4ea5 had them (``previous``: its ``edge_vertex.cu`` and
  ``vertex_cell.cu``, read by ``git show`` where the checkout has its history
  and cached under ``build/studies/sources/``, so run the script once in
  such a checkout before a copy without it), and K3 and K5 fused into one
  launch (``fused``: a warp per cell sums its three vertices' half-rows
  from the CSR); in turns. Where the variant launches by programmatic
  dependent launch, each reading is taken with the attribute and without
  (``_no_pdl``, through ``kernels.without_pdl``), and the launch floor (an
  empty kernel back to back) both ways.
* ``pdl_host``: what launching by programmatic dependent launch costs the
  host, shipped (``base``) and with commit 25f4ea5's K3 and K5
  (``previous``), in turns: host microseconds to issue one K3 launch and
  one K4 launch (plain; the card held busy behind a sleep so that no
  launch waits), and the kernel route's steps/s over 100-step FluxD and
  FvgnF rollouts; in ``base`` each with the attribute and without, in
  turns within the process.
* ``k4``: K4 on f32 latents and on bf16 ones, at the FvgnF mesh and at the
  FluxD-valid batch on its index route, shipped (``base``: 16 lanes per
  face, two 16-byte f32 loads per row a lane, 256-thread blocks, every lane
  loading both ids), with a warp per face (``k4_warp``: one 16-byte f32
  load per row a lane; ``k4_warp_t1024`` with 1024-thread blocks), with
  512- and 1024-thread blocks (``k4_t512``, ``k4_t1024``), with the ids
  loaded by one lane and shuffled to the others (``k4_shuffle``), and as
  commit 3dfe0b7 had it (``k4_previous``: its ``face_gather.cu``, bf16
  only, read as ``previous`` is); in turns, each held bit for bit against
  its plain version, with the launch floor at each variant's grid.
* ``face_input``: the unfused face block's gather, concatenation and MLP
  input cast on the FvgnF mesh, as run before K4 rounded its own input,
  as run now, and with the concatenation in bf16: kernels and device time
  per application (``measure_face_input``).
* ``k7_ring``: K7 (int8 tables, 64 and 128 lanes) on FluxD-valid's vc
  tables (band 256), on them widened to 1,920 rows and on the smallest
  phase 14 mesh's own vc table at the all-mesh pad (5,376 rows), with the
  shipped ring (``base``: as many slots as 232,448 bytes of shared memory
  hold, one block an SM once a band fills it), with a ring of half the
  bytes (``k7_half_ring``: 6 slots at 64 lanes, 3 at 128, two blocks an
  SM), and, at band 256 only, as commit K7_PREVIOUS had it
  (``k7_previous``: the whole band in shared memory, 1,792 rows at most,
  read as ``previous`` is); in turns, each held against its plain version.
* ``smoke_state``: whether what ``chip_smoke.py`` runs before its timed
  rollouts slows them: FluxD's kernel-route steps/s over 100-step
  rollouts, three before and three after running nothing (``control``),
  the PDL hazard check (``hazard``), or the whole of phase 2
  (``phase2``: ``kernel_phase``, ``table_phase``, the hazard check), in
  turns; every variant holds the FluxD-valid batch, as the smoke does.

Each variant runs in a process of its own (two copies of one library in
one process fail to launch). Prints one JSON line per study, with the
card's name and power limit.
"""

import ctypes
import json
import re
import shutil
import subprocess
import time
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
PREVIOUS = "25f4ea5"  # the commit whose K3 and K5 the k35 study reads
K4_PREVIOUS = "3dfe0b7"  # the commit whose K4 the k4 study reads
K7_PREVIOUS = "acb46f3"  # the commit whose K7 (whole band) the k7_ring study reads

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gnn_fluid_dynamics_tpu_torch.models import arch  # noqa: E402
from gnn_fluid_dynamics_tpu_torch.models.arch import MLP  # noqa: E402
from gnn_fluid_dynamics_tpu_torch.ops import kernels  # noqa: E402

_EXTRA_ENTRIES = kernels._EXTRA_ENTRIES
_ARGTYPES = kernels._ARGTYPES

STUDIES = ROOT / "build" / "studies"
SRC = kernels.CSRC
ITERS = 200

_STAMP_DEFS = """
__device__ unsigned long long gfd_stamps[16];
__device__ __forceinline__ void gfd_stamp(int i) {
  asm volatile("" ::: "memory");
  if (threadIdx.x == 0) atomicAdd(&gfd_stamps[i], (unsigned long long)clock64());
}
"""
_STAMP_READ = """
extern "C" int gfd_read_stamps(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, gfd::gfd_stamps, 16 * 8);
  unsigned long long z[16] = {};
  cudaMemcpyToSymbol(gfd::gfd_stamps, z, sizeof(z));
  return e;
}
"""
_K6_STORE = """      __stcs(reinterpret_cast<uint4*>(out + (size_t)(8 * h) * ld +
                                      8 * (j0 + q)),
             v);"""
_K6_PRODUCTS = """        if constexpr (ROLL)
          wgmma_rs64<true>(&acc[t][0][0], a[t][s], desc, 1);
        else
          wgmma_rs<true>(&acc[t][0][0], a[t][s], desc, 1);"""

_FUSED = """namespace gfd {

// K3 and K5 in one launch (a study): a warp per cell sums its three
// vertices' half-rows from the CSR, each sum rounded to bf16 as K3 stores
// it, then K5's mean in K5's order and rounding.
__global__ void __launch_bounds__(WARPS * 32)
edge_cell_kernel(const bf16* edge, const int* __restrict__ ptr,
                 const int* __restrict__ inc_row, const int* __restrict__ v0,
                 const int* __restrict__ v1, const int* __restrict__ v2,
                 int n_cells, float* out) {
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * WARPS + threadIdx.x / 32;
  int start[3] = {0, 0, 0}, end[3] = {0, 0, 0}, ids[3] = {0, 0, 0};
  if (c < n_cells) {
    const int vs[3] = {v0[c], v1[c], v2[c]};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      start[k] = ptr[vs[k]];
      end[k] = ptr[vs[k] + 1];
      if (start[k] + lane < end[k]) ids[k] = inc_row[start[k] + lane];
    }
  }
  pdl_wait();
  if (c >= n_cells) return;
  float m[8];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float s[8];
    vertex_sum(edge, inc_row, start[k], end[k], ids[k], lane, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = __bfloat162float(__float2bfloat16(s[j]));
      m[j] = k == 0 ? x : m[j] + x;
    }
  }
  if (lane < ROW_LANES) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      m[j] = __bfloat162float(__float2bfloat16(m[j])) / 3.0f;
    float4* dst = reinterpret_cast<float4*>(out + (size_t)c * HALF + lane * 8);
    dst[0] = make_float4(m[0], m[1], m[2], m[3]);
    dst[1] = make_float4(m[4], m[5], m[6], m[7]);
  }
}

}  // namespace gfd

extern "C" int gfd_edge_cell(int device, const void* edge, const void* ptr,
                             const void* inc_row, const void* v0,
                             const void* v1, const void* v2, int n_cells,
                             void* out, void* stream) {
  using namespace gfd;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_cells == 0) return cudaSuccess;
  return launch_pdl(edge_cell_kernel, dim3((n_cells + WARPS - 1) / WARPS),
                    dim3(WARPS * 32), (cudaStream_t)stream, (const bf16*)edge,
                    (const int*)ptr, (const int*)inc_row, (const int*)v0,
                    (const int*)v1, (const int*)v2, n_cells, (float*)out);
}
"""

_K4_WARP = ("face_gather.cu", "constexpr int FACE_LANES = 16;",
            "constexpr int FACE_LANES = 32;")


def _k4_threads(n):
    return ("face_gather.cu", "constexpr int GATHER_THREADS = 256;",
            f"constexpr int GATHER_THREADS = {n};")


# variant -> [(file, text in the shipped source, its replacement)]
VARIANTS = {
    "base": [],
    "w0_split": [
        ("gn_wgmma.cuh", "  static constexpr int total = bar_off + 3 * 8;",
         "  static constexpr int total = bar_off + (K0 / 64 + 2) * 8;"),
        ("gn_wgmma.cuh", """  for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
  fence_barrier_init();
  mbar_expect_tx(bar, L::w0_bytes);
  bulk_copy(w, w0, L::w0_bytes, bar);
  mbar_expect_tx(bar + 8, hh);
  bulk_copy(w + L::w0_bytes, w1, hh, bar + 8);
  mbar_expect_tx(bar + 16, hh);
  bulk_copy(w + L::w0_bytes + hh, w2, hh, bar + 16);""",
         """  constexpr int P0 = K0 / 64;
  for (int i = 0; i < P0 + 2; ++i) mbar_init(bar + 8 * i, 1);
  fence_barrier_init();
  for (int i = 0; i < P0; ++i) {
    mbar_expect_tx(bar + 8 * i, 16384);
    bulk_copy(w + i * 16384, w0 + i * 8192, 16384, bar + 8 * i);
  }
  mbar_expect_tx(bar + 8 * P0, hh);
  bulk_copy(w + L::w0_bytes, w1, hh, bar + 8 * P0);
  mbar_expect_tx(bar + 8 * (P0 + 1), hh);
  bulk_copy(w + L::w0_bytes + hh, w2, hh, bar + 8 * (P0 + 1));"""),
        ("gn_wgmma.cuh", "  mbar_wait(bar, 0);\n  float t[64];", "  float t[64];"),
        ("gn_wgmma.cuh", """  for (int s0 = 0; s0 < K0 / 16; s0 += PROMOTE) {
    wgmma_fence();""", """  for (int s0 = 0; s0 < K0 / 16; s0 += PROMOTE) {
    mbar_wait(bar + 8 * (s0 / PROMOTE), 0);
    wgmma_fence();"""),
        ("gn_wgmma.cuh", "    mbar_wait(bar + 8 * layer, 0);",
         "    mbar_wait(bar + 8 * (K0 / 64 + layer - 1), 0);"),
    ],
    "k2_stamps": [
        ("gn_wgmma.cuh", "namespace gfd {\n\nconstexpr int ROWS",
         "namespace gfd {\n" + _STAMP_DEFS + "\nconstexpr int ROWS"),
        ("gn_wgmma.cuh", "  mbar_wait(bar, 0);\n  float t[64];",
         "  gfd_stamp(3);\n  mbar_wait(bar, 0);\n  gfd_stamp(4);\n  float t[64];"),
        ("gn_wgmma.cuh", "  bias_silu_to_a(d, v.b0, q, a);\n",
         "  bias_silu_to_a(d, v.b0, q, a);\n  gfd_stamp(5);\n"),
        ("gn_wgmma.cuh", "  // + b2, LayerNorm over each row's",
         "  gfd_stamp(6);\n  // + b2, LayerNorm over each row's"),
        ("gn_wgmma.cuh", "  // 16-byte stores: 16 threads per row",
         "  gfd_stamp(7);\n  // 16-byte stores: 16 threads per row"),
        ("gn_wgmma.cuh", "}  // namespace gfd\n", "}  // namespace gfd\n" + _STAMP_READ),
        ("cell_block.cu", "  if (threadIdx.x == 0) load_weights<K_CELL>",
         "  gfd_stamp(0);\n  if (threadIdx.x == 0) load_weights<K_CELL>"),
        ("cell_block.cu", "    cp_async_wait_all();\n    fence_proxy_async();\n"
         "    __syncthreads();\n    mlp_ln_tile",
         "    gfd_stamp(1);\n    cp_async_wait_all();\n    fence_proxy_async();\n"
         "    __syncthreads();\n    gfd_stamp(2);\n    mlp_ln_tile"),
        ("cell_block.cu", "    mlp_ln_tile<K_CELL>(smem, vs, row0, n_cells, raw, res);\n"
         "    __syncthreads();\n",
         "    mlp_ln_tile<K_CELL>(smem, vs, row0, n_cells, raw, res);\n"
         "    __syncthreads();\n    gfd_stamp(8);\n"),
    ],
    "k6_no_stores": [("table_dual.cu", _K6_STORE, """      if (ld < 0)
        *reinterpret_cast<uint4*>(out + 8 * (j0 + q)) = v;""")],
    "k6_no_products": [("table_dual.cu", _K6_PRODUCTS, """        asm volatile("" ::"l"(desc), "r"(a[t][s][0]), "r"(a[t][s][1]),
                     "r"(a[t][s][2]), "r"(a[t][s][3]));""")],
    "previous": [],       # edge_vertex.cu, vertex_cell.cu of PREVIOUS
    # the shipped sources; these differ in what the process runs
    "control": [], "hazard": [], "phase2": [],
    "fused": [("edge_vertex.cu", "// Launches K3 on `stream`;",
               _FUSED + "\n// Launches K3 on `stream`;")],
    "k4_warp": [_K4_WARP],
    "k4_warp_t1024": [_K4_WARP, _k4_threads(1024)],
    "k4_t512": [_k4_threads(512)],
    "k4_t1024": [_k4_threads(1024)],
    # every lane of a warp takes part in the shuffles: the check of the face
    # against n_faces moves after them
    "k4_shuffle": [("face_gather.cu", """  if (f >= n_faces) return;
  const int o = __ldg(owner + f), n = __ldg(nbr + f);""",
                    """  int o = 0, n = 0;
  if (lane == 0 && f < n_faces) {
    o = __ldg(owner + f);
    n = __ldg(nbr + f);
  }
  o = __shfl_sync(0xffffffffu, o, 0, FACE_LANES);
  n = __shfl_sync(0xffffffffu, n, 0, FACE_LANES);
  if (f >= n_faces) return;""")],
    "k4_previous": [],    # face_gather.cu of K4_PREVIOUS
    "k7_half_ring": [("table_single.cu", "constexpr int SMEM_LIMIT = 232448;",
                      "constexpr int SMEM_LIMIT = 100000;")],
    # its source names the cap that table_mma.cuh then held
    "k7_previous": [("table_single.cu", "namespace gfd {\n",
                     "namespace gfd {\nconstexpr int MAX_BAND = 1792;\n")],
    "k6_no_l2_policy": [
        ("table_dual.cu", _K6_STORE, """      *reinterpret_cast<uint4*>(out + (size_t)(8 * h) * ld +
                                8 * (j0 + q)) = v;"""),
        ("table_dual.cu", "chunk * P::UNIT_COLS, row0, bar, read_once);",
         "chunk * P::UNIT_COLS, row0, bar);"),
    ],
}
STUDY_VARIANTS = {"w0_split": ("base", "w0_split"),
                  "k2_phases": ("k2_stamps",),
                  "k6": ("base", "k6_no_stores", "k6_no_products",
                         "k6_no_l2_policy"),
                  "k35": ("base", "previous", "fused"),
                  "k4": ("base", "k4_warp", "k4_warp_t1024", "k4_t512",
                         "k4_t1024", "k4_shuffle", "k4_previous"),
                  "k7_ring": ("base", "k7_half_ring", "k7_previous"),
                  "face_input": ("base",),
                  "pdl_host": ("base", "previous"),
                  "smoke_state": ("control", "hazard", "phase2")}
# variants whose sources are another commit's files
FILES_FROM = {"previous": (PREVIOUS, ("edge_vertex.cu", "vertex_cell.cu")),
              "k4_previous": (K4_PREVIOUS, ("face_gather.cu",)),
              "k7_previous": (K7_PREVIOUS, ("table_single.cu",))}
# the C signature of K4_PREVIOUS's gfd_face_gather: bf16 latents only
K4_PREVIOUS_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
    ctypes.c_int] + [ctypes.c_void_p] * 3
K2_PHASES = ("launch to gather issued", "gather landed", "to the W0 wait",
             "W0 wait", "product 1, SiLU", "product 2, SiLU",
             "product 3, LayerNorm", "stores")


def prepare(variant: str) -> Path:
    """The variant's patched copy of the sources, its libraries built."""
    d = STUDIES / variant
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(SRC, d / "csrc")
    commit, files = FILES_FROM.get(variant, (None, ()))
    for fname in files:
        (d / "csrc" / fname).write_text(previous_source(commit, fname))
    for fname, old, new in VARIANTS[variant]:
        path = d / "csrc" / fname
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"{variant}: {fname} no longer holds the text "
                             "this study patches")
        path.write_text(text.replace(old, new, 1))
    use(variant)
    kernels.build_kernels()
    return d


def previous_source(commit: str, fname: str) -> str:
    """``fname`` of the port's csrc as ``commit`` had it: from git where the
    checkout has its history (and then cached), else from the cache."""
    cache = STUDIES / "sources" / commit / fname
    rel = f"{SRC.relative_to(ROOT)}/{fname}"
    try:
        text = subprocess.run(["git", "show", f"{commit}:{rel}"], cwd=ROOT,
                              capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        if not cache.exists():
            raise SystemExit(f"{rel} of {commit}: no git history here and no "
                             f"cached copy at {cache}; run this script once "
                             "in a checkout with its history")
        return cache.read_text()
    cache.parent.mkdir(parents=True, exist_ok=True)
    cache.write_text(text)
    return text


def use(variant: str) -> None:
    kernels.CSRC = STUDIES / variant / "csrc"
    kernels.BUILD_DIR = STUDIES / variant / "lib"
    kernels._libs.clear()
    # the previous K3 and K5 sources have no entry points but their launchers
    kernels._EXTRA_ENTRIES = {} if variant == "previous" else _EXTRA_ENTRIES
    kernels._ARGTYPES = dict(_ARGTYPES)
    if variant == "k4_previous":
        kernels._ARGTYPES["gfd_face_gather"] = K4_PREVIOUS_ARGTYPES


def measure(study: str, variant: str) -> dict:
    """One variant's readings, in this process."""
    use(variant)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def latents(n):
        return torch.from_numpy(rng.normal(size=(n, 128)).astype(
            np.float32)).to(dev, torch.bfloat16)

    out = {}
    if study == "k35":
        return measure_k35(variant, latents)
    if study == "k4":
        return measure_k4(variant)
    if study == "face_input":
        return measure_face_input(variant)
    if study == "pdl_host":
        return measure_pdl_host(variant, latents)
    if study == "smoke_state":
        return measure_smoke_state(variant)
    if study == "k7_ring":
        return measure_k7_ring(variant, rng)
    if study == "k6":
        _, vg = cs.valid_data(dev)
        edges, cells = latents(vg.num_faces), latents(vg.num_cells)
        for tname, tdt in (("int8", torch.int8), ("bf16", torch.bfloat16)):
            forms = {"es_roll": (vg.es_onehot.to(tdt), vg.er_onehot.to(tdt),
                                 vg.es_off, edges, True),
                     "cf": (vg.cf_row_onehot.to(tdt), vg.cf_col_onehot.to(tdt),
                            vg.cf_off, cells, False)}
            for name, args in forms.items():
                kernels.table_dual(*args)
                out[f"{name}_{tname}"] = cs.gpu_ms(
                    lambda: kernels.table_dual(*args), ITERS)
        return out
    graph, _ = cs.bench_mesh(dev)
    _, vg = cs.valid_data(dev)
    big = cs.to_static_bands(vg, derive_idx=True)
    gen = torch.Generator().manual_seed(0)
    wf = MLP(384, 128, 128, generator=gen).to(dev).kernel_weights(packed=True)
    wc = MLP(192, 128, 128, generator=gen).to(dev).kernel_weights(packed=True)
    for g in (graph, big):
        c, e = latents(g.num_cells), latents(g.num_faces)
        vtx = kernels.edges_to_vertices_ref(e, g)
        if study == "k2_phases":
            lib = kernels._library("cell_block")
            lib.gfd_read_stamps.argtypes = [ctypes.c_void_p]
            buf = (ctypes.c_ulonglong * 16)()
            kernels.fused_cell_block(c, vtx, g, wc, True)
            torch.cuda.synchronize()
            lib.gfd_read_stamps(ctypes.addressof(buf))          # reset
            kernels.fused_cell_block(c, vtx, g, wc, True)
            torch.cuda.synchronize()
            lib.gfd_read_stamps(ctypes.addressof(buf))
            tiles = (g.num_cells + 63) // 64
            # stamp 0 is taken once per block, the others once per tile
            steps = [buf[i + 1] - buf[i] for i in range(1, 8)]
            out[f"cells_{g.num_cells}"] = {
                name: (d / tiles) for name, d in zip(K2_PHASES[1:], steps)}
            if tiles <= torch.cuda.get_device_properties(0).multi_processor_count:
                out[f"cells_{g.num_cells}"][K2_PHASES[0]] = (
                    (buf[1] - buf[0]) / tiles)
            continue
        k1 = (kernels.fused_face_block, (c, e, g, wf, False))
        k2 = (kernels.fused_cell_block, (c, vtx, g, wc, True))
        for name, (fn, args) in (("K1_single", k1), ("K2_dual", k2)):
            fn(*args)
            out[f"{name}_{g.num_faces if name == 'K1_single' else g.num_cells}"] = (
                cs.gpu_ms(lambda: fn(*args), ITERS))
    return out


def measure_k7_ring(variant: str, rng) -> dict:
    """K7 per launch at its three bands and two widths (band 256 only for
    ``k7_previous``), each held against its plain version."""
    dev = torch.device("cuda", 0)
    _, vg = cs.valid_data(dev)
    widened = cs.widen_band(vg.vc_onehot, vg.vc_off, cs.WIDE_VC_BAND,
                            vg.num_vertices)
    bands = {256: (vg.vc_onehot, vg.vc_off, vg.num_vertices),
             cs.WIDE_VC_BAND: (*widened, vg.num_vertices)}
    if variant != "k7_previous":
        trajs = cs.bucket_data()
        pad = cs.MeshDataset(trajs, num_buckets=cs.BUCKETS, device=dev).pad_to
        small = min(trajs, key=lambda t: t.geom["cell_pos"].shape[0])
        t = cs.banded_tables_for(small.geom, pad)
        bands[t.vc_onehot.shape[2]] = (
            torch.from_numpy(t.vc_onehot).to(dev).to(torch.int8),
            torch.tensor(t.vc_offsets, dtype=torch.int32, device=dev),
            pad["vertex"])
    else:
        del bands[cs.WIDE_VC_BAND]
    out = {}
    for band, (oh, off, rows) in bands.items():
        src = torch.from_numpy(rng.normal(size=(rows, 128)).astype(
            np.float32)).to(dev, torch.bfloat16)
        for lanes in (64, 128):
            s = src[:, :lanes].contiguous()
            cs._compare(f"K7 {variant} vc@{band} {lanes} lanes",
                        kernels.table_single(oh, off, s),
                        kernels.table_single_ref(oh, off, s), exact=False)
            out[f"vc@{band}_{lanes}"] = cs.gpu_ms(
                lambda: kernels.table_single(oh, off, s), ITERS)
    return out


def measure_k35(variant: str, latents) -> dict:
    """K3, K5 and the pair at both sizes, and the fused launch where the
    variant has it (with its largest difference from the pair's output);
    where the variant launches by PDL, each also without the attribute, and
    the launch floor both ways. ms per launch."""
    dev = torch.device("cuda", 0)
    graph, _ = cs.bench_mesh(dev)
    _, vg = cs.valid_data(dev)
    big = cs.to_static_bands(vg, derive_idx=True)
    pdl = variant != "previous"
    calls = {}
    for g in (graph, big):
        e = latents(g.num_faces)
        vtx = kernels.edges_to_vertices(e, g)
        calls.update({
            f"K3_{g.num_vertices}": lambda e=e, g=g: kernels.edges_to_vertices(e, g),
            f"K5_{g.num_cells}": lambda vtx=vtx, g=g: kernels.vertices_to_cells(vtx, g),
            f"pair_{g.num_cells}": lambda e=e, g=g: kernels.vertices_to_cells(
                kernels.edges_to_vertices(e, g), g)})
        if variant == "fused":
            calls[f"fused_{g.num_cells}"] = fused_call(e, g)
    out = {}
    for name, call in calls.items():
        if name.startswith("fused_"):
            got, want = call(), calls["pair_" + name[6:]]()
            torch.cuda.synchronize()
            out[name + "_max_abs_err_vs_pair"] = float((got - want).abs().max())
        call()
        out[name] = cs.gpu_ms(call, ITERS)
        if pdl:
            with kernels.without_pdl():
                out[name + "_no_pdl"] = cs.gpu_ms(call, ITERS)
    if pdl:
        for shape, (blocks, threads) in (("1x32", (1, 32)),
                                         ("k3_grid", ((graph.num_vertices + 7)
                                                      // 8, 256))):
            run = lambda: kernels.launch_floor(dev, blocks, threads)  # noqa: E731
            out[f"floor_pdl_{shape}"] = cs.gpu_ms(run, ITERS)
            with kernels.without_pdl():
                out[f"floor_plain_{shape}"] = cs.gpu_ms(run, ITERS)
    return out


def measure_k4(variant: str) -> dict:
    """K4 per launch on f32 and bf16 latents (bf16 only for
    ``k4_previous``) at the FvgnF mesh and the FluxD-valid batch on its
    index route, each first held bit for bit against its plain version; and
    the launch floor (an empty kernel, no PDL attribute) at the variant's
    grid. ms per launch."""
    dev = torch.device("cuda", 0)
    graph, _ = cs.bench_mesh(dev)
    _, vg = cs.valid_data(dev)
    big = cs.to_static_bands(vg, derive_idx=True)
    rng = np.random.default_rng(2)
    faces_per_block = k4_faces_per_block(variant)
    out = {}
    for g in (graph, big):
        nf = g.num_faces
        x32 = torch.from_numpy(rng.normal(size=(g.num_cells, 128)).astype(
            np.float32)).to(dev)
        forms = {"bf16": x32.to(torch.bfloat16)}
        if variant != "k4_previous":
            forms["f32"] = x32
        for dname, x in forms.items():
            if variant == "k4_previous":
                call = previous_k4(x, g)
            else:
                call = lambda x=x, g=g: kernels.gather_face_cells(x, g)  # noqa: E731
            got, want = call(), kernels.gather_face_cells_ref(x, g)
            torch.cuda.synchronize()
            if not all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                       for a, b in zip(got, want)):
                raise SystemExit(f"{variant}: K4 {dname} at {nf} faces "
                                 "differs from its plain version")
            out[f"K4_{dname}_{nf}"] = cs.gpu_ms(call, ITERS)
        with kernels.without_pdl():
            out[f"floor_k4_grid_{nf}"] = cs.gpu_ms(
                lambda nf=nf: kernels.launch_floor(
                    dev, -(-nf // faces_per_block), 256), ITERS)
    return out


def k4_faces_per_block(variant: str) -> int:
    """Faces per block of the variant's K4 grid, read from its source (the
    previous design gave 16 threads to a face)."""
    text = (STUDIES / variant / "csrc" / "face_gather.cu").read_text()
    threads = int(re.search(r"GATHER_THREADS = (\d+);", text).group(1))
    lanes = re.search(r"FACE_LANES = (\d+);", text)
    return threads // (int(lanes.group(1)) if lanes else 16)


def measure_face_input(variant: str) -> dict:
    """What the unfused face block runs around its gather up to its MLP's
    first product, on the FvgnF mesh: the gather, the concatenation with the
    edge latents and the step scalar, and the MLP's cast of that input to
    bf16. ``before``: the latents cast to bf16, K4, both rows widened to
    f32, the f32 concatenation; ``now``: K4 on the f32 latents, the
    concatenation widening its bf16 rows; ``bf16_concat``: the edge latents
    and the step scalar cast to bf16 and everything concatenated in bf16,
    which the MLP's cast then leaves alone. Each must give the same bf16
    MLP input bit for bit. Per form: CUDA kernels per application and their
    device microseconds per application (torch.profiler over 20
    applications), and ms per application back to back."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda", 0)
    graph, _ = cs.bench_mesh(dev)
    rng = np.random.default_rng(3)
    nf = graph.num_faces
    cell = torch.from_numpy(rng.normal(size=(graph.num_cells, 128)).astype(
        np.float32)).to(dev)
    edge = torch.from_numpy(rng.normal(size=(nf, 128)).astype(np.float32)).to(dev)
    extra = torch.tensor([[0.4]], device=dev)
    extra_b = extra.to(torch.bfloat16)

    def before():
        own, nbr = kernels.gather_face_cells(cell.to(torch.bfloat16), graph)
        return arch._with_extra([edge, own.float(), nbr.float()], extra,
                                nf).to(torch.bfloat16)

    def now():
        return arch._with_extra([edge, *kernels.gather_face_cells(cell, graph)],
                                extra, nf).to(torch.bfloat16)

    def bf16_concat():
        return torch.cat([edge.to(torch.bfloat16),
                          *kernels.gather_face_cells(cell, graph),
                          extra_b.expand(nf, 1)], dim=-1).to(torch.bfloat16)

    forms = {"before": before, "now": now, "bf16_concat": bf16_concat}
    want = before()
    out = {}
    for name, fn in forms.items():
        if not torch.equal(fn().view(torch.int16), want.view(torch.int16)):
            raise SystemExit(f"face_input: {name} gives another MLP input")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        out[f"{name}_kernels"] = len(events) / 20
        out[f"{name}_device_us"] = sum(
            e.time_range.end - e.time_range.start for e in events) / 20
        out[f"{name}_names"] = sorted({e.name[:50] for e in events})
        out[f"{name}_ms"] = cs.gpu_ms(fn, ITERS)
    return out


def previous_k4(x, g):
    """K4 as commit K4_PREVIOUS launched it, on bf16 latents ``x`` of ``g``:
    its entry point has no dtype argument."""
    own = torch.empty(g.num_faces, 128, dtype=torch.bfloat16, device=x.device)
    nbr = torch.empty_like(own)
    idx = g.cell_edge_index

    def call():
        kernels._launch("face_gather", x.device, x.data_ptr(),
                        idx[0].data_ptr(), idx[1].data_ptr(), g.num_faces,
                        own.data_ptr(), nbr.data_ptr())
        return own, nbr
    return call


def host_us(call, n: int = 300) -> float:
    """Host microseconds to issue one ``call``, the card held busy behind a
    sleep kernel (~100 ms) so that no launch waits for it."""
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def measure_pdl_host(variant: str, latents) -> dict:
    """Host cost of a K3 launch and of a plain K4 launch, and FluxD's and
    FvgnF's kernel-route steps/s; where the variant launches by PDL, with
    the attribute and without, in turns (on, off, off, on, on, off)."""
    dev = torch.device("cuda", 0)
    graph, _ = cs.bench_mesh(dev)
    modes = (True, False, False, True, True, False)
    if variant == "previous":
        modes = (True,) * 3

    def timed(mode, fn):
        if mode:
            return fn()
        with kernels.without_pdl():
            return fn()

    e, cells = latents(graph.num_faces), latents(graph.num_cells)
    runs = {"K3_host_us": (lambda: kernels.edges_to_vertices(e, graph), host_us),
            "K4_host_us": (lambda: kernels.gather_face_cells(cells, graph),
                           host_us)}
    for path in ("FluxD", "FvgnF"):
        kern, _, feats = cs.path_models(path, graph)
        cs.rollout_scan(kern, graph, feats, config=cs.RolloutConfig(
            num_steps=5, compute_error=False))
        runs[f"{path}_steps_per_s"] = (
            lambda kern=kern, feats=feats: cs.timed_rollout(kern, graph, feats),
            lambda fn: cs.STEPS / fn())
    out = {}
    for name, (call, reading) in runs.items():
        call()
        for mode in modes:
            key = name + ("" if mode else "_no_pdl")
            out.setdefault(key, []).append(timed(mode, lambda: reading(call)))
    return out


def measure_smoke_state(variant: str) -> dict:
    """FluxD's kernel-route steps/s, three rollouts before and three after
    the part of ``chip_smoke.py``'s phase 2 that ``variant`` names."""
    dev = torch.device("cuda", 0)
    graph, _ = cs.bench_mesh(dev)
    _, vgraph = cs.valid_data(dev)
    vindex = cs.to_static_bands(vgraph, derive_idx=True)
    kern, _, feats = cs.path_models("FluxD", graph)
    cs.rollout_scan(kern, graph, feats, config=cs.RolloutConfig(
        num_steps=5, compute_error=False))

    def steps_per_s():
        return [cs.STEPS / cs.timed_rollout(kern, graph, feats)
                for _ in range(3)]

    out = {"FluxD_steps_per_s_before": steps_per_s()}
    if variant == "phase2":
        cs.kernel_phase(graph, vindex)
        cs.table_phase(vgraph)
    if variant in ("hazard", "phase2"):
        cs.pdl_hazard_check(graph)
    out["FluxD_steps_per_s_after"] = steps_per_s()
    return out


def fused_call(e, g):
    """The fused variant's one launch of K3 and K5 on edges ``e`` of ``g``,
    returning its (C, 64) f32 output."""
    fn = kernels._library("edge_vertex").gfd_edge_cell
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
        ctypes.c_int] + [ctypes.c_void_p] * 2
    vf = g.vertex_face
    out = torch.empty(g.num_cells, 64, device=e.device)

    def fused():
        rc = fn(0, e.data_ptr(), g.vertex_inc_ptr.data_ptr(),
                g.vertex_inc_row.data_ptr(), vf[0].data_ptr(), vf[1].data_ptr(),
                vf[2].data_ptr(), g.num_cells, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"fused K3+K5 failed: CUDA error {rc}")
        return out
    return fused


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--measure":
        print("RESULT " + json.dumps(measure(sys.argv[2], sys.argv[3])))
        return 0
    studies = sys.argv[1:] or list(STUDY_VARIANTS)
    unknown = set(studies) - set(STUDY_VARIANTS)
    if unknown:
        print(f"unknown studies {sorted(unknown)}; the studies are "
              f"{list(STUDY_VARIANTS)}", file=sys.stderr)
        return 2
    for commit, files in FILES_FROM.values():   # before the card check, so a
        for fname in files:                      # checkout with git caches them
            previous_source(commit, fname)
    if not torch.cuda.is_available():
        print("no CUDA device: the studies run on the card", file=sys.stderr)
        return 2
    line = cs.card_line()
    for variant in {v for s in studies for v in STUDY_VARIANTS[s]}:
        prepare(variant)
    for study in studies:
        variants = STUDY_VARIANTS[study]
        order = variants + variants[::-1] if len(variants) > 1 else variants
        readings = {}
        for variant in order:
            res = subprocess.run(
                [sys.executable, __file__, "--measure", study, variant],
                capture_output=True, text=True, timeout=300)
            found = [l for l in res.stdout.splitlines()
                     if l.startswith("RESULT ")]
            if res.returncode != 0 or not found:
                print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
                return 1
            for key, value in json.loads(found[0][7:]).items():
                readings.setdefault(key, {}).setdefault(variant, []).append(value)
        unit = {"k2_phases": "cycles per tile",
                "pdl_host": "host us per launch and steps/s, in turns",
                "smoke_state": "steps/s, in turns"}.get(
                    study, "ms per launch, in turns")
        print(json.dumps({"study": study, "card": line, "unit": unit,
                          "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
