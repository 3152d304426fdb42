"""Design studies of the port's K1, K2 and K6 on one card, each from a
patched copy of ``gnn_fluid_dynamics_tpu_torch/csrc`` under the ignored
``build/studies/``; the shipped sources are read, never changed.

    python3 scripts/torch_kernel_studies.py

* ``w0_split``: K1 and K2 with W0 copied in one piece (the shipped design)
  or in 16 KB pieces on barriers of their own, the first product starting
  on the first piece; timed in turns base, variant, variant, base.
* ``k2_phases``: where one K2 tile's cycles go (clock stamps of thread 0 of
  each block, summed over blocks, per tile).
* ``k6``: K6 on the FluxD-valid batch's tables (int8, and cast to bf16),
  shipped and with one part taken out: the output stores, the products, or
  the L2 policies (the table copies' evict-first policy and the streaming
  stores); in turns.

Each variant runs in a process of its own (two copies of one library in
one process fail to launch). Prints one JSON line per study, with the
card's name and power limit.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gnn_fluid_dynamics_tpu_torch.models.arch import MLP  # noqa: E402
from gnn_fluid_dynamics_tpu_torch.ops import kernels  # noqa: E402

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
                         "k6_no_l2_policy")}
K2_PHASES = ("launch to gather issued", "gather landed", "to the W0 wait",
             "W0 wait", "product 1, SiLU", "product 2, SiLU",
             "product 3, LayerNorm", "stores")


def prepare(variant: str) -> Path:
    """The variant's patched copy of the sources, its libraries built."""
    d = STUDIES / variant
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(SRC, d / "csrc")
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


def use(variant: str) -> None:
    kernels.CSRC = STUDIES / variant / "csrc"
    kernels.BUILD_DIR = STUDIES / variant / "lib"
    kernels._libs.clear()


def measure(study: str, variant: str) -> dict:
    """One variant's readings, in this process."""
    use(variant)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def latents(n):
        return torch.from_numpy(rng.normal(size=(n, 128)).astype(
            np.float32)).to(dev, torch.bfloat16)

    out = {}
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


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--measure":
        print("RESULT " + json.dumps(measure(sys.argv[2], sys.argv[3])))
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device: the studies run on the card", file=sys.stderr)
        return 2
    line = cs.card_line()
    for variant in VARIANTS:
        prepare(variant)
    for study, variants in STUDY_VARIANTS.items():
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
        unit = ("cycles per tile" if study == "k2_phases"
                else "ms per launch, in turns")
        print(json.dumps({"study": study, "card": line, "unit": unit,
                          "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
