"""Time the aggregation kernels of the twice message passing (K3, K5, the
pair K3 -> K5, K6's two forms, K7) of one checkout of the port, on the card,
at chip_smoke.py's shapes: K3/K5 at the bench mesh, K6/K7 on FluxD-valid's
int8 tables. With ``--wide`` also their 256-lane forms (a checkout from
before them has none). Prints one line ``AB {json}``.

Two checkouts compare within one call, each in a process of its own, in
turns (parent, change, change, parent), e.g. with ``git archive`` of each
unpacked under build/ (rollouts/, checkpoints/ and runs/ deleted):

    python3 scripts/torch_kernel_ab.py build/ab/parent
    python3 scripts/torch_kernel_ab.py . --wide

Each checkout builds its own kernels (under its build/torch_kernels/) and
uses its own chip_smoke.py helpers. K3 and K5 alone are timed without the
PDL attribute, the pair with it, as chip_smoke.py phase 2 times them.
``--ptxas`` first prints, per kernel of the four sources, the registers
and spills ``nvcc -Xptxas -v`` reports (built under build/ptxas/).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import subprocess
import sys
import time

SOURCES = ("edge_vertex.cu", "vertex_cell.cu", "table_dual.cu",
           "table_single.cu")


def ptxas_report(kernels) -> dict:
    """{kernel's mangled name: "N registers, S bytes spill stores"} of the
    four sources, compiled with the port's flags and ``-Xptxas -v``, one
    ``nvcc`` per source, all started together."""
    os.makedirs("build/ptxas", exist_ok=True)
    procs = [subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(kernels.CSRC), "-o", f"build/ptxas/{src}.so",
         str(kernels.CSRC / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in SOURCES]
    report, name = {}, None
    for proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(log)
        for line in log.splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                report[name] = f"{m.group(1)} bytes spill stores"
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[name] = f"{m.group(1)} registers, " + report.get(name, "")
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkout", help="root of the checkout to time")
    ap.add_argument("--wide", action="store_true",
                    help="also time the 256-lane forms")
    ap.add_argument("--ptxas", action="store_true",
                    help="print the sources' ptxas register report first")
    args = ap.parse_args()
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from gnn_fluid_dynamics_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.ptxas:
        print("PTXAS " + json.dumps(ptxas_report(kernels)), flush=True)
    t0 = time.perf_counter()
    kernels.build_kernels()
    dev = torch.device("cuda", 0)
    graph, _ = cs.bench_mesh(dev)
    _, vg = cs.valid_data(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    H = kernels.H

    def latents(rows, width):
        return torch.randn(rows, width, generator=gen, device=dev).to(
            torch.bfloat16)

    out = {"checkout": args.checkout, "card": cs.card_line()}
    for suffix, w in (("", H),) + ((("_wide", 2 * H),) if args.wide else ()):
        edges = latents(graph.num_faces, w)
        vtx = kernels.edges_to_vertices_ref(edges, graph)
        with kernels.without_pdl():
            out["K3_ms" + suffix] = cs.gpu_ms(functools.partial(
                kernels.edges_to_vertices, edges, graph), cs.FLOOR_ITERS)
            out["K5_ms" + suffix] = cs.gpu_ms(functools.partial(
                kernels.vertices_to_cells, vtx, graph), cs.FLOOR_ITERS)
        out["pair_ms" + suffix] = cs.gpu_ms(
            lambda: kernels.vertices_to_cells(
                kernels.edges_to_vertices(edges, graph), graph),
            cs.FLOOR_ITERS)
        src_e = latents(vg.num_faces, w)
        src_v = latents(vg.num_vertices, w // 2)
        out["K6_es_roll_ms" + suffix] = cs.gpu_ms(lambda: kernels.table_dual(
            vg.es_onehot, vg.er_onehot, vg.es_off, src_e, True))
        out["K7_vc_ms" + suffix] = cs.gpu_ms(lambda: kernels.table_single(
            vg.vc_onehot, vg.vc_off, src_v))
    src_c = latents(vg.num_cells, H)
    out["K6_cf_ms"] = cs.gpu_ms(lambda: kernels.table_dual(
        vg.cf_row_onehot, vg.cf_col_onehot, vg.cf_off, src_c))
    out["seconds"] = time.perf_counter() - t0
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
