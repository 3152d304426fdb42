"""Drive the PyTorch/CUDA port on one card: build the GN-block kernels, hold
each against its plain PyTorch version, run the FluxD and FvgnF rollouts,
the trainer's validation rollout of FluxD, FluxD's training, the rollout
entry point and the MGN family at their shipped width through them, and
report each kernel's time beside its bound.

    python3 chip_smoke.py

Phases (each prints one flushed line; any failure exits non-zero):

1. device and build: the card's name and power limit, the kernels' build time;
2. kernel vs plain: K1-K5 at the FluxD/FvgnF shapes (K1 and K2 in four
   forms, single- and dual-output at the FluxD mesh and at the FluxD-valid
   batch on its index route, each also read against an f64 evaluation; K3,
   K5 and the pair K3 -> K5 also at that batch, whose pad vertex has a CSR
   row longer than one of K3's rounds; K4 on f32 latents that are not
   bf16-exact and on bf16 ones, at the FvgnF mesh and at that batch, and on
   latents at the edges of bf16 rounding, each exactly; timed beside the
   sequence it replaces, cast to bf16, K4, both rows widened to f32) and
   K6/K7 on the FluxD-valid batch's own tables (int8, and once more cast to
   bf16 and to f32; K6's roll form also on the tables widened to a band of
   896, K7 on the tables widened to 384), on seeded inputs; K6 and K7 also
   with a NaN source row that a tile's weights skip, whose NaN must reach
   the same places as in the plain version; K7 and its library call timed
   also with L2 flushed between launches; the launch floor (an empty kernel
   back to back, with and without the programmatic dependent launch
   attribute K3 and K5 launch with); and the PDL hazard checks: for 200
   rounds a slow writer, which lets the next launch start at its own start,
   writes fresh edge latents into the buffer that K3 reads right after it,
   and K3 -> K5 must agree with the plain versions on every round; and for
   200 rounds K1 with both outputs, then K3 on K1's raw output (MgnA's
   face-first order), K3 agreeing with its plain version on every round;
3. the three paths at hidden 128, 15 GN block applications and bf16, with
   seeded weights and statistics from the synthetic channel flow:

   * FluxD, on the RCM-ordered cylinder mesh of ``bench.py`` (3,462 cells,
     5,361 faces, 1,899 vertices), 15 fused GN blocks: K3 -> K2 -> K1 per
     block;
   * FvgnF, on the same mesh, one shared GN block applied 15 times with a
     step scalar, so unfused: K3 -> K5 -> cell MLP, K4 -> face MLP per
     application; its integrator's BatchNorm at Flax's init (mean 0, var 1);
   * FluxD-valid, the rollout half of the trainer's validation: two
     RCM-ordered 9,700-point cylinder meshes (``bench.py``'s production
     point) in one ``MeshDataset`` with int8 banded tables, padded to one
     shape and batched on the table route, so every block is unfused and
     reads the tables: K6 (es/er) -> K7 (vc) -> cell MLP, K6 (cf) -> face
     MLP; each table application is one launch for the whole batch.

   Each of the first 5 steps of a path is held against the same model's
   plain path on the card, on the same inputs (FluxD-valid's also against
   its own batch on the index route, fused K1-K3, on live rows); a 5-step
   rollout with the error metrics must stay finite (for FluxD-valid:
   ``validate`` on both routes, whose errors must agree); then a 100-step rollout is timed with
   every launch counter set to 0 just before it and read just after, and
   each kernel must have launched as often per step as its path runs it
   (15, K6 30) and never on another path; last a device profile of 10
   steps;
4. a summary line of the three paths;
5. training on the card, through ``Trainer.run`` (no kernel runs in a train
   step: ``train`` refuses the kernel route, as in the JAX package):

   * 5a FluxD at hidden 128, 15 blocks, bf16, ``config/train.json``'s
     optimizer (AdamW, clip 10), schedule, loss weights and noise, batch 4
     of four RCM-ordered 2,400-point cylinder meshes (about 3.5k cells
     each) with channel-flow trajectories, TRAIN_STEPS steps of one
     mini-epoch each, validated on the FluxD-valid dataset before and
     after (K6 30 and K7 15 launches per validation step, none in a train
     step; its errors against the plain route's within 5e-2), one
     checkpoint written and read back; then ms per train step (host clock
     over TIMED_STEPS steps after TIMED_WARMUP, ending in a synchronize), a
     device profile of TRAIN_PROFILE_STEPS steps, the peak device memory,
     and the mean loss of the first and the last LOSS_WINDOW steps (the
     last must be lower);
   * 5b one FluxD train step in f32 without noise, flip or dropout on the
     bench mesh, with the same weights and batch on the card and on the
     CPU: loss, gradient norm and parameters held against each other;
   * 5c FvgnF, as 5a for FVGNF_TRAIN_STEPS steps without validation: finite
     losses, and its BatchNorm's running statistics moved and finite;
6. the rollout entry point and the MGN family:

   * 6a FluxD through ``rollout.run``'s two halves (``restore_model``,
     ``rollout_dataset``) on phase 5a's checkpoint, adopting its config and
     statistics, on the bench mesh with a channel flow as ground truth:
     STEPS steps with the error metrics, ``errors.json`` written; K1-K3 15
     launches a step; the first 5 steps' errors within 5e-2 of the plain
     route's; steps/s;
   * 6b MgnA (face-first GN blocks, the cell decoder) on the bench mesh
     with MLS cell weights, fused: K1 with both outputs -> K3 on its raw
     output -> K2 with the residual only, per block in that order; as phase
     3 (5 steps against the plain route, the error metrics with the MLS
     divergence, 100 timed steps with the counters, a profile);
   * 6c MgnA on FluxD-valid's batch on the table route: K6 cf -> K6 es/er
     -> K7 per block, as phase 3 with ``validate`` on both routes;
   * 6d MgnB, MGNB_TRAIN_STEPS train steps on phase 5's batches with MLS
     cell weights: every loss term finite, the continuity term included,
     the loss falling, no kernel launched;

then the ``kernels`` line: per kernel its time per launch, launches, bound,
plain time and library time (K3 and K5 also the pair's time and the launch
floor).

The last line is ``{"ok": true, "device": {...}}``. Without a card the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from gnn_fluid_dynamics_tpu_torch.data.samplers import get_sampler
from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset, Trajectory,
                                                        rollout_batch)
from gnn_fluid_dynamics_tpu_torch.data.synthetic import (channel_flow_trajectory,
                                                         make_geometry)
from gnn_fluid_dynamics_tpu_torch.graph import (widen_band, from_geometry,
                                                to_static_bands)
from gnn_fluid_dynamics_tpu_torch.models.arch import MLP
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig, feature_masks
from gnn_fluid_dynamics_tpu_torch.models.flux import FluxD
from gnn_fluid_dynamics_tpu_torch.models.fvgn import FvgnF
from gnn_fluid_dynamics_tpu_torch.models.mgn import MgnA
from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
from gnn_fluid_dynamics_tpu_torch.ops import fvm, kernels
from gnn_fluid_dynamics_tpu_torch.ops.mls import compute_mls_weights
from gnn_fluid_dynamics_tpu_torch.ops.reorder import rcm_reorder_geometry
from gnn_fluid_dynamics_tpu_torch.rollout import run as rollout_cli
from gnn_fluid_dynamics_tpu_torch.rollout.engine import (SAVABLE_FIELDS,
                                                         RolloutConfig,
                                                         rollout_scan)
from gnn_fluid_dynamics_tpu_torch.training import train as train_cli
from gnn_fluid_dynamics_tpu_torch.training.checkpoint import Checkpointer
from gnn_fluid_dynamics_tpu_torch.training.config import load_config
from gnn_fluid_dynamics_tpu_torch.training.logging import Logger
from gnn_fluid_dynamics_tpu_torch.training.lr_schedule import get_schedule
from gnn_fluid_dynamics_tpu_torch.training.trainer import Trainer, optimizer_step
from gnn_fluid_dynamics_tpu_torch.training.validate import (validate,
                                                            validation_errors)

H = kernels.H
MP_NUM = 15
STEPS = 100            # timed rollout steps
CHECK_STEPS = 5        # steps held against the plain path
TIMING_ITERS = 50      # launches per timed batch
FLUSH_BYTES = 128 << 20  # written between launches to flush the 50 MB L2
VALID_POINTS = 9700    # FluxD-valid: bench.py's production mesh size
VALID_SEEDS = (0, 1)   # one mesh per seed, batched
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# kernel vs its plain version, elementwise on bf16 outputs: one bf16
# rounding step (2**-8 relative) taken on the other side of a boundary,
# from f32 sums in another order, plus its effect downstream. K4 rounds
# each value to bf16 once, as its plain version does, and is held exactly.
KERNEL_RTOL = KERNEL_ATOL = 2.0 ** -7
# kernel vs plain route of the same model on the same inputs, as the
# largest difference relative to the field's largest magnitude: bf16
# latents through 15 blocks (measured on the CPU at 904 cells: up to 2.8%
# on FluxD's face fields)
STEP_TOL = 5e-2
HAZARD_ROUNDS = 200
HAZARD_CYCLES = 100_000   # the hazard writer's idle cycles (~50 us) before it writes
FLOOR_ITERS = 200         # launches per timed batch of K3, K4, K5, the pair, the floor
K4_FACES_PER_BLOCK = 16   # K4's grid: 16 lanes per face (csrc/face_gather.cu)
# phase 5: training on the card
ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_CONFIG = os.path.join(ROOT, "config", "train.json")
SMOKE_DIR = os.path.join(ROOT, "build", "chip_smoke")   # logs and checkpoints
TRAIN_POINTS = 2400        # the bench mesh's generator: ~3.5k cells a mesh
TRAIN_SEEDS = (0, 1, 2, 3)  # one mesh per seed, batch 4
TRAIN_STEPS = 40           # Trainer.run's steps, one mini-epoch each
TIMED_WARMUP, TIMED_STEPS = 5, 30
TRAIN_PROFILE_STEPS = 5
FVGNF_TRAIN_STEPS = 10
LOSS_WINDOW = 10           # steps averaged at the start and at the end
# card against CPU, one f32 step: the loss within 1e-4 relative and the
# gradients' global norm within 1e-3 (f32 sums in another order, atomics on
# the card); each parameter within 2 lr (1 + 1e-4) + 1e-6: a first AdamW
# step moves an element by lr * g / (|g| + eps), about lr in the sign of g,
# so an element whose gradient is near 0 may move lr either way
CPU_LOSS_RTOL, CPU_GRAD_NORM_RTOL = 1e-4, 1e-3
# phase 6: the rollout entry point and the MGN family
MLS_ORDER = 1              # MgnA's MLS cell weights (the configs' default)
MGNB_TRAIN_STEPS = 10
MGNB_LOSS_WINDOW = 5
# MgnB's loss weights: config/train.json's (FluxD's) with the two terms
# MgnB adds: its direct velocity at the config default's 10, and continuity
# at 0.1 so that the MLS term counts
MGNB_LOSS_WEIGHTS = {"cell_velocity": 10.0, "continuity": 0.1}

KERNELS = {
    "K1_fused_face_block": dict(
        wrapper=kernels.fused_face_block,
        source="gnn_fluid_dynamics_tpu_torch/csrc/face_block.cu",
        replaces="gnn_fluid_dynamics_tpu/ops/pallas_agg.py:903 "
                 "(_fused_face_kernel_chunk; per-tile _fused_face_kernel :543)"),
    "K2_fused_cell_block": dict(
        wrapper=kernels.fused_cell_block,
        source="gnn_fluid_dynamics_tpu_torch/csrc/cell_block.cu",
        replaces="gnn_fluid_dynamics_tpu/ops/pallas_agg.py:951 "
                 "(_fused_cell_kernel_chunk; per-tile _fused_cell_kernel :596)"),
    "K3_edges_to_vertices": dict(
        wrapper=kernels.edges_to_vertices,
        source="gnn_fluid_dynamics_tpu_torch/csrc/edge_vertex.cu",
        replaces="gnn_fluid_dynamics_tpu/ops/pallas_agg.py:1090 "
                 "(_dual_colidx_kernel_chunk; per-tile _dual_colidx_kernel :137)"),
    "K4_gather_face_cells": dict(
        wrapper=kernels.gather_face_cells,
        source="gnn_fluid_dynamics_tpu_torch/csrc/face_gather.cu",
        replaces="gnn_fluid_dynamics_tpu/ops/pallas_agg.py:221 "
                 "(_dual_rowidx_kernel; banded_dual_rowidx_pallas :259, "
                 "pallas_call :281; with gather_face_cells_pallas's cast "
                 ":485)"),
    "K5_vertices_to_cells": dict(
        wrapper=kernels.vertices_to_cells,
        source="gnn_fluid_dynamics_tpu_torch/csrc/vertex_cell.cu",
        replaces="gnn_fluid_dynamics_tpu/ops/pallas_agg.py:289 "
                 "(_rowidx3_kernel; banded_rowidx3_pallas :322)"),
    "K6_table_dual": dict(
        wrapper=kernels.table_dual,
        source="gnn_fluid_dynamics_tpu_torch/csrc/table_dual.cu",
        replaces="gnn_fluid_dynamics_tpu/ops/pallas_agg.py:58 "
                 "(_dual_kernel; banded_dual_pallas :102, pallas_call :128)"),
    "K7_table_single": dict(
        wrapper=kernels.table_single,
        source="gnn_fluid_dynamics_tpu_torch/csrc/table_single.cu",
        replaces="gnn_fluid_dynamics_tpu/ops/pallas_agg.py:353 "
                 "(_single_kernel; banded_single_pallas :380, pallas_call :397)"),
}
# the main paths: model class, and the launches per step of each kernel the
# path runs (every other kernel: none)
PATHS = {
    "FluxD": (FluxD, {"K1_fused_face_block": MP_NUM,
                      "K2_fused_cell_block": MP_NUM,
                      "K3_edges_to_vertices": MP_NUM}),
    "FvgnF": (FvgnF, {"K3_edges_to_vertices": MP_NUM,
                      "K4_gather_face_cells": MP_NUM,
                      "K5_vertices_to_cells": MP_NUM}),
    "FluxD-valid": (FluxD, {"K6_table_dual": 2 * MP_NUM,
                            "K7_table_single": MP_NUM}),
    "MgnA": (MgnA, {"K1_fused_face_block": MP_NUM,
                    "K2_fused_cell_block": MP_NUM,
                    "K3_edges_to_vertices": MP_NUM}),
    "MgnA-valid": (MgnA, {"K6_table_dual": 2 * MP_NUM,
                          "K7_table_single": MP_NUM}),
}
ROLLOUT_PATHS = ("FluxD", "FvgnF", "FluxD-valid")      # phase 3
# the kernel wrappers a GN block calls, per block application, in order
# (":dual" K1/K2 with both outputs, ":roll" K6 on es/er with the roll)
BLOCK_ORDER = {
    "MgnA": ["fused_face_block:dual", "edges_to_vertices",
             "fused_cell_block"],
    "MgnA-valid": ["table_dual", "table_dual:roll", "table_single"],
}


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    say(f"FAIL: {msg}")
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def gpu_ms(fn, iters: int = TIMING_ITERS) -> float:
    """Device time per call of ``fn``: the calls are queued behind a sleep
    kernel, so the card runs them back to back however slowly the host
    issues them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)          # ~50 ms at the card's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gpu_ms_flushed(fn, iters: int = TIMING_ITERS) -> float:
    """Device time per call of ``fn`` with the L2 cache flushed before each
    call: a FLUSH_BYTES buffer is written between calls, and that write's
    own time, timed alone the same way, is subtracted."""
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

    def flushed():
        buf.zero_()
        fn()

    return gpu_ms(flushed, iters) - gpu_ms(buf.zero_, iters)


def bench_geometry():
    """The RCM-ordered 2,400-point cylinder mesh of ``bench.py``: 3,462
    cells, 5,361 faces, 1,899 vertices."""
    return rcm_reorder_geometry(make_geometry("cylinder", n_points=2400, seed=0))


def bench_mesh(device, mls: bool = False):
    """The bench mesh's graph at the first two states of a channel flow of
    CHECK_STEPS + 2 states, and that flow; with ``mls`` the graph carries
    MLS cell weights of order MLS_ORDER (MgnA's divergence metric)."""
    geom = bench_geometry()
    fields = channel_flow_trajectory(geom, num_timesteps=CHECK_STEPS + 2,
                                     dt=0.01)
    window = {k: v[:2] for k, v in fields.items()}
    if mls:
        nb, w = compute_mls_weights(geom["cell_pos"], MLS_ORDER)
        window.update(cell_grad_weights=w, cell_grad_neighbours=nb)
    graph = from_geometry(geom, window, dt=0.01, device=device)
    return graph, fields


def valid_data(device):
    """The FluxD-valid dataset and its validation batch: one trajectory of
    CHECK_STEPS + 2 channel-flow steps per seed, int8 banded tables, one
    graph on the table route (``Trainer.validate``'s
    ``to_static_bands(..., derive_idx=False)``)."""
    trajs = []
    for seed in VALID_SEEDS:
        geom = rcm_reorder_geometry(make_geometry(
            "cylinder", n_points=VALID_POINTS, seed=seed))
        fields = channel_flow_trajectory(geom, num_timesteps=CHECK_STEPS + 2,
                                         dt=0.01)
        trajs.append(Trajectory(mesh_id=f"cyl{seed}", geom=geom, fields=fields))
    ds = MeshDataset(trajs, with_banded=True, banded_dtype="int8",
                     pad_multiple=128, device=device)
    graph = to_static_bands(ds.get_batch(rollout_batch(ds)), derive_idx=False)
    return ds, graph


# K6's two forms on the table route, and K7's one: (tables, source rows'
# graph count, combine_roll)
TABLE_FORMS = {
    ("K6_table_dual", "es_roll"): (("es_onehot", "er_onehot"), "num_faces", True),
    ("K6_table_dual", "cf"): (("cf_row_onehot", "cf_col_onehot"), "num_cells",
                              False),
    ("K6_table_dual", "es_roll896"): (("es_onehot", "er_onehot"), "num_faces",
                                      True),
    ("K7_table_single", "vc"): (("vc_onehot",), "num_vertices", None),
    ("K7_table_single", "vc384"): (("vc_onehot",), "num_vertices", None),
}
# the table types each form runs on: the path's int8, and the graphs' other
# two (f32 is the datasets' default)
TABLE_TYPES = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
# forms run on tables widened to another band than the batch's (not on the
# path: held and timed only)
WIDENED = {("K6_table_dual", "es_roll896"): 896,
           ("K7_table_single", "vc384"): 384}


def table_form_bound(vg, form, tables) -> tuple:
    """(bytes, operations) of one table application at this batch's shapes:
    each table, the source and the offsets read once, the outputs written
    once; the products counted for this data's nonzero weights only (a
    multiply and an add per channel), plus K6's one add of the roll and
    K7's division."""
    (name, _), (keys, count, roll) = form, TABLE_FORMS[form]
    T, tile, band = tables[0].shape
    rows = T * tile
    width = H // 2 if name == "K7_table_single" else H
    nnz = sum(int((t != 0).sum()) for t in tables)
    nbytes = (sum(t.numel() * t.element_size() for t in tables)
              + getattr(vg, count) * width * 2 + T * 4)
    if name == "K7_table_single":
        return nbytes + rows * (H // 2) * 4, 2 * nnz * (H // 2) + rows * (H // 2)
    if roll:
        return nbytes + rows * (H // 2) * 2, 2 * nnz * (H // 2) + rows * (H // 2)
    return nbytes + 2 * rows * H * 2, 2 * nnz * H


def bounds(graph) -> dict:
    """Least time (ms) for each kernel's work at these shapes: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its operations over the peak rate for their type (the
    three products in bf16 on the tensor cores for K1/K2, the f32 adds of
    K3 and K5; K4 does none: its rounding is a conversion). K1 runs
    single-output and K2 dual-output on the main path; K4 reads f32 latents
    there (the FvgnF path's cell MLP output) and K5 stores its f32 mean."""
    F, C, V = graph.num_faces, graph.num_cells, graph.num_vertices
    vec = 5 * H * 2                                   # b0,b1,b2,ln_g,ln_b
    k1_bytes = (F * H * 2 + C * H * 2 + 2 * F * 4
                + (3 * H * H + 2 * H * H) * 2 + vec + F * H * 2)
    k1_flops = 2 * F * H * (3 * H + 2 * H)
    k2_bytes = (C * H * 2 + V * (H // 2) * 2 + 3 * C * 4
                + ((H + H // 2) * H + 2 * H * H) * 2 + vec + 2 * C * H * 2)
    k2_flops = 2 * C * H * (H + H // 2 + 2 * H)
    k3_bytes = F * H * 2 + (V + 1) * 4 + 2 * F * 4 + V * (H // 2) * 2
    k3_flops = 2 * F * (H // 2)
    k4_bytes = C * H * 4 + 2 * F * 4 + 2 * F * H * 2
    k5_bytes = V * (H // 2) * 2 + 3 * C * 4 + C * (H // 2) * 4
    k5_flops = 3 * C * (H // 2)                       # 2 adds + 1 division

    bound = _bound
    return {"K1_fused_face_block": bound(k1_bytes, k1_flops, PEAK_BF16_FLOPS),
            "K2_fused_cell_block": bound(k2_bytes, k2_flops, PEAK_BF16_FLOPS),
            "K3_edges_to_vertices": bound(k3_bytes, k3_flops, PEAK_F32_FLOPS),
            "K4_gather_face_cells": bound(k4_bytes, 0, PEAK_F32_FLOPS),
            "K5_vertices_to_cells": bound(k5_bytes, k5_flops, PEAK_F32_FLOPS)}


def _bound(nbytes, flops, peak):
    t_b, t_o = nbytes / PEAK_BYTES, flops / peak
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            nbytes, flops)


def _compare(name, got, want, exact) -> float:
    """Max abs error of the kernel's outputs against the plain version's;
    fails on a non-finite output or a difference beyond the tolerance."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rtol, atol = (0.0, 0.0) if exact else (KERNEL_RTOL, KERNEL_ATOL)
    err = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            fail(f"{name}: non-finite output")
        err = max(err, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            fail(f"{name}: kernel differs from its plain version "
                 f"(max abs err {err:.3g}, rtol {rtol}, atol {atol})")
    return err


def nan_case(what, kern, plain, tables, off, src) -> dict:
    """A dense product gives 0 x NaN = NaN, as the TPU kernel's one-hot
    product does: one source row, inside a tile's band where every table
    row of that tile weighs it 0, set to NaN. The kernel's NaN positions
    (``kern(src)``) must equal the plain version's (``plain(src)``: every
    row of each tile whose band holds the row, in the channels it reaches),
    and its other values must agree with the plain version's as in
    ``_compare``."""
    zero = sum((t != 0).sum(1) for t in tables) == 0        # (T, B)
    tiles = zero.any(1).nonzero()
    if len(tiles) == 0:
        fail(f"{what}: no tile has a band row that all its weights skip")
    t = int(tiles[0])
    col = int(zero[t].nonzero()[0])
    row = int(off[t]) + col
    bad = src.clone()
    bad[row] = float("nan")
    got, want = kern(bad), plain(bad)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    n_nan, err = 0, 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            fail(f"{what}: NaN at {int(torch.isnan(a).sum())} places where "
                 f"the plain version has {int(torch.isnan(b).sum())} (source "
                 f"row {row}, weighed 0 by tile {t})")
        n_nan += int(torch.isnan(b).sum())
        live = ~torch.isnan(b)
        err = max(err, _compare(what + " beside the NaN", a[live], b[live],
                                exact="cf" in what))
    if n_nan == 0:
        fail(f"{what}: the plain version has no NaN from source row {row}")
    return {"source_row": row, "tile": t, "n_nan": n_nan, "max_abs_err": err}


def table_phase(vg) -> dict:
    """K6 (es/er with the roll, cf without) and K7 (vc) on the FluxD-valid
    batch's own tables, int8 as the path runs them and once more cast to
    bf16 and to f32, each on seeded bf16 sources, held against its plain version (the
    cf form exactly), then timed beside it and beside one ``torch.bmm`` of
    the table (cast to bf16) by the stacked bands, both made outside the
    timed window. K6's roll form also runs on the tables widened to a band
    of 896 and K7 on the tables widened to 384, and K7 and its
    ``torch.bmm`` are timed also with L2 flushed between launches. Each
    form on the path's int8 tables also takes a NaN source row
    (``nan_case``). A kernel's top-level numbers are per launch on the int8
    tables the path runs: K6's the mean of its two forms, each launched once
    per block."""
    dev = vg.device
    rng = np.random.default_rng(1)
    srcs = {n: torch.from_numpy(rng.normal(size=(n, H)).astype(np.float32)).to(
        dev, torch.bfloat16) for n in {vg.num_faces, vg.num_cells,
                                       vg.num_vertices}}
    if int(vg.vc_onehot.max()) != 3:
        fail("the FluxD-valid batch's vc tables hold no weight of 3 (a "
             "padded cell): K7's weights are not held")
    results = {}
    for form, (keys, count, roll) in TABLE_FORMS.items():
        name, fname = form
        src = srcs[getattr(vg, count)]
        off = getattr(vg, keys[0].split("_")[0] + "_off")
        if name == "K7_table_single":
            src = src[:, :H // 2].contiguous()
        for tdt_name, tdt in TABLE_TYPES.items():
            tables = tuple(getattr(vg, k).to(tdt) for k in keys)
            if form in WIDENED:
                widened = [widen_band(t, off, WIDENED[form], src.shape[0])
                           for t in tables]
                tables = tuple(t for t, _ in widened)
                off = widened[0][1]
            # the kernel and its plain version as functions of the source
            if name == "K7_table_single":
                def kern(s, tables=tables, off=off):
                    return kernels.table_single(*tables, off, s)

                def plain(s, tables=tables, off=off):
                    return kernels.table_single_ref(*tables, off, s)
            else:
                def kern(s, tables=tables, off=off, roll=roll):
                    return kernels.table_dual(*tables, off, s, roll)

                def plain(s, tables=tables, off=off, roll=roll):
                    return kernels.table_dual_ref(*tables, off, s, roll)
            run = functools.partial(kern, src)
            ref = functools.partial(plain, src)
            err = _compare(f"{name} {fname} {tdt_name}", run(), ref(),
                           exact=fname == "cf")
            # the library yardstick: the tables as one bf16 (T, rows, B)
            # batch, times the bands (T, B, W), stacked beforehand
            oh = torch.cat([t.to(torch.bfloat16) for t in tables], dim=1)
            idx = off.long()[:, None] + torch.arange(oh.shape[2], device=dev)
            bands = src[idx]
            nbytes, flops = table_form_bound(vg, form, tables)
            lib = functools.partial(torch.bmm, oh, bands)
            results[(name, fname, tdt_name)] = r = {
                "max_abs_err": err, "ms": gpu_ms(run), "plain_ms": gpu_ms(ref),
                "library_ms": gpu_ms(lib),
                "bound": _bound(nbytes, flops, PEAK_F32_FLOPS)}
            if name == "K7_table_single":
                r["ms_l2_flushed"] = gpu_ms_flushed(run)
                r["library_ms_l2_flushed"] = gpu_ms_flushed(lib)
            del oh, bands, lib
            if tdt_name == "int8" and form not in WIDENED:
                results[(name, fname, "nan")] = nan_case(
                    f"{name} {fname}", kern, plain, tables, off, src)
    out = {}
    for name in ("K6_table_dual", "K7_table_single"):
        forms = {f"{f}_{d}": r for (n, f, d), r in results.items()
                 if n == name and d != "nan"}
        nan = {f: r for (n, f, d), r in results.items()
               if n == name and d == "nan"}
        main = [r for (n, f, d), r in results.items()
                if n == name and d == "int8" and (n, f) not in WIDENED]
        n = len(main)
        nbytes = sum(r["bound"][2] for r in main) / n
        flops = sum(r["bound"][3] for r in main) / n
        out[name] = {
            "max_abs_err": max(r["max_abs_err"] for r in forms.values()),
            "ms": sum(r["ms"] for r in main) / n,
            "plain_ms": sum(r["plain_ms"] for r in main) / n,
            "library_ms": sum(r["library_ms"] for r in main) / n,
            "bound": _bound(nbytes, flops, PEAK_F32_FLOPS),
            "forms": {f: {**{k: v for k, v in r.items() if k != "bound"},
                          "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                          "bytes": r["bound"][2], "flops": r["bound"][3]}
                      for f, r in forms.items()},
            "nan_through_zero_weight": nan,
            "unit": "per launch, the mean of " + ", ".join(
                f"{f}_int8" for (n, f) in TABLE_FORMS
                if n == name and (n, f) not in WIDENED)}
    return out


def kernel_phase(graph, index_graph) -> dict:
    """Each of K1-K5 on seeded inputs at the slice's shapes, held against
    its plain version on the same inputs, then timed beside it. K1 and K2
    in four forms each, single- and dual-output at the FluxD mesh and at
    ``index_graph`` (the FluxD-valid batch on its index route), also held
    against an f64 evaluation (``block_forms``); K3, K5 and the pair K3 ->
    K5 at both (``chain_forms``), and the launch floor; K4 in both input
    forms at both (``gather_forms``)."""
    dev = graph.device
    rng = np.random.default_rng(0)

    def latents(n):
        return torch.from_numpy(rng.normal(size=(n, H)).astype(np.float32)).to(
            dev, torch.bfloat16)

    gen = torch.Generator().manual_seed(0)
    w_face = MLP(3 * H, H, H, generator=gen).to(dev).kernel_weights(packed=True)
    w_cell = MLP(H + H // 2, H, H, generator=gen).to(dev).kernel_weights(
        packed=True)
    edges = latents(graph.num_faces)
    vtx = kernels.edges_to_vertices_ref(edges, graph)
    results = {"K4_gather_face_cells": gather_forms(graph, index_graph)}
    chain = chain_forms(graph, index_graph, latents)
    floor = floor_times(graph)
    for name, rows in (("K3_edges_to_vertices", graph.num_vertices),
                       ("K5_vertices_to_cells", graph.num_cells)):
        at_mesh = chain[name][str(rows)]
        results[name] = {
            "max_abs_err": max(f["max_abs_err"] for f in chain[name].values()),
            "ms": at_mesh["ms"], "plain_ms": at_mesh["plain_ms"],
            "forms": chain[name], "pair": chain["pair"],
            "launch_floor_ms": floor,
            "unit": "per launch at the FvgnF mesh, back to back without the "
                    "PDL attribute (with it a launch overlaps its own next "
                    "one); forms by rows; pair: K3 -> K5 by cells, with the "
                    "attribute as the path launches it and without; longest "
                    f"CSR row {chain['longest_csr_row']}"}
    # one PyTorch call computing each kernel's function where there is one;
    # timed here, never used by the port. K3: index_add_ of the (2F, H/2)
    # half-rows onto their vertices (bf16 accumulation)
    half_rows = edges.view(2 * graph.num_faces, H // 2)
    owner_of_row = graph.vertex_edge_index.T.reshape(-1)   # 2f: sender, 2f+1: receiver
    out = torch.zeros(graph.num_vertices, H // 2, device=dev,
                      dtype=torch.bfloat16)
    cell_vertices = graph.vertex_face.T.contiguous().long()
    library = {
        "K3_edges_to_vertices": lambda: out.index_add_(0, owner_of_row,
                                                       half_rows),
        # K5: the 3-vertex bag sum (bf16 out, without K5's division by 3)
        "K5_vertices_to_cells": lambda: F.embedding_bag(
            cell_vertices, vtx, mode="sum"),
    }
    for name, call in library.items():
        results[name]["library_ms"] = gpu_ms(call)
    for name, w in (("K1_fused_face_block", w_face),
                    ("K2_fused_cell_block", w_cell)):
        results[name] = block_forms(name, graph, index_graph, w, latents)
    return results


def rounding_cases(rows: int) -> torch.Tensor:
    """(rows, H) f32 latents at the edges of rounding to bf16, each row the
    one before rolled by one channel: ties between two bf16 values (to the
    even one, down and up, of either sign), values just off a tie, the
    largest finite bf16 and values beyond it (to +-Inf), subnormals (ties
    among them, and the largest, which rounds to the smallest normal), +-0,
    +-Inf and NaNs of several payloads (one whose low bits alone are set,
    which a bare round-to-nearest of the bits would make Inf); the rest of
    the row seeded normal values over many binades."""
    edges = np.array([
        0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000,      # ties
        0x3F808001, 0x3F807FFF, 0x4049_0FDB, 0xC2F6_E979,    # off a tie
        0x7F7F0000, 0x7F7F7FFF, 0x7F7F8000, 0x7F7FFFFF,      # to bf16 max, Inf
        0xFF7F8000, 0xFF7FFFFF,
        0x00000001, 0x00008000, 0x00018000, 0x00010000,      # subnormals
        0x007FFFFF, 0x807F8000, 0x80018000,
        0x00000000, 0x80000000, 0x7F800000, 0xFF800000,      # +-0, +-Inf
        0x7FC00000, 0x7F800001, 0xFFC00001, 0x7FFFFFFF,      # NaNs
    ], dtype=np.uint32).view(np.float32)
    rng = np.random.default_rng(4)
    rest = (rng.normal(size=H - len(edges))
            * np.exp2(rng.integers(-120, 120, size=H - len(edges))))
    row = np.concatenate([edges, rest.astype(np.float32)])
    return torch.from_numpy(np.stack([np.roll(row, r) for r in range(rows)]))


def gather_forms(graph, index_graph) -> dict:
    """K4 at the FvgnF mesh and at ``index_graph`` (the FluxD-valid batch on
    its index route), on seeded f32 latents, which are not bf16-exact, and
    on the same rounded to bf16: each form held exactly against its plain
    version, then timed back to back beside it, and on f32 beside the
    sequence it replaces (the cast to bf16, K4 on bf16, both rows widened
    to f32, which FvgnF's face block ran before K4 rounded its input), one
    ``index_select`` of the f32 latents (both rows of every face, unrounded)
    and the launch floor at K4's grid (an empty kernel without the PDL
    attribute, as K4 launches). Also at the mesh on ``rounding_cases``
    (``rounding_check``). The top-level numbers are the FvgnF path's form,
    f32 at the mesh."""
    rng = np.random.default_rng(2)
    forms, floor = {}, {}
    for g in (graph, index_graph):
        nf = g.num_faces
        x32 = torch.from_numpy(rng.normal(size=(g.num_cells, H)).astype(
            np.float32)).to(g.device)
        f32_bytes = bounds(g)["K4_gather_face_cells"][2]
        for dname, x in (("f32", x32), ("bf16", x32.to(torch.bfloat16))):
            run = functools.partial(kernels.gather_face_cells, x, g)
            ref = functools.partial(kernels.gather_face_cells_ref, x, g)
            got, want = run(), ref()
            torch.cuda.synchronize()
            nbytes = f32_bytes - (g.num_cells * H * 2 if dname == "bf16" else 0)
            b_ms, b_by, _, _ = _bound(nbytes, 0, PEAK_F32_FLOPS)
            forms[f"{dname}_{nf}"] = {
                "max_abs_err": _compare(f"K4_gather_face_cells {dname} at {nf} "
                                        "faces", got, want, exact=True),
                "ms": gpu_ms(run, FLOOR_ITERS), "plain_ms": gpu_ms(ref),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}

        def replaced(x32=x32, g=g):
            own, nbr = kernels.gather_face_cells(x32.to(torch.bfloat16), g)
            return own.float(), nbr.float()

        form = forms[f"f32_{nf}"]
        form["replaced_ms"] = gpu_ms(replaced, FLOOR_ITERS)
        form["library_ms"] = gpu_ms(functools.partial(
            torch.index_select, x32, 0, g.cell_edge_index.view(-1)), FLOOR_ITERS)
        run = functools.partial(kernels.launch_floor, g.device,
                                -(-nf // K4_FACES_PER_BLOCK), 256)
        with kernels.without_pdl():
            floor[str(nf)] = gpu_ms(run, FLOOR_ITERS)
    main = forms[f"f32_{graph.num_faces}"]
    return {
        "max_abs_err": max(f["max_abs_err"] for f in forms.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "library_ms": main["library_ms"], "replaced_ms": main["replaced_ms"],
        "forms": forms, "launch_floor_ms": floor,
        "rounding_cases": rounding_check(graph),
        "unit": "per launch at the FvgnF mesh on f32 latents (the path's "
                "form), back to back; forms by input dtype and faces; "
                "replaced_ms: cast to bf16, K4 on bf16, both rows widened to "
                "f32; launch floor by faces, an empty kernel at K4's grid"}


def rounding_check(graph) -> dict:
    """K4 on ``rounding_cases`` at ``graph``'s cells against its plain version:
    NaN at the same places, every other output identical bit for bit. Fails
    unless the plain outputs hold NaN, +-Inf from finite inputs beyond
    bf16's range, and nonzero subnormals. Returns those counts."""
    x = rounding_cases(graph.num_cells).to(graph.device)
    got = kernels.gather_face_cells(x, graph)
    want = kernels.gather_face_cells_ref(x, graph)
    for out, a, b in zip(("own", "nbr"), got, want):
        nan = torch.isnan(b)
        if not torch.equal(torch.isnan(a), nan):
            fail(f"K4 on the rounding cases: NaN at {int(torch.isnan(a).sum())} "
                 f"{out} outputs where the plain version has {int(nan.sum())}")
        differ = int((a.view(torch.int16) != b.view(torch.int16))[~nan].sum())
        if differ:
            fail(f"K4 on the rounding cases: {differ} {out} outputs differ "
                 "from the plain version's in their bits")
    b = want[0]
    counts = {"nan": int(torch.isnan(b).sum()),
              "inf_from_finite": int((torch.isinf(b)
                                      & torch.isfinite(x[graph.cell_edge_index[0]])
                                      ).sum()),
              "subnormal": int(((b != 0) & (b.abs() < 2.0 ** -126)).sum())}
    if not all(counts.values()):
        fail(f"K4 on the rounding cases: an edge is not reached {counts}")
    return counts


def csr_longest_row(g) -> int:
    """The most incidences of one vertex in ``g``'s CSR (the pad vertex of a
    padded graph holds about 2 per padded face)."""
    return int((g.vertex_inc_ptr[1:] - g.vertex_inc_ptr[:-1]).max())


def chain_forms(graph, index_graph, latents) -> dict:
    """K3 and K5 at the FvgnF mesh and at ``index_graph`` (the FluxD-valid
    batch on its index route), and the pair K3 -> K5 as FvgnF issues it,
    each held against its plain version and timed back to back. K3 and K5
    alone are timed without the PDL attribute: with it a kernel timed alone
    overlaps its own next launch, which no path does. The pair is timed
    with the attribute (each K3 may start as the K5 before it ends, as it
    may behind the kernel ahead of it in FvgnF's step) and without. Fails if
    the batch's longest CSR row fits in one of K3's rounds (32 incidences)."""
    longest = csr_longest_row(index_graph)
    if longest <= 32:
        fail(f"the padded batch's longest CSR row has {longest} incidences: "
             "K3's round loop is not held")
    out = {"K3_edges_to_vertices": {}, "K5_vertices_to_cells": {}, "pair": {}}
    for g in (graph, index_graph):
        edges = latents(g.num_faces)
        vtx = kernels.edges_to_vertices_ref(edges, g)
        k3 = functools.partial(kernels.edges_to_vertices, edges, g)
        k3_ref = functools.partial(kernels.edges_to_vertices_ref, edges, g)
        k5 = functools.partial(kernels.vertices_to_cells, vtx, g)
        k5_ref = functools.partial(kernels.vertices_to_cells_ref, vtx, g)

        def pair(edges=edges, g=g):
            return kernels.vertices_to_cells(kernels.edges_to_vertices(edges, g), g)

        def pair_ref(vtx=vtx, g=g):
            return kernels.vertices_to_cells_ref(vtx, g)

        bnd = bounds(g)
        b3, b5 = bnd["K3_edges_to_vertices"], bnd["K5_vertices_to_cells"]
        bnd["pair"] = _bound(b3[2] + b5[2], b3[3] + b5[3], PEAK_F32_FLOPS)
        for name, run, ref, rows in (
                ("K3_edges_to_vertices", k3, k3_ref, g.num_vertices),
                ("K5_vertices_to_cells", k5, k5_ref, g.num_cells),
                ("pair", pair, pair_ref, g.num_cells)):
            got, want = run(), ref()
            torch.cuda.synchronize()
            with kernels.without_pdl():
                ms_no_pdl = gpu_ms(run, FLOOR_ITERS)
            form = {"max_abs_err": _compare(f"{name} at {rows} rows", got,
                                            want, exact=False),
                    "ms": ms_no_pdl, "plain_ms": gpu_ms(ref),
                    "bound_ms": bnd[name][0], "bound_by": bnd[name][1]}
            if name == "pair":
                form["ms_no_pdl"] = ms_no_pdl
                form["ms"] = gpu_ms(run, FLOOR_ITERS)
            out[name][str(rows)] = form
    out["longest_csr_row"] = {"mesh": csr_longest_row(graph),
                              "batch": longest}
    return out


def floor_times(graph) -> dict:
    """ms per launch of an empty kernel back to back (as ``gpu_ms`` times),
    without and with the programmatic dependent launch attribute, at one
    block of 32 threads and at K3's grid on ``graph`` (a warp per vertex,
    8 per block)."""
    dev = graph.device
    out = {}
    for shape, (blocks, threads) in (("1x32", (1, 32)),
                                     ("k3_grid", ((graph.num_vertices + 7) // 8,
                                                  256))):
        run = functools.partial(kernels.launch_floor, dev, blocks, threads)
        with kernels.without_pdl():
            out[f"plain_{shape}"] = gpu_ms(run, FLOOR_ITERS)
        out[f"pdl_{shape}"] = gpu_ms(run, FLOOR_ITERS)
    return out


def pdl_hazard_check(graph) -> dict:
    """K3 and K5 start before the kernel ahead of them ends, and must not
    read its output before their wait. For HAZARD_ROUNDS rounds a writer
    that lets the next launch start at its own start, then idles
    HAZARD_CYCLES clock cycles, writes fresh edge latents (the sign flipped
    every round) into the buffer K3 reads right after it; then K5. K3 thus
    runs its prologue beside the writer, and K5 beside K3. Every round's
    vertex sums and cell means must agree with the plain versions on that
    round's edges. Also times a round (writer, K3, K5) back to back with
    and without the PDL attribute."""
    dev = graph.device
    gen = torch.Generator(device=dev).manual_seed(3)
    base = torch.empty(graph.num_faces, H, dtype=torch.bfloat16,
                       device=dev).normal_(generator=gen)
    edges = torch.zeros_like(base)

    def round_(r):
        kernels.slow_writer(base, edges, bool(r % 2), HAZARD_CYCLES)
        vtx = kernels.edges_to_vertices(edges, graph)
        return vtx, kernels.vertices_to_cells(vtx, graph)

    rounds = []
    torch.cuda.synchronize()
    for r in range(HAZARD_ROUNDS):
        rounds.append(round_(r))
    torch.cuda.synchronize()
    err = 0.0
    for r, (vtx, cells) in enumerate(rounds):
        e = -base if r % 2 else base
        err = max(err,
                  _compare(f"PDL hazard round {r}: K3", vtx,
                           kernels.edges_to_vertices_ref(e, graph), False),
                  _compare(f"PDL hazard round {r}: K5", cells,
                           kernels.vertices_to_cells_ref(vtx, graph), False))
    with kernels.without_pdl():
        round_no_pdl = gpu_ms(functools.partial(round_, 0), 20)
    return {"rounds": HAZARD_ROUNDS, "writer_idle_cycles": HAZARD_CYCLES,
            "max_abs_err": err,
            "ms_per_round": gpu_ms(functools.partial(round_, 0), 20),
            "ms_per_round_no_pdl": round_no_pdl}


def k1_k3_hazard_check(graph) -> dict:
    """MgnA's face-first block launches K3, by programmatic dependent
    launch, right behind K1 with both outputs, and K3 reads K1's raw
    output: it must not read it before its wait. For HAZARD_ROUNDS rounds
    K1 (dual) on seeded latents, the edge latents' sign flipped every
    round, then K3 on its raw output; only the raw outputs and the vertex
    sums are kept, so a round's raw buffer may be memory an earlier
    round's freed output held. Every round's vertex sums must agree with
    K3's plain version on that round's raw output. Also times a round with
    and without the PDL attribute."""
    dev = graph.device
    gen = torch.Generator(device=dev).manual_seed(4)
    cells = torch.empty(graph.num_cells, H, dtype=torch.bfloat16,
                        device=dev).normal_(generator=gen)
    edges = torch.empty(graph.num_faces, H, dtype=torch.bfloat16,
                        device=dev).normal_(generator=gen)
    inputs = (edges, -edges)
    w = MLP(3 * H, H, H, generator=torch.Generator().manual_seed(5)).to(
        dev).kernel_weights(packed=True)

    def round_(r):
        raw, _ = kernels.fused_face_block(cells, inputs[r % 2], graph, w,
                                          dual_out=True)
        return raw, kernels.edges_to_vertices(raw, graph)

    torch.cuda.synchronize()
    rounds = [round_(r) for r in range(HAZARD_ROUNDS)]
    torch.cuda.synchronize()
    err = 0.0
    for r, (raw, vtx) in enumerate(rounds):
        err = max(err, _compare(f"K1 -> K3 hazard round {r}", vtx,
                                kernels.edges_to_vertices_ref(raw, graph),
                                False))
    del rounds
    with kernels.without_pdl():
        round_no_pdl = gpu_ms(functools.partial(round_, 0), 20)
    return {"rounds": HAZARD_ROUNDS, "max_abs_err": err,
            "ms_per_round": gpu_ms(functools.partial(round_, 0), 20),
            "ms_per_round_no_pdl": round_no_pdl}


# the fused blocks: their wrapper, plain version, the rows they write, and
# whether the FluxD path runs them with the dual output
BLOCKS = {
    "K1_fused_face_block": (kernels.fused_face_block,
                            kernels.fused_face_block_ref, "num_faces", False),
    "K2_fused_cell_block": (kernels.fused_cell_block,
                            kernels.fused_cell_block_ref, "num_cells", True),
}


def block_exact(name, c, x, g, w) -> tuple:
    """A fused block's function in f64 with the plain version's bf16
    rounding points (the gathered input row, the hidden activations before
    each product): (raw, res), unrounded. K1 reads ``[x | c[owner] |
    c[neighbour]]`` with ``x`` the edge latents; K2 ``[c | mean of 3 rows
    of x]`` with ``x`` K3's vertex sums, the mean rounded to bf16."""
    m = w.mlp
    if name == "K1_fused_face_block":
        own, nbr = g.cell_edge_index[0].long(), g.cell_edge_index[1].long()
        row, base = torch.cat([x, c[own], c[nbr]], 1), x
    else:
        vf = g.vertex_face.long()
        v = x.double()
        agg = ((v[vf[0]] + v[vf[1]] + v[vf[2]]) / 3.0).to(torch.bfloat16)
        row, base = torch.cat([c, agg], 1), c
    h = row.double() @ m.w0.double() + m.b0.double()
    for wk, bk in ((m.w1, m.b1), (m.w2, m.b2)):
        h = F.silu(h).to(torch.bfloat16).double() @ wk.double() + bk.double()
    mu = h.mean(1, keepdim=True)
    var = (h * h).mean(1, keepdim=True) - mu * mu
    hn = ((h - mu) / torch.sqrt(var + kernels.LN_EPS) * m.ln_g.double()
          + m.ln_b.double())
    return hn, base.double() + hn


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at each |x| (8 significant bits)."""
    _, exp = torch.frexp(x)
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), exp - 8))


def _compare_block(name, got, want, exact) -> tuple:
    """A fused block's outputs against the plain version's, as ``_compare``,
    and both against the block's f64 evaluation ``exact``: an element
    beyond KERNEL_RTOL / KERNEL_ATOL of the plain version passes only where
    the kernel is no further from the f64 value than the plain version's
    largest distance from it plus one bf16 step at that value. Two f32
    evaluations round a hidden bf16 activation differently now and then,
    and LayerNorm amplifies it in rows of small variance; the f64
    evaluation says which of them is off. Returns (max abs err, readings
    per output)."""
    err, readings = 0.0, {}
    for out, a, b, x in zip(("raw", "res") if len(got) == 2 else ("res",),
                            got, want, exact):
        a, b = a.double(), b.double()
        if not torch.isfinite(a).all():
            fail(f"{name}: non-finite {out}")
        err = max(err, float((a - b).abs().max()))
        beyond = ~torch.isclose(a, b, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        plain_err = float((b - x).abs().max())
        kern_err = (a - x).abs()
        readings[out] = {"n_beyond_plain": int(beyond.sum()),
                         "max_err_vs_f64": float(kern_err.max()),
                         "plain_max_err_vs_f64": plain_err}
        off = beyond & (kern_err > plain_err + bf16_step(x))
        if off.any():
            fail(f"{name} {out}: {int(off.sum())} elements beyond "
                 f"{KERNEL_RTOL} of the plain version and further from the "
                 f"f64 evaluation than the plain version ({plain_err:.3g}) "
                 f"plus one bf16 step; readings {json.dumps(readings)}")
    return err, readings


def block_forms(name, graph, index_graph, w, latents) -> dict:
    """A fused block's four forms: single- and dual-output at the FluxD mesh
    and at ``index_graph``, on seeded latents (K2 on K3's vertex sums of
    seeded edge latents); each held against its plain version and its f64
    evaluation (``_compare_block``), timed beside the plain version, with
    its bound. The block's top-level numbers are those of the FluxD path's
    form (K1 single-, K2 dual-output)."""
    run_fn, ref_fn, count, main_dual = BLOCKS[name]
    forms = {}
    for g in (graph, index_graph):
        c = latents(g.num_cells)
        x = latents(g.num_faces)
        if name == "K2_fused_cell_block":
            x = kernels.edges_to_vertices_ref(x, g)
        exact = block_exact(name, c, x, g, w)
        for dual in (False, True):
            fname = f"{'dual' if dual else 'single'}_{getattr(g, count)}"
            run = functools.partial(run_fn, c, x, g, w, dual)
            ref = functools.partial(ref_fn, c, x, g, w, dual)
            got, want = run(), ref()
            got, want = (got, want) if dual else ((got,), (want,))
            err, readings = _compare_block(f"{name} {fname}", got, want,
                                           exact if dual else exact[1:])
            del got, want
            _, _, nbytes, flops = bounds(g)[name]
            # bounds() counts K1 single- and K2 dual-output
            out_bytes = getattr(g, count) * H * 2
            if dual and not main_dual:
                nbytes += out_bytes
            elif main_dual and not dual:
                nbytes -= out_bytes
            forms[fname] = {"ms": gpu_ms(run), "plain_ms": gpu_ms(ref),
                            "max_abs_err": err, "vs_f64": readings,
                            "bound": _bound(nbytes, flops, PEAK_BF16_FLOPS)}
        del exact
    main = f"{'dual' if main_dual else 'single'}_{getattr(graph, count)}"
    return {
        "max_abs_err": max(f["max_abs_err"] for f in forms.values()),
        "ms": forms[main]["ms"], "plain_ms": forms[main]["plain_ms"],
        "bound": forms[main]["bound"],
        "forms": {f: {**{k: v for k, v in r.items() if k != "bound"},
                      "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                      "bytes": r["bound"][2], "flops": r["bound"][3]}
                  for f, r in forms.items()},
        "unit": f"per launch, {main} (the FluxD path's form)"}


def check_against_plain(kern, plain, graph, feats, index_graph=None) -> dict:
    """The kernel and the plain route of the same model, step by step on the
    same inputs: each step's predicted fields from both, then the plain
    route's state fed back. (Free-running, the two would drift apart: with
    random weights the model amplifies any difference step over step.)
    Returns, per comparison, the largest difference of each field relative
    to its largest magnitude.

    With ``index_graph``, the same batch on the index route (fused K1-K3),
    the kernel route runs there too, a second witness: the index route
    against the plain route, and the table route against the index route on
    live rows (``cell_mask``/``face_mask``; a padded cell takes its pad
    vertex three times on the table route and once on the index route).
    The table route against the plain route is also read on live rows."""
    worst = {}

    def note(name, key, a, b, mask=None):
        if mask is not None:
            a, b = a[mask], b[mask]
        rel = float((a - b).abs().max() / b.abs().max())
        worst.setdefault(name, {})
        worst[name][key] = max(worst[name].get(key, 0.0), rel)

    with torch.inference_mode():
        for _ in range(CHECK_STEPS):
            sol_p = plain.derive_state(plain.forward(graph, feats), feats, graph)
            sol_k = kern.derive_state(kern.forward(graph, feats), feats, graph)
            sol_i = None if index_graph is None else kern.derive_state(
                kern.forward(index_graph, feats), feats, index_graph)
            for key in SAVABLE_FIELDS:
                if key not in sol_p:
                    continue
                a, b = sol_k[key].float(), sol_p[key].float()
                if not torch.isfinite(a).all():
                    fail(f"kernel route: non-finite {key}")
                note("kernel_vs_plain", key, a, b)
                if sol_i is None:
                    continue
                c = sol_i[key].float()
                if not torch.isfinite(c).all():
                    fail(f"index route: non-finite {key}")
                live = graph.cell_mask if key.startswith("cell") else graph.face_mask
                note("kernel_vs_plain_live", key, a, b, live)
                note("index_vs_plain", key, c, b)
                note("table_vs_index_live", key, a, c, live)
            feats = plain.update_features(sol_p, feats, graph)
    for name, fields in worst.items():
        for key, rel in fields.items():
            if rel > STEP_TOL:
                fail(f"{name}, {key}: {rel:.3g} > {STEP_TOL}")
    return worst


def rollout_errors_check(fields, mls: bool = False):
    """FluxD, FvgnF and MgnA: a CHECK_STEPS-step rollout of the kernel route
    against the channel flow, with the error metrics and every saved field
    finite. With ``mls`` (MgnA), the divergence error must be the MLS one:
    the graph carries the weights, and the last step's error equals the
    mean square of ``divergence_from_uc`` of the saved cell velocity over
    live cells (1e-5 relative) and is not 0."""
    def check(path, kern, plain, graph, feats):
        dev = graph.device
        gv = torch.from_numpy(fields["cell_velocity"][1:CHECK_STEPS + 1]).to(dev)
        gp = torch.from_numpy(fields["cell_pressure"][1:CHECK_STEPS + 1]).to(dev)
        errors, saved = rollout_scan(kern, graph, feats, gv, gp, RolloutConfig(
            num_steps=CHECK_STEPS, compute_error=True, save_fields=True))
        for key, val in {**errors, **saved}.items():
            if not torch.isfinite(val).all():
                fail(f"{path} rollout: non-finite {key}")
        if not mls:
            return
        if graph.cell_grad_weights is None:
            fail(f"{path}: the graph carries no MLS weights")
        div = fvm.divergence_from_uc(saved["cell_velocity"][-1],
                                     graph.cell_grad_weights,
                                     graph.cell_grad_neighbours,
                                     graph.cell_volume)
        want = float((div[graph.cell_mask] ** 2).mean())
        got = float(errors["divergence_error"][-1, 0])
        if not (got > 0 and abs(got - want) <= 1e-5 * want):
            fail(f"{path}: divergence error {got}, the MLS divergence of the "
                 f"saved velocity gives {want}")
        say(f"phase 6b-a' {path} {CHECK_STEPS}-step rollout with the error "
            "metrics: finite; its divergence error is the MLS one, by step "
            + json.dumps([float(f"{v:.6g}") for v in
                          errors["divergence_error"][:, 0].tolist()]))
    return check


def validate_check(ds, phase: str = "3a'"):
    """FluxD-valid: ``validate(model, ds, CHECK_STEPS)`` on both routes, the
    trainer's validation run free for CHECK_STEPS steps; every error finite,
    and the two routes' ``total_mean_error`` and each trajectory's mean
    velocity and pressure errors within STEP_TOL of each other (relative).
    With random weights the pressure error is near 1 and swamps the total;
    the velocity error is the one a wrong kernel would move. Phase 3a, step
    by step on every field, is the kernels' sharper gate."""
    def check(path, kern, plain, graph, feats):
        out = {}
        for route, model in (("kernel", kern), ("plain", plain)):
            flat = validate(model, ds, CHECK_STEPS)
            errors = validation_errors(model, ds, CHECK_STEPS)
            if not all(np.isfinite(v) for v in flat.values()):
                fail(f"{path} validate on the {route} route: non-finite "
                     f"{flat}")
            out[route] = {
                "total_mean_error": flat["total_mean_error"],
                "per_sim_mean": {
                    sid: {k: float(errors[k][:, i].mean())
                          for k in ("velocity_error", "pressure_error")}
                    for i, sid in enumerate(ds.sim_ids())}}
        pairs = {"total_mean_error": tuple(
            out[r]["total_mean_error"] for r in ("kernel", "plain"))}
        for sid in ds.sim_ids():
            for k in ("velocity_error", "pressure_error"):
                pairs[f"{sid}/{k}"] = tuple(out[r]["per_sim_mean"][sid][k]
                                            for r in ("kernel", "plain"))
        rel = {name: abs(k - p) / abs(p) for name, (k, p) in pairs.items()}
        for name, r in rel.items():
            if r > STEP_TOL:
                fail(f"{path} validate: {name} {pairs[name][0]} (kernel) vs "
                     f"{pairs[name][1]} (plain), {r:.3g} > {STEP_TOL}")
        say(f"phase {phase} {path} validate(model, ds, {CHECK_STEPS}) on both "
            "routes: ok, relative differences "
            + json.dumps({k: round(v, 6) for k, v in rel.items()}) + " "
            + json.dumps(out))
    return check


def path_models(path: str, graph):
    """``path``'s model on the kernel route and on the plain route, with the
    same seeded weights and statistics from ``graph``'s features, and those
    features."""
    cls = PATHS[path][0]
    dev = graph.device
    cfg = ModelConfig(name=cls.name, hidden_width=H, mp_num=MP_NUM,
                      aggregation="pallas", compute_dtype="bfloat16")
    kern = cls(cfg, device=dev, seed=0)
    plain = cls(dataclasses.replace(cfg, aggregation="segment"), device=dev,
                seed=0)
    _, feats = kern.transform_rollout(graph)
    acc = StatsAccumulator(kern.nmap)
    acc.update(feats, feature_masks(graph, feats))
    stats = acc.finalize()
    kern.set_stats(stats)
    plain.set_stats(stats)
    plain.module.load_state_dict(kern.module.state_dict())
    return kern, plain, feats


def zero_launches() -> None:
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0


def launch_counts() -> dict:
    return {name: spec["wrapper"].launches for name, spec in KERNELS.items()}


def slice_phase(path: str, graph, errors_check, device_line: str,
                index_graph=None, phase: str = "3") -> dict:
    """One path's rollout through the kernels: first held against the plain
    route (and, with ``index_graph``, against the index route of the same
    batch), then timed with the launch counters read around it. Its lines
    are phase 3a-3c, or ``<phase>-a`` to ``-c`` for a later phase; a path
    of BLOCK_ORDER is also held to its kernels' order within a step."""
    def tag(sub):
        return f"3{sub}" if phase == "3" else f"{phase}-{sub}"

    per_step = PATHS[path][1]
    kern, plain, feats = path_models(path, graph)
    worst = check_against_plain(kern, plain, graph, feats, index_graph)
    order = ""
    if path in BLOCK_ORDER:
        calls = launch_order(kern, graph, feats)
        if calls != BLOCK_ORDER[path] * MP_NUM:
            fail(f"{path}: kernels called in the order {calls}, expected "
                 f"{BLOCK_ORDER[path]} per block application")
        order = (f"; kernels in each of the {MP_NUM} block applications in "
                 "the order " + " -> ".join(BLOCK_ORDER[path]))
    say(f"phase {tag('a')} {path} kernel vs plain route, {CHECK_STEPS} steps on the "
        "same inputs: ok " + json.dumps(
            {n: {k: round(v, 6) for k, v in f.items()}
             for n, f in worst.items()}) + order)
    errors_check(path, kern, plain, graph, feats)

    # timed: plain, kernel (the main path, counters read around it), kernel,
    # plain — both routes in turns on the same card
    for model in (plain, kern):                                    # warm-up
        rollout_scan(model, graph, feats, config=RolloutConfig(
            num_steps=5, compute_error=False))
    walls = {"plain": [timed_rollout(plain, graph, feats)]}
    zero_launches()
    walls["kernel"] = [timed_rollout(kern, graph, feats)]
    launches = launch_counts()
    walls["kernel"].append(timed_rollout(kern, graph, feats))
    walls["plain"].append(timed_rollout(plain, graph, feats))
    for name, n in launches.items():
        want = per_step.get(name, 0) * STEPS
        if n != want:
            fail(f"{path}: {name} launched {n} times in {STEPS} steps, "
                 f"expected {want}")
    wall = walls["kernel"][0]
    say(f"phase {tag('b')} {path} h{H} mp{MP_NUM} bf16, {graph.num_cells} cells "
        f"{graph.num_faces} faces {graph.num_vertices} vertices, {STEPS} steps "
        f"in {wall:.4f} s = {STEPS / wall:.1f} steps/s, "
        f"{1e3 * wall / STEPS:.4f} ms/step; launches {json.dumps(launches)}; "
        "steps/s in turns plain, kernel, kernel, plain: "
        + ", ".join(f"{STEPS / w:.1f}" for w in (walls["plain"][0],
                                                 *walls["kernel"],
                                                 walls["plain"][1]))
        + f"; card {device_line}")
    prof = device_profile(kern, graph, feats)
    say(f"phase {tag('c')} {path} device profile of 10 kernel-route steps: "
        + ("not measured" if prof is None else json.dumps(prof)))
    return {"launches": launches, "steps_per_s": STEPS / wall,
            "ms_per_step": 1e3 * wall / STEPS,
            "profile": prof}


def launch_order(model, graph, feats) -> list:
    """The kernel wrappers one rollout-mode forward of ``model`` calls, in
    order (each wrapper's name, with ":dual" for both outputs and ":roll"
    for K6's roll form), read by wrapping the wrappers for the call. A
    wrapper counts its launches on the module attribute of its name, so
    each stand-in carries a counter of its own, which is dropped: this
    probe is not a main-path run. The counters mean something only between
    ``zero_launches()`` and ``launch_counts()``."""
    log = []
    saved = {name: getattr(kernels, name) for name in (
        "fused_face_block", "fused_cell_block", "edges_to_vertices",
        "gather_face_cells", "vertices_to_cells", "table_dual",
        "table_single")}

    def wrap(name, fn):
        def call(*args, **kw):
            log.append(name + (":dual" if kw.get("dual_out") else
                               ":roll" if kw.get("combine_roll") else ""))
            return fn(*args, **kw)
        call.launches = 0
        return call

    stand_ins = {name: wrap(name, fn) for name, fn in saved.items()}
    try:
        for name, call in stand_ins.items():
            setattr(kernels, name, call)
        with torch.inference_mode():
            model.forward(graph, feats)
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)
    return log


def timed_rollout(model, graph, feats) -> float:
    """Wall seconds of a STEPS-step rollout (no error metrics, as bench.py),
    ending in a synchronize; fails on a non-finite final state."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = rollout_scan(model, graph, feats, config=RolloutConfig(
        num_steps=STEPS, compute_error=False))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not torch.isfinite(out["final_cell_state"]).all():
        fail("timed rollout: non-finite final state")
    return wall


def device_profile(model, graph, feats, steps: int = 10):
    """``profile_steps`` over a short rollout of ``steps`` steps."""
    cfg = RolloutConfig(num_steps=steps, compute_error=False)
    return profile_steps(
        lambda: rollout_scan(model, graph, feats, config=cfg), steps)


def profile_steps(run, steps: int):
    """Device time per step by kernel name over ``run()``, which takes
    ``steps`` steps (the 8 largest kernels, and each of this package's), and
    the share of the window's wall time with a kernel running, from
    torch.profiler (device activity only); None where the profiler shows no
    device time. The device time per step is the sum of the kernels' spans,
    and also their union: a kernel launched by PDL starts before the one
    ahead of it ends (its prologue, then its wait), so the sum counts that
    overlap twice."""
    from torch.profiler import ProfilerActivity, profile
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as exc:  # measurement only: report, do not fail the run
        say(f"profiler unavailable: {exc!r}")
        return None
    if not events:
        return None
    per_name = {}
    for e in events:
        per_name[e.name] = per_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    busy = sum(per_name.values())
    union, reach = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in events):
        if end > reach:
            union += end - max(start, reach)
            reach = end
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    # this package's kernels: "gfd::name(...)", or "void gfd::name<...>(...)"
    # for a template
    ours = {n.split("(")[0].removeprefix("void "): t
            for n, t in per_name.items() if "gfd::" in n.split("(")[0]}
    return {"busy_share": busy / wall_us,
            "device_ms_per_step": busy / steps / 1e3,
            "device_union_ms_per_step": union / steps / 1e3,
            "wall_ms_per_step": wall_us / steps / 1e3,
            "kernels_per_step": len(events) / steps,
            "top_ms_per_step": {n[:60]: t / steps / 1e3 for n, t in top},
            "gfd_ms_per_step": {n: t / steps / 1e3 for n, t in ours.items()}}


# ---- phase 5: training ------------------------------------------------------

def train_data(device, steps: int = TRAIN_STEPS) -> MeshDataset:
    """Phase 5's training set: one RCM-ordered TRAIN_POINTS-point cylinder
    mesh per seed of TRAIN_SEEDS, each with a channel-flow trajectory of
    ``steps`` + 1 states, so that an epoch of ``balanced_chunked`` batches
    of 4 (one sample of each mesh) is ``steps`` steps."""
    trajs = []
    for seed in TRAIN_SEEDS:
        geom = rcm_reorder_geometry(make_geometry(
            "cylinder", n_points=TRAIN_POINTS, seed=seed))
        fields = channel_flow_trajectory(geom, num_timesteps=steps + 1,
                                         dt=0.01)
        trajs.append(Trajectory(mesh_id=f"cyl{seed}", geom=geom, fields=fields))
    return MeshDataset(trajs, device=device)


def train_config(name: str, steps: int):
    """``config/train.json`` as phase 5 trains it: model ``name`` at its
    shipped width and depth, bf16, its optimizer, clip, schedule, loss
    weights and noise; the ``auto`` aggregation, so that its validation
    rollout takes the kernel route (a train step never does); one epoch of
    ``steps`` steps of batch 4, a mini-epoch per step, validation and a
    checkpoint at the last; statistics over every 4th sample, not cached."""
    cfg = load_config(TRAIN_CONFIG)
    cfg.model.name = name
    cfg.model.aggregation = "auto"
    cfg.model.compute_dtype = "bfloat16"
    cfg.training.epochs = 1
    cfg.training.batch_size = cfg.training.mini_epoch_size = len(TRAIN_SEEDS)
    cfg.logging.valid_frequency = cfg.logging.save_frequency = steps
    cfg.logging.name = f"{name}-chip-smoke"
    cfg.dataset.stats_fpath = None
    cfg.dataset.stats_stride = 4
    return cfg


def build_trainer(cfg, ds, checkpointer=None):
    """The model of ``cfg`` on ``ds``'s device with statistics from ``ds``,
    a trainer logging to SMOKE_DIR, and its initial state."""
    model = train_cli.build_model(cfg, ds.device)
    stats = train_cli.compute_stats(cfg, model, ds)
    model.set_stats(stats)
    train_cli.set_noise_std(cfg, stats)
    logger = Logger(cfg, base_dir=os.path.join(SMOKE_DIR, "runs"))
    trainer = Trainer(cfg, model, logger=logger, checkpointer=checkpointer)
    return trainer, trainer.init_state()


def logged(trainer, key: str) -> list:
    """Every value of ``key`` in the trainer's metrics, in order."""
    with open(trainer.logger.metrics_path) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


def fluxd_training(train_ds, valid_ds, device_line: str) -> dict:
    """Phase 5a: ``Trainer.run`` of FluxD, its kernel launches counted
    around each validation and across the train steps, the losses read from
    its log, the checkpoint read back, the validation held against the
    plain route; then the timed steps, their profile and peak memory."""
    cfg = train_config("FluxD", TRAIN_STEPS)
    ckpt = Checkpointer(os.path.join(SMOKE_DIR, "ckpt"))
    trainer, state = build_trainer(cfg, train_ds, ckpt)
    t = cfg.training
    sched = get_schedule(t.lr_class, t, TRAIN_STEPS)
    say(f"phase 5a FluxD h{H} mp{MP_NUM} bf16, {trainer.model.count_parameters():,}"
        f" parameters, {t.optimizer_name} clip {t.clip_grad_norm}, noise std "
        f"{t.noise_std:.6g}; {t.lr_class} over {TRAIN_STEPS} mini-epochs of one "
        "step, lr by mini-epoch: "
        + json.dumps([float(f"{sched(i):.4g}") for i in range(TRAIN_STEPS)]))

    valid_launches = []
    validate_fn = trainer.validate

    def counted_validate(*args, **kw):
        before = launch_counts()
        out = validate_fn(*args, **kw)
        valid_launches.append({k: v - before[k]
                               for k, v in launch_counts().items()})
        return out

    trainer.validate = counted_validate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    trainer.run(state, train_ds, valid_ds, num_valid_steps=CHECK_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_launches = launch_counts()
    run_peak = torch.cuda.max_memory_allocated()
    trainer.validate = validate_fn

    per_valid = {name: PATHS["FluxD-valid"][1].get(name, 0) * CHECK_STEPS
                 for name in KERNELS}
    if len(valid_launches) != 2 or any(v != per_valid for v in valid_launches):
        fail(f"FluxD-train: launches per validation {valid_launches}, expected "
             f"2 validations of {per_valid}")
    in_steps = {k: n - sum(v[k] for v in valid_launches)
                for k, n in run_launches.items()}
    if any(in_steps.values()):
        fail(f"FluxD-train: kernels launched in train steps {in_steps}")
    losses = logged(trainer, "train/total_log_loss")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"FluxD-train: {len(losses)} logged losses {losses}")
    first = float(np.mean(losses[:LOSS_WINDOW]))
    last = float(np.mean(losses[-LOSS_WINDOW:]))
    if not last < first:
        fail(f"FluxD-train: mean loss of the last {LOSS_WINDOW} steps {last} "
             f"not below the first {LOSS_WINDOW} {first}")
    tree, meta = ckpt.load("latest")
    saved = state.module.state_dict()
    if (meta["step"] != TRAIN_STEPS or tree["module"].keys() != saved.keys()
            or not all(torch.equal(tree["module"][k], v.cpu())
                       for k, v in saved.items())):
        fail("FluxD-train: the checkpoint read back differs from the state")
    step_ms = [1e3 * v for v in logged(trainer, "performance/train_step_time")]
    say(f"phase 5a FluxD Trainer.run: {TRAIN_STEPS} steps in {run_s:.2f} s "
        "(two validations included); launches per validation "
        + json.dumps({k: v for k, v in valid_launches[0].items() if v})
        + f" ({CHECK_STEPS} rollout steps each); launches in the train steps "
        + json.dumps(in_steps) + f"; mean loss of the first {LOSS_WINDOW} "
        f"steps {first:.6f}, of the last {LOSS_WINDOW} {last:.6f}; losses "
        + json.dumps([round(v, 6) for v in losses])
        + f"; checkpoint {os.path.basename(ckpt.resolve('latest'))} read back; "
        f"peak memory over the run {run_peak / 2**30:.3f} GiB; the run's own "
        f"ms per step (batch assembly and the loss read at each mini-epoch "
        f"included): median {float(np.median(step_ms)):.3f}")

    plain_cfg = copy.deepcopy(cfg)
    plain_cfg.model.aggregation = "segment"
    plain = train_cli.build_model(plain_cfg, train_ds.device)
    plain.set_stats(trainer.model.stats)
    plain.module.load_state_dict(state.module.state_dict())
    validate_check(valid_ds, phase="5a'")("FluxD-train", trainer.model, plain,
                                          None, None)

    batches = [train_ds.get_batch(s) for s, _ in zip(
        get_sampler(cfg.dataset.sampler)(train_ds, t.batch_size,
                                         np.random.default_rng(0)),
        range(TIMED_WARMUP + TIMED_STEPS))]
    g0 = batches[0]
    lr = t.lr_max
    zero_launches()
    for g in batches[:TIMED_WARMUP]:
        trainer.train_step(state, g, lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for g in batches[TIMED_WARMUP:]:
        trainer.train_step(state, g, lr)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
    step_peak = torch.cuda.max_memory_allocated()
    if any(launch_counts().values()):
        fail(f"FluxD-train: kernels launched in timed steps {launch_counts()}")
    prof = profile_steps(lambda: [trainer.train_step(state, g, lr)
                                  for g in batches[:TRAIN_PROFILE_STEPS]],
                         TRAIN_PROFILE_STEPS)
    say(f"phase 5a FluxD train step h{H} mp{MP_NUM} bf16 batch "
        f"{t.batch_size} ({g0.num_cells} cells {g0.num_faces} faces "
        f"{g0.num_vertices} vertices): {ms:.3f} ms per step over "
        f"{TIMED_STEPS} steps after {TIMED_WARMUP} warm-up (host clock, "
        "batches assembled beforehand, ending in a synchronize); peak memory "
        f"over them {step_peak / 2**30:.3f} GiB; card {device_line}")
    say(f"phase 5a FluxD device profile of {TRAIN_PROFILE_STEPS} train "
        "steps: " + ("not measured" if prof is None else json.dumps(prof)))
    return {"launches": run_launches, "rollout_steps": 2 * CHECK_STEPS,
            "ms_per_step": ms, "profile": prof, "loss_first": first,
            "loss_last": last, "peak_bytes_run": run_peak,
            "peak_bytes_steps": step_peak}


def graph_to(graph, device):
    """``graph`` with every tensor moved to ``device``."""
    return graph.replace(**{
        f.name: getattr(graph, f.name).to(device)
        for f in dataclasses.fields(graph)
        if isinstance(getattr(graph, f.name), torch.Tensor)})


def card_vs_cpu(graph) -> dict:
    """Phase 5b: one FluxD train step in f32 (segment aggregation, no
    noise, flip or dropout) on ``graph`` with the same weights, statistics
    and batch on the card and on the CPU; fails beyond CPU_LOSS_RTOL,
    CPU_GRAD_NORM_RTOL or the parameters' bound (see there)."""
    cfg = train_config("FluxD", 1)
    cfg.model.compute_dtype = "float32"
    cfg.model.aggregation = "segment"
    lr = cfg.training.lr_max
    out, weights, stats = [], None, None
    for g in (graph, graph_to(graph, "cpu")):
        model = train_cli.build_model(cfg, g.device)
        if stats is None:
            _, feats = model.transform_rollout(g)
            acc = StatsAccumulator(model.nmap)
            acc.update(feats, feature_masks(g, feats))
            stats = acc.finalize()
            weights = {k: v.detach().cpu().clone()
                       for k, v in model.module.state_dict().items()}
        model.set_stats(stats)
        model.module.load_state_dict(weights)
        state = Trainer(cfg, model).init_state()
        tg, feats = model.transform_features(g, None, mode="train")
        state.module.train()
        loss = model.loss(model.forward(tg, feats, mode="train"), feats,
                          tg)["total_log_loss"]
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        norm = optimizer_step(state.optimizer, lr, cfg.training.clip_grad_norm)
        out.append((loss.item(), norm.item(), {
            k: v.detach().cpu() for k, v in state.module.state_dict().items()}))
    (lc, nc, pc), (lh, nh, ph) = out
    diff = torch.cat([(pc[k] - ph[k]).abs().reshape(-1) for k in pc])
    bound = 2 * lr * (1 + 1e-4) + 1e-6
    res = {"loss_card": lc, "loss_cpu": lh, "loss_rel": abs(lc - lh) / abs(lh),
           "grad_norm_card": nc, "grad_norm_cpu": nh,
           "grad_norm_rel": abs(nc - nh) / abs(nh),
           "param_max_abs_diff": float(diff.max()), "param_bound": bound,
           "params_beyond_1e-6": int((diff > 1e-6).sum()),
           "params": diff.numel()}
    if (res["loss_rel"] > CPU_LOSS_RTOL or res["grad_norm_rel"] > CPU_GRAD_NORM_RTOL
            or res["param_max_abs_diff"] > bound):
        fail(f"FluxD train step, card against CPU: {res}")
    say(f"phase 5b FluxD train step in f32 on the {graph.num_cells}-cell mesh, "
        f"card against CPU (loss within {CPU_LOSS_RTOL}, gradient norm within "
        f"{CPU_GRAD_NORM_RTOL} relative, parameters within {bound:.6g}): ok "
        + json.dumps(res))


def fvgnf_training(train_ds) -> dict:
    """Phase 5c: ``Trainer.run`` of FvgnF for FVGNF_TRAIN_STEPS steps on
    the first states of phase 5a's trajectories, no validation: no kernel
    launched, finite losses, the integrator's BatchNorm statistics moved
    from their init and finite."""
    ds = MeshDataset(train_ds.trajectories, timestep_range=(0, FVGNF_TRAIN_STEPS),
                     device=train_ds.device)
    cfg = train_config("FvgnF", FVGNF_TRAIN_STEPS)
    trainer, state = build_trainer(cfg, ds)
    bn = state.module.integrator.face_area_norm.masked_batch_norm.batch_norm
    init = (bn.running_mean.clone(), bn.running_var.clone())
    zero_launches()
    trainer.run(state, ds)
    losses = logged(trainer, "train/total_log_loss")
    stats = {"running_mean": bn.running_mean.item(),
             "running_var": bn.running_var.item()}
    if any(launch_counts().values()):
        fail(f"FvgnF training launched kernels {launch_counts()}")
    if len(losses) != FVGNF_TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"FvgnF training: losses {losses}")
    if (not np.isfinite(list(stats.values())).all()
            or torch.equal(bn.running_mean, init[0])
            or torch.equal(bn.running_var, init[1])):
        fail(f"FvgnF training: BatchNorm statistics {stats} (init 0, 1)")
    say(f"phase 5c FvgnF h{H} mp{MP_NUM} bf16 batch {cfg.training.batch_size}, "
        f"{FVGNF_TRAIN_STEPS} steps: ok, no kernel launched; losses "
        + json.dumps([round(v, 6) for v in losses])
        + "; the integrator's BatchNorm " + json.dumps(stats) + " (init 0, 1)")


# ---- phase 6: the rollout entry point and the MGN family --------------------

def rollout_run_phase(device, device_line: str) -> dict:
    """Phase 6a: ``rollout.run``'s two halves on the checkpoint phase 5a
    wrote (its config, with the ``auto`` aggregation, and its statistics
    adopted by ``restore_model``) and a dataset of the bench mesh with a
    channel flow of STEPS + 1 states as ground truth: STEPS steps with the
    error metrics, ``errors.json`` written, no save. The launch counters are
    set to 0 just before and read just after (K1-K3 15 a step, no other).
    The first CHECK_STEPS steps' errors are held against the same rollout
    on the plain route (STEP_TOL relative)."""
    geom = bench_geometry()
    fields = channel_flow_trajectory(geom, num_timesteps=STEPS + 2, dt=0.01)
    ds = MeshDataset([Trajectory(mesh_id="bench", geom=geom, fields=fields)],
                     timestep_range=(0, STEPS + 1), device=device)
    model, cfg, meta = rollout_cli.restore_model(
        os.path.join(SMOKE_DIR, "ckpt", "latest"), device)
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg.model.aggregation = "segment"
    plain = train_cli.build_model(plain_cfg, device)
    plain.set_stats(meta["stats"])
    plain.module.load_state_dict(model.module.state_dict())
    out_dir = os.path.join(SMOKE_DIR, "rollouts")
    ref = rollout_cli.rollout_dataset(plain, ds, os.path.join(out_dir, "plain"),
                                      timestep_range=(0, CHECK_STEPS + 1))
    zero_launches()
    res = rollout_cli.rollout_dataset(model, ds, os.path.join(out_dir, "kernel"))
    launches = launch_counts()
    per_step = PATHS["FluxD"][1]
    for name, n in launches.items():
        if n != per_step.get(name, 0) * STEPS:
            fail(f"rollout.run: {name} launched {n} times in {STEPS} steps, "
                 f"expected {per_step.get(name, 0) * STEPS}")
    with open(os.path.join(out_dir, "kernel", "errors.json")) as f:
        written = json.load(f)["scalar"]
    means = {k: written[k]["mean_all"] for k in
             ("velocity_error", "pressure_error", "divergence_error")}
    if not np.isfinite(list(means.values())).all():
        fail(f"rollout.run: errors.json holds non-finite errors {means}")
    rel = {}
    for k in means:
        a = res["errors"][k][:CHECK_STEPS].double()
        b = ref["errors"][k].double()
        rel[k] = float(((a - b).abs() / b.abs()).max())
        if rel[k] > STEP_TOL:
            fail(f"rollout.run: {k} of the first {CHECK_STEPS} steps "
                 f"{a.tolist()} (kernel) vs {b.tolist()} (plain), "
                 f"{rel[k]:.3g} > {STEP_TOL}")
    sps = res["num_steps"] / res["seconds"]
    say(f"phase 6a FluxD through rollout.run on the phase-5a checkpoint, "
        f"{geom['cell_pos'].shape[0]} cells padded to {ds.pad_to['cell']} "
        "(bench mesh, channel flow): "
        f"{res['num_steps']} steps with the error metrics in "
        f"{res['seconds']:.4f} s = {sps:.1f} steps/s, "
        f"{1e3 * res['seconds'] / res['num_steps']:.4f} ms/step (the entry "
        f"point's own clock, ending in a synchronize); launches "
        + json.dumps(launches) + "; errors.json mean_all "
        + json.dumps(means) + f"; first {CHECK_STEPS} steps against the plain "
        "route, largest relative difference " + json.dumps(rel)
        + f"; card {device_line}")
    return {"launches": launches, "rollout_steps": STEPS,
            "steps_per_s": sps, "ms_per_step": 1e3 * res["seconds"] / STEPS,
            "profile": None}


def mgnb_training(train_ds, device_line: str) -> dict:
    """Phase 6d: MGNB_TRAIN_STEPS ``Trainer.train_step`` calls of MgnB (h128,
    15 face-first blocks, bf16, ``config/train.json``'s optimizer and noise,
    MGNB_LOSS_WEIGHTS added) on phase 5's first training batch, with MLS
    cell weights: every loss term finite, the continuity term included;
    the mean total of the last MGNB_LOSS_WINDOW steps below the first's;
    no kernel launched."""
    train_ds.add_grad_weights("cell", MLS_ORDER)
    cfg = train_config("MgnB", MGNB_TRAIN_STEPS)
    cfg.training.loss_weights = {**cfg.training.loss_weights,
                                 **MGNB_LOSS_WEIGHTS}
    trainer, state = build_trainer(cfg, train_ds)
    t = cfg.training
    batch = train_ds.get_batch(next(iter(get_sampler(cfg.dataset.sampler)(
        train_ds, t.batch_size, np.random.default_rng(0)))))
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = [trainer.train_step(state, batch, t.lr_max)
             for _ in range(MGNB_TRAIN_STEPS)]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / MGNB_TRAIN_STEPS
    launches = launch_counts()
    if any(launches.values()):
        fail(f"MgnB training launched kernels {launches}")
    losses = {k: [float(s[k]) for s in steps] for k in steps[0]}
    if "continuity_loss" not in losses or not all(
            np.isfinite(v).all() for v in losses.values()):
        fail(f"MgnB training: losses {losses}")
    total = losses["total_log_loss"]
    first = float(np.mean(total[:MGNB_LOSS_WINDOW]))
    last = float(np.mean(total[-MGNB_LOSS_WINDOW:]))
    if not last < first:
        fail(f"MgnB training: mean loss of the last {MGNB_LOSS_WINDOW} steps "
             f"{last} not below the first {MGNB_LOSS_WINDOW} {first}")
    say(f"phase 6d MgnB h{H} mp{MP_NUM} bf16 batch {t.batch_size} with MLS "
        f"cell weights, {MGNB_TRAIN_STEPS} train steps: ok, no kernel "
        f"launched; mean total loss of the first {MGNB_LOSS_WINDOW} "
        f"{first:.6f}, of the last {last:.6f}; {ms:.3f} ms per step (host "
        "clock, the batch assembled beforehand); losses by term "
        + json.dumps({k: [round(x, 6) for x in v] for k, v in losses.items()})
        + f"; card {device_line}")
    return {"launches": launches, "rollout_steps": MGNB_TRAIN_STEPS,
            "ms_per_step": ms, "loss_first": first, "loss_last": last}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    line = card_line()
    build_s = kernels.build_kernels()
    say(f"phase 1 device: {line}; kernels built in {build_s:.2f} s "
        f"(nvcc, sm_90a, {kernels.BUILD_DIR})")

    graph, fields = bench_mesh(dev)
    t0 = time.perf_counter()
    ds, vgraph = valid_data(dev)
    say(f"phase 1 FluxD-valid data: {len(VALID_SEEDS)} meshes of "
        f"{VALID_POINTS} points, batch of {vgraph.num_cells} cells "
        f"{vgraph.num_faces} faces {vgraph.num_vertices} vertices, int8 "
        "tables es/er " + "x".join(map(str, vgraph.es_onehot.shape))
        + ", vc " + "x".join(map(str, vgraph.vc_onehot.shape))
        + ", cf " + "x".join(map(str, vgraph.cf_row_onehot.shape))
        + f", built in {time.perf_counter() - t0:.2f} s")
    vindex = to_static_bands(vgraph, derive_idx=True)
    per_kernel = kernel_phase(graph, vindex)
    per_kernel.update(table_phase(vgraph))
    say("phase 2 kernel vs plain: ok " + json.dumps(
        {k: round(v["max_abs_err"], 6) for k, v in per_kernel.items()}))
    for name in ("K1_fused_face_block", "K2_fused_cell_block",
                 "K3_edges_to_vertices", "K4_gather_face_cells",
                 "K5_vertices_to_cells", "K6_table_dual", "K7_table_single"):
        say(f"phase 2 {name} by form: " + json.dumps(per_kernel[name]["forms"]))
    k4 = per_kernel["K4_gather_face_cells"]
    say("phase 2 K4 on the rounding cases, bit for bit (NaN by place): ok "
        + json.dumps(k4["rounding_cases"]) + "; launch floor at K4's grid, "
        "ms per empty launch back to back, by faces: "
        + json.dumps(k4["launch_floor_ms"]))
    say("phase 2 K3 -> K5 pair by cells: "
        + json.dumps(per_kernel["K3_edges_to_vertices"]["pair"])
        + "; launch floor, ms per empty launch back to back: "
        + json.dumps(per_kernel["K3_edges_to_vertices"]["launch_floor_ms"]))
    hazard = pdl_hazard_check(graph)
    say("phase 2 PDL hazard check, K3 -> K5 right behind a slow writer of "
        "their input: ok " + json.dumps(hazard))
    say("phase 2 PDL hazard check, K3 on K1's raw output right behind K1 "
        "with both outputs (MgnA's face-first block): ok "
        + json.dumps(k1_k3_hazard_check(graph)))
    say("phase 2 NaN through a zero weight, same places as the plain version: "
        + json.dumps({name: per_kernel[name]["nan_through_zero_weight"]
                      for name in ("K6_table_dual", "K7_table_single")}))

    checks = {"FluxD": rollout_errors_check(fields),
              "FvgnF": rollout_errors_check(fields),
              "FluxD-valid": validate_check(ds)}
    paths = {path: (slice_phase(path, vgraph, checks[path], line, vindex)
                    if path == "FluxD-valid" else
                    slice_phase(path, graph, checks[path], line))
             for path in ROLLOUT_PATHS}

    say(f"phase 4 card {line}; " + "; ".join(
        f"{path} {p['steps_per_s']:.1f} steps/s, {p['ms_per_step']:.4f} ms/step, "
        + ("kernels per step not measured" if p["profile"] is None else
           f"{p['profile']['kernels_per_step']:g} kernels per step")
        for path, p in paths.items()))

    t5 = time.perf_counter()
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    train_ds = train_data(dev)
    paths["FluxD-train"] = fluxd_training(train_ds, ds, line)
    card_vs_cpu(graph)
    fvgnf_training(train_ds)
    say(f"phase 5 wall time {time.perf_counter() - t5:.1f} s")

    t6 = time.perf_counter()
    paths["FluxD-rollout-run"] = rollout_run_phase(dev, line)
    mgn_graph, _ = bench_mesh(dev, mls=True)
    paths["MgnA"] = slice_phase("MgnA", mgn_graph,
                                rollout_errors_check(fields, mls=True), line,
                                phase="6b")
    paths["MgnA-valid"] = slice_phase("MgnA-valid", vgraph,
                                      validate_check(ds, phase="6c-a'"), line,
                                      vindex, phase="6c")
    paths["MgnB-train"] = mgnb_training(train_ds, line)
    say(f"phase 6 card {line}; " + "; ".join(
        f"{path} {p['steps_per_s']:.1f} steps/s, {p['ms_per_step']:.4f} "
        "ms/step" + ("" if p["profile"] is None else
                     f", device {p['profile']['device_ms_per_step']:.4f} ms "
                     f"per step, busy {100 * p['profile']['busy_share']:.1f} %"
                     f", {p['profile']['kernels_per_step']:g} kernels per "
                     "step")
        for path, p in paths.items()
        if path in ("FluxD-rollout-run", "MgnA", "MgnA-valid"))
        + f"; phase 6 wall time {time.perf_counter() - t6:.1f} s")

    bnd = bounds(graph)
    rows = []
    for name, spec in KERNELS.items():
        r = per_kernel[name]
        b_ms, b_by, nbytes, flops = r["bound"] if "bound" in r else bnd[name]
        by_path = {path: p["launches"][name] for path, p in paths.items()}
        rows.append({
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_per_step": {
                p: n / paths[p].get("rollout_steps", STEPS)
                for p, n in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": r.get("library_ms"), "bytes": nbytes, "flops": flops,
            **({"forms": r["forms"], "unit": r["unit"]}
               if "forms" in r else {}),
            **{k: r[k] for k in ("pair", "launch_floor_ms", "replaced_ms",
                                 "rounding_cases") if k in r},
        })
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
