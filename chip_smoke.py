"""Drive the PyTorch/CUDA port on one card: build the GN-block kernels, hold
each against its plain PyTorch version, run the FluxD and FvgnF rollouts,
the trainer's validation rollout of FluxD, FluxD's training, the rollout
entry point, the MGN family, the rest of the FVGN family (temporal
bundling included), the StreamFunc family, the rest of the Flux family, the
VertPot family and the Conservative family at their shipped width through
them, FluxD's recipe of fused train calls, data-parallel, on data made
by the port's own generator, with its profiling, diagnosis and sweep tools,
space-sharded over ranks that share the card, and over meshes of two
sizes in size buckets, and report each kernel's time beside its bound.

    python3 chip_smoke.py

(``python3 chip_smoke.py --phase10b``, ``--phase11a``, ``--phase11b <rank>
<dir>``, ``--phase13 <rank> <dir>`` and ``--phase13c <rank> <dir>`` are the
processes of phases 10b, 11a, 11b, 13 and 13c, which the script starts.)

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
   896, K7 on the tables widened to 384), on seeded inputs; the wide forms
   of ConservativeH/J/K beside them: K3, K5 and the pair on 2H = 256-wide
   edge latents at the mesh and the batch, K6's roll form on 256-wide and
   K7 on 128-wide sources on the batch's tables; K6 and K7 also
   with a NaN source row that a tile's weights skip, whose NaN must reach
   the same places as in the plain version; K6 and K7 in every form and
   table type also on tables past the bands they held whole before they
   streamed them (``wide_band_phase``: phase 14b's smallest mesh at its
   all-mesh pad, es 15,616 rows, and FluxD-valid's vc widened to 1,920),
   timed beside their bounds, with a NaN case there; K7 and its library call timed
   also with L2 flushed between launches; the launch floor (an empty kernel
   back to back, with and without the programmatic dependent launch
   attribute K3 and K5 launch with); and the PDL hazard checks: for 200
   rounds a slow writer, which lets the next launch start at its own start,
   writes fresh edge latents into the buffer that K3 reads right after it,
   and K3 -> K5 must agree with the plain versions on every round; and for
   200 rounds K1 with both outputs, then K3 on K1's raw output (MgnA's
   face-first order), K3 agreeing with its plain version on every round;
   and the first check again for 50 rounds at the wide forms' 256 lanes;
   and K8, the unfused sub-block's MLP -> LayerNorm -> residual, in both
   forms (cell: f32 latents and f32 vertex mean; face: f32 edge latents and
   bf16 owner/neighbour rows), with and without the step scalar, single-
   and dual-output, at the bench mesh's rows and at the benchmark's b8
   batch's, each against its plain version and an f64 evaluation as K1/K2;
3. the three paths at hidden 128, 15 GN block applications and bf16, with
   seeded weights and statistics from the synthetic channel flow:

   * FluxD, on the RCM-ordered cylinder mesh of ``bench.py`` (3,462 cells,
     5,361 faces, 1,899 vertices), 15 fused GN blocks: K3 -> K2 -> K1 per
     block;
   * FvgnF, on the same mesh, one shared GN block applied 15 times with a
     step scalar, so unfused: K3 -> K5 -> K8 (cell MLP), K4 -> K8 (face
     MLP) per application; its integrator's BatchNorm at Flax's init (mean
     0, var 1);
   * FluxD-valid, the rollout half of the trainer's validation: two
     RCM-ordered 9,700-point cylinder meshes (``bench.py``'s production
     point) in one ``MeshDataset`` with int8 banded tables, padded to one
     shape and batched on the table route, so every block is unfused and
     reads the tables: K6 (es/er) -> K7 (vc) -> K8 (cell MLP), K6 (cf) ->
     K8 (face MLP); each table application is one launch for the whole
     batch. Every unfused bf16 path of the later phases (the table routes'
     validations, FvgnF's) launches K8 twice a block application.

   Each of the first 5 steps of a path is held against the same model's
   plain path on the card, on the same inputs (FluxD-valid's also against
   its own batch on the index route, fused K1-K3, on live rows); a 5-step
   rollout with the error metrics must stay finite (for FluxD-valid:
   ``validate`` on both routes, whose errors must agree); then a 100-step rollout is timed with
   every launch counter set to 0 just before it and read just after, and
   each kernel must have launched as often per step as its path runs it
   (15, K6 30, K8 30) and never on another path; last a device profile of 10
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

7. the rest of the FVGN family and the StreamFunc family, on the bench mesh
   with order-1 MLS weights at cells and faces (the first BUNDLE + 1
   states of a channel flow):

   * 7a each of FvgnB, C (bundle BUNDLE), D, E, H, I, J, K and StreamFuncA-D:
     CHECK_STEPS forwards of the kernel route held against the plain route
     on the same inputs, every bundled step (within STEP_TOL; StreamFunc
     within STREAMFUNC_STEP_TOL, see there), the kernels' order in a block
     (FVGN K3 -> K2 dual -> K1, StreamFunc K1 dual -> K3 -> K2), then
     LAUNCH_STEPS predicted steps with the counters around them: K1-K3 15 a
     forward, K4-K7 none;
   * 7b FvgnB, FvgnC and StreamFuncA: STEPS forwards timed as 3b, the
     counters around them, a device profile of 10 forwards (FvgnC also per
     predicted step);
   * 7c FvgnC on FluxD-valid's meshes at rollout stride BUNDLE:
     ``validate`` on the table route (K6 30, K7 15 a forward), the same
     rollout on the index route (K1-K3) and on the plain route, their
     per-trajectory mean errors within STEP_TOL;
   * 7d FvgnC, FVGNC_TRAIN_STEPS train steps on bundled windows: no kernel
     launched, the loss falling;
   * 7e StreamFuncA through ``rollout.run``'s two halves on a checkpoint
     the port writes: LAUNCH_STEPS steps with the error metrics, K1-K3 15 a
     step, its errors held against the plain route's;

8. the rest of the Flux family and the VertPot family, on phase 7's mesh:

   * 8a each of FluxA, FluxB, FluxC and VertPotA-G as 7a: the kernels'
     order in a block Flux K3 -> K2 dual -> K1, VertPot K3 -> K2 dual -> K1
     dual (its vertex sum reads K1's raw output), K1-K3 15 a step;
   * 8b FluxA and VertPotA timed and profiled as 7b; VertPotA's
     ``divergence_raw_error`` within (RAW_DIVERGENCE_ULPS x its largest raw
     flux)^2 (see there) over CHECK_STEPS steps, while its
     ``divergence_error`` is the z-score inverse's (3 x mean face flux)^2;
   * 8c VertPotA's ``validate`` on FluxD-valid's batch on the table route
     (K6 30, K7 15 a step) for P8_VALID_STEPS steps, beside its index and
     plain routes, per-trajectory mean errors within P8_VALID_TOL;
   * 8d FluxA and VertPotA, P8_TRAIN_STEPS train steps each as 7d;

9. the Conservative family, on phase 7's mesh:

   * 9a each of ConservativeA, B, D-K as 7a: F, G and I run K3 -> K5 on
     their H-wide ``[e_sym | e_sym]``, H, J and K on their 2H-wide ``[e_s |
     e_s]`` (the wide forms), 15 a step each; A, B, D and E run no kernel
     (their aggregation is a gather over each cell's faces);
   * 9b ConservativeA (the repo's e2e model) and ConservativeH timed and
     profiled as 7b;
   * 9c ConservativeH's ``validate`` on FluxD-valid's batch on the table
     route (K6's roll form on 2H-wide latents 15 and K7 on H-wide vertex
     sums 15 a step) for P9_VALID_STEPS steps, beside its index and plain
     routes, per-trajectory mean errors within P9_VALID_TOL;
   * 9d ConservativeA and ConservativeJ, P9_TRAIN_STEPS train steps each as
     7d;

10. the fused train calls of ``config/e2e/fluxd-r5.json`` (FluxD h128, 15
    blocks, bf16, AdamW, clip 10, its loss weights, noise_std_norm 0.045,
    pushforward 2, 16 steps a call, static_chunked, batch 4) on phase 5's
    trajectories in windows of 4 (an epoch of 38 steps):

    * 10a ``Trainer.run`` for FUSED_EPOCHS epochs (the first the
      pushforward warm-up, FUSED_WARMUP_EPOCHS) with mini-epochs of
      FUSED_MINI_EPOCH samples and the ``auto`` aggregation: the indexed
      path chosen by the JAX package's rule, the calls 16, 16, 6 in each
      epoch, the counters by the JAX package's crossing rule, the
      trajectory store on the card as large as
      ``estimate_device_field_bytes``; no kernel in a warm-up call, in a
      pushforward call only the unroll's rollout-mode forwards on the fused
      route (K1-K3 15 each a forward, 2 forwards a step); each of the two
      validations phase 5a's launches; finite losses, epoch 1's falling;
      the grad/param monitor (``train.main`` builds one for this config)
      logging at every mini-epoch, its gradients copied once a mini-epoch
      (at the last step of the call that closes it) and its time measured;
    * 10b in a process of its own (``--phase10b``, beside 10a;
      CUBLAS_WORKSPACE_CONFIG=:4096:8, deterministic algorithms with the
      ops that have none reported): from one state, an indexed call of 16
      pushforward steps, a multi call and 16 single steps on the same
      batches, equal bit for bit (see FUSED_ND_LOSS_RTOL otherwise);
    * 10c ms per train step of single steps through ``prefetch``, a multi
      call through ``prefetch_grouped`` and an indexed call through
      ``prefetch_indexed``, FUSED_TIMED_CALLS each in turns (host clock,
      ending in a synchronize), and a device profile of one indexed call
      with its host-to-device copies;

11. data-parallel training of the same recipe with ``settings.multi_gpu``
    (``parallel/data_parallel.py``, one process a rank; the run has one
    card, so NCCL across cards is not exercised):

    * 11a in a process of its own (``--phase11a``; CUBLAS_WORKSPACE_CONFIG
      and deterministic algorithms as 10b): an NCCL group of one rank;
      DP_STEPS ``dp_train_step``s across the warm-up -> pushforward switch
      against as many ``train_step``s from one state on phase 5's meshes
      cut to DP_STATES states, bit for bit (losses, parameters and
      buffers, moments, generator); then ms per step of each, in turns,
      the flat all-reduce's bytes and a profile of one step of each (the
      NCCL kernels, what the DP step adds);
    * 11b DP_RANKS processes (``--phase11b``), a gloo group on CUDA tensors
      of the one card: one f32 warm-up DP step, rank r on half r of a
      global batch of 4, against the mean of both halves' gradients, the
      clip and AdamW on rank 0: the mean losses and AdamW's moments (see
      DP_F32_LOSS_RTOL), and rank 0's half alone beyond; then ``Trainer.run``
      of the recipe on phase 5's meshes cut to DP_STATES states, FUSED_EPOCHS
      epochs: the counters by the JAX package's DP rule, the replicas (all
      parameters and buffers) equal on every rank after every barrier,
      rank 0 alone validating (phase 10a's launches each) and writing its
      metrics, its monitor's records (the update and the parameters, no
      gradients, as the JAX package's DP path) and checkpoints, K1-K3 only
      in epoch 2's unroll on each rank, finite losses, epoch 1's falling;
    * 11c the times: 11a's ms per DP step against the single step, the
      all-reduce's bytes and device time, 11b's ms per DP step (gloo's,
      staged through the host: not a multi-card figure);

12. FluxD-gen: data made by the port's own generation chain feeding the
    fluxd-r5 recipe, and the training tools on its run:

    * 12a (host) ``generate.mesh.main`` (GEN_MESHES meshes, the inflow
      regime, dt 0.01, seed 0, h GEN_H), the ``generate.simulation`` CLI
      (the built-in solver, GEN_STEPS saved frames after GEN_SPINUP
      discarded intervals; one process a mesh, ``--shard-index``) and ``generate.conversion.convert_case`` of each mesh in
      memory (no h5py on the card's machine) into ``build/chip_smoke/gen/``;
      every field finite, every saved frame's face flux with a discrete
      divergence below GEN_DIVERGENCE_TOL per cell; the C++ graph builder
      (``native``) built afresh, its time, and its connectivity against the
      numpy path's on a NATIVE_POINTS-point mesh, equal;
    * 12b (card) phase 10a's ``Trainer.run`` of the recipe (FUSED_EPOCHS
      epochs, the first the warm-up) on meshes 0-2, validated on mesh 3 on
      the table route, its calls and validations timed as the recorder's
      spans (``profiling.recording``, the card synchronized before each
      span closes), a checkpoint at its end;
      then one mini-epoch (GEN_MINI_EPOCH samples of pushforward steps and
      a validation) under ``profiling.trace``: the trace file names the
      device functions of K1, K2, K3, K6 and K7, and gives the device
      share; ``device_memory_stats``: in use <= peak <= limit = the card's
      memory;
    * 12c (card) ``diagnose.main`` twice on 12b's checkpoint, with
      ``aggregation`` "pallas" (the fused index route on mesh 3: K1-K3 15 a
      forward, 2 forwards) and "segment" (the plain route, no launch):
      every head's corr and rel within DIAG_TOL of each other in both
      spaces, the scalars equal;
    * 12d (card) ``sweep.main`` on a 2-combination grid of
      ``training.lr_max`` over a one-mini-epoch synthetic FluxD config: a
      dry run listing both, then shard 0 of 2 running one job as a
      subprocess (``training.train --device cuda``), exit code 0, its run
      ``<name>-0`` with a ``metrics.jsonl``;

13. space sharding (``parallel/spmd.py``: the partition, the hand-written
    halo exchange, the sharded rollout and train step) on gloo ranks that
    share the one card (NCCL refuses two ranks on one card, so the
    exchange is staged through the host; NCCL across cards is not
    exercised), each rank a process of its own:

    * 13a SPMD_RANKS processes (``--phase13``), a 1 x 2 layout: FluxD at
      h128, 15 fused blocks, bf16 on the bench mesh cut in two, CHECK_STEPS
      steps of ``make_spmd_rollout`` gathered and held against the single
      process's kernel route (bit for bit free-running, or else each step
      on the same inputs within STEP_TOL of each field's largest
      magnitude, as phase 3 holds two routes); then STEPS timed steps per rank with the launch counters and
      the halo's counters set to 0 just before and read just after (ms per
      step, exchanges and bytes per step, K1-K3 15 each a step, the other
      kernels none) and one step profiled;
    * 13b the same ranks and checks for FvgnF (K3, K5, K4);
    * 13d the same for FluxD on the table route (the trainer's validation
      route): the bench mesh padded to 128 rows with int8 tables, each
      rank on its own tables built from its local index tables (their
      band widths printed per rank); K6 30 and K7 15 a step a rank, the
      other kernels none;
    * 13e ConservativeH (its MLPs f32) on the index route, K3 and K5 in
      their 256-lane form 15 each a step a rank; 13e' on 13d's table
      route, K6's wide roll form and K7's wide form 15 each;
    * 13g one sharded step each of FvgnK (its reference velocity taken over
      the whole graph) and VertPotG (its face flux converted from every
      rank's cells) on the bench mesh, gathered and held against the
      single process's step (bit for bit, or within STEP_TOL);
    * 13c four processes (``--phase13c``), a 2 x 2 layout: one f32
      warm-up step of the fluxd-r5 recipe through ``make_spmd_train_step``,
      data row d on mesh d of one global batch, against ``dp_train_step``
      on 13a's two ranks (the mean losses within DP_F32_LOSS_RTOL, AdamW's
      moments within DP_F32_MOMENT_RTOL, the parameters' gap reported), no
      kernel launched; then ms per step;
    * 13f the same processes and checks for the shipped conservativea-r5
      recipe (ConservativeA at h128, 15 blocks, f32);

14. FluxD-buckets: the size buckets (``MeshDataset(num_buckets=...)``) and
    the bounded caches (``max_cached_graphs``) on four TRAIN_POINTS-point
    and four VALID_POINTS-point meshes of BUCKET_STATES channel-flow
    states, made in memory (four and two would split three and three by
    the JAX package's rule, one small mesh with the large ones):

    * 14a phase 10a's ``Trainer.run`` of the fluxd-r5 recipe and its
      checks on the meshes in BUCKETS buckets, validated on FluxD-valid's
      batch: each bucket's members and pads, every sampler batch and every
      indexed call within one bucket at its pad, K1-K3 30 each a
      pushforward step in both buckets and nothing else; then ms per
      pushforward step of calls in turns on bucket 0's batch, bucket 1's,
      and bucket 0's padded to the largest mesh (a one-bucket dataset),
      reported, not gated;
    * 14b each bucket's validation batch at its pad on the table route
      (int8 tables) held against the plain route (and its index route)
      within STEP_TOL, K6 30 and K7 15 a step over a CHECK_STEPS-step
      rollout, its band widths and each mesh's; then every mesh at
      ``pad_to`` in one batch on the table route the same way (a small
      mesh's bands there pass 1,792 rows), with its tables' bytes, a
      device profile of ALL_MESH_PROFILE_STEPS steps and the host's peak
      memory;
    * 14c the dataset again with ``max_cached_graphs`` BUCKET_CACHE: every
      mesh's graph visited (at most BUCKET_CACHE static graphs and tables
      held), the peak memory of the visits and the cache's bytes beside
      the unbounded dataset's, and each bucket's batch rebuilt after the
      evictions giving 14b's kernel-route fields bit for bit (the HDF5
      store itself runs on the CPU only: the card's machine has no h5py);

then the ``kernels`` line: per kernel its time per launch, launches, bound,
plain time and library time (K3 and K5 also the pair's time and the launch
floor); ``launches_per_step`` of a sharded path counts per rank and step.

The last line is ``{"ok": true, "device": {...}}``. Without a card the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import glob
import io
import itertools
import json
import os
import pathlib
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from gnn_fluid_dynamics_tpu_torch.data.samplers import get_sampler
from gnn_fluid_dynamics_tpu_torch.data.pipeline import (FIELD_KEYS, MeshDataset,
                                                        Trajectory,
                                                        compute_window,
                                                        prefetch,
                                                        prefetch_grouped,
                                                        prefetch_indexed,
                                                        rollout_batch)
from gnn_fluid_dynamics_tpu_torch import native
from gnn_fluid_dynamics_tpu_torch.data.synthetic import (channel_flow_trajectory,
                                                         cylinder_channel_mesh,
                                                         make_geometry)
from gnn_fluid_dynamics_tpu_torch.generate import conversion as gen_conversion
from gnn_fluid_dynamics_tpu_torch.generate import mesh as gen_mesh
from gnn_fluid_dynamics_tpu_torch.graph import (banded_tables_for,
                                                from_geometry, to_static_bands,
                                                widen_band)
from gnn_fluid_dynamics_tpu_torch.models.arch import MLP
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig, feature_masks
from gnn_fluid_dynamics_tpu_torch.models.flux import FluxD
from gnn_fluid_dynamics_tpu_torch.models.fvgn import FvgnF
from gnn_fluid_dynamics_tpu_torch.models.mgn import MgnA
from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.ops import connectivity, fvm, kernels
from gnn_fluid_dynamics_tpu_torch.ops.mls import compute_mls_weights
from gnn_fluid_dynamics_tpu_torch.ops.reorder import (rcm_reorder_geometry,
                                                      reorder_fields)
from gnn_fluid_dynamics_tpu_torch.rollout import run as rollout_cli
from gnn_fluid_dynamics_tpu_torch.rollout.engine import (SAVABLE_FIELDS,
                                                         RolloutConfig,
                                                         derive_states,
                                                         rollout_scan)
from gnn_fluid_dynamics_tpu_torch.training import train as train_cli
from gnn_fluid_dynamics_tpu_torch.training.checkpoint import Checkpointer
from gnn_fluid_dynamics_tpu_torch.training.config import load_config
from gnn_fluid_dynamics_tpu_torch.training.logging import Logger
from gnn_fluid_dynamics_tpu_torch.training.monitoring import ModelMonitor
from gnn_fluid_dynamics_tpu_torch.training import diagnose, profiling, sweep
from gnn_fluid_dynamics_tpu_torch.training.lr_schedule import get_schedule
from gnn_fluid_dynamics_tpu_torch.parallel import data_parallel, spmd
from gnn_fluid_dynamics_tpu_torch.training.trainer import (Trainer, gradients,
                                                           optimizer_step)
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
# K8's rows in phase 2: the bench mesh's (3,462 cells, 5,361 faces) and the
# benchmark's b8 batch's live rows (perfbench/traffic/rollout_b8.json: eight
# 9,700-point meshes)
MESH_ROWS = {"cell": 3462, "face": 5361}
B8_ROWS = {"cell": 108886, "face": 165873}
# kernel vs plain route of the same model on the same inputs, as the
# largest difference relative to the field's largest magnitude: bf16
# latents through 15 blocks (measured on the CPU at 904 cells: up to 2.8%
# on FluxD's face fields)
STEP_TOL = 5e-2
# the same for StreamFunc's fields: its velocity is the MLS curl of psi, a
# near-cancelling sum that turns psi's bf16 rounding into a larger relative
# error of the velocity, and StreamFuncC feeds unnormalized features to its
# bf16 MLPs (measured on the CPU over 5 forwards, the kernels' plain
# versions against the plain route: at the bench mesh up to 5.2 % (A) and
# 7.3 % (C) on the velocity, 6.0 % (C) on the pressure; at a 518-cell mesh
# 12.5 % (C) on the velocity). A wrong kernel moves the fields by O(1).
STREAMFUNC_STEP_TOL = 0.15
# 7e: StreamFunc's divergence error, the mean square of the MLS divergence
# of psi's curl, is what that cancellation leaves (about 1e-5 of the
# velocity error), so the two routes' bf16 roundings move it most (my chip
# run 1, PR 13: 12.8 % apart at the first step, 16 % within 5 steps; the
# CPU rehearsal 3.7 % and 6.3 %). A wrong kernel moves it by O(1).
STREAMFUNC_DIVERGENCE_TOL = 0.5
HAZARD_ROUNDS = 200
WIDE_HAZARD_ROUNDS = 50   # the same check at the wide forms' 2H
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
# phase 7: the rest of the FVGN family and the StreamFunc family
FVGN_VARIANTS = ("FvgnB", "FvgnC", "FvgnD", "FvgnE", "FvgnH", "FvgnI",
                 "FvgnJ", "FvgnK")
STREAMFUNC_VARIANTS = ("StreamFuncA", "StreamFuncB", "StreamFuncC",
                       "StreamFuncD")
BUNDLE = 2                 # FvgnC's temporal bundle (its default)
LAUNCH_STEPS = 20          # 7a's counted rollout, in predicted steps
TIMED_PATHS = ("FvgnB", "FvgnC", "StreamFuncA")       # 7b
VALID_FORWARDS = 3         # 7c: FvgnC's validation, in forwards
FVGNC_TRAIN_STEPS = 10
FVGNC_LOSS_WINDOW = 5
# 7e: StreamFuncA's train steps before its checkpoint. Seeded weights give
# a psi whose curl is ~1/h times too large, and a free-running rollout
# then parts the two routes' bf16 roundings within a few steps
SF_TRAIN_STEPS = 20
# phase 8: the rest of the Flux family and the VertPot family
FLUX_VARIANTS = ("FluxA", "FluxB", "FluxC")
VERTPOT_VARIANTS = ("VertPotA", "VertPotB", "VertPotC", "VertPotD",
                    "VertPotE", "VertPotF", "VertPotG")
P8_TIMED_PATHS = ("FluxA", "VertPotA")                 # 8b
P8_VALID_STEPS = 3          # 8c: VertPotA's validation steps
# 8c: the routes' per-trajectory mean errors over P8_VALID_STEPS steps of
# the 27,392-cell batch, relative: the bf16 latents of either kernel route
# move a mean over that many cells far less than one field's largest
# difference (measured on the CPU with the plain versions: up to 0.72 %;
# 7c's FvgnC keeps STEP_TOL)
P8_VALID_TOL = 1e-2
P8_TRAIN_STEPS = 10         # 8d, each of FluxA and VertPotA
P8_LOSS_WINDOW = 5
# 8b: VertPotA's divergence of the raw telescoped cell flux. Each cell's
# three fluxes are f32 differences of the same three potentials, each
# within half an ulp of its result, and their sum adds two more roundings:
# at most about 3 x 2^-23 of the largest raw flux per cell. The limit on
# its mean square is (2^-20 max|raw flux|)^2, eight times that bound.
RAW_DIVERGENCE_ULPS = 2.0 ** -20
# phase 9: the Conservative family
CONSERVATIVE_VARIANTS = ("ConservativeA", "ConservativeB", "ConservativeD",
                         "ConservativeE", "ConservativeF", "ConservativeG",
                         "ConservativeH", "ConservativeI", "ConservativeJ",
                         "ConservativeK")
# the variants whose blocks run the twice message passing: K3 -> K5 (F, G,
# I on H-wide, H, J, K on 2H-wide edge latents); A, B, D, E run no kernel
TWICE_MP_VARIANTS = ("ConservativeF", "ConservativeG", "ConservativeH",
                     "ConservativeI", "ConservativeJ", "ConservativeK")
P9_TIMED_PATHS = ("ConservativeA", "ConservativeH")     # 9b
P9_VALID_STEPS = 3          # 9c: ConservativeH's validation steps
P9_VALID_TOL = 1e-2         # 9c, as 8c's P8_VALID_TOL
P9_TRAINED = ("ConservativeA", "ConservativeJ")         # 9d
P9_TRAIN_STEPS = 10
P9_LOSS_WINDOW = 5
# phase 10: the fused train calls of config/e2e/fluxd-r5.json (16 steps a
# call) on phase 5's trajectories (41 states: 38 windows of 4 a mesh, so an
# epoch of static_chunked batches of the four meshes is calls of 16, 16, 6)
RECIPE_CONFIG = os.path.join(ROOT, "config", "e2e", "fluxd-r5.json")
FUSED_EPOCHS = 2
FUSED_WARMUP_EPOCHS = 1    # epoch 1 the warm slice, epoch 2 the pushforward
FUSED_MINI_EPOCH = 40      # samples: 10 steps, a boundary inside each call
FUSED_LOSS_WINDOW = 10     # epoch 1's first and last steps averaged
                           # (on the combination it began with)
FUSED_TIMED_CALLS = 3      # 10c: calls of each kind, in turns
# 10b: should an op of the step have no deterministic CUDA implementation
# (warned under use_deterministic_algorithms(True, warn_only=True)), the
# three ways are held within these instead of bit for bit: each loss within
# 1e-2 relative (an f32 sum in another order, through 16 bf16 steps) and
# each parameter within 2 k lr + 1e-6 (see CPU_LOSS_RTOL: a parameter moves
# by about lr a step, either way where its gradient is near 0)
FUSED_ND_LOSS_RTOL = 1e-2
# phase 11: data-parallel training of the fluxd-r5 recipe, one process a rank
DP_STEPS = 8               # 11a: 4 warm-up and 4 pushforward steps
DP_TIMED_STEPS = 3         # 11a: steps of each kind timed, in turns
DP_RANKS = 2               # 11b: gloo ranks on the one card
DP_STATES = 15             # 12 windows of 4 a mesh: 12 global steps an epoch
DP_LOSS_WINDOW = 5         # 11b: epoch 1's first and last steps averaged
# 11b's f32 step against its reference: the mean losses within this, and
# AdamW's moments after the step, which carry the averaged gradients (step
# 1: (1 - b1) clip(g) and (1 - b2) clip(g)^2), each tensor's largest error
# within DP_F32_MOMENT_RTOL of its largest magnitude (the two sides'
# backward passes add in orders the card does not fix); the reference from
# rank 0's half alone must lie beyond it. The parameters are not compared:
# a first AdamW step moves each by about lr whatever its gradient.
DP_F32_LOSS_RTOL = 1e-5
DP_F32_MOMENT_RTOL = 1e-4
# phase 13: space sharding (parallel/spmd.py) on gloo ranks sharing the card
SPMD_RANKS = 2             # 13a/13b: a 1 x 2 layout
SPMD_LAYOUT = (2, 2)       # 13c: data x space
SPMD_TIMED_STEPS = 3       # 13c: steps timed after the compared one
# the sharded rollout paths, by sub-phase: the bench mesh's graph on the
# index route (13a, 13b, 13e), its graph with int8 tables on the table
# route (13d, 13e')
SPMD_PATHS = {"a": "FluxD", "b": "FvgnF", "d": "FluxD-valid",
              "e": "ConservativeH", "e'": "ConservativeH-valid"}
SPMD_ONE_STEP = ("FvgnK", "VertPotG")   # 13g: one gathered step each
# 13c's and 13f's recipes: (tag, config)
SPMD_RECIPES = (("FluxD-r5", RECIPE_CONFIG),
                ("ConservativeA-r5", os.path.join(ROOT, "config", "e2e",
                                                  "conservativea-r5.json")))
# phase 14: the size buckets (data/pipeline.py's num_buckets) and the bounded
# caches (max_cached_graphs). Four meshes of each size: split by cell count
# into two buckets, as the JAX package splits them, four and two would put
# one small mesh with the large ones
BUCKET_SEEDS = (0, 1, 2, 3)    # one mesh a seed at TRAIN_POINTS and VALID_POINTS
BUCKETS = 2
BUCKET_STATES = 19         # 16 windows of 4 a mesh: calls 16, 16 an epoch
BUCKET_TIMED_STEPS = 4     # pushforward steps a timed call
BUCKET_TIMED_ROUNDS = 3    # timed calls of each, in turns
BUCKET_CACHE = 2           # 14c's max_cached_graphs
ALL_MESH_PROFILE_STEPS = 3  # 14b: the all-mesh batch's profiled steps
# phase 12: the port's generation chain (scripts/datagen_r5.sh's: the inflow
# regime, dt 0.01, seed 0, the built-in solver) feeding the fluxd-r5 recipe
GEN_DIR = os.path.join(SMOKE_DIR, "gen")
GEN_MESHES = 4             # meshes 0-2 train (batch 4: 0, 1, 2, 2), 3 validates
GEN_H = 0.03               # the shipped mesh size: ~1,800 vertices a mesh
GEN_STEPS = 41             # saved frames: 38 windows of 4, calls 16, 16, 6
GEN_SPINUP = 2             # saved intervals discarded (datagen_r5.sh: 1.5
#                            domain crossings, cut to keep the phase short)
GEN_DIVERGENCE_TOL = 1e-6  # per cell, each saved frame's f32 face flux
NATIVE_POINTS = 9700       # the native builder against numpy at this mesh size
GEN_MINI_EPOCH = 16        # samples: 4 steps, the traced mini-epoch
DIAG_TOL = 5e-2            # 12c: corr, and rel over max(1, |rel|), route to route
# 12c: each head's raw output on live rows, kernel route against plain
# route, as the norm of the difference over the norm of the plain head's
# deviation from its mean (the share of the head's variation the kernel
# route misses; a head's constant offset, such as a normalized flux's
# -mean/std, would hide a fault from a measure relative to its largest
# magnitude). Planted faults, the output of K1, of K2 or of K3 zeroed in
# turn: each head must lie beyond the limit under one of them, and each
# fault must move its most moved head DIAG_FAULT_RATIO times the route's
# largest gap. From readings on an H100 (four trainings): route gaps up to
# 0.167 (bf16 latents through 15 blocks, a near-constant head's small
# variation in the denominator); every head moved by 1.03 or more under
# K1's fault; K3's, the weakest, moved its most moved head by 0.40 to
# 1.70, 5.5 to 10 times that training's largest route gap
DIAG_OUT_TOL = 0.4
DIAG_FAULT_RATIO = 2.0
DIAG_FAULTS = ("fused_face_block", "fused_cell_block", "edges_to_vertices")
DIAG_HEADS = ("face_velocity", "face_pressure", "face_flux",
              "cell_velocity_change", "cell_velocity", "cell_pressure")
SWEEP_LRS = (1e-3, 3e-4)   # 12d's grid of training.lr_max

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
    "K8_mlp_block": dict(
        wrapper=kernels.mlp_block,
        source="gnn_fluid_dynamics_tpu_torch/csrc/mlp_block.cu",
        replaces="none: the counterpart of the fusion XLA does around "
                 "gnn_fluid_dynamics_tpu/ops/pallas_agg.py's banded_*_pallas "
                 "on the unfused route (a sub-block's MLP, LayerNorm and "
                 "residual)"),
}
# the main paths: model class, and the launches per step of each kernel the
# path runs (every other kernel: none)
PATHS = {
    "FluxD": (FluxD, {"K1_fused_face_block": MP_NUM,
                      "K2_fused_cell_block": MP_NUM,
                      "K3_edges_to_vertices": MP_NUM}),
    "FvgnF": (FvgnF, {"K3_edges_to_vertices": MP_NUM,
                      "K4_gather_face_cells": MP_NUM,
                      "K5_vertices_to_cells": MP_NUM,
                      "K8_mlp_block": 2 * MP_NUM}),
    "FluxD-valid": (FluxD, {"K6_table_dual": 2 * MP_NUM,
                            "K7_table_single": MP_NUM,
                            "K8_mlp_block": 2 * MP_NUM}),
    "MgnA": (MgnA, {"K1_fused_face_block": MP_NUM,
                    "K2_fused_cell_block": MP_NUM,
                    "K3_edges_to_vertices": MP_NUM}),
    "MgnA-valid": (MgnA, {"K6_table_dual": 2 * MP_NUM,
                          "K7_table_single": MP_NUM,
                          "K8_mlp_block": 2 * MP_NUM}),
}
_FUSED_PER_STEP = {"K1_fused_face_block": MP_NUM,
                   "K2_fused_cell_block": MP_NUM,
                   "K3_edges_to_vertices": MP_NUM}
# phase 7: per step = per forward (FvgnC predicts BUNDLE steps a forward)
PATHS.update({name: (get_model_class(name), _FUSED_PER_STEP)
              for name in FVGN_VARIANTS + STREAMFUNC_VARIANTS})
PATHS["FvgnC-valid"] = (get_model_class("FvgnC"),
                        {"K6_table_dual": 2 * MP_NUM,
                         "K7_table_single": MP_NUM,
                         "K8_mlp_block": 2 * MP_NUM})
PATHS.update({name: (get_model_class(name), _FUSED_PER_STEP)
              for name in FLUX_VARIANTS + VERTPOT_VARIANTS})
PATHS["VertPotA-valid"] = (get_model_class("VertPotA"),
                           {"K6_table_dual": 2 * MP_NUM,
                            "K7_table_single": MP_NUM,
                            "K8_mlp_block": 2 * MP_NUM})
_TWICE_MP_PER_STEP = {"K3_edges_to_vertices": MP_NUM,
                      "K5_vertices_to_cells": MP_NUM}
PATHS.update({name: (get_model_class(name),
                     _TWICE_MP_PER_STEP if name in TWICE_MP_VARIANTS else {})
              for name in CONSERVATIVE_VARIANTS})
# the table route: K6's roll form (no cf: the blocks' cell gathers are index
# gathers) -> K7 per block
PATHS["ConservativeH-valid"] = (get_model_class("ConservativeH"),
                                {"K6_table_dual": MP_NUM,
                                 "K7_table_single": MP_NUM})
ROLLOUT_PATHS = ("FluxD", "FvgnF", "FluxD-valid")      # phase 3
# the kernel wrappers a GN block calls, per block application, in order
# (":dual" K1/K2 with both outputs, ":roll" K6 on es/er with the roll)
BLOCK_ORDER = {
    "MgnA": ["fused_face_block:dual", "edges_to_vertices",
             "fused_cell_block"],
    "MgnA-valid": ["table_dual", "mlp_block:dual", "table_dual:roll",
                   "table_single", "mlp_block"],
    **{name: ["edges_to_vertices", "fused_cell_block:dual",
              "fused_face_block"] for name in FVGN_VARIANTS},
    **{name: ["fused_face_block:dual", "edges_to_vertices",
              "fused_cell_block"] for name in STREAMFUNC_VARIANTS},
    **{name: ["edges_to_vertices", "fused_cell_block:dual",
              "fused_face_block"] for name in FLUX_VARIANTS},
    # VertPot's vertex sum reads each block's raw face output
    **{name: ["edges_to_vertices", "fused_cell_block:dual",
              "fused_face_block:dual"] for name in VERTPOT_VARIANTS},
    # the Conservative blocks' MLPs run outside the kernels: only their
    # twice message passing, where they have one
    **{name: (["edges_to_vertices", "vertices_to_cells"]
              if name in TWICE_MP_VARIANTS else [])
       for name in CONSERVATIVE_VARIANTS},
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
    channel-flow steps per seed (CHECK_STEPS + 2, or as many as phase 7c's
    rollout of stride BUNDLE reads), int8 banded tables, one graph on the
    table route (``Trainer.validate``'s ``to_static_bands(...,
    derive_idx=False)``)."""
    trajs = []
    steps = max(CHECK_STEPS + 2, VALID_FORWARDS * BUNDLE * BUNDLE + 1)
    for seed in VALID_SEEDS:
        geom = rcm_reorder_geometry(make_geometry(
            "cylinder", n_points=VALID_POINTS, seed=seed))
        fields = channel_flow_trajectory(geom, num_timesteps=steps, dt=0.01)
        trajs.append(Trajectory(mesh_id=f"cyl{seed}", geom=geom, fields=fields))
    ds = MeshDataset(trajs, with_banded=True, banded_dtype="int8",
                     pad_multiple=128, device=device)
    graph = to_static_bands(ds.get_batch(rollout_batch(ds)), derive_idx=False)
    return ds, graph


# K6's two forms on the table route, and K7's one: (tables, source rows'
# graph count, combine_roll, source channels). The wide forms take
# ConservativeH/J/K's 2H-wide edge latents and their H-wide vertex sums.
TABLE_FORMS = {
    ("K6_table_dual", "es_roll"): (("es_onehot", "er_onehot"), "num_faces",
                                   True, H),
    ("K6_table_dual", "cf"): (("cf_row_onehot", "cf_col_onehot"), "num_cells",
                              False, H),
    ("K6_table_dual", "es_roll896"): (("es_onehot", "er_onehot"), "num_faces",
                                      True, H),
    ("K6_table_dual", "es_roll_wide"): (("es_onehot", "er_onehot"),
                                        "num_faces", True, 2 * H),
    ("K7_table_single", "vc"): (("vc_onehot",), "num_vertices", None, H // 2),
    ("K7_table_single", "vc384"): (("vc_onehot",), "num_vertices", None,
                                   H // 2),
    ("K7_table_single", "vc_wide"): (("vc_onehot",), "num_vertices", None, H),
}
WIDE_TABLE_FORMS = (("K6_table_dual", "es_roll_wide"),
                    ("K7_table_single", "vc_wide"))
# the table types each form runs on: the path's int8, and the graphs' other
# two (f32 is the datasets' default)
TABLE_TYPES = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}
# forms run on tables widened to another band than the batch's (not on the
# path: held and timed only)
WIDENED = {("K6_table_dual", "es_roll896"): 896,
           ("K7_table_single", "vc384"): 384}
# the forms beside the FluxD-valid path's, held and timed but not in a
# kernel's top-level numbers
OFF_PATH_FORMS = (*WIDENED, *WIDE_TABLE_FORMS)
# the widest band K6 and K7 held whole before they streamed it; phase 2 and
# 14b run bands past it
WHOLE_BAND_ROWS = 1792
# phase 2 past WHOLE_BAND_ROWS (wide_band_phase): the forms run on the
# smallest phase 14 mesh's tables at the all-mesh pad, and the band K7's
# two forms take on FluxD-valid's vc tables widened to it (past 896, the
# widest band K7's 128-lane form held whole)
WIDE_BAND_FORMS = (("K6_table_dual", "es_roll"), ("K6_table_dual", "cf"),
                   ("K6_table_dual", "es_roll_wide"),
                   ("K7_table_single", "vc"), ("K7_table_single", "vc_wide"))
WIDE_VC_BAND = 1920


def table_form_bound(vg, form, tables) -> tuple:
    """(bytes, operations) of one table application at this batch's shapes:
    each table, the source and the offsets read once, the outputs written
    once; the products counted for this data's nonzero weights only (a
    multiply and an add per channel), plus K6's one add of the roll and
    K7's division."""
    (name, _), (keys, count, roll, width) = form, TABLE_FORMS[form]
    T, tile, band = tables[0].shape
    rows = T * tile
    nnz = sum(int((t != 0).sum()) for t in tables)
    nbytes = (sum(t.numel() * t.element_size() for t in tables)
              + getattr(vg, count) * width * 2 + T * 4)
    if name == "K7_table_single":
        return nbytes + rows * width * 4, 2 * nnz * width + rows * width
    if roll:
        half = width // 2
        return nbytes + rows * half * 2, 2 * nnz * half + rows * half
    return nbytes + 2 * rows * width * 2, 2 * nnz * width


def bounds(graph, width: int = H) -> dict:
    """Least time (ms) for each kernel's work at these shapes: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its operations over the peak rate for their type (the
    three products in bf16 on the tensor cores for K1/K2, the f32 adds of
    K3 and K5; K4 does none: its rounding is a conversion). K1 runs
    single-output and K2 dual-output on the main path; K4 reads f32 latents
    there (the FvgnF path's cell MLP output) and K5 stores its f32 mean.
    ``width`` is the edge latents' width K3 reads (2H in the wide form of
    ConservativeH/J/K) and K5's input is half of it; K1, K2 and K4 are at
    H."""
    F, C, V = graph.num_faces, graph.num_cells, graph.num_vertices
    W = width
    vec = 5 * H * 2                                   # b0,b1,b2,ln_g,ln_b
    k1_bytes = (F * H * 2 + C * H * 2 + 2 * F * 4
                + (3 * H * H + 2 * H * H) * 2 + vec + F * H * 2)
    k1_flops = 2 * F * H * (3 * H + 2 * H)
    k2_bytes = (C * H * 2 + V * (H // 2) * 2 + 3 * C * 4
                + ((H + H // 2) * H + 2 * H * H) * 2 + vec + 2 * C * H * 2)
    k2_flops = 2 * C * H * (H + H // 2 + 2 * H)
    k3_bytes = F * W * 2 + (V + 1) * 4 + 2 * F * 4 + V * (W // 2) * 2
    k3_flops = 2 * F * (W // 2)
    k4_bytes = C * H * 4 + 2 * F * 4 + 2 * F * H * 2
    k5_bytes = V * (W // 2) * 2 + 3 * C * 4 + C * (W // 2) * 4
    k5_flops = 3 * C * (W // 2)                       # 2 adds + 1 division

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


def table_fns(form, tables, off):
    """The kernel of ``form`` (a TABLE_FORMS key) and its plain version on
    ``tables`` and ``off``, each a function of the source; and the library
    yardstick on a source, one ``torch.bmm`` of the tables as one bf16 (T,
    rows, B) batch by the stacked bands (T, B, W), both made beforehand."""
    name, roll = form[0], TABLE_FORMS[form][2]
    if name == "K7_table_single":
        def kern(s):
            return kernels.table_single(*tables, off, s)

        def plain(s):
            return kernels.table_single_ref(*tables, off, s)
    else:
        def kern(s):
            return kernels.table_dual(*tables, off, s, roll)

        def plain(s):
            return kernels.table_dual_ref(*tables, off, s, roll)

    def library(s):
        oh = torch.cat([t.to(torch.bfloat16) for t in tables], dim=1)
        idx = off.long()[:, None] + torch.arange(oh.shape[2], device=s.device)
        return functools.partial(torch.bmm, oh, s[idx])
    return kern, plain, library


def table_phase(vg) -> dict:
    """K6 (es/er with the roll, cf without) and K7 (vc) on the FluxD-valid
    batch's own tables, int8 as the path runs them and once more cast to
    bf16 and to f32, each on seeded bf16 sources, held against its plain version (the
    cf form exactly), then timed beside it and beside one ``torch.bmm`` of
    the table (cast to bf16) by the stacked bands, both made outside the
    timed window. K6's roll form also runs on the tables widened to a band
    of 896 and K7 on the tables widened to 384, and K7 and its
    ``torch.bmm`` are timed also with L2 flushed between launches. The wide
    forms (``WIDE_TABLE_FORMS``: K6's roll form on 2H-wide edge latents, K7
    on H-wide vertex sums, ConservativeH/J/K's) run on the batch's tables
    as the narrow ones. Each form on the path's int8 tables also takes a NaN
    source row (``nan_case``). A kernel's top-level numbers are per launch
    on the int8 tables the FluxD-valid path runs: K6's the mean of its two
    narrow forms, each launched once per block."""
    dev = vg.device
    rng = np.random.default_rng(1)
    srcs = {n: torch.from_numpy(rng.normal(size=(n, 2 * H)).astype(
        np.float32)).to(dev, torch.bfloat16)
        for n in {vg.num_faces, vg.num_cells, vg.num_vertices}}
    if int(vg.vc_onehot.max()) != 3:
        fail("the FluxD-valid batch's vc tables hold no weight of 3 (a "
             "padded cell): K7's weights are not held")
    results = {}
    for form, (keys, count, roll, width) in TABLE_FORMS.items():
        name, fname = form
        src = srcs[getattr(vg, count)][:, :width].contiguous()
        off = getattr(vg, keys[0].split("_")[0] + "_off")
        for tdt_name, tdt in TABLE_TYPES.items():
            tables = tuple(getattr(vg, k).to(tdt) for k in keys)
            if form in WIDENED:
                widened = [widen_band(t, off, WIDENED[form], src.shape[0])
                           for t in tables]
                tables = tuple(t for t, _ in widened)
                off = widened[0][1]
            kern, plain, library = table_fns(form, tables, off)
            run = functools.partial(kern, src)
            ref = functools.partial(plain, src)
            err = _compare(f"{name} {fname} {tdt_name}", run(), ref(),
                           exact=fname == "cf")
            nbytes, flops = table_form_bound(vg, form, tables)
            lib = library(src)
            results[(name, fname, tdt_name)] = r = {
                "max_abs_err": err, "ms": gpu_ms(run), "plain_ms": gpu_ms(ref),
                "library_ms": gpu_ms(lib),
                "bound": _bound(nbytes, flops, PEAK_F32_FLOPS)}
            if name == "K7_table_single":
                r["ms_l2_flushed"] = gpu_ms_flushed(run)
                r["library_ms_l2_flushed"] = gpu_ms_flushed(lib)
            del lib
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
                if n == name and d == "int8" and (n, f) not in OFF_PATH_FORMS]
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
                if n == name and (n, f) not in OFF_PATH_FORMS)}
    return out


def wide_band_phase(trajs, vg) -> dict:
    """K6 and K7 on tables past WHOLE_BAND_ROWS (896 rows for K7's 128-lane
    form), whose bands they stream: the smallest of phase 14's meshes with
    its own tables at the all-mesh ``pad_to`` of phase 14b (``trajs``),
    every form of WIDE_BAND_FORMS on them, and K7's two forms on the
    FluxD-valid batch's vc tables widened to WIDE_VC_BAND. Each int8 as the
    path runs them and cast to bf16 and f32, on seeded bf16 sources, held
    against its plain version as ``table_phase`` holds them (the cf form
    exactly) and timed beside its bound; the int8 tables also beside the
    plain version's time and one ``torch.bmm``, and the es roll form on
    them with a NaN source row (``nan_case``). Returns {"forms": {label:
    record}, "nan": ..., "bands": ..., ...}, a label ``<form>@<band>_<table
    type>``."""
    dev = vg.device
    pad = MeshDataset(trajs, num_buckets=BUCKETS, device=dev).pad_to
    small = min(trajs, key=lambda t: t.geom["cell_pos"].shape[0])
    t0 = time.perf_counter()
    host = banded_tables_for(small.geom, pad)
    built_s = time.perf_counter() - t0
    wide = {k: torch.from_numpy(getattr(host, k)).to(dev).to(torch.int8)
            for k in ("es_onehot", "er_onehot", "vc_onehot", "cf_row_onehot",
                      "cf_col_onehot")}
    for group in ("es", "vc", "cf"):
        wide[f"{group}_off"] = torch.tensor(getattr(host, f"{group}_offsets"),
                                            dtype=torch.int32, device=dev)
    del host
    sizes = types.SimpleNamespace(num_faces=pad["face"], num_cells=pad["cell"],
                                  num_vertices=pad["vertex"])
    cases = [(form, sizes, tuple(wide[k] for k in TABLE_FORMS[form][0]),
              wide[TABLE_FORMS[form][0][0].split("_")[0] + "_off"])
             for form in WIDE_BAND_FORMS]
    widened = widen_band(vg.vc_onehot, vg.vc_off, WIDE_VC_BAND,
                         vg.num_vertices)
    cases += [((name, fname), vg, (widened[0],), widened[1])
              for name, fname in TABLE_FORMS
              if name == "K7_table_single" and fname in ("vc", "vc_wide")]
    rng = np.random.default_rng(2)
    srcs = {}
    forms, nan = {}, {}
    for form, rows, tables8, off in cases:
        (name, fname), (_, count, _, width) = form, TABLE_FORMS[form]
        n = getattr(rows, count)
        if n not in srcs:
            srcs[n] = torch.from_numpy(rng.normal(size=(n, 2 * H)).astype(
                np.float32)).to(dev, torch.bfloat16)
        src = srcs[n][:, :width].contiguous()
        band = tables8[0].shape[2]
        for tdt_name, tdt in TABLE_TYPES.items():
            tables = tuple(t.to(tdt) for t in tables8)
            kern, plain, library = table_fns(form, tables, off)
            label = f"{fname}@{band}_{tdt_name}"
            run = functools.partial(kern, src)
            err = _compare(f"{name} {label}", run(), plain(src),
                           exact=fname == "cf")
            nbytes, flops = table_form_bound(rows, form, tables)
            b_ms, b_by, _, _ = _bound(nbytes, flops, PEAK_F32_FLOPS)
            r = forms[(name, label)] = {
                "max_abs_err": err, "ms": gpu_ms(run), "bound_ms": b_ms,
                "bound_by": b_by, "bytes": nbytes, "flops": flops}
            if tdt_name == "int8":
                r["plain_ms"] = gpu_ms(functools.partial(plain, src))
                r["library_ms"] = gpu_ms(library(src))
                if fname == "es_roll" and rows is sizes:
                    nan[(name, f"{fname}@{band}")] = nan_case(
                        f"{name} {fname}@{band}", kern, plain, tables, off,
                        src)
            del tables
    return {"forms": forms, "nan": nan, "mesh": small.mesh_id, "pad_to": pad,
            "tables_built_s": built_s,
            "bands": {k: wide[k].shape[2] for k in ("es_onehot", "vc_onehot",
                                                    "cf_row_onehot")},
            "table_bytes": sum(wide[k].numel() for k in wide
                               if k.endswith("onehot"))}


def kernel_phase(graph, index_graph) -> dict:
    """Each of K1-K5 on seeded inputs at the slice's shapes, held against
    its plain version on the same inputs, then timed beside it. K1 and K2
    in four forms each, single- and dual-output at the FluxD mesh and at
    ``index_graph`` (the FluxD-valid batch on its index route), also held
    against an f64 evaluation (``block_forms``); K3, K5 and the pair K3 ->
    K5 at both, at both widths (``chain_forms``), and the launch floor; K4
    in both input forms at both (``gather_forms``)."""
    dev = graph.device
    rng = np.random.default_rng(0)
    wide_rng = np.random.default_rng(5)

    def latents(n, rng=rng, width=H):
        return torch.from_numpy(rng.normal(size=(n, width)).astype(
            np.float32)).to(dev, torch.bfloat16)

    gen = torch.Generator().manual_seed(0)
    w_face = MLP(3 * H, H, H, generator=gen).to(dev).kernel_weights(packed=True)
    w_cell = MLP(H + H // 2, H, H, generator=gen).to(dev).kernel_weights(
        packed=True)
    edges = latents(graph.num_faces)
    vtx = kernels.edges_to_vertices_ref(edges, graph)
    results = {"K4_gather_face_cells": gather_forms(graph, index_graph)}
    chain = chain_forms(graph, index_graph, latents, functools.partial(
        latents, rng=wide_rng, width=2 * H))
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
                    "attribute as the path launches it and without; the "
                    "wide forms (2H-wide edge latents, H-wide vertex sums) "
                    "with _wide; longest CSR row "
                    f"{chain['longest_csr_row']}"}
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
    # the same two calls at the wide forms' shapes, beside them at the mesh
    wide_edges = latents(graph.num_faces, rng=wide_rng, width=2 * H)
    wide_vtx = kernels.edges_to_vertices_ref(wide_edges, graph)
    wide_out = torch.zeros(graph.num_vertices, H, device=dev,
                           dtype=torch.bfloat16)
    wide_library = {
        ("K3_edges_to_vertices", graph.num_vertices): lambda: (
            wide_out.index_add_(0, owner_of_row,
                                wide_edges.view(2 * graph.num_faces, H))),
        ("K5_vertices_to_cells", graph.num_cells): lambda: F.embedding_bag(
            cell_vertices, wide_vtx, mode="sum"),
    }
    for (name, rows), call in wide_library.items():
        results[name]["forms"][f"{rows}_wide"]["library_ms"] = gpu_ms(call)
    for name, w in (("K1_fused_face_block", w_face),
                    ("K2_fused_cell_block", w_cell)):
        results[name] = block_forms(name, graph, index_graph, w, latents)
    results["K8_mlp_block"] = mlp_block_forms(dev)
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


def chain_forms(graph, index_graph, latents, wide_latents) -> dict:
    """K3 and K5 at the FvgnF mesh and at ``index_graph`` (the FluxD-valid
    batch on its index route), and the pair K3 -> K5 as FvgnF issues it,
    each held against its plain version and timed back to back; at H-wide
    edge latents from ``latents`` (keyed by rows) and at the wide form's
    2H from ``wide_latents`` (ConservativeH/J/K's, keyed by rows and
    "_wide"). K3 and K5 alone are timed without the PDL attribute: with it
    a kernel timed alone overlaps its own next launch, which no path does.
    The pair is timed with the attribute (each K3 may start as the K5
    before it ends, as it may behind the kernel ahead of it in FvgnF's
    step) and without. Fails if the batch's longest CSR row fits in one of
    K3's rounds (32 incidences)."""
    longest = csr_longest_row(index_graph)
    if longest <= 32:
        fail(f"the padded batch's longest CSR row has {longest} incidences: "
             "K3's round loop is not held")
    out = {"K3_edges_to_vertices": {}, "K5_vertices_to_cells": {}, "pair": {}}
    for (width, make), g in itertools.product(
            ((H, latents), (2 * H, wide_latents)), (graph, index_graph)):
        suffix = "" if width == H else "_wide"
        edges = make(g.num_faces)
        vtx = kernels.edges_to_vertices_ref(edges, g)
        k3 = functools.partial(kernels.edges_to_vertices, edges, g)
        k3_ref = functools.partial(kernels.edges_to_vertices_ref, edges, g)
        k5 = functools.partial(kernels.vertices_to_cells, vtx, g)
        k5_ref = functools.partial(kernels.vertices_to_cells_ref, vtx, g)

        def pair(edges=edges, g=g):
            return kernels.vertices_to_cells(kernels.edges_to_vertices(edges, g), g)

        def pair_ref(vtx=vtx, g=g):
            return kernels.vertices_to_cells_ref(vtx, g)

        bnd = bounds(g, width)
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
            form = {"max_abs_err": _compare(f"{name} at {rows} rows{suffix}",
                                            got, want, exact=False),
                    "ms": ms_no_pdl, "plain_ms": gpu_ms(ref),
                    "bound_ms": bnd[name][0], "bound_by": bnd[name][1]}
            if name == "pair":
                form["ms_no_pdl"] = ms_no_pdl
                form["ms"] = gpu_ms(run, FLOOR_ITERS)
            out[name][f"{rows}{suffix}"] = form
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


def pdl_hazard_check(graph, width: int = H,
                     rounds: int = HAZARD_ROUNDS) -> dict:
    """K3 and K5 start before the kernel ahead of them ends, and must not
    read its output before their wait. For ``rounds`` rounds a writer
    that lets the next launch start at its own start, then idles
    HAZARD_CYCLES clock cycles, writes fresh edge latents (the sign flipped
    every round) into the buffer K3 reads right after it; then K5. K3 thus
    runs its prologue beside the writer, and K5 beside K3. Every round's
    vertex sums and cell means must agree with the plain versions on that
    round's edges. The edge latents are ``width`` wide (2H: the wide forms
    of ConservativeH/J/K). Also times a round (writer, K3, K5) back to back
    with and without the PDL attribute."""
    dev = graph.device
    gen = torch.Generator(device=dev).manual_seed(3)
    base = torch.empty(graph.num_faces, width, dtype=torch.bfloat16,
                       device=dev).normal_(generator=gen)
    edges = torch.zeros_like(base)

    def round_(r):
        kernels.slow_writer(base, edges, bool(r % 2), HAZARD_CYCLES)
        vtx = kernels.edges_to_vertices(edges, graph)
        return vtx, kernels.vertices_to_cells(vtx, graph)

    outs = []
    torch.cuda.synchronize()
    for r in range(rounds):
        outs.append(round_(r))
    torch.cuda.synchronize()
    err = 0.0
    for r, (vtx, cells) in enumerate(outs):
        e = -base if r % 2 else base
        err = max(err,
                  _compare(f"PDL hazard round {r}: K3", vtx,
                           kernels.edges_to_vertices_ref(e, graph), False),
                  _compare(f"PDL hazard round {r}: K5", cells,
                           kernels.vertices_to_cells_ref(vtx, graph), False))
    with kernels.without_pdl():
        round_no_pdl = gpu_ms(functools.partial(round_, 0), 20)
    return {"rounds": rounds, "width": width,
            "writer_idle_cycles": HAZARD_CYCLES, "max_abs_err": err,
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


def mlp_block_exact(parts, extra, w) -> tuple:
    """K8's function in f64 with its plain version's bf16 rounding points
    (the input row; each product, bias add and SiLU): (raw, res), the
    LayerNorm unrounded."""
    rows = parts[0].shape[0]
    cols = list(parts) + ([extra.expand(rows, 1)] if extra is not None else [])
    h = torch.cat([c.float() for c in cols], 1).to(torch.bfloat16).double()
    for i, (weight, bias) in enumerate(w.dense):
        h = (h @ weight.double().t()).to(torch.bfloat16).double()
        h = (h + bias.double()).to(torch.bfloat16).double()
        if i < 2:
            h = F.silu(h).to(torch.bfloat16).double()
    mu = h.mean(1, keepdim=True)
    var = torch.clamp((h * h).mean(1, keepdim=True) - mu * mu, min=0.0)
    hn = ((h - mu) / torch.sqrt(var + kernels.LN_EPS) * w.ln_g.double()
          + w.ln_b.double())
    return hn, parts[0].double() + hn


def mlp_block_bound(form: str, rows: int, dual: bool) -> tuple:
    """K8's least time at ``rows``: bytes (f32 base in, the other parts in
    f32 (cell) or bf16 (face), f32 residual out, bf16 raw out with
    ``dual``, the weights once) against its three products in bf16."""
    k0 = H + H // 2 if form == "cell" else 3 * H
    part_bytes = rows * H // 2 * 4 if form == "cell" else 2 * rows * H * 2
    nbytes = (rows * H * 4 + part_bytes + rows * H * 4
              + (rows * H * 2 if dual else 0)
              + (k0 + 1 + 2 * H) * H * 2 + 3 * H * 2 + 2 * H * 4)
    flops = 2 * rows * H * (k0 + 1 + 2 * H)
    return _bound(nbytes, flops, PEAK_BF16_FLOPS)


def silu_check(dev) -> dict:
    """K8's SiLU against PyTorch's on every bf16 value, bit for bit (NaN by
    place): K8 computes it with the fast exponential and division where
    they round to the same bf16 (``csrc/mlp_block.cu``), so this holds
    that claim on the card it runs on."""
    bits = torch.arange(65536, dtype=torch.int32, device=dev)
    x = torch.where(bits >= 32768, bits - 65536, bits).to(torch.int16).view(
        torch.bfloat16)
    got, want = kernels.mlp_block_silu_table(dev), F.silu(x)
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        fail("K8's SiLU: NaN at other places than PyTorch's")
    off = int((got.view(torch.int16) != want.view(torch.int16))[~nan].sum())
    if off:
        fail(f"K8's SiLU: {off} of the 65,536 bf16 values round otherwise "
             "than PyTorch's SiLU")
    return {"values": 65536, "nan": int(nan.sum()), "differ": off}


def mlp_block_forms(dev) -> dict:
    """K8 in both forms, with and without the step scalar, single- and
    dual-output, at the bench mesh's rows and at the benchmark's b8 batch's
    (``B8_ROWS``), on seeded parts in the dtypes the routes pass (cell:
    f32, f32; face: f32, bf16, bf16) and a seeded MLP with nonzero biases;
    each held against its plain version and its f64 evaluation
    (``_compare_block``, K1/K2's tolerance), timed beside the plain version,
    with its bound. The top-level numbers are FvgnF's face launch (single
    output, with the step scalar) at the bench mesh."""
    forms = {}
    for form, mesh_rows in (("cell", MESH_ROWS["cell"]),
                            ("face", MESH_ROWS["face"])):
        for step in (False, True):
            k0 = (H + H // 2 if form == "cell" else 3 * H) + int(step)
            gen = torch.Generator().manual_seed(k0)
            mlp = MLP(k0, H, H, dtype=torch.bfloat16, generator=gen)
            with torch.no_grad():
                for p in (mlp.dense0.bias, mlp.dense1.bias, mlp.dense2.bias,
                          mlp.layer_norm.bias):
                    p.copy_(0.1 * torch.randn(p.shape, generator=gen))
                mlp.layer_norm.weight.copy_(
                    1.0 + 0.2 * torch.randn(H, generator=gen))
            w = mlp.to(dev).kernel_weights(mlp_block=True)
            extra = torch.tensor([[7 / 15]], device=dev) if step else None
            for rows in (mesh_rows, B8_ROWS[form]):
                g = torch.Generator(device=dev).manual_seed(rows + k0)
                widths = (H, H // 2) if form == "cell" else (H, H, H)
                parts = [torch.randn(rows, wd, device=dev, generator=g)
                         for wd in widths]
                if form == "face":
                    parts[1:] = [p.to(torch.bfloat16) for p in parts[1:]]
                exact = mlp_block_exact(parts, extra, w)
                for dual in (False, True):
                    fname = (f"{form}_{'step_' if step else ''}"
                             f"{'dual' if dual else 'single'}_{rows}")
                    run = functools.partial(kernels.mlp_block, parts, extra,
                                            w, True, dual)
                    ref = functools.partial(kernels.mlp_block_ref, parts,
                                            extra, w, True, dual)
                    got, want = run(), ref()
                    got, want = (got, want) if dual else ((got,), (want,))
                    err, readings = _compare_block(
                        f"K8_mlp_block {fname}", got, want,
                        exact if dual else exact[1:])
                    del got, want
                    forms[fname] = {"ms": gpu_ms(run), "plain_ms": gpu_ms(ref),
                                    "max_abs_err": err, "vs_f64": readings,
                                    "bound": mlp_block_bound(form, rows, dual)}
                del exact, parts
    main = f"face_step_single_{MESH_ROWS['face']}"
    return {
        "silu": silu_check(dev) if dev.type == "cuda" else None,
        "max_abs_err": max(f["max_abs_err"] for f in forms.values()),
        "ms": forms[main]["ms"], "plain_ms": forms[main]["plain_ms"],
        "bound": forms[main]["bound"],
        "forms": {f: {**{k: v for k, v in r.items() if k != "bound"},
                      "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                      "bytes": r["bound"][2], "flops": r["bound"][3]}
                  for f, r in forms.items()},
        "unit": f"per launch, {main} (FvgnF's face launch at the bench mesh); "
                "forms <form>_[step_]<single|dual>_<rows>"}


def check_against_plain(kern, plain, graph, feats, index_graph=None,
                        tol: float = STEP_TOL) -> dict:
    """The kernel and the plain route of the same model, step by step on the
    same inputs: each step's predicted fields from both (every bundled step
    of a forward), then the plain route's state fed back. (Free-running, the two would drift apart: with
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
            sols_p = derive_states(plain, plain.forward(graph, feats), feats,
                                   graph)
            sols_k = derive_states(kern, kern.forward(graph, feats), feats,
                                   graph)
            sols_i = (None if index_graph is None else derive_states(
                kern, kern.forward(index_graph, feats), feats, index_graph))
            for j, (sol_p, sol_k) in enumerate(zip(sols_p, sols_k)):
                sol_i = None if sols_i is None else sols_i[j]
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
                    live = (graph.cell_mask if key.startswith("cell")
                            else graph.face_mask)
                    note("kernel_vs_plain_live", key, a, b, live)
                    note("index_vs_plain", key, c, b)
                    note("table_vs_index_live", key, a, c, live)
            feats = plain.update_features(sols_p[-1], feats, graph)
    for name, fields in worst.items():
        for key, rel in fields.items():
            if rel > tol:
                fail(f"{name}, {key}: {rel:.3g} > {tol}")
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
                      aggregation="pallas", compute_dtype="bfloat16",
                      bundle_size=BUNDLE if cls.name == "FvgnC" else None)
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
        "table_single", "mlp_block")}

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


def timed_rollout(model, graph, feats, steps: int = STEPS) -> float:
    """Wall seconds of a ``steps``-step rollout (no error metrics, as
    bench.py), ending in a synchronize; fails on a non-finite final
    state."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = rollout_scan(model, graph, feats, config=RolloutConfig(
        num_steps=steps, compute_error=False))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not torch.isfinite(out["final_cell_state"]).all():
        fail("timed rollout: non-finite final state")
    return wall


def device_profile(model, graph, feats, steps: int = 10):
    """``profile_steps`` over a short rollout of ``steps`` forwards (steps,
    for a model that bundles none)."""
    cfg = RolloutConfig(num_steps=steps * int(model.config.bundle_size or 1),
                        compute_error=False)
    return profile_steps(
        lambda: rollout_scan(model, graph, feats, config=cfg), steps)


def profile_steps(run, steps: int, copies: bool = False,
                  named: str = None):
    """Device time per step by kernel name over ``run()``, which takes
    ``steps`` steps (the 8 largest kernels, and each of this package's), and
    the share of the window's wall time with a kernel running, from
    torch.profiler (device activity only); None where the profiler shows no
    device time. The device time per step is the sum of the kernels' spans,
    and also their union: a kernel launched by PDL starts before the one
    ahead of it ends (its prologue, then its wait), so the sum counts that
    overlap twice. With ``copies``, also the host-to-device copies of the
    window and their bytes, from the exported trace. With ``named``, also
    the device time per step of each kernel whose name holds it (case
    aside)."""
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
        htod = None
        if copies:
            with tempfile.TemporaryDirectory() as tmp:
                trace = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(trace)
                with open(trace) as f:
                    htod = [e.get("args", {}).get("bytes", 0)
                            for e in json.load(f).get("traceEvents", [])
                            if "HtoD" in str(e.get("name", ""))]
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
            "gfd_ms_per_step": {n: t / steps / 1e3 for n, t in ours.items()},
            **({} if named is None else {"named_ms_per_step": {
                n[:80]: t / steps / 1e3 for n, t in per_name.items()
                if named.lower() in n.lower()}}),
            **({} if htod is None else {"htod_copies": len(htod),
                                        "htod_bytes": int(sum(htod))})}


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


def build_trainer(cfg, ds, checkpointer=None, monitor=None):
    """The model of ``cfg`` on ``ds``'s device with statistics from ``ds``,
    a trainer logging to SMOKE_DIR (with ``monitor``), and its initial
    state."""
    model = train_cli.build_model(cfg, ds.device)
    stats = train_cli.compute_stats(cfg, model, ds)
    model.set_stats(stats)
    train_cli.set_noise_std(cfg, stats)
    logger = Logger(cfg, base_dir=os.path.join(SMOKE_DIR, "runs"))
    trainer = Trainer(cfg, model, logger=logger, checkpointer=checkpointer,
                      monitor=monitor)
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


# ---- phase 7: the rest of the FVGN family and the StreamFunc family ---------

def phase7_mesh(device):
    """The bench mesh at the first BUNDLE + 1 states of a channel flow
    (FvgnC's window; every other variant reads its first and last), with
    order-1 MLS weights at cells (StreamFunc's curl, the divergence metric)
    and at faces (FvgnB's viscous term)."""
    geom = bench_geometry()
    window = channel_flow_trajectory(geom, num_timesteps=BUNDLE + 1, dt=0.01)
    for loc in ("cell", "face"):
        nb, w = compute_mls_weights(geom[f"{loc}_pos"], MLS_ORDER)
        window[f"{loc}_grad_weights"] = w
        window[f"{loc}_grad_neighbours"] = nb
    return from_geometry(geom, window, dt=0.01, device=device)


def check_launches(path: str, launches: dict, forwards: int) -> None:
    for name, n in launches.items():
        want = PATHS[path][1].get(name, 0) * forwards
        if n != want:
            fail(f"{path}: {name} launched {n} times in {forwards} forwards, "
                 f"expected {want}")


def variant_phase(name: str, graph, phase: str = "7a"):
    """Phase 7a (8a) for one variant: CHECK_STEPS forwards of the kernel
    route held against the plain route on the same inputs (every bundled
    step), the kernels' order in a block application, then a rollout of
    LAUNCH_STEPS predicted steps with the counters set to 0 just before and
    read just after. Returns (the path's record, the kernel-route model,
    its features)."""
    kern, plain, feats = path_models(name, graph)
    tol = STREAMFUNC_STEP_TOL if name in STREAMFUNC_VARIANTS else STEP_TOL
    worst = check_against_plain(kern, plain, graph, feats, tol=tol)
    calls = launch_order(kern, graph, feats)
    if calls != BLOCK_ORDER[name] * MP_NUM:
        fail(f"{name}: kernels called in the order {calls}, expected "
             f"{BLOCK_ORDER[name]} per block application")
    forwards = LAUNCH_STEPS // int(kern.config.bundle_size or 1)
    zero_launches()
    _, out = rollout_scan(kern, graph, feats, config=RolloutConfig(
        num_steps=LAUNCH_STEPS, compute_error=False))
    torch.cuda.synchronize()
    launches = launch_counts()
    if not torch.isfinite(out["final_cell_state"]).all():
        fail(f"{name}: non-finite final state")
    check_launches(name, launches, forwards)
    say(f"phase {phase} {name} kernel vs plain route, {CHECK_STEPS} forwards on "
        f"the same inputs, within {tol}: ok " + json.dumps(
            {n: {k: round(v, 6) for k, v in f.items()}
             for n, f in worst.items()})
        + "; kernels in each block application in the order "
        + " -> ".join(BLOCK_ORDER[name]) + f"; {LAUNCH_STEPS} steps in "
        f"{forwards} forwards, launches " + json.dumps(launches))
    return {"launches": launches, "rollout_steps": forwards}, kern, feats


def timed_variant(name: str, kern, graph, feats, device_line: str,
                  phase: str = "7b") -> dict:
    """Phase 7b (8b): a STEPS-forward rollout of the kernel route on 3b's clock
    (no error metrics, ending in a synchronize), the counters set to 0 just
    before and read just after; then a device profile of 10 forwards. A
    bundling model is reported per forward and per predicted step."""
    k = int(kern.config.bundle_size or 1)
    rollout_scan(kern, graph, feats, config=RolloutConfig(        # warm-up
        num_steps=5 * k, compute_error=False))
    zero_launches()
    wall = timed_rollout(kern, graph, feats, steps=STEPS * k)
    launches = launch_counts()
    check_launches(name, launches, STEPS)
    prof = device_profile(kern, graph, feats)
    per_step = "" if k == 1 else (
        f" = {STEPS * k / wall:.1f} predicted steps/s, "
        f"{1e3 * wall / (STEPS * k):.4f} ms per predicted step ({k} a "
        "forward)")
    say(f"phase {phase} {name} h{H} mp{MP_NUM} bf16, {graph.num_cells} cells "
        f"{graph.num_faces} faces: {STEPS} forwards in {wall:.4f} s = "
        f"{STEPS / wall:.1f} forwards/s, {1e3 * wall / STEPS:.4f} ms per "
        f"forward{per_step}; launches {json.dumps(launches)}; card "
        f"{device_line}")
    say(f"phase {phase} {name} device profile of 10 forwards"
        + ("" if k == 1 else f" ({10 * k} predicted steps)") + ": "
        + ("not measured" if prof is None else json.dumps(prof)))
    return {"launches": launches, "rollout_steps": STEPS,
            "steps_per_s": STEPS / wall, "ms_per_step": 1e3 * wall / STEPS,
            "bundle": k, "profile": prof}


def fvgnc_valid_phase(ds):
    """Phase 7c: FvgnC on FluxD-valid's meshes as the trainer validates a
    bundling model (rollout stride BUNDLE, window BUNDLE + 1, int8 tables),
    through ``routes_validation`` for VALID_FORWARDS forwards within
    STEP_TOL. Returns the two routes' records."""
    dsc = MeshDataset(ds.trajectories, stride=BUNDLE, data_window=BUNDLE + 1,
                      with_banded=True, banded_dtype="int8", pad_multiple=128,
                      device=ds.device)
    return routes_validation(
        "FvgnC-valid", "FvgnC", dsc, VALID_FORWARDS, BUNDLE, STEP_TOL, "7c",
        f"FvgnC (k {BUNDLE}) on FluxD-valid's meshes, stride {BUNDLE}")


def routes_validation(path: str, index_path: str, dsc, forwards: int,
                      bundle: int, tol: float, phase: str, label: str):
    """``path``'s model on the validation set ``dsc`` (int8 tables):
    ``validate`` for ``forwards`` forwards (``bundle`` predicted steps each) on
    the table route (K6 30 and K7 15 launches a forward, counted around
    it), the same rollout of the batch on the index route (the fused K1-K3
    of ``index_path``, counted around it) and on the plain route; each
    trajectory's mean velocity and pressure errors within ``tol`` of each
    other (relative). Returns the two kernel routes' records."""
    samples = rollout_batch(dsc)
    table = to_static_bands(dsc.get_batch(samples), derive_idx=False)
    index = to_static_bands(table, derive_idx=True)
    kern, plain, _ = path_models(path, table)
    n = forwards * bundle
    zero_launches()
    flat = validate(kern, dsc, n)
    torch.cuda.synchronize()
    table_launches = launch_counts()
    check_launches(path, table_launches, forwards)
    if not all(np.isfinite(v) for v in flat.values()):
        fail(f"{path} validate: non-finite {flat}")
    errors = {"table": validation_errors(kern, dsc, n),
              "plain": validation_errors(plain, dsc, n)}
    gt_v, gt_p = dsc.trajectory_targets([m for m, _ in samples],
                                        samples[0][1], n)
    _, feats = kern.transform_rollout(index)
    zero_launches()
    errors["index"], _ = rollout_scan(kern, index, feats, gt_v, gt_p,
                                      RolloutConfig(num_steps=n))
    torch.cuda.synchronize()
    index_launches = launch_counts()
    check_launches(index_path, index_launches, forwards)
    means = {route: {f"{sid}/{k}": float(e[k][:, i].mean())
                     for i, sid in enumerate(dsc.sim_ids())
                     for k in ("velocity_error", "pressure_error")}
             for route, e in errors.items()}
    for route, e in errors.items():
        if e["velocity_error"].shape[0] != n or not all(
                torch.isfinite(v).all() for v in e.values()):
            fail(f"{path}, {route} route: errors {e}")
    rel = {}
    for a, b in (("table", "index"), ("table", "plain")):
        for key, want in means[b].items():
            r = abs(means[a][key] - want) / abs(want)
            rel[f"{a}_vs_{b}/{key}"] = r
            if r > tol:
                fail(f"{path}: {key} {means[a][key]} ({a}) vs {want} "
                     f"({b}), {r:.3g} > {tol}")
    say(f"phase {phase} {label}, {table.num_cells} cells: validate({n} "
        f"steps, {forwards} forwards) on the table route, launches "
        + json.dumps(table_launches) + "; on the index route, launches "
        + json.dumps(index_launches) + "; per-trajectory mean errors within "
        f"{tol}: ok " + json.dumps({k: round(v, 6) for k, v in
                                   rel.items()}) + " " + json.dumps(means))
    return ({"launches": table_launches, "rollout_steps": forwards},
            {"launches": index_launches, "rollout_steps": forwards})


def fvgnc_training(train_ds, device_line: str) -> dict:
    """Phase 7d: ``train_steps`` of FvgnC (k BUNDLE) on bundled windows
    (BUNDLE + 1 states)."""
    return train_steps("FvgnC", train_ds, device_line, "7d",
                       FVGNC_TRAIN_STEPS, FVGNC_LOSS_WINDOW, bundle=BUNDLE)


def train_steps(name: str, train_ds, device_line: str, phase: str,
                steps: int, window: int, bundle=None) -> dict:
    """``steps`` ``Trainer.train_step`` calls of ``name`` (h128, 15 blocks,
    bf16, ``config/train.json``'s optimizer and noise; with ``bundle`` k, on
    windows of k + 1 states) on one batch of 4 windows of phase 5's
    trajectories: every loss term finite, the mean total of the last
    ``window`` steps below the first's, no kernel launched."""
    states = (bundle or 1) + 1
    ds = MeshDataset(train_ds.trajectories, data_window=states,
                     timestep_range=(0, steps), device=train_ds.device)
    cfg = train_config(name, steps)
    cfg.model.bundle_size = bundle
    trainer, state = build_trainer(cfg, ds)
    t = cfg.training
    batch = ds.get_batch(next(iter(get_sampler(cfg.dataset.sampler)(
        ds, t.batch_size, np.random.default_rng(0)))))
    if tuple(batch.cell_velocity.shape[1:]) != (states, 2):
        fail(f"{name} training: windows {tuple(batch.cell_velocity.shape)}")
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [trainer.train_step(state, batch, t.lr_max)
               for _ in range(steps)]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    launches = launch_counts()
    if any(launches.values()):
        fail(f"{name} training launched kernels {launches}")
    losses = {k: [float(r[k]) for r in results] for k in results[0]}
    if not all(np.isfinite(v).all() for v in losses.values()):
        fail(f"{name} training: losses {losses}")
    total = losses["total_log_loss"]
    first = float(np.mean(total[:window]))
    last = float(np.mean(total[-window:]))
    if not last < first:
        fail(f"{name} training: mean loss of the last {window} steps {last} "
             f"not below the first {window} {first}")
    kind = "windows" if bundle is None else "bundled windows"
    say(f"phase {phase} {name}" + ("" if bundle is None else f" (k {bundle})")
        + f" h{H} mp{MP_NUM} bf16 batch {t.batch_size} of {kind}, {steps} "
        f"train steps: ok, no kernel launched; mean total loss of the first "
        f"{window} {first:.6f}, of the last {last:.6f}; {ms:.3f} "
        "ms per step (host clock, the batch assembled beforehand); losses "
        "by term " + json.dumps({k: [round(x, 6) for x in v]
                                 for k, v in losses.items()})
        + f"; card {device_line}")
    return {"launches": launches, "rollout_steps": steps,
            "ms_per_step": ms, "loss_first": first, "loss_last": last}


def streamfunc_rollout_run(train_ds, device, device_line: str) -> dict:
    """Phase 7e: StreamFuncA through ``rollout.run``'s two halves on a
    checkpoint the port writes (``config/train.json`` as phase 5 trains it,
    the weights as seeded, the statistics of phase 5's trajectories), on
    the bench mesh with order-1 MLS cell weights and a channel flow as
    ground truth: LAUNCH_STEPS steps with the error metrics, the counters
    set to 0 just before and read just after (K1-K3 15 a step); the first
    step's velocity and pressure errors (one forward of each route from
    the same state) within STEP_TOL of the plain route's and those of the
    first CHECK_STEPS steps (which run free) within STREAMFUNC_STEP_TOL;
    the divergence error within STREAMFUNC_DIVERGENCE_TOL (see there).
    The checkpoint is StreamFuncA after
    SF_TRAIN_STEPS train steps on one of phase 5's batches, with MgnB's
    loss weights (its velocity term)."""
    cfg = train_config("StreamFuncA", SF_TRAIN_STEPS)
    cfg.training.loss_weights = {**cfg.training.loss_weights,
                                 **MGNB_LOSS_WEIGHTS}
    ckpt = Checkpointer(os.path.join(SMOKE_DIR, "ckpt-streamfunca"))
    trainer, state = build_trainer(cfg, train_ds, ckpt)
    t = cfg.training
    batch = train_ds.get_batch(next(iter(get_sampler(cfg.dataset.sampler)(
        train_ds, t.batch_size, np.random.default_rng(0)))))
    for _ in range(SF_TRAIN_STEPS):
        trainer.train_step(state, batch, t.lr_max)
    trainer.step_count = SF_TRAIN_STEPS
    ckpt.save(state, trainer)
    geom = bench_geometry()
    fields = channel_flow_trajectory(geom, num_timesteps=LAUNCH_STEPS + 2,
                                     dt=0.01)
    ds = MeshDataset([Trajectory(mesh_id="bench", geom=geom, fields=fields)],
                     timestep_range=(0, LAUNCH_STEPS + 1), device=device)
    ds.add_grad_weights("cell", MLS_ORDER)
    model, cfg, meta = rollout_cli.restore_model(ckpt.resolve("latest"),
                                                 device)
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg.model.aggregation = "segment"
    plain = train_cli.build_model(plain_cfg, device)
    plain.set_stats(meta["stats"])
    plain.module.load_state_dict(model.module.state_dict())
    out_dir = os.path.join(SMOKE_DIR, "rollouts-streamfunca")
    ref = rollout_cli.rollout_dataset(plain, ds, os.path.join(out_dir, "plain"),
                                      timestep_range=(0, CHECK_STEPS + 1))
    zero_launches()
    res = rollout_cli.rollout_dataset(model, ds, os.path.join(out_dir, "kernel"))
    launches = launch_counts()
    check_launches("StreamFuncA", launches, LAUNCH_STEPS)
    with open(os.path.join(out_dir, "kernel", "errors.json")) as f:
        written = json.load(f)["scalar"]
    means = {k: written[k]["mean_all"] for k in
             ("velocity_error", "pressure_error", "divergence_error")}
    if not np.isfinite(list(means.values())).all():
        fail(f"StreamFuncA rollout.run: non-finite errors {means}")
    rel, first = {}, {}
    for k in means:
        a = res["errors"][k][:CHECK_STEPS].double()
        b = ref["errors"][k].double()
        r = ((a - b).abs() / b.abs()).reshape(CHECK_STEPS, -1).amax(1)
        first[k], rel[k] = float(r[0]), float(r.max())
        # the first step: one forward of each route from the same state;
        # the later ones run free, each route on its own state
        tols = ((STREAMFUNC_DIVERGENCE_TOL, STREAMFUNC_DIVERGENCE_TOL)
                if k == "divergence_error" else
                (STEP_TOL, STREAMFUNC_STEP_TOL))
        if first[k] > tols[0] or rel[k] > tols[1]:
            fail(f"StreamFuncA rollout.run: {k} of the first {CHECK_STEPS} "
                 f"steps {a.tolist()} (kernel) vs {b.tolist()} (plain): the "
                 f"first {first[k]:.3g} (limit {tols[0]}), the largest "
                 f"{rel[k]:.3g} (limit {tols[1]})")
    sps = res["num_steps"] / res["seconds"]
    say(f"phase 7e StreamFuncA through rollout.run on a checkpoint the port "
        f"wrote ({os.path.basename(ckpt.resolve('latest'))}), bench mesh "
        f"with MLS cell weights: {res['num_steps']} steps with the error "
        f"metrics in {res['seconds']:.4f} s = {sps:.1f} steps/s; launches "
        + json.dumps(launches) + "; errors.json mean_all " + json.dumps(means)
        + "; against the plain route, relative difference of the first step "
        + json.dumps(first) + f", the largest of the first {CHECK_STEPS} "
        + json.dumps(rel) + f"; card {device_line}")
    return {"launches": launches, "rollout_steps": LAUNCH_STEPS,
            "steps_per_s": sps, "ms_per_step": 1e3 / sps, "profile": None}


def families_phase(dev, ds, train_ds, line: str) -> dict:
    """Phase 7: 7a every variant, 7b the timed three, 7c FvgnC's
    validation on the table route, 7d FvgnC's training, 7e StreamFuncA
    through the rollout entry point. Returns the paths' records."""
    t7 = time.perf_counter()
    graph = phase7_mesh(dev)
    paths, models = {}, {}
    for name in FVGN_VARIANTS + STREAMFUNC_VARIANTS:
        paths[name], kern, feats = variant_phase(name, graph)
        if name in TIMED_PATHS:
            models[name] = (kern, feats)
    for name in TIMED_PATHS:
        kern, feats = models[name]
        paths[f"{name}-timed"] = timed_variant(name, kern, graph, feats, line)
    paths["FvgnC-valid"], paths["FvgnC-valid-index"] = fvgnc_valid_phase(ds)
    paths["FvgnC-train"] = fvgnc_training(train_ds, line)
    paths["StreamFuncA-rollout-run"] = streamfunc_rollout_run(train_ds, dev,
                                                              line)
    say(f"phase 7 card {line}; " + "; ".join(
        f"{name} {p['steps_per_s']:.1f} forwards/s, {p['ms_per_step']:.4f} "
        "ms per forward" + ("" if p["profile"] is None else
                            f", device {p['profile']['device_ms_per_step']:.4f}"
                            f" ms per forward, busy "
                            f"{100 * p['profile']['busy_share']:.1f} %, "
                            f"{p['profile']['kernels_per_step']:g} kernels "
                            "per forward")
        for name, p in paths.items() if name.endswith("-timed"))
        + f"; phase 7 wall time {time.perf_counter() - t7:.1f} s")
    return paths


# ---- phase 8: the rest of the Flux family and the VertPot family -------------

def raw_divergence_check(kern, graph, device_line: str) -> dict:
    """Phase 8b for VertPotA: a CHECK_STEPS-step rollout of the kernel route
    with the error metrics against the channel flow. Its
    ``divergence_raw_error`` (of the telescoped cell flux before
    denormalization) must stay within (RAW_DIVERGENCE_ULPS x the largest raw
    flux of the steps)^2, and its ``divergence_error`` (of the denormalized
    flux) must be the z-score inverse's offset, (3 x the face flux's mean)^2
    per cell, within 1e-3 relative."""
    geom = bench_geometry()
    fields = channel_flow_trajectory(geom, num_timesteps=CHECK_STEPS + 2,
                                     dt=0.01)
    pad = ((0, 0), (0, graph.num_cells - geom["cell_pos"].shape[0]), (0, 0))
    gv, gp = (torch.from_numpy(np.pad(fields[k][1:CHECK_STEPS + 1], pad))
              .to(graph.device) for k in ("cell_velocity", "cell_pressure"))
    _, feats = kern.transform_rollout(graph)
    errors, _ = rollout_scan(kern, graph, feats, gv, gp,
                             RolloutConfig(num_steps=CHECK_STEPS))
    raw_max = 0.0
    with torch.inference_mode():       # the same steps, for the raw flux
        for _ in range(CHECK_STEPS):
            out = kern.forward(graph, feats)
            raw_max = max(raw_max, float(
                out["_cell_flux_raw"][graph.cell_mask].abs().max()))
            feats = kern.update_features(kern.derive_state(out, feats, graph),
                                         feats, graph)
    raw = errors["divergence_raw_error"][:, 0].double()
    div = errors["divergence_error"][:, 0].double()
    limit = (RAW_DIVERGENCE_ULPS * raw_max) ** 2
    offset = (3.0 * float(kern.stats["face_flux"]["mean"])) ** 2
    if not (torch.isfinite(raw).all() and float(raw.max()) <= limit):
        fail(f"VertPotA: divergence_raw_error {raw.tolist()} over the limit "
             f"{limit:.3g} (largest raw flux {raw_max:.6g})")
    gap = float(((div - offset).abs() / offset).max())
    if not gap <= 1e-3:
        fail(f"VertPotA: divergence_error {div.tolist()} is not (3 x mean "
             f"face flux)^2 = {offset:.6g} ({gap:.3g} apart)")
    say(f"phase 8b VertPotA {CHECK_STEPS}-step rollout with the error "
        "metrics: divergence_raw_error by step "
        + json.dumps([float(f"{v:.6g}") for v in raw.tolist()])
        + f", within (2^-20 x {raw_max:.6g})^2 = {limit:.6g}; "
        "divergence_error by step "
        + json.dumps([float(f"{v:.6g}") for v in div.tolist()])
        + f", (3 x mean face flux)^2 = {offset:.6g}, within {gap:.3g}; card "
        f"{device_line}")
    return {"raw_max": float(raw.max()), "limit": limit, "offset_gap": gap}


def flux_vertpot_phase(dev, ds, train_ds, line: str) -> dict:
    """Phase 8: 8a every Flux and VertPot variant on the bench mesh (as 7a),
    8b FluxA and VertPotA timed (as 7b) and VertPotA's raw divergence, 8c
    VertPotA's ``validate`` on FluxD-valid's batch (table route) beside its
    index and plain routes, 8d FluxA's and VertPotA's training. Returns the
    paths' records."""
    t8 = time.perf_counter()
    graph = phase7_mesh(dev)
    paths, models = {}, {}
    for name in FLUX_VARIANTS + VERTPOT_VARIANTS:
        paths[name], kern, feats = variant_phase(name, graph, phase="8a")
        if name in P8_TIMED_PATHS:
            models[name] = (kern, feats)
    for name in P8_TIMED_PATHS:
        kern, feats = models[name]
        paths[f"{name}-timed"] = timed_variant(name, kern, graph, feats, line,
                                               phase="8b")
    raw = raw_divergence_check(models["VertPotA"][0], graph, line)
    paths["VertPotA-valid"], paths["VertPotA-valid-index"] = (
        routes_validation("VertPotA-valid", "VertPotA", ds, P8_VALID_STEPS, 1,
                          P8_VALID_TOL, "8c", "VertPotA on FluxD-valid's batch"))
    for name in P8_TIMED_PATHS:
        paths[f"{name}-train"] = train_steps(name, train_ds, line, "8d",
                                             P8_TRAIN_STEPS, P8_LOSS_WINDOW)
    say(f"phase 8 card {line}; " + "; ".join(
        f"{name} {p['steps_per_s']:.1f} steps/s, {p['ms_per_step']:.4f} "
        "ms per step" + ("" if p["profile"] is None else
                         f", device {p['profile']['device_ms_per_step']:.4f}"
                         f" ms per step, busy "
                         f"{100 * p['profile']['busy_share']:.1f} %, "
                         f"{p['profile']['kernels_per_step']:g} kernels "
                         "per step")
        for name, p in paths.items() if name.endswith("-timed"))
        + f"; VertPotA raw divergence {json.dumps(raw)}"
        + f"; phase 8 wall time {time.perf_counter() - t8:.1f} s")
    return paths


# ---- phase 9: the Conservative family -----------------------------------------

def conservative_phase(dev, ds, train_ds, line: str) -> dict:
    """Phase 9: 9a each of the ten on phase 7's mesh (as 7a: CHECK_STEPS
    forwards against the plain route, the kernels' order in a block, then
    LAUNCH_STEPS steps with the counters: K3 15 and K5 15 a step for F, G,
    I at H and H, J, K at 2H, nothing for A, B, D, E), 9b ConservativeA
    and ConservativeH timed and profiled (as 7b), 9c ConservativeH's
    ``validate`` on FluxD-valid's batch on the table route (K6's roll form
    15 and K7 15 a step, at 2H and H) beside its index and plain routes,
    9d ConservativeA's and ConservativeJ's training (as 7d). Returns the
    paths' records."""
    t9 = time.perf_counter()
    graph = phase7_mesh(dev)
    paths, models = {}, {}
    for name in CONSERVATIVE_VARIANTS:
        paths[name], kern, feats = variant_phase(name, graph, phase="9a")
        if name in P9_TIMED_PATHS:
            models[name] = (kern, feats)
    for name in P9_TIMED_PATHS:
        kern, feats = models[name]
        paths[f"{name}-timed"] = timed_variant(name, kern, graph, feats, line,
                                               phase="9b")
    paths["ConservativeH-valid"], paths["ConservativeH-valid-index"] = (
        routes_validation("ConservativeH-valid", "ConservativeH", ds,
                          P9_VALID_STEPS, 1, P9_VALID_TOL, "9c",
                          "ConservativeH on FluxD-valid's batch"))
    for name in P9_TRAINED:
        paths[f"{name}-train"] = train_steps(name, train_ds, line, "9d",
                                             P9_TRAIN_STEPS, P9_LOSS_WINDOW)
    say(f"phase 9 card {line}; " + "; ".join(
        f"{name} {p['steps_per_s']:.1f} steps/s, {p['ms_per_step']:.4f} "
        "ms per step" + ("" if p["profile"] is None else
                         f", device {p['profile']['device_ms_per_step']:.4f}"
                         f" ms per step, busy "
                         f"{100 * p['profile']['busy_share']:.1f} %, "
                         f"{p['profile']['kernels_per_step']:g} kernels "
                         "per step")
        for name, p in paths.items() if name.endswith("-timed"))
        + f"; phase 9 wall time {time.perf_counter() - t9:.1f} s")
    return paths


# ---- phase 10: the fused train calls ------------------------------------------

def recipe_config(path: str = RECIPE_CONFIG, tag: str = "FluxD-r5"):
    """``config/e2e/fluxd-r5.json`` (or the recipe at ``path``) as phase 10
    trains it: its model (FluxD at h128, 15 blocks, bf16) with the ``auto``
    aggregation, so that its validation takes the kernel route; its
    training section (AdamW, clip 10, its loss weights, noise_std_norm
    0.045, pushforward 2, 16 steps a call, static_chunked, batch 4) for
    FUSED_EPOCHS epochs, the first the pushforward warm-up, mini-epochs of
    FUSED_MINI_EPOCH samples; no checkpoint; statistics over every 4th
    sample, not cached."""
    cfg = load_config(path)
    cfg.model.aggregation = "auto"
    t = cfg.training
    t.epochs = FUSED_EPOCHS
    t.pushforward_warmup_epochs = FUSED_WARMUP_EPOCHS
    t.mini_epoch_size = FUSED_MINI_EPOCH
    cfg.logging.save_frequency = 0
    cfg.logging.name = f"{tag}-chip-smoke"
    cfg.dataset.stats_fpath = None
    cfg.dataset.stats_stride = 4
    return cfg


def fused_dataset(train_ds, cfg, num_buckets: int = 1) -> MeshDataset:
    """Phase 5's trajectories (or ``train_ds``'s) in windows of the
    recipe's pushforward (pushforward_factor + 2 states), padded in
    ``num_buckets`` size buckets."""
    stride, window = compute_window(cfg.model.timestep_stride,
                                    cfg.training.pushforward_factor,
                                    cfg.model.bundle_size)
    return MeshDataset(train_ds.trajectories, stride=stride,
                       data_window=window, num_buckets=num_buckets,
                       device=train_ds.device)


def crossing_rule(calls, steps_per_mini_epoch: int) -> tuple:
    """(steps, mini-epochs) after fused calls of ``calls`` steps each, by
    the JAX package's rule: a call that carries the step count past a
    mini-epoch boundary ends one mini-epoch."""
    steps = mini_epochs = 0
    for n in calls:
        steps += n
        if steps // steps_per_mini_epoch > mini_epochs:
            mini_epochs += 1
    return steps, mini_epochs


@contextlib.contextmanager
def synced_span(name: str, **attrs):
    """The recorder's span ``name`` that waits for the card before it
    closes, so that its time is the device's work and not only its
    launch."""
    with profiling.span(name, **attrs):
        yield
        torch.cuda.synchronize()


def fused_training(train_ds, valid_ds, device_line: str, cfg=None,
                   checkpointer=None, timed: bool = False,
                   tag: str = "10a FluxD-r5", num_buckets: int = 1) -> tuple:
    """Phase 10a (and 12b, with ``tag``): ``Trainer.run`` of the fluxd-r5
    recipe (``cfg``, by default ``recipe_config()``) on the card. The
    automatic choice must be the indexed path, the calls of each epoch 16,
    16, 6, the counters JAX's rule, the trajectory store on the card as
    large as ``estimate_device_field_bytes``; no kernel in a warm-up call,
    and in a pushforward call only the unroll's rollout-mode forwards on
    the fused route (K1-K3 15 each a forward, PF forwards a step); each
    validation phase 5's launches; the losses finite, epoch 1's falling
    on the combination of meshes it began with.
    With ``checkpointer``, a checkpoint at the last mini-epoch; with
    ``timed``, each call and each validation is a :func:`synced_span`
    (``train_call`` with its ``epoch``, ``validate``) for the caller's
    ``profiling.recording`` to time. The dataset is padded in
    ``num_buckets`` size buckets (phase 14a), each combination's store at
    its own pad. Returns (the path's record, with each call's steps,
    epoch, cells and launches; the trainer, its state, the dataset)."""
    name = tag.split()[1]
    cfg = recipe_config() if cfg is None else cfg
    ds = fused_dataset(train_ds, cfg, num_buckets)
    t = cfg.training
    spc, pf = t.steps_per_call, t.pushforward_factor
    per_epoch = len(list(get_sampler(cfg.dataset.sampler)(
        ds, t.batch_size, np.random.default_rng(0))))
    want_calls = [min(spc, per_epoch - i)
                  for i in range(0, per_epoch, spc)] * FUSED_EPOCHS
    spme = max(t.mini_epoch_size // t.batch_size, 1)
    want_steps, want_me = crossing_rule(want_calls, spme)
    cfg.logging.valid_frequency = want_me
    cfg.logging.save_frequency = want_me if checkpointer is not None else 0
    if not cfg.logging.use_monitor:
        fail(f"{name}: the recipe no longer sets logging.use_monitor")
    monitor = TimedMonitor()
    trainer, state = build_trainer(cfg, ds, checkpointer, monitor=monitor)
    path = trainer.train_path(ds)
    if path != "indexed":
        fail(f"{name}: the trainer chose the {path} path, not indexed "
             f"({ds.estimate_device_field_bytes()} bytes of trajectories)")

    calls, valid_launches = [], []
    fused_fn, validate_fn = trainer.train_step_indexed, trainer.validate

    def section(what, **attrs):
        return (synced_span(what, **attrs) if timed
                else contextlib.nullcontext())

    def counted_call(state, graph, dev, ts, lrs, window, **kw):
        before = launch_counts()
        with section("train_call", epoch=trainer.epoch_count):
            out = fused_fn(state, graph, dev, ts, lrs, window, **kw)
        calls.append({"epoch": trainer.epoch_count, "steps": len(lrs),
                      "cells": graph.num_cells,
                      "combo": next(c for c, v in ds._device_fields_cache.items()
                                    if v is dev),
                      "launches": {k: v - before[k]
                                   for k, v in launch_counts().items()},
                      "losses": out["total_log_loss"]})
        return out

    def counted_validate(state, *args, **kw):
        before = launch_counts()
        with section("validate"):
            out = validate_fn(state, *args, **kw)
        valid_launches.append({k: v - before[k]
                               for k, v in launch_counts().items()})
        return out

    trainer.train_step_indexed, trainer.validate = counted_call, counted_validate
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run(state, ds, valid_ds, num_valid_steps=CHECK_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_launches = launch_counts()
    trainer.train_step_indexed, trainer.validate = fused_fn, validate_fn

    got_calls = [c["steps"] for c in calls]
    if got_calls != want_calls:
        fail(f"{name}: calls of {got_calls} steps, expected {want_calls}")
    counters = (trainer.epoch_count, trainer.step_count,
                trainer.mini_epoch_count, trainer.sample_count, state.step)
    want_counters = (FUSED_EPOCHS, want_steps, want_me,
                     want_steps * t.batch_size, want_steps)
    if counters != want_counters:
        fail(f"{name}: epoch, step, mini-epoch, sample counts and state "
             f"step {counters}, expected {want_counters}")
    unroll = PATHS["FluxD"][1]
    for c in calls:
        forwards = c["steps"] * pf if c["epoch"] > FUSED_WARMUP_EPOCHS else 0
        want = {k: unroll.get(k, 0) * forwards for k in KERNELS}
        if c["launches"] != want:
            fail(f"{name}: launches in a call of {c['steps']} steps in "
                 f"epoch {c['epoch']}: {c['launches']}, expected {want}")
    per_valid = {k: PATHS["FluxD-valid"][1].get(k, 0) * CHECK_STEPS
                 for k in KERNELS}
    if len(valid_launches) != 2 or any(v != per_valid for v in valid_launches):
        fail(f"{name}: launches per validation {valid_launches}, expected "
             f"2 validations of {per_valid}")
    store = [v for combo in ds._device_fields_cache.values()
             for v in combo.values()]
    store_bytes = sum(v.numel() * v.element_size() for v in store)
    # a combination holds a mesh as often as it names it (static_chunked
    # pads a chunk with a repeated mesh), at the combination's pad; the
    # estimate counts each mesh once, at its bucket's pad
    def mesh_bytes(tr, pad):
        return sum(tr.fields[k].shape[0] * tr.fields[k].shape[2] * 4
                   * pad["cell" if k.startswith("cell") else "face"]
                   for k in FIELD_KEYS if k in tr.fields)
    want_store = sum(mesh_bytes(ds.by_id[m], ds._pad_for(combo))
                     for combo in ds._device_fields_cache for m in combo)
    estimate = ds.estimate_device_field_bytes()
    if (store_bytes != want_store
            or any(v.device != ds.device for v in store)):
        fail(f"{name}: the trajectory store holds {store_bytes} bytes on "
             f"{sorted({str(v.device) for v in store})}, its combinations' "
             f"meshes {want_store}, the estimate {estimate} on {ds.device}")
    by_epoch = {e: torch.cat([c["losses"] for c in calls if c["epoch"] == e])
                .tolist() for e in range(1, FUSED_EPOCHS + 1)}
    mini = logged(trainer, "train/total_log_loss")
    if (not all(np.isfinite(v).all() for v in by_epoch.values())
            or len(mini) != want_me or not np.isfinite(mini).all()):
        fail(f"{name}: losses by epoch {by_epoch}, mini-epochs {mini}")
    # epoch 1's steps on the combination it began with: with size buckets
    # (14a) its first steps are one bucket's meshes and its last another's,
    # whose losses are not comparable
    begun = torch.cat([c["losses"] for c in calls if c["epoch"] == 1
                       and c["combo"] == calls[0]["combo"]]).tolist()
    first = float(np.mean(begun[:FUSED_LOSS_WINDOW]))
    last = float(np.mean(begun[-FUSED_LOSS_WINDOW:]))
    if not last < first:
        fail(f"{name}: epoch 1's mean loss of its last {FUSED_LOSS_WINDOW} "
             f"steps on its first combination {last} not below its first "
             f"{FUSED_LOSS_WINDOW} {first}")
    mon = monitored(trainer)
    if (monitor.calls["copy_gradients"] != want_me
            or mon["steps"] != list(range(1, want_me + 1))
            or mon["gradient_steps"] != mon["steps"]
            or mon["update_steps"] != mon["steps"][1:]
            or not mon["scalar_keys"] or not mon["finite"]):
        fail(f"{name}: the monitor copied gradients "
             f"{monitor.calls['copy_gradients']} times for {want_me} "
             f"mini-epochs and logged {mon}")
    say(f"phase {tag} Trainer.run (config/e2e/fluxd-r5.json's "
        f"training, h{H} mp{MP_NUM} bf16, batch {t.batch_size}, "
        f"{spc} steps a call, {cfg.dataset.sampler}, "
        f"{FUSED_EPOCHS} epochs, pushforward {pf} after {FUSED_WARMUP_EPOCHS}"
        f" warm-up epoch): ok, path {path}; calls {got_calls}; epoch, step, "
        f"mini-epoch, sample counts {list(counters[:4])} (JAX's crossing rule "
        f"at {spme} steps a mini-epoch); trajectory store {store_bytes} bytes "
        "on the card = its combinations' meshes (estimate_device_field_bytes, "
        f"each mesh once: {estimate}); launches per call "
        + json.dumps([{k: v for k, v in c["launches"].items() if v}
                      for c in calls])
        + " (the pushforward unroll's rollout-mode forwards only); per "
        "validation " + json.dumps({k: v for k, v in per_valid.items() if v})
        + f"; epoch 1 mean loss on its first combination ({len(begun)} "
        f"steps) of the first {FUSED_LOSS_WINDOW} steps {first:.6f}, of the "
        f"last {last:.6f}; of the whole epoch's ({len(by_epoch[1])}) first "
        f"{FUSED_LOSS_WINDOW} {np.mean(by_epoch[1][:FUSED_LOSS_WINDOW]):.6f}, "
        f"last {np.mean(by_epoch[1][-FUSED_LOSS_WINDOW:]):.6f}; mini-epoch losses "
        + json.dumps([round(v, 6) for v in mini])
        + f"; {run_s:.2f} s (two validations included); the monitor: "
        f"gradients copied {monitor.calls['copy_gradients']} times (once a "
        f"mini-epoch), {len(mon['gradient_keys'])} gradient norms, "
        f"{len(mon['scalar_keys']) // 2} scalar parameters with their "
        "gradients and the update logged at every mini-epoch (the update "
        "from the 2nd), ms in all (host "
        f"clock, synchronized around each call) "
        + json.dumps({k: round(v, 3) for k, v in monitor.ms.items()})
        + f"; card {device_line}")
    record = {"launches": run_launches,
              "rollout_steps": 2 * CHECK_STEPS + pf * sum(
                  c["steps"] for c in calls if c["epoch"] > FUSED_WARMUP_EPOCHS),
              "loss_first": first, "loss_last": last, "run_s": run_s,
              "calls": calls}
    return record, trainer, state, ds


class TimedMonitor(ModelMonitor):
    """A ModelMonitor that counts its calls and times them (host clock,
    the card synchronized before and after each)."""

    def __init__(self):
        super().__init__()
        self.calls = {n: 0 for n in _MONITOR_METHODS}
        self.ms = {n: 0.0 for n in _MONITOR_METHODS}

    def _timed(self, name, *args):
        sync = (torch.cuda.synchronize if torch.cuda.is_available()
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        out = getattr(super(), name)(*args)
        sync()
        self.calls[name] += 1
        self.ms[name] += 1e3 * (time.perf_counter() - t0)
        return out

    def copy_gradients(self, *args):
        return self._timed("copy_gradients", *args)

    def monitor_decoder_gradients(self, *args):
        return self._timed("monitor_decoder_gradients", *args)

    def monitor_decoder_updates(self, *args):
        return self._timed("monitor_decoder_updates", *args)

    def monitor_scalar_parameters(self, *args):
        return self._timed("monitor_scalar_parameters", *args)


_MONITOR_METHODS = ("copy_gradients", "monitor_decoder_gradients",
                    "monitor_decoder_updates", "monitor_scalar_parameters")


def monitored(trainer) -> dict:
    """What the monitor wrote into the trainer's metrics: the steps with
    any record, with gradient norms and with the update, the keys of each
    kind, and whether every value is finite."""
    with open(trainer.logger.metrics_path) as f:
        rows = [json.loads(line) for line in f]
    keys = {k for r in rows for k in r
            if k.split("/")[0] in ("gradients", "updates", "scalar_params")}
    values = [r[k] for r in rows for k in keys if k in r]

    def steps(pick):
        return sorted({r["step"] for r in rows if any(pick(k) for k in r
                                                      if k in keys)})
    return {"steps": steps(lambda k: True),
            "gradient_steps": steps(lambda k: k.startswith("gradients/")),
            "update_steps": steps(lambda k: k == "updates/face_mlp"),
            "gradient_keys": sorted(k for k in keys
                                    if k.startswith("gradients/")),
            "scalar_keys": sorted(k for k in keys
                                  if k.startswith("scalar_params/")),
            "finite": bool(values) and bool(np.isfinite(values).all())}


def _snapshot(state):
    """A copy of the train state's tensors: module, optimizer, generator,
    step."""
    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [clone(v) for v in tree]
        return tree.clone() if isinstance(tree, torch.Tensor) else tree
    return (clone(state.module.state_dict()),
            clone(state.optimizer.state_dict()), state.generator.get_state(),
            state.step)


def _restore(state, snap):
    state.module.load_state_dict(snap[0])
    state.optimizer.load_state_dict(copy.deepcopy(snap[1]))
    state.generator.set_state(snap[2])
    state.step = snap[3]


def three_ways_child() -> int:
    """Phase 10b, run as ``python3 chip_smoke.py --phase10b`` (in a process
    of its own, CUBLAS_WORKSPACE_CONFIG set by the parent, under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``): from one
    state, one indexed call of 16 pushforward steps, one multi call and 16
    ``train_step``s on the same batches, learning rates and generator
    state. Prints the comparison as one JSON line; exits 1 when the three
    part (bit for bit, or, where an op warned that it has no deterministic
    implementation, beyond FUSED_ND_LOSS_RTOL and 2 k lr + 1e-6)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_kernels()
    return three_ways_run(torch.device("cuda", 0))


def three_ways_run(dev) -> int:
    """``three_ways_child``'s comparison on ``dev``."""
    cfg = recipe_config()
    ds = fused_dataset(train_data(dev), cfg)
    trainer, state = build_trainer(cfg, ds)
    trainer.epoch_count = FUSED_WARMUP_EPOCHS + 1
    t = cfg.training
    k = t.steps_per_call
    batches = list(itertools.islice(get_sampler(cfg.dataset.sampler)(
        ds, t.batch_size, np.random.default_rng(0)), k))
    combo = tuple(m for m, _ in batches[0])
    ts = np.asarray([[s for _, s in b] for b in batches], np.int32)
    lrs = [t.lr_max] * k
    snap = _snapshot(state)
    ways = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        singles = [trainer.train_step(state, ds.get_batch(b), lr)
                   for b, lr in zip(batches, lrs)]
        ways["single"] = ({n: torch.stack([s[n] for s in singles])
                           for n in singles[0]}, _snapshot(state))
        _restore(state, snap)
        ways["multi"] = (trainer.train_step_multi(
            state, *ds.get_batch_stack(batches), lrs), _snapshot(state))
        _restore(state, snap)
        ways["indexed"] = (trainer.train_step_indexed(
            state, ds._batched_static(combo), ds.device_fields(combo), ts,
            lrs, ds.data_window), _snapshot(state))
        torch.cuda.synchronize()
    nondeterministic = sorted({str(w.message).split("\n")[0] for w in caught
                               if "deterministic" in str(w.message)})
    losses, (module, opt, gen, step) = ways["single"]
    result = {"steps": k, "nondeterministic_ops": nondeterministic}
    ok = True
    for name in ("multi", "indexed"):
        l2, (m2, o2, g2, s2) = ways[name]
        moments = [(v, o2["state"][i][key]) for i, st in opt["state"].items()
                   for key, v in st.items()]
        same = {"losses": all(torch.equal(l2[n], losses[n]) for n in losses),
                "parameters": all(torch.equal(m2[n], module[n])
                                  for n in module),
                "optimizer": all(torch.equal(a, b) for a, b in moments),
                "generator": torch.equal(g2, gen) and s2 == step}
        loss_rel = max(float(((l2[n] - losses[n]).abs()
                              / losses[n].abs().clamp_min(1e-30)).max())
                       for n in losses)
        param_abs = max(float((m2[n].float() - module[n].float()).abs().max())
                        for n in module if module[n].is_floating_point())
        result[name] = {"bit_for_bit": same, "loss_max_rel": loss_rel,
                        "param_max_abs": param_abs}
        if nondeterministic:
            ok &= (loss_rel <= FUSED_ND_LOSS_RTOL
                   and param_abs <= 2 * k * t.lr_max + 1e-6)
        else:
            ok &= all(same.values())
    result["losses"] = [round(v, 6) for v in losses["total_log_loss"].tolist()]
    say("phase 10b result: " + json.dumps(result))
    return 0 if ok else 1


def start_child(*args: str, env: dict = None) -> subprocess.Popen:
    """``python3 chip_smoke.py <args>`` in a process of its own (phases
    10b, 11a, 11b), ``env`` added to this process's environment."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), *args],
                            env={**os.environ, **(env or {})},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def child_result(proc: subprocess.Popen, tag: str) -> dict:
    """The JSON line ``<tag> result: {...}`` of a child that ran to its end
    with exit code 0; fails otherwise."""
    stdout, stderr = proc.communicate(timeout=600)
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith(f"{tag} result: ")]
    if proc.returncode != 0 or not lines:
        fail(f"{tag}: exit {proc.returncode}; {lines[-1:]}; stderr "
             + stderr[-3000:])
    return json.loads(lines[-1].removeprefix(f"{tag} result: "))


def start_three_ways() -> subprocess.Popen:
    """Phase 10b's process: ``three_ways_child``, with
    CUBLAS_WORKSPACE_CONFIG=:4096:8 set before its first product, so that
    deterministic algorithms bind no other phase. It runs beside 10a, which
    times nothing, and is waited for before 10c."""
    return start_child("--phase10b",
                       env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})


def three_ways(proc: subprocess.Popen, t0: float, device_line: str) -> dict:
    """Phase 10b: the result of ``start_three_ways``'s process, started at
    ``t0``; fails unless it ran to its end and the three ways agreed."""
    result = child_result(proc, "phase 10b")
    kind = ("within the stated tolerance, ops without a deterministic "
            "implementation: " + "; ".join(result["nondeterministic_ops"])
            if result["nondeterministic_ops"] else "bit for bit")
    say(f"phase 10b FluxD-r5 one state three ways ({result['steps']} "
        "pushforward steps: an indexed call, a multi call, single steps; "
        "deterministic algorithms, CUBLAS_WORKSPACE_CONFIG=:4096:8, a process "
        f"of its own): ok, {kind}; " + json.dumps(result)
        + f"; {time.perf_counter() - t0:.1f} s beside 10a; card {device_line}")
    return result


def fused_times(trainer, state, ds, device_line: str) -> dict:
    """Phase 10c: ms per train step, host clock ending in a synchronize,
    of FUSED_TIMED_CALLS calls of each kind in turns on one combination's
    first ``steps_per_call`` batches, through the feed ``Trainer.run``
    gives each: single steps through ``prefetch`` (its worker thread),
    one multi call through ``prefetch_grouped``, one indexed call through
    ``prefetch_indexed``; then a device profile of one indexed call (its
    device time and kernels per step, busy share, host-to-device copies)."""
    t = trainer.config.training
    k = t.steps_per_call
    batches = list(itertools.islice(get_sampler(trainer.config.dataset.sampler)(
        ds, t.batch_size, np.random.default_rng(1)), k))
    lr = t.lr_min

    def single():
        for g in prefetch(iter(batches), ds, size=t.prefetch_buffer):
            trainer.train_step(state, g, lr)

    def multi():
        for _, graph, stack in prefetch_grouped(iter(batches), ds, k,
                                                size=t.prefetch_buffer):
            trainer.train_step_multi(state, graph, stack, [lr] * k)

    def indexed():
        for _, graph, dev, ts in prefetch_indexed(iter(batches), ds, k):
            trainer.train_step_indexed(state, graph, dev, ts, [lr] * k,
                                       ds.data_window)

    runs = {"single": single, "multi": multi, "indexed": indexed}
    times = {name: [] for name in runs}
    zero_launches()
    for _ in range(FUSED_TIMED_CALLS):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0) / k)
    launches = {n: v for n, v in launch_counts().items() if v}
    prof = profile_steps(indexed, k, copies=True)
    _, stack = ds.get_batch_stack(batches)
    stack_bytes = sum(v.numel() * v.element_size() for v in stack.values())
    ts_bytes = 8 * k * t.batch_size     # the call's (k, B) int64 start steps
    say(f"phase 10c FluxD-r5 ms per train step ({k} pushforward steps a call"
        f", {FUSED_TIMED_CALLS} calls of each kind in turns, host clock ending"
        " in a synchronize, the feed's assembly included): "
        + json.dumps({n: [round(v, 3) for v in ts] for n, ts in times.items()})
        + f"; launches over them {json.dumps(launches)}; a multi call copies "
        f"{stack_bytes} bytes of windows to the card, an indexed call its "
        f"({k}, {t.batch_size}) int64 start steps, {ts_bytes} bytes (pinned, "
        "asynchronous); device profile of one indexed call (htod_*: the "
        "host-to-device copies its trace records): "
        + ("not measured" if prof is None else json.dumps(prof))
        + f"; card {device_line}")
    return {"ms_per_step": times, "profile": prof,
            "multi_bytes_per_call": stack_bytes,
            "indexed_bytes_per_call": ts_bytes}


def fused_phase(train_ds, valid_ds, line: str) -> dict:
    """Phase 10: 10a with 10b's process beside it, then 10c. Returns the
    path's record."""
    t10 = time.perf_counter()
    child = start_three_ways()
    try:
        record, trainer, state, ds = fused_training(train_ds, valid_ds, line)
        record["three_ways"] = three_ways(child, t10, line)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    record.update(fused_times(trainer, state, ds, line))
    say(f"phase 10 card {line}; FluxD-r5 ms per train step (median of "
        f"{FUSED_TIMED_CALLS} calls): " + json.dumps(
            {n: float(np.median(v))
             for n, v in record["ms_per_step"].items()})
        + f"; phase 10 wall time {time.perf_counter() - t10:.1f} s")
    return record


# ---- phase 11: data-parallel training ------------------------------------------

def dp_config(path: str = RECIPE_CONFIG, tag: str = "FluxD-r5"):
    """Phase 10's recipe (``recipe_config``) with ``settings.multi_gpu``."""
    cfg = recipe_config(path, tag)
    cfg.settings.multi_gpu = True
    cfg.logging.name = f"{tag}-dp-chip-smoke"
    return cfg


def _flat_state(state) -> torch.Tensor:
    """The module's parameters and buffers, in one flat f32 vector."""
    return torch.cat([v.reshape(-1).float()
                      for v in state.module.state_dict().values()])


def dp_nccl_child() -> int:
    """Phase 11a, run as ``python3 chip_smoke.py --phase11a`` (a process of
    its own, CUBLAS_WORKSPACE_CONFIG set by the parent, deterministic
    algorithms with the ops that have none reported): an NCCL group of one
    rank (file store), then ``dp_nccl_run``. Prints one JSON line; exits 1
    when the DP steps and the single steps part."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_kernels()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        data_parallel.init_process_group(
            dev, init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            return dp_nccl_run(dev)
        finally:
            torch.distributed.destroy_process_group()


def dp_nccl_run(dev) -> int:
    """From one state, DP_STEPS ``dp_train_step``s (NCCL, one rank) and
    DP_STEPS ``train_step``s on the recipe's first batches, across the
    warm-up -> pushforward switch (on phase 5's meshes cut to DP_STATES
    states): equal bit for bit (losses, parameters
    and buffers, AdamW's moments, generator, step). Then ms per step of
    each, DP_TIMED_STEPS pushforward steps in turns (dp, single, single,
    dp), the flat all-reduce's bytes and, from a profile of one DP step and
    one single step, the NCCL kernels' device time and what the DP step
    adds to the device time and the kernels (all under 11a's deterministic
    algorithms)."""
    cfg = dp_config()
    ds = fused_dataset(train_data(dev, steps=DP_STATES - 1), cfg)
    trainer, state = build_trainer(cfg, ds)
    t = cfg.training
    batches = list(itertools.islice(get_sampler(cfg.dataset.sampler)(
        ds, t.batch_size, np.random.default_rng(0)), DP_STEPS))
    snap = _snapshot(state)
    ways = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for kind, step in (("dp", trainer.dp_train_step),
                           ("single", trainer.train_step)):
            _restore(state, snap)
            losses = []
            for i, b in enumerate(batches):
                trainer.epoch_count = FUSED_WARMUP_EPOCHS + (
                    i >= DP_STEPS // 2)
                losses.append(step(state, ds.get_batch(b), t.lr_max))
            ways[kind] = ({n: torch.stack([x[n] for x in losses])
                           for n in losses[0]}, _snapshot(state))
        torch.cuda.synchronize()
    nondeterministic = sorted({str(w.message).split("\n")[0] for w in caught
                               if "deterministic" in str(w.message)})
    (l1, (m1, o1, g1, s1)), (l2, (m2, o2, g2, s2)) = ways["dp"], ways["single"]
    same = {"losses": all(torch.equal(l1[n], l2[n]) for n in l2),
            "state": all(torch.equal(m1[n], m2[n]) for n in m2),
            "optimizer": all(torch.equal(o1["state"][i][k], v)
                             for i, st in o2["state"].items()
                             for k, v in st.items()),
            "generator": torch.equal(g1, g2) and s1 == s2 == snap[3] + DP_STEPS}

    graph = ds.get_batch(batches[-1])
    times = {"dp": [], "single": []}
    for kind in ("dp", "single", "single", "dp"):
        step = trainer.dp_train_step if kind == "dp" else trainer.train_step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_TIMED_STEPS):
            step(state, graph, t.lr_min)
        torch.cuda.synchronize()
        times[kind].append(1e3 * (time.perf_counter() - t0) / DP_TIMED_STEPS)
    prof = {kind: profile_steps(lambda: step(state, graph, t.lr_min), 1,
                                named="nccl")
            for kind, step in (("dp", trainer.dp_train_step),
                               ("single", trainer.train_step))}
    n_losses = len(l1)
    flat_floats = (sum(p.numel() for p in state.module.parameters()) + n_losses
                   + sum(b.numel() for b in
                         data_parallel.batch_statistics(state.module)))
    result = {"steps": DP_STEPS, "bit_for_bit": same,
              "nondeterministic_ops": nondeterministic,
              "losses": [round(v, 6) for v in l1["total_log_loss"].tolist()],
              "ms_per_step": times, "allreduce_bytes": 4 * flat_floats,
              "allreduce_floats": {"parameters": flat_floats - n_losses - sum(
                  b.numel() for b in data_parallel.batch_statistics(
                      state.module)), "losses": n_losses},
              "profile": prof}
    say("phase 11a result: " + json.dumps(result))
    return 0 if all(same.values()) else 1


def dp_gloo_child(rank: int, workdir: str) -> int:
    """Phase 11b's rank ``rank``, run as ``python3 chip_smoke.py --phase11b
    <rank> <workdir>``: a gloo group of DP_RANKS ranks on CUDA tensors of
    the one card (NCCL refuses two ranks on one card), its rendezvous a
    file in ``workdir``; then ``dp_gloo_run``. Prints one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_kernels()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    data_parallel.init_process_group(
        dev, init_method=f"file://{workdir}/store", backend="gloo", rank=rank,
        world_size=DP_RANKS)
    try:
        result = dp_gloo_run(dev, rank, workdir)
    finally:
        torch.distributed.destroy_process_group()
    say("phase 11b result: " + json.dumps(result))
    return 0


def _moments(state) -> list:
    """AdamW's first and second moments of every parameter, in the
    optimizer's order."""
    return [state.optimizer.state[p][k].clone()
            for grp in state.optimizer.param_groups for p in grp["params"]
            for k in ("exp_avg", "exp_avg_sq")]


def _moment_gap(got: list, want: list) -> float:
    """The largest, over the moments' tensors, of max |got - want| over
    max |want| (0 where both are 0)."""
    gaps = []
    for a, b in zip(got, want):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        gaps.append(err / scale if scale else (0.0 if err == 0 else np.inf))
    return max(gaps)


def dp_f32_step(dev, ds, rank: int) -> dict:
    """One DP step of the recipe's warm-up in f32 (no noise or flip), rank r
    on half r of the first global batch, held on rank 0 against the single
    process's reference from the same state: each half's gradients, their
    mean, the clip, AdamW. Compares the mean losses and AdamW's moments
    (DP_F32_LOSS_RTOL, DP_F32_MOMENT_RTOL), and the moments of the step on
    rank 0's half alone, which must lie beyond the latter."""
    cfg = dp_config()
    cfg.model.compute_dtype = "float32"
    model = train_cli.build_model(cfg, dev)
    model.set_stats(train_cli.compute_stats(cfg, model, ds))
    tf = model.transform_features
    model.transform_features = (
        lambda g, generator=None, mode="rollout", noise_std=0.0: tf(
            g, None, mode, noise_std))
    trainer = Trainer(cfg, model)
    trainer.epoch_count = FUSED_WARMUP_EPOCHS
    state = trainer.init_state()
    data_parallel.replicate_(state.module)
    t = cfg.training
    per_dev = t.batch_size // DP_RANKS
    # rank 0's batch: static_chunked's draws follow a set's order, which
    # each process hashes its own way
    batch = data_parallel.broadcast_object(next(iter(get_sampler(
        cfg.dataset.sampler)(ds, t.batch_size, np.random.default_rng(0)))))
    halves = [batch[r * per_dev:(r + 1) * per_dev] for r in range(DP_RANKS)]
    snap = _snapshot(state)
    losses = trainer.dp_train_step(state, ds.get_batch(halves[rank]), t.lr_max)
    got = _moments(state)
    if rank != 0:
        return {}
    per_half, half_losses = [], []
    for h in halves:
        _restore(state, snap)
        half_losses.append(trainer._forward_backward(state, ds.get_batch(h)))
        per_half.append([g.clone() for g in gradients(state.optimizer)])

    def moments_from(grads):
        _restore(state, snap)
        for p, g in zip([p for grp in state.optimizer.param_groups
                         for p in grp["params"]], grads):
            p.grad = g.clone()
        optimizer_step(state.optimizer, t.lr_max, t.clip_grad_norm)
        return _moments(state)

    gap = _moment_gap(got, moments_from(
        [sum(gs) / len(gs) for gs in zip(*per_half)]))
    alone = _moment_gap(got, moments_from(per_half[0]))
    loss_rel = max(abs(float(losses[k]) - float(sum(h[k] for h in half_losses)
                                                / len(half_losses)))
                   / abs(float(losses[k])) for k in losses)
    return {"loss_max_rel": loss_rel, "moment_gap": gap,
            "moment_gap_rank0_half_alone": alone,
            "moment_rtol": DP_F32_MOMENT_RTOL,
            "ok": (loss_rel <= DP_F32_LOSS_RTOL
                   and gap <= DP_F32_MOMENT_RTOL < alone)}


def dp_gloo_run(dev, rank: int, workdir: str) -> dict:
    """On each rank: ``dp_f32_step``, then ``Trainer.run`` of the recipe
    with ``multi_gpu`` on phase 5's meshes cut to DP_STATES states, for
    FUSED_EPOCHS epochs (the first the warm-up), each rank with a logger
    and a checkpointer of its own under ``workdir`` and rank 0 with phase
    5's validation set: the counters, the launches of each DP step by epoch
    and of each validation, the replicas compared after every barrier, the
    ms of each DP step (host clock, synchronized around it), the losses and
    what each rank wrote."""
    cfg = dp_config()
    ds = fused_dataset(train_data(dev, steps=DP_STATES - 1), cfg)
    f32 = dp_f32_step(dev, ds, rank)
    t = cfg.training
    spme = max(t.mini_epoch_size // t.batch_size, 1)
    cfg.logging.valid_frequency = 1
    cfg.logging.save_frequency = 1
    valid_ds = valid_data(dev)[0] if rank == 0 else None
    base = os.path.join(workdir, f"rank{rank}")
    model = train_cli.build_model(cfg, dev)
    stats = train_cli.compute_stats(cfg, model, ds)
    model.set_stats(stats)
    train_cli.set_noise_std(cfg, stats)
    trainer = Trainer(cfg, model,
                      logger=Logger(cfg, base_dir=os.path.join(base, "runs")),
                      checkpointer=Checkpointer(os.path.join(base, "ckpt")),
                      monitor=ModelMonitor())
    state = trainer.init_state()
    steps, validations, replicated = [], [], []
    dp_step, validate_fn = trainer.dp_train_step, trainer.validate
    barrier = data_parallel.barrier

    def counted_step(state, graph, lr):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dp_step(state, graph, lr)
        torch.cuda.synchronize()
        steps.append({"epoch": trainer.epoch_count,
                      "ms": 1e3 * (time.perf_counter() - t0),
                      "graphs": graph.num_graphs,
                      "launches": {k: v - before[k]
                                   for k, v in launch_counts().items()},
                      "loss": float(out["total_log_loss"])})
        return out

    def counted_validate(*args, **kw):
        before = launch_counts()
        out = validate_fn(*args, **kw)
        validations.append({k: v - before[k]
                            for k, v in launch_counts().items()})
        return out

    def checked_barrier():
        barrier()
        data_parallel.assert_replicated(_flat_state(state),
                                        "the parameters and buffers")
        replicated.append(trainer.mini_epoch_count)

    trainer.dp_train_step, trainer.validate = counted_step, counted_validate
    data_parallel.barrier = checked_barrier
    zero_launches()
    t0 = time.perf_counter()
    try:
        trainer.run(state, ds, valid_ds, num_valid_steps=CHECK_STEPS)
    finally:
        data_parallel.barrier = barrier
    run_s = time.perf_counter() - t0
    launches = launch_counts()
    trainer.logger.close()
    with open(trainer.logger.metrics_path) as f:
        metric_lines = sum(1 for _ in f)
    mon = monitored(trainer) if metric_lines else None
    ckpt_dir = os.path.join(base, "ckpt")
    return {"rank": rank, "path": trainer.train_path(ds),
            "counters": [trainer.epoch_count, trainer.step_count,
                         trainer.mini_epoch_count, trainer.sample_count,
                         state.step],
            "spme": spme, "global_batch": t.batch_size,
            "per_epoch_batches": sum(
                len(b) == t.batch_size for b in get_sampler(
                    cfg.dataset.sampler)(ds, t.batch_size,
                                         np.random.default_rng(0))),
            "steps": steps, "validations": validations,
            "replicated_at": replicated, "launches": launches,
            "metric_lines": metric_lines, "monitored": mon,
            "checkpoints": sorted(n for n in os.listdir(ckpt_dir)
                                  if n.startswith("checkpoint-")),
            "f32_step": f32, "run_s": run_s}


def dp_phase(line: str) -> dict:
    """Phase 11: 11a in a process of its own, then 11b's DP_RANKS ranks,
    each in a process of its own; their checks, and 11c's times. Returns
    the path's record (the launches of both ranks' runs)."""
    t11 = time.perf_counter()
    a = child_result(start_child("--phase11a", env={
        "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}), "phase 11a")
    t11a = time.perf_counter() - t11
    kind = ("bit for bit" if not a["nondeterministic_ops"] else
            "bit for bit, though ops without a deterministic implementation "
            "warned: " + "; ".join(a["nondeterministic_ops"]))
    say(f"phase 11a FluxD-r5 NCCL, one rank: {a['steps']} dp_train_steps "
        f"against {a['steps']} train_steps across the warm-up -> pushforward "
        f"switch: ok, {kind}; " + json.dumps(a["bit_for_bit"])
        + f"; losses {a['losses']}; its process {t11a:.1f} s; card {line}")
    with tempfile.TemporaryDirectory() as work:
        procs = [start_child("--phase11b", str(r), work)
                 for r in range(DP_RANKS)]
        try:
            ranks = [child_result(p, "phase 11b") for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    r0 = ranks[0]
    t = dp_config().training
    per_dev = max(r0["global_batch"] // DP_RANKS, 1)
    want_steps = FUSED_EPOCHS * r0["per_epoch_batches"]
    want = [FUSED_EPOCHS, want_steps, want_steps // r0["spme"],
            want_steps * per_dev * DP_RANKS, want_steps]
    unroll = PATHS["FluxD"][1]
    per_valid = {k: PATHS["FluxD-valid"][1].get(k, 0) * CHECK_STEPS
                 for k in KERNELS}
    for r in ranks:
        if r["counters"] != want or r["path"] != "data_parallel":
            fail(f"phase 11b rank {r['rank']}: path {r['path']}, counters "
                 f"{r['counters']}, expected {want} (JAX's DP rule)")
        for s in r["steps"]:
            forwards = (t.pushforward_factor
                        if s["epoch"] > FUSED_WARMUP_EPOCHS else 0)
            expect = {k: unroll.get(k, 0) * forwards for k in KERNELS}
            if s["launches"] != expect or s["graphs"] != per_dev:
                fail(f"phase 11b rank {r['rank']}: a step of epoch "
                     f"{s['epoch']} on {s['graphs']} graphs launched "
                     f"{s['launches']}, expected {expect} on {per_dev}")
        if r["replicated_at"] != [0] + list(range(1, want[2] + 1)):
            fail(f"phase 11b rank {r['rank']}: replicas compared at "
                 f"{r['replicated_at']}")
        losses = [s["loss"] for s in r["steps"]]
        if not np.isfinite(losses).all():
            fail(f"phase 11b rank {r['rank']}: losses {losses}")
    if (len(r0["validations"]) != want[2] + 1
            or any(v != per_valid for v in r0["validations"])
            or ranks[1]["validations"]):
        fail(f"phase 11b: validations rank 0 {r0['validations']}, rank 1 "
             f"{ranks[1]['validations']}; expected {want[2] + 1} of "
             f"{per_valid} on rank 0 alone")
    if (r0["metric_lines"] == 0 or not r0["checkpoints"]
            or ranks[1]["metric_lines"] or ranks[1]["checkpoints"]):
        fail(f"phase 11b: metrics lines {[r['metric_lines'] for r in ranks]}, "
             f"checkpoints {[r['checkpoints'] for r in ranks]}: rank 0 alone "
             "writes")
    mon = r0["monitored"]
    if (mon is None or mon["steps"] != list(range(1, want[2] + 1))
            or mon["update_steps"] != mon["steps"][1:] or mon["gradient_keys"]
            or not mon["scalar_keys"] or not mon["finite"]):
        fail(f"phase 11b: rank 0's monitor logged {mon}; expected the update "
             f"and the scalar parameters at mini-epochs 1..{want[2]}, no "
             "gradients (the JAX package's DP path keeps none)")
    if not r0["f32_step"]["ok"]:
        fail(f"phase 11b: the f32 DP step against its reference: "
             f"{r0['f32_step']}")
    epoch1 = [s["loss"] for s in r0["steps"] if s["epoch"] == 1]
    first = float(np.mean(epoch1[:DP_LOSS_WINDOW]))
    last = float(np.mean(epoch1[-DP_LOSS_WINDOW:]))
    if not last < first:
        fail(f"phase 11b: epoch 1's mean loss of its last {DP_LOSS_WINDOW} "
             f"steps {last} not below its first {first}")
    ms = {f"epoch{e}": [round(s["ms"], 3) for s in r0["steps"]
                        if s["epoch"] == e] for e in (1, 2)}
    say(f"phase 11b FluxD-r5 Trainer.run on {DP_RANKS} gloo ranks sharing "
        f"the card (global batch {r0['global_batch']}, {per_dev} a rank, "
        f"{FUSED_EPOCHS} epochs, the first the warm-up): ok; counters "
        f"{want} (JAX's DP rule); replicas bit-equal after every barrier "
        f"{r0['replicated_at']}; rank 0 alone validated "
        f"({len(r0['validations'])} x {json.dumps({k: v for k, v in per_valid.items() if v})}), "
        f"logged ({r0['metric_lines']} lines; rank 1 "
        f"{ranks[1]['metric_lines']}) and checkpointed "
        f"({len(r0['checkpoints'])}; rank 1 {len(ranks[1]['checkpoints'])});"
        f" its monitor logged the update and {len(mon['scalar_keys'])} scalar "
        "parameters at every mini-epoch, no gradients;"
        f" K1-K3 {unroll['K1_fused_face_block'] * t.pushforward_factor} each "
        "a step in epoch 2's unroll on each rank, none in epoch 1; f32 step "
        "against the mean of both halves' gradients, clip, AdamW (losses, "
        "AdamW's moments; rank 0's half alone beside): "
        + json.dumps(r0["f32_step"]) + f"; epoch 1 mean loss of the first "
        f"{DP_LOSS_WINDOW} steps {first:.6f}, of the last {last:.6f}; "
        f"rank 0 run {r0['run_s']:.1f} s; the ranks' processes "
        f"{time.perf_counter() - t11 - t11a:.1f} s; card {line}")
    prof = {k: ("not measured" if v is None else {
        "nccl_ms": v["named_ms_per_step"], "device_ms": v["device_ms_per_step"],
        "kernels": v["kernels_per_step"]}) for k, v in a["profile"].items()}
    say(f"phase 11c card {line}; ms per train step, 11a (NCCL, one rank, "
        f"{DP_TIMED_STEPS} pushforward steps a batch, in turns dp, single, "
        "single, dp; deterministic algorithms): " + json.dumps(a["ms_per_step"])
        + f"; the flat all-reduce {a['allreduce_bytes']} bytes a step "
        + json.dumps(a["allreduce_floats"]) + "; a profile of one DP step "
        "and one single step (NCCL kernels' ms, device ms, kernels; under "
        "deterministic algorithms): " + json.dumps(prof)
        + "; 11b (gloo, 2 ranks sharing one card: the all-reduce staged "
        "through the host; not a multi-card figure), ms per DP step with a "
        "synchronize around it, rank 0: "
        + json.dumps({e: float(np.median(v)) for e, v in ms.items()})
        + f"; phase 11 wall time {time.perf_counter() - t11:.1f} s")
    return {"launches": {k: sum(r["launches"][k] for r in ranks)
                         for k in KERNELS},
            "rollout_steps": CHECK_STEPS * len(r0["validations"])
            + t.pushforward_factor * sum(
                1 for r in ranks for s in r["steps"]
                if s["epoch"] > FUSED_WARMUP_EPOCHS),
            "nccl": a, "gloo": ranks}

# ---- phase 12: the port's own data, the training tools -------------------------

def _quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` with its standard output kept: (result, output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def native_check() -> dict:
    """12a's native builder: built afresh under GEN_DIR (its build time),
    then its connectivity and the numpy path's on a NATIVE_POINTS-point
    cylinder mesh, timed and held equal."""
    native.BUILD_DIR = pathlib.Path(GEN_DIR) / "native"
    native._lib, native._lib_failed = None, False
    t0 = time.perf_counter()
    if not native.native_available():
        fail("12a: the native graph builder did not build (g++)")
    build_s = time.perf_counter() - t0
    pos, cells, _ = cylinder_channel_mesh(n_points=NATIVE_POINTS, seed=0)
    t0 = time.perf_counter()
    got = native.compute_connectivity(cells, pos)
    native_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    want = connectivity.compute_connectivity_full(cells, pos, use_native=False)
    numpy_ms = 1e3 * (time.perf_counter() - t0)
    if not all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(got, want)):
        fail("12a: the native connectivity differs from the numpy path's")
    return {"build_s": build_s, "native_ms": native_ms, "numpy_ms": numpy_ms,
            "cells": int(cells.shape[0]), "faces": int(got[1].shape[1])}


def gen_data(device_line: str) -> tuple:
    """Phase 12a (host): the generation chain through the port's CLIs into
    GEN_DIR, each mesh converted in memory and RCM-ordered (as
    ``train.build_datasets`` orders a banded run's meshes); the fields
    finite, each saved frame's flux divergence-free; the native builder's
    check. Returns (the RCM-ordered trajectories, the record)."""
    shutil.rmtree(GEN_DIR, ignore_errors=True)
    nat = native_check()
    meshes, raw = os.path.join(GEN_DIR, "meshes"), os.path.join(GEN_DIR, "raw")
    t0 = time.perf_counter()
    _quiet(gen_mesh.main, ["--num", str(GEN_MESHES), "--regime", "inflow",
                           "--dt", "0.01", "--seed", "0", "--h", str(GEN_H),
                           "--out", meshes])
    mesh_s = time.perf_counter() - t0
    # the solver's CLI sharded as an array job's tasks: one process a mesh
    t0 = time.perf_counter()
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": os.pathsep.join(
               p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gnn_fluid_dynamics_tpu_torch.generate."
         "simulation", "--meshes", meshes, "--out", raw, "--steps",
         str(GEN_STEPS), "--backend", "builtin", "--spinup", str(GEN_SPINUP),
         "--shard-index", str(i), "--num-shards", str(GEN_MESHES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(GEN_MESHES)]
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        fail("12a: generate.simulation exited "
             f"{[p.returncode for p in procs]}: {logs}")
    sim_s = time.perf_counter() - t0
    trajs, per_mesh = [], []
    for i in range(GEN_MESHES):
        case = f"mesh_{i}"
        t0 = time.perf_counter()
        traj = gen_conversion.convert_case(os.path.join(raw, case),
                                           os.path.join(meshes, case), case)
        conv_s = time.perf_counter() - t0
        with open(os.path.join(raw, case, "time.log")) as f:
            case_s = float(f.read())
        fields, geom = traj.fields, traj.geom
        if not all(np.isfinite(v).all() for v in fields.values()):
            fail(f"12a: {case} has a field that is not finite")
        if fields["cell_velocity"].shape[0] != GEN_STEPS:
            fail(f"12a: {case} holds {fields['cell_velocity'].shape[0]} "
                 f"frames, expected {GEN_STEPS}")
        flux = fields["face_flux"][..., 0].astype(np.float64)
        div = float(np.abs((flux[:, geom["face_index"].T]
                            * geom["cell_face_sign"]).sum(-1)).max())
        if not div < GEN_DIVERGENCE_TOL:
            fail(f"12a: {case}'s face flux has a divergence of {div} per "
                 f"cell, above {GEN_DIVERGENCE_TOL}")
        new_geom = rcm_reorder_geometry(geom)
        traj.fields = reorder_fields(fields, geom, new_geom)
        traj.geom = new_geom
        trajs.append(traj)
        per_mesh.append({"cells": int(geom["cell_pos"].shape[0]),
                         "faces": int(geom["face_pos"].shape[0]),
                         "vertices": int(geom["vertex_pos"].shape[0]),
                         "Re": round(traj.reynolds, 3),
                         "simulate_s": case_s, "convert_s": round(conv_s, 3),
                         "max_divergence": div})
    say(f"phase 12a FluxD-gen data (host): generate.mesh {GEN_MESHES} meshes "
        f"(inflow regime, dt 0.01, seed 0, h {GEN_H}) in {mesh_s:.2f} s; "
        f"generate.simulation (built-in solver, {GEN_STEPS} frames saved "
        f"every 2 solver intervals after {GEN_SPINUP} discarded) in "
        f"{sim_s:.2f} s ({GEN_MESHES} shards at once, one process a mesh); "
        "conversion.convert_case in memory; per mesh "
        + json.dumps(per_mesh) + f" (every field finite, each frame's flux "
        f"divergence below {GEN_DIVERGENCE_TOL} per cell); native graph "
        f"builder built in {nat['build_s']:.2f} s (g++), connectivity of a "
        f"{NATIVE_POINTS}-point mesh ({nat['cells']} cells, {nat['faces']} "
        f"faces) {nat['native_ms']:.2f} ms native against "
        f"{nat['numpy_ms']:.2f} ms numpy, equal; card {device_line}")
    return trajs, {"mesh_s": mesh_s, "simulate_s": sim_s, "meshes": per_mesh,
                   "native": nat}


def gen_config():
    """``recipe_config()`` as phase 12b trains it: mini-epochs of
    GEN_MINI_EPOCH samples, its own run name."""
    cfg = recipe_config()
    cfg.training.mini_epoch_size = GEN_MINI_EPOCH
    cfg.logging.name = "FluxD-gen-chip-smoke"
    return cfg


def trace_kernels(trace_dir: str, wall_s: float) -> dict:
    """The one trace file ``profiling.trace`` wrote under ``trace_dir``: the
    device kernels it names, K1-K7's device functions among them, their
    time, and the share of ``wall_s`` it covers."""
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(files) != 1:
        fail(f"12b: the trace wrote {files}, expected one file")
    with open(files[0]) as f:
        events = json.load(f).get("traceEvents", [])
    kernels_ = [e for e in events if e.get("cat") == "kernel"]
    functions = {"K1_fused_face_block": "face_block_kernel",
                 "K2_fused_cell_block": "cell_block_kernel",
                 "K3_edges_to_vertices": "edge_vertex_kernel",
                 "K4_gather_face_cells": "face_gather_kernel",
                 "K5_vertices_to_cells": "vertex_cell_kernel",
                 "K6_table_dual": "table_dual_kernel",
                 "K7_table_single": "table_single_kernel",
                 "K8_mlp_block": "k8::mlp_block_kernel"}
    named = {k: sum(1 for e in kernels_ if f"gfd::{fn}" in e.get("name", ""))
             for k, fn in functions.items()}
    device_us = sum(float(e.get("dur", 0.0)) for e in kernels_)
    return {"file": os.path.relpath(files[0], ROOT),
            "bytes": os.path.getsize(files[0]), "events": len(events),
            "kernels": len(kernels_), "named": named,
            "device_ms": device_us / 1e3,
            "device_share": device_us / 1e6 / wall_s}


def gen_training(dev, trajs, device_line: str) -> tuple:
    """Phase 12b: 10a's ``Trainer.run`` of the recipe on meshes 0-2 (mesh 3
    validating on the table route), its calls and validations timed as
    the recorder's spans, checkpointed;
    one more mini-epoch under ``profiling.trace``; the memory stats.
    Returns (the record, the validation's compute_window)."""
    cfg = gen_config()
    t = cfg.training
    r_stride, r_window = compute_window(cfg.model.timestep_stride, None,
                                        cfg.model.bundle_size, mode="rollout")
    valid_ds = MeshDataset(trajs[3:], stride=r_stride, data_window=r_window,
                           pad_multiple=t.pad_multiple, with_banded=True,
                           banded_dtype="bfloat16", device=dev)
    ckpt = Checkpointer(os.path.join(GEN_DIR, "ckpt"))
    with profiling.recording() as spans:
        record, trainer, state, ds = fused_training(
            MeshDataset(trajs[:3], device=dev), valid_ds, device_line,
            cfg=cfg, checkpointer=ckpt, timed=True, tag="12b FluxD-gen")
    if ckpt.resolve("latest") is None:
        fail("12b: Trainer.run wrote no checkpoint")
    steps = record["rollout_steps"]   # 10a's: forwards of the run
    train_steps = trainer.step_count

    # one mini-epoch under the trace: its pushforward steps through the
    # indexed feed, then its validation
    spme = max(t.mini_epoch_size // t.batch_size, 1)
    _, graph, dev_fields, ts = next(trainer._batches(
        ds, np.random.default_rng(cfg.settings.random_seed)))
    ts = ts[:spme]
    trace_dir = os.path.join(GEN_DIR, "trace")
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profiling.trace(trace_dir), profiling.recording() as traced_spans:
        with synced_span("traced_mini_epoch"):
            losses = trainer.train_step_indexed(
                state, graph, dev_fields, ts, [t.lr_min] * len(ts),
                ds.data_window)
            trainer.validate(state, valid_ds, CHECK_STEPS)
    traced_s = time.perf_counter() - t0
    traced = {k: v - before[k] for k, v in launch_counts().items()}
    pf = t.pushforward_factor
    want = {k: PATHS["FluxD"][1].get(k, 0) * pf * len(ts)
            + PATHS["FluxD-valid"][1].get(k, 0) * CHECK_STEPS for k in KERNELS}
    if traced != want:
        fail(f"12b: launches in the traced mini-epoch {traced}, expected "
             f"{want}")
    if not torch.isfinite(losses["total_log_loss"]).all():
        fail(f"12b: the traced mini-epoch's losses {losses}")
    tr = trace_kernels(trace_dir, traced_s)
    missing = [k for k in ("K1_fused_face_block", "K2_fused_cell_block",
                           "K3_edges_to_vertices", "K6_table_dual",
                           "K7_table_single", "K8_mlp_block")
               if not tr["named"][k]]
    if missing:
        fail(f"12b: the trace names no device function of {missing} "
             f"({tr['named']})")
    mem = profiling.device_memory_stats(dev)
    total_mb = torch.cuda.get_device_properties(dev).total_memory / 1024 ** 2
    if not (0 < mem["bytes_in_use_mb"] <= mem["peak_bytes_in_use_mb"]
            <= mem["bytes_limit_mb"] == total_mb):
        fail(f"12b: device_memory_stats {mem}, the card's memory {total_mb} MB")
    calls = spans.named("train_call")
    validations = spans.named("validate")
    if (len(validations) != 2 or len(calls) != len(record["calls"])
            or len(traced_spans.named("traced_mini_epoch")) != 1):
        fail(f"12b: the recorder holds {len(calls)} train_call spans for "
             f"{len(record['calls'])} calls, {len(validations)} validate "
             f"spans for 2 validations, "
             f"{len(traced_spans.named('traced_mini_epoch'))} traced "
             f"mini-epochs for 1")
    ms_per_step = 1e3 * sum(s.seconds for s in calls) / train_steps
    # each epoch takes the same steps (the sampler's 38 a mesh combination)
    by_epoch = {f"epoch {e}": 1e3 * sum(s.seconds for s in calls
                                        if s.attrs["epoch"] == e)
                / (train_steps // FUSED_EPOCHS)
                for e in sorted({s.attrs["epoch"] for s in calls})}
    report = {"validate": sum(s.seconds for s in validations) / 2,
              "traced_mini_epoch": traced_spans.seconds("traced_mini_epoch")}
    say(f"phase 12b FluxD-gen spans (card synchronized before each span "
        f"closes): {train_steps} train steps in "
        f"{len(calls)} calls, {ms_per_step:.3f} ms "
        f"per step over both epochs, by epoch (1 the warm-up, 2 with the "
        f"pushforward unroll) {json.dumps({e: round(v, 3) for e, v in by_epoch.items()})}, "
        f"{len(validations)} validations of {CHECK_STEPS} steps "
        f"{1e3 * report['validate']:.1f} ms each; the traced mini-epoch "
        f"({len(ts)} pushforward steps and a validation) {traced_s:.2f} s "
        f"under the trace, launches {json.dumps({k: v for k, v in traced.items() if v})}"
        f"; trace {tr['file']} ({tr['bytes']} bytes, {tr['events']} events, "
        f"{tr['kernels']} kernels; device functions by kernel "
        f"{json.dumps(tr['named'])}), device time {tr['device_ms']:.2f} ms, "
        f"device share {100 * tr['device_share']:.1f} % of the traced wall "
        f"time; device_memory_stats {json.dumps({k: round(v, 1) for k, v in mem.items()})}"
        f"; card {device_line}")
    record.update({"spans": report, "ms_per_step": ms_per_step,
                   "ms_per_step_by_epoch": by_epoch,
                   "train_steps": train_steps, "trace": tr,
                   "traced_s": traced_s, "memory": mem})
    record["launches"] = {k: v + traced[k]
                          for k, v in record["launches"].items()}
    record["rollout_steps"] = steps + pf * len(ts) + CHECK_STEPS
    return record, (r_stride, r_window)


def _route_checkpoint(aggregation: str) -> str:
    """A copy of 12b's checkpoint directory whose latest checkpoint's
    config takes ``aggregation``; returns its ``<dir>/latest``."""
    src = os.path.join(GEN_DIR, "ckpt")
    dst = os.path.join(GEN_DIR, f"ckpt-{aggregation}")
    shutil.copytree(src, dst)
    path = os.path.join(Checkpointer(dst).resolve("latest"), "meta.json")
    with open(path) as f:
        meta = json.load(f)
    meta["config"]["model"]["aggregation"] = aggregation
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    return os.path.join(dst, "latest")


def head_outputs(model, graph, feats) -> dict:
    """Every supervised head's raw output in both of diagnose's spaces
    (valid mode, normalized; rollout mode, physical) on live rows, f32,
    under the report's head names (the face velocity's two components
    apart)."""
    out = {}
    with torch.inference_mode():
        for space, mode in (("normalized", "valid"), ("physical", "rollout")):
            res = model.forward(graph, feats, mode=mode)
            for key in DIAG_HEADS:
                if key not in res:
                    continue
                live = (graph.cell_mask if key.startswith("cell")
                        else graph.face_mask) > 0
                v = res[key].float()[live]
                heads = ({"face_velocity_x": v[:, 0], "face_velocity_y":
                          v[:, 1]} if key == "face_velocity" else {key: v})
                for name, h in heads.items():
                    out[f"{name}/{space}"] = h
    return out


def head_gaps(got: dict, want: dict) -> dict:
    """Per head, the norm of the difference over the norm of ``want``'s
    deviation from its mean."""
    return {k: float((got[k] - want[k]).norm()
                     / (want[k] - want[k].mean()).norm()) for k in want}


def gen_diagnose(dev, trajs, window, device_line: str) -> dict:
    """Phase 12c: ``diagnose.main`` on 12b's checkpoint on the kernel
    route and on the plain route, mesh 3's first sample on the index route
    (the config's data module stood in for by that dataset: the card's
    machine has no h5py): the launches of each, the reports within
    DIAG_TOL, and the models diagnose restored held head by head within
    DIAG_OUT_TOL; the planted faults (K1's, K2's or K3's output zeroed)
    must break it for every head under one of them, and each must stand
    DIAG_FAULT_RATIO times above the route's largest gap."""
    ds = MeshDataset(trajs[3:], stride=window[0], data_window=window[1],
                     device=dev)
    reports, launches, secs, probed = {}, {}, {}, {}
    report_of = diagnose.head_report
    for route, agg in (("kernel", "pallas"), ("plain", "segment")):
        ckpt = _route_checkpoint(agg)

        def probe(model, graph, feats, route=route):
            probed[route] = (model, graph, feats)
            return report_of(model, graph, feats)

        zero_launches()
        t0 = time.perf_counter()
        with mock.patch.object(train_cli, "build_datasets",
                               lambda *a, **k: (None, ds)), \
                mock.patch.object(diagnose, "head_report", probe):
            report, out = _quiet(diagnose.main, [
                "--config", RECIPE_CONFIG, "--ckpt", ckpt, "--json",
                "--device", dev.type])
        secs[route] = time.perf_counter() - t0
        launches[route] = launch_counts()
        if json.loads(out) != json.loads(json.dumps(report)):
            fail(f"12c: diagnose's JSON is not its report ({route} route)")
        reports[route] = report
    want = {"kernel": {k: PATHS["FluxD"][1].get(k, 0) * 2 for k in KERNELS},
            "plain": {k: 0 for k in KERNELS}}
    if launches != want:
        fail(f"12c: launches by route {launches}, expected {want} (two "
             "forwards, valid and rollout mode)")
    k, p = reports["kernel"], reports["plain"]
    if k.keys() != p.keys() or k["_scalar_params"] != p["_scalar_params"]:
        fail(f"12c: the reports' heads or scalars differ: {sorted(k)} "
             f"{sorted(p)}")
    gaps = {}
    for head in k:
        if head == "_scalar_params":
            continue
        for space in ("normalized", "physical"):
            a, b = k[head][space], p[head][space]
            rel = (0.0 if a["rel"] is None and b["rel"] is None else
                   abs(a["rel"] - b["rel"]) / max(1.0, abs(b["rel"])))
            gaps[f"{head}/{space}"] = (abs(a["corr"] - b["corr"]), rel)
    worst = {n: g for n, g in gaps.items() if max(g) > DIAG_TOL}
    if worst:
        fail(f"12c: heads whose corr or rel differ beyond {DIAG_TOL} "
             f"between the routes: {worst}")
    # the heads themselves, on the models and sample diagnose probed
    plain_out = head_outputs(*probed["plain"])
    out_gaps = head_gaps(head_outputs(*probed["kernel"]), plain_out)
    if plain_out.keys() != {f"{h}/{s}" for h in k if h != "_scalar_params"
                            for s in ("normalized", "physical")}:
        fail(f"12c: head outputs {sorted(plain_out)}, report {sorted(k)}")
    planted = {}
    for name in DIAG_FAULTS:
        wrapper = getattr(kernels, name)

        def zeroed(*a, wrapper=wrapper, **kw):
            out = wrapper(*a, **kw)
            return (tuple(map(torch.zeros_like, out))
                    if isinstance(out, tuple) else torch.zeros_like(out))
        zeroed.launches = 0   # each wrapper counts on its module's name
        with mock.patch.object(kernels, name, zeroed):
            planted[name] = head_gaps(head_outputs(*probed["kernel"]),
                                      plain_out)
    say("phase 12c head outputs, |difference| over |the plain head's "
        "deviation from its mean|, kernel route: " + json.dumps(out_gaps)
        + "; the kernel route with one wrapper's output zeroed (planted "
        "faults): " + json.dumps(planted))
    worst = {n: g for n, g in out_gaps.items() if g > DIAG_OUT_TOL}
    if worst:
        fail(f"12c: head outputs that differ beyond {DIAG_OUT_TOL} between "
             f"the routes: {worst}")
    floor = DIAG_FAULT_RATIO * max(out_gaps.values())
    quiet = [f for f, g in planted.items() if max(g.values()) <= floor]
    blind = [n for n in out_gaps
             if max(g[n] for g in planted.values()) <= DIAG_OUT_TOL]
    if quiet or blind:
        fail(f"12c: the planted faults {quiet} move no head beyond "
             f"{DIAG_FAULT_RATIO} times the route's largest gap ({floor}), "
             f"or no planted fault moves the heads {blind} beyond "
             f"{DIAG_OUT_TOL}")
    say(f"phase 12c FluxD-gen diagnose.main --json on 12b's checkpoint, "
        f"mesh 3's first sample ({ds.get_item(0).num_cells} cells, index "
        f"route): the kernel route (aggregation pallas: launches "
        f"{json.dumps({n: v for n, v in launches['kernel'].items() if v})}, "
        f"{secs['kernel']:.2f} s) against the plain route (segment: none, "
        f"{secs['plain']:.2f} s), every head within {DIAG_TOL} (largest corr "
        f"gap {max(g[0] for g in gaps.values()):.2e}, rel gap "
        f"{max(g[1] for g in gaps.values()):.2e}); every head's output "
        f"within {DIAG_OUT_TOL} (largest {max(out_gaps.values()):.3e}), "
        f"every head beyond it under a planted fault, each fault's most "
        f"moved head {min(max(g.values()) for g in planted.values()):.3f} "
        f"or more; kernel route "
        + json.dumps({h: {s: {"corr": round(r["corr"], 4),
                              "rel": None if r["rel"] is None
                              else round(r["rel"], 4)}
                          for s, r in v.items()}
                      for h, v in k.items() if h != "_scalar_params"})
        + " scalars " + json.dumps({n: round(v, 6) for n, v in
                                    k["_scalar_params"].items()})
        + f"; card {device_line}")
    return {"launches": launches["kernel"], "rollout_steps": 2,
            "seconds": secs, "gaps": gaps, "output_gaps": out_gaps,
            "planted_gaps": planted}


def gen_sweep(dev, device_line: str) -> dict:
    """Phase 12d: ``sweep.main`` over SWEEP_LRS on a one-mini-epoch
    synthetic FluxD config (``config/train_synthetic.json`` with FluxD): a
    dry run, then shard 0 of 2, one job on the card in a subprocess."""
    work = os.path.join(GEN_DIR, "sweep")
    os.makedirs(work)
    with open(os.path.join(ROOT, "config", "train_synthetic.json")) as f:
        base = json.load(f)
    base["model"]["name"] = "FluxD"
    base["training"].update(epochs=1, mini_epoch_size=20 * 2)
    base["logging"].update(name="fluxd-sweep", valid_frequency=1,
                           save_frequency=1)
    base["dataset"]["stats_fpath"] = None
    with open(os.path.join(work, "base.json"), "w") as f:
        json.dump(base, f, indent=2)
    with open(os.path.join(work, "sweep.json"), "w") as f:
        json.dump({"base_config": "base.json", "mode": "grid",
                   "parameters": {"training.lr_max": list(SWEEP_LRS)}}, f)
    device = dev.type
    cwd = os.getcwd()
    os.chdir(work)
    try:
        _, dry = _quiet(sweep.main, ["--config", "sweep.json", "--dry-run",
                                     "--device", device])
        lines = dry.splitlines()
        if (lines[0] != "Sweep: 2 combinations, shard 0/1 runs 2"
                or [l.split("]")[0] for l in lines[1:]]
                != ["[sweep 0", "[sweep 1"]):
            fail(f"12d: the dry run printed {lines}")
        t0 = time.perf_counter()
        try:
            sweep.main(["--config", "sweep.json", "--shard-index", "0",
                        "--num-shards", "2", "--device", device])
        except SystemExit as exc:
            fail(f"12d: the sweep's job failed, exit code {exc.code}")
        job_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    runs = glob.glob(os.path.join(work, "runs", "synthetic", "default",
                                  "fluxd-sweep-0(*)", "metrics.jsonl"))
    other = glob.glob(os.path.join(work, "runs", "*", "*", "fluxd-sweep-1(*)"))
    if len(runs) != 1 or other:
        fail(f"12d: run directories {runs}, {other}")
    with open(runs[0]) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train/total_log_loss"] for r in rows
              if "train/total_log_loss" in r]
    if not losses or not np.isfinite(losses).all():
        fail(f"12d: the job logged the losses {losses}")
    say(f"phase 12d FluxD-gen sweep.main: dry run {lines}; shard 0 of 2 ran "
        f"training.lr_max {SWEEP_LRS[0]} as `training.train --device "
        f"{device}` in {job_s:.2f} s (process start included), exit code 0, "
        f"{os.path.relpath(runs[0], ROOT)} with {len(rows)} lines, train "
        f"losses {[round(v, 4) for v in losses]}; card {device_line}")
    return {"job_s": job_s, "losses": losses}


def gen_phase(dev, line: str) -> dict:
    """Phase 12: 12a-12d on the card ``dev``. Returns the path's record."""
    if not torch.cuda.is_available():
        fail("phase 12 runs on the card: no CUDA device")
    t12 = time.perf_counter()
    trajs, data = gen_data(line)
    t12b = time.perf_counter()
    record, window = gen_training(dev, trajs, line)
    t12c = time.perf_counter()
    diag = gen_diagnose(dev, trajs, window, line)
    t12d = time.perf_counter()
    record["sweep"] = gen_sweep(dev, line)
    record["launches"] = {k: v + diag["launches"][k]
                          for k, v in record["launches"].items()}
    record["rollout_steps"] += diag["rollout_steps"]
    record.update(data=data, diagnose=diag)
    end = time.perf_counter()
    say(f"phase 12 card {line}; FluxD-gen: 12a (host) {t12b - t12:.1f} s, 12b "
        f"{t12c - t12b:.1f} s ({record['ms_per_step']:.3f} ms per train step, "
        f"device share of the traced mini-epoch "
        f"{100 * record['trace']['device_share']:.1f} %), 12c "
        f"{t12d - t12c:.1f} s, 12d {end - t12d:.1f} s; phase 12 wall time "
        f"{end - t12:.1f} s")
    return record


# ---- phase 13: space sharding --------------------------------------------------

def spmd_group(dev, rank: int, world: int, workdir: str, name: str) -> None:
    """A gloo group of ``world`` ranks on CUDA tensors of the one card (NCCL
    refuses two ranks on one card), its rendezvous the file ``name`` in
    ``workdir``."""
    data_parallel.init_process_group(
        dev, init_method=f"file://{workdir}/{name}", backend="gloo",
        rank=rank, world_size=world)


def _child_device():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_kernels()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dev


def spmd_child(rank: int, workdir: str) -> int:
    """Phase 13's rank ``rank`` of SPMD_RANKS, run as ``python3
    chip_smoke.py --phase13 <rank> <workdir>``: 13a and 13b
    (``spmd_rollout_path``), then 13c's reference, the 2-rank DP step
    (``spmd_dp_reference``). Prints one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = _child_device()
    spmd_group(dev, rank, SPMD_RANKS, workdir, "store13")
    try:
        result = spmd_rollout_run(dev, rank, workdir)
    finally:
        torch.distributed.destroy_process_group()
    say("phase 13 result: " + json.dumps(result))
    return 0


def bench_table_graph(device):
    """The bench mesh's graph (``bench_mesh``'s first two states) padded to
    128 rows with int8 banded tables, on the table route (the trainer's
    validation graph)."""
    geom = bench_geometry()
    fields = channel_flow_trajectory(geom, num_timesteps=CHECK_STEPS + 2,
                                     dt=0.01)
    return from_geometry(geom, {k: v[:2] for k, v in fields.items()},
                         dt=0.01, pad_multiple=128, with_banded=True,
                         banded_dtype="int8", device=device)


def spmd_rollout_run(dev, rank: int, workdir: str) -> dict:
    """Phase 13's rank ``rank`` inside its group: the sharded rollout paths
    (13a, 13b, 13d, 13e, 13e'), 13g's single steps, then the references of
    13c and 13f."""
    mesh = spmd.make_mesh_spatial(SPMD_RANKS)
    graphs = {False: bench_mesh(dev)[0], True: bench_table_graph(dev)}
    result = {path: spmd_rollout_path(path, graphs[path.endswith("-valid")],
                                      mesh, rank)
              for path in SPMD_PATHS.values()}
    result["one_step"] = {name: spmd_one_step(name, graphs[False], mesh, rank)
                          for name in SPMD_ONE_STEP}
    result["dp_reference"] = {tag: spmd_dp_reference(dev, rank, workdir, tag,
                                                     path)
                              for tag, path in SPMD_RECIPES}
    return result


def spmd_rollout_path(path: str, graph, mesh, rank: int) -> dict:
    """13a/13b/13d/13e on each rank: ``path``'s model on the kernel route
    (h128, MP_NUM blocks, bf16, seeded weights, statistics from the whole
    mesh), CHECK_STEPS steps of ``make_spmd_rollout`` on this rank's part of
    ``graph`` (on the table route, with its own tables), gathered and held
    on rank 0 against the single process's kernel route on the whole graph
    (run there first): each field's largest gap, and whether it is bit for
    bit. Then the same steps on the same inputs
    (``spmd_steps_on_same_inputs``), which hold where the free-running
    fields are not bit for bit. Then STEPS timed steps with the launch
    counters and the halo's counters set to 0 just before and read just
    after (host clock, synchronized, both ranks at once on the card), and
    a profile of one step."""
    kern, _, feats = path_models(path, graph)
    cfg = RolloutConfig(num_steps=CHECK_STEPS, compute_error=False,
                        save_fields=True)
    want = (rollout_scan(kern, graph, feats, config=cfg)[1] if rank == 0
            else None)
    t0 = time.perf_counter()
    local = spmd.shard_graph_spatial(graph, mesh)
    part_s = time.perf_counter() - t0
    _, lfeats = kern.transform_rollout(local)
    _, got = spmd.make_spmd_rollout(kern, cfg)(local, lfeats)
    full = spmd.gather_fields(got, local, mesh)
    h = local.halo
    out = {"rank": rank, "owned_cells": int(local.cell_mask.sum()),
           "local_rows": [local.num_cells, local.num_faces,
                          local.num_vertices],
           "ghosts": {k: int(v.numel()) for k, v in h.recv_rows.items()},
           "partition_s": part_s, "table_route": local.table_route}
    if local.table_route:
        out["bands"] = spmd.band_widths(local)
        out["global_bands"] = spmd.band_widths(graph)
    if rank == 0:
        out["vs_single"] = {}
        for key, v in want.items():
            a = _live_rows(graph, key, full[key].to(v.device))
            b = _live_rows(graph, key, v)
            out["vs_single"][key] = {"max_abs": float((a - b).abs().max()),
                                     "bit_equal": bool(torch.equal(a, b))}
    out["same_inputs"] = spmd_steps_on_same_inputs(kern, graph, feats, local,
                                                   mesh, rank)
    timed = spmd.make_spmd_rollout(kern, RolloutConfig(
        num_steps=STEPS, compute_error=False))
    data_parallel.barrier()
    zero_launches()
    h.exchanges = h.bytes_sent = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, fields = timed(local, lfeats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out.update(launches=launch_counts(), exchanges=h.exchanges,
               bytes_sent=h.bytes_sent, ms_per_step=1e3 * wall / STEPS,
               finite=bool(torch.isfinite(fields["final_cell_state"]).all()))
    one = spmd.make_spmd_rollout(kern, RolloutConfig(num_steps=1,
                                                     compute_error=False))
    data_parallel.barrier()
    prof = profile_steps(lambda: one(local, lfeats), 1)
    out["profile"] = None if prof is None else {
        k: prof[k] for k in ("device_ms_per_step", "wall_ms_per_step",
                             "busy_share", "kernels_per_step",
                             "gfd_ms_per_step")}
    return out


def _live_rows(graph, key: str, v: torch.Tensor) -> torch.Tensor:
    """The live rows of a saved field (T, rows, ...) or of the final state
    (rows, ...): a gathered field holds zeros at the global graph's pad
    rows, which no rank owns."""
    mask = graph.face_mask if key.startswith("face") else graph.cell_mask
    return v[mask] if key == "final_cell_state" else v[:, mask]


def _first_cell_mlp(model):
    """The first block's cell MLP (an FVGN-style block's, or a Conservative
    block's), whose rows the sharded steps compute at the local row
    count."""
    module = model.module
    if hasattr(module, "epd"):
        return module.epd.blocks[0].cell_block.mlp
    return module.blocks[0].cell_mlp


def spmd_steps_on_same_inputs(kern, graph, feats, local, mesh,
                              rank: int) -> dict:
    """CHECK_STEPS steps of ``kern``, each from the single process's state
    on both sides (rank 0's, broadcast), as ``check_against_plain`` holds
    two routes (free-running, a random model amplifies any difference
    step over step): the single process's step on ``graph`` against one
    sharded step on ``local``, gathered. On rank 0, per field, the largest
    gap over the field's largest magnitude (gated by STEP_TOL), and whether
    every element lies within one bf16 step; and whether cuBLAS gives the
    first rows of the block's cell MLP alike at the global and the local
    row count (the unfused blocks' MLPs run there)."""
    one = spmd.make_spmd_rollout(kern, RolloutConfig(
        num_steps=1, compute_error=False, save_fields=True))
    worst = {}
    for _ in range(CHECK_STEPS):
        with torch.inference_mode():
            sol = derive_states(kern, kern.forward(graph, feats), feats,
                                graph)[-1]
        lfeats = {k: spmd.local_rows(v, local, "face" if k.startswith("face")
                                     else "cell") for k, v in feats.items()}
        full = spmd.gather_fields(one(local, lfeats)[1], local, mesh)
        if rank == 0:
            for key in SAVABLE_FIELDS:
                if key not in sol:
                    continue
                a = _live_rows(graph, key, full[key].to(sol[key].device))[0]
                b = _live_rows(graph, key, sol[key][None])[0]
                a, b = a.float(), b.float()
                rel = float((a - b).abs().max() / b.abs().max())
                w = worst.setdefault(key, {"rel": 0.0, "within_bf16_step": True})
                w["rel"] = max(w["rel"], rel)
                w["within_bf16_step"] &= bool(((a - b).abs()
                                               <= bf16_step(b)).all())
        with torch.inference_mode():
            feats = kern.update_features(sol, feats, graph)
            for v in feats.values():
                if v.is_floating_point():
                    torch.distributed.broadcast(v, 0)
    out = {"fields": worst}
    if rank == 0:
        mlp = _first_cell_mlp(kern)
        x = torch.randn((graph.num_cells, mlp.dense0.in_features),
                        generator=torch.Generator(device=graph.device)
                        .manual_seed(0), device=graph.device)
        n = local.num_cells
        with torch.inference_mode():
            out["mlp_rows_alike"] = bool(torch.equal(mlp(x)[:n], mlp(x[:n])))
    return out


def spmd_one_step(name: str, graph, mesh, rank: int) -> dict:
    """13g: one step of ``name`` on the kernel route (as
    ``spmd_rollout_path``'s model) through ``make_spmd_rollout`` on this
    rank's part of ``graph``, gathered and held on rank 0 against the
    single process's step from the same state: per field the largest gap
    over its largest magnitude, and whether it is bit for bit."""
    kern, _, feats = path_models(name, graph)
    cfg = RolloutConfig(num_steps=1, compute_error=False, save_fields=True)
    want = (rollout_scan(kern, graph, feats, config=cfg)[1] if rank == 0
            else None)
    local = spmd.shard_graph_spatial(graph, mesh)
    _, lfeats = kern.transform_rollout(local)
    _, got = spmd.make_spmd_rollout(kern, cfg)(local, lfeats)
    full = spmd.gather_fields(got, local, mesh)
    if rank != 0:
        return {"rank": rank}
    out = {}
    for key, v in want.items():
        a = _live_rows(graph, key, full[key].to(v.device)).float()
        b = _live_rows(graph, key, v).float()
        out[key] = {"rel": float((a - b).abs().max() / b.abs().max()),
                    "bit_equal": bool(torch.equal(a, b)),
                    "finite": bool(torch.isfinite(a).all())}
    return {"rank": rank, "fields": out}


def spmd_train_setup(dev, tag: str, path: str):
    """13c's (13f's) trainer: the recipe (``dp_config``) in f32 without
    noise or flip, in its warm-up epoch (no unroll, so no kernel), on
    phase 5's meshes cut to DP_STATES states, statistics from them."""
    cfg = dp_config(path, tag)
    cfg.model.compute_dtype = "float32"
    ds = fused_dataset(train_data(dev, steps=DP_STATES - 1), cfg)
    model = train_cli.build_model(cfg, dev)
    model.set_stats(train_cli.compute_stats(cfg, model, ds))
    tf = model.transform_features
    model.transform_features = (
        lambda g, generator=None, mode="rollout", noise_std=0.0: tf(
            g, None, mode, noise_std))
    trainer = Trainer(cfg, model)
    trainer.epoch_count = FUSED_WARMUP_EPOCHS
    return cfg, ds, trainer


def _halves(cfg, ds, n: int) -> list:
    """The first ``n`` samples of the recipe's first batch, one per data
    row: a row's single mesh is then cut across its space ranks (two whole
    meshes of a row would fall one to each space rank, with no halo)."""
    batch = next(iter(get_sampler(cfg.dataset.sampler)(
        ds, cfg.training.batch_size, np.random.default_rng(0))))
    return [[sample] for sample in batch[:n]]


def _step_record(state, losses) -> dict:
    return {"losses": {k: float(v) for k, v in losses.items()},
            "moments": [m.cpu() for m in _moments(state)],
            "params": [p.detach().cpu().clone() for grp in
                       state.optimizer.param_groups for p in grp["params"]]}


def spmd_dp_reference(dev, rank: int, workdir: str, tag: str,
                      path: str) -> dict:
    """13c's (13f's) reference on the SPMD_RANKS ranks: one
    ``dp_train_step`` of the recipe ``tag``, rank r on sample r of the
    first global batch (``_halves``: rank 0's draw, broadcast, and written
    to ``workdir`` for the 2 x 2 ranks); rank 0 writes the losses, moments
    and parameters after it."""
    cfg, ds, trainer = spmd_train_setup(dev, tag, path)
    state = trainer.init_state()
    data_parallel.replicate_(state.module)
    halves = data_parallel.broadcast_object(_halves(cfg, ds, SPMD_RANKS))
    losses = trainer.dp_train_step(state, ds.get_batch(halves[rank]),
                                   cfg.training.lr_max)
    if rank == 0:
        with open(os.path.join(workdir, f"halves-{tag}.json"), "w") as f:
            json.dump(halves, f)
        torch.save(_step_record(state, losses),
                   os.path.join(workdir, f"dp_reference-{tag}.pt"))
    return {"rank": rank, "graphs": len(halves[rank])}


def spmd_train_child(rank: int, workdir: str) -> int:
    """Phase 13c's (and 13f's) rank ``rank`` of a 2 x 2 layout, run as
    ``python3 chip_smoke.py --phase13c <rank> <workdir>`` after
    ``spmd_child``'s ranks: per recipe of SPMD_RECIPES
    (``spmd_train_run``). Prints one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = _child_device()
    spmd_group(dev, rank, SPMD_LAYOUT[0] * SPMD_LAYOUT[1], workdir,
               "store13c")
    try:
        result = {tag: spmd_train_run(dev, rank, workdir, tag, path)
                  for tag, path in SPMD_RECIPES}
    finally:
        torch.distributed.destroy_process_group()
    say("phase 13c result: " + json.dumps(result))
    return 0


def spmd_train_run(dev, rank: int, workdir: str, tag: str,
                   path: str) -> dict:
    """One ``make_spmd_train_step`` step of the recipe ``tag`` on this rank
    of a 2 x 2 layout, data row d on sample d of 13's global batch, held on
    rank 0 against the 2-rank DP step (the mean losses within
    DP_F32_LOSS_RTOL, AdamW's moments within DP_F32_MOMENT_RTOL of each
    tensor's largest magnitude; the parameters' gap is reported, not held:
    a first AdamW step moves each by about lr whatever the gradient), no
    kernel launched; then SPMD_TIMED_STEPS steps timed (host clock,
    synchronized)."""
    mesh = spmd.make_mesh_2d(*SPMD_LAYOUT)
    cfg, ds, trainer = spmd_train_setup(dev, tag, path)
    state = spmd.init_state(trainer, mesh)
    with open(os.path.join(workdir, f"halves-{tag}.json")) as f:
        halves = [[tuple(s) for s in h] for h in json.load(f)]
    local = spmd.shard_spatial_batch([ds.get_batch(h) for h in halves],
                                     mesh)
    step = spmd.make_spmd_train_step(trainer, mesh)
    lr = cfg.training.lr_max
    zero_launches()
    losses = step(state, local, lr)
    torch.cuda.synchronize()
    launches = launch_counts()
    result = {"rank": rank, "launches": launches,
              "owned_cells": int(local.cell_mask.sum()),
              "local_rows": [local.num_cells, local.num_faces,
                             local.num_vertices]}
    if rank == 0:
        want = torch.load(os.path.join(workdir, f"dp_reference-{tag}.pt"))
        got = _step_record(state, losses)
        loss_rel = max(abs(got["losses"][k] - v) / abs(v)
                       for k, v in want["losses"].items())
        moment_gap = _moment_gap(got["moments"], want["moments"])
        param_abs = max(float((a - b).abs().max())
                        for a, b in zip(got["params"], want["params"]))
        result.update(loss_max_rel=loss_rel, moment_gap=moment_gap,
                      param_max_abs=param_abs,
                      ok=(loss_rel <= DP_F32_LOSS_RTOL
                          and moment_gap <= DP_F32_MOMENT_RTOL
                          and not any(launches.values())))
    ms = []
    for _ in range(SPMD_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, local, lr)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    result.update(ms_per_step=ms, exchanges=local.halo.exchanges,
                  bytes_sent=local.halo.bytes_sent)
    return result


def _children(flag: str, n: int, workdir: str, tag: str) -> list:
    procs = [start_child(flag, str(r), workdir) for r in range(n)]
    try:
        return [child_result(p, tag) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _spmd_path_line(sub: str, path: str, per: list, line: str) -> str:
    gaps = per[0]["vs_single"]
    same = per[0]["same_inputs"]
    free_bits = all(g["bit_equal"] for g in gaps.values())
    kind = ("bit for bit" if free_bits else
            "not bit for bit free-running; on the same inputs each step "
            f"within {STEP_TOL} of each field's largest magnitude")
    route = ("the table route, each rank on its own int8 tables, band "
             "widths per rank " + json.dumps([r["bands"] for r in per])
             + " (the whole graph's " + json.dumps(per[0]["global_bands"])
             + ")" if per[0]["table_route"] else "the index route")
    return (f"phase 13{sub} {path} on {SPMD_RANKS} gloo ranks sharing the "
            f"card (1 x {SPMD_RANKS}; the exchange staged through the host: "
            f"not a multi-card figure), {route}: {CHECK_STEPS} steps against "
            f"the single process's kernel route: ok, {kind}; free-running "
            "largest gaps "
            + json.dumps({k: g["max_abs"] for k, g in gaps.items()})
            + "; on the same inputs (largest gap over the field's largest "
            "magnitude, and whether each element is within one bf16 step) "
            + json.dumps(same["fields"]) + "; cuBLAS gives the block's cell "
            "MLP's first rows alike at the local row count: "
            + str(same["mlp_rows_alike"])
            + "; per rank: owned cells "
            + json.dumps([r["owned_cells"] for r in per])
            + ", local cells/faces/vertices "
            + json.dumps([r["local_rows"] for r in per])
            + ", ghost cells/faces " + json.dumps([r["ghosts"] for r in per])
            + f"; {STEPS} steps: ms per step "
            + json.dumps([round(r["ms_per_step"], 3) for r in per])
            + ", halo exchanges per step "
            + json.dumps([r["exchanges"] / STEPS for r in per])
            + ", bytes sent per step "
            + json.dumps([r["bytes_sent"] / STEPS for r in per])
            + ", launches per step " + json.dumps(
                {k: v / STEPS for k, v in per[0]["launches"].items() if v})
            + " (others 0); one step profiled, rank 0: "
            + json.dumps(per[0]["profile"]) + f"; card {line}")


def spmd_phase(line: str) -> dict:
    """Phase 13: SPMD_RANKS rank processes (13a, 13b, 13d, 13e, 13e', 13g,
    the references of 13c and 13f), then a 2 x 2 layout's (13c, 13f);
    their checks. Returns the sharded paths' records (launches summed over
    the ranks, per rank and step)."""
    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        ranks = _children("--phase13", SPMD_RANKS, work, "phase 13")
        t_ab = time.perf_counter() - t13
        train = _children("--phase13c", SPMD_LAYOUT[0] * SPMD_LAYOUT[1],
                          work, "phase 13c")
    records = {}
    for sub, path in SPMD_PATHS.items():
        per = [r[path] for r in ranks]
        gaps = per[0]["vs_single"]
        same = per[0]["same_inputs"]
        free_bits = all(g["bit_equal"] for g in gaps.values())
        if not (free_bits or all(g["rel"] <= STEP_TOL
                                 for g in same["fields"].values())):
            fail(f"phase 13{sub} {path}: the sharded fields against the "
                 f"single process: free-running {gaps}; on the same inputs "
                 f"{same}")
        want = {k: PATHS[path][1].get(k, 0) * STEPS for k in KERNELS}
        for r in per:
            if r["launches"] != want or not r["finite"]:
                fail(f"phase 13{sub} {path} rank {r['rank']}: launches "
                     f"{r['launches']} over {STEPS} steps, expected {want}; "
                     f"finite {r['finite']}")
        say(_spmd_path_line(sub, path, per, line))
        records[f"{path}-spmd"] = {
            "launches": {k: sum(r["launches"][k] for r in per)
                         for k in KERNELS},
            "rollout_steps": STEPS * SPMD_RANKS, "ranks": per}
    for name in SPMD_ONE_STEP:
        got = ranks[0]["one_step"][name]["fields"]
        if not all(g["finite"] and (g["bit_equal"] or g["rel"] <= STEP_TOL)
                   for g in got.values()):
            fail(f"phase 13g {name}: one sharded step against the single "
                 f"process: {got}")
        say(f"phase 13g {name}: one step on 1 x {SPMD_RANKS} gloo ranks (the "
            "kernel route, the bench mesh), gathered, against the single "
            f"process's from the same state: ok (bit for bit, or within "
            f"{STEP_TOL} of each field's largest magnitude) "
            + json.dumps(got) + f"; card {line}")
    for sub, (tag, _) in zip("cf", SPMD_RECIPES):
        per = [r[tag] for r in train]
        r0 = per[0]
        if not r0["ok"] or any(any(r["launches"].values()) for r in per):
            fail(f"phase 13{sub} {tag}: the 2 x 2 step against the 2-rank "
                 f"DP step: {r0}; launches {[r['launches'] for r in per]}")
        say(f"phase 13{sub} {tag} f32 warm-up step on a {SPMD_LAYOUT[0]} x "
            f"{SPMD_LAYOUT[1]} layout (4 gloo ranks sharing the card) against "
            f"dp_train_step on {SPMD_RANKS} ranks, data row d on mesh d of one "
            "global batch: ok; losses within "
            f"{r0['loss_max_rel']:.3g} (<= {DP_F32_LOSS_RTOL}), AdamW's moments "
            f"{r0['moment_gap']:.3g} (<= {DP_F32_MOMENT_RTOL}), parameters "
            f"{r0['param_max_abs']:.3g}; no kernel launched; per rank owned "
            f"cells {[r['owned_cells'] for r in per]}; ms per step (rank 0, "
            f"{SPMD_TIMED_STEPS} steps after it) "
            + json.dumps([round(m, 3) for m in r0["ms_per_step"]])
            + f", halo exchanges {r0['exchanges'] / (SPMD_TIMED_STEPS + 1):g} "
            f"and bytes {r0['bytes_sent'] / (SPMD_TIMED_STEPS + 1):g} a step "
            f"(forward and backward); card {line}")
    say(f"phase 13 wall time {time.perf_counter() - t13:.1f} s (the 1 x "
        f"{SPMD_RANKS} processes {t_ab:.1f} s); card {line}")
    return records



# ---- phase 14: the size buckets and the bounded caches ---------------------------

def bucket_data() -> list:
    """Phase 14's trajectories, made in memory (the card's machine has no
    h5py): one RCM-ordered TRAIN_POINTS-point and one VALID_POINTS-point
    cylinder mesh per seed of BUCKET_SEEDS (``s<seed>``, ``v<seed>``), each
    with a channel flow of BUCKET_STATES states."""
    trajs = []
    for prefix, points in (("s", TRAIN_POINTS), ("v", VALID_POINTS)):
        for seed in BUCKET_SEEDS:
            geom = rcm_reorder_geometry(make_geometry(
                "cylinder", n_points=points, seed=seed))
            fields = channel_flow_trajectory(geom, num_timesteps=BUCKET_STATES,
                                             dt=0.01)
            trajs.append(Trajectory(mesh_id=f"{prefix}{seed}", geom=geom,
                                    fields=fields))
    return trajs


def bucket_members(ds) -> list:
    """Each bucket's meshes, in the dataset's order."""
    return [[m for m in ds.sim_ids() if ds.bucket_of[m] == b]
            for b in range(len(ds.bucket_pad))]


def bucket_training(trajs, valid_ds, device_line: str) -> tuple:
    """Phase 14a: phase 10a's ``Trainer.run`` of the fluxd-r5 recipe (with
    its checks: the calls, the counters, K1-K3 only in the pushforward
    unroll, 30 each a step, the store's bytes, finite losses, epoch 1's
    falling on its first bucket's meshes, the monitor) on the meshes in
    BUCKETS size buckets, validated
    on FluxD-valid's batch. Every sampler batch and every call lies in one
    bucket, and epoch 2 trains both. Returns (the record, the trainer, its
    state, the dataset, the config)."""
    cfg = recipe_config(tag="FluxD-buckets")
    holder = MeshDataset(trajs, device=valid_ds.device)
    record, trainer, state, ds = fused_training(
        holder, valid_ds, device_line, cfg=cfg, tag="14a FluxD-buckets",
        num_buckets=BUCKETS)
    members = bucket_members(ds)
    if members != [[t.mesh_id for t in trajs if t.mesh_id[0] == p]
                   for p in "sv"]:
        fail(f"14a: buckets {members}, expected the {TRAIN_POINTS}-point "
             f"meshes and the {VALID_POINTS}-point ones apart")
    t = cfg.training
    epoch = list(get_sampler(cfg.dataset.sampler)(
        ds, t.batch_size, np.random.default_rng(0)))
    spans = [b for b in epoch if len({ds.bucket_of[m] for m, _ in b}) > 1]
    calls = record["calls"]
    by_bucket = {}
    for c in calls:
        buckets = {ds.bucket_of[m] for m in c["combo"]}
        if len(buckets) > 1 or c["cells"] != len(c["combo"]) * ds._pad_for(
                c["combo"])["cell"]:
            fail(f"14a: a call on {c['combo']} of {c['cells']} cells spans "
                 f"buckets {buckets} or not its bucket's pad")
        if c["epoch"] > FUSED_WARMUP_EPOCHS:
            agg = by_bucket.setdefault(buckets.pop(), {"steps": 0,
                                                       "launches": {}})
            agg["steps"] += c["steps"]
            for k, v in c["launches"].items():
                agg["launches"][k] = agg["launches"].get(k, 0) + v
    if spans or sorted(by_bucket) != list(range(BUCKETS)):
        fail(f"14a: sampler batches across buckets {spans[:2]}; pushforward "
             f"calls by bucket {sorted(by_bucket)}")
    say(f"phase 14a FluxD-buckets {BUCKETS} size buckets: members "
        + json.dumps(members) + ", pads " + json.dumps(ds.bucket_pad)
        + f", pad_to {json.dumps(ds.pad_to)}; every batch of an epoch "
        f"({len(epoch)} of {t.batch_size}, {cfg.dataset.sampler}) and every "
        "call within one bucket, the calls' cells "
        + json.dumps(sorted({c["cells"] for c in calls}))
        + "; pushforward launches per step by bucket "
        + json.dumps({b: {k: v / a["steps"] for k, v in a["launches"].items()
                          if v} for b, a in sorted(by_bucket.items())})
        + " (K4-K7 none); trajectory store bytes at the bucket pads "
        f"{ds.estimate_device_field_bytes()}, at one pad "
        f"{fused_dataset(holder, cfg).estimate_device_field_bytes()}; card "
        f"{device_line}")
    return record, trainer, state, ds, cfg


def bucket_times(trainer, state, ds, cfg, device_line: str) -> dict:
    """Phase 14a's times: ms per pushforward train step (host clock ending
    in a synchronize) of indexed calls of BUCKET_TIMED_STEPS steps, in turns
    BUCKET_TIMED_ROUNDS times: bucket 0's batch at its pad, bucket 1's at
    its pad, and bucket 0's batch in a one-bucket dataset (padded to the
    largest mesh). Reported, not gated; the launches over them are
    checked (K1-K3 30 each a step)."""
    t = cfg.training
    k = BUCKET_TIMED_STEPS
    one = fused_dataset(ds, cfg, 1)
    combos = [tuple(sorted(m))[:t.batch_size] for m in bucket_members(ds)]
    runs = {"bucket 0": (ds, combos[0]), "bucket 1": (ds, combos[1]),
            "bucket 0, one bucket": (one, combos[0])}
    ts = np.repeat(np.arange(k, dtype=np.int32)[:, None], t.batch_size, 1)
    lr = t.lr_min

    def call(d, combo):
        trainer.train_step_indexed(state, d._batched_static(combo),
                                   d.device_fields(combo), ts, [lr] * k,
                                   d.data_window)

    for d, combo in runs.values():                     # builds, warm-up
        call(d, combo)
    times = {name: [] for name in runs}
    zero_launches()
    for _ in range(BUCKET_TIMED_ROUNDS):
        for name, (d, combo) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(d, combo)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0) / k)
    launches = launch_counts()
    steps = k * BUCKET_TIMED_ROUNDS * len(runs)
    want = {n: PATHS["FluxD"][1].get(n, 0) * t.pushforward_factor * steps
            for n in KERNELS}
    if launches != want:
        fail(f"14a timed calls: launches {launches}, expected {want}")
    cells = {name: d._batched_static(combo).num_cells
             for name, (d, combo) in runs.items()}
    med = {n: float(np.median(v)) for n, v in times.items()}
    profiles = {name: profile_steps(functools.partial(call, d, combo), k)
                for name, (d, combo) in runs.items()}
    say(f"phase 14a FluxD-buckets ms per pushforward train step ({k} steps "
        f"a call, {BUCKET_TIMED_ROUNDS} calls of each in turns, host clock "
        "ending in a synchronize): " + json.dumps(
            {n: [round(v, 3) for v in ts_] for n, ts_ in times.items()})
        + ", median " + json.dumps({n: round(v, 3) for n, v in med.items()})
        + "; batch cells " + json.dumps(cells) + f"; bucket 0's batch at its "
        "pad takes " + f"{med['bucket 0'] / med['bucket 0, one bucket']:.3f}"
        + " of its time padded to the largest mesh; launches over them "
        + json.dumps({n: v for n, v in launches.items() if v})
        + "; device profile of one call of each (per step): " + json.dumps(
            {n: ("not measured" if p is None else
                 {k_: p[k_] for k_ in ("device_ms_per_step", "busy_share",
                                       "kernels_per_step",
                                       "top_ms_per_step")})
             for n, p in profiles.items()})
        + f"; card {device_line}")
    return {"ms_per_step": times, "cells": cells, "launches": launches,
            "rollout_steps": t.pushforward_factor * steps,
            "profiles": profiles}


def counted_rollout(kern, graph, feats) -> tuple:
    """(fields of a CHECK_STEPS-step rollout of ``kern``, its launches, read
    around it)."""
    zero_launches()
    _, fields = rollout_scan(kern, graph, feats, config=RolloutConfig(
        num_steps=CHECK_STEPS, compute_error=False, save_fields=True))
    torch.cuda.synchronize()
    return fields, launch_counts()


def table_bytes(graph) -> int:
    """Bytes of a graph's banded tables (es/er, vc, cf)."""
    return sum(getattr(graph, k).numel() * getattr(graph, k).element_size()
               for k in ("es_onehot", "er_onehot", "vc_onehot",
                         "cf_row_onehot", "cf_col_onehot"))


def bucket_validation(trajs, device, device_line: str) -> tuple:
    """Phase 14b: the validation batch of each bucket (its meshes at t0, at
    its pad, int8 tables, the table route) held against the plain route
    for CHECK_STEPS steps on the same inputs (and against the index route
    of the same batch), within STEP_TOL as phase 3 holds FluxD-valid; a
    CHECK_STEPS-step rollout with the counters read around it: K6 30 and
    K7 15 a step, no other kernel; each batch's and each mesh's band
    widths. Then every mesh at ``pad_to`` in one batch, the trainer's
    validation batch of a one-bucket dataset, the same way: a small
    mesh's tables at that pad have bands past WHOLE_BAND_ROWS, which K6
    and K7 stream; its tables' bytes, the card's peak memory over it, a
    device profile of ALL_MESH_PROFILE_STEPS steps and the host's peak
    memory (ru_maxrss) are reported. Returns (the records, {bucket: (model, fields)})."""
    ds = MeshDataset(trajs, with_banded=True, banded_dtype="int8",
                     num_buckets=BUCKETS, device=device)
    out, refs, lines = {}, {}, []
    batches = [(b, ids, ds.bucket_pad[b])
               for b, ids in enumerate(bucket_members(ds))]
    batches.append(("all", ds.sim_ids(), ds.pad_to))
    valid_launches = dict.fromkeys(KERNELS, 0)
    all_mesh = {}
    for b, ids, pad in batches:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        graph = to_static_bands(ds.get_batch([(m, 0) for m in ids]),
                                derive_idx=False)
        built_s = time.perf_counter() - t0
        if not graph.table_route or graph.num_cells != len(ids) * pad["cell"]:
            fail(f"14b {b}: the batch of {ids} has {graph.num_cells} cells, "
                 f"not {len(ids)} x {pad['cell']}, or is off the table route")
        kern, plain, feats = path_models("FluxD-valid", graph)
        worst = check_against_plain(kern, plain, graph, feats,
                                    to_static_bands(graph, derive_idx=True))
        fields, launches = counted_rollout(kern, graph, feats)
        want = {n: PATHS["FluxD-valid"][1].get(n, 0) * CHECK_STEPS
                for n in KERNELS}
        if launches != want:
            fail(f"14b {b}: launches {launches}, expected {want}")
        bands = spmd.band_widths(graph)
        own = {m: spmd.band_widths(ds._static_graph(m, pad)) for m in ids}
        gaps = json.dumps({n: {k: round(v, 6) for k, v in f.items()}
                           for n, f in worst.items()})
        if b != "all":
            for n in KERNELS:
                valid_launches[n] += launches[n]
            refs[b] = (kern, fields)
            lines.append(f"bucket {b} {ids} at its pad {json.dumps(pad)}: "
                         f"{graph.num_cells} cells, band widths "
                         f"{json.dumps(bands)} (each mesh's own "
                         f"{json.dumps(own)}), largest gaps {gaps}")
            continue
        if max(bands.values()) <= WHOLE_BAND_ROWS:
            fail(f"14b: the all-mesh batch's bands {bands} do not pass "
                 f"{WHOLE_BAND_ROWS} rows: no band is streamed")
        profile = device_profile(kern, graph, feats, ALL_MESH_PROFILE_STEPS)
        all_mesh = {"launches": launches, "rollout_steps": CHECK_STEPS,
                    "bands": bands, "own_bands": own,
                    "table_bytes": table_bytes(graph), "built_s": built_s,
                    "cells": graph.num_cells, "faces": graph.num_faces,
                    "vertices": graph.num_vertices, "gaps": gaps,
                    "profile": profile,
                    "peak_bytes": torch.cuda.max_memory_allocated()}
        del graph, kern, plain, feats, fields
    out["FluxD-buckets-valid"] = {"launches": valid_launches,
                                  "rollout_steps": BUCKETS * CHECK_STEPS}
    out["FluxD-buckets-all"] = {k: all_mesh[k]
                                for k in ("launches", "rollout_steps")}
    prof = all_mesh["profile"]
    say(f"phase 14b FluxD-buckets validation per bucket on the table route "
        f"(int8 tables), {CHECK_STEPS} steps against the plain route on the "
        f"same inputs within {STEP_TOL}: ok; " + "; ".join(lines)
        + "; launches per step " + json.dumps(
            {n: v / (BUCKETS * CHECK_STEPS)
             for n, v in valid_launches.items() if v})
        + f". All {len(ds.sim_ids())} meshes at pad_to {json.dumps(ds.pad_to)}"
        f" in one batch on the table route ({all_mesh['cells']} cells, "
        f"{all_mesh['faces']} faces, {all_mesh['vertices']} vertices; built "
        f"in {all_mesh['built_s']:.2f} s), band widths "
        f"{json.dumps(all_mesh['bands'])} (each mesh's own "
        f"{json.dumps(all_mesh['own_bands'])}), tables "
        f"{all_mesh['table_bytes']} bytes (the card's peak memory over the "
        f"batch's build, checks and profile {all_mesh['peak_bytes']} bytes)"
        ", against the plain route and its "
        f"index route: ok, largest gaps {all_mesh['gaps']}, launches per step "
        + json.dumps({n: v / CHECK_STEPS
                      for n, v in all_mesh["launches"].items() if v})
        + f"; device profile of {ALL_MESH_PROFILE_STEPS} steps: "
        + ("not measured" if prof is None else json.dumps(
            {k: prof[k] for k in ("device_ms_per_step", "busy_share",
                                  "wall_ms_per_step", "gfd_ms_per_step")}))
        + "; host peak memory (ru_maxrss) "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} bytes"
        f"; card {device_line}")
    return out, refs


def graph_bytes(graphs) -> int:
    """Bytes of the tensors the graphs hold, each tensor once."""
    seen = {}
    for g in graphs:
        for v in vars(g).values():
            if isinstance(v, torch.Tensor):
                seen[v.data_ptr()] = v.numel() * v.element_size()
    return sum(seen.values())


def bucket_caches(trajs, refs, device, device_line: str) -> dict:
    """Phase 14c: 14b's dataset built twice, unbounded and with
    ``max_cached_graphs`` BUCKET_CACHE: every mesh's static graph visited
    at its bucket's pad (the caches bounded at BUCKET_CACHE entries in the
    second), the peak memory of the visits and the bytes the static-graph
    cache holds after them; then each bucket's validation batch rebuilt
    after the evictions and rolled out by 14b's model: its fields equal
    14b's kernel-route fields bit for bit. The HDF5 store's reads are not
    exercised here: the card's machine has no h5py, and
    ``tests/test_torch_lazy_store.py`` covers them on the CPU."""
    mem, ds = {}, None
    for bound in (None, BUCKET_CACHE):
        del ds                                  # the other dataset's graphs
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ds = MeshDataset(trajs, with_banded=True, banded_dtype="int8",
                         num_buckets=BUCKETS, max_cached_graphs=bound,
                         device=device)
        most = 0
        for m in ds.sim_ids():
            ds._static_graph(m, ds.bucket_pad[ds.bucket_of[m]])
            most = max(most, len(ds._static_graphs), len(ds._tables_cache))
        mem[str(bound)] = {
            "peak_bytes": torch.cuda.max_memory_allocated() - base,
            "held_bytes": graph_bytes(ds._static_graphs.values()),
            "static_graphs": len(ds._static_graphs),
            "tables": len(ds._tables_cache), "most_entries": most}
        if bound is not None and most > bound:
            fail(f"14c: the caches held {most} entries, bound {bound}")
    gaps = {}
    for b, ids in enumerate(bucket_members(ds)):
        kern, want = refs[b]
        graph = to_static_bands(ds.get_batch([(m, 0) for m in ids]),
                                derive_idx=False)
        _, feats = kern.transform_rollout(graph)
        got, _ = counted_rollout(kern, graph, feats)
        same = {k: bool(torch.equal(got[k], want[k])) for k in want}
        gaps[b] = same
        if not all(same.values()):
            fail(f"14c bucket {b}: the fields after eviction differ from "
                 f"14b's: {same}")
    say(f"phase 14c FluxD-buckets bounded caches (max_cached_graphs "
        f"{BUCKET_CACHE}): every mesh visited, at most "
        f"{mem[str(BUCKET_CACHE)]['most_entries']} static graphs and tables "
        "held; each bucket's validation batch rebuilt after the evictions "
        f"gives 14b's kernel-route fields bit for bit {json.dumps(gaps)}; "
        "torch.cuda.max_memory_allocated over the visits, and the bytes the "
        "static-graph cache holds after them, unbounded and bounded: "
        + json.dumps(mem) + f"; card {device_line}")
    return mem


def bucket_phase(device, valid_ds, trajs, line: str) -> dict:
    """Phase 14: 14a, its times, 14b and 14c on ``bucket_data()``'s
    trajectories. Returns the paths' records (launches, rollout steps)."""
    t14 = time.perf_counter()
    record, trainer, state, ds, cfg = bucket_training(trajs, valid_ds, line)
    times = bucket_times(trainer, state, ds, cfg, line)
    del trainer, state, ds
    records = {"FluxD-buckets-train": {
        "launches": {k: record["launches"][k] + times["launches"][k]
                     for k in KERNELS},
        "rollout_steps": record["rollout_steps"] + times["rollout_steps"]}}
    valid, refs = bucket_validation(trajs, device, line)
    records.update(valid)
    bucket_caches(trajs, refs, device, line)
    say(f"phase 14 card {line}; FluxD-buckets wall time "
        f"{time.perf_counter() - t14:.1f} s")
    return records


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
    t0 = time.perf_counter()
    trajs = bucket_data()
    say(f"phase 1 FluxD-buckets data: {len(trajs)} meshes of "
        f"{TRAIN_POINTS} and {VALID_POINTS} points, {BUCKET_STATES} states "
        f"each, made in {time.perf_counter() - t0:.2f} s")
    vindex = to_static_bands(vgraph, derive_idx=True)
    per_kernel = kernel_phase(graph, vindex)
    per_kernel.update(table_phase(vgraph))
    wide = wide_band_phase(trajs, vgraph)
    for (name, label), r in wide["forms"].items():
        k = per_kernel[name]
        k["forms"][label] = r
        k["max_abs_err"] = max(k["max_abs_err"], r["max_abs_err"])
    for (name, label), r in wide["nan"].items():
        per_kernel[name]["nan_through_zero_weight"][label] = r
    say("phase 2 K8's SiLU against PyTorch's on every bf16 value, bit for "
        "bit: ok " + json.dumps(per_kernel["K8_mlp_block"]["silu"]))
    say("phase 2 kernel vs plain: ok " + json.dumps(
        {k: round(v["max_abs_err"], 6) for k, v in per_kernel.items()}))
    for name in ("K1_fused_face_block", "K2_fused_cell_block",
                 "K3_edges_to_vertices", "K4_gather_face_cells",
                 "K5_vertices_to_cells", "K6_table_dual", "K7_table_single",
                 "K8_mlp_block"):
        say(f"phase 2 {name} by form: " + json.dumps(per_kernel[name]["forms"]))
    k4 = per_kernel["K4_gather_face_cells"]
    say("phase 2 K4 on the rounding cases, bit for bit (NaN by place): ok "
        + json.dumps(k4["rounding_cases"]) + "; launch floor at K4's grid, "
        "ms per empty launch back to back, by faces: "
        + json.dumps(k4["launch_floor_ms"]))
    say("phase 2 K3 -> K5 pair by cells (the wide forms with _wide): "
        + json.dumps(per_kernel["K3_edges_to_vertices"]["pair"])
        + "; launch floor, ms per empty launch back to back: "
        + json.dumps(per_kernel["K3_edges_to_vertices"]["launch_floor_ms"]))
    hazard = pdl_hazard_check(graph)
    say("phase 2 PDL hazard check, K3 -> K5 right behind a slow writer of "
        "their input: ok " + json.dumps(hazard))
    say("phase 2 PDL hazard check at the wide forms' width, K3 -> K5 on "
        f"{2 * H}-wide edge latents: ok " + json.dumps(pdl_hazard_check(
            graph, 2 * H, WIDE_HAZARD_ROUNDS)))
    say("phase 2 PDL hazard check, K3 on K1's raw output right behind K1 "
        "with both outputs (MgnA's face-first block): ok "
        + json.dumps(k1_k3_hazard_check(graph)))
    say(f"phase 2 K6/K7 past {WHOLE_BAND_ROWS} rows (896 for K7's 128-lane "
        f"form), streamed: {wide['mesh']}'s own int8 tables at the all-mesh "
        f"pad_to {json.dumps(wide['pad_to'])}, bands "
        f"{json.dumps(wide['bands'])} ({wide['table_bytes']} bytes, built in "
        f"{wide['tables_built_s']:.2f} s), and FluxD-valid's vc widened to "
        f"{WIDE_VC_BAND}; each against its plain version: ok; per launch, "
        "ms beside its bound (max(bytes / 3.35 TB/s, operations / 67 "
        "TFLOP/s)): " + json.dumps({f"{n[:2]} {lb}": r
                                    for (n, lb), r in wide["forms"].items()})
        + f"; card {line}")
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
    paths.update(families_phase(dev, ds, train_ds, line))
    paths.update(flux_vertpot_phase(dev, ds, train_ds, line))
    paths.update(conservative_phase(dev, ds, train_ds, line))
    paths["FluxD-r5-train"] = fused_phase(train_ds, ds, line)
    paths["FluxD-r5-dp"] = dp_phase(line)
    paths["FluxD-gen"] = gen_phase(dev, line)
    paths.update(spmd_phase(line))
    paths.update(bucket_phase(dev, ds, trajs, line))

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
    if sys.argv[1:] == ["--phase10b"]:
        sys.exit(three_ways_child())
    if sys.argv[1:] == ["--phase11a"]:
        sys.exit(dp_nccl_child())
    if sys.argv[1:2] == ["--phase11b"]:
        sys.exit(dp_gloo_child(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--phase13"]:
        sys.exit(spmd_child(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--phase13c"]:
        sys.exit(spmd_train_child(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
