"""Host-side data pipeline: trajectory store, sample map, padded batching.

Counterpart of ``gnn_fluid_dynamics_tpu/data/pipeline.py``: each trajectory
is held in host memory (numpy, time-major), or streamed from its HDF5 file
(:func:`~gnn_fluid_dynamics_tpu_torch.data.hdf5.load_dataset_lazy`); the
meshes are grouped by cell count into ``num_buckets`` size buckets, each
padded to its largest mesh, and a batch within one bucket is padded to the
bucket's shape, one that spans buckets to the largest mesh of all
(``pad_to``). The static batched geometry graph is built once per mesh
combination and each batch swaps only its time-window fields in. With
``with_banded`` each mesh carries its own banded tables at its pad, and
:func:`~gnn_fluid_dynamics_tpu_torch.graph.batch_graphs` brings a batch's
tables to one band width. ``max_cached_graphs`` bounds the per-(mesh, pad)
caches of static graphs and tables, for the streamed mode's bounded memory.

Training reads it through the samplers of
:mod:`gnn_fluid_dynamics_tpu_torch.data.samplers` and one of three feeds,
as the JAX package's trainer does: :func:`prefetch` (one batch a step,
assembled and copied to the device by a worker thread),
:func:`prefetch_grouped` (``k`` batches of one mesh combination stacked,
:meth:`MeshDataset.get_batch_stack`) and :func:`prefetch_indexed` (the
combination's whole trajectories held on the device once,
:meth:`MeshDataset.device_fields`, and ``(k, B)`` start indices a call).
Unlike the JAX package's workers, whose exception ends the epoch early
without a word, a worker's exception is raised in the consuming thread.

Left out: the JAX package's canonical band offsets per pad
(``_ensure_canon``, ``_canon_tables``), which give every mesh of a pad the
same per-tile offsets so that its compiled programs see few shapes. The
port's kernels read each tile's offset from the graph, and a canonical band
can be wider than every mesh's own (ROADMAP §1, "Left out on purpose").
Also left out: the incidence tables of the ``"gather"`` backend (the port's
graphs always carry their index vectors).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gnn_fluid_dynamics_tpu_torch import resolve_device
from gnn_fluid_dynamics_tpu_torch.graph import (FIELD_KEYS, MeshGraph,
                                                banded_tables_for,
                                                batch_graphs, from_geometry)
from gnn_fluid_dynamics_tpu_torch.ops.mls import compute_mls_weights
from gnn_fluid_dynamics_tpu_torch.training import profiling


@dataclasses.dataclass
class Trajectory:
    """One mesh + its time series (time-major numpy arrays)."""
    mesh_id: str
    geom: Dict[str, np.ndarray]
    fields: Dict[str, np.ndarray]          # key -> (T, N, D)
    dt: float = 0.01
    reynolds: float = 0.0
    # MLS weights: {cell,face}_grad_weights (N, K, 2), _grad_neighbours (N, K)
    grad_weights: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)

    @property
    def num_timesteps(self) -> int:
        return self.fields["cell_velocity"].shape[0]


def compute_window(timestep_stride: Optional[int],
                   pushforward_factor: Optional[int],
                   bundle_size: Optional[int],
                   mode: str = "train") -> Tuple[int, int]:
    """(stride, data_window) per the reference's precedence
    (``DataSet.py:71-89``)."""
    if timestep_stride:
        stride, window = timestep_stride, timestep_stride + 1
    else:
        stride, window = 1, 2
    if pushforward_factor:
        stride, window = 1, pushforward_factor + 2
    if bundle_size:
        window = bundle_size + 1
        if mode == "rollout":
            stride = bundle_size
    return stride, window


class MeshDataset:
    """A dataset over a set of trajectories, in memory or streamed, padded
    by size bucket. Graphs are built on ``device`` (the card unless
    ``device="cpu"``).

    ``num_buckets`` (at most the number of meshes) groups the meshes by cell
    count: a stable sort, cut into that many near-equal runs, each padded to
    its largest mesh (``bucket_pad``, ``bucket_of``); ``pad_to`` is the pad
    of all the meshes. ``max_cached_graphs``, where given, bounds the
    per-(mesh, pad) caches of static graphs and banded tables as LRUs: pair
    it with :func:`~gnn_fluid_dynamics_tpu_torch.data.hdf5.load_dataset_lazy`
    so that a large dataset runs in bounded memory (reference
    DataSet.py:127-172)."""

    def __init__(self, trajectories: Sequence[Trajectory],
                 stride: int = 1, data_window: int = 2,
                 timestep_range: Optional[Tuple[int, int]] = None,
                 pad_multiple: int = 128,
                 with_banded: bool = False,
                 banded_dtype="float32",
                 num_buckets: int = 1,
                 max_cached_graphs: Optional[int] = None,
                 device="cuda"):
        if not trajectories:
            raise ValueError("a dataset needs at least one trajectory")
        if max_cached_graphs is not None and max_cached_graphs < 1:
            raise ValueError(f"max_cached_graphs {max_cached_graphs}: the "
                             "caches need room for one graph")
        self.device = resolve_device(device)
        self.max_cached_graphs = max_cached_graphs
        self.trajectories = list(trajectories)
        self.by_id = {t.mesh_id: t for t in self.trajectories}
        self.stride = stride
        self.data_window = data_window
        if with_banded and pad_multiple % 128:
            pad_multiple = 128
        self.pad_multiple = pad_multiple
        self.with_banded = with_banded
        self.banded_dtype = banded_dtype

        def rup(n):
            m = max(pad_multiple, 1)
            return ((n + m - 1) // m) * m

        def pad_of(members):
            return {key: rup(max(t.geom[f"{key}_pos"].shape[0]
                                 for t in members))
                    for key in ("cell", "face", "vertex")}

        # size buckets: meshes grouped by cell count, each bucket padded to
        # its largest mesh (the JAX package's assignment, ties included)
        num_buckets = min(num_buckets, len(self.trajectories))
        sizes = np.array([t.geom["cell_pos"].shape[0]
                          for t in self.trajectories])
        order = np.argsort(sizes, kind="stable")
        self.bucket_of: Dict[str, int] = {}
        self.bucket_pad: List[Dict[str, int]] = []
        for b, idxs in enumerate(np.array_split(order, max(num_buckets, 1))):
            members = [self.trajectories[i] for i in idxs]
            self.bucket_pad.append(pad_of(members))
            for t in members:
                self.bucket_of[t.mesh_id] = b
        # the pad of a batch that spans buckets (the rollout's all-mesh one)
        self.pad_to = pad_of(self.trajectories)

        num_ts = min(t.num_timesteps for t in self.trajectories)
        if timestep_range:
            start, end = timestep_range[:2]
            if num_ts < end - 2 + data_window:
                raise ValueError(f"timestep_range {timestep_range} needs "
                                 f"{end - 2 + data_window} steps, the "
                                 f"trajectories have {num_ts}")
        else:
            start, end = 0, num_ts - data_window + 1
        # (mesh, ts) sample map, timestep-major like the reference
        # (DataSet.py:123-125)
        self.sample_map: List[Tuple[str, int]] = [
            (t.mesh_id, ts)
            for ts in range(start, end, stride)
            for t in self.trajectories
        ]
        self.timestep_range = (start, end)

        # keyed (mesh_id,) + _pad_key(pad); LRUs bounded by max_cached_graphs
        self._static_graphs: "OrderedDict[Tuple, MeshGraph]" = OrderedDict()
        self._tables_cache: "OrderedDict[Tuple, object]" = OrderedDict()
        # by mesh combination, whose pad _pad_for fixes
        self._batched_cache: Dict[Tuple[str, ...], MeshGraph] = {}
        self._batched_cache_size = 8
        # the indexed train path's trajectory stores, by mesh combination
        self._device_fields_cache: "OrderedDict[Tuple[str, ...], Dict]" = (
            OrderedDict())
        self._device_fields_cache_size = 16

    def __len__(self):
        return len(self.sample_map)

    def sim_ids(self) -> List[str]:
        return [t.mesh_id for t in self.trajectories]

    # ---- static geometry ---------------------------------------------------
    @staticmethod
    def _pad_key(pad: Dict[str, int]) -> Tuple[int, int, int]:
        return (pad["cell"], pad["face"], pad["vertex"])

    def _pad_for(self, mesh_ids) -> Dict[str, int]:
        """The pad of a batch of ``mesh_ids``: their bucket's, or ``pad_to``
        for a batch that spans buckets."""
        buckets = {self.bucket_of[m] for m in mesh_ids}
        if len(buckets) == 1:
            return self.bucket_pad[buckets.pop()]
        return self.pad_to

    def _lru_put(self, cache: OrderedDict, key, value):
        cache[key] = value
        cache.move_to_end(key)
        if self.max_cached_graphs is not None:
            while len(cache) > self.max_cached_graphs:
                cache.popitem(last=False)
        return value

    def _build_tables(self, mesh_id: str, pad: Dict[str, int]):
        with profiling.span("setup.tables"):
            return banded_tables_for(self.by_id[mesh_id].geom, pad)

    def _tables_put(self, key, value):
        return self._lru_put(self._tables_cache, key, value)

    def _tables_for(self, mesh_id: str, pad: Dict[str, int]):
        """The mesh's own banded tables at ``pad`` (not rebased onto
        offsets shared with other meshes: see the module's docstring)."""
        key = (mesh_id,) + self._pad_key(pad)
        if key in self._tables_cache:
            self._tables_cache.move_to_end(key)
            return self._tables_cache[key]
        profiling.count("dataset.table_builds")
        return self._tables_put(key, self._build_tables(mesh_id, pad))

    def _static_graph(self, mesh_id: str, pad: Dict[str, int]) -> MeshGraph:
        key = (mesh_id,) + self._pad_key(pad)
        if key in self._static_graphs:
            self._static_graphs.move_to_end(key)
            return self._static_graphs[key]
        t = self.by_id[mesh_id]
        return self._lru_put(self._static_graphs, key, from_geometry(
            t.geom, fields=t.grad_weights, dt=t.dt * self.stride,
            reynolds=t.reynolds, pad_to=pad, with_banded=self.with_banded,
            banded_dtype=self.banded_dtype,
            banded_tables=(self._tables_for(mesh_id, pad)
                           if self.with_banded else None),
            device=self.device))

    def _batched_static(self, mesh_ids: Tuple[str, ...]) -> MeshGraph:
        if mesh_ids not in self._batched_cache:
            pad = self._pad_for(mesh_ids)
            while len(self._batched_cache) >= self._batched_cache_size:
                self._batched_cache.pop(next(iter(self._batched_cache)))
            self._batched_cache[mesh_ids] = batch_graphs(
                [self._static_graph(m, pad) for m in mesh_ids])
        return self._batched_cache[mesh_ids]

    # ---- field windows -----------------------------------------------------
    def _window(self, mesh_id: str, ts: int,
                pad: Dict[str, int]) -> Dict[str, np.ndarray]:
        t = self.by_id[mesh_id]
        out = {}
        for key in FIELD_KEYS:
            if key not in t.fields:
                continue
            arr = t.fields[key][ts:ts + self.data_window]       # (W, N, D)
            npad = pad["cell" if key.startswith("cell") else "face"]
            x = np.transpose(arr, (1, 0, 2))                    # (N, W, D)
            if x.shape[0] < npad:
                x = np.pad(x, ((0, npad - x.shape[0]), (0, 0), (0, 0)))
            out[key] = x
        return out

    def get_batch(self, samples: Sequence[Tuple[str, int]]) -> MeshGraph:
        """One batched MeshGraph for [(mesh_id, ts), ...], at the batch's
        pad (:meth:`_pad_for`); the span ``setup.batch``."""
        with profiling.span("setup.batch"):
            mesh_ids = tuple(m for m, _ in samples)
            g = self._batched_static(mesh_ids)
            pad = self._pad_for(mesh_ids)
            winds = [self._window(m, ts, pad) for m, ts in samples]
            updates = {}
            for key in FIELD_KEYS:
                if key in winds[0]:
                    arr = np.concatenate([w[key] for w in winds], axis=0)
                    updates[key] = self._to_device(arr)
            return dataclasses.replace(g, **updates)

    def get_item(self, idx: int) -> MeshGraph:
        return self.get_batch([self.sample_map[idx]])

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        # a plain copy from pageable memory: the host buffer may be freed
        # as soon as it returns, and it is ordered on the current stream
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
            self.device)

    def get_batch_stack(self, sample_batches: Sequence[Sequence[Tuple[str, int]]]
                        ) -> Tuple[MeshGraph, Dict[str, torch.Tensor]]:
        """``k`` batches that share one mesh combination as (the static
        batched graph, ``{field: (k, N, W, D)}`` on the dataset's device):
        the input of the trainer's ``train_step_multi``."""
        mesh_ids = tuple(m for m, _ in sample_batches[0])
        if any(tuple(m for m, _ in sb) != mesh_ids for sb in sample_batches):
            raise ValueError("the batches of a stack must share one mesh "
                             "combination")
        g = self._batched_static(mesh_ids)
        pad = self._pad_for(mesh_ids)
        per_key: Dict[str, list] = {}
        for sb in sample_batches:
            winds = [self._window(m, ts, pad) for m, ts in sb]
            for key in FIELD_KEYS:
                if key in winds[0]:
                    per_key.setdefault(key, []).append(
                        np.concatenate([w[key] for w in winds], axis=0))
        return g, {key: self._to_device(np.stack(v))
                   for key, v in per_key.items()}

    # ---- device-resident trajectory fields ----------------------------------
    def estimate_device_field_bytes(self) -> int:
        """Bytes the whole dataset's trajectory fields take on the device,
        each mesh padded to its bucket's pad, in f32: the budget check of
        the indexed train path."""
        total = 0
        for t in self.trajectories:
            pad = self.bucket_pad[self.bucket_of[t.mesh_id]]
            for key, arr in t.fields.items():
                if key not in FIELD_KEYS:
                    continue
                npad = pad["cell" if key.startswith("cell") else "face"]
                total += arr.shape[0] * npad * arr.shape[2] * 4
        return total

    def device_fields(self, mesh_ids: Tuple[str, ...]
                      ) -> Dict[str, torch.Tensor]:
        """The whole trajectories of one mesh combination (a mesh may appear
        more than once) on the dataset's device, ``{key: (T, B*Npad, D)}``
        f32 in batch layout, zero-padded to the combination's pad, ``T``
        the combination's shortest trajectory; kept in an LRU of 16
        combinations. With a fixed-chunk
        sampler each combination is copied once for the whole run, and the
        indexed train step gathers its windows there."""
        cache = self._device_fields_cache
        if mesh_ids in cache:
            cache.move_to_end(mesh_ids)
            return cache[mesh_ids]
        pad = self._pad_for(mesh_ids)
        T = min(self.by_id[m].num_timesteps for m in mesh_ids)
        out = {}
        for key in FIELD_KEYS:
            if not all(key in self.by_id[m].fields for m in mesh_ids):
                continue
            npad = pad["cell" if key.startswith("cell") else "face"]
            rows = []
            for m in mesh_ids:
                x = np.asarray(self.by_id[m].fields[key][:T])
                rows.append(np.pad(x, ((0, 0), (0, npad - x.shape[1]), (0, 0))))
            out[key] = self._to_device(np.concatenate(rows, axis=1))
        while len(cache) >= self._device_fields_cache_size:
            cache.popitem(last=False)
        cache[mesh_ids] = out
        return out

    # ---- rollout ground truth ----------------------------------------------
    def trajectory_fields(self, mesh_ids: Sequence[str], t0: int,
                          num_steps: int,
                          keys: Sequence[str] = FIELD_KEYS
                          ) -> Dict[str, np.ndarray]:
        """Padded/batched ground-truth stacks (T, sum_N, D) of every requested
        field present in all the trajectories, at the batch's pad
        (:meth:`_pad_for`); row i is the state at t0 + (i+1)*stride."""
        pad = self._pad_for(mesh_ids)
        keys = [k for k in keys
                if all(k in self.by_id[m].fields for m in mesh_ids)]
        out: Dict[str, List[np.ndarray]] = {k: [] for k in keys}
        for i in range(num_steps):
            ts = t0 + (i + 1) * self.stride
            for k in keys:
                npad = pad["cell" if k.startswith("cell") else "face"]
                rows = []
                for m in mesh_ids:
                    x = self.by_id[m].fields[k][ts]
                    rows.append(np.pad(x, ((0, npad - x.shape[0]), (0, 0))))
                out[k].append(np.concatenate(rows, axis=0))
        return {k: np.stack(v) for k, v in out.items()}

    def trajectory_targets(self, mesh_ids: Sequence[str], t0: int,
                           num_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T, sum_C, 2) cell velocity + (T, sum_C, 1) pressure ground truth
        on the dataset's device, padded/batched to match a ``get_batch``
        graph (at its pad); row i is the state at t0 + (i+1)*stride."""
        f = self.trajectory_fields(mesh_ids, t0, num_steps,
                                   keys=("cell_velocity", "cell_pressure"))
        return tuple(torch.from_numpy(np.ascontiguousarray(
            f[k], np.float32)).to(self.device)
            for k in ("cell_velocity", "cell_pressure"))

    # ---- MLS weights -------------------------------------------------------
    def add_grad_weights(self, loc: str, poly_order: int):
        """MLS gradient weights of order ``poly_order`` for each mesh's
        ``loc`` ("cell" or "face") centers, where a mesh has none yet
        (reference ``MovingLeastSquaresWeights.add_weights_to_dataset``,
        maths.py:34-107); the graphs built so far are dropped (the tables
        do not depend on the weights and stay)."""
        for t in self.trajectories:
            wkey = f"{loc}_grad_weights"
            if wkey in t.grad_weights:
                continue
            nb, w = compute_mls_weights(t.geom[f"{loc}_pos"], poly_order)
            t.grad_weights[wkey] = w
            t.grad_weights[f"{loc}_grad_neighbours"] = nb
        self._static_graphs.clear()
        self._batched_cache.clear()


def train_batches(dataset: MeshDataset, batch_size: int,
                  rng: np.random.Generator):
    """Shuffled training batches of (mesh_id, ts) samples, each within one
    size bucket: the samples grouped by bucket in the order the buckets are
    first met, each bucket's permuted and cut into whole batches (its last
    partial one dropped), then all the batches permuted. The JAX package's
    ``train_batches``, drawing from ``rng`` in its order."""
    by_bucket: Dict[int, list] = {}
    for sample in dataset.sample_map:
        by_bucket.setdefault(dataset.bucket_of[sample[0]], []).append(sample)
    batches = []
    for samples in by_bucket.values():
        order = rng.permutation(len(samples))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            batches.append([samples[j] for j in order[i:i + batch_size]])
    for i in rng.permutation(len(batches)):
        yield batches[i]


class _Closed(Exception):
    """The consumer of a background feed has gone."""


def _background(produce, size: int):
    """Run ``produce(put)`` in a worker thread and yield what it puts, at
    most ``size`` items ahead. An exception of the worker is raised here,
    in the consuming thread, where the JAX package's feeds end the epoch
    early; when the consumer stops early, the worker stops at its next
    ``put``."""
    q: "queue.Queue" = queue.Queue(maxsize=max(int(size), 1))
    closed = threading.Event()

    def put(item):
        while not closed.is_set():
            try:
                q.put(item, timeout=0.05)
                return
            except queue.Full:
                pass
        raise _Closed

    def worker():
        try:
            produce(lambda item: put((True, item)))
            put((False, None))
        except _Closed:
            pass
        except BaseException as exc:  # handed to the consumer, raised there
            try:
                put((False, exc))
            except _Closed:
                pass

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            more, item = q.get()
            if not more:
                if item is not None:
                    raise item
                return
            yield item
    finally:
        closed.set()
        thread.join()


def prefetch(batch_iter, dataset: MeshDataset, size: int = 2):
    """Batches of ``batch_iter`` assembled and copied to the device by a
    worker thread, up to ``size`` ahead of the consumer. Yields
    MeshGraphs."""
    def produce(put):
        for samples in batch_iter:
            put(dataset.get_batch(samples))
    return _background(produce, size)


def _runs(batch_iter, k: int):
    """Runs of consecutive batches that share one mesh combination, each cut
    at ``k`` batches: (combination, batches)."""
    run, cur = [], None
    for samples in batch_iter:
        ids = tuple(m for m, _ in samples)
        if ids != cur:
            if run:
                yield cur, run
            run, cur = [], ids
        run.append(samples)
        if len(run) == k:
            yield cur, run
            run = []
    if run:
        yield cur, run


def prefetch_grouped(batch_iter, dataset: MeshDataset, k: int,
                     size: int = 2):
    """The multi-step feed: a run of ``k`` consecutive batches that share a
    mesh combination as ``("multi", graph, field_stack)``
    (:meth:`MeshDataset.get_batch_stack`), a shorter run (a chunk's tail, a
    change of combination) as single batches, ``("single", graph)``;
    assembled by a worker thread up to ``size`` ahead, in the JAX
    package's order."""
    def produce(put):
        for _, run in _runs(batch_iter, k):
            if len(run) == k:
                put(("multi", *dataset.get_batch_stack(run)))
            else:
                for samples in run:
                    put(("single", dataset.get_batch(samples)))
    return _background(produce, size)


def prefetch_indexed(batch_iter, dataset: MeshDataset, k: int):
    """The device-resident feed: each run of at most ``k`` consecutive
    batches that share a mesh combination as ``("indexed", graph,
    dev_fields, ts)``, with the combination's trajectory store
    (:meth:`MeshDataset.device_fields`) and the run's ``(k', B)`` int32
    start steps (a run's tail is a shorter one). No worker thread: a
    call's host work is one small index array."""
    for combo, run in _runs(batch_iter, k):
        ts = np.asarray([[t for _, t in sb] for sb in run], np.int32)
        yield ("indexed", dataset._batched_static(combo),
               dataset.device_fields(combo), ts)


def rollout_batch(dataset: MeshDataset, t0: Optional[int] = None):
    """The rollout initial batch: all trajectories at the range start
    (reference ``RolloutSampler`` ordering, sampler.py:5-46)."""
    t0 = dataset.timestep_range[0] if t0 is None else t0
    return [(m, t0) for m in dataset.sim_ids()]
