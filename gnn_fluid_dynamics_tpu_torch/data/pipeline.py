"""Host-side data pipeline: trajectory store, sample map, padded batching.

Counterpart of the in-memory part of ``gnn_fluid_dynamics_tpu/data/pipeline.py``:
each trajectory is kept in host memory (numpy, time-major); every mesh is
padded to one shape, that of the largest; the static batched geometry graph
is built once per mesh combination and each batch swaps only its
time-window fields in. With ``with_banded`` each mesh carries its own banded
tables, and :func:`~gnn_fluid_dynamics_tpu_torch.graph.batch_graphs` brings a
batch's tables to one band width.

Training reads it through :func:`train_batches` or the samplers of
:mod:`gnn_fluid_dynamics_tpu_torch.data.samplers`, one ``get_batch`` per step,
in the training process (no prefetch thread).

Not ported: the size buckets (``num_buckets``) and the per-pad canonical
band offsets, which the JAX package keeps so that its compiled programs see
few shapes; the out-of-core mode (``max_cached_graphs``), the prefetchers,
``device_fields``, ``get_batch_stack`` and the incidence tables of the
``"gather"`` backend (the port's graphs always carry
their index vectors).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gnn_fluid_dynamics_tpu_torch import resolve_device
from gnn_fluid_dynamics_tpu_torch.graph import (FIELD_KEYS, MeshGraph,
                                                batch_graphs, from_geometry)
from gnn_fluid_dynamics_tpu_torch.ops.mls import compute_mls_weights


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
    """In-memory dataset over a set of trajectories, padded to one shape.
    Graphs are built on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, trajectories: Sequence[Trajectory],
                 stride: int = 1, data_window: int = 2,
                 timestep_range: Optional[Tuple[int, int]] = None,
                 pad_multiple: int = 128,
                 with_banded: bool = False,
                 banded_dtype="float32",
                 device="cuda"):
        if not trajectories:
            raise ValueError("a dataset needs at least one trajectory")
        self.device = resolve_device(device)
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

        self.pad_to = {
            key: rup(max(t.geom[f"{key}_pos"].shape[0]
                         for t in self.trajectories))
            for key in ("cell", "face", "vertex")}

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

        self._static_graphs: Dict[str, MeshGraph] = {}
        self._batched_cache: Dict[Tuple[str, ...], MeshGraph] = {}
        self._batched_cache_size = 8

    def __len__(self):
        return len(self.sample_map)

    def sim_ids(self) -> List[str]:
        return [t.mesh_id for t in self.trajectories]

    # ---- static geometry ---------------------------------------------------
    def _static_graph(self, mesh_id: str) -> MeshGraph:
        if mesh_id not in self._static_graphs:
            t = self.by_id[mesh_id]
            self._static_graphs[mesh_id] = from_geometry(
                t.geom, fields=t.grad_weights, dt=t.dt * self.stride,
                reynolds=t.reynolds,
                pad_to=self.pad_to, with_banded=self.with_banded,
                banded_dtype=self.banded_dtype, device=self.device)
        return self._static_graphs[mesh_id]

    def _batched_static(self, mesh_ids: Tuple[str, ...]) -> MeshGraph:
        if mesh_ids not in self._batched_cache:
            while len(self._batched_cache) >= self._batched_cache_size:
                self._batched_cache.pop(next(iter(self._batched_cache)))
            self._batched_cache[mesh_ids] = batch_graphs(
                [self._static_graph(m) for m in mesh_ids])
        return self._batched_cache[mesh_ids]

    # ---- field windows -----------------------------------------------------
    def _window(self, mesh_id: str, ts: int) -> Dict[str, np.ndarray]:
        t = self.by_id[mesh_id]
        out = {}
        for key in FIELD_KEYS:
            if key not in t.fields:
                continue
            arr = t.fields[key][ts:ts + self.data_window]       # (W, N, D)
            npad = self.pad_to["cell" if key.startswith("cell") else "face"]
            x = np.transpose(arr, (1, 0, 2))                    # (N, W, D)
            if x.shape[0] < npad:
                x = np.pad(x, ((0, npad - x.shape[0]), (0, 0), (0, 0)))
            out[key] = x
        return out

    def get_batch(self, samples: Sequence[Tuple[str, int]]) -> MeshGraph:
        """One batched MeshGraph for [(mesh_id, ts), ...]."""
        mesh_ids = tuple(m for m, _ in samples)
        g = self._batched_static(mesh_ids)
        winds = [self._window(m, ts) for m, ts in samples]
        updates = {}
        for key in FIELD_KEYS:
            if key in winds[0]:
                arr = np.concatenate([w[key] for w in winds], axis=0)
                updates[key] = torch.from_numpy(
                    np.ascontiguousarray(arr, np.float32)).to(self.device)
        return dataclasses.replace(g, **updates)

    def get_item(self, idx: int) -> MeshGraph:
        return self.get_batch([self.sample_map[idx]])

    # ---- rollout ground truth ----------------------------------------------
    def trajectory_fields(self, mesh_ids: Sequence[str], t0: int,
                          num_steps: int,
                          keys: Sequence[str] = FIELD_KEYS
                          ) -> Dict[str, np.ndarray]:
        """Padded/batched ground-truth stacks (T, sum_N, D) of every requested
        field present in all the trajectories; row i is the state at
        t0 + (i+1)*stride."""
        keys = [k for k in keys
                if all(k in self.by_id[m].fields for m in mesh_ids)]
        out: Dict[str, List[np.ndarray]] = {k: [] for k in keys}
        for i in range(num_steps):
            ts = t0 + (i + 1) * self.stride
            for k in keys:
                npad = self.pad_to["cell" if k.startswith("cell") else "face"]
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
        graph; row i is the state at t0 + (i+1)*stride."""
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
        maths.py:34-107); the graphs built so far are dropped."""
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
    """Shuffled training batches of (mesh_id, ts) samples, the last partial
    one dropped, in batch order shuffled (the JAX package's
    ``train_batches``; without size buckets every sample is in one)."""
    order = rng.permutation(len(dataset.sample_map))
    batches = [[dataset.sample_map[j] for j in order[i:i + batch_size]]
               for i in range(0, len(order) - batch_size + 1, batch_size)]
    for i in rng.permutation(len(batches)):
        yield batches[i]


def rollout_batch(dataset: MeshDataset, t0: Optional[int] = None):
    """The rollout initial batch: all trajectories at the range start
    (reference ``RolloutSampler`` ordering, sampler.py:5-46)."""
    t0 = dataset.timestep_range[0] if t0 is None else t0
    return [(m, t0) for m in dataset.sim_ids()]
