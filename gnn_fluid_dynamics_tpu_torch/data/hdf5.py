"""HDF5 datasets in the reference's on-disk layout (counterpart of the
in-memory part of ``data/hdf5.py``; reference ``src/datasets/
DataSet.py:210-312``). One group per mesh (``mesh_<i>``) with subgroups

* ``geom``  — the geometry (``GEOM_KEYS``, and ``DERIVED_KEYS`` where
  written; regenerated when a file lacks them)
* ``cell``  — ``velocity`` (T, C, 2), ``pressure`` (T, C, 1)
* ``face``  — ``velocity`` (T, F, 2), ``pressure`` (T, F, 1), optional
  ``flux`` (T, F, 1)
* ``meta``  — ``dt``, ``num_timesteps``, optional ``Re``
* optional ``{cell,face}_grad_weights/<order>/{weights,neighbours}``
  (reference ``src/utils/maths.py:77-91``)

so the files this module writes are the JAX package's and the reference's,
and theirs are read here. Besides the eager reader and the writer, the
out-of-core store (:class:`H5Store` and its views, :func:`load_dataset_lazy`)
streams field windows and geometry from a file through a bounded LRU, and
:func:`add_grad_weights_to_file` caches MLS weights inside a file.

``h5py`` is imported inside the functions that open a file, never when this
module is imported: a machine without it (the card's) imports the module,
and opening a file there raises ``ImportError``.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from gnn_fluid_dynamics_tpu_torch.data.pipeline import Trajectory

GEOM_KEYS = (
    "vertex_pos", "vertex_edge_index", "vertex_face", "vertex_edge_vector",
    "face_normal", "face_pos", "face_area", "face_index", "face_type",
    "face_boundary_mask", "cell_pos", "cell_edge_index", "cell_volume",
    "cell_normal",
)
# tables of this package's own, absent from the reference's files
DERIVED_KEYS = ("cell_face_sign", "owner_local_slot")


def write_trajectory(f, mesh_id: str, geom: Dict[str, np.ndarray],
                     fields: Dict[str, np.ndarray], dt: float,
                     reynolds: Optional[float] = None):
    """Write one trajectory group into the h5py file or group ``f``."""
    g = f.create_group(mesh_id)
    gg = g.create_group("geom")
    for key in GEOM_KEYS + DERIVED_KEYS:
        if key in geom:
            gg.create_dataset(key, data=np.asarray(geom[key]))
    cell = g.create_group("cell")
    cell.create_dataset("velocity", data=fields["cell_velocity"])
    cell.create_dataset("pressure", data=fields["cell_pressure"])
    face = g.create_group("face")
    face.create_dataset("velocity", data=fields["face_velocity"])
    face.create_dataset("pressure", data=fields["face_pressure"])
    if "face_flux" in fields:
        face.create_dataset("flux", data=fields["face_flux"])
    meta = g.create_group("meta")
    meta.create_dataset("dt", data=float(dt))
    meta.create_dataset("num_timesteps",
                        data=int(fields["cell_velocity"].shape[0]))
    if reynolds is not None:
        meta.create_dataset("Re", data=float(reynolds))


def require_h5py():
    """The ``h5py`` module, or an ``ImportError`` that says what needs it."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError("h5py is not installed: the HDF5 datasets and the "
                          "out-of-core store need it") from exc
    return h5py


def save_dataset(path: str, trajectories: Sequence[Trajectory]):
    """Write ``trajectories`` to a new file at ``path``."""
    h5py = require_h5py()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        for t in trajectories:
            write_trajectory(f, t.mesh_id, t.geom, t.fields, t.dt, t.reynolds)


def _ensure_derived(geom: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The sign and slot tables, regenerated where a file (the reference
    writes none) lacks them."""
    if "cell_face_sign" not in geom:
        from gnn_fluid_dynamics_tpu_torch.ops.connectivity import (
            compute_cell_face_sign, compute_owner_local_slot)
        geom["cell_face_sign"] = compute_cell_face_sign(
            geom["face_index"], geom["cell_edge_index"])
        geom["owner_local_slot"] = compute_owner_local_slot(
            geom["face_index"], geom["cell_edge_index"])
    return geom


def load_dataset(path: str, sim_limit: Optional[int] = None,
                 sim_index: Optional[Sequence[int]] = None,
                 flux_scale: float = 1.0,
                 grad_weights_order: Optional[Dict[str, int]] = None,
                 shuffle: bool = False, seed: int = 0) -> List[Trajectory]:
    """The trajectories of the file at ``path``, with the reference's
    selection (``DataSet._create_map``, DataSet.py:99-125): the meshes in
    name order, or ``mesh_<i>`` for each ``i`` of ``sim_index``, or shuffled
    by ``seed``; the first ``sim_limit`` of them.

    ``flux_scale`` multiplies the face flux: the reference divides
    OpenFOAM's phi by 0.001 when it loads it (DataSet.py:259), so pass
    ``1/0.001`` for OpenFOAM-generated files. ``grad_weights_order`` maps
    "cell"/"face" to the MLS order whose stored weights to read, where the
    file has them."""
    h5py = require_h5py()
    out = []
    with h5py.File(path, "r") as f:
        for mesh_id in _select(f, path, sim_limit, sim_index, shuffle, seed):
            g = f[mesh_id]
            geom = _ensure_derived({k: g["geom"][k][()]
                                    for k in g["geom"].keys()})
            fields = {
                "cell_velocity": g["cell"]["velocity"][()],
                "cell_pressure": g["cell"]["pressure"][()],
                "face_velocity": g["face"]["velocity"][()],
                "face_pressure": g["face"]["pressure"][()],
            }
            if "flux" in g["face"]:
                fields["face_flux"] = g["face"]["flux"][()] * flux_scale
            out.append(_trajectory(g, mesh_id, geom, fields,
                                   grad_weights_order))
    return out


def _select(f, path: str, sim_limit, sim_index, shuffle: bool,
            seed: int) -> List[str]:
    """The mesh groups a loader reads, by the reference's selection
    (``DataSet._create_map``, DataSet.py:99-125)."""
    ids = sorted(k for k in f.keys() if k.startswith("mesh"))
    if sim_index is not None:
        ids = [f"mesh_{i}" for i in sim_index]
    elif shuffle:
        ids = list(np.random.default_rng(seed).permutation(ids))
    if sim_limit:
        if len(ids) < sim_limit:
            raise ValueError(f"{path} holds {len(ids)} meshes, "
                             f"sim_limit is {sim_limit}")
        ids = ids[:sim_limit]
    return ids


def _trajectory(g, mesh_id: str, geom, fields, grad_weights_order
                ) -> Trajectory:
    """A Trajectory of the group ``g`` with ``geom`` and ``fields``: its dt
    and Reynolds number, and its stored MLS weights of the orders
    ``grad_weights_order`` asks for, read into memory."""
    grad = {}
    for loc, order in (grad_weights_order or {}).items():
        key = f"{loc}_grad_weights"
        if key in g and str(order) in g[key]:
            sub = g[key][str(order)]
            grad[key] = sub["weights"][()]
            grad[f"{loc}_grad_neighbours"] = sub["neighbours"][()]
    dt = float(g["meta"]["dt"][()])
    re = float(g["meta"]["Re"][()]) if "Re" in g["meta"] else 0.0
    return Trajectory(mesh_id=mesh_id, geom=geom, fields=fields, dt=dt,
                      reynolds=re, grad_weights=grad)


# ---------------------------------------------------------------------------
# The out-of-core store: the reference streams windows from HDF5 with a
# handle per worker process and an LRU of geometry (DataSet.py:127-172)
# ---------------------------------------------------------------------------

_FIELD_PATHS = {
    "cell_velocity": ("cell", "velocity"),
    "cell_pressure": ("cell", "pressure"),
    "face_velocity": ("face", "velocity"),
    "face_pressure": ("face", "pressure"),
    "face_flux": ("face", "flux"),
}


class H5Store:
    """One file's lazy handle and a bounded LRU of its geometry arrays.

    The handle is opened (SWMR) in the process that reads, and opened again
    when the process id changes, as the reference opens one per DataLoader
    worker (DataSet.py:127-149). Geometry reads go through an LRU of at most
    ``cache_entries`` arrays, counting ``hits`` and ``misses`` (the
    reference's 25-mesh LRU, DataSet.py:63-64, 161-172)."""

    def __init__(self, path: str, cache_entries: int = 128):
        self.path = path
        self.cache_entries = cache_entries
        self._pid = None
        self._file = None
        self._cache: "OrderedDict[tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @property
    def file(self):
        if self._file is None or self._pid != os.getpid():
            self._file = require_h5py().File(self.path, "r", swmr=True)
            self._pid = os.getpid()
        return self._file

    def _put(self, key, value):
        self._cache[key] = value
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_entries:
            self._cache.popitem(last=False)
        return value

    def geom_array(self, mesh_id: str, key: str) -> np.ndarray:
        ck = (mesh_id, key)
        if ck in self._cache:
            self.hits += 1
            self._cache.move_to_end(ck)
            return self._cache[ck]
        self.misses += 1
        gg = self.file[mesh_id]["geom"]
        if key in gg:
            return self._put(ck, gg[key][()])
        if key in DERIVED_KEYS:
            # a file without the sign/slot tables (the reference's): made
            # from the index arrays, as the eager reader makes them
            partial = {k: self.geom_array(mesh_id, k)
                       for k in ("face_index", "cell_edge_index")}
            _ensure_derived(partial)
            for k in DERIVED_KEYS:
                self._put((mesh_id, k), partial[k])
            # NOT self._cache[ck]: a tight cache_entries bound can evict ck
            # inside _put before it is read back
            return partial[key]
        raise KeyError((mesh_id, key))

    def geom_keys(self, mesh_id: str) -> tuple:
        gg = self.file[mesh_id]["geom"]
        return tuple(gg.keys()) + tuple(k for k in DERIVED_KEYS
                                        if k not in gg)

    def field_dataset(self, mesh_id: str, key: str):
        """The h5py dataset of field ``key``, or None where the mesh has
        none."""
        grp, name = _FIELD_PATHS[key]
        g = self.file[mesh_id]
        return g[grp][name] if grp in g and name in g[grp] else None


class LazyArray:
    """A view of one field's h5py dataset with the pipeline's access pattern
    (``x[ts]``, ``x[ts:ts+W]``, ``.shape``): each access reads its window
    from the file, times ``scale`` (the face flux's ``flux_scale``)."""

    def __init__(self, store: H5Store, mesh_id: str, key: str,
                 scale: float = 1.0):
        self.store = store
        self.mesh_id = mesh_id
        self.key = key
        self.scale = scale
        self.shape = store.field_dataset(mesh_id, key).shape

    def __getitem__(self, idx):
        x = self.store.field_dataset(self.mesh_id, self.key)[idx]
        return x * np.float32(self.scale) if self.scale != 1.0 else x

    def __len__(self):
        return self.shape[0]


class LazyGeom:
    """A mapping view of one mesh's geometry group, read through the
    store's LRU."""

    def __init__(self, store: H5Store, mesh_id: str):
        self.store = store
        self.mesh_id = mesh_id
        self._keys = store.geom_keys(mesh_id)

    def __getitem__(self, key):
        return self.store.geom_array(self.mesh_id, key)

    def __contains__(self, key):
        return key in self._keys

    def keys(self):
        return self._keys

    def items(self):
        return ((k, self[k]) for k in self._keys)

    def get(self, key, default=None):
        return self[key] if key in self._keys else default


class PermutedLazyArray:
    """A LazyArray whose elements (axis -2) are permuted on read: the
    out-of-core form of ``ops.reorder.reorder_fields`` for RCM-ordered
    meshes."""

    def __init__(self, base: LazyArray, perm: np.ndarray):
        self.base = base
        self.perm = np.asarray(perm)
        self.shape = base.shape

    def __getitem__(self, idx):
        return self.base[idx][..., self.perm, :]

    def __len__(self):
        return self.shape[0]


class TransformedLazyGeom:
    """A LazyGeom through a geometry transform (the RCM relabeling), made on
    demand; the transformed dict is one entry of the store's LRU, under
    (mesh_id, ``tag``)."""

    def __init__(self, base: LazyGeom, transform, tag: str):
        self.base = base
        self.transform = transform
        self.tag = tag

    def _dict(self):
        store, mid = self.base.store, self.base.mesh_id
        ck = (mid, self.tag)
        if ck in store._cache:
            store.hits += 1
            store._cache.move_to_end(ck)
            return store._cache[ck]
        store.misses += 1
        raw = {k: self.base[k] for k in self.base.keys()}
        return store._put(ck, self.transform(raw))

    def __getitem__(self, key):
        return self._dict()[key]

    def __contains__(self, key):
        return key in self._dict()

    def keys(self):
        return tuple(self._dict().keys())

    def items(self):
        return self._dict().items()

    def get(self, key, default=None):
        return self._dict().get(key, default)


def load_dataset_lazy(path: str, sim_limit: Optional[int] = None,
                      sim_index: Optional[Sequence[int]] = None,
                      flux_scale: float = 1.0,
                      grad_weights_order: Optional[Dict[str, int]] = None,
                      shuffle: bool = False, seed: int = 0,
                      cache_entries: int = 128) -> List[Trajectory]:
    """The out-of-core form of :func:`load_dataset`, with its selection:
    trajectories whose ``geom`` and ``fields`` are views of the file
    (:class:`LazyGeom`, :class:`LazyArray`), so that the reference's
    1,000-mesh scale fits in bounded host memory (reference
    DataSet.py:127-172). Field windows are read from the file per batch,
    the face flux times ``flux_scale`` on read; the geometry goes through
    one shared :class:`H5Store` LRU of ``cache_entries`` arrays. The MLS
    weights are read into memory (small, and the static graphs need them
    whole)."""
    h5py = require_h5py()
    store = H5Store(path, cache_entries=cache_entries)
    out = []
    with h5py.File(path, "r", swmr=True) as f:
        for mesh_id in _select(f, path, sim_limit, sim_index, shuffle, seed):
            fields = {k: LazyArray(store, mesh_id, k,
                                   scale=(flux_scale if k == "face_flux"
                                          else 1.0))
                      for k in _FIELD_PATHS
                      if store.field_dataset(mesh_id, k) is not None}
            out.append(_trajectory(f[mesh_id], mesh_id,
                                   LazyGeom(store, mesh_id), fields,
                                   grad_weights_order))
    return out


def add_grad_weights_to_file(path: str, loc: str, poly_order: int,
                             recompute: bool = False):
    """MLS weights of order ``poly_order`` at every mesh's ``loc`` ("cell"
    or "face") centers, computed and stored in the file as
    ``<loc>_grad_weights/<order>/{neighbours, weights}``, the order added
    to the list ``meta/<loc>_grad_weights_orders`` (reference
    ``MovingLeastSquaresWeights._precompute``, maths.py:49-107). An order
    the list already names is left as it is, unless ``recompute``."""
    from gnn_fluid_dynamics_tpu_torch.ops.mls import compute_mls_weights
    with require_h5py().File(path, "a") as f:
        meta = f.require_group("meta")
        okey = f"{loc}_grad_weights_orders"
        existing = list(meta[okey][()]) if okey in meta else []
        if poly_order in existing and not recompute:
            return
        for mesh_id in [k for k in f.keys() if k.startswith("mesh")]:
            g = f[mesh_id]
            nb, w = compute_mls_weights(g["geom"][f"{loc}_pos"][()],
                                        poly_order)
            grp = g.require_group(f"{loc}_grad_weights")
            if str(poly_order) in grp:
                del grp[str(poly_order)]
            sub = grp.create_group(str(poly_order))
            sub.create_dataset("neighbours", data=nb)
            sub.create_dataset("weights", data=w)
        if poly_order not in existing:
            existing.append(poly_order)
            if okey in meta:
                del meta[okey]
            meta.create_dataset(okey, data=existing)
