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
and theirs are read here. ``h5py`` is imported inside the reader and the
writer only: nothing else of the port needs it.

Not ported yet: the out-of-core stores (``H5Store``, ``LazyArray`` and their
family, ``load_dataset_lazy``) and ``add_grad_weights_to_file``.
"""

from __future__ import annotations

import os
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


def save_dataset(path: str, trajectories: Sequence[Trajectory]):
    """Write ``trajectories`` to a new file at ``path``."""
    import h5py
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
    import h5py
    out = []
    with h5py.File(path, "r") as f:
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
        for mesh_id in ids:
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
            grad = {}
            for loc, order in (grad_weights_order or {}).items():
                key = f"{loc}_grad_weights"
                if key in g and str(order) in g[key]:
                    sub = g[key][str(order)]
                    grad[key] = sub["weights"][()]
                    grad[f"{loc}_grad_neighbours"] = sub["neighbours"][()]
            dt = float(g["meta"]["dt"][()])
            re = float(g["meta"]["Re"][()]) if "Re" in g["meta"] else 0.0
            out.append(Trajectory(mesh_id=mesh_id, geom=geom, fields=fields,
                                  dt=dt, reynolds=re, grad_weights=grad))
    return out
