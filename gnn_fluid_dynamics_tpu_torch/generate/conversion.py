"""Raw simulation output -> canonical HDF5 datasets (counterpart of
``generate/conversion.py``; reference ``generate/conversion.py``): move cases into train/valid/test
splits per a subsets JSON, converting built-in-solver npz output (or, via the
OpenFOAM preprocessing path, VTK series) to trajectory files.

Usage::

    python -m gnn_fluid_dynamics_tpu_torch.generate.conversion \
        --raw data/raw --meshes data/meshes --out data/h5 \
        --subsets gnn_fluid_dynamics_tpu_torch/generate/subsets/default.json
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np


def convert_case(raw_dir: str, mesh_dir: str, mesh_id: str):
    from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
    from gnn_fluid_dynamics_tpu_torch.data.pipeline import Trajectory
    from gnn_fluid_dynamics_tpu_torch.ops.connectivity import build_geometry

    mesh = np.load(os.path.join(mesh_dir, "mesh.npz"))
    geom = build_geometry(mesh["vertex_pos"], mesh["cells"],
                          mesh["vertex_types"], NodeType)
    with open(os.path.join(raw_dir, "meta.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(raw_dir, "fields.npz"))
    fields = {k: data[k] for k in data.files}
    # reference conversion keeps every 2nd step and doubles dt
    # (conversion.py:50-97); the builtin solver already saved at dt_saved
    dt = meta.get("dt_saved", meta["dt"])
    return Trajectory(mesh_id=mesh_id, geom=geom, fields=fields, dt=dt,
                      reynolds=meta.get("Re", 0.0))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--raw", type=str, default="data/raw")
    parser.add_argument("--meshes", type=str, default="data/meshes")
    parser.add_argument("--out", type=str, default="data/h5")
    parser.add_argument("--subsets", type=str, default=None)
    args = parser.parse_args(argv)

    from gnn_fluid_dynamics_tpu_torch.data.hdf5 import save_dataset

    cases = sorted(d for d in os.listdir(args.raw) if d.startswith("mesh_"))
    if args.subsets:
        with open(args.subsets) as f:
            subsets: Dict[str, List[int]] = json.load(f)
    else:
        n = len(cases)
        ids = list(range(n))
        subsets = {"train": ids[: int(0.8 * n) or 1],
                   "valid": ids[int(0.8 * n): int(0.9 * n)] or ids[:1],
                   "test": ids[int(0.9 * n):] or ids[:1]}

    os.makedirs(args.out, exist_ok=True)
    for subset, indices in subsets.items():
        trajs = []
        for new_id, i in enumerate(indices):
            case = f"mesh_{i}"
            if case not in cases:
                print(f"warning: {case} missing from raw output; skipped")
                continue
            trajs.append(convert_case(os.path.join(args.raw, case),
                                      os.path.join(args.meshes, case),
                                      f"mesh_{new_id}"))
        if trajs:
            path = os.path.join(args.out, f"{subset}.h5")
            save_dataset(path, trajs)
            print(f"{subset}: {len(trajs)} trajectories -> {path}")


if __name__ == "__main__":
    main()
