"""Preprocessing CLI (counterpart of ``data/preproc.py``; reference
``src/preproc.py:132-173``):
loop the configured subsets through the dataset converter, writing one
canonical HDF5 file per subset through h5py, which only the writer
imports.

Usage::

    python -m gnn_fluid_dynamics_tpu_torch.data.preproc --config config/preproc.json

The ``dataset.module`` selects the source format: ``openfoam`` (VTK series,
needs pyvista), ``cylinderflow`` (DeepMind h5), ``tfrecord`` (DeepMind
tfrecord, needs tensorflow), or ``builtin`` (generate/ npz output).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from typing import List, Optional


def preprocess_subset(config, subset: str):
    from gnn_fluid_dynamics_tpu_torch.data.hdf5 import save_dataset
    module = config.dataset.module.lower()
    out_root = config.preproc.out_dpath or config.dataset.dpath
    out_path = os.path.join(out_root, f"{subset}.h5")
    os.makedirs(out_root, exist_ok=True)
    limit = config.preproc.data_sim_limit

    if module == "openfoam":
        from gnn_fluid_dynamics_tpu_torch.data.openfoam import preprocess_dataset
        subsets_file = os.path.join(config.preproc.vtk_dpath or ".",
                                    "subsets.json")
        with open(subsets_file) as f:
            ids = json.load(f)[subset]
        preprocess_dataset(config.preproc.vtk_dpath, out_path,
                           ids[:limit] if limit else ids)
    elif module == "cylinderflow":
        from gnn_fluid_dynamics_tpu_torch.data.cylinderflow import convert_deepmind_h5
        src = os.path.join(config.preproc.vtk_dpath or ".", f"{subset}.h5")
        convert_deepmind_h5(src, out_path, sim_limit=limit)
    elif module == "tfrecord":
        from gnn_fluid_dynamics_tpu_torch.data.cylinderflow import convert_tfrecord
        root = config.preproc.vtk_dpath or "."
        convert_tfrecord(os.path.join(root, f"{subset}.tfrecord"),
                         os.path.join(root, "meta.json"), out_path,
                         sim_limit=limit)
    elif module == "builtin":
        from gnn_fluid_dynamics_tpu_torch.generate.conversion import main as conv
        raw = config.preproc.vtk_dpath or "data/raw"
        meshes = os.path.join(os.path.dirname(raw.rstrip("/")) or ".",
                              "meshes")
        conv(["--raw", raw, "--meshes", meshes, "--out", out_root])
        return
    else:
        raise ValueError(f"unknown preprocessing module {module!r}")
    print(f"{subset} -> {out_path}")


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--subsets", type=str, nargs="*",
                        default=["train", "valid", "test"])
    args = parser.parse_args(argv)

    from gnn_fluid_dynamics_tpu_torch.training.config import load_config
    config = load_config(args.config)
    for subset in args.subsets:
        preprocess_subset(config, subset)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:
        print(f"Preprocessing failed: {e}")
        traceback.print_exc()
        sys.exit(1)
