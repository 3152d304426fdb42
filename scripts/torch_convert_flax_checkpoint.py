"""Convert a checkpoint of the JAX package into the PyTorch port's layout.

    python scripts/torch_convert_flax_checkpoint.py \
        checkpoints/e2e/fluxd/checkpoint-12 build/fluxd-ckpt12

The JAX checkpoint directory holds ``state`` (orbax) and ``meta.json`` (the
training config and the normalization statistics). The output directory
gets ``state.pt`` — the port's module state dict (the Flax ``params`` and
``batch_stats`` through ``weights.params_from_flax``, legacy names renamed)
and the step, no optimizer state — and a copy of ``meta.json``. The port's
``rollout.run`` takes the output directory as its ``model.fpath``.

This script, and the tests, are the only code of the port's side that
import JAX and orbax; the port's package does not.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gnn_fluid_dynamics_tpu_torch.training.model_loading import (  # noqa: E402
    backward_compatibility)
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax  # noqa: E402


def restore_flax_state(ckpt_dir: str) -> dict:
    """The orbax tree under ``<ckpt_dir>/state``, restored without a
    template as numpy arrays: params, batch_stats, opt_state, rng, step."""
    import orbax.checkpoint as ocp
    return ocp.PyTreeCheckpointer().restore(
        os.path.abspath(os.path.join(ckpt_dir, "state")))


def convert(ckpt_dir: str, out_dir: str):
    """Write the port's checkpoint for the JAX checkpoint ``ckpt_dir`` into
    ``out_dir``; returns (the state dict written, the restored orbax
    tree)."""
    tree = restore_flax_state(ckpt_dir)
    variables = {"params": backward_compatibility(tree["params"])}
    if tree.get("batch_stats"):
        variables["batch_stats"] = backward_compatibility(tree["batch_stats"])
    module = params_from_flax(variables)
    os.makedirs(out_dir, exist_ok=True)
    torch.save({"module": module, "step": int(np.asarray(tree["step"]))},
               os.path.join(out_dir, "state.pt"))
    shutil.copyfile(os.path.join(ckpt_dir, "meta.json"),
                    os.path.join(out_dir, "meta.json"))
    return module, tree


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("ckpt_dir", help="a JAX checkpoint (state/, meta.json)")
    parser.add_argument("out_dir", help="the port's checkpoint to write")
    args = parser.parse_args(argv)
    module, _ = convert(args.ckpt_dir, args.out_dir)
    print(f"wrote {len(module)} tensors "
          f"({sum(v.numel() for v in module.values()):,} values) to "
          f"{args.out_dir}/state.pt")


if __name__ == "__main__":
    main()
