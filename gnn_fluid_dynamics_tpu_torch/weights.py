"""Weights from the JAX package: Flax variables onto the port's modules.

The JAX package's variables (``{"params": ..., "batch_stats": ...}``, as
nested dicts of numpy arrays) map onto the state dict of the port's model
module, e.g. FluxD's, FvgnF's and those of the other ported families:

==========================================================  ================================================================
Flax path                                                   torch state-dict key
==========================================================  ================================================================
``EncodeProcessDecode_0/Encoder_0/face_mlp/Dense_0``          ``epd.encoder.face_mlp.dense0``
``EncodeProcessDecode_0/GNBlock_3/CellBlock_0/MLP_0``          ``epd.blocks.3.cell_block.mlp``
``.../LayerNorm_0/scale``                                   ``.../layer_norm.weight``
``velocity_scale_x/scale``                                  ``velocity_scale_x.scale``
``velocity_scale/{scale,bias}`` (FvgnJ)                      ``velocity_scale.{scale,bias}``
``anisotropy_ratio`` (FvgnK, a scalar)                       ``anisotropy_ratio``
``integrator/face_area_norm/MaskedBatchNorm_0/BatchNorm_0``  ``integrator.face_area_norm.masked_batch_norm.batch_norm``
``face_area_norm/MaskedBatchNorm_0/BatchNorm_0`` (FvgnC)      ``face_area_norm.masked_batch_norm.batch_norm``
``.../BatchNorm_0/{scale,bias}`` (params)                   ``.../batch_norm.{weight,bias}``
``.../BatchNorm_0/{mean,var}`` (batch_stats)                ``.../batch_norm.{running_mean,running_var}``
==========================================================  ================================================================

A Flax ``Dense`` kernel is (in, out); a torch ``Linear.weight`` is (out, in).
The fused kernels take their own split of ``W0`` (``MLP.kernel_weights``), so
the state dict holds each matrix whole.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

_NAMES = (
    (re.compile(r"EncodeProcessDecode_0$"), "epd"),
    (re.compile(r"Encoder_0$"), "encoder"),
    (re.compile(r"GNBlock_(\d+)$"), r"blocks.\1"),
    (re.compile(r"CellBlock_0$"), "cell_block"),
    (re.compile(r"FaceBlock_0$"), "face_block"),
    (re.compile(r"MLP_0$"), "mlp"),
    (re.compile(r"Dense_(\d+)$"), r"dense\1"),
    (re.compile(r"LayerNorm_0$"), "layer_norm"),
    (re.compile(r"MaskedBatchNorm_0$"), "masked_batch_norm"),
    (re.compile(r"BatchNorm_0$"), "batch_norm"),
)
_COLLECTIONS = {"params", "batch_stats"}
_STAT_KEYS = {"mean": "running_mean", "var": "running_var"}


def _module_name(flax_name: str) -> str:
    for pattern, repl in _NAMES:
        if pattern.match(flax_name):
            return pattern.sub(repl, flax_name)
    return flax_name


def _leaf_name(name: str, parent: str, collection: str) -> str:
    if collection == "batch_stats":
        return _STAT_KEYS[name]
    if name == "kernel":
        return "weight"
    if name == "scale" and parent in ("LayerNorm_0", "BatchNorm_0"):
        return "weight"
    return name


def params_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """State dict (f32 CPU tensors) of the port's module for the Flax
    ``variables``: a mapping of collections (``params`` and, where the model
    has BatchNorms, ``batch_stats``), or a bare param tree. Any
    :class:`~collections.abc.Mapping` is a subtree, so Flax's ``FrozenDict``
    (not a ``dict``) is taken as a plain dict is."""
    if variables and set(variables) <= _COLLECTIONS and "params" in variables:
        collections = variables
    else:
        collections = {"params": variables}
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix, parent, collection):
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + _module_name(name) + ".", name, collection)
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                arr = arr.T
            key = prefix + _leaf_name(name, parent, collection)
            out[key] = torch.from_numpy(np.array(arr))

    for collection, tree in collections.items():
        walk(tree, "", "", collection)
    return out
