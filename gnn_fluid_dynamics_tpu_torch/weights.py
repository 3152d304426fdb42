"""Weights from the JAX package: Flax variables onto the port's modules.

The JAX package's variables (``{"params": ..., "batch_stats": ...}``, as
nested dicts of numpy arrays) map onto the state dict of the port's model
module, e.g. FluxD's, FvgnF's, VertPotA's, ConservativeH's and those of the
other families:

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
``integrator/vol_dt_norm/MaskedBatchNorm_0/...`` (FluxA)     ``integrator.vol_dt_norm.masked_batch_norm...``
``Encoder_0/cell_mlp/Dense_0`` (VertPot)                      ``encoder.cell_mlp.dense0``
``CellBlock_3/MLP_0`` (VertPot, at the top)                   ``blocks.3.cell_block.mlp``
``decoder_vertex/Dense_2`` (VertPot)                          ``decoder_vertex.dense2``
``_ConsEncoder_0/faceA_mlp/Dense_0/kernel`` (Conservative)     ``encoder.faceA_mlp.dense0.weight`` (no bias)
``_ConsHBlock_3/face_asym/Dense_1`` (any ``_Cons?Block_i``)     ``blocks.3.face_asym.dense1``
``faceS_mlp/Dense_0``, ``cell_mlp`` (H/J/K, at the top)       ``faceS_mlp.dense0``, ``cell_mlp``
``decoder/even_mlp/Dense_0`` (H/J/K)                          ``decoder.even_mlp.dense0``
``diffusion_scale`` (ConservativeJ, a (1,) parameter)         ``diffusion_scale``
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

# (pattern on the Flax name, whether it needs an ``Encoder_0`` beside it,
# torch name); the first that matches wins. A GN block's sub-blocks are
# ``CellBlock_0`` and ``FaceBlock_0`` inside ``GNBlock_i`` (or at the top of
# a bare GN block's tree). VertPot's processor has no GN block: its
# ``CellBlock_i``/``FaceBlock_i`` sit beside its ``Encoder_0`` and map to the
# port's ``blocks.i``. The Conservative family's blocks are ``_ConsABlock_i``
# ... ``_ConsIBlock_i`` (``blocks.i``) and A/B/D's encoder ``_ConsEncoder_0``
# (``encoder``; ``Encoder_0$`` does not match it, ``re.match`` anchoring at
# the start). Every other name, such as H/J/K's top-level ``cell_mlp``, is
# kept as it is.
_NAMES = (
    (re.compile(r"EncodeProcessDecode_0$"), False, "epd"),
    (re.compile(r"Encoder_0$"), False, "encoder"),
    (re.compile(r"_ConsEncoder_0$"), False, "encoder"),
    (re.compile(r"_Cons[A-Z]Block_(\d+)$"), False, r"blocks.\1"),
    (re.compile(r"GNBlock_(\d+)$"), False, r"blocks.\1"),
    (re.compile(r"CellBlock_(\d+)$"), True, r"blocks.\1.cell_block"),
    (re.compile(r"FaceBlock_(\d+)$"), True, r"blocks.\1.face_block"),
    (re.compile(r"CellBlock_0$"), False, "cell_block"),
    (re.compile(r"FaceBlock_0$"), False, "face_block"),
    (re.compile(r"MLP_0$"), False, "mlp"),
    (re.compile(r"Dense_(\d+)$"), False, r"dense\1"),
    (re.compile(r"LayerNorm_0$"), False, "layer_norm"),
    (re.compile(r"MaskedBatchNorm_0$"), False, "masked_batch_norm"),
    (re.compile(r"BatchNorm_0$"), False, "batch_norm"),
)
_COLLECTIONS = {"params", "batch_stats"}
_STAT_KEYS = {"mean": "running_mean", "var": "running_var"}


def _module_name(flax_name: str, siblings) -> str:
    beside_encoder = "Encoder_0" in siblings
    for pattern, needs_encoder, repl in _NAMES:
        if pattern.match(flax_name) and (beside_encoder or not needs_encoder):
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
                walk(value, prefix + _module_name(name, tree) + ".", name,
                     collection)
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                arr = arr.T
            key = prefix + _leaf_name(name, parent, collection)
            out[key] = torch.from_numpy(np.array(arr))

    for collection, tree in collections.items():
        walk(tree, "", "", collection)
    return out
