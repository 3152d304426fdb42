"""Weights from the JAX package: a Flax param tree onto the port's modules.

The JAX package's params (``variables["params"]``, as nested dicts of numpy
arrays) map onto the state dict of the port's model module, e.g. FluxD's:

==================================================  ===============================================
Flax path                                           torch state-dict key
==================================================  ===============================================
``EncodeProcessDecode_0/Encoder_0/face_mlp/Dense_0``  ``epd.encoder.face_mlp.dense0``
``EncodeProcessDecode_0/GNBlock_3/CellBlock_0/MLP_0``  ``epd.blocks.3.cell_block.mlp``
``.../LayerNorm_0/scale``                           ``.../layer_norm.weight``
``velocity_scale_x/scale``                          ``velocity_scale_x.scale``
==================================================  ===============================================

A Flax ``Dense`` kernel is (in, out); a torch ``Linear.weight`` is (out, in).
The fused kernels take their own split of ``W0`` (``MLP.kernel_weights``), so
the state dict holds each matrix whole.
"""

from __future__ import annotations

import re
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
)


def _module_name(flax_name: str) -> str:
    for pattern, repl in _NAMES:
        if pattern.match(flax_name):
            return pattern.sub(repl, flax_name)
    return flax_name


def params_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """State dict (f32 CPU tensors) of the port's module for the Flax param
    tree ``params`` (either ``variables`` or ``variables["params"]``)."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix, parent):
        for name, value in tree.items():
            if isinstance(value, dict):
                walk(value, prefix + _module_name(name) + ".", name)
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                key, arr = "weight", arr.T
            elif name == "scale" and parent.startswith("LayerNorm"):
                key = "weight"
            else:
                key = name
            out[prefix + key] = torch.from_numpy(np.array(arr))

    walk(params, "", "")
    return out
