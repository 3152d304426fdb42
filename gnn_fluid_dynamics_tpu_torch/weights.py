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

:func:`optimizer_state_from_optax` carries the JAX package's optimizer
state (optax's ``inject_hyperparams(adamw)`` or ``adam``, behind
``clip_by_global_norm``, which holds none) onto ``torch.optim.AdamW`` or
``Adam``: the moments ``mu`` and ``nu`` by the same names, the count as the
step.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

from gnn_fluid_dynamics_tpu_torch.training.model_loading import (
    backward_compatibility)

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


def _adam_state(opt_state):
    """The ``inject_hyperparams`` state in an optax state tree restored
    without a template (mappings and lists): the mapping with
    ``hyperparams``, alone or an element of a chain's list."""
    if isinstance(opt_state, Mapping):
        if "hyperparams" in opt_state:
            return opt_state
    elif isinstance(opt_state, (list, tuple)):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def optimizer_state_from_optax(opt_state, optimizer: torch.optim.Optimizer,
                               module: torch.nn.Module) -> Dict:
    """The state dict of ``optimizer`` (a ``torch.optim.AdamW`` or ``Adam``
    over ``module``'s parameters) holding the optax state ``opt_state`` of
    the JAX package's optimizer, as its checkpoints hold it (numpy, restored
    without a template): per parameter ``exp_avg`` from ``mu`` and
    ``exp_avg_sq`` from ``nu``, named through :func:`params_from_flax` after
    ``backward_compatibility``'s renames, and ``step`` from the count, a
    float32 tensor as torch keeps it. Raises ``ValueError`` when ``b1``,
    ``b2``, ``eps``, ``eps_root`` or ``weight_decay`` differ from the
    optimizer's (in f32, as optax holds them), or when the moments and the
    parameters do not match by name and shape."""
    state = _adam_state(opt_state)
    if state is None:
        raise ValueError("no inject_hyperparams state in the optax state")
    adam = next(s for s in state["inner_state"]
                if isinstance(s, Mapping) and "mu" in s)
    hyper = {k: float(np.asarray(v)) for k, v in state["hyperparams"].items()}
    own = optimizer.state_dict()["param_groups"]
    for group in own:
        want = {"b1": group["betas"][0], "b2": group["betas"][1],
                "eps": group["eps"], "eps_root": 0.0,
                "weight_decay": group["weight_decay"]}
        for key, value in want.items():
            got = hyper.get(key, 0.0)
            if np.float32(got) != np.float32(value):
                raise ValueError(f"optax's {key} is {got}, the optimizer's "
                                 f"{value}")
    names = {id(p): name for name, p in module.named_parameters()}
    order = [names[id(p)] for group in optimizer.param_groups
             for p in group["params"]]
    mu = params_from_flax(backward_compatibility(adam["mu"]))
    nu = params_from_flax(backward_compatibility(adam["nu"]))
    params = dict(module.named_parameters())
    if set(mu) != set(order) or set(nu) != set(order):
        raise ValueError("optax's moments and the module's parameters differ: "
                         f"{sorted(set(mu) ^ set(order))[:8]}")
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    out = {}
    for i, name in enumerate(order):
        shape = params[name].shape
        if mu[name].shape != shape or nu[name].shape != shape:
            raise ValueError(f"{name}: moments of shape {tuple(mu[name].shape)}"
                             f", parameter of shape {tuple(shape)}")
        out[i] = {"step": step.clone(), "exp_avg": mu[name],
                  "exp_avg_sq": nu[name]}
    return {"state": out, "param_groups": own}


# the inverse of _NAMES: a torch attribute -> its Flax module name, for the
# names a Flax module takes from its class (a module Flax names explicitly,
# such as ``decoder_face`` or ``integrator``, keeps its name)
_FLAX_NAMES = (
    (re.compile(r"epd$"), "EncodeProcessDecode_0"),
    (re.compile(r"mlp$"), "MLP_0"),
    (re.compile(r"dense(\d+)$"), r"Dense_\1"),
    (re.compile(r"layer_norm$"), "LayerNorm_0"),
    (re.compile(r"masked_batch_norm$"), "MaskedBatchNorm_0"),
    (re.compile(r"batch_norm$"), "BatchNorm_0"),
)


def flax_paths(module: torch.nn.Module) -> Dict[str, str]:
    """The Flax path (``"EncodeProcessDecode_0/decoder_face/Dense_2/kernel"``)
    of each of ``module``'s parameters, by torch name: the inverse of
    :func:`params_from_flax`'s map, whose image holds the current names only
    (``backward_compatibility`` renames a legacy ``decoder`` before it; the
    ``decoder`` of ConservativeH/J/K is a current name, and stays). The
    names Flax gives from a class are read off the torch module's class:
    ``encoder`` is ``Encoder_0`` or ``_ConsEncoder_0``, ``blocks.i`` is
    ``GNBlock_i`` inside an ``EncodeProcessDecode`` and ``_Cons?Block_i``
    in the Conservative family, and a ``GNBlock`` anywhere else (VertPot's)
    has no Flax module of its own: its ``cell_block`` and ``face_block``
    are ``CellBlock_i`` and ``FaceBlock_i``."""
    out: Dict[str, str] = {}

    def walk(m, torch_prefix, flax_prefix, block=0):
        for name, _ in m.named_parameters(recurse=False):
            parent = flax_prefix.rstrip("/").rsplit("/", 1)[-1]
            leaf = name
            if name == "weight":
                leaf = ("scale" if parent in ("LayerNorm_0", "BatchNorm_0")
                        else "kernel")
            out[torch_prefix + name] = flax_prefix + leaf
        for name, child in m.named_children():
            if isinstance(child, torch.nn.ModuleList):
                for i, c in enumerate(child):
                    cls = type(c).__name__
                    if (cls == "GNBlock"
                            and type(m).__name__ != "EncodeProcessDecode"):
                        walk(c, f"{torch_prefix}{name}.{i}.", flax_prefix, i)
                    else:
                        walk(c, f"{torch_prefix}{name}.{i}.",
                             f"{flax_prefix}{cls}_{i}/")
                continue
            if name == "encoder":
                flax = type(child).__name__ + "_0"
            elif name in ("cell_block", "face_block"):
                flax = ("CellBlock" if name == "cell_block"
                        else "FaceBlock") + f"_{block}"
            else:
                flax = next((p.sub(repl, name) for p, repl in _FLAX_NAMES
                             if p.match(name)), name)
            walk(child, f"{torch_prefix}{name}.", f"{flax_prefix}{flax}/")

    walk(module, "", "")
    return out
