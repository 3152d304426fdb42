"""The model protocol (counterpart of ``models/base.py``): feature
transformation (rollout and train modes), the forward pass, the loss, state
derivation and the autoregressive feedback. Each model family owns a config,
an ``nn.Module`` (``.module``), a normalization map, the dataset statistics
and the loss weights.

Where the JAX package keeps parameters and batch statistics outside the
model and returns the statistics' update from ``forward``, here they live in
``.module``: a train-mode forward updates the BatchNorms' running statistics
in place, and the random draws (noise, edge flip, dropout) come from a
``torch.Generator`` the caller passes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from gnn_fluid_dynamics_tpu_torch import resolve_device
from gnn_fluid_dynamics_tpu_torch.models import normalizer as norm
from gnn_fluid_dynamics_tpu_torch.models.arch import ArchConfig, gather3
from gnn_fluid_dynamics_tpu_torch.models.transforms import (
    calc_face_velocity_change, rollout_bc_mask)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model section of the experiment config (reference ``config.py:125-137``)."""
    name: str = "FluxD"
    hidden_width: int = 128
    mp_num: int = 15
    aggregation: str = "auto"         # arch.py AGGREGATIONS: "segment" |
    #                                   "pallas" | "auto" | "banded" | "gather"
    num_face_types: int = 5
    compute_dtype: str = "float32"    # "bfloat16" for the MLP stack
    # temporal bundling (FvgnC): the decoder emits this many steps per
    # forward, and the rollout takes num_steps // bundle_size forwards
    bundle_size: Optional[int] = None
    # learned-scale denorm initialization (FluxD): None = the reference's
    # shipped constants; "stats" = per-channel target std from the dataset
    # statistics; or {velocity_x, velocity_y, pressure, flux, diffusion} ->
    # float given as a tuple of pairs
    scale_init: Optional[object] = None
    dropout_rate: float = 0.0         # MLP dropout in train mode
    remat: bool = False               # recompute GN blocks in the backward pass
    # channels whose gradient is stopped inside FluxD's physical integrator
    # ("pressure", "velocity", "flux"): the supervised heads then learn only
    # from their own losses. () = the reference's behavior
    integrator_detach: Tuple[str, ...] = ()
    # override the class's pushforward flag (None = the class default)
    pushforward: Optional[bool] = None


class FluidModel:
    """Base class; subclasses implement the family-specific hooks.

    The module's weights are drawn at construction from ``seed`` (on the CPU,
    so every device gets the same weights) and moved to ``device``, which
    defaults to the card and raises when there is none. ``loss_weights``
    weigh the loss components (``training.loss_weights``)."""

    name = "base"
    pushforward_use = False           # reference Model.py: FvgnD's flag
    cell_grad_weights_use = False     # the dataset adds MLS weights
    face_grad_weights_use = False     # (reference Model.py:53)

    def __init__(self, config: ModelConfig, stats: Optional[Dict] = None,
                 device="cuda", seed: int = 0,
                 loss_weights: Optional[Dict[str, float]] = None):
        self.config = config
        self.device = resolve_device(device)
        if config.pushforward is not None:
            # shadow the class attribute on the instance
            self.pushforward_use = bool(config.pushforward)
        self.arch = ArchConfig(hidden=config.hidden_width, mp_num=config.mp_num,
                               aggregation=config.aggregation,
                               compute_dtype=config.compute_dtype,
                               block_order=self.block_order(),
                               share_blocks=self.share_blocks(),
                               step_scalar=self.step_scalar(),
                               dropout_rate=config.dropout_rate,
                               remat=config.remat)
        self.nmap = self.normalisation_map()
        self.loss_weights = dict(loss_weights or {})
        self.stats = None
        if stats is not None:
            self.stats = norm.stats_to_tensors(stats, self.device)
        generator = torch.Generator().manual_seed(seed)
        self.module = self.build_module(generator).to(self.device).eval()

    # ---- architecture hooks -------------------------------------------------
    def block_order(self) -> str:
        return "cell_first"

    def share_blocks(self) -> bool:
        return False

    def step_scalar(self) -> bool:
        return False

    def build_module(self, generator: torch.Generator) -> torch.nn.Module:
        raise NotImplementedError

    def normalisation_map(self) -> norm.NormalizationMap:
        raise NotImplementedError

    def set_stats(self, stats: Dict):
        self.stats = norm.stats_to_tensors(stats, self.device)

    def transform_features(self, graph, generator: torch.Generator = None,
                           mode: str = "rollout", noise_std: float = 0.0):
        """(graph, feats). Only ``mode="train"`` with a ``generator`` adds
        noise (given ``noise_std``) and flips edges; without a generator
        train mode adds neither."""
        raise NotImplementedError

    def transform_rollout(self, graph):
        """Rollout-mode features of ``graph``: (graph, feats)."""
        return self.transform_features(graph)

    def module_inputs(self, nfeats: Dict) -> tuple:
        """The normalized feature tensors the module takes before the graph
        (the Conservative family's split symmetric and antisymmetric face
        features replace ``face_x``)."""
        return (nfeats["cell_x"], nfeats["face_x"])

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """The outputs for normalized inputs; in ``"rollout"`` mode in
        physical units, in any other mode in the normalized space the loss
        compares in (the normalized inputs under ``"_nfeats"``). ``"train"``
        runs the module in train mode, its dropout drawing from
        ``generator``."""
        raise NotImplementedError

    def loss(self, outputs: Dict, feats: Dict, graph
             ) -> Dict[str, torch.Tensor]:
        """``total_log_loss`` and each ``<component>_loss``."""
        raise NotImplementedError

    def count_parameters(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    def derive_state(self, outputs: Dict, feats: Dict, graph
                     ) -> Dict[str, torch.Tensor]:
        """Physical state for the error metrics: ``cell_velocity`` (+= the
        predicted change) and ``cell_pressure`` (mean of the 3 face
        pressures) — reference ``rollout.py:337-346``."""
        sol = dict(outputs)
        sol.pop("_nfeats", None)
        if "cell_velocity" not in sol and "cell_velocity_change" in sol:
            sol["cell_velocity"] = (feats["cell_x"][:, 0:2]
                                    + sol["cell_velocity_change"])
        if "cell_pressure" not in sol and "face_pressure" in sol:
            fp = sol["face_pressure"].reshape(-1, 1)
            sol["cell_pressure"] = torch.mean(gather3(fp, graph), dim=1)
        return sol

    def update_features(self, solutions: Dict, feats: Dict, graph
                        ) -> Dict[str, torch.Tensor]:
        """Autoregressive feedback (reference ``Fvgn.py:133-148``): the new
        cell velocity in, face Δv recomputed with INFLOW/WALL faces clamped to
        the (initial) BC targets."""
        new_feats = dict(feats)
        v = solutions["cell_velocity"]
        new_feats["cell_x"] = v
        dv = calc_face_velocity_change(v[:, :2], graph.cell_edge_index)
        mask = rollout_bc_mask(graph.face_type)
        dv = torch.where(mask[:, None], feats["face_y"][:, 0:2], dv)
        new_feats["face_x"] = torch.cat([dv, feats["face_x"][:, 2:]], dim=1)
        return new_feats


def feature_masks(graph, feats: Dict) -> Dict:
    """Validity masks per bundle tensor, for stats accumulation."""
    out = {}
    for key in feats:
        if key.startswith("cell"):
            out[key] = graph.cell_mask
        elif key.startswith("face"):
            out[key] = graph.face_mask
    return out
