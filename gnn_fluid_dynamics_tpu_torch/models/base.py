"""The model protocol (counterpart of ``models/base.py``), for what the
rollout runs: feature transformation, the forward pass, state derivation and
the autoregressive feedback. Each model family owns a config, an
``nn.Module`` (``.module``), a normalization map and the dataset statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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
    # learned-scale denorm initialization (FluxD): None = the reference's
    # shipped constants; "stats" = per-channel target std from the dataset
    # statistics; or {velocity_x, velocity_y, pressure, flux, diffusion} ->
    # float given as a tuple of pairs
    scale_init: Optional[object] = None


class FluidModel:
    """Base class; subclasses implement the family-specific hooks.

    The module's weights are drawn at construction from ``seed`` (on the CPU,
    so every device gets the same weights) and moved to ``device``, which
    defaults to the card and raises when there is none."""

    name = "base"

    def __init__(self, config: ModelConfig, stats: Optional[Dict] = None,
                 device="cuda", seed: int = 0):
        self.config = config
        self.device = resolve_device(device)
        self.arch = ArchConfig(hidden=config.hidden_width, mp_num=config.mp_num,
                               aggregation=config.aggregation,
                               compute_dtype=config.compute_dtype,
                               share_blocks=self.share_blocks(),
                               step_scalar=self.step_scalar())
        self.nmap = self.normalisation_map()
        self.stats = None
        if stats is not None:
            self.stats = norm.stats_to_tensors(stats, self.device)
        generator = torch.Generator().manual_seed(seed)
        self.module = self.build_module(generator).to(self.device).eval()

    # ---- architecture hooks -------------------------------------------------
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

    def transform_features(self, graph):
        raise NotImplementedError

    def transform_rollout(self, graph):
        """Rollout-mode features of ``graph``: (graph, feats)."""
        return self.transform_features(graph)

    def forward(self, graph, feats: Dict) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

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
