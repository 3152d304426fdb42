"""FVGN family (counterpart of ``models/fvgn.py``): the canonical FvgnA's
rollout and FvgnF, its weight-shared variant with a step scalar. The other
variants come in later slices.

FvgnA: encode-process-decode (5 face outputs) -> the normalized-space FVGN
integrator; the outputs are z-scored and mapped back to physical units by
the dataset statistics.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from gnn_fluid_dynamics_tpu_torch.models import normalizer as norm
from gnn_fluid_dynamics_tpu_torch.models.arch import (ArchConfig,
                                                      EncodeProcessDecode,
                                                      FvgnIntegrator)
from gnn_fluid_dynamics_tpu_torch.models.base import FluidModel
from gnn_fluid_dynamics_tpu_torch.models.transforms import standard_face_features


def _z(tensor, s, e):
    return norm.StatSpec("z_score", (tensor, s, e))


def _f(name, tensor, s, e, stat_key=None):
    return norm.Field(name, tensor, s, e, stat_key or name)


class _FvgnAModule(nn.Module):
    """EPD + normalized integrator (Flax ``_FvgnAModule``). Returns (acc,
    face_out, extras)."""

    def __init__(self, cfg: ArchConfig, face_in: int, out_size: int = 5,
                 generator: torch.Generator = None):
        super().__init__()
        self.epd = EncodeProcessDecode(cfg, cell_in=2, face_in=face_in,
                                       face_out=out_size, generator=generator)
        self.integrator = FvgnIntegrator()

    def forward(self, cell_x, face_x, graph):
        face_out = self.epd(cell_x, face_x, graph)
        acc, extras = self.integrator(face_out, graph)
        return acc, face_out, extras


class FvgnA(FluidModel):
    """Canonical FVGN: the decoder predicts [u_f, v_f, p_f, D_x, D_y] per
    face; the integrator turns them into the cell acceleration
    (Fvgn.py:31-333)."""

    name = "FvgnA"
    face_out_size = 5

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _FvgnAModule(self.arch, face_in=5 + self.config.num_face_types,
                            out_size=self.face_out_size, generator=generator)

    def normalisation_map(self) -> norm.NormalizationMap:
        registry = {
            "cell_velocity_x": _z("cell_x", 0, 1),
            "cell_velocity_y": _z("cell_x", 1, 2),
            "cell_velocity_change_x": _z("cell_y", 0, 1),
            "cell_velocity_change_y": _z("cell_y", 1, 2),
            "face_velocity_difference_x": _z("face_x", 0, 1),
            "face_velocity_difference_y": _z("face_x", 1, 2),
            "face_edge_vector_x": _z("face_x", 2, 3),
            "face_edge_vector_y": _z("face_x", 3, 4),
            "face_area": _z("face_x", 4, 5),
            "face_velocity_x": _z("face_y", 0, 1),
            "face_velocity_y": _z("face_y", 1, 2),
            "face_pressure": _z("face_y", 2, 3),
        }
        inputs = tuple(_f(k, *registry[k].extractor) for k in registry)
        outputs = (
            _f("cell_velocity_change_x", "cell_out", 0, 1),
            _f("cell_velocity_change_y", "cell_out", 1, 2),
            _f("face_velocity_x", "face_out", 0, 1),
            _f("face_velocity_y", "face_out", 1, 2),
            _f("face_pressure", "face_out", 2, 3),
        )
        return norm.NormalizationMap(registry, inputs, outputs)

    def transform_features(self, graph):
        """Rollout-mode features (Fvgn.py:101-131; no noise, no edge flip):
        the INFLOW faces' Δv is the t0 face velocity."""
        cell_velocity = graph.cell_velocity[:, 0]
        cell_y = graph.cell_velocity[:, -1] - cell_velocity
        face_x, bc_mask = standard_face_features(
            graph, cell_velocity, self.config.num_face_types,
            bc_velocity=graph.face_velocity[:, 0])
        face_y = torch.cat([graph.face_velocity[:, -1],
                            graph.face_pressure[:, -1]], dim=1)
        feats = {"cell_x": cell_velocity, "cell_y": cell_y,
                 "face_x": face_x, "face_y": face_y, "face_bc_mask": bc_mask}
        return graph, feats

    def forward(self, graph, feats: Dict) -> Dict[str, torch.Tensor]:
        """One rollout step's outputs, mapped back to physical units
        (Fvgn.py:150-174)."""
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        acc, face_out, extras = self.module(nfeats["cell_x"], nfeats["face_x"],
                                            graph)
        bundle = norm.normalize_outputs({"cell_out": acc, "face_out": face_out},
                                        self.nmap, self.stats, inverse=True)
        return {
            "cell_velocity_change": bundle["cell_out"][:, 0:2],
            "face_velocity": bundle["face_out"][:, 0:2],
            "face_pressure": bundle["face_out"][:, 2:3],
            "_nfeats": nfeats,
            **{f"_{k}": v for k, v in extras.items()},
        }


class FvgnF(FvgnA):
    """Weight-shared single GN block applied mp_num times with a normalized
    step scalar appended to both block inputs (Fvgn.py:883-1010)."""

    name = "FvgnF"

    def share_blocks(self) -> bool:
        return True

    def step_scalar(self) -> bool:
        return True
