"""FVGN family (counterpart of ``models/fvgn.py``): the canonical FvgnA
(rollout and training) and FvgnF, its weight-shared variant with a step
scalar. The other variants come in later slices.

FvgnA: encode-process-decode (5 face outputs) -> the normalized-space FVGN
integrator; the outputs are z-scored and mapped back to physical units by
the dataset statistics.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from gnn_fluid_dynamics_tpu_torch.models import normalizer as norm
from gnn_fluid_dynamics_tpu_torch.models import transforms as T
from gnn_fluid_dynamics_tpu_torch.models.arch import (ArchConfig,
                                                      EncodeProcessDecode,
                                                      FvgnIntegrator)
from gnn_fluid_dynamics_tpu_torch.models.base import FluidModel
from gnn_fluid_dynamics_tpu_torch.models.losses import (combined_log_loss,
                                                        mse_per_element)
from gnn_fluid_dynamics_tpu_torch.ops import fvm


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

    def forward(self, cell_x, face_x, graph, train: bool = False,
                rng: torch.Generator = None):
        _, face_out = self.epd(cell_x, face_x, graph, train, rng)
        acc, extras = self.integrator(face_out, graph, train)
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

    def _input_state(self, graph, generator, mode, noise_std):
        """The t0 cell velocity (noised in train mode), the Δv target, and
        the graph (its edges flipped in train mode): the part of
        ``transform_features`` FluxA shares (Fvgn.py:101-116)."""
        cell_velocity = graph.cell_velocity[:, 0]
        train = mode == "train" and generator is not None
        if train and noise_std:
            cell_velocity = T.add_noise(generator, cell_velocity, noise_std)
        if self.pushforward_use and graph.cell_velocity.shape[1] > 2:
            # pushforward window: the supervised target is rebuilt after the
            # no-grad unroll (trainer.pushforward_retarget); here cell_y only
            # feeds the Δv statistics, which the reference pins to the LAST
            # single step of the window (Fvgn.py:833-835)
            cell_y = graph.cell_velocity[:, -1] - graph.cell_velocity[:, -2]
        else:
            cell_y = graph.cell_velocity[:, -1] - cell_velocity
        if train:
            graph, _ = T.random_edge_flip(generator, graph)
        return graph, cell_velocity, cell_y

    def transform_features(self, graph, generator: torch.Generator = None,
                           mode: str = "rollout", noise_std: float = 0.0):
        """Features (Fvgn.py:101-131): the INFLOW faces' Δv is the t0 face
        velocity. Train mode with a generator adds the noise and the edge
        flip."""
        graph, cell_velocity, cell_y = self._input_state(graph, generator,
                                                         mode, noise_std)
        face_x, bc_mask = T.standard_face_features(
            graph, cell_velocity, self.config.num_face_types,
            bc_velocity=graph.face_velocity[:, 0])
        face_y = torch.cat([graph.face_velocity[:, -1],
                            graph.face_pressure[:, -1]], dim=1)
        feats = {"cell_x": cell_velocity, "cell_y": cell_y,
                 "face_x": face_x, "face_y": face_y, "face_bc_mask": bc_mask}
        return graph, feats

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """One step's outputs, mapped back to physical units in rollout mode
        only (Fvgn.py:150-174)."""
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        acc, face_out, extras = self.module(nfeats["cell_x"], nfeats["face_x"],
                                            graph, mode == "train", generator)
        bundle = {"cell_out": acc, "face_out": face_out}
        if mode == "rollout":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats,
                                            inverse=True)
        return {
            "cell_velocity_change": bundle["cell_out"][:, 0:2],
            "face_velocity": bundle["face_out"][:, 0:2],
            "face_pressure": bundle["face_out"][:, 2:3],
            "_nfeats": nfeats,
            **{f"_{k}": v for k, v in extras.items()},
        }

    def loss(self, outputs, feats, graph) -> Dict[str, torch.Tensor]:
        """The four-term log loss in normalized space (Fvgn.py:176-212):
        continuity of the predicted face velocity with the BatchNorm'd face
        area, Δv, the face velocity off the INFLOW faces, the face
        pressure."""
        nfeats = outputs["_nfeats"]
        cmask, fmask = graph.cell_mask, graph.face_mask
        div = fvm.divergence_from_uf(outputs["face_velocity"], graph.cell_normal,
                                     outputs["_norm_face_area"],
                                     graph.face_index)
        comps = {
            "continuity": mse_per_element(div, torch.zeros_like(div), cmask),
            "cell_velocity_change": mse_per_element(
                outputs["cell_velocity_change"], nfeats["cell_y"], cmask),
            "face_velocity": mse_per_element(
                outputs["face_velocity"], nfeats["face_y"][:, :2],
                fmask & ~feats["face_bc_mask"]),
            "face_pressure": mse_per_element(
                outputs["face_pressure"], nfeats["face_y"][:, 2:3], fmask),
        }
        total = combined_log_loss(comps, self.loss_weights)
        return {"total_log_loss": total,
                **{f"{k}_loss": v for k, v in comps.items()}}


class FvgnF(FvgnA):
    """Weight-shared single GN block applied mp_num times with a normalized
    step scalar appended to both block inputs (Fvgn.py:883-1010)."""

    name = "FvgnF"

    def share_blocks(self) -> bool:
        return True

    def step_scalar(self) -> bool:
        return True
