"""MGN family (counterpart of ``models/mgn.py``; reference
``src/models/Mgn.py``): MeshGraphNets' encode-process-decode on cells, with
face-first GN blocks (Mgn.py:216-226) and a cell decoder that predicts the
state directly, no integrator.

========  ====================================================================
MgnA      predicts [Δu, Δv, p] on cells; losses on Δv and p (Mgn.py:40-275)
MgnB      direct velocity prediction + the MLS continuity loss
          (Mgn.py:278-391)
MgnC      MgnB with the velocities scaled by the characteristic |v|
          (``mean_scale``, Mgn.py:394-424)
========  ====================================================================

All three ask the dataset for MLS cell gradient weights
(``cell_grad_weights_use``): the rollout's divergence metric reads them, and
MgnB's loss.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from gnn_fluid_dynamics_tpu_torch.models import normalizer as norm
from gnn_fluid_dynamics_tpu_torch.models import transforms as T
from gnn_fluid_dynamics_tpu_torch.models.arch import (ArchConfig,
                                                      EncodeProcessDecode)
from gnn_fluid_dynamics_tpu_torch.models.base import FluidModel
from gnn_fluid_dynamics_tpu_torch.models.fvgn import _f, _z
from gnn_fluid_dynamics_tpu_torch.models.losses import (combined_log_loss,
                                                        mse_per_element)
from gnn_fluid_dynamics_tpu_torch.ops import fvm


class _MgnModule(nn.Module):
    """EPD with the cell head only (Flax ``_MgnModule``). Returns the cell
    outputs (C, out_size)."""

    def __init__(self, cfg: ArchConfig, face_in: int, out_size: int = 3,
                 generator: torch.Generator = None):
        super().__init__()
        self.epd = EncodeProcessDecode(cfg, cell_in=2, face_in=face_in,
                                       cell_out=out_size, generator=generator)

    def forward(self, cell_x, face_x, graph, train: bool = False,
                rng: torch.Generator = None):
        cell_out, _ = self.epd(cell_x, face_x, graph, train, rng)
        return cell_out


class MgnA(FluidModel):
    """MGN predicting [Δu, Δv, p] on cells (Mgn.py:40-275)."""

    name = "MgnA"
    cell_grad_weights_use = True     # the rollout's divergence metric (Mgn.py:46)

    def block_order(self) -> str:
        return "face_first"

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _MgnModule(self.arch, face_in=5 + self.config.num_face_types,
                          out_size=3, generator=generator)

    def normalisation_map(self) -> norm.NormalizationMap:
        registry = {
            "cell_velocity_x": _z("cell_x", 0, 1),
            "cell_velocity_y": _z("cell_x", 1, 2),
            "cell_velocity_change_x": _z("cell_y", 0, 1),
            "cell_velocity_change_y": _z("cell_y", 1, 2),
            "cell_pressure": _z("cell_y", 2, 3),
            "face_velocity_difference_x": _z("face_x", 0, 1),
            "face_velocity_difference_y": _z("face_x", 1, 2),
            "face_edge_vector_x": _z("face_x", 2, 3),
            "face_edge_vector_y": _z("face_x", 3, 4),
            "face_area": _z("face_x", 4, 5),
        }
        inputs = (
            _f("cell_velocity_x", "cell_x", 0, 1),
            _f("cell_velocity_y", "cell_x", 1, 2),
            _f("face_velocity_difference_x", "face_x", 0, 1),
            _f("face_velocity_difference_y", "face_x", 1, 2),
            _f("face_edge_vector_x", "face_x", 2, 3),
            _f("face_edge_vector_y", "face_x", 3, 4),
            _f("face_area", "face_x", 4, 5),
            _f("cell_velocity_change_x", "cell_y", 0, 1),
            _f("cell_velocity_change_y", "cell_y", 1, 2),
            _f("cell_pressure", "cell_y", 2, 3),
            # the BC face velocities take the cell velocity's statistics
            # (Mgn.py:126-127)
            _f("face_velocity_x", "face_y", 0, 1, "cell_velocity_x"),
            _f("face_velocity_y", "face_y", 1, 2, "cell_velocity_y"),
        )
        outputs = (
            _f("cell_velocity_change_x", "cell_out", 0, 1),
            _f("cell_velocity_change_y", "cell_out", 1, 2),
            _f("cell_pressure", "cell_out", 2, 3),
        )
        return norm.NormalizationMap(registry, inputs, outputs)

    def transform_features(self, graph, generator: torch.Generator = None,
                           mode: str = "rollout", noise_std: float = 0.0):
        """Features (Mgn.py:64-95). Train mode with a generator adds the
        noise (given ``noise_std``) to the t0 cell velocity, then flips
        edges."""
        cell_velocity = graph.cell_velocity[:, 0]
        train = mode == "train" and generator is not None
        if train and noise_std:
            cell_velocity = T.add_noise(generator, cell_velocity, noise_std)
        if train:
            graph, _ = T.random_edge_flip(generator, graph)
        return graph, self.features(graph, cell_velocity)

    def features(self, graph, cell_velocity: torch.Tensor) -> Dict:
        """The feature bundle of ``graph`` (edges as they are) with the t0
        cell velocity ``cell_velocity``: the INFLOW faces' Δv is the t0 face
        velocity, the target [Δv, p] at the window's end, the face velocity
        there the BC target (Mgn.py:90)."""
        cell_y = torch.cat([graph.cell_velocity[:, -1] - cell_velocity,
                            graph.cell_pressure[:, -1]], dim=1)
        face_x, bc_mask = T.standard_face_features(
            graph, cell_velocity, self.config.num_face_types,
            bc_velocity=graph.face_velocity[:, 0])
        return {"cell_x": cell_velocity, "cell_y": cell_y, "face_x": face_x,
                "face_y": graph.face_velocity[:, -1], "face_bc_mask": bc_mask}

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """One step's outputs, mapped back to physical units in rollout mode
        only (Mgn.py:153-173)."""
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        cell_out = self.module(nfeats["cell_x"], nfeats["face_x"], graph,
                               mode == "train", generator)
        bundle = {"cell_out": cell_out}
        if mode == "rollout":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats,
                                            inverse=True)
        return {"cell_velocity_change": bundle["cell_out"][:, 0:2],
                "cell_pressure": bundle["cell_out"][:, 2:3],
                "_nfeats": nfeats}

    def loss(self, outputs, feats, graph) -> Dict[str, torch.Tensor]:
        """Δv and p in normalized space (Mgn.py:175-197)."""
        nfeats = outputs["_nfeats"]
        cmask = graph.cell_mask
        comps = {
            "cell_velocity_change": mse_per_element(
                outputs["cell_velocity_change"], nfeats["cell_y"][:, 0:2],
                cmask),
            "cell_pressure": mse_per_element(
                outputs["cell_pressure"], nfeats["cell_y"][:, 2:3], cmask),
        }
        total = combined_log_loss(comps, self.loss_weights)
        return {"total_log_loss": total,
                **{f"{k}_loss": v for k, v in comps.items()}}

    def update_features(self, solutions, feats, graph):
        """Rollout feedback (Mgn.py:139-151): the new cell velocity in, the
        face Δv recomputed with the INFLOW faces only clamped to their BC
        targets."""
        new_feats = dict(feats)
        v = solutions["cell_velocity"]
        new_feats["cell_x"] = v
        dv = T.calc_face_velocity_change(v[:, :2], graph.cell_edge_index)
        dv = torch.where(feats["face_bc_mask"][:, None],
                         feats["face_y"][:, 0:2], dv)
        new_feats["face_x"] = torch.cat([dv, feats["face_x"][:, 2:]], dim=1)
        return new_feats


class MgnB(MgnA):
    """Direct velocity prediction + the continuity (MLS divergence) loss
    (Mgn.py:278-391)."""

    name = "MgnB"

    def normalisation_map(self) -> norm.NormalizationMap:
        nmap = super().normalisation_map()
        change = ("cell_velocity_change_x", "cell_velocity_change_y")
        inputs = tuple(f for f in nmap.inputs if f.name not in change) + (
            _f("cell_velocity_target_x", "cell_y", 0, 1, "cell_velocity_x"),
            _f("cell_velocity_target_y", "cell_y", 1, 2, "cell_velocity_y"),
        )
        outputs = tuple(f for f in nmap.outputs if f.name not in change) + (
            _f("cell_velocity_x", "cell_out", 0, 1),
            _f("cell_velocity_y", "cell_out", 1, 2),
        )
        return nmap.replace(inputs=inputs, outputs=outputs)

    def features(self, graph, cell_velocity: torch.Tensor) -> Dict:
        """MgnA's, with the direct target [v, p] at the window's end
        (Mgn.py:287-316)."""
        feats = super().features(graph, cell_velocity)
        feats["cell_y"] = torch.cat([graph.cell_velocity[:, -1],
                                     graph.cell_pressure[:, -1]], dim=1)
        return feats

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        outputs = super().forward(graph, feats, mode, generator)
        outputs["cell_velocity"] = outputs.pop("cell_velocity_change")
        return outputs

    def loss(self, outputs, feats, graph) -> Dict[str, torch.Tensor]:
        """Continuity (the MLS divergence of the predicted velocity, in
        normalized space as the reference computes it), v and p."""
        nfeats = outputs["_nfeats"]
        cmask = graph.cell_mask
        div = fvm.divergence_from_uc(outputs["cell_velocity"],
                                     graph.cell_grad_weights,
                                     graph.cell_grad_neighbours,
                                     graph.cell_volume)
        div = torch.where(cmask[:, None], div, torch.zeros_like(div))
        comps = {
            "continuity": mse_per_element(div, torch.zeros_like(div), cmask),
            "cell_velocity": mse_per_element(
                outputs["cell_velocity"], nfeats["cell_y"][:, 0:2], cmask),
            "cell_pressure": mse_per_element(
                outputs["cell_pressure"], nfeats["cell_y"][:, 2:3], cmask),
        }
        total = combined_log_loss(comps, self.loss_weights)
        return {"total_log_loss": total,
                **{f"{k}_loss": v for k, v in comps.items()}}


class MgnC(MgnB):
    """MgnB with the velocity fields scaled by the dataset's characteristic
    |v|, the mean of the cells' velocity magnitude (Mgn.py:394-424)."""

    name = "MgnC"

    _SCALED = ("cell_velocity_x", "cell_velocity_y",
               "cell_velocity_target_x", "cell_velocity_target_y")

    def normalisation_map(self) -> norm.NormalizationMap:
        nmap = super().normalisation_map()
        registry = dict(nmap.registry)
        registry["cell_velocity_char"] = norm.StatSpec(
            "mean_scale", ("norm", "cell_x", 0, 2))

        def retarget(fields):
            return tuple(
                norm.Field(f.name, f.tensor, f.start, f.stop,
                           "cell_velocity_char")
                if f.name in self._SCALED else f for f in fields)

        return norm.NormalizationMap(registry, retarget(nmap.inputs),
                                     retarget(nmap.outputs))
