"""StreamFunc family (counterpart of ``models/streamfunc.py``; reference
``src/models/StreamFunc.py``): MGN's cell decoder predicts a scalar stream
function psi and the pressure; the velocity is the rotated MLS gradient of
psi, divergence-free by construction (``DivergenceLayer``,
StreamFunc.py:93-106).

========  ====================================================================
SFA       psi -> velocity in normalized space, on MgnC (StreamFunc.py:109-135)
SFB       psi denormalized first, then the curl, normalized again for the
          loss (138-167)
SFC       no normalization in the forward pass, on MgnB (170-192)
SFD       SFB + kNN smoothing of psi and a Laplacian smoothness term
          (195-287)
========  ====================================================================

All four run MGN's face-first GN blocks with a 2-channel cell decoder, so on
the kernel route the fused face-first blocks (K1 with both outputs -> K3 ->
K2 single). Their rollout feedback clamps the INFLOW and WALL faces, where
MGN's clamps its full boundary mask.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from gnn_fluid_dynamics_tpu_torch.models import normalizer as norm
from gnn_fluid_dynamics_tpu_torch.models.base import FluidModel
from gnn_fluid_dynamics_tpu_torch.parallel.halo import reduce_sums, refresh
from gnn_fluid_dynamics_tpu_torch.models.losses import (combined_log_loss,
                                                        mse_per_element)
from gnn_fluid_dynamics_tpu_torch.models.mgn import MgnB, MgnC, _MgnModule
from gnn_fluid_dynamics_tpu_torch.ops import fvm


def divergence_layer(cell_potential: torch.Tensor, weights: torch.Tensor,
                     neighbours: torch.Tensor) -> torch.Tensor:
    """velocity = rotate90(MLS grad psi) = (-dpsi/dy, +dpsi/dx)
    (reference ``DivergenceLayer``, StreamFunc.py:93-106).
    cell_potential: (C,) or (C, 1), weights: (C, K, 2), neighbours: (C, K)
    -> (C, 2)."""
    psi = cell_potential.reshape(-1)
    diff = psi[neighbours.long()] - psi[:, None]
    gx = torch.sum(weights[:, :, 0] * diff, dim=1)
    gy = torch.sum(weights[:, :, 1] * diff, dim=1)
    return torch.stack([-gy, gx], dim=1)


def smoothing_layer(potential: torch.Tensor, neighbours: torch.Tensor,
                    k: int = 8) -> torch.Tensor:
    """kNN mean of psi over ``neighbours[:, :k]`` (reference
    ``SmoothingLayer``, StreamFunc.py:277-287): a mean over however many
    columns the stencil has up to k (6 for order-1 MLS weights), not
    padded to k."""
    psi = potential.reshape(-1)
    return torch.mean(psi[neighbours[:, :k].long()], dim=1)


def _masked(graph, v: torch.Tensor) -> torch.Tensor:
    return torch.where(graph.cell_mask[:, None], v, torch.zeros_like(v))


class _StreamFuncRolloutMixin:
    """Rollout feedback of ``BaseStreamFunc.update_features``
    (StreamFunc.py:77-91): the INFLOW|WALL faces clamped, not MGN's full
    boundary mask (Mgn.py:147), so OUTFLOW faces keep the predicted Δv.
    That is the base class's feedback."""

    update_features = FluidModel.update_features


class StreamFuncA(_StreamFuncRolloutMixin, MgnC):
    """psi -> the perpendicular-gradient velocity in normalized space
    (StreamFunc.py:109-135)."""

    name = "StreamFuncA"
    cell_grad_weights_use = True

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _MgnModule(self.arch, face_in=5 + self.config.num_face_types,
                          out_size=2, generator=generator)   # [psi, p]

    def _curl(self, cell_out, graph):
        v = divergence_layer(cell_out[:, 0], graph.cell_grad_weights,
                             graph.cell_grad_neighbours)
        return torch.cat([_masked(graph, v), cell_out[:, 1:2]], dim=1)

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        cell_out = self.module(nfeats["cell_x"], nfeats["face_x"], graph,
                               mode == "train", generator)
        bundle = {"cell_out": self._curl(cell_out, graph)}
        if mode == "rollout":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats,
                                            inverse=True)
        return {"cell_velocity": bundle["cell_out"][:, 0:2],
                "cell_pressure": bundle["cell_out"][:, 2:3],
                "_nfeats": nfeats}

    def loss(self, outputs, feats, graph) -> Dict[str, torch.Tensor]:
        """The velocity and pressure terms; continuity (the MLS divergence)
        is reported but not weighted (StreamFunc.py:45-75)."""
        nfeats = outputs["_nfeats"]
        cmask = graph.cell_mask
        # the stencil reads the velocity of the neighbours, whose curl reads
        # theirs: on a space-sharded graph a ghost's comes from its owner
        div = fvm.divergence_from_uc(refresh(outputs["cell_velocity"], graph,
                                             "cell"),
                                     graph.cell_grad_weights,
                                     graph.cell_grad_neighbours,
                                     graph.cell_volume)
        div = _masked(graph, div)
        continuity = mse_per_element(div, torch.zeros_like(div), cmask)
        comps = {
            "cell_velocity": mse_per_element(
                outputs["cell_velocity"], nfeats["cell_y"][:, 0:2], cmask),
            "cell_pressure": mse_per_element(
                outputs["cell_pressure"], nfeats["cell_y"][:, 2:3], cmask),
        }
        total = combined_log_loss(comps, self.loss_weights)
        return {"total_log_loss": total, "continuity_loss": continuity,
                **{f"{k}_loss": v for k, v in comps.items()}}


class StreamFuncB(StreamFuncA):
    """psi denormalized before the curl; the outputs normalized again in
    train mode (StreamFunc.py:138-167)."""

    name = "StreamFuncB"

    def _potential(self, cell_out, graph):
        """The psi column the curl takes (StreamFuncD smooths it)."""
        return cell_out[:, 0:1]

    def _physical(self, cell_out, graph, mode):
        """[psi, p] -> [psi, 0, p] denormalized (psi rides the velocity-x
        statistics, a reference quirk kept as it is), then the curl; the
        result normalized in train mode."""
        psi = self._potential(cell_out, graph)
        expanded = torch.cat([psi, torch.zeros_like(psi), cell_out[:, 1:2]],
                             dim=1)
        phys = norm.normalize_outputs({"cell_out": expanded}, self.nmap,
                                      self.stats, inverse=True)["cell_out"]
        v = divergence_layer(phys[:, 0], graph.cell_grad_weights,
                             graph.cell_grad_neighbours)
        bundle = {"cell_out": torch.cat([_masked(graph, v), phys[:, 2:]],
                                        dim=1)}
        if mode == "train":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats)
        return bundle["cell_out"]

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        cell_out = self.module(nfeats["cell_x"], nfeats["face_x"], graph,
                               mode == "train", generator)
        out = self._physical(cell_out, graph, mode)
        return {"cell_velocity": out[:, 0:2], "cell_pressure": out[:, 2:3],
                "_nfeats": nfeats}


class StreamFuncC(_StreamFuncRolloutMixin, MgnB):
    """No normalization in the forward pass: the module sees the raw
    features and the loss runs in physical units (StreamFunc.py:170-192)."""

    name = "StreamFuncC"
    cell_grad_weights_use = True

    build_module = StreamFuncA.build_module
    loss = StreamFuncA.loss

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        cell_out = self.module(feats["cell_x"], feats["face_x"], graph,
                               mode == "train", generator)
        v = divergence_layer(cell_out[:, 0], graph.cell_grad_weights,
                             graph.cell_grad_neighbours)
        return {"cell_velocity": _masked(graph, v),
                "cell_pressure": cell_out[:, 1:2],
                "_nfeats": feats}


class StreamFuncD(StreamFuncB):
    """StreamFuncB with psi smoothed by its kNN mean before the curl, and a
    Laplacian smoothness term on the raw psi in the loss
    (StreamFunc.py:195-287)."""

    name = "StreamFuncD"

    def _potential(self, cell_out, graph):
        return refresh(smoothing_layer(cell_out[:, 0:1],
                                       graph.cell_grad_neighbours, k=8)[:, None],
                       graph, "cell")

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        cell_out = self.module(nfeats["cell_x"], nfeats["face_x"], graph,
                               mode == "train", generator)
        out = self._physical(cell_out, graph, mode)
        return {"cell_velocity": out[:, 0:2], "cell_pressure": out[:, 2:3],
                "cell_potential": cell_out[:, 0:1], "_nfeats": nfeats}

    def loss(self, outputs, feats, graph) -> Dict[str, torch.Tensor]:
        """StreamFuncA's terms + 0.1 x the mean square of psi's 4-neighbour
        Laplacian over live cells, the total's log taken again
        (StreamFunc.py:237-275)."""
        losses = StreamFuncA.loss(self, outputs, feats, graph)
        psi = outputs["cell_potential"].reshape(-1)
        nb = graph.cell_grad_neighbours[:, :4].long()
        lap = torch.mean(psi[nb], dim=1) - psi
        lap = torch.where(graph.cell_mask, lap, torch.zeros_like(lap))
        total_sq, n = reduce_sums(torch.sum(lap ** 2),
                                  torch.sum(graph.cell_mask))
        smooth = total_sq / torch.clamp(n, min=1)
        w = self.loss_weights
        total = (w.get("cell_velocity", 0.0) * losses["cell_velocity_loss"]
                 + w.get("cell_pressure", 0.0) * losses["cell_pressure_loss"]
                 + 0.1 * smooth)
        losses["total_log_loss"] = torch.mean(torch.log(total))
        losses["potential_smoothness_loss"] = smooth
        return losses
