"""Flux model family (counterpart of ``models/flux.py``): FluxA's features,
normalization and loss, and FluxD — the reference's shipped model — whose
rollout and training this package runs.

FluxD: encode-process-decode -> learned per-channel scale denormalization ->
the physical flux integrator (Flux.py:459-595). Its outputs are physical;
outside rollout mode they are normalized for the loss.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from gnn_fluid_dynamics_tpu_torch.models import normalizer as norm
from gnn_fluid_dynamics_tpu_torch.models.arch import (ArchConfig,
                                                      EncodeProcessDecode,
                                                      LearnedScaleDenorm,
                                                      gather3)
from gnn_fluid_dynamics_tpu_torch.models.fvgn import FvgnA, _f, _z
from gnn_fluid_dynamics_tpu_torch.models.losses import (combined_log_loss,
                                                        mse_per_element,
                                                        rel_mse_per_graph)
from gnn_fluid_dynamics_tpu_torch.models.transforms import standard_face_features
from gnn_fluid_dynamics_tpu_torch.ops import fvm


class FluxA(FvgnA):
    """Joint velocity+flux prediction (Flux.py:28-206): the features and the
    normalization map FluxD inherits. FluxA's own module (the flux
    integrator with BatchNorm'd face weights) is not ported yet, so FluxA
    itself cannot be built."""

    name = "FluxA"

    def build_module(self, generator: torch.Generator) -> nn.Module:
        raise NotImplementedError(
            "FluxA's own module (FluxIntegrator) is not ported yet; FluxD is")

    def normalisation_map(self) -> norm.NormalizationMap:
        nmap = super().normalisation_map()
        registry = dict(nmap.registry)
        registry["face_flux"] = _z("face_y", 3, 4)
        inputs = nmap.inputs + (_f("face_flux", "face_y", 3, 4),)
        outputs = nmap.outputs + (_f("face_flux", "face_out", 3, 4),)
        return norm.NormalizationMap(registry, inputs, outputs)

    def transform_features(self, graph, generator: torch.Generator = None,
                           mode: str = "rollout", noise_std: float = 0.0):
        """Features (Flux.py:60-87): no BC override on the face Δv; the edge
        flip of train mode also flips ``face_flux``, so the flux target
        follows its face's new orientation."""
        graph, cell_velocity, cell_y = self._input_state(graph, generator,
                                                         mode, noise_std)
        face_x, bc_mask = standard_face_features(
            graph, cell_velocity, self.config.num_face_types, bc_velocity=None)
        face_y = torch.cat([graph.face_velocity[:, -1],
                            graph.face_pressure[:, -1],
                            graph.face_flux[:, -1]], dim=1)
        feats = {"cell_x": cell_velocity, "cell_y": cell_y,
                 "face_x": face_x, "face_y": face_y, "face_bc_mask": bc_mask}
        return graph, feats

    def loss(self, outputs, feats, graph) -> Dict[str, torch.Tensor]:
        """The five-term log loss in normalized space (Flux.py:118-156):
        continuity from the signed cell flux, Δv, the face velocity off the
        INFLOW faces, the face flux, the face pressure; with a
        ``face_pressure_rel`` weight also the per-graph relative MSE of the
        raw pressure, averaged over ``num_graphs`` (padded graphs included,
        as in the JAX package)."""
        nfeats = outputs["_nfeats"]
        cmask, fmask = graph.cell_mask, graph.face_mask
        div = fvm.divergence_from_cell_flux(outputs["cell_flux"])
        comps = {
            "continuity": mse_per_element(div, torch.zeros_like(div), cmask),
            "cell_velocity_change": mse_per_element(
                outputs["cell_velocity_change"], nfeats["cell_y"], cmask),
            "face_velocity": mse_per_element(
                outputs["face_velocity"], nfeats["face_y"][:, :2],
                fmask & ~feats["face_bc_mask"]),
            "face_flux": mse_per_element(
                outputs["face_flux"], nfeats["face_y"][:, 3:4], fmask),
            "face_pressure": mse_per_element(
                outputs["face_pressure"], nfeats["face_y"][:, 2:3], fmask),
        }
        if self.loss_weights.get("face_pressure_rel"):
            p_raw = norm.z_score(outputs["face_pressure"],
                                 self.stats["face_pressure"], inverse=True)
            comps["face_pressure_rel"] = torch.mean(rel_mse_per_graph(
                p_raw, feats["face_y"][:, 2:3], fmask, graph.face_batch,
                graph.num_graphs))
        total = combined_log_loss(comps, self.loss_weights)
        return {"total_log_loss": total,
                **{f"{k}_loss": v for k, v in comps.items()}}


# the reference's shipped scale constants (Flux.py:465-469)
_FLUXD_SCALE_DEFAULTS = (("velocity_x", 0.1), ("velocity_y", 0.0001),
                         ("pressure", 0.01), ("flux", 0.001),
                         ("diffusion", 0.01))


class _FluxDModule(nn.Module):
    """EPD -> learned scale denorm -> physical flux integrator
    (Flux.py:477-515, 557-595). Returns (acc, face_out). The channels named
    in ``detach`` ("velocity", "pressure", "flux") enter the integrator
    detached from the graph (JAX's ``stop_gradient``)."""

    def __init__(self, cfg: ArchConfig, face_in: int, scale_inits: tuple,
                 generator: torch.Generator = None, rho: float = 1.0,
                 nu: float = 0.001, detach: tuple = ()):
        super().__init__()
        self.rho, self.nu = rho, nu
        self.detach = tuple(detach)
        self.epd = EncodeProcessDecode(cfg, cell_in=2, face_in=face_in,
                                       face_out=6, generator=generator)
        si = dict(scale_inits)
        self.velocity_scale_x = LearnedScaleDenorm(1, si["velocity_x"])
        self.velocity_scale_y = LearnedScaleDenorm(1, si["velocity_y"])
        self.pressure_scale = LearnedScaleDenorm(1, si["pressure"])
        self.flux_scale = LearnedScaleDenorm(1, si["flux"])
        self.diffusion_scale = LearnedScaleDenorm(2, si["diffusion"])

    def scales(self) -> Dict[str, LearnedScaleDenorm]:
        return {"velocity_x": self.velocity_scale_x,
                "velocity_y": self.velocity_scale_y,
                "pressure": self.pressure_scale, "flux": self.flux_scale,
                "diffusion": self.diffusion_scale}

    def forward(self, cell_x, face_x, graph, train: bool = False,
                rng: torch.Generator = None):
        _, raw = self.epd(cell_x, face_x, graph, train, rng)
        face_out = torch.cat([self.velocity_scale_x(raw[:, 0:1]),
                              self.velocity_scale_y(raw[:, 1:2]),
                              self.pressure_scale(raw[:, 2:3]),
                              self.flux_scale(raw[:, 3:4]),
                              self.diffusion_scale(raw[:, 4:6])], dim=-1)
        uv, pf, phi, flux_d = (face_out[:, :2], face_out[:, 2:3],
                               face_out[:, 3:4], face_out[:, 4:6])
        if "velocity" in self.detach:
            uv = uv.detach()
        if "pressure" in self.detach:
            pf = pf.detach()
        if "flux" in self.detach:
            phi = phi.detach()
        g = gather3(torch.cat([phi, uv, flux_d, graph.face_area.reshape(-1, 1),
                               pf], dim=1), graph)                 # (C, 3, 7)
        cell_flux = g[..., 0:1] * graph.cell_face_sign[..., None]
        uvf, fd, e, pf3 = g[..., 1:3], g[..., 3:5], g[..., 5:6], g[..., 6:7]
        phi_a = torch.sum(uvf * cell_flux, dim=1)
        phi_d = torch.sum(fd, dim=1)
        phi_p = torch.sum(pf3 * graph.cell_normal * e, dim=1)
        coeff = torch.mean(graph.dt) / torch.clamp(
            graph.cell_volume.reshape(-1, 1), min=1e-12)
        acc = coeff * (-phi_a - phi_p / self.rho + self.nu * phi_d)
        acc = torch.where(graph.cell_mask[:, None], acc, torch.zeros_like(acc))
        return acc, face_out


class FluxD(FluxA):
    """Physical integration with learned (adaptive) denorm — the reference's
    shipped training target (Flux.py:459-595). Its loss is FluxA's."""

    name = "FluxD"

    # which stat key provides each channel's std under scale_init="stats"
    _SCALE_STAT_KEYS = {"velocity_x": "face_velocity_x",
                        "velocity_y": "face_velocity_y",
                        "pressure": "face_pressure",
                        "flux": "face_flux"}

    def resolve_scale_inits(self) -> tuple:
        si = self.config.scale_init
        if si is None:
            return _FLUXD_SCALE_DEFAULTS
        if si == "stats":
            if self.stats is None:
                return _FLUXD_SCALE_DEFAULTS   # set again by set_stats
            out = []
            for key, default in _FLUXD_SCALE_DEFAULTS:
                stat = self._SCALE_STAT_KEYS.get(key)
                val = (float(self.stats[stat]["std"])
                       if stat and stat in self.stats else default)
                out.append((key, val))
            return tuple(out)
        merged = dict(_FLUXD_SCALE_DEFAULTS)
        merged.update(dict(si))
        return tuple(sorted(merged.items()))

    def build_module(self, generator: torch.Generator) -> _FluxDModule:
        return _FluxDModule(self.arch, face_in=5 + self.config.num_face_types,
                            scale_inits=self.resolve_scale_inits(),
                            generator=generator,
                            detach=tuple(self.config.integrator_detach or ()))

    def set_stats(self, stats: Dict):
        """Store the dataset statistics. Under ``scale_init="stats"`` this
        also re-initializes the learned scales to the statistics' std, as the
        JAX package's ``set_stats`` + ``init`` does; load trained weights
        after it."""
        super().set_stats(stats)
        if self.config.scale_init == "stats":
            inits = dict(self.resolve_scale_inits())
            with torch.no_grad():
                for key, mod in self.module.scales().items():
                    mod.scale.fill_(inits[key])

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """One step's outputs: physical in rollout mode, normalized by the
        output statistics in any other mode (Flux.py:517-555)."""
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        acc, face_out = self.module(nfeats["cell_x"], nfeats["face_x"], graph,
                                    mode == "train", generator)
        bundle = {"cell_out": acc, "face_out": face_out}
        if mode != "rollout":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats)
        acc, face_out = bundle["cell_out"], bundle["face_out"]
        cell_flux = fvm.face_flux_to_cell_flux_g(face_out[:, 3:4], graph)
        return {
            "cell_velocity_change": acc[:, 0:2],
            "face_velocity": face_out[:, 0:2],
            "face_pressure": face_out[:, 2:3],
            "face_flux": face_out[:, 3:4],
            "cell_flux": cell_flux[..., 0],
            "_nfeats": nfeats,
        }
