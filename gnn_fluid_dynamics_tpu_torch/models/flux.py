"""Flux model family (counterpart of ``models/flux.py``): FluxA's features and
normalization, and FluxD — the reference's shipped model — whose rollout is
this package's main path.

FluxD: encode-process-decode -> learned per-channel scale denormalization ->
the physical flux integrator (Flux.py:459-595). Its outputs are physical.
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

    def transform_features(self, graph):
        """Rollout-mode features (Flux.py:60-87; no noise, no edge flip, no
        BC override on the face Δv)."""
        cell_velocity = graph.cell_velocity[:, 0]
        cell_y = graph.cell_velocity[:, -1] - cell_velocity
        face_x, bc_mask = standard_face_features(
            graph, cell_velocity, self.config.num_face_types, bc_velocity=None)
        face_y = torch.cat([graph.face_velocity[:, -1],
                            graph.face_pressure[:, -1],
                            graph.face_flux[:, -1]], dim=1)
        feats = {"cell_x": cell_velocity, "cell_y": cell_y,
                 "face_x": face_x, "face_y": face_y, "face_bc_mask": bc_mask}
        return graph, feats


# the reference's shipped scale constants (Flux.py:465-469)
_FLUXD_SCALE_DEFAULTS = (("velocity_x", 0.1), ("velocity_y", 0.0001),
                         ("pressure", 0.01), ("flux", 0.001),
                         ("diffusion", 0.01))


class _FluxDModule(nn.Module):
    """EPD -> learned scale denorm -> physical flux integrator
    (Flux.py:477-515, 557-595). Returns (acc, face_out)."""

    def __init__(self, cfg: ArchConfig, face_in: int, scale_inits: tuple,
                 generator: torch.Generator = None, rho: float = 1.0,
                 nu: float = 0.001):
        super().__init__()
        self.rho, self.nu = rho, nu
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

    def forward(self, cell_x, face_x, graph):
        raw = self.epd(cell_x, face_x, graph)
        face_out = torch.cat([self.velocity_scale_x(raw[:, 0:1]),
                              self.velocity_scale_y(raw[:, 1:2]),
                              self.pressure_scale(raw[:, 2:3]),
                              self.flux_scale(raw[:, 3:4]),
                              self.diffusion_scale(raw[:, 4:6])], dim=-1)
        uv, pf, phi, flux_d = (face_out[:, :2], face_out[:, 2:3],
                               face_out[:, 3:4], face_out[:, 4:6])
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
    shipped training target (Flux.py:459-595). Rollout only in this port."""

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
                            generator=generator)

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

    def forward(self, graph, feats: Dict) -> Dict[str, torch.Tensor]:
        """One rollout step's outputs (physical units)."""
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        acc, face_out = self.module(nfeats["cell_x"], nfeats["face_x"], graph)
        cell_flux = fvm.face_flux_to_cell_flux_g(face_out[:, 3:4], graph)
        return {
            "cell_velocity_change": acc[:, 0:2],
            "face_velocity": face_out[:, 0:2],
            "face_pressure": face_out[:, 2:3],
            "face_flux": face_out[:, 3:4],
            "cell_flux": cell_flux[..., 0],
            "_nfeats": nfeats,
        }
