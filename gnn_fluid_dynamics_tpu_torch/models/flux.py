"""Flux model family (counterpart of ``models/flux.py``; reference
``src/models/Flux.py``): FVGN variants that predict (or derive) the face
mass flux phi_f and use it for conservative advection.

========  ====================================================================
FluxA     predicts [u_f, v_f, p_f, phi_f, D_x, D_y]; flux-based integrator;
          continuity from the signed cell flux (Flux.py:28-206)
FluxB     predicts [u_f, v_f, p_f, D_x, D_y]; phi_f = u_f . n A derived
          (Flux.py:209-283)
FluxC     predicts [p_f, phi_f, D_x, D_y]; u_f by cell->face interpolation
          inside the integrator (Flux.py:286-456)
FluxD     FluxA + learned scale denorm + the physical dt/V integrator: the
          model of the reference's shipped config (Flux.py:459-595)
========  ====================================================================

Every variant runs ``EncodeProcessDecode``'s cell-first GN blocks without a
step scalar: on the kernel route the fused K3 -> K2 (both outputs) -> K1.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from gnn_fluid_dynamics_tpu_torch.models import normalizer as norm
from gnn_fluid_dynamics_tpu_torch.models.arch import (ArchConfig,
                                                      EncodeProcessDecode,
                                                      FaceAreaNorm,
                                                      FluxIntegrator,
                                                      LearnedScaleDenorm,
                                                      gather3)
from gnn_fluid_dynamics_tpu_torch.models.fvgn import FvgnA, _f, _z
from gnn_fluid_dynamics_tpu_torch.models.losses import (combined_log_loss,
                                                        mse_per_element,
                                                        rel_mse_per_graph)
from gnn_fluid_dynamics_tpu_torch.models.transforms import standard_face_features
from gnn_fluid_dynamics_tpu_torch.ops import fvm
from gnn_fluid_dynamics_tpu_torch.ops.geometry import cell_to_face


class _FluxAModule(nn.Module):
    """EPD -> the flux integrator (Flax ``_FluxAModule``). Returns (acc,
    face_out, extras)."""

    def __init__(self, cfg: ArchConfig, face_in: int, out_size: int = 6,
                 generator: torch.Generator = None):
        super().__init__()
        self.epd = EncodeProcessDecode(cfg, cell_in=2, face_in=face_in,
                                       face_out=out_size, generator=generator)
        self.integrator = FluxIntegrator()

    def forward(self, cell_x, face_x, graph, train: bool = False,
                rng: torch.Generator = None):
        _, face_out = self.epd(cell_x, face_x, graph, train, rng)
        acc, extras = self.integrator(face_out, graph, train)
        return acc, face_out, extras


class FluxA(FvgnA):
    """Joint velocity+flux prediction with flux-based advection
    (Flux.py:28-206)."""

    name = "FluxA"
    face_out_size = 6

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _FluxAModule(self.arch, face_in=5 + self.config.num_face_types,
                            out_size=self.face_out_size, generator=generator)

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

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """One step's outputs, mapped back to physical units in rollout mode
        only; the signed cell flux regathered from the face flux
        (Flux.py:89-116)."""
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        acc, face_out, extras = self.module(nfeats["cell_x"], nfeats["face_x"],
                                            graph, mode == "train", generator)
        bundle = {"cell_out": acc, "face_out": face_out}
        if mode == "rollout":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats,
                                            inverse=True)
        acc, face_out = bundle["cell_out"], bundle["face_out"]
        cell_flux = fvm.face_flux_to_cell_flux_g(face_out[:, 3:4], graph)
        return {
            "cell_velocity_change": acc[:, 0:2],
            "face_velocity": face_out[:, 0:2],
            "face_pressure": face_out[:, 2:3],
            "face_flux": face_out[:, 3:4],
            "cell_flux": cell_flux[..., 0],
            "_nfeats": nfeats,
            **{f"_{k}": v for k, v in extras.items()},
        }

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


class FluxB(FluxA):
    """Predicts [u_f, v_f, p_f, D_x, D_y] through FvgnA's module; phi_f =
    u_f . n A derived, on the BatchNorm'd area in train mode and the
    physical area in rollout (Flux.py:209-283). FluxA's normalization map
    is kept as it is, so its ``face_flux`` output statistics fall on the
    D_x column (a reference quirk)."""

    name = "FluxB"
    face_out_size = 5
    build_module = FvgnA.build_module

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        acc, face_out, extras = self.module(nfeats["cell_x"], nfeats["face_x"],
                                            graph, mode == "train", generator)
        bundle = {"cell_out": acc, "face_out": face_out}
        if mode == "rollout":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats,
                                            inverse=True)
            area = graph.face_area
        else:
            area = extras["norm_face_area"]
        acc, face_out = bundle["cell_out"], bundle["face_out"]
        return {
            "cell_velocity_change": acc[:, 0:2],
            "face_velocity": face_out[:, 0:2],
            "face_pressure": face_out[:, 2:3],
            "face_flux": fvm.calc_flux_from_uf(face_out[:, 0:2],
                                               graph.face_normal, area),
            "_nfeats": nfeats,
            **{f"_{k}": v for k, v in extras.items()},
        }

    def loss(self, outputs, feats, graph) -> Dict[str, torch.Tensor]:
        """Continuity from the unsigned sum of the owner-oriented face flux
        (Flux.py:255-259), Δv, the face flux and the face pressure."""
        nfeats = outputs["_nfeats"]
        cmask, fmask = graph.cell_mask, graph.face_mask
        div = fvm.divergence_from_face_flux(outputs["face_flux"],
                                            graph.face_index)
        comps = {
            "continuity": mse_per_element(div, torch.zeros_like(div), cmask),
            "cell_velocity_change": mse_per_element(
                outputs["cell_velocity_change"], nfeats["cell_y"][:, 0:2],
                cmask),
            "face_flux": mse_per_element(
                outputs["face_flux"], nfeats["face_y"][:, 3:4], fmask),
            "face_pressure": mse_per_element(
                outputs["face_pressure"], nfeats["face_y"][:, 2:3], fmask),
        }
        total = combined_log_loss(comps, self.loss_weights)
        return {"total_log_loss": total,
                **{f"{k}_loss": v for k, v in comps.items()}}


class _FluxCModule(nn.Module):
    """[p, phi, D_x, D_y] head; u_f by cell->face interpolation of the
    normalized cell velocity inside the integrator, whose advective term is
    the unsigned u_f phi_f per local face (Flux.py:382-421). Returns (acc,
    face_out, {"norm_face_area": ...})."""

    def __init__(self, cfg: ArchConfig, face_in: int,
                 generator: torch.Generator = None):
        super().__init__()
        self.epd = EncodeProcessDecode(cfg, cell_in=2, face_in=face_in,
                                       face_out=4, generator=generator)
        self.face_area_norm = FaceAreaNorm()

    def forward(self, cell_x, face_x, graph, train: bool = False,
                rng: torch.Generator = None):
        _, face_out = self.epd(cell_x, face_x, graph, train, rng)
        uv_face = cell_to_face(cell_x[:, 0:2], graph.cell_edge_index,
                               graph.face_pos, graph.cell_pos)
        face_area = self.face_area_norm(graph, train)
        g = gather3(torch.cat([uv_face, face_out[:, 1:2], face_out[:, 2:4],
                               face_area, face_out[:, 0:1]], dim=1),
                    graph)                                     # (C, 3, 7)
        uvf, phif = g[..., 0:2], g[..., 2:3]
        fd, e, pf3 = g[..., 3:5], g[..., 5:6], g[..., 6:7]
        phi_a = torch.sum(uvf * phif, dim=1)
        phi_dd = torch.sum(fd, dim=1)
        phi_p = torch.sum(pf3 * graph.cell_normal * e, dim=1)
        acc = -phi_a - phi_p + phi_dd
        acc = torch.where(graph.cell_mask[:, None], acc, torch.zeros_like(acc))
        return acc, face_out, {"norm_face_area": face_area}


class FluxC(FluxA):
    """Predicts only [p_f, phi_f, D]; u_f explicit (Flux.py:286-456). Its
    targets are ``face_y = [p, phi]``, and the inherited feedback clamps the
    INFLOW/WALL faces' Δv to ``face_y[:, 0:2]``, the t0 [p_f, phi_f]: a
    reference quirk kept as it is."""

    name = "FluxC"
    face_out_size = 4

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _FluxCModule(self.arch, face_in=5 + self.config.num_face_types,
                            generator=generator)

    def normalisation_map(self) -> norm.NormalizationMap:
        base = FvgnA.normalisation_map(self)
        registry = dict(base.registry)
        for k in ("face_velocity_x", "face_velocity_y"):
            del registry[k]
        registry["face_pressure"] = _z("face_y", 0, 1)
        registry["face_flux"] = _z("face_y", 1, 2)
        inputs = tuple(f for f in base.inputs
                       if f.name not in ("face_velocity_x", "face_velocity_y",
                                         "face_pressure")) + (
            _f("face_pressure", "face_y", 0, 1),
            _f("face_flux", "face_y", 1, 2),
        )
        outputs = (
            _f("cell_velocity_change_x", "cell_out", 0, 1),
            _f("cell_velocity_change_y", "cell_out", 1, 2),
            _f("face_pressure", "face_out", 0, 1),
            _f("face_flux", "face_out", 1, 2),
        )
        return norm.NormalizationMap(registry, inputs, outputs)

    def transform_features(self, graph, generator: torch.Generator = None,
                           mode: str = "rollout", noise_std: float = 0.0):
        """FluxA's features with the face targets [p, phi] (Flux.py:322)."""
        graph, feats = super().transform_features(graph, generator, mode,
                                                  noise_std)
        feats["face_y"] = torch.cat([graph.face_pressure[:, -1],
                                     graph.face_flux[:, -1]], dim=1)
        return graph, feats

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        acc, face_out, extras = self.module(nfeats["cell_x"], nfeats["face_x"],
                                            graph, mode == "train", generator)
        bundle = {"cell_out": acc, "face_out": face_out}
        if mode == "rollout":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats,
                                            inverse=True)
        acc, face_out = bundle["cell_out"], bundle["face_out"]
        return {
            "cell_velocity_change": acc[:, 0:2],
            "face_pressure": face_out[:, 0:1],
            "face_flux": face_out[:, 1:2],
            "_nfeats": nfeats,
            **{f"_{k}": v for k, v in extras.items()},
        }

    def loss(self, outputs, feats, graph) -> Dict[str, torch.Tensor]:
        """Continuity from the unsigned face-flux sum, Δv, the face flux and
        the face pressure (Flux.py:423-456)."""
        nfeats = outputs["_nfeats"]
        cmask, fmask = graph.cell_mask, graph.face_mask
        div = fvm.divergence_from_face_flux(outputs["face_flux"],
                                            graph.face_index)
        comps = {
            "continuity": mse_per_element(div, torch.zeros_like(div), cmask),
            "cell_velocity_change": mse_per_element(
                outputs["cell_velocity_change"], nfeats["cell_y"], cmask),
            "face_flux": mse_per_element(
                outputs["face_flux"], nfeats["face_y"][:, 1:2], fmask),
            "face_pressure": mse_per_element(
                outputs["face_pressure"], nfeats["face_y"][:, 0:1], fmask),
        }
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
