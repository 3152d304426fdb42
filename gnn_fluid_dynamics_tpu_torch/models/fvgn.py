"""FVGN family (counterpart of ``models/fvgn.py``; reference
``src/models/Fvgn.py``): the canonical FvgnA and its variants, as
subclasses that change one hook each.

========  ====================================================================
FvgnA     normalized-space integrator + 4-term log loss (Fvgn.py:31-333)
FvgnB     physical integrator, MLS viscous term (Fvgn.py:336-460)
FvgnC     temporal bundling: k-step decoder outputs (Fvgn.py:463-786)
FvgnD     pushforward training flag (Fvgn.py:789-836)
FvgnE     characteristic-scale (dimensional) normalization (Fvgn.py:839-880)
FvgnF     weight-shared processor + step scalar (Fvgn.py:883-1010)
FvgnH     augmented face features (Fvgn.py:1013-1114)
FvgnI     rollout BC clamp on INFLOW+WALL only (Fvgn.py:1117-1137)
FvgnJ     learned output scale/bias denormalization (Fvgn.py:1140-1273)
FvgnK     per-graph dimensionless scaling (Fvgn.py:1276-1416)
========  ====================================================================

FvgnA: encode-process-decode (5 face outputs) -> the normalized-space FVGN
integrator; the outputs are z-scored and mapped back to physical units by
the dataset statistics. Every variant but FvgnF runs cell-first GN blocks
without a step scalar, so on the kernel route the fused blocks.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from gnn_fluid_dynamics_tpu_torch.models import normalizer as norm
from gnn_fluid_dynamics_tpu_torch.models import transforms as T
from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
from gnn_fluid_dynamics_tpu_torch.models.arch import (ArchConfig,
                                                      EncodeProcessDecode,
                                                      FaceAreaNorm,
                                                      FvgnIntegrator,
                                                      LearnedScaleDenorm,
                                                      PhysicalIntegrator,
                                                      gather3,
                                                      physical_acceleration)
from gnn_fluid_dynamics_tpu_torch.models.base import FluidModel
from gnn_fluid_dynamics_tpu_torch.models.losses import (combined_log_loss,
                                                        mse_per_element)
from gnn_fluid_dynamics_tpu_torch.ops import fvm
from gnn_fluid_dynamics_tpu_torch.parallel import halo


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
        acc, face_out, extras = self.module(*self.module_inputs(nfeats),
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


def _advective(uv, graph, idx):
    """The advective term [uu uv; vu vv] . n of each cell's local faces,
    (C, 3, 2), from the face velocity ``uv`` (F, 2); ``idx`` is
    ``graph.face_index.T``."""
    uu_vu = torch.cat([uv[:, 0:1] * uv, uv[:, 1:2] * uv], dim=-1)
    uu = uu_vu[idx].reshape(-1, 3, 2, 2)
    return torch.einsum("cfkd,cfd->cfk", uu, graph.cell_normal)


class _FvgnBModule(nn.Module):
    """EPD -> denormalize -> physical integrator (Flax ``_FvgnBModule``,
    Fvgn.py:360-385). ``denorm`` maps the decoder's face outputs to
    physical units (the model's output statistics, which are set after the
    module is built). Returns (acc, physical face outputs, extras)."""

    def __init__(self, cfg: ArchConfig, face_in: int, out_size: int = 3,
                 generator: torch.Generator = None):
        super().__init__()
        self.epd = EncodeProcessDecode(cfg, cell_in=2, face_in=face_in,
                                       face_out=out_size, generator=generator)
        self.integrator = PhysicalIntegrator()

    def forward(self, cell_x, face_x, graph, train: bool = False,
                rng: torch.Generator = None,
                denorm: Callable[[torch.Tensor], torch.Tensor] = None):
        _, face_out = self.epd(cell_x, face_x, graph, train, rng)
        phys = denorm(face_out)
        acc, extras = self.integrator(phys, graph, train)
        return acc, phys, extras


class FvgnB(FvgnA):
    """Real-space integration: physical dt/V, the nu = 1e-3 viscous term
    from the MLS face velocity gradients; the decoder predicts only
    [u_f, v_f, p_f] (Fvgn.py:336-460). Train-mode outputs are normalized
    again for the loss."""

    name = "FvgnB"
    face_out_size = 3
    face_grad_weights_use = True

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _FvgnBModule(self.arch, face_in=5 + self.config.num_face_types,
                            out_size=self.face_out_size, generator=generator)

    def _denorm_faces(self, face_out: torch.Tensor) -> torch.Tensor:
        return norm.normalize_outputs({"face_out": face_out, "cell_out": None},
                                      self.nmap, self.stats,
                                      inverse=True)["face_out"]

    def _module_outputs(self, graph, feats, mode, generator):
        """(normalized inputs, acc, physical face outputs, extras)."""
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        acc, face_phys, extras = self.module(
            nfeats["cell_x"], nfeats["face_x"], graph, mode == "train",
            generator, self._denorm_faces)
        return nfeats, acc, face_phys, extras

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """Physical outputs, normalized in train mode only
        (Fvgn.py:386-410)."""
        nfeats, acc, face_phys, extras = self._module_outputs(
            graph, feats, mode, generator)
        bundle = {"cell_out": acc, "face_out": face_phys}
        if mode == "train":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats)
        return {
            "cell_velocity_change": bundle["cell_out"][:, 0:2],
            "face_velocity": bundle["face_out"][:, 0:2],
            "face_pressure": bundle["face_out"][:, 2:3],
            "_nfeats": nfeats,
            **{f"_{k}": v for k, v in extras.items()},
        }

    def loss(self, outputs, feats, graph) -> Dict[str, torch.Tensor]:
        """FvgnA's four terms, with continuity on the normalized face area
        column of the features, ``face_x[:, 4:5]`` (Fvgn.py:391)."""
        nfeats = outputs["_nfeats"]
        cmask, fmask = graph.cell_mask, graph.face_mask
        div = fvm.divergence_from_uf(outputs["face_velocity"], graph.cell_normal,
                                     nfeats["face_x"][:, 4:5], graph.face_index)
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


class _FvgnCModule(nn.Module):
    """EPD with a k-step decoder, then FvgnA's integrator per sub-step, each
    acceleration scaled by (k+1), a reference quirk kept as it is (Flax
    ``_FvgnCModule``, Fvgn.py:655-703). Returns (acc (C, k, 2), face_out
    (F, k, 5), {"norm_face_area": ...})."""

    def __init__(self, cfg: ArchConfig, face_in: int, bundle: int = 2,
                 generator: torch.Generator = None):
        super().__init__()
        self.bundle = bundle
        self.epd = EncodeProcessDecode(cfg, cell_in=2, face_in=face_in,
                                       face_out=5 * bundle, generator=generator)
        self.face_area_norm = FaceAreaNorm()

    def forward(self, cell_x, face_x, graph, train: bool = False,
                rng: torch.Generator = None):
        _, flat = self.epd(cell_x, face_x, graph, train, rng)
        face_out = flat.reshape(flat.shape[0], self.bundle, 5)
        face_area = self.face_area_norm(graph, train)
        idx = graph.face_index.T
        e = face_area.reshape(-1)[idx][..., None]                 # (C, 3, 1)
        unv = graph.cell_normal
        accs = []
        for t in range(self.bundle):
            uv = face_out[:, t, :2]
            p = face_out[:, t, 2:3]
            d = face_out[:, t, 3:]
            phi_a = torch.sum(_advective(uv, graph, idx) * e, dim=1)
            phi_d = torch.sum(d[idx], dim=1)
            phi_p = torch.sum(p[idx] * unv * e, dim=1)
            acc = (-phi_a - phi_p + phi_d) * (self.bundle + 1)
            accs.append(torch.where(graph.cell_mask[:, None], acc,
                                    torch.zeros_like(acc)))
        return torch.stack(accs, dim=1), face_out, {"norm_face_area": face_area}


class FvgnC(FvgnA):
    """Temporal bundling: the decoder emits k = ``bundle_size`` steps at once
    (Fvgn.py:463-786). The targets carry a bundle axis, (N, k, D); the loss
    is the log of the mean of the per-step weighted totals; the statistics
    of the face targets come from the first bundled step only."""

    name = "FvgnC"

    @property
    def bundle(self) -> int:
        return self.config.bundle_size or 2

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _FvgnCModule(self.arch, face_in=5 + self.config.num_face_types,
                            bundle=self.bundle, generator=generator)

    def normalisation_map(self) -> norm.NormalizationMap:
        nmap = super().normalisation_map()
        registry = dict(nmap.registry)
        # the bundled targets' statistics: the first step only
        # (Fvgn.py:521-523)
        for key, (tensor, s, e) in (("face_velocity_x", ("face_y", 0, 1)),
                                    ("face_velocity_y", ("face_y", 1, 2)),
                                    ("face_pressure", ("face_y", 2, 3))):
            registry[key] = norm.StatSpec("z_score", ("slice0", tensor, s, e))
        return nmap.replace(registry=registry)

    def transform_features(self, graph, generator: torch.Generator = None,
                           mode: str = "rollout", noise_std: float = 0.0):
        """FvgnA's features with bundled targets: ``cell_y`` (C, k, 2), the
        change of each later window step from the t0 velocity
        (Fvgn.py:483-484), and ``face_y`` (F, k, 3)."""
        graph, cell_velocity, _ = self._input_state(graph, generator, mode,
                                                    noise_std)
        cell_y = graph.cell_velocity[:, 1:] - cell_velocity[:, None, :]
        face_x, bc_mask = T.standard_face_features(
            graph, cell_velocity, self.config.num_face_types,
            bc_velocity=graph.face_velocity[:, 0])
        face_y = torch.cat([graph.face_velocity[:, 1:],
                            graph.face_pressure[:, 1:]], dim=2)
        feats = {"cell_x": cell_velocity, "cell_y": cell_y,
                 "face_x": face_x, "face_y": face_y, "face_bc_mask": bc_mask}
        return graph, feats

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """FvgnA's forward with a bundle axis on every output."""
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        acc, face_out, extras = self.module(nfeats["cell_x"], nfeats["face_x"],
                                            graph, mode == "train", generator)
        bundle = {"cell_out": acc, "face_out": face_out}
        if mode == "rollout":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats,
                                            inverse=True)
        return {
            "cell_velocity_change": bundle["cell_out"][:, :, 0:2],
            "face_velocity": bundle["face_out"][:, :, 0:2],
            "face_pressure": bundle["face_out"][:, :, 2:3],
            "_nfeats": nfeats,
            **{f"_{k}": v for k, v in extras.items()},
        }

    def loss(self, outputs, feats, graph) -> Dict[str, torch.Tensor]:
        """FvgnA's four terms per bundled step; the total is the log of the
        mean of the per-step weighted sums, each component the mean over
        the steps (Fvgn.py:598-653)."""
        nfeats = outputs["_nfeats"]
        cmask, fmask = graph.cell_mask, graph.face_mask
        totals, comps_acc = [], {}
        for t in range(self.bundle):
            div = fvm.divergence_from_uf(
                outputs["face_velocity"][:, t], graph.cell_normal,
                outputs["_norm_face_area"], graph.face_index)
            comps = {
                "continuity": mse_per_element(div, torch.zeros_like(div),
                                              cmask),
                "cell_velocity_change": mse_per_element(
                    outputs["cell_velocity_change"][:, t],
                    nfeats["cell_y"][:, t], cmask),
                "face_velocity": mse_per_element(
                    outputs["face_velocity"][:, t], nfeats["face_y"][:, t, :2],
                    fmask & ~feats["face_bc_mask"]),
                "face_pressure": mse_per_element(
                    outputs["face_pressure"][:, t],
                    nfeats["face_y"][:, t, 2:3], fmask),
            }
            total = None
            for name, value in comps.items():
                w = self.loss_weights.get(name)
                if w is None:
                    continue
                total = w * value if total is None else total + w * value
                comps_acc.setdefault(name, []).append(value)
            totals.append(total)
        loss = torch.log(torch.mean(torch.stack(totals)))
        return {"total_log_loss": loss,
                **{f"{k}_loss": torch.mean(torch.stack(v))
                   for k, v in comps_acc.items()}}

    def update_features(self, solutions, feats, graph):
        """The base feedback, with the BC clamp on the LAST bundled step's
        targets (Fvgn.py:566)."""
        new_feats = dict(feats)
        v = solutions["cell_velocity"]
        new_feats["cell_x"] = v
        dv = T.calc_face_velocity_change(v[:, :2], graph.cell_edge_index)
        mask = T.rollout_bc_mask(graph.face_type)
        dv = torch.where(mask[:, None], feats["face_y"][:, -1, 0:2], dv)
        new_feats["face_x"] = torch.cat([dv, feats["face_x"][:, 2:]], dim=1)
        return new_feats


class FvgnD(FvgnA):
    """The pushforward trick: the trainer unrolls no-grad steps before the
    supervised one (Fvgn.py:789-836 + train.py:247-252). The model's math is
    FvgnA's; the dataset window carries the extra steps, and the Δv
    statistics come from the window's last single step
    (``FvgnA._input_state``)."""

    name = "FvgnD"
    pushforward_use = True


class FvgnE(FvgnA):
    """Dimensional normalization by characteristic scales: velocity (the
    largest |u|, ``max_scale``), length (the mean of sqrt V,
    ``mean_scale``) and the derived pressure v_max^2 / 2
    (Fvgn.py:839-880; normalisation.py:183-197)."""

    name = "FvgnE"

    def normalisation_map(self) -> norm.NormalizationMap:
        registry = {
            "characteristic_velocity": norm.StatSpec(
                "max_scale", ("norm", "cell_x", 0, 2)),
            "characteristic_length": norm.StatSpec(
                "mean_scale", ("sqrt", "cell_volume", 0, 1)),
            "characteristic_pressure": norm.StatSpec("max_scale", None),
        }
        cv, cl, cp = ("characteristic_velocity", "characteristic_length",
                      "characteristic_pressure")
        inputs = (
            _f("cell_velocity_x", "cell_x", 0, 1, cv),
            _f("cell_velocity_y", "cell_x", 1, 2, cv),
            _f("cell_velocity_change_x", "cell_y", 0, 1, cv),
            _f("cell_velocity_change_y", "cell_y", 1, 2, cv),
            _f("face_velocity_difference_x", "face_x", 0, 1, cv),
            _f("face_velocity_difference_y", "face_x", 1, 2, cv),
            _f("face_edge_vector_x", "face_x", 2, 3, cl),
            _f("face_edge_vector_y", "face_x", 3, 4, cl),
            _f("face_area", "face_x", 4, 5, cl),
            _f("face_velocity_x", "face_y", 0, 1, cv),
            _f("face_velocity_y", "face_y", 1, 2, cv),
            _f("face_pressure", "face_y", 2, 3, cp),
        )
        outputs = (
            _f("cell_velocity_change_x", "cell_out", 0, 1, cv),
            _f("cell_velocity_change_y", "cell_out", 1, 2, cv),
            _f("face_velocity_x", "face_out", 0, 1, cv),
            _f("face_velocity_y", "face_out", 1, 2, cv),
            _f("face_pressure", "face_out", 2, 3, cp),
        )
        return norm.NormalizationMap(registry, inputs, outputs)

    def transform_features(self, graph, generator: torch.Generator = None,
                           mode: str = "rollout", noise_std: float = 0.0):
        """FvgnA's features and the cell volume, which the characteristic
        length's statistic reads."""
        graph, feats = super().transform_features(graph, generator, mode,
                                                  noise_std)
        feats["cell_volume"] = graph.cell_volume
        return graph, feats


class FvgnH(FvgnA):
    """Augmented face features: [Δv | n̂ | area | adjacent-cell distance |
    normal/edge-vector angle | one-hot] (Fvgn.py:1013-1114)."""

    name = "FvgnH"

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _FvgnAModule(self.arch, face_in=7 + self.config.num_face_types,
                            out_size=self.face_out_size, generator=generator)

    def normalisation_map(self) -> norm.NormalizationMap:
        registry = {
            "cell_velocity_x": _z("cell_x", 0, 1),
            "cell_velocity_y": _z("cell_x", 1, 2),
            "cell_velocity_change_x": _z("cell_y", 0, 1),
            "cell_velocity_change_y": _z("cell_y", 1, 2),
            "face_velocity_difference_x": _z("face_x", 0, 1),
            "face_velocity_difference_y": _z("face_x", 1, 2),
            "face_normal_x": _z("face_x", 2, 3),
            "face_normal_y": _z("face_x", 3, 4),
            "face_area": _z("face_x", 4, 5),
            "face_adjacent_distance": _z("face_x", 5, 6),
            "face_angle": _z("face_x", 6, 7),
            "face_velocity_x": _z("face_y", 0, 1),
            "face_velocity_y": _z("face_y", 1, 2),
            "face_pressure": _z("face_y", 2, 3),
        }
        inputs = tuple(_f(k, *registry[k].extractor) for k in registry)
        return norm.NormalizationMap(registry, inputs,
                                     super().normalisation_map().outputs)

    def transform_features(self, graph, generator: torch.Generator = None,
                           mode: str = "rollout", noise_std: float = 0.0):
        """Seven face columns and the one-hot: Δv (the t0 face velocity on
        every boundary face), the face normal, the area, the distance of the
        adjacent cells' centres, and the angle between the normal and their
        edge vector, arccos(|clip(dot)|), 0 where that distance is under
        1e-8 (Fvgn.py:1040-1093)."""
        graph, cell_velocity, _ = self._input_state(graph, generator, mode,
                                                    noise_std)
        cell_y = graph.cell_velocity[:, -1] - cell_velocity
        dv = T.calc_face_velocity_change(cell_velocity, graph.cell_edge_index)
        bc_mask = ~T.interior_face_mask(graph.face_type)
        dv = torch.where(bc_mask[:, None], graph.face_velocity[:, 0], dv)
        ev = T.calc_cell_edge_vector(graph.cell_pos, graph.cell_edge_index)
        onehot = T.calc_face_type_one_hot(graph.face_type,
                                          self.config.num_face_types)
        dist = torch.linalg.vector_norm(ev, dim=1, keepdim=True)
        small = dist < 1e-8
        ev_n = ev / (dist + 1e-8)
        dot = torch.clamp(torch.sum(ev_n * graph.face_normal, dim=1,
                                    keepdim=True), -1.0, 1.0)
        angle = torch.where(small, torch.zeros_like(dot),
                            torch.arccos(torch.abs(dot)))
        face_x = torch.cat([dv, graph.face_normal, graph.face_area, dist,
                            angle, onehot.to(dv.dtype)], dim=1)
        face_y = torch.cat([graph.face_velocity[:, -1],
                            graph.face_pressure[:, -1]], dim=1)
        feats = {"cell_x": cell_velocity, "cell_y": cell_y,
                 "face_x": face_x, "face_y": face_y, "face_bc_mask": bc_mask}
        return graph, feats


class FvgnI(FvgnA):
    """The rollout BC variant: training is FvgnA's, and its feedback clamps
    the INFLOW+WALL faces only (Fvgn.py:1117-1137), which is the base
    feedback here too, so the class is FvgnA under another name."""

    name = "FvgnI"


class _FvgnJModule(nn.Module):
    """EPD -> learned scale/bias denormalization -> the physical integrator
    on raw face areas (Flax ``_FvgnJModule``, Fvgn.py:1164-1273): Phi_A and
    Phi_P use the un-normalized face areas, Phi_D is a plain sum of the
    three faces, acc = mean(dt)/V * (-Phi_A - Phi_P/rho + nu Phi_D)."""

    def __init__(self, cfg: ArchConfig, face_in: int, out_size: int = 5,
                 generator: torch.Generator = None, rho: float = 1.0,
                 nu: float = 1e-3):
        super().__init__()
        self.rho, self.nu = rho, nu
        self.epd = EncodeProcessDecode(cfg, cell_in=2, face_in=face_in,
                                       face_out=out_size, generator=generator)
        # Fvgn.py:1149-1157: velocity x 1.0, y 0.01, pressure and diffusion
        # 1.0, every bias 0
        self.velocity_scale = LearnedScaleDenorm(2, (1.0, 0.01),
                                                 learn_bias=True)
        self.pressure_scale = LearnedScaleDenorm(1, 1.0, learn_bias=True)
        self.diffusion_scale = LearnedScaleDenorm(2, 1.0, learn_bias=True)

    def forward(self, cell_x, face_x, graph, train: bool = False,
                rng: torch.Generator = None):
        _, raw = self.epd(cell_x, face_x, graph, train, rng)
        uv = self.velocity_scale(raw[:, 0:2])
        p = self.pressure_scale(raw[:, 2:3])
        d = self.diffusion_scale(raw[:, 3:5])
        face_out = torch.cat([uv, p, d], dim=-1)
        unv = graph.cell_normal
        area = graph.face_area.reshape(-1, 1)
        uu_vu = torch.cat([uv[:, 0:1] * uv, uv[:, 1:2] * uv], dim=-1)
        g = gather3(torch.cat([area, uu_vu, d, p], dim=1), graph)
        e, uu, df, pf = (g[..., 0:1], g[..., 1:5].reshape(-1, 3, 2, 2),
                         g[..., 5:7], g[..., 7:8])
        phi_a = torch.sum(torch.einsum("cfkd,cfd->cfk", uu, unv) * e, dim=1)
        phi_d = torch.sum(df, dim=1)
        phi_p = torch.sum(pf * unv * e, dim=1)
        return (physical_acceleration(graph, phi_a, phi_p, phi_d, self.rho,
                                      self.nu),
                face_out, {})


class FvgnJ(FvgnB):
    """Learned per-channel output scale and bias in place of the output
    z-score (Fvgn.py:1140-1273): the outputs are physical, normalized again
    for the loss in train mode; FvgnB's loss (continuity on the normalized
    face area column, Fvgn.py:1203-1207)."""

    name = "FvgnJ"
    face_out_size = 5
    face_grad_weights_use = False

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _FvgnJModule(self.arch, face_in=5 + self.config.num_face_types,
                            out_size=self.face_out_size, generator=generator)

    def _module_outputs(self, graph, feats, mode, generator):
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        acc, face_phys, extras = self.module(
            nfeats["cell_x"], nfeats["face_x"], graph, mode == "train",
            generator)
        return nfeats, acc, face_phys, extras


class _FvgnKModule(nn.Module):
    """EPD -> per-graph dimensionless rescale -> physical integrator (Flax
    ``_FvgnKModule``, Fvgn.py:1290-1416). ``u_ref``/``l_ref`` enter as
    per-face (F, 1) tensors; the learned ``anisotropy_ratio`` scales the
    v channel. The integrator gathers the face areas by ``face_index`` and
    uses only the FIRST diffusion column, as the reference does
    (Fvgn.py:1398-1409)."""

    def __init__(self, cfg: ArchConfig, face_in: int,
                 generator: torch.Generator = None):
        super().__init__()
        self.epd = EncodeProcessDecode(cfg, cell_in=2, face_in=face_in,
                                       face_out=5, generator=generator)
        self.anisotropy_ratio = nn.Parameter(torch.tensor(1e-4))

    def forward(self, cell_x, face_x, graph, train: bool = False,
                rng: torch.Generator = None, u_ref=None, l_ref=None):
        _, raw = self.epd(cell_x, face_x, graph, train, rng)
        if u_ref is None:
            u_ref = torch.ones_like(raw[:, 0:1])
            l_ref = torch.ones_like(raw[:, 0:1])
        p_ref = u_ref ** 2
        d_ref = u_ref * l_ref
        face_out = torch.cat([raw[:, 0:1] * u_ref,
                              raw[:, 1:2] * u_ref * self.anisotropy_ratio,
                              raw[:, 2:3] * p_ref,
                              raw[:, 3:5] * d_ref], dim=-1)
        idx = graph.face_index.T
        unv = graph.cell_normal
        area3 = graph.face_area.reshape(-1)[idx][..., None]
        p = face_out[:, 2:3]
        d = face_out[:, 3:4]
        phi_a = torch.sum(_advective(face_out[:, 0:2], graph, idx) * area3,
                          dim=1)
        phi_d = torch.sum(d[idx], dim=1)
        phi_p = torch.sum(p[idx] * unv * area3, dim=1)
        return physical_acceleration(graph, phi_a, phi_p, phi_d), face_out, {}


class FvgnK(FvgnA):
    """Per-graph dimensionless scaling: u_ref from the inflow BC, l_ref from
    the Reynolds number, a learned anisotropy ratio; physical-unit
    integration (Fvgn.py:1276-1416). Outputs are normalized in every mode
    but ``"rollout"``."""

    name = "FvgnK"

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _FvgnKModule(self.arch, face_in=5 + self.config.num_face_types,
                            generator=generator)

    def _refs(self, graph, feats):
        """u_ref: each graph's first live INFLOW face's target u (1 for a
        graph without one); l_ref = Re * 1e-3 / u_ref (Fvgn.py:1291-1306).
        Per face, (F, 1) each. On a space-sharded graph the first face is
        taken over the whole graph (``halo.first_owned``: each rank offers
        its owned INFLOW faces, the space group takes the least global id,
        its owner supplies the value)."""
        inflow = ((graph.face_type.reshape(-1) == NodeType.INFLOW)
                  & graph.face_mask)
        found, u_first = halo.first_owned(graph, "face", inflow,
                                          feats["face_y"][:, 0],
                                          graph.face_batch, graph.num_graphs)
        u_ref_g = torch.where(found, u_first, torch.ones_like(u_first))
        re = graph.reynolds.reshape(-1).expand(graph.num_graphs)
        l_ref_g = re * 1e-3 / u_ref_g
        return u_ref_g[graph.face_batch][:, None], l_ref_g[graph.face_batch][:, None]

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        u_ref, l_ref = self._refs(graph, feats)    # from the physical targets
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        acc, face_phys, _ = self.module(nfeats["cell_x"], nfeats["face_x"],
                                        graph, mode == "train", generator,
                                        u_ref=u_ref, l_ref=l_ref)
        bundle = {"cell_out": acc, "face_out": face_phys}
        if mode != "rollout":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats)
        return {
            "cell_velocity_change": bundle["cell_out"][:, 0:2],
            "face_velocity": bundle["face_out"][:, 0:2],
            "face_pressure": bundle["face_out"][:, 2:3],
            "_nfeats": nfeats,
        }

    loss = FvgnB.loss
