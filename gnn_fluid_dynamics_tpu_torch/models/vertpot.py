"""Vertex-potential model family (counterpart of ``models/vertpot.py``;
reference ``src/models/VertPot.py``).

A vertex block sums the face block's raw edge latents at both endpoint
vertices; a vertex decoder emits a scalar potential whose differences around
each triangle give per-cell face fluxes that are divergence-free by
construction (``calc_cell_flux_from_vertices``, VertPot.py:25-40: a
telescoping sum).

========  ====================================================================
VertPotA  [u,v,p,Dx,Dy] face head + potential flux; flux-advection integrator
          with BatchNorm'd dt/V̄; no flux loss (VertPot.py:47-231)
VertPotB  physical integrator + MLS viscous term (VertPot.py:234-319)
VertPotC  [p,Dx,Dy] head, u_f by cell->face interpolation (VertPot.py:322-444)
VertPotD  A + the owner-slot face flux spliced into FluxA's integrator
          (VertPot.py:447-492)
VertPotE  FluxC's wiring with VertPot blocks (VertPot.py:494-539)
VertPotF  physical integration of the potential flux (VertPot.py:541-628)
VertPotG  loss on the face flux converted from the cell flux
          (VertPot.py:631-818)
========  ====================================================================

The processor is FVGN's cell-first GN block, each application also handing
out its face block's raw output (``GNBlock``'s ``face_raw``): on the kernel
route per block K3 -> K2 (both outputs) -> K1 (both outputs), the face block
reading K2's raw output, the residualed pair carrying on, and the vertex sum
reading the last block's K1 raw output. The JAX package's fused Pallas route
adds each residual a second time here (its fused blocks return residualed
latents to a module that adds the residual itself); the port keeps the
reference's semantics, those of the JAX package's plain route, on every
route. The two decoders compute in f32 whatever the compute dtype, as the
JAX package builds them without one.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from gnn_fluid_dynamics_tpu_torch.models import normalizer as norm
from gnn_fluid_dynamics_tpu_torch.models.arch import (MLP, ArchConfig,
                                                      Encoder, FaceAreaNorm,
                                                      FluxIntegrator, GNBlock,
                                                      VolDtNorm, block_route,
                                                      gather3,
                                                      physical_acceleration)
from gnn_fluid_dynamics_tpu_torch.models.flux import FluxA, FluxC
from gnn_fluid_dynamics_tpu_torch.models.fvgn import _f
from gnn_fluid_dynamics_tpu_torch.models.losses import (combined_log_loss,
                                                        mse_per_element)
from gnn_fluid_dynamics_tpu_torch.ops import fvm
from gnn_fluid_dynamics_tpu_torch.ops.geometry import cell_to_face
from gnn_fluid_dynamics_tpu_torch.ops.segment import \
    aggregate_edges_to_vertices_sum
from gnn_fluid_dynamics_tpu_torch.parallel.halo import refresh


def calc_cell_flux_from_vertices(vertex_out: torch.Tensor,
                                 graph) -> torch.Tensor:
    """Per-cell fluxes as potential differences around the triangle
    (reference VertPot.py:25-40): [psi(v1)-psi(v2), psi(v2)-psi(v0),
    psi(v0)-psi(v1)], which sum to zero per cell. -> (C, 3)."""
    psi = vertex_out.reshape(-1)
    v = psi[graph.vertex_face]                   # (3, C)
    return torch.stack([v[1] - v[2], v[2] - v[0], v[0] - v[1]], dim=1)


def _uv_face(cell_x, graph) -> torch.Tensor:
    return cell_to_face(cell_x[:, 0:2], graph.cell_edge_index, graph.face_pos,
                        graph.cell_pos)


def _owner_face_flux(cell_flux, graph) -> torch.Tensor:
    return fvm.cell_flux_to_face_flux(cell_flux, graph.cell_edge_index,
                                      graph.owner_local_slot)


class _VertPotModule(nn.Module):
    """Encoder -> ``mp_num`` cell-first GN blocks -> the vertex sum of the
    last block's raw face output -> the face and vertex decoders -> the
    potential's cell flux -> the ``integrator``, one of the ``_<kind>``
    methods (Flax ``_VertPotModule``). Returns (acc, face_out, cell_flux
    (C, 3), extras). No remat and no shared blocks, as in the JAX
    package."""

    def __init__(self, cfg: ArchConfig, face_in: int, face_out: int = 5,
                 integrator: str = "flux_norm",
                 generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        self.integrator_kind = integrator
        self.encoder = Encoder(cfg, 2, face_in, generator)
        self.blocks = nn.ModuleList(GNBlock(cfg, generator)
                                    for _ in range(cfg.mp_num))
        self.decoder_face, self.decoder_vertex = (
            MLP(cfg.hidden, cfg.hidden, n, layer_norm=False,
                dropout_rate=cfg.dropout_rate, generator=generator)
            for n in (face_out, 1))
        if integrator == "flux_norm":
            self.vol_dt_norm = VolDtNorm()
        if integrator in ("flux_norm", "fluxC", "fluxE"):
            self.face_area_norm = FaceAreaNorm()
        if integrator == "fluxD":
            self.integrator = FluxIntegrator()

    def forward(self, cell_x, face_x, graph, train: bool = False,
                rng: torch.Generator = None):
        cell_attr, edge_attr = self.encoder(cell_x, face_x, train, rng)
        cell_attr = refresh(cell_attr, graph, "cell")
        edge_attr = refresh(edge_attr, graph, "face")
        for block in self.blocks:
            route = block_route(self.cfg, graph, cell_attr, None, train)
            cell_attr, edge_attr, e_raw = block(cell_attr, edge_attr, graph,
                                                None, route, train, rng,
                                                face_raw=True)
        vertex_attr = aggregate_edges_to_vertices_sum(e_raw.float(), graph)
        face_out = refresh(self.decoder_face(edge_attr, train, rng), graph,
                           "face")
        vertex_out = self.decoder_vertex(vertex_attr, train, rng)
        vertex_out = torch.where(graph.vertex_mask[:, None], vertex_out,
                                 torch.zeros_like(vertex_out))
        # a ghost cell's vertex may miss faces of the rank's graph, so its
        # cell flux comes from its owner (the owner-slot face flux reads it)
        cell_flux = refresh(calc_cell_flux_from_vertices(vertex_out, graph),
                            graph, "cell")                        # (C, 3)
        acc, face_out, extras = getattr(self, "_" + self.integrator_kind)(
            cell_x, face_out, cell_flux, graph, train)
        acc = torch.where(graph.cell_mask[:, None], acc, torch.zeros_like(acc))
        return acc, face_out, cell_flux, extras

    # ---- the integrators: each (acc, face_out, extras) ----------------------
    def _flux_norm(self, cell_x, face_out, cell_flux, graph, train):
        """VertPotA's (VertPot.py:103-150): the advective flux u_f times the
        potential's cell flux times the BatchNorm'd dt/V̄."""
        n = self.vol_dt_norm(graph, train)
        area = self.face_area_norm(graph, train)
        g = gather3(torch.cat([n, face_out[:, 0:2], face_out[:, 3:5], area,
                               face_out[:, 2:3]], dim=1), graph)   # (C, 3, 7)
        nf, uvf = g[..., 0:1], g[..., 1:3]
        phi_a = torch.sum(uvf * cell_flux[..., None] * nf, dim=1)
        phi_d = torch.sum(g[..., 3:5], dim=1)
        phi_p = torch.sum(g[..., 6:7] * graph.cell_normal * g[..., 5:6], dim=1)
        return -phi_a - phi_p + phi_d, face_out, {"norm_face_area": area}

    def _fluxC(self, cell_x, face_out, cell_flux, graph, train):
        """VertPotC's (VertPot.py:368-409): explicit u_f, [p, Dx, Dy] head."""
        area = self.face_area_norm(graph, train)
        g = gather3(torch.cat([_uv_face(cell_x, graph), face_out[:, 1:3],
                               area, face_out[:, 0:1]], dim=1),
                    graph)                                     # (C, 3, 6)
        phi_a = torch.sum(g[..., 0:2] * cell_flux[..., None], dim=1)
        phi_d = torch.sum(g[..., 2:4], dim=1)
        phi_p = torch.sum(g[..., 5:6] * graph.cell_normal * g[..., 4:5], dim=1)
        return -phi_a - phi_p + phi_d, face_out, {"norm_face_area": area}

    def _fluxE(self, cell_x, face_out, cell_flux, graph, train):
        """VertPotE's (VertPot.py:494-539): the owner-slot face flux is
        appended to the [p, Dx, Dy] head and FluxC's integrator runs on the
        result, reading phi from column 1 (= Dx) and D from columns 2:4
        (= [Dy, flux]): the reference's columns, kept as they are."""
        face_out = torch.cat([face_out, _owner_face_flux(cell_flux, graph)],
                             dim=1)                            # (F, 4)
        area = self.face_area_norm(graph, train)
        g = gather3(torch.cat([_uv_face(cell_x, graph), face_out[:, 1:2],
                               face_out[:, 2:4], area, face_out[:, 0:1]],
                              dim=1), graph)                   # (C, 3, 7)
        uvf, phif = g[..., 0:2], g[..., 2:3]
        fd, e, pf3 = g[..., 3:5], g[..., 5:6], g[..., 6:7]
        phi_a = torch.sum(uvf * phif, dim=1)
        phi_dd = torch.sum(fd, dim=1)
        phi_p = torch.sum(pf3 * graph.cell_normal * e, dim=1)
        return -phi_a - phi_p + phi_dd, face_out, {"norm_face_area": area}

    def _fluxD(self, cell_x, face_out, cell_flux, graph, train):
        """VertPotD's (VertPot.py:447-492): the owner-slot face flux spliced
        into FluxA's integrator input, whose signed regather differs from
        the direct cell flux (the potential's cell flux is not exactly
        antisymmetric): a reference quirk kept as it is."""
        face_out = torch.cat([face_out[:, 0:3],
                              _owner_face_flux(cell_flux, graph),
                              face_out[:, 3:5]], dim=1)
        acc, extras = self.integrator(face_out, graph, train)
        return acc, face_out, extras

    def _fluxF(self, cell_x, face_out, cell_flux, graph, train):
        """VertPotF's (VertPot.py:541-628) under the JAX package's two shims:
        the owner-slot conversion for the reference's undefined ``_alt`` one,
        and nu = 1e-3 for the constructor's missing nu. The network-space
        outputs meet the physical areas, dt and V; the advective term reads
        the owner-slot face flux regathered per cell (the neighbour sees the
        owner's outward value, VertPot.py:613)."""
        face_out = torch.cat([face_out, _owner_face_flux(cell_flux, graph)],
                             dim=1)                            # (F, 4)
        grad = fvm.calc_gradient_tensor(face_out[:, 0:2],
                                        graph.face_grad_weights,
                                        graph.face_grad_neighbours)
        area = graph.face_area.reshape(-1, 1)
        gg = gather3(torch.cat([area, face_out[:, 0:2], face_out[:, 3:4], grad,
                                face_out[:, 2:3]], dim=1), graph)  # (C, 3, 9)
        area3, uvf, phif = gg[..., 0:1], gg[..., 1:3], gg[..., 3:4]
        phi_a = torch.sum(uvf * phif, dim=1)
        g = gg[..., 4:8].reshape(-1, 3, 2, 2)
        phi_d = torch.sum(torch.einsum("cfkd,cfd->cfk", g, graph.cell_normal)
                          * area3, dim=1)
        phi_p = torch.sum(gg[..., 8:9] * graph.cell_normal * area3, dim=1)
        return (physical_acceleration(graph, phi_a, phi_p, phi_d),
                face_out, {})

    def _none(self, cell_x, face_out, cell_flux, graph, train):
        return cell_x.new_zeros((cell_x.shape[0], 2)), face_out, {}


class VertPotA(FluxA):
    """Potential flux, flux-advection integrator, no flux loss
    (VertPot.py:47-231)."""

    name = "VertPotA"
    face_out_size = 5
    integrator_kind = "flux_norm"

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _VertPotModule(self.arch,
                              face_in=5 + self.config.num_face_types,
                              face_out=self.face_out_size,
                              integrator=self.integrator_kind,
                              generator=generator)

    def normalisation_map(self) -> norm.NormalizationMap:
        """FluxA's map with ``cell_out`` = [acc (2) | cell flux (3)], the
        flux columns under the face flux's statistics (VertPot.py:64-72)."""
        nmap = super().normalisation_map()
        outputs = tuple(f for f in nmap.outputs if f.name != "face_flux") + (
            _f("cell_flux", "cell_out", 2, 5, "face_flux"),)
        return nmap.replace(outputs=outputs)

    def _module_outputs(self, graph, feats, mode, generator):
        """(normalized inputs, acc, face_out, cell_flux, extras)."""
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        return (nfeats,) + tuple(self.module(
            nfeats["cell_x"], nfeats["face_x"], graph, mode == "train",
            generator))

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """Outputs in physical units in rollout mode only. ``_cell_flux_raw``
        is the telescoped flux before denormalization, divergence-free by
        construction; the denormalized ``cell_flux`` is not: the z-score
        inverse adds the mean face flux to each of the 3 local faces, so its
        divergence is 3 x that mean per cell (the rollout reports both)."""
        nfeats, acc, face_out, cell_flux, extras = self._module_outputs(
            graph, feats, mode, generator)
        bundle = {"cell_out": torch.cat([acc, cell_flux], dim=1),
                  "face_out": face_out}
        if mode == "rollout":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats,
                                            inverse=True)
        cell_out, face_out = bundle["cell_out"], bundle["face_out"]
        return {
            "cell_velocity_change": cell_out[:, 0:2],
            "cell_flux": cell_out[:, 2:5],
            "face_velocity": face_out[:, 0:2],
            "face_pressure": face_out[:, 2:3],
            "_cell_flux_raw": cell_flux,
            "_nfeats": nfeats,
            **{f"_{k}": v for k, v in extras.items()},
        }

    def loss(self, outputs, feats, graph) -> Dict[str, torch.Tensor]:
        """Continuity of the cell flux, Δv, the face velocity on every face
        (no INFLOW mask) and the face pressure (VertPot.py:152-185)."""
        nfeats = outputs["_nfeats"]
        cmask, fmask = graph.cell_mask, graph.face_mask
        div = fvm.divergence_from_cell_flux(outputs["cell_flux"])
        comps = {
            "continuity": mse_per_element(div, torch.zeros_like(div), cmask),
            "cell_velocity_change": mse_per_element(
                outputs["cell_velocity_change"], nfeats["cell_y"], cmask),
            "face_velocity": mse_per_element(
                outputs["face_velocity"], nfeats["face_y"][:, 0:2], fmask),
            "face_pressure": mse_per_element(
                outputs["face_pressure"], nfeats["face_y"][:, 2:3], fmask),
        }
        total = combined_log_loss(comps, self.loss_weights)
        return {"total_log_loss": total,
                **{f"{k}_loss": v for k, v in comps.items()}}


class VertPotB(VertPotA):
    """Physical integration + MLS viscous term (VertPot.py:234-319). The
    reference denormalizes [u_f, v_f, p_f] and the potential's cell flux
    before its physical integrator (VertPot.py:262-266), normalizes only the
    acceleration again for the train-mode loss, and returns the
    network-space cell flux and face outputs in train mode
    (VertPot.py:269-281)."""

    name = "VertPotB"
    face_out_size = 3
    integrator_kind = "none"
    face_grad_weights_use = True
    nu = 1e-3

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        nfeats, _, face_out, cell_flux, _ = self._module_outputs(
            graph, feats, mode, generator)
        zeros = cell_flux.new_zeros((cell_flux.shape[0], 2))
        phys = norm.normalize_outputs(
            {"cell_out": torch.cat([zeros, cell_flux], dim=1),
             "face_out": face_out}, self.nmap, self.stats, inverse=True)
        uvp = phys["face_out"]                    # physical [u, v, p]
        pflux = phys["cell_out"][:, 2:5]          # physical cell flux (C, 3)
        # the physical integrator (VertPot.py:283-319): Phi_A = u_f times the
        # cell flux per local face (no area), the MLS viscous term and the
        # pressure with the areas
        grad = fvm.calc_gradient_tensor(uvp[:, 0:2], graph.face_grad_weights,
                                        graph.face_grad_neighbours)
        area = graph.face_area.reshape(-1, 1)
        gg = gather3(torch.cat([area, uvp[:, 0:2], grad, uvp[:, 2:3]], dim=1),
                     graph)                                    # (C, 3, 8)
        area3, uvf = gg[..., 0:1], gg[..., 1:3]
        phi_a = torch.sum(uvf * pflux[..., None], dim=1)
        g = gg[..., 3:7].reshape(-1, 3, 2, 2)
        phi_d = torch.sum(torch.einsum("cfkd,cfd->cfk", g, graph.cell_normal)
                          * area3, dim=1)
        phi_p = torch.sum(gg[..., 7:8] * graph.cell_normal * area3, dim=1)
        acc = physical_acceleration(graph, phi_a, phi_p, phi_d, nu=self.nu)
        if mode == "rollout":
            cvc, out_flux, out_face = acc, pflux, uvp
        else:
            cvc = norm.normalize_outputs(
                {"cell_out": torch.cat([acc, torch.zeros_like(cell_flux)],
                                       dim=1),
                 "face_out": None}, self.nmap, self.stats)["cell_out"][:, 0:2]
            out_flux, out_face = cell_flux, face_out       # network space
        return {
            "cell_velocity_change": cvc,
            "cell_flux": out_flux,
            "face_velocity": out_face[:, 0:2],
            "face_pressure": out_face[:, 2:3],
            "_nfeats": nfeats,
        }


class VertPotC(VertPotA):
    """[p, Dx, Dy] head; u_f by cell->face interpolation
    (VertPot.py:322-444)."""

    name = "VertPotC"
    face_out_size = 3
    integrator_kind = "fluxC"

    def normalisation_map(self) -> norm.NormalizationMap:
        """FluxA's map with the outputs [Δv, cell flux, p from face_out
        column 0]; the targets stay [u, v, p, phi]."""
        nmap = FluxA.normalisation_map(self)
        outputs = (
            _f("cell_velocity_change_x", "cell_out", 0, 1),
            _f("cell_velocity_change_y", "cell_out", 1, 2),
            _f("cell_flux", "cell_out", 2, 5, "face_flux"),
            _f("face_pressure", "face_out", 0, 1),
        )
        return nmap.replace(outputs=outputs)

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        nfeats, acc, face_out, cell_flux, extras = self._module_outputs(
            graph, feats, mode, generator)
        bundle = {"cell_out": torch.cat([acc, cell_flux], dim=1),
                  "face_out": face_out}
        if mode == "rollout":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats,
                                            inverse=True)
        return {
            "cell_velocity_change": bundle["cell_out"][:, 0:2],
            "cell_flux": bundle["cell_out"][:, 2:5],
            "face_pressure": bundle["face_out"][:, 0:1],
            "_nfeats": nfeats,
            **{f"_{k}": v for k, v in extras.items()},
        }

    def loss(self, outputs, feats, graph) -> Dict[str, torch.Tensor]:
        """Continuity of the cell flux, Δv and the face pressure
        (VertPot.py:411-444)."""
        nfeats = outputs["_nfeats"]
        cmask, fmask = graph.cell_mask, graph.face_mask
        div = fvm.divergence_from_cell_flux(outputs["cell_flux"])
        comps = {
            "continuity": mse_per_element(div, torch.zeros_like(div), cmask),
            "cell_velocity_change": mse_per_element(
                outputs["cell_velocity_change"], nfeats["cell_y"], cmask),
            "face_pressure": mse_per_element(
                outputs["face_pressure"], nfeats["face_y"][:, 2:3], fmask),
        }
        total = combined_log_loss(comps, self.loss_weights)
        return {"total_log_loss": total,
                **{f"{k}_loss": v for k, v in comps.items()}}


class VertPotD(VertPotA):
    """The owner-slot potential face flux through FluxA's integrator and
    normalization map (VertPot.py:447-492; the ``_alt`` conversion the
    reference names is undefined, and the owner-slot one is the only
    candidate in its tree). FluxA's loss runs on the integrator's signed
    regathered flux, which the outputs give as ``cell_flux`` (network space
    in every mode)."""

    name = "VertPotD"
    integrator_kind = "fluxD"

    def normalisation_map(self) -> norm.NormalizationMap:
        return FluxA.normalisation_map(self)

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        nfeats, acc, eo6, _, extras = self._module_outputs(graph, feats, mode,
                                                           generator)
        bundle = {"cell_out": acc, "face_out": eo6}
        if mode == "rollout":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats,
                                            inverse=True)
        face_out = bundle["face_out"]
        return {
            "cell_velocity_change": bundle["cell_out"][:, 0:2],
            "face_velocity": face_out[:, 0:2],
            "face_pressure": face_out[:, 2:3],
            "face_flux": face_out[:, 3:4],
            "cell_flux": extras["cell_flux"],
            "_nfeats": nfeats,
            **{f"_{k}": v for k, v in extras.items()},
        }

    loss = FluxA.loss


class VertPotE(FluxC):
    """FluxC's wiring with VertPot blocks (VertPot.py:494-539): the
    potential's owner-slot face flux is appended to the [p, Dx, Dy] head
    before FluxC's integrator and loss run on it. Reference quirks kept as
    they are: the integrator reads phi from column 1 (= Dx) and D from
    columns 2:4 (= [Dy, flux]); the output normalizer puts the flux
    statistics on column 1; ``face_velocity`` is columns 0:2 (= [p, Dx]),
    so the rollout's divergence metric reads those, and ``face_pressure``
    column 2:3 (= Dy) (VertPot.py:525, 536-539); and, as in FluxC, the
    feedback clamps the INFLOW/WALL faces' Δv to the t0 [p_f, phi_f]."""

    name = "VertPotE"

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _VertPotModule(self.arch,
                              face_in=5 + self.config.num_face_types,
                              face_out=3, integrator="fluxE",
                              generator=generator)

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        acc, eo, _, extras = self.module(nfeats["cell_x"], nfeats["face_x"],
                                         graph, mode == "train", generator)
        bundle = {"cell_out": acc, "face_out": eo}
        if mode == "rollout":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats,
                                            inverse=True)
        face_out = bundle["face_out"]
        return {
            "cell_velocity_change": bundle["cell_out"][:, 0:2],
            "face_velocity": face_out[:, 0:2],     # [p, Dx]
            "face_pressure": face_out[:, 2:3],     # Dy
            "face_flux": face_out[:, 3:4],
            "_nfeats": nfeats,
            **{f"_{k}": v for k, v in extras.items()},
        }


class VertPotF(VertPotA):
    """Physical integration of the owner-slot potential face flux
    (VertPot.py:541-628), under the shims of the ``fluxF`` integrator, with
    FluxA's loss on the signed cell flux. In rollout mode the acceleration
    leaves physical and the face outputs are never denormalized
    (VertPot.py:586-592); in train mode only the acceleration is normalized
    (VertPot.py:583-585)."""

    name = "VertPotF"
    face_out_size = 3
    integrator_kind = "fluxF"
    face_grad_weights_use = True

    def normalisation_map(self) -> norm.NormalizationMap:
        return FluxA.normalisation_map(self)

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        nfeats, acc, eo4, _, _ = self._module_outputs(graph, feats, mode,
                                                      generator)
        if mode != "rollout":
            acc = norm.normalize_outputs({"cell_out": acc, "face_out": None},
                                         self.nmap, self.stats)["cell_out"]
        cell_flux = fvm.face_flux_to_cell_flux_g(eo4[:, 3:4], graph)
        return {
            "cell_velocity_change": acc[:, 0:2],
            "face_velocity": eo4[:, 0:2],
            "face_pressure": eo4[:, 2:3],
            "face_flux": eo4[:, 3:4],
            "cell_flux": cell_flux[..., 0],
            "_nfeats": nfeats,
        }

    loss = FluxA.loss


class VertPotG(VertPotA):
    """Loss on the face flux converted from the cell flux
    (VertPot.py:631-818): the reference's last-write-wins conversion
    (``fvm.cell_flux_to_face_flux_lastwrite``) applied after the output
    normalization, so in train mode the converted flux carries the z-score
    mean shift with the larger-indexed write's orientation."""

    name = "VertPotG"

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        outputs = super().forward(graph, feats, mode, generator)
        outputs["face_flux"] = fvm.cell_flux_to_face_flux_lastwrite_g(
            outputs["cell_flux"], graph)
        return outputs

    def loss(self, outputs, feats, graph) -> Dict[str, torch.Tensor]:
        """Continuity from the unsigned face-flux sum, Δv, the face velocity
        and pressure, and the face flux, which weighs in the total but is
        left out of the returned terms, as the reference leaves it
        (VertPot.py:738-772)."""
        nfeats = outputs["_nfeats"]
        cmask, fmask = graph.cell_mask, graph.face_mask
        div = fvm.divergence_from_face_flux(outputs["face_flux"],
                                            graph.face_index)
        comps = {
            "continuity": mse_per_element(div, torch.zeros_like(div), cmask),
            "cell_velocity_change": mse_per_element(
                outputs["cell_velocity_change"], nfeats["cell_y"], cmask),
            "face_velocity": mse_per_element(
                outputs["face_velocity"], nfeats["face_y"][:, 0:2], fmask),
            "face_pressure": mse_per_element(
                outputs["face_pressure"], nfeats["face_y"][:, 2:3], fmask),
            "face_flux": mse_per_element(
                outputs["face_flux"], nfeats["face_y"][:, 3:4], fmask),
        }
        total = combined_log_loss(comps, self.loss_weights)
        losses = {f"{k}_loss": v for k, v in comps.items()
                  if k != "face_flux"}
        return {"total_log_loss": total, **losses}
