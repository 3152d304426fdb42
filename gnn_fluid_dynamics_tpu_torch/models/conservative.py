"""Conservative family (counterpart of ``models/conservative.py``; reference
``src/models/Conservative.py``): FVGN/MGN variants with symmetry-aware
message passing. Symmetric edge features (area, angle, distance, type) and
antisymmetric ones (Δv, normal) go through even and odd network branches, so
that flipping a face's orientation flips the learned flux's sign exactly.

========  ====================================================================
ConsA     asym-gated face block (the gate acts in the FIRST block only, a
          reference quirk kept), two-way signed cell aggregation
          (Conservative.py:49-262)
ConsB     the same blocks on MGN's cell-output head (265-414)
ConsD     parallel symmetric and antisymmetric streams every block;
          antisymmetric decoder ``final_mlp(symm + asym)`` (417-658)
ConsE     FVGN features; the edge latent split into symmetric and
          antisymmetric halves for the cell aggregation (661-733)
ConsF     vertex-mediated symmetric + edge-wise antisymmetric aggregation,
          3H face block (734-823)
ConsG     F with a sum-combined 2H face block (824-898)
ConsH     strict parity separation; even/odd decoder, softplus x tanh signed
          flux; std_scale normalization of the odd inputs (899-1210)
ConsI     BC-frozen edge latents each block (INFLOW/WALL rows keep their
          value from before the block) (1211-1319)
ConsJ     H's wiring + learned output scales + physical integrator
          (1320-1684)
ConsK     H with the antisymmetric branch at H/2 (1685-1954)
========  ====================================================================

Dtypes, as in the JAX package: every MLP and ``AntisymMLP`` of the family
runs in f32, whatever ``compute_dtype`` says; only the ``Encoder`` of E, F, G
and I takes the compute dtype. The one kernel work of the family is the
twice message passing of F, G and I (on ``[e_sym | e_sym]``, H wide) and H,
J and K (on ``[e_s | e_s]``, 2H wide): on the kernel route K3 -> K5, or K6
(es/er) -> K7 on a graph on the table route, on the latents rounded to bf16
(``arch.aggregate_twice_mp``). The face -> cell aggregation and the blocks'
``c[row]``/``c[col]`` gathers (``arch.gather_face_cells`` on its plain
route) are f32 index gathers on every route, as the JAX package has them. The blocks take no remat, as in the JAX package.

On a space-sharded graph (``parallel/spmd.py``) every module refreshes the
ghost rows of what the next step reads through an index table or a banded
table, at the points ``arch.GNBlock`` takes for the GN blocks: the encoders'
cell and face latents; in each block each sub-block's new latents (the
face MLP's output before the face -> cell sum and the residual, the cell
MLP's output before ``gather_face_cells`` and the residual), so that the
twice message passing (K3/K6 at the faces of an owned cell's vertices,
K5/K7 at its vertices) and the gathers read owners' rows; the face
decoder's output before the integrators' ``gather3``. Each refresh is a
no-op on a graph without a halo.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from gnn_fluid_dynamics_tpu_torch.models import normalizer as norm
from gnn_fluid_dynamics_tpu_torch.models import transforms as T
from gnn_fluid_dynamics_tpu_torch.models.arch import (MLP, AntisymMLP,
                                                      ArchConfig, Encoder,
                                                      FaceAreaNorm,
                                                      FvgnIntegrator,
                                                      LearnedScaleDenorm,
                                                      aggregate_faces_to_cells,
                                                      aggregate_twice_mp,
                                                      gather3,
                                                      gather_face_cells,
                                                      kernel_route,
                                                      physical_acceleration)
from gnn_fluid_dynamics_tpu_torch.models.fvgn import FvgnA, _f, _z
from gnn_fluid_dynamics_tpu_torch.models.losses import (combined_log_loss,
                                                        mse_per_element)
from gnn_fluid_dynamics_tpu_torch.models.mgn import MgnA
from gnn_fluid_dynamics_tpu_torch.ops import fvm
from gnn_fluid_dynamics_tpu_torch.parallel.halo import refresh

ASYM_IN = 4          # the antisymmetric face features: [Δv | n̂] or [Δv | Δpos]


def _ms(tensor, s, e):
    return norm.StatSpec("mean_scale", ("norm", tensor, s, e))


def _ss(tensor, s, e):
    return norm.StatSpec("std_scale", (tensor, s, e))


def conservative_face_features(graph, cell_velocity, num_types, bc_velocity):
    """x_symm = [area | angle(n̂, Δpos) | |Δpos| | one-hot]; x_asym = [Δv
    (the INFLOW faces' overridden by ``bc_velocity``) | n̂] (reference
    Conservative.py:86-97). Returns (face_xs, face_xa, bc_mask)."""
    dv = T.calc_face_velocity_change(cell_velocity, graph.cell_edge_index)
    bc_mask = ~T.interior_face_mask(graph.face_type)
    if bc_velocity is not None:
        dv = torch.where(bc_mask[:, None], bc_velocity, dv)
    ev = T.calc_cell_edge_vector(graph.cell_pos, graph.cell_edge_index)
    onehot = T.calc_face_type_one_hot(graph.face_type, num_types)
    dist = torch.linalg.vector_norm(ev, dim=1, keepdim=True)
    ev_n = ev / torch.clamp(dist, min=1e-12)
    n = graph.face_normal
    n_n = n / torch.clamp(torch.linalg.vector_norm(n, dim=1, keepdim=True),
                          min=1e-12)
    dot = torch.sum(ev_n * n_n, dim=1, keepdim=True)
    angle = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    face_xs = torch.cat([graph.face_area, angle, dist, onehot.to(dv.dtype)],
                        dim=1)
    face_xa = torch.cat([dv, n_n], dim=1)
    return face_xs, face_xa, bc_mask


def _refresh_faces(graph, *parts):
    """The face-row tensors ``parts`` with their ghost rows refreshed, in one
    exchange of their concatenation (each part itself without a halo)."""
    if graph.halo is None:
        return parts
    whole = refresh(torch.cat(parts, dim=1), graph, "face")
    return whole.split([p.shape[1] for p in parts], dim=1)


def _input_state(graph, generator, mode, noise_std):
    """The t0 cell velocity (noised in train mode with a generator and a
    noise), the Δv target, and the graph (its edges flipped in train mode
    with a generator): the family's ``transform_features`` head
    (Conservative.py:67-85)."""
    cell_velocity = graph.cell_velocity[:, 0]
    train = mode == "train" and generator is not None
    if train and noise_std:
        cell_velocity = T.add_noise(generator, cell_velocity, noise_std)
    cell_y = graph.cell_velocity[:, -1] - cell_velocity
    if train:
        graph, _ = T.random_edge_flip(generator, graph)
    return graph, cell_velocity, cell_y


# ---- A, B: the gated blocks ----------------------------------------------------

class _ConsEncoder(nn.Module):
    """Symmetric face MLP, bias-free odd face MLP, cell MLP
    (Conservative.py:191-202). Returns (c, e_s, e_a)."""

    def __init__(self, cfg: ArchConfig, face_s_in: int,
                 generator: torch.Generator = None):
        super().__init__()
        H = cfg.hidden
        self.faceS_mlp = MLP(face_s_in, H, H, dropout_rate=cfg.dropout_rate,
                             generator=generator)
        self.faceA_mlp = AntisymMLP(ASYM_IN, H, H, generator=generator)
        self.cell_mlp = MLP(2, H, H, dropout_rate=cfg.dropout_rate,
                            generator=generator)

    def forward(self, cell_x, face_xs, face_xa, graph, train=False,
                rng=None):
        e_s, e_a = _refresh_faces(graph, self.faceS_mlp(face_xs, train, rng),
                                  self.faceA_mlp(face_xa))
        return (refresh(self.cell_mlp(cell_x, train, rng), graph, "cell"),
                e_s, e_a)


class _ConsABlock(nn.Module):
    """Face: mlp([e | x_r + x_c]), times the gate where given; cell:
    mlp([x | the two-way signed face sum]); residuals
    (Conservative.py:204-254)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None):
        super().__init__()
        H = cfg.hidden
        self.face_mlp = MLP(2 * H, H, H, dropout_rate=cfg.dropout_rate,
                            generator=generator)
        self.cell_mlp = MLP(2 * H, H, H, dropout_rate=cfg.dropout_rate,
                            generator=generator)

    def forward(self, cell_attr, edge_attr, gate, graph, train=False,
                rng=None):
        own, nbr = gather_face_cells(cell_attr, graph)
        e = self.face_mlp(torch.cat([edge_attr, own + nbr], dim=1), train, rng)
        if gate is not None:
            e = e * gate
        e = refresh(e, graph, "face")
        agg = aggregate_faces_to_cells(e, graph, antisym=True)
        c = refresh(self.cell_mlp(torch.cat([cell_attr, agg], dim=-1), train,
                                  rng), graph, "cell")
        return cell_attr + c, edge_attr + e


class _ConsAModule(nn.Module):
    """Encoder -> mp_num gated blocks (the gate, the odd encoder's output,
    in block 0 only) -> decoder heads of ``face_out`` / ``cell_out``
    channels (0 leaves one out). With ``integrate`` FVGN's integrator on
    the face head: returns (acc, face_out, extras); without, the cell head's
    output alone (ConservativeB, as MGN's module returns it)."""

    def __init__(self, cfg: ArchConfig, face_s_in: int, face_out: int = 0,
                 cell_out: int = 0, integrate: bool = True,
                 generator: torch.Generator = None):
        super().__init__()
        H = cfg.hidden
        self.encoder = _ConsEncoder(cfg, face_s_in, generator)
        self.blocks = nn.ModuleList(_ConsABlock(cfg, generator)
                                    for _ in range(cfg.mp_num))
        self.decoder_face, self.decoder_cell = (
            MLP(H, H, n, layer_norm=False, dropout_rate=cfg.dropout_rate,
                generator=generator) if n else None
            for n in (face_out, cell_out))
        self.integrator = FvgnIntegrator() if integrate else None

    def forward(self, cell_x, face_xs, face_xa, graph, train=False, rng=None):
        cell_attr, edge_attr, gate = self.encoder(cell_x, face_xs, face_xa,
                                                  graph, train, rng)
        for i, block in enumerate(self.blocks):
            # reference quirk: the asymmetric gate survives only block 0
            cell_attr, edge_attr = block(cell_attr, edge_attr,
                                         gate if i == 0 else None, graph,
                                         train, rng)
        face_out = cell_out = None
        if self.decoder_face is not None:
            face_out = refresh(self.decoder_face(edge_attr, train, rng), graph,
                               "face")
        if self.decoder_cell is not None:
            cell_out = self.decoder_cell(cell_attr, train, rng)
        if self.integrator is None:
            return cell_out
        acc, extras = self.integrator(face_out, graph, train)
        return acc, face_out, extras


class ConservativeA(FvgnA):
    """Conservative message passing on the FVGN head
    (Conservative.py:49-262)."""

    name = "ConservativeA"

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _ConsAModule(self.arch, face_s_in=3 + self.config.num_face_types,
                            face_out=5, generator=generator)

    def module_inputs(self, nfeats: Dict) -> tuple:
        return (nfeats["cell_x"], nfeats["face_xs"], nfeats["face_xa"])

    def normalisation_map(self) -> norm.NormalizationMap:
        registry = {
            "cell_velocity_x": _z("cell_x", 0, 1),
            "cell_velocity_y": _z("cell_x", 1, 2),
            "cell_velocity_change_x": _z("cell_y", 0, 1),
            "cell_velocity_change_y": _z("cell_y", 1, 2),
            "face_area": _z("face_xs", 0, 1),
            "face_adjacent_distance": _z("face_xs", 2, 3),
            "face_velocity_x": _z("face_y", 0, 1),
            "face_velocity_y": _z("face_y", 1, 2),
            "face_pressure": _z("face_y", 2, 3),
            "face_velocity_diff_char": _ms("face_xa", 0, 2),
        }
        inputs = (
            _f("cell_velocity_x", "cell_x", 0, 1),
            _f("cell_velocity_y", "cell_x", 1, 2),
            _f("face_velocity_diff", "face_xa", 0, 2, "face_velocity_diff_char"),
            _f("face_area", "face_xs", 0, 1),
            _f("face_adjacent_distance", "face_xs", 2, 3),
            _f("cell_velocity_change_x", "cell_y", 0, 1),
            _f("cell_velocity_change_y", "cell_y", 1, 2),
            _f("face_velocity_x", "face_y", 0, 1),
            _f("face_velocity_y", "face_y", 1, 2),
            _f("face_pressure", "face_y", 2, 3),
        )
        outputs = (
            _f("cell_velocity_change_x", "cell_out", 0, 1),
            _f("cell_velocity_change_y", "cell_out", 1, 2),
            _f("face_velocity_x", "face_out", 0, 1),
            _f("face_velocity_y", "face_out", 1, 2),
            _f("face_pressure", "face_out", 2, 3),
        )
        return norm.NormalizationMap(registry, inputs, outputs)

    def transform_features(self, graph, generator: torch.Generator = None,
                           mode: str = "rollout", noise_std: float = 0.0):
        """Features (Conservative.py:67-103): the split face features of
        :func:`conservative_face_features`, the t0 face velocity on the
        INFLOW faces' Δv."""
        graph, cell_velocity, cell_y = _input_state(graph, generator, mode,
                                                    noise_std)
        face_xs, face_xa, bc_mask = conservative_face_features(
            graph, cell_velocity, self.config.num_face_types,
            bc_velocity=graph.face_velocity[:, 0])
        face_y = torch.cat([graph.face_velocity[:, -1],
                            graph.face_pressure[:, -1]], dim=1)
        return graph, {"cell_x": cell_velocity, "cell_y": cell_y,
                       "face_xs": face_xs, "face_xa": face_xa,
                       "face_y": face_y, "face_bc_mask": bc_mask}

    def update_features(self, solutions, feats, graph):
        """Rollout feedback into x_asym (Conservative.py:147-162): Δv of the
        new cell velocity, the INFLOW/WALL faces' clamped to ``face_y``'s
        first two columns."""
        new_feats = dict(feats)
        v = solutions["cell_velocity"]
        new_feats["cell_x"] = v
        dv = T.calc_face_velocity_change(v[:, :2], graph.cell_edge_index)
        mask = T.rollout_bc_mask(graph.face_type)
        dv = torch.where(mask[:, None], feats["face_y"][:, 0:2], dv)
        new_feats["face_xa"] = torch.cat([dv, feats["face_xa"][:, 2:]], dim=1)
        return new_feats


class ConservativeB(MgnA):
    """Conservative blocks on MGN's cell-output head, no integrator, with
    MLS cell weights (Conservative.py:265-414)."""

    name = "ConservativeB"

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _ConsAModule(self.arch, face_s_in=3 + self.config.num_face_types,
                            cell_out=3, integrate=False, generator=generator)

    module_inputs = ConservativeA.module_inputs
    update_features = ConservativeA.update_features

    def normalisation_map(self) -> norm.NormalizationMap:
        base = ConservativeA.normalisation_map(self)
        registry = dict(base.registry)
        del registry["face_pressure"]
        registry["cell_pressure"] = _z("cell_y", 2, 3)
        inputs = tuple(f for f in base.inputs if f.name != "face_pressure") + (
            _f("cell_pressure", "cell_y", 2, 3),)
        outputs = (
            _f("cell_velocity_change_x", "cell_out", 0, 1),
            _f("cell_velocity_change_y", "cell_out", 1, 2),
            _f("cell_pressure", "cell_out", 2, 3),
        )
        return norm.NormalizationMap(registry, inputs, outputs)

    def transform_features(self, graph, generator: torch.Generator = None,
                           mode: str = "rollout", noise_std: float = 0.0):
        """ConservativeA's features with the target [Δv, p] and the face
        velocity at the window's end as ``face_y`` (the BC targets)."""
        graph, feats = ConservativeA.transform_features(self, graph, generator,
                                                        mode, noise_std)
        feats["cell_y"] = torch.cat([feats["cell_y"],
                                     graph.cell_pressure[:, -1]], dim=1)
        feats["face_y"] = graph.face_velocity[:, -1]
        return graph, feats


# ---- D: parallel streams ---------------------------------------------------------

class _ConsDBlock(nn.Module):
    """Parallel symmetric and antisymmetric streams (Conservative.py:572-645)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None):
        super().__init__()
        H = cfg.hidden
        self.face_symm = MLP(2 * H, H, H, dropout_rate=cfg.dropout_rate,
                             generator=generator)
        self.face_asym = AntisymMLP(2 * H, H, H, generator=generator)
        self.cell_mlp = MLP(3 * H, H, H, dropout_rate=cfg.dropout_rate,
                            generator=generator)

    def forward(self, cell_attr, e_s, e_a, graph, train=False, rng=None):
        own, nbr = gather_face_cells(cell_attr, graph)
        new_s, new_a = _refresh_faces(
            graph,
            self.face_symm(torch.cat([e_s, own + nbr], dim=1), train, rng),
            self.face_asym(torch.cat([e_a, own - nbr], dim=1)))
        symm_agg = aggregate_faces_to_cells(new_s, graph, antisym=False)
        asym_agg = aggregate_faces_to_cells(new_a, graph, antisym=True)
        new_c = refresh(self.cell_mlp(torch.cat([cell_attr, symm_agg,
                                                 asym_agg], dim=-1),
                                      train, rng), graph, "cell")
        return cell_attr + new_c, e_s + new_s, e_a + new_a


class _ConsDModule(nn.Module):
    """Encoder -> mp_num parallel-stream blocks -> the antisymmetric decoder
    ``AntisymMLP(symm_mlp(e_s) + asym_mlp(e_a))`` (Conservative.py:647-658)
    -> FVGN's integrator. Returns (acc, face_out, extras)."""

    def __init__(self, cfg: ArchConfig, face_s_in: int,
                 generator: torch.Generator = None):
        super().__init__()
        H = cfg.hidden
        self.encoder = _ConsEncoder(cfg, face_s_in, generator)
        self.blocks = nn.ModuleList(_ConsDBlock(cfg, generator)
                                    for _ in range(cfg.mp_num))
        self.symm_mlp = MLP(H, H, H, layer_norm=False, generator=generator)
        self.asym_mlp = AntisymMLP(H, H, H, generator=generator)
        self.decoder_face = AntisymMLP(H, H, 5, generator=generator)
        self.integrator = FvgnIntegrator()

    def forward(self, cell_x, face_xs, face_xa, graph, train=False, rng=None):
        cell_attr, e_s, e_a = self.encoder(cell_x, face_xs, face_xa, graph,
                                           train, rng)
        for block in self.blocks:
            cell_attr, e_s, e_a = block(cell_attr, e_s, e_a, graph, train, rng)
        face_out = refresh(self.decoder_face(self.symm_mlp(e_s, train, rng)
                                             + self.asym_mlp(e_a)),
                           graph, "face")
        acc, extras = self.integrator(face_out, graph, train)
        return acc, face_out, extras


class ConservativeD(ConservativeA):
    """Parallel symmetric/antisymmetric streams with an antisymmetric
    decoder (Conservative.py:417-658)."""

    name = "ConservativeD"

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _ConsDModule(self.arch, face_s_in=3 + self.config.num_face_types,
                            generator=generator)


# ---- E, F, G, I: FVGN's features and encoder, conservative blocks ------------

class _ConsEBlock(nn.Module):
    """FVGN's face block, then the edge latent split into symmetric and
    antisymmetric halves for the cell aggregation (Conservative.py:671-732)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None):
        super().__init__()
        H = cfg.hidden
        self.face_mlp = MLP(2 * H, H, H, dropout_rate=cfg.dropout_rate,
                            generator=generator)
        self.cell_mlp = MLP(2 * H, H, H, dropout_rate=cfg.dropout_rate,
                            generator=generator)

    def forward(self, cell_attr, edge_attr, graph, train=False, rng=None,
                use_kernels=False):
        own, nbr = gather_face_cells(cell_attr, graph)
        e = refresh(self.face_mlp(torch.cat([edge_attr, own + nbr], dim=1),
                                  train, rng), graph, "face")
        h2 = e.shape[1] // 2
        sym_msg = aggregate_faces_to_cells(e[:, :h2], graph, antisym=False)
        asym_msg = aggregate_faces_to_cells(e[:, h2:], graph, antisym=True)
        c = refresh(self.cell_mlp(torch.cat([cell_attr, sym_msg, asym_msg],
                                            dim=-1), train, rng), graph, "cell")
        return cell_attr + c, edge_attr + e


class _ConsFBlock(nn.Module):
    """Cell-first: the symmetric half through the vertices (twice message
    passing on ``[e_sym | e_sym]``, duplicated rather than forward/reverse
    halves) and the antisymmetric half edge-wise, then the face block on
    the cell MLP's raw output, ``[e | c_r | c_c]`` (F, 3H) or ``[e | c_r +
    c_c]`` (G, 2H) (Conservative.py:757-821)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None,
                 face_combine: str = "concat"):
        super().__init__()
        H = cfg.hidden
        self.face_combine = face_combine
        self.cell_mlp = MLP(2 * H, H, H, dropout_rate=cfg.dropout_rate,
                            generator=generator)
        self.face_mlp = MLP((3 if face_combine == "concat" else 2) * H, H, H,
                            dropout_rate=cfg.dropout_rate, generator=generator)

    def forward(self, cell_attr, edge_attr, graph, train=False, rng=None,
                use_kernels=False):
        h2 = edge_attr.shape[1] // 2
        e_sym = edge_attr[:, :h2]
        cell_agg = aggregate_twice_mp(torch.cat([e_sym, e_sym], dim=-1), graph,
                                      use_kernels)
        asym_agg = aggregate_faces_to_cells(edge_attr[:, h2:], graph,
                                            antisym=True)
        c = refresh(self.cell_mlp(torch.cat([cell_attr, cell_agg, asym_agg],
                                            dim=-1), train, rng), graph, "cell")
        own, nbr = gather_face_cells(c, graph)
        parts = ([edge_attr, own, nbr] if self.face_combine == "concat"
                 else [edge_attr, own + nbr])
        e = refresh(self.face_mlp(torch.cat(parts, dim=1), train, rng), graph,
                    "face")
        return cell_attr + c, edge_attr + e


class _ConsGBlock(_ConsFBlock):
    """F's block with the sum-combined face block (Flax ``_ConsGBlock``,
    Conservative.py:824-898); a class of its own, as there, so that its
    parameters take the Flax names (``weights.flax_paths``)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None):
        super().__init__(cfg, generator, face_combine="sum")


class _ConsIBlock(nn.Module):
    """F's aggregation and the sum-combined face block on the raw cell
    output; after the residual the INFLOW/WALL edge rows revert to their
    value before the block (Conservative.py:1247-1269)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None):
        super().__init__()
        H = cfg.hidden
        self.cell_mlp = MLP(2 * H, H, H, dropout_rate=cfg.dropout_rate,
                            generator=generator)
        self.face_mlp = MLP(2 * H, H, H, dropout_rate=cfg.dropout_rate,
                            generator=generator)

    def forward(self, cell_attr, edge_attr, graph, train=False, rng=None,
                use_kernels=False):
        h2 = edge_attr.shape[1] // 2
        e_sym = edge_attr[:, :h2]
        cell_agg = aggregate_twice_mp(torch.cat([e_sym, e_sym], dim=-1), graph,
                                      use_kernels)
        asym_agg = aggregate_faces_to_cells(edge_attr[:, h2:], graph,
                                            antisym=True)
        c_new = refresh(self.cell_mlp(torch.cat([cell_attr, cell_agg,
                                                 asym_agg], dim=-1),
                                      train, rng), graph, "cell")
        own, nbr = gather_face_cells(c_new, graph)
        e_new = refresh(self.face_mlp(torch.cat([edge_attr, own + nbr], dim=1),
                                      train, rng), graph, "face")
        bc = T.rollout_bc_mask(graph.face_type)
        edge_out = torch.where(bc[:, None], edge_attr, edge_attr + e_new)
        return cell_attr + c_new, edge_out


class _StdEPDWithBlocks(nn.Module):
    """FVGN's encoder (in the compute dtype) around the family's blocks, then
    an f32 face decoder and FVGN's integrator (Flax ``_StdEPDWithBlocks``).
    FvgnA's ``EncodeProcessDecode`` decodes in the compute dtype instead, so
    it is not this. Returns (acc, face_out, extras)."""

    def __init__(self, cfg: ArchConfig, make_block, face_in: int,
                 out_size: int = 5, generator: torch.Generator = None):
        super().__init__()
        H = cfg.hidden
        self.cfg = cfg
        self.encoder = Encoder(cfg, cell_in=2, face_in=face_in,
                               generator=generator)
        self.blocks = nn.ModuleList(make_block(cfg, generator)
                                    for _ in range(cfg.mp_num))
        self.decoder_face = MLP(H, H, out_size, layer_norm=False,
                                dropout_rate=cfg.dropout_rate,
                                generator=generator)
        self.integrator = FvgnIntegrator()

    def forward(self, cell_x, face_x, graph, train=False, rng=None):
        cell_attr, edge_attr = self.encoder(cell_x, face_x, train, rng)
        cell_attr = refresh(cell_attr, graph, "cell")
        edge_attr = refresh(edge_attr, graph, "face")
        use_kernels = kernel_route(self.cfg, cell_attr, train)
        for block in self.blocks:
            cell_attr, edge_attr = block(cell_attr, edge_attr, graph, train,
                                         rng, use_kernels)
        face_out = refresh(self.decoder_face(edge_attr, train, rng), graph,
                           "face")
        acc, extras = self.integrator(face_out, graph, train)
        return acc, face_out, extras


class ConservativeE(FvgnA):
    """FvgnA with the symmetric/antisymmetric split cell aggregation
    (Conservative.py:661-733)."""

    name = "ConservativeE"
    block = staticmethod(_ConsEBlock)

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _StdEPDWithBlocks(self.arch, self.block,
                                 face_in=5 + self.config.num_face_types,
                                 generator=generator)


class ConservativeF(ConservativeE):
    """Vertex symmetric + edge antisymmetric aggregation, 3H face block
    (Conservative.py:734-823)."""

    name = "ConservativeF"
    block = staticmethod(_ConsFBlock)


class ConservativeG(ConservativeE):
    """F with the sum-combined face block (Conservative.py:824-898)."""

    name = "ConservativeG"

    block = staticmethod(_ConsGBlock)


class ConservativeI(ConservativeE):
    """BC-aware blocks: the boundary edge latents frozen through the
    processor (Conservative.py:1211-1319)."""

    name = "ConservativeI"
    block = staticmethod(_ConsIBlock)


# ---- H, J, K: strict parity separation --------------------------------------------

class _ConsHBlock(nn.Module):
    """Cell-first parity block (Conservative.py:1098-1184): the symmetric
    latents through the vertices (twice message passing on ``[e_s | e_s]``,
    2H wide), the antisymmetric ones edge-wise; then the symmetric face MLP
    on ``[e_s | c_r + c_c]`` and the odd one on ``[e_a | c_r - c_c]`` of the
    raw cell output. ``asym_width`` (Ha) is H, or H/2 in ConservativeK."""

    def __init__(self, cfg: ArchConfig, asym_width: int,
                 generator: torch.Generator = None):
        super().__init__()
        H = cfg.hidden
        self.cell_mlp = MLP(2 * H + asym_width, H, H,
                            dropout_rate=cfg.dropout_rate, generator=generator)
        self.face_symm = MLP(2 * H, H, H, dropout_rate=cfg.dropout_rate,
                             generator=generator)
        self.face_asym = AntisymMLP(asym_width + H, H, asym_width,
                                    generator=generator)

    def forward(self, cell_attr, e_s, e_a, graph, train=False, rng=None,
                use_kernels=False):
        cell_agg = aggregate_twice_mp(torch.cat([e_s, e_s], dim=-1), graph,
                                      use_kernels)
        asym_agg = aggregate_faces_to_cells(e_a, graph, antisym=True)
        c_new = refresh(self.cell_mlp(torch.cat([cell_attr, cell_agg,
                                                 asym_agg], dim=-1),
                                      train, rng), graph, "cell")
        own, nbr = gather_face_cells(c_new, graph)
        s_new, a_new = _refresh_faces(
            graph,
            self.face_symm(torch.cat([e_s, own + nbr], dim=1), train, rng),
            self.face_asym(torch.cat([e_a, own - nbr], dim=1)))
        return cell_attr + c_new, e_s + s_new, e_a + a_new


class _ParityDecoder(nn.Module):
    """Even head on [h+ | (h-)^2] -> (u, v, p, |q|); odd head on [h- | h+]
    -> the sign; q = softplus(|q|) tanh(odd) (Conservative.py:1186-1208).
    Returns (F, 5): [u, v, p, q_x, q_y]."""

    def __init__(self, cfg: ArchConfig, asym_width: int,
                 generator: torch.Generator = None):
        super().__init__()
        H = cfg.hidden
        self.even_mlp = MLP(H + asym_width, H, 5, layer_norm=False,
                            generator=generator)
        self.odd_mlp = AntisymMLP(asym_width + H, H, 2, generator=generator)

    def forward(self, e_s, e_a, train=False, rng=None):
        uvp_qmag = self.even_mlp(torch.cat([e_s, e_a ** 2], dim=-1), train, rng)
        s_odd = torch.tanh(self.odd_mlp(torch.cat([e_a, e_s], dim=-1)))
        q = F.softplus(uvp_qmag[:, 3:5]) * s_odd
        return torch.cat([uvp_qmag[:, 0:2], uvp_qmag[:, 2:3], q], dim=-1)


def _signed_flux_terms(face_out, weight, graph):
    """(Phi_A, Phi_P, Phi_D) per cell from [u, v, p, q_x, q_y] face outputs
    and the per-face ``weight`` (F, 1): advection of uu . n, pressure p n
    and the signed scalar flux q . n, each times the weight, summed over
    the cell's 3 faces (Conservative.py:1041-1082, 1520-1556)."""
    unv = graph.cell_normal
    uv = face_out[:, :2]
    uu_vu = torch.cat([uv[:, 0:1] * uv, uv[:, 1:2] * uv], dim=-1)
    g = gather3(torch.cat([weight, uu_vu, face_out[:, 3:5], face_out[:, 2:3]],
                          dim=1), graph)                    # (C, 3, 8)
    e, uu = g[..., 0:1], g[..., 1:5].reshape(-1, 3, 2, 2)
    qf, pf = g[..., 5:7], g[..., 7:8]
    phi_a = torch.sum(torch.einsum("cfkd,cfd->cfk", uu, unv) * e, dim=1)
    phi_d = torch.sum(qf * unv * e, dim=1)
    phi_p = torch.sum(pf * unv * e, dim=1)
    return phi_a, phi_p, phi_d


class _ConsHIntegrator(nn.Module):
    """FVGN's normalized integrator whose diffusive term is the signed
    scalar flux times the outward normal, with the BatchNorm'd area dt / V̄
    weights (Conservative.py:1041-1082). Returns (acc, {"norm_face_area"})."""

    def __init__(self, rho: float = 1.0):
        super().__init__()
        self.rho = rho
        self.face_area_norm = FaceAreaNorm()

    def forward(self, edge_output, graph, train=False):
        face_area = self.face_area_norm(graph, train)
        phi_a, phi_p, phi_d = _signed_flux_terms(edge_output, face_area, graph)
        acc = -phi_a - phi_p / self.rho + phi_d
        acc = torch.where(graph.cell_mask[:, None], acc, torch.zeros_like(acc))
        return acc, {"norm_face_area": face_area}


class _ConsHModule(nn.Module):
    """H's encoder MLPs (at the top of the tree, as in the Flax module) ->
    mp_num parity blocks -> the parity decoder -> the integrator. J
    (``learned_scale``, ``physical``): learned output scales (velocity x 1.0
    and y 0.01, pressure 1.0, each with a bias, and a diffusion scale 1.0)
    and the physical q . n integrator, mean(dt)/V (-Phi_A - Phi_P + 0.001
    Phi_D) on the raw face areas (Conservative.py:1336-1343, 1496-1556).
    Returns (acc, face_out, extras)."""

    def __init__(self, cfg: ArchConfig, face_s_in: int, asym_width: int = 0,
                 learned_scale: bool = False, physical: bool = False,
                 generator: torch.Generator = None):
        super().__init__()
        H = cfg.hidden
        Ha = asym_width or H
        self.cfg = cfg
        self.faceS_mlp = MLP(face_s_in, H, H, dropout_rate=cfg.dropout_rate,
                             generator=generator)
        self.faceA_mlp = AntisymMLP(ASYM_IN, H, Ha, generator=generator)
        self.cell_mlp = MLP(2, H, H, dropout_rate=cfg.dropout_rate,
                            generator=generator)
        self.blocks = nn.ModuleList(_ConsHBlock(cfg, Ha, generator)
                                    for _ in range(cfg.mp_num))
        self.decoder = _ParityDecoder(cfg, Ha, generator)
        self.learned_scale = learned_scale
        if learned_scale:
            self.velocity_scale_x = LearnedScaleDenorm(1, 1.0, learn_bias=True)
            self.velocity_scale_y = LearnedScaleDenorm(1, 0.01, learn_bias=True)
            self.pressure_scale = LearnedScaleDenorm(1, 1.0, learn_bias=True)
            self.diffusion_scale = nn.Parameter(torch.ones(1))
        self.integrator = None if physical else _ConsHIntegrator()

    def forward(self, cell_x, face_xs, face_xa, graph, train=False, rng=None):
        e_s, e_a = _refresh_faces(graph, self.faceS_mlp(face_xs, train, rng),
                                  self.faceA_mlp(face_xa))
        cell_attr = refresh(self.cell_mlp(cell_x, train, rng), graph, "cell")
        use_kernels = kernel_route(self.cfg, cell_attr, train)
        for block in self.blocks:
            cell_attr, e_s, e_a = block(cell_attr, e_s, e_a, graph, train, rng,
                                        use_kernels)
        face_out = self.decoder(e_s, e_a, train, rng)
        if self.learned_scale:
            face_out = torch.cat([
                self.velocity_scale_x(face_out[:, 0:1]),
                self.velocity_scale_y(face_out[:, 1:2]),
                self.pressure_scale(face_out[:, 2:3]),
                face_out[:, 3:5] * self.diffusion_scale], dim=-1)
        face_out = refresh(face_out, graph, "face")
        if self.integrator is None:
            phi_a, phi_p, phi_d = _signed_flux_terms(
                face_out, graph.face_area.reshape(-1, 1), graph)
            return (physical_acceleration(graph, phi_a, phi_p, phi_d,
                                          nu=0.001), face_out, {})
        acc, extras = self.integrator(face_out, graph, train)
        return acc, face_out, extras


class ConservativeH(ConservativeA):
    """Strict parity separation with the even/odd decoder
    (Conservative.py:899-1210)."""

    name = "ConservativeH"

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _ConsHModule(self.arch, face_s_in=1 + self.config.num_face_types,
                            generator=generator)

    def normalisation_map(self) -> norm.NormalizationMap:
        registry = {
            "cell_velocity_x": _z("cell_x", 0, 1),
            "cell_velocity_y": _z("cell_x", 1, 2),
            "cell_velocity_change_x": _z("cell_y", 0, 1),
            "cell_velocity_change_y": _z("cell_y", 1, 2),
            "face_area": _z("face_xs", 0, 1),
            "face_velocity_x": _z("face_y", 0, 1),
            "face_velocity_y": _z("face_y", 1, 2),
            "face_pressure": _z("face_y", 2, 3),
            # the odd inputs keep their zero mean: std_scale
            "face_velocity_diff_x": _ss("face_xa", 0, 1),
            "face_velocity_diff_y": _ss("face_xa", 1, 2),
            "face_edge_vector_x": _ss("face_xa", 2, 3),
            "face_edge_vector_y": _ss("face_xa", 3, 4),
        }
        inputs = (
            _f("cell_velocity_x", "cell_x", 0, 1),
            _f("cell_velocity_y", "cell_x", 1, 2),
            _f("face_velocity_diff_x", "face_xa", 0, 1),
            _f("face_velocity_diff_y", "face_xa", 1, 2),
            _f("face_area", "face_xs", 0, 1),
            _f("face_edge_vector_x", "face_xa", 2, 3),
            _f("face_edge_vector_y", "face_xa", 3, 4),
            _f("cell_velocity_change_x", "cell_y", 0, 1),
            _f("cell_velocity_change_y", "cell_y", 1, 2),
            _f("face_velocity_x", "face_y", 0, 1),
            _f("face_velocity_y", "face_y", 1, 2),
            _f("face_pressure", "face_y", 2, 3),
        )
        return norm.NormalizationMap(registry, inputs,
                                     ConservativeA.normalisation_map(self).outputs)

    def transform_features(self, graph, generator: torch.Generator = None,
                           mode: str = "rollout", noise_std: float = 0.0):
        """x_symm = [area | one-hot], x_asym = [Δv (the t0 face velocity on
        the INFLOW faces) | Δpos] (Conservative.py:916-945)."""
        graph, cell_velocity, cell_y = _input_state(graph, generator, mode,
                                                    noise_std)
        dv = T.calc_face_velocity_change(cell_velocity, graph.cell_edge_index)
        bc_mask = ~T.interior_face_mask(graph.face_type)
        dv = torch.where(bc_mask[:, None], graph.face_velocity[:, 0], dv)
        ev = T.calc_cell_edge_vector(graph.cell_pos, graph.cell_edge_index)
        onehot = T.calc_face_type_one_hot(graph.face_type,
                                          self.config.num_face_types)
        face_y = torch.cat([graph.face_velocity[:, -1],
                            graph.face_pressure[:, -1]], dim=1)
        return graph, {"cell_x": cell_velocity, "cell_y": cell_y,
                       "face_xs": torch.cat([graph.face_area,
                                             onehot.to(dv.dtype)], dim=1),
                       "face_xa": torch.cat([dv, ev], dim=1),
                       "face_y": face_y, "face_bc_mask": bc_mask}


class ConservativeJ(ConservativeH):
    """H with learned output scales and the physical integrator; its
    outputs are physical, normalized again for the loss outside rollout
    mode (Conservative.py:1320-1684)."""

    name = "ConservativeJ"

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _ConsHModule(self.arch, face_s_in=1 + self.config.num_face_types,
                            learned_scale=True, physical=True,
                            generator=generator)

    def forward(self, graph, feats: Dict, mode: str = "rollout",
                generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        nfeats = norm.normalize_inputs(feats, self.nmap, self.stats)
        acc, face_phys, _ = self.module(*self.module_inputs(nfeats), graph,
                                        mode == "train", generator)
        bundle = {"cell_out": acc, "face_out": face_phys}
        if mode != "rollout":
            bundle = norm.normalize_outputs(bundle, self.nmap, self.stats)
        return {
            "cell_velocity_change": bundle["cell_out"][:, 0:2],
            "face_velocity": bundle["face_out"][:, 0:2],
            "face_pressure": bundle["face_out"][:, 2:3],
            "_nfeats": nfeats,
        }

    def loss(self, outputs, feats, graph) -> Dict[str, torch.Tensor]:
        """FvgnA's four terms, continuity on the normalized face area of
        x_symm, ``face_xs[:, 0:1]`` (Conservative.py:1445-1450)."""
        nfeats = outputs["_nfeats"]
        cmask, fmask = graph.cell_mask, graph.face_mask
        div = fvm.divergence_from_uf(outputs["face_velocity"], graph.cell_normal,
                                     nfeats["face_xs"][:, 0:1],
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


class ConservativeK(ConservativeH):
    """H with the antisymmetric branch at H/2 (Conservative.py:1685-1954)."""

    name = "ConservativeK"

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return _ConsHModule(self.arch, face_s_in=1 + self.config.num_face_types,
                            asym_width=self.arch.hidden // 2,
                            generator=generator)
