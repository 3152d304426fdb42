"""Core neural architecture: MLPs, GN blocks, encode-process-decode.

Counterpart of ``gnn_fluid_dynamics_tpu/models/arch.py`` for what FluxD's
rollout runs. Module and parameter names follow the Flax tree, so
:func:`gnn_fluid_dynamics_tpu_torch.weights.params_from_flax` maps one onto the
other.

The GN blocks have two paths, as in the JAX package:

* the **fused** path: per block, the edge->vertex sum (K3), the fused cell
  block (K2) and the fused face block (K1) of
  :mod:`gnn_fluid_dynamics_tpu_torch.ops.kernels`, with bf16 latents between
  them — the CUDA kernels on the card, their plain versions on the CPU;
* the **plain** (unfused) path: segment aggregation, row gathers and the
  :class:`MLP` modules in the configured compute dtype.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from gnn_fluid_dynamics_tpu_torch.ops import kernels
from gnn_fluid_dynamics_tpu_torch.ops import segment as seg_ops

AGGREGATIONS = ("segment", "pallas", "auto")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    hidden: int = 128
    mp_num: int = 15
    # "segment": the plain path; "pallas": the fused path (the name of the
    # JAX package's fused backend); "auto": fused when the latents are on the
    # card at the kernels' width, else plain
    aggregation: str = "auto"
    compute_dtype: str = "float32"   # "bfloat16" runs the MLP stack in bf16

    def __post_init__(self):
        if self.aggregation not in AGGREGATIONS:
            raise ValueError(f"aggregation {self.aggregation!r} is not one of "
                             f"{AGGREGATIONS}")

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def use_fused(cfg: ArchConfig, latent: torch.Tensor) -> bool:
    """Whether the GN blocks take the fused path for latents ``latent``."""
    if cfg.aggregation == "pallas":
        return True
    return (cfg.aggregation == "auto" and latent.is_cuda
            and cfg.hidden == kernels.H)


def _init_dense(layer: nn.Linear, generator: torch.Generator) -> None:
    """Flax ``Dense``'s init: LeCun-normal kernel truncated at 2 std, zero
    bias."""
    std = (1.0 / layer.in_features) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        nn.init.zeros_(layer.bias)


def _flax_layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm as Flax computes it: f32 statistics with var = E[x^2] -
    mean^2 clamped at 0, eps 1e-5 (the reference's torch default), result in
    ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * (torch.rsqrt(var + ln.eps) * ln.weight) + ln.bias
    return y.to(x.dtype)


class MLP(nn.Module):
    """Linear-SiLU-Linear-SiLU-Linear [+LayerNorm] (reference
    ``Model.build_mlp``). ``dtype`` is the compute dtype (parameters stay
    f32); outputs are f32."""

    def __init__(self, in_size: int, hidden: int, out_size: int,
                 layer_norm: bool = True, dtype=torch.float32,
                 generator: torch.Generator = None):
        super().__init__()
        self.dense0 = nn.Linear(in_size, hidden)
        self.dense1 = nn.Linear(hidden, hidden)
        self.dense2 = nn.Linear(hidden, out_size)
        self.layer_norm = (nn.LayerNorm(out_size, eps=1e-5) if layer_norm
                           else None)
        self.dtype = dtype
        for layer in (self.dense0, self.dense1, self.dense2):
            _init_dense(layer, generator)
        self._kernel_cache = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = x.to(dt)
        for i, layer in enumerate((self.dense0, self.dense1, self.dense2)):
            # product and bias add each round to the compute dtype, as Flax's
            # Dense does
            h = F.linear(h, layer.weight.to(dt)) + layer.bias.to(dt)
            if i < 2:
                h = F.silu(h)
        if self.layer_norm is not None:
            h = _flax_layer_norm(h, self.layer_norm)
        return h.float()

    def kernel_weights(self, dtype=torch.bfloat16) -> kernels.BlockWeights:
        """This MLP as the fused blocks take it: matrices (inputs, outputs),
        every tensor in ``dtype`` (the kernels take bf16; the plain versions
        any float dtype). Cached until a parameter is replaced or changed in
        place."""
        params = (self.dense0.weight, self.dense0.bias, self.dense1.weight,
                  self.dense1.bias, self.dense2.weight, self.dense2.bias,
                  self.layer_norm.weight, self.layer_norm.bias)
        key = (dtype,) + tuple((p.data_ptr(), p._version) for p in params)
        if self._kernel_cache is None or self._kernel_cache[0] != key:
            w = kernels.BlockWeights(*(
                (p.detach().t() if p.ndim == 2 else p.detach()).to(dtype).contiguous()
                for p in params))
            self._kernel_cache = (key, w)
        return self._kernel_cache[1]


def aggregate_twice_mp(edge_attr: torch.Tensor, graph) -> torch.Tensor:
    """The reference's 'twice message passing': forward/reverse halves of the
    edge latents summed onto vertices, then each cell's 3-vertex mean
    (``Fvgn.py:305-321``). Returns (C, H/2)."""
    h2 = edge_attr.shape[-1] // 2
    vtx = seg_ops.aggregate_edges_to_vertices_scatter(
        edge_attr[:, :h2], edge_attr[:, h2:], graph.vertex_edge_index,
        graph.num_vertices)
    return seg_ops.gather_vertices_to_cells(vtx, graph.vertex_face)


class CellBlock(nn.Module):
    """Edge->vertex->cell aggregation + cell MLP (reference ``Cell_Block``,
    Fvgn.py:298-325)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None):
        super().__init__()
        self.mlp = MLP(cfg.hidden + cfg.hidden // 2, cfg.hidden, cfg.hidden,
                       dtype=cfg.dtype, generator=generator)

    def forward(self, cell_attr, edge_attr, graph, fused: bool = False,
                dual_out: bool = False):
        if fused:
            vtx = kernels.edges_to_vertices(edge_attr.to(torch.bfloat16), graph)
            return kernels.fused_cell_block(cell_attr.to(torch.bfloat16), vtx,
                                            graph, self.mlp.kernel_weights(),
                                            dual_out=dual_out)
        cell_agg = aggregate_twice_mp(edge_attr, graph)
        return self.mlp(torch.cat([cell_attr, cell_agg], dim=-1))


class FaceBlock(nn.Module):
    """[edge | cell_owner | cell_neighbour] -> face MLP (reference
    ``Face_Block``, Fvgn.py:286-296)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None):
        super().__init__()
        self.mlp = MLP(3 * cfg.hidden, cfg.hidden, cfg.hidden,
                       dtype=cfg.dtype, generator=generator)

    def forward(self, cell_attr, edge_attr, graph, fused: bool = False,
                dual_out: bool = False):
        if fused:
            return kernels.fused_face_block(cell_attr.to(torch.bfloat16),
                                            edge_attr.to(torch.bfloat16),
                                            graph, self.mlp.kernel_weights(),
                                            dual_out=dual_out)
        own, nbr = graph.cell_edge_index[0], graph.cell_edge_index[1]
        return self.mlp(torch.cat([edge_attr, cell_attr[own], cell_attr[nbr]],
                                  dim=-1))


class GNBlock(nn.Module):
    """One processor block, FVGN order (cell block, then face block) with
    residuals (Fvgn.py:274-284)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None):
        super().__init__()
        self.cell_block = CellBlock(cfg, generator)
        self.face_block = FaceBlock(cfg, generator)

    def forward(self, cell_attr, edge_attr, graph, fused: bool = False):
        if fused:
            # residuals are applied inside the kernels; the face block reads
            # the cell block's RAW (pre-residual) output
            c_raw, c_res = self.cell_block(cell_attr, edge_attr, graph,
                                           fused=True, dual_out=True)
            e_res = self.face_block(c_raw, edge_attr, graph, fused=True)
            return c_res, e_res
        new_cell = self.cell_block(cell_attr, edge_attr, graph)
        new_edge = self.face_block(new_cell, edge_attr, graph)
        return cell_attr + new_cell, edge_attr + new_edge


class Encoder(nn.Module):
    """Independent face/cell input MLPs (reference ``Encoder``,
    Fvgn.py:257-266)."""

    def __init__(self, cfg: ArchConfig, cell_in: int, face_in: int,
                 generator: torch.Generator = None):
        super().__init__()
        self.face_mlp = MLP(face_in, cfg.hidden, cfg.hidden, dtype=cfg.dtype,
                            generator=generator)
        self.cell_mlp = MLP(cell_in, cfg.hidden, cfg.hidden, dtype=cfg.dtype,
                            generator=generator)

    def forward(self, cell_x, face_x):
        return self.cell_mlp(cell_x), self.face_mlp(face_x)


class EncodeProcessDecode(nn.Module):
    """Encoder -> mp_num GN blocks -> the face decoder head (``decoder_face``,
    no LayerNorm)."""

    def __init__(self, cfg: ArchConfig, cell_in: int, face_in: int,
                 face_out: int, generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, cell_in, face_in, generator)
        self.blocks = nn.ModuleList(GNBlock(cfg, generator)
                                    for _ in range(cfg.mp_num))
        self.decoder_face = MLP(cfg.hidden, cfg.hidden, face_out,
                                layer_norm=False, dtype=cfg.dtype,
                                generator=generator)

    def forward(self, cell_x, face_x, graph):
        cell_attr, edge_attr = self.encoder(cell_x, face_x)
        fused = use_fused(self.cfg, cell_attr)
        for block in self.blocks:
            cell_attr, edge_attr = block(cell_attr, edge_attr, graph, fused)
        return self.decoder_face(edge_attr)


def gather3(x: torch.Tensor, graph) -> torch.Tensor:
    """(F, D) -> (C, 3, D): each cell's 3 face rows (a plain index gather;
    the JAX package's ``fc3`` banded table is a TPU device)."""
    return x[graph.face_index.T]


class LearnedScaleDenorm(nn.Module):
    """Learned per-channel output scale (reference ``FvgnJ``,
    Fvgn.py:1149-1157) as FluxD uses it: its biases are constant 0, not
    parameters (Flux.py:471-475). FvgnJ's learned bias comes with that
    family."""

    def __init__(self, channels: int, init_scale=1.0):
        super().__init__()
        init = torch.broadcast_to(torch.as_tensor(init_scale, dtype=torch.float32),
                                  (channels,))
        self.scale = nn.Parameter(init.clone())

    def forward(self, x):
        return x * self.scale
