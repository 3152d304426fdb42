"""Core neural architecture: MLPs, GN blocks, encode-process-decode and the
integrators (FVGN's normalized and physical ones, the Flux family's).

Counterpart of ``gnn_fluid_dynamics_tpu/models/arch.py`` for what the ported
families run. Module and parameter names follow the Flax
tree, so :func:`gnn_fluid_dynamics_tpu_torch.weights.params_from_flax` maps
one onto the other.

The GN blocks take one of two routes, as in the JAX package:

* the **kernel** route, through the CUDA kernels of
  :mod:`gnn_fluid_dynamics_tpu_torch.ops.kernels` on the card (their plain
  versions on the CPU). A block without a step scalar on a graph on the
  index route is **fused**: per block the edge->vertex sum (K3), the fused
  cell block (K2) and the fused face block (K1), with bf16 latents between
  them. Any other block is **unfused**: on the index route (a block with a
  step scalar, as in FvgnF) K3 then the 3-vertex mean (K5) before the cell
  MLP and the owner/neighbour gather (K4) before the face MLP; on a graph on
  the table route (``MeshGraph.table_route``, the trainer's validation
  graph) the dense-table kernels instead: K6 on the es/er tables then K7 on
  vc before the cell MLP, K6 on the cf tables before the face MLP
  (``_fused_block_ok``, ``aggregate_twice_mp``, ``gather_face_cells``).
  Each sub-block's MLP -> LayerNorm -> residual then runs as one kernel,
  K8, on the aggregations' outputs where the MLP is one K8 takes (bf16, H
  wide, with a LayerNorm: :func:`mlp_block_ok`), and as its :class:`MLP`
  module with the residual outside otherwise (the f32 MLPs);
* the **plain** route: segment aggregation, row gathers and the
  :class:`MLP` modules in the configured compute dtype.

Every module takes ``train`` (and ``rng``, the ``torch.Generator`` dropout
draws from), as the Flax modules do: in train mode the blocks take the plain
route (the kernels have no backward), the MLPs apply dropout, the
integrator's BatchNorm normalizes by the batch's statistics and updates its
running ones, and with ``ArchConfig.remat`` each GN block application is
recomputed in the backward pass instead of keeping its activations.

On a space-sharded graph (``MeshGraph.halo``, :mod:`gnn_fluid_dynamics_tpu_torch.
parallel.spmd`) the modules refresh the ghost rows of a latent
(:func:`~gnn_fluid_dynamics_tpu_torch.parallel.halo.refresh`) where the
next step reads it through an index table: the encoder's cell and face
latents; in a fused cell-first block K2's raw output before K1 and K1's
residualed output before the next block's K3 (and K1's raw output when the
caller reads it), in a fused face-first block K1's raw output before K3 and
K2's output before the next block's K1, in an unfused block each
sub-block's output; the face decoder's output before the integrators'
``gather3``. The unfused block reads the same rows on the table route as
on the index route: K6 (es/er) then K7 read the edge latents at the faces
of an owned cell's vertices as K3 then K5 do, and K6 (cf) the cell
latents at an owned face's two cells as K4 does, each from the rank's own
tables; so the same refreshes cover both routes. The train-mode BatchNorm
sums its statistics over the space group, and dropout draws at the global
row count. On a graph without a halo each of these is a no-op.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from gnn_fluid_dynamics_tpu_torch.ops import kernels
from gnn_fluid_dynamics_tpu_torch.ops import segment as seg_ops
from gnn_fluid_dynamics_tpu_torch.ops.fvm import calc_gradient_tensor
from gnn_fluid_dynamics_tpu_torch.parallel import halo
from gnn_fluid_dynamics_tpu_torch.parallel.halo import refresh
from gnn_fluid_dynamics_tpu_torch.training import profiling

AGGREGATIONS = ("segment", "pallas", "auto", "banded", "gather")
BLOCK_ORDERS = ("cell_first", "face_first")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    hidden: int = 128
    mp_num: int = 15
    # "segment": the plain route; "pallas": the kernel route (the name of
    # the JAX package's Pallas backend); "auto": the kernel route when the
    # latents are on the card at the kernels' width, else plain. "banded"
    # and "gather", the JAX package's XLA banded and incidence-gather
    # backends (the shipped configs' names), reach no kernel there and take
    # the plain route here. The physics gathers (gather3, the cell flux,
    # the feedback's face velocity change) stay f32 index gathers on every
    # route, where the JAX package's bf16 banded tables round them to bf16.
    aggregation: str = "auto"
    compute_dtype: str = "float32"   # "bfloat16" runs the MLP stack in bf16
    share_blocks: bool = False       # FvgnF: one GN block applied mp_num times
    step_scalar: bool = False        # FvgnF: (i+1)/mp_num appended to both
    #                                  block inputs of application i
    dropout_rate: float = 0.0        # dropout after each SiLU of every MLP,
    #                                  in train mode
    remat: bool = False              # recompute each GN block application in
    #                                  the backward pass (torch.utils.checkpoint)
    block_order: str = "cell_first"  # "cell_first" (FVGN, Flux) or
    #                                  "face_first" (MGN)

    def __post_init__(self):
        if self.aggregation not in AGGREGATIONS:
            raise ValueError(f"aggregation {self.aggregation!r} is not one of "
                             f"{AGGREGATIONS}")
        if self.block_order not in BLOCK_ORDERS:
            raise ValueError(f"block_order {self.block_order!r} is not one of "
                             f"{BLOCK_ORDERS}")

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def kernel_route(cfg: ArchConfig, latent: torch.Tensor,
                 train: bool = False) -> bool:
    """Whether the GN blocks take the kernel route for latents ``latent``;
    the counterpart of the JAX package's ``_resolve_aggregation``
    (``models/arch.py:157-172``). The kernels run rollouts only: with
    ``train`` the kernel route is refused, as the JAX package downgrades
    ``"pallas"`` to its differentiable XLA path.

    The two differ on ``"auto"``. Here it takes the kernel route whenever the
    latents are on the card at the kernels' width (128), on any graph. The
    JAX package takes ``"segment"`` on a graph without ``hv`` tables, and
    its XLA ``"banded"`` backend off the TPU, or on a graph on the table
    route below ``AUTO_PALLAS_MIN_CELLS`` (10,240) cells. So on a small
    graph on the table route the port rounds the latents to bf16 in K6/K7
    where the JAX package on f32 tables does not: a difference at bf16
    level, and the card's crossover is its own to measure."""
    if train:
        return False
    if cfg.aggregation == "pallas":
        return True
    return (cfg.aggregation == "auto" and latent.is_cuda
            and cfg.hidden == kernels.H)


def block_route(cfg: ArchConfig, graph, latent: torch.Tensor, extra=None,
                train: bool = False) -> str:
    """``"fused"``, ``"unfused"`` or ``"plain"`` for one GN block application
    (``_fused_block_ok``): fused only on the kernel route, without a step
    scalar, on a graph on the index route."""
    if not kernel_route(cfg, latent, train):
        return "plain"
    if extra is None and not graph.table_route:
        return "fused"
    return "unfused"


def _init_dense(layer: nn.Linear, generator: torch.Generator) -> None:
    """Flax ``Dense``'s init: LeCun-normal kernel truncated at 2 std, zero
    bias (where the layer has one)."""
    std = (1.0 / layer.in_features) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        if layer.bias is not None:
            nn.init.zeros_(layer.bias)


def _flax_layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm as Flax computes it (:func:`kernels.layer_norm_ref`): f32
    statistics with var = E[x^2] - mean^2 clamped at 0, eps 1e-5 (the
    reference's torch default), result in ``x``'s dtype; a LayerNorm
    without bias adds none."""
    return kernels.layer_norm_ref(x, ln.weight, ln.bias, ln.eps)


def dropout(x: torch.Tensor, rate: float,
            rng: torch.Generator) -> torch.Tensor:
    """Flax ``nn.Dropout`` in train mode: each value kept with probability
    1 - ``rate`` and scaled by 1 / (1 - ``rate``), the others 0. The keep
    mask is drawn from ``rng`` (on ``x``'s device): ``F.dropout`` takes no
    generator."""
    if rng is None:
        raise ValueError("dropout in train mode needs a generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = halo.draw(torch.rand, x.shape, rng, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class MLP(nn.Module):
    """Linear-SiLU-[Dropout]-Linear-SiLU-[Dropout]-Linear [+LayerNorm]
    (reference ``Model.build_mlp``). ``dtype`` is the compute dtype
    (parameters stay f32, and so do their gradients); outputs are f32.
    Dropout applies in train mode only."""

    def __init__(self, in_size: int, hidden: int, out_size: int,
                 layer_norm: bool = True, dtype=torch.float32,
                 dropout_rate: float = 0.0,
                 generator: torch.Generator = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dense0 = nn.Linear(in_size, hidden)
        self.dense1 = nn.Linear(hidden, hidden)
        self.dense2 = nn.Linear(hidden, out_size)
        self.layer_norm = (nn.LayerNorm(out_size, eps=1e-5) if layer_norm
                           else None)
        self.dtype = dtype
        for layer in (self.dense0, self.dense1, self.dense2):
            _init_dense(layer, generator)
        self._kernel_cache = {}   # form -> (parameter versions, weights)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator = None) -> torch.Tensor:
        dt = self.dtype
        h = x.to(dt)
        for i, layer in enumerate((self.dense0, self.dense1, self.dense2)):
            # product and bias add each round to the compute dtype, as Flax's
            # Dense does
            h = F.linear(h, layer.weight.to(dt)) + layer.bias.to(dt)
            if i < 2:
                h = F.silu(h)
                if train and self.dropout_rate > 0:
                    h = dropout(h, self.dropout_rate, rng)
        if self.layer_norm is not None:
            h = _flax_layer_norm(h, self.layer_norm)
        return h.float()

    def kernel_weights(self, dtype=torch.bfloat16, packed: bool = False,
                       mlp_block: bool = False):
        """This MLP as the kernels take it, the one cache of its weights in
        the compute dtype. By default as the fused blocks' plain versions
        take it: matrices (inputs, outputs), every tensor in ``dtype`` (the
        kernels take bf16; the plain versions any float dtype). With
        ``packed``, the fused kernels' (K1's and K2's) ``PackedWeights``: the
        same with the matrices packed as the kernels read them
        (``kernels.packed_weights``). With ``mlp_block``, K8's
        ``MlpBlockWeights``: the Dense layers in ``dtype`` as ``F.linear``
        takes them, packed beside (``kernels.mlp_block_weights``), and the
        LayerNorm's f32 parameters.
        Each form is cached until a parameter is replaced or changed in
        place, so the packing runs once per set of weights."""
        params = (self.dense0.weight, self.dense0.bias, self.dense1.weight,
                  self.dense1.bias, self.dense2.weight, self.dense2.bias,
                  self.layer_norm.weight, self.layer_norm.bias)
        form = (dtype, packed, mlp_block)
        key = tuple((p.data_ptr(), p._version) for p in params)
        cached = self._kernel_cache.get(form)
        if cached is None or cached[0] != key:
            profiling.count("mlp.weight_packs")
            w = [p.detach() for p in params]
            if mlp_block:
                value = kernels.mlp_block_weights(
                    [(w[i].to(dtype), w[i + 1].to(dtype)) for i in (0, 2, 4)],
                    w[6].float(), w[7].float())
            else:
                value = kernels.BlockWeights(*(
                    (p.t() if p.ndim == 2 else p).to(dtype).contiguous()
                    for p in w))
                if packed:
                    value = kernels.packed_weights(value)
            cached = self._kernel_cache[form] = (key, value)
        return cached[1]


class AntisymMLP(nn.Module):
    """Bias-free tanh MLP for antisymmetric edge features: an odd activation
    and no bias keep f(-x) = -f(x) (reference
    ``Conservative.build_mlp_antisym``, Conservative.py:31-43). Always f32,
    whatever the compute dtype; no dropout. The optional LayerNorm has a
    scale and no bias."""

    def __init__(self, in_size: int, hidden: int, out_size: int,
                 layer_norm: bool = False,
                 generator: torch.Generator = None):
        super().__init__()
        self.dense0 = nn.Linear(in_size, hidden, bias=False)
        self.dense1 = nn.Linear(hidden, hidden, bias=False)
        self.dense2 = nn.Linear(hidden, out_size, bias=False)
        self.layer_norm = (nn.LayerNorm(out_size, eps=1e-5, bias=False)
                           if layer_norm else None)
        for layer in (self.dense0, self.dense1, self.dense2):
            _init_dense(layer, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(self.dense0(x))
        h = torch.tanh(self.dense1(h))
        h = self.dense2(h)
        return h if self.layer_norm is None else _flax_layer_norm(
            h, self.layer_norm)


def aggregate_faces_to_cells(edge_attr: torch.Tensor, graph,
                             antisym: bool) -> torch.Tensor:
    """The Conservative family's direct face -> cell two-way aggregation
    (reference ``Conservative.py:243-254, 636-652``) as a gather over each
    cell's 3 faces, weighted per slot: antisymmetric, the negated
    ``cell_face_sign`` (+1 where the cell is the neighbour, -1 where it
    owns the face) and 0 on a boundary self-loop (its +e/-e pair cancels);
    symmetric, 1 and 2 on a boundary self-loop (the cell takes both
    copies). Pad slots weigh as ``face_index``/``cell_face_sign`` of the
    padded graph say. (F, W) -> (C, W) in ``edge_attr``'s dtype; no
    kernel, as in the JAX package."""
    gface = graph.face_index.T                                # (C, 3)
    e = edge_attr[gface]                                      # (C, 3, W)
    boundary = graph.face_boundary_mask[gface]
    sign = graph.cell_face_sign.to(edge_attr.dtype)
    if antisym:
        w = torch.where(boundary, torch.zeros_like(sign), -sign)
    else:
        w = torch.where(boundary, torch.full_like(sign, 2.0),
                        torch.ones_like(sign))
    return torch.sum(e * w[..., None], dim=1)


def aggregate_twice_mp(edge_attr: torch.Tensor, graph,
                       use_kernels: bool = False) -> torch.Tensor:
    """The reference's 'twice message passing': forward/reverse halves of the
    edge latents summed onto vertices, then each cell's 3-vertex mean
    (``Fvgn.py:305-321``). (F, W) -> (C, W/2) f32, for W = H in the GN
    blocks and W = 2H in ConservativeH/J/K's blocks (``[e_s | e_s]``). With
    ``use_kernels`` the unfused block's kernels on the latents rounded to
    bf16 (``aggregate_edges_to_vertices_pallas``'s cast): K6 (es/er) then
    K7 (vc) on a graph on the table route, K3 then K5 on the index route,
    each at the input's width."""
    if use_kernels:
        e = edge_attr.to(torch.bfloat16)
        if graph.table_route:
            vtx = kernels.table_dual(graph.es_onehot, graph.er_onehot,
                                     graph.es_off, e, combine_roll=True)
            return kernels.table_single(graph.vc_onehot, graph.vc_off, vtx)
        return kernels.vertices_to_cells(kernels.edges_to_vertices(e, graph),
                                         graph)
    h2 = edge_attr.shape[-1] // 2
    vtx = seg_ops.aggregate_edges_to_vertices_scatter(
        edge_attr[:, :h2], edge_attr[:, h2:], graph.vertex_edge_index,
        graph.num_vertices)
    return seg_ops.gather_vertices_to_cells(vtx, graph.vertex_face)


def gather_face_cells(cell_attr: torch.Tensor, graph,
                      use_kernels: bool = False):
    """(x[owner], x[neighbour]) per face, (F, H) each. With ``use_kernels``
    the rows of the latents rounded to bf16, in bf16: through K4 on a graph
    on the index route, which rounds f32 latents itself, or through K6 (cf
    tables) on the latents cast to bf16 on a graph on the table route. The
    JAX wrapper widens them to f32; here the face block's concatenation
    does (:func:`_with_extra`)."""
    if not use_kernels:
        return (cell_attr[graph.cell_edge_index[0]],
                cell_attr[graph.cell_edge_index[1]])
    if graph.table_route:
        return kernels.table_dual(graph.cf_row_onehot, graph.cf_col_onehot,
                                  graph.cf_off, cell_attr.to(torch.bfloat16))
    return kernels.gather_face_cells(cell_attr, graph)


def _with_extra(parts: list, extra, rows: int) -> torch.Tensor:
    """``parts`` concatenated along channels, with the (1, E) step scalar
    ``extra`` broadcast over the rows appended when given. Parts of mixed
    dtypes are promoted by the concatenation itself (the kernel route's
    bf16 rows beside the f32 edge latents become f32, exactly); on the card
    it then copies each part with a kernel of its own, where parts of one
    dtype share one kernel."""
    if extra is not None:
        parts = parts + [extra.expand(rows, extra.shape[-1])]
    return torch.cat(parts, dim=-1)


def mlp_block_ok(mlp: MLP, route: str, fan_ins: tuple) -> bool:
    """Whether K8 runs a sub-block's MLP: on the unfused route (which
    excludes training), a bf16 MLP of the kernels' width with a LayerNorm,
    whose fan-in is one of ``fan_ins`` (the sub-block's, without and with
    the step scalar's column). Only what the call can observe decides it."""
    return (route == "unfused" and mlp.dtype == torch.bfloat16
            and mlp.layer_norm is not None
            and mlp.dense0.out_features == kernels.H
            and mlp.dense2.out_features == kernels.H
            and mlp.dense0.in_features in fan_ins)


def _sub_block_mlp(mlp: MLP, parts: list, extra, route: str, fan_ins: tuple,
                   residual: bool, dual_out: bool, train: bool, rng):
    """A non-fused sub-block's MLP on its input ``parts`` (the residual base
    first): K8 where :func:`mlp_block_ok`, else the :class:`MLP` module on
    their concatenation with the residual added after. Returns raw, or with
    ``residual`` ``parts[0] + raw`` (and raw before it with ``dual_out``);
    K8's raw is bf16, the module's f32, of the same values. On the unfused
    route, counts ``gn_mlp.kernel`` or ``gn_mlp.plain`` by the path taken."""
    kernel = mlp_block_ok(mlp, route, fan_ins)
    if route == "unfused":
        profiling.count("gn_mlp.kernel" if kernel else "gn_mlp.plain")
    if kernel:
        return kernels.mlp_block(parts, extra,
                                 mlp.kernel_weights(mlp_block=True),
                                 residual=residual, dual_out=dual_out)
    raw = mlp(_with_extra(parts, extra, parts[0].shape[0]), train, rng)
    if not residual:
        return raw
    res = parts[0] + raw
    return (raw, res) if dual_out else res


class CellBlock(nn.Module):
    """Edge->vertex->cell aggregation + cell MLP (reference ``Cell_Block``,
    Fvgn.py:298-325). Off the fused route it returns the MLP's raw output,
    or with ``residual`` ``cell_attr + raw`` as the fused route does (with
    ``dual_out`` raw too)."""

    FAN_INS = (kernels.H + kernels.H // 2, kernels.H + kernels.H // 2 + 1)

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None):
        super().__init__()
        self.mlp = MLP(cfg.hidden + cfg.hidden // 2 + int(cfg.step_scalar),
                       cfg.hidden, cfg.hidden, dtype=cfg.dtype,
                       dropout_rate=cfg.dropout_rate, generator=generator)

    def forward(self, cell_attr, edge_attr, graph, extra=None,
                route: str = "plain", dual_out: bool = False,
                train: bool = False, rng: torch.Generator = None,
                residual: bool = False):
        if route == "fused":
            vtx = kernels.edges_to_vertices(edge_attr.to(torch.bfloat16), graph)
            return kernels.fused_cell_block(
                cell_attr.to(torch.bfloat16), vtx, graph,
                self.mlp.kernel_weights(packed=True), dual_out=dual_out)
        cell_agg = aggregate_twice_mp(edge_attr, graph, route == "unfused")
        return _sub_block_mlp(self.mlp, [cell_attr, cell_agg], extra, route,
                              self.FAN_INS, residual, dual_out, train, rng)


class FaceBlock(nn.Module):
    """[edge | cell_owner | cell_neighbour] -> face MLP (reference
    ``Face_Block``, Fvgn.py:286-296). Unfused, the kernel route gathers the
    cell rows in bf16, which K8 reads as they are (the MLP module's
    concatenation widens them to f32, as the JAX wrapper's cast does). Off
    the fused route it returns as :class:`CellBlock` does, the residual's
    base being ``edge_attr``."""

    FAN_INS = (3 * kernels.H, 3 * kernels.H + 1)

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None):
        super().__init__()
        self.mlp = MLP(3 * cfg.hidden + int(cfg.step_scalar), cfg.hidden,
                       cfg.hidden, dtype=cfg.dtype,
                       dropout_rate=cfg.dropout_rate, generator=generator)

    def forward(self, cell_attr, edge_attr, graph, extra=None,
                route: str = "plain", dual_out: bool = False,
                train: bool = False, rng: torch.Generator = None,
                residual: bool = False):
        if route == "fused":
            return kernels.fused_face_block(cell_attr.to(torch.bfloat16),
                                            edge_attr.to(torch.bfloat16),
                                            graph,
                                            self.mlp.kernel_weights(packed=True),
                                            dual_out=dual_out)
        own, nbr = gather_face_cells(cell_attr, graph, route == "unfused")
        return _sub_block_mlp(self.mlp, [edge_attr, own, nbr], extra, route,
                              self.FAN_INS, residual, dual_out, train, rng)


_BLOCK_COUNTERS = {r: "gn_block." + r
                   for r in ("fused", "unfused", "table", "plain")}


class GNBlock(nn.Module):
    """One processor block with residuals, on the ``route`` of
    :func:`block_route`, in the config's ``block_order``: FVGN's cell block,
    then face block (Fvgn.py:274-284), or MGN's face block, then cell block
    (Mgn.py:216-226). The second sub-block reads the first one's raw
    (pre-residual) output and the other input as the block received it.
    Returns (cell, edge) residualed, and with ``face_raw`` also the face
    block's raw output (VertPot's vertex sum reads it, VertPot.py:201-208).

    Fused, the residuals are applied inside the kernels. Cell-first: K3 ->
    K2 with both outputs, then K1 on K2's raw output (with both outputs for
    ``face_raw``). Face-first: K1 with both outputs, then K3 on K1's raw
    output -> K2 with the residual only. Unfused (and plain), each
    sub-block returns its raw output and the residual (K8 computes both);
    K8's raw output is bf16 (VertPot widens it).

    Each application is the span ``gn_block`` with its ``route`` (the
    unfused route on a graph on the table route as ``"table"``) and adds
    one to the counter ``gn_block.<route>``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None):
        super().__init__()
        self.face_first = cfg.block_order == "face_first"
        self.cell_block = CellBlock(cfg, generator)
        self.face_block = FaceBlock(cfg, generator)

    def forward(self, cell_attr, edge_attr, graph, extra=None,
                route: str = "plain", train: bool = False,
                rng: torch.Generator = None, face_raw: bool = False):
        kind = "table" if route == "unfused" and graph.table_route else route
        profiling.count(_BLOCK_COUNTERS[kind])
        with profiling.span("gn_block", route=kind):
            return self._apply_block(cell_attr, edge_attr, graph, extra,
                                     route, train, rng, face_raw)

    def _apply_block(self, cell_attr, edge_attr, graph, extra, route, train,
                     rng, face_raw):
        if route == "fused" and self.face_first:
            e_raw, e_res = self.face_block(cell_attr, edge_attr, graph,
                                           route=route, dual_out=True)
            e_raw = refresh(e_raw, graph, "face")
            c_res = refresh(self.cell_block(cell_attr, e_raw, graph,
                                            route=route), graph, "cell")
            return (c_res, e_res, e_raw) if face_raw else (c_res, e_res)
        if route == "fused":
            c_raw, c_res = self.cell_block(cell_attr, edge_attr, graph,
                                           route=route, dual_out=True)
            c_raw = refresh(c_raw, graph, "cell")
            if face_raw:
                e_raw, e_res = self.face_block(c_raw, edge_attr, graph,
                                               route=route, dual_out=True)
                return (c_res, refresh(e_res, graph, "face"),
                        refresh(e_raw, graph, "face"))
            return c_res, refresh(self.face_block(c_raw, edge_attr, graph,
                                                  route=route), graph, "face")
        # the residuals go with the MLPs (K8's in the kernel) where the ghost
        # rows' refresh is the identity; on a graph of more than one space
        # rank each raw output is refreshed first, as the next sub-block
        # and the residual read it
        fused_res = graph.halo is None or graph.halo.n_space == 1

        def sub(kind, c, e, dual):
            block = self.cell_block if kind == "cell" else self.face_block
            if fused_res:
                return block(c, e, graph, extra, route, dual, train, rng,
                             residual=True)
            raw = refresh(block(c, e, graph, extra, route, train=train,
                                rng=rng).float(), graph, kind)
            res = (c if kind == "cell" else e) + raw
            return (raw, res) if dual else res

        if self.face_first:
            e_raw, e_res = sub("face", cell_attr, edge_attr, True)
            c_res = sub("cell", cell_attr, e_raw, False)
        else:
            c_raw, c_res = sub("cell", cell_attr, edge_attr, True)
            e_out = sub("face", c_raw, edge_attr, face_raw)
            e_raw, e_res = e_out if face_raw else (None, e_out)
        return (c_res, e_res, e_raw) if face_raw else (c_res, e_res)


def _remat_block(block: GNBlock, cell_attr, edge_attr, graph, extra,
                 route: str, rng: torch.Generator = None):
    """One training application of ``block`` under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward pass instead of kept (Flax's ``nn.remat``). The recomputation
    must draw the dropout masks the forward pass drew, so ``rng`` is set
    back to its state at the call for it, and afterwards returned to where
    the backward pass found it."""
    start = None if rng is None else rng.get_state()
    calls = []

    def run(c, e):
        resume = rng.get_state() if (calls and start is not None) else None
        if resume is not None:
            rng.set_state(start)
        calls.append(1)
        try:
            return block(c, e, graph, extra, route, train=True, rng=rng)
        finally:
            # the recomputation may be stopped early, by an exception
            if resume is not None:
                rng.set_state(resume)

    return torch.utils.checkpoint.checkpoint(run, cell_attr, edge_attr,
                                             use_reentrant=False,
                                             preserve_rng_state=False)


class Encoder(nn.Module):
    """Independent face/cell input MLPs (reference ``Encoder``,
    Fvgn.py:257-266)."""

    def __init__(self, cfg: ArchConfig, cell_in: int, face_in: int,
                 generator: torch.Generator = None):
        super().__init__()
        self.face_mlp = MLP(face_in, cfg.hidden, cfg.hidden, dtype=cfg.dtype,
                            dropout_rate=cfg.dropout_rate, generator=generator)
        self.cell_mlp = MLP(cell_in, cfg.hidden, cfg.hidden, dtype=cfg.dtype,
                            dropout_rate=cfg.dropout_rate, generator=generator)

    def forward(self, cell_x, face_x, train: bool = False,
                rng: torch.Generator = None):
        face_attr = self.face_mlp(face_x, train, rng)
        return self.cell_mlp(cell_x, train, rng), face_attr


class EncodeProcessDecode(nn.Module):
    """Encoder -> mp_num GN blocks -> the decoder heads, MLPs without
    LayerNorm: ``decoder_face`` on the edge latents (``face_out`` channels)
    and ``decoder_cell`` on the cell latents (``cell_out``); a head of 0
    channels is left out. Returns (cell_out, face_out), None for a head
    left out. With ``share_blocks`` one block (``blocks.0``, Flax
    ``GNBlock_0``) is applied ``mp_num`` times; with ``step_scalar``
    application ``i`` appends ``(i+1)/mp_num`` to both block inputs. With
    ``remat``, each training application runs under :func:`_remat_block`;
    the parameter names stay those without it."""

    def __init__(self, cfg: ArchConfig, cell_in: int, face_in: int,
                 face_out: int = 0, cell_out: int = 0,
                 generator: torch.Generator = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, cell_in, face_in, generator)
        self.blocks = nn.ModuleList(
            GNBlock(cfg, generator)
            for _ in range(1 if cfg.share_blocks else cfg.mp_num))
        self.decoder_face, self.decoder_cell = (
            MLP(cfg.hidden, cfg.hidden, n, layer_norm=False, dtype=cfg.dtype,
                dropout_rate=cfg.dropout_rate, generator=generator)
            if n else None for n in (face_out, cell_out))
        # the step scalars, one (1, 1) row each, in the encoder's output
        # dtype (f32); not weights, so outside the state dict
        self.register_buffer("step_scalars", torch.tensor(
            [[(i + 1) / cfg.mp_num] for i in range(cfg.mp_num)],
            dtype=torch.float32), persistent=False)

    def forward(self, cell_x, face_x, graph, train: bool = False,
                rng: torch.Generator = None):
        cell_attr, edge_attr = self.encoder(cell_x, face_x, train, rng)
        cell_attr = refresh(cell_attr, graph, "cell")
        edge_attr = refresh(edge_attr, graph, "face")
        for i in range(self.cfg.mp_num):
            block = self.blocks[0 if self.cfg.share_blocks else i]
            extra = (self.step_scalars[i:i + 1] if self.cfg.step_scalar
                     else None)
            route = block_route(self.cfg, graph, cell_attr, extra, train)
            if train and self.cfg.remat:
                cell_attr, edge_attr = _remat_block(
                    block, cell_attr, edge_attr, graph, extra, route, rng)
            else:
                cell_attr, edge_attr = block(cell_attr, edge_attr, graph,
                                             extra, route, train, rng)
        face_out = cell_out = None
        if self.decoder_face is not None:
            face_out = refresh(self.decoder_face(edge_attr, train, rng),
                               graph, "face")
        if self.decoder_cell is not None:
            cell_out = self.decoder_cell(cell_attr, train, rng)
        return cell_out, face_out


def gather3(x: torch.Tensor, graph) -> torch.Tensor:
    """(F, D) -> (C, 3, D): each cell's 3 face rows (a plain index gather;
    the JAX package's ``fc3`` banded table is a TPU device)."""
    return x[graph.face_index.T]


class BatchNorm(nn.Module):
    """Flax ``BatchNorm`` over the last axis: ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias``, eps 1e-5. Initialized as Flax does: scale 1, bias
    0, mean 0, var 1.

    In eval mode mean and var are the running statistics. In train mode
    they are the batch's, over the rows ``mask`` selects, in f32, with var = E[x^2] - mean^2 (biased, clamped at 0: Flax's
    ``use_fast_variance``, where ``nn.BatchNorm1d`` keeps an unbiased running
    variance); the running statistics then move as ``r = momentum * r + (1 -
    momentum) * batch``, momentum 0.9 in Flax's convention (torch's 0.1)."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    @staticmethod
    def batch_statistics(x, mask):
        """(mean, var) over the rows ``mask`` selects, in f32, var = E[x^2]
        - mean^2 clamped at 0; on a space-sharded graph (inside
        ``halo.sharded``) its sums and count are summed over the space
        group first."""
        xf = x.float()
        m = mask.reshape(-1, 1).expand_as(xf)
        xm = torch.where(m, xf, torch.zeros_like(xf))
        s1, s2, n = halo.reduce_statistics(xm.sum(0), (xm * xm).sum(0),
                                           m.sum(0))
        mean = s1 / n
        return mean, torch.clamp(s2 / n - mean * mean, min=0.0)

    def forward(self, x, mask=None, train: bool = False):
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = self.batch_statistics(x, mask)
            with torch.no_grad():
                for run, batch in ((self.running_mean, mean),
                                   (self.running_var, var)):
                    run.mul_(self.momentum).add_((1.0 - self.momentum)
                                                 * batch.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class MaskedBatchNorm(nn.Module):
    """1-channel batch norm whose batch statistics cover valid elements only
    (reference ``torch.nn.BatchNorm1d(1)`` in the integrators,
    normalisation.py:325-365). In eval mode the mask plays no part: the
    running statistics apply to every row; in train mode the batch's
    normalize every row, padded ones too."""

    def __init__(self):
        super().__init__()
        self.batch_norm = BatchNorm(1)

    def forward(self, x, mask=None, train: bool = False):
        return self.batch_norm(x, mask, train)


def _vol_dt_coeff(graph) -> torch.Tensor:
    """mean(dt) / mean-adjacent-cell-volume per face (reference
    ``normalize_vol_dt`` core, normalisation.py:346-365). -> (F, 1)."""
    vol = graph.cell_volume.reshape(-1)
    v_avg = 0.5 * (vol[graph.cell_edge_index[0]] + vol[graph.cell_edge_index[1]])
    # padded faces point at padded cells of zero volume
    v_avg = torch.clamp(v_avg, min=1e-12)
    return (torch.mean(graph.dt) / v_avg).reshape(-1, 1)


class FaceAreaNorm(nn.Module):
    """BatchNorm'd face_area * dt / V̄ scaling (reference
    ``normalize_face_area``, normalisation.py:325-344)."""

    def __init__(self):
        super().__init__()
        self.masked_batch_norm = MaskedBatchNorm()

    def forward(self, graph, train: bool = False):
        return self.masked_batch_norm(graph.face_area.reshape(-1, 1)
                                      * _vol_dt_coeff(graph), graph.face_mask,
                                      train)


class VolDtNorm(nn.Module):
    """BatchNorm'd dt / V̄ per face (reference ``normalize_vol_dt``,
    normalisation.py:346-365)."""

    def __init__(self):
        super().__init__()
        self.masked_batch_norm = MaskedBatchNorm()

    def forward(self, graph, train: bool = False):
        return self.masked_batch_norm(_vol_dt_coeff(graph), graph.face_mask,
                                      train)


class FvgnIntegrator(nn.Module):
    """Normalized-space momentum flux balance (reference ``FvgnA.Integrator``,
    Fvgn.py:214-255): acc = -Phi_A - Phi_P/rho + Phi_D with BatchNorm'd
    area*dt/V̄ face weights. ``edge_output`` = [u_f, v_f, p_f, D_x, D_y].
    Returns (acc, {"norm_face_area": ...})."""

    def __init__(self, rho: float = 1.0):
        super().__init__()
        self.rho = rho
        self.face_area_norm = FaceAreaNorm()

    def forward(self, edge_output, graph, train: bool = False):
        face_area = self.face_area_norm(graph, train)         # (F, 1)
        unv = graph.cell_normal                               # (C, 3, 2)
        uv = edge_output[:, :2]
        p = edge_output[:, 2:3]
        flux_d = edge_output[:, 3:]
        uu_vu = torch.cat([uv[:, 0:1] * uv, uv[:, 1:2] * uv], dim=-1)  # (F, 4)
        g = gather3(torch.cat([face_area, uu_vu, flux_d, p], dim=1),
                    graph)                                    # (C, 3, 8)
        e, uu, d, pf = g[..., 0:1], g[..., 1:5], g[..., 5:7], g[..., 7:8]
        # advective: per local face, [uu uv; vu vv] . n, times the area
        a = torch.einsum("cfkd,cfd->cfk", uu.reshape(-1, 3, 2, 2), unv)
        phi_a = torch.sum(a * e, dim=1)                       # (C, 2)
        phi_d = torch.sum(d, dim=1)
        phi_p = torch.sum(pf * unv * e, dim=1)
        acc = -phi_a - phi_p / self.rho + phi_d
        acc = torch.where(graph.cell_mask[:, None], acc, torch.zeros_like(acc))
        return acc, {"norm_face_area": face_area}


class FluxIntegrator(nn.Module):
    """Flux-based advection (reference ``FluxA.Integrator``,
    Flux.py:158-206): the advective momentum flux carries the predicted face
    flux, signed per cell, weighted by the BatchNorm'd dt/V̄; the pressure
    term takes the BatchNorm'd area*dt/V̄. ``edge_output`` = [u_f, v_f, p_f,
    phi_f, D_x, D_y]. Returns (acc, {"norm_face_area", "cell_flux" (C, 3)})."""

    def __init__(self, rho: float = 1.0):
        super().__init__()
        self.rho = rho
        self.vol_dt_norm = VolDtNorm()
        self.face_area_norm = FaceAreaNorm()

    def forward(self, edge_output, graph, train: bool = False):
        uv = edge_output[:, :2]
        p = edge_output[:, 2:3]
        phi = edge_output[:, 3:4]
        flux_d = edge_output[:, 4:6]
        n = self.vol_dt_norm(graph, train)                     # (F, 1)
        face_area = self.face_area_norm(graph, train)
        g = gather3(torch.cat([phi, n, uv, flux_d, face_area, p], dim=1),
                    graph)                                     # (C, 3, 8)
        phif, nf, uvf = g[..., 0:1], g[..., 1:2], g[..., 2:4]
        df, e, pf = g[..., 4:6], g[..., 6:7], g[..., 7:8]
        cell_flux = phif * graph.cell_face_sign[..., None]     # (C, 3, 1)
        phi_a = torch.sum(uvf * cell_flux * nf, dim=1)         # (C, 2)
        phi_d = torch.sum(df, dim=1)
        phi_p = torch.sum(pf * graph.cell_normal * e, dim=1)
        acc = -phi_a - phi_p / self.rho + phi_d
        acc = torch.where(graph.cell_mask[:, None], acc, torch.zeros_like(acc))
        return acc, {"norm_face_area": face_area,
                     "cell_flux": cell_flux[..., 0]}


def physical_acceleration(graph, phi_a, phi_p, phi_d, rho: float = 1.0,
                          nu: float = 1e-3) -> torch.Tensor:
    """mean(dt)/V * (-Phi_A - Phi_P/rho + nu Phi_D) on live cells, 0 on
    padded ones, the volume clamped at 1e-12 (Fvgn.py:425-460)."""
    coeff = torch.mean(graph.dt) / torch.clamp(
        graph.cell_volume.reshape(-1, 1), min=1e-12)
    acc = coeff * (-phi_a - phi_p / rho + nu * phi_d)
    return torch.where(graph.cell_mask[:, None], acc, torch.zeros_like(acc))


class PhysicalIntegrator(nn.Module):
    """Real-space integrator (reference ``FvgnB.Integrator``,
    Fvgn.py:425-460): the true dt/V scaling and a viscous term from the MLS
    face velocity gradient (``graph.face_grad_weights``). ``edge_output`` =
    [u_f, v_f, p_f] in physical units. Returns (acc, {})."""

    def __init__(self, rho: float = 1.0, nu: float = 1e-3):
        super().__init__()
        self.rho = rho
        self.nu = nu

    def forward(self, edge_output, graph, train: bool = False):
        unv = graph.cell_normal
        area = graph.face_area.reshape(-1, 1)
        uv = edge_output[:, :2]
        p = edge_output[:, 2:3]
        uu_vu = torch.cat([uv[:, 0:1] * uv, uv[:, 1:2] * uv], dim=-1)
        grad = calc_gradient_tensor(uv, graph.face_grad_weights,
                                    graph.face_grad_neighbours)   # (F, 4)
        gg = gather3(torch.cat([area, uu_vu, grad, p], dim=1), graph)
        e, uu, gr, pf = (gg[..., 0:1], gg[..., 1:5].reshape(-1, 3, 2, 2),
                         gg[..., 5:9].reshape(-1, 3, 2, 2), gg[..., 9:10])
        phi_a = torch.sum(torch.einsum("cfkd,cfd->cfk", uu, unv) * e, dim=1)
        phi_d = torch.sum(torch.einsum("cfkd,cfd->cfk", gr, unv) * e, dim=1)
        phi_p = torch.sum(pf * unv * e, dim=1)
        return (physical_acceleration(graph, phi_a, phi_p, phi_d, self.rho,
                                      self.nu), {})


class LearnedScaleDenorm(nn.Module):
    """Learned per-channel output scale, and with ``learn_bias`` a learned
    bias initialized at 0 (reference ``FvgnJ``, Fvgn.py:1149-1157). FluxD
    has no biases: they are constant 0 there, not parameters
    (Flux.py:471-475)."""

    def __init__(self, channels: int, init_scale=1.0, learn_bias: bool = False):
        super().__init__()
        init = torch.broadcast_to(torch.as_tensor(init_scale, dtype=torch.float32),
                                  (channels,))
        self.scale = nn.Parameter(init.clone())
        self.bias = (nn.Parameter(torch.zeros(channels)) if learn_bias
                     else None)

    def forward(self, x):
        if self.bias is None:
            return x * self.scale
        return x * self.scale + self.bias
