"""Core neural architecture: MLPs, GN blocks, encode-process-decode and the
FVGN integrator.

Counterpart of ``gnn_fluid_dynamics_tpu/models/arch.py`` for what the FluxD
and FvgnA/FvgnF rollouts run. Module and parameter names follow the Flax
tree, so :func:`gnn_fluid_dynamics_tpu_torch.weights.params_from_flax` maps
one onto the other.

The GN blocks take one of two routes, as in the JAX package:

* the **kernel** route, through the CUDA kernels of
  :mod:`gnn_fluid_dynamics_tpu_torch.ops.kernels` on the card (their plain
  versions on the CPU). A block without a step scalar on a graph on the
  index route is **fused**: per block the edge->vertex sum (K3), the fused
  cell block (K2) and the fused face block (K1), with bf16 latents between
  them. Any other block is **unfused**, its MLPs run as :class:`MLP` modules
  and its residuals outside the kernels: on the index route (a block with a
  step scalar, as in FvgnF) K3 then the 3-vertex mean (K5) before the cell
  MLP and the owner/neighbour gather (K4) before the face MLP; on a graph on
  the table route (``MeshGraph.table_route``, the trainer's validation
  graph) the dense-table kernels instead: K6 on the es/er tables then K7 on
  vc before the cell MLP, K6 on the cf tables before the face MLP
  (``_fused_block_ok``, ``aggregate_twice_mp``, ``gather_face_cells``);
* the **plain** route: segment aggregation, row gathers and the
  :class:`MLP` modules in the configured compute dtype.

Every module takes ``train`` (and ``rng``, the ``torch.Generator`` dropout
draws from), as the Flax modules do: in train mode the blocks take the plain
route (the kernels have no backward), the MLPs apply dropout, the
integrator's BatchNorm normalizes by the batch's statistics and updates its
running ones, and with ``ArchConfig.remat`` each GN block application is
recomputed in the backward pass instead of keeping its activations.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from gnn_fluid_dynamics_tpu_torch.ops import kernels
from gnn_fluid_dynamics_tpu_torch.ops import segment as seg_ops

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
    mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
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
        self._kernel_cache = None

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

    def kernel_weights(self, dtype=torch.bfloat16, packed: bool = False):
        """This MLP as the fused blocks take it: matrices (inputs, outputs),
        every tensor in ``dtype`` (the kernels take bf16; the plain versions
        any float dtype). With ``packed``, the fused kernels' (K1's and
        K2's) ``PackedWeights``: the same with the matrices packed as the
        kernels read them (``kernels.packed_weights``).
        Cached until a parameter is replaced or changed in place, so the
        packing runs once per set of weights."""
        params = (self.dense0.weight, self.dense0.bias, self.dense1.weight,
                  self.dense1.bias, self.dense2.weight, self.dense2.bias,
                  self.layer_norm.weight, self.layer_norm.bias)
        key = (dtype, packed) + tuple((p.data_ptr(), p._version) for p in params)
        if self._kernel_cache is None or self._kernel_cache[0] != key:
            w = kernels.BlockWeights(*(
                (p.detach().t() if p.ndim == 2 else p.detach()).to(dtype).contiguous()
                for p in params))
            self._kernel_cache = (key, kernels.packed_weights(w) if packed else w)
        return self._kernel_cache[1]


def aggregate_twice_mp(edge_attr: torch.Tensor, graph,
                       use_kernels: bool = False) -> torch.Tensor:
    """The reference's 'twice message passing': forward/reverse halves of the
    edge latents summed onto vertices, then each cell's 3-vertex mean
    (``Fvgn.py:305-321``). Returns (C, H/2) f32. With ``use_kernels`` the
    unfused block's kernels on bf16 latents: K6 (es/er) then K7 (vc) on a
    graph on the table route, K3 then K5 on the index route."""
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


class CellBlock(nn.Module):
    """Edge->vertex->cell aggregation + cell MLP (reference ``Cell_Block``,
    Fvgn.py:298-325)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None):
        super().__init__()
        self.mlp = MLP(cfg.hidden + cfg.hidden // 2 + int(cfg.step_scalar),
                       cfg.hidden, cfg.hidden, dtype=cfg.dtype,
                       dropout_rate=cfg.dropout_rate, generator=generator)

    def forward(self, cell_attr, edge_attr, graph, extra=None,
                route: str = "plain", dual_out: bool = False,
                train: bool = False, rng: torch.Generator = None):
        if route == "fused":
            vtx = kernels.edges_to_vertices(edge_attr.to(torch.bfloat16), graph)
            return kernels.fused_cell_block(
                cell_attr.to(torch.bfloat16), vtx, graph,
                self.mlp.kernel_weights(packed=True), dual_out=dual_out)
        cell_agg = aggregate_twice_mp(edge_attr, graph, route == "unfused")
        return self.mlp(_with_extra([cell_attr, cell_agg], extra,
                                    cell_attr.shape[0]), train, rng)


class FaceBlock(nn.Module):
    """[edge | cell_owner | cell_neighbour] -> face MLP (reference
    ``Face_Block``, Fvgn.py:286-296). Unfused, the kernel route gathers the
    cell rows in bf16 and the concatenation widens them to f32, as the JAX
    wrapper's cast does."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None):
        super().__init__()
        self.mlp = MLP(3 * cfg.hidden + int(cfg.step_scalar), cfg.hidden,
                       cfg.hidden, dtype=cfg.dtype,
                       dropout_rate=cfg.dropout_rate, generator=generator)

    def forward(self, cell_attr, edge_attr, graph, extra=None,
                route: str = "plain", dual_out: bool = False,
                train: bool = False, rng: torch.Generator = None):
        if route == "fused":
            return kernels.fused_face_block(cell_attr.to(torch.bfloat16),
                                            edge_attr.to(torch.bfloat16),
                                            graph,
                                            self.mlp.kernel_weights(packed=True),
                                            dual_out=dual_out)
        own, nbr = gather_face_cells(cell_attr, graph, route == "unfused")
        return self.mlp(_with_extra([edge_attr, own, nbr], extra,
                                    edge_attr.shape[0]), train, rng)


class GNBlock(nn.Module):
    """One processor block with residuals, on the ``route`` of
    :func:`block_route`, in the config's ``block_order``: FVGN's cell block,
    then face block (Fvgn.py:274-284), or MGN's face block, then cell block
    (Mgn.py:216-226). The second sub-block reads the first one's raw
    (pre-residual) output and the other input as the block received it.

    Fused, the residuals are applied inside the kernels. Cell-first: K3 ->
    K2 with both outputs, then K1 on K2's raw output. Face-first: K1 with
    both outputs, then K3 on K1's raw output -> K2 with the residual only."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator = None):
        super().__init__()
        self.face_first = cfg.block_order == "face_first"
        self.cell_block = CellBlock(cfg, generator)
        self.face_block = FaceBlock(cfg, generator)

    def forward(self, cell_attr, edge_attr, graph, extra=None,
                route: str = "plain", train: bool = False,
                rng: torch.Generator = None):
        if route == "fused" and self.face_first:
            e_raw, e_res = self.face_block(cell_attr, edge_attr, graph,
                                           route=route, dual_out=True)
            c_res = self.cell_block(cell_attr, e_raw, graph, route=route)
            return c_res, e_res
        if route == "fused":
            c_raw, c_res = self.cell_block(cell_attr, edge_attr, graph,
                                           route=route, dual_out=True)
            e_res = self.face_block(c_raw, edge_attr, graph, route=route)
            return c_res, e_res
        if self.face_first:
            new_edge = self.face_block(cell_attr, edge_attr, graph, extra,
                                       route, train=train, rng=rng)
            new_cell = self.cell_block(cell_attr, new_edge, graph, extra,
                                       route, train=train, rng=rng)
        else:
            new_cell = self.cell_block(cell_attr, edge_attr, graph, extra,
                                       route, train=train, rng=rng)
            new_edge = self.face_block(new_cell, edge_attr, graph, extra,
                                       route, train=train, rng=rng)
        return cell_attr + new_cell, edge_attr + new_edge


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
            face_out = self.decoder_face(edge_attr, train, rng)
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

    def forward(self, x, mask=None, train: bool = False):
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.float()
            m = mask.reshape(-1, 1).expand_as(xf)
            xm = torch.where(m, xf, torch.zeros_like(xf))
            n = m.sum(0)
            mean = xm.sum(0) / n
            var = torch.clamp((xm * xm).sum(0) / n - mean * mean, min=0.0)
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
