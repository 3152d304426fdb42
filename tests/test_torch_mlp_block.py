"""K8, the unfused GN sub-block's MLP -> LayerNorm -> residual, checked on
the CPU, where its wrapper takes its plain version:

* the plain version against ``MLP.forward`` on ``_with_extra``'s
  concatenation plus the residual, bit for bit, in both forms, with and
  without the step scalar, with and without the dual output, on the parts'
  dtypes the routes pass;
* a ``GNBlock`` on the unfused route (aggregation ``"pallas"``: the CPU
  takes the kernels' plain versions) against the block as it ran before
  K8, the MLP modules on the concatenations and the residuals outside,
  bit for bit: cell-first, face-first and with ``face_raw``, on the index
  and the table route;
* which sub-blocks K8 takes (``arch.mlp_block_ok``): not f32 MLPs, the
  fused route, the plain route or train mode, and none of a Conservative
  model's; on a graph of two space ranks the residual stays outside K8,
  after the refresh;
* the counters ``gn_mlp.kernel`` / ``gn_mlp.plain`` a forward (30 / 0 for
  FvgnF in bf16, 0 / 30 in f32) and one weight pack per MLP;
* the packed layout's permutations, which the kernel's register layout
  rests on (``csrc/mlp_block.cu``), and the wrapper's refusals.

Inputs come from seeded generators at the kernels' width (hidden 128) on a
300-point cylinder mesh.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import dataclasses

import pytest
import torch

from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset, Trajectory,
                                                        rollout_batch)
from gnn_fluid_dynamics_tpu_torch.data.synthetic import (channel_flow_trajectory,
                                                         cylinder_channel_mesh)
from gnn_fluid_dynamics_tpu_torch.graph import to_static_bands
from gnn_fluid_dynamics_tpu_torch.models import arch
from gnn_fluid_dynamics_tpu_torch.models.arch import MLP, ArchConfig, GNBlock
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig, feature_masks
from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.ops import kernels
from gnn_fluid_dynamics_tpu_torch.ops.connectivity import build_geometry
from gnn_fluid_dynamics_tpu_torch.ops.reorder import rcm_reorder_geometry
from gnn_fluid_dynamics_tpu_torch.training import profiling

H = 128
MP = 15


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.float().contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def dataset():
    geom = rcm_reorder_geometry(build_geometry(
        *cylinder_channel_mesh(n_points=300, seed=0), NodeType))
    traj = Trajectory(mesh_id="m0", geom=geom, dt=0.01,
                      fields=channel_flow_trajectory(geom, 3))
    return MeshDataset([traj], with_banded=True, banded_dtype="int8",
                       device="cpu")


@pytest.fixture(scope="module")
def graphs(dataset):
    batch = dataset.get_batch(rollout_batch(dataset))
    index, table = (to_static_bands(batch, derive_idx=d) for d in (True, False))
    assert table.table_route and not index.table_route
    return {"index": index, "table": table}


def _mlp(k0, seed, dtype=torch.bfloat16):
    """An MLP at fan-in ``k0`` with nonzero biases and LayerNorm parameters
    away from their init, so every term of the function shows."""
    mlp = MLP(k0, H, H, dtype=dtype,
              generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in (mlp.dense0.bias, mlp.dense1.bias, mlp.dense2.bias,
                  mlp.layer_norm.bias):
            p.copy_(0.1 * torch.randn(p.shape, generator=g))
        mlp.layer_norm.weight.copy_(1.0 + 0.2 * torch.randn(H, generator=g))
    return mlp


def _parts(form, dtypes, rows, seed):
    g = torch.Generator().manual_seed(seed)
    widths = (H, H // 2) if form == "cell" else (H, H, H)
    return [torch.randn(rows, w, generator=g).to(dt)
            for w, dt in zip(widths, dtypes)]


# ---- the plain version against MLP.forward ----------------------------------

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("form, dtypes", [
    ("cell", (F32, F32)),            # K5's and K7's f32 vertex mean
    ("face", (F32, BF16, BF16)),     # K4's and K6's bf16 rows
    ("face", (F32, F32, F32)),       # the plain route's f32 rows
])
@pytest.mark.parametrize("step", [False, True])
@pytest.mark.parametrize("dual_out", [False, True])
def test_plain_version_is_mlp_forward_plus_residual(form, dtypes, step,
                                                    dual_out):
    k0 = (H + H // 2 if form == "cell" else 3 * H) + int(step)
    mlp = _mlp(k0, seed=3)
    parts = _parts(form, dtypes, 517, seed=4)
    extra = torch.tensor([[7 / 15]]) if step else None
    raw_before = mlp(arch._with_extra(parts, extra, 517))
    res_before = parts[0] + raw_before
    w = mlp.kernel_weights(mlp_block=True)
    got = kernels.mlp_block(parts, extra, w, residual=True, dual_out=dual_out)
    raw, res = got if dual_out else (None, got)
    assert res.dtype == torch.float32
    assert torch.equal(_bits(res), _bits(res_before))
    if dual_out:
        assert raw.dtype == torch.bfloat16
        assert torch.equal(_bits(raw), _bits(raw_before))
    raw_only = kernels.mlp_block(parts, extra, w, residual=False)
    assert torch.equal(_bits(raw_only), _bits(raw_before))


# ---- the GN block as it ran before ------------------------------------------

def _old_block(block, cell, edge, g, extra, face_raw):
    """The unfused block as it ran before K8: each sub-block's MLP module on
    ``_with_extra``'s concatenation of the aggregations' outputs, the
    residuals added after."""
    def cell_mlp(c, e):
        agg = arch.aggregate_twice_mp(e, g, use_kernels=True)
        return block.cell_block.mlp(arch._with_extra([c, agg], extra,
                                                     c.shape[0]))

    def face_mlp(c, e):
        own, nbr = arch.gather_face_cells(c, g, use_kernels=True)
        return block.face_block.mlp(arch._with_extra([e, own, nbr], extra,
                                                     e.shape[0]))

    if block.face_first:
        new_edge = face_mlp(cell, edge)
        new_cell = cell_mlp(cell, new_edge)
    else:
        new_cell = cell_mlp(cell, edge)
        new_edge = face_mlp(new_cell, edge)
    out = (cell + new_cell, edge + new_edge)
    return out + (new_edge,) if face_raw else out


def _block(order, step, dtype="bfloat16", seed=11):
    cfg = ArchConfig(hidden=H, mp_num=MP, aggregation="pallas",
                     compute_dtype=dtype, step_scalar=step, block_order=order)
    return GNBlock(cfg, generator=torch.Generator().manual_seed(seed))


def _latents(g, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(g.num_cells, H, generator=gen),
            torch.randn(g.num_faces, H, generator=gen))


@pytest.mark.parametrize("route", ["index", "table"])
@pytest.mark.parametrize("order, face_raw, step", [
    ("cell_first", False, True),     # FvgnF
    ("cell_first", False, False),    # Flux, FVGN on the table route
    ("face_first", False, False),    # MGN on the table route
    ("cell_first", True, False),     # VertPot on the table route
])
def test_gn_block_unfused_is_unchanged(graphs, route, order, face_raw, step):
    g = graphs[route]
    block = _block(order, step)
    cell, edge = _latents(g, seed=12)
    extra = torch.tensor([[4 / 15]]) if step else None
    calls = []
    k8 = kernels.mlp_block

    def counted(*args, **kwargs):
        calls.append(kwargs)
        return k8(*args, **kwargs)

    kernels.mlp_block = counted
    try:
        got = block(cell, edge, g, extra, route="unfused", face_raw=face_raw)
    finally:
        kernels.mlp_block = k8
    want = _old_block(block, cell, edge, g, extra, face_raw)
    assert len(calls) == 2 and all(c["residual"] for c in calls)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    assert got[0].dtype == got[1].dtype == torch.float32


# ---- who takes K8 -----------------------------------------------------------

def test_routing_predicate():
    cell_fans, face_fans = arch.CellBlock.FAN_INS, arch.FaceBlock.FAN_INS
    bf = _mlp(H + H // 2 + 1, seed=1)
    assert arch.mlp_block_ok(bf, "unfused", cell_fans)
    assert arch.mlp_block_ok(_mlp(3 * H, seed=1), "unfused", face_fans)
    assert not arch.mlp_block_ok(bf, "fused", cell_fans)
    assert not arch.mlp_block_ok(bf, "plain", cell_fans)
    assert not arch.mlp_block_ok(bf, "unfused", face_fans)
    assert not arch.mlp_block_ok(_mlp(H + H // 2, seed=1, dtype=F32),
                                 "unfused", cell_fans)
    no_ln = MLP(3 * H, H, H, layer_norm=False, dtype=BF16,
                generator=torch.Generator().manual_seed(0))
    assert not arch.mlp_block_ok(no_ln, "unfused", face_fans)
    narrow = MLP(3 * 32, 32, 32, dtype=BF16,
                 generator=torch.Generator().manual_seed(0))
    assert not arch.mlp_block_ok(narrow, "unfused", (96, 97))


def _count_k8(monkeypatch):
    calls = []
    k8 = kernels.mlp_block

    def counted(*args, **kwargs):
        calls.append(1)
        return k8(*args, **kwargs)

    monkeypatch.setattr(kernels, "mlp_block", counted)
    return calls


@pytest.mark.parametrize("case", ["f32", "fused", "train"])
def test_other_paths_keep_their_code(graphs, monkeypatch, case):
    """An f32 block, the fused route and a train-mode application never
    reach K8, and give what the MLP modules give."""
    calls = _count_k8(monkeypatch)
    g = graphs["index"]
    cell, edge = _latents(g, seed=21)
    block = _block("cell_first", step=False,
                   dtype="float32" if case == "f32" else "bfloat16")
    if case == "f32":
        got = block(cell, edge, g, None, route="unfused")
        want = _old_block(block, cell, edge, g, None, False)
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
    elif case == "fused":
        block(cell, edge, g, None, route="fused")
    else:
        route = arch.block_route(ArchConfig(
            hidden=H, aggregation="pallas", compute_dtype="bfloat16"), g,
            cell, None, train=True)
        assert route == "plain"
        block(cell, edge, g, None, route=route, train=True)
    assert calls == []


def _model(name, graph, mp, dtype):
    """``name`` at hidden 128 on the kernel route, with statistics from
    ``graph``'s features; and those features."""
    model = get_model_class(name)(ModelConfig(
        name=name, hidden_width=H, mp_num=mp, aggregation="pallas",
        compute_dtype=dtype), device="cpu")
    _, feats = model.transform_rollout(graph)
    acc = StatsAccumulator(model.nmap)
    acc.update(feats, feature_masks(graph, feats))
    model.set_stats(acc.finalize())
    return model, feats


def test_conservative_model_never_reaches_k8(graphs, monkeypatch):
    calls = _count_k8(monkeypatch)
    model, feats = _model("ConservativeH", graphs["index"], 2, "bfloat16")
    model.forward(graphs["index"], feats)
    assert calls == []


class _TwoRanks:
    n_space = 2


@pytest.mark.parametrize("order", ["cell_first", "face_first"])
def test_two_space_ranks_keep_the_residual_outside(graphs, monkeypatch, order):
    """On a graph of two space ranks K8 returns raw only; each raw output is
    refreshed (a recording stand-in here) before the residual adds it and
    the next sub-block reads it, as before."""
    g = graphs["index"]
    sharded = dataclasses.replace(g, halo=_TwoRanks())
    refreshed = []

    def refresh(x, graph, kind):
        refreshed.append((kind, x.dtype))
        return x

    monkeypatch.setattr(arch, "refresh", refresh)
    calls = []
    k8 = kernels.mlp_block

    def counted(*args, **kwargs):
        calls.append(kwargs)
        return k8(*args, **kwargs)

    monkeypatch.setattr(kernels, "mlp_block", counted)
    block = _block(order, step=True)
    cell, edge = _latents(g, seed=31)
    extra = torch.tensor([[1 / 15]])
    got = block(cell, edge, sharded, extra, route="unfused")
    want = _old_block(block, cell, edge, g, extra, False)
    assert [c["residual"] for c in calls] == [False, False]
    kinds = ["face", "cell"] if order == "face_first" else ["cell", "face"]
    assert refreshed == [(k, torch.float32) for k in kinds]
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


# ---- counters and the weight cache ----------------------------------------

@pytest.mark.parametrize("dtype, kernel, plain", [("bfloat16", 2 * MP, 0),
                                                  ("float32", 0, 2 * MP)])
def test_counters_a_forward(graphs, dtype, kernel, plain):
    model, feats = _model("FvgnF", graphs["index"], MP, dtype)
    model.forward(graphs["index"], feats)          # packs the weights
    with profiling.recording() as rec:
        model.forward(graphs["index"], feats)
    want = {"gn_block.unfused": MP}
    if kernel:
        want["gn_mlp.kernel"] = kernel
    if plain:
        want["gn_mlp.plain"] = plain
    assert rec.counters == want                     # no weight pack


def test_weights_pack_once_per_form():
    mlp = _mlp(H + H // 2 + 1, seed=5)
    with profiling.recording() as rec:
        w = mlp.kernel_weights(mlp_block=True)
        assert mlp.kernel_weights(mlp_block=True) is w
        packed = mlp.kernel_weights(packed=False)
        assert mlp.kernel_weights(mlp_block=True) is w     # forms kept apart
        assert mlp.kernel_weights() is packed
        with torch.no_grad():
            mlp.dense2.weight.mul_(2.0)
        assert mlp.kernel_weights(mlp_block=True) is not w
    assert rec.counters == {"mlp.weight_packs": 3}
    w = mlp.kernel_weights(mlp_block=True)
    for (weight, bias), layer in zip(w.dense, (mlp.dense0, mlp.dense1,
                                               mlp.dense2)):
        assert weight.dtype == bias.dtype == torch.bfloat16
        assert torch.equal(weight, layer.weight.to(torch.bfloat16))
        assert torch.equal(bias, layer.bias.to(torch.bfloat16))
    assert w.ln_g.dtype == w.ln_b.dtype == torch.float32
    assert torch.equal(w.w0_step, mlp.dense0.weight[:, -1].to(torch.bfloat16))
    assert w.packed.shape == ((H + H // 2 + 2 * H) * H,)
    assert _mlp(3 * H, seed=5).kernel_weights(mlp_block=True).w0_step is None


def _unpack(flat, k, n):
    """:func:`kernels._core_matrices` undone: (k, n)."""
    return flat.reshape(k // 8, n // 8, 8, 8).permute(0, 3, 1, 2).reshape(k, n)


def test_packed_layout_follows_the_register_layout():
    """A thread (quad position q) holds A fragment rows 2q, 2q+1, 2q+8, 2q+9
    of each k step: they must be input columns 4q..4q+3. Its accumulator
    columns 8i+2q+j must be output columns 16(i//2)+4q+2(i%2)+j. W0's rows
    and W2's columns are packed so."""
    for q in range(4):
        assert [kernels._K_STEP[p] for p in (2 * q, 2 * q + 1, 2 * q + 8,
                                              2 * q + 9)] == [4 * q + t
                                                             for t in range(4)]
        for i in range(16):
            for j in range(2):
                assert kernels._OUT[8 * i + 2 * q + j] == (
                    16 * (i // 2) + 4 * q + 2 * (i % 2) + j)
    assert sorted(kernels._OUT) == list(range(H))
    g = torch.Generator().manual_seed(9)
    w0, w1, w2 = (torch.randn(k, H, generator=g) for k in (3 * H, H, H))
    flat = kernels.pack_mlp_block(w0, w1, w2)
    p0 = _unpack(flat[:3 * H * H], 3 * H, H)
    p1 = _unpack(flat[3 * H * H:4 * H * H], H, H)
    p2 = _unpack(flat[4 * H * H:], H, H)
    for p in range(3 * H):
        assert torch.equal(p0[p], w0[16 * (p // 16) + kernels._K_STEP[p % 16]])
    assert torch.equal(p1, w1)
    assert torch.equal(p2, w2[:, kernels._OUT])


def test_wrapper_refusals():
    """Checked before any launch (``meta`` tensors take the card's path)."""
    w = _mlp(H + H // 2, seed=6).kernel_weights(mlp_block=True)
    meta = kernels.MlpBlockWeights(
        tuple((a.to("meta"), b.to("meta")) for a, b in w.dense),
        w.ln_g.to("meta"), w.ln_b.to("meta"), w.packed.to("meta"), None)
    rows = 64
    cell = [torch.empty(rows, H, device="meta"),
            torch.empty(rows, H // 2, device="meta")]
    with pytest.raises(ValueError, match="2 parts"):
        kernels.mlp_block(cell + cell, None, meta)
    with pytest.raises(ValueError, match="step scalar"):
        kernels.mlp_block(cell, torch.empty(1, 1, device="meta"), meta)
    with pytest.raises(ValueError, match="shape"):
        kernels.mlp_block([cell[0], torch.empty(rows, H, device="meta")],
                          None, meta)
    with pytest.raises(ValueError, match="shape"):      # face form, cell weights
        kernels.mlp_block([cell[0]] * 3, None, meta)
    with pytest.raises(ValueError, match="dtype"):      # K5/K7 give f32
        kernels.mlp_block([cell[0], cell[1].to(torch.bfloat16)], None, meta)
