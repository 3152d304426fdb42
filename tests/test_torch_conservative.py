"""The port's Conservative family (ConservativeA, B, D-K) against the JAX
package's, with the Flax variables carried over by ``params_from_flax``, and
the pieces it stands on: ``AntisymMLP``, the face -> cell aggregation and
the twice message passing at 2H = 256 channels (ConservativeH/J/K).

* The one-step total log loss of ``tests/test_golden.py`` (the JAX package's
  ``PRNGKey(7)`` weights on ``test_models.build_graph(grad_weights=True)``,
  hidden 32, 2 blocks): within 1e-5 of the golden value and of the JAX
  package's; every loss component within 1e-4 relative of JAX's (1e-12
  absolute at f32 rounding level); the port's own statistics within 1e-6
  of JAX's. With the JAX package's train-mode batch statistics in place of
  the port's, every total with a BatchNorm is within 1e-6 of JAX's.
* A rollout-mode forward on the RCM-ordered 300-point cylinder mesh (518
  cells, padded to 640), f32 plain route, hidden 32, 2 blocks, every
  BatchNorm and learned bias moved off its init: each output within 1e-5 of
  JAX's ``"segment"`` route, as the largest difference over live rows
  relative to the output's largest magnitude.
* The kernel route on the kernels' plain versions (``aggregation="pallas"``,
  hidden 128, 2 blocks, bf16) against JAX's ``"pallas"`` route in interpret
  mode, for F (K3 -> K5 at 128 lanes), H and K (at 256): within 4e-2, as
  the other families' bf16 routes (the aggregation's input rounded to bf16
  on both sides; the sums in another order).
* ``rollout_scan``: 4 steps of A, B, H and J against the JAX package's,
  errors and the final state within 1e-4 relative.
* Train mode: the loss and the gradients' global norm of A, D, H and J
  within 1e-5 and 1e-4 relative of JAX's, on the edge flip and the noise
  the JAX package drew (the flip applied through ``flip_edges``), with the
  JAX package's batch statistics; ``compute_dtype`` reaches only E, F, G
  and I's FVGN encoder, bit for bit. Training through ``train.main`` and
  AdamW's decay: in ``tests/test_torch_conservative_training.py``.
* The pieces: ``AntisymMLP`` odd bit for bit and against Flax's (1e-6
  relative; with its LayerNorm 1e-5, the f32 model tolerance: the
  normalization divides the products' rounding by a 5-wide row's standard
  deviation, measured 1.25e-6); ``aggregate_faces_to_cells`` against JAX's on a padded mesh
  with boundary self-loops, both parities (1e-6 relative: three f32 terms
  summed in another order); the plain versions of K3 -> K5 and of K6 (roll)
  -> K7 on a 256-wide ``[X | X]`` against JAX's
  ``aggregate_edges_to_vertices_pallas`` -> ``aggregate_vertices_to_cells_pallas``
  in interpret mode, on the index route and on the dense tables, over live
  cells (within 2^-7 of the largest value: one bf16 rounding of a sum taken
  in another order); ``params_from_flax`` on each of the ten trees at 3
  blocks; ConservativeA from ``config/e2e/conservativea.json``.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.synthetic import (channel_flow_trajectory,
                                                   make_geometry)
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.graph import to_static_bands as jax_static_bands
from gnn_fluid_dynamics_tpu.models import arch as jax_arch
from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.models import normalizer as jax_norm
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_masks
from gnn_fluid_dynamics_tpu.ops import pallas_agg
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry
from test_models import LOSS_WEIGHTS
from test_torch_flux_family import (check_golden,
                                    check_golden_with_jax_statistics,
                                    check_rollout_forward, check_rollout_scan,
                                    jax_batch_statistics)  # noqa: F401
from test_torch_fvgn_family import (_golden_graphs, _jax_golden, _rel,
                                    _small_models, _stats_floats,
                                    cylinder)  # noqa: F401

from gnn_fluid_dynamics_tpu_torch.graph import from_geometry, to_static_bands
from gnn_fluid_dynamics_tpu_torch.models import arch
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig, feature_masks
from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.models.transforms import flip_edges
from gnn_fluid_dynamics_tpu_torch.ops import kernels
from gnn_fluid_dynamics_tpu_torch.training import train as train_cli
from gnn_fluid_dynamics_tpu_torch.training.config import load_config
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

ROOT = pathlib.Path(__file__).resolve().parents[1]
VARIANTS = ("ConservativeA", "ConservativeB", "ConservativeD", "ConservativeE",
            "ConservativeF", "ConservativeG", "ConservativeH", "ConservativeI",
            "ConservativeJ", "ConservativeK")
# B (MGN's head) and J (the physical integrator) have no BatchNorm
WITH_BATCH_NORM = tuple(n for n in VARIANTS
                        if n not in ("ConservativeB", "ConservativeJ"))
FACE_OUTPUTS = ("cell_velocity_change", "face_velocity", "face_pressure")
OUTPUTS = {n: FACE_OUTPUTS for n in VARIANTS}
OUTPUTS["ConservativeB"] = ("cell_velocity_change", "cell_pressure")
# the twice message passing's width per variant (None: no vertex route)
TWICE_MP_WIDTH = {"ConservativeF": 128, "ConservativeG": 128,
                  "ConservativeI": 128, "ConservativeH": 256,
                  "ConservativeJ": 256, "ConservativeK": 256}
F32_TOL, BF16_TOL = 1e-5, 4e-2
LOSS_RTOL, GRAD_NORM_RTOL = 1e-5, 1e-4
PIECE_RTOL = 1e-6
AGG_TOL = 2.0 ** -7
KERNEL_HIDDEN, KERNEL_MP = 128, 2


# ---- the models ------------------------------------------------------------------

@pytest.mark.parametrize("name", VARIANTS)
def test_golden_one_step_loss(name):
    check_golden(name)


@pytest.mark.parametrize("name", WITH_BATCH_NORM)
def test_golden_with_the_jax_batch_statistics(name, jax_batch_statistics):
    check_golden_with_jax_statistics(name)


@pytest.mark.parametrize("name", VARIANTS)
def test_rollout_forward_matches_jax(cylinder, name):
    check_rollout_forward(cylinder, name, OUTPUTS[name])


@pytest.mark.parametrize("name", ["ConservativeA", "ConservativeB",
                                  "ConservativeH", "ConservativeJ"])
def test_rollout_scan_matches_jax(cylinder, name):
    check_rollout_scan(cylinder, name)


@pytest.mark.parametrize("name", ["ConservativeA", "ConservativeD",
                                  "ConservativeH", "ConservativeJ"])
def test_train_mode_with_the_jax_flip_and_noise(name, jax_batch_statistics):
    """The JAX package's draw (noise on the t0 velocity, then the flip mask
    of its second key) given to the port as the noised velocity and the
    flipped graph: the same loss and the same gradients' global norm."""
    gj, gt = _golden_graphs()
    jm, variables, tm = _small_models(name)
    key = jax.random.PRNGKey(11)
    tgj, fj = jm.transform_features(gj, key, mode="train", noise_std=0.05)
    _, k_flip = jax.random.split(key)
    flip = (np.asarray(jax.random.bernoulli(k_flip, 0.5, (gj.num_faces,)))
            & np.asarray(gj.face_mask))
    assert flip.any()

    def loss_fn(params):
        out, _ = jm.forward({**variables, "params": params}, tgj, fj,
                            mode="train")
        return jm.loss(out, fj, tgj)["total_log_loss"]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    norm_j = float(jnp.sqrt(sum(jnp.sum(g ** 2)
                                for g in jax.tree.leaves(grads_j))))
    tgt, _ = flip_edges(gt, torch.from_numpy(flip))
    noised = torch.from_numpy(np.array(fj["cell_x"]))
    assert not torch.equal(noised, gt.cell_velocity[:, 0])
    tgt = tgt.replace(cell_velocity=torch.cat(
        [noised[:, None], tgt.cell_velocity[:, 1:]], dim=1))
    tgt, ft = tm.transform_features(tgt, None, mode="train")
    for k in ft:
        np.testing.assert_allclose(ft[k].numpy(), np.asarray(fj[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    tm.module.train()
    loss_t = tm.loss(tm.forward(tgt, ft, mode="train"), ft,
                     tgt)["total_log_loss"]
    loss_t.backward()
    norm_t = float(torch.sqrt(sum((p.grad ** 2).sum()
                                  for p in tm.module.parameters()
                                  if p.grad is not None)))
    assert _rel(loss_t.item(), float(loss_j)) <= LOSS_RTOL
    assert _rel(norm_t, norm_j) <= GRAD_NORM_RTOL


def test_compute_dtype_reaches_only_the_fvgn_encoder(cylinder):
    """Every MLP of the family runs in f32 whatever ``compute_dtype`` says,
    as in the JAX package; E, F, G and I's FVGN ``Encoder`` alone takes it.
    So bf16 changes nothing of A, B, D, H, J and K, bit for bit."""
    _, _, _, gt = cylinder
    moved = {}
    for name in VARIANTS:
        outs = []
        for dtype in ("float32", "bfloat16"):
            tm = get_model_class(name)(ModelConfig(
                hidden_width=32, mp_num=2, aggregation="segment",
                compute_dtype=dtype), device="cpu", seed=3)
            _, feats = tm.transform_rollout(gt)
            acc = StatsAccumulator(tm.nmap)
            acc.update(feats, feature_masks(gt, feats))
            tm.set_stats(acc.finalize())
            with torch.no_grad():
                outs.append(tm.forward(gt, feats)["cell_velocity_change"])
        moved[name] = not torch.equal(*outs)
    assert moved == {n: n in ("ConservativeE", "ConservativeF",
                              "ConservativeG", "ConservativeI")
                     for n in VARIANTS}


# ---- the kernel route -------------------------------------------------------------

@pytest.fixture(scope="module")
def banded_cylinder():
    """The cylinder window for the kernel routes: the JAX graph with its
    banded tables on the index route (``to_static_bands``) and on the dense
    tables (``derive_idx=False``); the port's on the index route and on its
    f32 tables (the table route)."""
    geom = rcm_reorder_geometry(make_geometry("cylinder", n_points=300, seed=0))
    window = {k: v[:2] for k, v in channel_flow_trajectory(
        geom, num_timesteps=2, dt=0.01).items()}
    kw = dict(dt=0.01, pad_multiple=128)
    gj = jax_from_geometry(geom, window, with_banded=True, **kw)
    return (jax_static_bands(gj), jax_static_bands(gj, derive_idx=False),
            from_geometry(geom, window, device="cpu", **kw),
            to_static_bands(from_geometry(geom, window, with_banded=True,
                                          banded_dtype="float32",
                                          device="cpu", **kw),
                            derive_idx=False))


def _kernel_models(graph_j, graph_t, name):
    """The JAX model on ``"pallas"`` in bf16 (seeded weights at
    KERNEL_HIDDEN, statistics of the window) and the port's with the same
    weights on the kernel route."""
    cfg = dict(name=name, hidden_width=KERNEL_HIDDEN, mp_num=KERNEL_MP,
               aggregation="pallas", compute_dtype="bfloat16")
    jm = jax_model_class(name)(JaxModelConfig(**cfg))
    _, jfeats = jm.transform_rollout(graph_j)
    acc = jax_norm.StatsAccumulator(jm.nmap)
    acc.update(jfeats, jax_masks(graph_j, jfeats))
    jm.set_stats(acc.finalize())
    variables = jm.init(jax.random.PRNGKey(0), graph_j, jfeats)
    tm = get_model_class(name)(ModelConfig(**cfg), device="cpu")
    tm.set_stats(_stats_floats(jm.stats))
    tm.module.load_state_dict(params_from_flax(variables))
    _, tfeats = tm.transform_rollout(graph_t)
    return jm, variables, jfeats, tm, tfeats


def _calls(monkeypatch):
    """The aggregation kernels' wrappers the model calls, in order, each
    with the width of its latents."""
    log = []
    for name in ("fused_face_block", "fused_cell_block", "edges_to_vertices",
                 "gather_face_cells", "vertices_to_cells", "table_dual",
                 "table_single"):
        fn = getattr(kernels, name)

        def spy(*a, _name=name, _fn=fn, **k):
            src = a[3] if _name == "table_dual" else a[2] if (
                _name == "table_single") else a[0]
            log.append((_name, src.shape[1]))
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, spy)
    return log


@pytest.mark.parametrize("name", ["ConservativeF", "ConservativeH",
                                  "ConservativeK"])
def test_kernel_route_matches_jax_pallas(banded_cylinder, name, monkeypatch):
    """K3 -> K5 (their plain versions) per block, at the width of the
    block's ``[e | e]``, against JAX's Pallas route in interpret mode."""
    gj, _, gt, _ = banded_cylinder
    jm, variables, jfeats, tm, tfeats = _kernel_models(gj, gt, name)
    jout, _ = jm.forward(variables, gj, jfeats, mode="rollout")
    log = _calls(monkeypatch)
    with torch.no_grad():
        tout = tm.forward(gt, tfeats)
    w = TWICE_MP_WIDTH[name]
    assert log == [("edges_to_vertices", w),
                   ("vertices_to_cells", w // 2)] * KERNEL_MP
    cm, fm = gt.cell_mask.numpy(), gt.face_mask.numpy()
    for key in FACE_OUTPUTS:
        assert torch.isfinite(tout[key]).all(), key
        assert _rel(tout[key], jout[key], cm if key.startswith("cell")
                    else fm) <= BF16_TOL, key


@pytest.mark.parametrize("name", VARIANTS)
def test_kernel_route_calls(banded_cylinder, name, monkeypatch):
    """Per block: K3 -> K5 on the index route and K6 (roll) -> K7 on the
    table route, at the twice message passing's width (H for F, G, I; 2H for
    H, J, K); no kernel at all for A, B, D and E. The table route agrees
    with the index route within the bf16 tolerance on live rows."""
    _, _, gt, gtab = banded_cylinder
    tm = get_model_class(name)(ModelConfig(hidden_width=KERNEL_HIDDEN,
                                           mp_num=KERNEL_MP,
                                           aggregation="pallas"),
                               device="cpu")
    _, feats = tm.transform_rollout(gt)
    acc = StatsAccumulator(tm.nmap)
    acc.update(feats, feature_masks(gt, feats))
    tm.set_stats(acc.finalize())
    _, tfeats = tm.transform_rollout(gtab)
    log = _calls(monkeypatch)
    with torch.no_grad():
        on_index = tm.forward(gt, feats)
        index_calls, log[:] = list(log), []
        on_tables = tm.forward(gtab, tfeats)
    w = TWICE_MP_WIDTH.get(name)
    if w is None:
        assert index_calls == [] and log == []
        return
    assert index_calls == [("edges_to_vertices", w),
                           ("vertices_to_cells", w // 2)] * KERNEL_MP
    assert log == [("table_dual", w), ("table_single", w // 2)] * KERNEL_MP
    cm, fm = gt.cell_mask, gt.face_mask
    for key in OUTPUTS[name]:
        mask = cm if key.startswith("cell") else fm
        a, b = on_tables[key][mask], on_index[key][mask]
        assert torch.isfinite(a).all(), key
        assert float((a - b).abs().max() / b.abs().max()) <= BF16_TOL, key


# ---- the pieces -------------------------------------------------------------------

@pytest.mark.parametrize("layer_norm", [False, True])
def test_antisym_mlp_is_odd_and_matches_flax(layer_norm):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 6)).astype(np.float32)
    fm = jax_arch.AntisymMLP(16, 5, layer_norm=layer_norm)
    params = fm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tm = arch.AntisymMLP(6, 16, 5, layer_norm=layer_norm)
    sd = params_from_flax(params)
    assert sorted(sd) == sorted(tm.state_dict())
    tm.load_state_dict(sd)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got, neg = tm(xt), tm(-xt)
    assert torch.equal(neg, -got)
    assert _rel(got, fm.apply(params, jnp.asarray(x))) <= (
        F32_TOL if layer_norm else PIECE_RTOL)


@pytest.mark.parametrize("antisym", [False, True])
def test_aggregate_faces_to_cells_matches_jax(cylinder, antisym):
    _, _, gj, gt = cylinder
    assert bool(gt.face_boundary_mask.any())
    assert not bool(gt.cell_mask.all())
    e = np.random.default_rng(3).normal(size=(gt.num_faces, 24)).astype(
        np.float32)
    want = jax_arch.aggregate_faces_to_cells(jnp.asarray(e), gj, antisym)
    got = arch.aggregate_faces_to_cells(torch.from_numpy(e), gt, antisym)
    assert got.shape == (gt.num_cells, 24)
    assert _rel(got, want) <= PIECE_RTOL


@pytest.mark.parametrize("route", ["index", "tables"])
def test_wide_twice_message_passing_matches_jax_pallas(banded_cylinder, route):
    """The kernel route's aggregation (the plain versions of K3 -> K5, or of
    K6 roll -> K7) on ``[X | X]``, 256 channels, against the JAX package's
    Pallas wrappers in interpret mode on the same route."""
    gj_idx, gj_tab, gt, gtab = banded_cylinder
    gj, g = (gj_idx, gt) if route == "index" else (gj_tab, gtab)
    x = np.random.default_rng(4).normal(size=(g.num_faces, 128)).astype(
        np.float32)
    xx = np.concatenate([x, x], axis=1)
    vtx = pallas_agg.aggregate_edges_to_vertices_pallas(jnp.asarray(xx), gj)
    assert vtx.shape == (gj.num_vertices, 256)
    want = pallas_agg.aggregate_vertices_to_cells_pallas(vtx, gj)
    got = arch.aggregate_twice_mp(torch.from_numpy(xx), g, use_kernels=True)
    assert got.shape == want.shape == (g.num_cells, 128)
    assert got.dtype == torch.float32
    live = g.cell_mask.numpy()
    assert _rel(got, want, live) <= AGG_TOL
    # and the plain route on the f32 latents, for scale
    plain = arch.aggregate_twice_mp(torch.from_numpy(xx), g)
    assert _rel(got, plain.numpy(), live) <= AGG_TOL


@pytest.mark.parametrize("name", VARIANTS)
def test_params_from_flax_maps_the_conservative_tree(name):
    """Every key of the Flax tree at 3 blocks lands on the port's state dict
    and every entry of the state dict is filled: ``_Cons?Block_i`` become
    ``blocks.i``, ``_ConsEncoder_0`` and ``Encoder_0`` become ``encoder``,
    H/J/K's top-level ``faceS_mlp``, ``faceA_mlp`` and ``cell_mlp`` stay at
    the top; an ``AntisymMLP`` has weights and no biases."""
    gj, _ = _golden_graphs()
    jm = jax_model_class(name)(JaxModelConfig(name=name, hidden_width=32,
                                              mp_num=3))
    jm.set_stats(_jax_golden(name)[0].stats)
    tg, feats = jm.transform_features(gj, None, mode="train")
    variables = jm.init(jax.random.PRNGKey(3), tg, feats)
    sd = params_from_flax(variables)
    tm = get_model_class(name)(ModelConfig(hidden_width=32, mp_num=3),
                               device="cpu")
    assert sorted(sd) == sorted(tm.module.state_dict())
    tm.module.load_state_dict(sd)
    block = [k for k in variables["params"] if k.endswith("Block_2")]
    assert len(block) == 1 and block[0].startswith("_Cons")
    mlp = "cell_mlp"
    k = variables["params"][block[0]][mlp]["Dense_1"]["kernel"]
    np.testing.assert_array_equal(
        sd[f"blocks.2.{mlp}.dense1.weight"].numpy(), np.asarray(k).T)
    asym = ("faceA_mlp.dense0" if name in ("ConservativeH", "ConservativeJ",
                                          "ConservativeK")
            else "encoder.faceA_mlp.dense0" if name in (
                "ConservativeA", "ConservativeB", "ConservativeD") else None)
    if asym is not None:
        assert f"{asym}.weight" in sd and f"{asym}.bias" not in sd


# ---- the shipped config ------------------------------------------------------------

@pytest.fixture(scope="module")
def shipped():
    """config/e2e/conservativea.json through the port's loader, the JAX
    model of the same config on ``"segment"`` with seeded weights and the
    cylinder window's statistics."""
    cfg = load_config(str(ROOT / "config/e2e/conservativea.json"))
    geom = rcm_reorder_geometry(make_geometry("cylinder", n_points=300, seed=0))
    fields = channel_flow_trajectory(geom, num_timesteps=2, dt=0.01)
    gj = jax_from_geometry(geom, fields, dt=0.01, pad_multiple=128)
    gt = from_geometry(geom, fields, dt=0.01, pad_multiple=128, device="cpu")
    m = cfg.model
    jm = jax_model_class("ConservativeA")(JaxModelConfig(
        name=m.name, hidden_width=m.hidden_width, mp_num=m.mp_num,
        aggregation="segment", compute_dtype="float32"))
    _, jfeats = jm.transform_rollout(gj)
    acc = jax_norm.StatsAccumulator(jm.nmap)
    acc.update(jfeats, jax_masks(gj, jfeats))
    jm.set_stats(acc.finalize())
    variables = jm.init(jax.random.PRNGKey(0), gj, jfeats)
    return cfg, gj, gt, jm, variables, jfeats, _stats_floats(jm.stats)


def _port_model(cfg, variables, stats, **changes):
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             **changes))
    tm = train_cli.build_model(cfg, "cpu")
    tm.set_stats(stats)
    tm.module.load_state_dict(params_from_flax(variables))
    return tm


def test_shipped_config_builds_on_the_plain_route(shipped):
    """Its ``"banded"`` takes the plain route, and its bf16 reaches no MLP
    of ConservativeA: the outputs of the segment model in f32, exactly."""
    cfg, _, gt, _, variables, _, stats = shipped
    assert (cfg.model.name, cfg.model.hidden_width, cfg.model.mp_num,
            cfg.model.aggregation, cfg.model.compute_dtype) == (
        "ConservativeA", 128, 15, "banded", "bfloat16")
    tm = _port_model(cfg, variables, stats)
    seg = _port_model(cfg, variables, stats, aggregation="segment",
                      compute_dtype="float32")
    _, feats = tm.transform_rollout(gt)
    with torch.no_grad():
        got, want = tm.forward(gt, feats), seg.forward(gt, feats)
    for key in FACE_OUTPUTS:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
        assert torch.isfinite(got[key]).all(), key


def test_shipped_config_matches_jax(shipped):
    cfg, gj, gt, jm, variables, jfeats, stats = shipped
    tm = _port_model(cfg, variables, stats)
    _, feats = tm.transform_rollout(gt)
    jout, _ = jm.forward(variables, gj, jfeats, mode="rollout")
    with torch.no_grad():
        tout = tm.forward(gt, feats)
    cm, fm = gt.cell_mask.numpy(), gt.face_mask.numpy()
    for key in FACE_OUTPUTS:
        assert _rel(tout[key], jout[key], cm if key.startswith("cell")
                    else fm) <= F32_TOL, key
