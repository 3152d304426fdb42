"""The rest of the port's FVGN family (FvgnB, C, D, E, H, I, J, K) against the
JAX package's, with the Flax variables carried over by ``params_from_flax``.

* The one-step total log loss of ``tests/test_golden.py`` (the JAX package's
  ``PRNGKey(7)`` weights on ``test_models.build_graph(grad_weights=True)``,
  hidden 32, 2 blocks): within 1e-5 of the golden value and of the JAX
  package's, every loss component within 1e-4 relative of JAX's (FvgnC's
  continuity term reads the train-mode BatchNorm of area * dt / V, whose
  f32 batch variance E[x^2] - mean^2 cancels: measured 1.6e-5), and the
  port's own statistics within 1e-6 of JAX's (FvgnC's first-step
  ``slice0`` statistics and FvgnE's norm, sqrt and derived pressure
  statistics among them).
* A rollout-mode forward on the RCM-ordered 300-point cylinder mesh (518
  cells, padded to 640), f32 plain route, hidden 32, 2 blocks, with every
  BatchNorm, learned bias and FvgnK's anisotropy ratio moved off its init:
  each output within 1e-5 of JAX's, as the largest difference over live
  rows relative to the output's largest magnitude (the same f32 math up to
  summation order).
* The pieces: ``calc_gradient_tensor`` (and its pairing, on a linear
  field), the five normalization schemes, the ``norm``/``sqrt``/``slice0``
  extractors, FvgnK's ``u_ref`` on a batch of two graphs one of which has
  no INFLOW face.
* Temporal bundling: FvgnC's rollout (k = 2, 6 forwards) against the JAX
  package's ``rollout_scan``, its errors and saved fields interleaved on one
  time axis (1e-4 relative: six free-running forwards of the same f32
  math); the rollout entry point writing it; and ``rollout_scan`` with
  k = 1 giving FluxD, FvgnF and MgnA the errors and fields of the loop it
  had before bundling, bit for bit.
* Train mode: the loss and the gradients' global norm of FvgnC, FvgnJ and
  FvgnK against JAX (1e-5 and 1e-4 relative, as ``test_torch_mgn.py``).
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.synthetic import (channel_flow_trajectory,
                                                   make_geometry)
from gnn_fluid_dynamics_tpu.graph import batch_graphs as jax_batch_graphs
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.models import normalizer as jax_norm
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_masks
from gnn_fluid_dynamics_tpu.ops import fvm as jax_fvm
from gnn_fluid_dynamics_tpu.ops import mls as jax_mls
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry
from gnn_fluid_dynamics_tpu.rollout import engine as jax_engine
from test_golden import GOLDEN
from test_models import LOSS_WEIGHTS, make_model

from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
from gnn_fluid_dynamics_tpu_torch.data.pipeline import MeshDataset, Trajectory
from gnn_fluid_dynamics_tpu_torch.graph import batch_graphs, from_geometry
from gnn_fluid_dynamics_tpu_torch.models import normalizer as norm
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig, feature_masks
from gnn_fluid_dynamics_tpu_torch.models.losses import (mse_per_graph,
                                                        rel_mse_per_graph)
from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.ops import fvm, mls
from gnn_fluid_dynamics_tpu_torch.rollout import engine
from gnn_fluid_dynamics_tpu_torch.rollout import run as rollout_cli
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

VARIANTS = ("FvgnB", "FvgnC", "FvgnD", "FvgnE", "FvgnH", "FvgnI", "FvgnJ",
            "FvgnK")
HIDDEN, MP, BUNDLE = 32, 2, 2
GOLDEN_ATOL, LOSS_RTOL, GRAD_NORM_RTOL = 1e-5, 1e-5, 1e-4
COMPONENT_RTOL = 1e-4
F32_TOL, ROLLOUT_RTOL = 1e-5, 1e-4
FORWARDS = 6                     # FvgnC's bundled rollout
OUTPUTS = ("cell_velocity_change", "face_velocity", "face_pressure")


def _cfg(name):
    return {"bundle_size": BUNDLE} if name == "FvgnC" else {}


def _stats_floats(stats):
    return {k: {s: float(v) for s, v in d.items()} for k, d in stats.items()}


def _rel(got, want, mask=None):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    if mask is not None:
        got, want = got[mask], want[mask]
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _with_mls(geom, fields):
    out = dict(fields)
    for loc in ("cell", "face"):
        nb, w = jax_mls.compute_mls_weights(geom[f"{loc}_pos"], 1)
        out[f"{loc}_grad_weights"] = w
        out[f"{loc}_grad_neighbours"] = nb
    return out


def _assert_stats_match(stats, jax_stats):
    assert set(stats) == set(jax_stats)
    for key, st in stats.items():
        for s, v in st.items():
            np.testing.assert_allclose(v, float(jax_stats[key][s]), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{key}/{s}")


# ---- the golden one-step losses ------------------------------------------------

@functools.lru_cache(maxsize=None)
def _golden_graphs():
    """``test_models.build_graph(grad_weights=True)``, for both packages."""
    from gnn_fluid_dynamics_tpu.data.synthetic import taylor_green_trajectory
    geom = make_geometry("structured", nx=6, ny=4)
    fields = _with_mls(geom, taylor_green_trajectory(geom, num_timesteps=3,
                                                     dt=0.01))
    return (jax_from_geometry(geom, fields, dt=0.01, pad_multiple=32),
            from_geometry(geom, fields, dt=0.01, pad_multiple=32,
                          device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_golden(name):
    """The JAX model of ``test_golden.py`` and its ``PRNGKey(7)`` variables
    (one init per variant: the rollout tests reuse the weights, which do
    not depend on the graph)."""
    gj, _ = _golden_graphs()
    jm = make_model(name, gj, **_cfg(name))
    tg, feats = jm.transform_features(gj, None, mode="train")
    return jm, jm.init(jax.random.PRNGKey(7), tg, feats)


def _small_models(name):
    jm, variables = _jax_golden(name)
    tm = get_model_class(name)(
        ModelConfig(name=name, hidden_width=HIDDEN, mp_num=MP,
                    aggregation="segment", **_cfg(name)),
        device="cpu", loss_weights=LOSS_WEIGHTS)
    tm.set_stats(_stats_floats(jm.stats))
    tm.module.load_state_dict(params_from_flax(variables))
    return jm, variables, tm


@pytest.mark.parametrize("name", VARIANTS)
def test_golden_one_step_loss(name):
    gj, gt = _golden_graphs()
    jm, variables, tm = _small_models(name)
    tgj, fj = jm.transform_features(gj, None, mode="train")
    ls_j = jm.loss(jm.forward(variables, tgj, fj, mode="train")[0], fj, tgj)
    tgt, ft = tm.transform_features(gt, None, mode="train")
    with torch.no_grad():
        ls_t = tm.loss(tm.forward(tgt, ft, mode="train"), ft, tgt)
    total = ls_t["total_log_loss"].item()
    assert abs(total - GOLDEN[name]) <= GOLDEN_ATOL
    assert abs(total - float(ls_j["total_log_loss"])) <= GOLDEN_ATOL
    assert set(ls_t) == set(ls_j)
    for k in ls_j:
        assert _rel(ls_t[k].item(), ls_j[k]) <= COMPONENT_RTOL, k
    acc = StatsAccumulator(tm.nmap)
    _, fr = tm.transform_features(gt)
    acc.update(fr, feature_masks(gt, fr))
    _assert_stats_match(acc.finalize(), jm.stats)


@pytest.mark.parametrize("name", ["FvgnC", "FvgnJ", "FvgnK"])
def test_train_mode_loss_and_gradient_norm(name):
    """The train-mode loss and its gradients' global norm (the BatchNorm's
    batch statistics, FvgnJ's learned biases and FvgnK's anisotropy ratio
    among the parameters)."""
    gj, gt = _golden_graphs()
    jm, variables, tm = _small_models(name)
    tgj, fj = jm.transform_features(gj, None, mode="train")

    def loss_fn(params):
        out, _ = jm.forward({**variables, "params": params}, tgj, fj,
                            mode="train")
        return jm.loss(out, fj, tgj)["total_log_loss"]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    norm_j = float(jnp.sqrt(sum(jnp.sum(g ** 2)
                                for g in jax.tree.leaves(grads_j))))
    tgt, ft = tm.transform_features(gt, None, mode="train")
    tm.module.train()
    loss_t = tm.loss(tm.forward(tgt, ft, mode="train"), ft,
                     tgt)["total_log_loss"]
    loss_t.backward()
    norm_t = float(torch.sqrt(sum((p.grad ** 2).sum()
                                  for p in tm.module.parameters())))
    assert _rel(loss_t.item(), float(loss_j)) <= LOSS_RTOL
    assert _rel(norm_t, norm_j) <= GRAD_NORM_RTOL


# ---- a rollout-mode forward on the cylinder mesh -------------------------------

@pytest.fixture(scope="module")
def cylinder():
    geom = rcm_reorder_geometry(make_geometry("cylinder", n_points=300, seed=0))
    fields = channel_flow_trajectory(geom, num_timesteps=FORWARDS * BUNDLE + 2,
                                     dt=0.01)
    window = _with_mls(geom, {k: v[:BUNDLE + 1] for k, v in fields.items()})
    kw = dict(dt=0.01, pad_multiple=128, reynolds=200.0)
    return (geom, fields, jax_from_geometry(geom, window, **kw),
            from_geometry(geom, window, device="cpu", **kw))


def _moved(tree, path=()):
    """Flax variables with every BatchNorm, learned bias and the anisotropy
    ratio moved off their init, so that their mapping counts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _moved(dict(v), path + (k,))
            continue
        v = np.asarray(v)
        if "BatchNorm_0" in path:
            v = np.full_like(v, {"scale": 1.3, "bias": -0.2, "mean": 0.4,
                                 "var": 2.5}[k])
        elif k == "bias" and path and path[-1].endswith("_scale"):
            v = v + 0.05
        elif k == "anisotropy_ratio":
            v = np.full_like(v, 0.3)
        out[k] = v
    return out


def _rollout_models(cylinder, name):
    _, _, gj, gt = cylinder
    cfg = dict(name=name, hidden_width=HIDDEN, mp_num=MP,
               aggregation="segment", **_cfg(name))
    jm = jax_model_class(name)(JaxModelConfig(**cfg))
    _, jfeats = jm.transform_features(gj, None, "rollout")
    acc = jax_norm.StatsAccumulator(jm.nmap)
    acc.update(jfeats, jax_masks(gj, jfeats))
    jm.set_stats(acc.finalize())
    variables = _moved(dict(_jax_golden(name)[1]))
    tm = get_model_class(name)(ModelConfig(**cfg), device="cpu")
    _, tfeats = tm.transform_rollout(gt)
    acc = StatsAccumulator(tm.nmap)
    acc.update(tfeats, feature_masks(gt, tfeats))
    tm.set_stats(acc.finalize())
    _assert_stats_match(_stats_floats(tm.stats), jm.stats)
    tm.module.load_state_dict(params_from_flax(variables))
    return jm, variables, jfeats, tm, tfeats


@pytest.mark.parametrize("name", VARIANTS)
def test_rollout_forward_matches_jax(cylinder, name):
    _, _, gj, gt = cylinder
    jm, variables, jfeats, tm, tfeats = _rollout_models(cylinder, name)
    assert set(tfeats) == set(jfeats)
    for key in tfeats:
        np.testing.assert_allclose(tfeats[key].numpy(), np.asarray(jfeats[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    jout, _ = jm.forward(variables, gj, jfeats, mode="rollout")
    with torch.no_grad():
        tout = tm.forward(gt, tfeats)
    assert set(tout) == set(jout)
    cm, fm = gt.cell_mask.numpy(), gt.face_mask.numpy()
    for key in OUTPUTS:
        assert tout[key].shape == jout[key].shape, key
        assert _rel(tout[key], jout[key], cm if key.startswith("cell")
                    else fm) <= F32_TOL, key


def test_fvgnh_angle_is_zero_on_boundary_self_loops(cylinder):
    """FvgnH's seven face columns: the adjacent distance is 0 on a boundary
    face (owner == neighbour), and there the angle is 0, not arccos of the
    normal against a zero vector."""
    _, _, _, gt = cylinder
    tm = get_model_class("FvgnH")(ModelConfig(hidden_width=8, mp_num=1),
                                  device="cpu")
    _, feats = tm.transform_rollout(gt)
    fx = feats["face_x"]
    assert fx.shape[1] == 7 + tm.config.num_face_types
    self_loop = gt.face_boundary_mask & gt.face_mask
    assert self_loop.any() and (~self_loop & gt.face_mask).any()
    assert not fx[self_loop][:, 5:7].any()
    interior = ~self_loop & gt.face_mask
    assert (fx[interior][:, 5] > 0).all()
    assert ((fx[interior][:, 6] >= 0) & (fx[interior][:, 6] <= np.pi / 2)).all()


# ---- the pieces ---------------------------------------------------------------

def test_calc_gradient_tensor_matches_jax():
    geom = make_geometry("structured", nx=9, ny=5, jitter=0.2, seed=3)
    nb, w = mls.compute_mls_weights(geom["face_pos"], 1)
    v = np.random.default_rng(4).normal(size=(nb.shape[0], 2)).astype(np.float32)
    want = jax_fvm.calc_gradient_tensor(jnp.asarray(v), jnp.asarray(w),
                                        jnp.asarray(nb))
    got = fvm.calc_gradient_tensor(torch.from_numpy(v), torch.from_numpy(w),
                                   torch.from_numpy(nb))
    assert got.shape == (nb.shape[0], 4)
    # sums of six f32 products (weights up to 7) in another order: the
    # largest difference relative to the largest entry
    assert _rel(got, want) <= 1e-6


def test_calc_gradient_tensor_keeps_the_reference_pairing():
    """On the linear field (a x + b y, c x + d y) the MLS weights are exact,
    and the tensor reads [g_xx, g_xy, g_yx, g_yy] = [a, d, c, b]: the
    reference's pairing, not the gradient's [a, b, c, d]."""
    geom = make_geometry("structured", nx=9, ny=5, jitter=0.2, seed=3)
    pos = geom["face_pos"]
    nb, w = mls.compute_mls_weights(pos, 1)
    a, b, c, d = 2.0, -3.0, 0.5, 1.5
    v = np.stack([a * pos[:, 0] + b * pos[:, 1],
                  c * pos[:, 0] + d * pos[:, 1]], axis=1).astype(np.float32)
    got = fvm.calc_gradient_tensor(torch.from_numpy(v), torch.from_numpy(w),
                                   torch.from_numpy(nb)).numpy()
    np.testing.assert_allclose(got, np.broadcast_to([a, d, c, b], got.shape),
                               atol=2e-5)


@pytest.mark.parametrize("scheme", sorted(jax_norm.SCHEMES))
def test_scheme_matches_jax(scheme):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    st = {"mean": 0.3, "std": 1.7, "min": -2.1, "max": 2.9}
    for inverse in (False, True):
        want = jax_norm.SCHEMES[scheme](
            jnp.asarray(x), {k: jnp.float32(v) for k, v in st.items()},
            inverse)
        got = norm.SCHEMES[scheme](
            torch.from_numpy(x), {k: torch.tensor(v) for k, v in st.items()},
            inverse)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7, err_msg=str(inverse))


@pytest.mark.parametrize("extractor", [
    ("norm", "cell_x", 0, 2), ("sqrt", "cell_volume", 0, 1),
    ("slice0", "face_y", 1, 3), ("face_y", 0, 2)])
def test_extractor_matches_jax(extractor):
    """Each extractor's masked statistics over two updates, against the
    JAX package's accumulator (a bundled (F, k, 3) ``face_y`` for
    ``slice0`` and the plain slice, which then spans every step)."""
    rng = np.random.default_rng(6)
    batches = [{"cell_x": rng.normal(size=(40, 2)),
                "cell_volume": rng.random((40, 1)),
                "face_y": rng.normal(size=(60, BUNDLE, 3))} for _ in range(2)]
    masks = [{"cell_x": rng.random(40) < 0.8, "cell_volume": rng.random(40) < 0.8,
              "face_y": rng.random(60) < 0.8} for _ in range(2)]
    out = []
    for mod, to in ((jax_norm, jnp.asarray), (norm, torch.from_numpy)):
        nmap = mod.NormalizationMap({"s": mod.StatSpec("z_score", extractor)},
                                    (), ())
        acc = mod.StatsAccumulator(nmap)
        for b, m in zip(batches, masks):
            acc.update({k: to(v.astype(np.float32)) for k, v in b.items()},
                       {k: to(v) for k, v in m.items()})
        out.append(acc.finalize())
    (want,), (got,) = out[0].values(), out[1].values()
    for s in want:
        np.testing.assert_allclose(got[s], float(want[s]), rtol=1e-6,
                                   atol=1e-12, err_msg=s)


def test_fvgne_derives_the_characteristic_pressure():
    """FvgnE's ``characteristic_pressure`` has no extractor: it is derived
    from the largest velocity magnitude, v_max^2 / 2."""
    _, gt = _golden_graphs()
    tm = get_model_class("FvgnE")(ModelConfig(hidden_width=8, mp_num=1),
                                  device="cpu")
    assert tm.nmap.registry["characteristic_pressure"].extractor is None
    _, feats = tm.transform_rollout(gt)
    acc = StatsAccumulator(tm.nmap)
    acc.update(feats, feature_masks(gt, feats))
    stats = acc.finalize()
    v = torch.linalg.vector_norm(feats["cell_x"][gt.cell_mask], dim=1)
    v_max = float(v.double().max())
    assert stats["characteristic_velocity"]["max"] == pytest.approx(v_max,
                                                                    rel=1e-12)
    assert stats["characteristic_pressure"] == pytest.approx(
        {"mean": v_max ** 2 / 4, "std": v_max ** 2 / 8, "min": 0.0,
         "max": v_max ** 2 / 2}, rel=1e-12)


def test_fvgnk_u_ref_on_a_batch_without_inflow():
    """u_ref is each graph's first live INFLOW face's target u, and 1 for a
    graph with no INFLOW face; l_ref = Re * 1e-3 / u_ref; both as the JAX
    package computes them, per face."""
    from gnn_fluid_dynamics_tpu.data.synthetic import taylor_green_trajectory
    pairs = []
    for seed, re, inflow in ((0, 100.0, True), (1, 250.0, False)):
        geom = make_geometry("structured", nx=6, ny=4, jitter=0.1, seed=seed)
        if not inflow:
            ft = geom["face_type"].copy()
            ft[ft == NodeType.INFLOW] = NodeType.OUTFLOW
            geom = {**geom, "face_type": ft}
        fields = taylor_green_trajectory(geom, num_timesteps=2, dt=0.01)
        fields["face_velocity"] = fields["face_velocity"] + 0.5
        kw = dict(dt=0.01, pad_multiple=32, reynolds=re)
        pairs.append((jax_from_geometry(geom, fields, **kw),
                      from_geometry(geom, fields, device="cpu", **kw)))
    gj = jax_batch_graphs([p[0] for p in pairs])
    gt = batch_graphs([p[1] for p in pairs])
    jm = jax_model_class("FvgnK")(JaxModelConfig(hidden_width=8, mp_num=1))
    tm = get_model_class("FvgnK")(ModelConfig(hidden_width=8, mp_num=1),
                                  device="cpu")
    _, jfeats = jm.transform_features(gj, None, "rollout")
    _, tfeats = tm.transform_rollout(gt)
    want = jm._refs(gj, jfeats)
    got = tm._refs(gt, tfeats)
    for g, w in zip(got, want):
        assert g.shape == (gt.num_faces, 1)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    u_ref, l_ref = got
    second = gt.face_batch == 1
    assert (u_ref[second] == 1.0).all()
    np.testing.assert_allclose(l_ref[second].numpy(), 250.0 * 1e-3, rtol=1e-7)
    first_inflow = int(torch.nonzero(
        (gt.face_type.reshape(-1) == NodeType.INFLOW) & gt.face_mask)[0])
    assert (u_ref[~second] == tfeats["face_y"][first_inflow, 0]).all()


# ---- temporal bundling in the rollout -------------------------------------------

def _ground_truth(cylinder, steps):
    geom, fields, _, gt = cylinder
    pad = ((0, 0), (0, gt.num_cells - geom["cell_pos"].shape[0]), (0, 0))
    return (np.pad(fields["cell_velocity"][1:steps + 1], pad),
            np.pad(fields["cell_pressure"][1:steps + 1], pad))


def test_fvgnc_bundled_rollout_matches_jax(cylinder):
    """k = 2, 6 forwards: 12 errors a metric, the two bundled steps of each
    forward in turn, against the JAX package's scan; the saved fields
    likewise on one time axis, and the final state."""
    _, _, gj, gt = cylinder
    steps = FORWARDS * BUNDLE
    gv, gp = _ground_truth(cylinder, steps)
    jm, variables, jfeats, tm, tfeats = _rollout_models(cylinder, "FvgnC")
    jerr, jfields = jax_engine.rollout_scan(
        jm, variables, gj, jfeats, jnp.asarray(gv), jnp.asarray(gp),
        jax_engine.RolloutConfig(num_steps=steps + 1, save_fields=True))
    calls = []
    forward = tm.forward
    tm.forward = lambda *a, **kw: calls.append(1) or forward(*a, **kw)
    terr, tfields = engine.rollout_scan(
        tm, gt, tfeats, torch.from_numpy(gv), torch.from_numpy(gp),
        engine.RolloutConfig(num_steps=steps + 1, save_fields=True))
    assert len(calls) == FORWARDS
    assert set(terr) == set(jerr)
    for k, want in jerr.items():
        assert terr[k].shape == (steps, 1), k
        assert float(np.abs(want).min()) > 0, k
        np.testing.assert_allclose(terr[k].numpy(), np.asarray(want),
                                   rtol=ROLLOUT_RTOL, err_msg=k)
    assert set(tfields) == set(jfields)
    cm, fm = gt.cell_mask.numpy(), gt.face_mask.numpy()
    for k, want in jfields.items():
        assert tfields[k].shape == want.shape, k
        mask = cm if k.startswith("cell") or k == "final_cell_state" else fm
        for t in range(want.shape[0] if want.ndim == 3 else 1):
            g = tfields[k][t] if want.ndim == 3 else tfields[k]
            w = want[t] if want.ndim == 3 else want
            assert _rel(g, w, mask) <= ROLLOUT_RTOL, (k, t)


def test_fvgnc_bundled_errors_use_each_sub_step_and_its_targets(cylinder):
    """Row 2 i + k of the errors is bundled step k of forward i against
    ground-truth row 2 i + k, its divergence clamped to that step's INFLOW
    targets."""
    _, _, _, gt = cylinder
    gv, gp = _ground_truth(cylinder, BUNDLE)
    _, _, _, tm, feats = _rollout_models(cylinder, "FvgnC")
    terr, _ = engine.rollout_scan(tm, gt, feats, torch.from_numpy(gv),
                                  torch.from_numpy(gp),
                                  engine.RolloutConfig(num_steps=BUNDLE))
    with torch.no_grad():
        sols = engine.derive_states(tm, tm.forward(gt, feats), feats, gt)
    assert len(sols) == BUNDLE
    for k, sol in enumerate(sols):
        want_v = rel_mse_per_graph(sol["cell_velocity"],
                                   torch.from_numpy(gv[k]), gt.cell_mask,
                                   gt.cell_batch, 1)
        div = engine._divergence_metric(sol, feats, gt, k)
        want_d = mse_per_graph(div, torch.zeros_like(div), gt.cell_mask,
                               gt.cell_batch, 1)
        torch.testing.assert_close(terr["velocity_error"][k], want_v,
                                   rtol=0, atol=0)
        torch.testing.assert_close(terr["divergence_error"][k], want_d,
                                   rtol=0, atol=0)
    assert not torch.equal(terr["velocity_error"][0],
                           terr["velocity_error"][1])


def _loop_before_bundling(model, graph, feats, gv, gp, steps):
    """``rollout_scan``'s loop as it was before temporal bundling."""
    ys = {}
    with torch.inference_mode():
        for i in range(steps):
            sol = model.derive_state(model.forward(graph, feats), feats, graph)
            ys.setdefault("velocity_error", []).append(rel_mse_per_graph(
                sol["cell_velocity"], gv[i], graph.cell_mask, graph.cell_batch,
                graph.num_graphs))
            ys.setdefault("pressure_error", []).append(rel_mse_per_graph(
                sol["cell_pressure"], gp[i], graph.cell_mask, graph.cell_batch,
                graph.num_graphs))
            div = engine._divergence_metric(sol, feats, graph)
            ys.setdefault("divergence_error", []).append(mse_per_graph(
                div, torch.zeros_like(div), graph.cell_mask, graph.cell_batch,
                graph.num_graphs))
            for key in engine.SAVABLE_FIELDS:
                if key in sol:
                    ys.setdefault(key, []).append(sol[key])
            feats = model.update_features(sol, feats, graph)
    out = {k: torch.stack(v) for k, v in ys.items()}
    out["final_cell_state"] = feats["cell_x"]
    return out


@pytest.mark.parametrize("name", ["FluxD", "FvgnF", "MgnA"])
def test_bundle_of_one_leaves_the_rollout_bit_for_bit(cylinder, name):
    _, _, _, gt = cylinder
    steps = 3
    gv, gp = (torch.from_numpy(a) for a in _ground_truth(cylinder, steps))
    tm = get_model_class(name)(ModelConfig(hidden_width=16, mp_num=2,
                                           bundle_size=1), device="cpu")
    _, feats = tm.transform_rollout(gt)
    acc = StatsAccumulator(tm.nmap)
    acc.update(feats, feature_masks(gt, feats))
    tm.set_stats(acc.finalize())
    errors, fields = engine.rollout_scan(
        tm, gt, feats, gv, gp, engine.RolloutConfig(num_steps=steps,
                                                    save_fields=True))
    want = _loop_before_bundling(tm, gt, feats, gv, gp, steps)
    got = {**errors, **fields}
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_rollout_entry_point_writes_a_bundled_rollout(tmp_path):
    """``rollout_dataset`` on a dataset of rollout stride k: 7 ground-truth
    steps give 3 forwards, 6 predicted steps in ``errors.json`` and in
    ``data0.h5``, their timesteps those of the ground-truth rows."""
    import h5py
    from gnn_fluid_dynamics_tpu_torch.data.synthetic import \
        make_geometry as make_geometry_t
    from gnn_fluid_dynamics_tpu_torch.data.synthetic import \
        taylor_green_trajectory
    geom = make_geometry_t("structured", nx=6, ny=4, jitter=0.1, seed=0)
    fields = taylor_green_trajectory(geom, num_timesteps=16, dt=0.01)
    ds = MeshDataset([Trajectory(mesh_id="m0", geom=geom, fields=fields)],
                     stride=BUNDLE, data_window=BUNDLE + 1,
                     timestep_range=(0, 15), device="cpu")
    tm = get_model_class("FvgnC")(ModelConfig(hidden_width=8, mp_num=1,
                                              bundle_size=BUNDLE),
                                  device="cpu")
    _, feats = tm.transform_rollout(ds.get_item(0))
    acc = StatsAccumulator(tm.nmap)
    acc.update(feats, feature_masks(ds.get_item(0), feats))
    tm.set_stats(acc.finalize())
    res = rollout_cli.rollout_dataset(tm, ds, str(tmp_path), save_full=True)
    assert res["num_steps"] == 7
    assert res["errors"]["velocity_error"].shape == (6, 1)
    with h5py.File(tmp_path / "data0.h5") as f:
        np.testing.assert_array_equal(f["m0/timesteps"][()],
                                      [2, 4, 6, 8, 10, 12])
        cells = geom["cell_pos"].shape[0]
        assert f["m0/cell/velocity"].shape == (6, cells, 2)
        np.testing.assert_array_equal(
            f["m0/cell/velocity"][()],
            res["fields"]["cell_velocity"][:, :cells].numpy())


@pytest.mark.parametrize("name,keys", [
    ("FvgnC", ("face_area_norm.masked_batch_norm.batch_norm.running_var",
               "epd.decoder_face.dense2.weight")),
    ("FvgnJ", ("velocity_scale.scale", "velocity_scale.bias",
               "pressure_scale.bias", "diffusion_scale.bias")),
    ("FvgnK", ("anisotropy_ratio",)),
    ("FvgnB", ("epd.decoder_face.dense2.bias",))])
def test_state_dict_of_the_new_parameter_trees(name, keys):
    """``params_from_flax`` maps every leaf of the variant's Flax variables
    onto the module's state dict and nothing else: FvgnC's top-level
    BatchNorm and its 10-channel decoder, FvgnJ's learned scales and
    biases, FvgnK's scalar anisotropy ratio, FvgnB's 3-channel decoder."""
    _, variables, tm = _small_models(name)
    sd = params_from_flax(variables)
    own = tm.module.state_dict()
    assert sorted(sd) == sorted(own)
    for key in keys:
        assert sd[key].shape == own[key].shape, key
    out = {"FvgnC": 5 * BUNDLE, "FvgnB": 3}.get(name)
    if out:
        assert own["epd.decoder_face.dense2.bias"].shape == (out,)
    if name == "FvgnK":
        assert sd["anisotropy_ratio"].shape == ()
        assert sd["anisotropy_ratio"].item() == pytest.approx(1e-4)
    if name == "FvgnJ":
        np.testing.assert_allclose(sd["velocity_scale.scale"].numpy(),
                                   [1.0, 0.01])
