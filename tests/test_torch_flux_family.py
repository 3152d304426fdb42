"""The rest of the port's Flux family (FluxA's own module, FluxB, FluxC) and
the finite-volume pieces it and the VertPot family stand on, against the JAX
package, with the Flax variables carried over by ``params_from_flax``.

* The one-step total log loss of ``tests/test_golden.py`` (the JAX package's
  ``PRNGKey(7)`` weights on ``test_models.build_graph(grad_weights=True)``,
  hidden 32, 2 blocks): within 1e-5 of the golden value and of the JAX
  package's; every loss component within 1e-4 relative of JAX's (1e-12
  absolute for a component at f32 rounding level); and the port's own
  statistics within 1e-6 of JAX's. The train-mode BatchNorm of FluxA's dt/V̄
  reads a constant on that uniform mesh, so its output is the batch mean's
  rounding, 1/sqrt(eps) ~ 316 times over: the one place where the two
  packages' summation orders show. With the JAX package's batch statistics
  put in place of the port's (``jax_batch_statistics``) every total is
  within 1e-6 of JAX's.
* A rollout-mode forward on the RCM-ordered 300-point cylinder mesh (518
  cells, padded to 640), f32 plain route, hidden 32, 2 blocks, every
  BatchNorm moved off its init: each output within 1e-5 of JAX's, as the
  largest difference over live rows relative to the output's largest
  magnitude (the same f32 math up to summation order).
* The fused route on the kernels' plain versions (``aggregation="pallas"``,
  bf16 latents), hidden 128, 2 blocks, against JAX's ``"segment"`` route in
  bf16: within 4e-2, as ``test_torch_fluxd.py`` (each MLP's bf16 roundings
  can fall differently; measured up to 3.0e-2, FluxB's cell velocity
  change).
* ``rollout_scan``: 4 steps against the JAX package's, errors and the final
  state within 1e-4 relative (four free-running steps of the same f32 math).
* Train mode: the loss and the gradients' global norm of FluxA and FluxB
  within 1e-5 and 1e-4 relative of JAX's, with the JAX package's batch
  statistics (see above).
* The pieces: ``calc_flux_from_uf``, ``divergence_from_face_flux``,
  ``cell_flux_to_face_flux`` (owner slot), ``cell_flux_to_face_flux_lastwrite``
  (duplicate destinations, a face no write reaches) and
  ``aggregate_edges_to_vertices_sum``, each against JAX (1e-6 relative, sums
  in another order; the gathers exactly).
* FluxC's feedback clamps the INFLOW/WALL faces' Δv to its ``face_y`` =
  [p, phi], as the JAX package's does.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.models import normalizer as jax_norm
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_masks
from gnn_fluid_dynamics_tpu.ops import fvm as jax_fvm
from gnn_fluid_dynamics_tpu.ops import segment as jax_segment
from gnn_fluid_dynamics_tpu.rollout import engine as jax_engine
from test_golden import GOLDEN
from test_torch_fvgn_family import (_assert_stats_match, _golden_graphs,
                                    _ground_truth, _jax_golden, _moved, _rel,
                                    _rollout_models, _small_models,
                                    _stats_floats, cylinder)  # noqa: F401

from gnn_fluid_dynamics_tpu_torch.models import arch
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig, feature_masks
from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.ops import fvm, segment
from gnn_fluid_dynamics_tpu_torch.rollout import engine
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

VARIANTS = ("FluxA", "FluxB", "FluxC")
GOLDEN_ATOL, COMPONENT_RTOL, COMPONENT_ATOL = 1e-5, 1e-4, 1e-12
JAX_STATS_ATOL = 1e-6
F32_TOL, BF16_TOL, ROLLOUT_RTOL = 1e-5, 4e-2, 1e-4
LOSS_RTOL, GRAD_NORM_RTOL = 1e-5, 1e-4
BF16_HIDDEN, BF16_MP = 128, 2
ROLLOUT_STEPS = 4
PIECE_RTOL = 1e-6


@pytest.fixture
def jax_batch_statistics(monkeypatch):
    """The port's train-mode BatchNorm with the batch mean and variance
    computed as the JAX package computes them (Flax's masked ``jnp.mean`` of
    x and x^2, var = E[x^2] - mean^2 clamped at 0)."""
    def stats(x, mask):
        xa = jnp.asarray(x.detach().numpy())
        m = jnp.asarray(mask.numpy()).reshape(-1, 1)
        mu = jnp.mean(xa, axis=0, where=m)
        var = jnp.maximum(0.0, jnp.mean(xa * xa, axis=0, where=m) - mu * mu)
        return (torch.from_numpy(np.array(mu)),
                torch.from_numpy(np.array(var)))
    monkeypatch.setattr(arch.BatchNorm, "batch_statistics",
                        staticmethod(stats))


def golden_losses(name):
    """(port's losses, JAX's losses) of the golden one-step train-mode
    loss."""
    gj, gt = _golden_graphs()
    jm, variables, tm = _small_models(name)
    tgj, fj = jm.transform_features(gj, None, mode="train")
    ls_j = jm.loss(jm.forward(variables, tgj, fj, mode="train")[0], fj, tgj)
    tgt, ft = tm.transform_features(gt, None, mode="train")
    with torch.no_grad():
        ls_t = tm.loss(tm.forward(tgt, ft, mode="train"), ft, tgt)
    return ls_t, ls_j


def check_golden(name, atol=GOLDEN_ATOL):
    gj, gt = _golden_graphs()
    ls_t, ls_j = golden_losses(name)
    total = ls_t["total_log_loss"].item()
    assert abs(total - GOLDEN[name]) <= atol
    assert abs(total - float(ls_j["total_log_loss"])) <= atol
    assert set(ls_t) == set(ls_j)
    for k in ls_j:
        got, want = ls_t[k].item(), float(ls_j[k])
        assert abs(got - want) <= max(COMPONENT_RTOL * abs(want),
                                      COMPONENT_ATOL), (k, got, want)
    jm, _, tm = _small_models(name)
    acc = StatsAccumulator(tm.nmap)
    _, fr = tm.transform_features(gt)
    acc.update(fr, feature_masks(gt, fr))
    _assert_stats_match(acc.finalize(), jm.stats)


def check_golden_with_jax_statistics(name):
    ls_t, ls_j = golden_losses(name)
    total = ls_t["total_log_loss"].item()
    assert abs(total - float(ls_j["total_log_loss"])) <= JAX_STATS_ATOL
    assert abs(total - GOLDEN[name]) <= JAX_STATS_ATOL + 1e-6   # 6 decimals


def check_rollout_forward(cylinder, name, outputs):
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
    for key in outputs:
        assert tout[key].shape == jout[key].shape, key
        assert _rel(tout[key], jout[key], cm if key.startswith("cell")
                    else fm) <= F32_TOL, key
    return tout


def bf16_models(cylinder, name):
    """The JAX model on its ``"segment"`` route in bf16 (its own seeded
    weights at BF16_HIDDEN, statistics of the cylinder window) and the
    port's with the same weights on the fused route."""
    _, _, gj, gt = cylinder
    cfg = dict(name=name, hidden_width=BF16_HIDDEN, mp_num=BF16_MP,
               compute_dtype="bfloat16")
    jm = jax_model_class(name)(JaxModelConfig(aggregation="segment", **cfg))
    _, jfeats = jm.transform_features(gj, None, "rollout")
    acc = jax_norm.StatsAccumulator(jm.nmap)
    acc.update(jfeats, jax_masks(gj, jfeats))
    jm.set_stats(acc.finalize())
    variables = _moved(dict(jm.init(jax.random.PRNGKey(0), gj, jfeats)))
    tm = get_model_class(name)(ModelConfig(aggregation="pallas", **cfg),
                               device="cpu")
    tm.set_stats(_stats_floats(jm.stats))
    tm.module.load_state_dict(params_from_flax(variables))
    _, tfeats = tm.transform_rollout(gt)
    return jm, variables, jfeats, tm, tfeats


def check_bf16_fused_route(cylinder, name, outputs):
    _, _, gj, gt = cylinder
    jm, variables, jfeats, tm, tfeats = bf16_models(cylinder, name)
    assert arch.block_route(tm.arch, gt, torch.zeros(1)) == "fused"
    jout, _ = jm.forward(variables, gj, jfeats, mode="rollout")
    with torch.no_grad():
        tout = tm.forward(gt, tfeats)
    cm, fm = gt.cell_mask.numpy(), gt.face_mask.numpy()
    for key in outputs:
        assert _rel(tout[key].float(), jout[key], cm if key.startswith("cell")
                    else fm) <= BF16_TOL, key


def check_rollout_scan(cylinder, name):
    _, _, gj, gt = cylinder
    gv, gp = _ground_truth(cylinder, ROLLOUT_STEPS)
    jm, variables, jfeats, tm, tfeats = _rollout_models(cylinder, name)
    jerr, jfields = jax_engine.rollout_scan(
        jm, variables, gj, jfeats, jnp.asarray(gv), jnp.asarray(gp),
        jax_engine.RolloutConfig(num_steps=ROLLOUT_STEPS))
    terr, tfields = engine.rollout_scan(
        tm, gt, tfeats, torch.from_numpy(gv), torch.from_numpy(gp),
        engine.RolloutConfig(num_steps=ROLLOUT_STEPS))
    assert set(terr) == set(jerr)
    for k, want in jerr.items():
        assert terr[k].shape == (ROLLOUT_STEPS, 1), k
        np.testing.assert_allclose(terr[k].numpy(), np.asarray(want),
                                   rtol=ROLLOUT_RTOL, atol=1e-12, err_msg=k)
    assert _rel(tfields["final_cell_state"], jfields["final_cell_state"],
                gt.cell_mask.numpy()) <= ROLLOUT_RTOL
    return terr


def check_train_mode(name):
    """The train-mode loss and its gradients' global norm."""
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
                                  for p in tm.module.parameters()
                                  if p.grad is not None)))
    assert _rel(loss_t.item(), float(loss_j)) <= LOSS_RTOL
    assert _rel(norm_t, norm_j) <= GRAD_NORM_RTOL


# ---- the models ----------------------------------------------------------------

@pytest.mark.parametrize("name", VARIANTS)
def test_golden_one_step_loss(name):
    check_golden(name)


@pytest.mark.parametrize("name", VARIANTS)
def test_golden_with_the_jax_batch_statistics(name, jax_batch_statistics):
    check_golden_with_jax_statistics(name)


@pytest.mark.parametrize("name,outputs", [
    ("FluxA", ("cell_velocity_change", "face_velocity", "face_pressure",
               "face_flux", "cell_flux")),
    ("FluxB", ("cell_velocity_change", "face_velocity", "face_pressure",
               "face_flux")),
    ("FluxC", ("cell_velocity_change", "face_pressure", "face_flux"))])
def test_rollout_forward_matches_jax(cylinder, name, outputs):
    check_rollout_forward(cylinder, name, outputs)


@pytest.mark.parametrize("name,outputs", [
    ("FluxA", ("cell_velocity_change", "face_velocity", "face_pressure",
               "face_flux")),
    ("FluxB", ("cell_velocity_change", "face_velocity", "face_pressure",
               "face_flux")),
    ("FluxC", ("cell_velocity_change", "face_pressure", "face_flux"))])
def test_fused_route_matches_jax_segment_in_bf16(cylinder, name, outputs):
    check_bf16_fused_route(cylinder, name, outputs)


@pytest.mark.parametrize("name", VARIANTS)
def test_rollout_scan_matches_jax(cylinder, name):
    check_rollout_scan(cylinder, name)


@pytest.mark.parametrize("name", ["FluxA", "FluxB"])
def test_train_mode_loss_and_gradient_norm(name, jax_batch_statistics):
    check_train_mode(name)


def test_fluxa_module_and_its_state_dict():
    """FluxA builds (its module was missing before): the flux integrator's
    two BatchNorms sit under ``integrator``, and the Flax tree maps onto
    the state dict with no key left over on either side."""
    _, variables = _jax_golden("FluxA")
    tm = get_model_class("FluxA")(ModelConfig(hidden_width=32, mp_num=2),
                                  device="cpu")
    sd = params_from_flax(variables)
    assert sorted(sd) == sorted(tm.module.state_dict())
    for bn in ("vol_dt_norm", "face_area_norm"):
        assert (f"integrator.{bn}.masked_batch_norm.batch_norm.running_var"
                in sd)


def test_fluxc_feedback_clamps_to_pressure_and_flux(cylinder):
    """FluxC's inherited feedback puts ``face_y[:, 0:2]`` = [p_f, phi_f] at
    t0 on the INFLOW/WALL faces' Δv, in both packages."""
    _, _, gj, gt = cylinder
    jm, variables, jfeats, tm, tfeats = _rollout_models(cylinder, "FluxC")
    jout, _ = jm.forward(variables, gj, jfeats, mode="rollout")
    jsol = jm.derive_state(jout, jfeats, gj)
    with torch.no_grad():
        tsol = tm.derive_state(tm.forward(gt, tfeats), tfeats, gt)
    want = jm.update_features(jsol, jfeats, gj)["face_x"]
    got = tm.update_features(tsol, tfeats, gt)["face_x"]
    fm = gt.face_mask.numpy()
    assert _rel(got, want, fm) <= F32_TOL
    from gnn_fluid_dynamics_tpu_torch.models.transforms import rollout_bc_mask
    clamped = (rollout_bc_mask(gt.face_type) & gt.face_mask).numpy()
    assert clamped.any()
    np.testing.assert_array_equal(
        got[clamped, :2].numpy(),
        torch.cat([gt.face_pressure[:, -1], gt.face_flux[:, -1]],
                  dim=1)[clamped].numpy())


# ---- the pieces ----------------------------------------------------------------

def _random(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_calc_flux_from_uf_matches_jax(cylinder):
    _, _, gj, gt = cylinder
    uv = _random((gt.num_faces, 2), 1)
    area = np.abs(_random((gt.num_faces, 1), 2))
    want = jax_fvm.calc_flux_from_uf(jnp.asarray(uv), gj.face_normal,
                                     jnp.asarray(area))
    got = fvm.calc_flux_from_uf(torch.from_numpy(uv), gt.face_normal,
                                torch.from_numpy(area))
    assert got.shape == (gt.num_faces, 1)
    assert _rel(got, want) <= PIECE_RTOL


def test_divergence_from_face_flux_matches_jax(cylinder):
    _, _, gj, gt = cylinder
    ff = _random((gt.num_faces, 1), 3)
    want = jax_fvm.divergence_from_face_flux(jnp.asarray(ff), gj.face_index)
    got = fvm.divergence_from_face_flux(torch.from_numpy(ff), gt.face_index)
    assert got.shape == (gt.num_cells, 1)
    assert _rel(got, want) <= PIECE_RTOL


def test_cell_flux_to_face_flux_matches_jax(cylinder):
    """The owner-slot conversion: each face its owner's value, exactly."""
    _, _, gj, gt = cylinder
    cf = _random((gt.num_cells, 3), 4)
    want = jax_fvm.cell_flux_to_face_flux(jnp.asarray(cf), gj.cell_edge_index,
                                          gj.owner_local_slot)
    got = fvm.cell_flux_to_face_flux(torch.from_numpy(cf), gt.cell_edge_index,
                                     gt.owner_local_slot)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lastwrite_loop(cf, cell_edge_index, face_index):
    """The reference's conversion as written: sequential assignment, so the
    last write in k wins; a face no write reaches keeps write 0's value
    (the JAX package's clip)."""
    C = cf.shape[0]
    out = {}
    for k in range(3 * C):
        dest = int(face_index[k // C, k % C])
        sign = 1.0 if int(cell_edge_index[0][dest]) == k // 3 else -1.0
        out[dest] = sign * cf[k // 3, k % 3]
    first = cf[0, 0] * (1.0 if int(cell_edge_index[0][int(face_index[0, 0])])
                        == 0 else -1.0)
    return np.float32([[out.get(f, first)] for f in
                       range(cell_edge_index.shape[1])])


def test_lastwrite_conversion_on_duplicates_and_an_unwritten_face():
    """Three cells, six faces: faces 1 and 2 are written several times
    (by writes of both orientations), face 5 never."""
    cell_edge_index = np.int32([[0, 0, 1, 1, 2, 2], [1, 2, 2, 0, 0, 1]])
    face_index = np.int32([[0, 1, 2], [1, 2, 3], [2, 4, 1]])
    cf = _random((3, 3), 5)
    want = jax_fvm.cell_flux_to_face_flux_lastwrite(
        jnp.asarray(cf), jnp.asarray(cell_edge_index), jnp.asarray(face_index))
    got = fvm.cell_flux_to_face_flux_lastwrite(
        torch.from_numpy(cf), torch.from_numpy(cell_edge_index),
        torch.from_numpy(face_index))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), _lastwrite_loop(cf, cell_edge_index, face_index))
    dests = face_index[np.arange(9) // 3, np.arange(9) % 3]
    assert np.bincount(dests, minlength=6)[5] == 0
    assert (np.bincount(dests)[[1, 2]] > 1).all()


def test_lastwrite_conversion_matches_jax_on_a_mesh(cylinder):
    _, _, gj, gt = cylinder
    cf = _random((gt.num_cells, 3), 6)
    want = jax_fvm.cell_flux_to_face_flux_lastwrite(
        jnp.asarray(cf), gj.cell_edge_index, gj.face_index)
    got = fvm.cell_flux_to_face_flux_lastwrite(
        torch.from_numpy(cf), gt.cell_edge_index, gt.face_index)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_edge_sum_onto_both_vertices_matches_jax(cylinder):
    _, _, gj, gt = cylinder
    e = _random((gt.num_faces, 16), 7)
    want = jax_segment.aggregate_edges_to_vertices_sum(jnp.asarray(e), gj)
    got = segment.aggregate_edges_to_vertices_sum(torch.from_numpy(e), gt)
    assert got.shape == (gt.num_vertices, 16)
    assert _rel(got, want) <= PIECE_RTOL
