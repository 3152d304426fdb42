"""The port's training-mode model pieces against the JAX package's: the
losses, the edge flip, the train-mode forward, loss and gradients of FluxD
and FvgnF, the golden one-step losses, the masked BatchNorm in train mode,
dropout and rematerialization.

Models at hidden 32 and ``mp_num`` 2 on ``test_models``' padded structured
mesh (6 x 4, padded to multiples of 32), with the Flax variables carried over
by ``params_from_flax``; a JAX gradient tree has the params' structure, so
the same function maps it onto the port's parameter names (Dense kernels
transposed). The JAX side runs ``aggregation="segment"``: its banded tables
in bf16 or int8 would round or truncate the latents (ROADMAP §3). Noise,
edge flip and dropout are off wherever the two are compared.

Tolerances, each stated where it is used: f32 loss components within 1e-5
relative, except FvgnF's two that pass through its BatchNorm's batch
statistics (5e-5, below); every f32 gradient leaf within 1e-4 of that leaf's
largest magnitude (the same math up to f32 summation order, through two GN
blocks and their backward); bf16 within bf16 steps (2**-8 relative each,
compounded through the blocks).
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.synthetic import (make_geometry,
                                                   taylor_green_trajectory)
from gnn_fluid_dynamics_tpu.graph import batch_graphs as jax_batch_graphs
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.models import losses as jax_losses
from gnn_fluid_dynamics_tpu.models import normalizer as jax_norm
from gnn_fluid_dynamics_tpu.models.arch import \
    MaskedBatchNorm as JaxMaskedBatchNorm
from gnn_fluid_dynamics_tpu.models.transforms import \
    random_edge_flip as jax_random_edge_flip
from test_models import LOSS_WEIGHTS, make_model

from gnn_fluid_dynamics_tpu_torch.graph import batch_graphs, from_geometry
from gnn_fluid_dynamics_tpu_torch.models import losses, normalizer
from gnn_fluid_dynamics_tpu_torch.models.arch import (MLP, MaskedBatchNorm,
                                                      dropout)
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig
from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
from gnn_fluid_dynamics_tpu_torch.models.transforms import (flip_edges,
                                                            random_edge_flip)
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

HIDDEN, MP = 32, 2
GOLDEN = {"FluxD": 3.467191, "FvgnF": 4.107755}   # tests/test_golden.py
F32_LOSS_RTOL, F32_GRAD_TOL = 1e-5, 1e-4
# FvgnF's integrator normalizes the face areas by the batch's variance,
# E[x^2] - mean^2 in f32 on both sides (Flax's fast variance); on this mesh
# var / mean^2 = 0.04, so the f32 summation order's 1e-7 grows 25-fold:
# each side's normalized areas lie ~5e-6 from an f64 evaluation
# (test_face_area_norm_train_mode_against_f64), and the two components
# built on them (continuity, and Δv through the integrator) part by up to
# 1.6e-5
BN_LOSSES, BN_LOSS_RTOL = ("continuity_loss", "cell_velocity_change_loss"), 5e-5
# bf16: each MLP rounds its input, products and activations to bf16 (2**-8
# relative), so the two sides part by a few bf16 steps where an f32 sum was
# taken in another order; the losses are means of many such values. A
# gradient leaf is held relative to the larger of its own largest magnitude
# and 1 % of the largest of all leaves: a leaf that is a sum with
# cancellation (FluxD's velocity_scale_y, 1e-3 from terms a thousand times
# larger) keeps bf16's absolute error, not its relative one
BF16_LOSS_RTOL, BF16_GRAD_TOL = 2e-2, 1e-1
BF16_LEAF_FLOOR = 1e-2


def _graphs(window=3, pad=32):
    """test_models' padded structured mesh with a Taylor-Green window, as
    the JAX package's graph and the port's (on the CPU)."""
    geom = make_geometry("structured", nx=6, ny=4)
    fields = dict(taylor_green_trajectory(geom, num_timesteps=window, dt=0.01))
    gj = jax_from_geometry(geom, fields, dt=0.01, pad_multiple=pad)
    gt = from_geometry(geom, fields, dt=0.01, pad_multiple=pad, device="cpu")
    return gj, gt


def _stats_floats(stats):
    return {k: {s: float(v) for s, v in d.items()} for k, d in stats.items()}


def _models(name, gj, dtype="float32", weights=LOSS_WEIGHTS, key=0, **kw):
    """The JAX model (``test_models.make_model``: statistics from the
    graph), its variables from ``PRNGKey(key)``, and the port's with the
    same statistics and variables."""
    jm = make_model(name, gj, compute_dtype=dtype, **kw)
    jm.loss_weights = weights
    tg, feats = jm.transform_features(gj, None, mode="train")
    variables = jm.init(jax.random.PRNGKey(key), tg, feats)
    tm = get_model_class(name)(
        ModelConfig(name=name, hidden_width=HIDDEN, mp_num=MP,
                    aggregation="segment", compute_dtype=dtype, **kw),
        device="cpu", loss_weights=weights)
    tm.set_stats(_stats_floats(jm.stats))
    tm.module.load_state_dict(params_from_flax(variables))
    return jm, dict(variables), tm


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---- losses ------------------------------------------------------------------

def _loss_inputs(dtype):
    rng = np.random.default_rng(0)
    out = rng.normal(size=(40, 3)).astype(dtype)
    tgt = rng.normal(size=(40, 3)).astype(dtype)
    mask = rng.random(40) < 0.7
    out[~mask] = np.inf                  # padded rows: where-selected away
    return out, tgt, mask


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 0.0),
                                        (np.float32, 1e-6)])
@pytest.mark.parametrize("fn", ["mse_per_element", "mse_per_batch"])
def test_masked_losses_match_jax(fn, dtype, rtol):
    """f64: bit for bit; f32 within 1e-6. Rows of inf outside the mask reach
    neither side."""
    out, tgt, mask = _loss_inputs(dtype)
    with jax.enable_x64(dtype == np.float64):
        want = getattr(jax_losses, fn)(jnp.asarray(out), jnp.asarray(tgt),
                                       jnp.asarray(mask))
        want = np.asarray(want)
    got = getattr(losses, fn)(torch.from_numpy(out), torch.from_numpy(tgt),
                              torch.from_numpy(mask))
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), want, rtol=rtol)


def test_masked_loss_gradient_ignores_padded_rows():
    """The where-select keeps the gradient on padded rows at 0 and finite."""
    out, tgt, mask = _loss_inputs(np.float32)
    x = torch.from_numpy(out).requires_grad_()
    losses.mse_per_element(x, torch.from_numpy(tgt),
                           torch.from_numpy(mask)).backward()
    assert torch.isfinite(x.grad).all()
    assert (x.grad[torch.from_numpy(~mask)] == 0).all()


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 0.0),
                                        (np.float32, 1e-6)])
def test_combined_log_loss_matches_jax(dtype, rtol):
    """A weight of 0 still adds its term; an unweighted component is left
    out. f64 bit for bit (the same sum in the same order), f32 within 1e-6."""
    comps = {"a": 0.3, "b": 1.7, "c": 0.02, "unweighted": 5.0}
    weights = {"a": 10.0, "b": 1.0, "c": 0.0}
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax_losses.combined_log_loss(
            {k: jnp.asarray(v, dtype) for k, v in comps.items()}, weights))
    got = losses.combined_log_loss(
        {k: torch.tensor(v, dtype=torch.float64 if dtype == np.float64
                         else torch.float32) for k, v in comps.items()},
        weights)
    np.testing.assert_allclose(got.item(), want, rtol=rtol)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 0.0),
                                        (np.float32, 1e-6)])
def test_face_pressure_rel_matches_jax(dtype, rtol):
    """FluxA's ``face_pressure_rel`` term: the raw pressure (z-score
    inverted) against its target, per-graph relative MSE averaged over
    ``num_graphs``, on a batch of two padded graphs: f64 bit for bit, f32
    within 1e-6."""
    gj, gt = _graphs()
    gj = jax_batch_graphs([gj, gj])
    gt = batch_graphs([gt, gt])
    rng = np.random.default_rng(1)
    pred = rng.normal(size=(gt.num_faces, 1)).astype(dtype)
    tgt = rng.normal(size=(gt.num_faces, 1)).astype(dtype) + 0.5
    stats = {"mean": 0.3, "std": 1.7}
    with jax.enable_x64(dtype == np.float64):
        p_raw = jax_norm.z_score(jnp.asarray(pred),
                                 {k: jnp.asarray(v, dtype)
                                  for k, v in stats.items()}, inverse=True)
        want = np.asarray(jnp.mean(jax_losses.rel_mse_per_graph(
            p_raw, jnp.asarray(tgt), gj.face_mask, gj.face_batch,
            gj.num_graphs)))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    p_raw = normalizer.z_score(torch.from_numpy(pred),
                               {k: torch.tensor(v, dtype=tdt)
                                for k, v in stats.items()}, inverse=True)
    got = torch.mean(losses.rel_mse_per_graph(
        p_raw, torch.from_numpy(tgt), gt.face_mask, gt.face_batch,
        gt.num_graphs))
    np.testing.assert_allclose(got.item(), want, rtol=rtol)


# ---- edge flip ---------------------------------------------------------------

def test_flip_edges_matches_random_edge_flip():
    """Given the mask ``jax.random.bernoulli`` draws for a key (and the
    graph's face mask), ``flip_edges`` flips exactly the fields
    ``random_edge_flip`` does: owner/neighbour, normal, flux, the cell face
    signs and the owner's slot; and the same safe (non-boundary) mask."""
    gj, gt = _graphs()
    key = jax.random.PRNGKey(5)
    gj2, safe_j = jax_random_edge_flip(key, gj)
    flip = (np.asarray(jax.random.bernoulli(key, 0.5, (gj.num_faces,)))
            & np.asarray(gj.face_mask))
    gt2, safe_t = flip_edges(gt, torch.from_numpy(flip))
    assert flip.sum() > 0 and (flip & ~np.asarray(safe_j)).sum() > 0
    np.testing.assert_array_equal(safe_t.numpy(), np.asarray(safe_j))
    for key_ in ("cell_edge_index", "face_normal", "face_flux",
                 "cell_face_sign", "owner_local_slot"):
        np.testing.assert_array_equal(getattr(gt2, key_).numpy(),
                                      np.asarray(getattr(gj2, key_)),
                                      err_msg=key_)
    # the rest of the graph is untouched
    np.testing.assert_array_equal(gt2.face_index.numpy(), gt.face_index.numpy())


def test_random_edge_flip_draws_live_faces_from_its_generator():
    _, gt = _graphs()
    draws = [random_edge_flip(torch.Generator().manual_seed(3), gt)[0]
             for _ in range(2)]
    torch.testing.assert_close(draws[0].cell_edge_index,
                               draws[1].cell_edge_index, rtol=0, atol=0)
    flipped = (draws[0].cell_edge_index != gt.cell_edge_index).any(0)
    assert flipped.any()
    assert not flipped[~gt.face_mask].any()


# ---- train-mode forward, loss and gradients ----------------------------------

def _train_step_both(name, dtype, weights=LOSS_WEIGHTS):
    """One train-mode forward + loss + backward on each side (no noise, flip
    or dropout): (JAX losses, JAX param grads as a port state dict, JAX
    input grads, JAX batch stats update, port model, port losses, port
    input grads, graphs)."""
    gj, gt = _graphs()
    jm, variables, tm = _models(name, gj, dtype, weights)
    tgj, feats_j = jm.transform_features(gj, None, mode="train")
    bstats = variables.get("batch_stats", {})

    def loss_fn(params, cell_x, face_x):
        f = {**feats_j, "cell_x": cell_x, "face_x": face_x}
        out, upd = jm.forward({"params": params, "batch_stats": bstats}, tgj,
                              f, mode="train")
        ls = jm.loss(out, f, tgj)
        return ls["total_log_loss"], (ls, upd)

    (gp, gcx, gfx), (ls_j, upd) = jax.grad(loss_fn, argnums=(0, 1, 2),
                                           has_aux=True)(
        variables["params"], feats_j["cell_x"], feats_j["face_x"])

    tgt, feats_t = tm.transform_features(gt, None, mode="train")
    cell_x = feats_t["cell_x"].clone().requires_grad_()
    face_x = feats_t["face_x"].clone().requires_grad_()
    f = {**feats_t, "cell_x": cell_x, "face_x": face_x}
    out = tm.forward(tgt, f, mode="train")
    ls_t = tm.loss(out, f, tgt)
    ls_t["total_log_loss"].backward()
    return (ls_j, params_from_flax(gp), (gcx, gfx), upd, tm, ls_t,
            (cell_x.grad, face_x.grad), gt)


CASES = [("FluxD", "float32", F32_LOSS_RTOL, F32_GRAD_TOL),
         ("FvgnF", "float32", F32_LOSS_RTOL, F32_GRAD_TOL),
         ("FluxD", "bfloat16", BF16_LOSS_RTOL, BF16_GRAD_TOL),
         ("FvgnF", "bfloat16", BF16_LOSS_RTOL, BF16_GRAD_TOL)]
FLUXD_WEIGHTS = {**LOSS_WEIGHTS, "face_pressure_rel": 0.5}


@pytest.mark.parametrize("name,dtype,loss_rtol,grad_tol", CASES)
def test_train_step_matches_jax(name, dtype, loss_rtol, grad_tol):
    """Every loss component within ``loss_rtol`` relative; every parameter's
    gradient (f32, whatever the compute dtype) within ``grad_tol`` of its
    leaf's largest magnitude, and finite; the gradients of the input
    features likewise, and 0 on every padded row where JAX's are. FluxD
    also carries the ``face_pressure_rel`` term."""
    weights = FLUXD_WEIGHTS if name == "FluxD" else LOSS_WEIGHTS
    (ls_j, grads_j, in_j, _, tm, ls_t, in_t, gt) = _train_step_both(
        name, dtype, weights)
    assert set(ls_t) == set(ls_j)
    for k in ls_j:
        rtol = (BN_LOSS_RTOL if (name, dtype) == ("FvgnF", "float32")
                and k in BN_LOSSES else loss_rtol)
        assert _rel(ls_t[k].item(), ls_j[k]) <= rtol, (k, ls_t[k], ls_j[k])
    params = dict(tm.module.named_parameters())
    assert set(grads_j) == set(params)
    floor = 0.0
    if dtype == "bfloat16":
        floor = BF16_LEAF_FLOOR * max(float(g.abs().max()) for g in grads_j.values())
    for k, want in grads_j.items():
        got = params[k].grad
        assert got is not None and got.dtype == torch.float32, k
        assert torch.isfinite(got).all(), k
        err = float((got - want).abs().max())
        assert err <= grad_tol * max(float(want.abs().max()), floor), (k, err)
    masks = (gt.cell_mask.numpy(), gt.face_mask.numpy())
    for got, want, mask in zip(in_t, in_j, masks):
        want = np.asarray(want)
        assert torch.isfinite(got).all()
        assert _rel(got, want) <= grad_tol
        zero = (want == 0).all(1) & ~mask
        assert (got.numpy()[zero] == 0).all()


def test_fvgnf_train_batch_norm_matches_jax():
    """FvgnF's train-mode forward normalizes the face areas by the batch's
    statistics over the live faces and moves the running ones as Flax's
    batch_stats update does (within 1e-6 relative)."""
    (_, _, _, upd, tm, _, _, _) = _train_step_both("FvgnF", "float32")
    bn = tm.module.integrator.face_area_norm.masked_batch_norm.batch_norm
    want = upd["batch_stats"]["integrator"]["face_area_norm"][
        "MaskedBatchNorm_0"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want["mean"]),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(want["var"]),
                               rtol=1e-6)


def test_face_area_norm_train_mode_against_f64():
    """FvgnF's BatchNorm'd face areas in train mode (a fresh BatchNorm, so
    the output is (x - mean) / sqrt(var + eps)): the port's and the JAX
    package's each within 1e-5 of an f64 evaluation over the live faces,
    values of order 1; the witness for BN_LOSS_RTOL."""
    from gnn_fluid_dynamics_tpu.models.arch import FaceAreaNorm as JaxFaceAreaNorm
    from gnn_fluid_dynamics_tpu.models.arch import _vol_dt_coeff
    from gnn_fluid_dynamics_tpu_torch.models.arch import FaceAreaNorm
    gj, gt = _graphs()
    mod = JaxFaceAreaNorm()
    y_j, _ = mod.apply(mod.init(jax.random.PRNGKey(0), gj, False), gj, True,
                       mutable=["batch_stats"])
    y_t = FaceAreaNorm()(gt, train=True).detach().numpy()
    x = (np.asarray(gj.face_area, np.float64).reshape(-1, 1)
         * np.asarray(_vol_dt_coeff(gj), np.float64))
    live = np.asarray(gj.face_mask)
    y64 = (x - x[live].mean()) / np.sqrt(x[live].var() + 1e-5)
    for y in (y_t, np.asarray(y_j)):
        assert np.abs(y - y64)[live].max() <= 1e-5


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_one_step_loss(name):
    """With the JAX-initialized weights of ``test_golden.py``
    (``PRNGKey(7)``), the port's train-mode total log loss is the golden
    value (``rtol=1e-4``, as there); the JAX side is held to it too."""
    gj, gt = _graphs()
    jm, variables, tm = _models(name, gj, key=7)
    tgj, fj = jm.transform_features(gj, None, mode="train")
    out_j, _ = jm.forward(variables, tgj, fj, mode="train")
    np.testing.assert_allclose(float(jm.loss(out_j, fj, tgj)["total_log_loss"]),
                               GOLDEN[name], rtol=1e-4)
    tgt, ft = tm.transform_features(gt, None, mode="train")
    with torch.no_grad():
        total = tm.loss(tm.forward(tgt, ft, mode="train"), ft,
                        tgt)["total_log_loss"]
    np.testing.assert_allclose(total.item(), GOLDEN[name], rtol=1e-4)


def test_train_mode_needs_a_generator_for_noise_and_flip():
    """Without a generator train mode adds neither noise nor a flip (as in
    ``test_golden.py``); with one it adds both, reproducibly."""
    _, gt = _graphs()
    tm = get_model_class("FluxD")(ModelConfig(hidden_width=HIDDEN, mp_num=MP),
                                  device="cpu")
    _, f_roll = tm.transform_features(gt)
    g_plain, f_plain = tm.transform_features(gt, None, mode="train",
                                             noise_std=0.1)
    for k in ("cell_x", "face_x", "face_y"):
        torch.testing.assert_close(f_plain[k], f_roll[k], rtol=0, atol=0)
    draws = [tm.transform_features(gt, torch.Generator().manual_seed(1),
                                   mode="train", noise_std=0.1)
             for _ in range(2)]
    torch.testing.assert_close(draws[0][1]["cell_x"], draws[1][1]["cell_x"],
                               rtol=0, atol=0)
    assert not torch.equal(draws[0][1]["cell_x"], f_roll["cell_x"])
    assert not torch.equal(draws[0][0].cell_edge_index, gt.cell_edge_index)


# ---- masked BatchNorm --------------------------------------------------------

def test_masked_batch_norm_train_mode_matches_flax():
    """Padded rows hold 1e6 and must not reach the batch statistics. The
    output (every row, padded ones too), the batch statistics (read back
    from the running update, against numpy f64 over the live rows) and the
    running update match Flax within 1e-6 relative; eval mode as well."""
    rng = np.random.default_rng(2)
    n, live = 96, 70
    x = (rng.normal(size=(n, 1)) * 2.0 + 0.5).astype(np.float32)
    mask = np.arange(n) < live
    x[~mask] = 1e6
    mod = JaxMaskedBatchNorm()
    v = mod.init(jax.random.PRNGKey(0), x, mask, False)
    v = {"params": {"BatchNorm_0": {"scale": np.full((1,), 1.3, np.float32),
                                    "bias": np.full((1,), -0.2, np.float32)}},
         "batch_stats": {"BatchNorm_0": {"mean": np.full((1,), 0.4, np.float32),
                                         "var": np.full((1,), 2.5, np.float32)}}}
    y_j, upd = mod.apply(v, x, mask, True, mutable=["batch_stats"])
    bs_j = upd["batch_stats"]["BatchNorm_0"]

    m = MaskedBatchNorm()
    m.load_state_dict(params_from_flax(v))
    y_t = m(torch.from_numpy(x), torch.from_numpy(mask), train=True)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=1e-6)
    bn = m.batch_norm
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(bs_j["mean"]),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(bs_j["var"]),
                               rtol=1e-6)
    xl = x[mask].astype(np.float64)
    batch_mean = (bn.running_mean.numpy() - 0.9 * 0.4) / 0.1
    batch_var = (bn.running_var.numpy() - 0.9 * 2.5) / 0.1
    np.testing.assert_allclose(batch_mean, xl.mean(), rtol=1e-5)
    np.testing.assert_allclose(batch_var, xl.var(), rtol=1e-5)
    # eval mode: the running statistics on every row, nothing updated
    y_je = mod.apply({"params": v["params"], "batch_stats": upd["batch_stats"]},
                     x, mask, False)
    before = bn.running_mean.clone()
    y_te = m(torch.from_numpy(x), torch.from_numpy(mask), train=False)
    np.testing.assert_allclose(y_te.detach().numpy(), np.asarray(y_je),
                               rtol=1e-6)
    torch.testing.assert_close(bn.running_mean, before, rtol=0, atol=0)


# ---- dropout and remat ---------------------------------------------------------

def test_dropout_keeps_and_scales_as_flax():
    """Kept fraction within 0.01 of 1 - p over 2**17 values (6 standard
    deviations), kept values scaled by 1/(1 - p) exactly, the rest 0; an
    MLP in eval mode (or at p = 0) applies none."""
    p = 0.3
    x = torch.rand(2 ** 17) + 0.5
    y = dropout(x, p, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / (1 - p), rtol=0, atol=0)
    with pytest.raises(ValueError):
        dropout(x, p, None)
    gen = torch.Generator().manual_seed(0)
    mlp = MLP(8, 16, 4, dropout_rate=p, generator=gen)
    plain = MLP(8, 16, 4, generator=torch.Generator().manual_seed(0))
    xs = torch.randn(32, 8)
    torch.testing.assert_close(mlp(xs), plain(xs), rtol=0, atol=0)
    torch.testing.assert_close(plain(xs, train=True), plain(xs), rtol=0, atol=0)
    assert not torch.allclose(mlp(xs, train=True, rng=gen), mlp(xs))


def test_remat_gives_the_same_loss_and_gradients():
    """FluxD with dropout (so the recomputation must redraw the same masks)
    and ``remat``: the same parameter names, the same loss, and gradients
    within 1e-6 of the run without it, from the same generator state."""
    _, gt = _graphs()
    runs = []
    for remat in (False, True):
        tm = get_model_class("FluxD")(
            ModelConfig(hidden_width=HIDDEN, mp_num=MP, aggregation="segment",
                        dropout_rate=0.2, remat=remat),
            device="cpu", seed=3, loss_weights=LOSS_WEIGHTS)
        _, feats = tm.transform_rollout(gt)
        from gnn_fluid_dynamics_tpu_torch.models.base import feature_masks
        acc = normalizer.StatsAccumulator(tm.nmap)
        acc.update(feats, feature_masks(gt, feats))
        tm.set_stats(acc.finalize())
        gen = torch.Generator().manual_seed(4)
        tg, f = tm.transform_features(gt, gen, mode="train", noise_std=0.01)
        total = tm.loss(tm.forward(tg, f, mode="train", generator=gen), f,
                        tg)["total_log_loss"]
        total.backward()
        runs.append((total.item(),
                     {k: p.grad.clone() for k, p in tm.module.named_parameters()},
                     gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert l0 == l1
    assert g0.keys() == g1.keys()
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(s1, s0, rtol=0, atol=0)
