"""The port's MGN family and MLS stencil against the JAX package's.

* ``ops/mls.py``: ``compute_mls_weights`` bit for bit at orders 1 and 2 on a
  jittered mesh (the same float64 numpy, and a kNN taken in row chunks that
  give each row the same distances); ``divergence_from_uc`` within 1e-6.
* The weights on the graph: padded, batched and added to a dataset as the
  JAX package does, exactly.
* MgnA, MgnB, MgnC: the golden one-step losses of ``tests/test_golden.py``
  (rtol 1e-4, as there) with the JAX package's ``PRNGKey(7)`` weights; the
  train-mode loss and gradient norm of MgnA with the same noise and flip
  mask (1e-5 and 1e-4 relative: f32, the same math up to summation order).
* MgnA's rollout forward on an RCM-ordered 300-point cylinder mesh (518
  cells, padded to 640) at hidden 128 and 2 face-first GN blocks, with the
  Flax weights carried over by ``params_from_flax``. Tolerances, as the
  largest difference over the live rows of an output relative to its
  largest magnitude: 1e-5 in f32 on the plain route (measured 1.1e-6); 4e-2
  on any route with bf16 latents, as ``test_torch_fluxd.py`` states it
  (each MLP's bf16 roundings, 2**-8 relative, can fall differently, and
  the encoder, two blocks and the decoder compound them; measured up to
  2.3e-2). The fused route (K1 dual -> K3 -> K2 single; the JAX package's
  Pallas kernels in interpret mode) is also held one GN block at a time,
  on the same bf16 inputs and live rows: within one bf16 rounding step
  taken on the other side of a boundary (2**-7 relative and absolute, the
  kernel tolerance of ``chip_smoke.py``), but for at most 1e-4 of the
  elements, which stay within two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.pipeline import MeshDataset as JaxDataset
from gnn_fluid_dynamics_tpu.data.pipeline import Trajectory as JaxTrajectory
from gnn_fluid_dynamics_tpu.data.synthetic import (channel_flow_trajectory,
                                                   make_geometry,
                                                   taylor_green_trajectory)
from gnn_fluid_dynamics_tpu.graph import batch_graphs as jax_batch_graphs
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.graph import to_static_bands as jax_to_static_bands
from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.models.arch import ArchConfig as JaxArchConfig
from gnn_fluid_dynamics_tpu.models.arch import GNBlock as JaxGNBlock
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_masks
from gnn_fluid_dynamics_tpu.models.normalizer import \
    StatsAccumulator as JaxStatsAccumulator
from gnn_fluid_dynamics_tpu.ops import fvm as jax_fvm
from gnn_fluid_dynamics_tpu.ops import mls as jax_mls
from gnn_fluid_dynamics_tpu.ops.geometry import knn as jax_knn
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry
from gnn_fluid_dynamics_tpu.rollout import engine as jax_engine
from test_models import LOSS_WEIGHTS, make_model

from gnn_fluid_dynamics_tpu_torch.data.pipeline import MeshDataset, Trajectory
from gnn_fluid_dynamics_tpu_torch.graph import (batch_graphs, from_geometry,
                                                to_static_bands)
from gnn_fluid_dynamics_tpu_torch.models.arch import ArchConfig, GNBlock
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig, feature_masks
from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
from gnn_fluid_dynamics_tpu_torch.models.registry import (MODEL_REGISTRY,
                                                          get_model_class)
from gnn_fluid_dynamics_tpu_torch.models.transforms import flip_edges
from gnn_fluid_dynamics_tpu_torch.ops import fvm, geometry, kernels, mls
from gnn_fluid_dynamics_tpu_torch.rollout import engine
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

GOLDEN = {"MgnA": 2.639695, "MgnB": 2.461878, "MgnC": 2.099358}
HIDDEN, MP, STEPS = 128, 2, 3
F32_TOL, BF16_TOL = 1e-5, 4e-2
BLOCK_RTOL = BLOCK_ATOL = 2.0 ** -7
BLOCK_BEYOND = 1e-4
LOSS_RTOL, GRAD_NORM_RTOL = 1e-5, 1e-4
OUTPUTS = ("cell_velocity_change", "cell_pressure")


def _stats_floats(stats):
    return {k: {s: float(v) for s, v in d.items()} for k, d in stats.items()}


def _rel(got, want, mask=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if mask is not None:
        got, want = got[mask], want[mask]
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _with_mls(geom, fields, locs=("cell",)):
    out = dict(fields)
    for loc in locs:
        nb, w = jax_mls.compute_mls_weights(geom[f"{loc}_pos"], 1)
        out[f"{loc}_grad_weights"] = w
        out[f"{loc}_grad_neighbours"] = nb
    return out


# ---- MLS --------------------------------------------------------------------

@pytest.mark.parametrize("loc", ["cell", "face"])
@pytest.mark.parametrize("order", [1, 2])
def test_mls_weights_bit_identical(order, loc):
    geom = make_geometry("structured", nx=9, ny=5, jitter=0.2, seed=3)
    pos = geom[f"{loc}_pos"]
    nb_j, w_j = jax_mls.compute_mls_weights(pos, order)
    nb_t, w_t = mls.compute_mls_weights(pos, order)
    assert w_t.dtype == np.float32 and w_t.shape == w_j.shape
    np.testing.assert_array_equal(nb_t, nb_j)
    np.testing.assert_array_equal(w_t, w_j)


def test_knn_in_row_chunks_equals_the_dense_search(monkeypatch):
    """Chunks of 7 rows, with a mask: the same neighbours and distances."""
    monkeypatch.setattr(geometry, "KNN_ROWS_PER_CHUNK", 7)
    pos = np.random.default_rng(2).random((60, 2))
    mask = np.random.default_rng(3).random(60) < 0.8
    for m in (None, mask):
        i_j, d_j = jax_knn(pos, 6, mask=m)
        i_t, d_t = geometry.knn(pos, 6, mask=m)
        np.testing.assert_array_equal(i_t, i_j)
        np.testing.assert_array_equal(d_t, d_j)


def test_mls_weights_reproduce_linear_gradients():
    """The contract of the stencil: the exact gradient of a linear field
    (to 1e-5, float32 weights)."""
    geom = make_geometry("structured", nx=9, ny=5, jitter=0.2, seed=3)
    pos = geom["cell_pos"]
    nb, w = mls.compute_mls_weights(pos, 1)
    f = 2.0 * pos[:, 0] - 3.0 * pos[:, 1]
    grad = np.einsum("nkd,nk->nd", w, f[nb] - f[:, None])
    np.testing.assert_allclose(grad, np.broadcast_to([2.0, -3.0], grad.shape),
                               atol=1e-5)


def test_divergence_from_uc_matches_jax():
    geom = make_geometry("structured", nx=9, ny=5, jitter=0.2, seed=3)
    nb, w = mls.compute_mls_weights(geom["cell_pos"], 1)
    u = np.random.default_rng(4).normal(size=(nb.shape[0], 2)).astype(np.float32)
    vol = np.asarray(geom["cell_volume"], np.float32).reshape(-1, 1)
    want = jax_fvm.divergence_from_uc(jnp.asarray(u), jnp.asarray(w),
                                      jnp.asarray(nb), jnp.asarray(vol))
    got = fvm.divergence_from_uc(torch.from_numpy(u), torch.from_numpy(w),
                                 torch.from_numpy(nb), torch.from_numpy(vol))
    assert got.shape == (nb.shape[0], 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ---- the weights on graphs and datasets --------------------------------------

GRAD_KEYS = ("cell_grad_weights", "cell_grad_neighbours", "face_grad_weights",
             "face_grad_neighbours")


def _mesh(seed, nx=6):
    geom = make_geometry("structured", nx=nx, ny=4, jitter=0.1, seed=seed)
    fields = taylor_green_trajectory(geom, num_timesteps=3, dt=0.01)
    return geom, _with_mls(geom, fields, ("cell", "face"))


def test_graph_grad_weights_pad_and_batch_as_jax():
    """Padded rows take zero weights and the last padded row as their
    neighbours; a batch offsets each graph's neighbours by its rows."""
    graphs_j, graphs_t = [], []
    for seed in (0, 1):
        geom, fields = _mesh(seed)
        graphs_j.append(jax_from_geometry(geom, fields, pad_multiple=32))
        graphs_t.append(from_geometry(geom, fields, pad_multiple=32,
                                      device="cpu"))
    for gj, gt in ((graphs_j[0], graphs_t[0]),
                   (jax_batch_graphs(graphs_j), batch_graphs(graphs_t))):
        for key in GRAD_KEYS:
            got, want = getattr(gt, key), np.asarray(getattr(gj, key))
            assert got.dtype == (torch.int32 if "neighbours" in key
                                 else torch.float32), key
            np.testing.assert_array_equal(got.numpy(), want, err_msg=key)
    assert graphs_t[0].cell_grad_neighbours[-1].eq(
        graphs_t[0].num_cells - 1).all()


def test_dataset_add_grad_weights_matches_jax():
    trajs = [_mesh(seed, nx=6 + seed) for seed in (0, 1)]

    def dataset(cls, traj_cls, **kw):
        ds = cls([traj_cls(mesh_id=f"m{i}", geom=g,
                           fields={k: v for k, v in f.items()
                                   if "grad" not in k})
                  for i, (g, f) in enumerate(trajs)], pad_multiple=32, **kw)
        ds.add_grad_weights("cell", 1)
        ds.add_grad_weights("face", 2)
        return ds

    dj = dataset(JaxDataset, JaxTrajectory)
    dt = dataset(MeshDataset, Trajectory, device="cpu")
    for tj, tt in zip(dj.trajectories, dt.trajectories):
        assert set(tt.grad_weights) == set(GRAD_KEYS)
        for key in GRAD_KEYS:
            np.testing.assert_array_equal(tt.grad_weights[key],
                                          tj.grad_weights[key])
    samples = [("m0", 0), ("m1", 0)]
    gj, gt = dj.get_batch(samples), dt.get_batch(samples)
    for key in GRAD_KEYS:
        np.testing.assert_array_equal(getattr(gt, key).numpy(),
                                      np.asarray(getattr(gj, key)))


# ---- the models: goldens and train mode --------------------------------------

def test_registry_holds_the_mgn_family():
    assert {"MgnA", "MgnB", "MgnC"} <= set(MODEL_REGISTRY)
    assert len(MODEL_REGISTRY) == 7
    for name in GOLDEN:
        cls = get_model_class(name)
        assert cls.cell_grad_weights_use and not cls.face_grad_weights_use


def _golden_graphs():
    """``test_models.build_graph(grad_weights=True)``, for both packages."""
    geom = make_geometry("structured", nx=6, ny=4)
    fields = _with_mls(geom, taylor_green_trajectory(geom, num_timesteps=3,
                                                     dt=0.01),
                       ("cell", "face"))
    return (jax_from_geometry(geom, fields, dt=0.01, pad_multiple=32),
            from_geometry(geom, fields, dt=0.01, pad_multiple=32,
                          device="cpu"))


def _small_models(name, gj, key=7):
    jm = make_model(name, gj)
    tg, feats = jm.transform_features(gj, None, mode="train")
    variables = jm.init(jax.random.PRNGKey(key), tg, feats)
    tm = get_model_class(name)(
        ModelConfig(name=name, hidden_width=32, mp_num=2,
                    aggregation="segment"),
        device="cpu", loss_weights=LOSS_WEIGHTS)
    tm.set_stats(_stats_floats(jm.stats))
    tm.module.load_state_dict(params_from_flax(variables))
    return jm, variables, tm


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_one_step_loss(name):
    """``test_golden.py``'s value from the JAX package's ``PRNGKey(7)``
    weights, every loss component within 1e-5 of JAX's, and the port's
    statistics (MgnC's mean velocity magnitude included) equal to JAX's
    to 1e-6."""
    gj, gt = _golden_graphs()
    jm, variables, tm = _small_models(name, gj)
    tgj, fj = jm.transform_features(gj, None, mode="train")
    out_j, _ = jm.forward(variables, tgj, fj, mode="train")
    ls_j = jm.loss(out_j, fj, tgj)
    tgt, ft = tm.transform_features(gt, None, mode="train")
    with torch.no_grad():
        ls_t = tm.loss(tm.forward(tgt, ft, mode="train"), ft, tgt)
    np.testing.assert_allclose(ls_t["total_log_loss"].item(), GOLDEN[name],
                               rtol=1e-4)
    assert set(ls_t) == set(ls_j)
    for k in ls_j:
        assert _rel(ls_t[k].item(), ls_j[k]) <= LOSS_RTOL, k
    acc = StatsAccumulator(tm.nmap)
    _, fr = tm.transform_features(gt)
    acc.update(fr, feature_masks(gt, fr))
    stats = acc.finalize()
    assert set(stats) == set(jm.stats)
    for key, st in stats.items():
        for s, v in st.items():
            np.testing.assert_allclose(v, float(jm.stats[key][s]), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{key}/{s}")


def test_mgna_train_mode_with_noise_and_flip_matches_jax():
    """The JAX package's draw (noise on the t0 velocity, then the flip mask
    of its second key) given to the port as the noised velocity and the
    flip mask: the same loss and the same gradients' global norm."""
    gj, gt = _golden_graphs()
    jm, variables, tm = _small_models("MgnA", gj, key=0)
    key = jax.random.PRNGKey(11)
    tgj, fj = jm.transform_features(gj, key, mode="train", noise_std=0.05)
    _, k_flip = jax.random.split(key)
    flip = (np.asarray(jax.random.bernoulli(k_flip, 0.5, (gj.num_faces,)))
            & np.asarray(gj.face_mask))
    assert flip.any()

    def loss_fn(params):
        out, _ = jm.forward({"params": params}, tgj, fj, mode="train")
        return jm.loss(out, fj, tgj)["total_log_loss"]

    loss_j, grads_j = jax.value_and_grad(loss_fn)(variables["params"])
    norm_j = float(jnp.sqrt(sum(jnp.sum(g ** 2)
                                for g in jax.tree.leaves(grads_j))))

    tgt, _ = flip_edges(gt, torch.from_numpy(flip))
    noised = torch.from_numpy(np.array(fj["cell_x"]))
    assert not torch.equal(noised, gt.cell_velocity[:, 0])
    ft = tm.features(tgt, noised)
    for k in ("cell_x", "cell_y", "face_x", "face_y"):
        np.testing.assert_allclose(ft[k].numpy(), np.asarray(fj[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    tm.module.train()
    loss_t = tm.loss(tm.forward(tgt, ft, mode="train"), ft,
                     tgt)["total_log_loss"]
    loss_t.backward()
    norm_t = float(torch.sqrt(sum((p.grad ** 2).sum()
                                  for p in tm.module.parameters())))
    assert _rel(loss_t.item(), float(loss_j)) <= LOSS_RTOL
    assert _rel(norm_t, norm_j) <= GRAD_NORM_RTOL


def test_mgnb_continuity_loss_reads_the_mls_divergence():
    """MgnB's continuity term is the mean square of the MLS divergence of
    its normalized velocity output over live cells."""
    gj, gt = _golden_graphs()
    _, _, tm = _small_models("MgnB", gj)
    tgt, ft = tm.transform_features(gt, None, mode="train")
    with torch.no_grad():
        out = tm.forward(tgt, ft, mode="train")
        ls = tm.loss(out, ft, tgt)
    div = fvm.divergence_from_uc(out["cell_velocity"], gt.cell_grad_weights,
                                 gt.cell_grad_neighbours, gt.cell_volume)
    want = (div[gt.cell_mask] ** 2).mean()
    torch.testing.assert_close(ls["continuity_loss"], want, rtol=1e-6,
                               atol=0)


# ---- MgnA's rollout on the three routes --------------------------------------

@pytest.fixture(scope="module")
def cylinder():
    geom = rcm_reorder_geometry(make_geometry("cylinder", n_points=300, seed=0))
    fields = channel_flow_trajectory(geom, num_timesteps=STEPS + 2, dt=0.01)
    window = _with_mls(geom, {k: v[:2] for k, v in fields.items()})
    return geom, fields, window


def _route_graphs(cylinder, route):
    """(JAX graph, port graph) on ``route``: "plain" (no tables), "fused"
    (tables, index vectors: the fused blocks) or "table" (bf16 tables, no
    index vectors: the dense-table kernels)."""
    geom, _, window = cylinder
    kw = dict(dt=0.01, pad_multiple=128)
    if route == "plain":
        return (jax_from_geometry(geom, window, **kw),
                from_geometry(geom, window, device="cpu", **kw))
    gj = jax_from_geometry(geom, window, with_banded=True,
                           banded_dtype=jnp.bfloat16, **kw)
    gt = from_geometry(geom, window, with_banded=True, banded_dtype="bfloat16",
                       device="cpu", **kw)
    if route == "fused":
        return jax_to_static_bands(gj), to_static_bands(gt)
    return gj, gt


def _mgna_models(gj, aggregation, dtype):
    cfg = dict(name="MgnA", hidden_width=HIDDEN, mp_num=MP,
               aggregation=aggregation, compute_dtype=dtype)
    jm = jax_model_class("MgnA")(JaxModelConfig(**cfg))
    _, jfeats = jm.transform_features(gj, None, "rollout")
    acc = JaxStatsAccumulator(jm.nmap)
    acc.update(jfeats, jax_masks(gj, jfeats))
    jm.set_stats(acc.finalize())
    variables = jm.init(jax.random.PRNGKey(0), gj, jfeats)
    tm = get_model_class("MgnA")(ModelConfig(**cfg), device="cpu")
    tm.set_stats(_stats_floats(jm.stats))
    tm.module.load_state_dict(params_from_flax(variables))
    return jm, variables, jfeats, tm


ROUTES = [("plain", "segment", "float32", F32_TOL),
          ("plain", "segment", "bfloat16", BF16_TOL),
          ("fused", "pallas", "float32", BF16_TOL),
          ("fused", "pallas", "bfloat16", BF16_TOL),
          ("table", "pallas", "bfloat16", BF16_TOL)]


@pytest.mark.parametrize("route,aggregation,dtype,tol", ROUTES)
def test_mgna_rollout_forward_matches_jax(cylinder, route, aggregation, dtype,
                                          tol):
    gj, gt = _route_graphs(cylinder, route)
    jm, variables, jfeats, tm = _mgna_models(gj, aggregation, dtype)
    _, tfeats = tm.transform_features(gt)
    for key in ("cell_x", "cell_y", "face_x", "face_y"):
        np.testing.assert_allclose(tfeats[key].numpy(), np.asarray(jfeats[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    jout, _ = jm.forward(variables, gj, jfeats, mode="rollout")
    with torch.no_grad():
        tout = tm.forward(gt, tfeats)
    cm = gt.cell_mask.numpy()
    for key in OUTPUTS:
        assert _rel(tout[key], jout[key], cm) <= tol, key


class _Calls:
    """Records the kernel wrappers the GN blocks call, in order, with
    ``dual_out`` (the plain versions run on the CPU)."""

    NAMES = ("fused_face_block", "fused_cell_block", "edges_to_vertices",
             "gather_face_cells", "vertices_to_cells", "table_dual",
             "table_single")

    def __init__(self, monkeypatch):
        self.log = []
        for name in self.NAMES:
            fn = getattr(kernels, name)
            monkeypatch.setattr(kernels, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def call(*args, **kw):
            form = (":dual" if kw.get("dual_out") else
                    ":roll" if kw.get("combine_roll") else "")
            self.log.append(name + form)
            return fn(*args, **kw)
        return call


@pytest.mark.parametrize("route,per_block", [
    ("fused", ["fused_face_block:dual", "edges_to_vertices",
               "fused_cell_block"]),
    ("table", ["table_dual", "table_dual:roll", "table_single"])])
def test_mgna_kernel_route_order(cylinder, monkeypatch, route, per_block):
    """Face-first on the kernel route: fused, K1 with both outputs, then K3
    on K1's raw output, then K2 with the residual only; on the table route
    K6 on the cf tables, then K6 on es/er with the roll, then K7."""
    _, gt = _route_graphs(cylinder, route)
    tm = get_model_class("MgnA")(ModelConfig(
        hidden_width=HIDDEN, mp_num=MP, aggregation="pallas",
        compute_dtype="bfloat16"), device="cpu")
    _, feats = tm.transform_features(gt)
    acc = StatsAccumulator(tm.nmap)
    acc.update(feats, feature_masks(gt, feats))
    tm.set_stats(acc.finalize())
    calls = _Calls(monkeypatch)
    with torch.no_grad():
        tm.forward(gt, feats)
    assert calls.log == per_block * MP


def test_face_first_fused_block_matches_jax_pallas(cylinder):
    """One face-first GN block on the fused route, on the same bf16
    latents, against the JAX package's fused Pallas block (interpret mode),
    on live rows: both outputs within one bf16 step (BLOCK_RTOL,
    BLOCK_ATOL) but for at most BLOCK_BEYOND of their elements, and those
    within twice that tolerance. A row of small variance, whose LayerNorm
    amplifies a hidden activation rounded the other way, may go past one
    step (measured: 1 cell element of 66,304, none of the faces')."""
    gj, gt = _route_graphs(cylinder, "fused")
    rng = np.random.default_rng(5)
    c = rng.normal(size=(gt.num_cells, HIDDEN)).astype(np.float32)
    e = rng.normal(size=(gt.num_faces, HIDDEN)).astype(np.float32)
    c, e = (torch.from_numpy(x).to(torch.bfloat16) for x in (c, e))
    cj, ej = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
              for x in (c, e))
    cfg_j = JaxArchConfig(hidden=HIDDEN, mp_num=1, aggregation="pallas",
                          block_order="face_first",
                          compute_dtype="bfloat16")
    block_j = JaxGNBlock(cfg_j)
    variables = block_j.init(jax.random.PRNGKey(1), cj, ej, gj)
    want = block_j.apply(variables, cj, ej, gj)
    block_t = GNBlock(ArchConfig(hidden=HIDDEN, mp_num=1, aggregation="pallas",
                                 block_order="face_first",
                                 compute_dtype="bfloat16"))
    state = params_from_flax(variables)
    block_t.load_state_dict(state)
    with torch.no_grad():
        got = block_t(c, e, gt, route="fused")
    for g, w, live in zip(got, want, (gt.cell_mask, gt.face_mask)):
        assert g.dtype == torch.bfloat16
        a = g.float().numpy()[live.numpy()]
        b = np.asarray(w.astype(jnp.float32))[live]
        beyond = ~np.isclose(a, b, rtol=BLOCK_RTOL, atol=BLOCK_ATOL)
        assert beyond.mean() <= BLOCK_BEYOND, beyond.sum()
        assert (np.abs(a - b) <= 2 * (BLOCK_ATOL + BLOCK_RTOL * np.abs(b))).all()


def test_mgna_rollout_errors_match_jax(cylinder):
    """A 3-step f32 rollout on the plain route: the velocity, pressure and
    MLS divergence errors per step within 1e-4 relative of the JAX
    package's (three free-running steps of the same f32 math)."""
    geom, fields, _ = cylinder
    gj, gt = _route_graphs(cylinder, "plain")
    jm, variables, jfeats, tm = _mgna_models(gj, "segment", "float32")
    _, tfeats = tm.transform_features(gt)
    pad = ((0, 0), (0, gt.num_cells - geom["cell_pos"].shape[0]), (0, 0))
    gv = np.pad(fields["cell_velocity"][1:STEPS + 1], pad)
    gp = np.pad(fields["cell_pressure"][1:STEPS + 1], pad)
    err_j, _ = jax_engine.rollout_scan(
        jm, variables, gj, jfeats, jnp.asarray(gv), jnp.asarray(gp),
        jax_engine.RolloutConfig(num_steps=STEPS))
    err_t, _ = engine.rollout_scan(
        tm, gt, tfeats, torch.from_numpy(gv), torch.from_numpy(gp),
        engine.RolloutConfig(num_steps=STEPS))
    assert set(err_t) == {"velocity_error", "pressure_error",
                          "divergence_error"}
    for k, want in err_j.items():
        assert float(np.abs(want).min()) > 0, k
        np.testing.assert_allclose(err_t[k].numpy(), np.asarray(want),
                                   rtol=1e-4, err_msg=k)


def test_divergence_metric_without_weights_is_zero(cylinder):
    """A graph without MLS weights gives MGN's rollout a zero divergence, as
    the JAX package's fall-through does."""
    geom, _, window = cylinder
    gt = from_geometry(geom, {k: v for k, v in window.items()
                              if "grad" not in k}, pad_multiple=128,
                       device="cpu")
    sol = {"cell_velocity": torch.ones(gt.num_cells, 2)}
    div = engine._divergence_metric(sol, {}, gt)
    assert div.shape == (gt.num_cells, 1) and not div.any()
