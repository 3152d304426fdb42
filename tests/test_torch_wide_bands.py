"""K6 and K7 take tables of any band width, as the TPU kernels do.

A batch padded well past a mesh's own size gives that mesh's tables bands
of thousands of rows: its padded entries all point at the last slot, so
the tile of its last live rows spans the padding. The trainer's validation
batch of meshes of different sizes runs on such tables.

* The plain versions (what the CPU runs, and what ``chip_smoke.py`` holds
  the kernels against on the card) against ``banded_dual_pallas`` and
  ``banded_single_pallas`` in interpret mode on int8 tables with a band of
  2,048 rows: K6's pair and roll forms (the roll at 128 and 256 lanes) and
  K7 at 64 and 128 lanes, exactly: the sources are small integers, whose
  sums bf16 holds exactly.
* The wrappers, given tensors off the CPU (``meta``), pass bands past
  1,792 rows (and past 896 for K7's 128-lane form) to the kernel with no
  check of their width.
* A space rank whose local band passes 1,792 rows gets its tables, and
  their plain versions sum as the whole graph's tables do, exactly.
* ``validate`` against the JAX package's ``Trainer.validate`` on two
  meshes of 1,200 and 300 points, the smaller one's es band past 1,792 at
  the batch's pad, with ``tests/test_torch_validate.py``'s setup and its
  tolerance (4e-2 relative: bf16 latents through the kernels on either
  side).
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.pipeline import MeshDataset as JaxDataset
from gnn_fluid_dynamics_tpu.data.pipeline import Trajectory as JaxTrajectory
from gnn_fluid_dynamics_tpu.data.synthetic import (channel_flow_trajectory,
                                                   make_geometry)
from gnn_fluid_dynamics_tpu.models import get_model_class
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.models.base import feature_masks as jax_masks
from gnn_fluid_dynamics_tpu.models.normalizer import \
    StatsAccumulator as JaxStatsAccumulator
from gnn_fluid_dynamics_tpu.ops import pallas_agg
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry
from gnn_fluid_dynamics_tpu.training.config import Config
from gnn_fluid_dynamics_tpu.training.trainer import Trainer

from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset,
                                                        Trajectory,
                                                        rollout_batch)
from gnn_fluid_dynamics_tpu_torch.graph import from_geometry, to_static_bands
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig, feature_masks
from gnn_fluid_dynamics_tpu_torch.models.flux import FluxD
from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
from gnn_fluid_dynamics_tpu_torch.ops import kernels
from gnn_fluid_dynamics_tpu_torch.parallel import spmd
from gnn_fluid_dynamics_tpu_torch.training.validate import validate
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

H = kernels.H
OLD_CAP = 1792          # the widest band K6/K7 took before they streamed it
BAND = 2048
OFFSETS = (0, 136, 512)  # 8-aligned, as the TPU kernels' DMAs want
SOURCE_ROWS = 2600
HIDDEN, MP, STEPS = 128, 2, 4
BF16_TOL = 4e-2


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _wide_tables(rng, n):
    """``n`` (3, 128, BAND) int8 tables of 0/1/2 weights, about 1 % nonzero,
    one tile's last column set so that its band is used to its end."""
    out = []
    for _ in range(n):
        oh = np.where(rng.random((len(OFFSETS), 128, BAND)) < 0.01,
                      rng.integers(1, 3, (len(OFFSETS), 128, BAND)), 0)
        oh[1, 7, BAND - 1] = 1
        out.append(oh.astype(np.int8))
    return out


@pytest.mark.parametrize("form", ["pair", "roll", "roll_wide", "single",
                                  "single_wide"])
def test_plain_versions_match_pallas_at_a_wide_band(form):
    rng = np.random.default_rng(22)
    width = {"pair": H, "roll": H, "roll_wide": 2 * H, "single": H,
             "single_wide": H}[form]
    src = rng.integers(-4, 5, (SOURCE_ROWS, width)).astype(np.float32)
    sj = jnp.asarray(src, jnp.bfloat16)
    off = np.asarray(OFFSETS, np.int32)
    offj, offt = jnp.asarray(off), torch.from_numpy(off)
    if form.startswith("single"):
        (oh,) = _wide_tables(rng, 1)
        lanes = width // 2 if form == "single" else width
        want = pallas_agg.banded_single_pallas(jnp.asarray(oh), offj, sj)
        want = _np(want)[:, :lanes] / 3.0
        got = kernels.table_single(torch.from_numpy(oh), offt, torch.from_numpy(
            src[:, :lanes]).to(torch.bfloat16))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), want)
        return
    a, b = _wide_tables(rng, 2)
    st = torch.from_numpy(src).to(torch.bfloat16)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    if form == "pair":
        want = pallas_agg.banded_dual_pallas(jnp.asarray(a), jnp.asarray(b),
                                             offj, sj)
        got = kernels.table_dual(at, bt, offt, st)
    else:
        want = (pallas_agg.banded_dual_pallas(
            jnp.asarray(a), jnp.asarray(b), offj, sj,
            combine_roll=width // 2)[:, :width // 2],)
        got = (kernels.table_dual(at, bt, offt, st, combine_roll=True),)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and np.any(_np(g) != 0)
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("kernel,lanes,band", [
    ("K6", H, 1920), ("K6", 2 * H, 2048), ("K7", H // 2, 5376),
    ("K7", H, 1024)])
def test_wrappers_pass_any_band_to_the_kernel(monkeypatch, kernel, lanes,
                                              band):
    """Off the CPU the wrappers check what the kernels take and launch; a
    band past the old cap is neither refused nor sent elsewhere. (The bands
    of 0 and 200 rows are still refused:
    ``test_torch_redesign.py::test_table_single_refuses_a_band_the_kernel_does_not_take``.)"""
    meta = torch.device("meta")
    launched, checked = [], []
    monkeypatch.setattr(kernels, "_launch",
                        lambda name, dev, *args: launched.append((name, args)))
    monkeypatch.setattr(kernels, "_check_bands",
                        lambda off, b, rows: checked.append((b, rows)))
    T, rows = 4, 8192
    oh = torch.empty((T, 128, band), dtype=torch.int8, device=meta)
    off = torch.zeros(T, dtype=torch.int32, device=meta)
    src = torch.empty((rows, lanes), dtype=torch.bfloat16, device=meta)
    call = kernels.table_dual if kernel == "K6" else kernels.table_single
    before = call.launches
    if kernel == "K6" and lanes == H:             # the pair (cf)
        a, b = call(oh, oh, off, src)
        assert a.shape == b.shape == (T * 128, H)
    elif kernel == "K6":                          # the wide roll (es/er)
        out = call(oh, oh, off, src, combine_roll=True)
        assert out.shape == (T * 128, H)
    else:
        out = call(oh, off, src)
        assert out.shape == (T * 128, lanes) and out.dtype == torch.float32
    assert checked == [(band, rows)]
    (name, args), = launched
    assert name == ("table_dual" if kernel == "K6" else "table_single")
    assert band in args and call.launches == before + 1
    call.launches = before


def test_space_rank_with_a_wide_band_gets_its_tables():
    """A 2,000-point cylinder in its generator's order (no RCM), whose
    cell -> face bands are wide, cut in two: each rank's cf band passes
    1,792 rows, it keeps the table route, and its tables' plain versions
    give, at its owned rows, what the whole graph's give at their global
    rows (cf, es/er with the roll, vc), bit for bit."""
    geom = make_geometry("cylinder", n_points=2000, seed=0)
    fields = channel_flow_trajectory(geom, num_timesteps=2, dt=0.01)
    g = from_geometry(geom, fields, dt=0.01, pad_multiple=128,
                      with_banded=True, banded_dtype="int8", device="cpu")
    gen = torch.Generator().manual_seed(5)
    cells = torch.randint(-8, 9, (g.num_cells, H), generator=gen).to(
        torch.bfloat16)
    edges = torch.randint(-8, 9, (g.num_faces, H), generator=gen).to(
        torch.bfloat16)
    vtx = torch.randint(-8, 9, (g.num_vertices, H // 2), generator=gen).to(
        torch.bfloat16)
    whole = {"cf": kernels.table_dual(g.cf_row_onehot, g.cf_col_onehot,
                                      g.cf_off, cells),
             "es": kernels.table_dual(g.es_onehot, g.er_onehot, g.es_off,
                                      edges, combine_roll=True),
             "vc": kernels.table_single(g.vc_onehot, g.vc_off, vtx)}
    part = spmd.partition(g, 2)
    for s in range(2):
        lg = spmd.local_graph(g, part, s)
        widths = spmd.band_widths(lg)
        assert lg.table_route and widths["cf"] > OLD_CAP, widths
        gid = {k: v.long() for k, v in lg.halo.gid.items()}
        row, col = kernels.table_dual(lg.cf_row_onehot, lg.cf_col_onehot,
                                      lg.cf_off, cells[gid["cell"]])
        own_f = lg.face_mask
        assert torch.equal(row[own_f], whole["cf"][0][gid["face"]][own_f])
        assert torch.equal(col[own_f], whole["cf"][1][gid["face"]][own_f])
        # es/er at the vertices of owned cells, vc at the owned cells
        sums = kernels.table_dual(lg.es_onehot, lg.er_onehot, lg.es_off,
                                  edges[gid["face"]], combine_roll=True)
        at = torch.unique(lg.vertex_face[:, lg.cell_mask].long())
        assert torch.equal(sums[at], whole["es"][gid["vertex"]][at])
        means = kernels.table_single(lg.vc_onehot, lg.vc_off,
                                     vtx[gid["vertex"]])
        own_c = lg.cell_mask
        assert torch.equal(means[own_c], whole["vc"][gid["cell"]][own_c])


@pytest.fixture(scope="module")
def mixed():
    """Two RCM-ordered cylinders of 1,200 and 300 points in one validation
    set (padded to the larger), in both packages' datasets, FluxD with the
    JAX package's seeded weights in both, and its statistics from each
    package's first batch, as ``tests/test_torch_validate.py`` sets them
    up."""
    geoms = [rcm_reorder_geometry(make_geometry("cylinder", n_points=n, seed=s))
             for n, s in ((1200, 0), (300, 1))]
    fields = [channel_flow_trajectory(g, num_timesteps=STEPS + 2, dt=0.01)
              for g in geoms]

    def trajs(cls):
        return [cls(mesh_id=f"sim{i}", geom=g, fields=f)
                for i, (g, f) in enumerate(zip(geoms, fields))]

    dj = JaxDataset(trajs(JaxTrajectory), with_banded=True,
                    banded_dtype="float32", pad_multiple=128)
    dt = MeshDataset(trajs(Trajectory), with_banded=True,
                     banded_dtype="float32", pad_multiple=128, device="cpu")
    cfg = dict(name="FluxD", hidden_width=HIDDEN, mp_num=MP,
               aggregation="pallas", compute_dtype="bfloat16", scale_init=None)
    jm = get_model_class("FluxD")(JaxModelConfig(**cfg))
    gj = dj.get_batch(rollout_batch(dj))
    _, jfeats = jm.transform_rollout(gj)
    acc = JaxStatsAccumulator(jm.nmap)
    acc.update(jfeats, jax_masks(gj, jfeats))
    jm.set_stats(acc.finalize())
    trainer = Trainer(Config(), jm)
    state = trainer.init_state(jax.random.PRNGKey(0), gj, jfeats)
    tm = FluxD(ModelConfig(**cfg), device="cpu")
    gt = dt.get_batch(rollout_batch(dt))
    _, tfeats = tm.transform_rollout(gt)
    acc = StatsAccumulator(tm.nmap)
    acc.update(tfeats, feature_masks(gt, tfeats))
    tm.set_stats(acc.finalize())
    tm.module.load_state_dict(params_from_flax(
        {"params": state.params, "batch_stats": state.batch_stats}))
    return dj, dt, trainer, state, tm


def test_validate_on_mixed_sizes_matches_jax_trainer(mixed):
    dj, dt, trainer, state, tm = mixed
    batch = to_static_bands(dt.get_batch(rollout_batch(dt)), derive_idx=False)
    small = dt._static_graph("sim1", dt.pad_to)
    assert batch.table_route and small.es_onehot.shape[2] > OLD_CAP
    assert batch.es_onehot.shape[2] == small.es_onehot.shape[2]

    class Logger:
        def save_plots(self, evo, step, prefix):
            pass

    trainer.logger = Logger()
    want = trainer.validate(state, dj, STEPS)
    got = validate(tm, dt, STEPS)
    assert sorted(got) == sorted(want)
    assert np.isfinite(got["total_mean_error"])
    for key in ("total_mean_error", "velocity_error/mean_all",
                "pressure_error/mean_all", "divergence_error/mean_all"):
        assert got[key] == pytest.approx(want[key], rel=BF16_TOL), key
