"""The rollout entry point on trained weights and real data, against the
JAX package.

The data is mesh_0 of ``rollouts/e2e/rollout-cyl/data0.h5`` (3,336 cells,
5,168 faces, 1,832 vertices, RCM-ordered; OpenFOAM ground truth at the
steps 1..389). The weights are the trained FluxD of
``checkpoints/e2e/fluxd/checkpoint-12`` (hidden 128, 15 blocks, bf16 as
shipped), restored by orbax and carried into the port by
``scripts/torch_convert_flax_checkpoint.py``. Both packages start from the
step-1 ground truth with the time step DT. The file holds no time step;
FluxD's cell velocity change is DT times a rate that does not depend on
DT, so the least-squares fit of the JAX model's one-step rate to the
ground truth's step difference gives a fair one (0.008167 in f32; DT is it
to 3 digits, ``test_stated_dt_is_the_least_squares_fit``). The parity does
not depend on it. Both sides take the plain route (``"segment"``): the JAX
package's ``"banded"`` route rounds the physics gathers to its tables'
dtype.

Tolerances, as the largest difference over the live rows of an output
relative to that output's largest magnitude:

* f32: one step within 2e-5 (measured 9.2e-6 on the cell velocity change,
  the others below 2e-6); the cell velocity and pressure of 10 free steps
  within 1e-3 at every step, and of the whole trajectory too (the slow
  test; measured 2.1e-6 at worst over its 388 steps).
* bf16, as shipped: one step of the face outputs within 5e-2 of the JAX
  package's (measured 1.2e-2). The cell velocity change is the
  integrator's sum dt/V (-Phi_a - Phi_p + nu Phi_d) of face terms that
  nearly cancel: each package's bf16 value lies 0.09-0.12 of its largest
  magnitude from the f32 model (measured), so the two part by up to 0.145,
  beyond 5e-2. It is held against the f32 model instead: the port's bf16
  value no further from it than the JAX package's bf16 value plus 5e-2.
  ``test_trained_fluxd_gap_is_before_the_integrator`` places that gap:
  each package's integrator, fed the other's decoder output, gives the
  other's value within 2e-5, so the integrators agree and the gap is the
  decoders' bf16 rounding (1.3e-2 at most), amplified by the sum.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import importlib.util
import json
import os
import pathlib
import shutil

import flax.linen as flax_nn
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data import hdf5 as jax_hdf5
from gnn_fluid_dynamics_tpu.data.pipeline import Trajectory as JaxTrajectory
from gnn_fluid_dynamics_tpu.data.synthetic import (make_geometry,
                                                   taylor_green_trajectory)
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.models import get_model_class as jax_model_class
from gnn_fluid_dynamics_tpu.models.arch import \
    EncodeProcessDecode as JaxEncodeProcessDecode
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.rollout import engine as jax_engine
from gnn_fluid_dynamics_tpu.training.config import Config as JaxConfig
from gnn_fluid_dynamics_tpu.training.train import \
    build_datasets as jax_build_datasets

from gnn_fluid_dynamics_tpu_torch.data import hdf5
from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset,
                                                        Trajectory,
                                                        rollout_batch)
from gnn_fluid_dynamics_tpu_torch.graph import from_geometry, to_static_bands
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig
from gnn_fluid_dynamics_tpu_torch.models.flux import FluxD
from gnn_fluid_dynamics_tpu_torch.models.mgn import MgnA
from gnn_fluid_dynamics_tpu_torch.ops.reorder import (rcm_reorder_geometry,
                                                      reorder_fields)
from gnn_fluid_dynamics_tpu_torch.rollout import engine, run
from gnn_fluid_dynamics_tpu_torch.training.checkpoint import (
    Checkpointer, restore_train_state)
from gnn_fluid_dynamics_tpu_torch.training.config import Config
from gnn_fluid_dynamics_tpu_torch.training.model_loading import (
    backward_compatibility, load_params_flexible)
from gnn_fluid_dynamics_tpu_torch.training.train import build_datasets
from gnn_fluid_dynamics_tpu_torch.training.trainer import Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = ROOT / "checkpoints/e2e/fluxd/checkpoint-12"
DATA = ROOT / "rollouts/e2e/rollout-cyl/data0.h5"
CONVERTER = ROOT / "scripts/torch_convert_flax_checkpoint.py"
DT = 0.00817
TEN = 10
F32_ONE_STEP, F32_TEN_STEPS, BF16_ONE_STEP = 2e-5, 1e-3, 5e-2
OUTPUTS = ("cell_velocity_change", "face_velocity", "face_pressure",
           "face_flux", "cell_flux")
FACE_OUTPUTS = OUTPUTS[1:]
FIELDS = {"cell_velocity": "cell/velocity_gt",
          "cell_pressure": "cell/pressure_gt",
          "face_velocity": "face/velocity_gt",
          "face_pressure": "face/pressure_gt", "face_flux": "face/flux_gt"}


def _rel(got, want, mask):
    got = np.asarray(got, np.float64)[mask]
    want = np.asarray(want, np.float64)[mask]
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """checkpoint-12 through the converter: (port checkpoint dir, state
    dict, the orbax tree, meta)."""
    spec = importlib.util.spec_from_file_location("torch_convert", CONVERTER)
    converter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(converter)
    out = tmp_path_factory.mktemp("ckpt") / "checkpoint-12"
    state, tree = converter.convert(str(CKPT), str(out))
    meta = json.loads((CKPT / "meta.json").read_text())
    return out, state, tree, meta


@pytest.fixture(scope="module")
def mesh0():
    """mesh_0's geometry and the ground truth of its first TEN + 1 saved
    steps (steps 1..11), time-major."""
    with h5py.File(DATA, "r") as f:
        g = f["mesh_0"]
        geom = {k: g["geom"][k][()] for k in g["geom"].keys()}
        fields = {k: g[path][:TEN + 1] for k, path in FIELDS.items()}
    return geom, fields


def _models(meta, state, tree, dtype):
    """JAX FluxD and the port's, checkpoint-12's config with
    ``aggregation="segment"`` and ``compute_dtype`` ``dtype``, the
    checkpoint's statistics and weights."""
    mcfg = {**meta["config"]["model"], "aggregation": "segment",
            "compute_dtype": dtype}

    def config(cls):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in mcfg.items() if k in names})

    jm = jax_model_class("FluxD")(config(JaxModelConfig))
    jm.set_stats(meta["stats"])
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    tm = FluxD(config(ModelConfig), device="cpu")
    tm.set_stats(meta["stats"])
    tm.module.load_state_dict(state)
    return jm, variables, tm


def _graphs(mesh0):
    geom, fields = mesh0
    window = {k: v[:2] for k, v in fields.items()}
    return (jax_from_geometry(geom, window, dt=DT, pad_multiple=128),
            from_geometry(geom, window, dt=DT, pad_multiple=128,
                          device="cpu"))


def _one_step(converted, mesh0, dtype):
    _, state, tree, meta = converted
    jm, variables, tm = _models(meta, state, tree, dtype)
    gj, gt = _graphs(mesh0)
    _, fj = jm.transform_features(gj, None, "rollout")
    out_j = jax.jit(lambda v, g, f: jm.forward(v, g, f, mode="rollout")[0])(
        variables, gj, fj)
    _, ft = tm.transform_rollout(gt)
    with torch.inference_mode():
        out_t = tm.forward(gt, ft)
    return ({k: np.asarray(out_j[k]) for k in OUTPUTS},
            {k: out_t[k].numpy() for k in OUTPUTS}, gt)


@pytest.fixture(scope="module")
def one_step_f32(converted, mesh0):
    return _one_step(converted, mesh0, "float32")


def _mask(gt, key):
    return (gt.cell_mask if key.startswith("cell") else gt.face_mask).numpy()


# ---- the converter and the checkpoint ----------------------------------------

def test_converter_writes_the_port_checkpoint(converted):
    """Every tensor of the port's FluxD (267, 2,210,316 values) with its
    shape, the optimizer's state, the step, and the meta with its
    statistics."""
    out, state, _, meta = converted
    tm = FluxD(ModelConfig(hidden_width=128, mp_num=15, scale_init="stats"),
               device="cpu")
    own = tm.module.state_dict()
    assert set(state) == set(own) and len(state) == 267
    assert sum(v.numel() for v in state.values()) == 2_210_316
    tm.module.load_state_dict(state, strict=True)
    tree, read_meta = Checkpointer(str(out.parent)).load(str(out))
    assert tree["step"] == meta["step"] == 52224
    assert set(tree) == {"module", "optimizer", "step"}
    assert read_meta["stats"] == meta["stats"]
    assert read_meta["config"] == meta["config"]


def test_resume_from_a_converted_checkpoint_raises(converted):
    """A converted checkpoint of the module and the step only (the
    converter's layout before it wrote the optimizer's state) cannot be
    resumed from."""
    out, _, _, meta = converted
    config = Config.from_dict(meta["config"])
    tm = FluxD(ModelConfig(hidden_width=128, mp_num=15, scale_init="stats"),
               device="cpu")
    state = Trainer(config, tm).init_state()
    tree, _ = Checkpointer(str(out.parent)).load(str(out))
    del tree["optimizer"]
    with pytest.raises(ValueError, match="optimizer"):
        restore_train_state(tree, state)


# ---- trained FluxD on mesh_0 --------------------------------------------------

def test_stated_dt_is_the_least_squares_fit(one_step_f32, mesh0):
    """DT within 1 % of the fit of the JAX model's rate (its cell velocity
    change per unit time step) to the ground truth's step 1 -> 2."""
    out_j, _, gt = one_step_f32
    _, fields = mesh0
    C = fields["cell_velocity"].shape[1]
    rate = out_j["cell_velocity_change"][:C] / DT
    dv = fields["cell_velocity"][1] - fields["cell_velocity"][0]
    fit = float((rate * dv).sum() / (rate * rate).sum())
    assert abs(fit / DT - 1.0) <= 1e-2, fit


@pytest.mark.parametrize("key", OUTPUTS)
def test_trained_fluxd_one_step_f32(one_step_f32, key):
    out_j, out_t, gt = one_step_f32
    assert _rel(out_t[key], out_j[key], _mask(gt, key)) <= F32_ONE_STEP


def test_trained_fluxd_one_step_bf16(converted, mesh0, one_step_f32):
    """As shipped, in bf16 (see the module's docstring for the cell
    velocity change)."""
    ref, _, gt = one_step_f32
    out_j, out_t, _ = _one_step(converted, mesh0, "bfloat16")
    for key in FACE_OUTPUTS:
        assert _rel(out_t[key], out_j[key], _mask(gt, key)) <= BF16_ONE_STEP
    key = "cell_velocity_change"
    mask = _mask(gt, key)
    port, jax_ = (_rel(o[key], ref[key], mask) for o in (out_t, out_j))
    assert port <= jax_ + BF16_ONE_STEP, (port, jax_)


def _after_decoder(converted, mesh0, dtype):
    """One step of each package in ``dtype``, with each package's decoder
    output (the six face channels before the learned scales) captured and
    then fed in place of its own decoder's into the other package's scales
    and integrator. Returns a dict: ``raw_j``/``raw_t`` the decoder
    outputs, ``cvc_j``/``cvc_t`` each package's cell velocity change,
    ``t_on_j`` the port's after-decoder part on JAX's decoder output,
    ``j_on_t`` JAX's on the port's, and the graph."""
    _, state, tree, meta = converted
    jm, variables, tm = _models(meta, state, tree, dtype)
    gj, gt = _graphs(mesh0)
    _, fj = jm.transform_features(gj, None, "rollout")
    _, ft = tm.transform_rollout(gt)

    def jax_step(v, g, f, raw):
        seen = {}

        def intercept(next_fun, args, kwargs, context):
            if (isinstance(context.module, JaxEncodeProcessDecode)
                    and context.method_name == "__call__"):
                out = next_fun(*args, **kwargs) if raw is None else (None, raw)
                seen["raw"] = out[1]
                return out
            return next_fun(*args, **kwargs)

        with flax_nn.intercept_methods(intercept):
            out = jm.forward(v, g, f, mode="rollout")[0]
        return out["cell_velocity_change"], seen["raw"]

    seen = {}

    def hook(module, args, out):
        if "feed" in seen:
            return out[0], seen["feed"]
        seen["raw"] = out[1]

    def port_step(raw=None):
        seen.clear()
        if raw is not None:
            seen["feed"] = torch.from_numpy(np.array(raw))
        handle = tm.module.epd.register_forward_hook(hook)
        try:
            with torch.inference_mode():
                out = tm.forward(gt, ft)["cell_velocity_change"].numpy()
        finally:
            handle.remove()
        return out

    jax_step = jax.jit(jax_step)
    cvc_j, raw_j = (np.asarray(a) for a in jax_step(variables, gj, fj, None))
    cvc_t = port_step()
    raw_t = seen["raw"].numpy()
    return {"raw_j": raw_j, "raw_t": raw_t, "cvc_j": cvc_j, "cvc_t": cvc_t,
            "t_on_j": port_step(raw_j),
            "j_on_t": np.asarray(jax_step(variables, gj, fj, raw_t)[0]),
            "graph": gt}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trained_fluxd_gap_is_before_the_integrator(converted, mesh0, dtype):
    """Places the bf16 gap of the cell velocity change (see the module's
    docstring). Each package's scales and integrator, fed the other
    package's decoder output, give the other package's cell velocity change
    within the f32 one-step bound, 2e-5 (both integrators run in f32;
    measured at most 2.1e-6 in f32 and 2.6e-6 in bf16, against the 0.145
    between the bf16 packages). So the packages' integrators agree, and the
    difference of their cell velocity changes comes from their decoder
    outputs, whose six channels agree within the issue's bf16 bound, 5e-2
    (measured at most 1.3e-2 in bf16, 2e-6 in f32)."""
    r = _after_decoder(converted, mesh0, dtype)
    gt = r["graph"]
    face, cell = _mask(gt, "face"), _mask(gt, "cell")
    for c in range(6):
        assert _rel(r["raw_t"][:, c], r["raw_j"][:, c], face) <= BF16_ONE_STEP
    assert _rel(r["t_on_j"], r["cvc_j"], cell) <= F32_ONE_STEP
    assert _rel(r["j_on_t"], r["cvc_t"], cell) <= F32_ONE_STEP


def _rollouts(converted, mesh0, steps, fields_gt=None):
    """``steps`` free f32 steps from step 1 in each package: (JAX errors,
    JAX fields, port errors, port fields, port graph)."""
    _, state, tree, meta = converted
    jm, variables, tm = _models(meta, state, tree, "float32")
    gj, gt = _graphs(mesh0)
    _, fields = mesh0
    if fields_gt is not None:
        fields = fields_gt
    pad = ((0, 0), (0, gt.num_cells - fields["cell_velocity"].shape[1]),
           (0, 0))
    gv = np.pad(fields["cell_velocity"][1:steps + 1], pad)
    gp = np.pad(fields["cell_pressure"][1:steps + 1], pad)
    _, fj = jm.transform_features(gj, None, "rollout")
    err_j, out_j = jax_engine.rollout_scan(
        jm, variables, gj, fj, jnp.asarray(gv), jnp.asarray(gp),
        jax_engine.RolloutConfig(num_steps=steps, save_fields=True))
    _, ft = tm.transform_rollout(gt)
    err_t, out_t = engine.rollout_scan(
        tm, gt, ft, torch.from_numpy(gv), torch.from_numpy(gp),
        engine.RolloutConfig(num_steps=steps, save_fields=True))
    return err_j, out_j, err_t, out_t, gt


def _per_step_rel(out_t, out_j, key, live):
    a = out_t[key].numpy()[:, live].astype(np.float64)
    b = np.asarray(out_j[key])[:, live].astype(np.float64)
    return np.abs(a - b).max(axis=(1, 2)) / np.abs(b).max(axis=(1, 2))


def test_trained_fluxd_ten_steps_f32(converted, mesh0):
    err_j, out_j, err_t, out_t, gt = _rollouts(converted, mesh0, TEN)
    live = gt.cell_mask.numpy()
    for key in ("cell_velocity", "cell_pressure"):
        rel = _per_step_rel(out_t, out_j, key, live)
        assert rel.shape == (TEN,) and (rel <= F32_TEN_STEPS).all(), (key, rel)
    for key in ("velocity_error", "pressure_error", "divergence_error"):
        assert np.isfinite(err_t[key].numpy()).all()


@pytest.mark.slow
def test_trained_fluxd_whole_trajectory_f32(converted):
    """All 388 steps the file's 389 states allow, from step 1: the cell
    velocity and pressure within 1e-3 of the JAX package's at every step
    (measured: at most 2.1e-6), and the mean velocity and pressure errors
    within 1e-3 relative (measured 0.019662 and 0.220308 on both sides;
    the JAX package's stored run, at the dataset's own time step, 0.0145
    and 0.2225). About two minutes on the CPU."""
    with h5py.File(DATA, "r") as f:
        g = f["mesh_0"]
        geom = {k: g["geom"][k][()] for k in g["geom"].keys()}
        fields = {k: g[path][()] for k, path in FIELDS.items()}
    steps = fields["cell_velocity"].shape[0] - 1
    mesh = (geom, {k: v[:2] for k, v in fields.items()})
    err_j, out_j, err_t, out_t, gt = _rollouts(converted, mesh, steps, fields)
    live = gt.cell_mask.numpy()
    for key in ("cell_velocity", "cell_pressure"):
        rel = _per_step_rel(out_t, out_j, key, live)
        assert (rel <= F32_TEN_STEPS).all(), (key, rel.max())
    for key in ("velocity_error", "pressure_error"):
        np.testing.assert_allclose(err_t[key].numpy().mean(),
                                   np.asarray(err_j[key]).mean(),
                                   rtol=F32_TEN_STEPS)


# ---- the entry point ----------------------------------------------------------

ENTRY_STEPS = 5


@pytest.fixture(scope="module")
def entry_run(converted, mesh0, tmp_path_factory):
    """``rollout.run.main`` on a reference-layout ``valid.h5`` holding
    mesh_0 with the ground truth of ENTRY_STEPS + 1 steps and time step DT,
    and the converted checkpoint, saving every 2nd step; run from a fresh
    working directory. Returns (working dir, config, main's result)."""
    geom, fields = mesh0
    work = tmp_path_factory.mktemp("rollout")
    data = work / "data"
    hdf5.save_dataset(str(data / "valid.h5"), [Trajectory(
        mesh_id="mesh_0", geom=geom, dt=DT,
        fields={k: v[:ENTRY_STEPS + 1] for k, v in fields.items()})])
    cfg = {"logging": {"project": "e2e", "name": "fluxd-ckpt12"},
           "dataset": {"module": "builtin", "dpath": str(data)},
           "model": {"fpath": str(converted[0])},
           "rollout": {"data_subset": "valid", "data_sim_limit": 1,
                       "data_timestep_range": [0, ENTRY_STEPS + 1],
                       "save_frequency": 2},
           "settings": {"machine": "default"}}
    path = work / "rollout.json"
    path.write_text(json.dumps(cfg))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        result = run.main(["--config", str(path), "--device", "cpu"])
    finally:
        os.chdir(cwd)
    return work, cfg, result


def test_entry_point_adds_no_numerics(entry_run, converted):
    """Its errors.json equals ``error_summary`` of a direct ``rollout_scan``
    of checkpoint-12's model (as configured: bf16, ``"banded"``, so the
    mesh RCM-ordered once more) on the same steps, exactly."""
    work, cfg, result = entry_run
    _, state, _, meta = converted
    written = json.loads(
        (work / "rollouts/e2e/fluxd-ckpt12/errors.json").read_text())
    (traj,) = hdf5.load_dataset(str(work / "data/valid.h5"))
    geom = rcm_reorder_geometry(traj.geom)
    traj = Trajectory(mesh_id=traj.mesh_id, geom=geom, dt=traj.dt,
                      fields=reorder_fields(traj.fields, traj.geom, geom))
    ds = MeshDataset([traj], timestep_range=(0, ENTRY_STEPS + 1),
                     device="cpu")
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    tm = FluxD(ModelConfig(**{k: v for k, v in meta["config"]["model"].items()
                              if k in names}), device="cpu")
    tm.set_stats(meta["stats"])
    tm.module.load_state_dict(state)
    graph = to_static_bands(ds.get_batch(rollout_batch(ds)))
    _, feats = tm.transform_rollout(graph)
    gv, gp = ds.trajectory_targets(ds.sim_ids(), 0, ENTRY_STEPS)
    errors, _ = engine.rollout_scan(tm, graph, feats, gv, gp,
                                    engine.RolloutConfig(num_steps=ENTRY_STEPS))
    scalars, evo = engine.error_summary(errors, ds.sim_ids())
    assert result["num_steps"] == ENTRY_STEPS
    assert written == json.loads(json.dumps({"scalar": scalars,
                                             "evolution": evo}))
    assert len(written["evolution"]["velocity_error"]["evo_mesh_0"]) == ENTRY_STEPS
    for key in ("velocity_error", "pressure_error", "divergence_error"):
        assert np.isfinite(written["scalar"][key]["mean_all"])


def test_entry_point_writes_the_reference_layout(entry_run):
    """data0.h5 with the datasets and shapes ``tests/test_rollout.py``
    asserts for the JAX writer, every 2nd of the 5 steps, and meta.json."""
    work, cfg, _ = entry_run
    out = work / "rollouts/e2e/fluxd-ckpt12"
    meta = json.loads((out / "meta.json").read_text())
    assert meta["meshes"] == {"data0": ["mesh_0"]}
    assert meta["timerange"] == [0, ENTRY_STEPS + 1]
    assert meta["model"] == cfg["model"]["fpath"]
    with h5py.File(out / "data0.h5", "r") as f:
        grp = f["mesh_0"]
        C = grp["geom"]["cell_pos"].shape[0]
        F = grp["geom"]["face_pos"].shape[0]
        assert (C, F) == (3336, 5168)
        for name, shape in (("velocity", (3, C, 2)), ("pressure", (3, C, 1)),
                            ("flux", (3, C, 3)), ("velocity_gt", (3, C, 2)),
                            ("pressure_gt", (3, C, 1))):
            assert grp["cell"][name].shape == shape, name
        for name, shape in (("velocity", (3, F, 2)), ("pressure", (3, F, 1)),
                            ("flux", (3, F, 1)), ("velocity_gt", (3, F, 2)),
                            ("pressure_gt", (3, F, 1)),
                            ("flux_gt", (3, F, 1))):
            assert grp["face"][name].shape == shape, name
        assert list(grp["timesteps"]) == [1, 3, 5]
        (traj,) = hdf5.load_dataset(str(work / "data/valid.h5"))
        new_geom = rcm_reorder_geometry(traj.geom)
        want = reorder_fields(traj.fields, traj.geom, new_geom)
        np.testing.assert_array_equal(grp["cell"]["velocity_gt"][1],
                                      want["cell_velocity"][3])


def test_entry_point_refuses_a_checkpoint_that_does_not_match(
        entry_run, converted):
    """A checkpoint with one leaf renamed makes ``rollout.run`` raise,
    naming the leaf, before it rolls out a partly random model."""
    work, cfg, _ = entry_run
    out = work / "renamed" / "checkpoint-12"
    shutil.copytree(converted[0], out)
    tree = torch.load(out / "state.pt", weights_only=True)
    leaf = "flux_scale.scale"
    tree["module"]["flux_scale.renamed"] = tree["module"].pop(leaf)
    torch.save(tree, out / "state.pt")
    path = work / "renamed.json"
    path.write_text(json.dumps({**cfg, "model": {"fpath": str(out)}}))
    with pytest.raises(ValueError, match=f"{leaf} \\(missing in checkpoint\\)"):
        run.main(["--config", str(path), "--device", "cpu"])


def test_entry_point_needs_the_card_unless_asked(entry_run):
    work, _, _ = entry_run
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--config", str(work / "rollout.json")])


# ---- the reference layout, both ways -----------------------------------------

def _small_trajectories(cls, reynolds=None):
    out = []
    for i in range(2):
        geom = make_geometry("structured", nx=5 + i, ny=4, jitter=0.1, seed=i)
        fields = taylor_green_trajectory(geom, num_timesteps=4, dt=0.01)
        if i == 1:
            geom = {k: v for k, v in geom.items()
                    if k not in hdf5.DERIVED_KEYS}
        kw = {} if reynolds is None else {"reynolds": reynolds}
        out.append(cls(mesh_id=f"mesh_{i}", geom=geom, fields=dict(fields),
                       dt=0.01 * (i + 1), **kw))
    return out


def _same_trajectories(got, want):
    assert [t.mesh_id for t in got] == [t.mesh_id for t in want]
    for a, b in zip(got, want):
        assert a.dt == b.dt and a.reynolds == b.reynolds
        assert set(a.geom) == set(b.geom) and set(a.fields) == set(b.fields)
        for key in a.geom:
            np.testing.assert_array_equal(a.geom[key], b.geom[key], key)
            assert a.geom[key].dtype == b.geom[key].dtype, key
        for key in a.fields:
            np.testing.assert_array_equal(a.fields[key], b.fields[key], key)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_layout_both_ways(tmp_path, writer):
    """One package writes, both read, array for array (the second mesh is
    written without the derived sign and slot tables, as the reference
    writes its files, and each reader regenerates them); stored MLS weights
    of the asked order are read where a mesh has them."""
    path = str(tmp_path / "d.h5")
    if writer == "port":
        hdf5.save_dataset(path, _small_trajectories(Trajectory, 150.0))
    else:
        jax_hdf5.save_dataset(path, _small_trajectories(JaxTrajectory, 150.0))
    rng = np.random.default_rng(6)
    with h5py.File(path, "a") as f:
        sub = f["mesh_0"].create_group("cell_grad_weights/1")
        sub.create_dataset("weights", data=rng.normal(
            size=(40, 6, 2)).astype(np.float32))
        sub.create_dataset("neighbours", data=rng.integers(0, 40, (40, 6)))
    order = {"cell": 1, "face": 2}
    got = hdf5.load_dataset(path, flux_scale=1000.0, grad_weights_order=order)
    want = jax_hdf5.load_dataset(path, flux_scale=1000.0,
                                 grad_weights_order=order)
    _same_trajectories(got, want)
    assert "cell_face_sign" in got[1].geom and got[1].reynolds == 150.0
    for a, b in zip(got, want):
        assert set(a.grad_weights) == set(b.grad_weights)
        for key in a.grad_weights:
            np.testing.assert_array_equal(a.grad_weights[key],
                                          b.grad_weights[key])
    assert set(got[0].grad_weights) == {"cell_grad_weights",
                                        "cell_grad_neighbours"}
    picked = hdf5.load_dataset(path, sim_index=[1])
    assert [t.mesh_id for t in picked] == ["mesh_1"]


def test_build_datasets_reads_hdf5_as_jax(tmp_path):
    """The valid split of an ``openfoam`` module with ``"banded"``
    aggregation, for MgnA: the file's meshes RCM-ordered, the flux scaled
    by 1/0.001, the MLS cell weights added, as the JAX package builds
    them."""
    jax_hdf5.save_dataset(str(tmp_path / "valid.h5"),
                          _small_trajectories(JaxTrajectory))
    cfg = {"dataset": {"module": "openfoam", "dpath": str(tmp_path)},
           "model": {"name": "MgnA", "aggregation": "banded"},
           "rollout": {"data_subset": "valid", "data_sim_limit": 2,
                       "data_timestep_range": [0, 3]}}
    _, dj = jax_build_datasets(JaxConfig.from_dict(cfg),
                               jax_model_class("MgnA"), splits=("valid",))
    train, dt = build_datasets(Config.from_dict(cfg), MgnA, splits=("valid",),
                               device="cpu")
    assert train is None
    _same_trajectories(dt.trajectories, dj.trajectories)
    for a, b in zip(dt.trajectories, dj.trajectories):
        assert set(a.grad_weights) == set(b.grad_weights) == {
            "cell_grad_weights", "cell_grad_neighbours"}
        for key in a.grad_weights:
            np.testing.assert_array_equal(a.grad_weights[key],
                                          b.grad_weights[key])
    assert dt.with_banded and dt.timestep_range == (0, 3)


# ---- loading shims -----------------------------------------------------------

def test_backward_compatibility_renames_decoder():
    nested = {"epd": {"decoder": {"dense0": {"kernel": 1}}, "encoder": 2}}
    assert backward_compatibility(nested) == {
        "epd": {"decoder_face": {"dense0": {"kernel": 1}}, "encoder": 2}}
    flat = {"epd.decoder.dense0.weight": 1, "epd.decoder_face.bias": 2}
    assert backward_compatibility(flat) == {
        "epd.decoder_face.dense0.weight": 1, "epd.decoder_face.bias": 2}


def test_load_params_flexible_keeps_and_reports_mismatches():
    """A matching entry is copied (its legacy name renamed first); a shape
    mismatch and a missing entry keep the module's values; an unexpected
    entry is reported."""
    tm = FluxD(ModelConfig(hidden_width=32, mp_num=1), device="cpu")
    own = {k: v.clone() for k, v in tm.module.state_dict().items()}
    state = {k.replace("decoder_face", "decoder"): torch.full_like(v, 0.5)
             for k, v in own.items()}
    bad = "epd.encoder.cell_mlp.dense0.weight"
    state[bad] = torch.zeros(3, 3)
    missing = "flux_scale.scale"
    del state[missing]
    state["epd.extra.weight"] = torch.zeros(1)
    skipped = load_params_flexible(tm.module, state)
    assert skipped == [f"{bad} (shape (3, 3) != {tuple(own[bad].shape)})",
                       f"{missing} (missing in checkpoint)",
                       "epd.extra.weight (unexpected in checkpoint)"]
    now = tm.module.state_dict()
    torch.testing.assert_close(now[bad], own[bad])
    torch.testing.assert_close(now[missing], own[missing])
    assert (now["epd.decoder_face.dense2.weight"] == 0.5).all()
