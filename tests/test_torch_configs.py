"""The shipped configurations load into the port, and Flax's frozen variables
transplant.

* The FluxD checkpoint's model config (``checkpoints/e2e/fluxd/checkpoint-12/
  meta.json``: hidden 128, 15 blocks, bf16, ``aggregation="banded"``, the
  learned scales from the statistics embedded there) builds in the port,
  with ``"banded"`` and with ``"gather"`` (``config/train.json``). Neither
  name reaches a Pallas kernel in the JAX package, so both take the port's
  plain route: the port's outputs equal its ``"segment"`` model's exactly,
  and, with the config's compute dtype set to f32, one forward matches the
  JAX model with ``aggregation="segment"`` and the same weights to 1e-5 of
  each output's largest magnitude over live rows (the same math up to f32
  summation order). As shipped, in bf16, the port's model is held to its own
  segment model only: each MLP's bf16 roundings can fall differently in the
  two frameworks, and over 15 blocks with the statistics' scales the outputs
  part by up to 4.6e-2 (measured); ``test_torch_fluxd.py`` compares bf16
  against JAX at 2 blocks.
* ``params_from_flax`` takes a ``FrozenDict`` as it takes a plain dict.
"""

import torch_test_env  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import json
import pathlib

import flax
import jax
import numpy as np
import pytest
import torch

from gnn_fluid_dynamics_tpu.data.synthetic import (channel_flow_trajectory,
                                                   make_geometry)
from gnn_fluid_dynamics_tpu.graph import from_geometry as jax_from_geometry
from gnn_fluid_dynamics_tpu.models import get_model_class
from gnn_fluid_dynamics_tpu.models.base import ModelConfig as JaxModelConfig
from gnn_fluid_dynamics_tpu.ops.reorder import rcm_reorder_geometry

from gnn_fluid_dynamics_tpu_torch.graph import from_geometry
from gnn_fluid_dynamics_tpu_torch.models.base import ModelConfig
from gnn_fluid_dynamics_tpu_torch.models.flux import FluxD
from gnn_fluid_dynamics_tpu_torch.weights import params_from_flax

ROOT = pathlib.Path(__file__).resolve().parents[1]
META = ROOT / "checkpoints/e2e/fluxd/checkpoint-12/meta.json"
F32_TOL = 1e-5
OUTPUTS = ("cell_velocity_change", "face_velocity", "face_pressure",
           "face_flux", "cell_flux")


@pytest.fixture(scope="module")
def meta():
    return json.loads(META.read_text())


@pytest.fixture(scope="module")
def mesh():
    geom = rcm_reorder_geometry(make_geometry("cylinder", n_points=300, seed=0))
    fields = channel_flow_trajectory(geom, num_timesteps=2, dt=0.01)
    gj = jax_from_geometry(geom, fields, dt=0.01, pad_multiple=128)
    gt = from_geometry(geom, fields, dt=0.01, pad_multiple=128, device="cpu")
    return gj, gt


def _port_config(model_cfg: dict) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in model_cfg.items() if k in names})


def _jax_model(meta, model_cfg):
    cfg = JaxModelConfig(**{k: v for k, v in model_cfg.items()
                            if k in {f.name for f in
                                     dataclasses.fields(JaxModelConfig)}})
    jm = get_model_class("FluxD")(dataclasses.replace(cfg,
                                                      aggregation="segment"))
    jm.set_stats(meta["stats"])
    return jm


@pytest.mark.parametrize("aggregation,dtype",
                         [("banded", "float32"), ("gather", "float32"),
                          ("banded", None)])
def test_shipped_fluxd_config_builds_and_matches_jax(meta, mesh, aggregation,
                                                     dtype):
    gj, gt = mesh
    model_cfg = dict(meta["config"]["model"], aggregation=aggregation)
    cfg = _port_config(model_cfg)
    assert (cfg.name, cfg.hidden_width, cfg.mp_num, cfg.compute_dtype,
            cfg.scale_init) == ("FluxD", 128, 15, "bfloat16", "stats")
    if dtype is not None:
        model_cfg["compute_dtype"] = dtype
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    tm = FluxD(cfg, stats=meta["stats"], device="cpu")
    tm.set_stats(meta["stats"])
    jm = _jax_model(meta, model_cfg)
    _, jfeats = jm.transform_rollout(gj)
    variables = jm.init(jax.random.PRNGKey(0), gj, jfeats)
    tm.module.load_state_dict(params_from_flax(variables))
    seg = FluxD(dataclasses.replace(cfg, aggregation="segment"),
                stats=meta["stats"], device="cpu")
    seg.module.load_state_dict(tm.module.state_dict())
    _, tfeats = tm.transform_rollout(gt)
    with torch.no_grad():
        tout = tm.forward(gt, tfeats)
        sout = seg.forward(gt, tfeats)
    cm, fm = gt.cell_mask.numpy(), gt.face_mask.numpy()
    for key in OUTPUTS:
        torch.testing.assert_close(tout[key], sout[key], rtol=0, atol=0)
        mask = cm if key.startswith("cell") else fm
        assert torch.isfinite(tout[key][mask]).all(), key
    if dtype is None:
        return
    jout, _ = jm.forward(variables, gj, jfeats, mode="rollout")
    for key in OUTPUTS:
        mask = cm if key.startswith("cell") else fm
        got = tout[key].float().numpy()[mask]
        want = np.asarray(jout[key], np.float32)[mask]
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= F32_TOL, (key, rel)


def test_every_aggregation_name_builds():
    for name in ("segment", "pallas", "auto", "banded", "gather"):
        assert FluxD(ModelConfig(name="FluxD", aggregation=name, hidden_width=8,
                                 mp_num=1), device="cpu").arch.aggregation == name
    with pytest.raises(ValueError, match="not one of"):
        FluxD(ModelConfig(aggregation="scatter"), device="cpu")


def test_params_from_flax_takes_a_frozen_dict(meta, mesh):
    gj, _ = mesh
    jm = get_model_class("FluxD")(JaxModelConfig(name="FluxD", hidden_width=16,
                                                 mp_num=2))
    jm.set_stats(meta["stats"])
    _, jfeats = jm.transform_rollout(gj)
    variables = flax.core.unfreeze(jm.init(jax.random.PRNGKey(1), gj, jfeats))
    frozen = flax.core.freeze(variables)
    assert not isinstance(frozen, dict)
    want = params_from_flax(variables)
    for tree in (frozen, frozen["params"]):
        got = params_from_flax(tree)
        assert sorted(got) == sorted(want)
        for key in want:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    tm = FluxD(ModelConfig(hidden_width=16, mp_num=2), device="cpu")
    tm.module.load_state_dict(params_from_flax(frozen))
