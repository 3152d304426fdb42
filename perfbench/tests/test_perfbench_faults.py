"""A run whose timed path is broken comes out not correct, and so does the
control (the reference one precision below the configuration's, in the
program's place). On the CPU at a tiny size: the harness's look for a card
is skipped and the rest of a run is driven, the program in f32 so that the
sound run's gaps are rounding alone."""

import pytest
import torch

from perfbench import control
from perfbench.harness import manifest, run_cell
from perfbench.tests.test_perfbench_reference import tiny

BENCH = manifest.BENCH_DIR
SEED = 2 ** 32 + 77


def _scan():
    from gnn_fluid_dynamics_tpu_torch.rollout.engine import rollout_scan
    return rollout_scan


def state_unchanged(model, graph, feats, gt_v, gt_p, cfg):
    """Every step returns the state it was given."""
    forward = model.forward

    def frozen(*args, **kwargs):
        out = forward(*args, **kwargs)
        out["cell_velocity_change"] = torch.zeros_like(out["cell_velocity_change"])
        return out

    model.forward = frozen
    try:
        return _scan()(model, graph, feats, gt_v, gt_p, cfg)
    finally:
        del model.forward


def half_batch(model, graph, feats, gt_v, gt_p, cfg):
    """The second half of the trajectories left out: their errors the mean
    of the first half's, their fields held at the initial state."""
    errors, fields = _scan()(model, graph, feats, gt_v, gt_p, cfg)
    half = graph.num_graphs // 2
    errors = {k: torch.cat([v[:, :half], v[:, :half].mean(1, keepdim=True)
                            .expand(-1, v.shape[1] - half)], 1)
              for k, v in errors.items()}
    late = (graph.cell_batch >= half)[None, :, None]
    fields["cell_velocity"] = torch.where(late, feats["cell_x"][None],
                                          fields["cell_velocity"])
    return errors, fields


def answer_altered(model, graph, feats, gt_v, gt_p, cfg):
    """One trajectory's answer altered where it is produced: its velocity
    change 25 % off at every step."""
    forward = model.forward

    def altered(*args, **kwargs):
        out = forward(*args, **kwargs)
        scale = torch.where(graph.cell_batch == 0, 1.25, 1.0)[:, None]
        out["cell_velocity_change"] = out["cell_velocity_change"] * scale
        return out

    model.forward = altered
    try:
        return _scan()(model, graph, feats, gt_v, gt_p, cfg)
    finally:
        del model.forward


def pressure_altered(model, graph, feats, gt_v, gt_p, cfg):
    """One trajectory's pressure altered where the head produces it: 25 %
    off at every step (the velocity, fed back, is left as it is)."""
    derive = model.derive_state

    def altered(*args, **kwargs):
        sol = dict(derive(*args, **kwargs))
        scale = torch.where(graph.cell_batch == 0, 1.25, 1.0)[:, None]
        sol["cell_pressure"] = sol["cell_pressure"] * scale
        return sol

    model.derive_state = altered
    try:
        return _scan()(model, graph, feats, gt_v, gt_p, cfg)
    finally:
        del model.derive_state


def _run(name, rollout=None):
    spec = tiny(name)
    cell = run_cell.make_cell(spec, SEED, torch.device("cpu"))
    cell.rollout = rollout
    result, checks = run_cell.run(spec, manifest.benchmark(BENCH.parent), name,
                                  SEED, 0.0, False, torch.device("cpu"), 0.0,
                                  cell=cell)
    return result, checks


@pytest.mark.parametrize("name", ["fluxd.rollout.b8", "fvgnf.rollout.b8"])
def test_sound_run_is_correct(name):
    result, checks = _run(name)
    assert result["correct"], checks
    bench = manifest.benchmark(BENCH.parent)
    assert set(result["metrics"]) == {
        m["name"] for m in manifest.reported(bench["end_to_end"], name)}


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, answer_altered,
                                   pressure_altered])
@pytest.mark.parametrize("name", ["fluxd.rollout.b8", "fvgnf.rollout.b8"])
def test_fault_is_not_correct(name, fault):
    result, checks = _run(name, fault)
    assert not result["correct"], checks
    assert result["failed"] > 0


@pytest.mark.parametrize("name", ["fluxd.rollout.b8", "fvgnf.rollout.b8"])
def test_control_fails_a_limit(name):
    """The fp8 control, on three seeds, reads above a limit in each."""
    spec = tiny(name, dtype="bfloat16")
    limits = spec["workload"]["check"]["limits"]
    for seed in (11, 2 ** 31 + 3, 2 ** 40 + 9):
        r = control.seed_readings(spec, seed, torch.device("cpu"), "fp8")
        assert any(r["control"][k] > limits[k] for k in limits), r["control"]


@pytest.mark.card
def test_control_on_the_card(card):
    """The control at the cell's own size (``perfbench/control.py`` on the
    card): each seed's control reads above a limit."""
    spec = manifest.cell("fluxd.rollout.b8")
    limits = spec["workload"]["check"]["limits"]
    r = control.seed_readings(spec, 5, card, "fp8")
    assert any(r["control"][k] > limits[k] for k in limits)
    assert all(r["program"][k] <= limits[k] for k in limits)
