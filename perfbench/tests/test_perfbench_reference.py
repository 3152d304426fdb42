"""The plain reference against the port's plain route on the CPU at a tiny
size, and what the benchmark's modules may import."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench.harness import manifest, run_cell

BENCH = manifest.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "gnn_fluid_dynamics_tpu"}


def tiny(name: str, dtype: str = "float32", steps: int = 6) -> dict:
    """The cell ``name`` at a CPU test's size: 2 meshes of 300 points."""
    spec = manifest.cell(name)
    spec["config"]["compute_dtype"] = dtype
    spec["traffic"].update(steps=steps, trace_steps=2)
    spec["traffic"]["mesh"].update(n_points=300, seeds=[0, 1])
    spec["workload"]["check"]["sampled_steps"] = min(steps, 4)
    return spec


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert not top_level_imports(path) & (FORBIDDEN | {
            "gnn_fluid_dynamics_tpu_torch"}), path


def test_benchmark_imports_neither_jax_nor_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" not in path.parts:
            assert not top_level_imports(path) & FORBIDDEN, path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run
    monkeypatch.setitem(sys.modules, "gnn_fluid_dynamics_tpu_torch_x", object())
    assert run.forbidden_modules() == [] or "jax" in run.forbidden_modules() \
        or "gnn_fluid_dynamics_tpu" in run.forbidden_modules()
    clean = [m for m in run.forbidden_modules()]
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.forbidden_modules()
    assert "gnn_fluid_dynamics_tpu_torch_x" not in run.forbidden_modules()
    assert set(clean) <= FORBIDDEN


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "fluxd.rollout.b8", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=BENCH.parent)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("name", ["fluxd.rollout.b8", "fvgnf.rollout.b8",
                                  "fluxd.valid.b8"])
def test_reference_matches_the_plain_route(name):
    """The f32 program on the plain route and the reference agree to f32
    rounding over a few steps (the reference derives its geometry, order,
    features and statistics itself)."""
    torch.manual_seed(0)
    spec = tiny(name)
    spec["workload"]["check"]["limits"] = {"dv_gap": 1e-3, "p_gap": 1e-3,
                                           "metric_gap": 1e-3}
    result, checks = run_cell.run(spec, manifest.benchmark(BENCH.parent), name,
                                  2 ** 33 + 5, 0.0, False, torch.device("cpu"), 0.0)
    assert result["correct"], checks
    assert result["attempted"] == 2
