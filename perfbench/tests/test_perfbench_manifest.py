"""The harness finds every configuration, traffic mix, cell and per-layer
metric by name, and ``BENCHMARK.json`` agrees with the files."""

import json
import shutil

from perfbench.harness import manifest

BENCH = manifest.BENCH_DIR
ROOT = BENCH.parent


def test_added_entries_are_found_without_an_edit(tmp_path):
    copy = tmp_path / "perfbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("out", "__pycache__"))
    before = {k: manifest.names(k, copy) for k in ("configs", "traffic",
                                                   "workloads", "metrics")}
    cfg = json.loads((copy / "configs" / "fluxd.json").read_text())
    (copy / "configs" / "fluxd_h256.json").write_text(json.dumps(
        {**cfg, "hidden_width": 256}))
    tr = json.loads((copy / "traffic" / "rollout_b8.json").read_text())
    (copy / "traffic" / "rollout_b32.json").write_text(json.dumps(
        {**tr, "mesh": {**tr["mesh"], "seeds": list(range(32))}}))
    (copy / "workloads" / "fluxd_h256.rollout.b32.json").write_text(json.dumps(
        {"config": "fluxd_h256", "traffic": "rollout_b32", "chips": 1,
         "why": "a test cell", "check": {"sampled_steps": 2,
                                         "limits": {"dv_gap": 1}}}))
    (copy / "metrics" / "steps_per_s.rollout.py").write_text(
        "def read(r):\n    return 1.0 / r['wall_per_step']\n")
    for kind, new in (("configs", "fluxd_h256"), ("traffic", "rollout_b32"),
                      ("workloads", "fluxd_h256.rollout.b32"),
                      ("metrics", "steps_per_s.rollout")):
        assert manifest.names(kind, copy) == sorted(before[kind] + [new])
    spec = manifest.cell("fluxd_h256.rollout.b32", copy)
    assert spec["config"]["hidden_width"] == 256
    assert len(spec["traffic"]["mesh"]["seeds"]) == 32
    assert manifest.reader("steps_per_s.rollout", copy)({"wall_per_step": 0.5}) == 2.0


def test_benchmark_json_agrees_with_the_files():
    bench = manifest.benchmark(ROOT)
    assert bench["paths"] == ["perfbench"]
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["name"] in manifest.names("configs")
    for w in bench["workloads"]:
        spec = manifest.cell(w["name"])["workload"]
        assert {k: spec[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}
    for m in bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))
        for w in m["workloads"]:
            e2e = [e["name"] for e in manifest.reported(bench["end_to_end"], w)]
            assert m["moves"] in e2e


def test_reported_metrics():
    ms = [{"name": "a", "workloads": ["x"]}, {"name": "b", "moves": "t"},
          {"name": "c", "moves": "u"}]
    assert [m["name"] for m in manifest.reported(ms, "x", {"t"})] == ["a", "b"]
    assert [m["name"] for m in manifest.reported(ms, "y")] == ["b", "c"]
