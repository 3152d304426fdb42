"""The ``rollout`` traffic kind: a batch of trajectories rolled out by the
program's rollout entry (``rollout/engine.py::rollout_scan``), back to back,
each rollout from the trajectories' first state against the analytic flow
held on the device, with its error metrics.

Set-up is the program's own path from raw meshes: its connectivity code,
RCM order, ``MeshDataset`` (padding, batching, the int8 banded tables of the
table route), the model from its registry with the benchmark's weights and
statistics worked out by its ``StatsAccumulator``. The window counts live
cells x steps over all its rollouts; the check holds every rollout of the
window against the plain reference (``perfbench/reference``), which works
everything out again from the same raw meshes, flow and weights.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import arithmetic, meshgen
from perfbench.harness.weights import make_weights

GN_BLOCK_RANGE = "perfbench::gn_block"


def program_geometry(mesh):
    """The program's geometry of one raw mesh: its connectivity code,
    then its RCM order (what ``training/train.py`` does to each mesh)."""
    from gnn_fluid_dynamics_tpu_torch.data.node_types import NodeType
    from gnn_fluid_dynamics_tpu_torch.ops.connectivity import build_geometry
    from gnn_fluid_dynamics_tpu_torch.ops.reorder import rcm_reorder_geometry
    return rcm_reorder_geometry(build_geometry(*mesh, NodeType))


def make_meshes(traffic: dict, seed: int) -> list:
    """The cell's raw meshes: the traffic's fixed set (one a mesh seed),
    in an order drawn from ``seed``, so that every run does the same work."""
    spec = traffic["mesh"]
    generate = getattr(meshgen, spec["generator"])
    order = np.random.default_rng(abs(int(seed))).permutation(len(spec["seeds"]))
    return [generate(spec["n_points"], spec["seeds"][i]) for i in order]


class RolloutCell:
    """One run of a rollout cell: ``setup``, ``window``, ``profile``,
    ``release``, ``readings``. ``rollout`` is the program's entry the window
    drives (a test puts a broken one in its place)."""

    def __init__(self, cfg: dict, traffic: dict, check: dict, seed: int,
                 device):
        self.cfg, self.traffic, self.check, self.seed = cfg, traffic, check, seed
        self.device = torch.device(device)
        self.steps = traffic["steps"]
        self.results: List[tuple] = []
        self.rollout = None
        self.sample = sample_steps(seed, self.steps, check["sampled_steps"])
        self.keep = np.unique(np.concatenate([self.sample,
                                              self.sample[self.sample > 0] - 1]))

    # ---- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from gnn_fluid_dynamics_tpu_torch.data.pipeline import (MeshDataset,
                                                                Trajectory,
                                                                rollout_batch)
        from gnn_fluid_dynamics_tpu_torch.graph import to_static_bands
        from gnn_fluid_dynamics_tpu_torch.models.base import (ModelConfig,
                                                              feature_masks)
        from gnn_fluid_dynamics_tpu_torch.models.normalizer import StatsAccumulator
        from gnn_fluid_dynamics_tpu_torch.models.registry import get_model_class
        from gnn_fluid_dynamics_tpu_torch.rollout import engine

        tr, cfg, dev = self.traffic, self.cfg, self.device
        dt = tr["dt"]
        self.meshes = make_meshes(tr, self.seed)
        times = [tr["t0_step"] * dt, (tr["t0_step"] + 1) * dt]
        trajs = []
        for i, mesh in enumerate(self.meshes):
            geom = program_geometry(mesh)
            fields = meshgen.flow_fields(geom["cell_pos"], geom["face_pos"],
                                         geom["face_normal"], geom["face_area"],
                                         times, tr["flow"])
            trajs.append(Trajectory(mesh_id=f"mesh{i}", geom=geom,
                                    fields=fields, dt=dt))
        table = tr["route"] == "table"
        ds = MeshDataset(trajs, pad_multiple=tr["pad_multiple"],
                         with_banded=table, banded_dtype=tr.get("table_dtype", "int8"),
                         device=dev)
        graph = to_static_bands(ds.get_batch(rollout_batch(ds)),
                                derive_idx=not table)
        model = get_model_class(cfg["model"])(ModelConfig(
            name=cfg["model"], hidden_width=cfg["hidden_width"],
            mp_num=cfg["mp_num"], aggregation=cfg["aggregation"],
            num_face_types=cfg["num_face_types"],
            compute_dtype=cfg["compute_dtype"]), device=dev)
        _, feats = model.transform_rollout(graph)
        acc = StatsAccumulator(model.nmap)
        acc.update(feats, feature_masks(graph, feats))
        model.set_stats(acc.finalize())
        state = model.module.state_dict()
        self.weights = make_weights({k: tuple(v.shape) for k, v in state.items()},
                                    cfg.get("fixed", {}), self.seed, dev)
        model.module.load_state_dict(self.weights)
        self.model, self.graph, self.feats = model, graph, feats
        self.gt_v, self.gt_p = self._ground_truth(graph.cell_pos)
        self.live = {"cells": sum(m[1].shape[0] for m in self.meshes)}
        self.live["faces"] = sum(int(t.geom["face_pos"].shape[0]) for t in trajs)
        self.live["vertices"] = sum(int(m[0].shape[0]) for m in self.meshes)
        self.engine = engine
        if self.rollout is None:
            self.rollout = engine.rollout_scan
        # every shape the window uses, and the kernels' build or load
        self._rollout(tr.get("warmup_steps", 2))
        self._sync()

    def _ground_truth(self, pos: torch.Tensor):
        flow, dt, t0 = self.traffic["flow"], self.traffic["dt"], self.traffic["t0_step"]
        p_kw = {k: flow[k] for k in ("u_in", "shed_freq") if k in flow}
        vs, ps = [], []
        for i in range(self.steps):
            t = (t0 + 1 + i) * dt
            u, v = meshgen.channel_velocity(pos[:, 0], pos[:, 1], t, **flow)
            vs.append(torch.stack([u, v], 1))
            ps.append(meshgen.channel_pressure(pos[:, 0], t, **p_kw)[:, None])
        return torch.stack(vs), torch.stack(ps)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _rollout(self, steps: int):
        cfg = self.engine.RolloutConfig(num_steps=steps, compute_error=True,
                                        save_fields=True)
        return self.rollout(self.model, self.graph, self.feats,
                            self.gt_v[:steps], self.gt_p[:steps], cfg)

    # ---- the window ---------------------------------------------------------
    def window(self, seconds: float) -> Dict[str, float]:
        """Back-to-back whole rollouts until ``seconds`` have passed; the
        throughput over all of them and all the time to the closing
        synchronize. Of each rollout the errors and, at the steps the check
        samples, the fields it reads are kept."""
        self._sync()
        t0 = time.perf_counter()
        marks = []
        while True:
            errors, fields = self._rollout(self.steps)
            self.results.append((errors, self._kept(fields)))
            marks.append(time.perf_counter() - t0)
            if marks[-1] >= seconds:
                break
        self._sync()
        wall = time.perf_counter() - t0
        self.wall_per_step = wall / (len(self.results) * self.steps)
        # the host's clock at the end of each rollout's issue: how steady
        # the rate is inside the window (not a metric)
        self.marks = marks + [wall]
        return {"rollout_throughput": self.live["cells"] * self.steps
                * len(self.results) / wall / 1e6}

    def _kept(self, fields):
        """The saved fields the check reads: the cell velocity at each
        sampled step and the one before it, the pressure and the
        divergence's source (cell flux or face velocity) at each sampled
        step."""
        keep = torch.as_tensor(self.keep, device=self.device)
        sample = torch.as_tensor(self.sample, device=self.device)
        div = "cell_flux" if "cell_flux" in fields else "face_velocity"
        return {"cell_velocity": fields["cell_velocity"][keep],
                "cell_pressure": fields["cell_pressure"][sample],
                div: fields[div][sample]}

    # ---- the traced stretch -------------------------------------------------
    def profile(self, trace_path: str) -> dict:
        """Time ``trace_steps`` steps of a rollout untraced, then profile
        the same stretch with each GN block application marked as a host
        range; returns the readings the per-layer metrics take."""
        from torch.profiler import ProfilerActivity, profile, record_function
        from gnn_fluid_dynamics_tpu_torch.ops import kernels
        from perfbench.harness.trace import Trace, union_length

        steps = self.traffic["trace_steps"]
        open_ranges = []

        def pre(mod, args):
            r = record_function(GN_BLOCK_RANGE)
            r.__enter__()
            open_ranges.append(r)

        def post(mod, args, out):
            open_ranges.pop().__exit__(None, None, None)

        self._sync()
        t0 = time.perf_counter()
        self._rollout(steps)                     # the same stretch, untraced
        self._sync()
        untraced = time.perf_counter() - t0
        blocks = [m for m in self.model.module.modules()
                  if type(m).__name__ == "GNBlock"]
        handles = [h for b in blocks for h in (b.register_forward_pre_hook(pre),
                                               b.register_forward_hook(post))]
        counters = [f for f in vars(kernels).values() if hasattr(f, "launches")]
        before = sum(f.launches for f in counters)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                self._rollout(steps)
                self._sync()
                wall = time.perf_counter() - t0
            prof.export_chrome_trace(trace_path)
        finally:
            for h in handles:
                h.remove()
        ours = sum(f.launches for f in counters) - before
        tr = Trace.load(trace_path)
        live = self.live
        bound = arithmetic.block_bound(self.cfg, live["cells"], live["faces"],
                                       live["vertices"])
        gn = tr.launched_in(GN_BLOCK_RANGE)
        return {
            "steps": steps, "wall_s": wall, "untraced_wall_s": untraced,
            "busy_s": tr.busy_us() * 1e-6,
            "kernels": len(tr.kernels), "unlaunched": tr.unlaunched(),
            "port_kernels": sum(1 for k in tr.kernels if "gfd::" in k.get("name", "")),
            "port_launches": ours,
            "gn_kernels": len(gn),
            "gn_device_s": union_length(Trace.span(k) for k in gn) * 1e-6,
            "gn_bound_s": bound["seconds"] * self.cfg["mp_num"] * steps,
            "h2d_bytes": tr.h2d_bytes(),
            "step_flops": arithmetic.step_flops(self.cfg, live["cells"],
                                                live["faces"]),
            "wall_per_step": self.wall_per_step,
            "breakdown": tr.breakdown(),
        }

    # ---- the check ----------------------------------------------------------
    def release(self) -> None:
        """Free the program's state before the reference runs; keep what
        the check reads, on the host."""
        g = self.graph
        self.layout = {k: getattr(g, k).cpu().numpy() for k in (
            "cell_pos", "cell_batch", "cell_mask", "face_pos", "face_batch",
            "face_mask")}
        self.results = [({k: v.double().cpu().numpy() for k, v in e.items()},
                         {k: v.cpu() for k, v in f.items()})
                        for e, f in self.results]
        del self.model, self.graph, self.feats, self.gt_v, self.gt_p
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, control: str = None) -> List[Dict[str, np.ndarray]]:
        """For each rollout of the window, per trajectory: ``dv_gap``, the
        relative L2 gap of the sampled steps' cell velocity changes from the
        reference's steps from the same states, pooled over the steps;
        ``p_gap``, that of the cell pressure less each trajectory's mean
        (pressure is fixed up to a constant, and a trajectory's mean,
        which the seed's weights set, would scale the gap); ``dv_worst``,
        the worst single
        step's velocity-change gap (over the reference's, or its mean over
        the steps where larger); ``metric_gap``, the largest relative gap
        of the rollout's errors from the reference's errors of the
        program's own fields. With ``control`` (a precision) the reference at that
        precision takes the program's place, its error metrics in bf16:
        the control's readings."""
        from perfbench.reference import rollout as ref
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        m, feats0, stats = ref.setup(self.meshes, self.traffic, self.cfg,
                                     self.device)
        lay = self.layout
        cells = _to_reference(ref.match_rows(
            m.cell_pos.cpu().numpy(), m.cell_graph.cpu().numpy(),
            lay["cell_pos"][lay["cell_mask"]], lay["cell_batch"][lay["cell_mask"]]),
            lay["cell_mask"], m.num_cells)
        faces = _to_reference(ref.match_rows(
            m.face_pos.cpu().numpy(), ref.face_graph(m).cpu().numpy(),
            lay["face_pos"][lay["face_mask"]], lay["face_batch"][lay["face_mask"]]),
            lay["face_mask"], m.num_faces)
        w = {k: v.float() for k, v in self.weights.items()}
        ng, seg = m.num_graphs, m.cell_graph
        where = {int(t): i for i, t in enumerate(self.keep)}

        counts = torch.bincount(seg, minlength=ng).float()[:, None]

        def norms(a, b):
            """Per trajectory, (||a - b||, ||b||)."""
            return [ref.segment_sum((x ** 2).sum(1), seg, ng).sqrt().double().cpu().numpy()
                    for x in (a - b, b)]

        def centred(x):
            """``x`` less each trajectory's mean."""
            sums = x.new_zeros((ng,) + tuple(x.shape[1:])).index_add_(0, seg, x)
            return x - (sums / counts)[seg]

        out = []
        for errs, kept in self.results:
            on = {k: v.to(self.device) for k, v in kept.items()}
            gaps = {"metric_gap": np.zeros(ng)}
            parts = {"dv_gap": [], "p_gap": []}
            for j, t in enumerate(self.sample):
                v_in = None if t == 0 else cells(on["cell_velocity"][where[t - 1]])
                base = feats0["cell_x"] if v_in is None else v_in
                r = ref.step_from(m, feats0, w, stats, self.traffic, self.cfg, v_in)
                if control:
                    c = ref.step_from(m, feats0, w, stats, self.traffic, self.cfg,
                                      v_in, control)
                    v_p, p_p, div = (c["cell_velocity"], c["cell_pressure"],
                                     c["divergence"])
                    e_p = ref.errors(m, feats0, self.traffic, int(t), v_p, p_p,
                                     div, torch.bfloat16)
                else:
                    v_p = cells(on["cell_velocity"][where[t]])
                    p_p = cells(on["cell_pressure"][j])
                    if "cell_flux" in on:
                        div = ref.divergence_of(m, feats0, cell_flux=cells(on["cell_flux"][j]))
                    else:
                        div = ref.divergence_of(m, feats0, face_velocity=faces(
                            on["face_velocity"][j]))
                    e_p = {k: v[t] for k, v in errs.items()}
                e_r = ref.errors(m, feats0, self.traffic, int(t), v_p, p_p, div)
                for key, e in e_r.items():
                    g = np.abs(e_p[key] - e) / np.maximum(np.abs(e), 1e-30)
                    gaps["metric_gap"] = np.fmax(gaps["metric_gap"],
                                                 np.nan_to_num(g, nan=np.inf))
                parts["dv_gap"].append(norms(v_p - base, r["cell_velocity"] - base))
                parts["p_gap"].append(norms(centred(p_p), centred(r["cell_pressure"])))
            for key, nd in parts.items():
                num, den = (np.stack(x) for x in zip(*nd))      # (steps, graphs)
                pooled = np.sqrt((num ** 2).sum(0) / (den ** 2).sum(0))
                gaps[key] = np.nan_to_num(pooled, nan=np.inf)
            num, den = (np.stack(x) for x in zip(*parts["dv_gap"]))
            worst = num / np.maximum(den, den.mean(0, keepdims=True))
            gaps["dv_worst"] = np.nan_to_num(worst, nan=np.inf).max(0)
            out.append(gaps)
        return out


def sample_steps(seed: int, steps: int, count: int) -> np.ndarray:
    """The steps the check compares: the first, the last and ``count`` - 2
    others drawn from the seed, sorted."""
    rng = np.random.default_rng(abs(int(seed)) + 1)
    inner = rng.choice(np.arange(1, steps - 1), size=max(0, min(count, steps) - 2),
                       replace=False) if steps > 2 else np.array([], np.int64)
    return np.unique(np.concatenate([[0, steps - 1], inner]).astype(np.int64))


def _to_reference(rows: np.ndarray, mask: np.ndarray, n: int):
    """A function taking a program tensor over its padded rows to the
    reference's row order (``rows``: each live row's reference row)."""
    live = torch.from_numpy(np.nonzero(mask)[0])
    dest = torch.from_numpy(rows)

    def convert(x: torch.Tensor) -> torch.Tensor:
        out = torch.empty((n,) + tuple(x.shape[1:]), dtype=torch.float32,
                          device=x.device)
        out[dest.to(x.device)] = x[live.to(x.device)].float()
        return out
    return convert
