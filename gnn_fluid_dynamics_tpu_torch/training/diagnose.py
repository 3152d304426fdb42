"""Per-head checkpoint diagnostics (counterpart of ``training/diagnose.py``):
the correlation and relative error of every model output against its
target, in normalized and in physical space.

Integrator models (FvgnJ/FluxD-style learned-scale heads) can silently zero
out a supervised face head when the dt/V-amplified cell-velocity-change loss
outweighs its direct supervision: the optimizer parks the head at the
constant that minimises its leverage on the momentum balance. A rollout
error of ~1.0 for a field while its one-step loss looks finite is the
signature; this tool shows each head's state in seconds.

    python -m gnn_fluid_dynamics_tpu_torch.training.diagnose \
        --config cfg.json --ckpt checkpoints/e2e/fluxd/best [--sample 5] \
        [--json] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises when there
is none. The reference has no such tool; its nearest analogue is
ModelMonitor's per-channel gradient logging (monitoring.py:8-97), which
shows a collapse only while training.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def head_report(model, graph, feats) -> dict:
    """{head: {space: {corr, rel, pred_mean, pred_std, tgt_mean, tgt_std}}}
    for every supervised output the model exposes, and its learned scalar
    parameters under ``"_scalar_params"``, by their Flax paths."""
    from gnn_fluid_dynamics_tpu_torch.weights import flax_paths

    report: dict = {}

    def add(name, space, pred, tgt, mask):
        p = _numpy(pred).astype(np.float64).reshape(mask.shape[0], -1)[mask]
        t = _numpy(tgt).astype(np.float64).reshape(mask.shape[0], -1)[mask]
        p, t = p.reshape(-1), t.reshape(-1)
        denom = float((t ** 2).sum())
        corr = (float(np.corrcoef(p, t)[0, 1])
                if p.std() > 0 and t.std() > 0 else 0.0)
        report.setdefault(name, {})[space] = {
            "corr": corr,
            "rel": float(((p - t) ** 2).sum() / denom) if denom else None,
            "pred_mean": float(p.mean()), "pred_std": float(p.std()),
            "tgt_mean": float(t.mean()), "tgt_std": float(t.std()),
        }

    cmask = _numpy(graph.cell_mask) > 0
    fmask = _numpy(graph.face_mask) > 0

    # normalized (train/valid) space: the predictions against the
    # normalized targets the training loss sees; physical (rollout) space:
    # the denormalized predictions against the raw targets
    with torch.no_grad():
        out_n = model.forward(graph, feats, mode="valid")
        out_p = model.forward(graph, feats, mode="rollout")
    nfeats = out_n["_nfeats"]

    def pairings(out, fy, cy):
        pairs = []
        if "face_velocity" in out and fy is not None and fy.shape[1] >= 2:
            pairs.append(("face_velocity_x", out["face_velocity"][:, 0],
                          fy[:, 0], fmask))
            pairs.append(("face_velocity_y", out["face_velocity"][:, 1],
                          fy[:, 1], fmask))
        if "face_pressure" in out and fy is not None and fy.shape[1] >= 3:
            pairs.append(("face_pressure", out["face_pressure"][:, 0],
                          fy[:, 2], fmask))
        if "face_flux" in out and fy is not None and fy.shape[1] >= 4:
            pairs.append(("face_flux", out["face_flux"][:, 0],
                          fy[:, 3], fmask))
        if "cell_velocity_change" in out and cy is not None:
            pairs.append(("cell_velocity_change", out["cell_velocity_change"],
                          cy[:, 0:2], cmask))
        # MGN/StreamFunc families: cell_y = [v_x, v_y, p] (Mgn.py:293,
        # StreamFunc.py:56-63)
        if "cell_velocity" in out and cy is not None and cy.shape[1] >= 2:
            pairs.append(("cell_velocity", out["cell_velocity"],
                          cy[:, 0:2], cmask))
        if "cell_pressure" in out and cy is not None and cy.shape[1] >= 3:
            pairs.append(("cell_pressure", out["cell_pressure"][:, 0],
                          cy[:, 2], cmask))
        return pairs

    for name, pred, tgt, mask in pairings(out_n, nfeats.get("face_y"),
                                          nfeats.get("cell_y")):
        add(name, "normalized", pred, tgt, mask)
    for name, pred, tgt, mask in pairings(out_p, feats.get("face_y"),
                                          feats.get("cell_y")):
        add(name, "physical", pred, tgt, mask)

    # learned scalar parameters (FvgnJ/FluxD-family scale heads), in the
    # order of the JAX package's walk of its sorted parameter tree
    paths = flax_paths(model.module)
    scalars = sorted(
        (paths[name].split("/"), float(p.detach().reshape(())))
        for name, p in model.module.named_parameters()
        if p.numel() == 1 and "scale" in paths[name])
    for parts, value in scalars:
        report.setdefault("_scalar_params", {})["/".join(parts)] = value
    return report


def print_report(report: dict, header: str) -> None:
    """The report as lines: each head and space, flagged where the
    prediction is nearly constant against a varying target; then each
    learned scalar."""
    print(header)
    scalars = report.get("_scalar_params", {})
    for name, spaces in report.items():
        if name == "_scalar_params":
            continue
        for space, r in spaces.items():
            flag = ""
            if r["tgt_std"] > 0 and r["pred_std"] < 0.05 * r["tgt_std"]:
                flag = "  << COLLAPSED (constant prediction)"
            rel = float("nan") if r["rel"] is None else r["rel"]
            print(f"  {name:24s} {space:10s} corr {r['corr']:+.3f} "
                  f"rel {rel:-8.3f} pred(m={r['pred_mean']:+.4f},"
                  f"s={r['pred_std']:.4f}) tgt(m={r['tgt_mean']:+.4f},"
                  f"s={r['tgt_std']:.4f}){flag}")
    for path, val in scalars.items():
        print(f"  scalar {path} = {val:.6g}")


def main(argv: Optional[list] = None) -> dict:
    """Probe the checkpoint ``--ckpt`` on validation sample ``--sample``;
    returns the report. The checkpoint's training config is adopted, with
    the given config's ``dataset.dpath`` (where set) and ``rollout``
    section (JAX ``training/diagnose.py:139-151``)."""
    from gnn_fluid_dynamics_tpu_torch import resolve_device
    from gnn_fluid_dynamics_tpu_torch.rollout.run import restore_model
    from gnn_fluid_dynamics_tpu_torch.training.config import load_config
    from gnn_fluid_dynamics_tpu_torch.training.train import build_datasets

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", required=True,
                        help="checkpoint dir, or dir/{latest,best}")
    parser.add_argument("--sample", type=int, default=0,
                        help="validation sample index to probe")
    parser.add_argument("--json", action="store_true",
                        help="print the full report as JSON")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    base = args.ckpt.rstrip("/")
    if base.split("/")[-1] not in ("latest", "best"):
        base += "/latest"
    model, config, meta = restore_model(base, device)
    given = load_config(args.config)
    config.dataset.dpath = given.dataset.dpath or config.dataset.dpath
    config.rollout = given.rollout

    # only the validation set is probed: the train set is not built
    _, dataset = build_datasets(config, type(model), splits=("valid",),
                                device=device)
    graph = dataset.get_item(args.sample)
    _, feats = model.transform_rollout(graph)
    report = head_report(model, graph, feats)
    if args.json:
        print(json.dumps(report, indent=2))
        return report
    print_report(report, f"checkpoint {args.ckpt} (mini_epoch "
                         f"{meta['mini_epoch']}) model {config.model.name}")
    return report


if __name__ == "__main__":
    main()
