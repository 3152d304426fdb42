"""Autoregressive rollout (counterpart of ``rollout/engine.py``).

The JAX package compiles the whole rollout into one ``lax.scan``; here it is a
Python loop over steps under ``torch.inference_mode``: forward -> state
derivation -> error metrics -> feature feedback. Error metrics match the
reference's ``_error_accumulate`` (rollout.py:121-148): per-graph relative
MSE of cell velocity and pressure against ground truth, and the divergence of
the predicted cell flux, face velocity or (by the MLS stencil) cell
velocity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from gnn_fluid_dynamics_tpu_torch.models.losses import (mse_per_graph,
                                                        rel_mse_per_graph)
from gnn_fluid_dynamics_tpu_torch.models.transforms import interior_face_mask
from gnn_fluid_dynamics_tpu_torch.ops import fvm

SAVABLE_FIELDS = ("cell_velocity", "cell_pressure", "cell_flux",
                  "face_velocity", "face_pressure", "face_flux")


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    """Rollout section of the experiment config (reference config.py:92-113)."""
    num_steps: int = 50
    compute_error: bool = True
    save_fields: bool = False      # keep every step's predicted fields


def _divergence_metric(solutions: Dict, feats: Dict, graph) -> torch.Tensor:
    """The divergence estimate the outputs allow (reference
    rollout.py:133-148): of the predicted signed cell flux (FluxD); else of
    the predicted face velocity with the INFLOW faces clamped to their BC
    targets (FvgnA/FvgnF); else, where the graph carries MLS cell weights,
    of the predicted cell velocity (MGN); else zero."""
    if "cell_flux" in solutions:
        div = fvm.divergence_from_cell_flux(solutions["cell_flux"])
    elif "face_velocity" in solutions:
        bc = ~interior_face_mask(graph.face_type)
        uf = torch.where(bc[:, None], feats["face_y"][:, 0:2],
                         solutions["face_velocity"])
        div = fvm.divergence_from_uf(uf, graph.cell_normal, graph.face_area,
                                     graph.face_index)
    elif "cell_velocity" in solutions and graph.cell_grad_weights is not None:
        div = fvm.divergence_from_uc(solutions["cell_velocity"],
                                     graph.cell_grad_weights,
                                     graph.cell_grad_neighbours,
                                     graph.cell_volume)
    else:
        div = torch.zeros_like(graph.cell_volume)
    return torch.where(graph.cell_mask[:, None], div, torch.zeros_like(div))


def rollout_scan(model, graph, feats0: Dict[str, torch.Tensor],
                 gt_cell_velocity: Optional[torch.Tensor] = None,
                 gt_cell_pressure: Optional[torch.Tensor] = None,
                 config: RolloutConfig = RolloutConfig(),
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Run ``config.num_steps`` autoregressive steps of ``model`` on its
    device.

    Args:
        model: a FluidModel.
        graph: the MeshGraph at t0, on the model's device.
        feats0: features from ``model.transform_rollout(graph)``.
        gt_cell_velocity: (T, C, 2) ground truth, row ``i`` the target of step
            ``i``; required when ``config.compute_error``.
        gt_cell_pressure: (T, C, 1) likewise.

    Returns:
        (errors, fields): errors holds ``velocity_error``/``pressure_error``/
        ``divergence_error`` of shape (T, num_graphs); fields holds the
        stacked per-step fields when ``save_fields``, and always
        ``final_cell_state``.
    """
    if graph.device != model.device:
        raise ValueError(f"graph is on {graph.device}, model on {model.device}")
    n = max(config.num_steps, 1)
    compute_error = config.compute_error and gt_cell_velocity is not None
    if compute_error and gt_cell_velocity.shape[0] < n:
        raise ValueError(f"ground truth has {gt_cell_velocity.shape[0]} steps, "
                         f"the rollout {n}")
    num_graphs = graph.num_graphs
    ys: Dict[str, list] = {}
    feats = feats0
    with torch.inference_mode():
        for i in range(n):
            outputs = model.forward(graph, feats)
            sol = model.derive_state(outputs, feats, graph)
            if compute_error:
                # the ground truth is the TARGET: it is the denominator
                ys.setdefault("velocity_error", []).append(rel_mse_per_graph(
                    sol["cell_velocity"], gt_cell_velocity[i], graph.cell_mask,
                    graph.cell_batch, num_graphs))
                ys.setdefault("pressure_error", []).append(rel_mse_per_graph(
                    sol["cell_pressure"], gt_cell_pressure[i], graph.cell_mask,
                    graph.cell_batch, num_graphs))
                div = _divergence_metric(sol, feats, graph)
                ys.setdefault("divergence_error", []).append(mse_per_graph(
                    div, torch.zeros_like(div), graph.cell_mask,
                    graph.cell_batch, num_graphs))
            if config.save_fields:
                for key in SAVABLE_FIELDS:
                    if key in sol:
                        ys.setdefault(key, []).append(sol[key])
            feats = model.update_features(sol, feats, graph)
    stacked = {k: torch.stack(v) for k, v in ys.items()}
    errors = {k: v for k, v in stacked.items() if k not in SAVABLE_FIELDS}
    fields = {k: v for k, v in stacked.items() if k in SAVABLE_FIELDS}
    fields["final_cell_state"] = feats["cell_x"]
    return errors, fields


def error_summary(errors: Dict[str, torch.Tensor], sim_ids=None
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Scalar stats + per-trajectory evolution arrays (reference
    ``_error_save``, rollout.py:167-223): each error's ``evo_all`` (the mean
    over the graphs per step) and, given the graphs' ``sim_ids``, one
    ``evo_<id>`` per graph."""
    host = {name: arr.detach().cpu().numpy() for name, arr in errors.items()}
    out_scalar, out_evo = {}, {}
    for name, a in host.items():                  # (T, B)
        sim_means = a.mean(axis=0)
        sim_vars = a.var(axis=1)
        out_scalar[name] = {
            "mean_all": float(a.mean()),
            "max_all": float(a.max()),
            "variance_mean_all": float(sim_means.var()),
            "mean_variance_all": float(sim_vars.mean()),
        }
        evo = {"evo_all": a.mean(axis=1).tolist()}
        if sim_ids is not None:
            for i, sid in enumerate(sim_ids):
                evo[f"evo_{sid}"] = a[:, i].tolist()
        out_evo[name] = evo
    if "velocity_error" in host and "pressure_error" in host:
        out_scalar["total_mean_error"] = float(
            (host["velocity_error"] + host["pressure_error"]).mean())
    return out_scalar, out_evo
