"""Rollout error metrics (counterpart of ``models/losses.py``), masked for
padding and pooled per graph."""

from __future__ import annotations

import torch

from gnn_fluid_dynamics_tpu_torch.ops.segment import segment_sum


def mse_per_graph(output: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor, batch: torch.Tensor,
                  num_graphs: int) -> torch.Tensor:
    """Per-graph mean of row-mean squared errors (reference ``MSE_per_graph``,
    loss.py:36-52). Returns (num_graphs,)."""
    node_mse = torch.mean((output - target) ** 2, dim=-1)
    m = mask.to(node_mse.dtype)
    node_mse = torch.where(mask, node_mse, torch.zeros_like(node_mse))
    s = segment_sum(node_mse, batch, num_graphs)
    n = segment_sum(m, batch, num_graphs)
    return s / torch.clamp(n, min=1.0)


def rel_mse_per_graph(prediction: torch.Tensor, target: torch.Tensor,
                      mask: torch.Tensor, batch: torch.Tensor,
                      num_graphs: int) -> torch.Tensor:
    """Per-graph relative MSE: sum|pred-gt|^2 / sum|gt|^2 — the rollout error
    metric (reference ``RelMSE_per_graph``, loss.py:70-89). The ground truth
    must be ``target``: it is the denominator. Returns (num_graphs,)."""
    diff = prediction - target
    if diff.ndim > 1 and diff.shape[-1] > 1:
        diff_sq = torch.sum(diff ** 2, dim=-1)
        target_sq = torch.sum(target ** 2, dim=-1)
    else:
        diff_sq = diff.reshape(diff.shape[0], -1)[:, 0] ** 2
        target_sq = target.reshape(target.shape[0], -1)[:, 0] ** 2
    diff_sq = torch.where(mask, diff_sq, torch.zeros_like(diff_sq))
    target_sq = torch.where(mask, target_sq, torch.zeros_like(target_sq))
    ssum_diff = segment_sum(diff_sq, batch, num_graphs)
    ssum_gt = segment_sum(target_sq, batch, num_graphs)
    return ssum_diff / torch.clamp(ssum_gt, min=1e-12)
