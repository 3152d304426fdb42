"""Losses and rollout error metrics (counterpart of ``models/losses.py``),
masked for padding: the training losses over valid elements, the error
metrics pooled per graph. Padded rows are where-selected, never multiplied,
so an inf or NaN there reaches neither a training loss nor its gradient.

On a space-sharded graph (``parallel/spmd.py``) the masks mark the rows the
rank owns, and inside ``halo.sharded`` each sum and count is summed over
the space group before it is divided, so that every rank holds the global
value (:func:`~gnn_fluid_dynamics_tpu_torch.parallel.halo.reduce_sums`)."""

from __future__ import annotations

import torch

from gnn_fluid_dynamics_tpu_torch.ops.segment import segment_sum
from gnn_fluid_dynamics_tpu_torch.parallel.halo import reduce_sums


def _masked_diff(output, target, mask):
    """output - target on the rows ``mask`` selects, 0 elsewhere. Selected
    before the square (the JAX package selects after it): the same values,
    and a padded row's inf then gets a gradient of 0, not 0 x inf = NaN."""
    diff = output - target
    return torch.where(mask[:, None], diff, torch.zeros_like(diff))


def mse_per_element(output: torch.Tensor, target: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over valid elements (reference
    ``MSE_per_element_torch``, loss.py:55-60). ``mask``: (N,) bool selects
    rows; every feature column of a selected row counts toward the mean."""
    se = _masked_diff(output, target, mask) ** 2
    n = torch.sum(mask.to(se.dtype)) * se.shape[-1]
    total, n = reduce_sums(torch.sum(se), n)
    return total / torch.clamp(n, min=1.0)


def mse_per_batch(output: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Summed squared error over valid rows (reference
    ``MSE_per_batch_torch``, loss.py:62-67)."""
    return reduce_sums(torch.sum(_masked_diff(output, target, mask) ** 2))


def combined_log_loss(components: dict, weights: dict) -> torch.Tensor:
    """total = mean(log(sum_i w_i * L_i)) over the components that have a
    weight (a weight of 0 still adds its term, times 0), the reference's
    combined loss (e.g. ``Fvgn.py:202-204``)."""
    total = None
    for name, value in components.items():
        w = weights.get(name, None)
        if w is None:
            continue
        term = w * value
        total = term if total is None else total + term
    return torch.mean(torch.log(total))


def mse_per_graph(output: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor, batch: torch.Tensor,
                  num_graphs: int) -> torch.Tensor:
    """Per-graph mean of row-mean squared errors (reference ``MSE_per_graph``,
    loss.py:36-52). Returns (num_graphs,)."""
    node_mse = torch.mean((output - target) ** 2, dim=-1)
    m = mask.to(node_mse.dtype)
    node_mse = torch.where(mask, node_mse, torch.zeros_like(node_mse))
    s, n = reduce_sums(segment_sum(node_mse, batch, num_graphs),
                       segment_sum(m, batch, num_graphs))
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
    ssum_diff, ssum_gt = reduce_sums(segment_sum(diff_sq, batch, num_graphs),
                                     segment_sum(target_sq, batch, num_graphs))
    return ssum_diff / torch.clamp(ssum_gt, min=1e-12)
