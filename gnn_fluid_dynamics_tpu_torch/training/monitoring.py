"""Gradient / parameter monitoring (counterpart of
``gnn_fluid_dynamics_tpu/training/monitoring.py``; reference ``ModelMonitor``,
``src/utils/monitoring.py:8-97``): the per-output-channel gradient norms of
the face decoder's last layer, the norm of the decoder's update between two
calls, and every scalar parameter with its gradient, logged under the JAX
package's keys at the step it is given (the trainer's ``mini_epoch_count``).

The JAX package's monitor walks Flax parameter trees; this one walks the
port's module and names each parameter by its Flax path
(:func:`~gnn_fluid_dynamics_tpu_torch.weights.flax_paths`). A Flax
``Dense`` kernel is (in, out) and its norm runs over axis 0; a torch
``Linear.weight`` is (out, in), so here it runs over dim 1. The gradients
are those of the last train step before the clip: the trainer copies them
with :meth:`ModelMonitor.copy_gradients` between the backward pass and
``optimizer_step``, which clips ``.grad`` in place, in the step that closes
a mini-epoch and in no other.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from gnn_fluid_dynamics_tpu_torch.weights import flax_paths


def find_decoder(module: torch.nn.Module
                 ) -> Tuple[Optional[str], Optional[torch.nn.Module]]:
    """(name, module) of the face decoder MLP, the submodule named
    ``decoder_face``; (None, None) where the model has none (MGN,
    StreamFunc, ConservativeB, H, J, K)."""
    return next(((n, m) for n, m in module.named_modules()
                 if n.rsplit(".", 1)[-1] == "decoder_face"), (None, None))


def last_decoder_weight(module: torch.nn.Module) -> Optional[str]:
    """The torch name of the weight of the decoder's last ``Linear``
    (``dense2``), as the JAX package takes the last of its ``Dense_i`` in
    sorted order; None without a decoder."""
    prefix, decoder = find_decoder(module)
    if decoder is None:
        return None
    names = sorted(n for n, m in decoder.named_children()
                   if isinstance(m, torch.nn.Linear))
    return f"{prefix}.{names[-1]}.weight" if names else None


class ModelMonitor:
    """Stateless except for the decoder's parameters at the previous call
    (for the update norm)."""

    def __init__(self):
        self._prev_decoder = None
        self._watched = None        # (module, its watched (name, parameter)s)

    @staticmethod
    def watched(module: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
        """The parameters whose gradients the monitor reads, by torch name:
        the decoder's last layer's weight and every scalar parameter."""
        last = last_decoder_weight(module)
        return {n: p for n, p in module.named_parameters()
                if p.numel() == 1 or n == last}

    def copy_gradients(self, module: torch.nn.Module
                       ) -> Dict[str, torch.Tensor]:
        """A copy of the current ``.grad`` of each :meth:`watched` parameter
        (zeros where the loss does not reach it, as optax's gradient is),
        on the device, without a host sync: taken before the clip. The
        watched parameters are found once for each module."""
        if self._watched is None or self._watched[0] is not module:
            self._watched = (module, list(self.watched(module).items()))
        return {n: (p.grad.detach().clone() if p.grad is not None
                    else torch.zeros_like(p))
                for n, p in self._watched[1]}

    def monitor_decoder_gradients(self, module: torch.nn.Module,
                                  grads: Optional[Dict[str, torch.Tensor]],
                                  logger, step: int):
        """``gradients/face_mlp_out{i}``: the L2 norm of the last decoder
        layer's gradient for output channel ``i`` (reference
        monitoring.py:8-44). Nothing without gradients or a decoder."""
        last = last_decoder_weight(module)
        grad = grads.get(last) if grads and last else None
        if grad is None or logger is None:
            return
        norms = torch.linalg.vector_norm(grad.float(), dim=1)  # (out, in)
        for i, n in enumerate(norms.tolist()):
            logger.save_scalar(n, step, f"gradients/face_mlp_out{i}")

    def monitor_decoder_updates(self, module: torch.nn.Module, logger,
                                step: int):
        """``updates/face_mlp``: the sum over the decoder's parameters of the
        L2 norm of each one's change since the previous call (reference
        monitoring.py:46-68); the first call only records them."""
        _, decoder = find_decoder(module)
        if decoder is None:
            return
        params = [p.detach() for p in decoder.parameters()]
        if self._prev_decoder is not None and logger is not None:
            total = sum(torch.linalg.vector_norm(p.float() - q.float()).item()
                        for p, q in zip(params, self._prev_decoder))
            logger.save_scalar(total, step, "updates/face_mlp")
        self._prev_decoder = [p.clone() for p in params]

    def monitor_scalar_parameters(self, module: torch.nn.Module,
                                  grads: Optional[Dict[str, torch.Tensor]],
                                  logger, step: int):
        """``scalar_params/<flax path>`` for every parameter of one element
        (the learned scales, the 1-channel BatchNorms' scale and bias,
        FvgnK's anisotropy, ConservativeJ's diffusion scale), and
        ``..._grad`` its gradient where ``grads`` holds it (reference
        monitoring.py:70-97), in the order of their Flax paths."""
        if logger is None:
            return
        paths = flax_paths(module)
        scalars = sorted(((paths[n], n, p) for n, p in module.named_parameters()
                          if p.numel() == 1), key=lambda s: s[0])
        for path, name, p in scalars:
            logger.save_scalar(p.detach().reshape(()).item(), step,
                               f"scalar_params/{path}")
            if grads is not None and name in grads:
                logger.save_scalar(grads[name].reshape(()).item(), step,
                                   f"scalar_params/{path}_grad")
