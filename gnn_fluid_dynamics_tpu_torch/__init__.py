"""gnn_fluid_dynamics_tpu_torch — the PyTorch/CUDA port of ``gnn_fluid_dynamics_tpu``.

The JAX package beside it is the reference: every module here mirrors the
layout of its counterpart there, and the tests hold each against it. The
port never imports JAX or the JAX package; the numpy-only modules it needs
(mesh generation, connectivity, reordering) are kept as copies.

Entry points run on the card unless the caller passes ``device="cpu"``; a
missing card raises instead of falling back. The GN-block kernels (the
counterparts of the JAX package's seven Pallas kernels) are hand-written CUDA
C++ under ``csrc/``, built with ``nvcc`` at first use
(:mod:`gnn_fluid_dynamics_tpu_torch.ops.kernels`).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, a card by its index (``"cuda"``
    is the current card, ``cuda:<i>``, the device its tensors report);
    raises when a CUDA device is asked for and no card is present (there is
    no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
