"""Seeded weights for a configuration, made on the device from ``--seed``
in one draw and handed to both the program and the plain reference.

Each dense matrix is normal with the std 1 / sqrt(fan-in) (LeCun, as the
configurations' init), cut at two std; biases, LayerNorm offsets and scales
are drawn around their init (0, 0 and 1) so that the comparison sees every
parameter act. Parameters the configuration fixes (FluxD's output scales)
and buffers (a BatchNorm's running statistics) take the configuration's
values."""

from __future__ import annotations

from typing import Dict

import torch


def make_weights(shapes: Dict[str, tuple], fixed: Dict[str, list], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on ``device``} for the parameter ``shapes``;
    ``fixed`` gives the value of each name it holds."""
    gen = torch.Generator(device=device)
    gen.manual_seed(abs(int(seed)) % (2 ** 63))
    drawn = sorted(n for n in shapes if n not in fixed)
    sizes = [int(torch.Size(shapes[n]).numel()) for n in drawn]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for name, part in zip(drawn, torch.split(flat, sizes)):
        x = part.reshape(shapes[name])
        if name.endswith(".weight") and len(shapes[name]) == 2:
            x = torch.clamp(x, -2.0, 2.0) / shapes[name][1] ** 0.5
        elif name.endswith("layer_norm.weight") or name.endswith("norm.weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.05 * x
        out[name] = x.contiguous()
    for name, value in fixed.items():
        out[name] = torch.tensor(value, dtype=torch.float32,
                                 device=device).reshape(shapes[name])
    return out
