"""The benchmark's frozen arithmetic: the H100's published peaks, the model
FLOPs of a configuration's step, and the least bytes and FLOPs of one GN
block application.

The per-kernel counts are those of the port's ``chip_smoke.py`` (``bounds``:
each input byte read once, each output byte written once; K1/K2's three
products on the tensor cores, K3's f32 adds), re-expressed per GN-block
application as the sum of the fused route's K3 -> K2 -> K1, the least
traffic of the block's work. The same count is charged whichever route
runs the block, so a faster route shows as a higher share.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12


def mlp_flops(rows: int, fan_in: int, hidden: int, fan_out: int) -> int:
    """Multiply-adds x 2 of Linear-Linear-Linear on ``rows`` rows."""
    return 2 * rows * (fan_in * hidden + hidden * hidden + hidden * fan_out)


def block_widths(cfg: dict) -> tuple:
    """(cell MLP fan-in, face MLP fan-in) of a GN block."""
    h, s = cfg["hidden_width"], int(cfg["step_scalar"])
    return h + h // 2 + s, 3 * h + s


def step_flops(cfg: dict, cells: int, faces: int) -> int:
    """Model FLOPs of one forward at ``cells``/``faces`` live rows: the
    encoder, ``mp_num`` GN-block applications and the face decoder (matrix
    products only)."""
    h = cfg["hidden_width"]
    cell_in, face_in = block_widths(cfg)
    enc = (mlp_flops(faces, 5 + cfg["num_face_types"], h, h)
           + mlp_flops(cells, 2, h, h))
    block = mlp_flops(cells, cell_in, h, h) + mlp_flops(faces, face_in, h, h)
    dec = mlp_flops(faces, h, h, cfg["face_out"])
    return enc + cfg["mp_num"] * block + dec


def block_bound(cfg: dict, cells: int, faces: int, vertices: int) -> dict:
    """The least time (s) of one GN-block application's work: max(bytes /
    peak bytes/s, FLOPs / bf16 peak), with the bytes and FLOPs."""
    H = cfg["hidden_width"]
    C, F, V = cells, faces, vertices
    vec = 5 * H * 2                                   # b0, b1, b2, ln_g, ln_b
    cell_in, face_in = block_widths(cfg)
    k1 = (F * H * 2 + C * H * 2 + 2 * F * 4
          + (face_in * H + 2 * H * H) * 2 + vec + F * H * 2)
    k2 = (C * H * 2 + V * (H // 2) * 2 + 3 * C * 4
          + (cell_in * H + 2 * H * H) * 2 + vec + 2 * C * H * 2)
    k3 = F * H * 2 + (V + 1) * 4 + 2 * F * 4 + V * (H // 2) * 2
    nbytes = k1 + k2 + k3
    flops = (2 * F * H * (face_in + 2 * H) + 2 * C * H * (cell_in + 2 * H)
             + 2 * F * (H // 2))
    return {"seconds": max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS),
            "bytes": nbytes, "flops": flops}
