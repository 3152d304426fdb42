"""The plain reference of the benchmark's configurations: FluxD and FvgnF's
rollout step in plain PyTorch, f32, row gathers and ``index_add_``, no
kernels, no padding, no batching tricks.

It follows the published description the port follows (FVGN's
encode-process-decode with cell-first GN blocks and the "twice message
passing" edge -> vertex -> cell aggregation; FluxD's learned output scales
and physical flux integrator; FvgnF's one shared block with a step scalar
and the normalized integrator), written again from the equations, and
imports nothing of the program. The weights are the benchmark's own,
handed to both sides by their parameter names.

``precision="fp8"`` is the control: every MLP product takes its operands
rounded to float8 e4m3 (per-tensor scale, f32 accumulation), the step below
the configurations' bf16.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.harness.meshgen import INFLOW, WALL, NUM_FACE_TYPES

FP8_MAX = 448.0
STAT_FLOOR = 1e-8          # the normalizer's std floor and its epsilon


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a per-tensor scale."""
    scale = torch.clamp(x.abs().amax(), min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Mesh:
    """One or more meshes' geometry (``geometry.build_geometry``) as one
    graph of tensors on ``device``: each mesh's rows follow the previous
    one's, its indices shifted by the rows before it."""

    def __init__(self, geoms, device):
        off_c = off_f = off_v = 0
        parts: Dict[str, list] = {}
        for g in geoms:
            shift = {"owner": off_c, "neighbour": off_c, "cell_faces": off_f,
                     "sender": off_v, "receiver": off_v, "cell_vertices": off_v}
            for k, v in g.items():
                if k == "num_vertices":
                    continue
                parts.setdefault(k, []).append(
                    torch.as_tensor(v + shift.get(k, 0)))
            c, f = g["cell_pos"].shape[0], g["face_pos"].shape[0]
            parts.setdefault("cell_graph", []).append(
                torch.full((c,), len(parts["cell_graph"]), dtype=torch.long))
            off_c, off_f, off_v = off_c + c, off_f + f, off_v + g["num_vertices"]
        for k, v in parts.items():
            t = torch.cat(v).to(device)
            setattr(self, k, t.long() if not t.is_floating_point() else t.float())
        self.num_graphs = len(geoms)
        self.num_cells, self.num_faces, self.num_vertices = off_c, off_f, off_v
        self.inflow = (self.face_type == INFLOW)
        self.clamped = self.inflow | (self.face_type == WALL)


def mlp(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str,
        layer_norm: bool = True, precision: str = "f32") -> torch.Tensor:
    """Linear-SiLU-Linear-SiLU-Linear [-LayerNorm], the parameters under
    ``name``."""
    q = _fp8 if precision == "fp8" else (lambda t: t)
    h = x
    for i in range(3):
        h = F.linear(q(h), q(w[f"{name}.dense{i}.weight"]),
                     w[f"{name}.dense{i}.bias"])
        if i < 2:
            h = F.silu(h)
    if layer_norm:
        h = F.layer_norm(h, (h.shape[-1],), w[f"{name}.layer_norm.weight"],
                         w[f"{name}.layer_norm.bias"], eps=1e-5)
    return h


def twice_message_passing(edge: torch.Tensor, m: Mesh) -> torch.Tensor:
    """Each face's first half-row summed at its sender vertex and its second
    half-row at its receiver, then each cell's mean of its 3 vertices."""
    half = edge.shape[1] // 2
    vtx = torch.zeros(m.num_vertices, half, device=edge.device)
    vtx.index_add_(0, m.sender, edge[:, :half])
    vtx.index_add_(0, m.receiver, edge[:, half:])
    return vtx[m.cell_vertices].sum(1) / 3.0


def processor(cell, edge, m: Mesh, w, cfg: dict, precision: str):
    """The GN blocks, cell-first: the cell MLP on [cell | aggregated edges],
    then the face MLP on [edge | new cell at owner | new cell at
    neighbour], each block adding its two outputs to its inputs."""
    n = cfg["mp_num"]
    for i in range(n):
        name = "epd.blocks.%d" % (0 if cfg["share_blocks"] else i)
        extra_c, extra_f = [], []
        if cfg["step_scalar"]:
            s = (i + 1) / n
            extra_c = [torch.full((cell.shape[0], 1), s, device=cell.device)]
            extra_f = [torch.full((edge.shape[0], 1), s, device=cell.device)]
        new_cell = mlp(torch.cat([cell, twice_message_passing(edge, m)]
                                 + extra_c, 1), w, name + ".cell_block.mlp",
                       precision=precision)
        new_edge = mlp(torch.cat([edge, new_cell[m.owner], new_cell[m.neighbour]]
                                 + extra_f, 1), w, name + ".face_block.mlp",
                       precision=precision)
        cell, edge = cell + new_cell, edge + new_edge
    return cell, edge


def z_score(x, st, inverse=False):
    std = max(st["std"], STAT_FLOOR)
    return x * (std + STAT_FLOOR) + st["mean"] if inverse else (
        (x - st["mean"]) / (std + STAT_FLOOR))


# the z-scored input columns: (feature, column, statistic)
INPUT_STATS = (("cell_x", 0, "cell_velocity_x"), ("cell_x", 1, "cell_velocity_y"),
               ("face_x", 0, "face_velocity_difference_x"),
               ("face_x", 1, "face_velocity_difference_y"),
               ("face_x", 2, "face_edge_vector_x"),
               ("face_x", 3, "face_edge_vector_y"), ("face_x", 4, "face_area"))


def statistics(feats: Dict[str, torch.Tensor], model: str) -> Dict[str, dict]:
    """Mean and std (f64, one degree of freedom removed) of each normalized
    quantity over all rows of the features."""
    cols = {"cell_velocity_x": ("cell_x", 0), "cell_velocity_y": ("cell_x", 1),
            "cell_velocity_change_x": ("cell_y", 0),
            "cell_velocity_change_y": ("cell_y", 1),
            "face_velocity_difference_x": ("face_x", 0),
            "face_velocity_difference_y": ("face_x", 1),
            "face_edge_vector_x": ("face_x", 2), "face_edge_vector_y": ("face_x", 3),
            "face_area": ("face_x", 4), "face_velocity_x": ("face_y", 0),
            "face_velocity_y": ("face_y", 1), "face_pressure": ("face_y", 2)}
    if model == "FluxD":
        cols["face_flux"] = ("face_y", 3)
    out = {}
    for key, (t, c) in cols.items():
        x = feats[t][:, c].double()
        out[key] = {"mean": float(x.mean()), "std": float(x.std())}
    return out


def initial_features(m: Mesh, fields: Dict[str, torch.Tensor], model: str):
    """Features from a window of states (each field (W, N, D)): the cell
    velocity at its first state, the change over its last step, the face
    inputs [dv | cell-pair vector | area | one-hot type] and the targets at
    its last state. FvgnF takes the INFLOW faces' dv from the first face
    velocity; FluxD does not, and its targets carry the face flux."""
    v0 = fields["cell_velocity"][0]
    dv = v0[m.owner] - v0[m.neighbour]
    if model != "FluxD":
        dv = torch.where(m.inflow[:, None], fields["face_velocity"][0], dv)
    onehot = F.one_hot(m.face_type, NUM_FACE_TYPES).float()
    face_x = torch.cat([dv, m.cell_pos[m.owner] - m.cell_pos[m.neighbour],
                        m.face_area[:, None], onehot], 1)
    face_y = [fields["face_velocity"][-1], fields["face_pressure"][-1]]
    if model == "FluxD":
        face_y.append(fields["face_flux"][-1])
    return {"cell_x": v0,
            "cell_y": fields["cell_velocity"][-1] - fields["cell_velocity"][-2],
            "face_x": face_x, "face_y": torch.cat(face_y, 1)}


def _gather3(x, m):
    return x[m.cell_faces]                                    # (C, 3, D)


def decode(m: Mesh, feats, w, stats, cfg: dict, precision: str = "f32"):
    """Normalized inputs -> encoder -> GN blocks -> face decoder: the raw
    face outputs."""
    cell_x = feats["cell_x"].clone()
    face_x = feats["face_x"].clone()
    for t, c, key in INPUT_STATS:
        x = cell_x if t == "cell_x" else face_x
        x[:, c] = z_score(x[:, c], stats[key])
    cell = mlp(cell_x, w, "epd.encoder.cell_mlp", precision=precision)
    edge = mlp(face_x, w, "epd.encoder.face_mlp", precision=precision)
    cell, edge = processor(cell, edge, m, w, cfg, precision)
    return mlp(edge, w, "epd.decoder_face", layer_norm=False, precision=precision)


def step(m: Mesh, feats, w, stats, cfg: dict, dt: float,
         precision: str = "f32") -> Dict[str, torch.Tensor]:
    """One rollout step: the new cell velocity and pressure and the
    divergence the step's outputs give per cell."""
    raw = decode(m, feats, w, stats, cfg, precision)
    if cfg["model"] == "FluxD":
        return _fluxd_head(raw, m, feats, w, dt)
    return _fvgnf_head(raw, m, feats, w, stats, dt)


def fluxd_module(raw, m, w, dt):
    """FluxD's learned output scales, then the physical flux balance
    dt/V (-sum (u phi_signed) - sum p n A + nu sum D) per cell: (the cell
    acceleration (C, 2), the scaled face outputs (F, 6))."""
    scale = torch.cat([w["velocity_scale_x.scale"], w["velocity_scale_y.scale"],
                       w["pressure_scale.scale"], w["flux_scale.scale"],
                       w["diffusion_scale.scale"]])
    out = raw * scale
    uv, p, phi, d = out[:, 0:2], out[:, 2:3], out[:, 3:4], out[:, 4:6]
    signed = _gather3(phi, m) * m.cell_sign[..., None]         # (C, 3, 1)
    phi_a = torch.sum(_gather3(uv, m) * signed, 1)
    phi_p = torch.sum(_gather3(p, m) * m.cell_normal
                      * _gather3(m.face_area[:, None], m), 1)
    phi_d = torch.sum(_gather3(d, m), 1)
    acc = dt / torch.clamp(m.cell_volume[:, None], min=1e-12) * (
        -phi_a - phi_p + 1e-3 * phi_d)
    return acc, out


def _fluxd_head(raw, m, feats, w, dt):
    acc, out = fluxd_module(raw, m, w, dt)
    return {"cell_velocity": feats["cell_x"] + acc,
            "cell_pressure": _gather3(out[:, 2:3], m).mean(1),
            "divergence": (_gather3(out[:, 3:4], m)[..., 0] * m.cell_sign).sum(
                1, keepdim=True)}


def _fvgnf_head(raw, m, feats, w, stats, dt):
    """FvgnF: the normalized flux balance with the batch-normalized face
    area A dt / mean adjacent volume, mapped back to physical units by the
    output statistics."""
    v_avg = torch.clamp(0.5 * (m.cell_volume[m.owner] + m.cell_volume[m.neighbour]),
                        min=1e-12)
    bn = "integrator.face_area_norm.masked_batch_norm.batch_norm."
    e = ((m.face_area * dt / v_avg)[:, None] - w[bn + "running_mean"]) * (
        torch.rsqrt(w[bn + "running_var"] + 1e-5) * w[bn + "weight"]) + w[bn + "bias"]
    uv, p, d = raw[:, 0:2], raw[:, 2:3], raw[:, 3:5]
    uu = torch.stack([uv[:, 0:1] * uv, uv[:, 1:2] * uv], 1)   # (F, 2, 2)
    n = m.cell_normal
    eg = _gather3(e, m)
    phi_a = torch.sum(torch.einsum("cfkd,cfd->cfk", _gather3(uu, m), n) * eg, 1)
    phi_p = torch.sum(_gather3(p, m) * n * eg, 1)
    phi_d = torch.sum(_gather3(d, m), 1)
    acc = -phi_a - phi_p + phi_d
    dvel = torch.stack([z_score(acc[:, 0], stats["cell_velocity_change_x"], True),
                        z_score(acc[:, 1], stats["cell_velocity_change_y"], True)], 1)
    uf = torch.stack([z_score(uv[:, 0], stats["face_velocity_x"], True),
                      z_score(uv[:, 1], stats["face_velocity_y"], True)], 1)
    pf = z_score(p, stats["face_pressure"], True)
    uf = torch.where(m.inflow[:, None], feats["face_y"][:, 0:2], uf)
    div = torch.sum(_gather3(uf, m) * n * _gather3(m.face_area[:, None], m),
                    dim=(1, 2))[:, None]
    return {"cell_velocity": feats["cell_x"] + dvel,
            "cell_pressure": _gather3(pf, m).mean(1), "divergence": div}


def feedback(out, feats, m: Mesh):
    """The next step's features: the new cell velocity, and the face dv
    recomputed from it with the INFLOW and WALL faces held at the initial
    targets' face velocity."""
    v = out["cell_velocity"]
    dv = torch.where(m.clamped[:, None], feats["face_y"][:, 0:2],
                     v[m.owner] - v[m.neighbour])
    return {**feats, "cell_x": v,
            "face_x": torch.cat([dv, feats["face_x"][:, 2:]], 1)}
