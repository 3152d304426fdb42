"""Declarative normalization (counterpart of ``models/normalizer.py``).

Each field spec names a statistics key, a tensor in the feature bundle, a
column slice and a scheme: ``z_score``, ``mean_scale``, ``std_scale``,
``min_max`` and ``max_scale`` (reference ``normalisation.py:281-322``).
Statistics accumulate as the reference's masked batch Welford + min/max
(``normalisation.py:80-181``), with its derived characteristic pressure
(``normalisation.py:183-197``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

EPS = 1e-8
MIN_STD = 1e-8


def z_score(data, stats, inverse=False):
    std = torch.clamp(stats["std"], min=MIN_STD)
    if not inverse:
        return (data - stats["mean"]) / (std + EPS)
    return data * (std + EPS) + stats["mean"]


def mean_scale(data, stats, inverse=False):
    if not inverse:
        return data / (stats["mean"] + EPS)
    return data * (stats["mean"] + EPS)


def std_scale(data, stats, inverse=False):
    if not inverse:
        return data / (stats["std"] + EPS)
    return data * (stats["std"] + EPS)


def min_max(data, stats, inverse=False):
    rng = stats["max"] - stats["min"]
    if not inverse:
        return (data - stats["min"]) / (rng + EPS)
    return data * (rng + EPS) + stats["min"]


def max_scale(data, stats, inverse=False):
    if not inverse:
        return data / (stats["max"] + EPS)
    return data * (stats["max"] + EPS)


SCHEMES: Dict[str, Callable] = {
    "z_score": z_score,
    "mean_scale": mean_scale,
    "std_scale": std_scale,
    "min_max": min_max,
    "max_scale": max_scale,
}


@dataclasses.dataclass(frozen=True)
class Field:
    """One normalized field: columns [start, stop) of bundle[tensor], using the
    statistics under ``stat_key``."""
    name: str
    tensor: str
    start: int
    stop: int
    stat_key: str


@dataclasses.dataclass(frozen=True)
class StatSpec:
    """How to gather statistics for one stat key: ``extractor`` is the
    (tensor, start, stop) slice of the feature bundle; ("norm", tensor,
    start, stop) for the row-wise L2 norm of a slice (MgnC's
    ``cell_velocity_char``); ("sqrt", ...) for its square root (FvgnE's
    ``characteristic_length``); ("slice0", ...) for the slice of the first
    bundled step only (FvgnC's face targets); or None for a derived
    statistic (FvgnE's ``characteristic_pressure``)."""
    scheme: str
    extractor: Optional[Tuple] = None


@dataclasses.dataclass(frozen=True)
class NormalizationMap:
    """registry: stat_key -> StatSpec; inputs/outputs: ordered Field lists."""
    registry: Dict[str, StatSpec]
    inputs: Tuple[Field, ...]
    outputs: Tuple[Field, ...]

    def replace(self, **kw) -> "NormalizationMap":
        return dataclasses.replace(self, **kw)


def _apply_fields(bundle, fields, registry, stats, inverse):
    # each tensor is rebuilt by concatenating its transformed and untouched
    # column segments (the fields of one tensor never overlap here)
    out = dict(bundle)
    by_tensor: Dict[str, list] = {}
    for f in fields:
        if out.get(f.tensor) is not None:
            by_tensor.setdefault(f.tensor, []).append(f)
    for tensor, fs in by_tensor.items():
        x = out[tensor]
        parts, pos = [], 0
        for f in sorted(fs, key=lambda f: f.start):
            if f.start < pos:
                raise ValueError(f"overlapping fields on {tensor}")
            if f.start > pos:
                parts.append(x[..., pos:f.start])
            scheme = SCHEMES[registry[f.stat_key].scheme]
            parts.append(scheme(x[..., f.start:f.stop], stats[f.stat_key],
                                inverse))
            pos = f.stop
        if pos < x.shape[-1]:
            parts.append(x[..., pos:])
        out[tensor] = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return out


def normalize_inputs(bundle, nmap: NormalizationMap, stats, inverse=False):
    """Reference ``CustomNormalizer.input`` (normalisation.py:255-264)."""
    return _apply_fields(bundle, nmap.inputs, nmap.registry, stats, inverse)


def normalize_outputs(bundle, nmap: NormalizationMap, stats, inverse=False):
    """Reference ``CustomNormalizer.output`` (normalisation.py:266-278)."""
    return _apply_fields(bundle, nmap.outputs, nmap.registry, stats, inverse)


class StatsAccumulator:
    """Streaming masked Welford + min/max per stat key (reference
    ``CustomAccumulator``, normalisation.py:10-205). Accumulates in float64
    on the host."""

    def __init__(self, nmap: NormalizationMap):
        self.nmap = nmap
        self.state: Dict[str, Dict[str, float]] = {}

    @staticmethod
    def _extract(bundle, spec: StatSpec):
        """(data, the bundle tensor it comes from), or (None, None) for a
        derived statistic (reference ``CustomAccumulator``'s extractors)."""
        ex = spec.extractor
        if ex is None:
            return None, None
        if ex[0] in ("norm", "sqrt", "slice0"):
            kind, tensor, start, stop = ex
            x = bundle[tensor]
            if kind == "norm":
                data = torch.linalg.vector_norm(x[..., start:stop], dim=-1)
            elif kind == "sqrt":
                data = torch.sqrt(x[..., start:stop])
            else:
                data = x[:, 0, start:stop]
        else:
            tensor, start, stop = ex
            data = bundle[tensor][..., start:stop]
        return data, tensor

    def update(self, bundle: Dict[str, torch.Tensor],
               masks: Dict[str, torch.Tensor]):
        """``masks`` maps tensor key -> (N,) bool validity mask."""
        for key, spec in self.nmap.registry.items():
            data, tensor = self._extract(bundle, spec)
            if data is None:
                continue
            data = data.detach().double().cpu().numpy()
            mask = masks.get(tensor)
            if mask is not None:
                data = data[mask.cpu().numpy().astype(bool)]
            flat = data.reshape(-1)
            if flat.size == 0:
                continue
            st = self.state.setdefault(key, {
                "mean": 0.0, "M2": 0.0, "count": 0,
                "min": float("inf"), "max": float("-inf")})
            st["min"] = min(st["min"], float(flat.min()))
            st["max"] = max(st["max"], float(flat.max()))
            n_b = flat.size
            mean_b = float(flat.mean())
            m2_b = float(((flat - mean_b) ** 2).sum())
            n_old = st["count"]
            n_new = n_old + n_b
            delta = mean_b - st["mean"]
            st["mean"] += delta * n_b / n_new
            st["M2"] += m2_b + delta ** 2 * n_old * n_b / n_new
            st["count"] = n_new

    def finalize(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for key, st in self.state.items():
            if st["count"] > 1:
                std = float(np.sqrt(max(st["M2"] / (st["count"] - 1), 1e-16)))
            else:
                std = 1e-4
            out[key] = {"mean": st["mean"], "std": std,
                        "min": st["min"], "max": st["max"]}
        # derived: the characteristic pressure v_max^2 / 2 (reference
        # normalisation.py:183-197)
        needs_char_p = any(f.stat_key == "characteristic_pressure"
                           for f in self.nmap.inputs + self.nmap.outputs)
        if needs_char_p and "characteristic_velocity" in out:
            p_max = 0.5 * out["characteristic_velocity"]["max"] ** 2
            out["characteristic_pressure"] = {
                "mean": p_max / 2, "std": p_max / 4, "min": 0.0, "max": p_max}
        return out


def stats_to_tensors(stats: Dict[str, Dict[str, float]], device,
                     dtype=torch.float32):
    """Plain-dict stats -> dict of 0-d tensors on ``device``."""
    return {k: {s: torch.tensor(float(v), dtype=dtype, device=device)
                for s, v in d.items()}
            for k, d in stats.items()}


def save_stats(stats, path: str):
    """Statistics (floats or 0-d tensors) to a JSON file."""
    def tofloat(d):
        return {k: (tofloat(v) if isinstance(v, dict) else float(v))
                for k, v in d.items()}
    with open(path, "w") as f:
        json.dump(tofloat(stats), f, indent=2)


def load_stats(path: str):
    with open(path) as f:
        return json.load(f)
