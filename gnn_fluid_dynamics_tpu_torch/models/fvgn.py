"""FVGN family (counterpart of ``models/fvgn.py``): for now only what FluxA
inherits from FvgnA, its normalization map. The family's own modules come in
a later slice."""

from __future__ import annotations

from gnn_fluid_dynamics_tpu_torch.models import normalizer as norm
from gnn_fluid_dynamics_tpu_torch.models.base import FluidModel


def _z(tensor, s, e):
    return norm.StatSpec("z_score", (tensor, s, e))


def _f(name, tensor, s, e, stat_key=None):
    return norm.Field(name, tensor, s, e, stat_key or name)


class FvgnA(FluidModel):
    """Canonical FVGN (Fvgn.py:31-333): the normalization map of the family."""

    name = "FvgnA"

    def normalisation_map(self) -> norm.NormalizationMap:
        registry = {
            "cell_velocity_x": _z("cell_x", 0, 1),
            "cell_velocity_y": _z("cell_x", 1, 2),
            "cell_velocity_change_x": _z("cell_y", 0, 1),
            "cell_velocity_change_y": _z("cell_y", 1, 2),
            "face_velocity_difference_x": _z("face_x", 0, 1),
            "face_velocity_difference_y": _z("face_x", 1, 2),
            "face_edge_vector_x": _z("face_x", 2, 3),
            "face_edge_vector_y": _z("face_x", 3, 4),
            "face_area": _z("face_x", 4, 5),
            "face_velocity_x": _z("face_y", 0, 1),
            "face_velocity_y": _z("face_y", 1, 2),
            "face_pressure": _z("face_y", 2, 3),
        }
        inputs = tuple(_f(k, *registry[k].extractor) for k in registry)
        outputs = (
            _f("cell_velocity_change_x", "cell_out", 0, 1),
            _f("cell_velocity_change_y", "cell_out", 1, 2),
            _f("face_velocity_x", "face_out", 0, 1),
            _f("face_velocity_y", "face_out", 1, 2),
            _f("face_pressure", "face_out", 2, 3),
        )
        return norm.NormalizationMap(registry, inputs, outputs)
