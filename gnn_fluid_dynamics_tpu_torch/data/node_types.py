"""Boundary/node type taxonomies.

Mirrors the reference's per-dataset enums:
* OpenFOAM datasets use {NORMAL, WALL_BOUNDARY, INFLOW, OUTFLOW, SLIP}
  (reference ``src/datasets/OpenFoam.py:19-24``);
* the DeepMind CylinderFlow dataset uses an 8-value enum
  (reference ``src/datasets/CylinderFlow.py:19-27``).
"""

from __future__ import annotations

import enum


class NodeType(enum.IntEnum):
    """OpenFOAM-style boundary classes (the default taxonomy)."""
    NORMAL = 0
    WALL_BOUNDARY = 1
    WALL = 1  # alias
    INFLOW = 2
    OUTFLOW = 3
    SLIP = 4

    @classmethod
    def num_types(cls) -> int:
        return 5


class CylinderNodeType(enum.IntEnum):
    """DeepMind MeshGraphNets cylinder-flow node types."""
    NORMAL = 0
    OBSTACLE = 1
    AIRFOIL = 2
    HANDLE = 3
    INFLOW = 4
    OUTFLOW = 5
    WALL_BOUNDARY = 6
    SIZE = 7
