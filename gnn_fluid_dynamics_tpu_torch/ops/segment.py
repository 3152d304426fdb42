"""Reference aggregation semantics (counterpart of ``ops/segment.py``).

These are the plain tensor versions of the rollout's message passing: the
"twice message passing" edge->vertex sum and the 3-vertex cell mean. They are
the unfused path of the model and the plain versions that the GN-block kernels
(:mod:`gnn_fluid_dynamics_tpu_torch.ops.kernels`) are held against.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum the rows of ``data`` into ``num_segments`` rows by id."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def aggregate_edges_to_vertices_scatter(
        fwd: torch.Tensor, rev: torch.Tensor, vertex_edge_index: torch.Tensor,
        num_vertices: int) -> torch.Tensor:
    """Scatter-add the forward half onto senders and the reverse half onto
    receivers (reference ``Fvgn.py:307-314``). fwd, rev: (F, H/2) -> (V, H/2)."""
    senders, receivers = vertex_edge_index[0], vertex_edge_index[1]
    out = segment_sum(fwd, senders, num_vertices)
    return out.index_add_(0, receivers, rev)


def aggregate_edges_to_vertices_sum(edge_attr: torch.Tensor,
                                    graph) -> torch.Tensor:
    """Full-width edge sum onto both endpoint vertices (the VertPot family's
    Vertex_Block, reference ``VertPot.py:212-222``): each edge row added to
    its sender's and to its receiver's row. (F, H) -> (V, H)."""
    senders, receivers = graph.vertex_edge_index[0], graph.vertex_edge_index[1]
    out = segment_sum(edge_attr, senders, graph.num_vertices)
    return out.index_add_(0, receivers, edge_attr)


def gather_vertices_to_cells(vertex_values: torch.Tensor,
                             vertex_face: torch.Tensor) -> torch.Tensor:
    """Mean of each cell's 3 vertex values (reference ``Fvgn.py:317-321``).
    vertex_values: (V, H), vertex_face: (3, C) -> (C, H)."""
    return (vertex_values[vertex_face[0]] + vertex_values[vertex_face[1]]
            + vertex_values[vertex_face[2]]) / 3.0
