"""Moving-least-squares gradient weights (a copy of the JAX package's
``ops/mls.py``, host-side numpy float64; reference ``src/utils/maths.py:
23-240``).

Per stencil center (cell or face), the 2 * T nearest other centers
(T = the number of monomials up to ``poly_order``), inverse-squared-distance
weighting, a 1e-10 Tikhonov term, and the gradient of the fitted polynomial
at the center: the weights reproduce the exact gradient of any polynomial up
to ``poly_order``. The rollout's divergence metric and MgnB's continuity
loss read them (:func:`~gnn_fluid_dynamics_tpu_torch.ops.fvm.divergence_from_uc`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gnn_fluid_dynamics_tpu_torch.ops.geometry import knn


def num_polynomial_terms(poly_order: int) -> int:
    return ((poly_order + 1) * (poly_order + 2)) // 2


def polynomial_basis(rel_pos: np.ndarray, poly_order: int) -> np.ndarray:
    """Monomial basis [1, x, y, x^2, xy, y^2, ...] up to ``poly_order`` in
    the reference's column order (``maths.py:164-240``).
    rel_pos: (..., 2) -> (..., num_terms)."""
    x, y = rel_pos[..., 0], rel_pos[..., 1]
    cols = []
    for order in range(poly_order + 1):
        for j in range(order + 1):  # x^(order-j) * y^j
            cols.append(x ** (order - j) * y ** j)
    return np.stack(cols, axis=-1)


def compute_mls_weights(pos: np.ndarray, poly_order: int,
                        mask: np.ndarray = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(neighbours (N, K) int64, weights (N, K, 2) float32) for all stencil
    centers, K = 2 * num_terms (``maths.py:57-58``); one batched float64
    solve replaces the reference's per-cell loop (``maths.py:115-160``)."""
    n_terms = num_polynomial_terms(poly_order)
    neighbours, distances = knn(pos, 2 * n_terms, mask=mask)
    pos64 = np.asarray(pos, np.float64)
    rel = pos64[neighbours] - pos64[:, None, :]        # (N, K, 2)

    w = 1.0 / (distances + 1e-10) ** 2
    w = w / np.sum(w, axis=1, keepdims=True)           # (N, K)
    P = polynomial_basis(rel, poly_order)              # (N, K, T)
    PW = P * w[..., None]
    A = np.einsum("nkt,nks->nts", P, PW)               # (N, T, T)
    A += 1e-10 * np.eye(n_terms)[None]
    # gradient of the basis at the origin: d/dx -> term 1 (x), d/dy -> term 2
    grad_basis = np.zeros((n_terms, 2))
    grad_basis[1, 0] = 1.0
    grad_basis[2, 1] = 1.0
    X = np.linalg.solve(A, np.broadcast_to(grad_basis, (A.shape[0],) +
                                           grad_basis.shape))  # (N, T, 2)
    weights = np.einsum("nkt,ntd->nkd", PW, X)         # (N, K, 2)
    return neighbours, weights.astype(np.float32)
