"""SE(3) pose solvers: weighted Horn/Umeyama and Mahalanobis Gauss-Newton.

Equivalent of the reference's host-side pose solve (SURVEY.md
§2.1 item 8, §3.4; BASELINE.json:5 "SE(3) pose solve via weighted
Horn/Mahalanobis alignment"). Both consume O(1)-sized reduced statistics
(4x4 cross-moments / 6x6 normal equations) produced by the sharded E-step,
so the solve itself is replicated and negligible.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hgmm.models.se3 import Pose, se3_exp


def solve_horn(horn: jax.Array, min_weight: float = 1e-9) -> Pose:
    """Weighted Horn/Umeyama rigid solve from the [4, 4] cross-moment matrix
    horn = P^T Q, P = [x | 1], Q = [w*nu | w] (hgmm.ops.em_ref.RegStats).

    H = sum_i w_i (x_i - xbar)(nu_i - nubar)^T ; SVD H = U D V^T ;
    R = V diag(1, 1, det(V U^T)) U^T ; t = nubar - R xbar.
    """
    Sw = jnp.maximum(horn[3, 3], min_weight)
    Sx = horn[0:3, 3]
    Snu = horn[3, 0:3]
    Sxnu = horn[0:3, 0:3]
    xbar = Sx / Sw
    nubar = Snu / Sw
    H = Sxnu - jnp.outer(Sx, Snu) / Sw
    U, _, Vt = jnp.linalg.svd(H)
    V = Vt.T
    d = jnp.sign(jnp.linalg.det(V @ U.T))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], dtype=H.dtype).at[2].set(d))
    R = V @ D @ U.T
    t = nubar - R @ xbar
    return Pose(R, t)


def solve_wls_increment(
    A: jax.Array,
    b: jax.Array,
    damping: float = 1e-6,
    marquardt: float = 1e-2,
    max_rot: float = 0.3,
) -> jax.Array:
    """Solve the Mahalanobis Gauss-Newton normal equations for the se(3)
    twist increment xi.

    Robustness (anisotropic scenes): plane-dominated mixtures make A nearly
    singular along the planes, and the raw GN step overshoots those weak
    directions far beyond the association basin (observed as odometry
    divergence on ground-plane-heavy LiDAR scenes). Marquardt damping
    (lambda * diag A) shrinks each direction's step relative to its own
    curvature, and the rotation-norm trust region caps the remaining
    worst case; both vanish as the solve converges (b -> 0)."""
    diag = jnp.diagonal(A)
    lm = marquardt * jnp.diag(jnp.maximum(diag, 1e-12 * jnp.sum(diag)))
    A = A + lm + damping * jnp.eye(6, dtype=A.dtype) * jnp.maximum(
        jnp.trace(A) / 6.0, 1.0
    )
    xi = jnp.linalg.solve(A, b)
    rot = jnp.linalg.norm(xi[:3])
    scale = jnp.minimum(1.0, max_rot / jnp.maximum(rot, 1e-12))
    return xi * scale


def apply_wls_increment(pose: Pose, xi: jax.Array) -> Pose:
    """Left-compose the increment: T <- exp(xi^) * T."""
    return se3_exp(xi).compose(pose)


def weighted_umeyama(
    x: jax.Array, y: jax.Array, w: jax.Array | None = None
) -> Pose:
    """Direct weighted rigid alignment of paired clouds (test/baseline path:
    the 'trusted slow implementation' of BASELINE.md)."""
    if w is None:
        w = jnp.ones(x.shape[0], dtype=x.dtype)
    P = jnp.concatenate([x, jnp.ones_like(x[:, :1])], axis=1)
    Q = jnp.concatenate([y * w[:, None], w[:, None]], axis=1)
    return solve_horn(P.T @ Q)
