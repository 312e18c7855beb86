"""Pure-JAX (dense) reference implementations of the fused EM contractions.

Every Pallas kernel in hgmm.ops.triton_em has its semantic twin here
(SURVEY.md §5.2: "every Pallas kernel ships with a jnp twin, tested against
each other"). These are also the implementations XLA runs on the CPU, and
`assign` and the nearest-neighbour search run as plain XLA everywhere.

Contracts (shared with the kernel path):

  em_stats(points, W, point_weights)      -> EmStats(S [K,10], loglik)
  em_stats_masked(..., parent, branch)    -> same, logits masked to the
                                             parent's child block (tree fit)
  reg_stats(x, y, W, mu, A6, b3)          -> RegStats: Horn 4x4 cross-moments
                                             + Mahalanobis 6x6 normal eqs
All reduce over points, so they are shard_map-able with a single psum
(BASELINE.json:5 "psum of sufficient statistics over the interconnect").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from hgmm.ops.gaussians import PHI_DIM, features

NEG_INF = -1e30


class EmStats(NamedTuple):
    S: jax.Array  # [K, PHI_DIM]  Gamma^T Psi  (T2 | T1 | T0 packed)
    loglik: jax.Array  # [] weighted data log-likelihood sum_i w_i log p(y_i)


class RegStats(NamedTuple):
    """Per-iteration registration statistics, all O(1)-sized (psum-able).

    horn: [4, 4] = P^T Q with P = [x | 1] (SOURCE, untransformed points),
          Q = [nu_tilde | w] where nu_tilde_i = sum_j gamma_ij mu_j and
          w_i = sum_j gamma_ij. Contains every moment weighted Umeyama needs.
    A: [6, 6], b: [6] Gauss-Newton normal equations of the Mahalanobis
       objective linearized on the se(3) twist at the current pose
       (SURVEY.md §3.4).
    loglik: [] data log-likelihood of transformed points under the mixture.
    """

    horn: jax.Array
    A: jax.Array
    b: jax.Array
    loglik: jax.Array


def _logits(points: jax.Array, W: jax.Array) -> jax.Array:
    """[N, K] log [pi_j N(y_i)] = -1/2 psi(y) @ W."""
    phi = features(points, pad=W.shape[0])
    return -0.5 * (phi @ W)


def _soft(
    logits: jax.Array, outlier_logit: jax.Array | float | None = None
) -> tuple[jax.Array, jax.Array]:
    """Row-softmax responsibilities + per-row logsumexp (log-evidence).

    With `outlier_logit` l0, an implicit uniform outlier component enters the
    normalizer: gamma_ij = exp(l_ij - lse_i) with
    lse_i = log(exp(l0) + sum_j exp(l_ij)); gamma rows then sum to < 1 and
    outlier-dominated points contribute little to the statistics
    (noisy/partial-overlap robustness, BASELINE.json config 3).
    """
    m = jnp.max(logits, axis=1, keepdims=True)
    if outlier_logit is not None:
        m = jnp.maximum(m, outlier_logit)
    # Guard fully-masked rows (all -inf): zero responsibilities, zero loglik.
    m_safe = jnp.maximum(m, NEG_INF)
    e = jnp.exp(logits - m_safe)
    s = jnp.sum(e, axis=1, keepdims=True)
    if outlier_logit is not None:
        s = s + jnp.exp(outlier_logit - m_safe)
    gamma = e / jnp.maximum(s, 1e-38)
    # Fully-masked rows (every logit at/below the mask floor) contribute
    # nothing — without this they'd softmax to uniform garbage.
    dead = m <= NEG_INF
    gamma = jnp.where(dead, 0.0, gamma)
    lse = jnp.squeeze(m_safe + jnp.log(jnp.maximum(s, 1e-38)), axis=1)
    lse = jnp.where(jnp.squeeze(dead, 1), 0.0, lse)
    return gamma, lse


def em_stats(
    points: jax.Array,
    W: jax.Array,
    point_weights: jax.Array | None = None,
    outlier_logit: jax.Array | float | None = None,
) -> EmStats:
    """Dense E-step + sufficient-statistic reduction.

    points: [N, 3]; W: [>=10, K] from pack_loglik_weights;
    point_weights: optional [N] (0 for padding rows).
    """
    logits = _logits(points, W)
    gamma, lse = _soft(logits, outlier_logit)
    if point_weights is not None:
        gamma = gamma * point_weights[:, None]
        lse = lse * point_weights
    phi = features(points)  # [N, 10]
    S = gamma.T @ phi  # [K, 10]
    return EmStats(S=S, loglik=jnp.sum(lse))


def child_mask_logits(
    logits: jax.Array, parent: jax.Array, branch: int
) -> jax.Array:
    """Mask [N, K] logits so point i sees only components
    [parent_i * branch, (parent_i + 1) * branch). Level-synchronous tree
    E-step (SURVEY.md §3.2; replaces the reference's recursive traversal)."""
    k = logits.shape[1]
    comp = jnp.arange(k, dtype=parent.dtype)[None, :]
    ok = (comp // branch) == parent[:, None]
    return jnp.where(ok, logits, NEG_INF)


def em_stats_masked(
    points: jax.Array,
    W: jax.Array,
    parent: jax.Array,
    branch: int,
    point_weights: jax.Array | None = None,
) -> EmStats:
    """em_stats with per-point restriction to the parent's child block."""
    logits = child_mask_logits(_logits(points, W), parent, branch)
    gamma, lse = _soft(logits)
    if point_weights is not None:
        gamma = gamma * point_weights[:, None]
        lse = lse * point_weights
    phi = features(points)
    return EmStats(S=gamma.T @ phi, loglik=jnp.sum(lse))


def assign(
    points: jax.Array,
    W: jax.Array,
    parent: jax.Array | None = None,
    branch: int | None = None,
) -> jax.Array:
    """Per-point argmax component (hard association), optionally restricted
    to each point's parent's child block. Output [N] int32 — the only
    O(N)-sized product of the tree build (SURVEY.md §3.2 step 2)."""
    logits = _logits(points, W)
    if parent is not None:
        assert branch is not None
        logits = child_mask_logits(logits, parent, branch)
    return jnp.argmax(logits, axis=1).astype(jnp.int32)


def top_k_mask_logits(logits: jax.Array, k: int) -> jax.Array:
    """Keep only each row's top-k logits (hierarchy pruning as masked top-k
    gating, BASELINE.json:5). k is static."""
    if k >= logits.shape[1]:
        return logits
    thresh = jax.lax.top_k(logits, k)[0][:, -1:]
    return jnp.where(logits >= thresh, logits, NEG_INF)


def reg_stats(
    x: jax.Array,
    W: jax.Array,
    mu: jax.Array,
    A6: jax.Array,
    b3: jax.Array,
    pose: tuple[jax.Array, jax.Array],
    point_weights: jax.Array | None = None,
    top_k: int | None = None,
    outlier_logit: jax.Array | float | None = None,
) -> RegStats:
    """Registration E-step statistics.

    x: [N, 3] source points (model frame); pose: (R [3,3], t [3]) applied as
    y = x R^T + t (the GPU kernel applies it in-kernel, so the source
    buffer is never rewritten per iteration);
    W: [>=10, K], mu: [K, 3], A6: [K, 6] packed precisions, b3: [K, 3]
    = Sigma^-1 mu. top_k: optional gating of associations. outlier_logit:
    log-density of a uniform outlier component (see _soft).
    """
    R, t = pose
    y = x @ R.T + t
    logits = _logits(y, W)
    if top_k is not None:
        logits = top_k_mask_logits(logits, top_k)
    gamma, lse = _soft(logits, outlier_logit)
    if point_weights is not None:
        gamma = gamma * point_weights[:, None]
        lse = lse * point_weights

    w = jnp.sum(gamma, axis=1)  # [N]
    horn, A, b = pose_moments(x, y, gamma @ mu, gamma @ A6, gamma @ b3, w)
    return RegStats(horn=horn, A=A, b=b, loglik=jnp.sum(lse))


def pose_moments(
    x: jax.Array,
    y: jax.Array,
    nu: jax.Array,
    M6: jax.Array,
    u: jax.Array,
    w: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Horn moments and Gauss-Newton normal equations from per-point
    responsibility-weighted mixture sums (shared with the GPU kernel,
    which emits those sums per point).

    x: [N, 3] source points, y: [N, 3] posed points; nu = gamma @ mu,
    M6 = gamma @ A6, u = gamma @ b3, w = sum_j gamma_ij (gamma already
    carries the point weights).
    """
    from hgmm.ops.gaussians import sym_unpack

    # ---- Horn moments: P^T Q, P = [x | 1], Q = [nu | w].
    P = jnp.concatenate([x, jnp.ones_like(x[:, :1])], axis=1)  # [N, 4]
    Q = jnp.concatenate([nu, w[:, None]], axis=1)  # [N, 4]
    horn = P.T @ Q  # [4, 4]

    # ---- Mahalanobis GN normal equations on twist xi = [omega, v]:
    # residual_i = M_i y_i - u_i with M_i = sum_j gamma_ij Sigma_j^-1,
    # u_i = sum_j gamma_ij Sigma_j^-1 mu_j; J_i = [-[y_i]_x | I].
    M = sym_unpack(M6)  # [N, 3, 3]
    r = jnp.einsum("nij,nj->ni", M, y) - u  # [N, 3]

    zeros = jnp.zeros_like(y[:, 0])
    # J_i columns: d r / d xi. [y]_x rows stacked per point.
    yx, yy, yz = y[:, 0], y[:, 1], y[:, 2]
    # -[y]_x = [[0, z, -y], [-z, 0, x], [y, -x, 0]]
    negyhat = jnp.stack(
        [
            jnp.stack([zeros, yz, -yy], axis=-1),
            jnp.stack([-yz, zeros, yx], axis=-1),
            jnp.stack([yy, -yx, zeros], axis=-1),
        ],
        axis=-2,
    )  # [N, 3, 3]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=y.dtype), negyhat.shape)
    J = jnp.concatenate([negyhat, eye], axis=-1)  # [N, 3, 6]
    MJ = jnp.einsum("nij,njk->nik", M, J)  # [N, 3, 6]
    A = jnp.einsum("nij,nik->jk", J, MJ)  # [6, 6]
    b = -jnp.einsum("nij,ni->j", J, r)  # [6]
    return horn, A, b
