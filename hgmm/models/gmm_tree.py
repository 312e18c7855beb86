"""Hierarchical GMM tree — level-synchronous batched build + adaptive cut.

Replacement for the reference's CUDA tree build + recursive CPU
traversal (SURVEY.md §2.1 item 7, §3.2; BASELINE.json:5 "recursive CPU
GMM-tree traversal becomes level-synchronous batched tensor passes").
Algorithm per Eckart/Kim/Kautz, arXiv 1807.02587 (PAPERS.md).

Design:
- Fixed branching J (8) and depth L (3): level l holds J^(l+1) Gaussians as
  flat arrays; child block of node p at level l is [p*J, (p+1)*J) at l+1.
- Build: fit level 0 with full EM; for each deeper level, seed J children
  per parent deterministically from the parent's covariance, then run EM
  sweeps where each point sees ONLY its parent's child block — a masked
  softmax of width J inside a single [N,16]@[16,K] contraction
  (hgmm.ops.em_stats_masked). Parents are hard (argmax) assignments,
  re-derived after each level completes.
- Association for registration: instead of per-point recursive descent, the
  adaptive-scale criterion of the paper (stop at geometrically simple nodes)
  is a PER-NODE property, so the "descent" collapses to a static mixed-
  resolution CUT of the tree: keep coarse nodes whose complexity is below
  threshold, else their leaves. The cut is a flat mixture padded to J^L
  components with zero weights — registration then reuses the flat fused
  E-step kernel with masked top-k gating. Zero recursion, zero gathers.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from hgmm import ops
from hgmm.ops.gaussians import (
    MixtureParams,
    mstep_update,
    pack_loglik_weights,
    sym3_eigvalsh,
)
from hgmm.models.gmm import em_fit, init_params, scene_variance

# Child seeding directions for J=8: cube corners (unit norm). numpy so the
# import never initializes a JAX backend (multi-process bootstrap ordering).
import numpy as np  # noqa: E402

_CUBE = np.array(
    [
        [-1, -1, -1], [-1, -1, 1], [-1, 1, -1], [-1, 1, 1],
        [1, -1, -1], [1, -1, 1], [1, 1, -1], [1, 1, 1],
    ],
    dtype=np.float32,
) / np.sqrt(3.0)


def _child_directions(branch: int) -> jax.Array:
    if branch == 8:
        return _CUBE
    # Deterministic pseudo-uniform directions for other branch factors.
    g = jax.random.normal(jax.random.PRNGKey(7), (branch, 3))
    return g / jnp.linalg.norm(g, axis=1, keepdims=True)


def seed_children(parents: MixtureParams, branch: int) -> MixtureParams:
    """Split every parent Gaussian into `branch` children: means offset along
    the parent covariance's Cholesky directions, covariance shrunk, weight
    split evenly. Deterministic (no RNG -> reproducible builds)."""
    kp = parents.pi.shape[0]
    dirs = _child_directions(branch).astype(parents.mu.dtype)  # [J, 3]
    chol = jnp.linalg.cholesky(
        parents.sigma + 1e-9 * jnp.eye(3, dtype=parents.sigma.dtype)
    )  # [Kp, 3, 3]
    offsets = jnp.einsum("kij,bj->kbi", chol, dirs)  # [Kp, J, 3]
    mu = (parents.mu[:, None, :] + 0.6 * offsets).reshape(kp * branch, 3)
    sigma = jnp.repeat(parents.sigma * 0.35, branch, axis=0)
    pi = jnp.repeat(parents.pi / branch, branch, axis=0)
    return MixtureParams(pi=pi, mu=mu, sigma=sigma)


@partial(jax.jit, static_argnames=("branch", "levels", "em_iters", "cov_type"))
def _fit_tree(
    points: jax.Array,
    init0: MixtureParams,
    branch: int,
    levels: int,
    em_iters: int,
    cov_reg: float,
    cov_type: str,
    point_weights: jax.Array | None = None,
    cov_floor_rel: float = 1e-4,
):
    """Level-synchronous build. Returns (tuple of per-level params,
    per-level final logliks)."""
    if point_weights is None:
        total = jnp.asarray(points.shape[0], dtype=points.dtype)
    else:
        total = jnp.sum(point_weights)
    # One scale-aware covariance floor for every level: deep levels are
    # exactly where collapse strikes (few points per leaf, thin structure)
    # — see em_fit's cov_floor_rel docstring.
    cov_floor = cov_floor_rel * scene_variance(points, point_weights)

    level_params = []
    level_logliks = []

    params0, ll0 = em_fit(
        points, init0, n_iters=em_iters, cov_reg=cov_reg, cov_type=cov_type,
        point_weights=point_weights, cov_floor_rel=cov_floor_rel,
    )
    level_params.append(params0)
    level_logliks.append(ll0[-1])
    # One prepare for every level's EM scan + assign (see ops.Prepared).
    prep = ops.prepare(points, point_weights)
    parent = ops.assign(prep, pack_loglik_weights(params0))

    for _ in range(1, levels):
        children = seed_children(level_params[-1], branch)

        def em_step(p: MixtureParams, _):
            W = pack_loglik_weights(p)
            stats = ops.em_stats_masked(prep, W, parent, branch)
            T0, T1, T2 = ops.unpack_suffstats(stats.S)
            new = mstep_update(
                T0, T1, T2, total, cov_reg=cov_reg, cov_type=cov_type,
                cov_floor=cov_floor,
            )
            return new, stats.loglik

        params_l, lls = jax.lax.scan(em_step, children, None, length=em_iters)
        level_params.append(params_l)
        level_logliks.append(lls[-1])
        parent = ops.assign(prep, pack_loglik_weights(params_l), parent, branch)

    return tuple(level_params), jnp.stack(level_logliks)


def node_complexity(params: MixtureParams) -> jax.Array:
    """Per-node geometric complexity in [0, 1]: smallest eigenvalue fraction
    of the covariance trace. Near-planar/degenerate (simple) nodes score low;
    isotropic blobs (complex, worth refining) score high. This is the
    adaptive-scale criterion of arXiv 1807.02587 made a node property."""
    eigs = sym3_eigvalsh(params.sigma)  # ascending, [K, 3]
    return eigs[:, 0] / jnp.maximum(jnp.sum(eigs, axis=1), 1e-30)


@dataclasses.dataclass
class GmmTree:
    """Fitted hierarchical GMM. levels[l].pi are GLOBAL mixture weights (sum
    to 1 within each level)."""

    levels: tuple[MixtureParams, ...]
    branch: int

    @classmethod
    def fit(
        cls,
        points: jax.Array,
        branch: int = 8,
        levels: int = 3,
        em_iters: int = 12,
        key: jax.Array | None = None,
        cov_reg: float = 1e-6,
        cov_type: str = "full",
        point_weights: jax.Array | None = None,
        cov_floor_rel: float = 1e-4,
        init0: MixtureParams | None = None,
    ) -> tuple["GmmTree", jax.Array]:
        """init0: optional level-0 warm start (e.g. an existing map's
        level 0 for incremental updates, pipelines.mapping.update_map);
        None seeds from the data. Mirrors parallel.sharded_tree_fit."""
        if key is None:
            key = jax.random.PRNGKey(0)
        if init0 is None:
            init0 = init_params(points, branch, key, point_weights=point_weights)
        lvls, logliks = _fit_tree(
            points, init0, branch, levels, em_iters, cov_reg, cov_type,
            point_weights, cov_floor_rel,
        )
        return cls(levels=tuple(lvls), branch=branch), logliks

    @property
    def n_leaves(self) -> int:
        return self.levels[-1].pi.shape[0]

    def leaf_mixture(self) -> MixtureParams:
        return self.levels[-1]

    def cut_mixture(
        self, complexity_threshold: float = 0.0, compact: bool = True
    ) -> MixtureParams:
        """Mixed-resolution mixture (arXiv 1807.02587's adaptive-scale
        association as a static cut): for each node at level L-2, if its
        complexity <= threshold keep the NODE (children dropped), else keep
        its CHILDREN. A kept coarse node takes EXACTLY the total weight of
        the leaves it replaces (not its own fitted pi, which matches the
        leaf mass only approximately under hard parent assignment), so the
        cut's weights sum to 1 by construction.

        With compact=True (requires calling OUTSIDE jit) zero-weight
        components are dropped host-side and K is padded up to a multiple
        of 64, so a cut that keeps C coarse nodes costs the fused kernels
        K ~= C + (Kc - C) * branch instead of Kc + Kc * branch.
        threshold=0 -> pure leaves."""
        if len(self.levels) < 2 or complexity_threshold <= 0.0:
            return self.leaf_mixture()
        coarse = self.levels[-2]
        leaves = self.levels[-1]
        leaf_mass = jnp.sum(leaves.pi.reshape(-1, self.branch), axis=1)  # [Kc]
        simple = node_complexity(coarse) <= complexity_threshold  # [Kc]
        keep_coarse = simple & (leaf_mass > 0)
        pi = jnp.concatenate(
            [
                jnp.where(keep_coarse, leaf_mass, 0.0),
                jnp.where(jnp.repeat(keep_coarse, self.branch), 0.0, leaves.pi),
            ]
        )
        mu = jnp.concatenate([coarse.mu, leaves.mu])
        sigma = jnp.concatenate([coarse.sigma, leaves.sigma])
        pi = pi / jnp.maximum(jnp.sum(pi), 1e-30)
        out = MixtureParams(pi=pi, mu=mu, sigma=sigma)
        return compact_mixture(out) if compact else out


def compact_mixture(params: MixtureParams, bucket: int = 64) -> MixtureParams:
    """Drop zero-weight components and pad K up to a multiple of `bucket`
    (identity-covariance, pi=0 pads — the packing gives them below-NEG_INF
    logits so they are inert in every kernel). Shapes become data-dependent:
    must run OUTSIDE jit; bucketing bounds recompile churn when cut sizes
    vary across frames."""
    pi = np.asarray(params.pi)
    keep = np.flatnonzero(pi > 0)
    if keep.size == 0:
        keep = np.array([0])
    k_pad = max(bucket, -(-keep.size // bucket) * bucket)
    if k_pad == pi.shape[0] and keep.size == pi.shape[0]:
        return params
    pad = k_pad - keep.size
    pi_c = np.concatenate([pi[keep], np.zeros(pad, pi.dtype)])
    mu_c = np.concatenate(
        [np.asarray(params.mu)[keep], np.zeros((pad, 3), np.float32)]
    )
    sigma_c = np.concatenate(
        [
            np.asarray(params.sigma)[keep],
            np.broadcast_to(np.eye(3, dtype=np.float32), (pad, 3, 3)),
        ]
    )
    return MixtureParams(
        pi=jnp.asarray(pi_c), mu=jnp.asarray(mu_c), sigma=jnp.asarray(sigma_c)
    )


def fit_gmm_tree(points, branch=8, levels=3, em_iters=12, key=None, **kw):
    return GmmTree.fit(
        points, branch=branch, levels=levels, em_iters=em_iters, key=key, **kw
    )
