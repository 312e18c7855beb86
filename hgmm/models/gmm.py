"""Flat K-component GMM fit via EM — config 1 of BASELINE.json (bunny,
K=64, CPU-runnable).

Replacement for the reference's flat GMM-EM registration model
(SURVEY.md §2.1 item 6). The EM loop is a jitted `lax.scan` whose body is
one fused E-step (hgmm.ops.em_stats) + a closed-form M-step — no
per-iteration host sync, unlike the reference's kernel-launch/memcpy loop
(SURVEY.md §4.1).
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
)


def init_params(
    points: jax.Array,
    k: int,
    key: jax.Array,
    point_weights: jax.Array | None = None,
) -> MixtureParams:
    """Random-subset means + isotropic covariance from the bounding box.

    Deterministic given `key`; jit-friendly (static k).

    point_weights: initial means are drawn with probability proportional to
    weight, so zero-weight padding rows (odometry bucketize pads zeros at
    the origin) can never seed a dead component at the padding origin
    (round-3 verdict item 6); the bounding box likewise ignores them.
    """
    n = points.shape[0]
    if point_weights is None:
        idx = jax.random.choice(key, n, shape=(k,), replace=False)
        lo = jnp.min(points, axis=0)
        hi = jnp.max(points, axis=0)
    else:
        if not isinstance(point_weights, jax.core.Tracer):
            # Eager guard: choice(replace=False, p) runs out of p>0 entries
            # and silently draws zero-weight padding rows — the exact
            # dead-component failure this weighting exists to prevent.
            import numpy as _np

            n_live = int(_np.sum(_np.asarray(point_weights) > 0))
            if n_live < k:
                raise ValueError(
                    f"init_params: only {n_live} positive-weight points for "
                    f"k={k} components"
                )
        p = point_weights / jnp.maximum(jnp.sum(point_weights), 1e-30)
        idx = jax.random.choice(key, n, shape=(k,), replace=False, p=p)
        live = (point_weights > 0)[:, None]
        lo = jnp.min(jnp.where(live, points, jnp.inf), axis=0)
        hi = jnp.max(jnp.where(live, points, -jnp.inf), axis=0)
    mu = points[idx]
    scale = jnp.maximum(jnp.max(hi - lo), 1e-6)
    var = (scale / max(k ** (1.0 / 3.0), 1.0)) ** 2
    sigma = jnp.broadcast_to(var * jnp.eye(3, dtype=points.dtype), (k, 3, 3))
    pi = jnp.full((k,), 1.0 / k, dtype=points.dtype)
    return MixtureParams(pi=pi, mu=mu, sigma=sigma)


def scene_variance(
    points: jax.Array, point_weights: jax.Array | None = None
) -> jax.Array:
    """Weighted mean squared deviation per axis (scalar, data units^2) —
    the scene scale the fit paths derive their covariance floor from."""
    if point_weights is None:
        mean = jnp.mean(points, axis=0)
        return jnp.mean((points - mean) ** 2)
    w = point_weights[:, None]
    tw = jnp.maximum(jnp.sum(point_weights), 1e-30)
    mean = jnp.sum(points * w, axis=0) / tw
    return jnp.sum(w * (points - mean) ** 2) / (3.0 * tw)


@partial(jax.jit, static_argnames=("n_iters", "cov_type"))
def em_fit(
    points: jax.Array,
    init: MixtureParams,
    n_iters: int = 30,
    cov_reg: float = 1e-6,
    cov_type: str = "full",
    point_weights: jax.Array | None = None,
    cov_floor_rel: float = 1e-4,
) -> tuple[MixtureParams, jax.Array]:
    """Run `n_iters` EM sweeps; returns (params, loglik_history [n_iters]).

    The loop is a lax.scan (BASELINE.json:5 "jitted scan"): fixed trip count,
    loglik history returned for convergence monitoring (SURVEY.md §6.5).

    cov_floor_rel: scale-aware covariance-eigenvalue floor as a fraction of
    the scene variance (so sigma_min ~ 1% of the cloud's standard deviation
    at the default). On degenerate data (points exactly on a curve/plane)
    EM otherwise collapses covariances to cov_reg, which both diverges the
    likelihood and drives packed precisions to ~1/cov_reg, where the
    quadratic-form logits cancel catastrophically in f32. 0 disables.
    """
    if point_weights is None:
        total = jnp.asarray(points.shape[0], dtype=points.dtype)
    else:
        total = jnp.sum(point_weights)
    cov_floor = cov_floor_rel * scene_variance(points, point_weights)
    # Feature buffers built ONCE, outside the scan (ops.Prepared).
    prep = ops.prepare(points, point_weights)

    def step(params: MixtureParams, _):
        W = pack_loglik_weights(params)
        stats = ops.em_stats(prep, W)
        T0, T1, T2 = ops.unpack_suffstats(stats.S)
        new = mstep_update(
            T0, T1, T2, total, cov_reg=cov_reg, cov_type=cov_type,
            cov_floor=cov_floor,
        )
        return new, stats.loglik

    params, logliks = jax.lax.scan(step, init, None, length=n_iters)
    return params, logliks


def log_likelihood(params: MixtureParams, points: jax.Array) -> jax.Array:
    """Mean per-point log-likelihood under the mixture."""
    W = pack_loglik_weights(params)
    stats = ops.em_stats(points, W)
    return stats.loglik / points.shape[0]


@dataclasses.dataclass
class Gmm:
    """Fitted flat GMM over a target cloud. `Gmm.fit` is the public entry
    (SURVEY.md §1.2 Models layer)."""

    params: MixtureParams

    @classmethod
    def fit(
        cls,
        points: jax.Array,
        k: int = 64,
        n_iters: int = 30,
        key: jax.Array | None = None,
        cov_reg: float = 1e-6,
        cov_type: str = "full",
        cov_floor_rel: float = 1e-4,
        point_weights: jax.Array | None = None,
    ) -> tuple["Gmm", jax.Array]:
        if key is None:
            key = jax.random.PRNGKey(0)
        init = init_params(points, k, key, point_weights=point_weights)
        params, logliks = em_fit(
            points, init, n_iters=n_iters, cov_reg=cov_reg, cov_type=cov_type,
            cov_floor_rel=cov_floor_rel, point_weights=point_weights,
        )
        return cls(params), logliks

    def log_likelihood(self, points: jax.Array) -> jax.Array:
        return log_likelihood(self.params, points)


# Backwards-friendly aliases used in hgmm.__init__.
GmmParams = MixtureParams


def fit_gmm(points, k=64, n_iters=30, key=None, **kw) -> tuple[Gmm, jax.Array]:
    return Gmm.fit(points, k=k, n_iters=n_iters, key=key, **kw)
