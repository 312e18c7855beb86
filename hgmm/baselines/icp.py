"""ICP baselines (SURVEY.md §2.1 items 4-5): the reference repo's CPU and
GPU ICP re-expressed in JAX — nearest neighbors via blocked distance
matmuls (hgmm.ops.knn), rigid solve via weighted Umeyama. Used as a
validation/comparison baseline for the GMM registration, exactly as the
reference used them in its README benchmarks."""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from hgmm.models.pose import solve_horn
from hgmm.models.se3 import Pose, se3_log
from hgmm.ops.knn import nearest_neighbor


class IcpResult(NamedTuple):
    pose: Pose
    rmse_history: jax.Array  # [n_iters] mean matched distance per iteration
    converged: jax.Array


@functools.partial(jax.jit, static_argnames=("n_iters",))
def icp(
    source: jax.Array,
    target: jax.Array,
    n_iters: int = 30,
    init_pose: Pose | None = None,
    tol: float = 1e-7,
    max_dist: float | None = None,
) -> IcpResult:
    """Point-to-point ICP, jitted scan. max_dist: reject matches beyond
    this distance (partial-overlap robustness)."""
    if init_pose is None:
        init_pose = Pose.identity(source.dtype)

    def step(carry, _):
        R, t, done = carry
        pose = Pose(R, t)
        y = pose.apply(source)
        # Chunked distance-matmul search (the reference's GPU-ICP
        # equivalent, SURVEY.md §2.1 item 5).
        idx, d2 = nearest_neighbor(y, target)
        matched = target[idx]
        if max_dist is not None:
            w = (d2 < max_dist * max_dist).astype(source.dtype)
        else:
            w = jnp.ones_like(d2)
        P = jnp.concatenate([source, jnp.ones_like(source[:, :1])], axis=1)
        Q = jnp.concatenate([matched * w[:, None], w[:, None]], axis=1)
        new_pose = solve_horn(P.T @ Q)
        delta = jnp.linalg.norm(se3_log(new_pose.compose(pose.inverse())))
        new_done = done | (delta < tol)
        R_out = jnp.where(done, R, new_pose.R)
        t_out = jnp.where(done, t, new_pose.t)
        rmse = jnp.sqrt(jnp.sum(d2 * w) / jnp.maximum(jnp.sum(w), 1.0))
        return (R_out, t_out, new_done), rmse

    carry0 = (init_pose.R, init_pose.t, jnp.zeros((), bool))
    (R, t, done), rmse = jax.lax.scan(step, carry0, None, length=n_iters)
    return IcpResult(Pose(R, t), rmse, done)


def icp_numpy(
    source: np.ndarray,
    target: np.ndarray,
    n_iters: int = 30,
    tol: float = 1e-9,
):
    """Trusted slow CPU reference (BASELINE.md "numpy/scipy" parity
    implementation; mirrors the reference's serial CPU ICP, SURVEY.md
    §2.1 item 4)."""
    src = np.asarray(source, np.float64)
    tgt = np.asarray(target, np.float64)
    R = np.eye(3)
    t = np.zeros(3)
    prev_err = np.inf
    for _ in range(n_iters):
        y = src @ R.T + t
        d2 = (
            np.sum(y * y, axis=1)[:, None]
            - 2.0 * y @ tgt.T
            + np.sum(tgt * tgt, axis=1)[None, :]
        )
        idx = np.argmin(d2, axis=1)
        m = tgt[idx]
        xc, mc = src.mean(0), m.mean(0)
        H = (src - xc).T @ (m - mc)
        U, _, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
        t = mc - R @ xc
        err = float(np.mean(np.min(d2, axis=1)))
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return Pose(jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32))
