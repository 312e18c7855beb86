"""Synthetic point-cloud generators.

The Stanford scans (bunny/dragon/happy-buddha) named by BASELINE.json
configs 1-2 are not redistributable inside this offline environment, so the
test/benchmark clouds are deterministic synthetic stand-ins with similar
structure (curved 2D surfaces embedded in 3D, non-uniform density). Real
scans load through hgmm.data.ply at deployment time.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hgmm.models.se3 import Pose
from hgmm.ops.gaussians import MixtureParams


def sample_gmm(key: jax.Array, params: MixtureParams, n: int) -> jax.Array:
    """Draw n points from a mixture (for EM-recovery unit tests)."""
    k_comp, k_norm = jax.random.split(key)
    comp = jax.random.choice(k_comp, params.pi.shape[0], shape=(n,), p=params.pi)
    chol = jnp.linalg.cholesky(params.sigma)  # [K, 3, 3]
    z = jax.random.normal(k_norm, (n, 3), dtype=params.mu.dtype)
    return params.mu[comp] + jnp.einsum("nij,nj->ni", chol[comp], z)


def make_cloud(key: jax.Array, n: int, kind: str = "trefoil") -> jax.Array:
    """Structured surface clouds (bunny stand-ins).

    trefoil: tube around a trefoil knot — curved, self-occluding, unambiguous
             under rigid motion (no rotational symmetry).
    helix:   swept helix ribbon.
    blob:    sample of a random 12-component GMM.
    """
    k1, k2, k3 = jax.random.split(key, 3)
    if kind == "blob":
        km, kc = jax.random.split(k1)
        mu = jax.random.uniform(km, (12, 3), minval=-1.0, maxval=1.0)
        a = 0.15 * jax.random.normal(kc, (12, 3, 3))
        sigma = jnp.einsum("kij,klj->kil", a, a) + 0.01 * jnp.eye(3)
        pi = jnp.full((12,), 1.0 / 12.0)
        return sample_gmm(k2, MixtureParams(pi, mu, sigma), n)

    t = jax.random.uniform(k1, (n,), minval=0.0, maxval=2.0 * jnp.pi)
    if kind == "trefoil":
        cx = jnp.sin(t) + 2.0 * jnp.sin(2.0 * t)
        cy = jnp.cos(t) - 2.0 * jnp.cos(2.0 * t)
        cz = -jnp.sin(3.0 * t)
        center = 0.3 * jnp.stack([cx, cy, cz], axis=-1)
        tube = 0.06
    elif kind == "helix":
        cx = jnp.cos(3.0 * t)
        cy = jnp.sin(3.0 * t)
        cz = t / jnp.pi - 1.0
        center = 0.5 * jnp.stack([cx, cy, cz], axis=-1)
        tube = 0.08
    else:
        raise ValueError(f"unknown cloud kind: {kind}")
    offset = tube * jax.random.normal(k3, (n, 3))
    return (center + offset).astype(jnp.float32)


def perturb(
    key: jax.Array,
    points: jax.Array,
    pose: Pose,
    noise: float = 0.0,
    keep_fraction: float = 1.0,
) -> jax.Array:
    """Apply a rigid transform + Gaussian noise + (static-shape) dropout by
    resampling kept points, producing the 'source' cloud of a registration
    test pair. keep_fraction < 1 simulates partial overlap."""
    k_noise, k_keep = jax.random.split(key)
    out = pose.apply(points)
    if noise > 0:
        out = out + noise * jax.random.normal(k_noise, out.shape, dtype=out.dtype)
    if keep_fraction < 1.0:
        n = points.shape[0]
        n_keep = max(int(n * keep_fraction), 1)
        idx = jax.random.permutation(k_keep, n)[:n_keep]
        out = out[idx]
    return out


def make_loop_sequence(
    n_frames: int,
    scene_points: int,
    seed: int = 0,
    loop_frames: int | None = None,
):
    """LiDAR-scale synthetic drive around a loop: metric steps, a ~15 m
    scene (an 8x-scaled trefoil of `scene_points` points), and a partial
    (bearing-sector, ~54% of the scene) noisy view per frame.

    The loop geometry is fixed: `loop_frames` frames (default n_frames)
    go once round a loop of 0.45 m steps at 64 frames, so more loop
    frames sample the same loop more densely. Frame k sits at angle
    2 pi k / loop_frames; n_frames < loop_frames drives only the first
    part of the loop. Returns (frames: list of [M_k, 3] float32 numpy
    arrays in the sensor frame, gt: list of absolute Pose)."""
    import numpy as np

    from hgmm.models.se3 import so3_exp

    loop_frames = n_frames if loop_frames is None else loop_frames
    radius = 0.45 * 64 / (2 * np.pi)
    scene = 8.0 * make_cloud(jax.random.PRNGKey(seed), scene_points, kind="trefoil")
    rng = np.random.default_rng(seed)
    gt, frames = [], []
    for k in range(n_frames):
        th = 2 * np.pi * k / loop_frames
        t = jnp.array([radius * np.cos(th) - radius, radius * np.sin(th), 0.0])
        pose = Pose(so3_exp(jnp.array([0.0, 0.0, 0.25 * np.sin(th)])), t)
        gt.append(pose)
        pts = np.asarray(pose.inverse().apply(scene))
        pts = pts[np.abs(np.arctan2(pts[:, 1], pts[:, 0])) < 1.7]
        pts = pts + 0.02 * rng.standard_normal(pts.shape).astype(np.float32)
        frames.append(pts.astype(np.float32))
    return frames, gt
