"""Global mixture-map building + map-based localization.

The SLAM-frontend capstone over the pairwise engine (BASELINE.json
north_star: "point-cloud registration and SLAM-frontend engine ...
extended with multi-frame pose-graph refinement"): after odometry +
refinement produce globally-consistent poses, the frames are fused into
ONE hierarchical-GMM map of the scene — the union of pose-transformed
points fit with the sharded tree build (the config-5 large-N path,
parallel.sharded_tree_fit: 10M+ fused points shard across the mesh with
psum'd sufficient statistics). The map is then a drop-in registration
target: `localize` runs the standard coarse-to-fine registration of a
new scan against it, giving relocalization / loop-closure-against-map
without access to the original frames.

Static-shape discipline: the fused cloud is voxel-downsampled and
padded to a bucket (SURVEY.md §8 "pad N to bucket sizes"), so repeated
map builds at different frame counts reuse one compiled program per
bucket.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from hgmm.models.gmm_tree import GmmTree
from hgmm.models.se3 import Pose


def _to_bucket(points, bucket, rng, weights=None):
    """Subsample (above) or zero-weight pad (below) to exactly `bucket`
    points — the shared static-shape discipline of build_map/update_map
    (odometry._bucketize is the per-frame sibling). Warns when evidence
    is dropped: a silent cap would read as "the whole fused cloud was
    fit" (round-5 review item)."""
    n = points.shape[0]
    if weights is None:
        weights = np.ones(n, np.float32)
    if n > bucket:
        import warnings

        warnings.warn(
            f"map fit bucket {bucket} < fused cloud {n}: subsampling "
            f"{n - bucket} points away — raise MapConfig.bucket (one "
            f"compiled program per bucket) or coarsen MapConfig.voxel "
            f"to keep full evidence",
            stacklevel=3,
        )
        idx = rng.choice(n, size=bucket, replace=False)
        return jnp.asarray(points[idx]), jnp.asarray(weights[idx])
    pad = bucket - n
    return (
        jnp.asarray(np.concatenate([points, np.zeros((pad, 3), np.float32)])),
        jnp.asarray(np.concatenate([weights, np.zeros(pad, np.float32)])),
    )


def _chol_samples(mu, sigma, z):
    """mu[K,3] + chol(sigma[K,3,3]) @ z[..., 3] Gaussian samples (shared
    by sample_mixture and viz.export_map — one copy of the eps-regularized
    Cholesky)."""
    chol = np.linalg.cholesky(sigma + 1e-9 * np.eye(3, dtype=sigma.dtype))
    return mu + np.einsum("...ij,...j->...i", chol, z)


@dataclasses.dataclass
class MapConfig:
    branch: int = 8
    levels: int = 3
    em_iters: int = 12
    voxel: float | None = None  # fuse-time voxel (meters); None = auto
    # Point budget of the fused cloud: subsample above, zero-weight pad
    # below (one compiled fit program per bucket).
    bucket: int = 1 << 18
    seed: int = 0


def fuse_frames(
    frames,
    poses,
    voxel: float | None = None,
) -> np.ndarray:
    """Transform each frame's points by its (refined) absolute pose and
    concatenate into one world-frame cloud.

    frames: sequence of [N_i, 3] arrays (or (points, weights) tuples as
    built by run_odometry — zero-weight padding rows are dropped).
    poses: matching absolute Pose per frame (e.g. PoseGraphResult.poses()).
    voxel: optional voxel-grid downsample of the FUSED cloud — the right
    place to thin: overlapping frames multiply-sample revisited surfaces,
    which would otherwise overweight them in the map fit. None picks the
    fused cloud's bbox diagonal / 256 (cheap, scale-free — note it scales
    with TOTAL mapped extent, so long trajectories get coarser voxels;
    pass an explicit metric voxel to pin resolution). 0 disables.
    """
    from hgmm.data.kitti import voxel_downsample

    if len(frames) != len(poses):
        raise ValueError(
            f"{len(frames)} frames vs {len(poses)} poses"
        )
    # ONE batched device->host pull of all poses, then pure-numpy
    # transforms: no device round trip per frame; the transform itself is
    # a trivial host matmul.
    Rs = np.asarray(jnp.stack([p.R for p in poses]))
    ts = np.asarray(jnp.stack([p.t for p in poses]))
    world = []
    for i, f in enumerate(frames):
        if isinstance(f, tuple):
            pts, w = f
            pts = np.asarray(pts)[np.asarray(w) > 0]
        else:
            pts = np.asarray(f)
        world.append(pts.astype(np.float32) @ Rs[i].T + ts[i])
    fused = np.concatenate(world, axis=0)
    if voxel is None:
        bbox = fused.max(axis=0) - fused.min(axis=0)
        voxel = float(np.linalg.norm(bbox)) / 256.0
    if voxel > 0:
        fused = voxel_downsample(fused, voxel)
    return fused.astype(np.float32)


def build_map(
    frames,
    poses,
    config: MapConfig | None = None,
    mesh=None,
) -> GmmTree:
    """Fit the global GMM-tree map to the fused world cloud.

    mesh: optional jax.sharding.Mesh — the fit runs points-sharded through
    parallel.sharded_tree_fit (the config-5 program; at KITTI scale the
    fused cloud is the 10M+-point workload of BASELINE.json:11).
    """
    cfg = config or MapConfig()
    fused = fuse_frames(frames, poses, voxel=cfg.voxel)
    pts, weights = _to_bucket(
        fused, cfg.bucket, np.random.default_rng(cfg.seed)
    )
    key = jax.random.PRNGKey(cfg.seed)
    if mesh is not None:
        from hgmm.parallel import sharded_tree_fit

        return sharded_tree_fit(
            pts, mesh, branch=cfg.branch, levels=cfg.levels,
            em_iters=cfg.em_iters, key=key, point_weights=weights,
        )
    tree, _ = GmmTree.fit(
        pts, branch=cfg.branch, levels=cfg.levels, em_iters=cfg.em_iters,
        key=key, point_weights=weights,
    )
    return tree


def localize(
    scan,
    map_tree: GmmTree,
    init_pose: Pose | None = None,
    mesh=None,
    n_iters: int = 40,
    method: str = "wls",
    outlier_logit: float | None = -8.0,
    complexity_threshold: float = 0.0,
):
    """Register a scan against the prebuilt map (relocalization).

    The map's coarse levels give the wide basin (coarse-to-fine descent,
    register_tree); the scan only needs pose-proximity to the mapped area,
    not a matching frame. outlier gating matters more than in odometry:
    a localization scan typically sees map regions plus NEW geometry.
    Returns the RegistrationResult whose pose maps scan points into the
    map (world) frame.
    """
    scan = jnp.asarray(scan, jnp.float32)
    kw = dict(
        init_pose=init_pose, n_iters=n_iters, method=method,
        outlier_logit=outlier_logit,
    )
    if mesh is not None:
        from hgmm.parallel import sharded_register_tree

        return sharded_register_tree(
            scan, map_tree, mesh,
            complexity_threshold=complexity_threshold, **kw,
        )
    from hgmm.pipelines.register import register_tree

    return register_tree(
        scan, map_tree, complexity_threshold=complexity_threshold, **kw
    )


def sample_mixture(params, n: int, seed: int = 0) -> np.ndarray:
    """Draw n points from a MixtureParams (host-side numpy): components by
    weight, then their Gaussians via Cholesky. Used to SYNTHESIZE a map's
    evidence when the original frames are gone (update_map)."""
    pi = np.asarray(params.pi, np.float64)
    mu = np.asarray(params.mu)
    sigma = np.asarray(params.sigma)
    live = pi > 0
    pi, mu, sigma = pi[live], mu[live], sigma[live]
    pi = pi / pi.sum()
    rng = np.random.default_rng(seed)
    comp = rng.choice(pi.size, size=n, p=pi)
    z = rng.standard_normal((n, 3)).astype(np.float32)
    return _chol_samples(mu[comp], sigma[comp], z).astype(np.float32)


def update_map(
    map_tree: GmmTree,
    frames,
    poses,
    config: MapConfig | None = None,
    mesh=None,
    carry_points: int | None = None,
    old_new_ratio: float = 1.0,
) -> GmmTree:
    """Incrementally extend an existing map with newly registered frames —
    WITHOUT access to the frames the map was built from (multi-session
    mapping: yesterday's map + today's drive).

    The old map's evidence is carried by synthesis: `carry_points` samples
    drawn from its leaf mixture (mixture-compression style) join the new
    frames' fused world points, with per-point weights scaled so the old
    evidence carries `old_new_ratio` times the new points' total mass.
    The refit warm-starts level 0 from the old map's level-0 parameters,
    so stable structure keeps its components while the tree re-seeds
    deeper levels over the joint evidence.
    """
    cfg = config or MapConfig()
    fused_new = fuse_frames(frames, poses, voxel=cfg.voxel)
    n_new = fused_new.shape[0]
    if carry_points is None:
        carry_points = min(n_new, cfg.bucket // 2)
    old_pts = sample_mixture(
        map_tree.leaf_mixture(), carry_points, seed=cfg.seed + 1
    )
    pts = np.concatenate([fused_new, old_pts])
    # Old evidence mass = old_new_ratio x new mass, regardless of sample
    # counts.
    w = np.concatenate(
        [
            np.ones(n_new, np.float32),
            np.full(
                carry_points,
                old_new_ratio * n_new / max(carry_points, 1),
                np.float32,
            ),
        ]
    )
    pts_j, w_j = _to_bucket(
        pts, cfg.bucket, np.random.default_rng(cfg.seed), weights=w
    )
    init0 = map_tree.levels[0]
    if int(init0.pi.shape[0]) != cfg.branch:
        raise ValueError(
            f"map branch {init0.pi.shape[0]} != MapConfig.branch "
            f"{cfg.branch}: the warm start must match the tree layout"
        )
    if mesh is not None:
        from hgmm.parallel import sharded_tree_fit

        return sharded_tree_fit(
            pts_j, mesh, branch=cfg.branch, levels=cfg.levels,
            em_iters=cfg.em_iters, key=jax.random.PRNGKey(cfg.seed),
            point_weights=w_j, init0=init0,
        )
    tree, _ = GmmTree.fit(
        pts_j, branch=cfg.branch, levels=cfg.levels, em_iters=cfg.em_iters,
        point_weights=w_j, init0=init0,
    )
    return tree
