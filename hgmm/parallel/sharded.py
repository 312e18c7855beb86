"""Sharded EM + registration over a device mesh (BASELINE.json config 5).

Points are sharded along the mesh "points" axis; every E-step reduces to
O(K) sufficient statistics (or O(1) pose statistics) that are psum'd over
the device interconnect — the ONLY cross-device traffic in the engine
(SURVEY.md §4.2).
Mixture parameters, poses and M-step updates are replicated: they are
KB-scale, so replication is the correct sharding (SURVEY.md §2.2).

Everything here runs identically on a fake CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8), on the GPUs of one
host, and across hosts after parallel.mesh.initialize_multihost() — the
same program, the standard JAX multi-host story (SURVEY.md §5.2
"Distributed without a cluster").
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from hgmm import ops
from hgmm.models.gmm import init_params, scene_variance
from hgmm.models.gmm_tree import seed_children
from hgmm.models.se3 import Pose
from hgmm.ops.gaussians import (
    MixtureParams,
    mstep_update,
    pack_loglik_weights,
    precision_terms,
    sym_pack,
)
from hgmm.parallel.mesh import POINTS_AXIS, make_mesh

_AXIS = POINTS_AXIS


def pad_points_for_mesh(points, mesh: Mesh, tile: int = 1):
    """Pad [N, 3] so N divides n_devices * tile; returns (points, weights)
    with zero weight on padding rows."""
    n = points.shape[0]
    mult = mesh.devices.size * tile
    n_pad = -(-n // mult) * mult
    w = jnp.ones((n,), points.dtype)
    if n_pad != n:
        points = jnp.concatenate(
            [points, jnp.zeros((n_pad - n, 3), points.dtype)]
        )
        w = jnp.concatenate([w, jnp.zeros((n_pad - n,), points.dtype)])
    return points, w


def _psum_tree(tree):
    return jax.tree.map(lambda x: jax.lax.psum(x, _AXIS), tree)


# check_vma is enabled whenever the ref backend is active (CPU fake-device
# meshes — the vma check then audits collective placement for free) and
# bypassed only when the Pallas kernels run: they don't annotate
# varying-mesh-axes on their pallas_call out_shapes, which jax.shard_map's
# default vma checking rejects at trace time. On the kernel path,
# collective placement is pinned by the fake-mesh equivalence tests
# (sharded == single-device results to fp tolerance) instead.
#
# Every cached factory takes `pallas` (the ops._pallas_active() value at
# CALL time) as an explicit cache-key argument: ops.set_backend after a
# program was cached must re-trace for the other backend, not silently
# reuse a program traced with stale dispatch + check_vma.
@functools.lru_cache(maxsize=None)
def _sharded_em_step(mesh: Mesh, n_iters: int, cov_type: str, pallas: bool):
    """Compiled sharded EM loop for a given mesh (cached per mesh/config).

    The WHOLE loop lives inside one shard_map: each device prepares its
    point shard once (ops.Prepared — the big feature buffers must not be
    rebuilt per sweep), the scan body psums the O(K) sufficient stats, and
    every device runs the identical replicated M-step (standard
    data-parallel optimizer-replication; psum outputs are bitwise equal
    across devices, so the replicated states stay in sync)."""

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        check_vma=not pallas,
        in_specs=(P(_AXIS), P(_AXIS), P(), P(), P(), P()),
        out_specs=(P(), P()),
    )
    def run(points, weights, init: MixtureParams, total, cov_reg, cov_floor):
        prep = ops.prepare(points, weights)

        def step(params, _):
            W = pack_loglik_weights(params)
            st = ops.em_stats(prep, W)
            S = jax.lax.psum(st.S, _AXIS)
            ll = jax.lax.psum(st.loglik, _AXIS)
            T0, T1, T2 = ops.unpack_suffstats(S)
            new = mstep_update(
                T0, T1, T2, total, cov_reg=cov_reg, cov_type=cov_type,
                cov_floor=cov_floor,
            )
            return new, ll

        return jax.lax.scan(step, init, None, length=n_iters)

    return run


def sharded_em_fit(
    points,
    init: MixtureParams,
    mesh: Mesh | None = None,
    n_iters: int = 30,
    cov_reg: float = 1e-6,
    cov_type: str = "full",
    point_weights=None,
    cov_floor_rel: float = 1e-4,
):
    """Distributed twin of hgmm.models.gmm.em_fit: identical math, stats
    psum'd over the mesh. Returns (params, loglik_history). Points are
    zero-weight padded to the mesh unconditionally — weighted callers with
    N not divisible by the device count previously crashed in shard_map."""
    if mesh is None:
        mesh = make_mesh()
    n = points.shape[0]
    points, pad_w = pad_points_for_mesh(points, mesh)
    point_weights = (
        pad_w if point_weights is None
        else pad_w.at[:n].set(point_weights.astype(pad_w.dtype))
    )
    total = jnp.sum(point_weights)
    cov_floor = cov_floor_rel * scene_variance(points, point_weights)
    run = _sharded_em_step(mesh, n_iters, cov_type, ops._pallas_active())
    return run(points, point_weights, init, total, cov_reg, cov_floor)


@functools.lru_cache(maxsize=None)
def _sharded_tree_fit_program(
    mesh: Mesh, branch: int, levels: int, em_iters: int, cov_type: str,
    pallas: bool,
):
    """The WHOLE level-synchronous tree build as ONE shard_map jit:
    prepare the point shard once, run the level-0 flat EM scan, then per
    level seed children -> masked EM scan -> re-assign parents — all
    without leaving the program: one host dispatch per fit, and the
    prepared feature buffers built once."""

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        check_vma=not pallas,
        in_specs=(P(_AXIS), P(_AXIS), P(), P(), P(), P()),
        out_specs=P(),
    )
    def run(points, weights, init0: MixtureParams, total, cov_reg, cov_floor):
        prep = ops.prepare(points, weights)

        def em_scan(init, parent):
            def step(params, _):
                W = pack_loglik_weights(params)
                if parent is None:
                    st = ops.em_stats(prep, W)
                else:
                    st = ops.em_stats_masked(prep, W, parent, branch)
                S = jax.lax.psum(st.S, _AXIS)
                ll = jax.lax.psum(st.loglik, _AXIS)
                T0, T1, T2 = ops.unpack_suffstats(S)
                new = mstep_update(
                    T0, T1, T2, total, cov_reg=cov_reg, cov_type=cov_type,
                    cov_floor=cov_floor,
                )
                return new, ll

            params, _ = jax.lax.scan(step, init, None, length=em_iters)
            return params

        level_params = [em_scan(init0, None)]
        if levels > 1:
            # ops.assign returns the shard size [n_local] on every backend,
            # keeping the per-shard parent layout.
            parent = ops.assign(prep, pack_loglik_weights(level_params[0]))
            for li in range(1, levels):
                children = seed_children(level_params[-1], branch)
                params_l = em_scan(children, parent)
                if li < levels - 1:
                    parent = ops.assign(
                        prep, pack_loglik_weights(params_l), parent, branch
                    )
                level_params.append(params_l)
        return tuple(level_params)

    return run


def sharded_tree_fit(
    points,
    mesh: Mesh | None = None,
    branch: int = 8,
    levels: int = 3,
    em_iters: int = 12,
    key=None,
    cov_reg: float = 1e-6,
    cov_type: str = "full",
    cov_floor_rel: float = 1e-4,
    point_weights=None,
    init0: MixtureParams | None = None,
):
    """Distributed level-synchronous GMM-tree build (config 5 + config 2).

    Level 0 fits with sharded flat EM; deeper levels run the masked child
    EM with per-point parents sharded alongside the points — the whole
    build is ONE compiled program (_sharded_tree_fit_program). Returns a
    GmmTree-compatible tuple of per-level MixtureParams.

    point_weights: optional per-point weights (callers that bucketize with
    zero-weight padding, e.g. odometry, pass them so neither the init
    seeding nor the fit sees the padding rows).
    init0: optional level-0 MixtureParams warm start (e.g. an existing
    map's level 0 for incremental updates, pipelines.mapping.update_map);
    None seeds from the data."""
    from hgmm.models.gmm_tree import GmmTree

    if mesh is None:
        mesh = make_mesh()
    if key is None:
        key = jax.random.PRNGKey(0)
    if init0 is None:
        # Init before mesh padding: real points (weight-aware) only.
        init0 = init_params(points, branch, key, point_weights=point_weights)
    n = points.shape[0]
    points, pad_w = pad_points_for_mesh(points, mesh)
    if point_weights is None:
        weights = pad_w
    else:
        weights = pad_w.at[:n].set(point_weights.astype(pad_w.dtype))
    total = jnp.sum(weights)
    cov_floor = cov_floor_rel * scene_variance(points, weights)
    run = _sharded_tree_fit_program(
        mesh, branch, levels, em_iters, cov_type, ops._pallas_active()
    )
    level_params = run(points, weights, init0, total, cov_reg, cov_floor)
    return GmmTree(levels=tuple(level_params), branch=branch)


class ShardedRegResult(NamedTuple):
    pose: Pose
    logliks: jax.Array
    deltas: jax.Array
    converged: jax.Array


@functools.lru_cache(maxsize=None)
def _sharded_register(
    mesh: Mesh, n_iters: int, method: str, top_k, wls_inner: int, pallas: bool
):
    from hgmm.pipelines.register import run_registration_scan

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        check_vma=not pallas,
        in_specs=(P(_AXIS), P(_AXIS), P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P(), P()),
    )
    def run(source, weights, params: MixtureParams, R0, t0, tol, outlier):
        # Replicated O(K) model packing + one per-shard prepare; the whole
        # registration scan (Horn/WLS phases, convergence cond) runs inside
        # the shard_map with only the O(1) pose statistics psum'd.
        W = pack_loglik_weights(params)
        A_, b_, _ = precision_terms(params)
        A6, b3 = sym_pack(A_), b_
        mu = params.mu
        prep = ops.prepare(source, weights)

        def stats_fn(R, t):
            st = ops.reg_stats(
                prep, W, mu, A6, b3, (R, t), None, top_k, outlier
            )
            st = _psum_tree(st)
            return st.horn, st.A, st.b, st.loglik

        (R, t, done), lls, deltas = run_registration_scan(
            stats_fn, R0, t0, n_iters, method, tol, wls_inner
        )
        return R, t, done, lls, deltas

    return run


@functools.lru_cache(maxsize=None)
def _sharded_register_tree_program(
    mesh: Mesh, n_iters: int, method: str, top_k, wls_inner: int,
    ks: tuple, pallas: bool,
):
    """Coarse-to-fine registration down `len(ks)` tree levels as ONE
    shard_map jit (prepare the source shard once; each level runs the full
    registration scan with that level's replicated model and psum'd pose
    statistics) rather than one program dispatch per level."""
    from hgmm.pipelines.register import run_registration_scan

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        check_vma=not pallas,
        in_specs=(P(_AXIS), P(_AXIS), P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P(), P()),
    )
    def run(source, weights, levels_params, R0, t0, tol, outlier):
        prep = ops.prepare(source, weights)
        R, t = R0, t0
        done = None
        lls, deltas = [], []
        for params in levels_params:
            W = pack_loglik_weights(params)
            A_, b_, _ = precision_terms(params)
            A6, b3 = sym_pack(A_), b_
            mu = params.mu

            def stats_fn(R, t, W=W, mu=mu, A6=A6, b3=b3):
                st = ops.reg_stats(
                    prep, W, mu, A6, b3, (R, t), None, top_k, outlier
                )
                st = _psum_tree(st)
                return st.horn, st.A, st.b, st.loglik

            (R, t, done), ll, dd = run_registration_scan(
                stats_fn, R, t, n_iters, method, tol, wls_inner
            )
            lls.append(ll)
            deltas.append(dd)
        return R, t, done, jnp.concatenate(lls), jnp.concatenate(deltas)

    return run


def sharded_register_tree(
    source,
    tree,
    mesh: Mesh | None = None,
    init_pose: Pose | None = None,
    complexity_threshold: float = 0.0,
    n_iters: int = 50,
    method: str = "horn+wls",
    tol: float = 1e-7,
    top_k: int | None = None,
    outlier_logit: float | None = None,
    wls_inner: int = 2,
    point_weights=None,
) -> "ShardedRegResult":
    """Distributed twin of pipelines.register.register_tree: coarse-to-fine
    registration down the tree levels in one compiled program, psum'd pose
    statistics the only cross-device traffic (see register_tree for why
    leaves-only fails)."""
    if mesh is None:
        mesh = make_mesh()
    pose = Pose.identity(source.dtype) if init_pose is None else init_pose
    levels = list(tree.levels)
    if complexity_threshold > 0.0:
        levels[-1] = tree.cut_mixture(complexity_threshold)
    n = source.shape[0]
    source, pad_w = pad_points_for_mesh(source, mesh)
    weights = (
        pad_w if point_weights is None
        else pad_w.at[:n].set(point_weights.astype(pad_w.dtype))
    )
    outlier = jnp.float32(-1e30 if outlier_logit is None else outlier_logit)
    run = _sharded_register_tree_program(
        mesh, n_iters, method, top_k, wls_inner,
        tuple(int(p.pi.shape[0]) for p in levels), ops._pallas_active(),
    )
    R, t, done, lls, deltas = run(
        source, weights, tuple(levels), pose.R, pose.t, jnp.float32(tol),
        outlier,
    )
    return ShardedRegResult(Pose(R, t), lls, deltas, done)


def sharded_register_points(
    source,
    params: MixtureParams,
    mesh: Mesh | None = None,
    init_pose: Pose | None = None,
    n_iters: int = 50,
    method: str = "horn+wls",
    tol: float = 1e-7,
    top_k: int | None = None,
    outlier_logit: float | None = None,
    wls_inner: int = 2,
    point_weights=None,
) -> ShardedRegResult:
    """Distributed twin of pipelines.register.register_points.

    point_weights: optional per-point weights (zero-weight bucketize
    padding must not contribute pose statistics)."""
    if mesh is None:
        mesh = make_mesh()
    if init_pose is None:
        init_pose = Pose.identity(source.dtype)
    n = source.shape[0]
    source, pad_w = pad_points_for_mesh(source, mesh)
    weights = (
        pad_w if point_weights is None
        else pad_w.at[:n].set(point_weights.astype(pad_w.dtype))
    )
    outlier = jnp.float32(-1e30 if outlier_logit is None else outlier_logit)
    run = _sharded_register(
        mesh, n_iters, method, top_k, wls_inner, ops._pallas_active()
    )
    R, t, done, lls, deltas = run(
        source, weights, params, init_pose.R, init_pose.t, jnp.float32(tol),
        outlier,
    )
    return ShardedRegResult(Pose(R, t), lls, deltas, done)
