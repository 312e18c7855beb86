"""Pairwise rigid registration: jitted scan over (E-step assoc, pose M-step).

Replaces the reference's per-iteration kernel-launch + memcpy + host-solve
loop (SURVEY.md §4.1a) with ONE compiled program: the whole iterate loop is
a lax.scan, the only host<->device crossing is at call boundaries
(BASELINE.json:5 "the registration loop becomes a jitted scan over EM+pose
iterations").

Methods (BASELINE.json:5 "weighted Horn/Mahalanobis alignment"):
- "horn": weighted Horn/Umeyama on virtual targets — robust, large basin.
- "wls": Mahalanobis Gauss-Newton on the se(3) twist — anisotropic-exact.
- "horn+wls": Horn for the first half of iterations, then WLS refinement.
"""

from __future__ import annotations

import typing
from functools import partial

import jax
import jax.numpy as jnp

from hgmm import ops
from hgmm.models.gmm import Gmm
from hgmm.models.gmm_tree import GmmTree
from hgmm.models.pose import (
    apply_wls_increment,
    solve_horn,
    solve_wls_increment,
)
from hgmm.models.se3 import Pose, se3_log
from hgmm.ops.gaussians import (
    MixtureParams,
    pack_loglik_weights,
    precision_terms,
    sym_pack,
)


class RegistrationResult(typing.NamedTuple):
    pose: Pose
    logliks: jax.Array  # [n_iters] data log-likelihood per iteration
    deltas: jax.Array  # [n_iters] ||se3 increment|| per iteration
    converged: jax.Array  # [] bool


def run_registration_scan(
    stats_fn,
    init_R: jax.Array,
    init_t: jax.Array,
    n_iters: int,
    method: str,
    tol,
    wls_inner: int,
):
    """The shared registration iterate: TWO lax.scan phases (Horn, then WLS
    Gauss-Newton) so neither phase ever executes the other solver's kernels,
    plus a lax.cond that skips ALL per-iteration work once converged —
    converged iterations cost one branch, not a fused E-step.

    stats_fn(R, t) -> (horn [4,4], A [6,6], b [6], loglik []) — the
    registration E-step statistics at the given pose (sharded callers pass a
    shard_map+psum wrapper; single-device callers pass ops.reg_stats).
    Iterations after convergence re-emit the LAST live (loglik, delta), so
    logliks[-1]/deltas[-1] always reflect the converged state — consumers
    (odometry records, loop-closure acceptance gates) read exactly those
    slots, and a zero sentinel there once made an early-converged closure
    candidate report loglik 0 and sail through the quality gate.

    Returns ((R, t, done), logliks [n_iters], deltas [n_iters]).
    """
    assert method in ("horn", "wls", "horn+wls"), method
    n_horn = (
        n_iters // 2 if method == "horn+wls"
        else (n_iters if method == "horn" else 0)
    )
    n_wls = n_iters - n_horn

    def _live(solver):
        def live(R, t):
            horn, A, b, ll = stats_fn(R, t)
            if solver == "horn":
                new_pose = solve_horn(horn)
            else:
                p = apply_wls_increment(Pose(R, t), solve_wls_increment(A, b))
                # A few Gauss-Newton inner steps, refreshing associations
                # each time (associations are cheap: same fused kernel).
                for _ in range(wls_inner - 1):
                    _, A2, b2, _ = stats_fn(p.R, p.t)
                    p = apply_wls_increment(p, solve_wls_increment(A2, b2))
                new_pose = p
            delta = jnp.linalg.norm(se3_log(new_pose.compose(Pose(R, t).inverse())))
            return new_pose.R, new_pose.t, delta, ll

        return live

    def _step(solver):
        live = _live(solver)

        def step(carry, _):
            R, t, done, ll_last, d_last = carry
            R2, t2, delta, ll = jax.lax.cond(
                done,
                lambda R, t: (R, t, d_last, ll_last),
                live,
                R, t,
            )
            return (R2, t2, done | (delta < tol), ll, delta), (ll, delta)

        return step

    z = jnp.zeros((), init_R.dtype)
    carry = (init_R, init_t, jnp.zeros((), bool), z, z)
    lls, deltas = [], []
    if n_horn:
        carry, (ll_h, d_h) = jax.lax.scan(_step("horn"), carry, None, length=n_horn)
        lls.append(ll_h)
        deltas.append(d_h)
    if n_wls:
        carry, (ll_w, d_w) = jax.lax.scan(_step("wls"), carry, None, length=n_wls)
        lls.append(ll_w)
        deltas.append(d_w)
    return carry[:3], jnp.concatenate(lls), jnp.concatenate(deltas)


def model_terms(params: MixtureParams):
    """Precompute the per-component terms every registration iteration
    reuses: W [10,K] packed logits, mu [K,3], A6 [K,6] packed precisions,
    b3 [K,3] = Sigma^-1 mu."""
    A, b, _ = precision_terms(params)
    return pack_loglik_weights(params), params.mu, sym_pack(A), b


@partial(
    jax.jit,
    static_argnames=("n_iters", "method", "top_k", "wls_inner"),
)
def register_points(
    source: jax.Array,
    params: MixtureParams,
    init_pose: Pose | None = None,
    n_iters: int = 50,
    method: str = "horn+wls",
    tol: float = 1e-7,
    top_k: int | None = None,
    outlier_logit: float | None = None,
    point_weights: jax.Array | None = None,
    wls_inner: int = 2,
) -> RegistrationResult:
    """Register `source` [N,3] onto a fitted mixture. Returns the pose T with
    T(source) ~ target."""
    if init_pose is None:
        init_pose = Pose.identity(source.dtype)
    W, mu, A6, b3 = model_terms(params)
    # Source buffer built once, outside the scan (ops.Prepared) — each
    # iteration re-reads only the static buffer.
    prep = ops.prepare(source, point_weights)

    def stats_fn(R, t):
        st = ops.reg_stats(
            prep, W, mu, A6, b3, (R, t), None, top_k, outlier_logit
        )
        return st.horn, st.A, st.b, st.loglik

    (R, t, done), logliks, deltas = run_registration_scan(
        stats_fn, init_pose.R, init_pose.t, n_iters, method, tol, wls_inner
    )
    return RegistrationResult(
        pose=Pose(R, t), logliks=logliks, deltas=deltas, converged=done
    )


def register_tree(
    source: jax.Array,
    tree: GmmTree,
    init_pose: Pose | None = None,
    n_iters: int = 50,
    method: str = "wls",
    tol: float = 1e-7,
    top_k: int | None = None,
    outlier_logit: float | None = None,
    point_weights: jax.Array | None = None,
    wls_inner: int = 2,
    complexity_threshold: float = 0.0,
) -> RegistrationResult:
    """Coarse-to-fine registration down the GMM tree (arXiv 1807.02587's
    multi-scale association, expressed level-synchronously): register
    against level 0 (branch components, wide basin), warm-start level 1,
    ..., finish on the leaf mixture (or the adaptive complexity cut).

    Registering directly against the leaves fails when the initial motion
    exceeds the leaf Gaussians' scale (measured: 0.4 m frame motion vs
    ~0.1 m leaves quenches at a local optimum); the coarse levels supply
    the basin, the fine levels the accuracy. `n_iters` is the PER-LEVEL
    iteration budget (convergence skipping makes coarse levels cheap).
    """
    pose = Pose.identity(source.dtype) if init_pose is None else init_pose
    levels = list(tree.levels)
    lls, deltas, res = [], [], None
    for li, params in enumerate(levels):
        if li == len(levels) - 1 and complexity_threshold > 0.0:
            params = tree.cut_mixture(complexity_threshold)
        res = register_points(
            source,
            params,
            init_pose=pose,
            n_iters=n_iters,
            method=method,
            tol=tol,
            top_k=top_k,
            outlier_logit=outlier_logit,
            point_weights=point_weights,
            wls_inner=wls_inner,
        )
        pose = res.pose
        lls.append(res.logliks)
        deltas.append(res.deltas)
    return RegistrationResult(
        pose=pose,
        logliks=jnp.concatenate(lls),
        deltas=jnp.concatenate(deltas),
        converged=res.converged,
    )


def register_pair(
    source: jax.Array,
    target: jax.Array | None = None,
    model: Gmm | GmmTree | MixtureParams | None = None,
    model_kind: str = "tree",
    k: int = 64,
    branch: int = 8,
    levels: int = 3,
    fit_iters: int = 20,
    complexity_threshold: float = 0.0,
    key: jax.Array | None = None,
    **register_kw,
) -> RegistrationResult:
    """End-to-end pairwise registration (SURVEY.md §4.2 entry point).

    Either pass `target` (a mixture is fitted to it) or a prefit `model`.
    model_kind: "flat" (config 1) or "tree" (config 2).
    """
    if model is None:
        assert target is not None, "need target cloud or prefit model"
        if model_kind == "flat":
            model, _ = Gmm.fit(target, k=k, n_iters=fit_iters, key=key)
        else:
            model, _ = GmmTree.fit(
                target, branch=branch, levels=levels, em_iters=fit_iters, key=key
            )
    if isinstance(model, GmmTree):
        return register_tree(
            source, model, complexity_threshold=complexity_threshold,
            **register_kw,
        )
    params = model.params if isinstance(model, Gmm) else model
    return register_points(source, params, **register_kw)
