"""Pose-graph optimization: Gauss-Newton on SE(3) with exact autodiff
Jacobians, plus a distributed Schur-complement solver for odometry chains
(BASELINE.json:5 "pose-graph/bundle-adjustment stage uses Schur-complement
reduction over collectives with keyframes/map blocks partitioned per
host"; papers: PAPERS.md 2209.02207, 1805.12279).

Parametrization: right-perturbation T_i <- T_i * Exp(xi_i). Edge residual
r_e = Log(Z_e^-1 * T_i^-1 * T_j) in R^6; per-edge 6x6 Jacobians come from
jax.jacfwd of the residual at xi = 0 — exact, no hand-derived adjoints to
get wrong, and still fully jittable (the graph is a fixed-size batch of
edges; SURVEY.md §3.6).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from hgmm.models.se3 import Pose, se3_exp, se3_log


class EdgeList(NamedTuple):
    """Fixed-size batch of relative-pose constraints i -> j."""

    i: jax.Array  # [E] int32 source node
    j: jax.Array  # [E] int32 target node
    R: jax.Array  # [E, 3, 3] measured relative rotation (frame i -> j)
    t: jax.Array  # [E, 3] measured relative translation
    weight: jax.Array  # [E] scalar information weight


def odometry_chain_edges(rel_poses: list[Pose] | tuple[Pose, ...]) -> EdgeList:
    """Edges (k, k+1) from a list of frame-to-frame relative poses
    (Z_k = pose of frame k+1 expressed in frame k)."""
    e = len(rel_poses)
    return EdgeList(
        i=jnp.arange(e, dtype=jnp.int32),
        j=jnp.arange(1, e + 1, dtype=jnp.int32),
        R=jnp.stack([p.R for p in rel_poses]),
        t=jnp.stack([p.t for p in rel_poses]),
        weight=jnp.ones((e,), jnp.float32),
    )


def concat_edge_lists(a: EdgeList, b: EdgeList) -> EdgeList:
    return EdgeList(
        i=jnp.concatenate([a.i, b.i]),
        j=jnp.concatenate([a.j, b.j]),
        R=jnp.concatenate([a.R, b.R]),
        t=jnp.concatenate([a.t, b.t]),
        weight=jnp.concatenate([a.weight, b.weight]),
    )


def _edge_residual(xi_i, xi_j, Ti_R, Ti_t, Tj_R, Tj_t, Z_R, Z_t):
    Ti = Pose(Ti_R, Ti_t).compose(se3_exp(xi_i))
    Tj = Pose(Tj_R, Tj_t).compose(se3_exp(xi_j))
    Z = Pose(Z_R, Z_t)
    return se3_log(Z.inverse().compose(Ti.inverse().compose(Tj)))


_res_and_jacs = jax.vmap(
    lambda TiR, Tit, TjR, Tjt, ZR, Zt: (
        _edge_residual(jnp.zeros(6), jnp.zeros(6), TiR, Tit, TjR, Tjt, ZR, Zt),
        jax.jacfwd(_edge_residual, argnums=0)(
            jnp.zeros(6), jnp.zeros(6), TiR, Tit, TjR, Tjt, ZR, Zt
        ),
        jax.jacfwd(_edge_residual, argnums=1)(
            jnp.zeros(6), jnp.zeros(6), TiR, Tit, TjR, Tjt, ZR, Zt
        ),
    )
)


class PoseGraphResult(NamedTuple):
    R: jax.Array  # [M, 3, 3]
    t: jax.Array  # [M, 3]
    residual_history: jax.Array  # [n_iters] sum of squared residuals

    def poses(self) -> list[Pose]:
        return [Pose(self.R[m], self.t[m]) for m in range(self.R.shape[0])]


def _robust_weight(weight, res, robust_delta):
    """IRLS Geman-McClure reweighting: the edge weight is scaled by
    (delta^2 / (delta^2 + ||r||^2))^2 — ~1 for residuals below delta,
    ~(delta/||r||)^4 above it. The kernel is REDESCENDING: a false loop
    closure (gross outlier constraint) is effectively switched OFF rather
    than merely bounded (a Huber/linear penalty still exerts a constant
    weight*delta pull that measurably bends the whole graph — tested).
    None = pure GN."""
    if robust_delta is None:
        return weight
    r2 = jnp.sum(res * res, axis=1)
    d2 = robust_delta * robust_delta
    return weight * (d2 / (d2 + r2)) ** 2


def refine_pose_graph(
    R: jax.Array,  # [M, 3, 3] initial absolute poses
    t: jax.Array,  # [M, 3]
    edges: EdgeList,
    n_iters: int = 10,
    damping: float = 1e-6,
    gauge_weight: float = 1e8,
    robust_delta: float | None = None,
) -> PoseGraphResult:
    """Dense Gauss-Newton (single device; M up to a few hundred). Node 0 is
    gauge-fixed by a strong prior. robust_delta: see _robust_weight.

    Edge endpoints are validated eagerly when concrete: under jit an
    out-of-range gather CLAMPS, silently pinning a bad constraint to node
    M-1 (same contract as refine_chain_sharded's closure validation)."""
    import numpy as np

    m = int(R.shape[0])
    if not isinstance(edges.i, jax.core.Tracer):
        idx = np.concatenate([np.asarray(edges.i), np.asarray(edges.j)])
        bad = idx[(idx < 0) | (idx >= m)]
        if bad.size:
            raise ValueError(
                f"edge endpoints {sorted(set(bad.tolist()))} out of range "
                f"for {m} nodes"
            )
    return _refine_pose_graph_jit(
        R, t, edges, n_iters, damping, gauge_weight, robust_delta
    )


@functools.partial(
    jax.jit, static_argnames=("n_iters", "robust_delta")
)
def _refine_pose_graph_jit(
    R, t, edges, n_iters, damping, gauge_weight, robust_delta
) -> PoseGraphResult:
    m = R.shape[0]

    def gn_step(carry, _):
        R, t = carry
        res, Ji, Jj = _res_and_jacs(
            R[edges.i], t[edges.i], R[edges.j], t[edges.j], edges.R, edges.t
        )  # [E,6], [E,6,6], [E,6,6]
        w_r = _robust_weight(edges.weight, res, robust_delta)
        w = w_r[:, None, None]
        H = jnp.zeros((m, m, 6, 6), R.dtype)
        H = H.at[edges.i, edges.i].add(w * jnp.einsum("eai,eaj->eij", Ji, Ji))
        H = H.at[edges.j, edges.j].add(w * jnp.einsum("eai,eaj->eij", Jj, Jj))
        H = H.at[edges.i, edges.j].add(w * jnp.einsum("eai,eaj->eij", Ji, Jj))
        H = H.at[edges.j, edges.i].add(w * jnp.einsum("eai,eaj->eij", Jj, Ji))
        g = jnp.zeros((m, 6), R.dtype)
        g = g.at[edges.i].add(
            w_r[:, None] * jnp.einsum("eai,ea->ei", Ji, res)
        )
        g = g.at[edges.j].add(
            w_r[:, None] * jnp.einsum("eai,ea->ei", Jj, res)
        )
        # Gauge prior on node 0 + Levenberg damping.
        H = H.at[0, 0].add(gauge_weight * jnp.eye(6, dtype=R.dtype))
        Hd = H.transpose(0, 2, 1, 3).reshape(6 * m, 6 * m)
        Hd = Hd + damping * jnp.eye(6 * m, dtype=R.dtype)
        delta = -jnp.linalg.solve(Hd, g.reshape(6 * m)).reshape(m, 6)
        upd = jax.vmap(se3_exp)(delta)
        R_new = jnp.einsum("mij,mjk->mik", R, upd.R)
        t_new = t + jnp.einsum("mij,mj->mi", R, upd.t)
        cost = jnp.sum(w_r * jnp.sum(res * res, axis=1))
        return (R_new, t_new), cost

    (R_out, t_out), costs = jax.lax.scan(gn_step, (R, t), None, length=n_iters)
    return PoseGraphResult(R_out, t_out, costs)


# ---------------------------------------------------------------------------
# Distributed Schur complement for odometry chains
# ---------------------------------------------------------------------------

def _can_shard_chain(m: int, s: int) -> bool:
    """Shardability condition, shared by refine_chain_sharded's fallback
    check and _chain_segmentation's None return so the two cannot drift
    (round-5 review item)."""
    return m - 1 >= s


def _chain_segmentation(m: int, s: int, closure_nodes):
    """Host-side static segmentation of an M-node chain over S devices,
    with a generalized RETAINED-NODE set (round-5: the S+1-keyframe closure
    budget is gone — closure endpoints interior to a segment stay interior
    and are simply excluded from that segment's Schur elimination, joining
    the global reduced system alongside the segment boundaries).

    Returns None only when the chain is too short to shard (m-1 < s), else
    a dict of numpy index arrays:
      bounds [S+1]      global node ids of the segment boundaries (even
                        split of the chain; NOT closure-driven)
      node_idx [S, L+1] slot -> global node id per segment (unused slots
                        alias the left boundary so pose gathers stay valid)
      pi, pj [S, L]     local slot endpoints of each edge slot
      eidx [S, L]       global chain-edge id of each edge slot (0 for pads)
      emask [S, L]      True where the edge slot carries a real chain edge
      perm [S, L+1]     slot permutation: the P retained slots first
                        (boundaries + closure endpoints + inert pad-slot
                        dummies), then the L+1-P interior slots to eliminate
      ret_gidx [S, P]   global reduced-system index of each retained slot
      gnode [G]         global node id per reduced index (M = dump row for
                        dummy pad slots, whose rows are damping-only)
      int_scatter [S*(L+1-P)] global node id of each eliminated interior
                        slot, or M (dump) for unused alias slots
      gid_of            dict node id -> reduced index (for closure edges)
      l_seg, p_ret, n_int, g_tot
    """
    import numpy as np

    if not _can_shard_chain(m, s):
        return None
    # Integer even split: consecutive bounds differ by >= 1 when m-1 >= s.
    bounds = np.array([(d * (m - 1)) // s for d in range(s + 1)], np.int64)
    closure_set = sorted(
        {int(x) for x in closure_nodes} - set(bounds.tolist())
    )
    interior_by_seg: list[list[int]] = [[] for _ in range(s)]
    for x in closure_set:
        d = int(np.searchsorted(bounds, x, side="right") - 1)
        interior_by_seg[d].append(x)
    rmax = max((len(v) for v in interior_by_seg), default=0)
    seg_len = bounds[1:] - bounds[:-1]  # [S] real edges per segment
    # Slot count: the longest segment PLUS rmax extra inert alias slots, so
    # (a) every segment — including full-length ones — can pad its
    # retained set to the common width P with EDGE-FREE dummy slots
    # (damping-only rows, provably decoupled, all sharing ONE dump index
    # in the reduced system: g_tot stays |boundaries ∪ closures| + 1
    # regardless of how closures cluster — without this, clustered
    # closures forced real interior slots in as fillers with unique
    # indices, inflating the replicated solve to O((S*C)^2); round-5
    # review item), and (b) at least one interior slot always remains to
    # eliminate (n_int >= 1 keeps the Schur shapes non-empty).
    l_seg = max(2, int(seg_len.max()) + rmax, rmax + 2)
    p_ret = 2 + rmax
    n_int = l_seg + 1 - p_ret  # >= 1 by construction
    node_idx = np.zeros((s, l_seg + 1), np.int32)
    pi = np.zeros((s, l_seg), np.int32)
    pj = np.zeros((s, l_seg), np.int32)
    eidx = np.zeros((s, l_seg), np.int32)
    emask = np.zeros((s, l_seg), bool)
    perm = np.zeros((s, l_seg + 1), np.int32)
    ret_gidx = np.zeros((s, p_ret), np.int32)
    int_scatter = np.full((s, n_int), m, np.int32)
    # Reduced-system indexing: boundaries and closure endpoints first
    # (shared vocabulary with the closure blocks), then ONE shared dump
    # index for every inert pad dummy (their rows are damping-only and
    # fully decoupled — pad slots carry no edges — so summing them on a
    # single row is exact and keeps the replicated solve at
    # |boundaries ∪ closures| + 1 nodes).
    gnode = sorted(set(bounds.tolist()) | set(closure_set))
    gid_of = {n: g for g, n in enumerate(gnode)}
    dump_gid = len(gnode)
    gnode = gnode + [m]
    for d in range(s):
        b0, b1 = int(bounds[d]), int(bounds[d + 1])
        ld = b1 - b0
        # Slots 0..ld-1 walk the real path from the left boundary; slot
        # l_seg is the right boundary; slots ld..l_seg-1 are unused (alias
        # b0 so residual evaluation stays finite — their edges get weight
        # 0 AND touch no slot, so their rows are damping-only: the
        # reduction is EXACT, not a stiff-penalty approximation).
        node_idx[d, :ld] = b0 + np.arange(ld)
        node_idx[d, ld:l_seg] = b0
        node_idx[d, l_seg] = b1
        pi[d, :ld] = np.arange(ld)
        pj[d, : ld - 1] = np.arange(1, ld)
        pj[d, ld - 1] = l_seg  # last real edge couples into the right bound
        eidx[d, :ld] = b0 + np.arange(ld)
        emask[d, :ld] = True
        # Retained slots: both boundaries, this segment's closure
        # endpoints, then edge-free alias-pad dummies (l_seg grants every
        # segment at least rmax of them, so dummies are ALWAYS inert pad
        # slots sharing the single dump index — never real nodes).
        r_slots = [x - b0 for x in interior_by_seg[d]]
        ret = [0, l_seg] + r_slots
        gq = [gid_of[b0], gid_of[b1]] + [gid_of[x] for x in interior_by_seg[d]]
        used = set(ret)
        for cand in range(ld, l_seg):
            if len(ret) == p_ret:
                break
            ret.append(cand)
            used.add(cand)
            gq.append(dump_gid)
        assert len(ret) == p_ret, (d, ld, l_seg, p_ret)
        nonret = [x for x in range(l_seg + 1) if x not in used]
        perm[d] = ret + nonret
        ret_gidx[d] = gq
        int_scatter[d] = [
            (b0 + x if 0 < x < ld else m) for x in nonret
        ]
    return dict(
        bounds=bounds.astype(np.int32), node_idx=node_idx, pi=pi, pj=pj,
        eidx=eidx, emask=emask, perm=perm, ret_gidx=ret_gidx,
        gnode=np.asarray(gnode, np.int32), int_scatter=int_scatter,
        gid_of=gid_of, l_seg=l_seg, p_ret=p_ret, n_int=n_int,
        g_tot=len(gnode),
    )


def refine_chain_sharded(
    R: jax.Array,
    t: jax.Array,
    edge_R: jax.Array,  # [M-1, 3, 3] measured relative rotations k -> k+1
    edge_t: jax.Array,  # [M-1, 3]
    mesh,
    n_iters: int = 10,
    damping: float = 1e-6,
    gauge_weight: float = 1e8,
    edge_weight: jax.Array | None = None,  # [M-1] chain-edge weights
    closures: EdgeList | None = None,  # loop closures (concrete node ids)
    robust_delta: float | None = None,  # IRLS robust gate (see _robust_weight)
) -> PoseGraphResult:
    """Distributed GN for an odometry chain via segment-wise Schur
    complement over collectives (BASELINE.json:5; SURVEY.md §2.2 row 3).

    The chain of M nodes splits EVENLY into S = n_devices segments; the
    RETAINED set of the Schur reduction is the S+1 segment boundaries plus
    every loop-closure endpoint (round-5: closure endpoints no longer need
    to BE boundaries, so there is no S+1 closure budget — a segment simply
    skips eliminating its closure-endpoint slots and they join the global
    reduced system). Segments are padded to a common slot count L with
    edge-free weight-0 alias slots, so arbitrary chain lengths reduce
    EXACTLY (no stiff-penalty approximation). Per GN iteration each device:
      1. builds its local segment normal equations over L+1 slots,
      2. Schur-eliminates its NON-retained interior slots with a local
         dense solve (a static slot permutation puts retained slots first),
      3. psums its reduced (6P)^2 retained-block contribution into the
         global G-node reduced system (G = S+1 boundaries + closure
         endpoints + inert pad dummies) — the ONLY cross-device traffic,
         O((S + C)^2) bytes for C closures,
      4. solves the tiny reduced system (replicated, with the closure
         blocks added once after the psum — closures connect retained
         nodes by construction, zero extra collective traffic) and
         back-substitutes its eliminated interior locally.
    Matches refine_pose_graph up to damping placement and fp error
    (tests/test_pose_graph.py asserts this, with and without closures,
    including C >> S closures).

    Falls back to the dense solver only when the chain is too short to
    shard (M-1 < n_devices) — that regime is small enough that the dense
    solve is the right tool.

    closures: endpoints must be CONCRETE (host) values — they determine
    the static retained-slot placement.
    """
    import numpy as np

    s = int(mesh.devices.size)
    m = int(R.shape[0])
    dtype = R.dtype
    if edge_weight is None:
        edge_weight = jnp.ones((m - 1,), dtype)

    closure_nodes = ()
    if closures is not None and int(np.asarray(closures.i).shape[0]) > 0:
        closure_nodes = [int(x) for x in np.asarray(closures.i)] + [
            int(x) for x in np.asarray(closures.j)
        ]
        # Validate eagerly: under jit an out-of-range gather index CLAMPS
        # (a closure at node m would silently pin node m-1) — raise, don't
        # fall through to a quietly-corrupted dense solve.
        bad = [x for x in closure_nodes if x < 0 or x >= m]
        if bad:
            raise ValueError(
                f"closure endpoints {bad} out of range for {m} nodes"
            )
    else:
        closures = None

    # Same condition as _chain_segmentation's None return (shared helper),
    # tested directly so the cached program factory is the only place the
    # index arrays are actually built (round-5 review item: the caller
    # previously built and discarded the full segmentation per call).
    if not _can_shard_chain(m, s):
        if m > 512:
            # The dense solver materializes an [M, M, 6, 6] Hessian — at
            # KITTI scale that is a silent OOM/stall, not a fallback.
            # Unreachable for m - 1 >= n_devices (the retained-node
            # reduction has no closure budget); kept as a guard.
            import warnings

            warnings.warn(
                f"refine_chain_sharded: cannot shard {m}-node chain over "
                f"{s} devices (m - 1 < n_devices); falling back to the "
                f"DENSE O(M^3) solver — expect high memory/time at this "
                f"scale",
                stacklevel=2,
            )
        edges = EdgeList(
            i=jnp.arange(m - 1, dtype=jnp.int32),
            j=jnp.arange(1, m, dtype=jnp.int32),
            R=edge_R, t=edge_t, weight=edge_weight,
        )
        if closures is not None:
            edges = concat_edge_lists(edges, closures)
        return refine_pose_graph(
            R, t, edges, n_iters=n_iters, damping=damping,
            gauge_weight=gauge_weight, robust_delta=robust_delta,
        )

    cl_key = None
    if closures is not None:
        cl_key = (
            tuple(int(x) for x in np.asarray(closures.i)),
            tuple(int(x) for x in np.asarray(closures.j)),
        )
        cl_args = (closures.R, closures.t, closures.weight)
    else:
        cl_args = (
            jnp.zeros((0, 3, 3), dtype),
            jnp.zeros((0, 3), dtype),
            jnp.zeros((0,), dtype),
        )
    run = _sharded_chain_program(
        mesh, m, n_iters, float(damping), float(gauge_weight),
        None if robust_delta is None else float(robust_delta),
        jnp.dtype(dtype).name, cl_key,
    )
    R_out, t_out, costs = run(R, t, edge_R, edge_t, edge_weight, *cl_args)
    return PoseGraphResult(R_out, t_out, costs)


@functools.lru_cache(maxsize=64)
def _sharded_chain_program(
    mesh, m, n_iters, damping, gauge_weight, robust_delta, dtype_name, cl_key
):
    """Compiled sharded chain-GN program, cached per (mesh, chain length,
    closure ENDPOINTS, solver scalars) rather than rebuilt and re-jitted
    on every call. Edge/closure MEASUREMENTS are traced
    arguments, so repeated refinement of the same-shaped graph (the
    production odometry loop, IRLS re-runs, the benchmark suite) reuses
    the executable."""
    import numpy as np

    from jax.sharding import PartitionSpec as P

    from hgmm.parallel.mesh import POINTS_AXIS

    s = int(mesh.devices.size)
    dtype = jnp.dtype(dtype_name)
    closure_nodes = () if cl_key is None else (cl_key[0] + cl_key[1])
    seg = _chain_segmentation(m, s, closure_nodes)
    l_seg = seg["l_seg"]
    p_ret = seg["p_ret"]
    n_int = seg["n_int"]
    g_tot = seg["g_tot"]
    eye6 = jnp.eye(6, dtype=dtype)
    node_idx = jnp.asarray(seg["node_idx"])  # [S, L+1]
    pi_segs = jnp.asarray(seg["pi"])  # [S, L]
    pj_segs = jnp.asarray(seg["pj"])
    perm_segs = jnp.asarray(seg["perm"])  # [S, L+1]
    retg_segs = jnp.asarray(seg["ret_gidx"])  # [S, P]
    gnode = jnp.asarray(seg["gnode"])  # [G] node id (m = dump)
    int_scatter = jnp.asarray(seg["int_scatter"]).reshape(-1)  # [S*n_int]
    emask = jnp.asarray(seg["emask"])
    eidx = jnp.asarray(seg["eidx"])

    if cl_key is not None:
        gid_of = seg["gid_of"]
        cl_i = np.asarray(cl_key[0], np.int32)
        cl_j = np.asarray(cl_key[1], np.int32)
        cl_ki = jnp.asarray([gid_of[int(x)] for x in cl_i], jnp.int32)
        cl_kj = jnp.asarray([gid_of[int(x)] for x in cl_j], jnp.int32)

    def closure_blocks(R_all, t_all, cl_R, cl_t, cl_w):
        """GN blocks of the closure edges on the G-node reduced system,
        computed replicated (O(C) tiny work per device)."""
        HK = jnp.zeros((g_tot, g_tot, 6, 6), dtype)
        gK = jnp.zeros((g_tot, 6), dtype)
        if cl_key is None:
            return HK, gK, jnp.zeros((), dtype)
        res, Ji, Jj = _res_and_jacs(
            R_all[cl_i], t_all[cl_i], R_all[cl_j], t_all[cl_j], cl_R, cl_t
        )
        w_r = _robust_weight(cl_w, res, robust_delta)
        w = w_r[:, None, None]
        HK = HK.at[cl_ki, cl_ki].add(w * jnp.einsum("eai,eaj->eij", Ji, Ji))
        HK = HK.at[cl_kj, cl_kj].add(w * jnp.einsum("eai,eaj->eij", Jj, Jj))
        HK = HK.at[cl_ki, cl_kj].add(w * jnp.einsum("eai,eaj->eij", Ji, Jj))
        HK = HK.at[cl_kj, cl_ki].add(w * jnp.einsum("eai,eaj->eij", Jj, Ji))
        gK = gK.at[cl_ki].add(
            w_r[:, None] * jnp.einsum("eai,ea->ei", Ji, res)
        )
        gK = gK.at[cl_kj].add(
            w_r[:, None] * jnp.einsum("eai,ea->ei", Jj, res)
        )
        cost = jnp.sum(w_r * jnp.sum(res * res, axis=1))
        return HK, gK, cost

    @jax.jit
    def run(R, t, edge_R, edge_t, edge_weight, cl_R, cl_t, cl_w):
        # Per-slot edge measurements/weights; pad slots carry identity Z
        # and weight 0 (inert).
        zR_segs = jnp.where(
            emask[..., None, None], edge_R[eidx], jnp.eye(3, dtype=dtype)
        )  # [S, L, 3, 3]
        zt_segs = jnp.where(emask[..., None], edge_t[eidx], 0.0)
        w_segs = jnp.where(emask, edge_weight[eidx], 0.0).astype(dtype)
        def gn_step(carry, _):
            R_all, t_all = carry
            R_segs = R_all[node_idx]  # [S, L+1, 3, 3]
            t_segs = t_all[node_idx]
            HK_cl, gK_cl, cost_cl = closure_blocks(
                R_all, t_all, cl_R, cl_t, cl_w
            )

            @functools.partial(
                jax.shard_map,
                mesh=mesh,
                # Pure-jnp body (no Pallas) — keep the vma audit on.
                check_vma=True,
                in_specs=(P(POINTS_AXIS),) * 9 + (P(), P()),
                out_specs=(P(POINTS_AXIS), P(None), P()),
            )
            def seg_step(R_seg_s, t_seg_s, zR_s, zt_s, w_s, pi_s, pj_s,
                         perm_s, retg_s, HK_cl, gK_cl):
                R_seg, t_seg = R_seg_s[0], t_seg_s[0]  # [L+1, ...]
                zR, zt, w = zR_s[0], zt_s[0], w_s[0]  # [L, ...]
                pi, pj = pi_s[0], pj_s[0]  # [L]
                perm, retg = perm_s[0], retg_s[0]  # [L+1], [P]
                d = jax.lax.axis_index(POINTS_AXIS)

                # --- 1. local normal equations over L+1 slots (scatter by
                # the static slot-endpoint arrays; weight-0 pad edges are
                # inert so the padded system is EXACTLY the real one plus
                # damping-only unused slots).
                res, Ji, Jj = _res_and_jacs(
                    R_seg[pi], t_seg[pi], R_seg[pj], t_seg[pj], zR, zt
                )
                w = _robust_weight(w, res, robust_delta)
                wJ = w[:, None, None]
                A = jnp.zeros((l_seg + 1, l_seg + 1, 6, 6), dtype)
                A = A.at[pi, pi].add(wJ * jnp.einsum("eai,eaj->eij", Ji, Ji))
                A = A.at[pj, pj].add(wJ * jnp.einsum("eai,eaj->eij", Jj, Jj))
                A = A.at[pi, pj].add(wJ * jnp.einsum("eai,eaj->eij", Ji, Jj))
                A = A.at[pj, pi].add(wJ * jnp.einsum("eai,eaj->eij", Jj, Ji))
                g = jnp.zeros((l_seg + 1, 6), dtype)
                g = g.at[pi].add(w[:, None] * jnp.einsum("eai,ea->ei", Ji, res))
                g = g.at[pj].add(w[:, None] * jnp.einsum("eai,ea->ei", Jj, res))
                # Gauge prior on global node 0 (device 0's left boundary,
                # slot 0) + Levenberg damping on every slot.
                A = A.at[0, 0].add(jnp.where(d == 0, gauge_weight, 0.0) * eye6)
                diag = jnp.arange(l_seg + 1)
                A = A.at[diag, diag].add(damping * eye6)

                # --- 2. permute retained slots first, Schur-eliminate the
                # trailing n_int non-retained interior slots.
                Ap = A[perm][:, perm]
                gp = g[perm]
                A_KK_d = (
                    Ap[:p_ret, :p_ret]
                    .transpose(0, 2, 1, 3)
                    .reshape(6 * p_ret, 6 * p_ret)
                )
                A_II_d = (
                    Ap[p_ret:, p_ret:]
                    .transpose(0, 2, 1, 3)
                    .reshape(6 * n_int, 6 * n_int)
                )
                A_IK_d = (
                    Ap[p_ret:, :p_ret]
                    .transpose(0, 2, 1, 3)
                    .reshape(6 * n_int, 6 * p_ret)
                )
                g_I = gp[p_ret:].reshape(6 * n_int)
                rhs = jnp.concatenate([A_IK_d, g_I[:, None]], axis=1)
                sol = jnp.linalg.solve(A_II_d, rhs)  # [6n_int, 6P+1]
                X = sol[:, :-1]  # A_II^-1 A_IK
                y = sol[:, -1]  # A_II^-1 g_I
                S_red = A_KK_d - A_IK_d.T @ X  # [6P, 6P]
                g_red = gp[:p_ret].reshape(-1) - A_IK_d.T @ y

                # --- 3. psum into the global G-node reduced system; the
                # replicated closure blocks join AFTER the psum (added once).
                HK = jnp.zeros((g_tot, g_tot, 6, 6), dtype)
                blocks = (
                    S_red.reshape(p_ret, 6, p_ret, 6).transpose(0, 2, 1, 3)
                )
                HK = HK.at[retg[:, None], retg[None, :]].add(blocks)
                gK = jnp.zeros((g_tot, 6), dtype)
                gK = gK.at[retg].add(g_red.reshape(p_ret, 6))
                HK = jax.lax.psum(HK, POINTS_AXIS) + HK_cl
                gK = jax.lax.psum(gK, POINTS_AXIS) + gK_cl

                # --- 4. replicated reduced solve + local back-substitution.
                HK_d = HK.transpose(0, 2, 1, 3).reshape(6 * g_tot, 6 * g_tot)
                HK_d = HK_d + damping * jnp.eye(6 * g_tot, dtype=dtype)
                delta_G = -jnp.linalg.solve(HK_d, gK.reshape(-1))
                delta_G = delta_G.reshape(g_tot, 6)
                dk_local = delta_G[retg].reshape(-1)  # [6P]
                delta_I = -(y + X @ dk_local).reshape(n_int, 6)

                cost = jax.lax.psum(jnp.sum(w * jnp.sum(res * res, 1)),
                                    POINTS_AXIS)
                return delta_I[None], delta_G, cost

            delta_int, delta_G, cost = seg_step(
                R_segs, t_segs, zR_segs, zt_segs, w_segs, pi_segs, pj_segs,
                perm_segs, retg_segs, HK_cl, gK_cl,
            )
            # Stitch: retained deltas land at their global nodes (dummy
            # pad entries hit the dump row m, discarded below), eliminated
            # interior deltas scatter to theirs.
            delta = jnp.zeros((m + 1, 6), dtype)
            delta = delta.at[gnode].set(delta_G)
            delta = delta.at[int_scatter].set(
                delta_int.reshape(s * n_int, 6)
            )[:m]
            upd = jax.vmap(se3_exp)(delta)
            R_new = jnp.einsum("mij,mjk->mik", R_all, upd.R)
            t_new = t_all + jnp.einsum("mij,mj->mi", R_all, upd.t)
            return (R_new, t_new), cost + cost_cl

        (R_out, t_out), costs = jax.lax.scan(gn_step, (R, t), None, length=n_iters)
        return R_out, t_out, costs

    return run
