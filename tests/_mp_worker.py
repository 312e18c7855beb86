"""Worker for the true multi-process distributed test (SURVEY.md §5.2:
"multi-process tests run the same program under jax.distributed.initialize
with N local processes on CPU").

Each process holds only ITS slice of the cloud (the multi-host ingest path:
parallel.mesh.shard_points_from_host), joins the process group via
parallel.mesh.initialize_multihost, and runs the sharded EM program.
Process 0 writes the fitted params for the parent test to compare against
the single-process oracle.

Usage: python _mp_worker.py <coordinator> <num_processes> <process_id> <out.npz>
"""

import sys

import jax

# CPU processes, set BEFORE any backend initializes: N processes can then
# coexist without fighting over a GPU.
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main() -> None:
    coord, nproc, pid, out = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    sys.path.insert(0, __file__.rsplit("/", 2)[0])

    # initialize_multihost must run before ANY backend-touching import
    # (several hgmm modules build jnp constants at import time).
    from hgmm.parallel.mesh import (
        initialize_multihost,
        make_mesh,
        shard_points_from_host,
    )

    initialize_multihost(coord, nproc, pid)

    from hgmm.models.gmm import init_params
    from hgmm.parallel.sharded import sharded_em_fit, sharded_register_points
    from hgmm.models.se3 import Pose, so3_exp
    from hgmm.data.synthetic import make_cloud
    assert jax.process_count() == nproc, jax.process_count()
    mesh = make_mesh()

    n = 512
    # Structured (helix) cloud: a rotationally-symmetric blob would make the
    # registration pose unidentifiable.
    pts_all = np.asarray(make_cloud(jax.random.PRNGKey(0), n, kind="helix"))
    per = n // nproc
    local = jnp.asarray(pts_all[pid * per : (pid + 1) * per])
    # Multi-host ingest: each process device_puts ONLY its slice; the global
    # array spans the full process-spanning mesh.
    pts = shard_points_from_host(local, mesh)
    assert pts.shape[0] == n, pts.shape

    init = init_params(jnp.asarray(pts_all), 8, jax.random.PRNGKey(1))
    params, lls = sharded_em_fit(pts, init, mesh, n_iters=5)

    # Registration over the same process-spanning mesh: recover a known pose.
    gt = Pose(so3_exp(jnp.array([0.0, 0.0, 0.2])), jnp.array([0.1, -0.05, 0.02]))
    src_all = np.asarray(gt.inverse().apply(jnp.asarray(pts_all)))
    src = shard_points_from_host(
        jnp.asarray(src_all[pid * per : (pid + 1) * per]), mesh
    )
    reg = sharded_register_points(src, params, mesh, n_iters=20, method="horn")

    # Distributed pose-graph over the SAME process-spanning mesh
    # (BASELINE.json:11 "psum EM + pose-graph refinement over N>=2 hosts"):
    # segment-wise Schur with a loop closure + robust kernel; every process
    # runs the identical replicated program, keyframe psums cross the
    # process boundary.
    from hgmm.models.se3 import random_pose
    from hgmm.pipelines.pose_graph import EdgeList, refine_chain_sharded

    s_mesh = int(mesh.devices.size)
    m = 2 * s_mesh + 3
    keys = jax.random.split(jax.random.PRNGKey(11), 2 * m)
    gt_nodes = [Pose.identity()]
    rels = []
    for k in range(m - 1):
        step = random_pose(keys[k], 0.1, 0.2)
        rels.append(step)
        gt_nodes.append(gt_nodes[-1].compose(step))
    noisy = [
        r.compose(random_pose(keys[m + k], 0.02, 0.02))
        for k, r in enumerate(rels)
    ]
    init_nodes = [gt_nodes[0]]
    for z in noisy:
        init_nodes.append(init_nodes[-1].compose(z))
    R0 = jnp.stack([p.R for p in init_nodes])
    t0 = jnp.stack([p.t for p in init_nodes])
    lc = gt_nodes[1].inverse().compose(gt_nodes[m - 2])
    closures = EdgeList(
        i=jnp.array([1], jnp.int32), j=jnp.array([m - 2], jnp.int32),
        R=lc.R[None], t=lc.t[None], weight=jnp.array([5.0]),
    )
    pg = refine_chain_sharded(
        R0, t0,
        jnp.stack([z.R for z in noisy]), jnp.stack([z.t for z in noisy]),
        mesh, n_iters=6, damping=1e-8, closures=closures, robust_delta=5.0,
    )

    if pid == 0:
        np.savez(
            out,
            pi=np.asarray(params.pi),
            mu=np.asarray(params.mu),
            sigma=np.asarray(params.sigma),
            lls=np.asarray(lls),
            R=np.asarray(reg.pose.R),
            t=np.asarray(reg.pose.t),
            gt_R=np.asarray(gt.R),
            gt_t=np.asarray(gt.t),
            pg_R=np.asarray(pg.R),
            pg_t=np.asarray(pg.t),
            pg_cost=np.asarray(pg.residual_history),
            pg_R0=np.asarray(R0),
            pg_t0=np.asarray(t0),
            pg_relR=np.asarray(jnp.stack([z.R for z in noisy])),
            pg_relt=np.asarray(jnp.stack([z.t for z in noisy])),
            pg_lcR=np.asarray(lc.R),
            pg_lct=np.asarray(lc.t),
        )
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
