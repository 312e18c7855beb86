#!/usr/bin/env python
"""End-to-end odometry-pipeline throughput (round-4 verdict item 2): the
flagship config-4 workload — a ~64-frame synthetic KITTI-scale loop
sequence driven through run_odometry (tree model, bucket 16384 by
default) — measured on the chip as frames/sec with a per-phase breakdown:

  fit       per-frame target-model fits (_fit_frame_model)
  register  per-pair registrations onto the previous frame's model
  closures  detect_loop_closures (proposal + registration verification)
  refine    pose-graph refinement (dense, or distributed Schur with
            --sharded)
  e2e       one run_odometry(detect_closures=True) + refine_odometry call
            (the headline frames/sec a user gets)

Timing is wall-clock, each phase closed by jax.block_until_ready.
Dispatches are asynchronous, so a phase also pays any host-side value
reads inside its loop (the closure phase reads convergence/loglik
scalars per candidate); the harness reports the dispatched-call count
per phase. Every line names the device. Exits non-zero without a GPU
unless --cpu is given. The sequence is hgmm.data.synthetic's
make_loop_sequence.

Usage: python benchmarks/odometry_suite.py [--frames 64] [--bucket 16384]
       [--model tree] [--sharded] [--cpu] [--skip-e2e]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--bucket", type=int, default=16384)
    ap.add_argument("--model", choices=("tree", "flat"), default="tree")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--skip-e2e", action="store_true",
                    help="phase breakdown only (halves chip time)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from hgmm.utils.runtime import device_record, enable_compile_cache, require_gpu

    require_gpu(cpu_ok=args.cpu)
    enable_compile_cache()
    device = device_record()
    from hgmm.data.synthetic import make_loop_sequence
    from hgmm.eval.metrics import ate
    from hgmm.models.se3 import Pose
    from hgmm.pipelines.loop_closure import ClosureConfig, detect_loop_closures
    from hgmm.pipelines.odometry import (
        OdometryConfig,
        OdometryResult,
        _bucketize,
        _fit_frame_model,
        _register_to_model,
        refine_odometry,
        run_odometry,
    )
    print(
        f"backend={jax.default_backend()} frames={args.frames} "
        f"bucket={args.bucket} model={args.model} sharded={args.sharded}",
        file=sys.stderr,
    )
    cfg = OdometryConfig(
        model_kind=args.model, bucket=args.bucket, seed=0,
        fit_iters=10, reg_iters=30, outlier_logit=-8.0,
    )
    mesh = None
    if args.sharded:
        from hgmm.parallel import make_mesh

        mesh = make_mesh()
    scans, gt = make_loop_sequence(args.frames, max(40_000, 3 * args.bucket))
    rng = np.random.default_rng(cfg.seed)
    frames = [_bucketize(s, cfg.bucket, rng) for s in scans]
    f = len(frames)
    base_key = jax.random.PRNGKey(cfg.seed)
    sync = jax.block_until_ready

    def report(phase, wall, n_items, n_calls, **extra):
        print(
            json.dumps(
                {
                    "phase": phase,
                    "wall_s": wall,
                    "items": n_items,
                    "per_item_ms": 1e3 * wall / max(n_items, 1),
                    "dispatched_calls": n_calls,
                    "device": device,
                    **extra,
                }
            )
        )

    # --- warmup: compile every program on frame 0 / pair (0,1).
    t0 = time.perf_counter()
    m0 = _fit_frame_model(frames[0], cfg, jax.random.fold_in(base_key, 0), mesh)
    r0 = _register_to_model(m0, frames[1], cfg, Pose.identity(), mesh)
    sync((r0.pose.R, r0.logliks))
    print(f"compile+warmup {time.perf_counter()-t0:.1f} s", file=sys.stderr)

    # --- phase 1: fits. One model per frame (what closure detection uses;
    # the odometry loop itself fits f-1 of these). Dispatched programs per
    # fit: 1 everywhere (the whole tree build is one jit on both paths —
    # the sharded one since the round-5 _sharded_tree_fit_program fusion).
    # Registration: 1 program on the flat and fused-sharded-tree paths,
    # one per level on the unsharded tree path.
    levels = cfg.levels if args.model == "tree" else 1
    reg_calls = 1 if (args.sharded or args.model == "flat") else levels
    models = {}
    t0 = time.perf_counter()
    for i in range(f):
        models[i] = _fit_frame_model(
            frames[i], cfg, jax.random.fold_in(base_key, i), mesh
        )
    sync(jax.tree_util.tree_leaves(models[f - 1]))
    fit_wall = time.perf_counter() - t0
    report("fit", fit_wall, f, f)

    # --- phase 2: registrations (warm-started chain, as run_odometry).
    t0 = time.perf_counter()
    rel_poses, logliks = [], []
    prev_rel = Pose.identity()
    for i in range(f - 1):
        res = _register_to_model(models[i], frames[i + 1], cfg, prev_rel, mesh)
        prev_rel = res.pose
        rel_poses.append(res.pose)
        logliks.append(res.logliks[-1])
    sync((prev_rel.R, prev_rel.t))
    reg_wall = time.perf_counter() - t0
    logliks = [float(x) for x in logliks]
    report("register", reg_wall, f - 1, (f - 1) * reg_calls)

    abs_poses = [Pose.identity()]
    for z in rel_poses:
        abs_poses.append(abs_poses[-1].compose(z))
    result = OdometryResult(
        abs_poses=abs_poses, rel_poses=rel_poses, logliks=logliks
    )

    # --- phase 3: closure detection (fits are NOT shared with phase 1's
    # models dict — detect_loop_closures builds its own cache, so this
    # measures the real marginal cost including per-endpoint model fits).
    ccfg = ClosureConfig(min_separation=5)
    t0 = time.perf_counter()
    closures = detect_loop_closures(frames, result, cfg, config=ccfg, mesh=mesh)
    wall = time.perf_counter() - t0
    n_cl = 0 if closures is None else int(np.asarray(closures.i).shape[0])
    # Each verified candidate: <=2 cached fits + 2 registrations (forward
    # + reciprocal).
    report(
        "closures", wall, max(ccfg.max_candidates, 1),
        ccfg.max_candidates * 2 * (1 + reg_calls), accepted=n_cl,
    )
    result.closures = closures

    # --- phase 4: pose-graph refinement (warm once: the GN solver jit
    # compiles per chain/closure shape; the committed number is the
    # steady-state solve a resumed/iterated pipeline pays).
    refined = refine_odometry(result, n_iters=10, mesh=mesh)
    sync((refined.R, refined.t))
    t0 = time.perf_counter()
    refined = refine_odometry(result, n_iters=10, mesh=mesh)
    sync((refined.R, refined.t))
    refine_wall = time.perf_counter() - t0
    dead = float(ate(result.abs_poses, gt))
    fixed = float(ate(refined.poses(), gt))
    report("refine", refine_wall, 1, 1, ate_dead=dead,
           ate_refined=fixed)

    # --- phase 5: global map build + one relocalization (round-5
    # pipelines.mapping — the fused world cloud through the [sharded]
    # tree fit, then a scan localized against the map).
    from hgmm.pipelines.mapping import MapConfig, build_map, localize

    mcfg = MapConfig(bucket=1 << 18)
    t0 = time.perf_counter()
    map_tree = build_map(frames, refined.poses(), mcfg, mesh=mesh)
    sync(jax.tree_util.tree_leaves(map_tree.levels[-1]))
    map_wall = time.perf_counter() - t0
    report("map_build", map_wall, 1, 1, fused_bucket=mcfg.bucket,
           leaves=map_tree.n_leaves)
    t0 = time.perf_counter()
    loc = localize(
        jnp.asarray(frames[f // 2][0]), map_tree,
        init_pose=result.abs_poses[f // 2], mesh=mesh,
    )
    sync((loc.pose.R, loc.pose.t))
    loc_wall = time.perf_counter() - t0
    loc_err = float(
        jnp.linalg.norm(loc.pose.t - refined.t[f // 2])
    )
    report("localize", loc_wall, 1, 1, err_vs_refined_t=loc_err)

    phases_wall = fit_wall + reg_wall + wall + refine_wall
    report("phases_total", phases_wall, f, 0,
           frames_per_sec=f / phases_wall)

    if args.skip_e2e:
        return

    # --- headline: the production entry point, one call.
    t0 = time.perf_counter()
    res = run_odometry(
        scans, cfg, mesh=mesh, detect_closures=True, closure_config=ccfg
    )
    refined = refine_odometry(res, n_iters=10, mesh=mesh)
    sync((refined.R, refined.t))
    e2e_wall = time.perf_counter() - t0
    report(
        "e2e", e2e_wall, f, 0,
        frames_per_sec=f / e2e_wall,
        ate_dead=float(ate(res.abs_poses, gt)),
        ate_refined=float(ate(refined.poses(), gt)),
    )


if __name__ == "__main__":
    main()
