#!/usr/bin/env python
"""Registration quality/speed suite — the JAX equivalent of the reference
README's CPU-ICP vs GPU-ICP vs GMM vs HGMM comparison charts (SURVEY.md
§2.1 item 13). Prints one JSON line per (algorithm, size), each naming the
device. Exits non-zero without a GPU unless --cpu is given.

Usage: python benchmarks/registration_suite.py [--n 100000] [--cpu]
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from hgmm.utils.runtime import device_record, enable_compile_cache, require_gpu

    require_gpu(cpu_ok=args.cpu)
    enable_compile_cache()
    device = device_record()
    from hgmm.baselines.icp import icp
    from hgmm.data.synthetic import make_cloud, perturb
    from hgmm.eval.metrics import registration_rmse, rotation_error_deg
    from hgmm.models.gmm import Gmm
    from hgmm.models.gmm_tree import GmmTree
    from hgmm.models.se3 import random_pose
    from hgmm.pipelines.register import register_points

    n = args.n
    cloud = make_cloud(jax.random.PRNGKey(0), n, kind="trefoil")
    gt = random_pose(jax.random.PRNGKey(1), max_angle=0.2, max_trans=0.06)
    source = perturb(jax.random.PRNGKey(2), cloud, gt.inverse(), noise=0.002)

    from hgmm.utils.timing import time_fn

    def timed(fn):
        out, median_s, _ = time_fn(fn, warmup=1, iters=3)
        return out, median_s

    def report(name, pose, fit_s, reg_s, **extra):
        print(
            json.dumps(
                {
                    "algorithm": name,
                    "n_points": n,
                    "fit_s": fit_s,
                    "register_s": reg_s,
                    "rmse": float(registration_rmse(pose, source, gt)),
                    "rot_err_deg": float(rotation_error_deg(pose, gt)),
                    "device": device,
                    **extra,
                }
            )
        )

    # ICP baseline
    res, dt = timed(lambda: icp(source, cloud, n_iters=30))
    report("icp", res.pose, 0.0, dt)

    # Flat GMM (config 1)
    (gmm, _), fit_dt = timed(
        lambda: Gmm.fit(cloud, k=64, n_iters=20, key=jax.random.PRNGKey(3))
    )
    res, dt = timed(lambda: register_points(source, gmm.params, n_iters=40))
    report("gmm_flat64", res.pose, fit_dt, dt)

    # Hierarchical GMM tree (config 2)
    (tree, _), fit_dt = timed(
        lambda: GmmTree.fit(cloud, branch=8, levels=3, em_iters=10,
                            key=jax.random.PRNGKey(4))
    )
    cut = tree.cut_mixture(0.0)
    res, dt = timed(
        lambda: register_points(source, cut, n_iters=40, outlier_logit=0.0)
    )
    report("hgmm_tree_8x3", res.pose, fit_dt, dt, k=int(cut.pi.shape[0]))

    # Adaptive mixed-resolution cut (arXiv 1807.02587 headline feature):
    # same tree, coarsen the simplest half of the parents — fewer components
    # for the same registration quality.
    from hgmm.models.gmm_tree import node_complexity

    thr = float(jnp.quantile(node_complexity(tree.levels[-2]), 0.5))
    acut = tree.cut_mixture(thr)
    res, dt = timed(
        lambda: register_points(source, acut, n_iters=40, outlier_logit=0.0)
    )
    report("hgmm_adaptive_cut", res.pose, fit_dt, dt, k=int(acut.pi.shape[0]))


if __name__ == "__main__":
    main()
