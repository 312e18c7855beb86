#!/usr/bin/env python
"""Weak-scaling benchmark of sharded EM (BASELINE.md row 2).

Runs the REAL sharded program (Mesh + shard_map + psum) on subsets of the
available devices with a fixed per-device point count and reports
points/sec + efficiency vs 1 device, each line naming the device. With
--cpu the devices are 8 fake CPU devices (functional validation of the
scaling path only); on the GPUs of one host the same script measures real
NVLink scaling — run under `jax.distributed.initialize` for multi-host.
Times are wall-clock around calls that end in block_until_ready. Exits
non-zero without a GPU unless --cpu is given.

Usage: python benchmarks/scaling.py [--points-per-device 262144] [--cpu]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points-per-device", type=int, default=1 << 18)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true", help="force CPU fake devices")
    args = ap.parse_args()

    import os

    if args.cpu and "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""
    ):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from hgmm.utils.runtime import device_record, enable_compile_cache, require_gpu

    require_gpu(cpu_ok=args.cpu)
    enable_compile_cache()
    device = device_record()
    from hgmm.data.synthetic import make_cloud
    from hgmm.models.gmm import init_params
    from hgmm.parallel import make_mesh, sharded_em_fit

    devices = jax.devices()
    sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= len(devices)]
    print(f"# backend={jax.default_backend()} devices={len(devices)}", file=sys.stderr)

    # Sharded-program overhead at 1 device: unsharded em_fit vs the same
    # fit through Mesh+shard_map+psum on a 1-device mesh. This is the part
    # of the weak-scaling story measurable on a single card (the collective
    # machinery must be ~free before multi-device efficiency can be high).
    from hgmm.models.gmm import em_fit

    n1 = args.points_per_device
    pts1 = make_cloud(jax.random.PRNGKey(0), n1, kind="trefoil")
    init1 = init_params(pts1, args.k, jax.random.PRNGKey(1))

    def run_unsharded():
        p, _ = em_fit(pts1, init1, n_iters=args.iters)
        jax.block_until_ready(p)

    run_unsharded()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_unsharded()
        times.append(time.perf_counter() - t0)
    unsharded_pps = n1 / (float(np.median(times)) / args.iters)

    results = []
    base_pps = None
    for s in sizes:
        mesh = make_mesh(devices[:s])
        n = args.points_per_device * s
        pts = make_cloud(jax.random.PRNGKey(0), n, kind="trefoil")
        init = init_params(pts, args.k, jax.random.PRNGKey(1))
        # compile + warm
        jax.block_until_ready(sharded_em_fit(pts, init, mesh, n_iters=args.iters))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(
                sharded_em_fit(pts, init, mesh, n_iters=args.iters)
            )
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times)) / args.iters
        pps = n / dt
        if base_pps is None:
            base_pps = pps / s  # per-device at s=1
        eff = pps / (base_pps * s)
        rec = {"devices": s, "points": n, "points_per_sec": pps,
               "weak_scaling_efficiency": eff, "device": device}
        if s == 1:
            rec["unsharded_points_per_sec"] = unsharded_pps
            rec["sharding_overhead"] = 1.0 - pps / unsharded_pps
        if jax.default_backend() == "cpu":
            # Fake devices share one physical CPU: this validates the
            # sharded program, the efficiency number is meaningless here.
            rec["note"] = "fake shared-CPU devices; functional validation only"
        results.append(rec)
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
