#!/usr/bin/env python
"""Config-5 scale demonstration: 10M+ points through the SHARDED EM program
(BASELINE.json:11 "10M+ point clouds sharded across hosts").

Runs hgmm.parallel.sharded_em_fit — the exact Mesh + shard_map + psum
program the multi-host deployment uses — over all local GPUs (every host's
when run under jax.distributed.initialize) at N = 10,485,760 points,
K = 512, and reports throughput + device memory, naming the device. Times
are wall-clock around calls that end in block_until_ready. Exits non-zero
without a GPU unless --cpu is given.

The point of this benchmark is the MEMORY story as much as speed: the
fused E-step never materialises the [N x K] responsibility matrix, so 10M
points cost ~N*(12 B raw + 64 B prepared features) ~= 0.8 GB, and the
suff-stat psum is K*(1+3+9) floats regardless of N.

Usage: python benchmarks/large_n.py [--n 10485760] [--k 512] [--cpu]
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
    ap.add_argument("--n", type=int, default=10 * (1 << 20))
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from hgmm.utils.runtime import device_record, enable_compile_cache, require_gpu

    require_gpu(cpu_ok=args.cpu)
    enable_compile_cache()
    from hgmm.models.gmm import init_params
    from hgmm.parallel import make_mesh, sharded_em_fit

    print(
        f"# backend={jax.default_backend()} devices={len(jax.devices())}",
        file=sys.stderr,
    )

    # Host-side synthetic scene (numpy: 10M x 3 f32 = 120 MB host RAM),
    # standing in for the streamed multi-host ingest of a real pipeline.
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(256, 3)).astype(np.float32) * 4.0
    idx = rng.integers(0, 256, size=args.n)
    pts_np = centers[idx] + rng.normal(size=(args.n, 3)).astype(np.float32) * 0.3

    mesh = make_mesh()
    pts = jnp.asarray(pts_np)
    init = init_params(pts, args.k, jax.random.PRNGKey(1))

    def run():
        return jax.block_until_ready(
            sharded_em_fit(pts, init, mesh, n_iters=args.iters)
        )

    t0 = time.perf_counter()
    p, lls = run()  # compile + first execution
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        p, lls = run()
        times.append(time.perf_counter() - t0)
    per_sweep = float(np.median(times)) / args.iters

    mem = {}
    try:
        stats = jax.local_devices()[0].memory_stats() or {}
        mem = {
            "bytes_in_use": stats.get("bytes_in_use"),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        }
    except Exception:
        pass

    print(
        json.dumps(
            {
                "benchmark": "large_n_sharded_em",
                "n_points": args.n,
                "k": args.k,
                "device": device_record(),
                "ms_per_sweep": per_sweep * 1e3,
                "points_per_sec": args.n / per_sweep,
                "compile_plus_first_run_s": compile_s,
                "final_loglik_per_point": float(lls[-1]) / args.n,
                **mem,
            }
        )
    )


if __name__ == "__main__":
    main()
