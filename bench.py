#!/usr/bin/env python
"""Headline benchmark: E-step + sufficient-statistic sweep throughput on
one GPU, through the public path (ops.prepare once, then ops.em_stats per
sweep, as every fit loop runs it).

Prints ONE JSON line on stdout:
  {"metric": "estep_points_per_sec", "value": N, "unit": "points/s",
   "n": ..., "k": ..., "ms_per_sweep": ..., "device": {...},
   "nvidia_smi": "<name>, <power limit>"}
Times are host wall-clock around calls that end in block_until_ready
(median of 20), compilation excluded. Exits non-zero without a GPU
unless --cpu is given.
"""

import argparse
import contextlib
import json
import sys

N = 1 << 21
K = 512
ITERS = 20


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (numbers are not device metrics)")
    ap.add_argument(
        "--trace", default=None, metavar="DIR",
        help="capture a jax.profiler trace of the timed sweeps to DIR "
        "(TensorBoard/Perfetto; SURVEY.md §6.1)",
    )
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from hgmm.utils.runtime import enable_compile_cache, require_gpu

    require_gpu(cpu_ok=args.cpu)
    enable_compile_cache()
    run_bench(trace_dir=args.trace)


def run_bench(trace_dir=None) -> None:
    import jax
    import jax.numpy as jnp

    from hgmm import ops
    from hgmm.ops.gaussians import MixtureParams
    from hgmm.utils.runtime import device_record, gpu_name_and_power_limit
    from hgmm.utils.timing import time_fn

    dev = device_record()
    smi = gpu_name_and_power_limit() if dev["platform"] == "gpu" else None
    log(f"device={dev} nvidia-smi={smi!r} path={'kernel' if ops._pallas_active() else 'XLA'}")

    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    mu = jax.random.normal(k1, (K, 3))
    a = 0.3 * jax.random.normal(k2, (K, 3, 3))
    sigma = jnp.einsum("kij,klj->kil", a, a) + 0.05 * jnp.eye(3)
    params = MixtureParams(jax.nn.softmax(jax.random.normal(k3, (K,))), mu, sigma)
    pts = jax.random.normal(k4, (N, 3), jnp.float32)
    W = ops.pack_loglik_weights(params)
    prep = jax.block_until_ready(ops.prepare(pts))
    sweep = jax.jit(ops.em_stats)

    if trace_dir is not None:
        from hgmm.utils.profiling import trace

        trace_ctx = trace(trace_dir)
        log(f"profiler trace -> {trace_dir}")
    else:
        trace_ctx = contextlib.nullcontext()
    with trace_ctx:
        _, t, _ = time_fn(sweep, prep, W, warmup=2, iters=ITERS)
    log(f"K={K} N={N}: {t * 1e3:.4f} ms/sweep, {N / t / 1e9:.4f} Gpts/s")
    print(json.dumps({
        "metric": "estep_points_per_sec",
        "value": N / t,
        "unit": "points/s",
        "n": N,
        "k": K,
        "ms_per_sweep": t * 1e3,
        "device": dev,
        "nvidia_smi": smi,
    }))


if __name__ == "__main__":
    main()
