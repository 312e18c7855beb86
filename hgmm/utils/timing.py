"""Benchmark timing harness (SURVEY.md §6.1): compiled-call wall timing with
block_until_ready, replacing the reference's cudaEvent timers."""

from __future__ import annotations

import time
from typing import Callable

import jax
import numpy as np


def time_fn(
    fn: Callable,
    *args,
    warmup: int = 2,
    iters: int = 10,
    **kwargs,
):
    """Median wall-time of fn(*args) with device sync (the first warmup call
    pays the compile). Returns (out, median_s, all_times)."""
    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times)), times
