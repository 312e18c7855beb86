"""Nearest-neighbor search as blocked distance matmuls (SURVEY.md §2.1
item 5; BASELINE.json:5 "per-point nearest-component search becomes blocked
distance matmuls").

The squared distance factors through one matmul per query chunk,

    d2(q, t) = |q|^2 - 2 q . t + |t|^2,

and `lax.map` over query chunks keeps the [N_query x N_target] distance
matrix from ever existing whole. Plain XLA on every backend: the search
serves only the ICP baseline (hgmm.baselines.icp), off the main path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def nearest_neighbor(query: jax.Array, target: jax.Array, chunk: int = 2048):
    """For each query point the index + squared distance of its nearest
    target point. Returns (idx [Nq] int32, d2 [Nq])."""
    t2 = jnp.sum(target * target, axis=1)

    def one_chunk(q):
        d2 = (
            jnp.sum(q * q, axis=1)[:, None]
            - 2.0 * (q @ target.T)
            + t2[None, :]
        )
        # Clamp: the factored form goes epsilon-negative for exact matches
        # (cancellation), and sqrt(-eps) downstream is NaN.
        return (
            jnp.argmin(d2, axis=1).astype(jnp.int32),
            jnp.maximum(jnp.min(d2, axis=1), 0.0),
        )

    n = query.shape[0]
    n_pad = _round_up(n, chunk)
    qp = jnp.pad(query, ((0, n_pad - n), (0, 0)))
    idx, d2 = jax.lax.map(one_chunk, qp.reshape(-1, chunk, 3))
    return idx.reshape(-1)[:n], d2.reshape(-1)[:n]

