"""hgmm.ops — the E-step operations: Pallas-Triton GPU kernels
(hgmm.ops.triton_em) and their plain-JAX twins (hgmm.ops.em_ref).

Dispatch rule, per operation:

  em_stats, em_stats_masked, reg_stats   the Triton kernels on a GPU
                                         backend, em_ref on the CPU
  assign, nearest neighbour (ops.knn)    em_ref / plain XLA everywhere

set_backend("ref") pins the twins everywhere; set_backend("pallas")
demands the kernels and raises where there is no GPU (the kernels are
never run in the interpreter outside tests); "auto" (the default) applies
the rule above. The equivalence tests compare both (SURVEY.md §5.2).
"""

from __future__ import annotations

import dataclasses

import jax

from hgmm.ops import em_ref
from hgmm.ops.em_ref import EmStats, RegStats  # noqa: F401
from hgmm.ops.gaussians import (  # noqa: F401
    PHI_DIM,
    PHI_PAD,
    MixtureParams,
    features,
    mstep_update,
    pack_loglik_weights,
    precision_terms,
    sym_pack,
    sym_unpack,
    unpack_suffstats,
)

_BACKEND = "auto"


@dataclasses.dataclass(frozen=True)
class Prepared:
    """Points prepared once for repeated E-step calls.

    Fit and registration loops call ops.prepare(points) ONCE, outside
    their lax.scan, and pass the result to every em_stats /
    em_stats_masked / assign / reg_stats call of the loop. On the kernel
    path `feat` is the kernels' [16, N_pad] f32 feature buffer
    (triton_em.features); on the XLA path it is None and the raw arrays
    are used. The path is fixed at prepare() time, so a Prepared value
    stays consistent even if set_backend changes later.
    """

    points: object = None  # raw [N, 3]
    point_weights: object = None  # raw [N] or None
    feat: object = None  # [16, N_pad] f32 (kernel path) or None
    n: int = 0  # true point count (static shape metadata)


jax.tree_util.register_dataclass(
    Prepared,
    data_fields=("points", "point_weights", "feat"),
    meta_fields=("n",),
)


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in ("auto", "ref", "pallas"):
        raise ValueError(f"unknown ops backend {name!r}")
    if name == "pallas" and jax.default_backend() != "gpu":
        raise RuntimeError(
            "ops backend 'pallas' runs the Triton kernels and needs a GPU; "
            f"JAX's default backend is {jax.default_backend()!r}"
        )
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


def _pallas_active() -> bool:
    """True when em_stats / em_stats_masked / reg_stats run the kernels."""
    if _BACKEND == "ref":
        return False
    return _BACKEND == "pallas" or jax.default_backend() == "gpu"


def prepare(points, point_weights=None) -> Prepared:
    """Build the Prepared buffers for `points` (see Prepared)."""
    feat = None
    if _pallas_active():
        from hgmm.ops import triton_em

        feat = triton_em.features(points, point_weights)
    return Prepared(
        points=points, point_weights=point_weights, feat=feat,
        n=int(points.shape[0]),
    )


def _prepared(points, point_weights) -> Prepared:
    if isinstance(points, Prepared):
        if point_weights is not None:
            raise ValueError("weights are baked into Prepared at prepare()")
        return points
    return prepare(points, point_weights)


def em_stats(points, W, point_weights=None, outlier_logit=None) -> EmStats:
    """E-step + sufficient-statistic reduction. See em_ref.em_stats.

    points: raw [N, 3] or a Prepared from ops.prepare (loops MUST use the
    latter — see Prepared). With a Prepared, point_weights must be None
    (weights were baked in at prepare time)."""
    prep = _prepared(points, point_weights)
    if prep.feat is not None:
        from hgmm.ops import triton_em

        return triton_em.em_stats(prep.feat, W, outlier_logit)
    return em_ref.em_stats(prep.points, W, prep.point_weights, outlier_logit)


def em_stats_masked(points, W, parent, branch, point_weights=None) -> EmStats:
    """Tree-fit E-step masked to each point's parent's child block.

    points: raw [N, 3] or a Prepared (see em_stats)."""
    prep = _prepared(points, point_weights)
    if prep.feat is not None:
        from hgmm.ops import triton_em

        return triton_em.em_stats(prep.feat, W, None, parent, branch)
    return em_ref.em_stats_masked(
        prep.points, W, parent, branch, prep.point_weights
    )


def assign(points, W, parent=None, branch=None):
    """Per-point hard (argmax) component assignment, shape [N]. Plain XLA
    on every backend: it runs once per tree level, not once per sweep."""
    points = points.points if isinstance(points, Prepared) else points
    return em_ref.assign(points, W, parent, branch)


def reg_stats(
    x, W, mu, A6, b3, pose, point_weights=None, top_k=None, outlier_logit=None,
) -> RegStats:
    """Registration E-step statistics (Horn moments + GN normal equations).

    x: raw [N, 3] or a Prepared (registration scans use the latter so the
    source buffer is built once per call, not per iteration). pose: (R, t)
    applied to x in the op (in-kernel on the GPU)."""
    prep = _prepared(x, point_weights)
    if prep.feat is not None:
        from hgmm.ops import triton_em

        return triton_em.reg_stats(
            prep.feat, W, mu, A6, b3, pose, top_k, outlier_logit
        )
    return em_ref.reg_stats(
        prep.points, W, mu, A6, b3, pose, prep.point_weights, top_k,
        outlier_logit,
    )
