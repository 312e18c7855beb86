"""hgmm — hierarchical-GMM point-cloud registration on NVIDIA GPUs.

A JAX/XLA/Pallas framework with the capabilities of the CUDA reference
(somanshu25/GPU-Accelerated-Point-Cloud-Registration-Using-Hierarchical-GMM;
mount empty at build time — see SURVEY.md §0, BASELINE.json is the binding
spec):

- flat GMM-EM registration                  -> hgmm.models.gmm
- hierarchical GMM tree (level-synchronous) -> hgmm.models.gmm_tree
- SE(3) pose solvers (Horn / Mahalanobis)   -> hgmm.models.pose
- Pallas-Triton fused E-step kernels        -> hgmm.ops
- ICP baselines (CPU + blocked-matmul)      -> hgmm.baselines
- multi-chip/multi-host sharded EM          -> hgmm.parallel
- KITTI odometry + pose-graph refinement    -> hgmm.pipelines
- PLY / KITTI .bin loaders (+ C++ native)   -> hgmm.data
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry code: every XLA matmul in this library is a small pose/feature
# contraction where reduced-precision operands (bf16, TF32) are unacceptable
# (coordinates enter squared). The Triton kernels name their own precision.
_jax.config.update("jax_default_matmul_precision", "highest")

from hgmm.models.gmm import Gmm, GmmParams, fit_gmm  # noqa: F401
from hgmm.models.gmm_tree import GmmTree, fit_gmm_tree  # noqa: F401
from hgmm.pipelines.odometry import (  # noqa: F401
    OdometryConfig,
    refine_odometry,
    run_odometry,
)
from hgmm.pipelines.register import register_pair  # noqa: F401
