"""Gaussian-mixture parameter packing: the quadratic-feature formulation.

This module is the mathematical heart of the E-step (SURVEY.md §8 "hard
parts"; BASELINE.json:5 "tiled point x mixture log-likelihood matmul").

The per-point/per-component Gaussian log-density

    log [pi_j N(y; mu_j, Sigma_j)]
      = -1/2 [ y^T A_j y - 2 b_j . y + c_j ],     A_j = Sigma_j^{-1},
        b_j = A_j mu_j,
        c_j = mu_j^T b_j + logdet Sigma_j + 3 log 2pi - 2 log pi_j

is LINEAR in the degree-<=2 monomial features of y:

    psi(y) = [x^2, y^2, z^2, xy, xz, yz, x, y, z, 1]        (10 features)

so a whole [N, K] log-likelihood table is ONE matmul  -1/2 * Psi @ W  with
Psi = psi(points) [N, 10] and W [10, K] packed from mixture parameters.
Dually, the EM M-step sufficient statistics are EXACTLY

    S = Gamma^T @ Psi  in [K, 10]:
        S[:, 9]   = T0 = sum_i gamma_ij               (weights)
        S[:, 6:9] = T1 = sum_i gamma_ij y_i           (first moments)
        S[:, 0:6] = T2 = sum_i gamma_ij y_i y_i^T     (second moments, sym)

so the E-step AND the M-step reduction are both contractions sharing one
feature matrix — the design the GPU kernels in hgmm.ops.triton_em fuse so
the [N, K] responsibility matrix never materializes in device memory.

The reference's CUDA E-step kernel + segmented-reduction M-step (SURVEY.md
§2.1 items 9-10) correspond to these two contractions.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

PHI_DIM = 10  # [x^2, y^2, z^2, xy, xz, yz, x, y, z, 1]
PHI_PAD = 16  # padded feature width: the smallest dot dimension Triton takes

LOG_2PI = 1.8378770664093453

# Index maps between the 6 packed symmetric entries and [3,3] matrices.
# numpy (not jnp) so importing this module never initializes a JAX backend —
# required by jax.distributed.initialize in multi-process programs
# (tests/_mp_worker.py).
import numpy as _np  # noqa: E402

_SYM_I = _np.array([0, 1, 2, 0, 0, 1])
_SYM_J = _np.array([0, 1, 2, 1, 2, 2])


class MixtureParams(NamedTuple):
    """Plain GMM parameters. K components in R^3.

    weights may be unnormalized in intermediate states; log-space where noted.
    """

    pi: jax.Array  # [K] mixture weights (sum to 1 over active components)
    mu: jax.Array  # [K, 3] means
    sigma: jax.Array  # [K, 3, 3] covariances (SPD)

    @property
    def k(self) -> int:
        return self.pi.shape[0]


def features(points: jax.Array, pad: int | None = None) -> jax.Array:
    """psi(y): degree-<=2 monomial features. points [N, 3] -> [N, pad or 10].

    When `pad` is given the trailing columns are zero — safe to matmul against
    a zero-padded W.
    """
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    ones = jnp.ones_like(x)
    phi = jnp.stack([x * x, y * y, z * z, x * y, x * z, y * z, x, y, z, ones], axis=-1)
    if pad is not None and pad > PHI_DIM:
        phi = jnp.pad(phi, ((0, 0), (0, pad - PHI_DIM)))
    return phi


def sym_pack(m: jax.Array) -> jax.Array:
    """[..., 3, 3] symmetric -> [..., 6] packed [m00,m11,m22,m01,m02,m12]."""
    return m[..., _SYM_I, _SYM_J]


def sym_unpack(p: jax.Array) -> jax.Array:
    """[..., 6] packed -> [..., 3, 3] symmetric."""
    out = jnp.zeros(p.shape[:-1] + (3, 3), dtype=p.dtype)
    out = out.at[..., _SYM_I, _SYM_J].set(p)
    return out.at[..., _SYM_J, _SYM_I].set(p)


def _inv_and_logdet_3x3(sigma: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Closed-form Cholesky-based inverse + logdet for batched SPD [K, 3, 3].

    Cofactor expansion cancels catastrophically in fp32 for ill-conditioned
    covariances (eigenvalues at the regularization floor give det ~ 1e-14 —
    well below fp32 cancellation noise), so we factor Sigma = L L^T with the
    explicit 3x3 recurrence, invert L, and form Sigma^-1 = L^-T L^-1.
    logdet = 2 sum log diag(L). No LAPACK — fusable, differentiable.
    """
    tiny = jnp.asarray(1e-30, dtype=sigma.dtype)
    a, b, c = sigma[..., 0, 0], sigma[..., 1, 0], sigma[..., 2, 0]
    d, e = sigma[..., 1, 1], sigma[..., 2, 1]
    f = sigma[..., 2, 2]
    l11 = jnp.sqrt(jnp.maximum(a, tiny))
    l21 = b / l11
    l31 = c / l11
    l22 = jnp.sqrt(jnp.maximum(d - l21 * l21, tiny))
    l32 = (e - l21 * l31) / l22
    l33 = jnp.sqrt(jnp.maximum(f - l31 * l31 - l32 * l32, tiny))
    # M = L^-1 (lower triangular).
    m11 = 1.0 / l11
    m22 = 1.0 / l22
    m33 = 1.0 / l33
    m21 = -l21 * m11 * m22
    m31 = (l21 * l32 - l31 * l22) * m11 * m22 * m33
    m32 = -l32 * m22 * m33
    # Sigma^-1 = M^T M (symmetric).
    i00 = m11 * m11 + m21 * m21 + m31 * m31
    i01 = m21 * m22 + m31 * m32
    i02 = m31 * m33
    i11 = m22 * m22 + m32 * m32
    i12 = m32 * m33
    i22 = m33 * m33
    inv = jnp.stack(
        [
            jnp.stack([i00, i01, i02], axis=-1),
            jnp.stack([i01, i11, i12], axis=-1),
            jnp.stack([i02, i12, i22], axis=-1),
        ],
        axis=-2,
    )
    logdet = 2.0 * (jnp.log(l11) + jnp.log(l22) + jnp.log(l33))
    return inv, logdet


def precision_terms(params: MixtureParams) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Per-component (A, b, c) of the quadratic form (see module docstring).

    A: [K, 3, 3] precision; b: [K, 3] = A mu; c: [K] constant incl. -2 log pi.
    Components with pi == 0 get c = +inf (log-weight -inf) so they never win.
    """
    A, logdet = _inv_and_logdet_3x3(params.sigma)
    # Elementwise contractions, NOT einsum: a dot_general may run at a
    # reduced precision (bf16 or TF32 operands), and with collapsed
    # covariances (A entries ~1/cov_reg) that rounding is thousands of
    # nats of absolute logit error. These are [K,3,3]-sized, so exact f32
    # elementwise math costs nothing.
    b = jnp.sum(A * params.mu[:, None, :], axis=-1)
    # Finite floor (not -inf): keeps 0*inf NaNs out of the feature matmul
    # while still pushing pi=0 components below the NEG_INF mask threshold.
    log_pi = jnp.where(params.pi > 0, jnp.log(jnp.maximum(params.pi, 1e-38)), -1e30)
    c = jnp.sum(params.mu * b, axis=-1) + logdet + 3.0 * LOG_2PI - 2.0 * log_pi
    return A, b, c


def pack_loglik_weights(params: MixtureParams, pad: int | None = None) -> jax.Array:
    """Pack (A, b, c) into W [10 (or pad), K] with
    log[pi_j N(y; mu_j, Sigma_j)] = -1/2 * psi(y) @ W[:, j].

    Cross-term rows carry the factor 2 (features are pure monomials).
    """
    A, b, c = precision_terms(params)
    a6 = sym_pack(A)  # [K, 6]
    rows = [
        a6[:, 0],
        a6[:, 1],
        a6[:, 2],
        2.0 * a6[:, 3],
        2.0 * a6[:, 4],
        2.0 * a6[:, 5],
        -2.0 * b[:, 0],
        -2.0 * b[:, 1],
        -2.0 * b[:, 2],
        c,
    ]
    W = jnp.stack(rows, axis=0)  # [10, K]
    if pad is not None and pad > PHI_DIM:
        W = jnp.pad(W, ((0, pad - PHI_DIM), (0, 0)))
    return W


def unpack_suffstats(S: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """S [K, >=10] = Gamma^T Psi  ->  (T0 [K], T1 [K,3], T2 [K,3,3])."""
    T0 = S[:, 9]
    T1 = S[:, 6:9]
    T2 = sym_unpack(S[:, 0:6])
    return T0, T1, T2


def sym3_eigvalsh(m: jax.Array) -> jax.Array:
    """Analytic ascending eigenvalues of symmetric [..., 3, 3] matrices
    (Smith's trigonometric method — the closed-form solution of the
    characteristic cubic).

    Replaces batched `jnp.linalg.eigh` on the M-step hot path: pure
    elementwise math with clamped `acos`, so it is NaN-free for every
    finite input (an iterative eigh is not guaranteed to converge cleanly
    for the clustered/degenerate eigenvalues that collapsed covariances
    produce) and fuses into the surrounding jit. f32 absolute
    accuracy is ~1e-4 * ||m|| worst-case (acos loses precision near
    clustered eigenvalues) — ample for floors (psd_floor compensates
    conservatively) and complexity scores.
    """
    q = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]) / 3.0
    a, d, f = m[..., 0, 0] - q, m[..., 1, 1] - q, m[..., 2, 2] - q
    b, c, e = m[..., 0, 1], m[..., 0, 2], m[..., 1, 2]
    p2 = a * a + d * d + f * f + 2.0 * (b * b + c * c + e * e)
    p = jnp.sqrt(jnp.maximum(p2, 0.0) / 6.0)
    # Normalize entries BEFORE the determinant (safe_p**3 underflows f32
    # for near-isotropic matrices; normalized entries are O(1)).
    safe_p = jnp.maximum(p, 1e-30)
    an, dn, fn = a / safe_p, d / safe_p, f / safe_p
    bn, cn, en = b / safe_p, c / safe_p, e / safe_p
    det = (
        an * (dn * fn - en * en)
        - bn * (bn * fn - en * cn)
        + cn * (bn * en - dn * cn)
    )
    r = jnp.clip(0.5 * det, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lmax = q + 2.0 * p * jnp.cos(phi)
    lmin = q + 2.0 * p * jnp.cos(phi + 2.0943951023931953)  # + 2 pi / 3
    lmid = 3.0 * q - lmax - lmin
    return jnp.stack([lmin, lmid, lmax], axis=-1)


def psd_floor(sigma: jax.Array, floor) -> jax.Array:
    """Floor the eigenvalues of symmetric [K, 3, 3] matrices at >= floor by
    adding the per-matrix eigenvalue deficit times I (eigenvectors are
    preserved exactly; eigenvalues above the floor shift up by the same
    deficit, which only matters for matrices that were degenerate anyway).

    Guards the M-step against non-PSD covariances from catastrophic
    cancellation in T2/T0 - mu mu^T for nearly-empty components (SURVEY.md §8
    "covariance PSD maintenance under eps-regularization"), and — with a
    scale-aware floor — against covariance collapse.
    """
    sym = 0.5 * (sigma + jnp.swapaxes(sigma, -1, -2))
    lmin = sym3_eigvalsh(sym)[..., 0]
    # Conservative: sym3_eigvalsh may OVERestimate lmin by ~1e-4 * ||m||
    # for clustered eigenvalues; subtract that allowance so the floor is a
    # guarantee (the cost is an equally tiny extra bump).
    norm_bound = jnp.abs(
        sym[..., 0, 0] + sym[..., 1, 1] + sym[..., 2, 2]
    ) + jnp.sqrt(
        jnp.maximum(jnp.sum(sym * sym, axis=(-2, -1)), 0.0)
    )
    lmin = lmin - 2e-4 * norm_bound
    bump = jnp.maximum(jnp.asarray(floor, sym.dtype) - lmin, 0.0)
    return sym + bump[..., None, None] * jnp.eye(3, dtype=sym.dtype)


def mstep_update(
    T0: jax.Array,
    T1: jax.Array,
    T2: jax.Array,
    total_weight: jax.Array | float,
    cov_reg: float = 1e-6,
    cov_type: str = "full",
    min_weight: float = 1e-6,
    cov_floor: jax.Array | float = 0.0,
) -> MixtureParams:
    """Closed-form M-step from sufficient statistics.

    pi_j = T0_j / total, mu_j = T1_j / T0_j,
    Sigma_j = T2_j / T0_j - mu_j mu_j^T + cov_reg * I.

    Empty components (T0 ~ 0) keep an identity-ish covariance and pi -> 0
    rather than producing NaNs (matches the robustness the reference needed
    from its segmented reductions; SURVEY.md §8 "covariance PSD maintenance").

    cov_floor: optional eigenvalue floor in data units^2 (on top of
    cov_reg). Fit entry points pass a SCALE-AWARE value (~1e-4 x scene
    variance) so covariance collapse on degenerate data saturates at a
    physically tiny scale instead of driving packed precisions to
    1/cov_reg magnitudes, where the quadratic-form logits cancel
    catastrophically in f32. Pass 0 to disable.
    """
    dtype = T1.dtype
    # Empty floor is RELATIVE to the data mass: a component holding less
    # than ~1e-6 of the total weight is numerically meaningless — its
    # mu = T1/T0 amplifies round-off into arbitrarily large garbage, whose
    # logits can then swamp a whole tree level. Zero it out: pi = 0
    # components are inert everywhere (their packed logit sits below the
    # mask floor).
    floor = jnp.maximum(jnp.asarray(min_weight, dtype), 1e-6 * total_weight)
    empty = T0 <= floor
    safe_T0 = jnp.maximum(T0, floor)
    pi = T0 / total_weight
    mu = jnp.where(empty[:, None], 0.0, T1 / safe_T0[:, None])
    sigma = T2 / safe_T0[:, None, None] - jnp.einsum("ki,kj->kij", mu, mu)
    if cov_type == "iso":
        var = jnp.trace(sigma, axis1=-2, axis2=-1) / 3.0
        sigma = var[:, None, None] * jnp.eye(3, dtype=dtype)
    elif cov_type == "diag":
        diag = jnp.diagonal(sigma, axis1=-2, axis2=-1)  # [K, 3]
        sigma = diag[..., None] * jnp.eye(3, dtype=dtype)
    sigma = sigma + cov_reg * jnp.eye(3, dtype=dtype)
    sigma = jnp.where(empty[:, None, None], jnp.eye(3, dtype=dtype), sigma)
    floor_eig = jnp.maximum(
        jnp.asarray(cov_floor, dtype), jnp.maximum(cov_reg, 1e-9)
    )
    sigma = psd_floor(sigma, floor_eig)
    pi = jnp.where(empty, 0.0, pi)
    return MixtureParams(pi=pi, mu=mu, sigma=sigma)
