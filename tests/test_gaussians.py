import jax
import jax.numpy as jnp
import numpy as np

from hgmm.ops import em_ref
from hgmm.ops.gaussians import (
    LOG_2PI,
    MixtureParams,
    features,
    mstep_update,
    pack_loglik_weights,
    precision_terms,
    sym_pack,
    sym_unpack,
    unpack_suffstats,
)


def _random_mixture(key, k, dtype=jnp.float32):
    k1, k2, k3 = jax.random.split(key, 3)
    mu = jax.random.normal(k1, (k, 3), dtype)
    a = 0.3 * jax.random.normal(k2, (k, 3, 3), dtype)
    sigma = jnp.einsum("kij,klj->kil", a, a) + 0.1 * jnp.eye(3, dtype=dtype)
    pi = jax.nn.softmax(jax.random.normal(k3, (k,), dtype))
    return MixtureParams(pi, mu, sigma)


def _dense_log_prob(params, pts):
    """Straightforward per-pair log N + log pi (numpy oracle)."""
    out = np.zeros((pts.shape[0], params.pi.shape[0]))
    for j in range(params.pi.shape[0]):
        d = np.asarray(pts) - np.asarray(params.mu[j])
        S = np.asarray(params.sigma[j], dtype=np.float64)
        Sinv = np.linalg.inv(S)
        quad = np.einsum("ni,ij,nj->n", d, Sinv, d)
        out[:, j] = (
            -0.5 * (quad + np.log(np.linalg.det(S)) + 3 * LOG_2PI)
            + np.log(np.asarray(params.pi[j]))
        )
    return out


def test_packed_loglik_matches_oracle():
    params = _random_mixture(jax.random.PRNGKey(0), 5)
    pts = jax.random.normal(jax.random.PRNGKey(1), (50, 3))
    W = pack_loglik_weights(params)
    got = -0.5 * (features(pts) @ W)
    want = _dense_log_prob(params, pts)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_padded_pack_matches():
    params = _random_mixture(jax.random.PRNGKey(2), 4)
    pts = jax.random.normal(jax.random.PRNGKey(3), (20, 3))
    base = -0.5 * (features(pts) @ pack_loglik_weights(params))
    padded = -0.5 * (features(pts, pad=16) @ pack_loglik_weights(params, pad=16))
    np.testing.assert_allclose(padded, base, rtol=1e-6)


def test_sym_pack_roundtrip():
    m = jax.random.normal(jax.random.PRNGKey(4), (7, 3, 3))
    m = m + jnp.swapaxes(m, -1, -2)
    np.testing.assert_allclose(sym_unpack(sym_pack(m)), m, atol=1e-6)


def test_suffstats_unpack():
    pts = jax.random.normal(jax.random.PRNGKey(5), (100, 3))
    gamma = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(6), (100, 4)))
    S = gamma.T @ features(pts)
    T0, T1, T2 = unpack_suffstats(S)
    np.testing.assert_allclose(T0, gamma.sum(0), rtol=1e-5)
    np.testing.assert_allclose(T1, gamma.T @ pts, rtol=1e-4, atol=1e-5)
    want_T2 = jnp.einsum("nk,ni,nj->kij", gamma, pts, pts)
    np.testing.assert_allclose(T2, want_T2, rtol=1e-3, atol=1e-4)


def test_mstep_exact_recovery():
    """Hard-assigned stats of a point set recover its empirical moments."""
    pts = jax.random.normal(jax.random.PRNGKey(7), (500, 3)) * jnp.array([1.0, 2.0, 0.5]) + 1.0
    gamma = jnp.ones((500, 1))
    S = gamma.T @ features(pts)
    T0, T1, T2 = unpack_suffstats(S)
    params = mstep_update(T0, T1, T2, 500.0, cov_reg=0.0)
    np.testing.assert_allclose(params.pi, [1.0], rtol=1e-5)
    np.testing.assert_allclose(params.mu[0], pts.mean(0), atol=1e-4)
    emp_cov = jnp.cov(pts.T, bias=True)
    np.testing.assert_allclose(params.sigma[0], emp_cov, rtol=2e-2, atol=1e-3)


def test_zero_weight_component_masked():
    params = _random_mixture(jax.random.PRNGKey(8), 4)
    params = params._replace(pi=params.pi.at[2].set(0.0))
    pts = jax.random.normal(jax.random.PRNGKey(9), (30, 3))
    stats = em_ref.em_stats(pts, pack_loglik_weights(params))
    T0, _, _ = unpack_suffstats(stats.S)
    assert float(T0[2]) == 0.0
    assert bool(jnp.isfinite(stats.loglik))


def test_precision_terms_shapes():
    params = _random_mixture(jax.random.PRNGKey(10), 6)
    A, b, c = precision_terms(params)
    assert A.shape == (6, 3, 3) and b.shape == (6, 3) and c.shape == (6,)
    np.testing.assert_allclose(
        jnp.einsum("kij,kj->ki", params.sigma, b), params.mu, rtol=1e-3, atol=1e-4
    )


def test_sym3_eigvalsh_matches_lapack():
    """Analytic 3x3 eigenvalues vs numpy, including degenerate cases
    (duplicate eigenvalues, rank deficiency, diagonal, isotropic)."""
    from hgmm.ops.gaussians import sym3_eigvalsh

    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 3, 3)).astype(np.float32)
    mats = [a @ np.swapaxes(a, 1, 2)]  # random PSD
    mats.append(np.broadcast_to(np.eye(3, dtype=np.float32), (4, 3, 3)))
    mats.append(np.stack([np.diag([1e-6, 1e-6, 0.3]).astype(np.float32),
                          np.diag([2.0, 2.0, 2.0]).astype(np.float32),
                          np.zeros((3, 3), np.float32),
                          np.diag([0.0, 0.0, 5.0]).astype(np.float32)]))
    m = np.concatenate(mats)
    got = np.asarray(sym3_eigvalsh(jnp.asarray(m)))
    ref = np.linalg.eigvalsh(m.astype(np.float64))
    scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1e-6)
    # ~1e-4 * ||m|| worst case for clustered eigenvalues (acos near +-1).
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-4)


def test_psd_floor():
    from hgmm.ops.gaussians import psd_floor, sym3_eigvalsh

    rng = np.random.default_rng(1)
    a = rng.normal(size=(32, 3, 3)).astype(np.float32) * 0.3
    sigma = a @ np.swapaxes(a, 1, 2)
    sigma[0] = np.diag([1e-9, 1e-9, 0.5])  # collapsed
    sigma[1] -= 0.05 * np.eye(3, dtype=np.float32)  # possibly indefinite
    out = psd_floor(jnp.asarray(sigma), 1e-3)
    eigs = np.asarray(sym3_eigvalsh(out))
    assert np.all(np.isfinite(np.asarray(out)))
    assert eigs[:, 0].min() >= 1e-3 * (1 - 1e-3)


def test_collapsed_mixture_stats_finite():
    """A collapsed-covariance mixture (|W| ~ 1e6) gives finite statistics
    and log-likelihood: the softmax subtracts each point's own max."""
    k = 16
    mu = jax.random.normal(jax.random.PRNGKey(0), (k, 3))
    sigma = jnp.broadcast_to(
        jnp.diag(jnp.array([1e-6, 1e-6, 0.1])), (k, 3, 3)
    )
    params = MixtureParams(jnp.full((k,), 1.0 / k), mu, sigma)
    pts = 2.0 * jax.random.normal(jax.random.PRNGKey(1), (300, 3))
    got = em_ref.em_stats(pts, pack_loglik_weights(params))
    assert bool(jnp.isfinite(got.S).all()), got.S
    assert bool(jnp.isfinite(got.loglik))
    T0, _, _ = unpack_suffstats(got.S)
    np.testing.assert_allclose(float(jnp.sum(T0)), 300.0, rtol=1e-5)


def test_mstep_cov_floor():
    """cov_floor keeps the smallest covariance eigenvalue at the floor even
    when the stats describe perfectly coplanar points."""
    from hgmm.ops.gaussians import sym3_eigvalsh

    n, k = 500, 2
    pts = np.zeros((n, 3), np.float32)
    pts[:, :2] = np.random.default_rng(3).normal(size=(n, 2))
    gamma = np.zeros((n, k), np.float32)
    gamma[: n // 2, 0] = 1.0
    gamma[n // 2 :, 1] = 1.0
    T0 = jnp.asarray(gamma.sum(0))
    T1 = jnp.asarray(gamma.T @ pts)
    T2 = jnp.asarray(np.einsum("nk,ni,nj->kij", gamma, pts, pts))
    p = mstep_update(T0, T1, T2, float(n), cov_reg=1e-6, cov_floor=1e-3)
    eigs = np.asarray(sym3_eigvalsh(p.sigma))
    assert eigs[:, 0].min() >= 1e-3 * (1 - 1e-3)
