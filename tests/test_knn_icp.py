import jax
import jax.numpy as jnp
import numpy as np

from hgmm.baselines.icp import icp, icp_numpy
from hgmm.baselines.numpy_em import em_fit_numpy, register_numpy
from hgmm.data.synthetic import make_cloud
from hgmm.eval.metrics import registration_rmse
from hgmm.models.gmm import Gmm
from hgmm.models.se3 import Pose, random_pose, so3_exp
from hgmm.ops.knn import nearest_neighbor
from hgmm.pipelines.register import register_points


def test_knn_chunked_matches_brute_force():
    """The chunked distance-matmul search returns the true nearest target
    (indices may flip only on exact ties)."""
    q = jax.random.normal(jax.random.PRNGKey(0), (500, 3))
    t = jax.random.normal(jax.random.PRNGKey(1), (700, 3))
    idx, d2 = nearest_neighbor(q, t)
    brute = np.sum((np.asarray(q)[:, None] - np.asarray(t)[None]) ** 2, -1)
    np.testing.assert_array_equal(idx, np.argmin(brute, axis=1))
    np.testing.assert_allclose(d2, brute.min(axis=1), rtol=1e-4, atol=1e-5)


def test_icp_recovers_known_motion():
    """ICP through the nearest-neighbour search recovers a known small
    rigid motion."""
    target = jax.random.normal(jax.random.PRNGKey(12), (600, 3))
    gt = Pose(so3_exp(jnp.array([0.0, 0.0, 0.05])), jnp.array([0.02, -0.01, 0.015]))
    source = gt.inverse().apply(target)
    res = icp(source, target, n_iters=20)
    np.testing.assert_allclose(np.asarray(res.pose.R), np.asarray(gt.R), atol=1e-3)
    np.testing.assert_allclose(np.asarray(res.pose.t), np.asarray(gt.t), atol=1e-3)


def test_knn_identity():
    t = jax.random.normal(jax.random.PRNGKey(2), (300, 3))
    idx, d2 = nearest_neighbor(t, t)
    np.testing.assert_array_equal(idx, np.arange(300))
    np.testing.assert_allclose(d2, 0.0, atol=1e-5)


def test_icp_recovers_small_pose():
    cloud = make_cloud(jax.random.PRNGKey(3), 1500, kind="trefoil")
    gt = random_pose(jax.random.PRNGKey(4), max_angle=0.1, max_trans=0.03)
    source = gt.inverse().apply(cloud)
    res = icp(source, cloud, n_iters=25)
    err = registration_rmse(res.pose, source, gt)
    assert float(err) < 0.02, float(err)


def test_icp_numpy_agrees_with_jax():
    cloud = make_cloud(jax.random.PRNGKey(5), 800, kind="helix")
    gt = random_pose(jax.random.PRNGKey(6), max_angle=0.08, max_trans=0.02)
    source = gt.inverse().apply(cloud)
    p_np = icp_numpy(np.asarray(source), np.asarray(cloud), n_iters=25)
    p_jx = icp(source, cloud, n_iters=25).pose
    np.testing.assert_allclose(p_np.R, p_jx.R, atol=1e-3)
    np.testing.assert_allclose(p_np.t, p_jx.t, atol=1e-3)


def test_engine_matches_trusted_numpy_oracle():
    """BASELINE.md parity row: the fast engine against the float64 numpy
    EM-ICP oracle on the same mixture."""
    cloud = make_cloud(jax.random.PRNGKey(7), 1200, kind="trefoil")
    gmm, _ = Gmm.fit(cloud, k=16, n_iters=20, key=jax.random.PRNGKey(8))
    gt = random_pose(jax.random.PRNGKey(9), max_angle=0.15, max_trans=0.04)
    source = gt.inverse().apply(cloud)
    pi = np.asarray(gmm.params.pi)
    mu = np.asarray(gmm.params.mu)
    sigma = np.asarray(gmm.params.sigma)
    R_np, t_np = register_numpy(np.asarray(source), pi, mu, sigma, n_iters=30)
    res = register_points(source, gmm.params, n_iters=30, method="horn")
    np.testing.assert_allclose(res.pose.R, R_np, atol=2e-3)
    np.testing.assert_allclose(res.pose.t, t_np, atol=2e-3)


def test_numpy_em_loglik_monotone():
    pts = np.asarray(make_cloud(jax.random.PRNGKey(10), 600, kind="blob"))
    _, _, _, lls = em_fit_numpy(pts, 6, n_iters=15)
    assert np.all(np.diff(lls) > -1e-6 * abs(lls[0]))
