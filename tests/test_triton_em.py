"""Triton E-step kernels == dense jnp twins (SURVEY.md §5.2: "every Pallas
kernel ships with a jnp twin, tested against each other").

On the CPU the kernels run in the Pallas interpreter (interpret=True); the
same kernels compiled for the card are compared with the twins by
test_kernels_on_gpu (gpu marker) and by chip_smoke.py phase 1 at real
widths. Both sides compute in f32 with the same arithmetic, so the
tolerances are f32 summation-order tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hgmm import ops
from hgmm.models.se3 import random_pose
from hgmm.ops import em_ref, triton_em
from hgmm.ops.gaussians import (
    MixtureParams,
    pack_loglik_weights,
    precision_terms,
    sym_pack,
)

RTOL, ATOL = 1e-4, 1e-5


def _mixture(key, k):
    k1, k2, k3 = jax.random.split(key, 3)
    mu = jax.random.normal(k1, (k, 3))
    a = 0.3 * jax.random.normal(k2, (k, 3, 3))
    sigma = jnp.einsum("kij,klj->kil", a, a) + 0.05 * jnp.eye(3)
    pi = jax.nn.softmax(jax.random.normal(k3, (k,)))
    return MixtureParams(pi, mu, sigma)


def _points(key, n=300):
    return jax.random.normal(key, (n, 3))


def _assert_stats(got, ref, rtol=RTOL, atol=ATOL):
    scale = float(jnp.max(jnp.abs(ref.S)))
    np.testing.assert_allclose(got.S, ref.S, rtol=rtol, atol=atol * max(scale, 1.0))
    np.testing.assert_allclose(got.loglik, ref.loglik, rtol=rtol)


def _assert_reg(got, ref, rtol=RTOL, atol=ATOL):
    for f in ("horn", "A", "b"):
        a, b = getattr(got, f), getattr(ref, f)
        scale = float(jnp.max(jnp.abs(b)))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * max(scale, 1.0))
    np.testing.assert_allclose(got.loglik, ref.loglik, rtol=rtol)


def _reg_args(params, key):
    A, b, _ = precision_terms(params)
    pose = random_pose(key)
    return params.mu, sym_pack(A), b, (pose.R, pose.t)


# ---------------------------------------------------------------------------
# em_stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [8, 12, 64])
def test_em_stats_matches_ref(k):
    params = _mixture(jax.random.PRNGKey(0), k)
    pts = _points(jax.random.PRNGKey(1))
    W = pack_loglik_weights(params)
    got = triton_em.em_stats(triton_em.features(pts), W, interpret=True)
    _assert_stats(got, em_ref.em_stats(pts, W))


@pytest.mark.parametrize("k", [8, 64])
def test_em_stats_weights_and_outlier(k):
    params = _mixture(jax.random.PRNGKey(2), k)
    pts = _points(jax.random.PRNGKey(3), 200)
    w = jax.random.uniform(jax.random.PRNGKey(4), (200,))
    W = pack_loglik_weights(params)
    got = triton_em.em_stats(
        triton_em.features(pts, w), W, outlier_logit=-3.0, interpret=True
    )
    _assert_stats(got, em_ref.em_stats(pts, W, w, outlier_logit=-3.0))


@pytest.mark.parametrize("k,branch", [(16, 8), (64, 8), (12, 4)])
def test_em_stats_masked_matches_ref(k, branch):
    params = _mixture(jax.random.PRNGKey(5), k)
    pts = _points(jax.random.PRNGKey(6), 300)
    w = (jax.random.uniform(jax.random.PRNGKey(8), (300,)) > 0.2).astype(jnp.float32)
    parent = jax.random.randint(jax.random.PRNGKey(7), (300,), 0, k // branch)
    W = pack_loglik_weights(params)
    got = triton_em.em_stats(
        triton_em.features(pts, w), W, None, parent, branch, interpret=True
    )
    _assert_stats(got, em_ref.em_stats_masked(pts, W, parent, branch, w))


@pytest.mark.parametrize("outlier", [-3.0, -80.0])
def test_em_stats_outlier_dominated(outlier):
    """Points far from every component with an outlier component: lse
    converges to the outlier logit and the stats stay ~0."""
    params = _mixture(jax.random.PRNGKey(30), 8)
    pts = _points(jax.random.PRNGKey(31), 128) + 50.0
    W = pack_loglik_weights(params)
    got = triton_em.em_stats(
        triton_em.features(pts), W, outlier_logit=outlier, interpret=True
    )
    ref = em_ref.em_stats(pts, W, outlier_logit=outlier)
    np.testing.assert_allclose(got.loglik, ref.loglik, rtol=1e-5)
    np.testing.assert_allclose(got.S, ref.S, atol=1e-6)


def test_em_stats_far_point_mixed():
    """One far point among normal ones, with an outlier component."""
    params = _mixture(jax.random.PRNGKey(32), 16)
    pts = jnp.concatenate(
        [_points(jax.random.PRNGKey(33), 255), jnp.full((1, 3), 40.0)], axis=0
    )
    W = pack_loglik_weights(params)
    got = triton_em.em_stats(
        triton_em.features(pts), W, outlier_logit=-5.0, interpret=True
    )
    _assert_stats(got, em_ref.em_stats(pts, W, outlier_logit=-5.0))


def test_em_stats_collapsed_mixture():
    """Collapsed covariances (|W| ~ 1e6): the per-point max makes the
    softmax overflow-proof, and the f32 logits match the twin's."""
    k = 16
    mu = jax.random.normal(jax.random.PRNGKey(0), (k, 3))
    sigma = jnp.broadcast_to(jnp.diag(jnp.array([1e-6, 1e-6, 0.1])), (k, 3, 3))
    params = MixtureParams(jnp.full((k,), 1.0 / k), mu, sigma)
    pts = 2.0 * _points(jax.random.PRNGKey(1))
    W = pack_loglik_weights(params)
    got = triton_em.em_stats(triton_em.features(pts), W, interpret=True)
    assert bool(jnp.isfinite(got.S).all()) and bool(jnp.isfinite(got.loglik))
    _assert_stats(got, em_ref.em_stats(pts, W), rtol=1e-3, atol=1e-4)


def test_em_stats_dead_components():
    """pi = 0 components (the M-step's empty ones) get exactly zero stats."""
    params = _mixture(jax.random.PRNGKey(40), 16)
    pi = params.pi.at[3].set(0.0).at[11].set(0.0)
    params = MixtureParams(pi / jnp.sum(pi), params.mu, params.sigma)
    pts = _points(jax.random.PRNGKey(41))
    W = pack_loglik_weights(params)
    got = triton_em.em_stats(triton_em.features(pts), W, interpret=True)
    _assert_stats(got, em_ref.em_stats(pts, W))
    assert float(jnp.max(jnp.abs(got.S[jnp.array([3, 11])]))) == 0.0


@pytest.mark.parametrize("n", [1, 127, 128, 129, 300])
def test_em_stats_padding(n):
    """N not a multiple of the point block: padding rows carry weight 0."""
    params = _mixture(jax.random.PRNGKey(9), 12)
    pts = _points(jax.random.PRNGKey(10), n)
    W = pack_loglik_weights(params)
    feat = triton_em.features(pts)
    assert feat.shape[1] % triton_em.BLOCK_N == 0 and feat.shape[1] >= n
    got = triton_em.em_stats(feat, W, interpret=True)
    _assert_stats(got, em_ref.em_stats(pts, W))


@pytest.mark.parametrize("programs,k", [(3, 100), (1, 64), (5, 8)])
def test_em_stats_partial_sums(monkeypatch, programs, k):
    """Stats-pass grids with several point blocks per program, a ragged
    last program and several component blocks all add up to the twin."""
    monkeypatch.setattr(triton_em, "STATS_PROGRAMS", programs)
    params = _mixture(jax.random.PRNGKey(11), k)
    pts = _points(jax.random.PRNGKey(12), 1000)
    W = pack_loglik_weights(params)
    got = triton_em.em_stats(triton_em.features(pts), W, interpret=True)
    _assert_stats(got, em_ref.em_stats(pts, W))


# ---------------------------------------------------------------------------
# reg_stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [None, 4])
@pytest.mark.parametrize("outlier", [None, -2.0])
def test_reg_stats_matches_ref(top_k, outlier):
    """Non-identity pose, point weights, optional top-k gating and outlier."""
    params = _mixture(jax.random.PRNGKey(13), 16)
    pts = _points(jax.random.PRNGKey(14), 300)
    w = (jax.random.uniform(jax.random.PRNGKey(15), (300,)) > 0.3).astype(jnp.float32)
    W = pack_loglik_weights(params)
    mu, A6, b3, pose = _reg_args(params, jax.random.PRNGKey(16))
    got = triton_em.reg_stats(
        triton_em.features(pts, w), W, mu, A6, b3, pose, top_k, outlier,
        interpret=True,
    )
    ref = em_ref.reg_stats(pts, W, mu, A6, b3, pose, w, top_k, outlier)
    _assert_reg(got, ref)


def test_reg_stats_outlier_dominated():
    params = _mixture(jax.random.PRNGKey(34), 8)
    pts = _points(jax.random.PRNGKey(35), 128) + 30.0
    W = pack_loglik_weights(params)
    mu, A6, b3, pose = _reg_args(params, jax.random.PRNGKey(36))
    got = triton_em.reg_stats(
        triton_em.features(pts), W, mu, A6, b3, pose, outlier_logit=-2.0,
        interpret=True,
    )
    ref = em_ref.reg_stats(pts, W, mu, A6, b3, pose, outlier_logit=-2.0)
    np.testing.assert_allclose(got.loglik, ref.loglik, rtol=1e-5)
    np.testing.assert_allclose(got.A, ref.A, atol=1e-5)
    np.testing.assert_allclose(got.b, ref.b, atol=1e-5)


def test_reg_stats_top_k_several_blocks():
    """top_k across component blocks (K=100: seven blocks of 16)."""
    params = _mixture(jax.random.PRNGKey(17), 100)
    pts = _points(jax.random.PRNGKey(18), 200)
    W = pack_loglik_weights(params)
    mu, A6, b3, pose = _reg_args(params, jax.random.PRNGKey(19))
    got = triton_em.reg_stats(
        triton_em.features(pts), W, mu, A6, b3, pose, 8, 0.0, interpret=True
    )
    _assert_reg(got, em_ref.reg_stats(pts, W, mu, A6, b3, pose, None, 8, 0.0))


def test_reg_stats_top_k_ties():
    """Duplicated components tie exactly; ties count as lax.top_k counts
    them (the k-th largest with multiplicity), so the kept set matches."""
    base = _mixture(jax.random.PRNGKey(20), 6)
    params = MixtureParams(
        jnp.concatenate([base.pi, base.pi]) / 2.0,
        jnp.concatenate([base.mu, base.mu]),
        jnp.concatenate([base.sigma, base.sigma]),
    )
    pts = _points(jax.random.PRNGKey(21), 150)
    W = pack_loglik_weights(params)
    mu, A6, b3, pose = _reg_args(params, jax.random.PRNGKey(22))
    got = triton_em.reg_stats(
        triton_em.features(pts), W, mu, A6, b3, pose, 3, interpret=True
    )
    _assert_reg(got, em_ref.reg_stats(pts, W, mu, A6, b3, pose, None, 3))


def test_reg_stats_top_k_at_least_k_is_ungated():
    params = _mixture(jax.random.PRNGKey(23), 8)
    pts = _points(jax.random.PRNGKey(24), 100)
    W = pack_loglik_weights(params)
    mu, A6, b3, pose = _reg_args(params, jax.random.PRNGKey(25))
    feat = triton_em.features(pts)
    a = triton_em.reg_stats(feat, W, mu, A6, b3, pose, 8, interpret=True)
    b = triton_em.reg_stats(feat, W, mu, A6, b3, pose, None, interpret=True)
    for f in ("horn", "A", "b", "loglik"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def test_features_layout():
    pts = _points(jax.random.PRNGKey(26), 130)
    w = jnp.linspace(0.5, 1.5, 130)
    feat = np.asarray(triton_em.features(pts, w))
    assert feat.shape == (16, 256) and feat.dtype == np.float32
    np.testing.assert_allclose(feat[:10, :130].T, ops.features(pts), rtol=1e-6)
    np.testing.assert_allclose(feat[10, :130], w, rtol=1e-6)
    assert not feat[11:].any() and not feat[:, 130:].any()


@pytest.mark.parametrize(
    "k,k_pad", [(1, 16), (8, 16), (12, 16), (24, 32), (64, 64), (100, 112), (512, 512)]
)
def test_padded_components(k, k_pad):
    assert triton_em.padded_components(k) == k_pad
    assert k_pad % triton_em.BLOCK_K == 0


def test_pack_mixture_pads_dead_components():
    params = _mixture(jax.random.PRNGKey(27), 12)
    W = pack_loglik_weights(params)
    wt = np.asarray(triton_em._pack_mixture(W, 16))
    assert wt.shape == (16, 16)
    np.testing.assert_allclose(
        wt[:10, :12], -0.5 * triton_em.LOG2E * np.asarray(W), rtol=1e-6
    )
    assert (wt[9, 12:] == em_ref.NEG_INF).all() and not wt[:9, 12:].any()
    assert not wt[10:].any()


# ---------------------------------------------------------------------------
# Dispatch (hgmm.ops)
# ---------------------------------------------------------------------------

def test_dispatch_cpu_uses_twins():
    assert jax.default_backend() == "cpu"
    assert ops.get_backend() == "auto" and not ops._pallas_active()
    prep = ops.prepare(_points(jax.random.PRNGKey(0), 64))
    assert prep.feat is None and prep.n == 64


def test_set_backend_pallas_without_gpu_raises():
    prev = ops.get_backend()
    with pytest.raises(RuntimeError, match="needs a GPU"):
        ops.set_backend("pallas")
    assert ops.get_backend() == prev


def test_set_backend_ref_and_unknown_name():
    prev = ops.get_backend()
    try:
        ops.set_backend("ref")
        assert not ops._pallas_active()
        with pytest.raises(ValueError):
            ops.set_backend("bogus")
    finally:
        ops.set_backend(prev)


def test_dispatch_rule_picks_kernels_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert ops._pallas_active()
    monkeypatch.setattr(ops, "_BACKEND", "ref")
    assert not ops._pallas_active()


def _kernel_path(monkeypatch):
    """Route hgmm.ops to the kernels as on a GPU, run in the interpreter."""
    monkeypatch.setattr(ops, "_pallas_active", lambda: True)
    for name in ("em_stats", "reg_stats"):
        fn = getattr(triton_em, name)
        monkeypatch.setattr(
            triton_em, name,
            lambda *a, _fn=fn, **k: _fn(*a, **k, interpret=True),
        )


def test_prepared_holds_kernel_buffer(monkeypatch):
    _kernel_path(monkeypatch)
    pts = _points(jax.random.PRNGKey(1), 200)
    w = jnp.ones((200,))
    prep = ops.prepare(pts, w)
    assert prep.feat.shape == (16, 256) and prep.n == 200
    assert prep.points is pts and prep.point_weights is w
    leaves = jax.tree_util.tree_leaves(prep)
    assert len(leaves) == 3  # points, weights, feat; n is static


@pytest.mark.parametrize("op", ["em_stats", "em_stats_masked", "reg_stats"])
def test_ops_route_to_kernels(monkeypatch, op):
    """With the kernel path active, hgmm.ops reaches the kernels (run here
    in the interpreter) and matches the twins through the same API."""
    params = _mixture(jax.random.PRNGKey(2), 16)
    pts = _points(jax.random.PRNGKey(3), 200)
    W = pack_loglik_weights(params)
    parent = jax.random.randint(jax.random.PRNGKey(4), (200,), 0, 2)
    mu, A6, b3, pose = _reg_args(params, jax.random.PRNGKey(5))
    calls = {
        "em_stats": lambda x: ops.em_stats(x, W, outlier_logit=-4.0),
        "em_stats_masked": lambda x: ops.em_stats_masked(x, W, parent, 8),
        "reg_stats": lambda x: ops.reg_stats(x, W, mu, A6, b3, pose, top_k=4),
    }
    ref = calls[op](ops.prepare(pts))
    _kernel_path(monkeypatch)
    prep = ops.prepare(pts)
    assert prep.feat is not None
    got = calls[op](prep)
    if op == "reg_stats":
        _assert_reg(got, ref)
    else:
        _assert_stats(got, ref)


def test_assign_is_plain_xla_on_every_path(monkeypatch):
    params = _mixture(jax.random.PRNGKey(6), 24)
    pts = _points(jax.random.PRNGKey(7), 300)
    W = pack_loglik_weights(params)
    parent = jax.random.randint(jax.random.PRNGKey(8), (300,), 0, 3)
    want = em_ref.assign(pts, W, parent, 8)
    _kernel_path(monkeypatch)
    got = ops.assign(ops.prepare(pts), W, parent, 8)
    assert got.shape == (300,)
    np.testing.assert_array_equal(got, want)


def test_weights_with_prepared_raise():
    prep = ops.prepare(_points(jax.random.PRNGKey(9), 64))
    with pytest.raises(ValueError, match="baked"):
        ops.em_stats(prep, jnp.zeros((10, 4)), point_weights=jnp.ones(64))


# ---------------------------------------------------------------------------
# Lowering for the card, checked on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["em", "masked", "reg", "reg_top_k"])
def test_kernels_lower_to_triton_for_cuda(case):
    """Every kernel lowers through the Pallas Triton route to Triton IR
    for CUDA (no primitive the route cannot lower). Compiling that IR to
    PTX needs the card: chip_smoke.py phase 1."""
    k, n = 64, 1000
    feat = triton_em.features(_points(jax.random.PRNGKey(0), n))
    W = pack_loglik_weights(_mixture(jax.random.PRNGKey(1), k))
    mu, A6, b3 = jnp.zeros((k, 3)), jnp.zeros((k, 6)), jnp.zeros((k, 3))
    pose = (jnp.eye(3), jnp.zeros(3))
    parent = jnp.zeros((n,), jnp.int32)
    fns = {
        "em": lambda f, W: triton_em.em_stats(f, W, -3.0),
        "masked": lambda f, W: triton_em.em_stats(f, W, None, parent, 8),
        "reg": lambda f, W: triton_em.reg_stats(f, W, mu, A6, b3, pose, None, -2.0),
        "reg_top_k": lambda f, W: triton_em.reg_stats(f, W, mu, A6, b3, pose, 8),
    }
    lowered = jax.jit(fns[case]).trace(feat, W).lower(lowering_platforms=("cuda",))
    n_kernels = lowered.as_text().count("xla.gpu.triton")
    assert n_kernels == (2 if case in ("em", "masked") else 1)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("op,k", [("em", 8), ("em", 512), ("masked", 64), ("reg", 512)])
def test_kernels_on_gpu(gpu, op, k):
    """The compiled kernels against the twins, at a small N."""
    import chip_smoke

    extra = {"branch": 8} if op == "masked" else {}
    res = chip_smoke.run_kernel_case(op, 50_000, k, extra, seed=0, timing=False)
    for f, err in res.items():
        assert err <= chip_smoke.TOL[f], (f, err)
