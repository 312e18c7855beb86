"""Fused E-step kernels for NVIDIA GPUs, written in Pallas through Triton.

Two operations of hgmm.ops run as kernels here; every other op is plain
XLA. Each kernel has its dense twin in hgmm.ops.em_ref, with the same
contract.

em_stats (every flat fit sweep and every masked tree level), two passes,
the attention forward/dV split applied to EM:

  1. `_lse_kernel`: one program per block of BLOCK_N points walks the
     components in blocks of BLOCK_K with an online log-sum-exp (running max
     and rescaled sum) and writes each point's log-normaliser lse[N],
     the uniform outlier component included.
  2. `_stats_kernel`: a grid of (component block x point super-block)
     programs. Each recomputes gamma = w * exp(logit - lse) for its
     component block and accumulates S^T = Psi^T gamma over its points;
     XLA adds the [P, 16, K] partial sums. Nothing carries between
     programs, no atomics are used, and the sums do not depend on the
     order in which programs run.

reg_stats (every registration iteration), one pass: per block of points
the pose is applied in-kernel from a 16-float operand, and an online
softmax over component blocks accumulates gamma @ [mu | A6 | b3 | 1] into
per-point rows [N, 16]. The Horn and Gauss-Newton reductions over those
rows run in XLA (em_ref.pose_moments). With `top_k` the kernel first
walks the components once to find each point's k-th largest logit.

Numerics follow em_ref's f32 arithmetic: logits are the quadratic form
-1/2 psi(y) . W, evaluated as nine f32 multiply-adds per (point,
component) on the CUDA cores, in log2 units (log2(e) folded into the
packed weights, one extra rounding) so each exponential is one exp2; both
contractions are f32 dots at Precision.HIGHEST (Triton's IEEE input
precision). The quadratic form cancels badly for tight covariances
(gaussians.precision_terms) and the registration residual M y - u cancels
too, so neither is given to plain TF32; TF32x3 was measured and was not
faster at every shape (PERF.md).

The point buffer is built once per fit or registration by `features`:
[16, N_pad] f32 with rows 0-9 the monomial features psi(x), row 10 the
point weight (0 on padding rows) and rows 11-15 zero; x, y, z are rows
6-8. `interpret=True` runs a kernel in the Pallas interpreter; only
tests pass it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from hgmm.ops.em_ref import NEG_INF, EmStats, RegStats, pose_moments
from hgmm.ops.gaussians import PHI_DIM, PHI_PAD

# Block sizes, chosen by measurement on an H100 (PERF.md): [128 x 64]
# logit tiles ran 3x slower than [128 x 32] or [128 x 16] ones (too many
# registers per thread, most likely), and 64- or 32-point blocks were
# slower for the fit kernels.
BLOCK_N = 128  # points per block (a power of two, as Triton wants)
BLOCK_K = 16  # components per block (Triton's smallest dot dimension)
# Programs of the stats pass: a few per SM of an H100 (132 SMs), so the
# [P, 16, K] partial sums stay near a megabyte whatever N is.
STATS_PROGRAMS = 528
_COMPILER_PARAMS = plgpu.CompilerParams(num_warps=4, num_stages=2)
_DOT = lax.Precision.HIGHEST
_F32 = jnp.float32
# Logits are carried in log2 units (log2(e) folded into the packed
# weights), so every exponential is one exp2.
LOG2E = 1.4426950408889634


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_components(k: int) -> int:
    """K rounded up to whole component blocks."""
    return _round_up(k, BLOCK_K)


def features(points: jax.Array, point_weights: jax.Array | None = None):
    """[N, 3] points (+ optional [N] weights) -> [16, N_pad] f32 buffer
    (layout in the module docstring), N_pad a multiple of BLOCK_N."""
    n = points.shape[0]
    n_pad = _round_up(max(n, 1), BLOCK_N)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    w = (
        jnp.ones((n,), _F32) if point_weights is None
        else point_weights.astype(_F32)
    )
    rows = [x * x, y * y, z * z, x * y, x * z, y * z, x, y, z,
            jnp.ones_like(x), w]
    feat = jnp.stack([r.astype(_F32) for r in rows], axis=0)
    return jnp.pad(feat, ((0, PHI_PAD - feat.shape[0]), (0, n_pad - n)))


def _pack_mixture(W: jax.Array, k_pad: int) -> jax.Array:
    """pack_loglik_weights output [>=10, K] -> [16, K_pad] with -1/2 and
    log2(e) folded in, so the kernels' logits are log2 densities. Padding
    components get the logit NEG_INF, the value em_ref gives masked
    entries."""
    k = W.shape[1]
    wt = (-0.5 * LOG2E) * W[:PHI_DIM].astype(_F32)
    wt = jnp.pad(wt, ((0, PHI_PAD - PHI_DIM), (0, k_pad - k)))
    return wt.at[PHI_DIM - 1, k:].set(NEG_INF)


def _outlier(outlier_logit) -> jax.Array:
    """The outlier log-density in log2 units; None -> NEG_INF, which
    em_ref._soft treats exactly as no outlier."""
    if outlier_logit is None:
        return jnp.asarray(NEG_INF, _F32)
    return LOG2E * jnp.asarray(outlier_logit, _F32)


# ---------------------------------------------------------------------------
# Kernel building blocks (traced inside kernel bodies)
# ---------------------------------------------------------------------------

def _logits(ph, wt_ref, kb):
    """[BN, BLOCK_K] logits of component block kb: -1/2 psi . W as nine
    rank-1 f32 multiply-adds onto the constant row. ph: the nine
    non-constant feature rows, each [BN]."""
    ks = pl.ds(kb * BLOCK_K, BLOCK_K)
    acc = jnp.broadcast_to(
        wt_ref[PHI_DIM - 1, ks][None, :], (ph[0].shape[0], BLOCK_K)
    )
    for c in range(PHI_DIM - 1):
        acc = acc + ph[c][:, None] * wt_ref[c, ks][None, :]
    return acc


def _child_mask(logits, parent, kb, branch):
    """em_ref.child_mask_logits for one component block."""
    comp = kb * BLOCK_K + lax.broadcasted_iota(jnp.int32, logits.shape, 1)
    return jnp.where(comp // branch == parent[:, None], logits, NEG_INF)


def _lse_step(m, s, logits):
    """One online log-sum-exp step (log2 units): running max m and sum s
    (both [BN], s relative to m). Fully masked rows keep m = NEG_INF and a
    finite s that _lse_final discards."""
    m_new = jnp.maximum(m, jnp.max(logits, axis=1))
    e = jnp.exp2(logits - m_new[:, None])
    return m_new, s * jnp.exp2(m - m_new) + jnp.sum(e, axis=1), e


def _lse_final(m, s, outlier):
    """Fold the outlier component in. Returns (lse, c1, tot, dead) with
    lse = log2(2^outlier + sum 2^logits), zero on fully masked rows as in
    em_ref._soft; c1 rescales s to the final max, tot = the final
    normaliser relative to that max (>= 1 on live rows)."""
    m_f = jnp.maximum(m, outlier)
    c1 = jnp.exp2(m - m_f)
    tot = s * c1 + jnp.exp2(outlier - m_f)
    dead = m_f <= NEG_INF
    lse = jnp.where(dead, 0.0, m_f + LOG2E * jnp.log(jnp.maximum(tot, 1e-38)))
    return lse, c1, tot, dead


def _psi_rows(y0, y1, y2):
    """The nine non-constant monomial features of gaussians.features."""
    return [y0 * y0, y1 * y1, y2 * y2, y0 * y1, y0 * y2, y1 * y2, y0, y1, y2]


def _top_k_threshold(ph, wt_ref, nkb, top_k):
    """Each point's top_k-th largest logit, counting ties as lax.top_k
    does: a descending running list of top_k values, into which every
    block's top_k largest are inserted one at a time."""
    bn = ph[0].shape[0]

    def body(kb, tops):
        logits = _logits(ph, wt_ref, kb)
        col = lax.broadcasted_iota(jnp.int32, logits.shape, 1)
        tops = list(tops)
        for _ in range(top_k):
            v = jnp.max(logits, axis=1)
            first = jnp.min(jnp.where(logits >= v[:, None], col, BLOCK_K), axis=1)
            logits = jnp.where(col == first[:, None], -3e38, logits)
            new = [jnp.maximum(tops[0], v)]
            for j in range(1, top_k):
                new.append(jnp.maximum(tops[j], jnp.minimum(tops[j - 1], v)))
            tops = new
        return tuple(tops)

    init = tuple(jnp.full((bn,), -3e38, _F32) for _ in range(top_k))
    return lax.fori_loop(0, nkb, body, init)[-1]


# ---------------------------------------------------------------------------
# em_stats: log-normaliser pass + partial-sum stats pass
# ---------------------------------------------------------------------------

def _lse_kernel(feat_ref, wt_ref, sc_ref, *refs, nkb, branch):
    parent_ref, lse_ref = (refs if branch else (None,) + refs)
    ph = [feat_ref[c, :] for c in range(PHI_DIM - 1)]
    parent = parent_ref[:] if branch else None
    bn = ph[0].shape[0]

    def body(kb, carry):
        logits = _logits(ph, wt_ref, kb)
        if branch:
            logits = _child_mask(logits, parent, kb, branch)
        m, s, _ = _lse_step(*carry, logits)
        return m, s

    init = (jnp.full((bn,), NEG_INF, _F32), jnp.zeros((bn,), _F32))
    m, s = lax.fori_loop(0, nkb, body, init)
    lse_ref[:] = _lse_final(m, s, sc_ref[0])[0]


def _stats_kernel(feat_ref, wt_ref, lse_ref, *refs, bpp, nblocks, branch):
    parent_ref, out_ref = (refs if branch else (None,) + refs)
    kb = pl.program_id(0)
    first = pl.program_id(1) * bpp
    count = jnp.minimum(bpp, nblocks - first)

    def body(i, acc):
        sl = pl.ds(pl.multiple_of((first + i) * BLOCK_N, BLOCK_N), BLOCK_N)
        ph = [feat_ref[c, sl] for c in range(PHI_DIM - 1)]
        logits = _logits(ph, wt_ref, kb)
        if branch:
            logits = _child_mask(logits, parent_ref[sl], kb, branch)
        w = feat_ref[PHI_DIM, sl]
        gamma = jnp.exp2(logits - lse_ref[sl][:, None]) * w[:, None]
        return acc + pl.dot(feat_ref[:, sl], gamma, precision=_DOT)

    out_ref[...] = lax.fori_loop(
        0, count, body, jnp.zeros((PHI_PAD, BLOCK_K), _F32)
    )


def em_stats(
    feat: jax.Array,
    W: jax.Array,
    outlier_logit=None,
    parent: jax.Array | None = None,
    branch: int | None = None,
    *,
    interpret: bool = False,
) -> EmStats:
    """Kernel twin of em_ref.em_stats (parent=None) and of
    em_ref.em_stats_masked (parent [N] and branch given). feat: the
    `features` buffer, weights baked in."""
    n_pad = feat.shape[1]
    nblocks = n_pad // BLOCK_N
    k = W.shape[1]
    k_pad = padded_components(k)
    nkb = k_pad // BLOCK_K
    wt = _pack_mixture(W, k_pad)
    sc = jnp.zeros((PHI_PAD,), _F32).at[0].set(_outlier(outlier_logit))
    masked = parent is not None
    args, branch_arg = [], 0
    if masked:
        branch_arg = int(branch)
        args = [jnp.pad(parent.astype(jnp.int32), (0, n_pad - parent.shape[0]),
                        constant_values=-1)]

    lse = pl.pallas_call(
        functools.partial(_lse_kernel, nkb=nkb, branch=branch_arg),
        grid=(nblocks,),
        in_specs=[
            pl.BlockSpec((PHI_PAD, BLOCK_N), lambda i: (0, i)),
            pl.BlockSpec((PHI_PAD, k_pad), lambda i: (0, 0)),
            pl.BlockSpec((PHI_PAD,), lambda i: (0,)),
        ] + [pl.BlockSpec((BLOCK_N,), lambda i: (i,))] * masked,
        out_specs=pl.BlockSpec((BLOCK_N,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((n_pad,), _F32),
        compiler_params=_COMPILER_PARAMS,
        backend="triton",
        interpret=interpret,
        name="hgmm_em_lse",
    )(feat, wt, sc, *args)

    bpp = -(-nblocks // max(1, STATS_PROGRAMS // nkb))  # blocks per program
    n_prog = -(-nblocks // bpp)
    parts = pl.pallas_call(
        functools.partial(_stats_kernel, bpp=bpp, nblocks=nblocks,
                          branch=branch_arg),
        grid=(nkb, n_prog),
        in_specs=[
            pl.BlockSpec((PHI_PAD, n_pad), lambda kb, p: (0, 0)),
            pl.BlockSpec((PHI_PAD, k_pad), lambda kb, p: (0, 0)),
            pl.BlockSpec((n_pad,), lambda kb, p: (0,)),
        ] + [pl.BlockSpec((n_pad,), lambda kb, p: (0,))] * masked,
        out_specs=pl.BlockSpec(
            (None, PHI_PAD, BLOCK_K), lambda kb, p: (p, 0, kb)
        ),
        out_shape=jax.ShapeDtypeStruct((n_prog, PHI_PAD, k_pad), _F32),
        compiler_params=_COMPILER_PARAMS,
        backend="triton",
        interpret=interpret,
        name="hgmm_em_stats",
    )(feat, wt, lse, *args)
    S = jnp.sum(parts, axis=0).T[:k, :PHI_DIM]
    return EmStats(S=S, loglik=jnp.sum(lse * feat[PHI_DIM]) / LOG2E)


# ---------------------------------------------------------------------------
# reg_stats: one online-softmax pass with the pose applied in-kernel
# ---------------------------------------------------------------------------

def _reg_kernel(feat_ref, wt_ref, aux_ref, sc_ref, red_ref, lse_ref, *,
                nkb, top_k):
    x0, x1, x2 = feat_ref[6, :], feat_ref[7, :], feat_ref[8, :]
    r = [sc_ref[i] for i in range(12)]  # R row-major, then t
    y0 = r[0] * x0 + r[1] * x1 + r[2] * x2 + r[9]
    y1 = r[3] * x0 + r[4] * x1 + r[5] * x2 + r[10]
    y2 = r[6] * x0 + r[7] * x1 + r[8] * x2 + r[11]
    ph = _psi_rows(y0, y1, y2)
    bn = x0.shape[0]
    thr = _top_k_threshold(ph, wt_ref, nkb, top_k) if top_k else None

    def body(kb, carry):
        m, s, acc = carry
        logits = _logits(ph, wt_ref, kb)
        if top_k:
            logits = jnp.where(logits >= thr[:, None], logits, NEG_INF)
        m_new, s, e = _lse_step(m, s, logits)
        aux = aux_ref[pl.ds(kb * BLOCK_K, BLOCK_K), :]
        acc = acc * jnp.exp2(m - m_new)[:, None] + pl.dot(e, aux, precision=_DOT)
        return m_new, s, acc

    init = (jnp.full((bn,), NEG_INF, _F32), jnp.zeros((bn,), _F32),
            jnp.zeros((bn, PHI_PAD), _F32))
    m, s, acc = lax.fori_loop(0, nkb, body, init)
    lse, c1, tot, dead = _lse_final(m, s, sc_ref[12])
    w = feat_ref[PHI_DIM, :]
    scale = jnp.where(dead, 0.0, w * c1 / jnp.maximum(tot, 1e-38))
    red_ref[...] = acc * scale[:, None]
    lse_ref[:] = lse


def reg_stats(
    feat: jax.Array,
    W: jax.Array,
    mu: jax.Array,
    A6: jax.Array,
    b3: jax.Array,
    pose: tuple[jax.Array, jax.Array],
    top_k: int | None = None,
    outlier_logit=None,
    *,
    interpret: bool = False,
) -> RegStats:
    """Kernel twin of em_ref.reg_stats. feat: the `features` buffer of the
    SOURCE points (model frame), weights baked in; pose (R, t) is applied
    in-kernel, so the buffer is never rewritten per iteration."""
    n_pad = feat.shape[1]
    k = W.shape[1]
    k_pad = padded_components(k)
    nkb = k_pad // BLOCK_K
    if top_k is not None and top_k >= k:
        top_k = None  # em_ref.top_k_mask_logits keeps every logit then
    R, t = pose
    wt = _pack_mixture(W, k_pad)
    aux = jnp.concatenate(
        [mu, A6, b3, jnp.ones((k, 1), mu.dtype)], axis=1
    ).astype(_F32)  # [K, 13]: mu | A6 | b3 | 1
    aux = jnp.pad(aux, ((0, k_pad - k), (0, PHI_PAD - aux.shape[1])))
    sc = jnp.concatenate([
        R.reshape(-1).astype(_F32), t.reshape(-1).astype(_F32),
        _outlier(outlier_logit)[None], jnp.zeros((3,), _F32),
    ])
    red, lse = pl.pallas_call(
        functools.partial(_reg_kernel, nkb=nkb, top_k=top_k or 0),
        grid=(n_pad // BLOCK_N,),
        in_specs=[
            pl.BlockSpec((PHI_PAD, BLOCK_N), lambda i: (0, i)),
            pl.BlockSpec((PHI_PAD, k_pad), lambda i: (0, 0)),
            pl.BlockSpec((k_pad, PHI_PAD), lambda i: (0, 0)),
            pl.BlockSpec((PHI_PAD,), lambda i: (0,)),
        ],
        out_specs=[
            pl.BlockSpec((BLOCK_N, PHI_PAD), lambda i: (i, 0)),
            pl.BlockSpec((BLOCK_N,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n_pad, PHI_PAD), _F32),
            jax.ShapeDtypeStruct((n_pad,), _F32),
        ],
        compiler_params=_COMPILER_PARAMS,
        backend="triton",
        interpret=interpret,
        name="hgmm_reg_stats",
    )(feat, wt, aux, sc)
    # Padding rows carry weight 0, so their rows of `red` are zero and
    # they add nothing below.
    x = feat[6:9].T
    y = x @ R.T + t
    horn, A, b = pose_moments(x, y, red[:, 0:3], red[:, 3:9], red[:, 9:12],
                              red[:, 12])
    return RegStats(
        horn=horn, A=A, b=b, loglik=jnp.sum(lse * feat[PHI_DIM]) / LOG2E
    )
