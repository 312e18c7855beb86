#!/usr/bin/env python
"""Smoke run of hgmm's main path on NVIDIA GPUs, at real sizes.

    python chip_smoke.py               # phases 0-3 on one GPU
    python chip_smoke.py --devices 4   # phase 0 + the sharded phase, 4 GPUs

Phase 0  The device: platform, kind, count, JAX version, XLA_FLAGS, the
         compile cache, and the card's name and power limit (nvidia-smi).
Phase 1  Each Triton E-step kernel, reached through hgmm.ops, against its
         f32 twin in em_ref at the shapes fits and registrations use: the
         error of every output beside its tolerance, kernel ms beside XLA
         ms, memory_analysis() of one fit sweep, peak device memory.
Phase 2  Object-scan registration: hgmm.register_pair with preset
         config2_tree_8x3 on a 437,645-point cloud (the Stanford dragon's
         published count) against a known pose.
Phase 3  Odometry: run_odometry(detect_closures=True) + refine_odometry at
         config-4 settings over 8 frames of ~120k raw points per scan.
Sharded  (--devices 4 only) sharded_tree_fit + sharded_register_tree on
         10,485,760 points over a 4-GPU mesh against the same programs on a
         1-GPU mesh, refine_chain_sharded against refine_pose_graph, and
         the collectives' device time from one trace.

Data and mixtures are generated from --seed. Every check raises on
failure, so a failed phase exits non-zero; the last line of a passing run
is one JSON object {"ok": true, "device": {...}}. Without a GPU the script
exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

N_FIT = 1 << 21  # points per fit sweep in phase 1
N_DRAGON = 437_645  # Stanford dragon, published point count
N_SHARDED = 10_485_760  # config 5
# Tolerances on max |kernel - reference| / max |reference| per output. Both
# sides are f32 throughout; they sum 2^21 points in different orders (the
# kernel per program block then across programs, XLA in its own reduction
# trees), so the expected difference grows like sqrt(N) * 2^-24 ~ 1e-4.
TOL = {"S": 1e-3, "loglik": 1e-4, "horn": 1e-3, "A": 1e-3, "b": 1e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# Phase 0
# ---------------------------------------------------------------------------

def phase_device(cache_dir: str) -> None:
    import jax

    from hgmm.utils.runtime import device_record, gpu_name_and_power_limit

    rec = device_record()
    log("== phase 0: device")
    log(f"platform={rec['platform']} kind={rec['kind']} count={rec['count']}")
    log(f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache_dir}")
    log(f"nvidia-smi name, power.limit: {gpu_name_and_power_limit()}")


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------

def _mixture(key, k):
    import jax
    import jax.numpy as jnp

    from hgmm.ops.gaussians import MixtureParams

    k1, k2, k3 = jax.random.split(key, 3)
    mu = jax.random.normal(k1, (k, 3))
    a = 0.3 * jax.random.normal(k2, (k, 3, 3))
    sigma = jnp.einsum("kij,klj->kil", a, a) + 0.05 * jnp.eye(3)
    return MixtureParams(jax.nn.softmax(jax.random.normal(k3, (k,))), mu, sigma)


def _rel_err(got, ref) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def kernel_cases():
    """(name, op, n, k, extra) for every shape phase 1 measures."""
    cases = [("em_stats", "em", N_FIT, k, {}) for k in (8, 64, 512)]
    cases += [("em_stats_masked", "masked", N_FIT, k, {"branch": 8})
              for k in (64, 512)]
    cases += [
        ("reg_stats", "reg", N_DRAGON, 512, {}),
        ("reg_stats top_k=8 outlier=0", "reg", N_DRAGON, 512,
         {"top_k": 8, "outlier_logit": 0.0}),
    ]
    return cases


def run_kernel_case(op, n, k, extra, seed, timing=True):
    """One kernel-vs-reference comparison through the public ops path.
    Returns a dict of errors (and, with timing, of kernel and XLA ms)."""
    import jax
    import jax.numpy as jnp

    from hgmm import ops
    from hgmm.models.se3 import random_pose
    from hgmm.ops import em_ref
    from hgmm.utils.timing import time_fn

    key = jax.random.fold_in(jax.random.PRNGKey(seed), 1000 * k + n % 997)
    kp, kx, kpar, kpose = jax.random.split(key, 4)
    params = _mixture(kp, k)
    pts = jax.random.normal(kx, (n, 3), jnp.float32)
    W = ops.pack_loglik_weights(params)
    prep = ops.prepare(pts)
    if ops._pallas_active():
        check(prep.feat is not None, "kernel path did not prepare a buffer")
    if op == "reg":
        A, b, _ = ops.precision_terms(params)
        A6 = ops.sym_pack(A)
        pose = random_pose(kpose)
        top_k, outlier = extra.get("top_k"), extra.get("outlier_logit")
        kern = jax.jit(lambda prep, W: ops.reg_stats(
            prep, W, params.mu, A6, b, (pose.R, pose.t), None, top_k, outlier))
        ref = jax.jit(lambda pts, W: em_ref.reg_stats(
            pts, W, params.mu, A6, b, (pose.R, pose.t), None, top_k, outlier))
        fields = ("horn", "A", "b", "loglik")
    elif op == "masked":
        branch = extra["branch"]
        parent = jax.random.randint(kpar, (n,), 0, k // branch)
        kern = jax.jit(lambda prep, W: ops.em_stats_masked(prep, W, parent, branch))
        ref = jax.jit(lambda pts, W: em_ref.em_stats_masked(pts, W, parent, branch))
        fields = ("S", "loglik")
    else:
        kern = jax.jit(lambda prep, W: ops.em_stats(prep, W))
        ref = jax.jit(lambda pts, W: em_ref.em_stats(pts, W))
        fields = ("S", "loglik")
    with jax.default_matmul_precision("highest"):
        want = jax.block_until_ready(ref(pts, W))
        got = jax.block_until_ready(kern(prep, W))
        out = {f: _rel_err(getattr(got, f), getattr(want, f)) for f in fields}
        if timing:
            _, t_k, _ = time_fn(kern, prep, W, warmup=1, iters=10)
            _, t_x, _ = time_fn(ref, pts, W, warmup=1, iters=5)
            out["kernel_ms"] = 1e3 * t_k
            out["xla_ms"] = 1e3 * t_x
    return out


def phase_kernels(seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from hgmm import ops

    log("== phase 1: kernels against em_ref (f32, highest)")
    check(ops._pallas_active(), "ops dispatch did not pick the Triton kernels")
    for name, op, n, k, extra in kernel_cases():
        t0 = time.perf_counter()
        res = run_kernel_case(op, n, k, extra, seed)
        errs = " ".join(
            f"{f} {res[f]:.2e} (tol {TOL[f]:.0e})" for f in TOL if f in res
        )
        log(
            f"{name} N={n} K={k}: {errs} | kernel {res['kernel_ms']:.3f} ms, "
            f"XLA {res['xla_ms']:.3f} ms, XLA/kernel "
            f"{res['xla_ms'] / res['kernel_ms']:.2f} "
            f"({time.perf_counter() - t0:.1f} s incl. compile)"
        )
        print(json.dumps({"case": name, "n": n, "k": k, **res}), flush=True)
        for f in TOL:
            if f in res:
                check(res[f] <= TOL[f], f"{name} K={k}: {f} error {res[f]:.3e}")

    # memory_analysis of one fit sweep (E-step + M-step) at N=2^21, K=512,
    # for the kernel path and for the dense twin.
    from hgmm.ops import em_ref

    params = _mixture(jax.random.PRNGKey(seed), 512)
    pts = jax.random.normal(jax.random.PRNGKey(seed + 1), (N_FIT, 3))
    prep = ops.prepare(pts)

    def sweep(stats_fn, x):
        W = ops.pack_loglik_weights(params)
        st = stats_fn(x, W)
        T0, T1, T2 = ops.unpack_suffstats(st.S)
        return ops.mstep_update(T0, T1, T2, jnp.float32(N_FIT))

    for label, fn, x in (("kernel", ops.em_stats, prep),
                         ("XLA em_ref", em_ref.em_stats, pts)):
        ma = jax.jit(lambda x, fn=fn: sweep(fn, x)).lower(x).compile()
        ma = ma.memory_analysis()
        log(
            f"fit sweep memory_analysis ({label}): "
            f"temp {ma.temp_size_in_bytes} B, args {ma.argument_size_in_bytes} B, "
            f"out {ma.output_size_in_bytes} B"
        )
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use after phase 1: {stats.get('peak_bytes_in_use')}")


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------

def phase_registration(seed: int, n: int = N_DRAGON) -> None:
    import jax

    from hgmm import register_pair
    from hgmm.configs.presets import PRESETS
    from hgmm.data.synthetic import make_cloud
    from hgmm.eval.metrics import registration_rmse, rotation_error_deg
    from hgmm.models.se3 import random_pose

    log(f"== phase 2: config2_tree_8x3 registration, {n} points")
    p = PRESETS["config2_tree_8x3"]
    cloud = make_cloud(jax.random.PRNGKey(seed), n, kind="trefoil")
    gt = random_pose(jax.random.PRNGKey(seed + 1), max_angle=0.2, max_trans=0.05)
    source = gt.inverse().apply(cloud)
    for run in ("cold (incl. compile)", "warm"):
        t0 = time.perf_counter()
        res = register_pair(
            source, target=cloud, model_kind=p.model_kind, k=p.k,
            branch=p.branch, levels=p.levels, fit_iters=p.fit_iters,
            complexity_threshold=p.complexity_threshold, n_iters=p.reg_iters,
            method=p.method, top_k=p.top_k, outlier_logit=p.outlier_logit,
            key=jax.random.PRNGKey(seed + 2),
        )
        jax.block_until_ready(res.pose)
        wall = time.perf_counter() - t0
        rmse = float(registration_rmse(res.pose, source, gt))
        rot = float(rotation_error_deg(res.pose, gt))
        log(f"{run}: fit + register {wall:.3f} s, RMSE {rmse:.3e} (bound 0.03), "
            f"rotation error {rot:.3e} deg (bound 2)")
        check(rmse < 0.03 and rot < 2.0, f"registration RMSE {rmse}, rot {rot}")


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------

# m, over 8 frames of a 0.45 m-step drive; runs so far reach ~0.12 m.
ATE_BOUND = 0.5


def phase_odometry(seed: int, scene_points: int = 220_000,
                   n_frames: int = 8) -> None:
    import numpy as np

    from hgmm.configs.presets import PRESETS
    from hgmm.data.synthetic import make_loop_sequence
    from hgmm.eval.metrics import ate
    from hgmm.pipelines.loop_closure import ClosureConfig
    from hgmm.pipelines.odometry import (
        OdometryConfig,
        refine_odometry,
        run_odometry,
    )

    frames, gt = make_loop_sequence(n_frames, scene_points, seed, loop_frames=64)
    raw = int(np.mean([f.shape[0] for f in frames]))
    log(f"== phase 3: odometry, {n_frames} frames, ~{raw} raw points/scan")
    p = PRESETS["config4_kitti_odometry"]
    cfg = OdometryConfig(
        model_kind=p.model_kind, branch=p.branch, levels=p.levels,
        fit_iters=p.fit_iters, reg_iters=p.reg_iters, method=p.method,
        outlier_logit=p.outlier_logit,
        complexity_threshold=p.complexity_threshold, bucket=16384,
    )
    t0 = time.perf_counter()
    res = run_odometry(frames, cfg, detect_closures=True,
                       closure_config=ClosureConfig())
    refined = refine_odometry(res, n_iters=10)
    ate_odo = float(ate(res.abs_poses, gt))
    ate_ref = float(ate(refined.poses(), gt))
    wall = time.perf_counter() - t0
    n_cl = 0 if res.closures is None else int(np.asarray(res.closures.i).shape[0])
    log(f"odometry + closures + refine {wall:.3f} s (incl. compile), "
        f"{n_cl} closures accepted, ATE {ate_odo:.4f} m -> refined "
        f"{ate_ref:.4f} m (bound {ATE_BOUND} m)")
    check(np.isfinite(ate_odo) and np.isfinite(ate_ref), "ATE not finite")
    check(ate_ref < ATE_BOUND, f"refined ATE {ate_ref} m")


# ---------------------------------------------------------------------------
# Sharded phase (--devices 4)
# ---------------------------------------------------------------------------

def _collective_ms(trace_dir: str) -> tuple[float, list]:
    """Device time of the collective operations in a jax.profiler trace:
    the summed durations of events whose names mark an all-reduce or an
    NCCL kernel, on the device planes."""
    import glob

    import jax

    total, names = 0.0, {}
    for path in glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True):
        pd = jax.profiler.ProfileData.from_file(path)
        for plane in pd.planes:
            if "gpu" not in plane.name.lower():
                continue
            for line in plane.lines:
                for ev in line.events:
                    nm = ev.name.lower()
                    if "nccl" in nm or "all-reduce" in nm or "allreduce" in nm:
                        total += ev.duration_ns
                        names[ev.name] = names.get(ev.name, 0.0) + ev.duration_ns
    top = sorted(names.items(), key=lambda kv: -kv[1])[:5]
    return total / 1e6, [(n, d / 1e6) for n, d in top]


def _chain_problem(m: int, seed: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hgmm.models.se3 import Pose, random_pose, so3_exp
    from hgmm.pipelines.pose_graph import EdgeList, odometry_chain_edges

    gt = [
        Pose(so3_exp(jnp.array([0.0, 0.0, 2 * np.pi * k / m])),
             jnp.array([np.cos(2 * np.pi * k / m), np.sin(2 * np.pi * k / m), 0.0]))
        for k in range(m)
    ]
    keys = jax.random.split(jax.random.PRNGKey(seed), m)
    rel = [gt[k].inverse().compose(gt[k + 1]).compose(
        random_pose(keys[k], 0.03, 0.03)) for k in range(m - 1)]
    init = [gt[0]]
    for z in rel:
        init.append(init[-1].compose(z))
    R0 = jnp.stack([p.R for p in init])
    t0 = jnp.stack([p.t for p in init])
    chain = odometry_chain_edges(rel)
    ci, cj = 3, m - 4
    lc = gt[ci].inverse().compose(gt[cj])
    closures = EdgeList(
        i=jnp.array([ci], jnp.int32), j=jnp.array([cj], jnp.int32),
        R=lc.R[None], t=lc.t[None], weight=jnp.array([5.0]),
    )
    return R0, t0, chain, closures


def phase_sharded(seed: int, n_devices: int, n: int = N_SHARDED) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hgmm import ops
    from hgmm.data.synthetic import make_cloud
    from hgmm.models.se3 import random_pose
    from hgmm.parallel import make_mesh, sharded_register_tree, sharded_tree_fit
    from hgmm.pipelines.pose_graph import (
        EdgeList,
        refine_chain_sharded,
        refine_pose_graph,
    )

    devs = jax.devices()
    check(len(devs) >= n_devices, f"need {n_devices} devices, have {len(devs)}")
    log(f"== sharded phase: {n} points, {n_devices}-device mesh vs 1-device mesh")
    mesh_n = make_mesh(devs[:n_devices])
    mesh_1 = make_mesh(devs[:1])
    cloud = make_cloud(jax.random.PRNGKey(seed), n, kind="trefoil")
    gt = random_pose(jax.random.PRNGKey(seed + 1), max_angle=0.2, max_trans=0.05)
    source = gt.inverse().apply(cloud)
    key = jax.random.PRNGKey(seed + 2)

    trees, poses = {}, {}
    for label, mesh in ((f"{n_devices}-device", mesh_n), ("1-device", mesh_1)):
        t0 = time.perf_counter()
        tree = sharded_tree_fit(cloud, mesh, branch=8, levels=3, em_iters=12,
                                key=key)
        jax.block_until_ready(tree.levels[-1].mu)
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        reg = sharded_register_tree(source, tree, mesh, n_iters=50,
                                    method="horn+wls")
        jax.block_until_ready(reg.pose.R)
        t_reg = time.perf_counter() - t0
        trees[label], poses[label] = tree, reg.pose
        log(f"{label}: tree fit {t_fit:.3f} s, tree registration {t_reg:.3f} s "
            "(both incl. compile)")

    # The fits: per-level mean log-likelihood of the whole cloud under each
    # tree (EM from one init; the psum order differs, so the trees agree to
    # f32 rounding amplified over 36 sweeps, not bitwise).
    a, b = trees[f"{n_devices}-device"], trees["1-device"]
    prep = ops.prepare(cloud)
    for li, (pa, pb) in enumerate(zip(a.levels, b.levels)):
        la = float(ops.em_stats(prep, ops.pack_loglik_weights(pa)).loglik) / n
        lb = float(ops.em_stats(prep, ops.pack_loglik_weights(pb)).loglik) / n
        log(f"level {li}: mean loglik {la:.6f} vs {lb:.6f}")
        check(abs(la - lb) <= 1e-3 * max(abs(lb), 1.0), f"level {li} loglik")
    # The registrations: each against ground truth, and against each other.
    from hgmm.eval.metrics import rotation_error_deg, translation_error

    for label, pose in poses.items():
        log(f"{label} registration vs ground truth: rotation "
            f"{float(rotation_error_deg(pose, gt)):.3e} deg, translation "
            f"{float(translation_error(pose, gt)):.3e}")
    pa, pb = poses[f"{n_devices}-device"], poses["1-device"]
    dR = float(np.max(np.abs(np.asarray(pa.R) - np.asarray(pb.R))))
    dt = float(np.max(np.abs(np.asarray(pa.t) - np.asarray(pb.t))))
    log(f"pose difference {n_devices}-device vs 1-device: R {dR:.2e}, t {dt:.2e} "
        "(tol 1e-3)")
    check(dR < 1e-3 and dt < 1e-3, "sharded registrations disagree")

    # Pose graph: distributed Schur solve against the dense solve.
    m = 16 * n_devices + 5
    R0, t0, chain, closures = _chain_problem(m, seed)
    dense = refine_pose_graph(
        R0, t0,
        EdgeList(*(jnp.concatenate([x, y]) for x, y in zip(chain, closures))),
        n_iters=8, damping=1e-8,
    )
    shard = refine_chain_sharded(R0, t0, chain.R, chain.t, mesh_n, n_iters=8,
                                 damping=1e-8, closures=closures)
    d_pg = float(max(np.max(np.abs(np.asarray(shard.t) - np.asarray(dense.t))),
                     np.max(np.abs(np.asarray(shard.R) - np.asarray(dense.R)))))
    log(f"refine_chain_sharded vs refine_pose_graph ({m} nodes, 1 closure): "
        f"max difference {d_pg:.2e} (tol 1e-3)")
    check(d_pg < 1e-3, "sharded pose graph disagrees with the dense solve")

    # Collectives' device time from one short trace of a sharded tree fit.
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as d:
        jax.profiler.start_trace(d)
        tree = sharded_tree_fit(cloud, mesh_n, branch=8, levels=3, em_iters=12,
                                key=key)
        jax.block_until_ready(tree.levels[-1].mu)
        jax.profiler.stop_trace()
        coll_ms, top = _collective_ms(d)
    log(f"traced sharded tree fit: collectives {coll_ms:.3f} ms device time; "
        f"top events {top}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded phase, over four GPUs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from hgmm.utils.runtime import (
        device_record,
        enable_compile_cache,
        require_gpu,
    )

    require_gpu()
    cache_dir = enable_compile_cache()
    phase_device(cache_dir)
    t0 = time.perf_counter()
    if args.devices == 4:
        phase_sharded(args.seed, 4)
    else:
        phase_kernels(args.seed)
        phase_registration(args.seed)
        phase_odometry(args.seed)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    rec = device_record()
    print(json.dumps({"ok": True, "device": rec}), flush=True)


if __name__ == "__main__":
    main()
