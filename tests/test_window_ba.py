import numpy as np
import jax.numpy as jnp
import pytest

from srba_slam_tpu.ops.window_ba import BAWindow, optimize_window
from srba_slam_tpu.utils import se3_np
from srba_slam_tpu.utils.camera import StereoCamera

CAM = StereoCamera.kitti()


def _make_window(rng, n_cams=4, n_lms=60, C=8, L=128, O=512,
                 pose_noise=0.02, lm_noise=0.05, px_noise=0.0):
    """Cameras on a line looking +z at a landmark cloud; each camera observes
    every landmark (if in front). Returns (window, gt_cam, gt_lm)."""
    gt_cam = np.zeros((n_cams, 6), np.float64)
    for i in range(1, n_cams):
        gt_cam[i] = gt_cam[i - 1] + np.array(
            [0.002 * rng.normal(), 0.002 * rng.normal(), 0.002 * rng.normal(),
             0.1 * rng.normal(), 0.05 * rng.normal(), 0.8]
        )
    lms_world = np.stack([
        rng.uniform(-8, 8, n_lms), rng.uniform(-2, 2, n_lms),
        rng.uniform(8, 30, n_lms) + 0.8 * (n_cams - 1),
    ], -1)
    lm_base = rng.integers(0, n_cams, n_lms)
    # landmark in base frame
    lm_pos = np.stack([
        se3_np.transform_point(se3_np.inverse(gt_cam[b]), p)
        for b, p in zip(lm_base, lms_world)
    ])
    obs_cam, obs_lm, obs_px = [], [], []
    for c in range(n_cams):
        for l in range(n_lms):
            pc = se3_np.transform_point(se3_np.inverse(gt_cam[c]), lms_world[l])
            if pc[2] < 1.0:
                continue
            ul = CAM.cx_l + CAM.fx_l * pc[0] / pc[2]
            vl = CAM.cy_l + CAM.fy_l * pc[1] / pc[2]
            ur = CAM.cx_r + CAM.fx_r * (pc[0] - CAM.baseline) / pc[2]
            obs_cam.append(c)
            obs_lm.append(l)
            obs_px.append([ul, vl, ur])
    obs_px = np.asarray(obs_px) + rng.normal(0, px_noise, (len(obs_px), 3))

    cam_pose = np.zeros((C, 6), np.float32)
    cam_pose[:n_cams] = gt_cam
    # perturb all but root
    cam_pose[1:n_cams] += rng.normal(0, pose_noise, (n_cams - 1, 6))
    lm_arr = np.zeros((L, 3), np.float32)
    lm_arr[:n_lms] = lm_pos + rng.normal(0, lm_noise, (n_lms, 3))
    lm_base_arr = np.zeros(L, np.int32)
    lm_base_arr[:n_lms] = lm_base
    oc = np.zeros(O, np.int32)
    ol = np.zeros(O, np.int32)
    op = np.zeros((O, 3), np.float32)
    ov = np.zeros(O, bool)
    n_o = len(obs_cam)
    oc[:n_o] = obs_cam
    ol[:n_o] = obs_lm
    op[:n_o] = obs_px
    ov[:n_o] = True
    win = BAWindow(
        cam_pose=jnp.asarray(cam_pose),
        cam_valid=jnp.asarray(np.arange(C) < n_cams),
        lm_pos=jnp.asarray(lm_arr),
        lm_base=jnp.asarray(lm_base_arr),
        lm_valid=jnp.asarray(np.arange(L) < n_lms),
        obs_cam=jnp.asarray(oc),
        obs_lm=jnp.asarray(ol),
        obs_px=jnp.asarray(op),
        obs_valid=jnp.asarray(ov),
    )
    return win, gt_cam, lm_pos


def test_ba_converges_to_ground_truth(rng):
    win, gt_cam, gt_lm = _make_window(rng)
    res = optimize_window(win, CAM, kernel_param=1.5, max_iters=15)
    assert float(res.cost_final) < float(res.cost_init) * 1e-3
    assert float(res.obs_rmse) < 0.05
    est = np.asarray(res.cam_pose)[: len(gt_cam)]
    np.testing.assert_allclose(est, gt_cam, atol=5e-3)


def test_ba_with_pixel_noise(rng):
    win, gt_cam, gt_lm = _make_window(rng, px_noise=0.5)
    res = optimize_window(win, CAM, max_iters=15)
    est = np.asarray(res.cam_pose)[: len(gt_cam)]
    # translations within a few cm despite 0.5px noise
    np.testing.assert_allclose(est[:, 3:], gt_cam[:, 3:], atol=0.05)
    assert float(res.obs_rmse) < 1.0


def test_ba_root_is_fixed(rng):
    win, gt_cam, _ = _make_window(rng)
    res = optimize_window(win, CAM, max_iters=8)
    np.testing.assert_array_equal(np.asarray(res.cam_pose)[0], np.asarray(win.cam_pose)[0])


def test_ba_robust_to_outlier_observations(rng):
    win, gt_cam, _ = _make_window(rng, px_noise=0.3)
    op = np.asarray(win.obs_px).copy()
    ov = np.asarray(win.obs_valid)
    n_o = int(ov.sum())
    bad = rng.choice(n_o, n_o // 10, replace=False)
    op[bad] += rng.uniform(40, 150, (len(bad), 3))
    win = win._replace(obs_px=jnp.asarray(op))
    res = optimize_window(win, CAM, kernel_param=1.5, max_iters=15)
    est = np.asarray(res.cam_pose)[: len(gt_cam)]
    np.testing.assert_allclose(est[:, 3:], gt_cam[:, 3:], atol=0.08)


def test_ba_ignores_padding(rng):
    win, gt_cam, _ = _make_window(rng)
    # poison padded entries; result must be unchanged
    op = np.asarray(win.obs_px).copy()
    ov = np.asarray(win.obs_valid)
    op[~ov] = 1e6
    lm = np.asarray(win.lm_pos).copy()
    lm[int(win.lm_valid.sum()):] = 1e6
    win2 = win._replace(obs_px=jnp.asarray(op), lm_pos=jnp.asarray(lm))
    r1 = optimize_window(win, CAM, max_iters=6)
    r2 = optimize_window(win2, CAM, max_iters=6)
    np.testing.assert_allclose(
        np.asarray(r1.cam_pose), np.asarray(r2.cam_pose), atol=1e-5
    )


# --------------------------------------------------------------------------
# init-anchor prior (SRBAParams.anchor_prior_w_rot/_trans — a documented
# deviation from the reference SRBA objective; see ops/window_ba.py) and the
# stage-1 pose-only pass (≙ use_robust_kernel_stage1, reference .cpp:1159)
# --------------------------------------------------------------------------

def _make_contaminated_window(n_true_cross=12, n_alias=8,
                              fold_t=(1.0, 0.0, 0.2),
                              fold_r=(0.0, 0.05, 0.0), seed=0):
    """Root (new KF, frozen) + one older camera that bases a landmark cloud.
    The root observes ``n_true_cross`` landmarks at TRUE geometry plus
    ``n_alias`` perceptually-aliased observations consistent with the older
    camera displaced by ``fold`` — the contaminated-consensus scenario that
    could fold the established map before the anchor prior landed."""
    rng = np.random.default_rng(seed)
    C, L, O = 8, 256, 512
    gt_cam1 = np.array([0.0, 0.0, 0.0, 0.15, -0.1, -1.5])
    n_lms = n_true_cross + n_alias + 40
    lm_pos1 = np.stack([
        rng.uniform(-6, 6, n_lms), rng.uniform(-1.5, 1.5, n_lms),
        rng.uniform(8, 25, n_lms)], -1)

    def project(pc):
        ul = CAM.cx_l + CAM.fx_l * pc[0] / pc[2]
        vl = CAM.cy_l + CAM.fy_l * pc[1] / pc[2]
        ur = CAM.cx_r + CAM.fx_r * (pc[0] - CAM.baseline) / pc[2]
        return [ul, vl, ur]

    obs_cam, obs_lm, obs_px = [], [], []
    for l in range(n_lms):  # camera-1 self observations (exact)
        obs_cam.append(1); obs_lm.append(l); obs_px.append(project(lm_pos1[l]))
    for l in range(n_true_cross):  # root's true cross observations
        pw = se3_np.transform_point(gt_cam1, lm_pos1[l])
        obs_cam.append(0); obs_lm.append(l); obs_px.append(project(pw))
    fold = np.concatenate([fold_r, fold_t])
    cam1_folded = se3_np.compose(gt_cam1, fold)
    for l in range(n_true_cross, n_true_cross + n_alias):  # aliased set
        pw = se3_np.transform_point(cam1_folded, lm_pos1[l])
        if pw[2] < 1.0:
            continue
        obs_cam.append(0); obs_lm.append(l); obs_px.append(project(pw))

    cam_pose = np.zeros((C, 6), np.float32)
    cam_pose[1] = gt_cam1
    lm_arr = np.zeros((L, 3), np.float32); lm_arr[:n_lms] = lm_pos1
    lm_base = np.zeros(L, np.int32); lm_base[:n_lms] = 1
    oc = np.zeros(O, np.int32); ol = np.zeros(O, np.int32)
    op = np.zeros((O, 3), np.float32); ov = np.zeros(O, bool)
    n_o = len(obs_cam)
    oc[:n_o] = obs_cam; ol[:n_o] = obs_lm; op[:n_o] = obs_px; ov[:n_o] = True
    win = BAWindow(
        cam_pose=jnp.asarray(cam_pose), cam_valid=jnp.asarray(np.arange(C) < 2),
        lm_pos=jnp.asarray(lm_arr), lm_base=jnp.asarray(lm_base),
        lm_valid=jnp.asarray(np.arange(L) < n_lms),
        obs_cam=jnp.asarray(oc), obs_lm=jnp.asarray(ol),
        obs_px=jnp.asarray(op), obs_valid=jnp.asarray(ov))
    return win, gt_cam1


def test_anchor_prior_blocks_contaminated_fold():
    """(a) with the prior at its defaults the older camera stays near its
    spanning-tree init despite the aliased consensus; (c) with the prior off
    (pre-anchor behavior) the weakly-determined system wanders meters."""
    win, gt1 = _make_contaminated_window()
    res_on = optimize_window(win, CAM, kernel_param=1.5, max_iters=25,
                             w_prior_rot=1000.0, w_prior_trans=100.0)
    res_off = optimize_window(win, CAM, kernel_param=1.5, max_iters=25,
                              w_prior_rot=0.0, w_prior_trans=0.0)
    d_on = np.linalg.norm(np.asarray(res_on.cam_pose)[1, 3:] - gt1[3:])
    d_off = np.linalg.norm(np.asarray(res_off.cam_pose)[1, 3:] - gt1[3:])
    assert d_on < 1.0, f"prior on: map folded {d_on:.2f} m"
    assert d_off > 2.0, f"prior off should reproduce the fold ({d_off:.2f} m)"


def test_anchor_prior_leaves_loop_closure_free():
    """(b) an information-rich drift correction (the loop-closure case: the
    window init already composes through the fresh closure edge, and ALL
    observations consistently demand the correction) must still happen —
    the prior may leave only a small residual bias."""
    rng = np.random.default_rng(3)
    win, gt_cam, _ = _make_window(rng, pose_noise=0.0, lm_noise=0.0)
    cp = np.asarray(win.cam_pose).copy()
    cp[3, 3] += 0.5
    cp[3, 5] += 0.3
    win = win._replace(cam_pose=jnp.asarray(cp))
    res = optimize_window(win, CAM, kernel_param=1.5, max_iters=25,
                          w_prior_rot=1000.0, w_prior_trans=100.0)
    err = np.linalg.norm(np.asarray(res.cam_pose)[3, 3:] - gt_cam[3, 3:])
    assert err < 0.03, f"prior blocked a 0.58 m information-rich correction ({err:.3f} m)"
    # prior off converges exactly (pre-anchor behavior preserved at w=0)
    res0 = optimize_window(win, CAM, kernel_param=1.5, max_iters=25,
                           w_prior_rot=0.0, w_prior_trans=0.0)
    err0 = np.linalg.norm(np.asarray(res0.cam_pose)[3, 3:] - gt_cam[3, 3:])
    assert err0 < 1e-3


def test_stage1_pose_only_refinement(rng):
    """stage-1 (pose-only, ≙ SRBA's new-edge optimization pass) reduces the
    observation RMSE before the full BA, and leaves landmarks untouched when
    run alone."""
    win, gt_cam, _ = _make_window(rng, pose_noise=0.05, lm_noise=0.0)
    # init rmse (no optimization at all): stage1_iters=0 reports the init
    base = optimize_window(win, CAM, max_iters=1, stage1_iters=0)
    rmse_init = float(base.obs_rmse_stg1)
    res = optimize_window(win, CAM, max_iters=15, stage1_iters=8)
    assert float(res.obs_rmse_stg1) < 0.5 * rmse_init
    # stage 2 minimizes robust cost + anchor prior, so the RAW rmse may
    # differ slightly from the pose-only stage-1 value; both must be small
    assert float(res.obs_rmse) < 0.1


def test_stage1_kernel_flag_changes_stage1(rng):
    """use_robust_kernel_stage1 must change the stage-1 behavior when the
    window carries outliers (≙ srba_use_robust_kernel_stage1 consumed, not
    just parsed)."""
    win, gt_cam, _ = _make_window(rng, pose_noise=0.05, lm_noise=0.0)
    op = np.asarray(win.obs_px).copy()
    ov = np.asarray(win.obs_valid)
    n_o = int(ov.sum())
    bad = rng.choice(n_o, n_o // 5, replace=False)
    op[bad] += 80.0
    win = win._replace(obs_px=jnp.asarray(op))
    r_kern = optimize_window(win, CAM, kernel_param=1.5, max_iters=1,
                             stage1_iters=8, use_kernel_stage1=True)
    r_nokern = optimize_window(win, CAM, kernel_param=1.5, max_iters=1,
                               stage1_iters=8, use_kernel_stage1=False)
    s1_kern = float(r_kern.obs_rmse_stg1)
    s1_nokern = float(r_nokern.obs_rmse_stg1)
    assert abs(s1_kern - s1_nokern) > 1e-3, "stage-1 kernel flag had no effect"


def test_mesh_sharded_window_matches_unsharded(rng):
    """Observation-sharded SPMD window BA (shard_window_obs + the same
    optimize_window program) must reproduce the single-device result: the
    assembly psums only reorder float sums."""
    import jax
    from jax.sharding import Mesh

    from srba_slam_tpu.ops.window_ba import shard_window_obs

    win, gt_cam, _ = _make_window(rng, px_noise=0.3)
    devs = np.array(jax.devices()[:8])
    assert len(devs) == 8, "conftest provides an 8-device CPU mesh"
    mesh = Mesh(devs, ("obs",))
    res_1 = optimize_window(win, CAM, kernel_param=1.5, max_iters=10)
    res_8 = optimize_window(shard_window_obs(win, mesh), CAM,
                            kernel_param=1.5, max_iters=10)
    np.testing.assert_allclose(np.asarray(res_8.cam_pose),
                               np.asarray(res_1.cam_pose), atol=5e-4)
    np.testing.assert_allclose(np.asarray(res_8.lm_pos),
                               np.asarray(res_1.lm_pos), atol=5e-3)
    assert abs(float(res_8.obs_rmse) - float(res_1.obs_rmse)) < 1e-2


def test_srba_engine_mesh_mode(rng):
    """SRBAEngine(mesh=...) runs its window solves observation-sharded and
    stays numerically consistent with the unsharded engine."""
    import jax
    from jax.sharding import Mesh

    from srba_slam_tpu.models.srba import SRBAEngine, SRBAParams
    from srba_slam_tpu.utils import se3_np

    mesh = Mesh(np.array(jax.devices()[:8]), ("obs",))

    def run(mesh_arg):
        eng = SRBAEngine(CAM, SRBAParams(
            submap_size=4, max_optimize_depth=3, max_kfs=16,
            win_cams=8, win_lms=1024, win_obs=2048, opt_iters=6),
            mesh=mesh_arg)
        rng2 = np.random.default_rng(5)
        lms_w = np.stack([rng2.uniform(-6, 6, 80), rng2.uniform(-2, 2, 80),
                          rng2.uniform(8, 25, 80)], -1)
        for kf in range(6):
            pose = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.8 * kf])
            inv = se3_np.inverse(pose)
            ids, px, rel = [], [], []
            for j, pw in enumerate(lms_w):
                pc = se3_np.transform_point(inv, pw)
                if pc[2] < 2.0:
                    continue
                ids.append(j)
                px.append([CAM.cx_l + CAM.fx_l * pc[0] / pc[2],
                           CAM.cy_l + CAM.fy_l * pc[1] / pc[2],
                           CAM.cx_r + CAM.fx_r * (pc[0] - CAM.baseline) / pc[2]])
                rel.append(pc)
            if kf:
                eng.set_initial_kf_pose(np.array([0, 0, 0, 0, 0, 0.8]))
            eng.define_new_keyframe(
                (np.asarray(ids, np.int64), np.asarray(px, np.float64),
                 np.asarray(rel, np.float64)), run_opt=kf > 0)
        eng.flush()
        return eng.kf_global[:6].copy()

    np.testing.assert_allclose(run(mesh), run(None), atol=1e-3)


def test_sharded_window_at_loop_closure_bucket(rng):
    """The observation-sharded window BA validated at the
    LOOP-CLOSURE bucket (C=32, L=8192, O=16384 — models/srba.py
    win_cams/win_lms/win_obs), where the psum assembly and the bf16
    split-matmul (_split_matmul) are most stressed. Sharded-vs-unsharded
    must agree to the same tolerances as the toy-scale test, and both
    must actually improve the perturbed window."""
    import time

    import jax
    from jax.sharding import Mesh

    from srba_slam_tpu.ops.window_ba import shard_window_obs
    from srba_slam_tpu.utils.synthworld import make_ba_window_problem

    C, L, O = 32, 8192, 16384
    win, gt_cam = make_ba_window_problem(
        CAM, np.random.default_rng(7),
        C=C, L=L, O=O, n_cams=30, n_lms=5000,
        pose_noise=0.03, lm_noise=0.05, px_noise=0.3)
    n_cams = 30
    devs = np.array(jax.devices()[:8])
    mesh = Mesh(devs, ("obs",))

    res_1 = optimize_window(win, CAM, kernel_param=1.5, max_iters=8)
    jax.block_until_ready(res_1.cam_pose)
    t0 = time.perf_counter()
    res_1 = optimize_window(win, CAM, kernel_param=1.5, max_iters=8)
    jax.block_until_ready(res_1.cam_pose)
    t_1 = time.perf_counter() - t0

    win_sh = shard_window_obs(win, mesh)
    res_8 = optimize_window(win_sh, CAM, kernel_param=1.5, max_iters=8)
    jax.block_until_ready(res_8.cam_pose)
    t0 = time.perf_counter()
    res_8 = optimize_window(win_sh, CAM, kernel_param=1.5, max_iters=8)
    jax.block_until_ready(res_8.cam_pose)
    t_8 = time.perf_counter() - t0

    # the solve genuinely improved the window
    assert float(res_1.cost_final) < 0.5 * float(res_1.cost_init)
    err = np.linalg.norm(
        np.asarray(res_1.cam_pose)[:n_cams, 3:] - gt_cam[:n_cams, 3:],
        axis=1)
    assert err.max() < 0.05, err.max()
    # sharded == unsharded at the big bucket (psums only reorder sums)
    np.testing.assert_allclose(np.asarray(res_8.cam_pose)[:n_cams],
                               np.asarray(res_1.cam_pose)[:n_cams],
                               atol=5e-4)
    assert abs(float(res_8.obs_rmse) - float(res_1.obs_rmse)) < 1e-2
    print(f"LC-bucket window solve (C={C},L={L},O={O}, 8 LM iters): "
          f"1-dev {t_1*1e3:.0f} ms, 8-dev sharded {t_8*1e3:.0f} ms "
          "(virtual CPU mesh — wall times indicative only)")


def _pack_win(win):
    from srba_slam_tpu.ops.window_ba import pack_window

    return pack_window(
        np.asarray(win.cam_pose), np.asarray(win.cam_valid),
        np.asarray(win.lm_pos), np.asarray(win.lm_base),
        np.asarray(win.lm_valid), np.asarray(win.obs_cam),
        np.asarray(win.obs_lm), np.asarray(win.obs_px),
        np.asarray(win.obs_valid))


def test_batched_group_solve_matches_per_window(rng, monkeypatch):
    """The WINDOW_SLOTS group program's VMAP path (forced via
    _VMAP_LO_LIMIT; default is the serial scan) returns the same blobs as
    per-window dispatches; padded slots read zero."""
    import srba_slam_tpu.ops.window_ba as wba
    from srba_slam_tpu.ops.window_ba import (
        WINDOW_SLOTS, optimize_window_packed_blob,
        optimize_windows_batch_blob,
    )

    monkeypatch.setattr(wba, "_VMAP_LO_LIMIT", 10 ** 12)

    C, L, O = 8, 128, 512
    kw = dict(kernel_param=1.5, max_iters=10, stage1_iters=2)
    wins = [_make_window(rng, n_cams=3 + i, n_lms=40 + 7 * i, C=C, L=L, O=O,
                         px_noise=0.3)[0] for i in range(3)]
    packed = [_pack_win(w) for w in wins]
    pad = WINDOW_SLOTS - len(packed)
    # pad with a COPY of the first window (the dispatch-side contract)
    ints = np.stack([p[0] for p in packed] + [packed[0][0]] * pad)
    floats = np.stack([p[1] for p in packed] + [packed[0][1]] * pad)
    valids = np.arange(WINDOW_SLOTS) < len(packed)
    blobs = np.asarray(optimize_windows_batch_blob(
        jnp.asarray(ints), jnp.asarray(floats), jnp.asarray(valids),
        C, L, O, CAM, **kw))
    assert blobs.shape == (WINDOW_SLOTS, C * 6 + L * 3 + 4)
    for i, (pi, pf) in enumerate(packed):
        solo = np.asarray(optimize_window_packed_blob(
            jnp.asarray(pi), jnp.asarray(pf), C, L, O, CAM, **kw))
        # same math batched vs solo: lock-step masked LM must not change
        # any accepted step (tolerances absorb batched-op reassociation)
        np.testing.assert_allclose(blobs[i], solo, rtol=1e-4, atol=1e-4)
    assert not blobs[len(packed):].any()


def test_batched_group_solve_scan_path(rng):
    """The default serial-scan path agrees with the per-window program and
    skips invalid slots (lax.cond)."""
    import srba_slam_tpu.ops.window_ba as wba

    # fresh static shapes so the jit cache can't serve the vmapped trace
    C, L, O = 8, 136, 520
    kw = dict(kernel_param=1.5, max_iters=8)
    win = _make_window(rng, n_cams=4, n_lms=50, C=C, L=L, O=O)[0]
    pi, pf = _pack_win(win)
    ints = np.stack([pi] * wba.WINDOW_SLOTS)
    floats = np.stack([pf] * wba.WINDOW_SLOTS)
    valids = np.zeros(wba.WINDOW_SLOTS, bool)
    valids[0] = True
    blobs = np.asarray(wba.optimize_windows_batch_blob(
        jnp.asarray(ints), jnp.asarray(floats), jnp.asarray(valids),
        C, L, O, CAM, **kw))
    solo = np.asarray(wba.optimize_window_packed_blob(
        jnp.asarray(pi), jnp.asarray(pf), C, L, O, CAM, **kw))
    np.testing.assert_allclose(blobs[0], solo, rtol=1e-5, atol=1e-5)
    assert not blobs[1:].any()


@pytest.mark.parametrize("C,L,O,n_cams,n_lms", [
    (8, 128, 512, 4, 60), (16, 256, 1024, 6, 120)])
def test_assembly_paths_agree(rng, monkeypatch, C, L, O, n_cams, n_lms):
    """The one-hot Hessian assembly (the accelerator default) and the
    scatter-add assembly (the CPU default) solve the same window to 1e-4."""
    import srba_slam_tpu.ops.window_ba as wba

    win = _make_window(rng, n_cams=n_cams, n_lms=n_lms, C=C, L=L, O=O,
                       px_noise=0.3)[0]
    res = {}
    try:
        for path in ("onehot", "scatter"):
            monkeypatch.setattr(wba, "ASSEMBLY", path)
            wba.optimize_window.clear_cache()
            res[path] = optimize_window(win, CAM, kernel_param=1.5,
                                        max_iters=10, stage1_iters=2)
    finally:
        wba.optimize_window.clear_cache()
    for r in res.values():
        assert float(r.cost_final) < 0.1 * float(r.cost_init)
    a, b = res["onehot"], res["scatter"]
    np.testing.assert_allclose(np.asarray(a.cam_pose), np.asarray(b.cam_pose),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.lm_pos), np.asarray(b.lm_pos),
                               rtol=1e-4, atol=1e-4)


def test_split_matmul_keeps_sixteen_bits(rng):
    """The one-hot path's split-bf16 contraction keeps ~16 mantissa bits
    (a plain bf16 matmul keeps 8: relative error ~2e-3)."""
    from srba_slam_tpu.ops.window_ba import _split_matmul

    oh = (rng.random((64, 512)) < 0.05).astype(np.float32)
    data = rng.normal(size=(512, 40)).astype(np.float32) * 1e3
    got = np.asarray(_split_matmul(jnp.asarray(oh, jnp.bfloat16),
                                   jnp.asarray(data)))
    ref = oh.astype(np.float64) @ data.astype(np.float64)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-4
