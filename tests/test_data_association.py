import numpy as np
import jax
import jax.numpy as jnp

from srba_slam_tpu.models.data_association import (
    S_TRACKED, S_REJ_ORB, da_cascade,
)
from srba_slam_tpu.models.keyframe import KeyframeStore
from srba_slam_tpu.models.vo import FrameFeatures
from srba_slam_tpu.ops import bits as bitops
from srba_slam_tpu.utils import se3_np
from srba_slam_tpu.utils.camera import StereoCamera

CAM = StereoCamera.kitti()
K = 128


def _flip(rng, desc, k):
    b = np.asarray(bitops.unpack_bits(desc)).copy()
    for i in range(b.shape[0]):
        idx = rng.choice(256, size=k, replace=False)
        b[i, idx] ^= 1
    return bitops.pack_bits(jnp.asarray(b))


def _make_kf(rng, pose_wc, pts_w, desc):
    """Synthesize a FrameFeatures for a camera at pose observing pts_w."""
    pc = np.stack([se3_np.transform_point(se3_np.inverse(pose_wc), p) for p in pts_w])
    ul = CAM.cx_l + CAM.fx_l * pc[:, 0] / pc[:, 2]
    vl = CAM.cy_l + CAM.fy_l * pc[:, 1] / pc[:, 2]
    ur = CAM.cx_r + CAM.fx_r * (pc[:, 0] - CAM.baseline) / pc[:, 2]
    n = len(pts_w)
    valid = np.zeros(K, bool); valid[:n] = True
    pad = lambda a, fill=0: np.concatenate([a, np.full((K - n, *a.shape[1:]), fill, a.dtype)])
    return FrameFeatures(
        ys_l=jnp.asarray(pad(np.round(vl).astype(np.int32))),
        xs_l=jnp.asarray(pad(np.round(ul).astype(np.int32))),
        score_l=jnp.asarray(pad(np.ones(n, np.float32))),
        valid_l=jnp.asarray(valid),
        desc_l=desc,
        ys_r=jnp.asarray(pad(np.round(vl).astype(np.int32))),
        xs_r=jnp.asarray(pad(np.round(ur).astype(np.int32))),
        valid_r=jnp.asarray(valid),
        desc_r=desc,
        m_r_idx=jnp.asarray(np.arange(K, dtype=np.int32)),
        m_valid=jnp.asarray(valid),
        pts3d=jnp.asarray(pad(pc.astype(np.float32))),
        octave=jnp.zeros(K, jnp.int32),
    )


def _setup(rng, n=100):
    pts = np.stack([
        rng.uniform(-10, 10, n), rng.uniform(-2, 2, n), rng.uniform(8, 35, n)
    ], -1)
    desc0 = jnp.asarray(rng.integers(0, 2**32, (K, 8), dtype=np.uint64).astype(np.uint32))
    kf0 = _make_kf(rng, np.zeros(6), pts, desc0)
    pose1 = np.array([0.01, 0.03, 0.0, 0.3, 0.0, 1.2])
    kf1 = _make_kf(rng, pose1, pts, _flip(rng, desc0, 6))
    return kf0, kf1, pose1, pts


def _store_with(kfs):
    store = KeyframeStore(max_kfs=4, capacity=K)
    for f in kfs:
        store.append(f, np.full(K, -1, np.int64), np.zeros(6, np.float32))
    return store


def test_cascade_tracks_and_recovers_pose(rng):
    kf0, kf1, pose1, _ = _setup(rng)
    store = _store_with([kf0])
    res = da_cascade(kf1, store.arrays, jnp.asarray([0]), jnp.asarray([True]),
                     CAM, jax.random.PRNGKey(0))
    assert int(res.tracked_count[0]) > 80
    assert bool(res.pose_valid[0])
    # pose maps KF0-frame points into KF1 frame: expected inverse(pose1)
    exp = se3_np.inverse(pose1)
    np.testing.assert_allclose(np.asarray(res.pose[0]), exp, atol=5e-3)


def test_cascade_rejects_unrelated_kf(rng):
    kf0, kf1, _, pts = _setup(rng)
    # unrelated KF: different descriptors, different geometry
    desc2 = jnp.asarray(rng.integers(0, 2**32, (K, 8), dtype=np.uint64).astype(np.uint32))
    kf2 = _make_kf(rng, np.array([0, 0, 0, 5.0, 0, -3.0]),
                   pts[::-1] + rng.normal(0, 3, pts.shape), desc2)
    store = _store_with([kf2])
    res = da_cascade(kf1, store.arrays, jnp.asarray([0]), jnp.asarray([True]),
                     CAM, jax.random.PRNGKey(0))
    assert int(res.tracked_count[0]) < 15


def test_cascade_batched_over_candidates(rng):
    kf0, kf1, pose1, pts = _setup(rng)
    desc2 = jnp.asarray(rng.integers(0, 2**32, (K, 8), dtype=np.uint64).astype(np.uint32))
    kf_unrel = _make_kf(rng, np.zeros(6), pts + rng.normal(0, 4, pts.shape), desc2)
    store = _store_with([kf0, kf_unrel])
    valid = jnp.asarray([True, True, False])  # third candidate masked off
    res = da_cascade(kf1, store.arrays, jnp.asarray([0, 1, 0]), valid,
                     CAM, jax.random.PRNGKey(1))
    t = np.asarray(res.tracked_count)
    assert t[0] > 80          # true predecessor
    assert t[1] < 15          # unrelated
    assert t[2] == 0          # masked
    assert not bool(res.pose_valid[2])


def test_orb_distance_filter_status(rng):
    kf0, kf1, _, _ = _setup(rng)
    # corrupt half of kf1's descriptors heavily -> S_REJ_ORB for those
    d = _flip(rng, kf1.desc_l, 120)
    half = jnp.arange(K) < 50
    kf1b = kf1._replace(desc_l=jnp.where(half[:, None], d, kf1.desc_l))
    store = _store_with([kf0])
    # direction filter off so the heavily-corrupted half reaches the ORB
    # distance filter (with it on, their random matches fail the slope test
    # first — correct cascade ordering)
    res = da_cascade(kf1b, store.arrays, jnp.asarray([0]), jnp.asarray([True]),
                     CAM, jax.random.PRNGKey(0), filter_by_direction=False)
    status = np.asarray(res.status[0])
    assert (status[:50] == S_REJ_ORB).sum() > 30
    assert (status[50:100] == S_TRACKED).sum() > 35


def test_change_pose_seeding_recovers_large_viewpoint_lc(rng):
    """Filter-4 pose seeding (≙ the role of initialPoseVector, reference
    .cpp:1840-1868 + :2133-2147): under a large viewpoint change the
    zero-initialized change-in-pose solve converges to the wrong basin and
    rejects everything. The cascade seeds itself with an on-device Horn
    3D-3D alignment over the surviving correspondences, so the loop closure
    is recovered with NO host graph state at all."""
    from srba_slam_tpu.models.data_association import _horn_seed

    n = 100
    pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(-2, 2, n),
                    rng.uniform(8, 35, n)], -1)
    desc = jnp.asarray(
        rng.integers(0, 2**32, (K, 8), dtype=np.uint64).astype(np.uint32))
    a = np.deg2rad(70.0)  # 70-degree viewpoint change around Y
    pose_oth = np.array([0.0, a, 0.0, 12 * np.sin(a), 0.0,
                         12 * (1 - np.cos(a))])
    kf_oth = _make_kf(rng, pose_oth, pts, desc)
    kf_cur = _make_kf(rng, np.zeros(6), pts, desc)
    store = _store_with([kf_oth])

    # the raw solve from a zero start lands in the wrong basin: the Horn
    # seed is what recovers it (checked on the full cascade below)
    from srba_slam_tpu.ops.robust_lm import solve_pose

    ur = kf_cur.xs_r[kf_cur.m_r_idx].astype(jnp.float32)
    obs = jnp.stack([kf_cur.xs_l.astype(jnp.float32),
                     kf_cur.ys_l.astype(jnp.float32), ur], -1)
    oth_pts = store.arrays.pts3d[0]
    zero_sol = solve_pose(oth_pts, obs, kf_cur.m_valid, CAM,
                          initial_pose=jnp.zeros(6, jnp.float32),
                          residual_threshold=5.0, min_inliers=15)
    assert not bool(zero_sol.valid)

    # full cascade with NO explicit seed: the built-in Horn seed recovers it
    auto = da_cascade(kf_cur, store.arrays, jnp.asarray([0]),
                      jnp.asarray([True]), CAM, jax.random.PRNGKey(0),
                      use_fund_matrix=False, residual_th=5.0)
    assert int(auto.tracked_count[0]) > 50 and bool(auto.pose_valid[0])
    np.testing.assert_allclose(np.asarray(auto.pose[0]), pose_oth, atol=0.02)

    # thin geometry falls back to the caller-provided seed
    w_thin = jnp.zeros(K, bool).at[:4].set(True)
    fb = jnp.asarray([1.0, 2, 3, 4, 5, 6], jnp.float32)
    np.testing.assert_allclose(
        np.asarray(_horn_seed(oth_pts, kf_cur.pts3d, w_thin, fb)),
        np.asarray(fb))


def test_direction_filter_helps_on_pan_motion(rng):
    """Filter 1 (direction histogram, ≙ .cpp:1883-1946): under pan-dominant
    motion the true matches share one displacement direction; decoy features
    whose descriptors collide with far-away features produce random
    directions and must fall to S_REJ_SLOPE while the uniform set survives."""
    from srba_slam_tpu.models.data_association import S_REJ_SLOPE

    n = 90
    pts = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n),
                    rng.uniform(10, 30, n)], -1)
    desc = jnp.asarray(
        rng.integers(0, 2**32, (K, 8), dtype=np.uint64).astype(np.uint32))
    kf_other = _make_kf(rng, np.zeros(6), pts, desc)
    # pan (yaw) motion: nearly uniform horizontal pixel displacement
    pan = np.array([0.0, np.deg2rad(3.0), 0.0, 0.0, 0.0, 0.0])
    kf_cur = _make_kf(rng, pan, pts, desc)
    # corrupt 25 current descriptors to duplicate OTHER features' descriptors
    # (descriptor collisions -> geometrically wrong matches, random direction)
    d = np.asarray(kf_cur.desc_l).copy()
    victims = np.arange(25)
    d[victims] = np.asarray(desc)[(victims + 40) % n]
    kf_cur = kf_cur._replace(desc_l=jnp.asarray(d))
    store = _store_with([kf_other])

    on = da_cascade(kf_cur, store.arrays, jnp.asarray([0]), jnp.asarray([True]),
                    CAM, jax.random.PRNGKey(0), filter_by_direction=True,
                    use_fund_matrix=False, use_change_pose=False)
    off = da_cascade(kf_cur, store.arrays, jnp.asarray([0]), jnp.asarray([True]),
                     CAM, jax.random.PRNGKey(0), filter_by_direction=False,
                     use_fund_matrix=False, use_change_pose=False)
    st_on = np.asarray(on.status[0])
    st_off = np.asarray(off.status[0])
    # wrong-direction decoys rejected by the slope filter
    assert (st_on[victims] == S_REJ_SLOPE).sum() > 15, st_on[victims]
    # uniform-direction true matches survive
    assert int(on.tracked_count[0]) > 50
    # without the filter the decoys' zero-distance collisions survive as
    # (geometrically wrong) tracked matches
    assert (st_off[victims] == S_TRACKED).sum() > 15, st_off[victims]


def test_fused_checks_batch_chains_and_pads(rng):
    """fused_checks_batch must equal sequential fused_check_write calls
    bit-exactly (the scan carry reproduces the per-check speculative-write
    chaining) and its padded slots must leave the store/DB untouched."""
    from srba_slam_tpu.models.data_association import (
        CHECK_SLOTS, fused_check_write, fused_checks_batch,
    )
    from srba_slam_tpu.models.keyframe import KFArrays

    kf0, kf1, _pose1, pts = _setup(rng)
    feats = jax.tree.map(lambda a, b: jnp.stack([a, b]), kf0, kf1)

    max_kfs = 8
    w_pad = 512
    leaf_bits = jnp.asarray(
        rng.integers(0, 2, (w_pad, 256)).astype(np.float32))
    weights = jnp.asarray(rng.uniform(0.1, 1.0, w_pad).astype(np.float32))

    row_fields = (kf0.ys_l, kf0.xs_l, kf0.valid_l, kf0.desc_l, kf0.ys_r,
                  kf0.xs_r, kf0.valid_r, kf0.desc_r, kf0.m_r_idx,
                  kf0.m_valid, kf0.pts3d, kf0.octave)

    def fresh_state():
        arrays = KFArrays(*(jnp.zeros((max_kfs,) + tuple(a.shape), a.dtype)
                            for a in row_fields))
        db = jnp.zeros((max_kfs, w_pad), jnp.float32)
        return arrays, db

    s0, s1 = 100, 101  # plain-int DA seeds, as production passes

    # sequential reference: check kf0 at row 1, then kf1 at row 2 (the
    # second check must see the first's speculative row through the chain)
    arrays, db = fresh_state()
    (b0,), arrays, db = fused_check_write(
        feats, arrays, db, leaf_bits, weights, jnp.int32(0), jnp.int32(1),
        CAM, s0)
    (b1,), arrays_ref, db_ref = fused_check_write(
        feats, arrays, db, leaf_bits, weights, jnp.int32(1), jnp.int32(2),
        CAM, s1)

    # fused: same two checks + padded slots in ONE dispatch
    arrays, db = fresh_state()
    pad = CHECK_SLOTS - 2
    js = (0, 1) + (0,) * pad          # python scalars, as production passes
    rows = (1, 2) + (0,) * pad
    valids = (True, True) + (False,) * pad
    seeds = (s0, s1) + (s1,) * pad
    blobs, arrays_f, db_f = fused_checks_batch(
        feats, arrays, db, leaf_bits, weights, js, rows, valids, CAM, seeds)

    np.testing.assert_array_equal(np.asarray(b0), np.asarray(blobs[0]))
    np.testing.assert_array_equal(np.asarray(b1), np.asarray(blobs[1]))
    np.testing.assert_array_equal(np.asarray(db_ref), np.asarray(db_f))
    for a_ref, a_f in zip(arrays_ref, arrays_f):
        np.testing.assert_array_equal(np.asarray(a_ref), np.asarray(a_f))
    # padded slots wrote nothing anywhere: rows 0 and 3+ are still zero
    for a in arrays_f:
        np.testing.assert_array_equal(np.asarray(a[0]),
                                      np.zeros_like(np.asarray(a[0])))
        np.testing.assert_array_equal(np.asarray(a[3:]),
                                      np.zeros_like(np.asarray(a[3:])))
    np.testing.assert_array_equal(np.asarray(db_f[3:]),
                                  np.zeros((max_kfs - 3, w_pad), np.float32))


def test_horn_seed_matches_float64_kabsch(rng):
    """The DA cascade's Horn 3D-3D seed (full-precision f32 products) agrees
    with a float64 numpy Kabsch fit over the same masked correspondences."""
    from srba_slam_tpu.models.data_association import _horn_seed

    n = 300
    p_oth = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n),
                      rng.uniform(4, 40, n)], -1)
    pose = np.array([0.03, -0.12, 0.02, 0.7, -0.1, 2.5])
    R_true, t_true = se3_np.exp(pose)
    p_cur = p_oth @ R_true.T + t_true + rng.normal(0, 0.01, (n, 3))
    w0 = rng.random(n) < 0.8

    seed = np.asarray(_horn_seed(
        jnp.asarray(p_oth, jnp.float32), jnp.asarray(p_cur, jnp.float32),
        jnp.asarray(w0), jnp.zeros(6, jnp.float32)))

    a, b = p_oth[w0], p_cur[w0]
    ca, cb = a.mean(0), b.mean(0)
    U, _s, Vt = np.linalg.svd((a - ca).T @ (b - cb))
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    ref = se3_np.log(R, cb - R @ ca)
    np.testing.assert_allclose(seed[:3], ref[:3], atol=2e-5)
    np.testing.assert_allclose(seed[3:], ref[3:], atol=5e-4)
    np.testing.assert_allclose(ref, pose, atol=1e-2)
