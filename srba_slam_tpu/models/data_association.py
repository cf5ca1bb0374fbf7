"""Inter-keyframe data association: the 4-filter cascade, batched.

≙ ``m_data_association`` / ``m_internal_data_association``
(reference src/CSRBAStereoSLAMEstimator.cpp:1341-1411, 1413-1727). The
reference loops over similar keyframes one at a time; here the whole cascade
runs for ALL candidate keyframes simultaneously (vmap over the stacked
keyframe rows):

1. brute-force Hamming matching of left descriptors (bf16 matmul —
   ≙ cv::BFMatcher(NORM_HAMMING), .cpp:1447-1452);
2. filter 1 (optional): direction histogram — 36 x 10° bins over the match
   displacement angles, keep the mode bin ±1 (.cpp:1883-1946);
3. filter 2: ORB distance ≤ max_orb_distance_da with 1-to-1 uniqueness,
   best-distance-wins (.cpp:1951-2010);
4. filter 3: fundamental-matrix RANSAC over the left pixels — applied only
   when ≥ 15 matches remain (.cpp:2015-2055);
5. filter 4: change-in-pose — robust GN solve of the candidate-KF → current
   pose from the candidate's 3D points; matches with residual >
   residual_th rejected, everything rejected if the solve is invalid
   (.cpp:2113-2177).

Per-match statuses use the reference's enum values so debug dumps are
directly comparable.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from srba_slam_tpu.models.keyframe import KFArrays
from srba_slam_tpu.models.vo import FrameFeatures
from srba_slam_tpu.ops.hamming import hamming_matrix
from srba_slam_tpu.ops.ransac import ransac_fundamental
from srba_slam_tpu.ops.robust_lm import solve_pose
from srba_slam_tpu.utils.camera import StereoCamera

# ≙ the status enum at reference src/CSRBAStereoSLAMEstimator.h:102
# (sTRACKED = 0, sNON_TRACKED, sREJ_SLOPE, ...) — same values, so debug
# dumps are directly comparable
S_TRACKED = 0
S_NON_TRACKED = 1
S_REJ_SLOPE = 2
S_REJ_ORB = 3
S_REJ_FUND_MATRIX = 4
S_REJ_CHANGE_POSE = 5
S_REJ_CONSISTENCY = 6

_BIG = 1e9  # python float: a module-level jnp constant captured by jitted
# code becomes a per-call transferred parameter
_HI = jax.lax.Precision.HIGHEST  # full f32 (no TF32 / bf16 passes)

# Iteration budget of the filter-4 change-in-pose GN solve. The VO engine
# runs the reference LS schedule (30/30, demo ini LEAST_SQUARES); the DA
# cascade seeds its solve with a robust Horn 3D-3D alignment (_horn_seed,
# which the reference does not have), so GN starts near the basin and a
# smaller budget reaches the same inlier classification — the lock-step
# vmapped while_loop over the 5 candidates is gated by its SLOWEST lane,
# so the cap is real device time (~4.8 ms of a ~6.5 ms check at 30/30).
# Decision equivalence vs 30/30 is asserted by tests on the street
# workload and the DA unit suite.
DA_SOLVE_ITERS_STAGE1 = 12
DA_SOLVE_ITERS_STAGE2 = 12


class DAResult(NamedTuple):
    """Per-candidate-KF association results (S candidates, K features)."""

    status: jax.Array         # int8 [S, K] per current-KF feature
    other_idx: jax.Array      # int32 [S, K] matched feature in candidate KF
    tracked_count: jax.Array  # int32 [S]
    pose: jax.Array           # f32 [S, 6] candidate-KF -> current-KF transform
    pose_valid: jax.Array     # bool [S]
    mean_residual: jax.Array  # f32 [S]
    # debug-artifact inputs (intermediates the cascade computes anyway;
    # they cross the link only when the check blob is packed with debug=True)
    raw_oidx: jax.Array       # int32 [S, K] PRE-filter Hamming argmin
    distance: jax.Array       # f32 [S, K] raw match distance (_BIG if none)
    residuals: jax.Array      # f32 [S, K] filter-4 change-in-pose residuals


def _horn_seed(p_oth: jax.Array, p_cur: jax.Array, w0: jax.Array,
               fallback: jax.Array, min_pts: int = 8):
    """Robust 3D-3D alignment seed for the change-in-pose solve.

    Fits R p_oth + t ≈ p_cur (Kabsch over the masked correspondences, one
    median-residual trim pass) and returns the SE(3) seed, or ``fallback``
    when the geometry is too thin. This plays the role of the reference's
    rough spanning-tree relative poses fed to getChangeInPose as
    ``initialPoseVector`` (reference src/CSRBAStereoSLAMEstimator.cpp:
    1840-1868, :2133-2147) — but is derived on device from the same
    correspondences the solve uses, so it needs no host graph state, lands
    in the right basin even under large viewpoint change, and is identical
    in per-frame and batched modes.
    """
    from srba_slam_tpu.utils import se3

    finite = jnp.isfinite(p_oth).all(-1) & jnp.isfinite(p_cur).all(-1)
    no = jnp.linalg.norm(p_oth, axis=-1)
    nc = jnp.linalg.norm(p_cur, axis=-1)
    # magnitude gates only (no positivity assumption on either frame);
    # zeroed/degenerate triangulations and far outliers drop out, the
    # median-trim pass below handles the rest
    near = (no > 1e-6) & (nc > 1e-6) & (no < 1e4) & (nc < 1e4)
    base = w0 & finite & near

    def fit(w):
        wf = w.astype(jnp.float32)
        n = jnp.sum(wf)
        nz = jnp.maximum(n, 1.0)
        co = jnp.sum(p_oth * wf[:, None], axis=0) / nz
        cp = jnp.sum(p_cur * wf[:, None], axis=0) / nz
        H = jnp.matmul(((p_oth - co) * wf[:, None]).T, p_cur - cp,
                       precision=_HI)
        U, _S, Vt = jnp.linalg.svd(H)
        d = jnp.linalg.det(jnp.matmul(Vt.T, U.T, precision=_HI))
        R = jnp.matmul(Vt.T * jnp.stack([1.0, 1.0, d]), U.T, precision=_HI)
        t = cp - jnp.matmul(R, co, precision=_HI)
        return R, t, n

    R, t, n = fit(base)
    res = jnp.linalg.norm(
        jnp.matmul(p_oth, R.T, precision=_HI) + t - p_cur, axis=-1)
    # masked median residual (sorted with invalid pushed to +inf)
    res_sorted = jnp.sort(jnp.where(base, res, jnp.inf))
    med = res_sorted[jnp.clip((n.astype(jnp.int32) - 1) // 2, 0,
                              res.shape[0] - 1)]
    keep2 = base & (res <= jnp.maximum(3.0 * med, 0.5))
    R, t, n2 = fit(keep2)
    pose = se3.log(R, t)
    ok = (n2 >= min_pts) & jnp.isfinite(pose).all()
    return jnp.where(ok, pose, fallback)


def _direction_filter(keep, cur_y, cur_x, oth_y, oth_x, oidx, img_h):
    """Mode-bin direction histogram (36 bins of 10 degrees), mode ±1 kept.

    EXACT reference binning (m_detect_outliers_with_direction, reference
    .cpp:1883-1946 called with offset = image height at .cpp:1486): the
    angle is ``atan((oy + H - ty)/(ox - tx))`` — the slope of the line
    joining the match across VERTICALLY STACKED images, not the raw
    displacement direction. The H offset dominates the numerator, which
    makes the filter a gentle horizontal-consistency gate that tolerates
    zoom/forward motion (raw atan2 binning — the round-2 implementation —
    radiates around the FOE and wrongly kills most of a forward-motion
    match set)."""
    dy = oth_y[oidx].astype(jnp.float32) + img_h - cur_y.astype(jnp.float32)
    dx = oth_x[oidx].astype(jnp.float32) - cur_x.astype(jnp.float32)
    # (90, 270) degrees; dx=0 -> atan(+/-inf) -> +/-90
    ang = jnp.degrees(jnp.arctan(dy / jnp.where(dx == 0, 1e-9, dx))) + 180.0
    bins = jnp.clip((ang / 10.0).astype(jnp.int32), 0, 35)
    hist = jnp.zeros((36,), jnp.int32).at[bins].add(keep.astype(jnp.int32))
    mode = jnp.argmax(hist).astype(jnp.int32)
    diff = jnp.abs(bins - mode)
    diff = jnp.minimum(diff, 36 - diff)  # circular (≙ the ibin_0/2 wraps)
    return diff <= 1


def _da_single(
    cur: FrameFeatures,
    oth_row,
    oth_valid_kf: jax.Array,
    init_pose: jax.Array,
    cam: StereoCamera,
    key: jax.Array,
    max_orb_distance_da: float,
    residual_th: float,
    max_y_diff_epipolar: float,
    filter_by_direction: bool,
    use_fund_matrix: bool,
    use_change_pose: bool,
    kernel_param: float,
    filter_by_orb_distance: bool = True,
    ransac_n_hyp: int = 128,
    min_alive: int = 15,
    seed_from_init: bool = False,
    init_gate_budget_m=0.0,
):
    (oy_l, ox_l, _oval_l, odesc_l, _oy_r, oxr, _ovr, _odesc_r, om_ridx,
     om_valid, opts3d, ooct) = oth_row
    k = cur.desc_l.shape[0]

    dist = hamming_matrix(cur.desc_l, odesc_l)  # f32
    gate = (cur.m_valid[:, None] & om_valid[None, :] & oth_valid_kf
            & (cur.octave[:, None] == ooct[None, :]))
    d = jnp.where(gate, dist, _BIG)
    oidx = jnp.argmin(d, axis=1).astype(jnp.int32)
    bd = jnp.min(d, axis=1)
    raw = bd < _BIG
    status = jnp.where(raw, S_TRACKED, S_NON_TRACKED).astype(jnp.int8)
    keep = raw

    # filter 1: direction histogram
    if filter_by_direction:
        ok = _direction_filter(keep, cur.ys_l, cur.xs_l, oy_l, ox_l, oidx,
                               jnp.float32(cam.height))
        status = jnp.where(keep & ~ok, S_REJ_SLOPE, status).astype(jnp.int8)
        keep = keep & ok

    # filter 2: ORB distance + 1-to-1 uniqueness (best wins); the whole
    # block is gated by da_filter_by_orb_distance, exactly like the
    # reference (.cpp:1500 wraps distance AND uniqueness in one `if`)
    if filter_by_orb_distance:
        ok = bd <= max_orb_distance_da
        status = jnp.where(keep & ~ok, S_REJ_ORB, status).astype(jnp.int8)
        keep = keep & ok
        rows = jnp.arange(k, dtype=jnp.int32).astype(jnp.float32)
        lex = jnp.where(keep, bd * k + rows, _BIG)
        cols = jax.lax.broadcasted_iota(jnp.int32, (k, k), 1)
        claimed = cols == oidx[:, None]
        col_best = jnp.min(jnp.where(claimed, lex[:, None], _BIG), axis=0)
        ok = lex == col_best[oidx]
        status = jnp.where(keep & ~ok, S_REJ_CONSISTENCY,
                           status).astype(jnp.int8)
        keep = keep & ok

    # filter 3: fundamental-matrix RANSAC on left pixel pairs
    if use_fund_matrix:
        n_alive = jnp.sum(keep.astype(jnp.int32))
        inl, _cnt, _F = ransac_fundamental(
            cur.xs_l.astype(jnp.float32), cur.ys_l.astype(jnp.float32),
            ox_l[oidx].astype(jnp.float32), oy_l[oidx].astype(jnp.float32),
            keep, key, threshold=max_y_diff_epipolar, n_hyp=ransac_n_hyp,
        )
        apply = n_alive >= min_alive
        ok = jnp.where(apply, inl, keep)
        status = jnp.where(keep & ~ok, S_REJ_FUND_MATRIX, status).astype(jnp.int8)
        keep = keep & ok

    # filter 4: change-in-pose residual gating (≙ getChangeInPose)
    pose = jnp.zeros((6,), jnp.float32)
    pose_ok = jnp.asarray(False)
    mean_res = jnp.asarray(0.0, jnp.float32)
    residuals = jnp.zeros((k,), jnp.float32)
    if use_change_pose:
        ur = cur.xs_r[cur.m_r_idx].astype(jnp.float32)
        obs = jnp.stack(
            [cur.xs_l.astype(jnp.float32), cur.ys_l.astype(jnp.float32), ur],
            axis=-1,
        )
        # initial pose: robust on-device Horn 3D-3D alignment over the
        # surviving correspondences (≙ the role of initialPoseVector at
        # reference .cpp:2133-2147 / similar_kfs_poses at :1840-1868): for
        # loop-closure candidates with large viewpoint change a zero start
        # converges to the wrong basin and rejects a true loop closure.
        # ``init_pose`` (explicit caller seed) is the fallback when the
        # 3D-3D geometry is too thin. ``seed_from_init=True`` (the
        # loop-closure RECOVERY re-check) instead FORCES the caller's
        # odometry-implied seed: on perceptually-aliased worlds the Horn
        # alignment locks the aliased consensus basin, while a GN started
        # at the odometry prior keeps only the odometry-consistent (true)
        # subset of the raw matches — the robust kernel downweights the
        # period-offset aliases from the first iteration.
        if seed_from_init:
            seed = init_pose
            # HARD pre-gate at the odometry prior (recovery path only): a
            # robust kernel alone cannot outvote a dominant aliased
            # consensus (Huber downweights, it does not zero), so matches
            # whose reprojection residual AT the prior already exceeds
            # what the drift budget allows are dropped before the solve.
            # The pixel allowance is depth-adaptive: a budget_m offset at
            # depth z subtends ~budget*fx/z pixels.
            from srba_slam_tpu.utils import se3 as _se3g

            p_pred = _se3g.transform_points(init_pose, opts3d[oidx])
            zq = jnp.maximum(p_pred[:, 2], 1.0)
            ulp = cam.cx_l + cam.fx_l * p_pred[:, 0] / zq
            vlp = cam.cy_l + cam.fy_l * p_pred[:, 1] / zq
            urp = cam.cx_r + cam.fx_r * (p_pred[:, 0] - cam.baseline) / zq
            ur_cur = cur.xs_r[cur.m_r_idx].astype(jnp.float32)
            e_px = jnp.maximum(
                jnp.abs(ulp - cur.xs_l.astype(jnp.float32)),
                jnp.maximum(jnp.abs(vlp - cur.ys_l.astype(jnp.float32)),
                            jnp.abs(urp - ur_cur)))
            allow = (jnp.asarray(init_gate_budget_m, jnp.float32)
                     * cam.fx_l / zq + residual_th)
            okg = (jnp.asarray(init_gate_budget_m, jnp.float32) <= 0.0) | \
                (e_px <= allow)
            status = jnp.where(keep & ~okg, S_REJ_CHANGE_POSE,
                               status).astype(jnp.int8)
            keep = keep & okg
        else:
            seed = _horn_seed(opts3d[oidx], cur.pts3d, keep, init_pose)
        sol = solve_pose(
            opts3d[oidx], obs, keep, cam,
            initial_pose=seed,
            kernel_param=kernel_param,
            residual_threshold=residual_th,
            min_inliers=min_alive,
            max_iters_initial=DA_SOLVE_ITERS_STAGE1,
            max_iters=DA_SOLVE_ITERS_STAGE2,
        )
        pose, pose_ok, mean_res = sol.pose, sol.valid, sol.mean_residual
        residuals = sol.residuals
        ok = jnp.where(pose_ok, sol.inliers, jnp.zeros_like(keep))
        # depth-consistency gate (robustness beyond the reference cascade):
        # the pixel residual barely constrains DEPTH at range — a 1 m depth
        # error at 20 m is under 1 px of disparity — so aliased matches
        # between different physical structures at different depths pass the
        # residual gate with multi-meter 3D error and then corrupt the
        # bundle adjustment. Gate on predicted-vs-triangulated depth with a
        # stereo-noise-proportional tolerance (sigma_z ~ z^2 * sigma_d /
        # (fx*b), sigma_d = 2 px, 4-sigma + 0.5 m floor).
        from srba_slam_tpu.utils import se3 as _se3

        p_pred = _se3.transform_points(pose, opts3d[oidx])
        z = jnp.maximum(cur.pts3d[:, 2], 0.5)
        depth_sig = z * z * 2.0 / (cam.fx_l * cam.baseline)
        ok3d = jnp.abs(p_pred[:, 2] - cur.pts3d[:, 2]) <= \
            4.0 * depth_sig + 0.5
        ok = ok & ok3d
        status = jnp.where(keep & ~ok, S_REJ_CHANGE_POSE, status).astype(jnp.int8)
        keep = keep & ok

    tracked = jnp.sum(keep.astype(jnp.int32))
    status = jnp.where(keep, S_TRACKED, status).astype(jnp.int8)
    return (status, jnp.where(keep, oidx, 0), tracked, pose, pose_ok,
            mean_res, oidx, bd, residuals)


@functools.partial(
    jax.jit,
    static_argnames=("filter_by_direction", "filter_by_orb_distance", "use_fund_matrix", "use_change_pose",
                     "n_query", "ransac_n_hyp"),
)
def query_and_associate(
    cur: FrameFeatures,
    store_arrays: KFArrays,
    db: jax.Array,               # BoW database [MAX_KFS, W]
    leaf_bits: jax.Array,
    weights: jax.Array,
    n_kfs: jax.Array,            # stored KF count (the new KF is NOT in yet)
    cam: StereoCamera,
    key: jax.Array,
    init_poses: jax.Array | None = None,  # f32 [MAX_KFS, 6] per-KF DA seeds
    n_query: int = 4,
    max_orb_distance_da: float = 60.0,
    residual_th: float = 30.0,
    max_y_diff_epipolar: float = 2.0,
    filter_by_direction: bool = True,
    filter_by_orb_distance: bool = True,
    use_fund_matrix: bool = True,
    use_change_pose: bool = True,
    kernel_param: float = 2.0,
    ransac_n_hyp: int = 128,
):
    """ONE dispatch for the whole keyframe check: BoW query (quantize +
    score + rank) AND the DA cascade against {previous KF} ∪ top-n_query BoW
    results. The host then applies the similar-KF selection / LC logic to the
    returned superset (extra candidates are simply ignored).

    ``init_poses[i]`` seeds the change-in-pose solve against candidate KF i
    (≙ the spanning-tree rough relative poses fed to getChangeInPose,
    reference .cpp:1840-1868, :2133-2147); zeros when omitted.

    Returns (scores [n_query], ids [n_query], cand [1+n_query], DAResult).
    """
    from srba_slam_tpu.models.bow import bow_vector

    q = bow_vector(cur.desc_l, cur.m_valid, leaf_bits, weights)
    scores_all = jnp.sum(jnp.minimum(db, q[None, :]), axis=-1)
    row = jnp.arange(db.shape[0])
    scores_all = jnp.where(row < n_kfs, scores_all, -1.0)
    top_s, top_i = jax.lax.top_k(scores_all, n_query)

    prev_kf = n_kfs - 1
    cand = jnp.concatenate([prev_kf[None], top_i.astype(jnp.int32)])
    cand_valid = jnp.concatenate([
        jnp.asarray([True]),
        (top_s > 0) & (top_i.astype(jnp.int32) != prev_kf),
    ])
    cand = jnp.clip(cand, 0, db.shape[0] - 1)
    init_cand = (
        init_poses[cand] if init_poses is not None
        else jnp.zeros((cand.shape[0], 6), jnp.float32)
    )
    da = da_cascade(
        cur, store_arrays, cand, cand_valid, cam, key,
        init_poses=init_cand,
        max_orb_distance_da=max_orb_distance_da,
        residual_th=residual_th,
        max_y_diff_epipolar=max_y_diff_epipolar,
        filter_by_direction=filter_by_direction,
        filter_by_orb_distance=filter_by_orb_distance,
        use_fund_matrix=use_fund_matrix,
        use_change_pose=use_change_pose,
        kernel_param=kernel_param,
        ransac_n_hyp=ransac_n_hyp,
    )
    return top_s, top_i, cand, da


@functools.partial(
    jax.jit,
    static_argnames=("filter_by_direction", "filter_by_orb_distance", "use_fund_matrix", "use_change_pose",
                     "n_query", "ransac_n_hyp", "debug"),
    donate_argnums=(1, 2),
)
def fused_check_write(
    feats,                       # FrameFeatures batch [B, ...] (vo_scan output)
    store_arrays: KFArrays,      # donated
    db: jax.Array,               # BoW database [MAX_KFS, W] (donated)
    leaf_bits: jax.Array,
    weights: jax.Array,
    j: jax.Array,                # frame index within the batch
    n_kfs: jax.Array,            # candidate count == speculative row index
    cam: StereoCamera,
    seed,                        # plain int (host RNG stream; the PRNG key
    #   is built in-program — see query_and_associate_packed)
    n_query: int = 4,
    max_orb_distance_da: float = 60.0,
    residual_th: float = 30.0,
    max_y_diff_epipolar: float = 2.0,
    filter_by_direction: bool = True,
    filter_by_orb_distance: bool = True,
    use_fund_matrix: bool = True,
    use_change_pose: bool = True,
    kernel_param: float = 2.0,
    ransac_n_hyp: int = 128,
    debug: bool = False,
):
    """ONE dispatch for a whole deferred keyframe check: slice frame j out
    of the scanned batch, SPECULATIVELY write its keyframe-store and BoW
    rows at ``n_kfs`` (rows at index >= the committed count are inert — the
    estimator's speculation model), and run the fused BoW-query + DA
    cascade: one jitted call where the unfused path (slice + query+DA +
    store write + BoW write) made four.

    Returns (handles, new_store_arrays, new_db) where handles is the exact
    11-tuple the estimator's ``_kf_decide`` consumes.
    """
    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    blob, new_arrays, new_db = _check_one_slot(
        feats, store_arrays, db, leaf_bits, weights, j, n_kfs,
        cam, key, n_query, max_orb_distance_da,
        residual_th, max_y_diff_epipolar, filter_by_direction,
        use_fund_matrix, use_change_pose, kernel_param, ransac_n_hyp,
        filter_by_orb_distance=filter_by_orb_distance, debug=debug)
    return (blob,), new_arrays, new_db


def _check_one_slot(feats, store_arrays, db, leaf_bits, weights, j, row,
                    cam, key, n_query, max_orb_distance_da,
                    residual_th, max_y_diff_epipolar, filter_by_direction,
                    use_fund_matrix, use_change_pose, kernel_param,
                    ransac_n_hyp, filter_by_orb_distance=True, debug=False):
    """One deferred check: speculative row write + BoW query + DA cascade +
    output packing. Callers handle padding themselves — the batch program
    skips invalid slots entirely via ``lax.cond``."""
    from srba_slam_tpu.models.bow import bow_vector

    frame = jax.tree.map(lambda a: a[j], feats)
    row_vals = (frame.ys_l, frame.xs_l, frame.valid_l, frame.desc_l,
                frame.ys_r, frame.xs_r, frame.valid_r, frame.desc_r,
                frame.m_r_idx, frame.m_valid, frame.pts3d, frame.octave)
    new_arrays = KFArrays(*(arr.at[row].set(val)
                            for arr, val in zip(store_arrays, row_vals)))
    v = bow_vector(frame.desc_l, frame.m_valid, leaf_bits, weights)
    new_db = jax.lax.dynamic_update_slice(db, v[None, :], (row, 0))

    scores_all = jnp.sum(jnp.minimum(new_db, v[None, :]), axis=-1)
    rows = jnp.arange(new_db.shape[0])
    scores_all = jnp.where(rows < row, scores_all, -1.0)
    top_s, top_i = jax.lax.top_k(scores_all, n_query)

    prev_kf = row - 1
    cand = jnp.concatenate([prev_kf[None], top_i.astype(jnp.int32)])
    cand_valid = jnp.concatenate([
        jnp.asarray([True]),
        (top_s > 0) & (top_i.astype(jnp.int32) != prev_kf),
    ])
    cand = jnp.clip(cand, 0, new_db.shape[0] - 1)
    da = da_cascade(
        frame, new_arrays, cand, cand_valid, cam, key,
        max_orb_distance_da=max_orb_distance_da,
        residual_th=residual_th,
        max_y_diff_epipolar=max_y_diff_epipolar,
        filter_by_direction=filter_by_direction,
        filter_by_orb_distance=filter_by_orb_distance,
        use_fund_matrix=use_fund_matrix,
        use_change_pose=use_change_pose,
        kernel_param=kernel_param,
        ransac_n_hyp=ransac_n_hyp,
    )
    (blob,) = pack_check_outputs(top_s, top_i, da, frame, debug=debug)
    return blob, new_arrays, new_db


CHECK_SLOTS = 8  # fixed slot count: ONE compiled program regardless of how
# many checks a batch queues (padded slots are masked no-ops); a variable
# slot count would queue a fresh multi-minute remote compile per new count


@functools.partial(
    jax.jit,
    static_argnames=("filter_by_direction", "filter_by_orb_distance", "use_fund_matrix",
                     "use_change_pose", "n_query", "ransac_n_hyp", "debug"),
    donate_argnums=(1, 2),
)
def fused_checks_batch(
    feats,                       # FrameFeatures batch [B, ...] (vo_scan output)
    store_arrays: KFArrays,      # donated
    db: jax.Array,               # BoW database [MAX_KFS, W] (donated)
    leaf_bits: jax.Array,
    weights: jax.Array,
    js,                          # CHECK_SLOTS-tuple of python ints (frame
    #   index per slot) — python scalars ride the dispatch itself; an
    #   int32 array argument would be a real host->device upload that
    #   queues BEHIND the in-flight frame prefetch, delaying the checks
    rows,                        # CHECK_SLOTS-tuple of python ints
    valids,                      # CHECK_SLOTS-tuple of python bools
    cam: StereoCamera,
    seeds,                       # CHECK_SLOTS-tuple of python ints (host
    #   RNG stream; PRNG keys are built in-program — see
    #   query_and_associate_packed)
    n_query: int = 4,
    max_orb_distance_da: float = 60.0,
    residual_th: float = 30.0,
    max_y_diff_epipolar: float = 2.0,
    filter_by_direction: bool = True,
    filter_by_orb_distance: bool = True,
    use_fund_matrix: bool = True,
    use_change_pose: bool = True,
    kernel_param: float = 2.0,
    ransac_n_hyp: int = 128,
    debug: bool = False,
):
    """ALL of a batch's deferred keyframe checks in ONE dispatch.

    A 15-frame batch typically queues ~5 checks; instead of one
    :func:`fused_check_write` dispatch per check, this runs them as a
    ``lax.scan`` over ``CHECK_SLOTS`` padded slots, threading the
    keyframe-store/BoW-DB speculative writes through the carry (identical
    chaining semantics to sequential per-check dispatches — later checks
    see earlier checks' speculative rows). Padded (invalid) slots skip the
    whole check through ``lax.cond`` — a check is ~10 ms of real device
    compute, and a per-count program would queue a fresh remote compile
    for every distinct check count.

    Returns (blobs, new_store_arrays, new_db) where ``blobs`` is a tuple of
    CHECK_SLOTS per-slot output blobs (same layout as
    :func:`pack_check_outputs`)."""
    def body(carry, xs):
        arrays, db_ = carry
        j, row, valid, seed = xs
        key = jax.random.PRNGKey(seed)

        def run(_):
            return _check_one_slot(
                feats, arrays, db_, leaf_bits, weights, j, row,
                cam, key, n_query, max_orb_distance_da,
                residual_th, max_y_diff_epipolar, filter_by_direction,
                use_fund_matrix, use_change_pose, kernel_param, ransac_n_hyp,
                filter_by_orb_distance=filter_by_orb_distance, debug=debug)

        blob_len = jax.eval_shape(run, None)[0].shape[0]

        def skip(_):
            # a padded slot must cost ~nothing: the cascade is ~10 ms of
            # device compute per slot, so masking writes alone (compute-and-
            # discard) would more than double a 3-check batch's device time
            return jnp.zeros(blob_len, jnp.int32), arrays, db_

        blob, arrays, db_ = jax.lax.cond(valid, run, skip, None)
        return (arrays, db_), blob

    (new_arrays, new_db), blobs = jax.lax.scan(
        body, (store_arrays, db),
        (jnp.stack([jnp.int32(j) for j in js]),
         jnp.stack([jnp.int32(r) for r in rows]),
         jnp.stack([jnp.asarray(v) for v in valids]),
         jnp.stack([jnp.asarray(sd, jnp.uint32) for sd in seeds])))
    return tuple(blobs), new_arrays, new_db


def pack_check_outputs(top_s, top_i, da: DAResult, frame,
                       debug: bool = False) -> tuple:
    """Pack a check's 11 output arrays into ONE device blob (int32), so a
    batch's pull fetches one buffer per check instead of ~11 small arrays.
    Float outputs ride along bitcast to int32 (f32 -> i32 is bijective and
    integer transfer is exact — no NaN-canonicalization hazard). Host side:
    unpack_check_outputs.

    ``debug=True`` appends the debug-artifact section (raw pre-filter match
    indices + Hamming distances + filter-4 residuals), the inputs of the
    reference's ``if_raw_match*`` / ``if_match_after*`` / ``da_dist*`` /
    ``posechange_outliers*`` golden files (reference .cpp:1455-1473,
    :1649-1721, :566-616, :2236-2251)."""
    floats = [top_s, frame.pts3d.ravel()]
    ints = [
        top_i.astype(jnp.int32),                 # [nq]
        da.status.astype(jnp.int32).ravel(),     # [S*K]
        da.other_idx.ravel(),                    # [S*K]
        da.tracked_count.astype(jnp.int32),      # [S]
        frame.m_valid.astype(jnp.int32),         # [K]
        frame.xs_l, frame.ys_l, frame.xs_r,      # 3x [K]
        frame.m_r_idx,                           # [K]
    ]
    if debug:
        # Hamming distances are integral (and _BIG fits int32): exact as i32
        ints += [da.raw_oidx.ravel(), da.distance.astype(jnp.int32).ravel()]
        floats += [da.residuals.ravel()]
    blob = jnp.concatenate(
        ints + [jax.lax.bitcast_convert_type(jnp.concatenate(floats),
                                             jnp.int32)])
    return (blob,)


@functools.partial(
    jax.jit,
    static_argnames=("filter_by_direction", "filter_by_orb_distance", "use_fund_matrix", "use_change_pose",
                     "n_query", "ransac_n_hyp", "debug"),
)
def query_and_associate_packed(
    cur: FrameFeatures, store_arrays: KFArrays, db, leaf_bits, weights,
    n_kfs, cam: StereoCamera, seed,
    n_query: int = 4, max_orb_distance_da: float = 60.0,
    residual_th: float = 30.0, max_y_diff_epipolar: float = 2.0,
    filter_by_direction: bool = True, filter_by_orb_distance: bool = True,
    use_fund_matrix: bool = True,
    use_change_pose: bool = True, kernel_param: float = 2.0,
    ransac_n_hyp: int = 128, debug: bool = False,
):
    """query_and_associate with blob-packed outputs (synchronous-check path
    companion of fused_check_write). ``seed`` is a PLAIN INT (host RNG
    stream): it rides the dispatch with no transfer and the PRNG key is
    built inside the program — a chained ``jax.random.split`` per check
    would cost one more jitted dispatch each."""
    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    top_s, top_i, _cand, da = query_and_associate(
        cur, store_arrays, db, leaf_bits, weights, n_kfs, cam, key,
        n_query=n_query, max_orb_distance_da=max_orb_distance_da,
        residual_th=residual_th, max_y_diff_epipolar=max_y_diff_epipolar,
        filter_by_direction=filter_by_direction,
        filter_by_orb_distance=filter_by_orb_distance,
        use_fund_matrix=use_fund_matrix, use_change_pose=use_change_pose,
        kernel_param=kernel_param, ransac_n_hyp=ransac_n_hyp,
    )
    return pack_check_outputs(top_s, top_i, da, cur, debug=debug)


def unpack_check_outputs(blob, s: int, k: int, nq: int,
                         debug: bool = False) -> tuple:
    """Inverse of pack_check_outputs on the HOST numpy blob; returns the
    11-tuple (scores, ids, status, other_idx, tracked, m_valid, xs_l, ys_l,
    xs_r, m_r_idx, pts3d) the estimator's decision logic consumes — with
    ``debug=True``, a 12th element: the debug-extras dict
    {raw_oidx [S,K], distance [S,K], residuals [S,K]}."""
    import numpy as np

    o = 0
    top_i = blob[o:o + nq]; o += nq
    status = blob[o:o + s * k].reshape(s, k).astype(np.int8); o += s * k
    other_idx = blob[o:o + s * k].reshape(s, k); o += s * k
    tracked = blob[o:o + s]; o += s
    m_valid = blob[o:o + k].astype(bool); o += k
    xs_l = blob[o:o + k]; o += k
    ys_l = blob[o:o + k]; o += k
    xs_r = blob[o:o + k]; o += k
    m_r_idx = blob[o:o + k]; o += k
    extras = None
    if debug:
        raw_oidx = blob[o:o + s * k].reshape(s, k); o += s * k
        distance = blob[o:o + s * k].reshape(s, k).astype(np.float32)
        o += s * k
    floats = np.ascontiguousarray(blob[o:]).view(np.float32)
    top_s = floats[:nq]
    pts3d = floats[nq:nq + 3 * k].reshape(k, 3)
    out = (top_s, top_i, status, other_idx, tracked, m_valid, xs_l, ys_l,
           xs_r, m_r_idx, pts3d)
    if debug:
        residuals = floats[nq + 3 * k:nq + 3 * k + s * k].reshape(s, k)
        extras = dict(raw_oidx=raw_oidx, distance=distance,
                      residuals=residuals)
        out = out + (extras,)
    return out


@functools.partial(
    jax.jit,
    static_argnames=("filter_by_direction", "filter_by_orb_distance", "use_fund_matrix", "use_change_pose",
                     "ransac_n_hyp"),
)
def da_cascade(
    cur: FrameFeatures,
    store_arrays: KFArrays,      # full keyframe store [M, K, ...]
    similar_idx: jax.Array,      # int32 [S] keyframe ids to associate against
    others_valid: jax.Array,     # bool [S]
    cam: StereoCamera,
    key: jax.Array,
    init_poses: jax.Array | None = None,  # f32 [S, 6] change-in-pose seeds
    max_orb_distance_da: float = 60.0,
    residual_th: float = 30.0,
    max_y_diff_epipolar: float = 2.0,
    filter_by_direction: bool = True,
    filter_by_orb_distance: bool = True,
    use_fund_matrix: bool = True,
    use_change_pose: bool = True,
    kernel_param: float = 2.0,
    ransac_n_hyp: int = 128,
) -> DAResult:
    """Run the full cascade of the current KF against S candidate KFs (rows
    gathered from the store inside the program — one dispatch total)."""
    s = others_valid.shape[0]
    others = jax.tree.map(lambda a: a[similar_idx], store_arrays)
    keys = jax.random.split(key, s)
    if init_poses is None:
        init_poses = jnp.zeros((s, 6), jnp.float32)

    def one(oth_row, ov, init, kk):
        return _da_single(
            cur, oth_row, ov, init, cam, kk,
            max_orb_distance_da, residual_th, max_y_diff_epipolar,
            filter_by_direction, use_fund_matrix, use_change_pose, kernel_param,
            filter_by_orb_distance=filter_by_orb_distance,
            ransac_n_hyp=ransac_n_hyp,
        )

    (status, oidx, tracked, pose, pose_ok, mean_res, raw_oidx, bd,
     residuals) = jax.vmap(one)(tuple(others), others_valid, init_poses, keys)
    tracked = jnp.where(others_valid, tracked, 0)
    return DAResult(status, oidx, tracked, pose, pose_ok & others_valid,
                    mean_res, raw_oidx, bd, residuals)


@functools.partial(
    jax.jit,
    static_argnames=("filter_by_direction", "filter_by_orb_distance", "use_fund_matrix",
                     "ransac_n_hyp"),
)
def recheck_candidate(
    store_arrays: KFArrays,
    row_new,                     # int: the (already written) new KF's row
    row_old,                     # int: the rejected loop-closure candidate
    cam: StereoCamera,
    init_pose: jax.Array,        # f32 [6] odometry-implied candidate-in-new
    seed,                        # plain int host RNG stream
    max_orb_distance_da: float = 60.0,
    residual_th: float = 30.0,
    max_y_diff_epipolar: float = 2.0,
    filter_by_direction: bool = True,
    filter_by_orb_distance: bool = True,
    use_fund_matrix: bool = True,
    kernel_param: float = 2.0,
    ransac_n_hyp: int = 128,
    init_gate_budget_m=0.0,      # drift budget (m) of the hard pre-gate at
    #   the odometry prior; traced scalar (0 disables)
):  # noqa: E501
    """Loop-closure RECOVERY re-check (framework extension; no reference
    counterpart — the reference has no aliasing defense at all): re-run the
    DA cascade for ONE candidate with the change-in-pose solve FORCED to
    start from the odometry-implied relative pose instead of the Horn
    appearance alignment (``seed_from_init``, see _da_single). Keeps only
    the odometry-consistent subset of the raw matches, which on an aliased
    world is the TRUE correspondence set. Both keyframes are read from the
    store (the new KF's row is already written — speculatively or
    committed). Returns (status [K], other_idx [K], tracked, pose [6])."""
    oth_row = tuple(arr[row_old] for arr in store_arrays)
    r = jax.tree.map(lambda a: a[row_new], store_arrays)
    cur = FrameFeatures(
        ys_l=r.ys_l, xs_l=r.xs_l, score_l=jnp.zeros_like(r.xs_l, jnp.float32),
        valid_l=r.valid_l, desc_l=r.desc_l, ys_r=r.ys_r, xs_r=r.xs_r,
        valid_r=r.valid_r, desc_r=r.desc_r, m_r_idx=r.m_r_idx,
        m_valid=r.m_valid, pts3d=r.pts3d, octave=r.octave)
    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    (status, oidx, tracked, pose, _pose_ok, _mean_res, _raw_oidx, _bd,
     _residuals) = _da_single(
        cur, oth_row, jnp.asarray(True), init_pose.astype(jnp.float32), cam,
        key, max_orb_distance_da, residual_th, max_y_diff_epipolar,
        filter_by_direction, use_fund_matrix, True, kernel_param,
        filter_by_orb_distance=filter_by_orb_distance,
        ransac_n_hyp=ransac_n_hyp, seed_from_init=True,
        init_gate_budget_m=init_gate_budget_m)
    return status, oidx, tracked, pose
