"""Synthetic stereo-world renderer (tests, benchmarks, demos).

Renders a textured, tilted plane seen from a moving rectified stereo rig —
ray-plane intersection + bilinear texture sampling, all in numpy. Gives
pixel-accurate ground-truth camera motion for VO / SLAM tests without any
dataset dependency.
"""

from __future__ import annotations

import numpy as np

from srba_slam_tpu.utils import se3_np


def smooth_texture(rng, h=2048, w=2048, spacing=48, sigma=6.0,
                   jitter_frac=1.0 / 3.0, fractal=False):
    """Multi-scale field of anisotropic Gaussian blobs on a dark floor.

    ``jitter_frac`` is the blob-placement jitter as a fraction of the cell
    spacing. The default (1/3) keeps a loose lattice; 1.0 places blobs
    uniformly inside their cells — APERIODIC, which matters for SLAM test
    worlds: a quasi-regular lattice aliases under motion by ~multiples of
    the spacing, producing large rigid-consistent sets of FALSE descriptor
    matches that pass every geometric data-association filter.

    Gives FAST corners with well-separated, persistent scores — the
    detector's top-K selection is then repeatable across small viewpoint
    changes, like on natural images (smooth noise textures produce thousands
    of near-tied weak corners and pathological selection churn). Three blob
    octaves + random elongation/orientation make each corner's BRIEF
    neighborhood spatially unique: a single-scale lattice of symmetric blobs
    produces near-identical descriptors everywhere, and that translation
    symmetry aliases inter-keyframe matching and fakes/breaks loop closures.
    """
    tex = np.full((h, w), 20.0, np.float32)

    def stamp_layer(spacing_l, sigma_l, amp_lo, amp_hi, signed=False):
        rad = int(3 * sigma_l)
        # margin must cover the jitter range; the max() keeps the default
        # jitter's blob layout bit-identical to the historical one
        lo = rad + max(spacing_l // 2,
                       int(np.ceil(spacing_l * jitter_frac)) + 1)
        win = np.arange(-rad, rad + 1)
        gy, gx = np.meshgrid(win, win, indexing="ij")
        for y0 in np.arange(lo, h - lo, spacing_l):
            for x0 in np.arange(lo, w - lo, spacing_l):
                cy = y0 + rng.uniform(-spacing_l * jitter_frac,
                                      spacing_l * jitter_frac)
                cx = x0 + rng.uniform(-spacing_l * jitter_frac,
                                      spacing_l * jitter_frac)
                amp = rng.uniform(amp_lo, amp_hi)
                if signed and rng.uniform() < 0.5:
                    amp = -amp
                iy, ix = int(round(cy)), int(round(cx))
                fy, fx = cy - iy, cx - ix
                sx = sigma_l * rng.uniform(0.55, 1.5)
                sy = sigma_l * rng.uniform(0.55, 1.5)
                th = rng.uniform(0.0, np.pi)
                ct, st = np.cos(th), np.sin(th)
                u = ct * (gx - fx) + st * (gy - fy)
                v = -st * (gx - fx) + ct * (gy - fy)
                blob = amp * np.exp(-(u**2 / sx**2 + v**2 / sy**2) / 2)
                tex[iy - rad : iy + rad + 1, ix - rad : ix + rad + 1] += \
                    blob.astype(np.float32)

    # coarse backdrop octaves (signed: bright and dark patches) give every
    # fine corner a unique large-scale context; the fine layer provides the
    # actual FAST corners
    stamp_layer(spacing * 4, sigma * 4, 25.0, 60.0, signed=True)
    stamp_layer(spacing * 2, sigma * 2, 20.0, 50.0, signed=True)
    stamp_layer(spacing, sigma, 40.0, 235.0)
    if fractal:
        # sub-octaves: corners exist at EVERY screen scale, so the tracked
        # feature set decays gradually as the camera approaches instead of
        # collapsing when one blob scale leaves the detector's band —
        # matching how real-world surfaces behave
        stamp_layer(spacing // 2, sigma / 2, 40.0, 180.0)
        stamp_layer(spacing // 4, sigma / 4, 40.0, 150.0)
    return np.clip(tex, 0.0, 255.0)


def _bilinear(tex, u, v):
    """Bilinear sample with wrap-around (the texture tiles, so planes are
    effectively infinite)."""
    h, w = tex.shape
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu, fv = u - u0, v - v0
    u0 %= w
    v0 %= h
    u1 = (u0 + 1) % w
    v1 = (v0 + 1) % h
    t00 = tex[v0, u0]
    t01 = tex[v0, u1]
    t10 = tex[v1, u0]
    t11 = tex[v1, u1]
    return (
        t00 * (1 - fu) * (1 - fv)
        + t01 * fu * (1 - fv)
        + t10 * (1 - fu) * fv
        + t11 * fu * fv
    )


class PlaneScene:
    """Textured plane n·x = d in world coordinates (default: tilted frontal
    plane ~12m away). Rays that miss the plane (behind the camera or beyond
    max_range) render black.

    ``PlaneScene.ground(rng)`` builds the long-sequence variant: an infinite
    tiled ground plane 1.5 m below the camera (KITTI-like road geometry) that
    never runs out however far the camera drives.
    """

    def __init__(self, rng, normal=(0.05, 0.08, -1.0), d=-12.0, tex_scale=60.0,
                 max_range=200.0):
        self.tex = smooth_texture(rng)
        n = np.asarray(normal, np.float64)
        self.n = n / np.linalg.norm(n)
        self.d = d / np.linalg.norm(np.asarray(normal, np.float64))
        self.tex_scale = tex_scale  # texture pixels per world meter
        self.max_range = max_range
        # in-plane texture basis (orthonormal, ⟂ n)
        a = np.array([1.0, 0.0, 0.0])
        if abs(self.n @ a) > 0.9:
            a = np.array([0.0, 1.0, 0.0])
        self.e1 = np.cross(self.n, a)
        self.e1 /= np.linalg.norm(self.e1)
        self.e2 = np.cross(self.n, self.e1)

    @staticmethod
    def ground(rng, height=1.5, tex_scale=24.0):
        """Infinite tiled ground plane `height` meters below the camera
        (camera convention: x right, y DOWN, z forward)."""
        return PlaneScene(rng, normal=(0.0, 1.0, 0.0), d=height,
                          tex_scale=tex_scale, max_range=120.0)

    def render(self, cam, pose_wc: np.ndarray):
        """Render the stereo pair for a camera at world pose `pose_wc`
        ([6] rotvec+trans; camera looks +z, x right, y down)."""
        R, t = se3_np.exp(np.asarray(pose_wc, np.float64))
        h, w = cam.height, cam.width
        us, vs = np.meshgrid(np.arange(w), np.arange(h))

        def render_eye(cx, cy, fx, fy, origin):
            dirs = np.stack(
                [(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, np.float64)], -1
            )
            dirs_w = dirs @ R.T
            denom = dirs_w @ self.n
            lam = (self.d - origin @ self.n) / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
            pts = origin[None, None, :] + lam[..., None] * dirs_w
            u_t = (pts @ self.e1) * self.tex_scale + self.tex.shape[1] / 2
            v_t = (pts @ self.e2) * self.tex_scale + self.tex.shape[0] / 2
            img = _bilinear(self.tex, u_t, v_t)
            # rays that miss the plane (behind camera / horizon / too far)
            visible = (lam > 0.0) & (lam < self.max_range)
            # 8-bit output (what a real camera delivers; keeps host->device
            # uploads at 1 byte/px)
            img = np.where(visible, img, 0.0)
            return np.clip(np.rint(img), 0.0, 255.0).astype(np.uint8)

        left = render_eye(cam.cx_l, cam.cy_l, cam.fx_l, cam.fy_l, t)
        right_origin = t + R @ np.array([cam.baseline, 0.0, 0.0])
        right = render_eye(cam.cx_r, cam.cy_r, cam.fx_r, cam.fy_r, right_origin)
        return left, right


class StreetScene:
    """Ground plane + camera-facing textured billboards at stable depths —
    a KITTI-street-like world for benchmark-geometry runs.

    A pure grazing ground plane is a pathological world for descriptor-based
    inter-keyframe association at automotive scale: its texture foreshortens
    and rescales so fast along the viewing direction that ORB descriptors of
    the same spot differ completely between keyframes meters apart, and the
    tiled texture aliases (real streets instead show facades, poles, parked
    cars — near-frontal surfaces whose appearance is stable over many
    meters). The billboards model that frontal structure: each is a quad
    facing the camera with its own texture window, so features on them track
    across keyframes like real roadside structure does.
    """

    def __init__(self, rng, path_len: float = 80.0, spacing: float = 4.0,
                 tex_scale: float = 90.0):
        self.ground = PlaneScene.ground(rng)
        # aperiodic (jitter_frac=1: a loose lattice aliases under ~2 m
        # motion steps at automotive geometry) + fractal (corners at every
        # screen scale decay gradually with distance) — see smooth_texture
        self.ground.tex = smooth_texture(rng, jitter_frac=1.0, fractal=True)
        self.tex = self.ground.tex  # share the texture, different windows
        self.tex_scale = tex_scale
        zs = np.arange(6.0, path_len + 70.0, spacing)
        n = len(zs)
        self.bz = zs + rng.uniform(-1.5, 1.5, n)
        side = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
        self.bx = side * rng.uniform(3.5, 9.0, n)
        self.by = rng.uniform(-1.2, 0.6, n)      # y down; ground at +1.5
        # range invariant: |bx| >= 3.5 and half-size <= 2.2 guarantee
        # >= 1.3 m lateral clearance from the camera path — a board grazing
        # the path would fill the whole frame with one hugely magnified
        # (featureless) texture patch for a frame or two, starving the
        # detector
        self.bs = rng.uniform(0.8, 2.2, n)
        # every billboard samples the shared texture through a UNIQUE warp
        # (offset + its own scale + random mirroring): two billboards must
        # never display the same pixel pattern, or their false inter-board
        # matches form geometrically consistent sets that pass every DA
        # filter and corrupt the bundle adjustment
        self.bu = rng.uniform(0, self.tex.shape[1], n)  # texture window offset
        self.bv = rng.uniform(0, self.tex.shape[0], n)
        self.bscale = rng.uniform(60.0, 130.0, n)       # px per meter
        self.bmu = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
        self.bmv = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)

    def render(self, cam, pose_wc: np.ndarray):
        R, t = se3_np.exp(np.asarray(pose_wc, np.float64))
        h, w = cam.height, cam.width
        us, vs = np.meshgrid(np.arange(w), np.arange(h))
        g = self.ground

        def render_eye(cx, cy, fx, fy, origin):
            dirs = np.stack(
                [(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, np.float64)],
                -1)
            dirs_w = dirs @ R.T
            denom = dirs_w @ g.n
            lam_g = (g.d - origin @ g.n) / np.where(
                np.abs(denom) < 1e-12, 1e-12, denom)
            pts = origin[None, None, :] + lam_g[..., None] * dirs_w
            u_t = (pts @ g.e1) * g.tex_scale + self.tex.shape[1] / 2
            v_t = (pts @ g.e2) * g.tex_scale + self.tex.shape[0] / 2
            img = _bilinear(self.tex, u_t, v_t)
            ok_g = (lam_g > 0.0) & (lam_g < g.max_range)
            img = np.where(ok_g, img, 0.0)
            best_lam = np.where(ok_g, lam_g, np.inf)
            dz = dirs_w[..., 2]
            for i in range(len(self.bz)):
                # project the quad's corners to bound the affected pixel
                # window (boards cover a tiny screen area; evaluating the
                # hit math full-frame per board dominates render time)
                cs = np.array([
                    [self.bx[i] + sx * self.bs[i], self.by[i] + sy * self.bs[i],
                     self.bz[i]]
                    for sx in (-1, 1) for sy in (-1, 1)])
                cc = (cs - origin) @ R
                if (cc[:, 2] < 0.1).all():
                    continue
                if (cc[:, 2] > 0.1).all():
                    uc = fx * cc[:, 0] / cc[:, 2] + cx
                    vc = fy * cc[:, 1] / cc[:, 2] + cy
                    x0 = max(int(np.floor(uc.min())) - 2, 0)
                    x1 = min(int(np.ceil(uc.max())) + 2, w)
                    y0 = max(int(np.floor(vc.min())) - 2, 0)
                    y1 = min(int(np.ceil(vc.max())) + 2, h)
                    if x0 >= x1 or y0 >= y1:
                        continue
                else:
                    x0, x1, y0, y1 = 0, w, 0, h  # crosses the near plane
                sl = (slice(y0, y1), slice(x0, x1))
                dzs = dz[sl]
                lam = (self.bz[i] - origin[2]) / np.where(
                    np.abs(dzs) < 1e-12, 1e-12, dzs)
                px = origin[0] + lam * dirs_w[sl + (0,)]
                py = origin[1] + lam * dirs_w[sl + (1,)]
                hit = ((lam > 0.1) & (lam < best_lam[sl])
                       & (np.abs(px - self.bx[i]) <= self.bs[i])
                       & (np.abs(py - self.by[i]) <= self.bs[i]))
                if not hit.any():
                    continue
                u_b = self.bmu[i] * (px - self.bx[i]) * self.bscale[i] \
                    + self.bu[i]
                v_b = self.bmv[i] * (py - self.by[i]) * self.bscale[i] \
                    + self.bv[i]
                img[sl] = np.where(hit, _bilinear(self.tex, u_b, v_b), img[sl])
                best_lam[sl] = np.where(hit, lam, best_lam[sl])
            return np.clip(np.rint(img), 0.0, 255.0).astype(np.uint8)

        left = render_eye(cam.cx_l, cam.cy_l, cam.fx_l, cam.fy_l, t)
        right_origin = t + R @ np.array([cam.baseline, 0.0, 0.0])
        right = render_eye(cam.cx_r, cam.cy_r, cam.fx_r, cam.fy_r,
                           right_origin)
        return left, right


def make_ba_window_problem(cam, rng, C, L, O, n_cams, n_lms,
                           pose_noise=0.02, lm_noise=0.05, px_noise=0.3,
                           step=0.8):
    """Vectorized synthetic windowed-BA problem at arbitrary scale
    (validates the sharded window solve at the loop-closure bucket —
    models/srba.py win_cams/win_lms/win_obs — where a python per-obs loop
    would take minutes). Cameras advance roughly +z through a landmark
    cloud; every in-front landmark is observed, subsampled to the O
    capacity. Returns (BAWindow, gt_cam [n_cams,6])."""
    import numpy as np

    from srba_slam_tpu.ops.window_ba import BAWindow
    from srba_slam_tpu.utils import se3_np

    import jax.numpy as jnp

    steps = np.zeros((n_cams, 6))
    steps[1:, 5] = step
    steps[1:, 3] = 0.1 * rng.normal(size=n_cams - 1)
    steps[1:, 4] = 0.05 * rng.normal(size=n_cams - 1)
    steps[1:, :3] = 0.002 * rng.normal(size=(n_cams - 1, 3))
    gt_cam = np.cumsum(steps, axis=0)
    depth = step * (n_cams - 1)
    lms_world = np.stack([
        rng.uniform(-10, 10, n_lms), rng.uniform(-2.5, 2.5, n_lms),
        rng.uniform(5, 20 + depth, n_lms),
    ], -1)
    lm_base = rng.integers(0, n_cams, n_lms)
    # landmarks in their base-camera frames (vectorized per camera)
    lm_pos = np.zeros((n_lms, 3))
    inv_cam = se3_np.inverse_batch(gt_cam)
    for c in range(n_cams):
        sel = lm_base == c
        if sel.any():
            lm_pos[sel] = se3_np.transform_points(inv_cam[c], lms_world[sel])
    # observations: all (cam, lm) pairs with z > 1 in front of the camera
    oc_all, ol_all, px_all = [], [], []
    for c in range(n_cams):
        pc = se3_np.transform_points(inv_cam[c], lms_world)  # [n_lms, 3]
        vis = pc[:, 2] > 1.0
        z = np.maximum(pc[:, 2], 1e-6)
        ul = cam.cx_l + cam.fx_l * pc[:, 0] / z
        vl = cam.cy_l + cam.fy_l * pc[:, 1] / z
        ur = cam.cx_r + cam.fx_r * (pc[:, 0] - cam.baseline) / z
        vis &= (ul > -200) & (ul < cam.width + 200)
        idx = np.nonzero(vis)[0]
        oc_all.append(np.full(len(idx), c))
        ol_all.append(idx)
        px_all.append(np.stack([ul[idx], vl[idx], ur[idx]], -1))
    oc = np.concatenate(oc_all)
    ol = np.concatenate(ol_all)
    px = np.concatenate(px_all) + rng.normal(0, px_noise, (len(oc), 3))
    if len(oc) > O:
        keep = rng.choice(len(oc), O, replace=False)
        keep.sort()
        oc, ol, px = oc[keep], ol[keep], px[keep]
    n_o = len(oc)

    cam_pose = np.zeros((C, 6), np.float32)
    cam_pose[:n_cams] = gt_cam
    cam_pose[1:n_cams] += rng.normal(0, pose_noise, (n_cams - 1, 6))
    lm_arr = np.zeros((L, 3), np.float32)
    lm_arr[:n_lms] = lm_pos + rng.normal(0, lm_noise, (n_lms, 3))
    lb = np.zeros(L, np.int32); lb[:n_lms] = lm_base
    oca = np.zeros(O, np.int32); oca[:n_o] = oc
    ola = np.zeros(O, np.int32); ola[:n_o] = ol
    opa = np.zeros((O, 3), np.float32); opa[:n_o] = px
    ova = np.zeros(O, bool); ova[:n_o] = True
    win = BAWindow(
        cam_pose=jnp.asarray(cam_pose),
        cam_valid=jnp.asarray(np.arange(C) < n_cams),
        lm_pos=jnp.asarray(lm_arr), lm_base=jnp.asarray(lb),
        lm_valid=jnp.asarray(np.arange(L) < n_lms),
        obs_cam=jnp.asarray(oca), obs_lm=jnp.asarray(ola),
        obs_px=jnp.asarray(opa), obs_valid=jnp.asarray(ova))
    return win, gt_cam
