"""Stereo frame sources (≙ MRPT CCameraSensor image_dir grabber).

The reference acquires frames through an MRPT ``CCameraSensor`` configured as
an image-directory grabber with C-style filename formats (reference
src/CSRBAStereoSLAMEstimator.cpp:1194-1197; demo config IMG_SOURCE section:
``left_format = image_0\\%06d.png``). Equivalents here:

* ``ImageDirSource`` — reads numbered stereo image pairs from disk (PNG/PGM
  via PIL when available, raw .npy always);
* ``SyntheticSource`` — renders a deterministic textured-world sequence for
  tests and benchmarks (no dataset dependency).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from srba_slam_tpu.config import GeneralOptions


def _load_gray(path: str) -> np.ndarray:
    """Grayscale frame in its native 8-bit dtype (a quarter of the upload
    bytes of f32; device programs cast on the device)."""
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"))


@dataclass
class ImageDirSource:
    """Numbered stereo pairs: dir/left_format % i, dir/right_format % i."""

    image_dir: str
    left_format: str
    right_format: str
    start_index: int = 0
    end_index: int = 0  # 0 = until files run out

    @staticmethod
    def from_options(o: GeneralOptions) -> "ImageDirSource":
        return ImageDirSource(
            o.image_dir_url, o.left_format, o.right_format,
            o.start_index, o.end_index,
        )

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        i = self.start_index
        while True:
            if self.end_index and i > self.end_index:
                return
            lp = os.path.join(self.image_dir, self.left_format % i)
            rp = os.path.join(self.image_dir, self.right_format % i)
            if not (os.path.exists(lp) and os.path.exists(rp)):
                return
            yield _load_gray(lp), _load_gray(rp)
            i += 1


class SyntheticSource:
    """Deterministic rendered stereo sequence over a textured tilted plane.

    The camera follows a smooth 6-DoF path (forward + sway + yaw). Ground
    truth poses are exposed via ``.gt_poses`` for ATE evaluation.
    """

    def __init__(self, cam, n_frames: int = 100, seed: int = 11,
                 step: float = 0.12, loop: bool = False, scene: str = "auto",
                 laps: float = 1.25):
        from srba_slam_tpu.utils.synthworld import PlaneScene, StreetScene
        from srba_slam_tpu.utils import se3_np

        self.cam = cam
        rng = np.random.default_rng(seed)
        if scene == "auto":
            # a frontal plane ~12m away runs out after ~8m of forward travel;
            # long sequences drive over an infinite tiled ground plane
            scene = "ground" if n_frames * step > 8.0 else "frontal"
        if scene == "street":
            # KITTI-like: ground + camera-facing roadside structure (stable
            # descriptors across keyframes — see StreetScene docstring)
            self.scene = StreetScene(rng, path_len=n_frames * step)
        elif scene == "ground":
            self.scene = PlaneScene.ground(rng)
        else:
            self.scene = PlaneScene(rng)
        rng = np.random.default_rng(seed + 1)
        poses = [np.zeros(6)]
        if loop:
            # closed circuit: constant yaw rate completes ``laps`` circles
            # over the sequence (default 1.25: one lap + 25% revisit, the
            # loop-closure territory); laps >= 2 revisits every spot twice,
            # exercising repeated loop-closure events. Tiny noise keeps the
            # geometry non-degenerate.
            yaw_rate = 2.0 * np.pi * laps / n_frames
            for i in range(n_frames - 1):
                inc = np.array([
                    rng.normal(0, 0.001), yaw_rate, rng.normal(0, 0.001),
                    rng.normal(0, 0.002), rng.normal(0, 0.002), step,
                ])
                poses.append(se3_np.compose(poses[-1], inc))
        else:
            for i in range(n_frames - 1):
                inc = np.array([
                    rng.normal(0, 0.002), 0.006 * np.sin(i / 5),
                    rng.normal(0, 0.002),
                    0.03 * np.cos(i / 7), rng.normal(0, 0.004), step,
                ])
                poses.append(se3_np.compose(poses[-1], inc))
        self.gt_poses = np.stack(poses)

    def __iter__(self):
        for p in self.gt_poses:
            yield self.scene.render(self.cam, p.astype(np.float32))
