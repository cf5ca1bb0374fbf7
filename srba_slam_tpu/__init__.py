"""srba_slam_tpu — a JAX stereo SLAM framework for accelerators.

A from-scratch JAX/XLA re-design of the capabilities of the
famoreno/srba-stereo-slam reference application (stereo visual odometry
frontend + bag-of-words place recognition + sparser relative bundle
adjustment backend), built for an accelerator (today an NVIDIA GPU):

* All per-frame dense compute (FAST/ORB detection, descriptor matching,
  robust pose solving, BoW scoring, bundle adjustment) runs as fixed-shape
  batched tensor programs compiled once by XLA; Hamming matching is an
  exact bf16 matmul with f32 accumulation.
* All variable-size SLAM state (keyframes, landmarks, kf2kf edges, BoW
  database) lives in padded, masked device arrays with static capacities.
* A thin host layer handles I/O, configuration and the rare data-dependent
  branch points (keyframe accept, loop-closure confirmation), mirroring the
  reference's public surface (reference: src/CSRBAStereoSLAMEstimator.h).

Subpackages
-----------
- ``srba_slam_tpu.ops``      — device kernels (detection, matching, solvers)
- ``srba_slam_tpu.models``   — pipeline engines (VO, BoW, SRBA backend, estimator)
- ``srba_slam_tpu.parallel`` — mesh / shard_map scale-out helpers
- ``srba_slam_tpu.utils``    — SE(3) algebra, camera models, profiling, I/O
- ``srba_slam_tpu.native``   — C++ runtime pieces (frame decoding / prefetch)
"""

__version__ = "0.1.0"

from srba_slam_tpu.config import GeneralOptions, SRBAStereoSLAMOptions, load_config

__all__ = [
    "GeneralOptions",
    "SRBAStereoSLAMOptions",
    "load_config",
    "__version__",
]
